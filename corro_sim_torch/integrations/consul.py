"""Consul service-discovery sync — `consul-client` + `corrosion consul sync`.

The reference ships a small hyper client for the local Consul agent
(``crates/consul-client/src/lib.rs``: ``AgentService``/``AgentCheck``,
``/v1/agent/services`` + ``/v1/agent/checks``) and a sync daemon
(``corrosion/src/command/consul/sync.rs``) that polls every second,
hash-diffs each service/check against locally persisted hash tables
(``__corro_consul_services``/``__corro_consul_checks``, ``sync.rs:58-141``)
and, per changed entity, transactionally upserts into the replicated
``consul_services``/``consul_checks`` tables — with the ``app_id``
extracted from service meta — and deletes entities that disappeared
(``sync.rs:388-470``).

Same pipeline here: :class:`ConsulAgentClient` speaks the agent HTTP API
(or reads a JSON file — the test/devcluster source), :class:`ConsulSync`
keeps the hash state (persisted to a sidecar JSON, playing the role of
the reference's local non-replicated tables) and writes through the
framework's transaction API.

Port of ``corro_sim/integrations/consul.py`` (host Python only; the same behaviour).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
import urllib.request


def hash_service(svc: dict) -> str:
    """Stable content hash of a service (``hash_service``, ``sync.rs:354``:
    seahash over the struct; any stable digest serves the diff)."""
    return _digest(
        [
            svc.get("ID", ""), svc.get("Service", ""),
            sorted(svc.get("Tags") or []),
            sorted((svc.get("Meta") or {}).items()),
            svc.get("Port", 0), svc.get("Address", ""),
        ]
    )


def hash_check(chk: dict) -> str:
    """``hash_check`` (``sync.rs:360``) — deliberately excludes ``output``
    like the reference (field order in the struct hash stops before the
    free-text output so flapping check output does not dirty the hash)."""
    return _digest(
        [
            chk.get("CheckID", ""), chk.get("Name", ""),
            chk.get("Status", ""), chk.get("ServiceID", ""),
            chk.get("ServiceName", ""),
        ]
    )


def _digest(obj) -> str:
    raw = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(raw.encode(), digest_size=8).hexdigest()


def app_id_of(svc: dict):
    """``app_id`` from service meta (``sync.rs:407-433`` extracts it into
    its own column for the Fly.io schema)."""
    meta = svc.get("Meta") or {}
    try:
        return int(meta["app_id"])
    except (KeyError, TypeError, ValueError):
        return None


class ConsulAgentClient:
    """`consul-client` analog: GET /v1/agent/services and /v1/agent/checks
    against a local Consul agent."""

    def __init__(self, base_url: str = "http://127.0.0.1:8500",
                 timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str):
        import time as _time

        from corro_sim_torch.utils.metrics import histograms as _histograms

        t0 = _time.perf_counter()
        try:
            with urllib.request.urlopen(
                self.base_url + path, timeout=self.timeout
            ) as r:
                out = json.loads(r.read())
        except Exception:
            from corro_sim_torch.utils.metrics import counters as _counters

            _counters.inc(
                "corro_consul_consul_response_errors_total",
                help_="consul API errors "
                      "(corro_consul.consul.response.errors)",
            )
            raise
        _histograms.observe(
            "corro_consul_consul_response_time_seconds",
            _time.perf_counter() - t0,
            help_="consul API response time "
                  "(corro_consul.consul.response.time.seconds)",
        )
        return out

    def agent_services(self) -> dict:
        return self._get("/v1/agent/services")

    def agent_checks(self) -> dict:
        return self._get("/v1/agent/checks")


class FileConsulSource:
    """Test/devcluster source: the agent state as a JSON file
    ``{"services": {...}, "checks": {...}}`` (same shapes as the HTTP
    API). Lets the sync daemon run with zero external processes."""

    def __init__(self, path):
        self.path = str(path)

    def _load(self) -> dict:
        with open(self.path) as f:
            return json.load(f)

    def agent_services(self) -> dict:
        return self._load().get("services", {})

    def agent_checks(self) -> dict:
        return self._load().get("checks", {})


class ConsulSync:
    """The sync daemon (``corrosion consul sync``, ``sync.rs:1-975``)."""

    def __init__(self, source, api_client, node_name: str,
                 state_path=None, target_node: int | None = None):
        self.source = source
        self.client = api_client
        self.node_name = node_name
        self.state_path = str(state_path) if state_path else None
        self.target_node = target_node
        # id -> hash; the __corro_consul_{services,checks} hash tables
        self._svc_hashes: dict[str, str] = {}
        self._chk_hashes: dict[str, str] = {}
        self._load_state()

    # ------------------------------------------------------------ state
    def _load_state(self) -> None:
        if not self.state_path:
            return
        try:
            with open(self.state_path) as f:
                st = json.load(f)
            self._svc_hashes = dict(st.get("services", {}))
            self._chk_hashes = dict(st.get("checks", {}))
        except FileNotFoundError:
            pass
        except (ValueError, OSError):
            # truncated/corrupt sidecar (crash mid-write): start empty —
            # worst case is re-upserting everything, which is idempotent
            self._svc_hashes = {}
            self._chk_hashes = {}

    def _save_state(self) -> None:
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"services": self._svc_hashes, "checks": self._chk_hashes},
                f,
            )
        os.replace(tmp, self.state_path)

    # ------------------------------------------------------------- sync
    def sync_once(self) -> dict:
        """One poll cycle. Returns counts like the reference's stats log
        (``sync.rs:620-640`` upserted/deleted tallies)."""
        services = self.source.agent_services()
        checks = self.source.agent_checks()
        statements: list = []
        stats = {
            "services_upserted": 0, "services_deleted": 0,
            "checks_upserted": 0, "checks_deleted": 0,
        }

        now = int(time.time())
        new_svc_hashes: dict[str, str] = {}
        for sid, svc in services.items():
            h = hash_service(svc)
            new_svc_hashes[sid] = h
            if self._svc_hashes.get(sid) == h:
                continue
            meta = dict(svc.get("Meta") or {})
            app_id = app_id_of(svc)
            if app_id is not None:
                meta["app_id"] = app_id
            statements.append(
                [
                    "INSERT INTO consul_services (node, id, name, tags, "
                    "meta, port, address, updated_at) VALUES "
                    "(?, ?, ?, ?, ?, ?, ?, ?)",
                    [
                        self.node_name, sid, svc.get("Service", ""),
                        json.dumps(svc.get("Tags") or []),
                        json.dumps(meta), svc.get("Port", 0),
                        svc.get("Address", ""), now,
                    ],
                ]
            )
            stats["services_upserted"] += 1
        for sid in set(self._svc_hashes) - set(new_svc_hashes):
            statements.append(
                [
                    "DELETE FROM consul_services WHERE node = ? AND id = ?",
                    [self.node_name, sid],
                ]
            )
            stats["services_deleted"] += 1

        new_chk_hashes: dict[str, str] = {}
        for cid, chk in checks.items():
            h = hash_check(chk)
            new_chk_hashes[cid] = h
            if self._chk_hashes.get(cid) == h:
                continue
            statements.append(
                [
                    "INSERT INTO consul_checks (node, id, service_id, "
                    "service_name, name, status, output, updated_at) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                    [
                        self.node_name, cid, chk.get("ServiceID", ""),
                        chk.get("ServiceName", ""), chk.get("Name", ""),
                        chk.get("Status", ""), chk.get("Output", ""), now,
                    ],
                ]
            )
            stats["checks_upserted"] += 1
        for cid in set(self._chk_hashes) - set(new_chk_hashes):
            statements.append(
                [
                    "DELETE FROM consul_checks WHERE node = ? AND id = ?",
                    [self.node_name, cid],
                ]
            )
            stats["checks_deleted"] += 1

        if statements:
            resp = self.client.execute(statements, node=self.target_node)
            errors = [r for r in resp["results"] if "error" in r]
            if errors:
                raise RuntimeError(f"consul sync tx failed: {errors[0]}")
        # commit the hash state only after the tx landed (the reference
        # writes hashes in the same tx, sync.rs:388-470)
        self._svc_hashes = new_svc_hashes
        self._chk_hashes = new_chk_hashes
        self._save_state()
        return stats

    def run(self, tripwire, interval: float = 1.0) -> None:
        """1 s poll loop (``sync.rs`` main loop cadence)."""
        while not tripwire.tripped:
            try:
                self.sync_once()
            except Exception as e:
                # next tick retries; the reference logs and continues
                print(f"consul sync error (retrying): {e}", file=sys.stderr)
            if tripwire.sleep(interval):
                return
