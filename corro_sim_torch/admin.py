"""Admin server — the `corro-admin` unix-socket command surface.

The reference runs a JSON-framed command server on a unix socket
(``corro-admin/src/lib.rs:44-120``) driven by the ``corrosion`` CLI:
Ping, Sync Generate, Locks{top}, Cluster Members / MembershipStates,
Actor Version, Subs Info/List. Same surface here, over ND-JSON lines
(one request object in, one response object out per line) against the
in-process LiveCluster.

Extra commands the reference does through other channels map naturally
onto the socket because the cluster lives in-process: ``backup`` /
``restore`` (``corrosion backup|restore``, ``main.rs:155-324``) and
fault injection (`corro-devcluster`'s role).

Port of ``corro_sim/admin.py``. Commands that read the cluster's
tensors take the cluster's lock and reduce on its device before the one
copy to the host.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading

import numpy as np
import torch


class AdminError(Exception):
    pass


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        api: AdminServer = self.server.admin  # type: ignore[attr-defined]
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                req = json.loads(raw)
                resp = api.dispatch(req)
            except AdminError as e:
                resp = {"ok": False, "error": str(e)}
            except json.JSONDecodeError as e:
                resp = {"ok": False, "error": f"bad request: {e}"}
            except Exception as e:  # survivable command failure
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class _Server(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class AdminServer:
    def __init__(self, cluster, sock_path: str):
        self.cluster = cluster
        self.path = str(sock_path)
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._srv = _Server(self.path, _Handler)
        self._srv.admin = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None
        self._db_locks: dict = {}  # token -> (holder thread, release event)

    def start(self) -> "AdminServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="corro-admin", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if os.path.exists(self.path):
            os.unlink(self.path)
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ dispatch
    def dispatch(self, req: dict) -> dict:
        cmd = req.get("cmd")
        fn = getattr(self, f"_cmd_{cmd}", None)
        if fn is None:
            raise AdminError(f"unknown command {cmd!r}")
        out = fn(req)
        return {"ok": True, **(out or {})}

    def _cmd_ping(self, req):
        return {"pong": True}

    def _cmd_locks(self, req):
        """`corrosion locks --top N` — LockRegistry dump
        (``corro-types/src/agent.rs:890-1099``, admin Locks{top})."""
        top = req.get("top")
        return {"locks": self.cluster.locks.snapshot(top=top)}

    def _cmd_cluster_members(self, req):
        return {"members": self.cluster.members()}

    def _cmd_cluster_membership_states(self, req):
        """SWIM per-node view matrix (admin MembershipStates analog):
        per-node counts reduced on the cluster's device, read in one
        copy, under the cluster's lock."""
        c = self.cluster
        out = {"swim_enabled": bool(c.cfg.swim_enabled)}
        if c.cfg.swim_enabled:
            with c._lock:
                host = torch.cat([
                    c._self_inc_device().to(torch.int64),
                    c._belief_device().reshape(-1),
                ]).cpu().numpy()
            inc, sus, dwn = host.reshape(3, -1)
            out["incarnation"] = inc.tolist()
            out["suspected_by"] = sus.tolist()
            out["down_by"] = dwn.tolist()
        return out

    def _cmd_cluster_rejoin(self, req):
        """Admin Cluster Rejoin: revive a node with a renewed identity
        (``FocaCmd::Rejoin``, ``corro-admin/src/lib.rs:364-383``)."""
        if "node" not in req:
            raise AdminError("cluster_rejoin requires 'node'")
        return self.cluster.rejoin(int(req["node"]))

    def _cmd_cluster_set_id(self, req):
        """Admin Cluster SetId (``corro-admin/src/lib.rs:431-474``):
        cluster ids map onto the partition plane (see
        LiveCluster.set_cluster_id). Both fields are required — a
        defaulted cluster_id of 0 would silently re-admit a walled-off
        node into the main cluster."""
        for field in ("node", "cluster_id"):
            if field not in req:
                raise AdminError(f"cluster_set_id requires {field!r}")
        return self.cluster.set_cluster_id(
            int(req["node"]), int(req["cluster_id"])
        )

    def _cmd_sync_reconcile_gaps(self, req):
        """Admin Sync ReconcileGaps (``corro-admin/src/lib.rs:315-341``)."""
        return self.cluster.reconcile_gaps()

    def _cmd_traces(self, req):
        """Recent spans from the process tracer — the admin-side read of
        what the reference ships to its OTLP collector."""
        from corro_sim_torch.utils.tracing import tracer

        n = int(req.get("n", 100))
        name = req.get("name")
        trace_id = req.get("trace_id")
        if trace_id:
            spans = tracer.trace(trace_id)
        else:
            spans = tracer.recent(n=n, name=name)
        return {"spans": [s.as_json() for s in spans]}

    def _cmd_flight(self, req):
        """Flight-recorder timeline: per-round metrics, annotations,
        derived convergence diagnostics. ``diag_only`` trims the body to
        the diagnostics; ``n`` keeps only the last n rounds; ``export``
        additionally dumps the full ND-JSON to a path server-side."""
        fl = getattr(self.cluster, "flight", None)
        if fl is None:
            raise AdminError("no flight recorder attached")
        export = req.get("export")
        if export:
            fl.dump(str(export))
        if req.get("diag_only"):
            return {"diagnostics": fl.diagnostics(),
                    **({"exported": export} if export else {})}
        n = req.get("n")
        if n is not None and int(n) < 0:
            raise AdminError("n must be >= 0")
        out = fl.timeline(last_rounds=int(n) if n else None)
        if export:
            out["exported"] = export
        return out

    def _cmd_sweep(self, req):
        """The fleet observatory's sweep snapshot (obs/lanes.py) — the
        admin-socket face of GET /v1/sweep: live per-chunk lane-state
        while a sweep runs in this process, the final summary after."""
        from corro_sim_torch.obs.lanes import sweep_status

        st = sweep_status()
        if st is None:
            raise AdminError("no sweep has run in this process")
        return {"sweep": st}

    def _cmd_probes(self, req):
        """Probe-tracer provenance + the per-node lag observatory
        (`corro-sim probes`). ``lag_only`` trims to the observatory;
        ``export`` writes the NDJSON journal + Chrome trace JSON
        server-side under the given path prefix."""
        if req.get("lag_only"):
            return {"node_lag": self.cluster.node_lag(
                top_k=int(req.get("top", 8))
            )}
        out = self.cluster.probe_report()
        export = req.get("export")
        if export:
            tr = self.cluster.probe_trace()
            if tr is None:
                raise AdminError(
                    "probe tracer disabled — nothing to export"
                )
            tr.dump_ndjson(f"{export}.ndjson")
            tr.dump_chrome_trace(f"{export}.trace.json")
            out["exported"] = [f"{export}.ndjson", f"{export}.trace.json"]
        return out

    # ------------------------------------------------------------- db lock
    # `corrosion db lock "cmd"` holds exclusive byte-range locks on the DB
    # while a shell command runs (``main.rs:492-530``,
    # ``sqlite3-restore/src/lib.rs:16-57``). The tensor-state analog: hold
    # the cluster's write lock between acquire/release admin calls — every
    # write, tick, migration and restore blocks until released. A holder
    # thread owns the (thread-bound) RLock and auto-releases on timeout in
    # case the client dies with the lock held.
    def _cmd_db_lock_acquire(self, req):
        import uuid

        timeout = float(req.get("timeout", 30.0))
        if not (0 < timeout <= 24 * 3600):
            raise AdminError(
                f"db lock timeout must be in (0, 86400], got {timeout}"
            )
        token = uuid.uuid4().hex[:12]
        acquired = threading.Event()
        release = threading.Event()
        expired = threading.Event()

        def hold():
            with self.cluster.locks.tracked(
                self.cluster._lock, f"db lock {token}", "write"
            ):
                acquired.set()
                if not release.wait(timeout):
                    expired.set()  # crash-safety auto-release fired
                    # prune our own entry: the client that would have
                    # released it is exactly the one that crashed
                    self._db_locks.pop(token, None)

        th = threading.Thread(target=hold, name=f"db-lock-{token}",
                              daemon=True)
        # register BEFORE starting: the holder's expiry-prune must always
        # find the entry, however small the timeout
        self._db_locks[token] = (th, release, expired)
        th.start()
        if not acquired.wait(10):
            release.set()
            self._db_locks.pop(token, None)
            raise AdminError("could not acquire the write lock in 10s")
        return {"token": token, "timeout": timeout}

    def _cmd_db_lock_release(self, req):
        token = req.get("token")
        entry = self._db_locks.pop(token, None)
        if entry is None:
            # distinguishable error text: the CLI treats an unknown token
            # as "the hold expired and self-pruned"
            raise AdminError(f"unknown db lock token {token!r}")
        th, release, expired = entry
        release.set()
        th.join(timeout=5)
        # an expired hold means the lock was NOT protecting the tail of
        # whatever ran under it — the caller must know
        return {"released": token, "expired": expired.is_set()}

    def _cmd_actor_version(self, req):
        actor = int(req.get("actor", 0))
        return self.cluster.actor_versions(actor)

    def _cmd_sync_generate(self, req):
        """SyncStateV1 analog for one node (admin Sync Generate):
        per-actor applied heads + total need vs the cluster's written
        heads (``generate_sync``, ``corro-types/src/sync.rs:284-344``)."""
        node = int(req.get("node", 0))
        self.cluster._check_node(node)
        c = self.cluster
        with c._lock:
            head = c.state.book.head[node]
            written = c.state.log.head
            # one copy: the node's heads and the written heads
            both = torch.stack([head, written]).cpu().numpy()
        heads, written = both[0], both[1]
        need = np.maximum(written - heads, 0)
        return {
            "actor_id": node,
            "heads": heads.tolist(),
            "need": {
                str(a): int(n) for a, n in enumerate(need) if n > 0
            },
            "total_need": int(need.sum()),
        }

    def _cmd_subs_list(self, req):
        subs = []
        for sub_id, m in self.cluster.subs._by_id.items():
            subs.append(
                {
                    "id": sub_id,
                    "sql": m.select.normalized(),
                    "node": m.node,
                    "change_id": m.change_id,
                    "streams": len(self.cluster._sub_queues.get(sub_id, [])),
                }
            )
        return {"subs": subs}

    def _cmd_subs_info(self, req):
        sub_id = req.get("id")
        m = self.cluster.subs.get(sub_id)
        if m is None:
            raise AdminError(f"no such subscription {sub_id!r}")
        return {
            "id": sub_id,
            "sql": m.select.normalized(),
            "node": m.node,
            "change_id": m.change_id,
            "buffered_events": len(m._events),
            "streams": len(self.cluster._sub_queues.get(sub_id, [])),
        }

    def _cmd_table_stats(self, req):
        return {"tables": self.cluster.table_stats()}

    def _cmd_backup(self, req):
        from corro_sim_torch.io.checkpoint import backup

        path = req.get("path")
        if not path:
            raise AdminError("backup needs a path")
        backup(self.cluster, path, node=int(req.get("node", 0)))
        return {"path": path}

    def _cmd_restore(self, req):
        from corro_sim_torch.io.checkpoint import restore_into

        path = req.get("path")
        if not path or not os.path.exists(path):
            raise AdminError(f"no such backup file {path!r}")
        restore_into(self.cluster, path, node=int(req.get("node", 0)))
        return {"path": path}

    def _cmd_checkpoint(self, req):
        from corro_sim_torch.io.checkpoint import save_checkpoint

        path = req.get("path")
        if not path:
            raise AdminError("checkpoint needs a path")
        save_checkpoint(self.cluster, path)
        return {"path": path}

    def _cmd_set_alive(self, req):
        """Fault injection (devcluster role): mark a node up/down."""
        self.cluster.set_alive(int(req["node"]), bool(req["alive"]))
        return {}

    def _cmd_tick(self, req):
        self.cluster.tick(int(req.get("rounds", 1)))
        return {"rounds_ticked": self.cluster._rounds_ticked}


class AdminClient:
    """Line-oriented client for the admin socket (CLI side)."""

    def __init__(self, sock_path: str, timeout: float = 30.0):
        self.path = str(sock_path)
        self.timeout = timeout

    def call(self, cmd: str, **args) -> dict:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(self.timeout)
            s.connect(self.path)
            s.sendall(
                (json.dumps({"cmd": cmd, **args}) + "\n").encode()
            )
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        resp = json.loads(buf)
        if not resp.get("ok"):
            raise AdminError(resp.get("error", "command failed"))
        return resp
