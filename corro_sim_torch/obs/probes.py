"""Probe trace observability: infection trees, coverage curves, the
per-node lag observatory, and the three export surfaces.

Port of ``corro_sim/obs/probes.py`` (host numpy; a copy, so that the
port imports nothing of the JAX package). The on-device tracer
(``engine/probe.py``) leaves provenance tensors in the ``SimState``;
this module is the host layer that turns them into the artifacts gossip
analysis needs:

- **infection trees** — who infected whom, reconstructed from
  ``infector``/``hop``; sync joins (range transfers, no per-message
  provenance) are kept separate from gossip edges;
- **coverage curves** — nodes infected by round, per probe (monotone by
  construction: ``first_seen`` only ever transitions -1 → r once);
- **delivery statistics** — p50/p99 delivery round relative to the
  origin commit, hop-count distribution, redundancy ratio (duplicate
  deliveries per infection), and **stretch** vs BFS shortest paths on
  the ground-truth peer graph (a pure-NumPy oracle — hop ≥ BFS must
  hold for every gossip-reached node);
- **lag observatory** — per-node rows-behind, last-sync age and SWIM
  suspicion, with the top-k laggards called out;
- exports: Chrome trace-event JSON (loadable in Perfetto / chrome://
  tracing), ND-JSON journals (same torn-tail-tolerant discipline as the
  flight recorder).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

# infector sentinels, as engine/probe.py has them (not imported: this
# module imports no torch at module level, like obs/flight.py)
INFECTOR_NONE = -1
INFECTOR_SYNC = -2

__all__ = [
    "PROBE_FIELDS",
    "ProbeTrace",
    "bfs_hops",
    "ground_truth_adjacency",
    "node_lag_observatory",
]

# the probe planes, in ProbeState's field order
PROBE_FIELDS = ("actor", "ver", "first_seen", "infector", "hop", "dup",
                "last_sync")


def _host(x) -> np.ndarray:
    """A tensor's or an array's values as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def bfs_hops(adj: np.ndarray, src: int) -> np.ndarray:
    """(N,) BFS shortest-path hops from ``src`` over boolean adjacency
    ``adj[i, j]`` ("i can deliver to j"); -1 = unreachable. The NumPy
    oracle the on-device hop counts are validated against: gossip can
    never beat BFS, so ``hop >= bfs_hops`` (stretch >= 1) for every
    reached node."""
    n = adj.shape[0]
    dist = np.full(n, -1, np.int32)
    dist[src] = 0
    frontier = np.zeros(n, bool)
    frontier[src] = True
    d = 0
    while frontier.any():
        d += 1
        reach = adj[frontier].any(axis=0) & (dist < 0)
        dist[np.nonzero(reach)[0]] = d
        frontier = reach
    return dist


def ground_truth_adjacency(alive, part, blackhole=None) -> np.ndarray:
    """The simulator's link predicate as a dense graph: both endpoints
    up and in the same partition (engine/step._reachable_fn). Gossip
    targets are sampled uniformly over the membership view, so this is
    the densest graph any message could traverse — BFS over it lower-
    bounds every achievable hop count.

    ``blackhole``: the fault layer's directed (src, dst) drop pairs
    (``FaultConfig.blackhole``, -1 = wildcard) — edges it covers carry
    nothing, so they leave the oracle graph too. This is how the chaos
    tests realize ring/star topologies and validate hop counts against
    BFS on the constrained graph (tests/test_faults.py)."""
    alive = np.asarray(alive, bool)
    part = np.asarray(part)
    adj = (
        alive[:, None]
        & alive[None, :]
        & (part[:, None] == part[None, :])
    )
    if blackhole:
        # the SAME wildcard expansion the transport applies
        # (faults/masks.py) — oracle graph and drop mask cannot diverge
        from corro_sim_torch.faults.masks import pairs_to_mask

        adj &= ~pairs_to_mask(blackhole, adj.shape[0])
    np.fill_diagonal(adj, False)
    return adj


@dataclasses.dataclass
class ProbeTrace:
    """Host-side view of one run's probe provenance tensors."""

    actor: np.ndarray  # (K,) origin actor per probe
    ver: np.ndarray  # (K,) tracked version
    first_seen: np.ndarray  # (K, N) round, -1 = never
    infector: np.ndarray  # (K, N) peer / INFECTOR_* sentinel
    hop: np.ndarray  # (K, N) gossip hops, -1 = n/a
    dup: np.ndarray  # (K,) duplicate deliveries
    last_sync: np.ndarray  # (N,) last sync-sweep round, -1 = never
    round_ms: float = 200.0
    meta: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_state(cls, cfg, state, **meta) -> "ProbeTrace":
        """Extract from a SimState whose ``probe`` holds tensors (on any
        device) or host arrays. One small transfer: K x N int planes."""
        p = state.probe
        return cls(
            **{f: _host(getattr(p, f)) for f in PROBE_FIELDS},
            round_ms=float(cfg.round_ms),
            meta=dict(meta),
        )

    @property
    def num_probes(self) -> int:
        return int(self.actor.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.first_seen.shape[1])

    # ------------------------------------------------------------ analysis
    def origin_round(self, k: int) -> int | None:
        """Round probe k's version was committed at its origin (None if
        it never was — the sampled actor wrote nothing)."""
        r = int(self.first_seen[k, int(self.actor[k])])
        return r if r >= 0 else None

    def coverage_curve(self, k: int) -> tuple[list[int], list[int]]:
        """(rounds, infected_count) — nodes holding probe k by each
        round with an infection event. Monotone non-decreasing by
        construction."""
        seen = self.first_seen[k]
        rounds = np.unique(seen[seen >= 0])
        counts = [int(((seen >= 0) & (seen <= r)).sum()) for r in rounds]
        return [int(r) for r in rounds], counts

    def infection_tree(self, k: int) -> dict:
        """Probe k's provenance: gossip edges (parent → child, hop-
        stamped) and sync joins (no per-message provenance) separately.
        """
        seen = self.first_seen[k]
        inf = self.infector[k]
        hop = self.hop[k]
        origin = self.origin_round(k)
        edges = []
        sync_joins = []
        for n in np.nonzero(seen >= 0)[0]:
            n = int(n)
            if inf[n] >= 0:
                edges.append({
                    "parent": int(inf[n]), "child": n,
                    "round": int(seen[n]), "hop": int(hop[n]),
                })
            elif inf[n] == INFECTOR_SYNC:
                sync_joins.append({"node": n, "round": int(seen[n])})
        return {
            "probe": k,
            "actor": int(self.actor[k]),
            "ver": int(self.ver[k]),
            "origin_round": origin,
            "edges": edges,
            "sync_joins": sync_joins,
        }

    def summary(self, k: int, adj: np.ndarray | None = None) -> dict:
        """Per-probe delivery statistics. ``adj``: ground-truth peer
        graph for the BFS stretch oracle (omitted → no stretch block)."""
        seen = self.first_seen[k]
        inf = self.infector[k]
        hop = self.hop[k]
        n = self.num_nodes
        infected = int((seen >= 0).sum())
        origin = self.origin_round(k)
        out = {
            "probe": k,
            "actor": int(self.actor[k]),
            "ver": int(self.ver[k]),
            "origin_round": origin,
            "infected": infected,
            "coverage": round(infected / n, 4),
            "gossip_infections": int((inf >= 0).sum()),
            "sync_joins": int((inf == INFECTOR_SYNC).sum()),
            "dup_deliveries": int(self.dup[k]),
            "delivery_round_p50": None,
            "delivery_round_p99": None,
            "hop_max": None,
            "hop_mean": None,
            "redundancy_ratio": None,
        }
        if origin is None or infected == 0:
            return out
        lags = (seen[seen >= 0] - origin).astype(np.float64)
        out["delivery_round_p50"] = float(np.percentile(lags, 50))
        out["delivery_round_p99"] = float(np.percentile(lags, 99))
        hops = hop[hop >= 1]
        if hops.size:
            out["hop_max"] = int(hops.max())
            out["hop_mean"] = round(float(hops.mean()), 3)
        non_origin = max(infected - 1, 1)
        out["redundancy_ratio"] = round(
            float(self.dup[k]) / non_origin, 3
        )
        if adj is not None:
            st = self.stretch(k, adj)
            if st is not None:
                out["stretch"] = st
        return out

    def stretch(self, k: int, adj: np.ndarray) -> dict | None:
        """hop / BFS-shortest-path per gossip-reached node — the bound
        gossip theory states reach in (stretch >= 1 always; how much
        above 1 measures the fabric's detours). None when the probe has
        no gossip-reached nodes."""
        origin = self.origin_round(k)
        if origin is None:
            return None
        bfs = bfs_hops(adj, int(self.actor[k]))
        hop = self.hop[k]
        mask = (hop >= 1) & (bfs >= 1)
        if not mask.any():
            return None
        ratios = hop[mask].astype(np.float64) / bfs[mask]
        return {
            "min": round(float(ratios.min()), 3),
            "mean": round(float(ratios.mean()), 3),
            "max": round(float(ratios.max()), 3),
            "nodes": int(mask.sum()),
        }

    def delivery_p99(self) -> float | None:
        """Worst p99 delivery lag across probes that have an origin —
        the scalar the drivers watch for flight-recorder regression
        annotations."""
        worst = None
        for k in range(self.num_probes):
            s = self.summary(k)
            p99 = s["delivery_round_p99"]
            if p99 is not None and (worst is None or p99 > worst):
                worst = p99
        return worst

    def report(self, adj: np.ndarray | None = None) -> dict:
        """The GET /v1/probes body: per-probe summaries + trees."""
        return {
            "meta": {
                "probes": self.num_probes,
                "nodes": self.num_nodes,
                "round_ms": self.round_ms,
                **self.meta,
            },
            "summaries": [
                self.summary(k, adj=adj) for k in range(self.num_probes)
            ],
            "trees": [
                self.infection_tree(k) for k in range(self.num_probes)
            ],
        }

    # ------------------------------------------------------------- exports
    def to_ndjson(self) -> str:
        """One self-describing line per record, the flight-recorder
        discipline: every prefix of a valid file is a valid file."""
        lines = [json.dumps({
            "t": "probe_meta",
            "probes": self.num_probes,
            "nodes": self.num_nodes,
            "round_ms": self.round_ms,
            **self.meta,
        }, sort_keys=True)]
        for k in range(self.num_probes):
            lines.append(json.dumps(
                {"t": "probe", **self.summary(k)}, sort_keys=True
            ))
            seen = self.first_seen[k]
            order = np.nonzero(seen >= 0)[0]
            order = order[np.argsort(seen[order], kind="stable")]
            for n in order:
                n = int(n)
                lines.append(json.dumps({
                    "t": "probe_node", "k": k, "node": n,
                    "r": int(seen[n]),
                    "hop": int(self.hop[k, n]),
                    "infector": int(self.infector[k, n]),
                }, sort_keys=True))
        return "\n".join(lines) + "\n"

    def dump_ndjson(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_ndjson())
        os.replace(tmp, path)

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing).

        Layout: one *process* per probe, one *thread* per infected node;
        each infection is a complete ("X") slice starting at the node's
        first-seen simulated time, and gossip edges are flow arrows
        ("s"/"f") from infector to infected. Timestamps are simulated
        microseconds (``round * round_ms * 1000``)."""
        us = self.round_ms * 1000.0
        ev: list[dict] = []
        flow_id = 0
        for k in range(self.num_probes):
            pid = k
            ev.append({
                "ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": f"probe {k} (actor {int(self.actor[k])} "
                                 f"v{int(self.ver[k])})"},
            })
            seen = self.first_seen[k]
            for n in np.nonzero(seen >= 0)[0]:
                n = int(n)
                r = int(seen[n])
                inf = int(self.infector[k, n])
                via = (
                    "origin" if inf == INFECTOR_NONE
                    else "sync" if inf == INFECTOR_SYNC
                    else "gossip"
                )
                ev.append({
                    "ph": "M", "pid": pid, "tid": n,
                    "name": "thread_name",
                    "args": {"name": f"node {n}"},
                })
                ev.append({
                    "ph": "X", "pid": pid, "tid": n,
                    "ts": r * us, "dur": us,
                    "name": f"infected via {via}",
                    "cat": "probe",
                    "args": {
                        "round": r,
                        "hop": int(self.hop[k, n]),
                        "infector": inf,
                        "via": via,
                    },
                })
                if inf >= 0:
                    flow_id += 1
                    ev.append({
                        "ph": "s", "pid": pid, "tid": inf,
                        "ts": r * us, "id": flow_id,
                        "name": "infect", "cat": "infection",
                    })
                    ev.append({
                        "ph": "f", "pid": pid, "tid": n,
                        "ts": r * us, "id": flow_id, "bp": "e",
                        "name": "infect", "cat": "infection",
                    })
        return {
            "traceEvents": ev,
            "displayTimeUnit": "ms",
            "otherData": {
                "probes": self.num_probes,
                "nodes": self.num_nodes,
                "round_ms": self.round_ms,
                **{k: v for k, v in self.meta.items()
                   if isinstance(v, (str, int, float, bool))},
            },
        }

    def dump_chrome_trace(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)


def node_lag_observatory(
    log_head,
    book_head,
    alive,
    current_round: int,
    last_sync=None,
    suspected_by=None,
    top_k: int = 8,
) -> dict:
    """The per-node lag observatory: who is behind, by how much, and why
    it might be (stale sync, SWIM suspicion).

    - ``rows_behind[n]`` — versions written cluster-wide that node n has
      not applied (sum over actors of ``max(log_head - book_head, 0)``);
    - ``last_sync_age[n]`` — rounds since the node took part in an
      anti-entropy sweep (None column when no probe state tracked it);
    - ``suspected_by[n]`` — how many observers currently suspect the
      node (caller derives it from SWIM state);
    - ``top_laggards`` — the ``top_k`` worst rows-behind among live
      nodes, each row carrying all three columns.
    """
    log_head = np.asarray(log_head)
    book_head = np.asarray(book_head)
    alive = np.asarray(alive, bool)
    behind = np.maximum(log_head[None, :] - book_head, 0).sum(axis=1)
    behind = np.where(alive, behind, 0)
    ages = None
    if last_sync is not None:
        ls = np.asarray(last_sync)
        if ls.shape[0] == behind.shape[0]:
            ages = np.where(ls >= 0, current_round - ls, -1)
    sus = None
    if suspected_by is not None:
        sus = np.asarray(suspected_by)
        if sus.shape[0] != behind.shape[0]:
            sus = None
    order = np.argsort(-behind, kind="stable")[:top_k]
    top = []
    for n in order:
        n = int(n)
        row = {"node": n, "rows_behind": int(behind[n])}
        if ages is not None:
            row["last_sync_age"] = int(ages[n])
        if sus is not None:
            row["suspected_by"] = int(sus[n])
        top.append(row)
    live = behind[alive]
    return {
        "nodes": int(behind.shape[0]),
        "alive": int(alive.sum()),
        "rows_behind_total": int(behind.sum()),
        "rows_behind_max": int(live.max()) if live.size else 0,
        "rows_behind_mean": round(float(live.mean()), 3) if live.size else 0.0,
        "lagging_nodes": int((live > 0).sum()),
        "last_sync_age_max": (
            int(ages[alive].max()) if ages is not None and alive.any()
            else None
        ),
        "top_laggards": top,
    }
