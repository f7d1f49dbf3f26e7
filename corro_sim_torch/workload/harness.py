"""The live load harness: a compiled workload driven through the agent.

Where ``run_sim(workload=...)`` measures the *dissemination* half of
production load (convergence while writes storm), this harness measures
the *serving* half: the same schedule mapped to SQL against a
:class:`~corro_sim_torch.harness.cluster.LiveCluster` — the write path the
HTTP API serializes — while hundreds of concurrent subscriptions watch
through :mod:`corro_sim_torch.subs.manager` and one-shot queries fan
through the
public surfaces (direct / HTTP / pgwire). The question every round
answers: **how late do subscribers learn about a committed change while
the cluster is busy?**

Latency clock (``corro_sub_latency_rounds``/``_seconds``): a write
accepted at round *t* commits in tick *t+1* (the one-changeset-per-node-
per-round drain); the subscriber-side matcher emits the corresponding
``SubEvent`` at some round *T* (stamped on the event by the notify
path). Delivery latency = *T − (t+1)* rounds — 0 when the observer is
the writer's own node, gossip/sync propagation otherwise. Writes whose
value never surfaces (overwritten before the matcher diff saw them)
count as *coalesced*, exactly the batching the reference's candidate
accumulation does (``pubsub.rs:1154-1296``).

Schema: the canonical service-discovery table (corrosion's actual job) —
``services(id, node, val)``; workload key ids are pk ordinals, every
committed write carries a process-unique ``val`` so events correlate
back to their write without guessing.

Port of ``corro_sim/workload/harness.py``, host Python over the port's
LiveCluster: the schedule is numpy, the subscriber queues hold host
events, and the cluster's tensors are touched only through its methods.
A cluster the harness builds lives on ``device`` (CUDA unless the caller
asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import functools
import time

from corro_sim_torch.utils.metrics import (
    ROUNDS_BUCKETS,
    SUB_LATENCY_ROUNDS,
    SUB_LATENCY_ROUNDS_HELP,
    SUB_LATENCY_SECONDS,
    SUB_LATENCY_SECONDS_HELP,
    WORKLOAD_COALESCED_TOTAL,
    WORKLOAD_QUERIES_TOTAL,
    WORKLOAD_ROUNDS_TOTAL,
    WORKLOAD_WRITES_TOTAL,
    counters,
)

SERVICES_SCHEMA = """
CREATE TABLE services (
    id INTEGER NOT NULL PRIMARY KEY,
    node INTEGER NOT NULL DEFAULT 0,
    val INTEGER NOT NULL DEFAULT 0
);
"""

# the query-fan rotation: the shapes a service-discovery consumer runs
# (full scans, health filters, per-node views, pk ranges)
_SUB_QUERIES = (
    "SELECT id, val FROM services",
    "SELECT id, val FROM services WHERE val >= 0",
    "SELECT id, node, val FROM services WHERE node = {node}",
    "SELECT id, val FROM services WHERE id >= {lo} AND id < {hi}",
)


@dataclasses.dataclass
class LoadReport:
    """One live-load run's result (the ``workload-report`` artifact body
    and the GET /v1/workload payload)."""

    spec: str
    nodes: int
    rounds: int  # load-phase rounds driven
    settle_rounds: int  # extra rounds until drained (or budget)
    matchers: int  # distinct registered matchers
    subscriptions: int  # live subscriber streams (≥ matchers)
    writes: int
    deletes: int
    observed: int  # (write, subscriber) deliveries measured
    coalesced: int  # writes a subscriber never saw individually
    queries: dict  # surface -> one-shot queries issued
    latency_rounds: dict  # {p50, p90, p99, max, count}
    latency_seconds: dict  # {p50, p99, max, count}
    drained: bool  # cluster reached gap 0 inside the settle budget
    wall_seconds: float

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


class _SubProbe:
    """One latency-tracked subscriber stream: its queue, its val→commit
    bookkeeping, and the position of ``val`` in the query's row shape."""

    def __init__(self, sub_id: str, node: int, queue, columns: list):
        self.sub_id = sub_id
        self.node = node
        self.queue = queue
        # event cells and the initial columns header share one layout
        # (pk prefix + selected value columns), so the header position
        # of `val` indexes the cells directly
        self.val_pos = columns.index("val") if "val" in columns else None
        self.pending: dict[int, list] = {}  # key -> [(val, commit_round,
        # wall)] oldest-first

    def expect(self, key: int, val: int, commit_round: int,
               wall: float) -> None:
        self.pending.setdefault(key, []).append((val, commit_round, wall))

    def drop_key(self, key: int) -> int:
        """A DELETE landed: everything still pending on the key will
        never surface as a value — count it coalesced."""
        return len(self.pending.pop(key, ()))


def _quantiles(hist) -> dict:
    if hist is None or not hist.count:
        return {"count": 0, "p50": None, "p90": None, "p99": None,
                "max": None}
    return {
        "count": hist.count,
        "p50": hist.quantile(0.50),
        "p90": hist.quantile(0.90),
        "p99": hist.quantile(0.99),
        "max": round(hist.max, 6),
    }


def load_cluster(workload, *, seed: int = 0,
                 default_capacity: int | None = None,
                 cfg_overrides: dict | None = None, device=None,
                 cluster_cls=None):
    """The cluster :func:`run_live_load` builds for ``workload``: the
    services table with one row slot per key (``default_capacity``
    overrides), warmed up before traffic arrives so that round-0 writes
    carry no setup wall (on the card, the merge library's build).
    ``cluster_cls`` (the port's ``LiveCluster`` by default) lets a caller
    build the same cluster from another class with its API."""
    if cluster_cls is None:
        from corro_sim_torch.harness.cluster import LiveCluster

        cluster_cls = functools.partial(LiveCluster, device=device)
    cap = default_capacity or max(16, workload.key_universe())
    cluster = cluster_cls(
        SERVICES_SCHEMA, num_nodes=workload.n, seed=seed,
        default_capacity=cap, cfg_overrides=cfg_overrides,
    )
    cluster.warmup()
    return cluster


def run_live_load(
    workload,
    *,
    cluster=None,
    subs: int = 8,
    subscribers_per_sub: int = 1,
    latency_subs: int = 32,
    queries_per_round: int = 0,
    http: bool = False,
    pg: bool = False,
    seed: int = 0,
    settle_rounds: int = 256,
    cfg_overrides: dict | None = None,
    default_capacity: int | None = None,
    device=None,
) -> LoadReport:
    """Drive ``workload`` through a live cluster end to end.

    ``subs`` distinct matchers spread over observer nodes (each opened
    ``subscribers_per_sub`` times — live subscriber streams dedupe onto
    one matcher exactly like the reference's ``get_or_insert``);
    the first ``latency_subs`` streams are latency-tracked (bounding the
    val→commit bookkeeping at fleet scale). ``queries_per_round``
    one-shot queries fan through the enabled surfaces round-robin
    (direct always; ``http``/``pg`` spin real servers on loopback).

    A cluster the harness builds (``cluster=None``) lives on ``device``.

    Returns a :class:`LoadReport`; also installed as
    ``cluster.workload_report`` (GET /v1/workload) and observed into the
    cluster's ``corro_sub_latency_*`` histograms + the process-wide
    ``corro_workload_*`` counters.
    """
    t_start = time.perf_counter()
    own_cluster = cluster is None
    if own_cluster:
        cluster = load_cluster(workload, seed=seed,
                               default_capacity=default_capacity,
                               cfg_overrides=cfg_overrides, device=device)
    n = cluster.cfg.num_nodes
    if workload.n != n:
        raise ValueError(
            f"workload compiled for {workload.n} nodes, cluster has {n}"
        )

    # ---- subscription fan ------------------------------------------------
    probes: list[_SubProbe] = []
    streams = 0
    matcher_ids: set = set()
    kspan = max(workload.key_universe(), 1)
    for j in range(subs):
        node = j % n
        tmpl = _SUB_QUERIES[j % len(_SUB_QUERIES)]
        lo = (j * 7) % kspan
        sql = tmpl.format(node=node, lo=lo, hi=lo + max(kspan // 2, 1))
        sub_id, initial, q = cluster.subscribe_attached(sql, node=node)
        matcher_ids.add(sub_id)
        streams += 1
        cols = next(
            (e["columns"] for e in initial if "columns" in e), []
        )
        # only full-coverage queries are latency-tracked: a filtered sub
        # (per-node view, pk range) legitimately never sees most writes,
        # which would read as phantom coalescing
        track = j % len(_SUB_QUERIES) < 2
        if track and len(probes) < latency_subs:
            probes.append(_SubProbe(sub_id, node, q, cols))
        for _ in range(subscribers_per_sub - 1):
            q2 = cluster.sub_attach_queue(sub_id)
            streams += 1
            if track and q2 is not None and len(probes) < latency_subs:
                probes.append(_SubProbe(sub_id, node, q2, cols))

    # ---- query-fan surfaces ---------------------------------------------
    api_srv = pg_srv = api_client = pg_client = None
    surfaces = ["direct"]
    if http:
        from corro_sim_torch.api.http import ApiServer
        from corro_sim_torch.client import ApiClient

        api_srv = ApiServer(cluster).start()
        api_client = ApiClient(api_srv.addr)
        surfaces.append("http")
    if pg:
        from corro_sim_torch.api.pg import PgServer, SimplePgClient

        pg_srv = PgServer(cluster).start()
        pg_client = SimplePgClient(*pg_srv.addr)
        surfaces.append("pg")
    queries = {s: 0 for s in surfaces}
    qi = 0

    key_of = cluster.layout.key_of  # slot -> (table, (pk,)) | None
    hist = cluster.histograms
    next_val = 1
    writes = deletes = observed = coalesced = 0
    lat_rounds: list = []
    lat_secs: list = []

    def drain() -> None:
        nonlocal observed, coalesced
        now = time.perf_counter()
        for p in probes:
            while p.queue:
                ev = p.queue.popleft()
                key_t = key_of(ev.rowid)
                key = int(key_t[1][0]) if key_t else ev.rowid
                if ev.kind == "delete":
                    coalesced += p.drop_key(key)
                    continue
                if p.val_pos is None:
                    continue
                cells = ev.cells
                val = (
                    cells[p.val_pos] if len(cells) > p.val_pos else None
                )
                waiting = p.pending.get(key)
                if not waiting or val is None:
                    continue
                hit = next(
                    (i for i, (v, _, _) in enumerate(waiting)
                     if v == val), None,
                )
                if hit is None:
                    continue
                # older writes to the key were coalesced into this one
                coalesced += hit
                v, commit_round, wall0 = waiting[hit]
                del waiting[: hit + 1]
                if not waiting:
                    p.pending.pop(key, None)
                emit_round = (
                    ev.round if ev.round is not None
                    else cluster._rounds_ticked
                )
                lat_rounds.append(float(max(emit_round - commit_round, 0)))
                lat_secs.append(max(now - wall0, 0.0))
                observed += 1

    def fan_queries() -> None:
        nonlocal qi
        for _ in range(queries_per_round):
            surface = surfaces[qi % len(surfaces)]
            node = qi % n
            sql = "SELECT id, val FROM services WHERE val >= 0"
            qi += 1
            if surface == "direct":
                cluster.query_rows(sql, node=node)
            elif surface == "http":
                api_client.query_rows(sql, node=node)
            else:
                pg_client.query(sql)
            queries[surface] += 1

    # ---- the load loop ---------------------------------------------------
    try:
        for r in range(workload.rounds):
            t0 = cluster._rounds_ticked
            commit_round = t0 + 1
            wall0 = time.perf_counter()
            for i in range(n):
                if not workload.writers[r, i]:
                    continue
                key = int(workload.rows[r, i])
                if workload.dels[r, i]:
                    cluster.execute(
                        [f"DELETE FROM services WHERE id = {key}"],
                        node=i, wait=False,
                    )
                    deletes += 1
                    writes += 1
                    continue
                val = next_val
                next_val += 1
                cluster.execute(
                    [
                        f"INSERT INTO services (id, node, val) "
                        f"VALUES ({key}, {i}, {val})"
                    ],
                    node=i, wait=False,
                )
                writes += 1
                for p in probes:
                    p.expect(key, val, commit_round, wall0)
            cluster.tick(1)
            drain()
            fan_queries()
        # ---- settle: drain the cluster, keep harvesting deliveries ------
        settled = 0
        drained = False
        while settled < settle_rounds:
            cluster.tick(1)
            settled += 1
            drain()
            if cluster.converged:
                drained = True
                break
    finally:
        for c in (api_client, pg_client):
            if c is not None:
                try:
                    c.close()
                except Exception:
                    pass
        for srv in (api_srv, pg_srv):
            if srv is not None:
                srv.close()

    # everything still pending after the settle phase was coalesced away
    for p in probes:
        coalesced += sum(len(v) for v in p.pending.values())
        p.pending.clear()

    # ---- metrics + report ------------------------------------------------
    hist.observe_many(SUB_LATENCY_ROUNDS, lat_rounds,
                      help_=SUB_LATENCY_ROUNDS_HELP,
                      buckets=ROUNDS_BUCKETS)
    hist.observe_many(SUB_LATENCY_SECONDS, lat_secs,
                      help_=SUB_LATENCY_SECONDS_HELP)
    counters.inc(WORKLOAD_WRITES_TOTAL, n=writes - deletes,
                 labels='{kind="write"}',
                 help_="workload schedule ops committed through the live "
                       "write path, by kind")
    counters.inc(WORKLOAD_WRITES_TOTAL, n=deletes,
                 labels='{kind="delete"}',
                 help_="workload schedule ops committed through the live "
                       "write path, by kind")
    counters.inc(WORKLOAD_ROUNDS_TOTAL, n=workload.rounds,
                 help_="load-phase rounds driven by the live harness")
    counters.inc(WORKLOAD_COALESCED_TOTAL, n=coalesced,
                 help_="writes a subscriber never saw individually "
                       "(matcher-diff coalescing)")
    for s, cnt in queries.items():
        counters.inc(WORKLOAD_QUERIES_TOTAL, n=cnt,
                     labels=f'{{surface="{s}"}}',
                     help_="one-shot queries fanned by the load harness, "
                           "by surface")
    rounds_h = hist.get(SUB_LATENCY_ROUNDS)
    secs_h = hist.get(SUB_LATENCY_SECONDS)
    report = LoadReport(
        spec=workload.spec,
        nodes=n,
        rounds=workload.rounds,
        settle_rounds=settled,
        matchers=len(matcher_ids),
        subscriptions=streams,
        writes=writes,
        deletes=deletes,
        observed=observed,
        coalesced=coalesced,
        queries=queries,
        latency_rounds=_quantiles(rounds_h),
        latency_seconds=_quantiles(secs_h),
        drained=drained,
        wall_seconds=round(time.perf_counter() - t_start, 3),
    )
    cluster.workload_report = {"live": report.as_json()}
    return report
