"""The JAX package's benchmark configurations, run through the port.

Port of ``corro_sim/benchmarks.py``, one configuration at a time. So far:

- config 1, the devcluster analog (``corro_sim/benchmarks.py:392-444``):
  N live agents, a single-table schema, 1k INSERTs through the real
  write path, then convergence. Its 64-agent form is the devcluster leg
  of the north-star bench (``corro_sim/benchmarks.py:195-240``);
- config 6, the production workload leg (``corro_sim/benchmarks.py:
  761-858``): Zipf + churn traffic through ``run_sim(workload=)`` at
  10 000 nodes, and the same schedule as SQL through a LiveCluster with
  1024 subscribers at min(N, 256) nodes (``workload/harness.py``).
"""

from __future__ import annotations

import os
import time

CONFIG1_SCHEMA = """
    CREATE TABLE t (
        id INTEGER NOT NULL PRIMARY KEY,
        v TEXT NOT NULL DEFAULT ''
    );
    """


def config1_run(cluster_cls, inserts: int = 1000, nodes: int = 3,
                **cluster_kw) -> dict:
    """Config 1's recipe on a ``LiveCluster`` class (this port's, or any
    class with its API, such as the JAX package's for the parity tests
    and pins): build, warm up outside the timed window, load every
    agent's statement queue, and drain them together to convergence.
    Returns the cluster, the converged round count and the wall."""
    cluster = cluster_cls(
        CONFIG1_SCHEMA, num_nodes=nodes,
        default_capacity=max(inserts + 16, 64),
        cfg_overrides={"log_capacity": max(2 * inserts, 1024)},
        **cluster_kw,
    )
    # warm-up outside the timed window: the single round, the chunk and
    # the remap path
    cluster.execute(["INSERT INTO t (id, v) VALUES (0, 'warm')"])
    cluster.warmup()
    # multi-row INSERTs: one transaction = one changeset (clients batch
    # statements into /v1/transactions the same way); each agent drains
    # one changeset per round, so spread them round-robin
    rows_per_stmt = max(cluster.cfg.seqs_per_version, 1)
    stmts = []
    for start in range(1, inserts + 1, rows_per_stmt):
        values = ", ".join(
            f"({i}, 'w{i}')"
            for i in range(start, min(start + rows_per_stmt, inserts + 1))
        )
        stmts.append(f"INSERT INTO t (id, v) VALUES {values}")
    t0 = time.perf_counter()
    # every agent has its statement queue loaded (wait=False plans and
    # enqueues without draining), then all queues drain together: one
    # changeset per node per round, like N agents committing concurrently
    for node in range(nodes):
        batch = stmts[node::nodes]
        if batch:
            cluster.execute(batch, node=node, wait=False)
    converged = cluster.run_until_converged(max_rounds=4096)
    wall = time.perf_counter() - t0
    return {"cluster": cluster, "converged_round": converged, "wall": wall}


def config1_report(run: dict, inserts: int, nodes: int) -> dict:
    """The JAX package's ``run_config_1`` dict of a :func:`config1_run`,
    plus the converged round count."""
    wall = run["wall"]
    return {
        "metric": f"devcluster_{nodes}_agents_{inserts}_inserts_wall_s",
        "value": round(wall, 3),
        "unit": "s",
        "inserts_per_sec": round(inserts / wall, 1),
        "per_insert_ms": round(1000.0 * wall / inserts, 3),
        "converged": run["converged_round"] is not None,
        "converged_round": run["converged_round"],
    }


def run_config_1(inserts: int = 1000, nodes: int = 3, device=None) -> dict:
    """Config 1 on ``device`` (``None``: CUDA): the JAX package's
    ``run_config_1`` dict plus the converged round count."""
    from corro_sim_torch.harness.cluster import LiveCluster

    return config1_report(
        config1_run(LiveCluster, inserts, nodes, device=device),
        inserts, nodes)


CONFIG6_SPEC = ("zipf:alpha=1.1,rate=0.3,keys=2048"
                "+churn_storm:waves=6,batch=64,keys=2048")


def config6_live_args(subs: int = 1024, sub_queries: int = 64,
                      queries_per_round: int = 4) -> dict:
    """``run_live_load``'s arguments for config 6's live half: ``subs``
    subscriber streams over ``sub_queries`` matchers, 64 of them
    latency-tracked, ``queries_per_round`` one-shot queries, seed 0 and
    a settle budget of 512 rounds."""
    return dict(
        subs=sub_queries,
        subscribers_per_sub=max(1, subs // max(sub_queries, 1)),
        latency_subs=64, queries_per_round=queries_per_round, seed=0,
        settle_rounds=512,
    )


def config6_live_run(nodes: int = 256, rounds: int = 64,
                     spec: str = CONFIG6_SPEC, *, subs: int = 1024,
                     sub_queries: int = 64, queries_per_round: int = 4,
                     device=None, default_capacity: int | None = None,
                     cluster_cls=None, run=None, workload=None,
                     **live_kw):
    """Config 6's live half at ``nodes`` nodes: the schedule made with
    seed 0, its cluster built and warmed as ``run_live_load`` builds it
    (``cluster_cls``, ``run`` and ``workload``: another LiveCluster
    class, ``run_live_load`` and schedule, such as the JAX package's for
    its pins), then driven with :func:`config6_live_args` and ``live_kw``
    (``http=``, ``pg=``). Returns ``(report, cluster)``."""
    from corro_sim_torch.workload import make_workload
    from corro_sim_torch.workload.harness import load_cluster, run_live_load

    args = dict(config6_live_args(subs, sub_queries, queries_per_round),
                **live_kw)
    wl = workload or make_workload(spec, nodes, rounds=rounds, seed=0)
    cluster = load_cluster(wl, seed=args["seed"],
                           default_capacity=default_capacity,
                           device=device, cluster_cls=cluster_cls)
    report = (run or run_live_load)(wl, cluster=cluster, **args)
    return report, cluster


def run_config_6(nodes: int | None = None, subs: int | None = None,
                 rounds: int | None = None, device=None) -> dict:
    """Config 6 on ``device`` (``None``: CUDA): the JAX package's
    ``run_config_6`` dict. The batched half runs ``run_sim(workload=)``
    at ``CORRO_BENCH_NODES`` (default 10 000); the live half drives the
    same schedule through a LiveCluster at ``CORRO_BENCH_LIVE_NODES``
    (default min(nodes, 256)) with ``CORRO_BENCH_SUBS`` (1024) streams
    over ``CORRO_BENCH_SUB_QUERIES`` (64) matchers and reports the
    sub-delivery p50/p99. The batched dict leaves out the JAX package's
    compile fields (the port compiles nothing) and carries the port's
    setup seconds instead."""
    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.device import resolve_device
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.workload import make_workload

    device = resolve_device(device)
    n = nodes or int(os.environ.get("CORRO_BENCH_NODES", "10000"))
    rounds = rounds or int(os.environ.get("CORRO_BENCH_ROUNDS", "64"))
    spec = os.environ.get("CORRO_BENCH_WORKLOAD", CONFIG6_SPEC)
    subs_n = subs or int(os.environ.get("CORRO_BENCH_SUBS", "1024"))
    sub_queries = int(os.environ.get("CORRO_BENCH_SUB_QUERIES", "64"))
    live_n = int(os.environ.get(
        "CORRO_BENCH_LIVE_NODES", str(min(n, 256))
    ))

    # ---- batched: convergence under storm at full scale -----------------
    wl = make_workload(spec, n, rounds=rounds, seed=0)
    cfg = SimConfig(
        num_nodes=n,
        num_rows=max(wl.key_universe(), 256),
        num_cols=2,
        log_capacity=max(rounds * 2, 256),
        pend_slots=8,
        emit_slots=4,
        fanout=3,
        sync_interval=4,
        sync_adaptive=True,
    ).validate()
    t0 = time.perf_counter()
    res = run_sim(
        cfg, init_state(cfg, seed=0, device=device), max_rounds=4096,
        chunk=8, seed=0, workload=wl, device=device,
    )
    batched = {
        "nodes": n,
        "spec": wl.spec,
        "schedule_writes": wl.total_writes,
        "schedule_deletes": wl.total_deletes,
        "converged_round": res.converged_round,
        "rounds_run": res.rounds,
        "wall_per_round_ms": round(res.wall_per_round_ms, 3),
        "changes_applied": int(res.metrics["fresh"].sum())
        + int(res.metrics["sync_versions"].sum()),
        "workload_events": len(wl.events),
        "pipeline": res.pipeline,
        "wall_seconds": round(time.perf_counter() - t0, 1),
        "setup_seconds": round(res.setup_seconds, 3),
    }
    del res

    # ---- live: sub-delivery latency under the same traffic shape --------
    report, _ = config6_live_run(
        live_n, rounds, spec, device=device, subs=subs_n,
        sub_queries=sub_queries,
        queries_per_round=int(
            os.environ.get("CORRO_BENCH_QUERIES_PER_ROUND", "4")),
    )
    live = report.as_json()
    return {
        "metric": "workload_engine_zipf_churn",
        "value": live["latency_rounds"]["p99"],
        "unit": "sub_delivery_p99_rounds",
        "converged": batched["converged_round"] is not None,
        "batched": batched,
        "live": live,
    }
