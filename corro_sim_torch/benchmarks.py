"""The JAX package's benchmark configurations, run through the port.

Port of ``corro_sim/benchmarks.py``, one configuration at a time. So far:
config 1, the devcluster analog (``corro_sim/benchmarks.py:392-444``):
N live agents, a single-table schema, 1k INSERTs through the real write
path, then convergence. Its 64-agent form is the devcluster leg of the
north-star bench (``corro_sim/benchmarks.py:195-240``).
"""

from __future__ import annotations

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
