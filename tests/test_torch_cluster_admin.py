"""Parity of the port's LiveCluster admin, scenario and introspection
calls with the JAX package's on the CPU (tests/test_torch_cluster.py
holds the helpers and the reference cases): scenarios armed, cleared and
split into single rounds inside a chunk, nodes down and rejoined,
cluster ids, partitions, reconcile_gaps, members, the lag observatory,
table stats, actor versions and the probe report, under full-view SWIM
and under windowed SWIM with the probe tracer. Every returned value, the
class and message of every error, and the whole cluster after the case
must agree. Tolerance: exact.
"""

import pytest

from test_torch_cluster import (  # noqa: F401 - a module fixture
    BOTH, KV, both, one_torch_thread, outcome, queue_writes)


def case_admin(B, c):
    out = {}
    queue_writes(c, 24, c.cfg.num_nodes)
    out["first"] = c.run_until_converged(max_rounds=128)
    out["load"] = c.load_scenario("lossy:p=0.3", rounds=16)
    queue_writes(c, 12, c.cfg.num_nodes)
    c.tick(3)
    out["during"] = c.fault_report()
    out["clear"] = c.clear_scenario()
    # a timeline that varies inside a chunk runs it as single rounds
    out["flapper"] = c.load_scenario("flapper:frac=0.25,period=3",
                                     rounds=24)
    queue_writes(c, 12, c.cfg.num_nodes)
    c.tick(32)
    out["chunks"] = c._chunk_dispatches
    c.clear_scenario()
    c.set_alive(2, False)
    c.tick(12)
    out["members_down"] = c.members()
    out["node_lag"] = c.node_lag(top_k=3)
    out["suspected"] = c._suspected_by()
    out["rejoin"] = c.rejoin(2)
    out["rejoin_again"] = c.rejoin(2)
    out["set_id"] = c.set_cluster_id(1, 7)
    c.tick(2)
    c.set_cluster_id(1, 0)
    c.set_partition([0] * c.cfg.num_nodes)
    out["reconcile"] = c.reconcile_gaps()
    out["converged"] = c.run_until_converged(max_rounds=256)
    out["members"] = c.members()
    out["stats"] = c.table_stats()
    out["versions"] = [c.actor_versions(a) for a in range(c.cfg.num_nodes)]
    out["probes"] = c.probe_report()
    out["stages"] = sorted(c.stage_timings())
    out["errors"] = [outcome(c.set_cluster_id, 0, 2 ** 16),
                     outcome(c.actor_versions, 99)]
    return out


@pytest.mark.parametrize("swim", [
    {"swim_enabled": True, "swim_suspect_rounds": 3},
    {"swim_enabled": True, "swim_view_size": 4, "narrow_state": True,
     "probes": 2},
], ids=["full_view", "windowed_probes"])
def test_admin_scenarios_and_introspection(swim):
    pair = {B.key: B.LiveCluster(KV, num_nodes=8, seed=5,
                                 default_capacity=48, cfg_overrides=swim)
            for B in BOTH}
    out = both(pair, case_admin)
    assert out["rejoin"]["incarnation"] >= 1
    assert out["rejoin_again"]["incarnation"] == (
        out["rejoin"]["incarnation"] + 1)
    assert out["errors"][0][0] == "ExecError"


def case_log_wrap(B, c):
    """More versions than the changelog ring holds while a node is away:
    the ring-wrap
    tripwire latches, convergence is never reported, and the flight
    record carries the wrap's round."""
    c.set_alive(1, False)  # a node away while node 0 writes past the ring
    for i in range(24):
        c.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)",
                    [f"w{i}", f"v{i}", i]]], node=0, wait=False)
    c.tick(30)
    c.set_alive(1, True)
    return (c.run_until_converged(max_rounds=64), c.log_poisoned,
            c.run_until_converged(max_rounds=8),
            [e for e in c.flight.events() if e["name"] == "log_wrapped"])


def test_log_wrap_poisons_the_cluster():
    pair = {B.key: B.LiveCluster(KV, num_nodes=3, seed=6,
                                 default_capacity=32,
                                 cfg_overrides={"log_capacity": 8})
            for B in BOTH}
    out = both(pair, case_log_wrap)
    assert out[0] is None and out[1] is True and out[2] is None
    assert len(out[3]) == 1
