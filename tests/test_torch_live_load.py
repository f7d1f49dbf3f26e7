"""Parity of the port's live load harness and config 6's live half with
the JAX package's on the CPU.

``run_live_load`` drives config 6's Zipf + churn schedule as SQL through
a LiveCluster of each package, with subscriber streams over matchers on
observer nodes and one-shot queries fanned over the direct, HTTP and
pgwire surfaces (real servers on loopback). The ``LoadReport``s must be
equal apart from their seconds (the wall and the seconds quantiles; the
seconds histogram's sample count is held), the clusters equal leaf for
leaf, and the pinned record (``profile_slice.live_load_record``) equal.
``run_config_6`` at a small size returns the JAX package's dict, but for
the JAX package's compile fields. The 256-node pins
(``profile_slice.CONFIG6_LIVE_PINS``, ``SERVE_256_PINS``) are held on
the card by chip_smoke.py; :func:`jax_config6_live_pins` is their
recipe. Queries across respaces of the value universe answer alike
though the port empties its query cache there. Tolerance: exact.
"""

import jax
import pytest

import corro_sim.benchmarks as r_benchmarks
import corro_sim.harness.cluster as r_cluster
import corro_sim.workload.harness as r_harness
from corro_sim.workload import make_workload as r_make_workload
from corro_sim.workload.harness import SERVICES_SCHEMA as R_SCHEMA
from corro_sim_torch import profile_slice as ps
from corro_sim_torch.benchmarks import (
    CONFIG6_SPEC,
    config6_live_run,
    run_config_6,
)
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.workload.harness import SERVICES_SCHEMA
from test_torch_cluster import (  # noqa: F401 - a module fixture
    BOTH, assert_same_cluster, one_torch_thread, ref_leaves)


def untimed_report(rep: dict) -> dict:
    """A LoadReport's JSON without its seconds."""
    out = dict(rep)
    out.pop("wall_seconds")
    out["latency_seconds"] = {"count": rep["latency_seconds"]["count"]}
    return out


def both_runs(nodes: int, rounds: int, **kw) -> dict:
    """Config 6's live half at ``nodes`` nodes on each package:
    ``{package: (report JSON, cluster)}``."""
    ref_wl = r_make_workload(CONFIG6_SPEC, nodes, rounds=rounds, seed=0)
    rep, c = config6_live_run(
        nodes, rounds, cluster_cls=r_cluster.LiveCluster,
        run=r_harness.run_live_load, workload=ref_wl, **kw)
    out = {"ref": (rep.as_json(), c)}
    rep, c = config6_live_run(nodes, rounds, device="cpu", **kw)
    out["port"] = (rep.as_json(), c)
    return out


SURFACES = {
    "direct": dict(subs=128, sub_queries=16),
    "http_pg": dict(subs=128, sub_queries=16, http=True, pg=True),
    "http_pg_2048_slots": dict(subs=64, sub_queries=8, http=True, pg=True,
                               default_capacity=2048),
}


@pytest.mark.parametrize("case", sorted(SURFACES))
def test_live_load_matches_the_jax_package(case):
    runs = both_runs(32, 16, **SURFACES[case])
    (rrep, rc), (prep, pc) = runs["ref"], runs["port"]
    assert untimed_report(prep) == untimed_report(rrep)
    assert prep["observed"] > 0 and prep["drained"]
    surfaces = {"direct"} | ({"http", "pg"} if "http" in case else set())
    assert set(prep["queries"]) == surfaces
    assert all(n > 0 for n in prep["queries"].values())
    assert ps.live_load_record(prep, state_to_numpy(pc.state)) == \
        ps.live_load_record(rrep, ref_leaves(rc.state))
    assert pc.workload_report == {"live": prep}
    assert_same_cluster(rc, pc)
    for c in (rc, pc):
        c.tripwire.trip()


def jax_config6_live_pins() -> dict:
    """The recipe of ``profile_slice.CONFIG6_LIVE_PINS`` and
    ``SERVE_256_PINS``: chip_smoke.py's "config6_live" and "serve_256"
    runs (``config6_live_run`` at ``CONFIG6_LIVE_NODES`` nodes, the
    second with ``SERVE_RUN``) on the JAX package's LiveCluster,
    ``run_live_load`` and schedule on the CPU, recorded by
    ``live_load_record`` (about 140 s each)."""
    out = {}
    for name, kw in (("config6_live", {}), ("serve_256", ps.SERVE_RUN)):
        n = ps.CONFIG6_LIVE_NODES
        rep, c = config6_live_run(
            n, cluster_cls=r_cluster.LiveCluster,
            run=r_harness.run_live_load,
            workload=r_make_workload(CONFIG6_SPEC, n, rounds=64, seed=0),
            **kw)
        out[name] = ps.live_load_record(rep.as_json(), ref_leaves(c.state))
    return out


def test_pins_hold_one_run_on_three_surfaces():
    """The two pins are one schedule and one outcome: they differ only
    in where the one-shot queries went and in the table's slot count."""
    a, b = ps.CONFIG6_LIVE_PINS, ps.SERVE_256_PINS
    assert set(a) == set(b) == set(ps.LIVE_LOAD_FIELDS) | {
        "latency_rounds", "table"}
    assert {k for k in a if a[k] != b[k]} == {"queries", "table"}
    assert sum(a["queries"].values()) == sum(b["queries"].values()) == 256
    assert a["subscriptions"] == 1024 and a["matchers"] == 64


def test_run_config_6_matches_the_jax_package(monkeypatch):
    """``run_config_6`` at 32 nodes, 8 load rounds and 64 subscribers:
    the batched half's outcome and the live half's report equal the JAX
    package's (the JAX package's compile fields and the port's setup
    seconds apart)."""
    monkeypatch.setenv("CORRO_BENCH_SUB_QUERIES", "8")
    got = run_config_6(nodes=32, subs=64, rounds=8, device="cpu")
    want = r_benchmarks.run_config_6(nodes=32, subs=64, rounds=8)
    for k in ("metric", "value", "unit", "converged"):
        assert got[k] == want[k], k
    same = ("nodes", "spec", "schedule_writes", "schedule_deletes",
            "converged_round", "rounds_run", "changes_applied",
            "workload_events")
    assert {k: got["batched"][k] for k in same} == \
        {k: want["batched"][k] for k in same}
    assert untimed_report(got["live"]) == untimed_report(want["live"])


def test_jax_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"


def test_queries_across_respaces_match_the_jax_package():
    """A respace of the value universe empties the port's one-shot query
    cache (the JAX package rebinds every cached matcher instead): queries
    on many nodes, interleaved with writes of ever larger integers that
    force respaces, answer as the JAX package's do."""
    assert SERVICES_SCHEMA == R_SCHEMA
    answers, clusters = {}, {}
    for B in BOTH:
        c = B.LiveCluster(SERVICES_SCHEMA, num_nodes=8, seed=2,
                          default_capacity=64)
        out = []
        for i in range(160):
            c.execute([f"INSERT INTO services (id, node, val) VALUES "
                       f"({i % 48}, {i % 8}, {i * 1000})"],
                      node=i % 8, wait=i % 16 == 0)
            if i % 5 == 0:
                c.tick(1)
                out.append(c.query_rows(
                    "SELECT id, val FROM services WHERE val >= 5000",
                    node=i % 8))
                out.append(c.query_rows(
                    f"SELECT id, node FROM services WHERE node = {i % 3}",
                    node=(i + 1) % 8))
        answers[B.key], clusters[B.key] = out, c
    assert answers["port"] == answers["ref"]
    assert clusters["port"].universe.version > 1
    assert len(clusters["port"]._query_cache) < 16
    assert_same_cluster(clusters["ref"], clusters["port"])
