"""The device mesh on gloo ranks: ``engine/sharding.py``, the mesh forms
of the merge (``route_merge_sharded``, ``merge_grouped(mesh=)``),
``run_sim(mesh=)`` and ``run_sweep(mesh=)`` against the JAX package.

The port's ranks are processes (``engine/ranks.py``): each test spawns
its ranks once and runs several jobs of ``engine/mesh_jobs.py`` in them.
Tolerance: bit-for-bit equality — every state leaf and every per-round
metric of an 8-rank run equals the JAX package's one-device run (and the
port's), as ``tests/test_multichip.py`` holds the JAX package's 8-device
runs. The JAX package's own mesh runs on the conftest's 8 host devices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.config import FaultConfig as RefFaultConfig
from corro_sim.config import SimConfig as RefSimConfig
from corro_sim.core.merge_kernel import grouped_merge as ref_grouped_merge
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.sharding import make_mesh as ref_make_mesh
from corro_sim.engine.sharding import state_shardings as ref_state_shardings
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim_torch import config as pconfig
from corro_sim_torch.core.merge_kernel import (
    grouped_merge_reference,
    route_lanes,
    sharded_kernel_downgrade,
)
from corro_sim_torch.engine import sharding as psh
from corro_sim_torch.engine.mesh_jobs import batch, random_lanes, sweep_job
from corro_sim_torch.engine.ranks import run_ranks
from corro_sim_torch.engine.state import init_state
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

RANKS = 8
TIMEOUT = 300  # seconds a spawn may take before its ranks are killed

BASE_KW = dict(num_nodes=16, num_rows=8, num_cols=2, log_capacity=64)
KERNEL_KW = dict(num_nodes=16, num_rows=64, num_cols=2, log_capacity=64,
                 merge_kernel="on", sync_interval=4)
RUN_KW = dict(max_rounds=16, chunk=8, seed=9, stop_on_convergence=False)
PIPE_KW = dict(max_rounds=40, chunk=8, seed=5, min_rounds=24)
WL = ("zipf:alpha=1.1,rate=0.5,keys=8", 6, 4)

# name -> (config fields, run_sim arguments, workload)
CASES = {
    "actor": (dict(BASE_KW, shard_log=True), RUN_KW, None),
    "repl": (dict(BASE_KW, shard_log=False), RUN_KW, None),
    "off": (dict(BASE_KW, shard_log=True, merge_kernel="off"), RUN_KW,
            None),
    "kernel": (dict(KERNEL_KW, shard_log=True), RUN_KW, None),
    "kernel_auto": (dict(KERNEL_KW, shard_log=True, merge_kernel="auto"),
                    RUN_KW, None),
    "pipe": (dict(BASE_KW, shard_log=True), dict(PIPE_KW, pipeline=True),
             None),
    "narrow": (dict(BASE_KW, shard_log=True, swim_enabled=True,
                    swim_view_size=8, sync_interval=4, narrow_state=True),
               RUN_KW, None),
    "full_swim": (dict(BASE_KW, swim_enabled=True, sync_interval=4,
                       swim_payload_members=6), RUN_KW, None),
    "lossy": (dict(BASE_KW, shard_log=True,
                   faults=dict(loss=0.2)), RUN_KW, None),
    "workload": (dict(BASE_KW, shard_log=True), RUN_KW, WL),
    "latency": (dict(BASE_KW, latency_regions=2, latency_inter=3,
                     rtt_rings=True, probes=4, sync_hot_actors=0,
                     sync_interval=2), RUN_KW, None),
}


def _ref_cfg(fields: dict) -> RefSimConfig:
    fields = dict(fields)
    faults = fields.pop("faults", None)
    if faults is not None:
        fields["faults"] = RefFaultConfig(**faults)
    return RefSimConfig(**fields).validate()


def _port_cfg(fields: dict) -> pconfig.SimConfig:
    return pconfig.sim_config_from_dict(
        dataclasses.asdict(_ref_cfg(fields)))


@pytest.fixture(scope="module")
def mesh_runs():
    """Every case's 8-rank run, from one spawn of the ranks."""
    calls = [("run_sim_job",
              (dataclasses.asdict(_port_cfg(fields)), kw["seed"], kw),
              {"workload_spec": wl})
             for fields, kw, wl in CASES.values()]
    got = run_ranks(batch, RANKS, calls, timeout=TIMEOUT)
    return dict(zip(CASES, got))


_REF_CACHE: dict = {}


def ref_run(name: str, mesh=None):
    """The JAX package's run of ``CASES[name]`` (one device unless
    ``mesh``), cached for the module."""
    key = (name, mesh is not None)
    if key not in _REF_CACHE:
        fields, kw, wl = CASES[name]
        cfg = _ref_cfg(fields)
        workload = None
        if wl is not None:
            from corro_sim.workload import make_workload

            workload = make_workload(wl[0], cfg.num_nodes, rounds=wl[1],
                                     seed=wl[2])
        kw = dict(kw)
        if "pipeline" in kw:
            kw["pipeline"] = False
        _REF_CACHE[key] = ref_run_sim(
            cfg, ref_init_state(cfg, seed=kw["seed"]),
            RefSchedule(write_rounds=8), workload=workload,
            mesh=ref_make_mesh() if mesh else None, **kw)
    return _REF_CACHE[key]


def ref_leaves(state) -> dict:
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(state)[0]}


def assert_equal_to_reference(ref, got):
    """Every per-round metric and every state leaf, bit for bit, plus the
    convergence round and the repair chunks."""
    assert got["converged_round"] == ref.converged_round
    assert got["repair_chunks"] == ref.repair_chunks
    assert sorted(got["metrics"]) == sorted(ref.metrics)
    for k, v in ref.metrics.items():
        np.testing.assert_array_equal(got["metrics"][k], np.asarray(v),
                                      err_msg=k)
    want = ref_leaves(ref.state)
    assert sorted(got["state"]) == sorted(want)
    for k, v in want.items():
        assert got["state"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["state"][k], v, err_msg=k)


# ------------------------------------------------ the merge's mesh forms

MERGE_SHAPE = dict(seed=3, n=16, cells=128, cap=128, m=2403)
_MERGE_CACHE: dict = {}


def merge_runs(d: int) -> dict:
    if d not in _MERGE_CACHE:
        args = tuple(MERGE_SHAPE.values())
        got = run_ranks(batch, d, [("merge_job", ("route",) + args, {}),
                                    ("merge_job", ("grouped",) + args, {})],
                        timeout=TIMEOUT)
        _MERGE_CACHE[d] = dict(zip(("route", "grouped"), got))
    return _MERGE_CACHE[d]


@pytest.fixture(scope="module")
def merge_references():
    """The plain merge on one device and the JAX package's kernel in
    interpret mode, on the same lanes."""
    seed, n, cells, cap, m = MERGE_SHAPE.values()
    planes, lanes, cols = random_lanes(seed, n, cells, cap, m)
    lt = {k: torch.as_tensor(v) for k, v in lanes.items()}
    box = route_lanes(lt["dst"], lt["rank"], lt["cell"], lt["cv"], lt["vr"],
                      lt["site"], lt["cl"], lt["valid"], n, cap)
    plain = dict(zip(("cv", "vr", "site", "cl"), (
        x.numpy() for x in grouped_merge_reference(
            *(torch.as_tensor(planes[k]) for k in ("cv", "vr", "site",
                                                    "cl")),
            box, cap, cols))))
    # the JAX package's 8-row mailbox: the six fields, two pad rows
    box8 = np.zeros((8, n * cap), np.int32)
    box8[:6] = box.numpy()
    out = ref_grouped_merge(
        jnp.asarray(planes["cv"]), jnp.asarray(planes["vr"]),
        jnp.asarray(planes["site"]),
        jnp.asarray(np.repeat(planes["cl"], cols, axis=1)),
        jnp.asarray(box8), cap, cols, interpret=True)
    jx = dict(zip(("cv", "vr", "site", "cl"), (np.asarray(x) for x in out)))
    jx["cl"] = jx["cl"][:, ::cols]
    # the lanes exercise what the routing must get right
    keep = lanes["valid"] & (lanes["rank"] < cap)
    assert (lanes["valid"] & (lanes["rank"] >= cap)).any()  # over cap
    assert (~lanes["valid"]).any()  # invalid
    assert m % RANKS  # padded to a multiple of every D
    for k in plain:
        assert np.array_equal(plain[k], jx[k]), k
    return plain, keep


@pytest.mark.parametrize("kind", ["route", "grouped"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_merge_equals_plain_and_jax(d, kind, merge_references):
    """``route_merge_sharded`` (lanes from every shard, routed by one
    all_to_all) and ``merge_grouped(mesh=)`` (node-major mailbox slices,
    no collective) at D = 2, 4 and 8 equal the plain merge on one device
    and the JAX package's kernel, bit for bit."""
    plain, keep = merge_references
    got = merge_runs(d)[kind]
    # cross-shard lanes: some shard's lanes go to another shard
    planes, lanes, _ = random_lanes(*MERGE_SHAPE.values())
    ml = -(-len(lanes["dst"]) // d)
    src_shard = np.arange(len(lanes["dst"])) // ml
    assert (keep & (lanes["dst"] // (16 // d) != src_shard)).any()
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


def test_sharded_kernel_downgrade_reasons():
    """The port's gate: CUDA planes keep the kernel under "auto", the
    CPU's ranks downgrade with ``sharded_non_cuda``; the shape reasons
    and an operator's "off" are the JAX package's."""
    base = pconfig.SimConfig(num_nodes=16, num_rows=64, num_cols=2)
    auto = dataclasses.replace(base, merge_kernel="auto")
    assert sharded_kernel_downgrade(auto, 8, "cpu") == "sharded_non_cuda"
    assert sharded_kernel_downgrade(auto, 8, "cuda") is None
    assert sharded_kernel_downgrade(
        dataclasses.replace(base, merge_kernel="on"), 8, "cpu") is None
    assert sharded_kernel_downgrade(
        dataclasses.replace(base, merge_kernel="off"), 8, "cpu") is None
    assert sharded_kernel_downgrade(
        dataclasses.replace(base, num_rows=8), 8, "cuda") == \
        "cell_space_unaligned"
    assert sharded_kernel_downgrade(
        dataclasses.replace(base, num_nodes=12), 8, "cuda") == \
        "uneven_node_shards"


# ------------------------------------------------------- placement


def test_explicit_shard_log_override_and_specs_match_the_jax_package():
    """``resolve_shard_log`` and ``state_shardings`` give the JAX
    package's regime and ``PartitionSpec`` for every leaf, both log
    regimes, at the BASE shape and past ``SHARD_LOG_ACTORS``."""
    small, big = 64, psh.SHARD_LOG_ACTORS
    assert psh.resolve_shard_log(num_actors=small) is False
    assert psh.resolve_shard_log(num_actors=big) is True
    assert psh.resolve_shard_log(num_actors=small, shard_log=True) is True
    assert psh.resolve_shard_log(num_actors=big, shard_log=False) is False
    mesh = psh.Mesh(("nodes",), {"nodes": 8}, {"nodes": 0}, None, "cpu")
    rmesh = ref_make_mesh()
    for fields in (BASE_KW, dict(BASE_KW, swim_enabled=True, probes=2,
                                 rtt_rings=True),
                   dict(BASE_KW, num_nodes=big)):
        cfg = _ref_cfg(fields)
        rstate = jax.eval_shape(lambda: ref_init_state(cfg, seed=0))
        pstate = init_state(_port_cfg(fields), seed=0, device="meta")
        for shard_log in (None, True, False):
            want = {
                jax.tree_util.keystr(p).lstrip("."): tuple(s.spec)
                for p, s in jax.tree_util.tree_flatten_with_path(
                    ref_state_shardings(rstate, rmesh, cfg.num_nodes,
                                        shard_log=shard_log))[0]}
            got = {k: p.spec for k, p in psh._specs(psh.state_shardings(
                pstate, mesh, cfg.num_nodes, shard_log=shard_log)).items()}
            assert got == want, shard_log


def test_state_bytes_breakdown_log_share_drops_with_mesh():
    cfg = pconfig.SimConfig(num_nodes=4096, num_rows=128, num_cols=2,
                            log_capacity=256)
    sharded = psh.state_bytes_breakdown(cfg, sharded_over=8, shard_log=True)
    repl = psh.state_bytes_breakdown(cfg, sharded_over=8, shard_log=False)
    assert sharded["log"]["placement"] == "actor_sharded"
    assert repl["log"]["placement"] == "replicated"
    assert sharded["log"]["total"] == repl["log"]["total"]
    assert sharded["log"]["per_device"] * 8 == repl["log"]["per_device"]
    assert sharded["book"]["per_device"] * 8 == sharded["book"]["total"]


def test_no_rank_rebuilds_an_n_by_n_plane():
    """The placement rule inside a round: a dispatch mode records every
    tensor the mesh rounds allocate on every rank (full-view SWIM, RTT
    rings, probes, the kernel forced, the actor-sharded log, sync every
    other round). On 8 ranks none has two axes of length N; on one rank,
    the control, the same rounds build (N, N) planes."""
    cfg = _port_cfg(dict(
        num_nodes=96, num_rows=64, num_cols=2, log_capacity=64,
        swim_enabled=True, rtt_rings=True, merge_kernel="on",
        sync_interval=2, shard_log=True, probes=2, sync_need_sample=16,
        sync_hot_actors=32))
    args = (dataclasses.asdict(cfg), 3, 6)
    eight = run_ranks(batch, RANKS, [("placement_job", args, {})],
                      timeout=TIMEOUT)[0]
    one = run_ranks(batch, 1, [("placement_job", args, {})],
                    timeout=TIMEOUT)[0]
    assert eight["allocations"] > 1000
    assert eight["max_n_axes"] <= 1, eight["shapes"]
    assert one["max_n_axes"] == 2


SHARD_BUILD_CASES = {
    "full_swim_rtt_stale": dict(
        num_nodes=32, num_rows=8, num_cols=2, log_capacity=16,
        swim_enabled=True, rtt_rings=True, shard_log=True, probes=2,
        node_faults=pconfig.NodeFaultConfig(stale=((3, 2, 5),))),
    "windowed_replicated_log": dict(
        num_nodes=32, num_rows=8, num_cols=2, log_capacity=16,
        swim_enabled=True, swim_view_size=8, shard_log=False),
}


@pytest.mark.parametrize("name", sorted(SHARD_BUILD_CASES))
def test_init_state_on_a_mesh_builds_only_the_shard(name):
    """``init_state(mesh=)`` is ``shard_state`` of the whole state, leaf
    for leaf on each of 4 shards, and allocates no tensor with two axes
    of length N on the way (the row planes are made at the shard's
    rows)."""
    from corro_sim_torch.convert import _leaves
    from corro_sim_torch.engine.mesh_jobs import AllocationWatch

    cfg = pconfig.SimConfig(**SHARD_BUILD_CASES[name]).validate()
    n = cfg.num_nodes
    whole = init_state(cfg, seed=4, device="cpu")
    for i in range(4):
        mesh = psh.Mesh(("nodes",), {"nodes": 4}, {"nodes": i}, None, "cpu")
        watch = AllocationWatch(n)
        with watch():
            got = dict(_leaves(init_state(cfg, seed=4, device="cpu",
                                          mesh=mesh)))
        want = dict(_leaves(psh.shard_state(whole, mesh, n,
                                            shard_log=cfg.shard_log)))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, i, k)
        assert watch.worst <= 1, watch.shapes


def test_gather_state_never_holds_a_whole_plane_on_a_device():
    """On 8 ranks, ``gather_state`` brings each sharded leaf to rank 0's
    host one part at a time: the only tensors with two axes of length N
    that it allocates are rank 0's host copies, one per such leaf, and
    the other ranks allocate none. The shard build allocates none on any
    rank, and the gathered state is ``init_state`` built whole."""
    cfg = pconfig.SimConfig(
        **SHARD_BUILD_CASES["full_swim_rtt_stale"]).validate()
    (got,) = run_ranks(batch, RANKS, [("gather_job", (cfg, 4), {})],
                       timeout=TIMEOUT)
    assert got["equal"]
    assert got["build_max_n_axes"] <= 1
    assert got["big_leaves"] >= 3  # the book, the SWIM plane, the RTT plane
    assert got["rank0_big"] == got["big_leaves"]
    assert got["others_big"] == 0


# ------------------------------------------- cross-device equivalence


@pytest.mark.parametrize("name", ["actor", "repl"])
def test_sharded_bit_identical_both_log_regimes(name, mesh_runs):
    got = mesh_runs[name]
    assert got["sharding"]["shard_log"] == (
        "actor_sharded" if name == "actor" else "replicated")
    assert_equal_to_reference(ref_run(name), got)


@pytest.mark.parametrize("name", ["narrow", "full_swim", "lossy",
                                  "workload", "latency"])
def test_sharded_bit_identical_variants(name, mesh_runs):
    """Windowed narrow SWIM, full-view SWIM with bounded payloads, seeded
    link loss, a compiled workload, and the latency ring with RTT rings,
    probes and the legacy sync schedule."""
    ref = ref_run(name)
    if name == "lossy":
        assert int(np.asarray(ref.metrics["fault_lost"]).sum()) > 0
    if name == "workload":
        assert int(np.asarray(ref.metrics["writes"]).sum()) > 0
    assert_equal_to_reference(ref, mesh_runs[name])


def test_sharded_merge_kernel_bit_identical(mesh_runs):
    """merge_kernel="on" under the mesh: delivery through
    route_merge_sharded, the sync sweep through merge_grouped(mesh=), the
    kernel's plain version per shard on the CPU; not downgraded."""
    got = mesh_runs["kernel"]
    assert got["sharding"]["merge_kernel"] == "on"
    assert got["sharding"]["downgrades"] == []
    assert_equal_to_reference(ref_run("kernel"), got)


def test_sharded_auto_kernel_downgrade_is_explicit(mesh_runs):
    """A mesh run that cannot keep its kernel downgrades observably —
    sharding report, flight annotation, counter — while an operator's
    explicit "off" stays a choice."""
    actor = mesh_runs["actor"]
    assert actor["sharding"]["merge_kernel"] == "off"
    assert actor["sharding"]["downgrades"] == [{
        "field": "merge_kernel", "value": "off",
        "reason": "cell_space_unaligned",
    }]
    assert len(actor["flight_events"]) == 1
    assert actor["flight_events"][0]["attrs"]["field"] == "merge_kernel"
    assert actor["downgrade_total"] >= 1
    auto = mesh_runs["kernel_auto"]
    assert auto["sharding"]["downgrades"] == [{
        "field": "merge_kernel", "value": "off",
        "reason": "sharded_non_cuda",
    }]
    assert_equal_to_reference(ref_run("kernel"), auto)
    off = mesh_runs["off"]
    assert off["sharding"]["downgrades"] == []
    assert off["flight_events"] == []


def test_donate_pipeline_sharded_compose_bit_identical(mesh_runs):
    """The pipelined loop on the mesh, through the repair switch, equals
    the JAX package's sequential one-device run."""
    got = mesh_runs["pipe"]
    ref = ref_run("pipe")
    assert got["pipeline"]["enabled"] is True
    assert got["sharding"]["shard_log"] == "actor_sharded"
    assert ref.converged_round is not None
    assert got["repair_chunks"] > 0
    assert_equal_to_reference(ref, got)


def test_sharded_runs_report_mesh_provenance(mesh_runs):
    """RunResult.sharding equals the JAX package's mesh run's, key for
    key (the reason strings agree at this shape)."""
    got = mesh_runs["repl"]["sharding"]
    assert got["devices"] == 8
    assert got["mesh_shape"] == {"nodes": 8}
    assert got["shard_log"] == "replicated"
    assert got == ref_run("repl", mesh=True).sharding
    assert ref_run("repl").sharding is None


def test_shard_log_config_surfaces(tmp_path):
    """--shard-log / env / TOML all reach SimConfig.shard_log."""
    from corro_sim_torch.io.config_file import load_config

    assert load_config(env={"CORRO_SIM__SHARD_LOG": "on"}).shard_log is True
    assert load_config(env={"CORRO_SIM__SHARD_LOG": "0"}).shard_log is False
    assert load_config(env={"CORRO_SIM__SHARD_LOG": "auto"}).shard_log \
        is None
    with pytest.raises(ValueError):
        load_config(env={"CORRO_SIM__SHARD_LOG": "maybe"})
    toml = tmp_path / "c.toml"
    toml.write_text("[sim]\nnum_nodes = 32\nshard_log = true\n")
    cfg = load_config(str(toml), env={})
    assert cfg.shard_log is True and cfg.num_nodes == 32
    toml.write_text('[sim]\nshard_log = "auto"\n')
    assert load_config(str(toml), env={}).shard_log is None


# ------------------------------------------------------------ the sweep


@pytest.mark.parametrize("node_shards", [1, 2])
def test_mesh_sweep_bit_identical_to_unsharded(node_shards):
    """The lane axis over 8 ranks changes placement only: 6 lanes on 6
    ranks (2 idle), or with ``node_shards`` 2 three lane groups of two
    ranks, each lane's 12 nodes split over its group (crash-amnesia
    wipes, link loss and clock skew from the lanes' knob planes). Every
    lane's state, metrics and rounds equal the unsharded sweep's, and so
    do the dispatches, the occupancy books and the sweep-gate counts;
    ``devices`` is the mesh's size."""
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.sweep import build_plan
    from corro_sim_torch.sweep.engine import run_sweep
    from test_torch_sweep import BASE, CHUNK, MAX_ROUNDS, MIXED_SCENARIOS

    def plan():
        return build_plan(BASE, MIXED_SCENARIOS, [0, 1], rounds=48,
                          write_rounds=8)

    ref = run_sweep(plan(), max_rounds=MAX_ROUNDS, chunk=CHUNK,
                    device="cpu")
    got = run_ranks(sweep_job, RANKS, plan(),
                    dict(max_rounds=MAX_ROUNDS, chunk=CHUNK), node_shards,
                    timeout=TIMEOUT)
    assert got.devices == 6
    assert (got.rounds, got.dispatches) == (ref.rounds, ref.dispatches)
    assert got.occupancy == ref.occupancy
    assert got.sweeps == ref.sweeps
    assert [lr.index for lr in got.lanes] == [lr.index for lr in ref.lanes]
    for a, b in zip(ref.lanes, got.lanes):
        assert (a.converged_round, a.rounds, a.poisoned) == (
            b.converged_round, b.rounds, b.poisoned)
        assert a.resilience == b.resilience
        for k in a.metrics:
            np.testing.assert_array_equal(a.metrics[k], b.metrics[k],
                                          err_msg=k)
        sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_compact_mesh_refused():
    """Compaction re-packs the lane axis at runtime: a mesh over more
    than one rank cannot follow."""
    from unittest import mock

    from corro_sim_torch.sweep import build_plan
    from corro_sim_torch.sweep.engine import run_sweep
    from test_torch_sweep import BASE

    psh.check_compact_mesh(None)
    fake = mock.Mock(size=4)
    with pytest.raises(ValueError, match="power-of-2 buckets"):
        psh.check_compact_mesh(fake)
    plan = build_plan(BASE, ["lossy:p=0.1"], [0], rounds=16,
                      write_rounds=8)
    for kw in ({"compact": True}, {"pipeline": True}):
        with pytest.raises(ValueError, match="power-of-2 buckets"):
            run_sweep(plan, mesh=fake, device="cpu", **kw)


# ---------------------------------------------------------- the bench


def test_bench_config5_on_the_mesh_equals_the_reference():
    """In a world of 8 ranks config 5 runs unsized and sharded, with the
    placement block, as the JAX package's 8-device leg does: the same
    rounds, changes and provenance (the byte counts by placement; the
    port's carriers are wider)."""
    from corro_sim import benchmarks as ref_bench
    from corro_sim_torch.engine.mesh_jobs import bench_job

    ref = ref_bench.run_config_5(nodes=64)
    got = run_ranks(bench_job, RANKS, "run_config_5", {"nodes": 64},
                    timeout=TIMEOUT)
    for k in ("metric", "value", "converged", "changes_applied",
              "devices"):
        assert got[k] == ref[k], k
    assert got["devices"] == 8 and "note" not in got
    rs, gs = dict(ref["sharding"]), dict(got["sharding"])
    rb, gb = rs.pop("state_bytes"), gs.pop("state_bytes")
    # the JAX package downgrades for its backend; the port for the CPU
    assert [d["reason"] for d in rs.pop("downgrades")] == [
        "sharded_non_tpu"]
    assert [d["reason"] for d in gs.pop("downgrades")] == [
        "sharded_non_cuda"]
    assert gs == rs
    assert {c: v["placement"] for c, v in gb.items()} == {
        c: v["placement"] for c, v in rb.items()}


def test_config7_sizing_on_a_mesh():
    """Config 7's weak-scaling rule: D ranks run D eighths of the
    100 000-node target, sized by one device's memory, in whole shards;
    one device keeps today's eighth."""
    from corro_sim_torch.profile_slice import size_config7

    h100 = 80 * 10**9
    assert size_config7(h100, 100_000, 8) == (100_000, None)
    nodes, reason = size_config7(h100, 100_000, 2)
    assert nodes == 25_000 and "2/8" in reason
    assert size_config7(h100, 100_000, 1)[0] == 12_500
    nodes, reason = size_config7(2 * 10**9, 100_000, 8)
    assert nodes % 8 == 0 and nodes < 100_000
    assert reason == "device memory budget"


def test_mesh_checkpoint_resumes_on_both_packages(tmp_path):
    """A mesh run's token is the state gathered whole, written by rank
    0 in the JAX package's npz format: the port resumes it on one
    device and the JAX package resumes it too, each to the
    uninterrupted run's metrics and state."""
    from corro_sim.io.checkpoint import load_sim_checkpoint as ref_load
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.io.checkpoint import load_sim_checkpoint

    path = str(tmp_path / "mesh.npz")
    fields, kw, _ = CASES["actor"]
    cfg = _port_cfg(fields)
    (run,) = run_ranks(batch, RANKS, [("run_sim_job", (
        dataclasses.asdict(cfg), kw["seed"],
        dict(kw, checkpoint_path=path, checkpoint_every=1)), {})],
        timeout=TIMEOUT)
    ref = ref_run("actor")
    assert_equal_to_reference(ref, run)
    # the token holds the config the run ran: its kernel downgraded
    tok = load_sim_checkpoint(path)
    assert tok.cfg.merge_kernel == "off"
    got = run_sim(tok.cfg, init_state(cfg, seed=kw["seed"], device="cpu"),
                  Schedule(write_rounds=8), device="cpu", resume=tok, **kw)
    from corro_sim_torch.convert import state_to_numpy

    assert_equal_to_reference(ref, {
        "converged_round": got.converged_round,
        "repair_chunks": got.repair_chunks, "metrics": got.metrics,
        "state": state_to_numpy(got.state)})
    rtok = ref_load(path)
    again = ref_run_sim(rtok.cfg, ref_init_state(rtok.cfg, seed=kw["seed"]),
                        RefSchedule(write_rounds=8), resume=rtok, **kw)
    for k, v in ref.metrics.items():
        np.testing.assert_array_equal(np.asarray(again.metrics[k]),
                                      np.asarray(v), err_msg=k)


def test_sweep_state_shardings_match_the_jax_package():
    """The stacked sweep carry's placements: the lane axis on "sweep",
    and node-sized axis-1 leaves on "nodes" when lanes are node-sharded
    (the JAX package's ``sweep_state_shardings``, spec for spec)."""
    from corro_sim.engine.sharding import make_sweep_mesh as ref_sweep_mesh
    from corro_sim.engine.sharding import (
        sweep_state_shardings as ref_sweep_shardings,
    )

    lanes = 4
    cfg = _ref_cfg(dict(BASE_KW, swim_enabled=True))
    rstate = jax.eval_shape(lambda: ref_init_state(cfg, seed=0))
    rstacked = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((lanes,) + x.shape, x.dtype), rstate)
    pstate = init_state(_port_cfg(dict(BASE_KW, swim_enabled=True)),
                        seed=0, device="meta")
    pstacked = psh._map_leaves(pstate, lambda k, t: torch.empty(
        (lanes,) + tuple(t.shape), dtype=t.dtype, device="meta"))
    for node_shards in (1, 2):
        rmesh = ref_sweep_mesh(lanes, node_shards=node_shards)
        mesh = psh.Mesh(("sweep", "nodes"), dict(rmesh.shape),
                        {"sweep": 0, "nodes": 0}, None, "cpu")
        want = {jax.tree_util.keystr(p).lstrip("."): tuple(s.spec)
                for p, s in jax.tree_util.tree_flatten_with_path(
                    ref_sweep_shardings(cfg, rstacked, rmesh))[0]}
        got = {k: p.spec for k, p in psh._specs(psh.sweep_state_shardings(
            cfg, pstacked, mesh)).items()}
        assert got == want, node_shards
