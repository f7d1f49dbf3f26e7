"""Parity, node-lifecycle faults: corro_sim_torch.faults.nodes, the
feature leaves and ``renew_membership`` against the JAX package's, on
the CPU.

Module parity feeds both packages the same seeded numpy state and holds
every output leaf bit for bit. Whole runs hold every state leaf (the
``node_epoch`` and ``node_snapshot`` feature leaves included), every
per-round metric, ``converged_round`` and ``repair_chunks`` equal to the
JAX package's, for the pipelined and the sequential loop (tolerance:
exact). The schedules are static, so the repair step must derive the
same fault timeline as the full step: the port's run with and without
the repair switch must agree too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.config import FaultConfig, NodeFaultConfig, SimConfig
from corro_sim.engine import features as ref_features
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.faults import nodes as ref_nodes
from corro_sim.faults.invariants import InvariantChecker as RefChecker
from corro_sim.faults.scorecard import ResilienceScorecard as RefScorecard
from corro_sim.membership.swim import renew_membership as ref_renew
from corro_sim.workload.generators import Workload as RefWorkload
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_from_reference, state_to_numpy
from corro_sim_torch.engine import features
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import clone_state, init_state, state_nbytes
from corro_sim_torch.faults import (
    InvariantChecker,
    ResilienceScorecard,
    nodes,
)
from corro_sim_torch.membership.swim import renew_membership
from corro_sim_torch.workload.generators import Workload

N = 16
BASE = SimConfig(
    num_nodes=N, num_rows=16, num_cols=2, log_capacity=64,
    write_rate=0.6, sync_interval=4, swim_enabled=True, swim_interval=2,
    narrow_state=True,
)
# crash, stale rejoin, skew and stragglers together; a second crash and
# a stale restore land after the write phase, inside the repair tail
COMBINED = NodeFaultConfig(
    crash=((1, 12), (4, 12), (9, 40)),
    stale=((2, 4, 12), (6, 30, 44)),
    skew=((0, 30), (7, -12)),
    straggle=((3, 8, 2), (5, 4, 1)),
)


def _down(nodes, lo, hi, rounds=64, n=N):
    alive = np.ones((rounds, n), bool)
    alive[lo:hi, list(nodes)] = False
    return alive


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _assert_leaves_equal(have: dict, want: dict):
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def _assert_run_equal(got, ref):
    _assert_leaves_equal(state_to_numpy(got.state), _leaves(ref.state))
    assert set(got.metrics) == set(ref.metrics)
    for k in ref.metrics:
        np.testing.assert_array_equal(got.metrics[k],
                                      np.asarray(ref.metrics[k]), err_msg=k)
    assert got.rounds == ref.rounds
    assert got.converged_round == ref.converged_round
    assert got.repair_chunks == ref.repair_chunks


def _port_cfg(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


def _randomized(cfg, seed=0):
    """The JAX package's init state of ``cfg`` with seeded random table,
    bookkeeping, gossip, clock and SWIM leaves, and the port's copy."""
    rng = np.random.default_rng(seed)
    st = ref_init_state(cfg, seed=0)
    n, r, c, a = cfg.num_nodes, cfg.num_rows, cfg.num_cols, cfg.num_actors

    def ints(shape, lo, hi, dtype=np.int32):
        return jnp.asarray(rng.integers(lo, hi, shape).astype(dtype))

    st = st.replace(
        table=st.table.replace(cv=ints((n, r, c), 0, 9),
                               vr=ints((n, r, c), -5, 50),
                               site=ints((n, r, c), -1, n),
                               cl=ints((n, r), 0, 4)),
        book=st.book.replace(head=ints((n, a), 0, 20),
                             win=ints((n, a), 0, 2**32, np.uint32)),
        gossip=st.gossip.replace(pend=ints(st.gossip.pend.shape, 0, 9),
                                 cursor=ints((n,), 0, cfg.pend_slots)),
        hlc=ints((n,), 0, 100), last_cleared=ints((n,), -1, 100),
    )
    if cfg.swim_enabled:
        sw = st.swim
        if hasattr(sw, "member"):
            sw = sw.replace(belief=ints(sw.belief.shape, 0, 2**16,
                                        sw.belief.dtype))
        else:
            hi = 2**16 if cfg.narrow_state else 2**32
            p = rng.integers(0, hi, sw.p.shape).astype(sw.p.dtype)
            # saturated self-incarnations on some rows
            sat = (63 << 10) if cfg.narrow_state else ((1 << 14) - 1) << 18
            p[np.arange(0, n, 3), np.arange(0, n, 3)] |= sat
            sw = sw.replace(p=jnp.asarray(p))
        st = st.replace(swim=sw)
    return st, state_from_reference(_leaves(st), "cpu")


# ------------------------------------------------------------ module parity

@pytest.mark.parametrize("round_", [-1, 0, 3, 12, 13])
def test_mask_at_matches(round_):
    nodes_ = np.array([0, 3, 3, 7, 15], np.int32)
    rounds = np.array([-1, 3, 12, 12, 13], np.int32)
    want = ref_nodes._mask_at(nodes_, rounds, N, jnp.int32(round_))
    np.testing.assert_array_equal(
        nodes._mask_at(nodes_, rounds, N, round_), np.asarray(want))


@pytest.mark.parametrize("nf", [
    NodeFaultConfig(skew=((0, 50), (9, -20), (9, 7))),
    NodeFaultConfig(trace_vacuous=True), NodeFaultConfig(),
], ids=["skew", "vacuous", "off"])
def test_skew_plane_matches(nf):
    want = ref_nodes.skew_plane(nf, N)
    got = nodes.skew_plane(_port_cfg(
        dataclasses.replace(BASE, node_faults=nf)).node_faults, N, "cpu")
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nf", [
    NodeFaultConfig(straggle=((3, 8, 2), (5, 4, 1), (3, 3, 3))),
    NodeFaultConfig(trace_vacuous=True),
], ids=["straggle", "vacuous"])
def test_straggler_active_matches(nf):
    pnf = _port_cfg(dataclasses.replace(BASE, node_faults=nf)).node_faults
    for r in range(0, 20, 3):
        want = np.asarray(ref_nodes.straggler_active(nf, N, jnp.int32(r)))
        np.testing.assert_array_equal(
            nodes.straggler_active(pnf, N, r, "cpu").numpy(), want)
        np.testing.assert_array_equal(nodes.straggler_active(
            pnf, N, torch.tensor(r, dtype=torch.int32), "cpu").numpy(), want)
    assert nodes.straggler_active(
        _port_cfg(BASE).node_faults, N, 0, "cpu") is None


def test_recovering_mask_matches():
    ref, port = _randomized(BASE, seed=3)
    np.testing.assert_array_equal(
        nodes.recovering_mask(port.book, port.log).numpy(),
        np.asarray(ref_nodes.recovering_mask(ref.book, ref.log)))


@pytest.mark.parametrize("nf,round_", [
    (NodeFaultConfig(crash=((1, 5), (4, 5), (4, 9))), 5),
    (NodeFaultConfig(stale=((2, 3, 7), (6, 5, 7))), 3),  # capture
    (NodeFaultConfig(stale=((2, 3, 7), (6, 5, 7))), 7),  # restore
    # amnesia and a stale restore of the same node in one round, and a
    # capture of another: amnesia wins
    (NodeFaultConfig(crash=((2, 7), (8, 7)), stale=((2, 3, 7), (5, 7, 9)),
                     epoch_jump=5), 7),
    (NodeFaultConfig(crash=((1, 5),)), 6),  # nothing fires
], ids=["amnesia", "capture", "stale", "both", "none"])
@pytest.mark.parametrize("layout", ["narrow", "wide", "windowed"])
def test_apply_node_faults_matches(nf, round_, layout):
    swim = {"narrow": dict(narrow_state=True),
            "wide": dict(narrow_state=False),
            "windowed": dict(swim_view_size=6, swim_payload_members=3)}
    cfg = dataclasses.replace(BASE, node_faults=nf, **swim[layout])
    ref, port = _randomized(cfg, seed=round_)
    if nf.stale:
        # a captured snapshot that differs from the live state
        _, donor = _randomized(cfg, seed=99)
        snap = {k: getattr(donor.table, k, None) for k in
                ("cv", "vr", "site", "cl")}
        snap.update(head=donor.book.head, win=donor.book.win)
        port.features["node_snapshot"] = snap
        feats = dict(ref.features)
        feats["node_snapshot"] = {k: jnp.asarray(
            state_to_numpy(donor)[("table." if k in ("cv", "vr", "site", "cl")
                                   else "book.") + k]) for k in snap}
        ref = ref.replace(features=feats)
    want, want_wiped = ref_nodes.apply_node_faults(cfg, ref, jnp.int32(round_))
    got, wiped = nodes.apply_node_faults(_port_cfg(cfg), port, round_)
    np.testing.assert_array_equal(wiped.numpy(), np.asarray(want_wiped))
    _assert_leaves_equal(state_to_numpy(got), _leaves(want))


@pytest.mark.parametrize("layout", ["wide", "narrow", "windowed"])
def test_renew_membership_matches(layout):
    kw = {"wide": dict(narrow_state=False), "narrow": dict(narrow_state=True),
          "windowed": dict(swim_view_size=5, swim_payload_members=2)}[layout]
    ref, port = _randomized(dataclasses.replace(BASE, **kw), seed=11)
    wipe = np.random.default_rng(1).random(N) < 0.4
    wipe[0] = True  # row 0 carries a saturated self-incarnation
    want = ref_renew(ref.swim, jnp.asarray(wipe))
    got = renew_membership(port.swim, torch.as_tensor(wipe))
    w = _leaves(ref.replace(swim=want))
    h = state_to_numpy(dataclasses.replace(port, swim=got))
    for k in w:
        if k.startswith("swim."):
            np.testing.assert_array_equal(h[k], w[k], err_msg=k)


def test_feature_registry_matches():
    for nf in (COMBINED, NodeFaultConfig(trace_vacuous=True),
               NodeFaultConfig(skew=((0, 1),)), NodeFaultConfig()):
        for faults in (FaultConfig(), FaultConfig(burst_enter=0.1)):
            cfg = dataclasses.replace(BASE, node_faults=nf, faults=faults)
            assert (features.enabled_feature_names(_port_cfg(cfg))
                    == tuple(n for n in ref_features.enabled_feature_names(cfg)
                             if n != "sweep_knobs"))
            ref = ref_init_state(cfg, seed=0)
            port = init_state(_port_cfg(cfg), seed=0, device="cpu")
            _assert_leaves_equal(state_to_numpy(port), _leaves(ref))


def test_clone_state_deep_copies_feature_leaves():
    """The pipelined loop speculates on clone_state's copy: every feature
    tensor must be copied, never shared."""
    cfg = _port_cfg(dataclasses.replace(
        BASE, node_faults=COMBINED, faults=FaultConfig(burst_enter=0.1)))
    st = init_state(cfg, seed=0, device="cpu")
    cp = clone_state(st)
    pairs = [(st.features["node_epoch"], cp.features["node_epoch"]),
             (st.fault_burst, cp.fault_burst)] + [
        (st.features["node_snapshot"][k], cp.features["node_snapshot"][k])
        for k in st.features["node_snapshot"]]
    for a, b in pairs:
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    snap_bytes = sum(t.numel() * t.element_size()
                     for t in st.features["node_snapshot"].values())
    assert state_nbytes(st) > snap_bytes > 0
    # the round trip through the JAX package's leaves, checkpoint spelling
    # included
    leaves = state_to_numpy(st)
    back = state_from_reference(leaves, "cpu")
    _assert_leaves_equal(state_to_numpy(back), leaves)
    slashed = {k.replace("features['", "features/").replace("']['", "/")
               .rstrip("']"): v for k, v in leaves.items()}
    _assert_leaves_equal(
        state_to_numpy(state_from_reference(slashed, "cpu")), leaves)


# --------------------------------------------------------------- whole runs

def test_whole_run_combined_node_faults_bit_identical():
    """Crash, stale rejoin, skew and stragglers in one run; wipes and a
    capture land in the repair tail. Pipelined and sequential equal the
    JAX package's run, and the port's run without the repair switch
    equals both (the switch lands inside the fault windows)."""
    cfg = dataclasses.replace(BASE, node_faults=COMBINED).validate()
    alive = _down((1, 4), 8, 12)
    alive[36:40, 9] = False
    kw = dict(max_rounds=64, chunk=8, seed=0, min_rounds=12,
              stop_on_convergence=False)
    ref_inv = RefChecker(cfg)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0),
                      RefSchedule(write_rounds=8, alive=alive),
                      invariants=ref_inv, scorecard=RefScorecard(cfg), **kw)
    pcfg = _port_cfg(cfg)
    runs = []
    for pipe in (True, False):
        inv = InvariantChecker(pcfg)
        runs.append(run_sim(
            pcfg, init_state(pcfg, seed=0, device="cpu"),
            Schedule(write_rounds=8, alive=alive), device="cpu",
            pipeline=pipe, invariants=inv,
            scorecard=ResilienceScorecard(pcfg), **kw))
        assert inv.report() == ref_inv.report()
    for run in runs:
        _assert_run_equal(run, ref)
        assert run.resilience == ref.resilience
    assert ref.repair_chunks >= 2  # rounds 40 and 44 run on the repair step
    full = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                   Schedule(write_rounds=8, alive=alive), device="cpu",
                   phase_specialize=False, **kw)
    assert full.repair_chunks == 0
    _assert_leaves_equal(state_to_numpy(full.state), _leaves(ref.state))
    for k in ref.metrics:
        np.testing.assert_array_equal(full.metrics[k],
                                      np.asarray(ref.metrics[k]), err_msg=k)
    m = runs[0].metrics
    assert m["node_fault_wipes"].sum() == 5
    assert m["node_fault_straggling"].sum() > 0
    assert m["node_fault_recovering"].sum() > 0


def _solo_workload(cls, n, rounds, writer, load_rounds):
    """Everybody writes in the first ``load_rounds`` rounds, then only
    ``writer`` does, up to ``rounds``."""
    rng = np.random.default_rng(4)
    writers = np.zeros((rounds, n), bool)
    writers[:load_rounds] = rng.random((load_rounds, n)) < 0.5
    writers[load_rounds:, writer] = True
    return cls(
        name="solo", params={"writer": writer}, rounds=rounds, n=n,
        writers=writers,
        rows=rng.integers(0, 16, (rounds, n)).astype(np.int32),
        cols=rng.integers(0, 2, (rounds, n, 1)).astype(np.int32),
        vals=rng.integers(0, 1000, (rounds, n, 1)).astype(np.int32),
        dels=np.zeros((rounds, n), bool),
        ncells=np.ones((rounds, n), np.int32),
    )


def test_crash_amnesia_under_workload_gates_writes_on_the_device():
    """After its wipe, node 1 is the only scheduled writer; the device's
    write gate silences it while it resyncs, so the round is quiesced
    and sweeps on the adaptive floor cadence, which the host's schedule
    rows cannot show. The port must not let the host's "writers run"
    veto those sweeps."""
    cfg = dataclasses.replace(
        BASE, swim_enabled=False, sync_interval=8, sync_adaptive=True,
        sync_floor_rounds=2, node_faults=NodeFaultConfig(crash=((1, 8),)),
    ).validate()
    alive = _down((1,), 6, 8, rounds=48)
    kw = dict(max_rounds=48, chunk=8, seed=0, min_rounds=24)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0),
                      RefSchedule(write_rounds=0, alive=alive),
                      workload=_solo_workload(RefWorkload, N, 24, 1, 6), **kw)
    pcfg = _port_cfg(cfg)
    for pipe in (True, False):
        got = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                      Schedule(write_rounds=0, alive=alive), device="cpu",
                      workload=_solo_workload(Workload, N, 24, 1, 6),
                      pipeline=pipe, **kw)
        _assert_run_equal(got, ref)
    m = got.metrics
    gated = (m["writes"] == 0) & (np.arange(len(m["writes"])) < 24)
    gated[:8] = False
    floor = (np.arange(len(gated)) % 8) != 7
    # rounds where the schedule had node 1 write, the gate silenced it,
    # and a floor-cadence sweep ran
    assert (gated & floor & (m["sync_pairs"] > 0)).any()
    assert m["node_fault_recovering"].sum() > 0 and m["writes"][8:24].sum() > 0


def test_trace_vacuous_node_faults_equal_the_fault_free_run():
    vac = dataclasses.replace(
        BASE, node_faults=NodeFaultConfig(trace_vacuous=True))
    kw = dict(max_rounds=64, chunk=8, seed=0)
    ref = ref_run_sim(vac, ref_init_state(vac, seed=0),
                      RefSchedule(write_rounds=8), **kw)
    got = run_sim(_port_cfg(vac), init_state(_port_cfg(vac), seed=0,
                                             device="cpu"),
                  Schedule(write_rounds=8), device="cpu", **kw)
    _assert_run_equal(got, ref)
    off = run_sim(_port_cfg(BASE), init_state(_port_cfg(BASE), seed=0,
                                              device="cpu"),
                  Schedule(write_rounds=8), device="cpu", **kw)
    have = state_to_numpy(got.state)
    have.pop("features['node_epoch']")
    _assert_leaves_equal(state_to_numpy(off.state), have)
    nf_keys = {k for k in got.metrics if k.startswith("node_fault_")}
    assert nf_keys and set(off.metrics) == set(got.metrics) - nf_keys
    for k, v in off.metrics.items():
        np.testing.assert_array_equal(v, got.metrics[k], err_msg=k)
