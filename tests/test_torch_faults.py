"""Parity, link faults: corro_sim_torch.faults.inject and the step's two
transport points against the JAX package's, on the CPU.

Module parity feeds both packages the same keys and seeded numpy inputs
and holds each mask bit for bit. Whole runs hold every state leaf
(``fault_burst`` included), every per-round metric (the ``fault_*``
series included), ``converged_round`` and ``repair_chunks`` equal to the
JAX package's, for the pipelined and the sequential loop (tolerance:
exact — masks are float32 threshold compares of the same uniforms).
``trace_vacuous`` runs the fault machinery with zero effect: it must
equal the fault-free run apart from the ``fault_*`` series.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.config import FaultConfig, SimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.faults import inject as ref_inject
from corro_sim.faults.invariants import InvariantChecker as RefChecker
from corro_sim.faults.masks import pairs_to_mask as ref_pairs_to_mask
from corro_sim_torch import config as pconfig
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.faults import InvariantChecker, inject
from corro_sim_torch.faults.masks import pairs_to_mask
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

# a fault config's whole run: the north-star shape at 24 nodes, SWIM on
# (narrow, a tick every 2 rounds), a partition in rounds 4-9
BASE = SimConfig(
    num_nodes=24, num_rows=32, num_cols=4, log_capacity=128,
    write_rate=0.5, swim_enabled=True, swim_interval=2, narrow_state=True,
    sync_interval=4, sync_actor_topk=8,
)


def _part(r, n):
    p = np.zeros(n, np.int32)
    if 4 <= r < 10:
        p[n // 2:] = 1
    return p


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _assert_run_equal(got, ref, want_state):
    have = state_to_numpy(got.state)
    assert set(have) == set(want_state)
    for k in want_state:
        assert have[k].dtype == want_state[k].dtype, k
        np.testing.assert_array_equal(have[k], want_state[k], err_msg=k)
    assert set(got.metrics) == set(ref.metrics)
    for k in ref.metrics:
        np.testing.assert_array_equal(got.metrics[k],
                                      np.asarray(ref.metrics[k]), err_msg=k)
    assert got.rounds == ref.rounds
    assert got.converged_round == ref.converged_round
    assert got.repair_chunks == ref.repair_chunks


def _runs(cfg, schedule_fn, **kw):
    """The JAX package's run, and the port's pipelined and sequential
    runs of the same config, schedule and arguments, each with an
    invariant checker armed; the checkers' reports must agree."""
    ref_inv = RefChecker(cfg)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0), schedule_fn(RefSchedule),
                      invariants=ref_inv, **kw)
    pcfg = sim_config_from_dict(dataclasses.asdict(cfg))
    got = []
    for pipeline in (True, False):
        inv = InvariantChecker(pcfg)
        got.append(run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                           schedule_fn(Schedule), device="cpu",
                           pipeline=pipeline, invariants=inv, **kw))
        assert inv.report() == ref_inv.report()
        assert inv.chunks_checked > 0
    return ref, got


# ------------------------------------------------------------ module parity

def _keys(seed):
    k = jax.random.PRNGKey(seed)
    return k, np.asarray(k, np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_fault_keys_match(seed):
    rk, pk = _keys(seed)
    for r, p in zip(ref_inject.fault_keys(rk), inject.fault_keys(pk)):
        np.testing.assert_array_equal(np.asarray(r, np.uint32), p)


@pytest.mark.parametrize("faults,n", [
    (FaultConfig(burst_enter=0.2, burst_exit=0.4), 37),
    (FaultConfig(burst_enter=0.05, burst_exit=0.3, loss=0.1), 300),
    (FaultConfig(loss=0.1), 16),  # burst off: the placeholder passes
], ids=["n37", "n300", "off"])
def test_burst_update_matches(faults, n):
    rng = np.random.default_rng(n)
    burst = rng.random(n) < 0.3 if faults.burst_on else np.zeros(1, bool)
    pf = pconfig.FaultConfig(**dataclasses.asdict(faults))
    for seed in range(3):
        rk, pk = _keys(seed)
        k_b = ref_inject.fault_keys(rk)[0]
        want = ref_inject.burst_update(faults, jnp.asarray(burst), k_b)
        got = inject.burst_update(pf, torch.as_tensor(burst),
                                  inject.fault_keys(pk)[0])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("faults", [
    FaultConfig(loss=0.2),
    FaultConfig(loss=0.1, dup=0.3),
    FaultConfig(dup=0.2),
    FaultConfig(loss=0.05, burst_enter=0.1, burst_loss=0.9),
    FaultConfig(trace_vacuous=True),
], ids=["loss", "loss_dup", "dup_only", "burst", "vacuous"])
@pytest.mark.parametrize("lanes", [1, 129, 4097])
def test_link_fault_masks_match(faults, lanes):
    """Bit for bit over the (2, L) draw: row 0 loss (receiver burst
    aware), row 1 duplication; a knob at 0 draws nothing and its mask
    is constant."""
    n = 50
    rng = np.random.default_rng(lanes)
    dst = rng.integers(0, n, lanes).astype(np.int32)
    burst = rng.random(n) < 0.4 if faults.burst_on else np.zeros(1, bool)
    pf = pconfig.FaultConfig(**dataclasses.asdict(faults))
    rk, pk = _keys(lanes)
    want = ref_inject.link_fault_masks(
        faults, ref_inject.fault_keys(rk)[1], jnp.asarray(dst),
        jnp.asarray(burst))
    got = inject.link_fault_masks(pf, inject.fault_keys(pk)[1],
                                  torch.as_tensor(dst), torch.as_tensor(burst))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("faults", [
    FaultConfig(loss=0.3),
    FaultConfig(loss=0.1, sync_loss=0.5),
    FaultConfig(blackhole=((3, -1), (-1, 5), (7, 8))),
    FaultConfig(loss=0.2, blackhole=((0, -1),)),
], ids=["loss", "sync_loss", "blackhole", "loss_blackhole"])
def test_sync_grant_keep_matches(faults):
    n, p_cnt = 40, 3
    rng = np.random.default_rng(5)
    peer = rng.integers(0, n, (n, p_cnt)).astype(np.int32)
    pf = pconfig.FaultConfig(**dataclasses.asdict(faults))
    bh = ref_inject.blackhole_mask(faults, n)
    for seed in range(2):
        rk, pk = _keys(seed)
        want = ref_inject.sync_grant_keep(
            faults, ref_inject.fault_keys(rk)[2], jnp.arange(n),
            jnp.asarray(peer), None if bh is None else jnp.asarray(bh))
        got = inject.sync_grant_keep(
            pf, inject.fault_keys(pk)[2], torch.arange(n),
            torch.as_tensor(peer), inject.blackhole_tensor(pf, n, "cpu"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pairs", [
    (), ((1, 2),), ((3, -1),), ((-1, 4),), ((-1, -1), (0, 5)),
    ((2, -1), (-1, 2), (6, 7), (6, 7)),
])
def test_pairs_to_mask_matches(pairs):
    np.testing.assert_array_equal(pairs_to_mask(pairs, 9),
                                  ref_pairs_to_mask(pairs, 9))


def test_burst_plane_follows_the_config():
    cfg = sim_config_from_dict(dataclasses.asdict(
        dataclasses.replace(BASE, faults=FaultConfig(loss=0.1))))
    assert pconfig.validate_torch_slice(cfg) is cfg
    state = init_state(dataclasses.replace(
        cfg, faults=pconfig.FaultConfig(burst_enter=0.1)), device="cpu")
    assert state.fault_burst.shape == (BASE.num_nodes,)
    assert init_state(cfg, device="cpu").fault_burst.shape == (1,)


# --------------------------------------------------------------- whole runs

@pytest.mark.parametrize("faults,kw", [
    # loss, duplication and Gilbert bursts together, to convergence
    (FaultConfig(loss=0.2, dup=0.1, burst_enter=0.1, burst_exit=0.3),
     dict(max_rounds=160, chunk=8)),
    # a one-way blackhole (never heals) plus light loss, fixed rounds
    (FaultConfig(blackhole=((3, -1),), loss=0.05),
     dict(max_rounds=48, chunk=8, stop_on_convergence=False)),
], ids=["loss_dup_burst", "blackhole_one_way"])
def test_whole_run_link_faults_bit_identical(faults, kw):
    cfg = dataclasses.replace(BASE, faults=faults).validate()
    ref, got = _runs(cfg, lambda S: S(write_rounds=8, part_fn=_part),
                     seed=0, **kw)
    want = _leaves(ref.state)
    for run in got:
        _assert_run_equal(run, ref, want)
    m = got[0].metrics
    assert m["fault_lost"].sum() > 0
    lhs = m["msgs_sent"].astype(np.int64) + m["fault_matured"]
    rhs = sum(m[k].astype(np.int64) for k in (
        "fault_parked", "fault_emit_lost", "fault_delivered",
        "fault_unreachable", "fault_blackholed", "fault_lost"))
    np.testing.assert_array_equal(lhs, rhs)
    if faults.blackhole:
        assert m["fault_blackholed"].sum() > 0
        assert m["fault_sync_lost"].sum() > 0
    else:
        assert m["fault_dup"].sum() > 0 and m["fault_burst_nodes"].max() > 0


def test_trace_vacuous_faults_equal_the_fault_free_run():
    """The fault machinery with every knob at zero effect changes no
    state leaf and no metric of the fault-free run, in the port and in
    the JAX package."""
    sched = dict(max_rounds=64, chunk=8, seed=0)
    vac = dataclasses.replace(BASE, faults=FaultConfig(trace_vacuous=True))
    ref, got = _runs(vac, lambda S: S(write_rounds=8, part_fn=_part), **sched)
    want = _leaves(ref.state)
    for run in got:
        _assert_run_equal(run, ref, want)
    pcfg = sim_config_from_dict(dataclasses.asdict(BASE))
    off = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                  Schedule(write_rounds=8, part_fn=_part), device="cpu",
                  **sched)
    assert state_to_numpy(off.state).keys() == want.keys()
    for k, v in state_to_numpy(off.state).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    fault_keys = {k for k in got[0].metrics if k.startswith("fault_")}
    assert fault_keys and set(off.metrics) == set(got[0].metrics) - fault_keys
    for k, v in off.metrics.items():
        np.testing.assert_array_equal(v, got[0].metrics[k], err_msg=k)
    assert off.converged_round == got[0].converged_round
