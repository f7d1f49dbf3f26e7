"""Parity of the latency model, the in-flight ring and the RTT rings:
corro_sim_torch against corro_sim on the CPU.

Module by module (link delays, RTT samples with duplicate lanes, the
ring recomputation with its incumbent tie rule, the cold start where
every score ties) and in whole runs: the latency ring with and without
RTT rings, and a lossy soak under the ring whose conservation counters
and invariant report must be equal. Tolerance: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.config import FaultConfig as RefFaultConfig
from corro_sim.config import SimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.faults import scenarios as ref_scenarios
from corro_sim.faults.invariants import InvariantChecker as RefChecker
from corro_sim.membership import rtt as r_rtt
from corro_sim_torch import prng
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.engine.step import sim_step
from corro_sim_torch.membership import rtt as p_rtt
from corro_sim_torch.profile_slice import (
    DIGESTS,
    SLICE8_ROUNDS,
    RUN_ARGS,
    run_digest,
    run_soak,
    slice8_config,
    slice_schedule,
)
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

N = 32


def _port_cfg(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


def _eq(got, want, what):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), err_msg=what)


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _assert_runs_equal(ref, got):
    assert got.rounds == ref.rounds
    assert got.converged_round == ref.converged_round
    assert got.repair_chunks == ref.repair_chunks
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        _eq(got.metrics[k], v, k)
    want, have = _leaves(ref.state), state_to_numpy(got.state)
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        _eq(have[k], want[k], k)


def _cfg(**kw):
    return SimConfig(num_nodes=N, latency_regions=4, **kw)


def test_link_delay_matches():
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, 500).astype(np.int32)
    dst = rng.integers(0, N, 500).astype(np.int32)
    cfg = _cfg(latency_inter=6)
    got = p_rtt.link_delay(_port_cfg(cfg), torch.as_tensor(src),
                           torch.as_tensor(dst))
    _eq(got, r_rtt.link_delay(cfg, jnp.asarray(src), jnp.asarray(dst)),
        "delay")
    assert set(got.tolist()) == {1, 6}


def test_observe_rtt_matches():
    """Samples from delivered lanes only, duplicates included (equal
    samples per edge), over a plane that already holds observations."""
    rng = np.random.default_rng(1)
    cfg = _cfg(rtt_rings=True)
    m = 3000
    src = rng.integers(0, N, m).astype(np.int32)
    dst = rng.integers(0, N, m).astype(np.int32)
    delivered = rng.random(m) < 0.3
    delivered[-1] = False
    dst[-1] = N - 1  # an undelivered lane on the last row changes nothing
    rtt = np.full((N, N), 255, np.uint8)
    rtt[3, :5] = np.asarray(r_rtt.link_delay(
        cfg, jnp.arange(5), jnp.full(5, 3)))
    want = r_rtt.observe_rtt(cfg, jnp.asarray(rtt), jnp.asarray(dst),
                             jnp.asarray(src), jnp.asarray(delivered))
    got = p_rtt.observe_rtt(_port_cfg(cfg), torch.as_tensor(rtt),
                            torch.as_tensor(dst), torch.as_tensor(src),
                            torch.as_tensor(delivered))
    assert got.dtype == torch.uint8
    _eq(got, want, "rtt")
    assert (got != 255).sum() > N


@pytest.mark.parametrize("case", ["observed", "cold_start", "ties"])
def test_recompute_ring0_matches(case):
    """Lowest observed delay first, self never, unobserved last; on ties
    the current ring's members win, then the lower index (the cold start,
    where every score ties, returns the incumbents)."""
    rng = np.random.default_rng(len(case))
    n, k = N, 4
    ring0 = ((np.arange(n)[:, None] + np.arange(1, k + 1)[None, :]) % n)
    ring0[:, -1] = rng.integers(0, n, n)  # a long link, maybe a duplicate
    ring0 = ring0.astype(np.int32)
    if case == "cold_start":
        rtt = np.full((n, n), 255, np.uint8)
    elif case == "ties":
        rtt = rng.choice(np.array([1, 255], np.uint8), (n, n))
    else:
        rtt = rng.choice(np.array([1, 2, 4, 255], np.uint8), (n, n))
    want = r_rtt.recompute_ring0(jnp.asarray(rtt), jnp.asarray(ring0))
    got = p_rtt.recompute_ring0(torch.as_tensor(rtt), torch.as_tensor(ring0))
    assert got.dtype == torch.int32
    _eq(got, want, "ring0")
    assert (got.numpy() != np.arange(n)[:, None]).all()
    if case == "cold_start":
        distinct = [sorted(set(r)) for r in ring0.tolist()]
        for row, inc in zip(got.numpy().tolist(), distinct):
            assert set(inc) <= set(row)


def test_inflight_ring_delays_instead_of_drops():
    """A delay-4 link delivers 3 rounds after emission and is not lost:
    node 0 writes once; its near ring peer applies the version in the
    same round, its far ring peer exactly at round 3."""
    cfg = _port_cfg(SimConfig(
        num_nodes=4, num_rows=4, num_cols=1, log_capacity=16,
        write_rate=0.0, latency_regions=2, latency_intra=1,
        latency_inter=4, fanout=1, pend_slots=4, ring0_size=2,
        sync_interval=1024))
    state = init_state(cfg, seed=0, device="cpu")
    state.ring0 = torch.tensor([[1, 2], [0, 3], [3, 0], [2, 1]],
                               dtype=torch.int32)
    n, s = 4, cfg.seqs_per_version
    alive = torch.ones(n, dtype=torch.bool)
    part = torch.zeros(n, dtype=torch.int32)
    zero_w = (torch.zeros(n, dtype=torch.bool),
              torch.zeros((n, s), dtype=torch.int32),
              torch.zeros((n, s), dtype=torch.int32),
              torch.zeros((n, s), dtype=torch.int32),
              torch.zeros(n, dtype=torch.bool),
              torch.zeros(n, dtype=torch.int32))
    first_w = (torch.tensor([True, False, False, False]), zero_w[1],
               zero_w[2], torch.ones((n, s), dtype=torch.int32), zero_w[4],
               torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    root = prng.PRNGKey(1)
    near, far = [], []
    for r in range(5):
        state, _ = sim_step(cfg, state, prng.fold_in(root, r), alive, part,
                            False, r, writes=first_w if r == 0 else zero_w)
        near.append(int(state.book.head[1, 0]))
        far.append(int(state.book.head[2, 0]))
    assert near[0] == 1
    assert far[:4] == [0, 0, 0, 1]


def _part(r, num):
    p = np.zeros(num, np.int32)
    if 4 <= r < 12:
        p[num // 2:] = 1
    return p


def _north_star(**kw):
    """Config 0's shape (SWIM on, narrow layout, the upper half cut in
    rounds 4-11) at 32 nodes, with the sweep on its interval only, so
    the gossip rings drain rounds before the cluster converges."""
    return SimConfig(
        num_nodes=N, num_rows=32, num_cols=4, log_capacity=512,
        write_rate=0.5, zipf_alpha=0.8, swim_enabled=True,
        swim_suspect_rounds=6, swim_interval=4, narrow_state=True,
        sync_interval=8, pend_slots=8, fanout=2, sync_adaptive=False,
        sync_actor_topk=16, sync_cap_per_actor=1, sync_req_actors=16,
        sync_need_sample=16, **kw,
    )


@pytest.mark.parametrize("case", ["ring", "ring_rtt"])
def test_run_sim_latency_matches(case):
    """Whole runs under the in-flight ring (four regions), and with RTT
    rings recomputed every 4 rounds (two regions). Neither may switch to
    the repair step: the gossip rings report drained at a chunk boundary
    past the write phase well before convergence, so a select_repair that
    ignored the ring or the RTT rings would take it there, and the runs
    would part (the port's repair step refuses the ring outright)."""
    kw = (dict(latency_regions=4) if case == "ring" else
          dict(latency_regions=2, rtt_rings=True, ring_update_interval=4))
    cfg = _north_star(**kw)
    run_kw = dict(max_rounds=256, chunk=4, seed=0, min_rounds=16)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0),
                      RefSchedule(write_rounds=8, part_fn=_part), **run_kw)
    pcfg = _port_cfg(cfg)
    got = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                  Schedule(write_rounds=8, part_fn=_part), device="cpu",
                  **run_kw)
    assert ref.converged_round is not None and ref.repair_chunks == 0
    pend = np.asarray(ref.metrics["pend_live"])
    drained = [r for r in range(11, ref.converged_round - 4, 4)
               if pend[r] == 0]
    assert drained, "no drained chunk boundary before convergence"
    _assert_runs_equal(ref, got)
    if case == "ring_rtt":
        seeded = init_state(pcfg, seed=0, device="cpu").ring0
        assert not torch.equal(got.state.ring0, seeded)
        observed = got.state.rtt.numpy()
        assert (observed != 255).sum() > N


def test_lossy_soak_under_the_latency_ring_matches():
    """A lossy soak (p 0.1) under the in-flight ring with the invariant
    checker armed: state, metrics and the checker's report equal, and
    the ring's conservation counters balance every round."""
    base = SimConfig(num_nodes=N, num_rows=32, num_cols=2, log_capacity=64,
                     write_rate=0.3, swim_enabled=True, sync_interval=4,
                     latency_regions=2)
    spec, args = "lossy:p=0.1", dict(rounds=48, write_rounds=8, seed=1)
    sc = ref_scenarios.make_scenario(spec, N, **args)
    c = sc.apply(base)
    assert c.faults == RefFaultConfig(loss=0.1)
    inv = RefChecker(c)
    ref = ref_run_sim(c, ref_init_state(c, seed=1), sc.schedule(),
                      max_rounds=160, chunk=8, seed=1, min_rounds=8,
                      invariants=inv)
    soak = run_soak(_port_cfg(base), spec, device="cpu", max_rounds=160,
                    chunk=8, **args)
    _assert_runs_equal(ref, soak.result)
    assert soak.invariants.report() == inv.report()
    assert soak.invariants.ok
    m = soak.result.metrics
    assert m["fault_parked"].sum() > 0 and m["fault_matured"].sum() > 0
    lhs = m["msgs_sent"] + m["fault_matured"]
    rhs = sum(m[k] for k in ("fault_parked", "fault_emit_lost",
                             "fault_delivered", "fault_unreachable",
                             "fault_blackholed", "fault_lost"))
    _eq(lhs, rhs, "conservation")


def test_latency_digest_on_the_cpu():
    """Config 0 across four regions with RTT rings and 8 probes at 256
    nodes, as chip_smoke.py's slice8_digests phase runs it: the JAX
    package's pinned digest and converged round."""
    cfg = slice8_config("latency_256")
    res = run_sim(cfg, init_state(cfg, seed=0, device="cpu"),
                  slice_schedule(), device="cpu", **RUN_ARGS)
    assert res.converged_round == SLICE8_ROUNDS["latency_256"]
    assert run_digest(state_to_numpy(res.state), res.metrics) == (
        DIGESTS["latency_256"])
