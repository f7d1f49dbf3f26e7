"""Parity of the legacy and deal-probe sync schedules and the RTT-aware
sweep: corro_sim_torch.sync.sync against corro_sim.sync.sync on the CPU.

The inputs are a mid-run cluster (32 nodes of the north-star shape, 12
rounds in, books lagging) plus masks and planes drawn from a seeded
numpy generator; both sides get the same numbers and every output must
be equal (tolerance: exact, integer arithmetic). The schedules are held
at a nonzero sweep phase, where the legacy schedule's prefix counts are
in rotated scan order. Whole runs of both schedules are held leaf for
leaf and round for round, through the repair switch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.config import SimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.sync import sync as r_sync
from corro_sim_torch import prng
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.sync import sync as p_sync
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

N = 32


def _part(r, num):
    p = np.zeros(num, np.int32)
    if 4 <= r < 12:
        p[num // 2:] = 1
    return p


def _cfg(**kw):
    """The north-star shape at 32 nodes with room for several versions
    per actor in a sweep (cap 2), a budget below K' (kp 8 of 16) so the
    per-slot budget rank binds."""
    return SimConfig(
        num_nodes=N, num_rows=32, num_cols=4, log_capacity=64,
        write_rate=0.5, delete_rate=0.1, zipf_alpha=0.8,
        swim_enabled=False, sync_interval=8, pend_slots=8, fanout=2,
        sync_adaptive=True, sync_floor_rounds=1, sync_actor_topk=8,
        sync_cap_per_actor=2, sync_req_actors=16, sync_need_sample=16,
        sync_peers=4, **kw,
    )


def _port_cfg(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


def _t(x):
    return torch.as_tensor(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _eq(got, want, what):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), err_msg=what)


@pytest.fixture(scope="module")
def mid():
    """(port state, reference state) of the same 12-round-old cluster."""
    cfg = _port_cfg(_cfg())
    res = run_sim(
        cfg, init_state(cfg, seed=1, device="cpu"),
        Schedule(write_rounds=16, part_fn=_part), max_rounds=12, chunk=12,
        seed=1, stop_on_convergence=False, device="cpu",
    )
    leaves = state_to_numpy(res.state)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        ref_init_state(_cfg(), seed=1))
    ref = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves[jax.tree_util.keystr(p).lstrip(".")])
        for p, _ in flat
    ])
    return res.state, ref


@pytest.mark.parametrize("phase", [0, 3, 7])
def test_deal_serving_slots_matches(phase):
    rng = np.random.default_rng(phase)
    granted = rng.random((N, 5)) < 0.5
    granted[0] = False  # nothing granted: the sentinel on every lane
    granted[1] = True
    got = p_sync.deal_serving_slots(_t(granted),
                                    torch.tensor(phase, dtype=torch.int32), 12)
    want = r_sync.deal_serving_slots(_j(granted), jnp.int32(phase), 12)
    for g, w, what in zip(got, want, ("slot", "rank_in_slot")):
        _eq(g, w, what)
    assert (got[0][0] == 5).all()


def _rotated_prefix_counts(pos, phase):
    """The legacy schedule's inclusive prefix counts in rotated scan
    order, as corro_sim/sync/sync.py:287-297 builds them."""
    c = jnp.cumsum(jnp.asarray(pos).astype(jnp.int32), axis=1)
    a = pos.shape[1]
    cpm1 = jnp.where(phase > 0, c[:, max(phase - 1, 0)][:, None], 0)
    wraps = jnp.arange(a)[None, :] < phase
    return c - cpm1 + jnp.where(wraps, c[:, -1:], 0)


@pytest.mark.parametrize("phase", [0, 5, 29])
def test_kth_positive_rolled_matches_the_fused_compare(phase):
    """The port's binary search, rolled by the phase, against the JAX
    package's fused compare-reduce (the branch it runs below 2**33
    lanes) on rotated prefix counts. At a nonzero phase the unrolled
    search answers differently: the roll is what makes it right."""
    rng = np.random.default_rng(phase)
    pos = rng.random((N, 40)) < 0.3
    pos[0] = False  # no positive: every lane past the axis
    kprime = 12
    csum = _rotated_prefix_counts(pos, phase)
    want = r_sync._kth_positive(csum, kprime, N, 40, roll_phase=phase)
    got = p_sync._kth_positive(_t(csum), kprime,
                               roll_phase=torch.tensor(phase))
    _eq(got, want, "kth")
    assert (got[0] == 40).all()
    if phase:
        unrolled = p_sync._kth_positive(_t(csum), kprime)
        assert not torch.equal(unrolled, got)


def _grants(rng, p_cnt=4):
    peer = rng.integers(0, N, (N, p_cnt)).astype(np.int32)
    granted = rng.random((N, p_cnt)) < 0.7
    granted[2] = False
    return peer, granted


@pytest.mark.parametrize("deal_probes", [0, 2, 3])
def test_legacy_schedule_matches(mid, deal_probes):
    """Both serving assignments at a nonzero phase, with a budget rank
    that binds (kp 8 < K' 16)."""
    port, ref = mid
    cfg = _cfg(sync_hot_actors=0, sync_deal_probes=deal_probes)
    peer, granted = _grants(np.random.default_rng(deal_probes))
    phase = 11
    kp, kprime = 8, 16
    want = r_sync._legacy_schedule(
        cfg, ref.book, ref.log, _j(peer), _j(granted), jnp.int32(phase),
        jnp.arange(N, dtype=jnp.int32), N, N, 4, kp, kprime)
    got = p_sync._legacy_schedule(
        _port_cfg(cfg), port.book, port.log, _t(peer), _t(granted),
        torch.tensor(phase, dtype=torch.int32), 0, kp, kprime)
    for g, w, what in zip(got, want, ("topa", "slot", "topv", "lane_ok",
                                      "within_budget")):
        _eq(g, w, what)
    assert got[3].any() and (got[2] > 0).any()
    assert not got[4].all()  # the per-slot budget cuts some lanes


def _rtt_plane(rng, regions=4):
    """A partly observed (N, N) delay plane of a 4-region cluster."""
    region = np.arange(N) * regions // N
    delay = np.where(region[:, None] == region[None, :], 1, 4)
    return np.where(rng.random((N, N)) < 0.6, delay, 255).astype(np.uint8)


@pytest.mark.parametrize("case", [
    "hot_rtt", "legacy", "legacy_rtt", "deal_rtt",
])
def test_sync_round_matches(mid, case):
    """One sweep under each schedule, and with an RTT plane: candidate
    ranking by delay on equal need, and the halved per-lane caps."""
    port, ref = mid
    kw = {"hot_rtt": {}, "legacy": dict(sync_hot_actors=0),
          "legacy_rtt": dict(sync_hot_actors=0),
          "deal_rtt": dict(sync_hot_actors=0, sync_deal_probes=2)}[case]
    cfg = _cfg(**kw)
    rng = np.random.default_rng(len(case))
    alive = rng.random(N) < 0.9
    part = _part(6, N)
    pairs = alive[:, None] & alive[None, :] & (part[:, None] == part[None, :])
    view = np.ones((1, N), bool)
    rtt = _rtt_plane(rng) if case.endswith("rtt") else None
    key = prng.PRNGKey(9)
    out_r = jax.jit(r_sync.sync_round, static_argnums=0)(
        cfg, ref.book, ref.log, ref.table, ref.hlc, ref.last_cleared,
        ref.cleared_hlc, jnp.asarray(key), _j(alive), _j(view), _j(pairs),
        rtt=None if rtt is None else _j(rtt), round_idx=ref.sync_rounds,
    )
    table = dataclasses.replace(port.table, **{
        f: getattr(port.table, f).clone() for f in ("cv", "vr", "site", "cl")})
    out_p = p_sync.sync_round(
        _port_cfg(cfg), port.book, port.log, table, port.hlc,
        port.last_cleared, port.cleared_hlc, key, _t(alive), _t(view),
        _t(pairs), rtt=None if rtt is None else _t(rtt),
        round_idx=port.sync_rounds,
    )
    book_r, table_r, hlc_r, lc_r, m_r = out_r
    book_p, table_p, hlc_p, lc_p, m_p = out_p
    _eq(book_p.head, book_r.head, "book.head")
    _eq(book_p.win.to(torch.int64), np.asarray(book_r.win).astype(np.int64),
        "book.win")
    for f in ("cv", "vr", "site", "cl"):
        _eq(getattr(table_p, f), getattr(table_r, f), f"table.{f}")
    _eq(hlc_p, hlc_r, "hlc")
    _eq(lc_p, lc_r, "last_cleared")
    assert set(m_p) == set(m_r)
    for k in m_r:
        _eq(m_p[k], m_r[k], k)
    assert int(m_p["sync_versions"]) > 0


@pytest.mark.parametrize("deal_probes", [0, 2])
def test_run_sim_legacy_schedules_match(deal_probes):
    """Whole runs on the legacy schedule (exact argmax, and two deal
    probes) with SWIM on, through the repair switch: every state leaf,
    every metric of every round, the converged round and the repair
    chunks equal."""
    cfg = dataclasses.replace(
        _cfg(sync_hot_actors=0, sync_deal_probes=deal_probes),
        swim_enabled=True, swim_suspect_rounds=6, swim_interval=4,
        narrow_state=True, sync_adaptive=False)
    kw = dict(max_rounds=256, chunk=4, seed=0, min_rounds=16)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0),
                      RefSchedule(write_rounds=8, part_fn=_part), **kw)
    pcfg = _port_cfg(cfg)
    got = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                  Schedule(write_rounds=8, part_fn=_part), device="cpu",
                  **kw)
    assert ref.converged_round is not None and ref.repair_chunks > 0
    assert got.converged_round == ref.converged_round
    assert got.repair_chunks == ref.repair_chunks
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        _eq(got.metrics[k], v, k)
    want = {jax.tree_util.keystr(p).lstrip("."): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(ref.state)[0]}
    have = state_to_numpy(got.state)
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        _eq(have[k], want[k], k)
