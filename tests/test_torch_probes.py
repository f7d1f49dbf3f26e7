"""Parity of the probe tracer: corro_sim_torch.engine.probe and
corro_sim_torch.obs.probes against corro_sim's on the CPU.

The tracer's updates on seeded planes (the int8 hop plane saturating at
127 under ``narrow_state``), the delivery pass's probe merge point on a
mid-run cluster, a whole run with probes through the repair switch (its
ProbeTrace and its flight events, ``probe_p99_regression`` among them),
and the host layer's reports and exports on that run's trace.
Tolerance: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.config import SimConfig
from corro_sim.core import delivery as r_delivery
from corro_sim.engine import probe as r_probe
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.obs import probes as r_obs
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.core import delivery as p_delivery
from corro_sim_torch.engine import probe as p_probe
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.obs import probes as p_obs
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

N, K = 32, 4


def _port_cfg(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


def _eq(got, want, what):
    np.testing.assert_array_equal(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), err_msg=what)


def _eq_probe(got, want):
    for f in p_obs.PROBE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == torch.as_tensor(np.array(w)).dtype, f
        _eq(g, w, f)


def _planes(rng, narrow):
    """A probe state part way through a run: some nodes infected, hops
    up to the int8 plane's edge under ``narrow``."""
    port = p_probe.make_probe_state(K, N, narrow=narrow)
    first = np.where(rng.random((K, N)) < 0.4,
                     rng.integers(0, 9, (K, N)), -1).astype(np.int32)
    hop = np.where(first >= 0, rng.integers(0, 5, (K, N)), -1)
    if narrow:
        hop[:, :6] = np.where(first[:, :6] >= 0, [125, 126, 127, 127, 0, 1],
                              -1)
    port.first_seen = torch.as_tensor(first)
    port.hop = torch.as_tensor(hop.astype(np.int8 if narrow else np.int32))
    port.infector = torch.as_tensor(
        np.where(first >= 0, rng.integers(-2, N, (K, N)), -1).astype(np.int32))
    port.dup = torch.as_tensor(rng.integers(0, 5, K).astype(np.int32))
    ref = r_probe.make_probe_state(K, N, narrow=narrow).replace(**{
        f: jnp.asarray(getattr(port, f).numpy()) for f in p_obs.PROBE_FIELDS})
    return port, ref


@pytest.mark.parametrize("narrow", [False, True], ids=["wide", "narrow"])
def test_make_probe_state_matches(narrow):
    for k in (0, K):
        _eq_probe(p_probe.make_probe_state(k, N, narrow=narrow),
                  r_probe.make_probe_state(k, N, narrow=narrow))


@pytest.mark.parametrize("narrow", [False, True], ids=["wide", "narrow"])
def test_probe_updates_match(narrow):
    """Origin marking, the delivery merge point (same-round ties to the
    minimum src, duplicates counted, hop + 1 saturating at 127 on the
    int8 plane), the sync merge point, the sweep stamp and the metrics."""
    rng = np.random.default_rng(7 + narrow)
    port, ref = _planes(rng, narrow)
    writers = rng.random(N) < 0.5
    w_ver = rng.integers(0, 3, N).astype(np.int32)
    got = p_probe.probe_write_update(port, 9, torch.as_tensor(writers),
                                     torch.as_tensor(w_ver))
    want = r_probe.probe_write_update(ref, jnp.int32(9), jnp.asarray(writers),
                                      jnp.asarray(w_ver))
    _eq_probe(got, want)

    m = 4000
    dst = rng.integers(0, N, m).astype(np.int32)
    src = rng.integers(0, N, m).astype(np.int32)
    src[:300] = rng.integers(0, 6, 300)  # infectors at the plane's edge
    actor = np.asarray(port.actor)[rng.integers(0, K, m)]
    actor[::7] = rng.integers(0, N, len(actor[::7]))
    ver = rng.integers(1, 3, m).astype(np.int32)
    delivered = rng.random(m) < 0.8
    complete = delivered & (rng.random(m) < 0.7)
    args = (dst, src, actor.astype(np.int32), ver, delivered, complete)
    got = p_probe.probe_delivery_update(got, 10,
                                        *map(torch.as_tensor, args))
    want = r_probe.probe_delivery_update(want, jnp.int32(10),
                                         *map(jnp.asarray, args))
    _eq_probe(got, want)
    if narrow:
        assert (got.hop == 127).sum() > (port.hop == 127).sum()
        assert (got.hop >= -1).all()  # saturated, never wrapped

    head = rng.integers(0, 3, (N, N)).astype(np.int32)
    alive = rng.random(N) < 0.8
    got = p_probe.probe_book_update(got, torch.as_tensor(head), 11)
    want = r_probe.probe_book_update(want, jnp.asarray(head), jnp.int32(11))
    _eq_probe(got, want)
    for is_sync in (False, True):
        got = p_probe.probe_sync_mark(got, is_sync, torch.as_tensor(alive),
                                      12 + is_sync)
        want = r_probe.probe_sync_mark(want, jnp.asarray(is_sync),
                                       jnp.asarray(alive),
                                       jnp.int32(12 + is_sync))
        _eq_probe(got, want)
    mg, mw = p_probe.probe_metrics(got), r_probe.probe_metrics(want)
    assert set(mg) == set(mw)
    for k in mw:
        _eq(mg[k], mw[k], k)


def _cfg(**kw):
    return SimConfig(
        num_nodes=N, num_rows=32, num_cols=4, log_capacity=512,
        write_rate=0.5, zipf_alpha=0.8, swim_enabled=True,
        swim_suspect_rounds=6, swim_interval=4, narrow_state=True,
        sync_interval=8, pend_slots=8, fanout=2, sync_adaptive=False,
        sync_actor_topk=16, sync_cap_per_actor=1, sync_req_actors=16,
        sync_need_sample=16, probes=K, **kw,
    )


def _part(r, num):
    p = np.zeros(num, np.int32)
    if 4 <= r < 12:
        p[num // 2:] = 1
    return p


def test_delivery_pass_with_probes_matches():
    """The probe merge point on the sorted stream of a mid-run cluster,
    and the pre-cap mask the RTT samples read."""
    cfg = _cfg(apply_queue_cap=8)
    pcfg = _port_cfg(cfg)
    res = run_sim(pcfg, init_state(pcfg, seed=1, device="cpu"),
                  Schedule(write_rounds=16, part_fn=_part), max_rounds=8,
                  chunk=8, seed=1, stop_on_convergence=False, device="cpu")
    port = res.state
    leaves = state_to_numpy(port)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        ref_init_state(cfg, seed=1))
    ref = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves[jax.tree_util.keystr(p).lstrip(".")])
        for p, _ in flat])
    rng = np.random.default_rng(3)
    m = 1500
    heads = port.book.head.numpy()
    dst = rng.integers(0, N, m).astype(np.int32)
    src = rng.integers(0, N, m).astype(np.int32)
    actor = np.asarray(port.probe.actor)[rng.integers(0, K, m)]
    actor[::3] = rng.integers(0, N, len(actor[::3]))
    ver = np.maximum(heads[dst, actor] + rng.integers(-1, 3, m), 1)
    ver = np.minimum(ver, port.log.head.numpy()[actor]).astype(np.int32)
    delivered = (rng.random(m) < 0.9) & (ver > 0)
    args = (dst, src, actor.astype(np.int32), ver, np.zeros(m, np.int32),
            delivered)
    out_r = jax.jit(r_delivery.delivery_pass, static_argnums=0)(
        cfg, ref.table, ref.book, ref.log, ref.probe, ref.hlc,
        *map(jnp.asarray, args), ref.round)
    out_p = p_delivery.delivery_pass(
        pcfg, port.table, port.book, port.log, port.hlc,
        *map(torch.as_tensor, args), probe=port.probe, round_=port.round)
    _eq_probe(out_p.probe, out_r.probe)
    for f in ("dst", "src", "delivered", "delivered_precap", "complete",
              "fresh_chunk", "hlc_recv"):
        _eq(getattr(out_p, f), getattr(out_r, f), f)
    assert (out_p.delivered_precap & ~out_p.delivered).any()  # cap binds
    assert (out_p.probe.first_seen != port.probe.first_seen).any()


@pytest.fixture(scope="module")
def runs():
    """One run with probes through the repair switch, on both sides (the
    port's pipelined and sequential)."""
    cfg = _cfg()
    kw = dict(max_rounds=256, chunk=4, seed=0, min_rounds=16)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0),
                      RefSchedule(write_rounds=8, part_fn=_part), **kw)
    pcfg = _port_cfg(cfg)
    got = {
        pipeline: run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                          Schedule(write_rounds=8, part_fn=_part),
                          device="cpu", pipeline=pipeline, **kw)
        for pipeline in (True, False)
    }
    return ref, got


def _events(fl):
    """``(round, name)`` of each flight event but the pipeline's own, and
    the attributes of the probe regressions."""
    return [
        (e["r"], e["name"],
         e["attrs"] if e["name"] == "probe_p99_regression" else None)
        for e in fl.events()
        if e["name"] not in ("compile", "pipeline", "pipeline_discard")
    ]


@pytest.mark.parametrize("pipeline", [True, False])
def test_run_sim_with_probes_matches(runs, pipeline):
    ref, got = runs[0], runs[1][pipeline]
    assert ref.converged_round is not None and ref.repair_chunks > 0
    assert got.converged_round == ref.converged_round
    assert got.repair_chunks == ref.repair_chunks
    assert set(got.metrics) == set(ref.metrics) >= {"probe_infected",
                                                    "probe_dups"}
    for k, v in ref.metrics.items():
        _eq(got.metrics[k], v, k)
    want = {jax.tree_util.keystr(p).lstrip("."): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(ref.state)[0]}
    have = state_to_numpy(got.state)
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        _eq(have[k], want[k], k)
    for f in p_obs.PROBE_FIELDS:
        _eq(getattr(got.probe, f), getattr(ref.probe, f), f)
    assert got.probe.meta == ref.probe.meta
    ev = _events(got.flight)
    assert ev == _events(ref.flight)
    assert "probe_p99_regression" in {e[1] for e in ev}


def test_probe_trace_reports_match(runs):
    """The host layer on the run's trace: per-probe summaries with the
    BFS stretch, infection trees, coverage curves, both exports, and the
    lag observatory."""
    ref, got = runs[0], runs[1][True]
    tr_p, tr_r = got.probe, ref.probe
    adj_p = p_obs.ground_truth_adjacency(np.ones(N, bool),
                                         np.zeros(N, np.int32),
                                         blackhole=((0, 5), (-1, 7)))
    adj_r = r_obs.ground_truth_adjacency(np.ones(N, bool),
                                         np.zeros(N, np.int32),
                                         blackhole=((0, 5), (-1, 7)))
    _eq(adj_p, adj_r, "adjacency")
    for k in range(K):
        _eq(p_obs.bfs_hops(adj_p, k), r_obs.bfs_hops(adj_r, k), "bfs")
        assert tr_p.coverage_curve(k) == tr_r.coverage_curve(k)
    assert tr_p.report(adj_p) == tr_r.report(adj_r)
    assert tr_p.to_ndjson() == tr_r.to_ndjson()
    assert tr_p.to_chrome_trace() == tr_r.to_chrome_trace()
    assert tr_p.delivery_p99() == tr_r.delivery_p99() is not None
    assert any(tr_p.stretch(k, adj_p) for k in range(K))
    state, rstate = got.state, ref.state
    lag = dict(log_head=state.log.head.numpy(),
               book_head=state.book.head.numpy(), alive=np.ones(N, bool),
               current_round=got.rounds,
               last_sync=state.probe.last_sync.numpy(),
               suspected_by=np.arange(N) % 3, top_k=5)
    assert p_obs.node_lag_observatory(**lag) == r_obs.node_lag_observatory(
        **dict(lag, log_head=np.asarray(rstate.log.head),
               book_head=np.asarray(rstate.book.head)))


def test_convert_and_clone_carry_rtt_inflight_and_probe_planes():
    """A JAX state with the RTT plane, the in-flight ring and the probe
    planes (int8 hops) crosses to the port and back unchanged, the
    port's init_state builds the same leaves, and clone_state copies
    every one of them (the pipelined loop speculates on the copy)."""
    from corro_sim_torch.convert import state_from_reference
    from corro_sim_torch.engine.state import clone_state

    cfg = dataclasses.replace(_cfg(), latency_regions=2, rtt_rings=True)
    ref = ref_init_state(cfg, seed=3)
    want = {jax.tree_util.keystr(p).lstrip("."): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    rng = np.random.default_rng(5)
    want["rtt"] = rng.choice(np.array([1, 2, 255], np.uint8), (N, N))
    want["inflight"] = rng.integers(0, N, want["inflight"].shape).astype(
        np.int32)
    want["probe.hop"] = rng.integers(-1, 128, (K, N)).astype(np.int8)
    state = state_from_reference(want, "cpu")
    have = state_to_numpy(state)
    built = state_to_numpy(init_state(_port_cfg(cfg), seed=3, device="cpu"))
    assert set(have) == set(want) == set(built)
    for k in want:
        assert have[k].dtype == want[k].dtype == built[k].dtype, k
        _eq(have[k], want[k], k)
    _eq(built["probe.actor"], np.asarray(ref.probe.actor), "probe.actor")
    copy = clone_state(state)
    for f in p_obs.PROBE_FIELDS:
        assert (getattr(copy.probe, f).data_ptr()
                != getattr(state.probe, f).data_ptr()), f
    assert copy.rtt.data_ptr() != state.rtt.data_ptr()
    assert copy.inflight.data_ptr() != state.inflight.data_ptr()
