"""Parity of the workload engine: corro_sim_torch.workload and the
``writes`` port against the JAX package on the CPU.

- the generators (host numpy) give byte-identical schedules and events;
- ``broadcast_step`` under an ``emit_slots`` cap services the same slots
  and spends the same budgets, its phase vector held at 60 000 nodes,
  where the JAX package's int32 ``node * 0x9E37`` wraps;
- ``sim_step(writes=...)`` and whole ``run_sim(workload=...)`` runs of
  config 6's shape (``corro_sim/benchmarks.py:800-834``, keys scaled to
  the node count) are bit-identical: every state leaf, every metric of
  every round, ``converged_round`` and ``repair_chunks``;
- an all-idle schedule through the writes port is bit-identical to the
  sampler with writes disabled (the runtime form of the JAX package's
  ``assert_workload_vacuous``);
- a first-write schedule injected through ``inject_round`` (replay's
  path) converges to the state the writes port reaches.

Tolerance: exact — integer arithmetic plus float32 threshold compares,
and ``gap`` sums stay far below 2**24 at these sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim import workload as r_workload
from corro_sim.config import SimConfig
from corro_sim.engine import step as r_step
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.gossip import broadcast as r_bcast
from corro_sim.utils import spec as r_spec
from corro_sim_torch import prng
from corro_sim_torch import workload as p_workload
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_from_reference, state_to_numpy
from corro_sim_torch.engine import step as p_step
from corro_sim_torch.engine.driver import Schedule, round_key, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.gossip import broadcast as p_bcast
from corro_sim_torch.utils import spec as p_spec
from corro_sim_torch.workload.inject import (
    inject_round,
    workload_as_injection,
)
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

FIELDS = ("writers", "rows", "cols", "vals", "dels", "ncells")

# config 6's spec with its 2048 keys and 64-key churn batches scaled down
SPEC6_SMALL = ("zipf:alpha=1.1,rate=0.3,keys=64"
               "+churn_storm:waves=6,batch=8,keys=64")
SPEC_DELETES = ("zipf:alpha=1.1,rate=0.4,keys=64,delete_rate=0.2"
                "+churn_storm:waves=3,batch=8,keys=64")


def _port_cfg(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def config6_small(n, merge_kernel="auto", rounds=64, spec=SPEC6_SMALL):
    """Config 6's batched half exactly as ``run_config_6`` builds it, with
    the schedule's key count scaled down; returns ``(cfg, spec)``."""
    wl = r_workload.make_workload(spec, n, rounds=rounds, seed=0)
    cfg = SimConfig(
        num_nodes=n, num_rows=max(wl.key_universe(), 256), num_cols=2,
        log_capacity=max(rounds * 2, 256), pend_slots=8, emit_slots=4,
        fanout=3, sync_interval=4, sync_adaptive=True,
        merge_kernel=merge_kernel,
    )
    return cfg.validate(), spec


# ------------------------------------------------------------ generators


GENERATOR_SPECS = [
    "zipf", "zipf:alpha=0.7,rate=0.6,keys=40,delete_rate=0.3",
    "uniform:rate=0.5", "burst", "burst:on=3,off=5,rate_hi=0.8,keys=20",
    "multiwriter", "multiwriter:hot=2,writers=5",
    "churn_storm", "churn_storm:waves=3,batch=5,keys=30,gap=4",
    SPEC6_SMALL, SPEC_DELETES,
]


@pytest.mark.parametrize("spec", GENERATOR_SPECS)
def test_generators_are_byte_identical(spec):
    for n, rounds, seed in ((12, 16, 0), (12, 16, 3), (40, 24, 7)):
        want = r_workload.make_workload(spec, n, rounds=rounds, seed=seed)
        got = p_workload.make_workload(spec, n, rounds=rounds, seed=seed)
        for f in FIELDS:
            w, g = getattr(want, f), getattr(got, f)
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        assert got.events == want.events
        assert got.spec == want.spec and got.name == want.name
        assert got.rounds == want.rounds
        assert got.key_universe() == want.key_universe()
        assert (got.total_writes, got.total_deletes) == (
            want.total_writes, want.total_deletes)
        for r in (0, rounds - 1, rounds + 2):
            for a, b in zip(got.writes_at(r, 3), want.writes_at(r, 3)):
                np.testing.assert_array_equal(a, b)
        for start, length in ((0, 8), (rounds - 3, 8), (rounds + 8, 8)):
            for a, b in zip(got.slice(start, length, 2),
                            want.slice(start, length, 2)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert got.writes_in(start, length) == want.writes_in(
                start, length)
            assert got.events_in(start, length) == want.events_in(
                start, length)


def test_spec_grammar_and_validation():
    for spec in ("zipf:alpha=1.1,rate=0.4,keys=64", "burst", "x:a=b,c=2"):
        assert p_spec.parse_spec(spec) == r_spec.parse_spec(spec)
        name, params = p_spec.parse_spec(spec)
        assert p_spec.format_spec(name, params) == r_spec.format_spec(
            name, params)
    assert p_workload.parse_workload_spec(SPEC6_SMALL) == (
        r_workload.parse_workload_spec(SPEC6_SMALL))
    for bad in (":a=1", "zipf:alpha"):
        with pytest.raises(ValueError):
            p_spec.parse_spec(bad)
    with pytest.raises(ValueError):
        p_workload.parse_workload_spec("no_such_generator")

    wl = p_workload.make_workload(SPEC6_SMALL, 12, rounds=16, seed=0)
    cfg = _port_cfg(SimConfig(num_nodes=12, num_rows=64, num_cols=2))
    assert wl.validate(cfg) is wl
    for change in (dict(num_nodes=13), dict(num_rows=wl.key_universe() - 1),
                   dict(num_cols=0)):
        with pytest.raises(ValueError):
            wl.validate(dataclasses.replace(cfg, **change))
    wide = dataclasses.replace(wl, cols=np.zeros((16, 12, 2), np.int32))
    with pytest.raises(ValueError):
        wide.validate(cfg)  # 2 cells per changeset > seqs_per_version 1
    idle = p_workload.empty_workload(6, rounds=5)
    assert not idle.writers.any() and idle.key_universe() == 1
    assert idle.writes_at(0, 3)[1].shape == (6, 3)


# ----------------------------------------------------- the emit window


def _ring(rng, n, p):
    pend = np.stack([
        rng.integers(0, n, (n, p)), rng.integers(1, 9, (n, p)),
        rng.integers(0, 2, (n, p)), rng.integers(0, 3, (n, p)),
    ], axis=-1).astype(np.int32)
    cursor = rng.integers(0, p, n).astype(np.int32)
    return pend, cursor


@pytest.mark.parametrize("p,e", [(8, 4), (8, 3), (16, 5), (8, 8), (8, 0)])
def test_broadcast_step_emit_window(p, e):
    n, fanout = 24, 3
    rng = np.random.default_rng(p * 31 + e)
    pend, cursor = _ring(rng, n, p)
    alive = rng.random(n) < 0.9
    view = np.ones((1, n), bool)
    for round_idx in (0, 1, 5, 37, 2 ** 31 - 3):
        key = prng.fold_in(prng.PRNGKey(5), round_idx % 1000)
        ref = r_bcast.GossipState(
            pend=_j(pend), cursor=_j(cursor), overflow=jnp.int32(3))
        port = p_bcast.GossipState(
            pend=_t(pend), cursor=_t(cursor),
            overflow=torch.tensor(3, dtype=torch.int32))
        out_r = r_bcast.broadcast_step(
            ref, jnp.asarray(key), _j(alive), _j(view), fanout,
            emit_slots=e, round_idx=round_idx,
        )
        out_p = p_bcast.broadcast_step(
            port, key, _t(alive), _t(view), fanout, emit_slots=e,
            round_idx=round_idx,
        )
        np.testing.assert_array_equal(out_p[0].pend.numpy(),
                                      np.asarray(out_r[0].pend))
        np.testing.assert_array_equal(out_p[0].cursor.numpy(),
                                      np.asarray(out_r[0].cursor))
        for a, b in zip(out_p[1:], out_r[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if 0 < e < p:  # the window leaves the other slots' budgets
            spent = pend[..., 3] - out_p[0].pend[..., 3].numpy()
            assert (spent.sum(axis=1) <= e).all()


@pytest.mark.parametrize("p,e", [(8, 4), (12, 5)])
def test_emit_window_phase_wraps_like_int32(p, e):
    """At 60 000 nodes ``node * 0x9E37`` passes 2**31: each node's
    serviced window must match the JAX package's wrapped int32 phase.
    The ring holds each slot's index in its actor field, so the emitted
    actors name the serviced slots. (A ring size dividing 2**32, such as
    config 6's 8, hides the wrap; 12 shows it.)"""
    n = 60000
    pend = np.zeros((n, p, 4), np.int32)
    pend[..., 0] = np.arange(p, dtype=np.int32)
    pend[..., 3] = 1
    zeros = np.zeros(n, np.int32)
    alive = np.ones(n, bool)
    view = np.ones((1, n), bool)
    key = prng.PRNGKey(2)
    node = np.arange(n, dtype=np.int64)
    for round_idx in (0, 3, 1001):
        out_r = r_bcast.broadcast_step(
            r_bcast.GossipState(pend=_j(pend), cursor=_j(zeros),
                                overflow=jnp.int32(0)),
            jnp.asarray(key), _j(alive), _j(view), 1, emit_slots=e,
            round_idx=round_idx,
        )
        want = np.asarray(out_r[3]).reshape(n, e)
        got = p_bcast.serviced_slots(n, p, e, round_idx, "cpu").numpy()
        np.testing.assert_array_equal(got, want)
        unwrapped = ((round_idx * e) % p + (node * 0x9E37) % p) % p
        if p == 12:  # the wrap is live: unwrapped products differ
            assert (got[:, 0] != unwrapped).any()


# ------------------------------------------------------ the writes port


def _mid_pair(cfg, rounds=8, seed=1):
    """(port state, reference state) of the same cluster after ``rounds``
    sampler rounds, run by the port and carried to the JAX pytree."""
    pcfg = _port_cfg(cfg)
    res = run_sim(
        pcfg, init_state(pcfg, seed=seed, device="cpu"),
        Schedule(write_rounds=32), max_rounds=rounds, chunk=rounds,
        seed=seed, stop_on_convergence=False, device="cpu",
    )
    leaves = state_to_numpy(res.state)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        ref_init_state(cfg, seed=seed)
    )
    ref = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves[jax.tree_util.keystr(p).lstrip(".")])
        for p, _ in flat
    ])
    return res.state, ref


def test_sim_step_writes_port():
    """Three rounds of the step fed a schedule with deletes and
    multi-cell changesets, from a mid-run state, with one node down."""
    cfg = dataclasses.replace(
        config6_small(32)[0], seqs_per_version=2, write_rate=0.3,
    )
    port, ref = _mid_pair(cfg)
    n, s = cfg.num_nodes, cfg.seqs_per_version
    rng = np.random.default_rng(21)
    alive = np.ones(n, bool)
    alive[5] = False
    part = np.zeros(n, np.int32)
    step = jax.jit(
        lambda st, k, *w: r_step.sim_step(
            cfg, st, k, _j(alive), _j(part), jnp.asarray(False), writes=w)
    )
    pcfg = _port_cfg(cfg)
    for r in range(8, 11):
        writers = rng.random(n) < 0.6
        writes = (
            writers, np.repeat(rng.integers(0, 64, n), s).reshape(n, s),
            np.stack([np.zeros(n), np.ones(n)], 1),
            rng.integers(0, 1 << 20, (n, s)), rng.random(n) < 0.3,
            rng.integers(1, s + 1, n),
        )
        writes = tuple(np.asarray(w, dtype) for w, dtype in zip(
            writes, (bool, np.int32, np.int32, np.int32, bool, np.int32)))
        key = prng.fold_in(prng.PRNGKey(3), r)
        ref, ref_m = step(ref, jnp.asarray(key), *map(_j, writes))
        port, got_m = p_step.sim_step(
            pcfg, port, key, _t(alive), _t(part), False, r,
            writes=tuple(map(_t, writes)),
        )
        assert int(got_m["writes"]) == int((writers & alive).sum())
        assert int(got_m["deletes"]) > 0
        for k, v in ref_m.items():
            np.testing.assert_array_equal(got_m[k].numpy(), np.asarray(v),
                                          err_msg=k)
    want, have = _leaves(ref), state_to_numpy(port)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


RUN_CASES = {
    "config6_32_kernel_on": lambda: config6_small(32, "on"),
    "config6_32_kernel_off": lambda: config6_small(32, "off"),
    "config6_64": lambda: config6_small(64),
    "composed_deletes_32": lambda: config6_small(32, spec=SPEC_DELETES),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_sim_workload_bit_identical(case):
    cfg, spec = RUN_CASES[case]()
    n = cfg.num_nodes
    wl_r = r_workload.make_workload(spec, n, rounds=64, seed=0)
    wl = p_workload.make_workload(spec, n, rounds=64, seed=0)
    kw = dict(max_rounds=4096, chunk=8, seed=0)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0), workload=wl_r, **kw)
    pcfg = _port_cfg(cfg)
    got = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                  device="cpu", workload=wl, **kw)
    assert ref.converged_round is not None
    assert got.converged_round == ref.converged_round
    assert got.rounds == ref.rounds
    assert got.repair_chunks == ref.repair_chunks
    assert int(got.metrics["writes"].sum()) == wl.total_writes
    assert int(got.metrics["deletes"].sum()) == wl.total_deletes > 0
    assert float(got.metrics["gap"][-1]) == 0.0
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        np.testing.assert_array_equal(got.metrics[k], np.asarray(v),
                                      err_msg=k)
    want, have = _leaves(ref.state), state_to_numpy(got.state)
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_idle_schedule_is_the_disabled_sampler():
    """An all-idle schedule fed through the writes port equals the
    sampler with writes disabled, from a cluster with traffic in flight."""
    cfg = _port_cfg(config6_small(32)[0])
    res = run_sim(
        cfg, init_state(cfg, seed=0, device="cpu"),
        Schedule(write_rounds=8), max_rounds=8, chunk=8, seed=0,
        stop_on_convergence=False, device="cpu",
    )
    mid = state_to_numpy(res.state)
    assert (mid["gossip.pend"][..., 3] > 0).any()  # rings not drained
    kw = dict(max_rounds=24, chunk=8, seed=4, stop_on_convergence=False,
              device="cpu")
    sampler = run_sim(cfg, state_from_reference(mid, "cpu"),
                      Schedule(write_rounds=0), **kw)
    port = run_sim(cfg, state_from_reference(mid, "cpu"),
                   Schedule(write_rounds=0),
                   workload=p_workload.empty_workload(32, rounds=8), **kw)
    assert port.repair_chunks == sampler.repair_chunks
    for k, v in sampler.metrics.items():
        np.testing.assert_array_equal(port.metrics[k], v, err_msg=k)
    a, b = state_to_numpy(sampler.state), state_to_numpy(port.state)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# ------------------------------------------------- replay path identity


def _first_write_workload(cfg, rounds=1):
    n = cfg.num_nodes
    return p_workload.Workload(
        name="parity", params={}, rounds=rounds, n=n,
        writers=np.ones((rounds, n), bool),
        rows=np.arange(n, dtype=np.int32)[None, :].repeat(rounds, 0),
        cols=(np.arange(n, dtype=np.int32) % cfg.num_cols)[None, :, None],
        vals=(100 + np.arange(n, dtype=np.int32))[None, :, None],
        dels=np.zeros((rounds, n), bool),
        ncells=np.ones((rounds, n), np.int32),
    )


def test_replay_and_writes_port_converge_identically():
    """A first-write schedule injected through ``inject_round`` (replay's
    path) converges to the table, log and bookkeeping the same schedule
    reaches through ``sim_step``'s writes port, under the same round
    keys — and the writes-port path equals the JAX package's."""
    cfg = SimConfig(num_nodes=12, num_rows=16, num_cols=2, log_capacity=64,
                    write_rate=0.6, sync_interval=4)
    pcfg = _port_cfg(cfg)
    n, total = cfg.num_nodes, 24
    wl = _first_write_workload(cfg)
    alive = torch.ones(n, dtype=torch.bool)
    part = torch.zeros(n, dtype=torch.int32)
    root = prng.PRNGKey(11)

    # path A — the writes port (workload / live-agent path)
    sa = init_state(pcfg, seed=0, device="cpu")
    for r in range(total):
        w = tuple(_t(x) for x in wl.writes_at(r, cfg.seqs_per_version))
        sa, _ = p_step.sim_step(pcfg, sa, round_key(root, r), alive, part,
                                r < 0, r, writes=w)
    # path B — trace-form injection (replay's path), then quiesced steps
    sb = init_state(pcfg, seed=0, device="cpu")
    injections = workload_as_injection(wl, pcfg)
    for r in range(total):
        if r < len(injections):
            sb = inject_round(pcfg, sb, *map(_t, injections[r]))
        sb, _ = p_step.sim_step(pcfg, sb, round_key(root, r), alive, part,
                                False, r)
    a, b = state_to_numpy(sa), state_to_numpy(sb)
    for name in ("table.vr", "table.cv", "table.cl", "table.site",
                 "book.head", "log.head", "log.cells"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)

    # the JAX package's writes-port path reaches the same state
    from corro_sim.analysis.jaxpr_audit import run_step_loop

    ref, _ = run_step_loop(cfg, total, 0, seed=11, workload=(
        r_workload.Workload(**{f.name: getattr(wl, f.name)
                               for f in dataclasses.fields(wl)})))
    want = _leaves(ref)
    for k in want:
        np.testing.assert_array_equal(a[k], want[k], err_msg=k)


def test_workload_as_injection_matches_and_rejects_rewrites():
    cfg = SimConfig(num_nodes=12, num_rows=16, num_cols=2, log_capacity=64)
    from corro_sim.workload.inject import (
        workload_as_injection as r_as_injection,
    )

    wl = _first_write_workload(cfg, rounds=1)
    got = workload_as_injection(wl, cfg)
    want = r_as_injection(wl, cfg)
    for g_round, w_round in zip(got, want):
        for g, w in zip(g_round, w_round):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    n = cfg.num_nodes
    rewrites = dataclasses.replace(
        wl, rounds=2, writers=np.ones((2, n), bool),
        rows=np.zeros((2, n), np.int32), cols=np.zeros((2, n, 1), np.int32),
        vals=np.ones((2, n, 1), np.int32), dels=np.zeros((2, n), bool),
        ncells=np.ones((2, n), np.int32),
    )
    with pytest.raises(ValueError):
        workload_as_injection(rewrites, cfg)
    deletes = dataclasses.replace(wl, dels=np.ones((1, n), bool))
    with pytest.raises(ValueError):
        workload_as_injection(deletes, cfg)
