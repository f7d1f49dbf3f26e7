"""Parity, multi-cell and multi-chunk changesets, module by module.

A version is one transaction's changeset of up to ``seqs_per_version``
(S) cells, gossiped as ``chunks_per_version`` (cpv) chunks; each version
owns a group of cpv window bits and applies once the group is full. Each
ported function that sees S > 1 or cpv > 1 runs against its JAX twin on
the same numbers (drawn from a seeded numpy generator) and keys; every
output leaf must be equal (tolerance: exact — integer arithmetic plus
float32 threshold compares). The cluster cases start from config 3's
shape (the Consul schema's 6 columns, S = 4, cpv = 2, full-view SWIM) at
32 nodes, 12 rounds in, so rings hold chunk lanes and windows hold
partial versions.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_modules import _compare, _j, _t, _table_copy
from test_torch_slice import config3_ref, config3_small

from corro_sim.core import bookkeeping as r_book
from corro_sim.core import changelog as r_log
from corro_sim.core import compaction as r_own
from corro_sim.core import crdt as r_crdt
from corro_sim.core import delivery as r_delivery
from corro_sim.engine import step as r_step
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.gossip import broadcast as r_bcast
from corro_sim.schema import TableLayout, consul_schema_sql, parse_and_constrain
from corro_sim.sync import sync as r_sync
from corro_sim.utils import bits as r_bits
from corro_sim_torch import prng
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_from_reference, state_to_numpy
from corro_sim_torch.core import bookkeeping as p_book
from corro_sim_torch.core import changelog as p_log
from corro_sim_torch.core import compaction as p_own
from corro_sim_torch.core import crdt as p_crdt
from corro_sim_torch.core import delivery as p_delivery
from corro_sim_torch.engine import step as p_step
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.gossip import broadcast as p_bcast
from corro_sim_torch.profile_slice import (
    CONSUL_COLS,
    CONSUL_ROWS,
    config3_config,
)
from corro_sim_torch.sync import sync as p_sync
from corro_sim_torch.utils import bits as p_bits

N = 32
S = 4


def _port_cfg(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _mid_state(cfg, rounds=12, seed=1):
    """(port state, reference state) of the same ``rounds``-old cluster,
    run by the port and carried to the JAX package's pytree."""
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


@pytest.fixture(scope="module")
def mid():
    """Config 3's shape at 32 nodes, 12 rounds into its write phase."""
    port, ref = _mid_state(config3_small(N))
    assert (port.gossip.pend[..., 2] > 0).any()  # chunk 1 lanes in rings
    assert int(p_book.partial_versions(port.book, 2)) > 0
    return port, ref


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


# ------------------------------------------------------- the window bits


@pytest.mark.parametrize("bpv", [2, 4, 8, 16, 32])
def test_absorb_and_shift_by_groups(bpv):
    rng = _rng(f"absorb{bpv}")
    win = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32)
    full = (1 << bpv) - 1
    # whole complete groups in the low bits, then a partial one
    win[:6] = [x & 0xFFFFFFFF for x in (
        0, full, full | (1 << bpv), 2 ** 32 - 1, full >> 1,
        (full << bpv) | full)]
    t = (rng.integers(0, 33 // bpv + 1, 4000) * bpv).astype(np.uint32)
    head = rng.integers(0, 100, 4000).astype(np.int32)
    w64 = torch.as_tensor(win.astype(np.int64))
    _compare(
        (r_bits.absorb(_j(head), _j(win), bpv),
         r_bits.window_shift_right(_j(win), _j(t))),
        (p_bits.absorb(_t(head), w64, bpv),
         p_bits.window_shift_right(w64, _t(t.astype(np.int64)))),
    )


def _random_book(rng, n, a, bpv):
    head = rng.integers(0, 20, (n, a)).astype(np.int32)
    win = rng.integers(0, 2 ** 32, (n, a), dtype=np.uint64).astype(np.uint32)
    # sparse windows: most words hold a few groups, some none
    win &= rng.integers(0, 2 ** 32, (n, a), dtype=np.uint64).astype(np.uint32)
    win[rng.random((n, a)) < 0.3] = 0
    # keep the pre-batch window absorbed (no complete group at bit 0)
    full = (1 << bpv) - 1
    low = (win & full) == full
    win[low] &= ~np.uint32(1)
    ref = r_book.Bookkeeping(head=jnp.asarray(head), win=jnp.asarray(win))
    port = p_book.Bookkeeping(head=_t(head),
                              win=torch.as_tensor(win.astype(np.int64)))
    return ref, port


@pytest.mark.parametrize("bpv", [2, 4, 8, 16, 32])
def test_partial_versions(bpv):
    ref, port = _random_book(_rng(f"partial{bpv}"), 24, 24, bpv)
    _compare(r_book.partial_versions(ref, bpv),
             p_book.partial_versions(port, bpv))


@pytest.mark.parametrize("bpv", [2, 4, 8])
def test_advance_heads_by_groups(bpv):
    rng = _rng(f"advance{bpv}")
    ref, port = _random_book(rng, 24, 24, bpv)
    floor = (np.asarray(ref.head) + rng.integers(-3, 6, (24, 24))).astype(
        np.int32)
    _compare(r_book.advance_heads(ref, _j(floor), bpv),
             p_book.advance_heads(port, _t(floor), bpv))


def _chunk_lanes(rng, head, n, a, bpv, m):
    """Lanes sorted by (where(valid, dst, n+1), actor, ver, chunk): within
    and beyond the window, below the head, duplicates, invalid lanes."""
    vwin = 32 // bpv
    dst = rng.integers(0, n, m).astype(np.int32)
    actor = rng.integers(0, a, m).astype(np.int32)
    ver = head[dst, actor] + rng.integers(-1, vwin + 3, m)
    ver = np.maximum(ver, 1).astype(np.int32)
    chunk = rng.integers(0, bpv, m).astype(np.int32)
    valid = rng.random(m) < 0.85
    dup = rng.integers(0, m, m // 5)  # exact duplicates
    dst, actor, ver, chunk, valid = (
        np.concatenate([x, x[dup]]) for x in (dst, actor, ver, chunk, valid)
    )
    order = np.lexsort((chunk, ver, actor, np.where(valid, dst, n + 1)))
    return tuple(x[order] for x in (dst, actor, ver, valid, chunk))


@pytest.mark.parametrize("bpv", [2, 4, 8])
def test_deliver_versions_chunked(bpv):
    """Two batches on one book: the second completes versions the first
    left partial."""
    rng = _rng(f"deliver{bpv}")
    n = a = 16
    ref, port = _random_book(rng, n, a, bpv)
    head = np.asarray(ref.head)
    first = _chunk_lanes(rng, head, n, a, bpv, 900)
    dst, actor, ver, valid, chunk = first
    # the second batch: every chunk of each version the first touched
    reps = np.repeat(np.arange(len(dst)), bpv)
    second = (dst[reps], actor[reps], ver[reps], valid[reps],
              np.tile(np.arange(bpv, dtype=np.int32), len(dst)))
    order = np.lexsort((second[4], second[2], second[1],
                        np.where(second[3], second[0], n + 1)))
    second = tuple(x[order] for x in second)
    completed = 0
    for i, lanes in enumerate((first, second)):
        d, ac, v, ok, c = lanes
        out_r = r_book.deliver_versions(
            ref, _j(d), _j(ac), _j(v), _j(ok), chunk=_j(c),
            bits_per_version=bpv, presorted=True)
        out_p = p_book.deliver_versions(
            port, _t(d), _t(ac), _t(v), _t(ok), chunk=_t(c),
            bits_per_version=bpv)
        _compare(out_r, out_p)
        ref, port = out_r[0], out_p[0]
        completed += int(out_p[2].sum())
        assert out_p[1].any()  # fresh chunks
        if i == 0:
            assert out_p[3].any()  # beyond-window drops
            assert (out_p[1] & ~out_p[2]).any()  # partial versions
    assert completed > 0


# ----------------------------------------------- cells of a changeset


def _multi_cell_writes(rng, n, rows, cols, s):
    """Each writer touches 1..s distinct columns of one row; padded lanes
    (beyond ncells) carry column 0 and garbage values."""
    writers = rng.random(n) < 0.7
    dels = (rng.random(n) < 0.2) & writers
    ncells = np.where(dels, 1, rng.integers(1, s + 1, n)).astype(np.int32)
    col = np.argsort(rng.random((n, cols)), axis=1)[:, :s].astype(np.int32)
    seq = np.arange(s)[None, :]
    col = np.where(seq < ncells[:, None], col, 0).astype(np.int32)
    row = np.repeat(rng.integers(0, rows, (n, 1)), s, 1).astype(np.int32)
    val = rng.integers(0, 1 << 20, (n, s)).astype(np.int32)
    return writers, row, col, val, dels, ncells


def test_local_write_multi_cell(mid):
    port, ref = mid
    w, row, col, val, dels, nc = _multi_cell_writes(
        _rng("local_write"), N, 64, CONSUL_COLS, S)
    args = (np.arange(N, dtype=np.int32), row, col, val, dels, nc, w)
    out_p = p_crdt.local_write(_table_copy(port), *map(_t, args))
    _compare(r_crdt.local_write(ref.table, *map(_j, args)), out_p)
    # padded cells touch nothing: a changed cell lies in a row whose
    # causal length moved, or is a live lane's cell
    live = w[:, None] & (np.arange(S)[None, :] < nc[:, None])
    lanes = {(i, row[i, k], col[i, k]) for i in range(N) for k in range(S)
             if live[i, k]}
    bumped = (out_p[0].cl != port.table.cl).numpy()
    for node, r, c in (out_p[0].cv != port.table.cv).nonzero().tolist():
        assert bumped[node, r] or (node, r, c) in lanes


def test_changelog_multi_cell(mid):
    port, ref = mid
    rng = _rng("changelog")
    w, row, col, val, dels, nc = _multi_cell_writes(
        rng, N, 64, CONSUL_COLS, S)
    cv = rng.integers(1, 9, (N, S)).astype(np.int32)
    cl = rng.integers(1, 4, (N, S)).astype(np.int32)
    args = (np.arange(N, dtype=np.int32), row, col, val, cv, cl, nc, w)
    out_r = r_log.append_changesets(ref.log, *map(_j, args))
    out_p = p_log.append_changesets(port.log, *map(_t, args))
    _compare(out_r, out_p)
    # the live count is the changeset's cells, not S
    slot = (out_p[1].long() - 1) % port.log.capacity
    rows = torch.arange(N)
    assert torch.equal(out_p[0].live[rows, slot][_t(w)], _t(nc)[_t(w)])
    actor = rng.integers(0, N, 300).astype(np.int32)
    ver = rng.integers(1, 40, 300).astype(np.int32)
    _compare(r_log.gather_changesets(out_r[0], _j(actor), _j(ver)),
             p_log.gather_changesets(out_p[0], _t(actor), _t(ver)))


def test_update_ownership_multi_cell(mid):
    port, ref = mid
    rng = _rng("ownership")
    w, row, col, val, dels, nc = _multi_cell_writes(
        rng, N, 64, CONSUL_COLS, S)
    actor = np.repeat(np.arange(N, dtype=np.int32)[:, None], S, 1)
    ver = np.repeat((port.log.head.numpy() + 1).astype(np.int32)[:, None],
                    S, 1)
    cv = rng.integers(1, 9, (N, S)).astype(np.int32)
    cl = np.repeat(np.where(dels, 2, 1)[:, None], S, 1).astype(np.int32)
    vr = np.where(dels[:, None], r_crdt.NEG, val).astype(np.int32)
    site = np.where(dels[:, None], r_crdt.NEG, actor).astype(np.int32)
    live = w[:, None] & (np.arange(S)[None, :] < nc[:, None])
    args = [x.reshape(-1) for x in (
        actor, ver, row, col, cv, vr, site, cl, live,
        np.repeat(dels[:, None], S, 1))]
    _compare(
        jax.jit(r_own.update_ownership)(ref.own, ref.log, *map(_j, args)),
        p_own.update_ownership(port.own, port.log, *map(_t, args)),
    )


# --------------------------------------------------- gossip with chunks


def test_broadcast_step_with_chunks(mid):
    port, ref = mid
    rng = _rng("broadcast")
    alive = rng.random(N) < 0.9
    view = rng.random((N, N)) < 0.9
    key = prng.fold_in(prng.PRNGKey(4), 6)
    out_r = r_bcast.broadcast_step(ref.gossip, jnp.asarray(key), _j(alive),
                                   _j(view), 3, need_chunk=True)
    out_p = p_bcast.broadcast_step(port.gossip, key, _t(alive), _t(view), 3,
                                   need_chunk=True)
    _compare(out_r, out_p)
    assert (out_p[5] > 0).any()  # chunk 1 lanes are emitted


def test_enqueue_chunks_beyond_the_ring(mid):
    """The degenerate ring (cpv > pend_slots): each writer's tiled chunk
    lanes through the grouped path's overflow rotation."""
    port, ref = mid
    rng = _rng("enqueue")
    cpv = 20  # > pend_slots (16)
    writers = rng.random(N) < 0.6
    ver = rng.integers(1, 9, N).astype(np.int32)
    rows = np.arange(N, dtype=np.int32)
    tiled = p_step._tile_chunks(cpv, _t(rows), _t(rows), _t(ver),
                                _t(writers))
    ref_tiled = r_step._tile_chunks(cpv, _j(rows), _j(rows), _j(ver),
                                    _j(writers))
    _compare(ref_tiled, tiled)
    d, a, v, ok, c = tiled
    rd, ra, rv, rok, rc = ref_tiled
    enqueue = jax.jit(r_bcast.enqueue_broadcasts,
                      static_argnames=("transmissions", "grouped"))
    out_r = enqueue(ref.gossip, rd, ra, rv, rc, rok, transmissions=4,
                    grouped=True)
    out_p = p_bcast.enqueue_broadcasts(port.gossip, d, a, v, c, ok, 4,
                                       grouped=True)
    _compare(out_r, out_p)
    assert int(out_p.overflow) > int(port.gossip.overflow)


# ------------------------------------------------ delivery with chunks


def _chunk_deliveries(port, rng, m, cpv):
    heads = port.book.head.numpy()
    dst = rng.integers(0, N, m).astype(np.int32)
    src = rng.integers(0, N, m).astype(np.int32)
    actor = rng.integers(0, N, m).astype(np.int32)
    ver = np.maximum(heads[dst, actor] + rng.integers(-1, 5, m), 0)
    ver = np.minimum(ver, port.log.head.numpy()[actor]).astype(np.int32)
    chunk = rng.integers(0, cpv, m).astype(np.int32)
    delivered = (rng.random(m) < 0.8) & (ver > 0)
    return dst, src, actor, ver, chunk, delivered


@pytest.mark.parametrize("merge_kernel", ["off", "on"])
def test_delivery_pass_with_chunks(mid, merge_kernel):
    """Four-key sort, chunk plane, chunked bookkeeping and the S-wide
    merge; "on" routes cap_lanes = apply_queue_cap * S = 512 lanes per
    node through the mailbox."""
    port, ref = mid
    cfg = config3_small(N)
    args = _chunk_deliveries(port, _rng(f"delivery{merge_kernel}"), 2400, 2)
    out_r = jax.jit(r_delivery.delivery_pass, static_argnums=0)(
        cfg, ref.table, ref.book, ref.log, ref.probe, ref.hlc,
        *map(_j, args), ref.round,
    )
    out_p = p_delivery.delivery_pass(
        _port_cfg(dataclasses.replace(cfg, merge_kernel=merge_kernel)),
        _table_copy(port), port.book, port.log, port.hlc, *map(_t, args),
        probe=port.probe, round_=port.round,
    )
    _compare(out_r, out_p)
    assert out_p.complete.any() and (out_p.fresh_chunk & ~out_p.complete).any()
    assert (out_p.cell_live.sum(1) > 1).any()  # multi-cell merges


# ---------------------------------------------------- sync with chunks


@pytest.mark.parametrize("merge_kernel", ["off", "on"])
def test_sync_round_with_chunks(mid, merge_kernel):
    """S = 4, cpv = 2: partial serving skips buffered chunks' cells in
    sync_cells while the merge applies whole changesets; the already
    count reads whole groups; heads advance by groups."""
    port, ref = mid
    cfg = config3_small(N)
    rng = _rng(f"sync{merge_kernel}")
    alive = rng.random(N) < 0.95
    pairs = alive[:, None] & alive[None, :]
    view = np.ones((1, N), bool)
    key = prng.PRNGKey(9)
    out_r = jax.jit(r_sync.sync_round, static_argnums=0)(
        cfg, ref.book, ref.log, ref.table, ref.hlc, ref.last_cleared,
        ref.cleared_hlc, jnp.asarray(key), _j(alive), _j(view), _j(pairs),
        round_idx=ref.sync_rounds,
    )
    out_p = p_sync.sync_round(
        _port_cfg(dataclasses.replace(cfg, merge_kernel=merge_kernel)),
        port.book, port.log, _table_copy(port), port.hlc, port.last_cleared,
        port.cleared_hlc, key, _t(alive), _t(view), _t(pairs),
        round_idx=port.sync_rounds,
    )
    _compare(out_r, out_p)
    assert int(out_p[4]["sync_versions"]) > 0
    assert int(out_p[4]["sync_cells"]) > 0


# ------------------------------------------------- one step, each branch


STEP_CASES = {
    # s_eff = min(S, num_cols) > 1 and == S: argsort columns, no padding
    "s_eff_eq_S": lambda: config3_small(N),
    # 1 < s_eff < S: argsort columns padded with zeros
    "s_eff_lt_S": lambda: config3_small(N, seqs_per_version=8, num_cols=4),
    # s_eff == 1 < S: one randint column padded with zeros
    "s_eff_1_lt_S": lambda: config3_small(N, num_cols=1),
    # cpv > pend_slots: the own-write enqueue takes the grouped path
    "cpv_gt_pend": lambda: config3_small(N, chunks_per_version=4,
                                         pend_slots=2),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_sim_step_write_branches(case):
    cfg = STEP_CASES[case]()
    port, ref = _mid_state(cfg, rounds=6, seed=3)
    rng = _rng(case)
    alive = rng.random(N) < 0.95
    part = np.zeros(N, np.int32)
    key = prng.fold_in(prng.PRNGKey(11), 6)
    step = jax.jit(r_step.sim_step, static_argnums=0)
    ref_state, ref_m = step(cfg, ref, jnp.asarray(key), _j(alive), _j(part),
                            jnp.asarray(True))
    got_state, got_m = p_step.sim_step(
        _port_cfg(cfg), port, key, _t(alive), _t(part), True, 6,
    )
    cells, writes = int(got_m["cells_written"]), int(got_m["writes"])
    assert writes > 0
    if case == "s_eff_1_lt_S":
        assert cells == writes
    else:
        assert cells > writes
    _compare(ref_m, got_m)
    want, have = _leaves(ref_state), state_to_numpy(got_state)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_consul_layout_constant():
    """The port's own 512 x 6 constant is the Consul schema's layout, and
    its config 3 is the JAX package's run_config_3 field for field."""
    layout = TableLayout(
        parse_and_constrain(consul_schema_sql()), default_capacity=256
    )
    assert (CONSUL_ROWS, CONSUL_COLS) == (layout.num_rows, layout.num_cols)
    for n in (1000, 32):
        assert dataclasses.asdict(config3_config(n)) == dataclasses.asdict(
            config3_ref(n))


def test_multi_chunk_state_round_trip():
    cfg = config3_small(N)
    want = _leaves(ref_init_state(cfg, seed=2))
    have = state_to_numpy(state_from_reference(want, "cpu"))
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
