"""Parity, module by module: each ported function against its JAX twin.

The inputs are a mid-run cluster (32 nodes of the north-star shape
without SWIM, 12 rounds in, inside the partition window, so rings hold
pending gossip, books lag and the log holds cleared versions) plus
lanes drawn from a seeded numpy generator. Both sides get the same
numbers; every output leaf must be equal (tolerance: exact).

The port's two merge arms (``merge_kernel`` "off": the scatter merge;
"on": the mailbox through ``grouped_merge``) are both held against the
JAX package's scatter arm here, which tests/test_merge_kernel.py holds
equal to its Pallas arm; tests/test_torch_slice.py runs the Pallas arm
itself against the port's mailbox arm over a whole simulation.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.config import SimConfig
from corro_sim.core import bookkeeping as r_book
from corro_sim.core import changelog as r_log
from corro_sim.core import compaction as r_own
from corro_sim.core import crdt as r_crdt
from corro_sim.core import delivery as r_delivery
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.gossip import broadcast as r_bcast
from corro_sim.sync import sync as r_sync
from corro_sim.utils import bits as r_bits
from corro_sim.utils import slots as r_slots
from corro_sim_torch import prng
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.core import bookkeeping as p_book
from corro_sim_torch.core import changelog as p_log
from corro_sim_torch.core import compaction as p_own
from corro_sim_torch.core import crdt as p_crdt
from corro_sim_torch.core import delivery as p_delivery
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.gossip import broadcast as p_bcast
from corro_sim_torch.sync import sync as p_sync
from corro_sim_torch.utils import bits as p_bits
from corro_sim_torch.utils import slots as p_slots
from corro_sim_torch.utils import sort as p_sort
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

N = 32


def _part(r, num):
    p = np.zeros(num, np.int32)
    if 4 <= r < 12:
        p[num // 2:] = 1
    return p


def _cfg(merge_kernel="off"):
    return SimConfig(
        num_nodes=N, num_rows=32, num_cols=4, log_capacity=64,
        write_rate=0.5, delete_rate=0.1, zipf_alpha=0.8,
        swim_enabled=False, sync_interval=8, pend_slots=8, fanout=2,
        sync_adaptive=True, sync_floor_rounds=1, sync_actor_topk=8,
        sync_cap_per_actor=2, sync_req_actors=16, sync_need_sample=16,
        merge_kernel=merge_kernel,
    )


def _port_cfg(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


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
        ref_init_state(_cfg(), seed=1)
    )
    ref = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves[jax.tree_util.keystr(p).lstrip(".")])
        for p, _ in flat
    ])
    return res.state, ref


def _t(x):
    return torch.as_tensor(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _compare(ref, got, path="out"):
    if isinstance(got, torch.Tensor):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=path)
    elif isinstance(got, np.ndarray):
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=path)
    elif isinstance(got, dict):
        assert set(got) == set(ref), path
        for k in got:
            _compare(ref[k], got[k], f"{path}[{k}]")
    elif hasattr(got, "_fields") or dataclasses.is_dataclass(got):
        names = (got._fields if hasattr(got, "_fields")
                 else [f.name for f in dataclasses.fields(got)])
        for k in names:
            _compare(getattr(ref, k), getattr(got, k), f"{path}.{k}")
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(ref), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _compare(r, g, f"{path}[{i}]")
    else:
        assert got == ref, path


def _write_lanes(rng, n, rows, cols):
    writers = rng.random(n) < 0.6
    row = rng.integers(0, rows, (n, 1)).astype(np.int32)
    col = rng.integers(0, cols, (n, 1)).astype(np.int32)
    val = rng.integers(0, 1 << 20, (n, 1)).astype(np.int32)
    dels = (rng.random(n) < 0.2) & writers
    return writers, row, col, val, dels, np.ones(n, np.int32)


def _sorted_deliveries(rng, heads, m, n):
    """Lanes ordered by (where(valid, dst, n+1), actor, ver), with
    duplicates, versions inside and beyond the window, invalid lanes."""
    dst = rng.integers(0, n, m).astype(np.int32)
    actor = rng.integers(0, n, m).astype(np.int32)
    ver = (heads[dst, actor] + rng.integers(-2, 40, m)).astype(np.int32)
    ver = np.maximum(ver, 1)
    valid = rng.random(m) < 0.8
    order = np.lexsort((ver, actor, np.where(valid, dst, n + 1)))
    return dst[order], actor[order], ver[order], valid[order]


# ---------------------------------------------------------------- cases


def case_crdt_apply_cell_changes(port, ref, rng):
    from test_merge_kernel import random_lanes

    lanes = random_lanes(rng, N, 32, 4, 500)
    return (r_crdt.apply_cell_changes(ref.table, *map(_j, lanes)),
            p_crdt.apply_cell_changes(port.table, *map(_t, lanes)))


def case_crdt_local_write(port, ref, rng):
    w, row, col, val, dels, nc = _write_lanes(rng, N, 32, 4)
    writer = np.arange(N, dtype=np.int32)
    args = (writer, row, col, val, dels, nc, w)
    return (r_crdt.local_write(ref.table, *map(_j, args)),
            p_crdt.local_write(port.table, *map(_t, args)))


def case_changelog_append(port, ref, rng):
    w, row, col, val, dels, nc = _write_lanes(rng, N, 32, 4)
    cv = rng.integers(1, 9, (N, 1)).astype(np.int32)
    cl = rng.integers(1, 4, (N, 1)).astype(np.int32)
    args = (np.arange(N, dtype=np.int32), row, col, val, cv, cl, nc, w)
    return (r_log.append_changesets(ref.log, *map(_j, args)),
            p_log.append_changesets(port.log, *map(_t, args)))


def case_changelog_gather(port, ref, rng):
    actor = rng.integers(0, N, 200).astype(np.int32)
    ver = rng.integers(1, 80, 200).astype(np.int32)
    return (r_log.gather_changesets(ref.log, _j(actor), _j(ver)),
            p_log.gather_changesets(port.log, _t(actor), _t(ver)))


def case_bookkeeping_deliver(port, ref, rng):
    lanes = _sorted_deliveries(rng, port.book.head.numpy(), 600, N)
    return (r_book.deliver_versions(ref.book, *map(_j, lanes),
                                    presorted=True),
            p_book.deliver_versions(port.book, *map(_t, lanes)))


def case_bookkeeping_advance_heads(port, ref, rng):
    floor = (port.book.head.numpy()
             + rng.integers(-3, 6, (N, N))).astype(np.int32)
    return (r_book.advance_heads(ref.book, _j(floor)),
            p_book.advance_heads(port.book, _t(floor)))


def case_bookkeeping_partial_versions(port, ref, rng):
    return (r_book.partial_versions(ref.book, 1),
            p_book.partial_versions(port.book, 1))


def case_compaction_update_ownership(port, ref, rng):
    w, row, col, val, dels, nc = _write_lanes(rng, N, 32, 4)
    actor = np.arange(N, dtype=np.int32)
    ver = (port.log.head.numpy() + 1).astype(np.int32)
    cv = rng.integers(1, 9, N).astype(np.int32)
    cl = np.where(dels, 2, 1).astype(np.int32)
    vr = np.where(dels, r_crdt.NEG, val[:, 0]).astype(np.int32)
    site = np.where(dels, r_crdt.NEG, actor).astype(np.int32)
    args = (actor, ver, row[:, 0], col[:, 0], cv, vr, site, cl, w, dels)
    return (jax.jit(r_own.update_ownership)(ref.own, ref.log, *map(_j, args)),
            p_own.update_ownership(port.own, port.log, *map(_t, args)))


def case_broadcast_step(port, ref, rng):
    alive = rng.random(N) < 0.9
    view = np.ones((1, N), bool)
    pkey = prng.fold_in(prng.PRNGKey(4), 6)
    out_r = r_bcast.broadcast_step(
        ref.gossip, jnp.asarray(pkey), _j(alive), _j(view), 2,
        need_chunk=False,
    )
    out_p = p_bcast.broadcast_step(
        port.gossip, pkey, _t(alive), _t(view), 2, need_chunk=False,
    )
    return out_r, out_p


def case_broadcast_enqueue_own(port, ref, rng):
    w = rng.random(N) < 0.5
    ver = rng.integers(1, 9, N).astype(np.int32)
    args = (np.arange(N, dtype=np.int32), ver, np.zeros(N, np.int32), w)
    return (r_bcast.enqueue_own(ref.gossip, *map(_j, args), 4, 1),
            p_bcast.enqueue_own(port.gossip, *map(_t, args), 4, 1))


def _enqueue(port, ref, rng, grouped):
    m = 400
    dst = np.sort(rng.integers(0, N, m)).astype(np.int32)
    if not grouped:
        rng.shuffle(dst)
    actor = rng.integers(0, N, m).astype(np.int32)
    ver = rng.integers(1, 9, m).astype(np.int32)
    valid = rng.random(m) < 0.7
    args = (dst, actor, ver, np.zeros(m, np.int32), valid)
    ref_enqueue = jax.jit(r_bcast.enqueue_broadcasts,
                          static_argnames=("transmissions", "grouped"))
    return (ref_enqueue(ref.gossip, *map(_j, args), transmissions=2,
                        grouped=grouped),
            p_bcast.enqueue_broadcasts(port.gossip, *map(_t, args), 2,
                                       grouped=grouped))


def case_broadcast_enqueue_grouped(port, ref, rng):
    return _enqueue(port, ref, rng, True)


def case_broadcast_enqueue_sorted(port, ref, rng):
    return _enqueue(port, ref, rng, False)


def _table_copy(port):
    """The mailbox merge consumes its table; the module-scoped cluster is
    shared by every case."""
    return dataclasses.replace(port.table, **{
        f.name: getattr(port.table, f.name).clone()
        for f in dataclasses.fields(port.table)
    })


def _delivery(port, ref, rng, merge_kernel):
    cfg = _cfg()
    m = 800
    heads = port.book.head.numpy()
    dst = rng.integers(0, N, m).astype(np.int32)
    src = rng.integers(0, N, m).astype(np.int32)
    actor = rng.integers(0, N, m).astype(np.int32)
    ver = np.maximum(heads[dst, actor] + rng.integers(-1, 4, m), 0)
    ver = np.minimum(ver, port.log.head.numpy()[actor]).astype(np.int32)
    delivered = (rng.random(m) < 0.8) & (ver > 0)
    chunk = np.zeros(m, np.int32)
    args = (dst, src, actor, ver, chunk, delivered)
    out_r = jax.jit(r_delivery.delivery_pass, static_argnums=0)(
        cfg, ref.table, ref.book, ref.log, ref.probe, ref.hlc,
        *map(_j, args), ref.round,
    )
    out_p = p_delivery.delivery_pass(
        _port_cfg(_cfg(merge_kernel)), _table_copy(port), port.book, port.log,
        port.hlc,
        *map(_t, args), probe=port.probe, round_=port.round,
    )
    return out_r, out_p


def case_delivery_scatter_arm(port, ref, rng):
    return _delivery(port, ref, rng, "off")


def case_delivery_kernel_arm(port, ref, rng):
    return _delivery(port, ref, rng, "on")


def _pairs(rng):
    alive = rng.random(N) < 0.9
    part = _part(6, N)
    pairs = alive[:, None] & alive[None, :] & (part[:, None] == part[None, :])
    return alive, pairs


def case_sync_choose_sync_peers(port, ref, rng):
    cfg = _cfg()
    alive, pairs = _pairs(rng)
    view = np.ones((1, N), bool)
    key = prng.PRNGKey(8)
    out_r = jax.jit(r_sync.choose_sync_peers, static_argnums=0)(cfg, ref.book, jnp.asarray(key),
                                     _j(alive), _j(view), _j(pairs))
    out_p = p_sync.choose_sync_peers(_port_cfg(cfg), port.book, key,
                                     _t(alive), _t(view), _t(pairs))
    return out_r, out_p


def _sync(port, ref, rng, merge_kernel):
    cfg = _cfg()
    alive, pairs = _pairs(rng)
    view = np.ones((1, N), bool)
    key = prng.PRNGKey(9)
    out_r = jax.jit(r_sync.sync_round, static_argnums=0)(
        cfg, ref.book, ref.log, ref.table, ref.hlc, ref.last_cleared,
        ref.cleared_hlc, jnp.asarray(key), _j(alive), _j(view), _j(pairs),
        round_idx=ref.sync_rounds,
    )
    out_p = p_sync.sync_round(
        _port_cfg(_cfg(merge_kernel)), port.book, port.log, _table_copy(port),
        port.hlc,
        port.last_cleared, port.cleared_hlc, key, _t(alive), _t(view),
        _t(pairs), round_idx=port.sync_rounds,
    )
    return out_r, out_p


def case_sync_round_scatter_arm(port, ref, rng):
    return _sync(port, ref, rng, "off")


def case_sync_round_kernel_arm(port, ref, rng):
    return _sync(port, ref, rng, "on")


def case_bits(port, ref, rng):
    win = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32)
    win[:8] = [0, 1, 3, 2 ** 32 - 1, 2 ** 31, 0x7FFFFFFF, 0xFFFF, 5]
    t = rng.integers(0, 33, 4000).astype(np.uint32)
    head = rng.integers(0, 100, 4000).astype(np.int32)
    w64 = torch.as_tensor(win.astype(np.int64))
    return (
        (r_bits.trailing_ones_u32(_j(win)),
         r_bits.window_shift_right(_j(win), _j(t)),
         r_bits.absorb(_j(head), _j(win))),
        (p_bits.trailing_ones_u32(w64),
         p_bits.window_shift_right(w64, _t(t.astype(np.int64))),
         p_bits.absorb(_t(head), w64)),
    )


def case_slots(port, ref, rng):
    g = np.sort(rng.integers(0, 40, 500)).astype(np.int32)
    a = rng.integers(0, 3, 500).astype(np.int32)
    mask = rng.random(500) < 0.6
    return (
        (r_slots.dedupe_sorted_mask(_j(g), _j(a)),
         r_slots.ranks_within_group(_j(g)),
         r_slots.group_counts(_j(g), 30),
         r_slots.ranks_within_group_masked(_j(g), _j(mask))),
        (p_slots.dedupe_sorted_mask(_t(g), _t(a)),
         p_slots.ranks_within_group(_t(g)),
         p_slots.group_counts(_t(g), 30),
         p_slots.ranks_within_group_masked(_t(g), _t(mask))),
    )


def case_sort_lexsort(port, ref, rng):
    keys = [rng.integers(0, 4, 300).astype(np.int32) for _ in range(3)]
    return (jnp.lexsort([_j(k) for k in keys]),
            p_sort.lexsort([_t(k) for k in keys]))


def case_sort_top_k_ties(port, ref, rng):
    x = rng.integers(-1, 4, (64, 10)).astype(np.int32)
    x[0] = [3, 1, 3, 2, 3, 0, 0, 0, 0, 0]
    return (jax.lax.top_k(_j(x), 3), p_sort.top_k(_t(x), 3))


CASES = {k[len("case_"):]: v for k, v in dict(globals()).items()
         if k.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_parity(name, mid):
    port, ref = mid
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    out_r, out_p = CASES[name](port, ref, rng)
    _compare(out_r, out_p)
