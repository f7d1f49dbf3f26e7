"""Parity: the port's dst-grouped merge against the JAX package's.

On CPU tensors ``corro_sim_torch.core.merge_kernel.grouped_merge`` runs
its plain version (the mailbox unpacked into ``apply_cell_changes``);
it is held against the Pallas kernel in interpret mode and against the
JAX package's scatter merge on the ``random_lanes`` batches of
tests/test_merge_kernel.py. The merge consumes its planes on both
devices, so every test hands it copies of what it compares against. The
CUDA kernel itself is held against the plain version on the card in
tests/test_torch_merge_cuda.py. Tolerance everywhere: exact equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.config import SimConfig
from corro_sim.core.crdt import apply_cell_changes as ref_apply
from corro_sim.core.crdt import make_table_state as ref_make_table
from corro_sim.core.merge_kernel import merge_grouped as ref_merge_grouped
from corro_sim.core.merge_kernel import route_lanes as ref_route_lanes
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.core import crdt
from corro_sim_torch.core import merge_kernel as mk
from test_merge_kernel import random_lanes, rank_within_dst

FIELDS = ("cv", "vr", "site", "cl")


def _t(x, device="cpu"):
    return torch.as_tensor(np.array(x), device=device)


def _assert_tables(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).cpu().numpy(), np.asarray(getattr(want, f)),
            err_msg=f,
        )


def _populated(rng, n, r, c):
    """A reference table with one random batch applied, and its twin."""
    pre = random_lanes(rng, n, r, c, 200)
    ref = ref_apply(ref_make_table(n, r, c), *[jnp.asarray(x) for x in pre])
    port = crdt.TableState(**{f: _t(getattr(ref, f)) for f in FIELDS})
    return ref, port


def _copy(state):
    return crdt.TableState(**{f: getattr(state, f).clone() for f in FIELDS})


def _planes(state):
    n = state.cl.shape[0]
    return (state.cv.reshape(n, -1), state.vr.reshape(n, -1),
            state.site.reshape(n, -1), state.cl)


def _routed(lanes, n, c, cap, router):
    dst, row, col, cv, vr, site, cl, valid = lanes
    rank = rank_within_dst(dst, valid)
    args = (dst, rank, row * c + col, cv, vr, site, cl, valid)
    if router is ref_route_lanes:
        return router(*[jnp.asarray(x) for x in args], n, cap)
    return router(*[_t(x) for x in args], n, cap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_merge_matches_pallas_and_scatter(seed):
    rng = np.random.default_rng(seed)
    n, r, c, cap = 16, 32, 4, 128
    ref_state, state = _populated(rng, n, r, c)
    lanes = random_lanes(rng, n, r, c, 400)

    ref_box = _routed(lanes, n, c, cap, ref_route_lanes)
    box = _routed(lanes, n, c, cap, mk.route_lanes)
    # the port's mailbox is the reference's without its two pad rows
    np.testing.assert_array_equal(
        box.numpy(), np.asarray(ref_box)[:mk.LANE_FIELDS])

    got = mk.merge_grouped(_copy(state), box, cap)
    _assert_tables(got, ref_merge_grouped(
        ref_state, ref_box, cap, block_nodes=8, interpret=True))
    _assert_tables(got, ref_apply(ref_state, *[jnp.asarray(x) for x in lanes]))
    _assert_tables(
        crdt.apply_cell_changes(state, *[_t(x) for x in lanes]),
        ref_apply(ref_state, *[jnp.asarray(x) for x in lanes]),
    )


def test_cap_truncates_like_masking():
    rng = np.random.default_rng(7)
    n, r, c, cap, m0 = 8, 32, 4, 128, 150
    ref_state = ref_make_table(n, r, c)
    state = crdt.make_table_state(n, r, c, "cpu")
    lanes = (
        np.zeros(m0, np.int32), rng.integers(0, r, m0).astype(np.int32),
        rng.integers(0, c, m0).astype(np.int32),
        rng.integers(1, 5, m0).astype(np.int32),
        rng.integers(0, 50, m0).astype(np.int32),
        rng.integers(0, n, m0).astype(np.int32), np.ones(m0, np.int32),
        np.ones(m0, bool),
    )
    masked = lanes[:7] + (lanes[7] & (np.arange(m0) < cap),)
    want = ref_apply(ref_state, *[jnp.asarray(x) for x in masked])
    got = mk.merge_grouped(state, _routed(lanes, n, c, cap, mk.route_lanes), cap)
    _assert_tables(got, want)


def test_plain_version_is_the_cpu_path():
    """On CPU tensors the wrapper runs the plain version, writes its
    result into the planes it was given and counts no kernel launch."""
    rng = np.random.default_rng(3)
    n, r, c, cap = 8, 32, 4, 128
    _, state = _populated(rng, n, r, c)
    box = _routed(random_lanes(rng, n, r, c, 300), n, c, cap, mk.route_lanes)
    before = dict(mk.LAUNCHES)
    planes = _planes(state)
    want = mk.grouped_merge_reference(*planes, box, cap, c)
    got = mk.grouped_merge(*planes, box, cap, c)
    for g, p, w in zip(got, planes, want):
        assert g is p
        assert torch.equal(p, w)
    assert mk.LAUNCHES == before


@pytest.mark.parametrize("rows,cols,cap", [
    (256, 4, 128),  # the slice's shape
    (8192, 1, 128),  # one column, the gate's 8192 cells
    (128, 8, 128),
    (256, 4, 256),
])
def test_grouped_merge_consumes_its_planes(rows, cols, cap):
    """The merged values land in the storage the caller passed (same
    data_ptr, also through merge_grouped's (N, R, C) views) and equal
    the JAX package's scatter merge of the same lanes."""
    rng = np.random.default_rng(rows + cols + cap)
    n = 8
    ref_state, state = _populated(rng, n, rows, cols)
    lanes = random_lanes(rng, n, rows, cols, n * cap // 2)
    box = _routed(lanes, n, cols, cap, mk.route_lanes)
    ptrs = [getattr(state, f).data_ptr() for f in FIELDS]
    got = mk.merge_grouped(state, box, cap)
    assert [getattr(got, f).data_ptr() for f in FIELDS] == ptrs
    want = ref_apply(ref_state, *[jnp.asarray(x) for x in lanes])
    _assert_tables(state, want)
    _assert_tables(got, want)


def test_grouped_merge_refuses_non_contiguous_planes():
    n, cells, cols, cap = 4, 128, 4, 128
    planes = [torch.zeros((n, cells), dtype=torch.int32) for _ in range(3)]
    planes.append(torch.zeros((n, cells // cols), dtype=torch.int32))
    box = torch.zeros((mk.LANE_FIELDS, n * cap), dtype=torch.int32)
    strided = torch.zeros((cells, n), dtype=torch.int32).T
    with pytest.raises(ValueError):
        mk.grouped_merge(strided, *planes[1:], box, cap, cols)


def test_grouped_merge_refuses_bad_operands():
    n, cells, cols, cap = 4, 128, 4, 128
    planes = [torch.zeros((n, cells), dtype=torch.int32) for _ in range(3)]
    planes.append(torch.zeros((n, cells // cols), dtype=torch.int32))
    box = torch.zeros((mk.LANE_FIELDS, n * cap), dtype=torch.int32)
    with pytest.raises(ValueError):
        mk.grouped_merge(*planes[:3], planes[3].long(), box, cap, cols)
    with pytest.raises(ValueError):
        mk.grouped_merge(*planes, box[:, :-1], cap, cols)
    with pytest.raises(ValueError):
        mk.grouped_merge(*planes, box, cap, 3)
    with pytest.raises(ValueError):  # cl per cell instead of per row
        mk.grouped_merge(*planes[:3], planes[0], box, cap, cols)


@pytest.mark.parametrize("mode,path,device,rows,cols,want", [
    ("off", "sync", "cuda", 32, 4, False),
    ("on", "delivery", "cpu", 32, 4, True),
    ("on", "sync", "cpu", 64, 1, False),  # config 2: 64 cells run no kernel
    ("on", "sync", "cpu", 4096, 4, False),  # past the 8192-cell limit
    ("auto", "sync", "cuda", 256, 4, True),
    ("auto", "sync", "cpu", 256, 4, False),
    ("auto", "delivery", "cuda", 256, 4, False),
])
def test_kernel_supported_gate(mode, path, device, rows, cols, want):
    cfg = sim_config_from_dict(dataclasses.asdict(SimConfig(
        num_rows=rows, num_cols=cols, merge_kernel=mode,
    )))
    assert mk.kernel_supported(cfg, path, torch.device(device)) is want
