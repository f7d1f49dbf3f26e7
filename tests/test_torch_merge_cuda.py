"""The CUDA merge kernel against its plain version, on the card.

Every test is marked ``cuda`` and skips without a CUDA device: the
kernel has no CPU mode. The file imports no JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_merge_cuda.py -q -m cuda

Inputs come from a seeded numpy generator. The kernel merges in place;
each case computes the plain version first (it is functional), then
launches the kernel on the same planes and requires the result in those
planes, bit for bit (tolerance: exact).
"""

import numpy as np
import pytest
import torch

from corro_sim_torch.core import crdt
from corro_sim_torch.core import merge_kernel as mk

NEG = crdt.NEG


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _lanes(rng, n, rows, cols, m):
    """Deletes, resurrections, invalid lanes and same-cell conflicts."""
    row = rng.integers(0, rows, m)
    col = rng.integers(0, cols, m)
    vr = rng.integers(-3, 50, m)
    cl = rng.integers(1, 4, m)
    is_del = rng.random(m) < 0.2
    fields = np.stack([
        row * cols + col, rng.integers(1, 6, m),
        np.where(is_del, NEG, vr), rng.integers(0, n, m),
        np.where(is_del, cl + cl % 2, cl), rng.random(m) < 0.8,
    ]).astype(np.int32)
    return fields


def _state(rng, n, rows, cols, device):
    pre = _lanes(rng, n, rows, cols, n * 64)
    dst = rng.integers(0, n, n * 64).astype(np.int32)
    f = torch.as_tensor(pre, device=device)
    return crdt.apply_cell_changes(
        crdt.make_table_state(n, rows, cols, device),
        torch.as_tensor(dst, device=device), f[0] // cols, f[0] % cols,
        f[1], f[2], f[3], f[4], f[5] != 0,
    )


def _check(state, box, cap, cols):
    n = state.cl.shape[0]
    planes = (state.cv.view(n, -1), state.vr.view(n, -1),
              state.site.view(n, -1), state.cl)
    want = mk.grouped_merge_reference(*planes, box, cap, cols)
    before = mk.LAUNCHES["grouped_merge"]
    got = mk.grouped_merge(*planes, box, cap, cols)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["grouped_merge"] == before + 1
    for g, p, w in zip(got, planes, want):
        assert g.data_ptr() == p.data_ptr()
        assert torch.equal(p, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,cols,cap", [
    (512, 256, 4, 128),  # the slice's cell layout
    (256, 8192, 1, 128),
    (512, 128, 8, 128),
    (512, 256, 4, 256),
    (256, 64, 16, 128),  # the general (run-time cols) path
    (256, 128, 3, 128),
    (64, 32, 4, 100),  # cap not a multiple of 32
    (1000, 512, 6, 1024),  # config 3's sync mailbox: one warp per block
    (1000, 512, 6, 512),  # config 3's delivery mailbox under "on"
    (1000, 2048, 2, 512),  # config 6's sync mailbox (4096 cells)
    (1000, 2048, 2, 128),  # config 6's delivery mailbox under "on"
])
def test_cuda_kernel_matches_plain_version(dev, n, rows, cols, cap):
    rng = np.random.default_rng(n + rows + cols + cap)
    state = _state(rng, n, rows, cols, dev)
    box = torch.as_tensor(_lanes(rng, n, rows, cols, n * cap), device=dev)
    _check(state, box, cap, cols)


@pytest.mark.cuda
def test_kernel_hot_row_and_empty_mailbox(dev):
    rng = np.random.default_rng(5)
    n, rows, cols, cap = 64, 256, 4, 128
    state = _state(rng, n, rows, cols, dev)
    box = torch.as_tensor(_lanes(rng, n, rows, cols, n * cap), device=dev)
    box[mk.LANE_VALID] = 0
    _check(state, box, cap, cols)  # nothing valid: nothing changes
    box[mk.LANE_VALID, :cap] = 1  # every lane of node 0 on row 7
    box[mk.LANE_CELL, :cap] = 7 * cols + box[mk.LANE_CELL, :cap] % cols
    _check(state, box, cap, cols)


@pytest.mark.cuda
def test_dram_probe_keeps_the_planes(dev):
    """The probe's read and read-write patterns leave the planes as they
    were; its write pattern fills exactly the listed rows."""
    from corro_sim_torch import merge_probe as mp

    rng = np.random.default_rng(9)
    n, rows, cols, cap = 64, 256, 4, 128
    state = _state(rng, n, rows, cols, dev)
    box = torch.as_tensor(_lanes(rng, n, rows, cols, n * cap), device=dev)
    hit = mp.hit_rows(box, cap, cols, rows * cols)
    planes = (state.cv.view(n, -1), state.vr.view(n, -1),
              state.site.view(n, -1))
    before = [p.clone() for p in planes]
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for mode in range(1, len(mp.PROBE_MODES)):
        mp.probe(planes, hit, mode, sink)
        torch.cuda.synchronize()
        assert all(torch.equal(p, b) for p, b in zip(planes, before))
    mp.probe(planes, hit, 0, sink)
    torch.cuda.synchronize()
    listed = torch.zeros((n, rows), dtype=torch.bool, device=dev)
    listed[torch.arange(n, device=dev)[:, None].expand_as(hit)[hit >= 0],
           hit[hit >= 0].long()] = True
    written = listed.repeat_interleave(cols, dim=1)
    for p, b in zip(planes, before):
        assert bool((p[written] == 0).all())
        assert torch.equal(p[~written], b[~written])
