"""The merge is a join: merging a mailbox tile by tile, in lane order,
equals merging all of its lanes at once.

The CUDA kernel merges a mailbox larger than a warp's share of shared
memory in tiles (``core/csrc/merge_kernel.cu``); the card tests
(tests/test_torch_merge_cuda.py) hold it against the plain version at
config 5's 8192 lanes per node. Here the plain version
(``grouped_merge_reference``) is held to the property the tiling rests
on, on the CPU: for every tile size, the sequential merge of each
node's lanes ``[t0, t0 + tile)`` equals the single merge (tolerance:
exact).
"""

import numpy as np
import pytest
import torch

from corro_sim_torch.core import crdt
from corro_sim_torch.core import merge_kernel as mk

NEG = crdt.NEG


def _lanes(rng, n, rows, cols, m):
    """Deletes, resurrections, invalid lanes and same-cell conflicts."""
    row = rng.integers(0, rows, m)
    col = rng.integers(0, cols, m)
    vr = rng.integers(-3, 50, m)
    cl = rng.integers(1, 5, m)
    is_del = rng.random(m) < 0.2
    return torch.as_tensor(np.stack([
        row * cols + col, rng.integers(1, 6, m),
        np.where(is_del, NEG, vr), rng.integers(0, n, m),
        np.where(is_del, cl + cl % 2, cl), rng.random(m) < 0.7,
    ]).astype(np.int32))


def _planes(rng, n, rows, cols):
    t = crdt.make_table_state(n, rows, cols, "cpu")
    planes = (t.cv.view(n, -1), t.vr.view(n, -1), t.site.view(n, -1), t.cl)
    return mk.grouped_merge(*planes, _lanes(rng, n, rows, cols, n * 64), 64,
                            cols)


def _tiles(box, n, cap, tile):
    for t0 in range(0, cap, tile):
        width = min(tile, cap - t0)
        yield box.view(mk.LANE_FIELDS, n, cap)[:, :, t0:t0 + width].reshape(
            mk.LANE_FIELDS, -1).contiguous(), width


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tile", [128, 256, 384])
def test_tile_by_tile_equals_all_at_once(seed, tile):
    n, rows, cols, cap = 16, 16, 2, 1024
    rng = np.random.default_rng(seed)
    planes = _planes(rng, n, rows, cols)
    box = _lanes(rng, n, rows, cols, n * cap)
    want = mk.grouped_merge_reference(*planes, box, cap, cols)
    got = tuple(t.clone() for t in planes)
    for sub, width in _tiles(box, n, cap, tile):
        got = mk.grouped_merge_reference(*got, sub, width, cols)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_later_delete_wipes_an_earlier_tiles_value():
    """A value at cl 1 in the first tile, a delete at cl 2 in the second
    and a value at cl 1 in the third: the row ends wiped at cl 2."""
    n, rows, cols, cap, tile = 2, 4, 2, 384, 128
    box = torch.zeros((mk.LANE_FIELDS, n * cap), dtype=torch.int32)
    for pos, fields in ((5, (2, 5, 40, 1, 1)), (tile + 3, (3, 1, NEG, 1, 2)),
                        (2 * tile + 9, (3, 6, 50, 1, 1))):
        box[:5, pos] = torch.tensor(fields, dtype=torch.int32)
        box[mk.LANE_VALID, pos] = 1
    t = crdt.make_table_state(n, rows, cols, "cpu")
    planes = (t.cv.view(n, -1), t.vr.view(n, -1), t.site.view(n, -1), t.cl)
    want = mk.grouped_merge_reference(*planes, box, cap, cols)
    got = planes
    for sub, width in _tiles(box, n, cap, tile):
        got = mk.grouped_merge_reference(*got, sub, width, cols)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[3][0, 1]) == 2
    assert want[1][0, 2:4].tolist() == [NEG, NEG]
