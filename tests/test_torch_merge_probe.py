"""The merge probe's CPU-side pieces: the rows a mailbox hits, the
sync-style mailbox layout and the refusals. The timings themselves need
the card (``python -m corro_sim_torch.merge_probe``); the probe kernel is
checked there by tests/test_torch_merge_cuda.py."""

import numpy as np
import pytest
import torch

from corro_sim_torch import merge_probe as mp
from corro_sim_torch.core import merge_kernel as mk

from test_torch_merge_bound import CAP, CELLS, COLS, _box


def test_hit_rows_of_the_hand_built_mailbox():
    # node 0: cells 1 and 5 hit rows 0 and 1; the out-of-range and the
    # invalid lane hit nothing. node 1: cells 2, 3 and 0 are all row 0.
    got = mp.hit_rows(_box(), CAP, COLS, CELLS)
    assert got.dtype == torch.int32
    assert got.tolist() == [[0, 1], [0, -1]]


def test_hit_rows_of_an_empty_mailbox():
    box = torch.zeros((mk.LANE_FIELDS, 3 * CAP), dtype=torch.int32)
    assert mp.hit_rows(box, CAP, COLS, CELLS).tolist() == [[-1]] * 3


@pytest.mark.parametrize("seed", [0, 1])
def test_hit_rows_match_a_python_count(seed):
    rng = np.random.default_rng(seed)
    n, r, c, cap = 6, 32, 4, 16
    box = mp.sync_box(mp.random_lanes(rng, n, r, c, n * cap), c, "cpu")
    got = mp.hit_rows(box, cap, c, r * c)
    for node in range(n):
        lanes = box[:, node * cap:(node + 1) * cap]
        want = sorted({int(cell) // c for cell, ok in
                       zip(lanes[mk.LANE_CELL], lanes[mk.LANE_VALID]) if ok})
        row = [x for x in got[node].tolist() if x >= 0]
        assert row == want


def test_sync_box_is_node_major_fields():
    rng = np.random.default_rng(4)
    n, r, c, cap = 3, 8, 4, 8
    lanes = mp.random_lanes(rng, n, r, c, n * cap)
    box = mp.sync_box(lanes, c, "cpu")
    assert box.shape == (mk.LANE_FIELDS, n * cap)
    assert box.dtype == torch.int32 and box.is_contiguous()
    _dst, row, col, cv, vr, site, cl, valid = lanes
    want = np.stack([row * c + col, cv, vr, site, cl, valid])
    np.testing.assert_array_equal(box.numpy(), want)


def test_probe_refuses_a_wide_table():
    planes = [torch.zeros((2, 2048), dtype=torch.int32) for _ in range(3)]
    rows = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="1024"):
        mp.probe(planes, rows, 0, torch.zeros(1, dtype=torch.int32))


def test_main_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        mp.main(["--out", "unused"])
    assert e.value.code == 2
