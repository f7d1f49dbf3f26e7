"""The merge kernel's bound: ``merge_work`` (in place) and
``merge_work_out_of_place`` on a hand-built two-node mailbox, against
counts worked out by hand below. Exact integers.

Table: 2 nodes, 2 rows x 4 columns (8 cells), cap 4 lanes per node.
Node 0 holds row 0 at cl 1 with cells 0 and 1 written, row 1 at cl 1
with cell 4 written; node 1 is empty (cl 0).

Lanes (cell, cv, vr, site, cl, valid):
  node 0  l0 (1, 2, 7, 3, 1, 1)      value lane, kept row 0: cell 1 wins
          l1 (5, 1, 4, 2, 2, 1)      value lane, grows row 1: wiped
          l2 (-3, ...,       1)      out of range
          l3 (0, ...,        0)      invalid
  node 1  l4 (2, 1, NEG, NEG, 2, 1)  delete: grows row 0
          l5 (3, 1, 9, 0, 1, 1)      stale generation (row 0 is now 2)
          l6 (0, 3, 1, 1, 2, 1)      value lane in the wiped row
          l7 (0, 3, 1, 0, 2, 1)      ties l6 on cv and vr; site 1 wins
"""

import torch

from corro_sim_torch.core import crdt
from corro_sim_torch.core import merge_kernel as mk

NEG = crdt.NEG
N, ROWS, COLS, CAP = 2, 2, 4, 4
CELLS = ROWS * COLS


def _before():
    cv = torch.zeros((N, CELLS), dtype=torch.int32)
    vr = torch.full((N, CELLS), NEG, dtype=torch.int32)
    site = torch.full((N, CELLS), -1, dtype=torch.int32)
    cl = torch.zeros((N, ROWS), dtype=torch.int32)
    cl[0] = 1
    cv[0, :2], vr[0, :2], site[0, :2] = 1, torch.tensor([10, 20]), \
        torch.tensor([0, 1])
    cv[0, 4], vr[0, 4], site[0, 4] = 2, 5, 1
    return cv, vr, site, cl


def _box():
    lanes = [  # cell, cv, vr, site, cl, valid
        (1, 2, 7, 3, 1, 1), (5, 1, 4, 2, 2, 1), (-3, 1, 1, 1, 1, 1),
        (0, 9, 9, 9, 9, 0),
        (2, 1, NEG, NEG, 2, 1), (3, 1, 9, 0, 1, 1), (0, 3, 1, 1, 2, 1),
        (0, 3, 1, 0, 2, 1),
    ]
    return torch.tensor(lanes, dtype=torch.int32).T.contiguous()


def _merged():
    before = _before()
    after = tuple(t.clone() for t in before)
    mk.grouped_merge(*after, _box(), CAP, COLS)
    return before, after


def test_hand_built_merge_result():
    _, (cv, vr, site, cl) = _merged()
    assert cl.tolist() == [[1, 2], [2, 0]]
    # node 0: cell 1 won by l0; row 1 wiped, cell 5 from l1
    assert cv[0].tolist() == [1, 2, 0, 0, 0, 1, 0, 0]
    assert vr[0].tolist() == [10, 7, NEG, NEG, NEG, 4, NEG, NEG]
    assert site[0].tolist() == [0, 3, -1, -1, -1, 2, -1, -1]
    # node 1: row 0 wiped by l4, cell 0 from l6/l7; row 1 untouched
    assert cv[1].tolist() == [3, 0, 0, 0, 0, 0, 0, 0]
    assert vr[1].tolist() == [1] + [NEG] * 7
    assert site[1].tolist() == [1] + [-1] * 7


def test_in_place_bound_counts_by_hand():
    before, after = _merged()
    nbytes, ops = mk.merge_work(before, _box(), CAP, COLS, after)
    # lanes: 8 valid words + cell of 7 valid + cl of 6 in range + vr of 5
    #   at their generation (not l5) + cv of 4 value lanes (not l4) +
    #   site of 4 tying the merged cv and vr = 34
    # reads: cl of 3 hit rows + cv/vr/site of 1 hit cell in a kept row
    #   (node 0 cell 1) = 3 + 3
    # writes: 2 grown cl + 2 wiped rows x 4 cells x 3 planes + 1 changed
    #   cell of a kept row x 3 = 2 + 24 + 3
    assert nbytes == 4 * (34 + 3 + 3 + 2 + 24 + 3)
    # maxes: 6 + 4 + 4 + 4; selects: 3 hit cells x 3; compares: 3 rows
    assert ops == 18 + 9 + 3


def test_out_of_place_bound_counts_by_hand():
    before, after = _merged()
    nbytes, ops = mk.merge_work_out_of_place(before, _box(), CAP, COLS, after)
    # lanes: 8 valid words + 2 x 6 in range + 5 + 4 + 4 = 33
    # inputs: cl plane 4 + 2 kept rows x 4 cells x 3 planes = 28
    # outputs: 3 planes x 16 cells + cl plane 4 = 52
    assert nbytes == 4 * (33 + 28 + 52)
    # 6 + 4 + 2 x 4 maxes, 3 x 16 selects, 4 compares
    assert ops == 18 + 48 + 4


def test_sector_bytes_by_hand():
    """Each of the mailbox's six field rows is 8 words, one 32-byte sector,
    and each is read; the 4-word cl plane is one sector, read (hit rows)
    and written (grown rows); each 16-word plane is two sectors, both
    partly written (node 0: row 1 and cell 1; node 1: row 0), so both are
    read and written."""
    before, after = _merged()
    assert mk.merge_sector_bytes(before, _box(), CAP, COLS, after) == \
        32 * (6 + 2 + 3 * 4)


def test_untouched_mailbox_costs_only_valid_words():
    before = _before()
    after = tuple(t.clone() for t in before)
    box = torch.zeros((mk.LANE_FIELDS, N * CAP), dtype=torch.int32)
    mk.grouped_merge(*after, box, CAP, COLS)
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    assert mk.merge_work(before, box, CAP, COLS, after) == (4 * N * CAP, 0)
