"""The least bytes the grouped LWW merge needs on given inputs: a frozen
copy of ``corro_sim_torch/core/merge_kernel.py::merge_work``, so that the
merge's roofline is counted the same whatever implements the merge.

The mailbox is ``(6, N * cap)`` int32 lanes, fields in this order: the
flat cell, col_version, value, site, causal length and a valid word;
each node owns ``cap`` consecutive lanes. The planes are ``cv``, ``vr``
and ``site`` ``(N, cells)`` and ``cl`` ``(N, rows)``.
"""

from __future__ import annotations

import torch

LANE_CELL, LANE_CV, LANE_VR, LANE_SITE, LANE_CL, LANE_VALID = range(6)
NEG = -(2 ** 31)
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet


def lane_classes(lanes, cap: int, cols: int, after):
    """Masks over the mailbox's lanes, by what the merge reads of them:
    valid word set; valid and in range (``hit``); at their row's merged
    generation (``gen``); carrying a value (``value``); tying the merged
    cv (``win1``); tying the merged cv and vr (``win2``). Also each lane's
    flat ``node * cells + cell`` index (clamped)."""
    cv1, vr1, _site1, cl1 = after
    n, cells = cv1.shape
    node = torch.arange(n * cap, device=lanes.device) // cap
    cell = lanes[LANE_CELL].long()
    valid = lanes[LANE_VALID] != 0
    hit = valid & (cell >= 0) & (cell < cells)
    flat = node * cells + cell.clamp(0, cells - 1)
    gen = hit & (lanes[LANE_CL] == cl1.reshape(-1)[flat // cols])
    value = gen & (lanes[LANE_VR] != NEG)
    win1 = value & (lanes[LANE_CV] == cv1.reshape(-1)[flat])
    win2 = win1 & (lanes[LANE_VR] == vr1.reshape(-1)[flat])
    return flat, valid, hit, gen, value, win1, win2


def merge_bytes(before, lanes, cap: int, cols: int, after) -> int:
    """Bytes, each word read or written once: of the lanes, the valid
    word of every lane, the cell of each valid lane, the cl of each
    in-range one, the vr of those at their row's merged generation, the
    cv of those carrying a value and the site of those tying the merged
    cv and vr; the cl of each (node, row) a valid in-range lane hits; the
    stored cv/vr/site of each cell a value lane at its row's merged
    generation hits, in a row whose cl did not grow; writes of each grown
    cl, of cv/vr/site for every cell of a row whose cl grew, and of each
    changed cell of a kept row."""
    cv0, vr0, site0, cl0 = before
    cv1, vr1, site1, cl1 = after
    n, cells = cv0.shape
    flat, valid, hit, gen, value, _win1, win2 = lane_classes(
        lanes, cap, cols, after)

    def count(m):
        return int(m.sum())

    grew = (cl1 > cl0).reshape(-1)
    rows_hit = torch.unique(flat[hit] // cols).numel()
    cells_hit = torch.unique(flat[value])
    kept_cells = count(~grew[cells_hit // cols])
    changed = ((cv1 != cv0) | (vr1 != vr0) | (site1 != site0)).reshape(-1)
    changed_kept = count(changed & ~grew.repeat_interleave(cols))
    lane_words = (n * cap + count(valid) + count(hit) + count(gen)
                  + count(value) + count(win2))
    words = (lane_words + rows_hit + 3 * kept_cells
             + count(grew) * (1 + 3 * cols) + 3 * changed_kept)
    return 4 * words
