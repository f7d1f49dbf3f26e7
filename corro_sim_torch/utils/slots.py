"""Dedupe masks and within-group ranks over sorted lane batches.

Port of ``corro_sim/utils/slots.py``: both primitives sit on one sort —
order lanes by destination key, then first-occurrence masks and ranks
within a group are elementwise ops.
"""

from __future__ import annotations

import torch


def dedupe_sorted_mask(*keys: torch.Tensor) -> torch.Tensor:
    """Given already-sorted parallel key arrays, mask of first occurrences
    along the last axis."""
    first = torch.ones(keys[0].shape, dtype=torch.bool, device=keys[0].device)
    neq = torch.zeros_like(first[..., 1:])
    for k in keys:
        neq = neq | (k[..., 1:] != k[..., :-1])
    first[..., 1:] = neq
    return first


def ranks_within_group(group_sorted: torch.Tensor) -> torch.Tensor:
    """Rank of each element of a sorted group-id array within its group,
    e.g. ``[2,2,2,5,5,9] -> [0,1,2,0,1,0]`` (int32)."""
    n = group_sorted.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=group_sorted.device)
    starts = torch.searchsorted(group_sorted, group_sorted, side="left")
    return (idx - starts).to(torch.int32)


def group_counts(group_sorted: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Counts per group id (ids outside ``[0, num_groups)`` drop)."""
    keep = (group_sorted >= 0) & (group_sorted < num_groups)
    out = torch.zeros(num_groups, dtype=torch.int32,
                      device=group_sorted.device)
    return out.index_add_(
        0, torch.where(keep, group_sorted, 0).long(), keep.to(torch.int32)
    )


def ranks_within_group_masked(
    group: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Rank of each selected element among the selected elements of its
    group, without sorting. Requires the selected subsequence of
    ``group`` to be nondecreasing. An exclusive cumsum of the mask gives
    global selected counts; a cummax over run starts rebases them per
    group (int32)."""
    m = mask.to(torch.int64)
    ex = torch.cumsum(m, 0) - m
    gdst = torch.where(mask, group.to(torch.int64), -1)
    run = torch.cummax(gdst, 0).values
    prev_run = torch.cat([run.new_full((1,), -1), run[:-1]])
    is_start = mask & (prev_run != group)
    base = torch.cummax(torch.where(is_start, ex, -1), 0).values
    return torch.where(mask, ex - base, 0).to(torch.int32)
