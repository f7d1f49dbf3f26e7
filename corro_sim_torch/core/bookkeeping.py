"""Version bookkeeping: who has applied which versions of which actor.

Port of ``corro_sim/core/bookkeeping.py``. ``head[N, A]`` is the
contiguously applied prefix per (node, actor); ``win[N, A]`` a 32-bit
out-of-order window over the next ``32 // bits_per_version`` versions.
Each version owns a group of ``bits_per_version`` adjacent bits, one per
changeset chunk (bit ``v * bpv + c`` set = chunk ``c`` of version
``head + 1 + v`` arrived); a version applies once its whole group is set,
and a partly set group is a buffered partial version. The JAX package
keeps ``win`` as uint32; the port carries it in int64 (torch has no
uint32 shifts on the CPU) and masks to 32 bits. A delivery beyond the
window drops, and anti-entropy repairs it.
"""

from __future__ import annotations

import dataclasses

import torch

from corro_sim_torch.utils.bits import WINDOW_BITS, absorb, window_shift_right
from corro_sim_torch.utils.slots import dedupe_sorted_mask
from corro_sim_torch.utils.sort import scatter_add


@dataclasses.dataclass
class Bookkeeping:
    head: torch.Tensor  # (N, A) int32
    win: torch.Tensor  # (N, A) int64 carrier of a uint32 window


def make_bookkeeping(num_nodes: int, num_actors: int, device) -> Bookkeeping:
    return Bookkeeping(
        head=torch.zeros((num_nodes, num_actors), dtype=torch.int32,
                         device=device),
        win=torch.zeros((num_nodes, num_actors), dtype=torch.int64,
                        device=device),
    )


def version_window(bits_per_version: int) -> int:
    """How many versions ahead of the head the window can buffer."""
    return WINDOW_BITS // bits_per_version


def deliver_versions(
    book: Bookkeeping,
    dst: torch.Tensor,
    actor: torch.Tensor,
    ver: torch.Tensor,
    valid: torch.Tensor,
    chunk: torch.Tensor | None = None,
    bits_per_version: int = 1,
):
    """Record a batch of ``(dst, actor, ver[, chunk])`` deliveries.

    The lanes must already be ordered by ``(where(valid, dst, n+1),
    actor, ver, chunk)`` (the delivery pass hoists that sort) — the JAX
    package's ``presorted=True`` path. Returns ``(book, fresh_chunk,
    complete, dropped)`` in the given lane order: the first delivery of
    a chunk not yet seen, the one lane per (dst, actor, ver) that made
    its version complete, and beyond-window drops.

    Each version owns a group of ``bits_per_version`` window bits, one
    per chunk; it completes when its whole group is set now and was not
    before the batch. ``chunk`` None is the chunkless path of one bit
    per version, where a fresh lane completes its version; more bits per
    version need the chunk lanes.

    Window offsets are computed against the head before the batch, so a
    version more than the window ahead of the pre-round head drops even
    if the same batch fills the gap."""
    n = book.head.shape[0]
    bpv = bits_per_version
    vwin = version_window(bpv)
    chunkless = chunk is None
    s_dst = torch.where(valid, dst, n + 1)
    if chunkless:
        first_chunk = first_ver = dedupe_sorted_mask(s_dst, actor, ver) & valid
    else:
        first_chunk = dedupe_sorted_mask(s_dst, actor, ver, chunk) & valid
        first_ver = dedupe_sorted_mask(s_dst, actor, ver) & valid

    # invalid lanes index node -1 (the JAX package's wrapped sentinel);
    # their gathers are garbage and every use is masked by `first_*`
    d = torch.where(valid, s_dst, -1).long()
    a = actor.long()
    head_g = book.head[d, a]
    win_g = book.win[d, a]
    voff = ver - head_g - 1
    in_window = (voff >= 0) & (voff < vwin)
    if chunkless:
        off = voff.clamp(0, WINDOW_BITS - 1).to(torch.int64)
    else:
        off = (voff * bpv + chunk).clamp(0, WINDOW_BITS - 1).to(torch.int64)
    already = in_window & (((win_g >> off) & 1) != 0)
    fresh = first_chunk & in_window & ~already
    dropped = first_chunk & (voff >= vwin)

    bit = torch.where(fresh, torch.ones_like(off) << off, 0)
    new_win = scatter_add(book.win, (d, a), bit, valid)

    if bpv == 1:
        complete = fresh
    else:
        # the version's group of bits, read after the scatter: all set
        # now and not all set before the batch. gshift <= 32 - bpv, so
        # the mask stays inside 32 bits.
        group_mask = (1 << bpv) - 1
        gshift = (voff.clamp(0, vwin - 1) * bpv).to(torch.int64)
        vmask = group_mask << gshift
        now_g = new_win[d, a]
        complete = (
            first_ver & in_window
            & ((now_g & vmask) == vmask)
            & ((win_g & vmask) != vmask)
        )

    new_head, new_win = absorb(book.head, new_win, bpv)
    return Bookkeeping(head=new_head, win=new_win), fresh, complete, dropped


def partial_versions(book: Bookkeeping, bits_per_version: int) -> torch.Tensor:
    """() int32 — buffered partial versions across the cluster: window
    groups with some but not all chunk bits set (the reference's
    ``__corro_buffered_changes`` row count). Single-chunk versions are
    never partial."""
    bpv = bits_per_version
    if bpv == 1:
        return torch.zeros((), dtype=torch.int32, device=book.head.device)
    group_mask = (1 << bpv) - 1
    total = torch.zeros((), dtype=torch.int32, device=book.head.device)
    for v in range(version_window(bpv)):
        g = (book.win >> (v * bpv)) & group_mask
        total = total + ((g != 0) & (g != group_mask)).sum(dtype=torch.int32)
    return total


def advance_heads(book: Bookkeeping, new_floor: torch.Tensor,
                  bits_per_version: int = 1) -> Bookkeeping:
    """Raise heads to at least ``new_floor`` — the sync fast path — and
    re-absorb window bits now below the head."""
    floor = torch.maximum(book.head, new_floor)
    delta = (floor - book.head).to(torch.int64) * bits_per_version
    head, win = absorb(
        floor, window_shift_right(book.win, delta), bits_per_version
    )
    return Bookkeeping(head=head, win=win)
