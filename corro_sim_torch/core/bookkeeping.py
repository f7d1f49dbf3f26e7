"""Version bookkeeping: who has applied which versions of which actor.

Port of ``corro_sim/core/bookkeeping.py``. ``head[N, A]`` is the
contiguously applied prefix per (node, actor); ``win[N, A]`` a 32-bit
out-of-order window over the next versions (bit ``k`` set = version
``head + 1 + k`` arrived). The JAX package keeps ``win`` as uint32; the
port carries it in int64 (torch has no uint32 shifts on the CPU) and
masks to 32 bits. A delivery beyond the window drops, and anti-entropy
repairs it.
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


def deliver_versions(
    book: Bookkeeping,
    dst: torch.Tensor,
    actor: torch.Tensor,
    ver: torch.Tensor,
    valid: torch.Tensor,
):
    """Record a batch of single-chunk ``(dst, actor, ver)`` deliveries.

    The lanes must already be ordered by ``(where(valid, dst, n+1),
    actor, ver)`` (the delivery pass hoists that sort) — the JAX
    package's ``presorted=True``, chunkless path. Returns ``(book,
    fresh, complete, dropped)`` in the given lane order; with one chunk
    per version a fresh lane completes its version.

    Window offsets are computed against the head before the batch, so a
    version more than the window ahead of the pre-round head drops even
    if the same batch fills the gap."""
    n = book.head.shape[0]
    s_dst = torch.where(valid, dst, n + 1)
    first = dedupe_sorted_mask(s_dst, actor, ver) & valid

    # invalid lanes index node -1 (the JAX package's wrapped sentinel);
    # their gathers are garbage and every use is masked by `first`
    d = torch.where(valid, s_dst, -1).long()
    a = actor.long()
    head_g = book.head[d, a]
    win_g = book.win[d, a]
    voff = ver - head_g - 1
    in_window = (voff >= 0) & (voff < WINDOW_BITS)
    off = voff.clamp(0, WINDOW_BITS - 1).to(torch.int64)
    already = in_window & (((win_g >> off) & 1) != 0)
    fresh = first & in_window & ~already
    dropped = first & (voff >= WINDOW_BITS)

    bit = torch.where(fresh, torch.ones_like(off) << off, 0)
    new_win = scatter_add(book.win, (d, a), bit, valid)
    new_head, new_win = absorb(book.head, new_win, 1)
    return Bookkeeping(head=new_head, win=new_win), fresh, fresh, dropped


def partial_versions(book: Bookkeeping, bits_per_version: int) -> torch.Tensor:
    """() int32 — buffered partial versions; single-chunk versions are
    never partial."""
    if bits_per_version != 1:
        raise NotImplementedError("chunks_per_version > 1 is not ported")
    return torch.zeros((), dtype=torch.int32, device=book.head.device)


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
