"""Branch-free bit utilities for the out-of-order version window.

Port of ``corro_sim/utils/bits.py``. The window is a uint32 per (node,
actor) in the JAX package; torch has no uint32 shifts on the CPU, so the
port carries it in int64 and masks back to 32 bits after every shift.
Bit ``k`` means version ``head + 1 + k`` has been applied out of order;
absorbing the contiguous prefix is "count trailing ones, shift right".
"""

from __future__ import annotations

import torch

WINDOW_BITS = 32
M32 = 0xFFFFFFFF


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word in ``[0, 2**32)`` (SWAR count)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def trailing_ones_u32(x: torch.Tensor) -> torch.Tensor:
    """Consecutive set low bits of each 32-bit word (int64 result).

    ``popcount(lowbit(~x) - 1)``; an all-ones word gives 32 because the
    masked ``0 - 1`` is ``2**32 - 1``."""
    y = ~x & M32
    lowbit = y & -y
    return _popcount32((lowbit - 1) & M32)


def window_shift_right(win: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Logical right shift of each 32-bit window by ``t`` bits; a shift of
    32 or more gives 0."""
    t = t.clamp(0, WINDOW_BITS)
    shifted = win >> t.clamp(max=31)
    return torch.where(t >= WINDOW_BITS, torch.zeros_like(win), shifted)


def absorb(head: torch.Tensor, win: torch.Tensor, bits_per_version: int = 1):
    """Advance contiguous heads by the trailing complete versions and
    shift the window past them. Returns ``(head, win)``."""
    t = trailing_ones_u32(win)
    if bits_per_version > 1:
        t = (t // bits_per_version) * bits_per_version
    new_head = head + (t // bits_per_version).to(head.dtype)
    return new_head, window_shift_right(win, t)
