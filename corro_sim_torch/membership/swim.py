"""SWIM membership state — the SWIM-off placeholder only.

Port of the ``SwimState`` container of ``corro_sim/membership/swim.py``.
With SWIM off the plane is a ``(1, 1)`` placeholder; the JAX package
keeps it uint32 (uint16 under ``narrow_state``), the port carries those
in int64 (int32). The SWIM automaton itself is the next slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SwimState:
    p: torch.Tensor  # (N, N) packed (inc, status, since) beliefs


def make_swim_state(num_nodes: int, enabled: bool, narrow: bool,
                    device) -> SwimState:
    if enabled:
        raise NotImplementedError("SWIM is not ported yet")
    dtype = torch.int32 if narrow else torch.int64
    return SwimState(p=torch.zeros((1, 1), dtype=dtype, device=device))
