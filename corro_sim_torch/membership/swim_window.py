"""The membership view gossip and sync consult.

Port of the SWIM-off branch of ``membership_view`` in
``corro_sim/membership/swim_window.py``: with SWIM off every node
believes every member is up, a shared ``(1, N)`` view.
"""

from __future__ import annotations

import torch


def membership_view(cfg, swim_state, n: int) -> torch.Tensor:
    if cfg.swim_enabled:
        raise NotImplementedError("SWIM views are not ported yet")
    return torch.ones((1, n), dtype=torch.bool, device=swim_state.p.device)
