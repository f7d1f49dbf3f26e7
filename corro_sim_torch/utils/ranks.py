"""Order-preserving rank translation.

Port of ``corro_sim/utils/ranks.py``. When a value universe re-sorts
(the twin's stale-universe refresh re-freezes its interner; a live
universe re-spaces), every plane holding old ranks must be re-labelled.
One implementation serves every holder, so the semantics cannot
diverge: unknown and sentinel ranks (anything not in ``old``, e.g. the
NEG fill, and every negative value) pass through unchanged.

Two paths with one answer: numpy arrays on the host, and torch tensors
where they lie (the twin translates its table and log planes on the
card). Each works in the array's own dtype, as the JAX package's does:
the rank tables are cast to it, then searched.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rank_map", "translate_ranks"]


def translate_ranks(values, old, new):
    """Map each element of ``values`` from old-rank space to new-rank
    space. ``old`` ascends; ``new`` is parallel to it. ``values`` is a
    numpy array or a torch tensor of any integer dtype and shape;
    elements not present in ``old`` are unchanged."""
    if len(old) == 0:
        return values
    if isinstance(values, torch.Tensor):
        return _translate_tensor(values, old, new)
    o = np.asarray(old, values.dtype)
    nw = np.asarray(new, values.dtype)
    idx = np.clip(np.searchsorted(o, values), 0, len(old) - 1)
    found = (values >= 0) & (o[idx] == values)
    return np.where(found, nw[idx], values)


def _translate_tensor(values: torch.Tensor, old, new) -> torch.Tensor:
    """The tensor path: a search of the sorted table, a clamp, a
    found-mask and a select, on ``values``' device and in its dtype."""
    np_dtype = torch.empty((), dtype=values.dtype).numpy().dtype
    o = torch.as_tensor(np.asarray(old, np_dtype), device=values.device)
    nw = torch.as_tensor(np.asarray(new, np_dtype), device=values.device)
    idx = torch.searchsorted(o, values.contiguous()).clamp_(0, len(old) - 1)
    found = (values >= 0) & (o[idx] == values)
    return torch.where(found, nw[idx], values)


def rank_map(old, new) -> dict:
    """Python-side translation dict for scalar rank fields."""
    return dict(zip(old, new))
