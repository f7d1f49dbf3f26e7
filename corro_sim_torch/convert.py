"""Carry simulator state between the JAX package and the port.

Leaves are keyed by their dotted path in the state (``"table.cv"``,
``"book.win"``, ``"probe.hop"``, ...) — the JAX package's pytree path
with the leading dot dropped. The JAX package keeps the window and the
SWIM belief plane unsigned (uint32, or uint16 under ``narrow_state``);
the port carries them in wider signed types (int64, int32), because
torch has no unsigned 32- or 16-bit arithmetic on the CPU.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from corro_sim_torch.engine.state import SimState
from corro_sim_torch.membership.swim import SwimState
from corro_sim_torch.membership.swim_window import SwimWindowState

# leaves the port widens, and the unsigned type each carrier narrows to
_NARROW = {torch.int64: np.uint32, torch.int32: np.uint16}
WIDENED = ("book.win", "swim.p", "swim.belief")


def _leaves(obj, prefix: str = ""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", v


def _build(cls, leaves: dict, device, prefix: str = ""):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        typ = hints[f.name]
        if key == "swim":  # windowed when the leaves hold its planes
            typ = SwimWindowState if "swim.member" in leaves else SwimState
        if dataclasses.is_dataclass(typ):
            kwargs[f.name] = _build(typ, leaves, device, key + ".")
            continue
        arr = np.asarray(leaves[key])
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        elif arr.dtype == np.uint16:
            arr = arr.astype(np.int32)
        kwargs[f.name] = torch.as_tensor(arr.copy(), device=device)
    return cls(**kwargs)


def state_from_reference(leaves: dict, device) -> SimState:
    """The port's :class:`SimState` from the JAX package's state flattened
    into ``{dotted path: numpy array}``."""
    return _build(SimState, leaves, torch.device(device))


def state_to_numpy(state: SimState) -> dict:
    """``{dotted path: numpy array}`` in the JAX package's dtypes."""
    out = {}
    for key, t in _leaves(state):
        arr = t.detach().cpu().numpy()
        if key in WIDENED:
            arr = arr.astype(_NARROW[t.dtype])
        out[key] = arr
    return out
