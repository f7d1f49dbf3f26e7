"""Carry simulator state between the JAX package and the port.

Leaves are keyed by their path in the state, the JAX package's
``jax.tree_util.keystr`` with the leading dot dropped: ``"table.cv"``,
``"book.win"``, ``"probe.hop"``, ``"fault_burst"``, and for the feature
leaves ``"features['node_epoch']"``,
``"features['node_snapshot']['head']"``. On the way in, the checkpoint
spelling ``"features/node_snapshot/head"`` is read as well. The JAX
package keeps the window and the SWIM belief plane unsigned (uint32, or
uint16 under ``narrow_state``); the port carries them in wider signed
types (int64, int32), because torch has no unsigned 32- or 16-bit
arithmetic on the CPU.
"""

from __future__ import annotations

import dataclasses
import re
import typing

import numpy as np
import torch

from corro_sim_torch.engine.state import SimState
from corro_sim_torch.membership.swim import SwimState
from corro_sim_torch.membership.swim_window import SwimWindowState

# leaves the port widens, and the unsigned type each carrier narrows to
_NARROW = {torch.int64: np.uint32, torch.int32: np.uint16}
WIDENED = ("book.win", "swim.p", "swim.belief",
           "features['node_snapshot']['win']")


def _dict_leaves(d: dict, prefix: str):
    for k, v in d.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            yield from _dict_leaves(v, key)
        else:
            yield key, v


def _leaves(obj, prefix: str = ""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, f"{prefix}{f.name}.")
        elif isinstance(v, dict):
            yield from _dict_leaves(v, f"{prefix}{f.name}")
        else:
            yield f"{prefix}{f.name}", v


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.int32)
    return torch.as_tensor(arr.copy(), device=device)


def _features(leaves: dict, device) -> dict:
    """The ``features`` dict from its leaves, in either spelling."""
    out: dict = {}
    for key, arr in leaves.items():
        if key.startswith("features["):
            path = re.findall(r"\['([^']*)'\]", key)
        elif key.startswith("features/"):
            path = key.split("/")[1:]
        else:
            continue
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _tensor(arr, device)
    return out


def _build(cls, leaves: dict, device, prefix: str = ""):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        typ = hints[f.name]
        if key == "features":
            kwargs[f.name] = _features(leaves, device)
            continue
        if key == "swim":  # windowed when the leaves hold its planes
            typ = SwimWindowState if "swim.member" in leaves else SwimState
        if dataclasses.is_dataclass(typ):
            kwargs[f.name] = _build(typ, leaves, device, key + ".")
            continue
        kwargs[f.name] = _tensor(leaves[key], device)
    return cls(**kwargs)


def state_from_reference(leaves: dict, device) -> SimState:
    """The port's :class:`SimState` from the JAX package's state flattened
    into ``{path: numpy array}``."""
    return _build(SimState, leaves, torch.device(device))


def state_to_numpy(state: SimState) -> dict:
    """``{path: numpy array}`` in the JAX package's dtypes."""
    out = {}
    for key, t in _leaves(state):
        arr = t.detach().cpu().numpy()
        if key in WIDENED:
            arr = arr.astype(_NARROW[t.dtype])
        out[key] = arr
    return out
