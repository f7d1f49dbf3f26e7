"""Sort and scatter helpers that keep the JAX package's semantics.

- :func:`lexsort` — ``jnp.lexsort``: the last key is primary, ties keep
  input order (a chain of stable argsorts, least significant key first).
- :func:`top_k` — ``jax.lax.top_k``: the lower index wins a tie, which a
  stable descending sort keeps and ``torch.topk`` does not.
- :func:`scatter_max`, :func:`scatter_min`, :func:`scatter_add`,
  :func:`scatter_set` — ``x.at[idx].max/min/add/set(v, mode="drop")`` on the flattened leading
  axes: lanes whose index is masked out or out of range change nothing.
"""

from __future__ import annotations

import torch


def lexsort(keys) -> torch.Tensor:
    """Indices that sort by ``keys[-1]``, then ``keys[-2]``, ... (int64)."""
    keys = list(keys)
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis,
    lower index first among equals."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def flat_index(shape, *idx):
    """Linear index into the leading ``len(idx)`` axes of ``shape`` and
    the mask of lanes whose every index lies in range."""
    lin = torch.zeros_like(idx[0], dtype=torch.int64)
    ok = torch.ones_like(idx[0], dtype=torch.bool)
    for dim, i in zip(shape, idx):
        i = i.to(torch.int64)
        ok = ok & (i >= 0) & (i < dim)
        lin = lin * dim + i
    return lin, ok


def _prep(dest, idx, vals, keep):
    lead = len(idx)
    lin, ok = flat_index(dest.shape[:lead], *idx)
    if keep is not None:
        ok = ok & keep
    flat = dest.reshape((-1,) + tuple(dest.shape[lead:]))
    if isinstance(vals, torch.Tensor):
        vals = vals.to(dtype=dest.dtype, device=dest.device)
    else:  # a fill: copying a host scalar to the card would wait for it
        vals = torch.full((), vals, dtype=dest.dtype, device=dest.device)
    vals = vals.expand(lin.shape + tuple(dest.shape[lead:]))
    return flat, torch.where(ok, lin, 0), ok, vals


def _lane_mask(ok, vals):
    return ok.reshape(ok.shape + (1,) * (vals.dim() - ok.dim()))


def _scatter_reduce(dest, idx, vals, keep, reduce: str, identity: int):
    flat, lin, ok, vals = _prep(dest, idx, vals, keep)
    vals = torch.where(_lane_mask(ok, vals), vals, identity)
    row = flat[0].numel()
    if row > 1:
        lin = (lin[..., None] * row + torch.arange(
            row, device=lin.device)).reshape(-1)
    out = flat.reshape(-1).clone()
    out.scatter_reduce_(0, lin.reshape(-1), vals.reshape(-1), reduce)
    return out.reshape(dest.shape)


def scatter_max(dest, idx, vals, keep=None):
    """``dest.at[idx].max(vals, mode="drop")`` (returns a new tensor)."""
    return _scatter_reduce(dest, idx, vals, keep, "amax",
                           torch.iinfo(dest.dtype).min)


def scatter_min(dest, idx, vals, keep=None):
    """``dest.at[idx].min(vals, mode="drop")`` (returns a new tensor)."""
    return _scatter_reduce(dest, idx, vals, keep, "amin",
                           torch.iinfo(dest.dtype).max)


def scatter_add(dest, idx, vals, keep=None):
    """``dest.at[idx].add(vals, mode="drop")`` (returns a new tensor)."""
    flat, lin, ok, vals = _prep(dest, idx, vals, keep)
    vals = torch.where(_lane_mask(ok, vals), vals, 0)
    return flat.clone().index_add_(0, lin, vals).reshape(dest.shape)


def scatter_set(dest, idx, vals, keep=None):
    """``dest.at[idx].set(vals, mode="drop")`` (returns a new tensor).
    Kept lanes must hold distinct indices (the JAX package leaves the
    winner of a duplicate ``set`` unspecified); dropped lanes write a
    scratch row past the end."""
    flat, lin, ok, vals = _prep(dest, idx, vals, keep)
    n = flat.shape[0]
    out = torch.cat([flat, flat[:1]])
    out[torch.where(ok, lin, n)] = vals
    return out[:n].reshape(dest.shape)
