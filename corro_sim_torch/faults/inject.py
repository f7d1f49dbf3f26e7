"""Link-fault kernels: the tensor side of :class:`FaultConfig`.

Port of ``corro_sim/faults/inject.py``. Everything here is gated on
``cfg.faults`` by the caller: with faults off the step runs none of it.

Key discipline: the fault lane derives its randomness by ``fold_in`` on
the round key with a fixed tag, not by widening the step's 9-way split,
so every other subkey is the same whether faults are on or off, and the
repair step derives the same fault keys as the full step. The keys are
host numpy (``prng``); the draws run on the state's device.

A draw whose every outcome is fixed by the knobs is not made: a loss of
exactly 0 keeps every lane (a uniform is never below 0) and a dup of 0
duplicates none. The draws that remain use the JAX package's counters
(a ``(2, L)`` draw's second row starts at counter ``L``), so each mask
equals the JAX package's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from corro_sim_torch import prng
from corro_sim_torch.engine.features import FeatureLeaf, register_feature
from corro_sim_torch.faults.masks import pairs_to_mask
from corro_sim_torch.utils.runtime import upload

__all__ = [
    "FAULT_KEY_TAG",
    "LaneFaultKnobs",
    "blackhole_mask",
    "blackhole_tensor",
    "burst_update",
    "fault_keys",
    "link_fault_masks",
    "sync_grant_keep",
]

# the Gilbert burst-loss Markov plane keeps the JAX package's
# placeholder-field layout (SimState.fault_burst, a (1,) stub when burst
# loss is off); a sweep with any bursting lane would arm it for every
# lane
register_feature(FeatureLeaf(
    name="fault_burst",
    enabled=lambda cfg: (
        cfg.faults.burst_enter > 0
        or (cfg.sweep.enabled and cfg.sweep.burst)
    ),
    build=lambda cfg, seed, device: torch.zeros(
        (cfg.num_nodes,), dtype=torch.bool, device=device),
    placeholder=lambda cfg, device: torch.zeros(
        (1,), dtype=torch.bool, device=device),
    field="fault_burst",
    volatile=True,
))

# fold_in tag of the fault key lane, folded on the round key itself
# (fixed forever: changing it changes every seeded fault stream)
FAULT_KEY_TAG = 0x0FA17


def fault_keys(key) -> tuple:
    """``(k_burst, k_link, k_sync)``: the round's fault subkeys, a
    ``fold_in`` of the round key and a 3-way split."""
    k_burst, k_link, k_sync = prng.split(prng.fold_in(key, FAULT_KEY_TAG), 3)
    return k_burst, k_link, k_sync


def blackhole_mask(faults, n: int) -> np.ndarray | None:
    """(N, N) bool host constant: True where src→dst silently drops;
    None without blackholes."""
    if not faults.blackhole:
        return None
    return pairs_to_mask(faults.blackhole, n)


@functools.lru_cache(maxsize=8)
def _blackhole_on(faults, n: int, device: str) -> torch.Tensor:
    return upload(blackhole_mask(faults, n), device)


def blackhole_tensor(faults, n: int, device) -> torch.Tensor | None:
    """:func:`blackhole_mask` on ``device``, uploaded once per run shape
    (callers must not write to it)."""
    if not faults.blackhole:
        return None
    return _blackhole_on(faults, n, str(device))


def _f32(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def burst_update(faults, burst: torch.Tensor, k_burst) -> torch.Tensor:
    """Advance the per-node Gilbert burst state one round: in-burst nodes
    exit with ``burst_exit``, healthy nodes enter with ``burst_enter``
    (two uniforms per node). Returns the placeholder untouched when
    burst loss is off."""
    if not faults.burst_on:
        return burst
    dev = burst.device
    u = prng.uniform(k_burst, (2,) + tuple(burst.shape), dev)
    enter = u[0] < _f32(faults.burst_enter, dev)
    stay = u[1] >= _f32(faults.burst_exit, dev)
    return torch.where(burst, stay, enter)


def link_fault_masks(faults, k_link, dst: torch.Tensor,
                     burst: torch.Tensor):
    """``(keep, dup)`` lane masks for the broadcast delivery point:
    ``keep`` survives the Bernoulli loss draw (a receiver in its burst
    state loses at ``max(loss, burst_loss)``), ``dup`` is delivered
    twice (accounted, not re-merged: every merge is idempotent per
    (dst, actor, ver, chunk)). Row 0 of the JAX package's ``(2, L)``
    draw decides loss, row 1 duplication."""
    dev = dst.device
    lanes = dst.shape[0]
    if faults.loss > 0.0 or faults.burst_on:
        p = _f32(faults.loss, dev)
        if faults.burst_on:
            p = torch.where(
                burst[dst.long()],
                torch.maximum(p, _f32(faults.burst_loss, dev)), p,
            )
        keep = prng.uniform(k_link, (lanes,), dev) >= p
    else:
        keep = torch.ones((lanes,), dtype=torch.bool, device=dev)
    if faults.dup > 0.0:
        dup = prng.uniform(k_link, (lanes,), dev,
                           offset=lanes) < _f32(faults.dup, dev)
    else:
        dup = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    return keep, dup


class LaneFaultKnobs:
    """Stands in for :class:`FaultConfig` in the kernels above with one
    sweep lane's thresholds (``corro_sim_torch/sweep/knobs.py``): the
    lane's host copy of its ``sweep_knobs`` leaf, so every draw the
    knobs fix is skipped for that lane exactly as for a config holding
    the same values. The gate (``burst_on``) is the union sweep's."""

    __slots__ = (
        "loss", "dup", "burst_enter", "burst_exit", "burst_loss",
        "resolved_sync_loss", "burst_on",
    )

    def __init__(self, knobs: dict, burst_on: bool):
        self.loss = float(knobs["loss"])
        self.dup = float(knobs["dup"])
        self.burst_enter = float(knobs["burst_enter"])
        self.burst_exit = float(knobs["burst_exit"])
        self.burst_loss = float(knobs["burst_loss"])
        self.resolved_sync_loss = float(knobs["sync_loss"])
        self.burst_on = bool(burst_on)


def sync_grant_keep(faults, k_sync, rows: torch.Tensor, peer: torch.Tensor,
                    bh: torch.Tensor | None) -> torch.Tensor:
    """(N, P) keep mask for admitted sync connections: a grant fails
    with ``resolved_sync_loss`` (the QUIC stream drop) and always when
    either direction of the client-server edge is blackholed (sync is a
    request and a response)."""
    dev = peer.device
    if faults.resolved_sync_loss > 0.0:
        keep = prng.uniform(k_sync, peer.shape, dev) >= _f32(
            faults.resolved_sync_loss, dev)
    else:
        keep = torch.ones(peer.shape, dtype=torch.bool, device=dev)
    if bh is not None:
        r = rows.long()[:, None]
        p = peer.long()
        keep = keep & ~(bh[r, p] | bh[p, r])
    return keep
