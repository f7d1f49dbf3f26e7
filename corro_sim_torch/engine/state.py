"""The whole cluster as one dataclass of tensors.

Port of ``corro_sim/engine/state.py``: a structure of arrays whose leading
axis is the node dimension. The planes of optional features (the probe
tracer, the RTT plane, the in-flight ring, the burst-loss plane) keep
the JAX package's ``(1, ...)`` placeholder shapes when their feature is
off, and the dict-style planes of the feature registry
(``engine/features.py``: the node-fault epoch and snapshot) appear
exactly where the JAX package's do, so the two states compare leaf for
leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the fault modules register their feature leaves at import time
import corro_sim_torch.faults.inject  # noqa: F401
import corro_sim_torch.faults.nodes  # noqa: F401
import corro_sim_torch.sweep.knobs  # noqa: F401
from corro_sim_torch.config import SimConfig, validate_torch_slice
from corro_sim_torch.core.bookkeeping import Bookkeeping, make_bookkeeping
from corro_sim_torch.core.changelog import ChangeLog, make_changelog
from corro_sim_torch.core.compaction import CellOwnership, make_ownership
from corro_sim_torch.core.crdt import TableState, make_table_state
from corro_sim_torch.device import resolve_device
from corro_sim_torch.engine.features import build_features, build_field
from corro_sim_torch.engine.probe import ProbeState  # registers "probe"
from corro_sim_torch.gossip.broadcast import GossipState, make_gossip_state
from corro_sim_torch.membership.rtt import make_rtt
from corro_sim_torch.membership.swim import SwimState, make_swim_state
from corro_sim_torch.membership.swim_window import (
    SwimWindowState,
    make_swim_window_state,
)


@dataclasses.dataclass
class SimState:
    table: TableState
    book: Bookkeeping
    log: ChangeLog
    own: CellOwnership
    gossip: GossipState
    swim: SwimState | SwimWindowState  # windowed when swim_view_size > 0
    ring0: torch.Tensor  # (N, ring0_size) int32 static eager-peer table
    row_cdf: torch.Tensor  # (R,) float32 cumulative row distribution
    round: torch.Tensor  # () int32
    sync_rounds: torch.Tensor  # () int32 — executed anti-entropy sweeps
    hlc: torch.Tensor  # (N,) int32 per-node hybrid logical clock
    last_cleared: torch.Tensor  # (N,) int32 newest applied EmptySet ts
    cleared_hlc: torch.Tensor  # (A, L) int32 EmptySet stamp per version
    rtt: torch.Tensor  # (N, N) uint8 observed edge delay [receiver,
    # sender], 255 = unobserved; (1, 1) when rtt_rings is off
    inflight: torch.Tensor  # (slots, 6, L) int32 in-flight delayed lanes,
    # one ring slot per future round, planes (dst, src, actor, ver,
    # chunk, valid); (1, 6, 1) when the latency model is off
    probe: ProbeState  # the probe tracer (engine/probe.py); (1, 1)
    # placeholder planes when probes == 0
    fault_burst: torch.Tensor  # (N,) bool Gilbert burst state per node's
    # receive path; a (1,) placeholder when burst loss is off
    features: dict = dataclasses.field(default_factory=dict)
    # the enabled dict-style feature leaves (engine/features.py), keyed
    # by name; a disabled feature contributes nothing


def _row_cdf(cfg: SimConfig) -> np.ndarray:
    r = cfg.num_rows
    if cfg.zipf_alpha <= 0.0:
        w = np.ones(r, np.float64)
    else:
        w = 1.0 / np.power(np.arange(1, r + 1, dtype=np.float64), cfg.zipf_alpha)
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    return cdf.astype(np.float32)


def _ring0(cfg: SimConfig, seed: int) -> np.ndarray:
    """Static low-latency neighbor table: the nearest ids plus one random
    long link (``members.rs:40,140-188`` analog)."""
    rng = np.random.default_rng(seed)
    n, k = cfg.num_nodes, cfg.ring0_size
    near = ((np.arange(n)[:, None] + np.arange(1, k + 1)[None, :]) % n).astype(
        np.int32
    )
    if k >= 2:
        near[:, -1] = rng.integers(0, n, size=n)  # one random long link
    return near


def init_state(cfg: SimConfig, seed: int = 0, device=None) -> SimState:
    """The empty cluster for ``cfg`` on ``device`` (default ``cuda``)."""
    validate_torch_slice(cfg)
    dev = resolve_device(device)
    n = cfg.num_nodes
    i32 = dict(dtype=torch.int32, device=dev)
    return SimState(
        table=make_table_state(n, cfg.num_rows, cfg.num_cols, dev),
        book=make_bookkeeping(n, cfg.num_actors, dev),
        log=make_changelog(
            cfg.num_actors, cfg.log_capacity, cfg.seqs_per_version, dev
        ),
        own=make_ownership(cfg.num_rows, cfg.num_cols, dev),
        gossip=make_gossip_state(n, cfg.pend_slots, dev),
        swim=(
            make_swim_window_state(
                n, cfg.swim_view_size, seed, cfg.swim_enabled,
                cfg.narrow_state, dev,
            )
            if cfg.swim_view_size > 0
            else make_swim_state(n, cfg.swim_enabled, cfg.narrow_state, dev)
        ),
        ring0=torch.as_tensor(_ring0(cfg, seed), device=dev),
        row_cdf=torch.as_tensor(_row_cdf(cfg), device=dev),
        round=torch.zeros((), **i32),
        sync_rounds=torch.zeros((), **i32),
        hlc=torch.zeros((n,), **i32),
        last_cleared=torch.full((n,), -1, **i32),
        cleared_hlc=torch.full((cfg.num_actors, cfg.log_capacity), -1, **i32),
        rtt=make_rtt(n, cfg.rtt_rings, dev),
        inflight=torch.zeros(
            (cfg.inflight_slots, 6, cfg.lanes_per_round)
            if cfg.inflight_slots else (1, 6, 1), **i32),
        probe=build_field("probe", cfg, seed, dev),
        fault_burst=build_field("fault_burst", cfg, seed, dev),
        features=build_features(cfg, seed, dev),
    )


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor: through dataclasses
    and through dicts (the feature leaves) alike."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return dataclasses.replace(obj, **{
        f.name: _map_tensors(getattr(obj, f.name), fn)
        for f in dataclasses.fields(obj)
    })


def clone_state(state: SimState) -> SimState:
    """A device-side deep copy: every tensor cloned where it lies. The
    pipelined driver speculates from one, because a step consumes its
    input state."""
    return _map_tensors(state, torch.Tensor.clone)


def state_nbytes(state: SimState) -> int:
    """Bytes of the state's tensors."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    _map_tensors(state, add)
    return total
