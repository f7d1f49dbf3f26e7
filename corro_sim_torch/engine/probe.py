"""On-device probe tracer: per-version propagation provenance planes.

Port of ``corro_sim/engine/probe.py``. K sampled versions ("probes") are
tracked through the gossip fabric on the device, off the lane tensors
the step already builds:

- ``first_seen[K, N]``: the round node n first held probe k (-1 never);
- ``infector[K, N]``: the peer whose message completed probe k at n, the
  minimum src among same-round candidates; ``-1`` at the origin, ``-2``
  where anti-entropy sync repaired it;
- ``hop[K, N]``: gossip path length from the origin (0 there; -1 for
  sync joins); int8 under ``narrow_state``, saturating at 127;
- ``dup[K]``: delivered probe chunks that landed on infected nodes;
- ``last_sync[N]``: the last round the node took part in a sweep.

With ``cfg.probes == 0`` the step runs none of this and the state holds
``(1, 1)`` placeholders.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from corro_sim_torch.engine.features import FeatureLeaf, register_feature
from corro_sim_torch.utils.sort import scatter_min

# infector sentinels
INFECTOR_NONE = -1  # origin (or not yet infected)
INFECTOR_SYNC = -2  # joined via an anti-entropy range transfer

_BIG = 2 ** 31 - 1


@dataclasses.dataclass
class ProbeState:
    actor: torch.Tensor  # (K,) int32 origin actor of each probe
    ver: torch.Tensor  # (K,) int32 tracked version of that actor
    first_seen: torch.Tensor  # (K, N) int32 round, -1 = never
    infector: torch.Tensor  # (K, N) int32 peer id or INFECTOR_* sentinel
    hop: torch.Tensor  # (K, N) int32 (int8 under narrow_state)
    dup: torch.Tensor  # (K,) int32 duplicate deliveries
    last_sync: torch.Tensor  # (N,) int32 last sweep round, -1 = never


def make_probe_state(num_probes: int, num_nodes: int, narrow: bool = False,
                     device=None) -> ProbeState:
    """Probe k tracks version 1 of actor ``k * N // K``: K origins spread
    evenly over the id space. ``num_probes == 0`` gives the ``(1, 1)``
    placeholder. ``narrow``: the hop plane is int8."""
    i32 = dict(dtype=torch.int32, device=device)
    hop_dt = torch.int8 if narrow else torch.int32
    k, n = (1, 1) if num_probes <= 0 else (num_probes, num_nodes)
    if num_probes <= 0:
        actor = torch.zeros((1,), **i32)
        ver = torch.zeros((1,), **i32)
    else:
        actor = torch.as_tensor(
            (np.arange(k, dtype=np.int64) * n // k).astype(np.int32),
            device=device)
        ver = torch.ones((k,), **i32)
    return ProbeState(
        actor=actor, ver=ver,
        first_seen=torch.full((k, n), -1, **i32),
        infector=torch.full((k, n), INFECTOR_NONE, **i32),
        hop=torch.full((k, n), -1, dtype=hop_dt, device=device),
        dup=torch.zeros((k,), **i32),
        last_sync=torch.full((n,), -1, **i32),
    )


# a field leaf, as in the JAX package: SimState.probe holds the planes,
# (1, 1) placeholders when off
register_feature(FeatureLeaf(
    name="probe",
    enabled=lambda cfg: cfg.probes > 0,
    build=lambda cfg, seed, device: make_probe_state(
        cfg.probes, cfg.num_nodes, cfg.narrow_state, device),
    placeholder=lambda cfg, device: make_probe_state(
        0, cfg.num_nodes, cfg.narrow_state, device),
    field="probe",
    volatile=True,
))


def probe_write_update(probe: ProbeState, round_, writers: torch.Tensor,
                       w_ver: torch.Tensor) -> ProbeState:
    """Origin marking: actor a committing version v this round seeds probe
    (a, v) at itself, hop 0, no infector."""
    k = probe.actor.shape[0]
    kidx = torch.arange(k, device=probe.actor.device)
    a = probe.actor.long()
    cur = probe.first_seen[kidx, a]
    hit = writers[a] & (w_ver[a] == probe.ver) & (cur < 0)
    first_seen = probe.first_seen.clone()
    first_seen[kidx, a] = torch.where(hit, round_, cur).to(torch.int32)
    hop = probe.hop.clone()
    hop[kidx, a] = torch.where(hit, 0, probe.hop[kidx, a]).to(hop.dtype)
    return dataclasses.replace(probe, first_seen=first_seen, hop=hop)


def probe_delivery_update(probe: ProbeState, round_, dst, src, actor, ver,
                          delivered, complete) -> ProbeState:
    """The broadcast merge point: lanes completing a probe's version at a
    new node record (first_seen, infector, hop); delivered probe chunks
    landing on infected nodes count as duplicates.

    Same-round ties pick the minimum src (a scatter-min; lanes that do
    not complete a new node take no part). ``hop`` is the infector's hop
    + 1, computed in int32 and saturated at the plane type's maximum, so
    an int8 plane stops at 127 instead of wrapping to "never"."""
    k = probe.actor.shape[0]
    m = dst.shape[0]
    n = probe.first_seen.shape[1]
    kk = torch.arange(k, device=dst.device)[:, None].expand(k, m)
    dstb = dst.long()[None, :].expand(k, m)
    match = ((actor[None, :] == probe.actor[:, None])
             & (ver[None, :] == probe.ver[:, None]))  # (K, m)
    seen = probe.first_seen[kk, dstb] >= 0  # pre-update state
    dup = probe.dup + (match & delivered[None, :] & seen).sum(
        dim=1, dtype=torch.int32)
    cand = match & complete[None, :] & ~seen
    min_src = scatter_min(
        torch.full((k, n), _BIG, dtype=torch.int32, device=dst.device),
        (kk, dstb), src[None, :].expand(k, m), cand,
    )
    newly = min_src != _BIG
    hop_src = torch.gather(probe.hop, 1, min_src.clamp(0, n - 1).long())
    hop_next = torch.clamp(hop_src.to(torch.int32), min=0) + 1
    if probe.hop.dtype != torch.int32:
        hop_next = torch.clamp(hop_next, max=torch.iinfo(probe.hop.dtype).max)
    return dataclasses.replace(
        probe,
        first_seen=torch.where(newly, round_, probe.first_seen).to(
            torch.int32),
        infector=torch.where(newly, min_src, probe.infector),
        hop=torch.where(newly, hop_next.to(probe.hop.dtype), probe.hop),
        dup=dup,
    )


def probe_book_update(probe: ProbeState, book_head: torch.Tensor,
                      round_) -> ProbeState:
    """The anti-entropy merge point: a node whose applied head now covers
    a probe's version without a recorded gossip delivery joined via a
    sync range transfer (INFECTOR_SYNC, no hop)."""
    has = book_head[:, probe.actor.long()].T >= probe.ver[:, None]  # (K, N)
    newly = has & (probe.first_seen < 0)
    return dataclasses.replace(
        probe,
        first_seen=torch.where(newly, round_, probe.first_seen).to(
            torch.int32),
        infector=torch.where(newly, INFECTOR_SYNC, probe.infector),
    )


def probe_sync_mark(probe: ProbeState, is_sync: bool, alive: torch.Tensor,
                    round_) -> ProbeState:
    """Stamp sweep participation: every live node takes part in a sweep
    round. ``is_sync`` is the host's answer for the round."""
    if not is_sync:
        return probe
    return dataclasses.replace(
        probe, last_sync=torch.where(alive, round_, probe.last_sync).to(
            torch.int32))


def probe_metrics(probe: ProbeState) -> dict:
    """Per-round scalars for the metrics and the flight recorder."""
    return {
        "probe_infected": (probe.first_seen >= 0).sum(dtype=torch.int32),
        "probe_dups": probe.dup.sum(dtype=torch.int32),
    }
