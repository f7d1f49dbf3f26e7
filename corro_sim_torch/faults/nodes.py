"""Node-lifecycle fault kernels: the tensor side of
:class:`NodeFaultConfig`.

Port of ``corro_sim/faults/nodes.py``. Four
fault kinds, all compiled from static schedules over the round counter,
with no random draw:

- **crash-restart with amnesia** — at a scheduled round the node's
  replica state (table rows, bookkeeping row, gossip ring, SWIM beliefs,
  HLC, last-cleared stamp) wipes to the empty-DB state; it rejoins with
  an epoch-bumped HLC and SWIM incarnation, and anti-entropy serves its
  history back (the global change log survives);
- **stale rejoin** — the wipe restores from the ``node_snapshot`` leaf,
  captured at an earlier scheduled round, instead of zero;
- **HLC clock skew** — a per-node offset raises the physical floor of
  timestamp generation (``engine/step.py::_hlc_tick``);
- **stragglers** — per-node duty cycles that skip broadcast emission and
  sync initiation on inactive rounds.

The schedules are host data and the round is counted on the host, so
which nodes wipe or snapshot in a round is known before anything is
queued: a round with no wipe and no capture queues nothing (the JAX
package's masked writes are then identities), and a round with one
uploads its mask. Every mask equals the JAX package's, so the full and
the repair step derive the same fault timeline and the post-quiesce
switch stays bit-for-bit.

Under a fleet sweep (``corro_sim_torch/sweep/``) the schedules are a
lane's knob planes instead (one wipe per node, -1 = never): the host
decisions read the lane's host copy of its ``sweep_knobs`` leaf, the
masks computed on the card (skew, duty cycles) read the leaf itself.

Write-gate soundness: node ordinal == actor id, so a wiped node must not
mint fresh versions while its own actor column is still behind the log
head (``recovering_mask``); the step gates local commits on it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from corro_sim_torch.core.crdt import NEG
from corro_sim_torch.engine.features import FeatureLeaf, register_feature
from corro_sim_torch.utils.runtime import upload

__all__ = [
    "apply_node_faults",
    "recovering_mask",
    "skew_plane",
    "straggler_active",
]


def _snapshot_leaf(cfg, seed, device) -> dict:
    """The stale-rejoin capture plane: table cell planes and bookkeeping
    rows, initialized to the empty-DB values (a restore scheduled before
    its snapshot degenerates to amnesia). ``win`` rides the port's int64
    carrier of the JAX package's uint32 window."""
    n, r, c, a = (cfg.num_nodes, cfg.num_rows, cfg.num_cols,
                  cfg.num_actors)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "cv": torch.zeros((n, r, c), **i32),
        "vr": torch.full((n, r, c), NEG, **i32),
        "site": torch.full((n, r, c), -1, **i32),
        "cl": torch.zeros((n, r), **i32),
        "head": torch.zeros((n, a), **i32),
        "win": torch.zeros((n, a), dtype=torch.int64, device=device),
    }


register_feature(FeatureLeaf(
    name="node_epoch",
    # the vacuous trace threads the plane too
    enabled=lambda cfg: bool(
        cfg.node_faults.wipe_enabled or cfg.node_faults.trace_vacuous
        or (cfg.sweep.enabled and cfg.sweep.wipe_planes)
    ),
    build=lambda cfg, seed, device: torch.zeros(
        (cfg.num_nodes,), dtype=torch.int32, device=device),
    volatile=True,
))
register_feature(FeatureLeaf(
    name="node_snapshot",
    enabled=lambda cfg: bool(
        cfg.node_faults.stale or (cfg.sweep.enabled and cfg.sweep.stale)
    ),
    build=_snapshot_leaf,
    volatile=True,
))


def _mask_at(nodes, rounds, n: int, round_: int) -> np.ndarray:
    """(N,) bool host mask: which scheduled ``(node, round)`` entries
    fire in round ``round_``. The sentinel (node 0, round -1) never
    fires."""
    hit = np.asarray(rounds) == int(round_)
    out = np.zeros((n,), bool)
    nodes = np.asarray(nodes)[hit]
    out[nodes[(nodes >= 0) & (nodes < n)]] = True
    return out


def _sched(pairs, vacuous: bool, width: int = 2):
    """Schedule tuples → per-column int32 host arrays, with a
    never-firing sentinel row when the schedule is empty but the
    machinery must run (``trace_vacuous``)."""
    rows = [tuple(int(x) for x in p) for p in pairs]
    if not rows:
        assert vacuous
        rows = [tuple([0] + [-1] * (width - 1))]
    return tuple(np.asarray(col, np.int32) for col in zip(*rows))


@functools.lru_cache(maxsize=16)
def _skew_on(skew: tuple, n: int, device: str) -> torch.Tensor:
    plane = np.zeros((n,), np.int32)
    for node, off in skew:
        plane[int(node)] = int(off)
    return upload(plane, device)


def skew_plane(nf, n: int, device, sweep=None) -> torch.Tensor | None:
    """(N,) int32 per-node clock offset for ``_hlc_tick``'s physical
    floor, on ``device`` (uploaded once per run shape; callers must not
    write to it), or None when skew is off. ``sweep``: a lane's
    ``sweep_knobs`` leaf, whose ``skew`` plane replaces the schedule."""
    if sweep is not None:
        return sweep["skew"] if "skew" in sweep else None
    if not (nf.skew or nf.trace_vacuous):
        return None
    return _skew_on(tuple(nf.skew), n, str(device))


@functools.lru_cache(maxsize=16)
def _straggle_on(straggle: tuple, vacuous: bool, device: str):
    nodes, period, active = _sched(straggle, vacuous, width=3)
    if not straggle:
        # sentinel: period 1, active 1 — always participating
        period = np.ones_like(period)
        active = np.ones_like(active)
    return (upload(nodes.astype(np.int64), device), upload(nodes, device),
            upload(period, device), upload(active, device))


def straggler_active(nf, n: int, round_, device,
                     sweep=None) -> torch.Tensor | None:
    """(N,) bool participation mask: False while a straggler's duty
    cycle parks it, ``(round + node) % period < active``. None when
    stragglers are off. ``round_`` is the host round (gossip gates) or
    the device sweep counter (sync gates). ``sweep``: a lane's
    ``sweep_knobs`` leaf; its duty planes give the dense per-node form
    of the same expression (non-stragglers at period 1, active 1)."""
    if sweep is not None:
        if "straggle_period" not in sweep:
            return None
        ids = torch.arange(n, dtype=torch.int32, device=device)
        return ((round_ + ids) % sweep["straggle_period"]
                ) < sweep["straggle_active"]
    if not (nf.straggle or nf.trace_vacuous):
        return None
    nodes, nodes32, period, active = _straggle_on(
        tuple(nf.straggle), bool(nf.trace_vacuous), str(device))
    act = ((round_ + nodes32) % period) < active
    parked = torch.zeros((n,), dtype=torch.int32, device=nodes.device)
    parked.index_add_(0, nodes, (~act).to(torch.int32))
    return parked == 0


def recovering_mask(book, log) -> torch.Tensor:
    """(N,) bool: nodes whose own actor column is still behind the log
    head — the post-wipe resync window in which local commits are
    gated, and the ``node_fault_recovering`` metric. Identically False
    absent wipes."""
    return book.head.diagonal() < log.head


def _wipe_masks(nf, n: int, round_: int):
    """Host masks of round ``round_``: ``(capture, amnesia, stale)``
    (``stale`` None without stale schedules)."""
    cap = sv = None
    if nf.stale:
        s_nodes = [int(x[0]) for x in nf.stale]
        cap = _mask_at(s_nodes, [int(x[1]) for x in nf.stale], n, round_)
        sv = _mask_at(s_nodes, [int(x[2]) for x in nf.stale], n, round_)
    if nf.crash or (nf.trace_vacuous and not nf.stale):
        c_nodes, c_rounds = _sched(nf.crash, nf.trace_vacuous)
        am = _mask_at(c_nodes, c_rounds, n, round_)
    else:
        am = np.zeros((n,), bool)
    return cap, am, sv


def _sweep_wipe_masks(sweep: dict, round_: int):
    """The host masks of round ``round_`` from a lane's knob planes:
    ``(capture, amnesia, stale, epoch_jump)``."""
    fire = sweep["wipe_round"] == int(round_)
    if "snap_round" in sweep:
        stale = np.asarray(sweep["wipe_stale"], bool)
        return (sweep["snap_round"] == int(round_), fire & ~stale,
                fire & stale, int(sweep["epoch_jump"]))
    return None, fire, None, int(sweep["epoch_jump"])


def apply_node_faults(cfg, state, round_: int, sweep=None):
    """The node-fault prologue, at the start of a round in both step
    programs: capture stale-rejoin snapshots, then execute every wipe
    scheduled for round ``round_`` (the host's count of ``state.round``).
    Returns ``(state, wiped)``, ``wiped`` the (N,) bool device mask of
    the nodes restarted this round.

    Wipe semantics (the empty-SQLite restart): table planes and the
    bookkeeping row reset to their init values (or the snapshot's for
    stale entries; amnesia wins if both fire), the gossip ring drops,
    SWIM membership renews with a bumped incarnation, the HLC reboots
    from the wall clock plus the epoch jump, and the last-cleared stamp
    forgets. Not wiped: the global change log and its cleared stamps,
    link fault state.

    ``sweep``: a lane's host copy of its ``sweep_knobs`` leaf; where it
    holds wipe planes they replace the schedules.

    The snapshot and the restored planes are new tensors: the merge
    updates table planes in place, so neither may share storage with
    the table."""
    nf = cfg.node_faults
    n = cfg.num_nodes
    dev = state.hlc.device
    if sweep is not None and "wipe_round" not in sweep:
        sweep = None  # sweeping, but no lane arms the wipe planes
    if sweep is None and not (nf.wipe_enabled or nf.trace_vacuous):
        return state, torch.zeros((n,), dtype=torch.bool, device=dev)
    feats = dict(state.features)
    table, book = state.table, state.book
    if sweep is not None:
        cap, am, sv, epoch_jump = _sweep_wipe_masks(sweep, round_)
    else:
        cap, am, sv = _wipe_masks(nf, n, round_)
        epoch_jump = nf.epoch_jump
    if cap is not None and cap.any():
        c = upload(cap, str(dev))
        snap = feats["node_snapshot"]
        c3, c2 = c[:, None, None], c[:, None]
        feats["node_snapshot"] = {
            "cv": torch.where(c3, table.cv, snap["cv"]),
            "vr": torch.where(c3, table.vr, snap["vr"]),
            "site": torch.where(c3, table.site, snap["site"]),
            "cl": torch.where(c2, table.cl, snap["cl"]),
            "head": torch.where(c2, book.head, snap["head"]),
            "win": torch.where(c2, book.win, snap["win"]),
        }
    wiped_np = am | sv if sv is not None else am
    if not wiped_np.any():
        return (dataclasses.replace(state, features=feats),
                torch.zeros((n,), dtype=torch.bool, device=dev))

    wiped = upload(wiped_np, str(dev))
    amnesia = upload(am, str(dev)) if sv is not None else None
    snap = feats.get("node_snapshot")

    def pick(live, zero, field, expand):
        w = wiped.reshape((n,) + (1,) * expand)
        if amnesia is None:
            return torch.where(w, zero, live)
        a = amnesia.reshape((n,) + (1,) * expand)
        return torch.where(w, torch.where(a, zero, snap[field]), live)

    table = dataclasses.replace(
        table,
        cv=pick(table.cv, 0, "cv", 2),
        vr=pick(table.vr, NEG, "vr", 2),
        site=pick(table.site, -1, "site", 2),
        cl=pick(table.cl, 0, "cl", 1),
    )
    book = dataclasses.replace(
        book, head=pick(book.head, 0, "head", 1),
        win=pick(book.win, 0, "win", 1),
    )
    # the in-memory broadcast queue dies with the process
    gossip = dataclasses.replace(
        state.gossip,
        pend=torch.where(wiped[:, None, None], 0, state.gossip.pend),
        cursor=torch.where(wiped, 0, state.gossip.cursor),
    )
    swim = state.swim
    if cfg.swim_enabled:
        from corro_sim_torch.membership.swim import renew_membership

        swim = renew_membership(swim, wiped)
    # epoch-bumped HLC reboot: the clock restarts at the wall clock plus
    # the configured per-epoch jump; _hlc_tick's max keeps it monotone
    epoch = feats["node_epoch"] + wiped.to(torch.int32)
    feats["node_epoch"] = epoch
    hlc = torch.where(wiped, (round_ + epoch_jump * epoch).to(torch.int32),
                      state.hlc)
    last_cleared = torch.where(wiped, -1, state.last_cleared)
    return dataclasses.replace(
        state, table=table, book=book, gossip=gossip, swim=swim, hlc=hlc,
        last_cleared=last_cleared, features=feats,
    ), wiped
