"""One simulation round: the whole cluster advances in one batched step.

Port of ``corro_sim/engine/step.py``. A version is one transaction's
changeset of up to ``seqs_per_version`` cells, gossiped as
``chunks_per_version`` chunks; a receiver buffers partial versions and
merges a version once every chunk arrived. Round structure:

  node-fault prologue (scheduled wipes, snapshot captures) -> local
  writes -> eager ring-0 broadcast -> gossip dissemination -> the
  in-flight latency ring -> link faults at delivery -> probe origins ->
  delivery + bookkeeping + probe tracer + CRDT merge -> RTT samples and
  ring-0 recomputation -> rebroadcast of fresh changes -> SWIM tick
  (every ``swim_interval`` rounds) -> (every ``sync_interval`` rounds, or
  on the adaptive floor cadence) anti-entropy sync -> probe sync marks ->
  HLC tick.

Gossip and sync consult the membership view of the state at the start
of the round (after the node-fault prologue); a SWIM tick's result shows
from the next round on.

Faults (``corro_sim_torch/faults/``): link faults draw from a lane
``fold_in``-derived from the round key, so every other subkey is the
same with faults on or off; node faults are static schedules over the
round and sweep counters, with no draw, so the repair step derives the
same fault timeline as the full step. With both off the step runs none
of their code.

Under a fleet sweep (``cfg.sweep``, ``corro_sim_torch/sweep/``) one lane
runs the step under the plan's union config and reads its own knobs
from the ``sweep_knobs`` leaf, as the JAX package's vmapped lane does:
link-fault thresholds (``faults/inject.py::LaneFaultKnobs``), node-fault
planes, the write source and, with ``sweep.sim_knobs``, the write and
delete rates and the sync and suspicion cadences. Where the step decides
on the host it decides from the lane's host copy of the leaf (the
``knobs`` argument), which holds the same values.

Every stage is a batched tensor op over all nodes. Whether the sync
sweep runs is decided on the host wherever host data fixes it: the
interval rounds, ``sync_adaptive`` off, a round off the floor cadence,
and a round in which writers are known to run. Elsewhere the adaptive
term (``behind_pre``, and under the random sampler whether anybody
wrote) is device data, and the sweep is a branch of data-dependent
size: the step copies that one bool to the host as soon as it is
computed, before the round's gossip and delivery are queued, and reads
it when the sweep is due, so the host rarely waits for it. The SWIM
cadence and its announce gate depend on the round number only, which
the caller passes on the host.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig
from corro_sim_torch.core.bookkeeping import partial_versions
from corro_sim_torch.core.changelog import append_changesets
from corro_sim_torch.core.compaction import update_ownership
from corro_sim_torch.core.crdt import NEG, local_write
from corro_sim_torch.core.delivery import delivery_pass
from corro_sim_torch.engine.probe import (
    probe_book_update,
    probe_metrics,
    probe_sync_mark,
    probe_write_update,
)
from corro_sim_torch.engine.state import SimState
from corro_sim_torch.faults.inject import (
    LaneFaultKnobs,
    blackhole_tensor,
    burst_update,
    fault_keys,
    link_fault_masks,
)
from corro_sim_torch.faults.nodes import (
    apply_node_faults,
    recovering_mask,
    skew_plane,
    straggler_active,
)
from corro_sim_torch.gossip.broadcast import (
    broadcast_step,
    enqueue_broadcasts,
    enqueue_own,
)
from corro_sim_torch.membership.rtt import (
    link_delay,
    observe_rtt,
    recompute_ring0,
)
from corro_sim_torch.membership.swim import (
    plane_metrics,
    swim_step,
    tick_round,
)
from corro_sim_torch.membership.swim_window import (
    membership_view,
    swim_window_step,
    window_metrics,
)
from corro_sim_torch.sync.sync import sync_round
from corro_sim_torch.utils.runtime import start_async_fetch
from corro_sim_torch.utils.sort import scatter_max

# The step's PRNG stream map: the round key splits once into these
# lanes, in this order (the JAX package's STEP_KEY_STREAMS). Reordering
# a lane re-keys every seeded simulation.
STEP_KEY_STREAMS = (
    "write",   # [0] workload write-commit coin
    "row",     # [1] write target row
    "col",     # [2] write target column
    "val",     # [3] written value
    "del",     # [4] delete coin
    "ncell",   # [5] cells-per-changeset draw (multi-cell configs only)
    "bcast",   # [6] gossip broadcast targets
    "swim",    # [7] SWIM probe, exchanges and announce
    "sync",    # [8] anti-entropy partner + payload
)

_SYNC_METRICS = ("sync_pairs", "sync_requests", "sync_rejections",
                 "sync_versions", "sync_empties", "sync_cells")

# how each round's sweep was decided: on or off by host data
# ("host_on", "host_off"), or by the device predicate read on the host
# ("read_on", "read_off"). run_sim reports the counts in
# RunResult.pipeline; a sweep that runs launches the merge kernel once
# where the kernel takes the sweep.
SWEEP_GATES = dict.fromkeys(
    ("host_on", "host_off", "read_on", "read_off"), 0)


def _reachable_fn(alive: torch.Tensor, part: torch.Tensor):
    """Ground-truth link predicate: both up and in the same partition."""

    def reach(src, dst):
        src, dst = src.long(), dst.long()
        return alive[src] & alive[dst] & (part[src] == part[dst])

    return reach


def _pairwise_mask(alive: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """(N, N) ground-truth reachability for sync peer choice."""
    return alive[:, None] & alive[None, :] & (part[:, None] == part[None, :])


def _i32(x: int, device) -> torch.Tensor:
    # a fill, not torch.tensor: a host value copied to the card waits
    # for the card to drain its queue
    return torch.full((), x, dtype=torch.int32, device=device)


def _tile_chunks(cpv: int, *arrays):
    """Repeat each lane ``cpv`` times, appending a chunk index array."""
    out = [a.repeat_interleave(cpv) for a in arrays]
    n = arrays[0].shape[0]
    chunk = torch.arange(cpv, dtype=torch.int32,
                         device=arrays[0].device).repeat(n)
    return (*out, chunk)


def _write_cells(cfg: SimConfig, k_col, k_ncell, n: int, dev):
    """``(w_col (n, S), w_ncells (n,))``: each writer's changeset touches
    1..min(S, num_cols) distinct columns of its row (a transaction
    writing several columns, one seq-numbered cell each); unused cell
    lanes are zero-padded and masked by ``w_ncells``."""
    s = cfg.seqs_per_version
    s_eff = min(s, cfg.num_cols)
    if s_eff > 1:
        w_ncells = prng.randint(k_ncell, (n,), 1, s_eff + 1, dev)
        w_col = torch.argsort(
            prng.uniform(k_col, (n, cfg.num_cols), dev), dim=1, stable=True,
        ).to(torch.int32)[:, :s_eff]
    else:
        w_ncells = torch.ones((n,), dtype=torch.int32, device=dev)
        w_col = prng.randint(k_col, (n, 1), 0, cfg.num_cols, dev)
    if w_col.shape[1] < s:
        w_col = torch.nn.functional.pad(w_col, (0, s - w_col.shape[1]))
    return w_col, w_ncells


def host_knobs(state: SimState) -> dict:
    """A sweep lane's ``sweep_knobs`` leaf as host numpy values (one copy
    of each; the step never changes the leaf)."""
    return {k: v.detach().cpu().numpy()
            for k, v in state.features["sweep_knobs"].items()}


@functools.lru_cache(maxsize=64)
def _sim_knob_config(cfg: SimConfig, write_rate: float, delete_rate: float,
                     sync_interval: int, suspect_rounds: int) -> SimConfig:
    return dataclasses.replace(
        cfg, write_rate=write_rate, delete_rate=delete_rate,
        sync_interval=sync_interval, swim_suspect_rounds=suspect_rounds)


def _lane_config(cfg: SimConfig, sw: dict) -> SimConfig:
    """The union config with a lane's SimConfig scalar knobs
    (``sweep.sim_knobs``): the float32 write and delete thresholds and
    the sync and suspicion cadences the step reads from ``cfg``."""
    if not cfg.sweep.sim_knobs:
        return cfg
    return _sim_knob_config(
        cfg, float(sw["write_rate"]), float(sw["delete_rate"]),
        int(sw["sync_interval"]), int(sw["swim_suspect_rounds"]))


def _sample_writes(cfg: SimConfig, state: SimState, write_keys, alive,
                   write_enable: bool):
    """The sampler's round of local writes, in the ``writes`` tuple's
    form: Bernoulli writers at ``write_rate``, Zipf rows from the
    state's row distribution, deletes at ``delete_rate``."""
    k_write, k_row, k_col, k_val, k_del, k_ncell = write_keys
    n, s = cfg.num_nodes, cfg.seqs_per_version
    dev = alive.device
    f32 = dict(dtype=torch.float32, device=dev)
    writers = (
        (prng.uniform(k_write, (n,), dev) < torch.full((), cfg.write_rate, **f32))
        & alive
        & bool(write_enable)
    )
    u = prng.uniform(k_row, (n,), dev)
    w_row = torch.searchsorted(state.row_cdf, u).to(torch.int32).clamp(
        0, cfg.num_rows - 1
    )
    w_del = (
        prng.uniform(k_del, (n,), dev) < torch.full((), cfg.delete_rate, **f32)
    ) & writers
    w_col, w_ncells = _write_cells(cfg, k_col, k_ncell, n, dev)
    # a DELETE is one cl-only change
    w_ncells = torch.where(w_del, 1, w_ncells)
    w_val = prng.randint(k_val, (n, s), 0, cfg.value_universe, dev)
    return writers, w_row[:, None].expand(n, s), w_col, w_val, w_del, w_ncells


def sim_step(
    cfg: SimConfig,
    state: SimState,
    key,
    alive: torch.Tensor,  # (N,) bool ground truth
    part: torch.Tensor,  # (N,) int32 partition id
    write_enable: bool,  # workload phase switch
    round_idx: int,  # ``state.round`` as the host counts it
    repair: bool = False,
    writes: tuple | None = None,
    quiesced: bool | None = None,
    knobs: dict | None = None,
):
    """Advance the cluster one round; returns ``(state, metrics)``.

    The step consumes ``state``: the mailbox merge updates table planes
    in place (on the repair step, ``state.table`` itself), so the caller
    must not read ``state`` afterwards; the returned state may share its
    tensors. The JAX package's ``run_sim(donate=True)`` is the precedent.

    ``writes``: when None, the sampler draws this round's local writes.
    Otherwise the round's changesets as tensors ``(writers (N,) bool,
    rows (N, S) int32, cols (N, S) int32, vals (N, S) int32, dels (N,)
    bool, ncells (N,) int32)`` — a compiled workload's round or a live
    agent's accepted transactions — replace the sampler: none of its
    draws run, the key split stays the same, and ``write_enable`` is
    ignored.

    ``quiesced``: with ``writes``, whether nobody writes this round, when
    the caller knows it on the host (the sampler's rounds answer it from
    ``write_enable``); None reads it from the device when it matters.

    ``repair``: the post-quiesce specialization (:func:`_repair_step`),
    bit-for-bit this step while no writes run and every gossip ring is
    drained; it takes no ``writes``.

    ``knobs``: under a sweep, the lane's host copy of its
    ``sweep_knobs`` leaf (:func:`host_knobs`; read here when None). With
    ``sweep.workload``, ``writes`` feeds the lane only where its
    ``use_workload`` knob says so; else the sampler does."""
    sw = None
    if cfg.sweep.enabled:
        sw = knobs if knobs is not None else host_knobs(state)
        cfg = _lane_config(cfg, sw)
    if repair:
        return _repair_step(cfg, state, key, alive, part, round_idx, sw)
    n = cfg.num_nodes
    s = cfg.seqs_per_version
    cpv = cfg.chunks_per_version
    dev = state.hlc.device
    rows_idx = torch.arange(n, dtype=torch.int32, device=dev)
    (k_write, k_row, k_col, k_val, k_del, k_ncell, k_bcast, k_swim,
     k_sync) = prng.split(key, len(STEP_KEY_STREAMS))
    reach = _reachable_fn(alive, part)
    state, nf = _node_fault_prologue(cfg, state, round_idx, sw)
    fl = _fault_lane(cfg, state, key, sw)
    view = membership_view(cfg, state.swim, n)

    # ---------------------------------------------------------- local writes
    if writes is not None and not (
            sw is not None and cfg.sweep.workload
            and not bool(sw["use_workload"])):
        writers, w_row_s, w_col, w_val, w_del, w_ncells = writes
        writers = writers & alive
        w_del = w_del & writers
    else:
        writers, w_row_s, w_col, w_val, w_del, w_ncells = _sample_writes(
            cfg, state, (k_write, k_row, k_col, k_val, k_del, k_ncell),
            alive, write_enable)
        # the sampler draws no writer outside the write phase
        quiesced = None if write_enable and cfg.write_rate > 0 else True
    if nf is not None:
        # post-wipe write gate (faults/nodes.py): a restarted node mints
        # no version until anti-entropy has served its own actor's
        # history back; identically all-pass absent wipes
        writers = writers & ~(recovering_mask(state.book, state.log) & alive)
        w_del = w_del & writers
        if nf["wipes"] and quiesced is False:
            # the gate may silence every scheduled writer, which only
            # the device sees
            quiesced = None

    table, ch_cv, ch_cl, ch_vr = local_write(
        state.table, rows_idx, w_row_s, w_col, w_val, w_del, w_ncells, writers
    )
    log, w_ver = append_changesets(
        state.log, rows_idx, w_row_s, w_col, ch_vr, ch_cv, ch_cl, w_ncells,
        writers,
    )
    # self-bookkeeping: a node's own writes are trivially in order
    head = state.book.head.clone()
    head.diagonal().add_(writers.to(torch.int32))
    book = dataclasses.replace(state.book, head=head)
    # ring-wrap tripwire and the pre-delivery repair signal, from the
    # post-write log heads against the pre-delivery bookkeeping
    lag_pre = log.head[None, :] - state.book.head
    log_wrapped = ((lag_pre > log.capacity) & alive[:, None]).sum(
        dtype=torch.int32)
    behind_pre = ((lag_pre > 0) & alive[:, None]).any()
    del lag_pre
    gate = _sync_gate(cfg, round_idx, quiesced, behind_pre, writers)

    # global ownership fold: which versions lost cells to this round
    w_cell_live = writers[:, None] & (
        torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        < w_ncells[:, None]
    )
    rows_s = rows_idx[:, None].expand(n, s)
    pre_cleared = log.cleared
    own, log = update_ownership(
        state.own, log,
        rows_s.reshape(-1),
        w_ver[:, None].expand(n, s).reshape(-1),
        w_row_s.reshape(-1),
        w_col.reshape(-1),
        ch_cv.reshape(-1),
        ch_vr.reshape(-1),
        torch.where(w_del[:, None], NEG, rows_s).reshape(-1),
        ch_cl.reshape(-1),
        w_cell_live.reshape(-1),
        w_del[:, None].expand(n, s).reshape(-1),
    )
    # each version cleared this round is stamped with the round's
    # write-phase clock (store_empty_changeset, change.rs:267-389)
    newly_cleared = log.cleared & ~pre_cleared
    writer_ts = torch.where(writers, state.hlc, -1).max()
    cleared_hlc = torch.where(
        newly_cleared, torch.maximum(state.cleared_hlc, writer_ts),
        state.cleared_hlc,
    )

    # ------------------------------------------------- eager ring-0 messages
    # every chunk of a fresh local changeset goes to every ring-0 peer
    r0 = state.ring0.shape[1]
    e_dst, e_src, e_ver, e_valid, e_chunk = _tile_chunks(
        cpv, state.ring0.reshape(-1), rows_idx.repeat_interleave(r0),
        w_ver.repeat_interleave(r0), writers.repeat_interleave(r0),
    )
    active = None if nf is None else nf["active"]
    if active is not None:
        # a parked straggler skips this round's eager sends; its write
        # sits in its own ring and goes out on its next active round
        e_valid = e_valid & active[e_src.long()]

    # ------------------------------------------------- gossip dissemination
    gossip, g_dst, g_src, g_actor, g_ver, g_chunk, g_valid = broadcast_step(
        state.gossip, k_bcast, alive if active is None else alive & active,
        view, cfg.fanout,
        emit_slots=cfg.emit_slots, round_idx=round_idx, need_chunk=cpv > 1,
    )
    dst = torch.cat([e_dst, g_dst])
    src = torch.cat([e_src, g_src])
    actor = torch.cat([e_src, g_actor])
    ver = torch.cat([e_ver, g_ver])
    chunk = torch.cat([e_chunk, g_chunk])
    valid = torch.cat([e_valid, g_valid])
    msgs_sent = valid.sum(dtype=torch.int32)  # emissions, pre-delay split

    # ------------------------------------------------ in-flight latency
    # a lane whose link delay d > 1 parks in a ring slot and re-enters
    # the delivery lanes d - 1 rounds later; it parks only if its link is
    # up at emission, and reachability is checked again at delivery.
    # Matured lanes merge the sender's current clock.
    inflight = state.inflight
    parked = None  # the conservation counters of the ring, faults on
    if cfg.inflight_slots:
        slot = round_idx % cfg.inflight_slots
        mat = inflight[slot].clone()  # (6, L) lanes maturing this round
        far = valid & (link_delay(cfg, src, dst) > 1)
        up = reach(src, dst)
        park_ok = far & up
        if fl is not None:
            parked = {
                "fault_parked": park_ok.sum(dtype=torch.int32),
                "fault_emit_lost": (far & ~up).sum(dtype=torch.int32),
                "fault_matured": mat[5].sum(dtype=torch.int32),
            }
        inflight[slot] = torch.stack([
            x.to(torch.int32) for x in (dst, src, actor, ver, chunk, park_ok)
        ])
        dst = torch.cat([dst, mat[0]])
        src = torch.cat([src, mat[1]])
        actor = torch.cat([actor, mat[2]])
        ver = torch.cat([ver, mat[3]])
        chunk = torch.cat([chunk, mat[4]])
        valid = torch.cat([valid & ~far, mat[5].bool()])
    delivered = valid & reach(src, dst)
    fault_metrics = {}
    if fl is not None:
        # the broadcast transport point: deliverable lanes die to the
        # blackhole mask or the loss draw, or arrive twice (accounted
        # only: every merge is idempotent per (dst, actor, ver, chunk))
        zero = _i32(0, dev)
        fault_metrics["fault_unreachable"] = (valid & ~delivered).sum(
            dtype=torch.int32)
        if fl["bh"] is not None:
            holed = delivered & fl["bh"][src.long(), dst.long()]
            delivered = delivered & ~holed
            fault_metrics["fault_blackholed"] = holed.sum(dtype=torch.int32)
        else:
            fault_metrics["fault_blackholed"] = zero
        keep, dup = link_fault_masks(fl["conf"], fl["k_link"], dst,
                                     fl["burst"])
        fault_metrics["fault_lost"] = (delivered & ~keep).sum(
            dtype=torch.int32)
        delivered = delivered & keep
        fault_metrics["fault_dup"] = (delivered & dup).sum(dtype=torch.int32)
        fault_metrics["fault_delivered"] = delivered.sum(dtype=torch.int32)
        # conservation accounting for the invariant checker: emissions
        # that parked or died at emission, and parked lanes maturing
        fault_metrics.update(parked or dict.fromkeys(
            ("fault_parked", "fault_emit_lost", "fault_matured"), zero))
        fault_metrics["fault_burst_nodes"] = _burst_nodes(fl)

    # ------------------------------------------------------- probe origins
    probe = state.probe
    if cfg.probes:
        probe = probe_write_update(probe, state.round, writers, w_ver)

    # --------------------------------------- fused delivery merge (1 pass)
    dv = delivery_pass(
        cfg, table, book, log, state.hlc, dst, src, actor, ver, chunk,
        delivered, probe=probe, round_=state.round,
    )
    table, book, probe = dv.table, dv.book, dv.probe

    # ------------------------------------------------- RTT samples + rings
    # every landed lane is an RTT sample, capped or not; the rings are
    # recomputed every ring_update_interval rounds, and the new ring-0
    # takes the next round's eager sends
    rtt, ring0 = state.rtt, state.ring0
    if cfg.rtt_rings:
        rtt = observe_rtt(cfg, rtt, dv.dst, dv.src, dv.delivered_precap)
        iv = cfg.ring_update_interval
        if round_idx % iv == iv - 1:
            ring0 = recompute_ring0(rtt, ring0)

    # ------------------------------------------------- rebroadcast + enqueue
    if cpv <= cfg.pend_slots:
        # own-write lanes are node-major with cpv lanes per node, so the
        # ring-slot rank is the lane index
        gossip = enqueue_own(
            gossip, rows_idx.repeat_interleave(cpv),
            w_ver.repeat_interleave(cpv),
            torch.arange(cpv, dtype=torch.int32, device=dev).repeat(n),
            writers, cfg.max_transmissions, cpv,
        )
    else:
        # degenerate ring (cpv > pend_slots): the grouped path's overflow
        # rotation picks which chunks survive
        wq_dst, wq_actor, wq_ver, wq_valid, wq_chunk = _tile_chunks(
            cpv, rows_idx, rows_idx, w_ver, writers
        )
        gossip = enqueue_broadcasts(
            gossip, wq_dst, wq_actor, wq_ver, wq_chunk, wq_valid,
            cfg.max_transmissions, grouped=True,
        )
    gossip = enqueue_broadcasts(
        gossip, dv.dst, dv.actor, dv.ver, dv.chunk, dv.fresh_chunk,
        cfg.rebroadcast_transmissions, grouped=True,
    )

    swim, swim_metrics = _swim_block(cfg, state.swim, k_swim, alive, reach,
                                     round_idx)

    # last_cleared_ts analog, HLC-gated (handlers.rs:524-719)
    last_cleared = scatter_max(
        state.last_cleared, (dv.dst,),
        cleared_hlc[dv.g_actor.long(), dv.g_slot.long()],
        dv.complete & dv.c_cleared,
    )

    # ----------------------------------------------------------------- sync
    is_sync = _sync_due(gate)
    book, table, hlc_s, last_cleared, sync_metrics = _sync_block(
        cfg, is_sync, book, log, table, state.hlc, last_cleared, cleared_hlc,
        k_sync, alive, view, part, round_idx=state.sync_rounds,
        fault=fl, client_ok=_sync_client_ok(cfg, nf, state),
        rtt=rtt if cfg.rtt_rings else None,
    )
    probe = _probe_after_sync(cfg, probe, book, is_sync, alive, state.round)

    # -------------------------------------------------------------- metrics
    gap = _gap(alive, log, book)
    hlc, skew = _hlc_tick(alive, hlc_s, dv.hlc_recv, state.round,
                          None if nf is None else nf["skew"])
    metrics = {
        "writes": writers.sum(dtype=torch.int32),
        "deletes": w_del.sum(dtype=torch.int32),
        "cells_written": torch.where(writers, w_ncells, 0).sum(
            dtype=torch.int32),
        "msgs_sent": msgs_sent,
        "delivered": dv.delivered.sum(dtype=torch.int32),
        "fresh": dv.complete.sum(dtype=torch.int32),
        "fresh_chunks": dv.fresh_chunk.sum(dtype=torch.int32),
        "gossip_cells": dv.cell_live.sum(dtype=torch.int32),
        "buffered_partials": partial_versions(
            book, cfg.chunks_per_version),
        "dropped_window": dv.dropped.sum(dtype=torch.int32),
        "queue_overflow": gossip.overflow,
        "pend_live": (gossip.pend_tx > 0).sum(dtype=torch.int32),
        "cleared_versions": log.cleared.sum(dtype=torch.int32),
        "gap": gap,
        "log_wrapped": log_wrapped,
        "clock_skew": skew,
        **swim_metrics,
        **sync_metrics,
        **(probe_metrics(probe) if cfg.probes else {}),
        **fault_metrics,
        **_node_fault_metrics(nf, alive, book, log),
    }
    new_state = dataclasses.replace(
        state,
        table=table,
        book=book,
        log=log,
        own=own,
        gossip=gossip,
        swim=swim,
        round=state.round + 1,
        sync_rounds=state.sync_rounds + int(is_sync),
        hlc=hlc,
        last_cleared=last_cleared,
        cleared_hlc=cleared_hlc,
        rtt=rtt,
        ring0=ring0,
        inflight=inflight,
        probe=probe,
        fault_burst=state.fault_burst if fl is None else fl["burst"],
    )
    return new_state, metrics


def _probe_after_sync(cfg, probe, book, is_sync: bool, alive, round_):
    """The anti-entropy merge point and the sweep stamp, both step
    programs' last probe updates of a round."""
    if not cfg.probes:
        return probe
    probe = probe_book_update(probe, book.head, round_)
    return probe_sync_mark(probe, is_sync, alive, round_)


def _node_fault_prologue(cfg, state, round_idx: int, sw=None):
    """The node-fault prologue both step programs run before anything
    reads the state: the round's scheduled wipes and snapshot captures,
    the straggler duty mask and the clock-skew plane. Returns ``(state,
    None)`` with node faults off, else ``(state, {"wiped", "active",
    "skew", "wipes", "leaf"})``: ``wipes`` whether any wipe is scheduled
    at all, ``leaf`` the sweep lane's knob leaf (None off the sweep)."""
    lane = sw is not None and cfg.sweep.node_faults
    if not (cfg.node_faults.enabled or lane):
        return state, None
    n = cfg.num_nodes
    dev = state.hlc.device
    leaf = state.features["sweep_knobs"] if lane else None
    state, wiped = apply_node_faults(cfg, state, round_idx,
                                     sweep=sw if lane else None)
    return state, {
        "wiped": wiped,
        "active": straggler_active(cfg.node_faults, n, round_idx, dev,
                                   sweep=leaf),
        "skew": skew_plane(cfg.node_faults, n, dev, sweep=leaf),
        "wipes": (bool((sw["wipe_round"] >= 0).any())
                  if lane and "wipe_round" in sw
                  else cfg.node_faults.wipe_enabled),
        "leaf": leaf,
    }


def _fault_lane(cfg, state, key, sw=None):
    """The round's link-fault lane, the same in both step programs: the
    fold_in-derived keys, the advanced burst state, the blackhole mask
    and the thresholds (``cfg.faults``, or a sweep lane's
    :class:`LaneFaultKnobs`); None with link faults off."""
    lane = sw is not None and cfg.sweep.link_faults
    if not (cfg.faults.enabled or lane):
        return None
    conf = LaneFaultKnobs(sw, cfg.sweep.burst) if lane else cfg.faults
    k_burst, k_link, k_sync = fault_keys(key)
    return {
        "k_link": k_link,
        "k_sync": k_sync,
        "burst": burst_update(conf, state.fault_burst, k_burst),
        "bh": blackhole_tensor(cfg.faults, cfg.num_nodes, state.hlc.device),
        "conf": conf,
    }


def _burst_nodes(fl) -> torch.Tensor:
    if fl["conf"].burst_on:
        return fl["burst"].sum(dtype=torch.int32)
    return _i32(0, fl["burst"].device)


def _sync_client_ok(cfg, nf, state):
    """The straggler duty mask on the sweep counter, for the pair rows
    of the sync sweep (made only when a sweep runs): a parked node
    initiates no sweep but still serves inbound ones. The cycle ticks on
    the sweep counter, not the round counter, so its phase cannot alias
    with ``sync_interval`` and starve a node's client side forever."""
    if nf is None or nf["active"] is None:
        return None
    return lambda: straggler_active(cfg.node_faults, cfg.num_nodes,
                                    state.sync_rounds, state.hlc.device,
                                    sweep=nf["leaf"])


def _node_fault_metrics(nf, alive, book, log) -> dict:
    """The node-fault metrics, shared by both step programs (additive
    node-rounds): wipes this round, straggler node-rounds parked, and
    live nodes still resyncing their own write cursor."""
    if nf is None:
        return {}
    zero = _i32(0, alive.device)
    return {
        "node_fault_wipes": nf["wiped"].sum(dtype=torch.int32),
        "node_fault_straggling": (
            (alive & ~nf["active"]).sum(dtype=torch.int32)
            if nf["active"] is not None else zero
        ),
        "node_fault_recovering": (recovering_mask(book, log) & alive).sum(
            dtype=torch.int32),
    }


def _swim_block(cfg, swim_state, k_swim, alive, reach, round_idx: int):
    """The SWIM cadence: a tick every ``swim_interval``-th round; on the
    rounds between, the metrics of the standing beliefs."""
    zero = _i32(0, alive.device)
    if not cfg.swim_enabled:
        return swim_state, dict.fromkeys(
            ("swim_suspects", "swim_down", "swim_probe_failures"), zero)
    windowed = cfg.swim_view_size > 0
    if tick_round(cfg, round_idx):
        step_fn = swim_window_step if windowed else swim_step
        return step_fn(cfg, swim_state, k_swim, alive, reach, round_idx)
    metrics_fn = window_metrics if windowed else plane_metrics
    return swim_state, metrics_fn(swim_state, alive, zero)


def _sync_gate(cfg, round_: int, quiesced: bool | None, behind_pre,
               writers):
    """Whether this round runs a sweep: every ``sync_interval``-th round,
    plus — under ``sync_adaptive`` — floor-cadence rounds in which
    nobody wrote but somebody is still behind.

    Returns a bool where host data fixes the answer. Else the answer is
    device data — ``behind_pre``, and whether anybody wrote where the
    caller does not know it (``quiesced`` None) — and this starts its
    copy to the host and returns it, for :func:`_sync_due`."""
    si = cfg.sync_interval
    if round_ % si == si - 1:
        SWEEP_GATES["host_on"] += 1
        return True
    if (not cfg.sync_adaptive or quiesced is False
            or round_ % cfg.sync_floor_rounds != cfg.sync_floor_rounds - 1):
        SWEEP_GATES["host_off"] += 1
        return False
    pred = behind_pre
    if quiesced is None:
        pred = (writers.sum(dtype=torch.int32) == 0) & behind_pre
    return start_async_fetch(pred)


def _sync_due(gate) -> bool:
    """The sweep gate's answer, reading the device predicate's copy
    where :func:`_sync_gate` started one."""
    if isinstance(gate, bool):
        return gate
    due = bool(gate.resolve()[0])
    SWEEP_GATES["read_on" if due else "read_off"] += 1
    return due


def _sync_block(cfg, is_sync: bool, book, log, table, hlc, last_cleared,
                cleared_hlc, k_sync, alive, view, part, round_idx,
                fault=None, client_ok=None, rtt=None):
    """One anti-entropy sweep when ``is_sync``; zero metrics otherwise.
    ``fault``: the round's link-fault lane (:func:`_fault_lane`) with
    link faults on.
    ``client_ok``: makes the straggler duty mask, which gates the pair
    rows (the client side) only. ``rtt``: the observed edge delays with
    RTT rings on."""
    if not is_sync:
        dev = hlc.device
        names = _SYNC_METRICS + (
            ("fault_sync_lost",) if fault is not None else ())
        return book, table, hlc, last_cleared, {
            k: _i32(0, dev) for k in names
        }
    pairs = _pairwise_mask(alive, part)
    if client_ok is not None:
        pairs = pairs & client_ok()[:, None]
    return sync_round(
        cfg, book, log, table, hlc, last_cleared, cleared_hlc, k_sync,
        alive, view, pairs, rtt=rtt, round_idx=round_idx,
        fault_key=None if fault is None else fault["k_sync"],
        fault_cfg=(None if fault is None or fault["conf"] is cfg.faults
                   else fault["conf"]),
    )


def _gap(alive, log, book) -> torch.Tensor:
    """() float32 cluster-wide count of written-but-unapplied versions at
    live nodes. Summed exactly in int64 and cast once: equal to the JAX
    package's float32 sum wherever that sum is exact (partial sums under
    2**24), and exact beyond."""
    lag = (log.head[None, :] - book.head).to(torch.int64)
    return (lag * alive[:, None]).sum().to(torch.float32)


def _hlc_tick(alive, hlc_s, hlc_recv, round_, skew=None):
    """uhlc max+tick: merged clocks from this round's deliveries and sync
    contacts, physical floor = the round counter, raised per node by the
    ``skew`` offset plane under clock skew; down nodes freeze. Returns
    ``(hlc, skew)``."""
    floor = round_ if skew is None else round_ + skew
    hlc = torch.where(
        alive,
        torch.maximum(torch.maximum(hlc_s, hlc_recv), floor) + 1,
        hlc_s,
    )
    int_min = -(2 ** 31) + 1
    int_max = 2 ** 31 - 1
    skew = torch.clamp(
        torch.where(alive, hlc, int_min).max()
        - torch.where(alive, hlc, int_max).min(),
        min=0,
    )
    return hlc, skew


def _repair_step(cfg, state: SimState, key, alive, part, round_idx: int,
                 sw=None):
    """The post-quiesce round: SWIM + sync + bookkeeping only.
    Preconditions (driver-checked): no writes this round, every gossip
    ring drained, no in-flight ring and no RTT rings; under those this is
    bit-for-bit :func:`sim_step`. Of the probe tracer only the sync merge
    point and the sweep stamp run: no writer and no lane make the
    origin and delivery updates no-ops there."""
    if cfg.inflight_slots or cfg.rtt_rings:
        raise ValueError("the repair step runs without the in-flight ring "
                         "and RTT rings")
    n = cfg.num_nodes
    dev = state.hlc.device
    keys = prng.split(key, len(STEP_KEY_STREAMS))
    k_swim, k_sync = keys[7], keys[8]
    # the full step's node-fault prologue and fault lane: a wipe in the
    # convergence tail executes here too, the burst state keeps evolving
    # and sync grants keep failing
    state, nf = _node_fault_prologue(cfg, state, round_idx, sw)
    fl = _fault_lane(cfg, state, key, sw)
    view = membership_view(cfg, state.swim, n)
    log, book = state.log, state.book
    lag_pre = log.head[None, :] - book.head
    log_wrapped = ((lag_pre > log.capacity) & alive[:, None]).sum(
        dtype=torch.int32)
    behind_pre = ((lag_pre > 0) & alive[:, None]).any()
    del lag_pre
    # quiesced is identically True here (no writers by precondition)
    gate = _sync_gate(cfg, round_idx, True, behind_pre, None)
    hlc_recv = torch.zeros((n,), dtype=torch.int32, device=dev)

    # SWIM keeps its tick cadence through the tail
    swim, swim_metrics = _swim_block(
        cfg, state.swim, k_swim, alive, _reachable_fn(alive, part), round_idx
    )

    is_sync = _sync_due(gate)
    book, table, hlc_s, last_cleared, sync_metrics = _sync_block(
        cfg, is_sync, book, log, state.table, state.hlc, state.last_cleared,
        state.cleared_hlc, k_sync, alive, view, part,
        round_idx=state.sync_rounds, fault=fl,
        client_ok=_sync_client_ok(cfg, nf, state),
    )
    probe = _probe_after_sync(cfg, state.probe, book, is_sync, alive,
                              state.round)
    gap = _gap(alive, log, book)
    hlc, skew = _hlc_tick(alive, hlc_s, hlc_recv, state.round,
                          None if nf is None else nf["skew"])
    zero = _i32(0, dev)
    fault_metrics = {}
    if fl is not None:
        # the zeros the full step computes on zero lanes, and the live
        # burst series
        fault_metrics = dict.fromkeys(
            ("fault_lost", "fault_dup", "fault_blackholed",
             "fault_unreachable", "fault_delivered", "fault_parked",
             "fault_emit_lost", "fault_matured"), zero)
        fault_metrics["fault_burst_nodes"] = _burst_nodes(fl)
    metrics = {
        "writes": zero,
        "deletes": zero,
        "cells_written": zero,
        "msgs_sent": zero,
        "delivered": zero,
        "fresh": zero,
        "fresh_chunks": zero,
        "gossip_cells": zero,
        "buffered_partials": partial_versions(
            book, cfg.chunks_per_version),
        "dropped_window": zero,
        "queue_overflow": state.gossip.overflow,
        "pend_live": (state.gossip.pend_tx > 0).sum(dtype=torch.int32),
        "cleared_versions": log.cleared.sum(dtype=torch.int32),
        "gap": gap,
        "log_wrapped": log_wrapped,
        "clock_skew": skew,
        **swim_metrics,
        **sync_metrics,
        **(probe_metrics(probe) if cfg.probes else {}),
        **fault_metrics,
        **_node_fault_metrics(nf, alive, book, log),
    }
    new_state = dataclasses.replace(
        state,
        table=table,
        book=book,
        swim=swim,
        round=state.round + 1,
        sync_rounds=state.sync_rounds + int(is_sync),
        hlc=hlc,
        last_cleared=last_cleared,
        probe=probe,
        fault_burst=state.fault_burst if fl is None else fl["burst"],
    )
    return new_state, metrics
