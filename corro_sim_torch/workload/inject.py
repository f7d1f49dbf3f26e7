"""Shared changeset injection: one code path for replay and synthetic load.

Port of ``corro_sim/workload/inject.py``. Two producers feed committed
changesets into the dissemination machinery from outside the step's own
write sampler:

- **trace replay** (:mod:`corro_sim_torch.engine.replay`) — real-cluster
  changesets carrying authoritative ``cv``/``cl``/``vr`` stamps, injected
  between rounds by :func:`inject_round`;
- **the synthetic workload engine** (:mod:`corro_sim_torch.workload`) —
  compiled write schedules threaded through ``sim_step``'s ``writes``
  port, where the step's own ``local_write`` derives the stamps from the
  writer's current causal state.

:func:`workload_as_injection` maps a first-write workload schedule into
the trace form, so "replay a synthesized workload" and "run the
workload through the step's writes port" are the same path (the parity
tests pin the final states equal); :func:`trace_workload` folds a live
feed's encoded chunks back into a workload tape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from corro_sim_torch.config import SimConfig
from corro_sim_torch.core.changelog import append_changesets
from corro_sim_torch.core.compaction import update_ownership
from corro_sim_torch.core.crdt import NEG, apply_cell_changes
from corro_sim_torch.engine.state import SimState
from corro_sim_torch.gossip.broadcast import enqueue_broadcasts
from corro_sim_torch.utils.sort import scatter_add, scatter_max, scatter_set

__all__ = [
    "inject_round",
    "pad_trace_cells",
    "trace_round_args",
    "trace_workload",
    "workload_as_injection",
]

_CELL_PLANES = ("row", "col", "vr", "cv", "cl")


def pad_trace_cells(block, seqs_per_version: int) -> dict:
    """Pad an encoded trace's cell planes (``row/col/vr/cv/cl``, shape
    ``(rounds, A, S)``) up to the config's seq capacity — extra lanes are
    dead, ``ncells`` masks them out everywhere."""
    pad = seqs_per_version - block.row.shape[2]
    if pad < 0:
        raise ValueError(
            f"trace changesets carry up to {block.row.shape[2]} cells; "
            f"cfg.seqs_per_version={seqs_per_version} is too small"
        )
    return {
        name: np.pad(getattr(block, name), ((0, 0), (0, 0), (0, pad)))
        for name in _CELL_PLANES
    }


def trace_round_args(block, cells: dict, r: int, device) -> tuple:
    """Round ``r``'s :func:`inject_round` argument tuple off an encoded
    trace and its :func:`pad_trace_cells` planes, on ``device``."""
    host = (block.valid[r], block.empty[r], block.ts[r], block.ncells[r],
            *(cells[name][r] for name in _CELL_PLANES))
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=device)
                 for x in host)


def inject_round(
    cfg: SimConfig,
    state: SimState,
    valid: torch.Tensor,  # (A,) bool
    empty: torch.Tensor,  # (A,) bool
    ts: torch.Tensor,  # (A,) int32 — EmptySet ts for cleared lanes (-1 none)
    ncells: torch.Tensor,  # (A,) int32
    row: torch.Tensor,  # (A, S) int32
    col: torch.Tensor,  # (A, S) int32
    vr: torch.Tensor,  # (A, S) int32
    cv: torch.Tensor,  # (A, S) int32
    cl: torch.Tensor,  # (A, S) int32
) -> SimState:
    """Commit one changeset round: local apply + log append + gossip enqueue.

    ``A`` (the trace's actor count) may be smaller than ``cfg.num_nodes``;
    actor ordinal == node ordinal (ActorId is the crsql site id,
    ``corro-types/src/actor.rs:26``), so only the first ``A`` nodes
    write. Delete lanes are identified per cell (``vr == NEG`` — cl-only
    changes), so one changeset may mix a row tombstone with value writes
    to other rows, as one reference transaction can.
    """
    from corro_sim_torch.engine.step import _tile_chunks

    a, s = row.shape
    dev = row.device
    actor = torch.arange(a, dtype=torch.int32, device=dev)
    actor_s = actor[:, None].expand(a, s)
    has_cells = valid & ~empty
    cell_live = has_cells[:, None] & (
        torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        < ncells[:, None]
    )
    site = torch.where(vr == NEG, NEG, actor_s)

    # Local apply on the writer's own table (the trace carries
    # authoritative cv/cl — no recomputation, unlike local_write).
    table = apply_cell_changes(
        state.table, actor_s.reshape(-1), row.reshape(-1), col.reshape(-1),
        cv.reshape(-1), vr.reshape(-1), site.reshape(-1), cl.reshape(-1),
        cell_live.reshape(-1),
    )
    log, ver = append_changesets(
        state.log, actor, row, col, vr, cv, cl,
        torch.where(empty, 0, ncells), valid,
    )
    # Cleared versions occupy their slot but deliver nothing; each keeps
    # the ts its EmptySet carried (message-granular, handlers.rs:524-719).
    # The other lanes index one past the last actor, which the scatters
    # drop, as the JAX package's mode="drop" does.
    aidx = torch.where(valid & empty, actor, log.head.shape[0])
    slot = (ver - 1) % log.capacity
    log = dataclasses.replace(
        log, cleared=scatter_set(log.cleared, (aidx, slot), True))
    cleared_hlc = scatter_max(state.cleared_hlc, (aidx, slot), ts)

    book = dataclasses.replace(
        state.book,
        head=scatter_add(state.book.head, (actor, actor),
                         valid.to(torch.int32)),
    )
    own, log = update_ownership(
        state.own, log,
        actor_s.reshape(-1),
        ver[:, None].expand(a, s).reshape(-1),
        row.reshape(-1),
        col.reshape(-1),
        cv.reshape(-1),
        vr.reshape(-1),
        site.reshape(-1),
        cl.reshape(-1),
        cell_live.reshape(-1),
        (vr == NEG).reshape(-1),  # per-lane tombstone marker
    )
    # Enqueue every chunk of the fresh version into the writer's own ring.
    q_dst, q_src, q_ver, q_valid, q_chunk = _tile_chunks(
        cfg.chunks_per_version, actor, actor, ver, valid
    )
    gossip = enqueue_broadcasts(
        state.gossip, q_dst, q_src, q_ver, q_chunk, q_valid,
        cfg.max_transmissions,
    )
    return dataclasses.replace(
        state, table=table, book=book, log=log, own=own, gossip=gossip,
        cleared_hlc=cleared_hlc,
    )


def trace_workload(chunks, cfg: SimConfig):
    """The inverse of :func:`workload_as_injection`: fold a live feed's
    encoded chunks (:class:`~corro_sim_torch.io.traces.StreamChunk`)
    back into a :class:`~corro_sim_torch.workload.generators.Workload`
    tape — the
    coupled-load half of the twin's cadence re-fork loop: the trailing
    window the shadow just absorbed replays INTO every forecast lane, so
    recovery is graded under the live traffic, not against a quiet
    cluster.

    The workload write port is narrower than a raw changeset, so the
    fold is lossy at the edges — each loss is dropped and COUNTED (the
    ``trace_window`` event carries the tallies), never silently kept
    wrong:

    - EmptySets and pure-DELETE changesets carry causal history the
      port cannot stamp; the changeset is dropped (``dropped_sets``).
    - a changeset spans several rows but the port writes one row per
      changeset; cells off the first row are dropped
      (``dropped_cells``), as are tombstone lanes (``vr == NEG``) mixed
      into a value changeset.

    Returns ``None`` when the window folds to zero writes (nothing to
    couple — the caller forecasts uncoupled rather than replaying an
    empty tape).
    """
    from corro_sim_torch.workload.generators import Workload

    n = cfg.num_nodes
    rows_out: list = []  # per round: (writers, rows, cells[a] lists)
    dropped_sets = dropped_cells = 0
    for ch in chunks:
        a_n = ch.valid.shape[1]
        for r in range(ch.rounds):
            writers = np.zeros((n,), bool)
            rrow = np.zeros((n,), np.int32)
            cells: dict = {}
            for a in range(a_n):
                if not ch.valid[r, a] or ch.empty[r, a]:
                    dropped_sets += int(bool(ch.valid[r, a]))
                    continue
                nc = int(ch.ncells[r, a])
                keep = [
                    (int(ch.col[r, a, c]), int(ch.vr[r, a, c]))
                    for c in range(nc)
                    if ch.vr[r, a, c] != NEG
                    and ch.row[r, a, c] == ch.row[r, a, 0]
                ]
                dropped_cells += nc - len(keep)
                if not keep:
                    dropped_sets += 1
                    continue
                writers[a] = True
                rrow[a] = int(ch.row[r, a, 0])
                cells[a] = keep
            if writers.any():
                rows_out.append((writers, rrow, cells))
    if not rows_out:
        return None
    rounds = len(rows_out)
    s = max(
        max(len(c) for _, _, cells in rows_out for c in cells.values()),
        1,
    )
    writers = np.zeros((rounds, n), bool)
    rows = np.zeros((rounds, n), np.int32)
    cols = np.zeros((rounds, n, s), np.int32)
    vals = np.zeros((rounds, n, s), np.int32)
    ncells = np.zeros((rounds, n), np.int32)
    for r, (w, rrow, cells) in enumerate(rows_out):
        writers[r] = w
        rows[r] = rrow
        for a, keep in cells.items():
            ncells[r, a] = len(keep)
            for c, (col, vr) in enumerate(keep):
                cols[r, a, c] = col
                vals[r, a, c] = vr
    return Workload(
        name="trace_window",
        params={"rounds": rounds, "writes": int(writers.sum())},
        rounds=rounds, n=n, writers=writers, rows=rows, cols=cols,
        vals=vals, dels=np.zeros((rounds, n), bool), ncells=ncells,
        events=[(0, "trace_window", {
            "dropped_sets": dropped_sets,
            "dropped_cells": dropped_cells,
        })],
    )


def workload_as_injection(workload, cfg: SimConfig):
    """Map a first-write workload schedule into :func:`inject_round`'s
    trace form — per round: (valid, empty, ts, ncells, row, col, vr, cv,
    cl) numpy arrays.

    Valid only for schedules where every ``(node, row, col)`` cell is
    written at most once and no changeset is a DELETE: the authoritative
    stamps are then statically known (first write ⇒ ``cv = 1``,
    ``cl = 1``, ``vr =`` the written value), exactly what ``local_write``
    derives in the step's writes port.
    """
    if (workload.writers & workload.dels).any():
        raise ValueError(
            "workload_as_injection: DELETE changesets need causal history "
            "the trace form cannot stamp statically"
        )
    seen: set = set()
    for r in range(workload.rounds):
        for i in np.nonzero(workload.writers[r])[0]:
            nc = int(workload.ncells[r, i])
            for c in range(nc):
                key = (int(i), int(workload.rows[r, i]),
                       int(workload.cols[r, i, c]))
                if key in seen:
                    raise ValueError(
                        "workload_as_injection requires first-write-only "
                        f"schedules; cell {key} written twice"
                    )
                seen.add(key)
    n, s = workload.n, max(workload.cells_width, 1)
    out = []
    for r in range(workload.rounds):
        rows = np.broadcast_to(
            workload.rows[r][:, None], (n, s)
        ).astype(np.int32)
        out.append((
            workload.writers[r].copy(),
            np.zeros((n,), bool),  # no EmptySets in a synthetic schedule
            np.full((n,), -1, np.int32),
            workload.ncells[r].astype(np.int32),
            np.ascontiguousarray(rows),
            workload.cols[r].astype(np.int32),
            workload.vals[r].astype(np.int32),
            np.ones((n, s), np.int32),  # first write: col_version 1
            np.ones((n, s), np.int32),  # live row: causal length 1
        ))
    return out
