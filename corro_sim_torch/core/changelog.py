"""The global change log: every actor's write history as dense tensors.

Port of ``corro_sim/core/changelog.py``. One packed ``(A, L, S, 5)`` int32
tensor holds ``[row, col, vr, cv, cl]`` per cell, indexed by (actor,
version % L, seq); ``L`` caps versions per actor (a ring) and ``S`` cells
per changeset.
"""

from __future__ import annotations

import dataclasses

import torch

from corro_sim_torch.utils.sort import scatter_add, scatter_set

# cells[..., k] layout of the packed cell tensor
CELL_ROW, CELL_COL, CELL_VR, CELL_CV, CELL_CL = range(5)


@dataclasses.dataclass
class ChangeLog:
    cells: torch.Tensor  # (A, L, S, 5) int32 — [row, col, vr, cv, cl]
    ncells: torch.Tensor  # (A, L) int32
    live: torch.Tensor  # (A, L) int32 — cells still globally winning
    cleared: torch.Tensor  # (A, L) bool — fully superseded
    head: torch.Tensor  # (A,) int32 — versions each actor has written

    @property
    def capacity(self) -> int:
        return self.cells.shape[1]

    @property
    def seqs(self) -> int:
        return self.cells.shape[2]


def make_changelog(num_actors: int, capacity: int, seqs: int,
                   device, rows: int | None = None) -> ChangeLog:
    """The empty log. ``rows``: make the per-version planes for that
    many actors only (one rank's actor shard); ``head`` stays whole."""
    a = num_actors if rows is None else rows
    i32 = dict(dtype=torch.int32, device=device)
    return ChangeLog(
        cells=torch.zeros((a, capacity, seqs, 5), **i32),
        ncells=torch.zeros((a, capacity), **i32),
        live=torch.zeros((a, capacity), **i32),
        cleared=torch.zeros((a, capacity), dtype=torch.bool, device=device),
        head=torch.zeros((num_actors,), **i32),
    )


def append_changesets(
    log: ChangeLog,
    actor: torch.Tensor,  # (n,) int32, distinct per lane
    row: torch.Tensor,  # (n, S) int32
    col: torch.Tensor,
    vr: torch.Tensor,
    cv: torch.Tensor,
    cl: torch.Tensor,
    ncells: torch.Tensor,  # (n,) int32
    valid: torch.Tensor,  # (n,) bool
    actor_lo: int | None = None,
):
    """Append one changeset per listed actor; returns ``(log, version)``
    per lane (1-based versions).

    ``actor_lo``: the log is one rank's actor shard (its per-version
    planes hold actors ``[actor_lo, actor_lo + A/D)``, its heads every
    actor): the heads and versions advance for every lane, the planes
    take the lanes of the shard's own actors."""
    ver = log.head[torch.where(valid, actor, 0).long()] + 1
    slot = (ver - 1) % log.capacity
    idx, mine = (actor, slot), valid
    if actor_lo is not None:
        local = actor - actor_lo
        mine = valid & (local >= 0) & (local < log.cells.shape[0])
        idx = (local, slot)
    packed = torch.stack([row, col, vr, cv, cl], dim=-1)  # (n, S, 5)
    return (
        ChangeLog(
            cells=scatter_set(log.cells, idx, packed, mine),
            ncells=scatter_set(log.ncells, idx, ncells, mine),
            live=scatter_set(log.live, idx, ncells, mine),
            cleared=scatter_set(log.cleared, idx, False, mine),
            head=scatter_add(log.head, (actor,), 1, valid),
        ),
        ver.to(torch.int32),
    )


def gather_changesets(log: ChangeLog, actor: torch.Tensor,
                      ver: torch.Tensor):
    """``(row, col, vr, cv, cl, ncells)`` of the (actor, version) lanes;
    the cell planes have shape ``lanes + (S,)``."""
    slot = ((ver - 1) % log.capacity).long()
    a = actor.long()
    g = log.cells[a, slot]
    return (
        g[..., CELL_ROW], g[..., CELL_COL], g[..., CELL_VR],
        g[..., CELL_CV], g[..., CELL_CL], log.ncells[a, slot],
    )


def fetch_changesets(log: ChangeLog, mesh, actor: torch.Tensor,
                     ver: torch.Tensor):
    """:func:`gather_changesets` plus the ``cleared`` flag of each
    ``(actor, version)`` lane from an actor-sharded log: this rank's
    ``log`` holds its actors' planes, and the lanes' rows come from their
    owners in one :meth:`~corro_sim_torch.engine.sharding.Mesh.fetch_rows`.
    Returns ``(row, col, vr, cv, cl, ncells, cleared)``."""
    al, cap = log.ncells.shape
    s = log.seqs
    plane = torch.cat([
        log.cells.reshape(al * cap, s * 5), log.ncells.reshape(-1, 1),
        log.cleared.to(torch.int32).reshape(-1, 1),
    ], dim=1)
    slot = ((ver - 1) % cap).long()
    got = mesh.fetch_rows(plane, actor.long() * cap + slot)
    g = got[..., :s * 5].reshape(tuple(actor.shape) + (s, 5))
    return (
        g[..., CELL_ROW], g[..., CELL_COL], g[..., CELL_VR],
        g[..., CELL_CV], g[..., CELL_CL], got[..., s * 5],
        got[..., s * 5 + 1] != 0,
    )
