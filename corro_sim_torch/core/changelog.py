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
                   device) -> ChangeLog:
    i32 = dict(dtype=torch.int32, device=device)
    return ChangeLog(
        cells=torch.zeros((num_actors, capacity, seqs, 5), **i32),
        ncells=torch.zeros((num_actors, capacity), **i32),
        live=torch.zeros((num_actors, capacity), **i32),
        cleared=torch.zeros((num_actors, capacity), dtype=torch.bool,
                            device=device),
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
):
    """Append one changeset per listed actor; returns ``(log, version)``
    per lane (1-based versions)."""
    ver = log.head[torch.where(valid, actor, 0).long()] + 1
    slot = (ver - 1) % log.capacity
    idx = (actor, slot)
    packed = torch.stack([row, col, vr, cv, cl], dim=-1)  # (n, S, 5)
    return (
        ChangeLog(
            cells=scatter_set(log.cells, idx, packed, valid),
            ncells=scatter_set(log.ncells, idx, ncells, valid),
            live=scatter_set(log.live, idx, ncells, valid),
            cleared=scatter_set(log.cleared, idx, False, valid),
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
