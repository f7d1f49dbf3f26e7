"""Overwritten-version clearing — the reference's changeset compaction.

Port of ``corro_sim/core/compaction.py``. ``CellOwnership`` tracks, per
table cell, the globally winning change and the (actor, version) that
produced it, plus per-row causal-length (tombstone) ownership. When a
round's writes steal a cell from its owner, or a generation change wipes
a row, the owner's ``live`` count in the change log drops; at zero the
version is cleared and is served as an empty changeset from then on
(``agent.rs:1662-1721``, ``change.rs:267-389``).
"""

from __future__ import annotations

import dataclasses

import torch

from corro_sim_torch.core.changelog import ChangeLog
from corro_sim_torch.core.crdt import NEG
from corro_sim_torch.utils.slots import dedupe_sorted_mask
from corro_sim_torch.utils.sort import scatter_add, scatter_max, scatter_set


@dataclasses.dataclass
class CellOwnership:
    # per-cell winning change (R, C)
    cv: torch.Tensor  # int32 col_version
    vr: torch.Tensor  # int32 value rank
    site: torch.Tensor  # int32 writer site
    actor: torch.Tensor  # int32 owning actor, -1 = none
    ver: torch.Tensor  # int32 owning version, 0 = none
    # per-row causal-length state (R,)
    rcl: torch.Tensor  # int32 causal length (global max)
    ractor: torch.Tensor  # int32 tombstone-owning DELETE actor, -1 = none
    rver: torch.Tensor  # int32 tombstone-owning DELETE version, 0 = none
    rsite: torch.Tensor  # int32 tombstone tie-break site


def make_ownership(num_rows: int, num_cols: int, device) -> CellOwnership:
    i32 = dict(dtype=torch.int32, device=device)
    shape = (num_rows, num_cols)
    return CellOwnership(
        cv=torch.zeros(shape, **i32),
        vr=torch.full(shape, NEG, **i32),
        site=torch.full(shape, -1, **i32),
        actor=torch.full(shape, -1, **i32),
        ver=torch.zeros(shape, **i32),
        rcl=torch.zeros((num_rows,), **i32),
        ractor=torch.full((num_rows,), -1, **i32),
        rver=torch.zeros((num_rows,), **i32),
        rsite=torch.full((num_rows,), -1, **i32),
    )


def _decrement_live(log: ChangeLog, actor, ver, valid) -> ChangeLog:
    """``live[actor, ver] -= 1`` where valid (and the version is still
    in the ring); versions at zero live cells become cleared."""
    a = torch.where(valid, actor, 0).long()
    in_ring = valid & (ver > log.head[a] - log.capacity)
    slot = (torch.clamp(ver, min=1) - 1) % log.capacity
    live = scatter_add(log.live, (actor, slot), -1, in_ring)
    cleared = log.cleared | ((live <= 0) & (log.ncells > 0))
    return dataclasses.replace(log, live=live, cleared=cleared)


def _first_per_key(key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mask of the first valid lane per key value (in caller order)."""
    k = torch.where(valid, key, 2 ** 30)
    order = torch.argsort(k, stable=True)
    first = torch.empty_like(valid)
    first[order] = dedupe_sorted_mask(k[order]) & valid[order]
    return first


def update_ownership(
    own: CellOwnership,
    log: ChangeLog,
    actor: torch.Tensor,  # (M,) int32 — writing actor per cell lane
    ver: torch.Tensor,  # (M,) int32 — version per cell lane
    row: torch.Tensor,
    col: torch.Tensor,
    cv: torch.Tensor,
    vr: torch.Tensor,  # NEG for cl-only DELETE lanes
    site: torch.Tensor,  # NEG for cl-only lanes
    cl: torch.Tensor,
    valid: torch.Tensor,  # live cell lanes
    is_delete: torch.Tensor,
):
    """Fold one round of freshly written cells into global ownership;
    returns ``(own, log)``. Every losing side of a contested cell — the
    previous owner, a same-round lane beaten at scatter time, and every
    value cell of a row that changed generation — loses one live cell.

    Lanes are unique per (row, col) among value lanes and per row among
    DELETE lanes (one changeset writes a cell at most once)."""
    num_rows, num_cols = own.cv.shape
    row_c = torch.where(valid, row, 0).long()

    # 1) row causal length: merge from every lane
    rcl0 = own.rcl
    rcl1 = scatter_max(rcl0, (row,), cl, valid)
    bumped = rcl1 > rcl0

    # 2) generation wipe: bumped rows lose cells + their owners
    wipe = bumped[:, None] & (own.actor >= 0)
    log = _decrement_live(
        log, own.actor.reshape(-1), own.ver.reshape(-1), wipe.reshape(-1)
    )
    bump2 = bumped[:, None]
    cv0 = torch.where(bump2, 0, own.cv)
    vr0 = torch.where(bump2, NEG, own.vr)
    site0 = torch.where(bump2, -1, own.site)
    oactor = torch.where(bump2, -1, own.actor)
    over = torch.where(bump2, 0, own.ver)

    # 3) tombstone ownership
    old_tomb_lost = bumped & (own.ractor >= 0)
    log = _decrement_live(log, own.ractor, own.rver, old_tomb_lost)
    ractor0 = torch.where(bumped, -1, own.ractor)
    rver0 = torch.where(bumped, 0, own.rver)
    rsite0 = torch.where(bumped, -1, own.rsite)

    del_lane = valid & is_delete & (cl == rcl1[row_c])
    drow_g = torch.where(del_lane, row, 0).long()
    rsite1 = scatter_max(rsite0, (row,), actor, del_lane)
    dwin = del_lane & (actor == rsite1[drow_g])
    tomb_changed = rsite1 != rsite0
    ractor1 = scatter_set(ractor0, (row,), actor, dwin)
    rver1 = scatter_set(rver0, (row,), ver, dwin)
    drow = torch.where(del_lane, row, num_rows)
    outbid = (
        _first_per_key(drow, del_lane)
        & ~bumped[drow_g]
        & (ractor0[drow_g] >= 0)
        & tomb_changed[drow_g]
    )
    log = _decrement_live(log, ractor0[drow_g], rver0[drow_g], outbid)
    dself_lost = valid & is_delete & ~dwin
    log = _decrement_live(log, actor, ver, dself_lost)

    # 4) value cells: contest at the current generation
    val = valid & (vr != NEG) & (cl == rcl1[row_c])
    idx = (row, col)
    # gathers at non-value lanes read a clamped cell and are masked
    g = (torch.where(val, row, 0).long(), col.long())
    cv1 = scatter_max(cv0, idx, cv, val)
    vr_base = torch.where(cv1 > cv0, NEG, vr0)
    w1 = val & (cv == cv1[g])
    vr1 = scatter_max(vr_base, idx, vr, w1)
    site_base = torch.where((cv1 != cv0) | (vr1 != vr0), NEG, site0)
    w2 = w1 & (vr == vr1[g])
    site1 = scatter_max(site_base, idx, site, w2)
    winner = w2 & (site == site1[g])

    changed = (cv1 != cv0) | (vr1 != vr0) | (site1 != site0)
    actor1 = scatter_set(oactor, idx, actor, winner)
    ver1 = scatter_set(over, idx, ver, winner)

    cell_key = torch.where(val, row * num_cols + col, 2 ** 30)
    first_cell = _first_per_key(cell_key, val)
    old_lost = first_cell & (oactor[g] >= 0) & changed[g]
    log = _decrement_live(log, oactor[g], over[g], old_lost)
    self_lost = valid & (vr != NEG) & ~winner
    log = _decrement_live(log, actor, ver, self_lost)

    own = CellOwnership(
        cv=cv1, vr=vr1, site=site1, actor=actor1, ver=ver1,
        rcl=rcl1, ractor=ractor1, rver=rver1, rsite=rsite1,
    )
    return own, log
