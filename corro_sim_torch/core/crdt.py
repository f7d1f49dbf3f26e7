"""CR-SQLite's LWW cell merge as batched tensor ops.

Port of ``corro_sim/core/crdt.py``. For an existing (row, column) cell an
incoming change wins iff its ``(col_version, value, site)`` triple is
lexicographically larger than the stored one; the per-row causal length
``cl`` merges by max first, and a row whose ``cl`` grows changes
generation and loses its cells (``doc/crdts.md:13,15-17,237``).

The merge runs as four masked scatter-max passes over the cluster's
``(N, R, C)`` int32 planes. :func:`apply_cell_changes` is also the plain
version of the CUDA merge kernel (:mod:`corro_sim_torch.core.merge_kernel`).
"""

from __future__ import annotations

import dataclasses

import torch

from corro_sim_torch.utils.sort import scatter_max

NEG = -(2 ** 31)


@dataclasses.dataclass
class TableState:
    """Per-node CRDT cell state; every field ``(N, R, C)`` int32 except
    ``cl`` ``(N, R)``."""

    cv: torch.Tensor  # col_version, starts at 0 (= never written)
    vr: torch.Tensor  # value rank, NEG when never written
    site: torch.Tensor  # writer site ordinal, -1 when never written
    cl: torch.Tensor  # causal length per row, 0 = never existed


def make_table_state(num_nodes: int, num_rows: int, num_cols: int,
                     device) -> TableState:
    shape = (num_nodes, num_rows, num_cols)
    i32 = dict(dtype=torch.int32, device=device)
    return TableState(
        cv=torch.zeros(shape, **i32),
        vr=torch.full(shape, NEG, **i32),
        site=torch.full(shape, -1, **i32),
        cl=torch.zeros((num_nodes, num_rows), **i32),
    )


def apply_cell_changes(
    state: TableState,
    dst: torch.Tensor,
    row: torch.Tensor,
    col: torch.Tensor,
    ch_cv: torch.Tensor,
    ch_vr: torch.Tensor,
    ch_site: torch.Tensor,
    ch_cl: torch.Tensor,
    valid: torch.Tensor,
) -> TableState:
    """Merge a flat batch of ``(M,)`` cell-change lanes into the table.

    ``valid`` masks padding lanes. A value lane takes part only at its
    row's post-merge generation; the stored value competes in the value
    tie-break only if the stored col_version survived, and the stored
    site only if both survived."""
    n = state.cl.shape[0]
    dst = torch.where(valid, dst, -1)
    # invalid lanes gather a clamped node and are masked below
    g_dst = dst.clamp(0, n - 1).long()
    row_l, col_l = row.long(), col.long()

    # Pass 0: causal length — per-row max, then generation wipe.
    cl0 = state.cl
    cl1 = scatter_max(cl0, (dst, row), ch_cl, keep=valid)
    bumped = (cl1 > cl0)[:, :, None]
    cv0 = torch.where(bumped, 0, state.cv)
    vr0 = torch.where(bumped, NEG, state.vr)
    site0 = torch.where(bumped, -1, state.site)

    idx = (dst, row, col)
    val = valid & (ch_vr != NEG) & (ch_cl == cl1[g_dst, row_l])

    # Pass 1: col_version.
    cv1 = scatter_max(cv0, idx, ch_cv, keep=val)

    # Pass 2: value rank.
    vr_base = torch.where(cv1 > cv0, NEG, vr0)
    win1 = val & (ch_cv == cv1[g_dst, row_l, col_l])
    vr1 = scatter_max(vr_base, idx, ch_vr, keep=win1)

    # Pass 3: site.
    site_base = torch.where((cv1 != cv0) | (vr1 != vr0), NEG, site0)
    win2 = win1 & (ch_vr == vr1[g_dst, row_l, col_l])
    site1 = scatter_max(site_base, idx, ch_site, keep=win2)

    return TableState(cv=cv1, vr=vr1, site=site1, cl=cl1)


def local_write(
    state: TableState,
    writer: torch.Tensor,  # (n,) int32
    row: torch.Tensor,  # (n, S) int32
    col: torch.Tensor,  # (n, S) int32
    vr: torch.Tensor,  # (n, S) int32
    is_delete: torch.Tensor,  # (n,) bool
    ncells: torch.Tensor,  # (n,) int32
    valid: torch.Tensor,  # (n,) bool
    row_lo: int = 0,
):
    """Apply one multi-cell changeset per writer; return its change
    records ``(new_state, ch_cv, ch_cl, ch_vr)``, each ``(n, S)``.

    ``row_lo``: ``state`` holds the rows of nodes ``row_lo`` on (one
    rank's shard under a mesh); ``writer`` stays the global node id,
    which is also the changes' site.

    An UPDATE bumps each touched cell's col_version; a DELETE bumps the
    row's causal length to the next even number and an INSERT after a
    delete to the next odd one (causal-length CRDT)."""
    n, s = row.shape
    dev = row.device
    cell_live = valid[:, None] & (
        torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        < ncells[:, None]
    )
    widx = torch.where(valid, writer - row_lo, -1).long()[:, None]
    row_l, col_l = row.long(), col.long()
    cur_cv = state.cv[widx, row_l, col_l]
    cur_cl = state.cl[widx, row_l]

    alive = (cur_cl % 2) == 1
    del_b = is_delete[:, None]
    ch_cl = torch.where(
        del_b,
        torch.where(alive, cur_cl + 1, cur_cl),
        torch.where(alive, cur_cl, cur_cl + 1),
    ).to(torch.int32)
    ch_cv = torch.where(del_b, cur_cv, cur_cv + 1).to(torch.int32)
    ch_vr = torch.where(del_b, NEG, vr).to(torch.int32)
    writer_b = writer[:, None].expand(n, s)
    ch_site = torch.where(del_b, NEG, writer_b).to(torch.int32)

    new_state = apply_cell_changes(
        state,
        (writer_b - row_lo).reshape(-1),
        row.reshape(-1),
        col.reshape(-1),
        ch_cv.reshape(-1),
        ch_vr.reshape(-1),
        ch_site.reshape(-1),
        ch_cl.reshape(-1),
        cell_live.reshape(-1),
    )
    return new_state, ch_cv, ch_cl, ch_vr
