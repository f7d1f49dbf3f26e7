"""Fused broadcast-delivery pass: one sorted lane stream, every consumer.

Port of ``corro_sim/core/delivery.py``. One lane sort feeds the HLC
scatter-max, the apply-queue rank, bookkeeping dedupe, the probe
tracer's delivery merge point, the changeset gathers and the CRDT
merge. The merge routes through the mailbox and
:func:`~corro_sim_torch.core.merge_kernel.grouped_merge` when
``kernel_supported(cfg, "delivery", device)`` says so, and through the
scatter merge :func:`~corro_sim_torch.core.crdt.apply_cell_changes`
otherwise. Single-chunk configs (``chunks_per_version == 1``) pack
``(dst, actor)`` into one sort key and carry a constant chunk plane;
multi-chunk configs sort on four keys and carry the permuted chunks.

Under a device mesh (``mesh=``) every rank holds the round's lanes
whole (they come from the gathered gossip ring) and its own shard of
the table and the bookkeeping. Each rank records the deliveries whose
destination it owns — the delivered lanes of one shard are one run of
the dst-sorted order — and the per-lane outcomes are summed across the
ranks (each lane has one owner). Each rank gathers the changesets of
its own slice of the sorted lanes from the log (fetched from the actor
shards under ``shard_log``) and the cell lanes go to their
destination's shard with one ``all_to_all_single``: through
:func:`~corro_sim_torch.core.merge_kernel.route_merge_sharded` on the
kernel arm, and through the same routing then
:func:`~corro_sim_torch.core.crdt.apply_cell_changes` on the local rows
on the scatter arm.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from corro_sim_torch.core.bookkeeping import deliver_versions
from corro_sim_torch.core.changelog import gather_changesets
from corro_sim_torch.core.crdt import NEG, apply_cell_changes
from corro_sim_torch.core.merge_kernel import (
    LANE_CELL,
    LANE_CL,
    LANE_CV,
    LANE_SITE,
    LANE_VALID,
    LANE_VR,
    kernel_supported,
    merge_grouped,
    route_lanes,
    route_merge_sharded,
    route_to_shards,
)
from corro_sim_torch.engine.probe import probe_delivery_update
from corro_sim_torch.utils.slots import ranks_within_group_masked
from corro_sim_torch.utils.sort import lexsort, scatter_max


class DeliveryResult(NamedTuple):
    """What the rest of the round consumes. Lane arrays are in SORTED
    order (delivered lanes grouped by dst)."""

    table: object
    book: object
    probe: object  # updated ProbeState (untouched when probes are off)
    hlc_recv: torch.Tensor  # (N,) max sender clock delivered this round
    dst: torch.Tensor
    src: torch.Tensor
    actor: torch.Tensor
    ver: torch.Tensor
    chunk: torch.Tensor
    delivered: torch.Tensor  # post-cap delivery mask
    delivered_precap: torch.Tensor  # pre-cap mask: every landed lane is
    # an RTT sample, capped or not (transport.rs:199-233)
    fresh_chunk: torch.Tensor
    complete: torch.Tensor
    dropped: torch.Tensor
    c_cleared: torch.Tensor
    g_actor: torch.Tensor
    g_slot: torch.Tensor
    cell_live: torch.Tensor  # (m, S) cells actually merged; under a
    # mesh ``c_cleared`` and ``cell_live`` cover this rank's share of the
    # sorted lanes only (:func:`lane_share`)


def _route_scatter(table, dst, cell, cv, vr, site, cl, valid, cols: int,
                   mesh):
    """The mesh's scatter arm: the cell lanes to their destination's
    shard (:func:`route_to_shards`, no mailbox cap), then the scatter
    merge on this rank's rows."""
    nl = table.cv.shape[0]
    zero = torch.zeros(dst.shape, dtype=torch.int32, device=dst.device)
    ex = route_to_shards(dst, zero, cell, cv, vr, site, cl, valid,
                         2 ** 31 - 1, nl, mesh)
    lo = mesh.index * nl
    cell_r = ex[:, LANE_CELL]
    return apply_cell_changes(
        table, ex[:, 6] - lo, torch.div(cell_r, cols, rounding_mode="floor"),
        cell_r % cols, ex[:, LANE_CV], ex[:, LANE_VR], ex[:, LANE_SITE],
        ex[:, LANE_CL], ex[:, LANE_VALID] != 0,
    )


def _pad_lanes(x: torch.Tensor, m_pad: int) -> torch.Tensor:
    if x.shape[0] == m_pad:
        return x
    pad = torch.zeros((m_pad - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def lane_share(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of a whole sorted lane array: the stream padded
    with zeros to a multiple of the rank count, then the rank's equal
    slice. Under a mesh the delivery pass gathers and merges these lanes
    (and ``c_cleared`` and ``cell_live`` cover them)."""
    ml = -(-x.shape[0] // mesh.nodes)
    a = mesh.index * ml
    return _pad_lanes(x, ml * mesh.nodes)[a:a + ml]


def delivery_pass(cfg, table, book, log, hlc, dst, src, actor, ver, chunk,
                  delivered, probe=None, round_=None,
                  mesh=None) -> DeliveryResult:
    """Sort once; deliver, account, trace and merge off that one order.
    On the mailbox path ``table`` is merged in place (consumed).
    ``probe``: the probe tracer's state, updated at round ``round_`` when
    ``cfg.probes`` (returned as given otherwise).

    ``mesh``: a :class:`~corro_sim_torch.engine.sharding.Mesh`; ``table``
    and ``book`` are this rank's shards, ``log`` its shard under
    ``shard_log`` (with the heads whole), the lanes whole (module
    docstring)."""
    n = cfg.num_nodes
    s = cfg.seqs_per_version
    cpv = cfg.chunks_per_version
    dev = dst.device

    sort_dst = torch.where(delivered, dst, n + 1)
    if cpv == 1 and (n + 2) * (n + 2) < 2 ** 31:
        # pack (dst, actor) into one key; chunk is identically 0
        order = lexsort((ver, sort_dst * (n + 2) + actor))
    else:
        order = lexsort((chunk, ver, actor, sort_dst))
    dst, src, actor, ver = dst[order], src[order], actor[order], ver[order]
    delivered = delivered[order]
    if cpv == 1:
        chunk = torch.zeros(dst.shape, dtype=torch.int32, device=dev)
    else:
        chunk = chunk[order]

    # HLC merge: every delivered message carries the sender's clock
    hlc_recv = scatter_max(
        torch.zeros((n,), dtype=torch.int32, device=dev),
        (dst,), hlc[src.long()], delivered,
    )

    use_kernel = kernel_supported(cfg, "delivery", dev)
    # bounded apply queue (config.rs:10-41): at most apply_queue_cap
    # deliveries per node per round, on both merge paths
    rankd = ranks_within_group_masked(dst, delivered)
    delivered_precap = delivered
    overcap = delivered & (rankd >= cfg.apply_queue_cap)
    delivered = delivered & ~overcap
    # this shard's deliveries (all of them off a mesh): one run of the
    # dst-sorted order
    lo, hi = (0, n) if mesh is None else mesh.bounds(n)
    mine = delivered if mesh is None else delivered & (dst >= lo) & (dst < hi)
    book, fresh_chunk, complete, dropped = deliver_versions(
        book, dst - lo, actor, ver, mine,
        chunk=None if cpv == 1 else chunk, bits_per_version=cpv,
    )
    if mesh is not None:
        # each lane has one owner, so the sum is the owner's outcome
        packed = mesh.reduce(
            fresh_chunk.to(torch.int32) | (complete.to(torch.int32) << 1)
            | (dropped.to(torch.int32) << 2))
        fresh_chunk = (packed & 1) != 0
        complete = (packed & 2) != 0
        dropped = (packed & 4) != 0
    dropped = dropped | overcap
    if cfg.probes:
        # the broadcast merge point rides the same sorted stream
        probe = probe_delivery_update(
            probe, round_, dst, src, actor, ver, delivered, complete)
    g_actor = torch.where(complete, actor, 0)
    g_slot = (torch.clamp(ver, min=1) - 1) % log.capacity
    if mesh is not None:
        # this rank's share of the sorted lanes, padded with lanes that
        # carry nothing so every rank holds as many
        def mine_of(x):
            return lane_share(x, mesh)
    else:
        def mine_of(x):
            return x
    s_actor, s_ver = mine_of(g_actor), mine_of(torch.clamp(ver, min=1))
    s_complete, s_dst = mine_of(complete), mine_of(dst)
    if mesh is not None and log.cells.shape[0] != log.head.shape[0]:
        # actor-sharded log: fetch the slice's changesets from the owners
        from corro_sim_torch.core.changelog import fetch_changesets

        (c_row, c_col, c_vr, c_cv, c_cl, c_n,
         c_cleared) = fetch_changesets(log, mesh, s_actor, s_ver)
    else:
        c_row, c_col, c_vr, c_cv, c_cl, c_n = gather_changesets(
            log, s_actor, s_ver)
        # cleared versions deliver no cells (handle_emptyset analog)
        c_cleared = log.cleared[s_actor.long(),
                                ((s_ver - 1) % log.capacity).long()]
    ms = s_dst.shape[0]
    seq = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    cell_live = (s_complete[:, None] & ~c_cleared[:, None]
                 & (seq < c_n[:, None]))
    # DELETE entries (vr == NEG) are cl-only: no site claim
    c_site = torch.where(c_vr == NEG, NEG,
                         mine_of(actor)[:, None].expand(ms, s))
    dst_cells = s_dst[:, None].expand(ms, s).reshape(-1)
    flat_cell = (c_row * cfg.num_cols + c_col).reshape(-1)
    if use_kernel:
        cap_lanes = cfg.apply_queue_cap * s
        rank_cell = mine_of(rankd)[:, None] * s + seq
        if mesh is None:
            box = route_lanes(
                dst_cells, rank_cell.reshape(-1), flat_cell,
                c_cv.reshape(-1), c_vr.reshape(-1), c_site.reshape(-1),
                c_cl.reshape(-1), cell_live.reshape(-1), n, cap_lanes,
            )
            table = merge_grouped(table, box, cap_lanes)
        else:
            table = route_merge_sharded(
                table, dst_cells, rank_cell.reshape(-1), flat_cell,
                c_cv.reshape(-1), c_vr.reshape(-1), c_site.reshape(-1),
                c_cl.reshape(-1), cell_live.reshape(-1), cap_lanes, mesh,
            )
    elif mesh is None:
        table = apply_cell_changes(
            table, dst_cells, c_row.reshape(-1), c_col.reshape(-1),
            c_cv.reshape(-1), c_vr.reshape(-1), c_site.reshape(-1),
            c_cl.reshape(-1), cell_live.reshape(-1),
        )
    else:
        table = _route_scatter(
            table, dst_cells, flat_cell, c_cv.reshape(-1), c_vr.reshape(-1),
            c_site.reshape(-1), c_cl.reshape(-1), cell_live.reshape(-1),
            cfg.num_cols, mesh,
        )

    return DeliveryResult(
        table=table, book=book, probe=probe, hlc_recv=hlc_recv,
        dst=dst, src=src, actor=actor, ver=ver, chunk=chunk,
        delivered=delivered, delivered_precap=delivered_precap,
        fresh_chunk=fresh_chunk, complete=complete,
        dropped=dropped, c_cleared=c_cleared, g_actor=g_actor,
        g_slot=g_slot, cell_live=cell_live,
    )
