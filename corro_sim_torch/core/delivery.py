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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from corro_sim_torch.core.bookkeeping import deliver_versions
from corro_sim_torch.core.changelog import gather_changesets
from corro_sim_torch.core.crdt import NEG, apply_cell_changes
from corro_sim_torch.core.merge_kernel import (
    kernel_supported,
    merge_grouped,
    route_lanes,
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
    cell_live: torch.Tensor  # (m, S) cells actually merged


def delivery_pass(cfg, table, book, log, hlc, dst, src, actor, ver, chunk,
                  delivered, probe=None, round_=None) -> DeliveryResult:
    """Sort once; deliver, account, trace and merge off that one order.
    On the mailbox path ``table`` is merged in place (consumed).
    ``probe``: the probe tracer's state, updated at round ``round_`` when
    ``cfg.probes`` (returned as given otherwise)."""
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
    book, fresh_chunk, complete, dropped = deliver_versions(
        book, dst, actor, ver, delivered,
        chunk=None if cpv == 1 else chunk, bits_per_version=cpv,
    )
    dropped = dropped | overcap
    if cfg.probes:
        # the broadcast merge point rides the same sorted stream
        probe = probe_delivery_update(
            probe, round_, dst, src, actor, ver, delivered, complete)
    g_actor = torch.where(complete, actor, 0)
    g_slot = (torch.clamp(ver, min=1) - 1) % log.capacity
    c_row, c_col, c_vr, c_cv, c_cl, c_n = gather_changesets(
        log, g_actor, torch.clamp(ver, min=1)
    )
    m = dst.shape[0]
    # cleared versions deliver no cells (handle_emptyset analog)
    c_cleared = log.cleared[g_actor.long(), g_slot.long()]
    seq = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    cell_live = complete[:, None] & ~c_cleared[:, None] & (seq < c_n[:, None])
    # DELETE entries (vr == NEG) are cl-only: no site claim
    c_site = torch.where(c_vr == NEG, NEG, actor[:, None].expand(m, s))
    dst_cells = dst[:, None].expand(m, s).reshape(-1)
    if use_kernel:
        cap_lanes = cfg.apply_queue_cap * s
        rank_cell = rankd[:, None] * s + seq
        box = route_lanes(
            dst_cells, rank_cell.reshape(-1),
            (c_row * cfg.num_cols + c_col).reshape(-1),
            c_cv.reshape(-1), c_vr.reshape(-1), c_site.reshape(-1),
            c_cl.reshape(-1), cell_live.reshape(-1), n, cap_lanes,
        )
        table = merge_grouped(table, box, cap_lanes)
    else:
        table = apply_cell_changes(
            table, dst_cells, c_row.reshape(-1), c_col.reshape(-1),
            c_cv.reshape(-1), c_vr.reshape(-1), c_site.reshape(-1),
            c_cl.reshape(-1), cell_live.reshape(-1),
        )

    return DeliveryResult(
        table=table, book=book, probe=probe, hlc_recv=hlc_recv,
        dst=dst, src=src, actor=actor, ver=ver, chunk=chunk,
        delivered=delivered, delivered_precap=delivered_precap,
        fresh_chunk=fresh_chunk, complete=complete,
        dropped=dropped, c_cleared=c_cleared, g_actor=g_actor,
        g_slot=g_slot, cell_live=cell_live,
    )
