"""Anti-entropy sync: vectorized ``compute_available_needs`` + budgeted
repair.

Port of ``corro_sim/sync/sync.py`` with its three request schedules:
the dense hot-actor schedule (``sync_hot_actors > 0`` and
``sync_deal_probes == 0``), and the legacy full-actor-axis schedule
(``sync_hot_actors == 0``) with its exact-argmax or deal-probe serving
assignment (``sync_deal_probes > 0``). With measured RTTs (``rtt=``),
closer peers win candidate ties and slow connections serve halved
per-actor caps.

Each sweep, every node picks up to ``resolved_sync_peers`` peers out of
``sync_candidates`` random members, ranked by sampled need
(``handlers.rs:1008-1042``); servers admit at most ``sync_server_cap``
requests (``agent.rs:132``); each needed actor is served by exactly one
granted peer, the one furthest ahead (the global range dedupe of
``api/peer.rs:1179-1372``); and the served versions are gathered from
the change log and merged.
"""

from __future__ import annotations

import torch

from corro_sim_torch import prng
from corro_sim_torch.core.bookkeeping import Bookkeeping, advance_heads
from corro_sim_torch.core.changelog import ChangeLog, gather_changesets
from corro_sim_torch.core.crdt import NEG, TableState, apply_cell_changes
from corro_sim_torch.core.merge_kernel import kernel_supported, merge_grouped
from corro_sim_torch.utils.bits import WINDOW_BITS
from corro_sim_torch.utils.slots import ranks_within_group
from corro_sim_torch.utils.sort import lexsort, scatter_max, top_k


def choose_sync_peers(cfg, book: Bookkeeping, key, alive, view_alive,
                      reachable, rtt=None):
    """Pick up to ``resolved_sync_peers`` peers per node and enforce the
    server-side semaphore across every request of the sweep. Candidates
    rank by sampled need, then, with ``rtt`` (the ``(N, N)`` observed
    edge delays), by lower delay (``handlers.rs:1018-1042``).

    Returns ``(peer, granted, requested)``, each ``(N, P)``."""
    n, a = book.head.shape
    dev = book.head.device
    p_cnt = cfg.resolved_sync_peers
    k_cand, k_samp, k_adm = prng.split(key, 3)
    c = cfg.sync_candidates

    cand = prng.randint(k_cand, (n, c), 0, n, dev)
    samp = prng.choice(
        k_samp, a, (min(cfg.sync_need_sample, a),), replace=False,
        device=dev,
    )
    cand_l = cand.long()
    head_s = book.head[:, samp.long()]  # (N, S)
    need = torch.clamp(
        head_s[cand_l] - head_s[:, None, :], min=0
    ).sum(dim=-1, dtype=torch.int32)  # (N, C)

    rows = torch.arange(n, dtype=torch.int32, device=dev)
    if callable(view_alive):
        # windowed SWIM: the per-pair membership test over K-entry views
        believed = view_alive(rows[:, None].expand(n, c), cand)
    elif view_alive.shape[0] == 1:
        believed = view_alive[0][cand_l]
    else:
        believed = view_alive[rows.long()[:, None], cand_l]
    # a candidate repeated in the sample is chosen at most once
    earlier = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)
    dup = (cand[:, :, None] == cand[:, None, :]) & earlier[None]
    ok = believed & (cand != rows[:, None]) & ~dup.any(dim=2)
    if rtt is not None:
        # need * 64 + (63 - rtt): need dominates, close peers win ties
        rtt_c = torch.clamp(rtt[rows.long()[:, None], cand_l].to(
            torch.int32), max=63)
        score = torch.clamp(need, max=1 << 24) * 64 + (63 - rtt_c)
    else:
        score = need
    score = torch.where(ok, score, -1)

    topv, topi = top_k(score, p_cnt)  # (N, P), lower index wins ties
    peer = torch.gather(cand, 1, topi)
    valid_slot = topv >= 0

    peer_l = peer.long()
    if reachable.shape[0] == 1:
        link = reachable[0][peer_l]
    else:
        link = reachable[rows.long()[:, None], peer_l]
    want = valid_slot & alive[:, None] & alive[peer_l] & link

    # server semaphore: random first-come-first-served admission
    m = n * p_cnt
    req = torch.where(want, peer, n + 1).reshape(-1)
    prio = prng.randint(k_adm, (m,), 0, 1 << 30, dev)
    order = lexsort((prio, req))
    rank = ranks_within_group(req[order])
    admitted = torch.empty(m, dtype=torch.bool, device=dev)
    admitted[order] = rank < cfg.sync_server_cap
    granted = want & admitted.reshape(n, p_cnt)
    return peer, granted, want


def choose_serving_slots(delta_p: torch.Tensor, topa: torch.Tensor, phase):
    """``(slot, best)`` — one serving peer slot per requested (node,
    actor) lane: the furthest-ahead granted peer, ties dealt round-robin
    by ``(actor + phase) mod eligible``. ``delta_p`` is ``(N, P, K')``."""
    n, p_cnt, kprime = delta_p.shape
    best = delta_p.max(dim=1).values
    elig = (delta_p == best[:, None, :]) & (best[:, None, :] > 0)
    elig_cnt = elig.sum(dim=1, dtype=torch.int32)
    k_tie = (topa + phase) % torch.clamp(elig_cnt, min=1)
    cum = torch.zeros((n, kprime), dtype=torch.int32, device=delta_p.device)
    slot = torch.zeros_like(cum)
    for p in range(p_cnt):
        slot = torch.where(elig[:, p] & (cum == k_tie), p, slot)
        cum = cum + elig[:, p].to(torch.int32)
    return slot, best


def deal_serving_slots(granted: torch.Tensor, phase, kprime: int):
    """``(slot, rank_in_slot)``: request lane k is dealt to the
    ``(k + phase) mod g``-th granted slot of its node (g = the node's
    granted count), the reference's round-robin request dealing
    (``api/peer.rs:1241-1372``); a node with nothing granted gets the
    sentinel ``P`` on every lane. ``rank_in_slot`` is the lane's position
    among its slot's lanes, ``k // g``."""
    n, p_cnt = granted.shape
    dev = granted.device
    g1 = torch.clamp(granted.sum(dim=1, dtype=torch.int32), min=1)[:, None]
    grank = torch.cumsum(granted.to(torch.int32), dim=1,
                         dtype=torch.int32) - 1  # (N, P)
    lanes = torch.arange(kprime, dtype=torch.int32, device=dev)[None, :]
    j = (lanes + phase) % g1  # (N, K')
    slot = torch.full((n, kprime), p_cnt, dtype=torch.int32, device=dev)
    for p in range(p_cnt):
        match = granted[:, p:p + 1] & (grank[:, p:p + 1] == j)
        slot = torch.where(match, p, slot)
    return slot, lanes // g1


def _kth_positive(csum: torch.Tensor, kprime: int,
                  roll_phase=None) -> torch.Tensor:
    """(N, K') column index of the k-th positive from per-row inclusive
    prefix counts: the first column whose count reaches k, a left binary
    search over each row.

    The search needs rows in scan order. The legacy schedule's counts are
    in rotated scan order (the scan starts at column ``roll_phase``), so
    their row is rolled first, by index arithmetic on the device scalar.
    The JAX package counts ``#{j : csum[j] < k}`` in one fused compare,
    which does not depend on the column order, but builds an (N, A, K')
    plane (ROADMAP.md queue 3)."""
    n, a = csum.shape
    if roll_phase is not None:
        cols = (torch.arange(a, device=csum.device) + roll_phase) % a
        csum = csum[:, cols]
    tk = torch.arange(1, kprime + 1, dtype=csum.dtype, device=csum.device)
    tk = tk[None, :].expand(n, kprime).contiguous()
    return torch.searchsorted(csum.contiguous(), tk, side="left").to(
        torch.int32)


def _rank_within_slot(slot: torch.Tensor) -> torch.Tensor:
    """Rank of each lane within its serving-slot group along each row
    (lanes in scan order; the per-connection budget keeps the first
    ``kp``)."""
    n, kprime = slot.shape
    order = torch.argsort(slot, dim=1, stable=True)
    s_sorted = torch.gather(slot, 1, order)
    idx2 = torch.arange(kprime, dtype=torch.int32, device=slot.device)
    idx2 = idx2[None, :].expand(n, kprime)
    newgrp = torch.cat([
        torch.ones((n, 1), dtype=torch.bool, device=slot.device),
        s_sorted[:, 1:] != s_sorted[:, :-1],
    ], dim=1)
    grp_start = torch.cummax(torch.where(newgrp, idx2, 0), dim=1).values
    out = torch.empty((n, kprime), dtype=torch.int32, device=slot.device)
    out.scatter_(1, order, idx2 - grp_start)
    return out


def _legacy_schedule(cfg, book, log, peer, granted, phase, round_idx, kp,
                     kprime):
    """The full-actor-axis request schedule (``sync_hot_actors == 0``).

    1. Each node selects up to K' actors it still needs (its bookkeeping
       against the written heads, the needs side of
       ``compute_available_needs``, ``sync.rs:127-249``) by scanning the
       actor axis from the sweep's random phase and keeping the first K'
       positives (the reference's shuffled request dealing,
       ``peer.rs:1241-1372``).
    2. One serving slot per lane: the deal-probe assignment
       (``cfg.sync_deal_probes``) or the exact argmax.

    Returns ``(topa, slot, topv, lane_ok, within_budget)``, each (N, K').
    (``round_idx`` is the dense schedule's; this one does not read it.)"""
    n, a = book.head.shape
    p_cnt = peer.shape[1]
    my_need = torch.clamp(log.head[None, :] - book.head, min=0)  # (N, A)
    pos = my_need > 0
    # the inclusive prefix counts in rotated scan order, built in original
    # column order: for column o the count is c[o] - c[phase - 1], plus
    # the row total where o < phase wraps to the tail
    c = torch.cumsum(pos.to(torch.int32), dim=1, dtype=torch.int32)
    total = c[:, -1:]
    cpm1 = torch.where(
        phase > 0,
        c.index_select(1, torch.clamp(phase - 1, min=0).reshape(1).long()),
        0,
    )
    wraps = torch.arange(a, dtype=torch.int32, device=c.device)[None] < phase
    csum = c - cpm1 + torch.where(wraps, total, 0)
    del c, pos, my_need
    idx = _kth_positive(csum, kprime, roll_phase=phase)
    del csum
    lane_ok = idx < a
    topa = (torch.where(lane_ok, idx, 0) + phase) % a  # (N, K') int32
    topa_l = topa.long()
    my_head = torch.gather(book.head, 1, topa_l)  # (N, K')
    if cfg.sync_deal_probes:
        # deal lanes round-robin over the granted slots, then probe up to
        # sync_deal_probes dealings per lane and serve from the furthest
        # ahead (strict > keeps the earlier dealing on a tie)
        slot, rank_in_slot = deal_serving_slots(granted, phase, kprime)
        topv = torch.zeros((n, kprime), dtype=torch.int32,
                           device=topa.device)
        for i in range(min(cfg.sync_deal_probes, p_cnt)):
            slot_i, _ = deal_serving_slots(granted, phase + i, kprime)
            peer_i = torch.gather(peer, 1, torch.clamp(
                slot_i, max=p_cnt - 1).long())
            tv_i = torch.where(
                slot_i < p_cnt,
                torch.clamp(book.head[peer_i.long(), topa_l] - my_head,
                            min=0),
                0,
            )
            slot = torch.where(tv_i > topv, slot_i, slot)
            topv = torch.maximum(tv_i, topv)
        slot = torch.where(lane_ok & (topv > 0), slot, p_cnt)
        within_budget = rank_in_slot < kp
    else:
        # exact argmax: what each granted peer can serve of each requested
        # actor, (N, P, K'), then the furthest-ahead assignment; dead
        # lanes get the sentinel slot P, their own budget group
        ph = book.head[peer.long()[:, :, None], topa_l[:, None, :]]
        delta_p = torch.clamp(ph - my_head[:, None, :], min=0)
        delta_p = torch.where(granted[:, :, None], delta_p, 0)
        slot, topv = choose_serving_slots(delta_p, topa, phase)
        slot = torch.where(lane_ok & (topv > 0), slot, p_cnt)
        within_budget = _rank_within_slot(slot) < kp
    return topa, slot, topv, lane_ok, within_budget


def _hot_schedule(cfg, book, log, peer, granted, phase, round_idx, kp,
                  kprime):
    """The dense hot-actor schedule: compact the actor axis to the actors
    anyone could need, then run needs, capability and the serving
    assignment as dense work over (N, P, A'). Returns ``(topa, slot,
    topv, lane_ok, within_budget)``, each (N, K')."""
    n, a = book.head.shape
    p_cnt = peer.shape[1]
    dev = book.head.device
    ahot = min(cfg.sync_hot_actors, a)
    min_head = book.head.min(dim=0).values
    hot_mask = log.head > min_head
    hot_cs = torch.cumsum(hot_mask.to(torch.int32), 0).to(torch.int32)
    total_hot = hot_cs[-1]
    total1 = torch.clamp(total_hot, min=1)
    # sequential window rotation over the hot set (sweep k serves hot
    # ranks [k*A', (k+1)*A') mod total)
    start = (torch.as_tensor(round_idx, dtype=torch.int32, device=dev)
             * ahot) % total1
    ranks = (start + torch.arange(ahot, dtype=torch.int32, device=dev)) \
        % total1 + 1
    hpos = torch.searchsorted(hot_cs, ranks.to(hot_cs.dtype), side="left")
    hot_ok = torch.arange(ahot, device=dev) < total_hot
    hot_idx = torch.where(hot_ok, hpos, 0).clamp(0, a - 1)  # (A',) int64

    head_hot = book.head[:, hot_idx]  # (N, A')
    ph_hot = head_hot[peer.long()]  # (N, P, A')
    delta_p = torch.clamp(ph_hot - head_hot[:, None, :], min=0)
    delta_p = torch.where(
        granted[:, :, None] & hot_ok[None, None, :], delta_p, 0
    )
    slot_d, best_d = choose_serving_slots(
        delta_p, hot_idx.to(torch.int32)[None, :].expand(n, ahot), phase
    )

    ch = torch.cumsum((best_d > 0).to(torch.int32), dim=1).to(torch.int32)
    idx = _kth_positive(ch, kprime)
    lane_ok = idx < ahot
    pos_sel = torch.where(lane_ok, idx, 0).long()
    topa = hot_idx[pos_sel].to(torch.int32)  # (N, K')
    slot = torch.gather(slot_d, 1, pos_sel)
    topv = torch.where(lane_ok, torch.gather(best_d, 1, pos_sel), 0)
    slot = torch.where(lane_ok & (topv > 0), slot, p_cnt)
    if kp >= kprime:
        within_budget = torch.ones((n, kprime), dtype=torch.bool,
                                   device=dev)
    else:
        within_budget = _rank_within_slot(slot) < kp
    return topa, slot, topv, lane_ok, within_budget


def sync_round(cfg, book: Bookkeeping, log: ChangeLog, table: TableState,
               hlc, last_cleared, cleared_hlc, key, alive, view_alive,
               reachable, rtt=None, round_idx=0, fault_key=None,
               fault_cfg=None):
    """One anti-entropy sweep (multi-peer).

    Returns ``(book, table, hlc, last_cleared, metrics)``. On the mailbox
    path (``kernel_supported``) ``table`` is merged in place and the
    returned table holds its storage.

    ``fault_key``: the round's sync-fault subkey
    (:func:`~corro_sim_torch.faults.inject.fault_keys`) when link faults
    are on: an admitted connection then drops with
    ``faults.resolved_sync_loss`` and across a blackholed edge, before
    the clock exchange (a dropped connection carries nothing), and the
    drops count in ``fault_sync_lost``, not in the rejections.

    ``rtt``: the ``(N, N)`` observed edge delays when ``rtt_rings`` is
    on; they rank sync candidates and size each connection's caps.

    ``fault_cfg``: a sweep lane's fault knobs
    (:class:`~corro_sim_torch.faults.inject.LaneFaultKnobs`) in place of
    ``cfg.faults``; None off the sweep."""
    n, a = book.head.shape
    dev = book.head.device
    k_peer, k_phase = prng.split(key)
    peer, granted, requested = choose_sync_peers(
        cfg, book, k_peer, alive, view_alive, reachable, rtt
    )
    p_cnt = peer.shape[1]
    rejected = requested & ~granted
    fault_metrics = {}
    if cfg.faults.enabled or fault_cfg is not None:
        from corro_sim_torch.faults.inject import (
            blackhole_tensor,
            sync_grant_keep,
        )

        keep = sync_grant_keep(
            fault_cfg if fault_cfg is not None else cfg.faults, fault_key, torch.arange(n, dtype=torch.int32,
                                                device=dev),
            peer, blackhole_tensor(cfg.faults, n, dev),
        )
        fault_metrics["fault_sync_lost"] = (granted & ~keep).sum(
            dtype=torch.int32)
        granted = granted & keep
    peer_l = peer.long()

    # clock exchange, both directions (api/peer.rs:1074-1126,1502-1521)
    client_merge = hlc
    for p in range(p_cnt):
        client_merge = torch.maximum(
            client_merge, torch.where(granted[:, p], hlc[peer_l[:, p]], -1)
        )
    hlc = scatter_max(
        client_merge, (peer.reshape(-1),),
        hlc[:, None].expand(peer.shape).reshape(-1), granted.reshape(-1),
    )

    kp = min(cfg.sync_actor_topk, a)
    req = cfg.sync_req_actors or 2 * kp
    kprime = min(req, kp * p_cnt, a)
    cap = cfg.sync_cap_per_actor
    bpv = cfg.chunks_per_version
    vwin = WINDOW_BITS // bpv
    group_mask = (1 << bpv) - 1
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    rows_l = rows.long()
    s = log.seqs
    offs = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)

    phase = prng.randint(k_phase, (), 0, a, dev)
    # the dense schedule is exact-argmax only: a deal-probe policy takes
    # the legacy schedule
    schedule = (_hot_schedule
                if cfg.sync_hot_actors > 0 and not cfg.sync_deal_probes
                else _legacy_schedule)
    topa, slot, topv, lane_ok, within_budget = schedule(
        cfg, book, log, peer, granted, phase, round_idx, kp, kprime)

    # adaptive chunk sizing (peer.rs:345-349): a slow connection serves
    # halved per-actor caps, floored at 1; an unobserved edge (255)
    # serves the full cap. Sentinel slots clamp to the last peer: their
    # topv is 0, so their take is 0 whatever the cap.
    if rtt is not None:
        raw = rtt[rows_l[:, None], peer_l].to(torch.int32)  # (N, P)
        delay = torch.where(raw == 255, 1, torch.clamp(raw, max=4))
        cap_slot = torch.clamp(torch.bitwise_right_shift(
            torch.full_like(delay, cap), torch.clamp(delay - 1, min=0)),
            min=1)
        cap_lane = torch.gather(cap_slot, 1,
                                torch.clamp(slot, max=p_cnt - 1).long())
    else:
        cap_lane = cap
    take = torch.where(
        lane_ok & within_budget, torch.clamp(topv, max=cap_lane), 0
    )

    # flat gather lanes: (N, K', cap) -> versions head+1 ... head+take
    topa_l = topa.long()
    base = book.head[rows_l[:, None], topa_l]  # (N, K')
    ver = base[:, :, None] + offs[None, None, :]
    lane_valid = offs[None, None, :] <= take[:, :, None]

    actor_l = topa[:, :, None].expand(ver.shape).reshape(-1)
    ver_l = ver.reshape(-1)
    valid_l = lane_valid.reshape(-1)
    dst_l = rows[:, None, None].expand(ver.shape).reshape(-1)

    g_actor_l = torch.where(valid_l, actor_l, 0)
    row, col, vr, cv, cl, ncells = gather_changesets(
        log, g_actor_l, torch.clamp(ver_l, min=1)
    )
    m = dst_l.shape[0]
    # cleared versions are served as empties (api/peer.rs:716-758)
    g_slot_l = (torch.clamp(ver_l, min=1) - 1) % log.capacity
    cleared_l = log.cleared[g_actor_l.long(), g_slot_l.long()]
    seq = torch.arange(s, dtype=torch.int32, device=dev)
    cell_live = (
        valid_l[:, None] & ~cleared_l[:, None] & (seq[None, :] < ncells[:, None])
    )
    site_l = torch.where(vr == NEG, NEG, actor_l[:, None].expand(m, s))

    # seq-granular partial serving (SyncNeedV1::Partial): cells whose
    # chunk the receiver already buffered via gossip do not ship, while
    # the merge applies the whole changeset. Served versions are base +
    # o, so the window offset of version o is o - 1.
    win_k = book.win[rows_l[:, None], topa_l]  # (N, K') int64
    chunk_of_seq = torch.arange(s, dtype=torch.int64, device=dev) * bpv // s
    voff_o = (offs - 1).clamp(0, vwin - 1).long()
    bit_off = voff_o[:, None] * bpv + chunk_of_seq[None, :]  # (cap, S)
    buffered = (
        ((win_k[:, :, None, None] >> bit_off[None, None]) & 1) != 0
    ) & ((offs - 1) < vwin)[None, None, :, None]  # (N, K', cap, S)
    shipped = cell_live & ~buffered.reshape(m, s)

    if kernel_supported(cfg, "sync", dev):
        # sync lanes are node-major by construction: the mailbox is a
        # reshape plus pad, no routing scatter
        lanes_per_node = kprime * cap * s
        pad = (-lanes_per_node) % 128

        def node_major(x):
            v = x.reshape(n, lanes_per_node).to(torch.int32)
            if pad:
                v = torch.nn.functional.pad(v, (0, pad))
            return v.reshape(-1)

        box = torch.stack([
            node_major(row * cfg.num_cols + col), node_major(cv),
            node_major(vr), node_major(site_l), node_major(cl),
            node_major(cell_live),
        ])
        table = merge_grouped(table, box, lanes_per_node + pad)
    else:
        table = apply_cell_changes(
            table, dst_l[:, None].expand(m, s).reshape(-1),
            row.reshape(-1), col.reshape(-1), cv.reshape(-1),
            vr.reshape(-1), site_l.reshape(-1), cl.reshape(-1),
            cell_live.reshape(-1),
        )

    floor = book.head.clone()
    floor_flat = floor.view(-1)
    floor_flat.scatter_reduce_(
        0, (rows_l[:, None] * a + topa_l).reshape(-1),
        (base + take).reshape(-1), "amax",
    )

    # versions already complete in the window came via gossip and were
    # counted then
    already = torch.zeros(take.shape, dtype=torch.int32, device=dev)
    for o in range(min(cap, vwin)):
        g = (win_k >> (o * bpv)) & group_mask
        already = already + ((g == group_mask) & (o < take)).to(torch.int32)
    new_versions = (take - already).sum(dtype=torch.int32)
    empties = (valid_l & cleared_l).sum(dtype=torch.int32)

    last_cleared = scatter_max(
        last_cleared, (dst_l,),
        cleared_hlc[g_actor_l.long(), g_slot_l.long()], valid_l & cleared_l,
    )

    book = advance_heads(book, floor, bpv)

    metrics = {
        "sync_pairs": granted.sum(dtype=torch.int32),
        "sync_requests": requested.sum(dtype=torch.int32),
        "sync_rejections": rejected.sum(dtype=torch.int32),
        "sync_versions": new_versions,
        "sync_empties": empties,
        "sync_cells": shipped.sum(dtype=torch.int32),
        **fault_metrics,
    }
    return book, table, hlc, last_cleared, metrics
