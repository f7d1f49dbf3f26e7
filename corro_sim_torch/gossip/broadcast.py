"""Gossip broadcast dissemination over sampled targets.

Port of ``corro_sim/gossip/broadcast.py``. Each node owns a ring of
pending broadcasts ``(N, P, 4)`` int32 — ``[actor, ver, chunk, tx]`` per
slot. One round, every live serviced slot (all of them, or an
``emit_slots`` window) goes to ``fanout`` random members the sender
believes are up and spends one transmission
(``broadcast/mod.rs:532-597``); receivers re-enqueue fresh changes
(``handlers.rs:950-960``); a full ring overwrites and counts overflow
(``handlers.rs:866-884``).
"""

from __future__ import annotations

import dataclasses

import torch

from corro_sim_torch import prng
from corro_sim_torch.utils.slots import (
    group_counts,
    ranks_within_group,
    ranks_within_group_masked,
)
from corro_sim_torch.utils.sort import scatter_set

PEND_ACTOR, PEND_VER, PEND_CHUNK, PEND_TX = range(4)

# fold_in tag deriving the per-round broadcast-target key from the
# step's broadcast stream (the JAX package's BROADCAST_TARGET_KEY_TAG)
BROADCAST_TARGET_KEY_TAG = 7


@dataclasses.dataclass
class GossipState:
    pend: torch.Tensor  # (N, P, 4) int32 — [actor, ver, chunk, tx]
    cursor: torch.Tensor  # (N,) int32 ring-buffer write cursor
    overflow: torch.Tensor  # () int32 — live slots overwritten

    @property
    def pend_tx(self) -> torch.Tensor:
        return self.pend[..., PEND_TX]


def make_gossip_state(num_nodes: int, pend_slots: int, device) -> GossipState:
    i32 = dict(dtype=torch.int32, device=device)
    return GossipState(
        pend=torch.zeros((num_nodes, pend_slots, 4), **i32),
        cursor=torch.zeros((num_nodes,), **i32),
        overflow=torch.zeros((), **i32),
    )


def enqueue_broadcasts(
    gossip: GossipState,
    dst: torch.Tensor,
    actor: torch.Tensor,
    ver: torch.Tensor,
    chunk: torch.Tensor,
    valid: torch.Tensor,
    transmissions: int,
    grouped: bool = False,
) -> GossipState:
    """Append ``(actor, ver, chunk)`` to each dst's pending ring.

    ``grouped=True``: the valid lanes' dst values are already
    nondecreasing, so ranks come from a sort-free cumsum/cummax pass, and
    an overfull dst keeps a window rotated by a per-dst phase so overflow
    drops are unbiased across actors. Lanes past the ring capacity drop
    and count as overflow."""
    n, p, _ = gossip.pend.shape
    big = n + 1
    if grouped:
        s_dst = torch.where(valid, dst, big)
        s_actor, s_ver, s_chunk, s_valid = actor, ver, chunk, valid
        rank = ranks_within_group_masked(dst, valid)
        counts_all = group_counts(torch.where(valid, dst, big), n)
        d0 = torch.where(valid, dst, 0).long()
        cnt = counts_all[d0]
        cnt1 = torch.clamp(cnt, min=1)
        phase = (gossip.cursor[d0] * 0x9E37) % cnt1
        rank = torch.where(cnt > p, (rank + phase) % cnt1, rank)
        counts = torch.clamp(counts_all, max=p)
    else:
        key = torch.where(valid, dst, big)
        order = torch.argsort(key, stable=True)
        s_dst = key[order]
        s_actor, s_ver, s_chunk, s_valid = (
            actor[order], ver[order], chunk[order], valid[order]
        )
        rank = ranks_within_group(s_dst)
    over_capacity = s_valid & (rank >= p)
    s_valid = s_valid & (rank < p)
    d0 = torch.where(s_valid, s_dst, 0).long()
    slot = (gossip.cursor[d0] + rank) % p
    # the JAX package gathers its out-of-range drop row clamped to the
    # last node; the read is masked by s_valid either way
    d_clamp = torch.where(s_valid, s_dst, n - 1).long()
    clobbered = (
        (gossip.pend[d_clamp, slot.long(), PEND_TX] > 0) & s_valid
    ) | over_capacity
    if not grouped:
        counts = group_counts(torch.where(s_valid, s_dst, big), n)
    packed = torch.stack([
        s_actor, s_ver, s_chunk,
        torch.where(s_valid, transmissions, 0).to(torch.int32),
    ], dim=-1)
    return GossipState(
        pend=scatter_set(gossip.pend, (s_dst, slot), packed, s_valid),
        cursor=((gossip.cursor + counts) % p).to(torch.int32),
        overflow=gossip.overflow + clobbered.sum(dtype=torch.int32),
    )


def enqueue_own(
    gossip: GossipState,
    actor: torch.Tensor,  # (N * per_node,) node-major lanes
    ver: torch.Tensor,
    chunk: torch.Tensor,
    valid_node: torch.Tensor,  # (N,) bool
    transmissions: int,
    per_node: int,
) -> GossipState:
    """Sort-free enqueue of each node's own fresh chunks: node ``i`` owns
    lanes ``[i*per_node, (i+1)*per_node)``, so the lane index within the
    node is the ring-slot rank."""
    n, p, _ = gossip.pend.shape
    dev = actor.device
    rank = torch.arange(per_node, dtype=torch.int32, device=dev).repeat(n)
    dst = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(
        per_node)
    valid = valid_node.repeat_interleave(per_node)
    over_capacity = valid & (rank >= p)
    valid = valid & (rank < p)
    slot = (gossip.cursor.repeat_interleave(per_node) + rank) % p
    d_clamp = torch.where(valid, dst, n - 1).long()
    clobbered = (
        (gossip.pend[d_clamp, slot.long(), PEND_TX] > 0) & valid
    ) | over_capacity
    packed = torch.stack([
        actor, ver, chunk,
        torch.where(valid, transmissions, 0).to(torch.int32),
    ], dim=-1)
    counts = torch.where(valid_node, min(per_node, p), 0).to(torch.int32)
    return GossipState(
        pend=scatter_set(gossip.pend, (dst, slot), packed, valid),
        cursor=((gossip.cursor + counts) % p).to(torch.int32),
        overflow=gossip.overflow + clobbered.sum(dtype=torch.int32),
    )


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range, as int32 arithmetic
    wraps (two's complement)."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def serviced_slots(n: int, p: int, e: int, round_idx: int,
                   device) -> torch.Tensor:
    """``(N, E)`` int64 ring slots each node services this round under
    an egress cap of ``e < p`` slots: a window that advances by ``e``
    every round, offset per node by a static phase so nodes decorrelate.

    The JAX package computes ``round_idx * e`` and ``node * 0x9E37`` in
    int32 (wrapping past 2**31, which ``node * 0x9E37`` does beyond
    53 020 nodes) and then takes the remainder with the divisor's sign;
    so does this, in int64 carriers."""
    rnd = torch.full((), round_idx, dtype=torch.int64, device=device)
    base = _wrap_i32(_wrap_i32(rnd) * e) % p
    node = torch.arange(n, dtype=torch.int64, device=device)
    node_phase = _wrap_i32(node * 0x9E37) % p
    lane = torch.arange(e, dtype=torch.int64, device=device)
    return (base + node_phase[:, None] + lane[None, :]) % p


def broadcast_step(
    gossip: GossipState,
    key,
    sender_alive: torch.Tensor,  # (N,) bool
    target_alive_view,  # (1, N) or (N, N) believed up, or a callable
    fanout: int,
    emit_slots: int = 0,
    round_idx: int = 0,
    need_chunk: bool = True,
):
    """Emit one round of gossip; decrement transmission budgets.

    ``emit_slots`` (0 = all): egress cap per node per round — the
    reference's bounded flush (``broadcast/mod.rs:378,394,446-455``). A
    round-rotating window (:func:`serviced_slots` of ``round_idx``, the
    round number) picks which slots are serviced; unserviced slots keep
    their transmission budget and wait.

    Returns ``(gossip, dst, src, actor, ver, chunk, valid)`` flat lanes
    of length ``N * serviced_slots * fanout``."""
    n, p, _ = gossip.pend.shape
    e = p if not emit_slots or emit_slots >= p else emit_slots
    dev = gossip.pend.device
    if e < p:
        slot_ids = serviced_slots(n, p, e, round_idx, dev)
        rows = torch.arange(n, device=dev)[:, None]
        pend_e = gossip.pend[rows, slot_ids]  # (N, E, 4)
    else:
        pend_e = gossip.pend
    live = (pend_e[..., PEND_TX] > 0) & sender_alive[:, None]  # (N, E)

    tkey = prng.fold_in(key, BROADCAST_TARGET_KEY_TAG)
    targets = prng.randint(tkey, (n, e, fanout), 0, n, dev)
    src = torch.arange(n, dtype=torch.int32, device=dev)[:, None, None]
    src = src.expand(targets.shape)
    # a shared (1, N) view (SWIM off), the sender's row of an (N, N)
    # plane, or the windowed per-pair membership test (a callable)
    if callable(target_alive_view):
        believed_up = target_alive_view(src, targets)
    elif target_alive_view.shape[0] == 1:
        believed_up = target_alive_view[0][targets.long()]
    else:
        believed_up = target_alive_view[src.long(), targets.long()]
    ok = live[:, :, None] & believed_up & (targets != src)

    dst = targets.reshape(-1)
    valid = ok.reshape(-1)
    actor = pend_e[..., PEND_ACTOR][:, :, None].expand(targets.shape)
    ver = pend_e[..., PEND_VER][:, :, None].expand(targets.shape)
    if need_chunk:
        chunk = pend_e[..., PEND_CHUNK][:, :, None].expand(targets.shape)
        chunk = chunk.reshape(-1)
    else:
        chunk = torch.zeros(dst.shape, dtype=torch.int32, device=dev)
    new_pend = gossip.pend.clone()
    if e < p:
        # a node's serviced slots are distinct, so the update is a set
        new_pend[rows, slot_ids, PEND_TX] = (
            pend_e[..., PEND_TX] - live.to(torch.int32))
    else:
        new_pend[..., PEND_TX] -= live.to(torch.int32)
    return (
        dataclasses.replace(gossip, pend=new_pend),
        dst,
        src.reshape(-1),
        actor.reshape(-1),
        ver.reshape(-1),
        chunk,
        valid,
    )
