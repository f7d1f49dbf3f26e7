"""Windowed SWIM: an O(N·K) belief state, and the view gossip and sync
consult.

Port of ``corro_sim/membership/swim_window.py``. Each node tracks at
most K members:

    member (N, K) int32   — tracked member id, -1 = empty (slot 0 = self)
    belief (N, K) packed  — the full plane's (inc | status | since)
                            packing, in the same carriers (int64 wide,
                            int32 narrow), so precedence merges stay
                            integer max
    cursor (N,)   int32   — rotating insertion cursor

Per tick: probe one known believed-up member (direct and indirect),
suspect on silence, time suspicions out, pull bounded payload blocks
from ``swim_gossip_peers`` known members (matched members merge by
packed max, unknown ones fill slots at the cursor), the periodic
announce pull from a uniformly random member id, and refutation in
slot 0.
"""

from __future__ import annotations

import dataclasses

import torch

from corro_sim_torch import prng
from corro_sim_torch.membership.swim import (
    DOWN,
    SUSPECT,
    SWIM_PEER_KEY_TAG_BASE,
    _status,
    announce_round,
    belief_dtype,
    swim_layout,
    view_alive,
)
from corro_sim_torch.utils.sort import scatter_set

# xor'd into the seed of the bootstrap sample's key
BOOTSTRAP_SEED_XOR = 0x5117


@dataclasses.dataclass
class SwimWindowState:
    member: torch.Tensor  # (N, K) int32, -1 = empty; slot 0 = self
    belief: torch.Tensor  # (N, K) packed (inc | status | since)
    cursor: torch.Tensor  # (N,) int32 rotating insertion cursor

    # unpacked read-only views; empty slots read as ALIVE/0
    @property
    def status(self) -> torch.Tensor:
        return _status(self.belief).to(torch.int8)

    @property
    def inc(self) -> torch.Tensor:
        return (self.belief >> swim_layout(self.belief.dtype).inc_shift).to(
            torch.int32)

    @property
    def since(self) -> torch.Tensor:
        return (self.belief & swim_layout(self.belief.dtype).since_mask).to(
            torch.int32)

    @property
    def self_inc(self) -> torch.Tensor:
        """(N,) each node's own incarnation (slot 0 = self)."""
        return (self.belief[:, 0] >> swim_layout(self.belief.dtype)
                .inc_shift).to(torch.int32)


def make_swim_window_state(num_nodes: int, view_size: int, seed: int,
                           enabled: bool, narrow: bool,
                           device) -> SwimWindowState:
    """Self in slot 0 and a bootstrap sample of other members, drawn from
    ``PRNGKey(seed ^ BOOTSTRAP_SEED_XOR)``, in the rest; ``(1, 1)`` with
    SWIM off."""
    n = num_nodes if enabled else 1
    k = max(view_size, 2) if enabled else 1
    i32 = dict(dtype=torch.int32, device=device)
    rows = torch.arange(n, **i32)
    member = torch.full((n, k), -1, **i32)
    member[:, 0] = rows
    if enabled and n > 1:
        # never the node itself: self lives only in slot 0
        fill = prng.randint(prng.PRNGKey(seed ^ BOOTSTRAP_SEED_XOR),
                            (n, k - 1), 1, n, device)
        member[:, 1:] = torch.remainder(rows[:, None] + fill, n)
    return SwimWindowState(
        member=member,
        belief=torch.zeros((n, k), dtype=belief_dtype(narrow), device=device),
        cursor=torch.ones((n,), **i32),
    )


def membership_view(cfg, swim_state, n: int):
    """The view gossip and sync consult: the windowed per-pair test (a
    callable) when ``swim_view_size > 0``, the dense (N, N) plane
    otherwise, a shared all-up ``(1, N)`` row with SWIM off."""
    if not cfg.swim_enabled:
        dev = (swim_state.member if cfg.swim_view_size > 0
               else swim_state.p).device
        return torch.ones((1, n), dtype=torch.bool, device=dev)
    if cfg.swim_view_size > 0:
        return lambda src, dst: believed_up_pairs(swim_state, src, dst)
    return view_alive(swim_state)


def believed_up_pairs(st: SwimWindowState, src: torch.Tensor,
                      dst: torch.Tensor) -> torch.Tensor:
    """Per pair, whether ``src`` would still talk to ``dst``: true unless
    src's view holds dst DOWN (unknown members count as up). ``src`` and
    ``dst`` have equal shapes; cost is pairs x K."""
    src_l = src.long()
    mem = st.member[src_l]
    bel = st.belief[src_l]
    lo = swim_layout(bel.dtype)
    down = (mem == dst[..., None]) & ((bel & lo.status_mask) >= lo.down_key)
    return ~down.any(dim=-1)


def view_alive_dense(st: SwimWindowState) -> torch.Tensor:
    """(N, N) believed-up plane, O(N²·K): small N only."""
    n = st.member.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=st.member.device)
    return believed_up_pairs(st, ids[:, None].expand(n, n),
                             ids[None, :].expand(n, n))


def _merge_block(st: SwimWindowState, peer, ok, pay_off,
                 pay_k: int) -> SwimWindowState:
    """Merge ``pay_k`` contiguous view slots of ``peer``'s view, from
    ``pay_off``, into every node's view: matched members by packed max,
    unmatched ones into slots at the rotating cursor (never slot 0).

    More fresh entries than ``k - 1`` wrap the cursor onto a slot an
    earlier lane of the same row also writes; the JAX package leaves the
    winner of that duplicate write unspecified. The port applies a row's
    fresh lanes in payload order, so the later lane wins."""
    n, k = st.member.shape
    dev = st.member.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    cols = torch.arange(pay_k, dtype=torch.int32, device=dev)
    src_slots = torch.remainder(pay_off[:, None] + cols[None, :], k)
    peer_l = peer.long()[:, None]
    inc_mem = st.member[peer_l, src_slots.long()]  # (N, P)
    inc_bel = st.belief[peer_l, src_slots.long()]
    inc_ok = ok[:, None] & (inc_mem >= 0)

    match = st.member[:, :, None] == torch.where(inc_ok, inc_mem, -2)[
        :, None, :]  # (N, K, P)
    best_in = torch.where(match, inc_bel[:, None, :], 0).amax(dim=2)
    belief = torch.maximum(st.belief, best_in)

    fresh = inc_ok & ~match.any(dim=1) & (inc_mem != rows[:, None])
    fresh_i = fresh.to(torch.int32)
    frank = torch.cumsum(fresh_i, dim=1, dtype=torch.int32) - 1
    count = fresh_i.sum(dim=1, dtype=torch.int32)
    dst_slot = 1 + torch.remainder(st.cursor[:, None] + frank - 1, k - 1)
    # lane j and lane j' > j share a slot iff frank' = frank + (k - 1)
    won = fresh & (frank + (k - 1) >= count[:, None])
    idx = (rows[:, None].expand(n, pay_k), dst_slot)
    member = scatter_set(st.member, idx, inc_mem, won)
    belief = scatter_set(belief, idx, inc_bel, won)
    cursor = 1 + torch.remainder(st.cursor - 1 + count, k - 1)
    return SwimWindowState(member=member, belief=belief, cursor=cursor)


def swim_window_step(cfg, st: SwimWindowState, key, alive: torch.Tensor,
                     reachable, round_idx: int):
    """One windowed SWIM round for every node; returns ``(state,
    metrics)``. The input state is not modified: the round's view (a
    callable over it) stays the state at the start of the round."""
    n, k = st.member.shape
    lo = swim_layout(st.belief.dtype)
    dev = st.member.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    rows_l = rows.long()
    k_tgt, k_ind, k_ex, k_ann = prng.split(key, 4)
    rnd = round_idx & lo.since_mask
    pay = min(max(cfg.swim_payload_members, 2), k)

    # --- probe: one random KNOWN target each -----------------------------
    slot = prng.randint(k_tgt, (n,), 1, k, dev)
    slot_l = slot.long()
    tgt = st.member[rows_l, slot_l]
    cur = st.belief[rows_l, slot_l]
    cur_status = _status(cur)
    probing = alive & (tgt >= 0) & (tgt != rows) & (cur_status < DOWN)
    tgt_c = torch.where(tgt >= 0, tgt, 0)
    direct_ack = probing & alive[tgt_c.long()] & reachable(rows, tgt_c)
    islot = prng.randint(k_ind, (n, cfg.swim_indirect_probes), 1, k, dev)
    inter = st.member[rows_l[:, None], islot.long()]
    inter_c = torch.where(inter >= 0, inter, 0)
    ind_ok = (
        (inter >= 0)
        & alive[inter_c.long()]
        & alive[tgt_c.long()][:, None]
        & reachable(rows[:, None], inter_c)
        & reachable(inter_c, tgt_c[:, None])
    ).any(dim=1)
    acked = direct_ack | (probing & ind_ok)
    failed = probing & ~acked

    newly_suspect = failed & (cur_status == 0)
    refuted_ack = acked & (cur_status == SUSPECT)
    new_status = torch.where(
        newly_suspect, SUSPECT, torch.where(refuted_ack, 0, cur_status)
    )
    new_since = torch.where(newly_suspect, rnd, cur & lo.since_mask)
    new_b = ((cur & lo.inc_only_mask) | (new_status << lo.status_shift)
             | new_since)
    onehot = torch.arange(k, device=dev)[None, :] == slot_l[:, None]
    belief = torch.where(onehot & probing[:, None], new_b[:, None],
                         st.belief)

    # --- suspicion timeout -> down ---------------------------------------
    elapsed = (rnd - (belief & lo.since_mask)) & lo.since_mask
    timed_out = (
        (_status(belief) == SUSPECT)
        & (elapsed >= cfg.swim_suspect_rounds)
        & alive[:, None]
        & (st.member >= 0)
    )
    belief = torch.where(timed_out, (belief & lo.not_status_mask)
                         | lo.down_key, belief)
    st = SwimWindowState(member=st.member, belief=belief, cursor=st.cursor)

    # --- pull exchanges with known believed-up members -------------------
    for g in range(cfg.swim_gossip_peers):
        kg_s, kg_o = prng.split(
            prng.fold_in(k_ex, SWIM_PEER_KEY_TAG_BASE + g)
        )
        pslot = prng.randint(kg_s, (n,), 1, k, dev).long()
        peer = st.member[rows_l, pslot]
        pb = st.belief[rows_l, pslot]
        peer_c = torch.where(peer >= 0, peer, 0)
        ok = (
            alive & (peer >= 0) & (peer != rows)
            & ((pb & lo.status_mask) < lo.down_key)
            & alive[peer_c.long()] & reachable(rows, peer_c)
        )
        off = prng.randint(kg_o, (n,), 0, k, dev)
        st = _merge_block(st, peer_c, ok, off, pay)

    # --- periodic announce: uniform-random member, ground-truth gated ----
    if announce_round(cfg, round_idx):
        ka_t, ka_o = prng.split(k_ann)
        peer = prng.randint(ka_t, (n,), 0, n, dev)
        ok = (alive & (peer != rows) & alive[peer.long()]
              & reachable(rows, peer))
        off = prng.randint(ka_o, (n,), 0, k, dev)
        st = _merge_block(st, peer, ok, off, pay)

    # --- refutation / identity renew (slot 0 = self) ---------------------
    self_b = st.belief[:, 0]
    need_refute = alive & ((self_b & lo.status_mask) > 0)
    inc_next = torch.clamp((self_b >> lo.inc_shift) + 1, max=lo.inc_max)
    belief = st.belief.clone()
    belief[:, 0] = torch.where(need_refute, inc_next << lo.inc_shift, self_b)
    st = SwimWindowState(member=st.member, belief=belief, cursor=st.cursor)
    return st, window_metrics(st, alive, failed.sum(dtype=torch.int32))


def window_metrics(st: SwimWindowState, alive: torch.Tensor,
                   probe_failures: torch.Tensor) -> dict:
    """Suspect and DOWN beliefs held by live nodes about tracked
    members."""
    status = _status(st.belief)
    held = (st.member >= 0) & alive[:, None]
    return {
        "swim_suspects": ((status == SUSPECT) & held).sum(dtype=torch.int32),
        "swim_down": ((status >= DOWN) & held).sum(dtype=torch.int32),
        "swim_probe_failures": probe_failures,
    }
