"""SWIM failure detection over one packed (N, N) belief plane.

Port of ``corro_sim/membership/swim.py``. Node ``i``'s belief about
member ``j`` is packed as ``inc << inc_shift | status << status_shift |
since``, so plain integer ``max`` is foca's update precedence: higher
incarnation wins, then higher severity (down > suspect > alive), then the
later suspicion start. Each tick every node probes one random member
(with indirect probes), suspects on silence, times suspicions out to
DOWN, exchanges bounded view blocks with ``swim_gossip_peers`` peers in
both directions, runs the periodic announce, and refutes its own
suspicion by bumping its incarnation (saturating).

Ranges and counters. While a profiler records, :func:`swim_step` opens
the sibling ranges ``corro.swim.probe`` (targets, indirect probes,
suspicion), ``corro.swim.timeout``, ``corro.swim.exchange`` (the
``swim_gossip_peers`` pull/push rounds), ``corro.swim.announce``
(announce ticks only) and ``corro.swim.refute`` (refutation and the
tick's counts) through :meth:`~corro_sim_torch.utils.tracing.Tracer.stage`;
with none recording they build nothing. Each tick counts itself in
``corro_swim_ticks_total{announce}``, on the host, reading nothing from
the device.

Carriers. The JAX package keeps the plane unsigned: uint32 (wide) or
uint16 (``narrow_state``). Torch has no unsigned 32- or 16-bit arithmetic
on the CPU, so the port carries the wide plane in int64 and the narrow
one in int32; the layout is keyed by the carrier's dtype. Every value in
the plane stays in ``[0, 2**bits)``, so ``max`` ranks the same, and each
expression that would wrap in the unsigned type (the mod-2^k suspicion
clock) is masked back to the field's width. Complements are the layout's
positive masks, never ``~mask`` on the carrier.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from corro_sim_torch import prng
from corro_sim_torch.utils.metrics import (
    SWIM_TICKS_HELP,
    SWIM_TICKS_TOTAL,
    counters,
)
from corro_sim_torch.utils.runtime import host_array
from corro_sim_torch.utils.tracing import tracer

ALIVE, SUSPECT, DOWN = 0, 1, 2

# fold_in tags of the per-exchange keys drawn from the SWIM lane (the JAX
# package's key-lineage contract): peer exchange g folds
# SWIM_PEER_KEY_TAG_BASE + g, the announce folds SWIM_ANNOUNCE_KEY_TAG.
# Shared with the windowed automaton. Changing either re-keys every
# seeded membership stream.
SWIM_PEER_KEY_TAG_BASE = 0
SWIM_ANNOUNCE_KEY_TAG = 997


@dataclasses.dataclass(frozen=True)
class SwimLayout:
    """Packed-field geometry of one belief plane, as python ints."""

    dtype: torch.dtype  # the signed carrier
    bits: int  # width of the JAX package's unsigned plane
    status_shift: int
    inc_shift: int
    since_mask: int
    inc_max: int  # refutation saturation bound of the inc field

    @property
    def status_mask(self) -> int:
        return 3 << self.status_shift

    @property
    def down_key(self) -> int:
        return DOWN << self.status_shift

    @property
    def full_mask(self) -> int:
        return (1 << self.bits) - 1

    @property
    def not_status_mask(self) -> int:
        return self.full_mask ^ self.status_mask

    @property
    def inc_only_mask(self) -> int:
        return self.full_mask ^ (self.status_mask | self.since_mask)


WIDE_LAYOUT = SwimLayout(
    dtype=torch.int64, bits=32, status_shift=16, inc_shift=18,
    since_mask=0xFFFF, inc_max=(1 << 14) - 1,
)
NARROW_LAYOUT = SwimLayout(
    dtype=torch.int32, bits=16, status_shift=8, inc_shift=10,
    since_mask=0xFF, inc_max=(1 << 6) - 1,
)


def swim_layout(dtype: torch.dtype) -> SwimLayout:
    """The layout a belief plane uses, keyed by its carrier dtype."""
    return NARROW_LAYOUT if dtype == torch.int32 else WIDE_LAYOUT


def belief_dtype(narrow: bool) -> torch.dtype:
    return NARROW_LAYOUT.dtype if narrow else WIDE_LAYOUT.dtype


def pack_swim(status, inc, since, dtype: torch.dtype) -> torch.Tensor:
    """(status, inc, since) planes -> one packed plane."""
    lo = swim_layout(dtype)

    def t(x):
        return torch.as_tensor(x).to(lo.dtype)

    return ((t(inc) << lo.inc_shift) | (t(status) << lo.status_shift)
            | (t(since) & lo.since_mask))


def _status(b: torch.Tensor) -> torch.Tensor:
    return (b >> swim_layout(b.dtype).status_shift) & 3


@dataclasses.dataclass
class SwimState:
    p: torch.Tensor  # (N, N) packed (inc, status, since) beliefs

    # unpacked read-only views (metrics, tests)
    @property
    def status(self) -> torch.Tensor:
        return _status(self.p).to(torch.int8)

    @property
    def inc(self) -> torch.Tensor:
        return (self.p >> swim_layout(self.p.dtype).inc_shift).to(
            torch.int32)

    @property
    def since(self) -> torch.Tensor:
        return (self.p & swim_layout(self.p.dtype).since_mask).to(
            torch.int32)


def make_swim_state(num_nodes: int, enabled: bool, narrow: bool,
                    device, rows: int | None = None) -> SwimState:
    """The all-ALIVE plane; ``(1, 1)`` with SWIM off. ``rows``: only
    that many observers' rows (one rank's shard)."""
    n = num_nodes if enabled else 1
    r = rows if enabled and rows is not None else n
    return SwimState(p=torch.zeros((r, n), dtype=belief_dtype(narrow),
                                   device=device))


def down_belief_matrix(sw, n: int) -> np.ndarray:
    """(observer, subject) bool numpy matrix: who believes whom DOWN.
    Host-side; takes the full plane and the windowed state alike, on any
    device or already on the host (``status`` and ``member`` as numpy
    arrays)."""
    status = host_array(sw.status)
    if hasattr(sw, "member"):
        member = host_array(sw.member)
        out = np.zeros((n, n), bool)
        obs = np.broadcast_to(np.arange(n)[:, None], member.shape)
        hit = (member >= 0) & (status >= DOWN)
        out[obs[hit], member[hit]] = True
        return out
    return status >= DOWN


def renew_membership(swim_state, wipe: torch.Tensor, row_lo: int = 0):
    """Crash-restart the masked nodes' membership state: each wiped
    node's belief row resets to the empty-DB state and its self entry
    comes back ALIVE at a bumped incarnation (saturating at the layout's
    ``inc_max``), the foca identity ``renew()`` that lets peers holding a
    DOWN verdict re-admit it. The pre-wipe self-incarnation is read
    before the reset. Takes the full (N, N) plane (wide or narrow
    carrier) and the windowed member/belief state; ``wipe`` is an (N,)
    bool mask, and untouched rows pass through unchanged. ``row_lo``: the
    full plane is one rank's rows, those of nodes ``row_lo`` on (the
    windowed state is whole under a mesh)."""
    if hasattr(swim_state, "member"):  # windowed O(N·K) belief state
        belief = swim_state.belief
        lo = swim_layout(belief.dtype)
        n = swim_state.member.shape[0]
        old_inc = belief[:, 0] >> lo.inc_shift
        renewed = torch.clamp(old_inc + 1, max=lo.inc_max) << lo.inc_shift
        fresh = torch.full_like(swim_state.member, -1)
        fresh[:, 0] = torch.arange(n, dtype=fresh.dtype, device=fresh.device)
        member = torch.where(wipe[:, None], fresh, swim_state.member)
        belief = torch.where(wipe[:, None], 0, belief)
        belief[:, 0] = torch.where(wipe, renewed, belief[:, 0])
        cursor = torch.where(wipe, 1, swim_state.cursor)
        return dataclasses.replace(swim_state, member=member, belief=belief,
                                   cursor=cursor)
    p = swim_state.p
    lo = swim_layout(p.dtype)
    rows = torch.arange(p.shape[0], device=p.device)
    cols = rows + row_lo
    wipe = wipe[row_lo:row_lo + p.shape[0]]
    old_inc = p[rows, cols] >> lo.inc_shift
    renewed = torch.clamp(old_inc + 1, max=lo.inc_max) << lo.inc_shift
    p = torch.where(wipe[:, None], 0, p)
    p[rows, cols] = torch.where(wipe, renewed, p[rows, cols])
    return dataclasses.replace(swim_state, p=p)


def view_alive(swim: SwimState) -> torch.Tensor:
    """(N, N) bool: who each node would still gossip and sync with.
    Suspects stay targets; only DOWN members are excluded."""
    lo = swim_layout(swim.p.dtype)
    return (swim.p & lo.status_mask) < lo.down_key


def tick_round(cfg, round_idx: int) -> bool:
    """Whether SWIM ticks in round ``round_idx``."""
    return cfg.swim_interval <= 1 or round_idx % cfg.swim_interval == 0


def announce_round(cfg, round_idx: int) -> bool:
    """Whether a tick in round ``round_idx`` runs the periodic announce:
    the one tick inside each announce window (every tick once
    ``swim_interval`` exceeds ``swim_announce_interval``)."""
    return round_idx % cfg.swim_announce_interval < cfg.swim_interval


def swim_step(cfg, swim: SwimState, key, alive: torch.Tensor, reachable,
              round_idx: int, mesh=None):
    """One SWIM protocol round for every node; returns ``(swim,
    metrics)``. ``round_idx`` is the round number on the host;
    ``reachable(src, dst)`` is the ground-truth link predicate.

    ``mesh``: ``swim.p`` is this rank's ``(N/D, N)`` rows. Draws keep
    their global shapes and each rank takes its rows' share; a pull or
    an announce fetches just the partners' rows
    (:meth:`~corro_sim_torch.engine.sharding.Mesh.fetch_rows`), a push
    routes each sender's row to the target's owner, and the diagonal
    the bounded pull reads is all-gathered (N words)."""
    p = swim.p
    lo = swim_layout(p.dtype)
    n = p.shape[1]
    r0, r1 = (0, n) if mesh is None else mesh.bounds(n)
    nl = r1 - r0
    dev = p.device
    announce = announce_round(cfg, round_idx)
    counters.inc(SWIM_TICKS_TOTAL, labels=f'{{announce="{int(announce)}"}}',
                 help_=SWIM_TICKS_HELP)
    k_tgt, k_ind, k_ex = prng.split(key, 3)
    rnd = round_idx & lo.since_mask

    def rows_of(idx):
        """``p[idx]`` of the whole plane: this rank's rows, or fetched."""
        if mesh is None:
            return p[idx.long()]
        return mesh.fetch_rows(p, idx)

    def diagonal():
        d = p[loc, me.long()]
        return d if mesh is None else mesh.gather(d)

    # --- probe: one random target each ----------------------------------
    with tracer.stage("corro.swim.probe"):
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        me = rows[r0:r1]  # this rank's nodes
        loc = torch.arange(nl, device=dev)  # their rows of p
        alive_me = alive[r0:r1]
        zero = torch.zeros((), dtype=lo.dtype, device=dev)
        tgt = prng.randint(k_tgt, (n,), 0, n, dev)[r0:r1]
        tgt_l = tgt.long()
        cur = p[loc, tgt_l]
        cur_status = (cur >> lo.status_shift) & 3
        probing = alive_me & (tgt != me) & (cur_status < DOWN)
        direct_ack = probing & alive[tgt_l] & reachable(me, tgt)
        inter = prng.randint(k_ind, (n, cfg.swim_indirect_probes), 0, n,
                             dev)[r0:r1]
        ind_ok = (
            alive[inter.long()]
            & alive[tgt_l][:, None]
            & reachable(me[:, None], inter)
            & reachable(inter, tgt[:, None])
        ).any(dim=1)
        acked = direct_ack | (probing & ind_ok)
        failed = probing & ~acked

        newly_suspect = failed & (cur_status == ALIVE)
        # an ack refutes only our own suspicion at the same incarnation
        refuted = acked & (cur_status == SUSPECT)
        new_status = torch.where(
            newly_suspect, SUSPECT, torch.where(refuted, ALIVE, cur_status)
        )
        new_since = torch.where(newly_suspect, rnd, cur & lo.since_mask)
        new_p = ((cur & lo.inc_only_mask) | (new_status << lo.status_shift)
                 | new_since)
        p = p.clone()
        p[loc, tgt_l] = torch.where(probing, new_p, cur)

    # --- suspicion timeout -> down --------------------------------------
    with tracer.stage("corro.swim.timeout"):
        elapsed = (rnd - (p & lo.since_mask)) & lo.since_mask  # mod 2^k
        timed_out = (
            (_status(p) == SUSPECT)
            & (elapsed >= cfg.swim_suspect_rounds)
            & alive_me[:, None]
        )
        p = torch.where(timed_out, (p & lo.not_status_mask) | lo.down_key,
                        p)

    # --- epidemic view exchange -----------------------------------------
    # pull: merge a believed-up peer's view; push: every node pushes to a
    # random target, concurrent pushes combined by a row scatter-max.
    # Each datagram carries a contiguous block of swim_payload_members
    # member columns at a per-sender phase (>= n: the full view), and
    # always its sender's own entry (the message header).
    bounded = cfg.swim_payload_members < n

    def payload_block(key_b):
        """Each sender's block phase, (N,); None with the full view."""
        if not bounded:
            return None
        return prng.randint(key_b, (n,), 0, n, dev)

    def block_rows(off):
        """The block masks of the senders whose phases are ``off``."""
        return torch.remainder(cols[None, :] - off[:, None], n) < (
            cfg.swim_payload_members)

    with tracer.stage("corro.swim.exchange"):
        cols = torch.arange(n, dtype=torch.int32, device=dev)
        for g in range(cfg.swim_gossip_peers):
            kg_pull, kg_push, kg_bl1, kg_bl2 = prng.split(
                prng.fold_in(k_ex, SWIM_PEER_KEY_TAG_BASE + g), 4
            )
            peer = prng.randint(kg_pull, (n,), 0, n, dev)[r0:r1]
            peer_l = peer.long()
            can1 = (
                alive_me & alive[peer_l] & reachable(me, peer) & (peer != me)
                & ((p[loc, peer_l] & lo.status_mask) < lo.down_key)
            )
            can = can1[:, None]
            off = payload_block(kg_bl1)
            if off is not None:
                # the responder picks the contents
                can = can & block_rows(off[peer_l])
            p = torch.where(can, torch.maximum(p, rows_of(peer)), p)
            if off is not None:
                # the sender's identity + incarnation ride every message
                p[loc, peer_l] = torch.maximum(
                    p[loc, peer_l],
                    torch.where(can1, diagonal()[peer_l], zero)
                )

            push_tgt = prng.randint(kg_push, (n,), 0, n, dev)[r0:r1]
            push_l = push_tgt.long()
            ok_push = (
                alive_me & alive[push_l] & reachable(me, push_tgt)
                & (push_tgt != me)
                & ((p[loc, push_l] & lo.status_mask) < lo.down_key)
            )
            send = ok_push[:, None]
            off = payload_block(kg_bl2)
            if off is not None:
                send = send & block_rows(off[r0:r1])
            contrib = torch.where(send, p, zero)
            if off is not None:
                contrib[loc, me.long()] = torch.where(
                    ok_push, p[loc, me.long()], zero)
            # zero is the identity of this max and every value is >= 0, so
            # a row whose sender may not push (all zeros) can land
            # anywhere: no lane is dropped, and the max is order-free
            # (deterministic under atomics too)
            if mesh is None:
                best = torch.zeros_like(p).index_reduce_(
                    0, push_l, contrib, "amax", include_self=True
                )
            else:
                # only rows that may push carry anything: route those to
                # the targets' owners
                sel = torch.nonzero(ok_push).reshape(-1)
                owner = torch.div(push_l[sel], nl, rounding_mode="floor")
                order = torch.argsort(owner, stable=True)
                sel = sel[order]
                _, got_tgt, got_rows = mesh.exchange(
                    torch.bincount(owner, minlength=mesh.nodes),
                    push_l[sel], contrib[sel])
                best = torch.zeros_like(p).index_reduce_(
                    0, got_tgt - r0, got_rows, "amax", include_self=True
                )
            p = torch.where(alive_me[:, None], torch.maximum(p, best), p)

    # --- periodic announce (belief-independent) --------------------------
    if announce:
        with tracer.stage("corro.swim.announce"):
            perm = prng.permutation(
                prng.fold_in(k_ex, SWIM_ANNOUNCE_KEY_TAG), n, dev
            )
            inv = torch.empty_like(perm)
            inv[perm.long()] = rows  # the stable argsort of a permutation
            for partner in (perm, inv):
                partner = partner[r0:r1]
                part_l = partner.long()
                can = (alive_me & alive[part_l] & reachable(me, partner)
                       & (partner != me))[:, None]
                p = torch.where(can, torch.maximum(p, rows_of(partner)), p)

    # --- refutation / identity renew -------------------------------------
    with tracer.stage("corro.swim.refute"):
        self_p = p[loc, me.long()]
        need_refute = alive_me & ((self_p & lo.status_mask) > 0)
        inc_next = torch.clamp((self_p >> lo.inc_shift) + 1, max=lo.inc_max)
        refreshed = inc_next << lo.inc_shift  # ALIVE, since 0
        p[loc, me.long()] = torch.where(need_refute, refreshed, self_p)

        swim = SwimState(p=p)
        failures = failed.sum(dtype=torch.int32)
        if mesh is not None:
            failures = mesh.reduce(failures)
        return swim, plane_metrics(swim, alive, failures, mesh=mesh)


def plane_metrics(swim: SwimState, alive: torch.Tensor,
                  probe_failures: torch.Tensor, mesh=None) -> dict:
    """Suspect and DOWN beliefs held by live nodes. ``mesh``: ``swim.p``
    is this rank's rows; the counts are summed over the ranks."""
    status = _status(swim.p)
    if mesh is not None:
        r0, r1 = mesh.bounds(alive.shape[0])
        alive = alive[r0:r1]
    counts = torch.stack([
        ((status == SUSPECT) & alive[:, None]).sum(dtype=torch.int32),
        ((status == DOWN) & alive[:, None]).sum(dtype=torch.int32),
    ])
    if mesh is not None:
        counts = mesh.reduce(counts)
    return {
        "swim_suspects": counts[0],
        "swim_down": counts[1],
        "swim_probe_failures": probe_failures,
    }
