"""One SWIM tick of a whole cluster, in plain ``torch``.

The membership layer's reference: from the belief plane a tick starts
with, the plane it must end with. It imports neither the program nor
JAX; its draws come from ``draws.py``'s threefry (``split``,
``fold_in``, ``randint``, ``bits``) and a plain permutation.

The protocol, as foca's automaton runs it (SURVEY.md sections 2 and 7;
``broadcast/mod.rs:120-375``), once a round for every node at once:

1. probe: each live node pings one member drawn at random; on silence it
   asks ``indirect_probes`` helpers to ping it; a member that answers
   neither way is suspected from this round on, and a suspect that
   answers is believed alive again;
2. timeout: a suspicion older than ``suspect_rounds`` rounds becomes a
   DOWN verdict;
3. exchange, ``gossip_peers`` times: each node pulls a peer's view and
   pushes its own to another member; a datagram holds at most
   ``payload_members`` member entries (foca's 1178-byte packet,
   ``broadcast/mod.rs:743``) and always the sender's own entry, its
   header; a node never talks to a member it believes DOWN;
4. announce, in one round of each ``announce_interval``: each node
   exchanges full views with two partners, whatever it believes of them;
5. refute: a live node suspected or declared DOWN by itself (what it has
   heard of itself) comes back ALIVE at the next incarnation.

A belief is ``(incarnation, status, since)``, ordered in that order
(foca's precedence: a higher incarnation wins, then the graver status,
ALIVE < SUSPECT < DOWN); ``since`` is the round a suspicion began,
modulo the field's width. Two beliefs merge to the larger. The layouts
pack a belief into one unsigned integer, ``inc << inc_shift | status <<
status_shift | since``, of 32 bits (wide) or 16 (narrow); here every
belief is held in int64, and the plane comes back in the caller's dtype.

Departures from foca, each one the simulator's:

- rounds are synchronous: every node acts in every stage at once, and a
  stage sees the plane as the stage before it left it; within the
  exchange, a pull reads the responders' rows as the previous stage
  left them, and the header it carries is the responder's own entry
  after the pull;
- time is counted in rounds: the suspicion timeout is a count of rounds
  on the ``since`` clock, which wraps at the field's width;
- an answered probe of a suspect reverts it to ALIVE at the same
  incarnation (foca waits for the member's own refutation);
- indirect helpers are drawn with replacement among all members, the
  prober and the target included; one that is up and reaches both
  answers for the target;
- a datagram's member entries are a contiguous block of
  ``payload_members`` members at a phase each sender draws, not foca's
  backlog of recent updates; pushes that meet at one node merge
  together;
- the announce pairs node ``i`` with ``perm[i]`` and with
  ``perm^-1[i]`` of one random permutation, in that order;
- the refuted incarnation saturates at the field's maximum.

The plane is worked row block by row block (``block_rows`` observers at
a time), so at 10 000 nodes the reference holds two working planes
besides the one it is given, and one block's temporaries, beside the
program's state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simbench.reference import draws

ALIVE, SUSPECT, DOWN = 0, 1, 2
# fold_in tags of the exchange's keys: exchange g folds PEER_TAG + g,
# the announce folds ANNOUNCE_TAG
PEER_TAG = 0
ANNOUNCE_TAG = 997
BLOCK_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the fields of a packed belief lie."""

    bits: int
    status_shift: int
    inc_shift: int

    @property
    def since_mask(self) -> int:
        return (1 << self.status_shift) - 1

    @property
    def inc_max(self) -> int:
        return (1 << (self.bits - self.inc_shift)) - 1


WIDE = Layout(bits=32, status_shift=16, inc_shift=18)
NARROW = Layout(bits=16, status_shift=8, inc_shift=10)


@dataclasses.dataclass(frozen=True)
class Params:
    """The protocol's settings: the configuration's ``swim_*`` fields."""

    narrow: bool
    indirect_probes: int
    suspect_rounds: int
    gossip_peers: int
    payload_members: int
    announce_interval: int
    interval: int

    @classmethod
    def from_sim(cls, sim) -> "Params":
        """From a simulator configuration (its ``swim_*`` fields and
        ``narrow_state``)."""
        return cls(
            narrow=bool(sim.narrow_state),
            indirect_probes=int(sim.swim_indirect_probes),
            suspect_rounds=int(sim.swim_suspect_rounds),
            gossip_peers=int(sim.swim_gossip_peers),
            payload_members=int(sim.swim_payload_members),
            announce_interval=int(sim.swim_announce_interval),
            interval=int(sim.swim_interval),
        )


def status(b: torch.Tensor, lo: Layout) -> torch.Tensor:
    return (b >> lo.status_shift) & 3


def is_announce(params: Params, round_idx: int) -> bool:
    """Whether a tick in ``round_idx`` announces: the one tick inside
    each window of ``announce_interval`` rounds (every tick, when ticks
    are further apart than that)."""
    return round_idx % params.announce_interval < params.interval


# -- the rules a planted fault replaces (simbench's CPU tests do) --------

def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The belief that wins between ``a`` and ``b``."""
    return torch.maximum(a, b)


def combine_pushes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two pushes that reach one node in the same round, as one."""
    return torch.maximum(a, b)


def timed_out(elapsed: torch.Tensor, suspect_rounds: int) -> torch.Tensor:
    """Whether a suspicion ``elapsed`` rounds old is a DOWN verdict."""
    return elapsed >= suspect_rounds


def with_header(plane, peer, can, diag):
    """Each receiver's belief about its responder after the responder's
    own entry (its header, ``diag[peer]``) merged in, where the exchange
    happened (``can``)."""
    rows = torch.arange(plane.shape[0], device=plane.device)
    got = torch.where(can, diag[peer], torch.zeros_like(diag[peer]))
    plane[rows, peer] = merge(plane[rows, peer], got)
    return plane


# -- one tick ------------------------------------------------------------

def _dev(x, device, dtype=torch.int64):
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def permutation(key, n: int) -> np.ndarray:
    """A random order of ``0..n-1``: as many rounds as ``3 ln n / ln
    (2**32 - 1)`` asks, each a stable sort of the order by fresh 32-bit
    draws."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    key = np.asarray(key, np.uint32)
    for _ in range(rounds):
        key, sub = draws.split(key, 2)
        x = x[np.argsort(draws.bits(sub, n), kind="stable")]
    return x


def _blocks(n: int, size: int):
    for a in range(0, n, size):
        yield a, min(a + size, n)


def block_mask(cols: torch.Tensor, phase: torch.Tensor, n: int,
               members: int) -> torch.Tensor:
    """``(rows, n)``: the members each datagram carries, ``members``
    consecutive ids from each sender's ``phase`` on, wrapping at ``n``."""
    return (cols[None, :] - phase[:, None]) % n < members


def swim_tick(plane: torch.Tensor, key, alive: torch.Tensor,
              part: torch.Tensor, round_idx: int, params: Params,
              block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """The belief plane after one tick in round ``round_idx``.

    ``plane``: ``(N, N)``, row ``i`` node ``i``'s beliefs, packed in the
    layout ``params.narrow`` names (any integer dtype that holds it);
    ``key``: the tick's threefry key, ``(2,)`` uint32; ``alive``: who is
    up; ``part``: each node's side of the network (two nodes reach each
    other when both are up and on one side)."""
    lo = NARROW if params.narrow else WIDE
    n = plane.shape[0]
    dev = plane.device
    out_dtype = plane.dtype
    alive = alive.to(device=dev, dtype=torch.bool)
    part = part.to(device=dev)
    ids = torch.arange(n, device=dev)
    rnd = round_idx & lo.since_mask

    def reach(a, b):
        return alive[a] & alive[b] & (part[a] == part[b])

    def open_to(p, who, other):
        """``who`` may talk to ``other``: both up and linked, not the
        same node, and ``who`` holds no DOWN verdict on ``other``."""
        return (reach(who, other) & (other != who)
                & (status(p[who, other], lo) < DOWN))

    k_tgt, k_ind, k_ex = draws.split(key, 3)
    p = plane.to(torch.int64).clone()

    # 1. probe
    tgt = _dev(draws.randint(k_tgt, n, 0, n), dev)
    helpers = _dev(draws.randint(k_ind, n * params.indirect_probes, 0, n),
                   dev).reshape(n, params.indirect_probes)
    cur = p[ids, tgt]
    st = status(cur, lo)
    probing = alive & (tgt != ids) & (st < DOWN)
    direct = reach(ids, tgt)
    indirect = (reach(ids[:, None], helpers)
                & reach(helpers, tgt[:, None])).any(dim=1)
    answered = probing & (direct | indirect)
    silent = probing & ~(direct | indirect)
    inc_part = (cur >> lo.inc_shift) << lo.inc_shift
    since = cur & lo.since_mask
    suspect = inc_part | (SUSPECT << lo.status_shift) | rnd
    back = inc_part | (ALIVE << lo.status_shift) | since
    new = torch.where(silent & (st == ALIVE), suspect,
                      torch.where(answered & (st == SUSPECT), back, cur))
    p[ids, tgt] = new

    # 2. timeout, block by block (elementwise)
    for a, b in _blocks(n, block_rows):
        blk = p[a:b]
        elapsed = (rnd - (blk & lo.since_mask)) & lo.since_mask
        down = ((status(blk, lo) == SUSPECT)
                & timed_out(elapsed, params.suspect_rounds)
                & alive[a:b, None])
        p[a:b] = torch.where(
            down, (blk & ~(3 << lo.status_shift)) | (DOWN << lo.status_shift),
            blk)

    # 3. exchange
    bounded = params.payload_members < n
    for g in range(params.gossip_peers):
        k_pull, k_push, k_ph1, k_ph2 = draws.split(
            draws.fold_in(k_ex, PEER_TAG + g), 4)
        peer = _dev(draws.randint(k_pull, n, 0, n), dev)
        pull_ok = alive & open_to(p, ids, peer)
        phase1 = (_dev(draws.randint(k_ph1, n, 0, n), dev) if bounded
                  else None)
        pulled = torch.empty_like(p)
        for a, b in _blocks(n, block_rows):
            resp = peer[a:b]
            take = pull_ok[a:b, None]
            if bounded:  # the responder's block
                take = take & block_mask(ids, phase1[resp], n,
                                         params.payload_members)
            pulled[a:b] = torch.where(take, merge(p[a:b], p[resp]), p[a:b])
        p = pulled
        if bounded:
            p = with_header(p, peer, pull_ok, p[ids, ids].clone())

        dst = _dev(draws.randint(k_push, n, 0, n), dev)
        push_ok = alive & open_to(p, ids, dst)
        phase2 = (_dev(draws.randint(k_ph2, n, 0, n), dev) if bounded
                  else None)
        # the senders, grouped by the node they push to
        order = torch.argsort(torch.where(push_ok, dst, n), stable=True)
        order = order[: int(push_ok.sum())]
        to = dst[order]
        pushed = p.clone()
        edges = torch.searchsorted(
            to, torch.arange(0, n + block_rows, block_rows, device=dev))
        for a, b in _blocks(n, block_rows):
            lo_i = int(edges[a // block_rows])
            hi_i = int(edges[a // block_rows + 1])
            senders, tb = order[lo_i:hi_i], to[lo_i:hi_i] - a
            if senders.numel() == 0:
                continue
            rows = p[senders]
            if bounded:
                keep = block_mask(ids, phase2[senders], n,
                                  params.payload_members)
                keep[torch.arange(senders.numel(), device=dev), senders] = True
                rows = torch.where(keep, rows, torch.zeros_like(rows))
            # the k-th sender into each node, for k = 0, 1, ...
            starts = torch.searchsorted(tb, tb, right=False)
            nth = torch.arange(tb.numel(), device=dev) - starts
            inbox = None
            for k in range(int(nth.max()) + 1):
                at = nth == k
                layer = torch.zeros((b - a, n), dtype=p.dtype, device=dev)
                layer[tb[at]] = rows[at]
                inbox = layer if inbox is None else combine_pushes(inbox,
                                                                   layer)
            got = alive[a:b, None]
            pushed[a:b] = torch.where(got, merge(p[a:b], inbox), p[a:b])
        p = pushed

    # 4. announce
    if is_announce(params, round_idx):
        perm = _dev(permutation(draws.fold_in(k_ex, ANNOUNCE_TAG), n), dev)
        inv = torch.empty_like(perm)
        inv[perm] = ids
        for partner in (perm, inv):
            ok = alive & reach(ids, partner) & (partner != ids)
            heard = torch.empty_like(p)
            for a, b in _blocks(n, block_rows):
                heard[a:b] = torch.where(ok[a:b, None],
                                         merge(p[a:b], p[partner[a:b]]),
                                         p[a:b])
            p = heard

    # 5. refute
    own = p[ids, ids]
    inc = torch.clamp((own >> lo.inc_shift) + 1, max=lo.inc_max)
    p[ids, ids] = torch.where(alive & (status(own, lo) != ALIVE),
                              inc << lo.inc_shift, own)
    return p.to(out_dtype)
