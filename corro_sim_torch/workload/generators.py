"""Production-shaped traffic generators: the synthetic-workload engine.

Port of ``corro_sim/workload/generators.py``; host numpy code, so the
schedules are byte-identical to the JAX package's for the same
``(spec, n, rounds, seed)``. Each generator compiles a traffic shape a
production corrosion cluster sees — Zipf-skewed key popularity, bursty
on/off write arrival, multi-writer contention on hot keys, and
service-discovery churn storms (register/deregister waves) — into a
**precomputed per-round write schedule**: the same arguments always
produce the same arrays, and chunk boundaries never change what a round
carries.

``run_sim(..., workload=w)`` threads the schedule through
``sim_step``'s explicit ``writes=`` port, the port replayed traces
share (:mod:`corro_sim_torch.workload.inject`).

Spec strings use the ``name[:k=v,...]`` grammar
(:mod:`corro_sim_torch.utils.spec`); ``+`` composes generators::

    zipf:alpha=1.1,rate=0.4
    burst:on=8,off=24,rate_hi=0.9
    churn_storm:waves=4,batch=8
    zipf:alpha=1.1+churn_storm:waves=2

Composition merges schedules lane-wise: the SPARSER part wins a
contended ``(round, node)`` write slot (a churn wave's register and
deregister ops must survive under a bulk Zipf background), denser parts
fill the lanes left idle — one changeset per node per round is the write
discipline the whole pipeline serializes on (agent.rs:500-731).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from corro_sim_torch.utils.spec import format_spec, parse_spec

__all__ = [
    "WORKLOADS",
    "Workload",
    "empty_slice",
    "empty_workload",
    "make_workload",
    "parse_workload_spec",
]


@dataclasses.dataclass
class Workload:
    """A compiled traffic schedule: per-round write arrays + event markers.

    ``writers[r, i]`` — node ``i`` commits a changeset in round ``r``;
    ``rows[r, i]`` — the key (row slot) it writes;
    ``cols``/``vals[r, i, c]`` — the written cells (``ncells`` live);
    ``dels[r, i]`` — the changeset is a causal-length DELETE (deregister).

    Events are sparse ``(round, kind, attrs)`` markers (burst onsets,
    churn waves).
    """

    name: str
    params: dict
    rounds: int  # rounds carrying scheduled writes (the load phase)
    n: int
    writers: np.ndarray  # (R, N) bool
    rows: np.ndarray  # (R, N) int32 key ids
    cols: np.ndarray  # (R, N, S) int32 column planes
    vals: np.ndarray  # (R, N, S) int32 cell values (identity universe)
    dels: np.ndarray  # (R, N) bool
    ncells: np.ndarray  # (R, N) int32
    events: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.events.sort(key=lambda ev: ev[0])

    @property
    def spec(self) -> str:
        return format_spec(self.name, self.params)

    @property
    def cells_width(self) -> int:
        return self.cols.shape[2]

    @property
    def total_writes(self) -> int:
        return int(self.writers.sum())

    @property
    def total_deletes(self) -> int:
        return int((self.writers & self.dels).sum())

    def key_universe(self) -> int:
        """Distinct key ids the schedule can touch (row-slot capacity the
        consuming config must provide)."""
        if not self.writers.any():
            return 1
        return int(self.rows[self.writers].max()) + 1

    def validate(self, cfg) -> "Workload":
        """Shape and bounds check against a ``SimConfig`` consumer."""
        r, n = self.writers.shape
        if n != cfg.num_nodes:
            raise ValueError(
                f"workload compiled for {n} nodes, config has "
                f"{cfg.num_nodes}")
        if self.key_universe() > cfg.num_rows:
            raise ValueError(
                f"workload touches key {self.key_universe() - 1} but "
                f"cfg.num_rows={cfg.num_rows}")
        if self.cells_width > cfg.seqs_per_version:
            raise ValueError(
                f"workload writes {self.cells_width} cells per changeset; "
                f"cfg.seqs_per_version={cfg.seqs_per_version} is too small")
        if self.writers.any():
            live_cols = self.cols[self.writers]
            if int(live_cols.max()) >= cfg.num_cols:
                raise ValueError(
                    f"workload writes column {int(live_cols.max())} but "
                    f"cfg.num_cols={cfg.num_cols}")
        return self

    def writes_at(self, r: int, s: int):
        """One round's ``sim_step`` writes tuple — zero writers past the
        schedule's end (load ends; it never repeats the final round)."""
        n = self.n
        if r >= self.rounds:
            return (
                np.zeros((n,), bool), np.zeros((n, s), np.int32),
                np.zeros((n, s), np.int32), np.zeros((n, s), np.int32),
                np.zeros((n,), bool), np.zeros((n,), np.int32),
            )
        pad = s - self.cells_width
        cols = np.pad(self.cols[r], ((0, 0), (0, pad)))
        vals = np.pad(self.vals[r], ((0, 0), (0, pad)))
        rows = np.broadcast_to(self.rows[r][:, None], (n, s))
        return (
            self.writers[r].copy(), np.ascontiguousarray(rows, np.int32),
            cols.astype(np.int32), vals.astype(np.int32),
            (self.writers[r] & self.dels[r]).copy(),
            self.ncells[r].astype(np.int32),
        )

    def slice(self, start: int, length: int, s: int):
        """Round-major ``(length, ...)`` write arrays for one chunk — the
        workload analog of :meth:`engine.driver.Schedule.slice`."""
        out = empty_slice(self.n, length, s)
        lo, hi = start, min(start + length, self.rounds)
        if lo < hi:
            k = hi - lo
            w = self.writers[lo:hi]
            out[0][:k] = w
            out[1][:k] = self.rows[lo:hi][:, :, None]  # broadcast over S
            out[2][:k, :, : self.cells_width] = self.cols[lo:hi]
            out[3][:k, :, : self.cells_width] = self.vals[lo:hi]
            out[4][:k] = w & self.dels[lo:hi]
            out[5][:k] = self.ncells[lo:hi]
        return out

    def writes_in(self, start: int, length: int) -> bool:
        """Whether rounds ``[start, start+length)`` schedule any write."""
        lo, hi = start, min(start + length, self.rounds)
        return lo < hi and bool(self.writers[lo:hi].any())

    def events_in(self, start: int, length: int) -> list:
        return [
            ev for ev in self.events if start <= ev[0] < start + length
        ]


def empty_slice(n: int, length: int, s: int) -> tuple:
    """All-idle round-major write arrays in the exact ``slice`` shape."""
    return (
        np.zeros((length, n), bool),
        np.zeros((length, n, s), np.int32),
        np.zeros((length, n, s), np.int32),
        np.zeros((length, n, s), np.int32),
        np.zeros((length, n), bool),
        np.zeros((length, n), np.int32),
    )


def _alloc(rounds: int, n: int, s: int):
    return dict(
        writers=np.zeros((rounds, n), bool),
        rows=np.zeros((rounds, n), np.int32),
        cols=np.zeros((rounds, n, s), np.int32),
        vals=np.zeros((rounds, n, s), np.int32),
        dels=np.zeros((rounds, n), bool),
        ncells=np.ones((rounds, n), np.int32),
    )


def _zipf_cdf(keys: int, alpha: float) -> np.ndarray:
    """Cumulative Zipf(alpha) key-popularity distribution over ``keys``
    ranks — the engine/state.py ``_row_cdf`` law, host-side."""
    if alpha <= 0.0:
        w = np.ones(keys, np.float64)
    else:
        w = 1.0 / np.power(np.arange(1, keys + 1, dtype=np.float64), alpha)
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    return cdf


def _sample_keys(rng, cdf: np.ndarray, shape) -> np.ndarray:
    return np.searchsorted(cdf, rng.random(shape)).astype(np.int32).clip(
        0, len(cdf) - 1
    )


def _fill_writes(a: dict, rng, mask: np.ndarray, cdf: np.ndarray,
                 values: int, delete_rate: float = 0.0) -> None:
    """Populate schedule lanes under ``mask`` with Zipf-sampled keys and
    uniform cell values (single-cell changesets, column 0)."""
    a["writers"] |= mask
    a["rows"][mask] = _sample_keys(rng, cdf, int(mask.sum()))
    a["vals"][mask, 0] = rng.integers(0, values, int(mask.sum()))
    if delete_rate > 0.0:
        a["dels"][mask] = rng.random(int(mask.sum())) < delete_rate


def zipf(n, rounds, seed, alpha: float = 1.1, rate: float = 0.5,
         keys: int = 0, values: int = 1 << 20, delete_rate: float = 0.0):
    """Zipf-skewed key popularity at a steady Bernoulli arrival rate —
    a few hot keys absorb most writes; the long tail trickles."""
    keys = int(keys) or max(16, n // 4)
    rng = np.random.default_rng(int(seed) ^ 0x21BF)
    a = _alloc(rounds, n, 1)
    cdf = _zipf_cdf(keys, float(alpha))
    mask = rng.random((rounds, n)) < float(rate)
    _fill_writes(a, rng, mask, cdf, int(values), float(delete_rate))
    # params record EVERY schedule-shaping knob: the canonical spec must
    # reproduce this exact schedule when fed back with the same seed
    return Workload(
        name="zipf",
        params={"alpha": alpha, "rate": rate, "keys": keys,
                "values": values, "delete_rate": delete_rate},
        rounds=rounds, n=n, events=[], **a,
    )


def uniform(n, rounds, seed, rate: float = 0.5, keys: int = 0,
            values: int = 1 << 20):
    """Uniform keys at a steady rate — the sampler's write phase as an
    explicit schedule."""
    w = zipf(n, rounds, seed, alpha=0.0, rate=rate, keys=keys,
             values=values)
    return dataclasses.replace(
        w, name="uniform",
        params={"rate": rate, "keys": w.params["keys"], "values": values},
    )


def burst(n, rounds, seed, on: int = 4, off: int = 12,
          rate_hi: float = 0.9, rate_lo: float = 0.05,
          alpha: float = 0.0, keys: int = 0, values: int = 1 << 20):
    """Bursty on/off arrival: the cluster idles at ``rate_lo`` then slams
    to ``rate_hi`` for bursts on a seeded on/off Markov alternation (mean
    sojourns ``on``/``off`` rounds). Burst onsets are events."""
    keys = int(keys) or max(16, n // 4)
    rng = np.random.default_rng(int(seed) ^ 0x8057)
    a = _alloc(rounds, n, 1)
    cdf = _zipf_cdf(keys, float(alpha))
    on_p = 1.0 / max(float(off), 1.0)  # P(off -> on) per round
    off_p = 1.0 / max(float(on), 1.0)  # P(on -> off) per round
    state_on = False
    events = []
    rate_rounds = np.empty(rounds, np.float64)
    for r in range(rounds):
        if state_on and rng.random() < off_p:
            state_on = False
            events.append((r, "burst_off", {}))
        elif not state_on and rng.random() < on_p:
            state_on = True
            events.append((r, "burst_on", {"phase": "burst"}))
        rate_rounds[r] = float(rate_hi) if state_on else float(rate_lo)
    mask = rng.random((rounds, n)) < rate_rounds[:, None]
    _fill_writes(a, rng, mask, cdf, int(values))
    return Workload(
        name="burst",
        params={"on": on, "off": off, "rate_hi": rate_hi,
                "rate_lo": rate_lo, "alpha": alpha, "keys": keys,
                "values": values},
        rounds=rounds, n=n, events=events, **a,
    )


def multiwriter(n, rounds, seed, hot: int = 4, rate: float = 0.7,
                writers: int = 0, values: int = 1 << 20):
    """Multi-writer contention: ``writers`` nodes (default: all) hammer
    the same ``hot`` keys — the pure CRDT-conflict regime."""
    hot = max(1, int(hot))
    writers_n = int(writers) or n
    rng = np.random.default_rng(int(seed) ^ 0x3417)
    a = _alloc(rounds, n, 1)
    mask = np.zeros((rounds, n), bool)
    mask[:, :writers_n] = rng.random((rounds, writers_n)) < float(rate)
    a["writers"] |= mask
    a["rows"][mask] = rng.integers(0, hot, int(mask.sum()))
    a["vals"][mask, 0] = rng.integers(0, values, int(mask.sum()))
    return Workload(
        name="multiwriter",
        params={"hot": hot, "rate": rate, "writers": writers_n,
                "values": values},
        rounds=rounds, n=n, events=[], **a,
    )


def churn_storm(n, rounds, seed, waves: int = 4, batch: int = 0,
                keys: int = 0, gap: int = 0, values: int = 1 << 20):
    """Service-discovery churn storms: every ``gap`` rounds a wave
    deregisters (causal-length DELETE) a batch of live service keys and
    registers a fresh batch, spread over the nodes. Between waves a
    background trickle re-touches live keys (health-check refresh)."""
    keys = int(keys) or max(16, n // 2)
    batch = int(batch) or max(1, keys // 8)
    waves = max(1, int(waves))
    gap = int(gap) or max(2, rounds // (waves + 1))
    rng = np.random.default_rng(int(seed) ^ 0xC402)
    a = _alloc(rounds, n, 1)
    events = []
    live = list(range(min(batch, keys)))  # seed registrations land wave 0
    next_key = len(live)
    for w in range(waves):
        r0 = (w + 1) * gap - gap // 2 if w == 0 else w * gap + gap // 2
        r0 = min(max(r0, 0), rounds - 1)
        # one wave = deregister `batch` live keys + register `batch` new
        # ones, each op one changeset on a rotating writer node; ops pack
        # into consecutive rounds at one-write-per-node-per-round
        ops = []
        dereg = [
            live.pop(int(rng.integers(0, len(live))))
            for _ in range(min(batch, max(len(live) - 1, 0)))
        ]
        ops += [(k, True) for k in dereg]
        for _ in range(batch):
            k = next_key % keys
            next_key += 1
            if k not in live:
                live.append(k)
            ops.append((k, False))
        ops = [ops[i] for i in rng.permutation(len(ops))]
        r, node = r0, int(rng.integers(0, n))
        placed = 0
        for k, is_del in ops:
            # next free (round, node) lane at/after the wave onset
            tries = 0
            while r < rounds and a["writers"][r, node]:
                node = (node + 1) % n
                tries += 1
                if tries >= n:
                    r, tries = r + 1, 0
            if r >= rounds:
                break
            a["writers"][r, node] = True
            a["rows"][r, node] = k
            a["dels"][r, node] = is_del
            a["vals"][r, node, 0] = int(rng.integers(0, values))
            placed += 1
            node = (node + 1) % n
        events.append(
            (r0, "churn_wave", {"wave": w, "ops": placed,
                                "phase": "storm"})
        )
    # background refresh trickle on live keys between waves
    trickle = rng.random((rounds, n)) < 0.02
    trickle &= ~a["writers"]
    if live:
        live_arr = np.asarray(sorted(live), np.int32)
        a["writers"] |= trickle
        a["rows"][trickle] = live_arr[
            rng.integers(0, len(live_arr), int(trickle.sum()))
        ]
        a["vals"][trickle, 0] = rng.integers(0, values, int(trickle.sum()))
    return Workload(
        name="churn_storm",
        params={"waves": waves, "batch": batch, "keys": keys, "gap": gap,
                "values": values},
        rounds=rounds, n=n, events=events, **a,
    )


def empty_workload(n: int, rounds: int = 8) -> Workload:
    """An all-idle schedule: fed through the writes port it must be
    bit-identical to the sampler with writes disabled."""
    return Workload(
        name="empty", params={}, rounds=rounds, n=n,
        **_alloc(rounds, n, 1),
    )


WORKLOADS = {
    "zipf": zipf,
    "uniform": uniform,
    "burst": burst,
    "multiwriter": multiwriter,
    "churn_storm": churn_storm,
}


def parse_workload_spec(spec: str) -> list[tuple[str, dict]]:
    """``name[:k=v,...][+name2[:...]]`` → ordered (name, params) parts,
    each validated against the workload table."""
    parts = []
    for piece in spec.split("+"):
        name, params = parse_spec(piece)
        if name not in WORKLOADS:
            raise ValueError(
                f"unknown workload {name!r} "
                f"(have: {', '.join(sorted(WORKLOADS))})"
            )
        parts.append((name, params))
    return parts


def _merge(parts: list[Workload]) -> Workload:
    """Lane-wise composition: sparse parts win contended (round, node)
    slots and denser parts fill the lanes left idle. Deterministic: fill
    order is ascending scheduled-write count, ties in spec order."""
    base = parts[0]
    s = max(p.cells_width for p in parts)
    rounds = max(p.rounds for p in parts)
    n = base.n
    a = _alloc(rounds, n, s)
    a["ncells"][:] = 1
    events: list = []
    fill_order = sorted(
        range(len(parts)), key=lambda i: (parts[i].total_writes, i)
    )
    for i in fill_order:
        p = parts[i]
        free = ~a["writers"][: p.rounds]
        take = p.writers & free
        a["writers"][: p.rounds] |= take
        a["rows"][: p.rounds][take] = p.rows[take]
        a["cols"][: p.rounds, :, : p.cells_width][take] = p.cols[take]
        a["vals"][: p.rounds, :, : p.cells_width][take] = p.vals[take]
        a["dels"][: p.rounds][take] = p.dels[take]
        a["ncells"][: p.rounds][take] = p.ncells[take]
        events.extend(p.events)
    return Workload(
        name="+".join(p.name for p in parts),
        params={}, rounds=rounds, n=n, events=events, **a,
    )


def make_workload(
    spec: str,
    n: int,
    rounds: int = 16,
    seed: int = 0,
) -> Workload:
    """Compile a (possibly composed) spec for an ``n``-node cluster's
    ``rounds``-round load phase."""
    compiled = [
        WORKLOADS[name](n, rounds, seed + i, **params)
        for i, (name, params) in enumerate(parse_workload_spec(spec))
    ]
    if len(compiled) == 1:
        return compiled[0]
    merged = _merge(compiled)
    # the composed spec round-trips as the join of the parts' canonical
    # specs (params live inside each part, not on the composite)
    merged.name = "+".join(p.spec for p in compiled)
    merged.params = {}
    return merged
