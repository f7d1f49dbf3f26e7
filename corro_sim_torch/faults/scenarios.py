"""Named failure scenarios: seeded generators compiling into vectorized
``Schedule`` arrays + fault-config overrides.

Port of ``corro_sim/faults/scenarios.py``: the same catalog in host
numpy, with the same seeds, so a spec compiles to the same arrays, knobs
and events on both sides; :meth:`Scenario.schedule` returns the port's
:class:`~corro_sim_torch.engine.driver.Schedule`.

A scenario is the reproducible form of a chaos experiment: the same
``(name, params, n, rounds, seed)`` always produces the same
``(rounds, n)`` alive/partition arrays, the same fault knobs and the
same event markers. The scheduled timeline is indexed by absolute
round, so the rows a chunked driver sees are independent of chunk
boundaries; the *stochastic* knobs
(loss/dup/burst draws) replay exactly under the same run seed and
chunking, like every other random stream in the simulation.

Spec strings are ``name[:k=v,...]``::

    lossy:p=0.1
    rolling_restart:batch=4,down=8
    split_brain_heal:at=8,heal=40
    churn:rate=0.05
    blackhole_one_way:src=0

Event tuples are ``(round, kind, attrs)``; an attrs ``phase="heal"``
marks the moment the last scheduled fault clears — the soak harness
measures recovery time (rounds from heal to re-convergence) from the
latest such event.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from corro_sim_torch.config import SimConfig
from corro_sim_torch.utils.spec import format_spec, parse_spec

__all__ = [
    "SCENARIOS",
    "Scenario",
    "make_scenario",
    "parse_scenario_spec",
    "ring_blackhole",
    "star_blackhole",
]


@dataclasses.dataclass
class Scenario:
    """A compiled failure scenario: schedule arrays + fault overrides."""

    name: str
    params: dict
    rounds: int
    write_rounds: int
    faults: dict  # FaultConfig field overrides
    alive: np.ndarray | None = None  # (rounds, n) bool
    part: np.ndarray | None = None  # (rounds, n) int32
    events: list = dataclasses.field(default_factory=list)
    node_faults: dict = dataclasses.field(default_factory=dict)
    # NodeFaultConfig field overrides (faults/nodes.py): crash/stale
    # wipe schedules, skew planes, straggler duty cycles

    def __post_init__(self):
        # round-sorted invariant: event cursors and the flight-record
        # reader assume chronological order (wave
        # generators emit kill/rejoin interleaved)
        self.events.sort(key=lambda ev: ev[0])

    def schedule(self):
        """The vectorized :class:`corro_sim_torch.engine.driver.Schedule`."""
        from corro_sim_torch.engine.driver import Schedule

        return Schedule(
            write_rounds=self.write_rounds,
            alive=self.alive,
            part=self.part,
            events=list(self.events),
            name=self.spec,
        )

    def apply(self, cfg: SimConfig) -> SimConfig:
        """``cfg`` with this scenario's fault knobs merged in — the
        link-level FaultConfig overrides and the node-level
        NodeFaultConfig ones alike."""
        if not self.faults and not self.node_faults:
            return cfg
        kw = {}
        if self.faults:
            kw["faults"] = dataclasses.replace(cfg.faults, **self.faults)
        if self.node_faults:
            kw["node_faults"] = dataclasses.replace(
                cfg.node_faults, **self.node_faults
            )
        return dataclasses.replace(cfg, **kw).validate()

    def fault_window(self) -> tuple[int, int] | None:
        """The ``[first, last]`` round range this scenario's faults are
        actually in effect — from the event timeline when present, else
        the whole run for always-on fault knobs (loss, skew, duty
        cycles). Bookkeeping events that happen on a HEALTHY cluster
        (the stale-rejoin snapshot capture) do not open the window — a
        window starting there would grade fault-free rounds as faulted.
        None only for a scenario with neither events nor overrides."""
        onsets = [ev for ev in self.events if ev[1] != "snapshot"]
        if onsets:
            return (
                int(min(ev[0] for ev in onsets)),
                int(self.heal_round
                    if self.heal_round is not None
                    else max(ev[0] for ev in onsets)),
            )
        if self.faults or self.node_faults:
            return (0, self.rounds - 1)
        return None

    def check_workload(self, workload) -> None:
        """The coupled-spec validation (`run/soak --scenario X
        --workload Y`): the fault window and the workload's write range
        must OVERLAP, or the run is two experiments glued end to end —
        latency-under-load numbers during the fault window would be
        measured against zero traffic (SWARM's
        replication-latency-under-load story needs both at once). ONE
        error message, raised at spec time, not after minutes of
        compile."""
        w = np.asarray(workload.writers)
        if not w.any():
            lo_w, hi_w = 0, -1
        else:
            rows = np.nonzero(w.any(axis=1))[0]
            lo_w, hi_w = int(rows[0]), int(rows[-1])
        fw = self.fault_window()
        if fw is None or (lo_w <= fw[1] and hi_w >= fw[0]):
            return
        raise ValueError(
            f"scenario {self.spec!r} schedules its faults in rounds "
            f"[{fw[0]}, {fw[1]}] but workload {workload.spec!r} writes "
            f"only in rounds [{lo_w}, {hi_w}] — the ranges never "
            "overlap, so no fault would ever land under load; extend "
            "the workload's --write-rounds/rounds or move the "
            "scenario's fault window"
        )

    @property
    def spec(self) -> str:
        return format_spec(self.name, self.params)

    @property
    def heal_round(self) -> int | None:
        heals = [r for r, _, attrs in self.events
                 if attrs.get("phase") == "heal"]
        return max(heals) if heals else None


def _base(n: int, rounds: int) -> tuple[np.ndarray, np.ndarray]:
    return np.ones((rounds, n), bool), np.zeros((rounds, n), np.int32)


def lossy(n, rounds, write_rounds, seed, p: float = 0.1):
    """Uniform stochastic link loss for the whole run — the baseline
    chaos every gossip-theory convergence guarantee is stated under."""
    return Scenario(
        name="lossy", params={"p": p}, rounds=rounds,
        write_rounds=write_rounds, faults={"loss": float(p)},
    )


def duplicating(n, rounds, write_rounds, seed, p: float = 0.1,
                dup: float = 0.2):
    """Lossy AND duplicating links (UDP's full failure menu)."""
    return Scenario(
        name="duplicating", params={"p": p, "dup": dup}, rounds=rounds,
        write_rounds=write_rounds,
        faults={"loss": float(p), "dup": float(dup)},
    )


def burst(n, rounds, write_rounds, seed, enter: float = 0.05,
          exit: float = 0.3, loss: float = 1.0):
    """Gilbert burst loss: node receive paths flip into a high-loss
    state and back (the flaky-NIC / congested-uplink pattern)."""
    return Scenario(
        name="burst",
        params={"enter": enter, "exit": exit, "loss": loss},
        rounds=rounds, write_rounds=write_rounds,
        faults={
            "burst_enter": float(enter), "burst_exit": float(exit),
            "burst_loss": float(loss),
        },
    )


def blackhole_one_way(n, rounds, write_rounds, seed, src: int = 0):
    """Node ``src`` transmits into a void but still receives — the
    asymmetric-partition failure SWIM's indirect probes exist for."""
    return Scenario(
        name="blackhole_one_way", params={"src": int(src)}, rounds=rounds,
        write_rounds=write_rounds,
        faults={"blackhole": ((int(src), -1),)},
    )


def rolling_restart(n, rounds, write_rounds, seed, batch: int = 0,
                    down: int = 6, stagger: int = 0, start: int = 2):
    """Restart every node once, in staggered batches — the deploy-wave
    scenario. ``batch`` nodes go down per wave (default: ~n/8), each wave
    ``stagger`` rounds after the previous (default: down//2, so waves
    overlap like a real rolling deploy), each node down ``down`` rounds.
    """
    batch = int(batch) or max(1, n // 8)
    stagger = int(stagger) or max(1, int(down) // 2)
    down = int(down)
    alive, part = _base(n, rounds)
    events = []
    waves = (n + batch - 1) // batch
    last_up = 0
    for w in range(waves):
        lo, hi = w * batch, min((w + 1) * batch, n)
        t0 = int(start) + w * stagger
        t1 = t0 + down
        if t0 >= rounds:
            break
        alive[t0:min(t1, rounds), lo:hi] = False
        events.append((t0, "kill", {"nodes": [lo, hi], "wave": w}))
        if t1 < rounds:
            events.append((t1, "rejoin", {"nodes": [lo, hi], "wave": w}))
        last_up = max(last_up, min(t1, rounds - 1))
    if events:
        events.append((last_up, "heal", {"phase": "heal"}))
    return Scenario(
        name="rolling_restart",
        params={"batch": batch, "down": down, "stagger": stagger},
        rounds=rounds, write_rounds=write_rounds, faults={},
        alive=alive, part=part, events=events,
    )


def flapper(n, rounds, write_rounds, seed, frac: float = 0.1,
            period: int = 4, until: int = 0):
    """A fraction of nodes flap down/up on a fixed period until round
    ``until`` (default: half the run), then stay up — the crash-looping
    agent that SWIM must keep re-admitting."""
    until = int(until) or rounds // 2
    k = max(1, int(round(n * float(frac))))
    period = max(1, int(period))
    alive, part = _base(n, rounds)
    r = np.arange(rounds)
    flap_down = ((r // period) % 2 == 1) & (r < until)
    alive[:, :k] = ~flap_down[:, None]
    events = [
        (0, "flap_start", {"nodes": [0, k], "period": period}),
        (min(until, rounds - 1), "heal", {"phase": "heal"}),
    ]
    return Scenario(
        name="flapper",
        params={"frac": frac, "period": period, "until": until},
        rounds=rounds, write_rounds=write_rounds, faults={},
        alive=alive, part=part, events=events,
    )


def split_brain_heal(n, rounds, write_rounds, seed, at: int = -1,
                     heal: int = -1, parts: int = 2):
    """Partition the cluster into ``parts`` contiguous islands at round
    ``at`` (default: mid-write-phase; 0 = split from the very first
    round), heal at ``heal`` (default: half the run) — convergence then
    requires anti-entropy to merge the divergent islands' histories."""
    at = int(at) if int(at) >= 0 else max(1, write_rounds // 2)
    heal = int(heal) if int(heal) > at else max(at + 1, rounds // 2)
    parts = max(2, int(parts))
    alive, part = _base(n, rounds)
    island = (np.arange(n) * parts // n).astype(np.int32)
    part[at:heal] = island[None, :]
    events = [
        (at, "split", {"parts": parts}),
        (min(heal, rounds - 1), "heal", {"phase": "heal", "parts": parts}),
    ]
    return Scenario(
        name="split_brain_heal",
        params={"at": at, "heal": heal, "parts": parts},
        rounds=rounds, write_rounds=write_rounds, faults={},
        alive=alive, part=part, events=events,
    )


def churn(n, rounds, write_rounds, seed, rate: float = 0.02,
          down: int = 6, until: int = 0):
    """Memoryless churn: every up node crashes with probability ``rate``
    per round and stays down ``down`` rounds, until round ``until``
    (default: half the run) — the background failure hum of a large
    fleet. Seeded: the same (n, rounds, seed) always crashes the same
    nodes at the same rounds."""
    until = int(until) or rounds // 2
    down = int(down)
    rng = np.random.default_rng(int(seed) ^ 0xC0FF)
    alive, part = _base(n, rounds)
    down_until = np.zeros(n, np.int64)  # round each node revives
    events = []
    kills = 0
    for r in range(min(until, rounds)):
        up = down_until <= r
        crash = up & (rng.random(n) < float(rate))
        if crash.any():
            down_until[crash] = r + down
            kills += int(crash.sum())
            events.append(
                (r, "kill", {"nodes": np.nonzero(crash)[0].tolist()})
            )
        alive[r] = down_until <= r
    # after `until`, everyone is forced back up (the heal edge); nodes
    # still serving a down window revive there
    last_down = int(min(max(down_until.max(), until), rounds - 1))
    for r in range(until, rounds):
        alive[r] = down_until <= r
    alive[last_down:] = True
    events.append((last_down, "heal", {"phase": "heal", "kills": kills}))
    return Scenario(
        name="churn",
        params={"rate": rate, "down": down, "until": until},
        rounds=rounds, write_rounds=write_rounds, faults={},
        alive=alive, part=part, events=events,
    )


# ------------------------------------------------ node-lifecycle scenarios
# (faults/nodes.py): the agent-level failure catalog — state
# loss, stale restores, clock skew, stragglers — compiled into the same
# (alive schedule + config override + event) shape as the link catalog.


def _pick_nodes(n: int, count: int, seed: int, tag: int) -> list[int]:
    rng = np.random.default_rng(int(seed) ^ tag)
    return sorted(
        int(v) for v in rng.choice(n, size=min(int(count), n),
                                   replace=False)
    )


def crash_amnesia(n, rounds, write_rounds, seed, nodes: int = 3,
                  at: int = -1, down: int = 4, jump: int = 0):
    """Corrosion's production failure mode: ``nodes`` agents crash at
    round ``at`` (default mid-write-phase), stay down ``down`` rounds,
    and restart with an EMPTY database — table, bookkeeping, gossip
    rings, SWIM membership all wiped at the rejoin round
    (faults/nodes.py). They rejoin with an epoch-bumped HLC (+ ``jump``
    per restart) and must full-resync via anti-entropy; the scorecard's
    rows_lost==0 / recovery_rounds numbers are this scenario's whole
    point."""
    at = int(at) if int(at) >= 0 else max(2, write_rounds // 2)
    down = max(1, int(down))
    rejoin = min(at + down, rounds - 1)
    victims = _pick_nodes(n, nodes, seed, 0xA3E1)
    alive, part = _base(n, rounds)
    alive[at:rejoin, victims] = False
    events = [
        (at, "kill", {"nodes": victims, "fault": "crash_amnesia"}),
        (rejoin, "rejoin", {"nodes": victims, "amnesia": True}),
        (rejoin, "heal", {"phase": "heal"}),
    ]
    return Scenario(
        name="crash_amnesia",
        params={"nodes": int(nodes), "at": at, "down": down,
                "jump": int(jump)},
        rounds=rounds, write_rounds=write_rounds, faults={},
        alive=alive, part=part, events=events,
        node_faults={
            "crash": tuple((v, rejoin) for v in victims),
            "epoch_jump": int(jump),
        },
    )


def stale_rejoin(n, rounds, write_rounds, seed, nodes: int = 2,
                 snap: int = -1, at: int = -1, down: int = 4):
    """Restart from an old backup: the victims' row state is snapshotted
    at round ``snap`` (default: a quarter into the write phase), they
    crash at ``at`` and rejoin restored FROM THE SNAPSHOT instead of
    empty — anti-entropy repays only the delta (the scorecard's
    resync_rows)."""
    snap = int(snap) if int(snap) >= 0 else max(1, write_rounds // 4)
    at = int(at) if int(at) >= 0 else max(snap + 1, write_rounds // 2)
    down = max(1, int(down))
    rejoin = min(at + down, rounds - 1)
    victims = _pick_nodes(n, nodes, seed, 0x57A1)
    alive, part = _base(n, rounds)
    alive[at:rejoin, victims] = False
    events = [
        (snap, "snapshot", {"nodes": victims}),
        (at, "kill", {"nodes": victims, "fault": "stale_rejoin"}),
        (rejoin, "rejoin", {"nodes": victims, "snapshot_round": snap}),
        (rejoin, "heal", {"phase": "heal"}),
    ]
    return Scenario(
        name="stale_rejoin",
        params={"nodes": int(nodes), "snap": snap, "at": at,
                "down": down},
        rounds=rounds, write_rounds=write_rounds, faults={},
        alive=alive, part=part, events=events,
        node_faults={
            "stale": tuple((v, snap, rejoin) for v in victims),
        },
    )


def clock_skew(n, rounds, write_rounds, seed, nodes: int = 0,
               max_skew: int = 64):
    """Per-node HLC wall-clock offsets (default: a quarter of the
    cluster, seeded offsets up to ``max_skew`` rounds fast or slow) —
    the NTP-drift study: LWW tie-breaks and EmptySet-ts gating must
    stay convergent when some nodes mint timestamps from the future.
    No outage: the heal marker sits at the write-phase end so recovery
    measures the skewed tail."""
    count = int(nodes) or max(1, n // 4)
    victims = _pick_nodes(n, count, seed, 0xC10C)
    rng = np.random.default_rng(int(seed) ^ 0x5CE3)
    offs = rng.integers(1, max(int(max_skew), 2), size=len(victims))
    signs = rng.choice((-1, 1), size=len(victims))
    skew = tuple(
        (v, int(o * s)) for v, o, s in zip(victims, offs, signs)
    )
    events = [
        (0, "skew", {"nodes": victims}),
        (max(write_rounds - 1, 0), "heal", {"phase": "heal"}),
    ]
    return Scenario(
        name="clock_skew",
        params={"nodes": count, "max_skew": int(max_skew)},
        rounds=rounds, write_rounds=write_rounds, faults={},
        events=events, node_faults={"skew": skew},
    )


def stragglers(n, rounds, write_rounds, seed, frac: float = 0.1,
               period: int = 8, active: int = 2):
    """A fraction of nodes run slow: they emit broadcasts and initiate
    sync sweeps only ``active`` of every ``period`` duty rounds
    (faults/nodes.py — they still receive, answer SWIM probes, serve
    inbound sync and commit local writes). The convergence tail
    stretches to the stragglers' cadence; the heal marker sits at the
    write-phase end so recovery measures that stretch."""
    k = max(1, int(round(n * float(frac))))
    victims = _pick_nodes(n, k, seed, 0x57AA)
    events = [
        (0, "straggle", {"nodes": victims, "period": int(period),
                         "active": int(active)}),
        (max(write_rounds - 1, 0), "heal", {"phase": "heal"}),
    ]
    return Scenario(
        name="stragglers",
        params={"frac": frac, "period": int(period),
                "active": int(active)},
        rounds=rounds, write_rounds=write_rounds, faults={},
        events=events,
        node_faults={
            "straggle": tuple(
                (v, int(period), int(active)) for v in victims
            ),
        },
    )


# ----------------------------------------------------- topology constraints
def _allow_only(n: int, allowed: np.ndarray) -> tuple:
    """Blackhole pairs blocking every directed edge NOT in ``allowed``
    ((N, N) bool). Self-edges are irrelevant (never delivered).

    O(N^2) pairs by construction — topology studies are meant for
    modest clusters (the soak default sweep excludes them); the
    validate/mask consumers are vectorized so even a large list only
    costs memory, not Python-loop time."""
    allowed = allowed | np.eye(n, dtype=bool)
    blocked = np.argwhere(~allowed)
    return tuple(map(tuple, blocked.tolist()))


def ring_blackhole(n: int) -> tuple:
    """Blackhole mask constraining gossip to a bidirectional ring —
    node i can only reach i±1 (mod n), realized in the transport layer."""
    allowed = np.zeros((n, n), bool)
    i = np.arange(n)
    allowed[i, (i + 1) % n] = True
    allowed[i, (i - 1) % n] = True
    return _allow_only(n, allowed)


def star_blackhole(n: int, hub: int = 0) -> tuple:
    """Blackhole mask constraining gossip to a star around ``hub``."""
    allowed = np.zeros((n, n), bool)
    allowed[hub, :] = True
    allowed[:, hub] = True
    return _allow_only(n, allowed)


def ring(n, rounds, write_rounds, seed, p: float = 0.0):
    """Gossip constrained to a ring topology via blackhole masks (+
    optional loss) — the worst-diameter graph gossip bounds quote."""
    return Scenario(
        name="ring", params={"p": p}, rounds=rounds,
        write_rounds=write_rounds,
        faults={"blackhole": ring_blackhole(n), "loss": float(p)},
    )


def star(n, rounds, write_rounds, seed, hub: int = 0, p: float = 0.0):
    """Gossip constrained to a star topology via blackhole masks."""
    return Scenario(
        name="star", params={"hub": hub, "p": p}, rounds=rounds,
        write_rounds=write_rounds,
        faults={
            "blackhole": star_blackhole(n, int(hub)), "loss": float(p),
        },
    )


SCENARIOS = {
    "lossy": lossy,
    "duplicating": duplicating,
    "burst": burst,
    "blackhole_one_way": blackhole_one_way,
    "rolling_restart": rolling_restart,
    "flapper": flapper,
    "split_brain_heal": split_brain_heal,
    "churn": churn,
    "ring": ring,
    "star": star,
    "crash_amnesia": crash_amnesia,
    "stale_rejoin": stale_rejoin,
    "clock_skew": clock_skew,
    "stragglers": stragglers,
}

# The soak sweep's default set: scenarios whose faults clear (or are
# survivable) so re-convergence is the pass criterion. Excluded by
# design: blackhole_one_way (the hole never heals — an availability
# study, not a recovery one) and ring/star (topology-constrained
# studies whose convergence time grows with the graph diameter).
SOAK_DEFAULT = (
    "lossy", "duplicating", "burst", "rolling_restart", "flapper",
    "split_brain_heal", "churn",
    "crash_amnesia", "stale_rejoin", "clock_skew", "stragglers",
)


def parse_scenario_spec(spec: str) -> tuple[str, dict]:
    """``name[:k=v,...]`` → (name, params) — the shared grammar
    (:mod:`corro_sim_torch.utils.spec`) validated against the scenario
    table."""
    name, params = parse_spec(spec)
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r} (have: {', '.join(sorted(SCENARIOS))})"
        )
    return name, params


def make_scenario(
    spec: str,
    n: int,
    rounds: int = 256,
    write_rounds: int = 16,
    seed: int = 0,
) -> Scenario:
    """Compile a ``name[:k=v,...]`` spec for an ``n``-node cluster."""
    name, params = parse_scenario_spec(spec)
    return SCENARIOS[name](n, rounds, write_rounds, seed, **params)
