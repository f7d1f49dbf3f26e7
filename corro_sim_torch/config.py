"""Simulation configuration — the PyTorch port's own copy of the JAX
package's ``config.py``, field for field.

The port imports nothing of the JAX package, so it carries this copy
instead; keeping every field name identical lets a caller (and the
parity tests) build one side's config from ``dataclasses.asdict`` of the
other's. The docs on each field describe the JAX package's program;
:func:`validate_torch_slice` at the bottom says which of them the port
runs so far.

The reference loads a TOML ``Config{db, api, gossip, perf, ...}`` with
env-var overrides (``corro-types/src/config.rs:44-62,284-291``) whose
``PerfConfig`` exposes every channel capacity and queue threshold
(``config.rs:168-215``). Here the same role is played by :class:`SimConfig`:
every buffer size, fanout, cadence and cap is a static field (cluster
size, fanout and buffer caps are fixed per run, churn changes membership
*state*, not shapes).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Chaos-injection knobs (corro_sim/faults/): stochastic link faults
    applied on-device at the two transport points of ``engine/step.py`` —
    the broadcast emission/delivery split and the anti-entropy lane grant
    — exactly where the reference's UDP datagrams and QUIC sync streams
    would fail. Static like everything else on :class:`SimConfig`: with
    every knob at its default (``enabled`` False) the step program traces
    ZERO extra ops and is bit-identical to the fault-free one
    (tests/test_faults.py guards this, the ``cfg.probes`` discipline).

    The fault surface is the DATA plane (gossip chunks + sync grants).
    SWIM probe traffic is modeled as control-plane and not fault-gated —
    membership false positives come from the *schedule* (nodes actually
    down / partitioned), not from datagram loss, so the SWIM false-DOWN
    invariant (faults/invariants.py) stays checkable under any fault mix.
    """

    loss: float = 0.0  # P(a deliverable gossip chunk is dropped) — the
    # per-link Bernoulli UDP-loss analog, applied at DELIVERY time so it
    # hits eager ring-0 sends, random gossip and matured in-flight lanes
    # alike (reference transport would drop on the wire the same way)
    dup: float = 0.0  # P(a delivered chunk arrives twice). The second
    # copy is accounted (fault_dup metric, conservation checker) but not
    # re-merged: every merge path is idempotent per (dst, actor, ver,
    # chunk), so a duplicate datagram's only real-world effect here is
    # wasted accounting — the same reason the reference tolerates UDP
    # duplication without a dedupe layer.
    burst_enter: float = 0.0  # Gilbert burst-loss Markov knob: P(a node's
    # receive path enters the burst state) per round. 0 disables the
    # burst machinery entirely (no state, no draws).
    burst_exit: float = 0.5  # P(leaving the burst state) per round
    burst_loss: float = 1.0  # loss probability while in the burst state
    # (applied as max(loss, burst_loss) on the victim's incoming links)
    sync_loss: float | None = None  # P(an admitted sync connection drops
    # before serving) — the QUIC stream-failure analog, applied at the
    # lane grant in sync/sync.py. None = same as ``loss``.
    blackhole: tuple = ()  # asymmetric blackhole masks: directed
    # (src, dst) node pairs whose messages silently vanish; -1 is a
    # wildcard (``(3, -1)`` = everything node 3 sends is dropped while it
    # still receives — the one-way-partition failure gossip must survive).
    # Also constrains sync (a grant over a blackholed edge fails).
    trace_vacuous: bool = False  # force the fault program to TRACE with
    # every knob at zero effect — the non-perturbation guard's lever
    # (tests/test_faults.py): the injection points themselves must not
    # change state, metrics or key derivation.

    @property
    def enabled(self) -> bool:
        """Static gate: False traces zero fault ops (the cfg.probes
        discipline)."""
        return bool(
            self.loss > 0.0
            or self.dup > 0.0
            or self.burst_enter > 0.0
            or self.blackhole
            or self.trace_vacuous
        )

    @property
    def burst_on(self) -> bool:
        """Static burst-machinery gate. The inject kernels branch on
        THIS (never on ``burst_enter`` numerically), so a sweep can
        substitute per-lane traced thresholds behind the same gate
        (corro_sim/sweep/: ``burst_on`` is a static bool on the lane
        knob object too)."""
        return self.burst_enter > 0.0

    @property
    def resolved_sync_loss(self) -> float:
        return self.loss if self.sync_loss is None else self.sync_loss

    def validate(self, num_nodes: int) -> "FaultConfig":
        for name in ("loss", "dup", "burst_enter", "burst_exit",
                     "burst_loss"):
            v = getattr(self, name)
            assert 0.0 <= v <= 1.0, f"faults.{name} must be in [0, 1]"
        if self.sync_loss is not None:
            assert 0.0 <= self.sync_loss <= 1.0, (
                "faults.sync_loss must be in [0, 1]"
            )
        if self.blackhole:
            # vectorized: topology scenarios carry O(N^2) pairs
            import numpy as _np

            pairs = _np.asarray(self.blackhole, dtype=_np.int64)
            assert pairs.ndim == 2 and pairs.shape[1] == 2, (
                "blackhole entries are (src, dst) pairs"
            )
            assert ((pairs >= -1) & (pairs < num_nodes)).all(), (
                f"blackhole pairs out of range for {num_nodes} nodes"
            )
        return self


@dataclasses.dataclass(frozen=True)
class NodeFaultConfig:
    """Node-lifecycle fault knobs (corro_sim/faults/nodes.py): crashes
    that lose state, restarts from stale snapshots, per-node clock skew
    and stragglers — the *agent*-level failure modes, where
    :class:`FaultConfig` above models the *link*-level ones. Corrosion's
    production failure mode is exactly this: an agent restarts with an
    empty or stale SQLite DB and must full-resync via anti-entropy
    (PAPER.md §survey). Everything is a static schedule over the round
    counter, so both step programs (full and repair-specialized) derive
    identical masks from ``state.round`` with ZERO new random draws —
    the repair-program equivalence the driver's post-quiesce switch
    depends on. Disabled (the default) traces zero extra ops and
    contributes zero SimState leaves (the ``engine/features.py``
    registry: ``node_epoch``/``node_snapshot`` appear only for enabling
    configs, so every non-enabling config's pytree/jaxpr/cache keys stay
    byte-identical).

    Amnesia recoverability bound: a wiped node full-resyncs from the
    change log, which is a ring of ``log_capacity`` versions per actor —
    if any actor has written more than that when the wipe lands, the
    ring-wrap tripwire fires and the run is POISONED. That is correct
    physics, not a bug: history evicted from every surviving replica is
    unrecoverable (doc/fault_injection.md §node faults).
    """

    crash: tuple = ()  # (node, round) pairs — crash-restart with
    # AMNESIA: at the start of `round` the node's replica state (table
    # rows, bookkeeping row, gossip rings, SWIM beliefs, HLC) is wiped
    # to the empty-DB state and the node rejoins with an epoch-bumped
    # HLC + SWIM incarnation; anti-entropy must full-resync it. The
    # global change log survives (peers hold the actor's history — the
    # reference's surviving replicas serve a rejoining node its own
    # rows back). Schedule the wipe round at the node's scheduled
    # *rejoin* (scenarios.crash_amnesia pairs it with a down window).
    stale: tuple = ()  # (node, snap_round, round) triples — STALE
    # REJOIN: at `snap_round` the node's (table, bookkeeping) rows are
    # captured into the ``node_snapshot`` feature leaf; at `round` the
    # wipe restores FROM that snapshot instead of zero (restart from an
    # old backup), and sync repays only the delta (resync_rows).
    skew: tuple = ()  # (node, offset) pairs — per-node wall-clock
    # offset plane perturbing HLC timestamp generation (the physical
    # floor becomes round + offset), exercising LWW tie-breaks and the
    # EmptySet ts gating under clock skew. Static for the run.
    straggle: tuple = ()  # (node, period, active) triples — per-node
    # activation slowdown: the node participates in broadcast emission
    # and anti-entropy sweeps only on rounds with
    # ``(round + node) % period < active`` (duty cycle active/period).
    # It still receives, still answers SWIM probes (it is alive, just
    # slow) and still commits local writes — they disseminate on its
    # next active round, exactly like an overloaded agent whose flush
    # loop falls behind.
    epoch_jump: int = 0  # HLC jump a rejoining node boots with:
    # hlc = round + epoch_jump * restart_epoch (uhlc seeds from the
    # wall clock; a restarted node's clock may be ahead). 0 = clean
    # wall-clock reboot.
    trace_vacuous: bool = False  # force the node-fault program to TRACE
    # with zero scheduled effect — the non-perturbation guard's lever
    # (tests/test_node_faults.py): the injection points themselves must
    # not change state, metrics or key derivation.

    @property
    def enabled(self) -> bool:
        """Static gate: False traces zero node-fault ops (the
        cfg.probes discipline)."""
        return bool(
            self.crash or self.stale or self.skew or self.straggle
            or self.trace_vacuous
        )

    @property
    def wipe_enabled(self) -> bool:
        """Whether any wipe (amnesia or stale restore) is scheduled —
        the ``node_epoch`` leaf's enabling condition rides
        ``enabled`` so the vacuous trace threads the plane too."""
        return bool(self.crash or self.stale)

    def wipe_schedule(self) -> tuple:
        """Every scheduled ``(node, round)`` wipe, amnesia and stale
        alike — the host-side consumers' one source of truth (invariant
        checker exemptions, scorecard resync accounting)."""
        return tuple(
            [(int(n), int(r)) for n, r in self.crash]
            + [(int(n), int(r)) for n, _s, r in self.stale]
        )

    def validate(self, num_nodes: int) -> "NodeFaultConfig":
        for n, r in self.crash:
            assert 0 <= int(n) < num_nodes, (
                f"node_faults.crash node {n} out of range"
            )
            assert int(r) >= 0, "node_faults.crash round must be >= 0"
        for n, s, r in self.stale:
            assert 0 <= int(n) < num_nodes, (
                f"node_faults.stale node {n} out of range"
            )
            assert 0 <= int(s) < int(r), (
                "node_faults.stale snapshots must predate the restore "
                f"round (got snap={s}, restore={r})"
            )
        for n, _off in self.skew:
            assert 0 <= int(n) < num_nodes, (
                f"node_faults.skew node {n} out of range"
            )
        for n, period, active in self.straggle:
            assert 0 <= int(n) < num_nodes, (
                f"node_faults.straggle node {n} out of range"
            )
            assert int(period) >= 1 and 1 <= int(active) <= int(period), (
                "node_faults.straggle needs 1 <= active <= period "
                f"(got period={period}, active={active}) — a node with "
                "no active rounds never drains its rings"
            )
        return self


def node_faults_from_dict(d: dict) -> NodeFaultConfig:
    """Rebuild a NodeFaultConfig from its JSON-round-tripped asdict form
    (checkpoint headers, resume tokens): the schedule tuples come back
    as lists-of-lists and must re-tuple, like FaultConfig.blackhole."""
    d = dict(d)
    for key in ("crash", "stale", "skew", "straggle"):
        d[key] = tuple(
            tuple(int(x) for x in row) for row in d.get(key, ())
        )
    return NodeFaultConfig(**d)


def shift_node_faults(nf: "NodeFaultConfig", offset: int) -> "NodeFaultConfig":
    """``nf`` with every round-scheduled fault shifted ``offset`` rounds
    later — the what-if fork's frame adapter (corro_sim/engine/twin.py).

    Node-fault schedules compare against ``state.round``, which is
    ABSOLUTE: a twin forked at round R carries ``round == R`` into every
    forecast lane, so a scenario whose wipe is authored "at relative
    round k" must schedule it at R + k. Only the wipe/snapshot rounds
    shift; ``skew`` carries no round and a straggler's duty phase is a
    function of the absolute round by design (``(round + node) %
    period`` — the phase an overloaded agent is in does not reset
    because an operator forked a forecast)."""
    offset = int(offset)
    if offset == 0 or not (nf.crash or nf.stale):
        return nf
    return dataclasses.replace(
        nf,
        crash=tuple((int(n), int(r) + offset) for n, r in nf.crash),
        stale=tuple(
            (int(n), int(s) + offset, int(r) + offset)
            for n, s, r in nf.stale
        ),
    )


@dataclasses.dataclass(frozen=True)
class TwinConfig:
    """Digital-twin driver knobs (corro_sim/engine/twin.py): how the
    shadow consumes a changeset feed. HOST-side orchestration only — a
    twin run dispatches the exact same compiled step/inject programs a
    plain replay of the same shape would, so this block contributes ZERO
    SimState leaves and ZERO traced ops whether enabled or not
    (tests/test_twin.py pins pytree + jaxpr identity across the gate;
    the acceptance bar: golden 4253/2153 and every primed program stay
    byte-identical for non-twin configs — and for twin ones too)."""

    enabled: bool = False  # provenance gate: a twin run's config says so
    # (reports, checkpoint headers); nothing on-device reads it
    scan_lines: int = 0  # universe scan window in feed lines; 0 = the
    # whole feed (file mode — a live tail must bound it)
    chunk_lines: int = 64  # feed lines consumed per shadow chunk (the
    # checkpoint-cursor granularity)
    skip_bad: bool = False  # quarantine hostile feed lines (counted in
    # corro_twin_bad_lines_total{reason}) instead of refusing the feed
    # with one up-front ValueError
    drain_rounds: int = 256  # post-feed round budget chasing gap -> 0
    checkpoint_every: int = 1  # feed chunks between cursor checkpoints

    # ---- live-tail bounds (corro_sim/io/feedsource.py): how hard a
    # `corro-sim twin --tail` shadow chases a source that stalls, moves
    # or dies. All host-side; none of these touch the step program.
    tail_poll_ms: int = 250  # base poll cadence; also the backoff floor
    reconnect_max_s: float = 30.0  # cumulative retry budget against a
    # missing file / failing endpoint before the source is declared dead
    idle_timeout_s: float = 10.0  # a source that yields no new complete
    # line for this long is dead (a live tail's only natural exit)
    max_lag_lines: int = 65536  # backpressure bound: the source stops
    # reading ahead once this many undelivered lines are buffered

    # ---- stale-universe refresh: when the windowed unknown_actor +
    # unknown_value quarantine rate crosses the threshold, the closed
    # world re-freezes from a trailing scan window at the next chunk
    # boundary (a scheduled re-key event; engine/twin.py).
    refresh_threshold: float = 0.0  # quarantine-rate trigger; 0 = never
    refresh_window_lines: int = 256  # trailing lines rescanned per
    # refresh (also the rate window the trigger is measured over)

    forecast_every: int = 0  # run a fork -> forecast cycle every N feed
    # chunks (0 = only the explicit final --forecast, if any)

    def validate(self) -> "TwinConfig":
        assert self.scan_lines >= 0, "twin.scan_lines must be >= 0"
        assert self.chunk_lines >= 1, "twin.chunk_lines must be >= 1"
        assert self.drain_rounds >= 0, "twin.drain_rounds must be >= 0"
        assert self.checkpoint_every >= 0, (
            "twin.checkpoint_every must be >= 0 (0 = no cursor "
            "checkpoints)"
        )
        assert self.tail_poll_ms >= 1, "twin.tail_poll_ms must be >= 1"
        assert self.reconnect_max_s >= 0, (
            "twin.reconnect_max_s must be >= 0"
        )
        assert self.idle_timeout_s > 0, "twin.idle_timeout_s must be > 0"
        assert self.max_lag_lines >= 1, "twin.max_lag_lines must be >= 1"
        assert 0.0 <= self.refresh_threshold <= 1.0, (
            "twin.refresh_threshold must be in [0, 1]"
        )
        assert self.refresh_window_lines >= 1, (
            "twin.refresh_window_lines must be >= 1"
        )
        assert self.refresh_threshold == 0.0 or self.skip_bad, (
            "twin.refresh_threshold needs skip_bad: the refresh trigger "
            "is the windowed quarantine rate, and strict mode refuses "
            "the feed before anything can quarantine"
        )
        assert self.forecast_every >= 0, (
            "twin.forecast_every must be >= 0 (0 = no cadence re-forks)"
        )
        return self


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static descriptor of a fleet-of-clusters sweep program
    (corro_sim/sweep/): ``lanes`` simulated clusters race in ONE jitted
    dispatch — the scan carry gains a leading lane axis and
    ``make_step``/``make_workload_step`` run under ``jax.vmap``.

    Everything that VARIES across lanes (link-fault scalars, node-fault
    schedules, the sampler-vs-schedule write source) moves from baked
    config constants into per-lane DATA riding the ``sweep_knobs``
    registry feature leaf (engine/features.py — the PR 10 contract:
    disabled configs contribute zero leaves, so every non-sweeping
    config's pytree/jaxpr/cache keys stay byte-identical). The fields
    here are the static GATES: which fault machinery the union program
    must trace at all. A gate is on when ANY lane needs it; lanes that
    don't carry value-neutral knobs (loss 0, wipe round -1, duty 1/1),
    which the vacuity guards (tests/test_faults.py,
    tests/test_node_faults.py) already prove bit-identical to the
    untraced path — that equivalence is exactly what makes a mixed
    scenario matrix collapse into one program whose every lane equals
    its serial ``run_sim`` twin (tests/test_sweep.py).
    """

    lanes: int = 0  # sweep width; 0 = sweeping off (every existing
    # config — the enabled-gate for the sweep_knobs feature leaf)
    link_faults: bool = False  # trace the link-fault machinery with
    # per-lane traced thresholds (loss/dup/sync_loss ride the knob leaf)
    burst: bool = False  # trace the Gilbert burst machinery (per-lane
    # enter/exit/loss thresholds; arms the (N,) fault_burst plane)
    wipes: bool = False  # per-lane crash-restart wipe planes
    # (wipe_round/wipe_stale/epoch_jump)
    stale: bool = False  # per-lane stale-rejoin snapshot planes
    # (snap_round; arms the node_snapshot leaf)
    skew: bool = False  # per-lane HLC skew plane
    straggle: bool = False  # per-lane duty-cycle planes
    workload: bool = False  # the program takes the write-schedule scan
    # inputs AND traces the sampler, selecting per lane by the
    # use_workload knob — so schedule-driven and sampler-driven lanes
    # mix in one dispatch
    sim_knobs: bool = False  # per-lane SimConfig scalars beyond the
    # link-fault set: write_rate / delete_rate as traced f32 thresholds
    # and sync_interval / swim_suspect_rounds as traced i32 cadences
    # (knobs.SIM_KNOB_FIELDS). zipf_alpha needs no gate at all — it
    # only shapes the host-precomputed row_cdf plane, so a zipf axis is
    # a pure per-lane data swap with zero program change.

    @property
    def enabled(self) -> bool:
        return self.lanes > 0

    @property
    def node_faults(self) -> bool:
        """Whether any node-lifecycle plane is armed."""
        return self.wipes or self.stale or self.skew or self.straggle

    @property
    def wipe_planes(self) -> bool:
        """Whether the wipe planes (and the node_epoch leaf) exist."""
        return self.wipes or self.stale

    def validate(self) -> "SweepConfig":
        assert self.lanes >= 0, "sweep.lanes must be >= 0"
        if not self.enabled:
            assert not (
                self.link_faults or self.burst or self.wipes or self.stale
                or self.skew or self.straggle or self.workload
                or self.sim_knobs
            ), "sweep gates need lanes > 0"
        return self


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # --- cluster shape ---
    num_nodes: int = 64
    num_rows: int = 256  # table row slots (pk universe)
    num_cols: int = 4  # columns per row
    log_capacity: int = 1024  # max versions per actor per run (ring)
    seqs_per_version: int = 1  # max cells per changeset (CrsqlSeq axis;
    # one version = one transaction's changeset, corro-api-types/lib.rs:235-245)
    chunks_per_version: int = 1  # gossip chunks per changeset — the
    # ChunkedChanges ≤8 KiB split (corro-types/src/change.rs:16-122); a
    # version applies only when all chunks arrived (partial buffering,
    # agent/util.rs:1065-1190). Must divide 32 (window bits per version).

    # --- workload ---
    write_rate: float = 0.5  # P(node writes) per round while writes enabled
    delete_rate: float = 0.0  # P(write is a DELETE)
    zipf_alpha: float = 0.0  # 0 = uniform rows; >0 = Zipf hot-row contention
    value_universe: int = 1 << 20  # interned value id space

    # --- gossip (reference broadcast/mod.rs) ---
    pend_slots: int = 16  # pending-broadcast ring per node
    emit_slots: int = 0  # egress cap: pending slots serviced per node per
    # round (0 = all of them). The reference bounds egress per flush — 64
    # KiB or 500 ms, whichever first (broadcast/mod.rs:378,394,446-455) —
    # so a saturated pending queue DELAYS sends rather than fanning out
    # unbounded; slots beyond the cap keep their transmission budget and
    # wait. Also the emission lane count (the dominant per-round compute
    # at 10k nodes) scales with this, not with ring capacity.
    fanout: int = 3  # random members per dissemination round
    max_transmissions: int = 4  # re-send budget (foca-style)
    rebroadcast_transmissions: int = 2  # budget for relayed changes
    ring0_size: int = 4  # eager low-latency peer set size

    # --- anti-entropy sync (reference api/peer.rs, agent/handlers.rs) ---
    sync_interval: int = 8  # rounds between sync sweeps (1-15 s backoff analog)
    sync_adaptive: bool = False  # accelerated repair cadence: a round with
    # zero cluster-wide writes and a nonzero gap syncs on the FLOOR cadence
    # below instead of the lean sync_interval, so repair accelerates when
    # gossip stops carrying new data.
    sync_floor_rounds: int = 1  # adaptive floor, in rounds. The reference's
    # sync_loop fires on a growing 1 s → 15 s backoff (util.rs:327-371,
    # MAX_SYNC_BACKOFF agent/mod.rs:34-36) — at round_ms=200 the 1 s floor
    # is 5 rounds; 1 keeps the (more aggressive than reference)
    # sync-every-round tail.
    sync_candidates: int = 10  # RANDOM_NODES_CHOICES (agent/mod.rs:38)
    sync_server_cap: int = 3  # inbound sync semaphore (corro-types/agent.rs:132)
    sync_peers: int | None = None  # concurrent sync peers per node per sweep;
    # None = the reference's max(min(n/100, 10), 3) (handlers.rs:1008-1015)
    sync_actor_topk: int = 32  # actors repaired per node per PEER per sweep
    # (a per-connection chunk budget, peer.rs:1207 — parallel peers each
    # carry a full budget, so sweep bandwidth scales with sync_peers)
    sync_cap_per_actor: int = 8  # versions per actor per sync round
    sync_req_actors: int | None = None  # total request lanes (actors) a
    # node schedules per sweep across all its peers; None = 2× the
    # per-connection budget (parallel headroom without paying full P×
    # lane memory/compute every sweep — lanes are padded to this shape
    # whether needed or not). Clamped to sync_actor_topk × peers.
    # NOTE (per-connection budget bound under probing): with probes >= 1,
    # a lane's budget rank comes from the PRIMARY dealing while its slot
    # may be reassigned by a probe, so one connection can serve up to
    # probes x sync_actor_topk lanes (vs exactly sync_actor_topk under
    # the exact-argmax policy) — a deliberate fidelity trade for the
    # cheaper schedule; size server-side budgets accordingly.
    sync_deal_probes: int = 0  # serving-slot assignment policy. 0 = exact
    # argmax over every granted peer's capability per lane (full
    # (N, P, K') head gather + argsort budget rank — best repair depth,
    # needed when per-actor backlogs are deep and asymmetric). k >= 1 =
    # deal lanes round-robin across granted slots (the reference's
    # shuffled request dealing, api/peer.rs:1241-1372) and probe only k
    # candidate slots per lane — with shallow per-actor needs (the
    # convergence-tail regime) k=2 matches argmax throughput at ~1/6 the
    # sweep-schedule cost on the real chip.
    sync_need_sample: int = 256  # actors sampled for need estimation
    sync_hot_actors: int = 1024  # dense-schedule hot-actor axis width: per
    # sweep, the actors that could possibly be needed by anyone (their
    # written head exceeds some node's applied head) are compacted to at
    # most this many (rotating fairly when more are hot), and the whole
    # request schedule — needs, per-peer capability, serving assignment —
    # runs as dense elementwise work over (N, P, A') instead of
    # per-element gathers over (N, P, K') + an (N, A, K') compare-reduce.
    # Exact, not approximate: a non-hot actor has zero need at every
    # node. 0 = the legacy full-axis schedule.

    # --- SWIM membership (foca analog) ---
    swim_enabled: bool = False
    swim_interval: int = 1  # rounds between SWIM ticks. foca's probe
    # period (1-5 s) is several broadcast flushes long (broadcast flush =
    # 500 ms, mod.rs:378) — ticking SWIM every gossip round is FASTER
    # failure detection than the reference's; >1 restores the ratio and
    # cuts the (N, N)-plane traffic proportionally. Suspicion timeouts
    # (swim_suspect_rounds) count gossip rounds either way.
    swim_indirect_probes: int = 3  # num_indirect_probes
    swim_suspect_rounds: int = 6  # suspicion timeout, in rounds
    swim_gossip_peers: int = 3  # view-exchange peers per round
    swim_announce_interval: int = 4  # belief-independent announce cadence
    # (ANNOUNCE_INTERVAL analog, agent/mod.rs:32 — heals mutual-down splits)
    swim_view_size: int = 0  # > 0: the windowed O(N·K) belief state
    # (membership/swim_window.py) — each node tracks at most this many
    # members instead of the full (N, N) plane (10 GB at 50k, why config
    # 5 historically ran SWIM off). foca's per-node state is O(members
    # known) the same way. 0 = the full-view automaton.
    swim_payload_members: int = 64  # member entries per exchange datagram —
    # the ≤1178-byte SWIM packet bound (broadcast/mod.rs:743) at ~18 B per
    # piggybacked update; >= num_nodes disables the bound (full views)

    # --- state packing (doc/performance.md "state packing & op budget") ---
    narrow_state: bool = False  # pack the widest per-node planes into
    # narrow dtypes (the `rtt: uint8` precedent): SWIM belief planes —
    # full-view (N, N) and windowed (N, K) — drop from uint32 to uint16
    # (inc 6 bits saturating at 63, status 2 bits, since 8 bits mod-2^8)
    # and the probe hop plane drops to int8 (saturating at 127), halving
    # HBM traffic on the biggest state tensor at 10k nodes (400 MB →
    # 200 MB). Bit-exact against the wide reference while incarnations
    # stay under 63, suspicions resolve within 256 rounds (validated:
    # swim_suspect_rounds bound below), gossip paths stay under 127
    # hops, and concurrent suspicions of one member don't straddle a
    # multiple of 256 rounds (the wide layout's mod-2^16 wrap caveat,
    # shrunk with the since field — membership/swim.py). Default off: the
    # switch changes SimState leaf dtypes, which re-keys every compiled
    # step program (cold .jax_cache — see doc/performance.md).

    # --- device-mesh placement (engine/sharding.py) ---
    shard_log: bool | None = None  # change-log placement on a device mesh:
    # True = actor-sharded (each device owns its actors' write history;
    # delivery/sync gathers become collectives, per-device log HBM drops
    # by the mesh size), False = replicated (every gather device-local),
    # None = the SHARD_LOG_ACTORS shape heuristic (sharded at >= 2048
    # actors). Surfaced as `run --shard-log on|off|auto`,
    # CORRO_SIM__SHARD_LOG, and `[sim] shard_log` (doc/multichip.md).
    # Irrelevant off-mesh: single-device runs ignore it.

    # --- merge execution (TPU Pallas kernel, core/merge_kernel.py) ---
    merge_kernel: str = "auto"  # "auto" = Pallas dst-grouped merge for the
    # SYNC sweep on real TPU (single device, 128-aligned cell space;
    # measured ~120 ms/sweep saved at 10k nodes) while gossip delivery
    # keeps the XLA scatter (neutral there — mostly-invalid lanes make
    # the in-situ scatter cheap); "on" forces the kernel on BOTH merge
    # paths (equivalence tests; interpret mode off-TPU); "off" keeps the
    # XLA scatter path everywhere (sharded runs force this — pallas_call
    # does not partition over a mesh).
    apply_queue_cap: int = 128  # max deliveries merged per node per round
    # under the kernel path — the reference's bounded apply channel
    # (config.rs:10-41: change-apply cost threshold + drop queue); lanes
    # beyond the cap are dropped BEFORE bookkeeping (counted in
    # dropped_window) and anti-entropy repairs them, exactly like queue
    # overflow drops (handlers.rs:866-884). Must be a multiple of 128.

    # --- probe tracer (obs/probes.py; the sim-world analog of the
    # reference's distributed tracing) ---
    probes: int = 0  # K sampled versions tracked through the gossip
    # fabric entirely on-device: per (probe, node) first-seen round,
    # infector and hop count, plus duplicate-delivery counts and a
    # per-node last-sync stamp (engine/probe.py). Static, so 0 traces
    # ZERO extra ops — the step program is bit-identical to the
    # uninstrumented one (tests/test_probes.py guards this). Probe k
    # tracks version 1 of actor k*N//K by default; drivers may re-aim
    # probes by replacing state.probe before running.

    # --- chaos injection (corro_sim/faults/) ---
    faults: FaultConfig = FaultConfig()  # stochastic link faults at the
    # two transport points (broadcast delivery + sync grant). Defaults
    # disabled: zero extra traced ops, bit-identical step program
    # (tests/test_faults.py non-perturbation guard).

    # --- node-lifecycle faults (corro_sim/faults/nodes.py) ---
    node_faults: NodeFaultConfig = NodeFaultConfig()  # crash-restart
    # with amnesia, stale rejoin from a snapshot leaf, HLC clock skew
    # and straggler duty cycles — agent-level failures where `faults`
    # above is link-level. Defaults disabled: zero extra traced ops,
    # zero extra SimState leaves (registry features), bit-identical
    # step program (tests/test_node_faults.py non-perturbation guard).

    # --- digital twin (corro_sim/engine/twin.py) ---
    twin: TwinConfig = TwinConfig()  # feed-shadow driver knobs (scan
    # window, chunk size, hostile-line posture, cursor cadence). Pure
    # host orchestration: zero SimState leaves, zero traced ops, the
    # step program byte-identical with the block enabled OR disabled
    # (tests/test_twin.py pins it at the pytree and jaxpr layers).

    # --- fleet-of-clusters sweep (corro_sim/sweep/) ---
    sweep: SweepConfig = SweepConfig()  # static gates of the vmapped
    # chaos-matrix program: lanes > 0 stacks the scan carry over a
    # leading lane axis and the per-lane fault knobs ride the
    # sweep_knobs registry feature leaf. Default disabled: zero extra
    # traced ops, zero extra SimState leaves, byte-identical step
    # program (the engine/features.py contract).

    # --- host-side driver (engine/driver.py) ---
    pipeline: bool = True  # pipelined chunk dispatch: overlap device
    # compute with host-side control/transfers/bookkeeping (speculative
    # next-chunk dispatch + async metric fetch; doc/performance.md).
    # Purely host-side restructuring — the chunk programs, keys and
    # schedule rows are identical either way, and results are
    # bit-identical to the sequential loop (tests/test_pipeline.py).
    # `corro-sim run --no-pipeline` / `CORRO_SIM__PIPELINE=0` opt out;
    # donated-buffer runs (run_sim(donate=True)) force it off.

    # --- timing model ---
    round_ms: float = 200.0  # simulated wall-clock per round (broadcast
    # flush cadence is 500 ms in the reference, broadcast/mod.rs:378; one
    # sim round ≈ one flush+delivery hop)

    # --- link latency + RTT rings (members.rs:40,140-188) ---
    latency_regions: int = 1  # >1 enables the delay model (contiguous
    # node-id regions; think racks/DCs)
    latency_intra: int = 1  # rounds-to-deliver within a region (must be 1
    # while the in-flight ring buffers only the inter class)
    latency_inter: int = 4  # rounds-to-deliver across regions: a message
    # emitted in round r is DELIVERED in round r + latency_inter - 1 via
    # the in-flight ring (real delay, not loss — transport.rs:199-233)
    rtt_rings: bool = False  # measure per-edge RTT on delivery and
    # recompute ring0 from observations (else ring0 stays static)
    ring_update_interval: int = 8  # rounds between ring recomputations

    @property
    def num_actors(self) -> int:
        return self.num_nodes

    @property
    def lanes_per_round(self) -> int:
        """Message lanes one round emits: eager ring-0 chunks + gossip."""
        return self.num_nodes * (
            self.ring0_size * self.chunks_per_version
            + self.pend_slots * self.fanout
        )

    @property
    def inflight_slots(self) -> int:
        """Ring depth of the in-flight delay buffer (0 = disabled)."""
        if self.latency_regions > 1 and self.latency_inter > 1:
            return self.latency_inter - 1
        return 0

    @property
    def resolved_sync_peers(self) -> int:
        """Concurrent sync peers per sweep — max(min(n/100, 10), 3), the
        reference's parallel_sync peer count (``handlers.rs:1008-1015``),
        clamped to the candidate pool."""
        p = self.sync_peers
        if p is None:
            p = max(min(self.num_nodes // 100, 10), 3)
        return max(1, min(p, self.sync_candidates, self.num_nodes - 1))

    def validate(self) -> "SimConfig":
        assert self.num_nodes >= 2
        assert self.fanout >= 1 and self.pend_slots >= 1
        assert self.log_capacity >= 1
        assert self.sync_candidates >= 1
        assert self.seqs_per_version >= 1
        assert 0 <= self.probes <= self.num_nodes, (
            "probes samples distinct origin actors — at most one per node"
        )
        assert self.chunks_per_version in (1, 2, 4, 8, 16, 32), (
            "chunks_per_version must divide the 32-bit version window"
        )
        assert self.shard_log in (None, True, False), (
            "shard_log is tri-state: True (actor-sharded), False "
            "(replicated), or None (the SHARD_LOG_ACTORS heuristic)"
        )
        if self.narrow_state:
            # the narrow since field is 8 bits: a suspicion must start,
            # time out and resolve well inside one mod-2^8 window for
            # the packed-max merge to stay bit-exact with the wide plane
            assert self.swim_suspect_rounds < 128, (
                "narrow_state packs the suspicion clock into 8 bits — "
                "swim_suspect_rounds must stay under 128 rounds"
            )
        assert self.latency_regions <= 1 or self.latency_intra == 1, (
            "the in-flight delay ring buffers the inter-region class only; "
            "intra-region delivery is same-round (latency_intra must be 1)"
        )
        self.faults.validate(self.num_nodes)
        self.node_faults.validate(self.num_nodes)
        self.twin.validate()
        self.sweep.validate()
        if self.sweep.enabled:
            assert not self.node_faults.enabled, (
                "a sweep union config carries node faults as per-lane "
                "planes (sweep_knobs leaf), never as static schedules"
            )
        return self


def sim_config_from_dict(d: dict) -> SimConfig:
    """Rebuild a :class:`SimConfig` from ``dataclasses.asdict`` of this
    one or of the JAX package's (the two are field-for-field copies)."""
    d = dict(d)
    faults = dict(d.pop("faults", {}))
    faults["blackhole"] = tuple(
        tuple(int(x) for x in pair) for pair in faults.get("blackhole", ())
    )
    return SimConfig(
        faults=FaultConfig(**faults),
        node_faults=node_faults_from_dict(d.pop("node_faults", {})),
        twin=TwinConfig(**d.pop("twin", {})),
        sweep=SweepConfig(**d.pop("sweep", {})),
        **d,
    )


def validate_torch_slice(cfg: SimConfig) -> SimConfig:
    """Validate ``cfg`` for the PyTorch port, which runs every
    configuration the JAX package's step runs (the fleet sweep's union
    configs included). Returns ``cfg`` so callers can chain it."""
    cfg.validate()
    return cfg
