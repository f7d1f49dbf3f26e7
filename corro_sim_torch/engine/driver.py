"""Run loop: chunks of rounds with a host-side convergence exit.

Port of ``corro_sim/engine/driver.py::run_sim``. The simulator's
contract is rounds-to-convergence: drive rounds until every live node
has applied every written version (``gap == 0``) after the write phase
ends. Rounds run in chunks; after each chunk the host reads the chunk's
metrics (two stacks, one copy), applies the convergence rule, records
the chunk in the flight recorder and decides whether the next chunk may
run on the repair-specialized step. Keys, schedule rows and chunk
boundaries are the JAX package's, so a seeded run walks the same
trajectory.

Chunk dispatch is **pipelined** by default (``SimConfig.pipeline``):
chunk N+1's kernels are queued before chunk N's metrics land on the
host, whose copy started when chunk N was queued; the host's work for
chunk N (convergence, flight, ``on_chunk``) then overlaps the card
running chunk N+1. Chunks commit strictly in order, so results equal
the sequential loop's: a speculative chunk the sequential loop would
not have run (the run converged or was poisoned one chunk earlier, or
the repair-program choice changed) is discarded and, on a program
mispredict, run again on the right program. A step consumes its input
state, so a speculative chunk runs on a device copy of the committed
state (the JAX package's donation double-buffer): one state's bytes of
memory and one copy per chunk. Queueing a chunk is host work here (the
step is eager), so between the speculative chunk's rounds the host
checks whether chunk N's metrics have landed; once they show that the
speculative chunk will be discarded, the rest of it is not queued.

A run checkpoints at chunk boundaries (``checkpoint_path=``,
``checkpoint_every=``; ``io/checkpoint.py``) and resumes from a token
(``resume=``) bit for bit: the keys of chunk ``ci`` are ``fold_in(root,
ci)`` with ``ci`` continuing from the token, the schedule rows depend on
the absolute round only, and the repair-selection cursor comes back. A
token holds the committed state, copied to the host as soon as its
chunk is queued.

An invariant checker and a resilience scorecard (``faults/``) read the
chunk-boundary state: the bookkeeping heads and SWIM beliefs they read
per chunk are copied to the host as soon as the chunk is queued, before
any later chunk (speculative or not) is queued after it, and they are
fed committed chunks only. At the convergence report they read the
committed state's tables, which no queued chunk consumes. The probe
tracer's per-chunk extraction (``cfg.probes``) reads its ``(K, N)``
planes the same way.

While a ``torch.profiler`` records (``profile_dir=`` or the caller's
own), the loop's host work is ranges on the profiler's clock beside the
step's (``utils/tracing.py::Tracer.stage``): the tracer's spans
``corro.chunk`` (the sequential loop's chunk) and
``corro.chunk_dispatch``, ``corro.chunk.stage`` (keys, schedule rows and
write staging), ``corro.chunk.spec_copy`` (the speculative chunk's state
copy), ``corro.chunk.resolve`` (the wait for a chunk's metrics) and
``corro.chunk.commit`` (the host's bookkeeping of a committed chunk).
The caller's ``on_chunk`` runs inside none of them, so a profiler it
starts or stops cuts no range short.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import types
from typing import Callable

import numpy as np
import torch

from corro_sim_torch import prng
from corro_sim_torch.analysis.transfer_guard import (
    env_enabled as _tg_env_enabled,
    guarded as _tg_guarded,
    point_counts as _tg_counts,
    sanctioned as _tg_sanctioned,
)
from corro_sim_torch.config import SimConfig, validate_torch_slice
from corro_sim_torch.convert import _leaves
from corro_sim_torch.core.merge_kernel import (
    build_kernel,
    kernel_supported,
    sharded_kernel_downgrade,
)
from corro_sim_torch.device import resolve_device
from corro_sim_torch.engine import step as step_mod
from corro_sim_torch.sync.serve import build_serve_kernel
from corro_sim_torch.engine.state import SimState, clone_state, state_nbytes
from corro_sim_torch.engine.step import host_knobs, sim_step
from corro_sim_torch.obs.flight import FlightRecorder
from corro_sim_torch.obs.probes import PROBE_FIELDS, ProbeTrace
from corro_sim_torch.utils.compile_cache import CompileCacheProbe
from corro_sim_torch.utils.metrics import (
    CONFIG_DOWNGRADE_HELP,
    CONFIG_DOWNGRADE_TOTAL,
    PIPELINE_FETCH_WAIT,
    PIPELINE_FETCH_WAIT_HELP,
    PIPELINE_OVERLAP_SECONDS,
    PIPELINE_SPECULATIVE_TOTAL,
    PIPELINE_SPECULATIVE_WASTED,
    SECONDS_BUCKETS,
    counters,
    histograms,
)
from corro_sim_torch.utils.runtime import AsyncFetch, start_async_fetch, upload
from corro_sim_torch.utils.tracing import tracer


@dataclasses.dataclass
class Schedule:
    """Per-round ground truth: who is up, partition ids, write phase.

    Default: everybody up, one partition, writes for ``write_rounds``
    rounds, then quiesce. ``alive``/``part`` may be precomputed ``(R,
    n)`` arrays (rounds past the end hold the last row) or callables
    ``(round, n) -> (n,)``, each evaluated once per round.

    ``events``: sparse ``(round, name, attrs)`` markers (node kill or
    rejoin, partition split or heal); ``run_sim`` copies the ones inside
    each executed chunk into the flight recorder as ``fault_event``.
    ``name``: the scenario's label, kept in the flight recorder's meta."""

    write_rounds: int = 16
    alive_fn: Callable[[int, int], np.ndarray] | None = None
    part_fn: Callable[[int, int], np.ndarray] | None = None
    alive: np.ndarray | None = None  # (R, n) bool
    part: np.ndarray | None = None  # (R, n) int32
    events: list = dataclasses.field(default_factory=list)
    name: str | None = None
    _alive_rows: list = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )
    _part_rows: list = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )

    def _materialize(self, upto: int, n: int) -> None:
        if self.alive_fn is not None:
            for r in range(len(self._alive_rows), upto):
                self._alive_rows.append(np.asarray(self.alive_fn(r, n), bool))
        if self.part_fn is not None:
            for r in range(len(self._part_rows), upto):
                self._part_rows.append(
                    np.asarray(self.part_fn(r, n), np.int32)
                )

    @staticmethod
    def _rows(src, idx: np.ndarray):
        if src is None or len(src) == 0:
            return None
        if isinstance(src, list):
            last = len(src) - 1
            return np.stack([src[min(int(i), last)] for i in idx])
        return src[np.minimum(idx, len(src) - 1)]

    def slice(self, start: int, length: int, n: int):
        """``(alive, part, write_enable)`` rows for rounds
        ``[start, start + length)``."""
        idx = np.arange(start, start + length)
        self._materialize(start + length, n)
        alive = self._rows(
            self.alive if self.alive is not None
            else (self._alive_rows if self.alive_fn is not None else None),
            idx,
        )
        if alive is None:
            alive = np.ones((length, n), bool)
        part = self._rows(
            self.part if self.part is not None
            else (self._part_rows if self.part_fn is not None else None),
            idx,
        )
        if part is None:
            part = np.zeros((length, n), np.int32)
        we = idx < self.write_rounds
        return (
            np.ascontiguousarray(alive, dtype=bool),
            np.ascontiguousarray(part, dtype=np.int32),
            np.ascontiguousarray(we, dtype=bool),
        )

    def events_in(self, start: int, length: int) -> list:
        """The events falling inside rounds ``[start, start + length)``."""
        return [ev for ev in self.events if start <= ev[0] < start + length]


def chunk_keys(root, ci: int, chunk: int) -> np.ndarray:
    """The ``chunk`` per-round keys of chunk ``ci``:
    ``split(fold_in(root, ci), chunk)``."""
    return prng.split(prng.fold_in(root, ci), chunk)


def round_key(root, r: int) -> np.ndarray:
    """The single-round key ``fold_in(root, r)`` of engines that step one
    absolute round at a time (not round ``r`` of :func:`chunk_keys`)."""
    return prng.fold_in(root, r)


def _chunk_runner(cfg: SimConfig, device=None) -> Callable:
    """The full step over one chunk of rounds from keys the caller
    chose: the JAX package's ``_chunk_runner``, for a caller that keys
    its chunks itself (the headline bench). Returns ``run(state, keys,
    alive, part, we) -> (state, metrics)``: ``alive``, ``part`` and
    ``we`` the schedule's host rows for the chunk, ``metrics`` its
    per-round series as numpy (one blocking copy). Consumes ``state``."""
    validate_torch_slice(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda" and (
        kernel_supported(cfg, "sync", dev)
        or kernel_supported(cfg, "delivery", dev)
    ):
        build_kernel()

    def run(state: SimState, keys, alive, part, we) -> tuple:
        r0 = int(state.round)
        alive_t = upload(np.ascontiguousarray(alive, dtype=bool), dev)
        part_t = upload(np.ascontiguousarray(part, dtype=np.int32), dev)
        per_round = []
        for r in range(len(keys)):
            state, m = sim_step(cfg, state, keys[r], alive_t[r], part_t[r],
                                bool(we[r]), r0 + r)
            per_round.append(m)
        return state, metrics_to_numpy(per_round)

    return run


def converged_at(gaps, base: int, chunk: int, min_rounds: int) -> int | None:
    """The convergence rule on one chunk's per-round ``gap`` series: the
    first round strictly past ``min_rounds`` with a zero gap, and only
    when the chunk ends converged."""
    rounds = base + chunk
    if not (rounds > min_rounds and gaps[-1] == 0.0):
        return None
    idx = np.arange(1, chunk + 1) + base
    eligible = (gaps == 0.0) & (idx > min_rounds)
    return int(idx[np.argmax(eligible)])


@dataclasses.dataclass
class RunResult:
    state: SimState
    metrics: dict  # name -> (rounds,) np.ndarray
    rounds: int
    converged_round: int | None
    repair_chunks: int  # chunks run on the repair-specialized step
    wall_seconds: float  # chunk execution wall, device-synchronized
    setup_seconds: float  # kernel build/load before the first chunk
    poisoned: bool = False  # change-log ring wrapped past a live laggard
    stage_seconds: float = 0.0  # of wall_seconds: workload schedule
    # uploads, host to device
    flight: FlightRecorder | None = None  # per-round telemetry timeline
    pipeline: dict | None = None  # the chunk pipeline's counts and
    # walls (the JAX package's keys), and how the queued rounds' sweeps
    # were decided: host_decided, host_reads (of the device predicate),
    # sweeps_run
    resilience: dict | None = None  # the resilience scorecard's block
    # (faults/scorecard.py) when a scorecard was armed
    check_seconds: dict | None = None  # host seconds in the armed
    # checkers, {"invariants": s, "scorecard": s}, outside wall_seconds'
    # chunk walls (sequential loop) or overlapping the next chunk's
    # device work (pipelined loop)
    probe: ProbeTrace | None = None  # the final state's probe trace when
    # cfg.probes
    checkpoint_seconds: float = 0.0  # host seconds writing resume tokens
    # (the state's host copy, compression and the atomic write)
    compile_cache: dict | None = None  # the kernel-library lookups of
    # the setup, hit or miss (utils/compile_cache.py
    # CompileCacheProbe.summary()); nothing counted on the CPU
    sharding: dict | None = None  # mesh placement provenance: devices,
    # mesh shape, change-log regime, the merge kernel in effect and the
    # explicit downgrades; None off a mesh
    transfer_guard: dict | None = None  # with the guard armed, this
    # run's host reads by sanctioned point (analysis/transfer_guard.py)

    @property
    def wall_per_round_ms(self) -> float:
        return 1000.0 * self.wall_seconds / max(self.rounds, 1)


def pack_metrics(per_round: list) -> tuple:
    """Per-round metric dicts of device scalars → ``(int_stack,
    float_stack, int_keys)`` on the device: the integer metrics as an
    int32 ``(K, rounds)`` stack in sorted name order, ``gap`` as a
    float32 ``(1, rounds)`` stack."""
    ikeys = [k for k in sorted(per_round[0]) if k != "gap"]
    i_stack = torch.stack([
        torch.stack([m[k] for m in per_round]).to(torch.int32)
        for k in ikeys
    ])
    f_stack = torch.stack([m["gap"] for m in per_round])[None].to(
        torch.float32)
    return i_stack, f_stack, ikeys


def unpack_metrics(i_np: np.ndarray, f_np: np.ndarray, ikeys) -> dict:
    out = {k: i_np[j] for j, k in enumerate(ikeys)}
    out["gap"] = f_np[0]
    return out


def metrics_to_numpy(per_round: list) -> dict:
    """Per-round metric dicts of device scalars → ``name -> (rounds,)``
    numpy series, in one blocking copy of two stacks."""
    i_stack, f_stack, ikeys = pack_metrics(per_round)
    return unpack_metrics(*start_async_fetch(i_stack, f_stack).resolve(),
                          ikeys)


def _boundary_fetch(cfg: SimConfig, state: SimState) -> AsyncFetch:
    """Start copying what the checkers read per chunk to the host: the
    bookkeeping heads, and with SWIM on the belief statuses (and the
    windowed view's members)."""
    leaves = [state.book.head]
    if cfg.swim_enabled:
        leaves.append(state.swim.status)
        if hasattr(state.swim, "member"):
            leaves.append(state.swim.member)
    return start_async_fetch(*leaves)


def _boundary_view(fetch: AsyncFetch) -> types.SimpleNamespace:
    """The fetched leaves in the state's shape, for the checkers."""
    got = fetch.resolve()
    swim = None
    if len(got) > 1:
        swim = types.SimpleNamespace(status=got[1])
        if len(got) > 2:
            swim.member = got[2]
    return types.SimpleNamespace(book=types.SimpleNamespace(head=got[0]),
                                 swim=swim)


# the leaves the checkers read (per chunk, at convergence and at the
# end) and the probe extraction's
_CHECK_KEYS = ("table.", "book.head", "swim.", "features['node_snapshot']")
_PROBE_KEYS = ("probe.",)


def _read_keys(checks: bool, probes) -> tuple:
    """The leaf-key prefixes the host readers need of a mesh run's
    state."""
    return (_CHECK_KEYS if checks else ()) + (_PROBE_KEYS if probes else ())


def _probe_fetch(cfg: SimConfig, state: SimState) -> AsyncFetch | None:
    """Start copying the probe tracer's planes to the host, for the
    per-chunk extraction; None with probes off."""
    if not cfg.probes:
        return None
    return start_async_fetch(*(getattr(state.probe, f) for f in PROBE_FIELDS))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class _InFlight:
    """One dispatched chunk whose metrics have not been read yet."""

    ci: int
    base: int  # first round the chunk covers (0-based)
    state_out: SimState  # the chunk's final state (chunk N+1's input)
    fetch: AsyncFetch | None  # its metric stacks on their way to the host
    boundary: AsyncFetch | None  # the checkers' leaves of state_out
    probe: AsyncFetch | None  # state_out's probe planes (cfg.probes)
    ikeys: list
    use_repair: bool
    speculative: bool  # dispatched before the previous chunk's metrics
    alive: np.ndarray
    part: np.ndarray
    we: np.ndarray
    cut: bool = False  # speculative and stopped early: to be discarded
    snapshot: AsyncFetch | None = None  # every leaf of state_out, when
    # the chunk's commit writes a checkpoint
    whole: SimState | None = None  # under a mesh, the host readers'
    # leaves of state_out on rank 0's host (checkers, probes, checkpoints)


def run_sim(
    cfg: SimConfig,
    state: SimState,
    schedule: Schedule | None = None,
    max_rounds: int = 4096,
    chunk: int = 16,
    seed: int = 0,
    stop_on_convergence: bool = True,
    min_rounds: int | None = None,
    device=None,
    workload=None,
    on_chunk: Callable[[dict], None] | None = None,
    flight: FlightRecorder | None = None,
    profile_dir: str | None = None,
    pipeline: bool | None = None,
    invariants=None,
    scorecard=None,
    phase_specialize: bool = True,
    resume=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    checkpoint_meta: dict | None = None,
    mesh=None,
    transfer_guard: bool | None = None,
) -> RunResult:
    """Run ``state`` forward in chunks of ``chunk`` rounds until
    convergence (or ``max_rounds``) — the JAX package's ``run_sim``.

    Consumes ``state``, as :func:`~corro_sim_torch.engine.step.sim_step`
    does: its tensors may be updated in place; read the result's state.

    ``device``: where the run happens (default ``cuda``; the state must
    already live there). ``min_rounds``: do not test convergence before
    this round (default: the write phase length).

    ``workload``: a compiled
    :class:`~corro_sim_torch.workload.generators.Workload`. Its load
    phase is the write phase (``schedule.write_rounds`` extends to its
    rounds), and every full chunk feeds its rows through ``sim_step``'s
    ``writes`` port in place of the sampler; the rows are uploaded once
    per chunk, and past the schedule's end one all-idle chunk is
    uploaded once and reused. Its events land in the flight recorder as
    ``workload_event``.

    ``on_chunk``: called after every executed chunk with the JAX
    package's progress dict (chunk index, rounds done, this chunk's and
    the cumulative wall, ``compile_s`` — here the kernel build seconds —,
    which program ran, the last gap and ``pend_live``).

    ``flight``: a :class:`~corro_sim_torch.obs.flight.FlightRecorder` to
    fill with the per-round metric timeline and the run's annotations;
    one is created when not given (``RunResult.flight``).

    ``profile_dir``: run the chunk loop under ``torch.profiler`` and
    write its Chrome trace to ``profile_dir/trace.json``.

    ``pipeline``: dispatch each chunk before the previous chunk's
    metrics are read (module docstring); None follows ``cfg.pipeline``.
    Both loops give the same state and metrics.

    ``invariants``: a :class:`~corro_sim_torch.faults.InvariantChecker`,
    fed every committed chunk's boundary state and metrics and the
    convergence report; each violation is annotated into the flight
    record and counted in ``corro_fault_invariant_violations_total``.

    ``scorecard``: a
    :class:`~corro_sim_torch.faults.ResilienceScorecard`, fed on the
    checker's cadence; its finalized block is ``RunResult.resilience``
    and a ``resilience`` flight annotation.

    ``phase_specialize``: False keeps the full step through the
    convergence tail (the repair step is bit-for-bit the same there).

    ``resume``: a :class:`~corro_sim_torch.io.checkpoint.SimCheckpoint`
    (the JAX package's tokens too): continue a killed run at its last
    checkpointed chunk boundary, bit for bit. Pass the killed run's
    config, schedule, seed and chunk (``check_compatible`` refuses
    others) and an ``init_state``-shaped template as ``state``; the
    metric series and the flight timeline stitch, walls restart at zero.
    It does not compose with ``workload``.

    ``checkpoint_path``/``checkpoint_every``: write a resume token to
    ``checkpoint_path`` after every ``checkpoint_every``-th committed
    chunk that does not end the run (write-then-rename), after
    ``on_chunk``; ``checkpoint_meta`` rides the token verbatim.

    ``mesh``: a :class:`~corro_sim_torch.engine.sharding.Mesh`; call
    ``run_sim`` on every rank with the same arguments and either this
    rank's shard (``init_state(cfg, mesh=mesh)``, which never makes the
    whole) or the whole ``state``, of which each rank keeps its slice
    (``shard_state``); ``resume`` takes the whole template. The ranks
    run the sharded step, read the same metrics and take the same
    decisions. A kernel the mesh cannot keep is downgraded explicitly
    (:func:`~corro_sim_torch.core.merge_kernel.sharded_kernel_downgrade`:
    a ``config_downgrade`` flight annotation and
    ``corro_config_downgrade_total``). The host readers — checkers,
    probes, checkpoints — run on rank 0, on the leaves they read
    gathered onto its host one part at a time (``gather_state``); rank
    0 writes the token. The result's state stays each rank's shard, as
    the JAX package's stays sharded: ``gather_state(res.state, mesh,
    mesh_shardings(cfg, mesh))`` makes it whole on rank 0's host. Only
    rank 0's result carries ``probe`` and ``resilience``.
    ``RunResult.sharding`` records the placement.

    ``transfer_guard``: arm the transfer guard over the chunk loops
    (``analysis/transfer_guard.py``): on the card
    ``torch.cuda.set_sync_debug_mode("error")``, on the CPU a dispatch
    mode that refuses host reads, so that any host read outside the
    sanctioned points raises. None follows ``CORRO_SIM_TRANSFER_GUARD``.
    ``RunResult.transfer_guard`` counts the run's reads by point."""
    validate_torch_slice(cfg)
    want = resolve_device(device)
    if mesh is None and state.hlc.device.type != want.type:
        raise ValueError(
            f"state lives on {state.hlc.device}, asked to run on {want}"
        )
    dev = state.hlc.device
    schedule = schedule or Schedule()
    if workload is not None:
        workload.validate(cfg)
        if schedule.write_rounds < workload.rounds:
            schedule = dataclasses.replace(
                schedule, write_rounds=workload.rounds
            )
    if min_rounds is None:
        min_rounds = schedule.write_rounds
    if pipeline is None:
        pipeline = cfg.pipeline
    if transfer_guard is None:
        transfer_guard = _tg_env_enabled()
    tg = bool(transfer_guard)
    if flight is None:
        flight = FlightRecorder()
    n = cfg.num_nodes
    flight.set_meta(
        driver="run_sim", nodes=n, chunk=chunk, seed=seed,
        max_rounds=max_rounds, pipeline=bool(pipeline),
        **({"scenario": schedule.name} if schedule.name else {}),
        **({"workload": workload.spec} if workload is not None else {}),
    )

    metrics_chunks: list = []
    rounds = 0
    start_ci = 0
    last_pend_live = None
    prev_writes = False
    repair_seen = False
    repair_chunks = 0
    probe_p99_last = None  # the worst probe p99 delivery lag seen so far
    if resume is not None:
        # state, key position, repair-selection cursor, metric tail and
        # flight timeline all come back; the loops below then run as if
        # the earlier chunks had run in this process
        if workload is not None:
            raise ValueError(
                "resume does not compose with workload runs "
                "(the schedule cursor is not checkpointed)"
            )
        resume.check_compatible(cfg, seed=seed, chunk=chunk)
        if mesh is not None and state.hlc.shape[0] != n:
            raise ValueError("resume under a mesh installs into the whole "
                             "template: pass init_state(cfg) without mesh=")
        state = resume.install_state(state)
        rounds = resume.rounds
        start_ci = resume.next_chunk
        cur = resume.cursor
        last_pend_live = cur.get("last_pend_live")
        prev_writes = bool(cur.get("prev_writes", False))
        repair_seen = bool(cur.get("repair_seen", False))
        repair_chunks = int(cur.get("repair_chunks", 0))
        probe_p99_last = cur.get("probe_p99_last")
        if resume.metrics:
            metrics_chunks.append(dict(resume.metrics))
        flight.ingest_ndjson(resume.flight_lines)
        flight.set_meta(resumed_from=resume.path, resumed_at_round=rounds)
        flight.annotate(rounds, "resume", chunk=start_ci)
        counters.inc(
            "corro_soak_resumes_total",
            help_="runs continued from a chunk-boundary checkpoint "
                  "(run_sim resume=)",
        )
        if checkpoint_meta is None:
            checkpoint_meta = resume.meta

    specs = sharding_info = None
    if mesh is not None:
        from corro_sim_torch.engine.sharding import (
            mesh_shardings,
            resolve_shard_log,
            shard_state,
        )

        if n % mesh.nodes:
            raise ValueError(f"{n} nodes do not split over {mesh.nodes} "
                             "shards")
        specs = mesh_shardings(cfg, mesh)
        if state.hlc.shape[0] == n:  # the whole state: keep this slice
            state = shard_state(state, mesh, n, shard_log=cfg.shard_log)
        elif state.hlc.device != mesh.device:
            raise ValueError(f"the shard lives on {state.hlc.device}, the "
                             f"rank on {mesh.device}")
        dev = mesh.device
        downgrades: list = []
        reason = sharded_kernel_downgrade(cfg, mesh.size, dev)
        if reason is not None:
            # the mesh cannot keep the merge kernel here: the scatter
            # merge, said out loud
            cfg = dataclasses.replace(cfg, merge_kernel="off")
            downgrades.append({"field": "merge_kernel", "value": "off",
                               "reason": reason})
            flight.annotate(0, "config_downgrade", field="merge_kernel",
                            value="off", reason=reason)
            counters.inc(
                CONFIG_DOWNGRADE_TOTAL,
                labels=f'{{field="merge_kernel",reason="{reason}"}}',
                help_=CONFIG_DOWNGRADE_HELP,
            )
        sharding_info = {
            "devices": int(mesh.size),
            "mesh_shape": {str(k): int(v) for k, v in mesh.shape.items()},
            "shard_log": ("actor_sharded" if resolve_shard_log(
                num_actors=cfg.num_actors, shard_log=cfg.shard_log)
                else "replicated"),
            "merge_kernel": cfg.merge_kernel,
            "downgrades": downgrades,
        }
        flight.set_meta(sharding=sharding_info)

    def host_view(st, keys=None):
        """``st`` for the host readers: itself off a mesh; under one, its
        ``keys`` leaves (every leaf when None) gathered whole onto rank
        0's host, one part at a time, and None on the other ranks."""
        if mesh is None:
            return st
        from corro_sim_torch.engine.sharding import gather_state

        with _tg_sanctioned("mesh_gather", tg):
            return gather_state(st, mesh, specs, keys=keys)

    t0 = time.perf_counter()
    cache_probe = CompileCacheProbe()
    if dev.type == "cuda" and (
        kernel_supported(cfg, "sync", dev)
        or kernel_supported(cfg, "delivery", dev)
    ):
        build_kernel(probe=cache_probe)
    if dev.type == "cuda" and kernel_supported(cfg, "sync", dev):
        build_serve_kernel(probe=cache_probe)
    setup_seconds = time.perf_counter() - t0
    flight.record_phase("setup", setup_seconds)

    # the round counter on the host, for the SWIM cadence and the sweep
    # gate: one read here, none per round
    round0 = int(state.round) - rounds
    # a sweep lane's knob leaf on the host: the step decides from it
    knobs = (host_knobs(state) if cfg.sweep.enabled else None)
    root = prng.PRNGKey(seed)
    gates0 = dict(step_mod.SWEEP_GATES)
    converged_round = None
    poisoned = False
    wall = 0.0
    stage_seconds = 0.0
    idle_writes = None
    checkpoint_seconds = 0.0
    fetch_wait_total = 0.0
    spec_dispatched = 0
    spec_wasted = 0
    copy_bytes = 0

    def stage_writes(base: int, alive: np.ndarray) -> tuple:
        """The chunk's write-schedule rows on the device, and whether
        each round is quiesced (no live writer), read from the host
        rows."""
        nonlocal idle_writes, stage_seconds
        if base >= workload.rounds and idle_writes is not None:
            return idle_writes, [True] * chunk
        t = time.perf_counter()
        rows = workload.slice(base, chunk, cfg.seqs_per_version)
        staged = tuple(upload(x, dev) for x in rows)
        stage_seconds += time.perf_counter() - t
        if base >= workload.rounds:
            idle_writes = staged
        return staged, [not (rows[0][r] & alive[r]).any()
                        for r in range(chunk)]

    check_seconds = {"invariants": 0.0, "scorecard": 0.0}
    armed = invariants is not None or scorecard is not None

    # the repair step runs without the in-flight ring and RTT rings: a
    # drained gossip ring does not drain parked lanes, and every landed
    # lane is an RTT sample
    repair_eligible = (phase_specialize and cfg.inflight_slots == 0
                       and not cfg.rtt_rings)

    def select_repair(pend_live, we) -> bool:
        """Repair once the rings report drained and the chunk schedules
        no writes, where the config admits the repair step."""
        return bool(repair_eligible and pend_live == 0 and not we.any())

    def checkpoint_due(ci: int) -> bool:
        return bool(checkpoint_path and checkpoint_every
                    and (ci + 1) % checkpoint_every == 0)

    def dispatch(ci, base, state_in, known_pend_live, blocked_by_writes,
                 speculative, behind=None) -> _InFlight:
        """Queue one chunk of rounds on the device and start the copy of
        its metrics; the program follows the sequential rule against
        ``known_pend_live`` (one chunk stale when speculative), and
        ``blocked_by_writes`` vetoes the repair step while an unread
        chunk still carries write rounds. ``behind``: the unread chunk
        this one speculates past; once its metrics show that this chunk
        will be discarded, the rest of it is not queued."""
        alive, part, we = schedule.slice(base, chunk, n)
        use_repair = (select_repair(known_pend_live, we)
                      and not blocked_by_writes)
        staged, quiesced = None, [None] * chunk
        with tracer.stage("corro.chunk.stage"), \
                _tg_sanctioned("chunk_stage", tg):
            keys = chunk_keys(root, ci, chunk)
            alive_t = upload(alive, dev)
            part_t = upload(part, dev)
            if workload is not None and not use_repair:
                staged, quiesced = stage_writes(base, alive)
        st = state_in
        per_round = []
        with tracer.span("chunk dispatch", ci=ci, slow_warn=False,
                         runner="repair" if use_repair else "full"):
            for r in range(chunk):
                if behind is not None and landed(behind):
                    if doomed(behind, we, use_repair):
                        return _InFlight(
                            ci=ci, base=base, state_out=st, fetch=None,
                            boundary=None, probe=None, ikeys=[],
                            use_repair=use_repair,
                            speculative=speculative, alive=alive,
                            part=part, we=we, cut=True)
                    behind = None  # this chunk commits: stop checking
                st, m = sim_step(
                    cfg, st, keys[r], alive_t[r], part_t[r], bool(we[r]),
                    round0 + base + r, repair=use_repair,
                    writes=None if staged is None else tuple(
                        x[r] for x in staged),
                    quiesced=quiesced[r], knobs=knobs, mesh=mesh,
                )
                per_round.append(m)
            i_s, f_s, ikeys = pack_metrics(per_round)
            with (_tg_sanctioned("metric_fetch_start", tg) if pipeline
                  else contextlib.nullcontext()):
                fetch = start_async_fetch(i_s, f_s)
            # the checkers' and the probe extraction's reads, queued
            # before any chunk that follows
            due = checkpoint_due(ci)
            full = (host_view(st, None if due else _read_keys(
                armed, cfg.probes)) if armed or cfg.probes or due
                else None)
            boundary = (_boundary_fetch(cfg, full)
                        if armed and full is not None else None)
            probe = _probe_fetch(cfg, full) if full is not None else None
            # a checkpoint holds this committed state: copy it before a
            # later chunk is queued behind it
            snapshot = (start_async_fetch(*(t for _, t in _leaves(full)))
                        if due and full is not None else None)
        return _InFlight(ci=ci, base=base, state_out=st, fetch=fetch,
                         boundary=boundary, probe=probe, ikeys=ikeys,
                         use_repair=use_repair,
                         speculative=speculative, alive=alive, part=part,
                         we=we, snapshot=snapshot,
                         whole=full if mesh is not None else None)

    def landed(pending: _InFlight) -> bool:
        """Whether ``pending``'s metrics are on the host. Under a mesh
        the ranks agree (every rank's copy landed), since each rank's
        timing is its own and every rank must queue the same rounds."""
        ready = pending.fetch.ready()
        if mesh is None:
            return ready
        with _tg_sanctioned("mesh_agree", tg):
            return mesh.agree(ready)

    def doomed(pending: _InFlight, we, use_repair) -> bool:
        """Whether ``pending``'s metrics (landed) show that the chunk
        speculating past it will be discarded: the run ends at
        ``pending`` (poisoned or converged), or the repair-program
        choice differs from the sequential rule's."""
        with _tg_sanctioned("metric_peek", tg):
            m = unpack_metrics(*pending.fetch.resolve(), pending.ikeys)
        if m["log_wrapped"].any():
            return True
        if stop_on_convergence and converged_at(
                m["gap"], pending.base, chunk, min_rounds) is not None:
            return True
        return select_repair(int(m["pend_live"][-1]), we) != use_repair

    def violations_found(found, at_round) -> None:
        for v in found:
            flight.annotate(
                v.round + 1 if v.round is not None else at_round,
                "invariant_violation", invariant=v.invariant,
                detail=v.detail,
            )
            counters.inc(
                "corro_fault_invariant_violations_total",
                labels=f'{{invariant="{v.invariant}"}}',
                help_="soak invariant violations by checker",
            )

    def process(ci, base, m, inflight: _InFlight, chunk_elapsed,
                annot_extra=None) -> bool:
        """Host-side bookkeeping of one executed (committed) chunk,
        shared by both loops. Returns False when the run must stop
        (converged or poisoned)."""
        nonlocal rounds, prev_writes, last_pend_live, poisoned
        nonlocal converged_round, repair_seen, repair_chunks, probe_p99_last
        with tracer.stage("corro.chunk.commit"):
            we, use_repair = inflight.we, inflight.use_repair
            runner = "repair" if use_repair else "full"
            if use_repair and not repair_seen:
                counters.inc(
                    "corro_repair_program_switches_total",
                    help_="post-quiesce switches to the repair-specialized "
                          "step",
                )
                flight.annotate(base + 1, "repair_program_switch")
                repair_seen = True
            if use_repair:
                repair_chunks += 1
            counters.inc("corro_chunk_dispatch_total",
                         labels=f'{{runner="{runner}"}}',
                         help_="chunk dispatches by program")
            histograms.observe(
                "corro_chunk_wall_seconds", chunk_elapsed,
                labels=f'{{runner="{runner}"}}',
                help_="per-chunk execution wall by program (pipelined mode: "
                      "the commit-to-commit interval)",
                buckets=SECONDS_BUCKETS,
            )
            metrics_chunks.append(m)
            flight.record_rounds(base + 1, m)
            flight.annotate(base + chunk, "chunk", chunk=ci, runner=runner,
                            wall_s=round(chunk_elapsed, 6),
                            **(annot_extra or {}))
            for ev_r, ev_name, ev_attrs in schedule.events_in(base, chunk):
                flight.annotate(ev_r + 1, "fault_event", kind=ev_name,
                                **ev_attrs)
                counters.inc("corro_fault_events_total",
                             labels=f'{{kind="{ev_name}"}}',
                             help_="scheduled fault events executed, by kind")
            if workload is not None:
                for ev_r, ev_name, ev_attrs in workload.events_in(base, chunk):
                    flight.annotate(ev_r + 1, "workload_event", kind=ev_name,
                                    **ev_attrs)
                    counters.inc("corro_workload_events_total",
                                 labels=f'{{kind="{ev_name}"}}',
                                 help_="scheduled workload events executed, "
                                       "by kind")
            if "fault_lost" in m:
                for mk, cname in (
                    ("fault_lost", "corro_fault_lost_total"),
                    ("fault_dup", "corro_fault_dup_total"),
                    ("fault_blackholed", "corro_fault_blackholed_total"),
                    ("fault_sync_lost", "corro_fault_sync_lost_total"),
                ):
                    delta = int(np.asarray(m[mk]).sum()) if mk in m else 0
                    if delta:
                        counters.inc(cname, n=delta,
                                     help_="injected fault effects "
                                           "(corro_sim_torch/faults/)")
            if "node_fault_wipes" in m:
                for mk, cname, chelp in (
                    ("node_fault_wipes", "corro_node_fault_wipes_total",
                     "crash-restart wipes executed (amnesia + stale)"),
                    ("node_fault_straggling",
                     "corro_node_fault_straggling_total",
                     "straggler node-rounds parked by the duty cycle"),
                    ("node_fault_recovering",
                     "corro_node_fault_recovering_total",
                     "node-rounds spent resyncing a wiped write cursor"),
                ):
                    delta = int(np.asarray(m[mk]).sum())
                    if delta:
                        counters.inc(cname, n=delta, help_=chelp)
            if inflight.boundary is not None:
                # the JAX package's cadence: one sanctioned read per armed
                # reader, the view's copy inside the first
                view = None
                if scorecard is not None:
                    t = time.perf_counter()
                    with _tg_sanctioned("invariants", tg):
                        view = _boundary_view(inflight.boundary)
                        scorecard.on_chunk(view, m, inflight.alive,
                                           inflight.part, base)
                    check_seconds["scorecard"] += time.perf_counter() - t
                if invariants is not None:
                    t = time.perf_counter()
                    with _tg_sanctioned("invariants", tg):
                        view = view or _boundary_view(inflight.boundary)
                        found = list(invariants.on_chunk(
                            view, m, inflight.alive, inflight.part, base))
                    check_seconds["invariants"] += time.perf_counter() - t
                    violations_found(found, base + 1)
            if prev_writes and not bool(we.any()):
                flight.annotate(base + 1, "schedule_transition",
                                kind="write_phase_end")
            prev_writes = bool(we.any())
            last_pend_live = int(m["pend_live"][-1])
            rounds = base + chunk
            if inflight.probe is not None:
                # a probe whose p99 delivery lag worsened this chunk (a late
                # straggler stretched the tail) annotates the flight record
                with _tg_sanctioned("probe_extract", tg):
                    planes = dict(zip(PROBE_FIELDS, inflight.probe.resolve()))
                    p99 = ProbeTrace.from_state(
                        cfg, types.SimpleNamespace(
                            probe=types.SimpleNamespace(**planes))
                    ).delivery_p99()
                if (p99 is not None and probe_p99_last is not None
                        and p99 > probe_p99_last):
                    flight.annotate(rounds, "probe_p99_regression", p99=p99,
                                    prev=probe_p99_last)
                    counters.inc(
                        "corro_probe_p99_regressions_total",
                        help_="chunks in which a probe's p99 delivery lag "
                              "worsened",
                    )
                if p99 is not None:
                    probe_p99_last = p99
        # the caller's callback runs outside the range: a profiler it
        # starts or stops finds no program range open
        if on_chunk is not None:
            on_chunk({
                "chunk": ci,
                "rounds_done": rounds,
                "chunk_wall_s": round(chunk_elapsed, 3),
                "wall_s": round(wall, 3),
                "compile_s": round(setup_seconds, 3),
                "runner": runner,
                "gap": float(m["gap"][-1]),
                "pend_live": last_pend_live,
            })
        with tracer.stage("corro.chunk.commit"):
            if m["log_wrapped"].any():
                # a live node lagged some actor past log_capacity: gathers may
                # have read overwritten slots, so convergence cannot be trusted
                poisoned = True
                wrapped_at = base + 1 + int(np.argmax(m["log_wrapped"] != 0))
                flight.annotate(wrapped_at, "log_wrapped")
                return False
            if stop_on_convergence:
                conv = converged_at(m["gap"], base, chunk, min_rounds)
                if conv is not None:
                    converged_round = conv
                    flight.annotate(converged_round, "converged")
                    # the convergence report is checked on the committed
                    # state, which no queued chunk consumes
                    alive_now, part_now = inflight.alive[-1], inflight.part[-1]
                    done = (inflight.state_out if mesh is None
                            else inflight.whole)
                    if scorecard is not None and done is not None:
                        t = time.perf_counter()
                        with _tg_sanctioned("invariants", tg):
                            scorecard.on_converged(done, alive_now, part_now)
                        check_seconds["scorecard"] += time.perf_counter() - t
                    if invariants is not None and done is not None:
                        t = time.perf_counter()
                        with _tg_sanctioned("invariants", tg):
                            found = list(invariants.on_converged(
                                done, alive_now, part_now))
                        check_seconds["invariants"] += time.perf_counter() - t
                        violations_found(found, converged_round)
                    return False
            if checkpoint_due(ci):
                # only a continuing run reaches here: a token never re-animates
                # a finished run
                with _tg_sanctioned("checkpoint", tg):
                    save_checkpoint(ci, inflight)
            return True

    def save_checkpoint(ci, inflight: _InFlight) -> None:
        nonlocal checkpoint_seconds
        from corro_sim_torch.io.checkpoint import (
            save_sim_checkpoint,
            state_flat,
        )

        if inflight.snapshot is None:
            return  # under a mesh rank 0 writes the token
        t = time.perf_counter()
        flat = state_flat(inflight.whole or inflight.state_out,
                          inflight.snapshot.resolve())
        save_sim_checkpoint(
            checkpoint_path, cfg=cfg, state=flat, seed=seed, chunk=chunk,
            rounds=rounds, next_chunk=ci + 1,
            cursor={
                "last_pend_live": last_pend_live,
                "prev_writes": prev_writes,
                "repair_seen": repair_seen,
                "repair_chunks": repair_chunks,
                "probe_p99_last": probe_p99_last,
            },
            metrics={
                k: np.concatenate([np.asarray(c[k]) for c in metrics_chunks])
                for k in metrics_chunks[0]
            },
            flight=flight, meta=checkpoint_meta,
        )
        checkpoint_seconds += time.perf_counter() - t
        flight.annotate(rounds, "checkpoint", chunk=ci, path=checkpoint_path)
        counters.inc(
            "corro_soak_checkpoints_total",
            help_="chunk-boundary soak checkpoints written "
                  "(run_sim checkpoint_every=)",
        )

    def resolve(inflight: _InFlight, mode: str) -> tuple:
        """The chunk's metrics on the host, and the seconds the host
        waited for them."""
        t_f = time.perf_counter()
        with tracer.stage("corro.chunk.resolve"), \
                _tg_sanctioned("metric_resolve", tg):
            m = unpack_metrics(*inflight.fetch.resolve(), inflight.ikeys)
        waited = time.perf_counter() - t_f
        histograms.observe(PIPELINE_FETCH_WAIT, waited,
                           labels=f'{{mode="{mode}"}}',
                           help_=PIPELINE_FETCH_WAIT_HELP,
                           buckets=SECONDS_BUCKETS)
        return m, waited

    profiler = None
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        profiler = profile(activities=acts)
    drain = 0.0
    # the guard covers the chunk loops only: the set-up before them and
    # the drain and result after them read the card freely; the stack
    # disarms it after the loops, or on the way out of a failed run
    guard = contextlib.ExitStack()
    with profiler if profiler is not None else contextlib.nullcontext(), \
            guard:
        _sync(dev)
        tg0 = _tg_counts()
        guard.enter_context(_tg_guarded(tg, dev))
        if not pipeline:
            # ----------------------------------------------- sequential loop
            ci = start_ci
            while rounds < max_rounds:
                t0 = time.perf_counter()
                with tracer.span("chunk", ci=ci, slow_warn=False):
                    inflight = dispatch(ci, rounds, state, last_pend_live,
                                        False, speculative=False)
                    m, waited = resolve(inflight, "sequential")
                chunk_elapsed = time.perf_counter() - t0
                fetch_wait_total += waited
                wall += chunk_elapsed
                flight.record_phase("execute", chunk_elapsed)
                state = inflight.state_out
                cont = process(ci, rounds, m, inflight, chunk_elapsed)
                ci += 1
                if not cont:
                    break
        else:
            # ------------------------------------------------ pipelined loop
            # at most one unread chunk (`pending`) and one speculative
            # chunk behind it ride the device queue; chunks commit in
            # order, one behind dispatch
            pending = None
            last_commit_t = time.perf_counter()
            if rounds < max_rounds:
                pending = dispatch(start_ci, rounds, state, last_pend_live,
                                   False, speculative=False)
            while pending is not None:
                nxt = None
                next_base = pending.base + chunk
                if next_base < max_rounds:
                    # the speculative chunk runs on a copy: the step
                    # consumes its input, and pending's state stays the
                    # committed state and the re-dispatch source
                    with tracer.stage("corro.chunk.spec_copy"):
                        spec_src = clone_state(pending.state_out)
                    copy_bytes += state_nbytes(spec_src)
                    nxt = dispatch(pending.ci + 1, next_base, spec_src,
                                   last_pend_live, bool(pending.we.any()),
                                   speculative=True, behind=pending)
                    spec_dispatched += 1
                    counters.inc(
                        PIPELINE_SPECULATIVE_TOTAL,
                        help_="chunks dispatched before the previous "
                              "chunk's metrics were read",
                    )
                m, waited = resolve(pending, "pipelined")
                fetch_wait_total += waited
                now = time.perf_counter()
                chunk_elapsed = now - last_commit_t
                last_commit_t = now
                wall += chunk_elapsed
                flight.record_phase("execute", chunk_elapsed)
                state = pending.state_out
                cont = process(
                    pending.ci, pending.base, m, pending, chunk_elapsed,
                    annot_extra={"pipeline": True,
                                 "fetch_wait_s": round(waited, 6),
                                 "speculative": pending.speculative},
                )
                if not cont:
                    if nxt is not None:
                        # the one wasted dispatch that bought the overlap
                        reason = "poisoned" if poisoned else "converged"
                        spec_wasted += 1
                        counters.inc(
                            PIPELINE_SPECULATIVE_WASTED,
                            labels=f'{{reason="{reason}"}}',
                            help_="speculative chunk results discarded, "
                                  "by reason",
                        )
                        flight.annotate(rounds, "pipeline_discard",
                                        chunk=nxt.ci, reason=reason)
                    pending = None
                    continue
                if nxt is None:  # round budget spent
                    pending = None
                    continue
                # the speculative program choice read pend_live one chunk
                # stale: check it against the sequential rule, and run
                # the chunk again on the right program if it differs
                if select_repair(last_pend_live, nxt.we) != nxt.use_repair:
                    spec_wasted += 1
                    counters.inc(
                        PIPELINE_SPECULATIVE_WASTED,
                        labels='{reason="program_switch"}',
                        help_="speculative chunk results discarded, by "
                              "reason",
                    )
                    flight.annotate(rounds, "pipeline_discard",
                                    chunk=nxt.ci, reason="program_switch")
                    # nothing reads the committed state after this: the
                    # re-dispatched chunk commits next
                    nxt = dispatch(nxt.ci, nxt.base, state, last_pend_live,
                                   False, speculative=False)
                if nxt.cut:
                    raise RuntimeError("a cut speculative chunk reached "
                                       "its commit")
                pending = nxt
        guard.close()
        # the run is done when its state is, not when its last metrics
        # landed
        t0 = time.perf_counter()
        _sync(dev)
        drain = time.perf_counter() - t0
        wall += drain
        flight.record_phase("drain", drain)
    if profiler is not None:
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    # how the queued rounds' sweeps were decided (discarded speculative
    # chunks included); each sweep run launches the merge kernel once
    # where the kernel takes the sweep
    g = {k: step_mod.SWEEP_GATES[k] - gates0[k] for k in gates0}
    sweeps = {"host_decided": g["host_on"] + g["host_off"],
              "host_reads": g["read_on"] + g["read_off"],
              "sweeps_run": g["host_on"] + g["read_on"]}
    if pipeline:
        exec_wall = max(wall - drain, 0.0)
        overlap = max(exec_wall - fetch_wait_total, 0.0)
        counters.inc(
            PIPELINE_OVERLAP_SECONDS, n=round(overlap, 6),
            help_="host wall spent concurrent with device chunk execution "
                  "(execute wall minus fetch wait)",
        )
        pipeline_stats = {
            "enabled": True,
            "speculative_dispatched": spec_dispatched,
            "speculative_wasted": spec_wasted,
            "fetch_wait_s": round(fetch_wait_total, 6),
            "execute_wall_s": round(exec_wall, 6),
            "overlap_ratio": (round(overlap / exec_wall, 4)
                              if exec_wall > 0 else None),
            "speculative_copy_bytes": copy_bytes,
        }
        flight.annotate(
            rounds, "pipeline",
            **{k: v for k, v in pipeline_stats.items() if k != "enabled"},
        )
    else:
        pipeline_stats = {"enabled": False,
                          "fetch_wait_s": round(fetch_wait_total, 6)}
    pipeline_stats.update(sweeps)
    metrics = {
        k: np.concatenate([c[k] for c in metrics_chunks])
        for k in metrics_chunks[0]
    }
    # the final readers' leaves (the state itself off a mesh)
    final = (host_view(state, _read_keys(scorecard is not None,
                                         cfg.probes))
             if scorecard is not None or cfg.probes else None)
    resilience = None
    if scorecard is not None and final is not None:
        t = time.perf_counter()
        resilience = scorecard.finalize(
            converged_round=None if poisoned else converged_round,
            rounds=rounds, final_state=final,
        )
        check_seconds["scorecard"] += time.perf_counter() - t
        flight.annotate(
            rounds, "resilience",
            **{k: v for k, v in resilience.items()
               if isinstance(v, (int, float, str, bool)) or v is None},
        )
    return RunResult(
        state=state,
        metrics=metrics,
        rounds=rounds,
        converged_round=None if poisoned else converged_round,
        repair_chunks=repair_chunks,
        wall_seconds=wall,
        setup_seconds=setup_seconds,
        compile_cache=cache_probe.summary(),
        poisoned=poisoned,
        stage_seconds=stage_seconds,
        flight=flight,
        pipeline=pipeline_stats,
        resilience=resilience,
        check_seconds=check_seconds if armed else None,
        probe=(ProbeTrace.from_state(cfg, final, driver="run_sim",
                                     seed=seed, rounds=rounds)
               if cfg.probes and final is not None else None),
        checkpoint_seconds=checkpoint_seconds,
        sharding=sharding_info,
        transfer_guard=({k: v - tg0.get(k, 0)
                         for k, v in _tg_counts().items()
                         if v - tg0.get(k, 0)} if tg else None),
    )
