"""Digital twin: shadow a live changeset feed and forecast what-if chaos.

Port of ``corro_sim/engine/twin.py``. The simulator must consume
``corro-api-types`` changesets so real-cluster traces replay; this
module is that bridge's top layer, composing three subsystems:

- **streaming ingestion** (:class:`corro_sim_torch.io.traces.TraceStream`):
  an initial scan window freezes the interner/actor universe, then the
  ND-JSON feed is consumed chunk by chunk against it. The feed is
  HOSTILE input: malformed lines, unknown actors, out-of-order versions
  and duplicates quarantine with ``corro_twin_bad_lines_total{reason}``
  counters (``skip_bad``) or collect into ONE up-front ValueError (the
  strict default — every error at once);
- **the shadow** (:func:`run_twin`): each feed chunk's completed
  injection slices commit through the replay path
  (:func:`corro_sim_torch.workload.inject.inject_round`, the single
  injection home) and the everyone-up step runs between them;
  per-chunk headlines score convergence and FIFO delivery p50/p99
  against the feed's own ``ts`` stamps. A cursor checkpoint (the sim
  resume token, ``meta["twin"]``) is written at feed-chunk boundaries,
  so a killed twin resumes bit-identically mid-feed;
- **predictive what-if chaos** (:func:`fork_twin` / :func:`run_forecast`):
  the live twin state is written as a FORK token
  (:func:`corro_sim_torch.io.checkpoint.save_fork_checkpoint`) and the
  scenario × seed grid races as warm-start lanes of one sweep
  (:mod:`corro_sim_torch.sweep` with ``plan.fork``), each lane
  bit-identical to a serial ``run_sim`` resumed from the same token.
  The frontier grades projected ``recovery_rounds``/``rows_lost``
  against the ``twin_forecast`` section of the resilience thresholds.

What the port does differently, with equal results:

- the host reads each round's metrics once (the ring-wrap tripwire and
  the per-chunk headline need them); :attr:`TwinResult.host_reads`
  counts those reads;
- late clears write only the cleared ``(actor, slot)`` entries, on the
  device (a set on ``log.cleared``, a max on ``cleared_hlc``), where the
  JAX package copies both planes to the host and back;
- a stale-universe refresh translates the rank planes (``table.vr``,
  ``own.vr`` and the log's value lane) on the device
  (:func:`corro_sim_torch.utils.ranks.translate_ranks`);
- a step consumes its input state, so a cursor checkpoint copies the
  committed state to the host before the next step is queued.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig, validate_torch_slice
from corro_sim_torch.core.merge_kernel import build_kernel, kernel_supported
from corro_sim_torch.device import resolve_device
from corro_sim_torch.engine.driver import metrics_to_numpy, round_key
from corro_sim_torch.engine.replay import make_injector, make_shadow_step
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.io.traces import (
    BAD_UNKNOWN_ACTOR,
    BAD_UNKNOWN_COLUMN,
    BAD_UNKNOWN_ROW,
    BAD_UNKNOWN_VALUE,
    TraceStream,
    TraceUniverse,
    extend_universe,
    scan_universe,
    validate_feed,
)
from corro_sim_torch.obs.flight import FlightRecorder
from corro_sim_torch.utils.metrics import (
    ROUNDS_BUCKETS,
    TWIN_BAD_LINES_HELP,
    TWIN_BAD_LINES_TOTAL,
    TWIN_DELIVERY_ROUNDS,
    TWIN_FEED_LINES_TOTAL,
    TWIN_FORECAST_LANES_TOTAL,
    TWIN_REFRESH_EPOCH,
    TWIN_REFRESH_EPOCH_HELP,
    TWIN_REFRESH_HELP,
    TWIN_REFRESH_TOTAL,
    TWIN_TAIL_LAG_LINES,
    TWIN_TAIL_LAG_LINES_HELP,
    counters,
    gauges,
    histograms,
)
from corro_sim_torch.utils.sort import scatter_max, scatter_set
from corro_sim_torch.workload.inject import pad_trace_cells, trace_round_args

__all__ = [
    "TwinResult",
    "fork_twin",
    "load_feed_lines",
    "probe_feed_heads",
    "run_forecast",
    "run_twin",
    "save_fork",
    "twin_universe",
]

# the quarantine reasons whose windowed rate triggers a stale-universe
# refresh: everything a re-scan of the feed itself can actually fix
# (stale/duplicate/oversized/malformed lines stay hostile forever)
_REFRESH_REASONS = (
    BAD_UNKNOWN_ACTOR, BAD_UNKNOWN_VALUE, BAD_UNKNOWN_ROW,
    BAD_UNKNOWN_COLUMN,
)


@dataclasses.dataclass
class TwinResult:
    """One shadow run's outcome (:func:`run_twin`)."""

    state: object
    cfg: SimConfig
    universe: TraceUniverse
    stream: TraceStream
    rounds: int  # sim rounds executed (feed + drain), twin-absolute
    feed_rounds: int  # rounds that carried injected feed versions
    converged_round: int | None
    poisoned: bool
    metrics: dict  # name -> (rounds,) np arrays
    headlines: list  # per-feed-chunk headline dicts
    report: dict
    flight: FlightRecorder
    seed: int
    wall_seconds: float
    checkpoint_path: str | None = None
    refreshes: list = dataclasses.field(default_factory=list)
    # stale-universe re-freeze events (cursor epochs)
    trend: list = dataclasses.field(default_factory=list)
    # cadence re-fork forecast_trend points (one per forecast_every
    # cycle)
    source: dict | None = None  # live-source report (tail mode only)
    host_reads: int = 0  # blocking metric reads, one per round run here
    seconds: dict = dataclasses.field(default_factory=dict)
    # host seconds of this run's parts: "feed" (parse, classify and
    # encode every chunk), "late_clears", "refresh", "checkpoint"


def load_feed_lines(path: str) -> list:
    """The feed file's lines, UNFILTERED (file mode reads it once; a
    live tail would hand :func:`run_twin` its own ``lines``). Blank
    lines ride along so every quarantine diagnostic reports the real
    file line number — the stream consumes them without effect."""
    with open(path, encoding="utf-8") as f:
        return list(f)


def twin_universe(lines: list, cfg_scan_lines: int = 0) -> TraceUniverse:
    """Freeze the closed world from the scan window (``scan_lines == 0``
    scans the whole feed — the file posture). Lenient: hostile lines in
    the window are skipped here and classified at feed time."""
    window = lines if cfg_scan_lines <= 0 else lines[:cfg_scan_lines]
    return scan_universe(window, lenient=True)


def probe_feed_heads(lines: list, universe: TraceUniverse) -> np.ndarray:
    """Final per-actor version horizons a full feed would reach — sizes
    the shadow's change-log ring without encoding anything
    (``encode=False``: classification only, no plane allocation)."""
    probe = TraceStream(universe)
    for i in range(0, len(lines), 4096):
        probe.feed(lines[i:i + 4096], skip_bad=True, encode=False)
    return probe.heads


def run_twin(
    feed: str | None = None,
    cfg: SimConfig | None = None,
    lines: list | None = None,
    seed: int = 0,
    checkpoint_path: str | None = None,
    resume=None,
    flight: FlightRecorder | None = None,
    on_chunk=None,
    universe: TraceUniverse | None = None,
    source=None,
    on_cycle=None,
    device=None,
) -> TwinResult:
    """Shadow a changeset feed chunk by chunk on ``device`` (default
    ``cuda``).

    ``cfg`` defaults to the universe's suggested shape with the feed's
    final horizons sizing the log ring; pass one to pin the shadow
    shape (its ``cfg.twin`` block carries the driver knobs — scan
    window, chunk size, hostile-line posture, checkpoint cadence).

    ``resume``: a twin cursor checkpoint
    (:func:`corro_sim_torch.io.checkpoint.load_sim_checkpoint`, ``meta
    ["twin"]``; the JAX package's tokens too) — the stream cursor, sim
    state, metrics and headlines all restore, the per-round key stream
    continues at its absolute round, and the remaining feed plays out
    bit-identically to the uninterrupted run.

    ``source``: a live :class:`corro_sim_torch.io.feedsource.FeedSource`
    — tail mode. ``lines`` then seeds the already-available prefix (the
    scan window, plus the consumed prefix on resume) and the loop
    blocks on ``source.wait_lines`` for each FULL chunk, so chunk
    boundaries — and therefore classification, injection and the whole
    shadow — are bit-identical to replaying the same lines file-mode.
    When the source dies past its backoff/idle budget the shadow
    consumes the final partial chunk, drains, and returns with
    ``result.source["dead"]`` set. Strict (non ``skip_bad``) posture
    cannot pre-validate a feed that is still being written; it is
    enforced per chunk instead (the stream raises before the cursor
    moves).

    ``on_cycle``: the cadence re-fork hook (``twin.forecast_every``) —
    called at every Nth chunk boundary with ``{chunk, round, state,
    cfg, seed, stream, feed, window_chunks}``; a returned dict's
    ``"trend"`` entry is appended to ``result.trend`` (and rides the
    cursor checkpoint, so a resumed twin keeps its trend history). The
    state it is handed is the live one: a hook that runs it must run a
    copy (:func:`corro_sim_torch.engine.state.clone_state`)."""
    from corro_sim_torch.io.checkpoint import save_sim_checkpoint

    dev = resolve_device(device)
    if lines is None:
        if feed is None:
            raise ValueError("run_twin needs a feed path or lines")
        lines = load_feed_lines(feed)
    lines = list(lines)
    if resume is not None and cfg is None:
        cfg = resume.cfg
    twin_knobs = (cfg.twin if cfg is not None else None)
    scan_lines = twin_knobs.scan_lines if twin_knobs else 0
    if universe is None:  # the caller may hand in the one it scanned
        universe = twin_universe(lines, scan_lines)
    if cfg is None:
        heads = probe_feed_heads(lines, universe)
        cfg = universe.suggest_config(
            rounds=int(heads.max(initial=0)) + 1,
        )
        from corro_sim_torch.config import TwinConfig

        cfg = dataclasses.replace(
            cfg, twin=TwinConfig(enabled=True)
        ).validate()
        twin_knobs = cfg.twin
    validate_torch_slice(cfg)
    if universe.num_actors > cfg.num_nodes:
        raise ValueError(
            f"feed has {universe.num_actors} actors > {cfg.num_nodes} nodes"
        )
    if universe.seqs_per_version > cfg.seqs_per_version:
        raise ValueError(
            f"feed changesets carry up to {universe.seqs_per_version} "
            f"cells; cfg.seqs_per_version={cfg.seqs_per_version} is too "
            "small"
        )

    # strict posture: classify EVERY line up front and refuse the whole
    # feed with one error naming each bad line; skip_bad defers to
    # per-chunk quarantine instead. The validation pass MUST chunk
    # exactly like the run below — classification is
    # chunk-boundary-dependent (io/traces.py validate_feed docstring).
    # A live tail cannot see the whole feed up front: strict mode is
    # then enforced per chunk (stream.feed raises, cursor unmoved).
    if not twin_knobs.skip_bad and source is None:
        bad = validate_feed(
            lines, universe, chunk_lines=twin_knobs.chunk_lines
        )
        if bad:
            raise ValueError(
                f"hostile trace feed ({len(bad)} bad lines — rerun "
                "with --skip-bad to quarantine them):\n  "
                + "\n  ".join(
                    f"line {no}: {reason}: {detail}"
                    for no, reason, detail in bad
                )
            )

    if flight is None:
        flight = FlightRecorder()
    flight.set_meta(
        driver="run_twin", nodes=cfg.num_nodes, seed=seed,
        feed=feed, chunk_lines=twin_knobs.chunk_lines,
        skip_bad=twin_knobs.skip_bad, live=source is not None,
    )

    if dev.type == "cuda" and (
        kernel_supported(cfg, "sync", dev)
        or kernel_supported(cfg, "delivery", dev)
    ):
        build_kernel()
    inject = make_injector(cfg)
    step = make_shadow_step(cfg, dev)
    root = prng.PRNGKey(seed)

    metrics_parts: list = []  # dict-of-arrays blocks to concatenate
    headlines: list = []
    refreshes: list = []  # re-key events (cursor epochs)
    refresh_refused: list = []  # extensions that would not fit cfg
    trend: list = []  # cadence forecast_trend points
    late_applied = 0  # retroactively cleared log slots
    rounds = 0
    feed_rounds = 0
    chunk_index = 0
    host_reads = 0
    seconds = {"feed": 0.0, "late_clears": 0.0, "refresh": 0.0,
               "checkpoint": 0.0}

    def _consumed_sha(upto: int) -> str:
        # the consumed prefix's content hash: the resume guard that a
        # rotated/edited/truncated feed cannot silently pass (the token
        # only knows cfg/seed/chunking — the FEED is part of the run's
        # identity too)
        h = hashlib.sha256()
        for ln in lines[:upto]:
            h.update((ln if isinstance(ln, str) else repr(ln)).encode())
        return h.hexdigest()

    if resume is not None:
        twin_meta = (resume.meta or {}).get("twin")
        if not twin_meta:
            raise ValueError(
                f"{resume.path!r} is a sim checkpoint but carries no "
                "twin cursor — resume it via run_sim(resume=...)"
            )
        resume.check_compatible(cfg, seed=seed, chunk=1)
        consumed = int(twin_meta["cursor"].get("lines_seen", 0))
        if consumed > len(lines):
            raise ValueError(
                f"resume cursor has consumed {consumed} feed lines but "
                f"the feed only has {len(lines)} — this is not the "
                "feed the token was written against"
            )
        want_sha = twin_meta.get("feed_sha")
        if want_sha is not None and _consumed_sha(consumed) != want_sha:
            raise ValueError(
                "resume feed mismatch: the first "
                f"{consumed} lines differ from the ones the token's "
                "shadow consumed — resuming against a rotated or "
                "edited feed would silently diverge"
            )
        state = resume.install_state(init_state(cfg, seed=seed, device=dev))
        refreshes = list(twin_meta.get("refreshes", []))
        for ev in refreshes:
            # deterministic re-freeze replay: the cursor's refresh
            # epochs name the exact trailing windows the killed run
            # extended the universe from; the checkpointed STATE is
            # already in the final epoch's rank space (the remap
            # happened before the checkpoint), so only the universe
            # (and therefore the stream's encoder) is rebuilt here
            at = int(ev["at_line"])
            w = int(ev["window_lines"])
            uni2, info = extend_universe(
                universe, lines[max(0, at - w):at],
                max_actors=cfg.num_nodes, max_rows=cfg.num_rows,
                max_cols=cfg.num_cols, max_seqs=cfg.seqs_per_version,
            )
            if uni2 is None:
                raise ValueError(
                    "resume refresh replay failed at epoch "
                    f"{ev.get('epoch')}: {'; '.join(info['refused'])} — "
                    "the feed prefix no longer reproduces the refresh "
                    "the token recorded"
                )
            universe = uni2
        trend = list(twin_meta.get("trend", []))
        late_applied = int(twin_meta.get("late_applied", 0))
        stream = TraceStream.from_cursor(
            universe, twin_meta["cursor"]
        )
        rounds = resume.rounds
        feed_rounds = int(twin_meta.get("feed_rounds", rounds))
        chunk_index = int(twin_meta.get("chunk_index", 0))
        headlines = list(twin_meta.get("headlines", []))
        if resume.metrics:
            metrics_parts.append(resume.metrics)
        flight.ingest_ndjson(resume.flight_lines)
        flight.set_meta(
            resumed_from=resume.path, resumed_at_round=rounds,
        )
        flight.annotate(rounds, "twin_resume", chunk=chunk_index)
        counters.inc(
            "corro_twin_resumes_total",
            help_="twin shadows continued from a feed-cursor "
                  "checkpoint (engine/twin.py)",
        )
    else:
        state = init_state(cfg, seed=seed, device=dev)
        stream = TraceStream(universe)

    def _save_checkpoint() -> None:
        # the committed state goes to the host here, before the next
        # step (which consumes it) is queued
        t = time.perf_counter()
        metrics_now = _concat_metrics(metrics_parts)
        save_sim_checkpoint(
            checkpoint_path, cfg=cfg, state=state, seed=seed,
            chunk=1, rounds=rounds, next_chunk=rounds, cursor={},
            metrics=metrics_now, flight=flight,
            meta={"twin": {
                "feed": feed,
                "feed_sha": _consumed_sha(stream.lines_seen),
                "cursor": stream.cursor(),
                "chunk_index": chunk_index,
                "feed_rounds": feed_rounds,
                "headlines": headlines,
                "refreshes": refreshes,
                "refresh_epoch": len(refreshes),
                "trend": trend,
                "late_applied": late_applied,
            }},
        )
        flight.annotate(rounds, "twin_checkpoint", chunk=chunk_index,
                        path=checkpoint_path)
        counters.inc(
            "corro_twin_checkpoints_total",
            help_="feed-cursor checkpoints written (engine/twin.py)",
        )
        seconds["checkpoint"] += time.perf_counter() - t

    t0 = time.perf_counter()
    poisoned = False
    converged = None

    def _exec_round(state):
        """One shadow step + the ring-wrap poison tripwire — the ONE
        per-round stanza both the feed loop and the drain loop run; its
        metric read is the round's one host read."""
        nonlocal rounds, poisoned, host_reads
        state, m = step(state, round_key(root, rounds), rounds)
        rounds += 1
        m = {k: v[0] for k, v in metrics_to_numpy([m]).items()}
        host_reads += 1
        if int(m["log_wrapped"]) > 0:
            # ring-wrap tripwire (engine/step.py): state may be
            # silently wrong — stop, never report convergence
            poisoned = True
            flight.annotate(rounds, "log_wrapped")
        return state, m

    def _flush_rounds(base: int, ms: list) -> None:
        if not ms:
            return
        stacked = {
            k: np.stack([mr[k] for mr in ms]) for k in ms[0]
        }
        metrics_parts.append(stacked)
        flight.record_rounds(base + 1, stacked)

    def _apply_late_clears(state, entries):
        """Retroactive EmptySet application (value-neutral): mark the
        already-committed log slots of a late clear as cleared so sync
        peers serve the Empty answer — the same cleared/cleared_hlc
        bookkeeping :func:`corro_sim_torch.workload.inject.inject_round`
        does for in-chunk clears, applied after the fact, on the device
        and to the named slots only. The slot CONTENT stays (LWW
        already superseded it)."""
        nonlocal late_applied
        capacity = cfg.log_capacity
        actors, slots, stamps = [], [], []
        for ai, lo, hi, ts_ in entries:
            head = int(stream.heads[ai])
            for v in range(max(1, lo), hi + 1):
                if head - v >= capacity:
                    continue  # slot recycled (the twin poisons on wrap
                    # before this can matter; belt and braces)
                actors.append(ai)
                slots.append((v - 1) % capacity)
                stamps.append(ts_)
        if not actors:
            return state, 0
        late_applied += len(actors)
        idx = (torch.tensor(actors, dtype=torch.int64, device=dev),
               torch.tensor(slots, dtype=torch.int64, device=dev))
        ts = torch.tensor(stamps, dtype=torch.int32, device=dev)
        # a slot named twice is set True twice: the set stays exact
        return dataclasses.replace(
            state,
            log=dataclasses.replace(
                state.log, cleared=scatter_set(state.log.cleared, idx, True)),
            cleared_hlc=scatter_max(state.cleared_hlc, idx, ts),
        ), len(actors)

    def _refresh_window() -> tuple:
        """Trailing (lines, unknown) sums covering at least the
        configured rate window — chunk-granular, so a resumed run
        measures the identical rate at the identical boundary."""
        lines_sum = unk_sum = 0
        for n_l, n_u in reversed(window_hist):
            lines_sum += n_l
            unk_sum += n_u
            if lines_sum >= twin_knobs.refresh_window_lines:
                break
        return lines_sum, unk_sum

    def _maybe_refresh(state):
        """The scheduled re-key event: when the windowed unknown-name
        quarantine rate crosses the threshold, re-freeze the closed
        world from the trailing scan window at this chunk boundary.
        Ordinals extend in place; value ranks re-sort, so the three
        rank-typed state planes translate on the device (the checkpoint
        installer's exact remap set). An extension that would not fit
        the shapes REFUSES loudly and the shadow keeps quarantining."""
        nonlocal universe
        if twin_knobs.refresh_threshold <= 0.0:
            return state
        lines_sum, unk_sum = _refresh_window()
        if (
            lines_sum < twin_knobs.refresh_window_lines
            or unk_sum / lines_sum < twin_knobs.refresh_threshold
        ):
            return state
        at = stream.lines_seen
        window = lines[max(0, at - lines_sum):at]
        new_uni, info = extend_universe(
            universe, window,
            max_actors=cfg.num_nodes, max_rows=cfg.num_rows,
            max_cols=cfg.num_cols, max_seqs=cfg.seqs_per_version,
        )
        window_hist.clear()  # one verdict per window, either way
        if new_uni is None:
            refresh_refused.append({
                "chunk": chunk_index, "at_line": at,
                "reasons": info["refused"],
            })
            flight.annotate(
                rounds, "twin_refresh_refused", chunk=chunk_index,
                at_line=at, reasons="; ".join(info["refused"]),
            )
            counters.inc(
                TWIN_REFRESH_TOTAL, labels='{trigger="refused"}',
                help_=TWIN_REFRESH_HELP,
            )
            return state
        if info["rank_moves"]:
            state = _translate_state_ranks(
                state, info["old_ranks"], info["new_ranks"])
        universe = new_uni
        stream.rebind(new_uni)
        event = {
            "epoch": len(refreshes) + 1,
            "chunk": chunk_index,
            "at_line": at,
            "window_lines": lines_sum,
            "unknown_lines": unk_sum,
            "actors_added": info["actors_added"],
            "rows_added": info["rows_added"],
            "cols_added": info["cols_added"],
            "values_added": info["values_added"],
            "rank_moves": info["rank_moves"],
        }
        refreshes.append(event)
        counters.inc(
            TWIN_REFRESH_TOTAL, labels='{trigger="quarantine"}',
            help_=TWIN_REFRESH_HELP,
        )
        gauges.set(
            TWIN_REFRESH_EPOCH, float(len(refreshes)),
            help_=TWIN_REFRESH_EPOCH_HELP,
        )
        flight.annotate(rounds, "twin_refresh", **event)
        return state

    start_line = stream.lines_seen
    step_width = twin_knobs.chunk_lines
    window_hist: list = []  # per-chunk (lines, unknown_*) pairs the
    # refresh trigger windows over
    window_chunks: list = []  # encoded chunks since the last cadence
    # cycle — the coupled-forecast replay window
    while not poisoned:
        if source is not None and not source.dead:
            need = step_width - (len(lines) - start_line)
            if need > 0:
                # block for a FULL chunk (or source death): chunk
                # boundaries — and so the whole shadow — stay
                # bit-identical to file-mode replay of the same lines
                lines.extend(source.wait_lines(need))
            gauges.set(
                TWIN_TAIL_LAG_LINES,
                float(len(lines) - start_line + source.lag_lines),
                help_=TWIN_TAIL_LAG_LINES_HELP,
            )
        if start_line >= len(lines):
            break
        chunk_lines = lines[start_line:start_line + step_width]
        start_line += len(chunk_lines)
        t = time.perf_counter()
        out = stream.feed(chunk_lines, skip_bad=twin_knobs.skip_bad)
        seconds["feed"] += time.perf_counter() - t
        for line_no, reason, detail in out.bad:
            counters.inc(
                TWIN_BAD_LINES_TOTAL,
                labels=f'{{reason="{reason}"}}',
                help_=TWIN_BAD_LINES_HELP,
            )
            flight.annotate(
                rounds, "twin_bad_line", line=line_no, reason=reason,
                detail=detail,
            )
        for line_no, _reason, detail in out.late:
            counters.inc(
                "corro_twin_late_clears_total",
                help_="benign late EmptySets dropped (clearing already-"
                      "injected versions; io/traces.py LATE_CLEAR)",
            )
            flight.annotate(
                rounds, "twin_late_clear", line=line_no, detail=detail,
            )
        counters.inc(
            TWIN_FEED_LINES_TOTAL, n=out.lines,
            help_="feed lines consumed by the twin shadow "
                  "(good + quarantined; engine/twin.py)",
        )
        chunk_metrics: list = []
        if out.rounds:
            cells = pad_trace_cells(out, cfg.seqs_per_version)
            base = rounds
            for j in range(out.rounds):
                state = inject(state, *trace_round_args(out, cells, j, dev))
                state, m = _exec_round(state)
                feed_rounds = rounds
                chunk_metrics.append(m)
                if poisoned:
                    break
            _flush_rounds(base, chunk_metrics)
        late_n = 0
        if out.late_apply:
            # retroactive EmptySets: clear the superseded log slots the
            # clear arrived too late to catch in-chunk
            t = time.perf_counter()
            state, late_n = _apply_late_clears(state, out.late_apply)
            seconds["late_clears"] += time.perf_counter() - t
            if late_n:
                flight.annotate(
                    rounds, "twin_late_apply", slots=late_n,
                    chunk=chunk_index,
                )
        headline = {
            "chunk": chunk_index,
            "lines": out.lines,
            "bad": len(out.bad),
            "rounds": out.rounds,
            "round": rounds,
            "gap": (
                float(chunk_metrics[-1]["gap"]) if chunk_metrics
                else (
                    float(headlines[-1]["gap"]) if headlines else 0.0
                )
            ),
            "applied": int(sum(
                int(mr["fresh"]) + int(mr["sync_versions"])
                for mr in chunk_metrics
            )),
            "feed_ts": (
                {"lo": out.ts_lo, "hi": out.ts_hi}
                if out.ts_hi is not None else None
            ),
            "sim_ms": round(out.rounds * cfg.round_ms, 3),
            "late_applied": late_n,
        }
        headlines.append(headline)
        flight.annotate(
            rounds, "twin_chunk",
            **{k: v for k, v in headline.items()
               if isinstance(v, (int, float, str, bool)) or v is None},
        )
        counters.inc(
            "corro_twin_chunks_total",
            help_="feed chunks shadowed (engine/twin.py)",
        )
        if on_chunk is not None:
            on_chunk(dict(headline))
        unk = sum(
            1 for _no, reason, _d in out.bad
            if reason in _REFRESH_REASONS
        )
        window_hist.append((out.lines, unk))
        if not poisoned:
            t = time.perf_counter()
            state = _maybe_refresh(state)
            seconds["refresh"] += time.perf_counter() - t
        if out.rounds:
            window_chunks.append(out)
        chunk_index += 1
        if (
            twin_knobs.forecast_every and on_cycle is not None
            and not poisoned
            and chunk_index % twin_knobs.forecast_every == 0
        ):
            # cadence re-fork: the operator hook forks the live state
            # and grades recovery, optionally replaying the trailing
            # window as coupled workload; runs BEFORE the checkpoint at
            # the same boundary so the trend point rides the cursor
            point = on_cycle({
                "chunk": chunk_index, "round": rounds, "state": state,
                "cfg": cfg, "seed": seed, "stream": stream,
                "feed": feed, "window_chunks": list(window_chunks),
            })
            window_chunks.clear()
            if isinstance(point, dict) and "trend" in point:
                trend.append(point["trend"])
        if (
            checkpoint_path and twin_knobs.checkpoint_every
            and chunk_index % twin_knobs.checkpoint_every == 0
            and not poisoned
        ):
            _save_checkpoint()

    # ---- drain: chase gap -> 0 now that the feed is exhausted
    drained = 0
    last_gap = float(headlines[-1]["gap"]) if headlines else 0.0
    if not poisoned and last_gap == 0.0 and rounds > 0:
        converged = rounds
    while (
        not poisoned and converged is None
        and drained < twin_knobs.drain_rounds
    ):
        base = rounds
        drain_metrics: list = []
        for _ in range(min(8, twin_knobs.drain_rounds - drained)):
            state, m = _exec_round(state)
            drained += 1
            drain_metrics.append(m)
            if poisoned:
                break
            if float(m["gap"]) == 0.0:
                converged = rounds
                break
        _flush_rounds(base, drain_metrics)
    if converged is not None:
        flight.annotate(converged, "converged")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    metrics = _concat_metrics(metrics_parts)
    counters.inc(
        "corro_twin_rounds_total",
        # rounds executed IN THIS PROCESS: a resumed run restored
        # `resume.rounds` of history whose execution the killed process
        # already counted
        n=rounds - (resume.rounds if resume is not None else 0),
        help_="shadow sim rounds executed (feed + drain; "
              "engine/twin.py)",
    )
    if checkpoint_path and twin_knobs.checkpoint_every:
        # the final cursor: a twin killed AFTER the feed still resumes
        # into the drain tail instead of replaying the whole feed
        if not poisoned:
            _save_checkpoint()

    source_report = source.report() if source is not None else None
    report = _shadow_report(
        cfg, stream, metrics, headlines, rounds, feed_rounds,
        converged, poisoned, feed,
        late_applied=late_applied, refreshes=refreshes,
        refresh_refused=refresh_refused, source=source_report,
    )
    flight.annotate(
        rounds, "twin_report",
        **{k: v for k, v in report.items()
           if isinstance(v, (int, float, str, bool)) or v is None},
    )
    return TwinResult(
        state=state, cfg=cfg, universe=universe, stream=stream,
        rounds=rounds, feed_rounds=feed_rounds,
        converged_round=None if poisoned else converged,
        poisoned=poisoned, metrics=metrics, headlines=headlines,
        report=report, flight=flight, seed=seed, wall_seconds=wall,
        checkpoint_path=checkpoint_path, refreshes=refreshes,
        trend=trend, source=source_report, host_reads=host_reads,
        seconds=seconds,
    )


def _translate_state_ranks(state, old, new):
    """``state`` with its three rank-typed planes (``table.vr``,
    ``own.vr`` and the log cells' value lane) translated from ``old``
    to ``new`` ranks, where they lie."""
    from corro_sim_torch.core.changelog import CELL_VR
    from corro_sim_torch.utils.ranks import translate_ranks

    cells = state.log.cells.clone()
    cells[..., CELL_VR] = translate_ranks(cells[..., CELL_VR], old, new)
    return dataclasses.replace(
        state,
        table=dataclasses.replace(
            state.table, vr=translate_ranks(state.table.vr, old, new)),
        own=dataclasses.replace(
            state.own, vr=translate_ranks(state.own.vr, old, new)),
        log=dataclasses.replace(state.log, cells=cells),
    )


def _concat_metrics(parts: list) -> dict:
    if not parts:
        return {}
    return {
        k: np.concatenate([np.asarray(p[k]) for p in parts])
        for k in parts[0]
    }


def _shadow_report(
    cfg, stream, metrics, headlines, rounds, feed_rounds, converged,
    poisoned, feed, late_applied=0, refreshes=None,
    refresh_refused=None, source=None,
) -> dict:
    """The shadow headline block: feed hygiene + convergence + the FIFO
    delivery read scored against the feed's own clock."""
    from corro_sim_torch.faults.scorecard import fifo_delivery_quantiles

    delivery = None
    if metrics:
        applied = (
            np.asarray(metrics["fresh"], np.int64)
            + np.asarray(metrics["sync_versions"], np.int64)
        )
        q = fifo_delivery_quantiles(
            applied, metrics["gap"], 0, rounds
        )
        if q is not None:
            delivery = {
                "method": "fifo_horizontal_distance",
                "p50_rounds": q["p50"],
                "p99_rounds": q["p99"],
                "p50_ms": round(q["p50"] * cfg.round_ms, 3),
                "p99_ms": round(q["p99"] * cfg.round_ms, 3),
                "units": q["units"],
            }
            histograms.observe(
                TWIN_DELIVERY_ROUNDS, q["p99"],
                help_="shadowed feed delivery p99 in rounds "
                      "(FIFO horizontal distance; engine/twin.py)",
                buckets=ROUNDS_BUCKETS,
            )
    ts_stamps = [
        h["feed_ts"] for h in headlines if h.get("feed_ts")
    ]
    feed_ts = None
    if ts_stamps:
        feed_ts = {
            "lo": min(t["lo"] for t in ts_stamps),
            "hi": max(t["hi"] for t in ts_stamps),
        }
        feed_ts["span"] = feed_ts["hi"] - feed_ts["lo"]
    return {
        "feed": feed,
        "nodes": cfg.num_nodes,
        "actors": stream.universe.num_actors,
        "lines": stream.lines_seen,
        "bad_lines": stream.bad_lines,
        "bad_by_reason": dict(stream.counters),
        "late_clears": stream.late_clears,
        "chunks": len(headlines),
        "rounds": rounds,
        "feed_rounds": feed_rounds,
        "converged_round": None if poisoned else converged,
        "poisoned": poisoned,
        "final_gap": (
            float(np.asarray(metrics["gap"])[-1]) if metrics else 0.0
        ),
        "changes_applied": (
            int(np.asarray(metrics["fresh"]).sum())
            + int(np.asarray(metrics["sync_versions"]).sum())
            if metrics else 0
        ),
        # the shadow's wall on the SIM clock next to the feed's own span
        # on ITS clock (ts units are the feed producer's — reported
        # verbatim, never converted)
        "sim_ms": round(rounds * cfg.round_ms, 3),
        "feed_ts": feed_ts,
        "shadow_delivery": delivery,
        # retroactive EmptySet slots cleared after their versions were
        # already injected (value-neutral; sync peers now serve Empty)
        "late_applied": late_applied,
        "refresh": {
            "epoch": len(refreshes or ()),
            "events": list(refreshes or ()),
            "refused": list(refresh_refused or ()),
        },
        # live-source telemetry (None for file-mode replay — the block
        # is excluded from live-vs-file identity comparisons, which pin
        # everything else)
        "source": source,
    }


# --------------------------------------------------------------- forecast

def save_fork(
    path: str, *, cfg, state, seed, rounds, feed=None, lines_seen=0,
    chunk: int = 8,
) -> "object":
    """Write ANY twin state (final or mid-tail) as a what-if FORK token
    and return the loaded
    :class:`~corro_sim_torch.io.checkpoint.SimCheckpoint`. The cadence
    re-fork loop calls this from ``on_cycle`` with the in-flight state;
    :func:`fork_twin` is the end-of-run convenience wrapper."""
    from corro_sim_torch.io.checkpoint import (
        load_sim_checkpoint,
        save_fork_checkpoint,
    )

    save_fork_checkpoint(
        path, cfg=cfg, state=state, seed=seed, chunk=chunk,
        fork_round=rounds,
        meta={"feed": feed, "lines_seen": lines_seen},
    )
    return load_sim_checkpoint(path)


def fork_twin(result: TwinResult, path: str,
              chunk: int = 8) -> "object":
    """Write the live twin state as a what-if FORK token and return the
    loaded :class:`~corro_sim_torch.io.checkpoint.SimCheckpoint` — the
    state every forecast lane (and every serial repro) warm-starts
    from."""
    return save_fork(
        path, cfg=result.cfg, state=result.state, seed=result.seed,
        rounds=result.rounds, feed=result.report.get("feed"),
        lines_seen=result.stream.lines_seen, chunk=chunk,
    )


def run_forecast(
    fork,
    scenarios: list,
    seeds: list,
    rounds: int = 64,
    max_rounds: int = 512,
    chunk: int = 8,
    thresholds: dict | None = None,
    on_chunk=None,
    flight_dir: str | None = None,
    coupled_workload=None,
    device=None,
) -> dict:
    """Race the what-if grid from a fork token: one sweep of (scenario ×
    seed) warm-start lanes on ``device`` (default ``cuda``),
    frontier-graded against the ``twin_forecast`` threshold section.
    Returns the JAX package's forecast block, plus ``"sweep"``: the
    :class:`~corro_sim_torch.sweep.engine.SweepResult` whose lanes hold
    their final states (for a serial-twin check); ``breaches``
    non-empty is the failing condition (semantics unchanged from the
    soak/sweep gate).

    ``flight_dir``: demux every forecast lane's flight timeline
    (``projected: true`` in its meta — a projection, never a
    measurement) as per-lane ND-JSON under this directory. The returned
    block always carries a ``trend`` point (per-cell projected recovery
    at this fork round) and the fleet ``occupancy`` stats.

    ``coupled_workload``: a prebuilt
    :class:`~corro_sim_torch.workload.generators.Workload` (typically
    :func:`corro_sim_torch.workload.inject.trace_workload` over the
    feed's trailing window) replayed INTO every lane right after the
    fork — recovery graded under live traffic, not against a quiet
    cluster."""
    from corro_sim_torch.config import FaultConfig, NodeFaultConfig
    from corro_sim_torch.obs.lanes import (
        demux_flights,
        fleet_occupancy,
        write_lane_flights,
    )
    from corro_sim_torch.sweep.engine import run_sweep
    from corro_sim_torch.sweep.frontier import build_frontier, check_frontier
    from corro_sim_torch.sweep.plan import build_plan

    base = dataclasses.replace(
        fork.cfg, faults=FaultConfig(), node_faults=NodeFaultConfig(),
        write_rate=0.0,
    ).validate()
    plan = build_plan(
        base, scenarios, seeds, rounds=rounds, write_rounds=0,
        fork=fork, workload=coupled_workload,
    )
    res = run_sweep(
        plan, max_rounds=max_rounds, chunk=chunk, on_chunk=on_chunk,
        device=device,
    )
    frontier = build_frontier(res.lanes, projected=True)
    breaches = (
        check_frontier(frontier, thresholds, section="twin_forecast")
        if thresholds else []
    )
    frontier["thresholds_ok"] = not breaches
    frontier["breaches"] = breaches
    lane_flight_paths = None
    if flight_dir:
        lane_flight_paths = write_lane_flights(
            demux_flights(plan, res, breaches=breaches, projected=True),
            flight_dir,
        )
    # the projected-recovery trend POINT for this fork round: repeated
    # forecasts (continuous re-forking) append one per fork, forming the
    # trend lines the twin report publishes next to its shadow headlines
    trend = {
        "fork_round": fork.fork_round,
        "projected": True,
        "cells": [
            {
                "cell": c["cell"],
                "scenario": c["scenario"],
                "lanes": c["lanes"],
                "converged": c["converged"],
                "recovery_rounds": c["recovery_rounds"],
                "rows_lost_worst": c["rows_lost_worst"],
            }
            for c in frontier["cells"]
        ],
    }
    for lane in res.lanes:
        counters.inc(
            TWIN_FORECAST_LANES_TOTAL,
            labels=f'{{scenario="{lane.spec.split(":", 1)[0]}"}}',
            help_="what-if forecast lanes raced from a twin fork, by "
                  "scenario (engine/twin.py)",
        )
    return {
        "fork": fork.path,
        "fork_round": fork.fork_round,
        "lanes": plan.num_lanes,
        "rounds": rounds,
        "dispatches": res.dispatches,
        "wall_seconds": round(res.wall_seconds, 3),
        "compile_seconds": round(res.compile_seconds, 3),
        "compile_cache": res.compile_cache,
        "lanes_detail": [
            {
                "scenario": lr.spec,
                "seed": lr.seed,
                "cell": lr.cell,
                "converged_round": lr.converged_round,
                "rounds_run": lr.rounds,
                "recovery_rounds": lr.recovery_rounds,
                "poisoned": lr.poisoned,
                "rows_lost": (lr.resilience or {}).get("rows_lost"),
                "resync_rows": (lr.resilience or {}).get("resync_rows"),
                "invariants_ok": (lr.invariants or {}).get("ok", True),
                "repro_cmd": lr.repro_cmd,
            }
            for lr in res.lanes
        ],
        "frontier": frontier,
        "trend": trend,
        "occupancy": fleet_occupancy(res),
        **(
            {"coupled_load": {
                "workload": coupled_workload.spec,
                "rounds": coupled_workload.rounds,
                "events": coupled_workload.events,
            }}
            if coupled_workload is not None else {}
        ),
        **(
            {"lane_flights": {
                "dir": flight_dir, "count": len(lane_flight_paths),
            }}
            if lane_flight_paths is not None else {}
        ),
        "ok": not breaches and all(
            lr.converged_round is not None and not lr.poisoned
            for lr in res.lanes
        ),
        "sweep": res,
    }
