"""Prometheus text exposition for a LiveCluster, and the process-wide
counters and histograms of the run loop.

Port of ``corro_sim/utils/metrics.py``: :data:`counters`,
:data:`histograms` (the reference exporter's ``SECONDS_BUCKETS``, and
``CHUNK_SIZE_BUCKETS`` for the changes-per-round histogram),
:data:`gauges`, the per-queue :class:`ChannelMetrics`, the names of the
metric families, and :func:`render_prometheus`, the ``/metrics`` body.
Each registry keeps its series by ``(name, labels)``, labels in the
Prometheus text format (``'{reason="converged"}'``).

Metric names follow the reference's (dots become underscores, as its
Prometheus exporter mangles them): ``corro_broadcast_recv_count`` is
``corro.broadcast.recv.count``. The families of modules the port does
not have yet (lint, audit contracts and keys, the compile cache, the
perf ledger and the doctor) are left out.

What differs from the JAX package: a scrape reads the device state once,
reduced on the device (``LiveCluster.scrape_reads``: heads, per-node
backlogs, live rows per table, SWIM belief counts), where the JAX
package copies whole planes to the host; and ``corro_db_size_bytes`` is
the port's own resident bytes (``engine/sharding.py``), which are larger
where the port keeps a leaf in a wider carrier.
"""

from __future__ import annotations

import bisect
import re
import threading

# step-metric key → (prometheus name, type, help)
_SERIES = {
    "writes": (
        "corro_changes_committed_total", "counter",
        "local versions committed (make_broadcastable_changes analog)",
    ),
    "fresh": (
        "corro_changes_applied_total", "counter",
        "remote broadcast changes applied (process_multiple_changes analog)",
    ),
    "sync_versions": (
        "corro_sync_changes_recv_total", "counter",
        "versions repaired by anti-entropy sync",
    ),
    "dropped_window": (
        "corro_broadcast_dropped_total", "counter",
        "broadcasts dropped by bounded inboxes (handlers.rs:866-884 analog)",
    ),
    "deletes": (
        "corro_deletes_applied_total", "counter",
        "causal-length delete merges applied",
    ),
    "rounds": (
        "corro_sim_rounds_total", "counter",
        "simulation rounds executed",
    ),
    "gossip_cells": (
        "corro_broadcast_recv_cells_total", "counter",
        "cell lanes merged off the gossip delivery path",
    ),
    "sync_cells": (
        "corro_sync_recv_cells_total", "counter",
        "cell lanes shipped by anti-entropy sweeps",
    ),
}

# Byte-volume model for the wire counters below: one cell rides the wire
# as a `Change` row — table + pk + cid + val + col_version/db_version/seq
# ints + 16-byte site_id + cl (corro-api-types/src/lib.rs:235-245); ~128 B
# is the round JSON/speedy midpoint the reference's chunker assumes when
# it splits at ~8 KiB (change.rs:16-122). Chunk framing adds ~32 B.
CHANGE_WIRE_BYTES = 128
CHUNK_HEADER_BYTES = 32


# the reference exporter's bucket config (command/agent.rs:95-117)
SECONDS_BUCKETS = (
    0.001, 0.005, 0.025, 0.050, 0.100, 0.200,
    1.0, 2.0, 3.0, 4.0, 5.0, 10.0, 30.0, 60.0,
)
CHUNK_SIZE_BUCKETS = (1.0, 10.0, 75.0, 250.0, 375.0, 500.0, 650.0)

# ---- corro_pipeline_*: chunk-pipeline observability ------------------
# The host wall spent BLOCKED resolving a chunk's metric stacks, by
# mode: "sequential" (the blocking read of run_sim(pipeline=False)) or
# "pipelined" (the resolve of a copy started at dispatch, one chunk
# behind). Companion counters written by the driver: chunks dispatched
# ahead of the previous chunk's metrics, discarded speculative results
# by reason (converged | poisoned | program_switch), and the host wall
# spent concurrent with device chunk execution.
PIPELINE_FETCH_WAIT = "corro_pipeline_fetch_wait_seconds"
PIPELINE_FETCH_WAIT_HELP = (
    "host wall blocked resolving a chunk's packed metric stacks "
    "(device->host), by dispatch mode; sequential mode is the "
    "blocking-read stall the chunk pipeline hides"
)
# The host wall blocked on the sweep gate's read of its device predicate
# (engine/step.py::_sync_due: the copy's event wait), one sample a read.
SWEEP_GATE_WAIT = "corro_sweep_gate_wait_seconds"
SWEEP_GATE_WAIT_HELP = (
    "host wall blocked reading the sync sweep gate's device predicate "
    "(device->host), one sample per read"
)
# The sync sweeps by how they served their lanes (sync/serve.py):
# path="kernel" (the CUDA serve kernel) or "torch" (the plain lanes). The
# host counts one per sweep and reads nothing from the device.
SYNC_SERVE_TOTAL = "corro_sync_serve_total"
SYNC_SERVE_HELP = (
    "anti-entropy sweeps by the path that served their lanes "
    "(kernel | torch)"
)
# SWIM's full-view ticks by whether they ran the periodic announce
# (announce="1") or not ("0") (membership/swim.py::swim_step), those of
# a discarded speculative chunk too. The host counts them from the round
# number and the configuration and reads nothing from the device.
SWIM_TICKS_TOTAL = "corro_swim_ticks_total"
SWIM_TICKS_HELP = (
    "full-view SWIM ticks run, discarded speculative ones included, by "
    "whether they ran the periodic announce (0 | 1)"
)
PIPELINE_SPECULATIVE_TOTAL = "corro_pipeline_speculative_total"
PIPELINE_SPECULATIVE_WASTED = "corro_pipeline_speculative_wasted_total"
PIPELINE_OVERLAP_SECONDS = "corro_pipeline_overlap_seconds_total"


# ---- corro_config_downgrade_total: explicit config fallbacks ---------
# A run that cannot honor a requested config knob on this backend says
# so: each fallback increments this counter and lands a
# `config_downgrade` flight annotation:
#   corro_config_downgrade_total{field,reason}
# In the JAX package the merge kernel's fallback under a device mesh
# emits it; the port emits it once it has a mesh.
CONFIG_DOWNGRADE_TOTAL = "corro_config_downgrade_total"
CONFIG_DOWNGRADE_HELP = (
    "config knobs downgraded at run time because the backend cannot "
    "honor them, by field and reason (flight `config_downgrade` "
    "annotations carry the same provenance)"
)

# ---- corro_lint_*: static analysis + transfer-guard observability ----
# The corro-lint analyzer (analysis/lint.py, `lint`) exports its run
# profile as info counters:
#   corro_lint_runs_total                    analyzer invocations
#   corro_lint_files_scanned_total           files parsed
#   corro_lint_findings_total{rule,severity} findings by rule (CL1xx)
#   corro_lint_suppressions_total{rule}      `# corro-lint: ignore[...]`
#                                            hits
# The transfer guard (analysis/transfer_guard.py, armed by
# CORRO_SIM_TRANSFER_GUARD=1 / run_sim(transfer_guard=True)) counts
# every host read through the chunk loop's sanctioned points:
#   corro_lint_sanctioned_transfers_total{point}
LINT_RUNS_TOTAL = "corro_lint_runs_total"
LINT_FILES_SCANNED_TOTAL = "corro_lint_files_scanned_total"
LINT_FINDINGS_TOTAL = "corro_lint_findings_total"
LINT_SUPPRESSIONS_TOTAL = "corro_lint_suppressions_total"
LINT_SANCTIONED_TRANSFERS_TOTAL = "corro_lint_sanctioned_transfers_total"

# ---- corro_audit_contract_*: the program-contract auditor
# (analysis/contracts.py, `audit --contracts`), by family (vacuity |
# determinism | memory | collectives):
#   corro_audit_contract_checks_total{family}      contracts evaluated
#   corro_audit_contract_violations_total{family}  budget violations +
#                                                  manifest drift
AUDIT_CONTRACT_CHECKS_TOTAL = "corro_audit_contract_checks_total"
AUDIT_CONTRACT_VIOLATIONS_TOTAL = "corro_audit_contract_violations_total"

# ---- corro_audit_key_*: the key-lineage auditor (analysis/keys.py,
# `audit --keys`), by family (k1 | k2 | k3 | manifest):
#   corro_audit_key_checks_total{family}      lineage checks evaluated
#   corro_audit_key_violations_total{family}  violations + drift
AUDIT_KEY_CHECKS_TOTAL = "corro_audit_key_checks_total"
AUDIT_KEY_VIOLATIONS_TOTAL = "corro_audit_key_violations_total"

# ---- corro_workload_* / corro_sub_latency_*: the production workload
# engine (workload/, workload/harness.py). The load harness
# drives a compiled traffic schedule through a LiveCluster with
# concurrent subscriptions + query fans and records:
#   corro_workload_writes_total{kind="write"|"delete"}  schedule ops
#                                                       committed
#   corro_workload_rounds_total                         load rounds driven
#   corro_workload_coalesced_total     writes whose value never reached a
#                                      subscriber (overwritten before the
#                                      matcher diff ran — the reference's
#                                      candidate batching coalesces the
#                                      same way, pubsub.rs:1154-1296)
#   corro_workload_queries_total{surface="direct"|"http"|"pg"}
#                                      one-shot queries fanned per surface
#   corro_workload_events_total{kind}  burst onsets / churn waves executed
#                                      (batched path, engine/driver.py)
# and two delivery-latency histograms, change COMMIT → SubEvent emit:
#   corro_sub_latency_rounds   in simulation rounds (exact: events carry
#                              their emit round)
#   corro_sub_latency_seconds  host wall from API accept to queue drain
SUB_LATENCY_ROUNDS = "corro_sub_latency_rounds"
SUB_LATENCY_ROUNDS_HELP = (
    "subscription delivery latency in simulation rounds "
    "(change commit -> SubEvent emit)"
)
SUB_LATENCY_SECONDS = "corro_sub_latency_seconds"
SUB_LATENCY_SECONDS_HELP = (
    "subscription delivery wall latency (write accepted -> event "
    "drained by the subscriber)"
)
# ---- corro_node_fault_* / corro_resilience_*: the node-lifecycle
# fault domain + resilience scorecard (faults/nodes.py,
# faults/scorecard.py). Step
# metrics (additive node-round counters, emitted only while
# SimConfig.node_faults is enabled):
#   corro_node_fault_wipes_total        crash-restart wipes executed
#                                       (amnesia + stale restores)
#   corro_node_fault_straggling_total   straggler node-rounds parked by
#                                       the duty cycle
#   corro_node_fault_recovering_total   node-rounds spent resyncing a
#                                       wiped write cursor
# Scorecard families (one finalized block per graded run, labeled by
# scenario):
#   corro_resilience_runs_total             graded runs
#   corro_resilience_rows_lost_total        cells diverging from the
#                                           partition reference at the
#                                           convergence report
#   corro_resilience_resync_rows_total      version-applications repaid
#                                           to wiped nodes
#   corro_resilience_swim_false_down_total  belief pairs marking a live
#                                           node DOWN
#   corro_resilience_swim_flaps_total       false-DOWN pairs relapsing
#   corro_resilience_recovery_rounds        histogram: heal →
#                                           re-convergence (ROUNDS_BUCKETS)
NODE_FAULT_WIPES_TOTAL = "corro_node_fault_wipes_total"
RESILIENCE_RUNS_TOTAL = "corro_resilience_runs_total"
RESILIENCE_RECOVERY_ROUNDS = "corro_resilience_recovery_rounds"

WORKLOAD_WRITES_TOTAL = "corro_workload_writes_total"
WORKLOAD_ROUNDS_TOTAL = "corro_workload_rounds_total"
WORKLOAD_COALESCED_TOTAL = "corro_workload_coalesced_total"
WORKLOAD_QUERIES_TOTAL = "corro_workload_queries_total"


# ---- corro_sweep_*: the fleet sweep (sweep/engine.py, obs/lanes.py):
# lanes racing, converged and poisoned (gauges), lane-rounds dispatched
# for settled lanes (by the JAX package's definition: a dispatch
# executes its width, whether or not a slot's lane races), and each
# frontier cell's heal-to-re-convergence rounds (a histogram)
SWEEP_LANES_ACTIVE = "corro_sweep_lanes_active"
SWEEP_LANES_ACTIVE_HELP = (
    "sweep lanes still racing (not yet converged or poisoned; "
    "corro_sim_torch/sweep/engine.py)"
)
SWEEP_LANES_CONVERGED = "corro_sweep_lanes_converged"
SWEEP_LANES_CONVERGED_HELP = (
    "sweep lanes frozen at their convergence chunk"
)
SWEEP_LANES_POISONED = "corro_sweep_lanes_poisoned"
SWEEP_LANES_POISONED_HELP = (
    "sweep lanes frozen by the ring-wrap poison tripwire"
)
SWEEP_WASTED_LANE_ROUNDS_TOTAL = "corro_sweep_wasted_lane_rounds_total"
SWEEP_WASTED_LANE_ROUNDS_HELP = (
    "lane-rounds of dispatch width holding no racing lane "
    "(corro_sim_torch/obs/lanes.py fleet occupancy)"
)
SWEEP_RECOVERY_ROUNDS = "corro_sweep_recovery_rounds"
SWEEP_RECOVERY_ROUNDS_HELP = (
    "per-lane heal -> re-convergence rounds by frontier cell "
    "(scenario spec + knob suffix; corro_sim_torch/sweep/engine.py)"
)

# ---- corro_twin_*: the digital twin (engine/twin.py, io/feedsource.py):
#   corro_twin_feed_lines_total        feed lines consumed (good + bad)
#   corro_twin_bad_lines_total{reason} quarantined hostile feed lines by
#                                      reason (io/traces.py BAD_REASONS)
#   corro_twin_chunks_total            feed chunks shadowed
#   corro_twin_rounds_total            shadow sim rounds (feed + drain)
#   corro_twin_checkpoints_total       feed-cursor checkpoints written
#   corro_twin_resumes_total           shadows resumed from a cursor
#   corro_twin_forecast_lanes_total{scenario}
#                                      what-if lanes raced from a fork
#   corro_twin_delivery_rounds         histogram: shadowed delivery p99
#                                      in rounds (ROUNDS_BUCKETS)
# and of the live tail and the stale-universe refresh:
#   corro_twin_tail_polls_total{source}    polls by a live source
#                                          (file|http)
#   corro_twin_tail_retries_total{source}  jittered-backoff retries
#   corro_twin_tail_rotations_total        feed rotations re-bound
#   corro_twin_tail_source_deaths_total{reason}
#                                          sources declared dead
#   corro_twin_tail_lag_lines              gauge: lines buffered ahead of
#                                          the shadow's cursor
#   corro_twin_refresh_total{trigger}      closed-world re-freezes
#   corro_twin_refresh_epoch               gauge: current refresh epoch
TWIN_BAD_LINES_TOTAL = "corro_twin_bad_lines_total"
TWIN_BAD_LINES_HELP = (
    "hostile feed lines quarantined by the twin shadow, by reason "
    "(corro_sim/io/traces.py)"
)
TWIN_FEED_LINES_TOTAL = "corro_twin_feed_lines_total"
TWIN_DELIVERY_ROUNDS = "corro_twin_delivery_rounds"
TWIN_FORECAST_LANES_TOTAL = "corro_twin_forecast_lanes_total"
TWIN_TAIL_POLLS_TOTAL = "corro_twin_tail_polls_total"
TWIN_TAIL_POLLS_HELP = (
    "live feed polls issued, by source kind (corro_sim/io/feedsource.py)"
)
TWIN_TAIL_RETRIES_TOTAL = "corro_twin_tail_retries_total"
TWIN_TAIL_RETRIES_HELP = (
    "jittered exponential-backoff retries against a missing or failing "
    "live feed source (corro_sim/io/feedsource.py)"
)
TWIN_TAIL_ROTATIONS_TOTAL = "corro_twin_tail_rotations_total"
TWIN_TAIL_ROTATIONS_HELP = (
    "feed-file rotations the tail re-bound to (inode changed under the "
    "consumed-prefix sha guard; corro_sim/io/feedsource.py)"
)
TWIN_TAIL_SOURCE_DEATHS_TOTAL = "corro_twin_tail_source_deaths_total"
TWIN_TAIL_SOURCE_DEATHS_HELP = (
    "live feed sources declared dead, by reason (idle_timeout|"
    "source_gone|reconnect_budget|truncated; corro_sim/io/feedsource.py)"
)
TWIN_TAIL_LAG_LINES = "corro_twin_tail_lag_lines"
TWIN_TAIL_LAG_LINES_HELP = (
    "feed lines buffered ahead of the shadow's cursor (bounded by "
    "twin.max_lag_lines; corro_sim/engine/twin.py)"
)
TWIN_REFRESH_TOTAL = "corro_twin_refresh_total"
TWIN_REFRESH_HELP = (
    "stale-universe re-freezes (scheduled re-key events), by trigger "
    "(corro_sim/engine/twin.py)"
)
TWIN_REFRESH_EPOCH = "corro_twin_refresh_epoch"
TWIN_REFRESH_EPOCH_HELP = (
    "current closed-world refresh epoch of the running twin shadow "
    "(corro_sim/engine/twin.py)"
)
# Subscription evaluation (subs/manager.py): plain single-table matchers
# whose device predicates share a structure skeleton evaluate as ONE
# group per step (SubsManager._batched_precompute):
#   corro_subs_matcher_evals_total{mode="batched"|"single"}  matcher
#       evaluations by dispatch mode (batched = rode a group evaluation)
#   corro_subs_batch_groups_total    batched group dispatches
SUBS_MATCHER_EVALS_TOTAL = "corro_subs_matcher_evals_total"
SUBS_BATCH_GROUPS_TOTAL = "corro_subs_batch_groups_total"

# Kernel-library builds (utils/compile_cache.py CompileCacheProbe, fed by
# core/merge_kernel.py::build_kernel's lookup):
#   corro_compile_cache_hits_total{program}    lookups served by a library
#                                              on disk or already loaded
#   corro_compile_cache_misses_total{program}  lookups that ran nvcc
#   corro_compile_cold_seconds{program}        nvcc's wall on the misses
# The same numbers ride RunResult.compile_cache and the bench reports.
COMPILE_CACHE_HITS_TOTAL = "corro_compile_cache_hits_total"
COMPILE_CACHE_MISSES_TOTAL = "corro_compile_cache_misses_total"
COMPILE_COLD_SECONDS = "corro_compile_cold_seconds"
COMPILE_COLD_SECONDS_HELP = (
    "nvcc wall of the kernel-library builds that missed the build "
    "directory, by kernel library"
)

# The performance ledger (obs/ledger.py):
#   corro_perf_ledger_records          records in the loaded ledger
#   corro_perf_ledger_series           distinct (config, platform) series
#   corro_perf_latest_value{series}    latest measured value per series
#   corro_perf_check_breaches          band breaches at the last --check
#   corro_perf_check_skipped_cross_platform
#                                      series honest-skipped (capture
#                                      platform != band platform)
#   corro_perf_unmeasured_records      explicit unmeasured records (the
#                                      device-preflight-failure shape)
PERF_LEDGER_RECORDS = "corro_perf_ledger_records"
PERF_LEDGER_RECORDS_HELP = (
    "records in the loaded performance ledger (obs/ledger.py)"
)
PERF_LEDGER_SERIES = "corro_perf_ledger_series"
PERF_LEDGER_SERIES_HELP = (
    "distinct (config, platform) series in the performance ledger"
)
PERF_LATEST_VALUE = "corro_perf_latest_value"
PERF_LATEST_VALUE_HELP = (
    "latest measured value per ledger series (label: series = "
    "config@platform)"
)
PERF_CHECK_BREACHES = "corro_perf_check_breaches"
PERF_CHECK_BREACHES_HELP = (
    "series breaching their tolerance band at the last `perf --check` "
    "(the exit-6 regression sentinel)"
)
PERF_CHECK_SKIPPED = "corro_perf_check_skipped_cross_platform"
PERF_CHECK_SKIPPED_HELP = (
    "series honest-skipped at the last check: the capture's platform "
    "differs from every banded platform for its config — CPU-relative "
    "numbers are never graded against device baselines"
)
PERF_UNMEASURED_RECORDS = "corro_perf_unmeasured_records"
PERF_UNMEASURED_RECORDS_HELP = (
    "explicit unmeasured ledger records (device preflight failures) — "
    "holes the trajectory shows, never grades"
)

# The run doctor (obs/doctor.py):
#   corro_doctor_findings_total{rule,severity}
#                                      findings at the last diagnosis,
#                                      per rule and severity
#   corro_doctor_artifacts_scanned     artifacts the last diagnosis read
#   corro_doctor_artifacts_skipped     artifacts honest-skipped with a
#                                      reason (unreadable/unrecognized)
#   corro_doctor_critical_findings     critical findings at the last
#                                      diagnosis (the --check exit-6
#                                      tripwire)
DOCTOR_FINDINGS_TOTAL = "corro_doctor_findings_total"
DOCTOR_FINDINGS_TOTAL_HELP = (
    "findings at the last doctor diagnosis, labeled by rule and "
    "severity (obs/doctor.py)"
)
DOCTOR_ARTIFACTS_SCANNED = "corro_doctor_artifacts_scanned"
DOCTOR_ARTIFACTS_SCANNED_HELP = (
    "telemetry artifacts the last doctor diagnosis classified and read"
)
DOCTOR_ARTIFACTS_SKIPPED = "corro_doctor_artifacts_skipped"
DOCTOR_ARTIFACTS_SKIPPED_HELP = (
    "artifacts the last doctor diagnosis honest-skipped with a counted "
    "reason (unreadable, unrecognized, torn) — visible, never fatal"
)
DOCTOR_CRITICAL_FINDINGS = "corro_doctor_critical_findings"
DOCTOR_CRITICAL_FINDINGS_HELP = (
    "critical findings at the last doctor diagnosis — nonzero trips "
    "`doctor --check` exit 6, the shared regression tripwire code"
)
ROUNDS_BUCKETS = (
    0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0,
    64.0, 96.0, 128.0,
)


class Histogram:
    """A Prometheus histogram: cumulative bucket counts, sum, count."""

    __slots__ = ("buckets", "counts", "sum", "count", "max")

    def __init__(self, buckets=SECONDS_BUCKETS):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1
        if value > self.max:
            self.max = value

    def quantile(self, q: float) -> float | None:
        """Bucket-resolution quantile estimate: the upper bound of the
        bucket the q-th sample falls in, clamped to the observed max
        (the max itself for the +Inf tail)."""
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                if i >= len(self.buckets):
                    return self.max
                return min(float(self.buckets[i]), self.max)
        return self.max


class HistogramRegistry:
    """Named histograms, ``(name, labels) -> Histogram``."""

    def __init__(self):
        self._h: dict[tuple, Histogram] = {}
        self._help: dict[str, str] = {}
        self._lock = threading.Lock()

    def observe(self, name: str, value: float, labels: str = "",
                help_: str = "", buckets=SECONDS_BUCKETS) -> None:
        with self._lock:
            h = self._h.get((name, labels))
            if h is None:
                h = self._h[(name, labels)] = Histogram(buckets)
                if help_:
                    self._help.setdefault(name, help_)
            h.observe(value)

    def observe_many(self, name: str, values, labels: str = "",
                     help_: str = "", buckets=SECONDS_BUCKETS) -> None:
        """Many samples under one lock acquisition (a whole drain's or
        dispatch's worth)."""
        if not values:
            return
        with self._lock:
            h = self._h.get((name, labels))
            if h is None:
                h = self._h[(name, labels)] = Histogram(buckets)
                if help_:
                    self._help.setdefault(name, help_)
            for v in values:
                h.observe(v)

    def get(self, name: str, labels: str = "") -> Histogram | None:
        with self._lock:
            return self._h.get((name, labels))

    def quantile(self, name: str, q: float,
                 labels: str = "") -> float | None:
        """Bucket-resolution quantile of one series (None when empty)."""
        h = self.get(name, labels)
        return h.quantile(q) if h is not None else None

    def render(self) -> list[str]:
        with self._lock:
            out = []
            seen = set()
            for (name, labels), h in sorted(self._h.items()):
                if name not in seen:
                    seen.add(name)
                    out.append(
                        f"# HELP {name} {self._help.get(name, name)}")
                    out.append(f"# TYPE {name} histogram")
                base = labels[1:-1] if labels else ""
                cum = 0
                for b, c in zip(h.buckets, h.counts):
                    cum += c
                    lbl = f'{base},le="{b}"' if base else f'le="{b}"'
                    out.append(f"{name}_bucket{{{lbl}}} {cum}")
                lbl = f'{base},le="+Inf"' if base else 'le="+Inf"'
                out.append(f"{name}_bucket{{{lbl}}} {h.count}")
                sfx = f"{{{base}}}" if base else ""
                out.append(f"{name}_sum{sfx} {round(h.sum, 6)}")
                out.append(f"{name}_count{sfx} {h.count}")
            return out


class CounterRegistry:
    """Named counters, ``(name, labels) -> value``."""

    def __init__(self):
        self._c: dict[tuple, float] = {}
        self._help: dict[str, str] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: float = 1, labels: str = "",
            help_: str = "") -> None:
        with self._lock:
            self._c[(name, labels)] = self._c.get((name, labels), 0) + n
            if help_:
                self._help.setdefault(name, help_)

    def get(self, name: str, labels: str = "") -> float:
        with self._lock:
            return self._c.get((name, labels), 0)

    def render(self) -> list[str]:
        return _render_values(self, "counter")


histograms = HistogramRegistry()
counters = CounterRegistry()


class GaugeRegistry:
    """Named last-value gauges, ``(name, labels) -> value``."""

    def __init__(self):
        self._g: dict[tuple, float] = {}
        self._help: dict[str, str] = {}
        self._lock = threading.Lock()

    def set(self, name: str, value: float, labels: str = "",
            help_: str = "") -> None:
        with self._lock:
            self._g[(name, labels)] = value
            if help_:
                self._help.setdefault(name, help_)

    def get(self, name: str, labels: str = "") -> float | None:
        with self._lock:
            return self._g.get((name, labels))

    def render(self) -> list[str]:
        return _render_values(self, "gauge")


def _render_values(reg, kind: str) -> list[str]:
    """A counter or gauge registry's series in the text format."""
    values = reg._c if kind == "counter" else reg._g
    with reg._lock:
        out = []
        seen = set()
        for (name, labels), v in sorted(values.items()):
            if name not in seen:
                seen.add(name)
                out.append(f"# HELP {name} {reg._help.get(name, name)}")
                out.append(f"# TYPE {name} {kind}")
            out.append(f"{name}{labels} {v}")
        return out


gauges = GaugeRegistry()


class ChannelMetrics:
    """Per-queue health counters, the ``corro.runtime.channel.*`` series
    (``corro-types/src/channel.rs:16-184``): send, recv and failed-send
    counts, depth and capacity gauges, and a send-delay EWMA per named
    channel. The host-side queues (the write queue, the subscription
    event queues) count at their touch points. ``histograms``: where
    the send-delay histogram lands (the owning cluster's registry)."""

    def __init__(self, histograms: HistogramRegistry | None = None):
        self._ch: dict[str, dict] = {}
        self._labels: dict[str, str] = {}
        self.histograms = histograms
        self._lock = threading.Lock()  # touch points span threads

    def _c(self, name: str) -> dict:
        return self._ch.setdefault(
            name, {"send": 0, "recv": 0, "failed": 0, "depth": 0,
                   "capacity": 0, "send_delay_ewma_ms": 0.0,
                   "delay_samples": 0})

    def set_capacity(self, name: str, capacity: int) -> None:
        with self._lock:
            self._c(name)["capacity"] = int(capacity)

    def set_depth(self, name: str, depth: int) -> None:
        with self._lock:
            self._c(name)["depth"] = int(depth)

    def on_send(self, name: str, n: int = 1,
                delay_s: float | None = None) -> None:
        with self._lock:
            c = self._c(name)
            c["send"] += n
            c["depth"] += n
            if delay_s is not None:
                ms = delay_s * 1000.0
                c["send_delay_ewma_ms"] += 0.2 * (
                    ms - c["send_delay_ewma_ms"])
                c["delay_samples"] += 1
        if delay_s is not None:
            lbl = self._labels.get(name)
            if lbl is None:
                lbl = self._labels[name] = f'{{channel_name="{name}"}}'
            (self.histograms or histograms).observe(
                "corro_runtime_channel_send_delay_seconds", delay_s,
                labels=lbl,
                help_="send delay per channel "
                      "(corro.runtime.channel.send_delay)",
            )

    def on_recv(self, name: str, n: int = 1) -> None:
        with self._lock:
            c = self._c(name)
            c["recv"] += n
            c["depth"] = max(0, c["depth"] - n)

    def on_failed(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c(name)["failed"] += n

    def snapshot(self) -> dict:
        with self._lock:
            return {k: dict(v) for k, v in self._ch.items()}


def render_prometheus(cluster) -> str:
    """The ``/metrics`` body for ``cluster``. Its device state is read
    once, through ``cluster.scrape_reads()``."""
    lines: list[str] = []
    reads = cluster.scrape_reads()

    def emit(name, kind, help_, value, labels=""):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{labels} {value}")

    totals = cluster.metrics_totals()
    for key, (name, kind, help_) in _SERIES.items():
        if key in totals:
            emit(name, kind, help_, int(totals[key]))
    # remaining step metrics, generically. probe_* step metrics are
    # GAUGES (infected count, cumulative dups) — summing them across
    # rounds would lie; they render in the probe block below instead.
    # fault_* metrics render in their own corro_fault_* block.
    for key, v in sorted(totals.items()):
        if (
            key not in _SERIES
            and not key.startswith(("probe_", "fault_", "node_fault_"))
        ):
            emit(
                f"corro_sim_{key}_total", "counter",
                f"sim step metric {key}", v,
            )

    # ---- node-lifecycle faults (corro_sim/faults/nodes.py): additive
    # node-round counters, named corro_node_fault_* so the driver-side
    # counters and soak dashboards line up.
    for key in sorted(k for k in totals if k.startswith("node_fault_")):
        emit(
            f"corro_{key}_total", "counter",
            f"node-lifecycle fault flow {key[11:]} "
            "(corro_sim/faults/nodes.py)",
            int(totals[key]),
        )

    # ---- chaos injection (corro_sim/faults/): injected-fault flow
    # counters + the burst-state gauge, named corro_fault_* so soak
    # dashboards and the driver-side counters line up.
    fault_totals = {
        k: int(v) for k, v in totals.items()
        if k.startswith("fault_") and k != "fault_burst_nodes"
    }
    _faults = getattr(getattr(cluster, "cfg", None), "faults", None)
    if fault_totals or (_faults is not None and _faults.enabled):
        for key in sorted(fault_totals):
            emit(
                f"corro_{key}_total", "counter",
                f"injected fault effect {key[6:]} (corro_sim/faults/)",
                fault_totals[key],
            )
        emit(
            "corro_fault_burst_nodes", "gauge",
            "nodes currently in the burst-loss state",
            int(cluster.metrics_lasts().get("fault_burst_nodes", 0)),
        )

    # ---- wire byte volume (corro.broadcast.recv.bytes /
    # corro.sync.chunk.sent.bytes analogs, agent/metrics.rs): modeled from
    # the cell/chunk counters via the Change wire-size constants above.
    g_cells = int(totals.get("gossip_cells", 0))
    g_chunks = int(totals.get("delivered", 0))
    bcast_bytes = g_cells * CHANGE_WIRE_BYTES + g_chunks * CHUNK_HEADER_BYTES
    emit(
        "corro_broadcast_recv_bytes_total", "counter",
        "modeled broadcast bytes received "
        f"(cells*{CHANGE_WIRE_BYTES} + chunks*{CHUNK_HEADER_BYTES})",
        bcast_bytes,
    )
    s_cells = int(totals.get("sync_cells", 0))
    s_versions = int(totals.get("sync_versions", 0))
    emit(
        "corro_sync_chunk_sent_bytes_total", "counter",
        "modeled anti-entropy bytes shipped "
        f"(cells*{CHANGE_WIRE_BYTES} + versions*{CHUNK_HEADER_BYTES})",
        s_cells * CHANGE_WIRE_BYTES + s_versions * CHUNK_HEADER_BYTES,
    )

    # ---- per-stage round timing (tools/profile_round.py's live analog;
    # VERDICT r2 #9): wall-clock per simulation round by host stage.
    stages = cluster.stage_timings()
    if stages:
        lines.append(
            "# HELP corro_round_stage_ms per-round wall-clock by stage (ewma)"
        )
        lines.append("# TYPE corro_round_stage_ms gauge")
        for stage, t in sorted(stages.items()):
            lines.append(
                f'corro_round_stage_ms{{stage="{stage}"}} {t["ewma_ms"]}'
            )
            lines.append(
                f'corro_round_stage_ms{{stage="{stage}",window="last"}} '
                f'{t["last_ms"]}'
            )

    # live gauges (agent/metrics.rs:18-108 analog: rows, gaps, members)
    head = reads["head"]
    gap = reads["behind"].sum()
    emit(
        "corro_sync_gaps_count", "gauge",
        "total unapplied (node, actor) version gap", int(gap),
    )
    alive = int(cluster._alive.sum())
    emit(
        "corro_members_alive", "gauge",
        "nodes marked alive by the harness", alive,
    )

    # ---- reference-named series (agent/metrics.rs and friends) mapped
    # from the same underlying data, so dashboards built against the
    # reference's names point here unchanged.
    lasts = cluster.metrics_lasts()
    emit("corro_gossip_cluster_size", "gauge",
         "configured cluster size (corro.gossip.cluster_size)",
         cluster.cfg.num_nodes)
    emit("corro_gossip_members", "gauge",
         "live members (corro.gossip.members)", alive)
    lines.append("# HELP corro_gossip_member_states members by SWIM state "
                 "(corro.gossip.member.states)")
    lines.append("# TYPE corro_gossip_member_states gauge")
    suspects = int(lasts.get("swim_suspects", 0))
    downs = int(lasts.get("swim_down", 0))
    lines.append(f'corro_gossip_member_states{{state="alive"}} '
                 f"{max(alive - suspects - downs, 0)}")
    lines.append(f'corro_gossip_member_states{{state="suspect"}} {suspects}')
    lines.append(f'corro_gossip_member_states{{state="down"}} {downs}')
    emit("corro_gossip_config_max_transmissions", "gauge",
         "broadcast re-send budget (corro.gossip.config.max_transmissions)",
         cluster.cfg.max_transmissions)
    emit("corro_gossip_config_num_indirect_probes", "gauge",
         "SWIM indirect probes (corro.gossip.config.num_indirect_probes)",
         cluster.cfg.swim_indirect_probes)
    emit("corro_broadcast_pending_count", "gauge",
         "live pending-broadcast slots (corro.broadcast.pending.count)",
         int(lasts.get("pend_live", 0)))
    emit("corro_broadcast_recv_count_total", "counter",
         "broadcast datagrams delivered (corro.broadcast.recv.count)",
         int(totals.get("delivered", 0)))
    emit("corro_agent_changes_recv_total", "counter",
         "change messages received (corro.agent.changes.recv)",
         int(totals.get("delivered", 0)))
    emit("corro_agent_changes_in_queue", "gauge",
         "buffered partial versions (corro.agent.changes.in_queue)",
         int(cluster._partials))
    emit("corro_db_buffered_changes_rows_total", "gauge",
         "buffered seq-incomplete rows (corro.db.buffered.changes.rows)",
         int(cluster._partials))
    emit("corro_db_gaps_sum", "gauge",
         "unapplied version gap total (corro.db.gaps.sum)", int(gap))
    emit("corro_sync_client_needed", "gauge",
         "versions the cluster still needs (corro.sync.client.needed)",
         int(gap))
    emit("corro_sync_client_head", "gauge",
         "max version head written (corro.sync.client.head)",
         int(head.max()) if head.size else 0)
    emit("corro_sync_changes_sent_total", "counter",
         "versions served by sync (corro.sync.changes.sent; symmetric to "
         "recv in-process)", int(totals.get("sync_versions", 0)))
    emit("corro_sync_client_req_sent_total", "counter",
         "sync requests sent (corro.sync.client.req.sent)",
         int(totals.get("sync_requests", 0)))
    lines.append("# HELP corro_sync_client_member sync admissions by result "
                 "(corro.sync.client.member)")
    lines.append("# TYPE corro_sync_client_member counter")
    lines.append(f'corro_sync_client_member{{result="accepted"}} '
                 f"{int(totals.get('sync_pairs', 0))}")
    lines.append(f'corro_sync_client_member{{result="rejected"}} '
                 f"{int(totals.get('sync_rejections', 0))}")
    emit("corro_sync_empties_count_total", "counter",
         "cleared versions served as empties (corro.sync.empties.count)",
         int(totals.get("sync_empties", 0)))
    emit("corro_peer_datagram_sent_total", "counter",
         "gossip datagrams emitted (corro.peer.datagram.sent.total)",
         int(totals.get("msgs_sent", 0)))
    emit("corro_peer_datagram_recv_total", "counter",
         "gossip datagrams delivered (corro.peer.datagram.recv.total)",
         int(totals.get("delivered", 0)))
    emit("corro_peer_datagram_bytes_recv_total", "counter",
         "modeled datagram bytes received (corro.peer.datagram.bytes.recv; "
         "same wire model as corro_broadcast_recv_bytes_total)",
         bcast_bytes)
    emit("corro_peer_connection_accept_total", "counter",
         "sync connections admitted (corro.peer.connection.accept.total)",
         int(totals.get("sync_pairs", 0)))
    _ch = getattr(cluster, "channels", None)
    emit("corro_subs_changes_matched_count_total", "counter",
         "subscription events matched+queued "
         "(corro.subs.changes.matched.count)",
         int(_ch.snapshot().get("subs_events", {}).get("send", 0))
         if _ch is not None else 0)
    # modeled database footprint (corro.db.size analog): resident bytes of
    # the cluster state tensors, from their shapes
    from corro_sim_torch.engine.sharding import state_bytes

    total_bytes, _ = state_bytes(cluster.cfg)
    emit("corro_db_size_bytes", "gauge",
         "modeled resident state bytes (corro.db.size analog)",
         int(total_bytes))
    emit(
        "corro_subs_count", "gauge",
        "registered live-query matchers", len(cluster.subs),
    )
    stats = reads["table_stats"]
    lines.append(
        "# HELP corro_db_table_rows live rows per table (max over nodes)"
    )
    lines.append("# TYPE corro_db_table_rows gauge")
    for t, s in stats.items():
        rows = max(s["live_rows_per_node"], default=0)
        lines.append(f'corro_db_table_rows{{table="{t}"}} {rows}')
    pending = sum(len(q) for q in cluster._pending)
    emit(
        "corro_write_queue_pending", "gauge",
        "queued uncommitted changesets (SplitPool write queue analog)",
        pending,
    )

    # ---- per-channel queue health (corro.runtime.channel.*,
    # channel.rs:16-184): host-side queues count at their touch points;
    # the device-side gossip pending rings derive theirs from step
    # metrics (sends = enqueued chunks, recvs = emissions, failed =
    # overflow clobbers, depth = live slots after the last round).
    chans = getattr(cluster, "channels", None)
    if chans is not None:
        snap = chans.snapshot()
        lasts = getattr(cluster, "metrics_lasts", lambda: {})()
        snap["gossip_pending"] = {
            "send": int(
                totals.get("fresh_chunks", 0) + totals.get("writes", 0)
            ),
            "recv": int(totals.get("msgs_sent", 0)),
            "failed": int(lasts.get("queue_overflow", 0)),
            "depth": int(lasts.get("pend_live", 0)),
            "capacity": cluster.cfg.num_nodes * cluster.cfg.pend_slots,
            "send_delay_ewma_ms": 0.0,
        }
        series = [
            ("send", "corro_runtime_channel_send_count_total", "counter",
             "items enqueued per channel"),
            ("recv", "corro_runtime_channel_recv_count_total", "counter",
             "items dequeued per channel"),
            ("failed", "corro_runtime_channel_failed_send_count_total",
             "counter", "failed/overflowing sends per channel"),
            ("depth", "corro_runtime_channel_depth", "gauge",
             "current queued items per channel"),
            ("capacity", "corro_runtime_channel_max_capacity", "gauge",
             "channel capacity (0 = unbounded)"),
            ("send_delay_ewma_ms", "corro_runtime_channel_send_delay_ms",
             "gauge", "EWMA send delay per channel (only channels with "
             "observed samples; host queues are unbounded deques that "
             "never block)"),
        ]
        for field, name, kind, help_ in series:
            rows_out = []
            for cname in sorted(snap):
                if (
                    field == "send_delay_ewma_ms"
                    and not snap[cname].get("delay_samples")
                ):
                    continue  # never measured — don't fake a healthy 0
                rows_out.append(
                    f'{name}{{channel_name="{cname}"}} '
                    f"{snap[cname][field]}"
                )
            if rows_out:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {kind}")
                lines.extend(rows_out)

    # ---- per-table live rows per node (agent/metrics.rs per-table rows).
    # Per-node breakdown only below a cardinality cap: tables x N series
    # at simulator scale (10k+) would be a classic Prometheus explosion;
    # corro_db_table_rows (max over nodes) always covers the signal.
    if cluster.cfg.num_nodes <= 64:
        lines.append(
            "# HELP corro_db_table_rows_node live rows per table per node"
        )
        lines.append("# TYPE corro_db_table_rows_node gauge")
        for t, s in stats.items():
            for node, rows in enumerate(s["live_rows_per_node"]):
                lines.append(
                    f'corro_db_table_rows_node'
                    f'{{table="{t}",node="{node}"}} {rows}'
                )

    # ---- versioning / bookkeeping gauges (agent/metrics.rs:18-108)
    emit(
        "corro_db_versions_written", "gauge",
        "changeset versions written across all actors (log heads sum)",
        int(head.sum()),
    )
    emit(
        "corro_db_versions_applied", "gauge",
        "applied (node, actor) version count (booked heads sum)",
        reads["book_sum"],
    )
    cleared = reads["cleared"]
    emit(
        "corro_db_cleared_versions", "gauge",
        "versions fully superseded (empty changesets; compaction analog)",
        cleared,
    )
    emit(
        "corro_db_log_capacity", "gauge",
        "change-log ring capacity per actor", cluster.state.log.capacity,
    )

    # ---- gossip ring occupancy (broadcast buffer gauges analog)
    emit(
        "corro_broadcast_pending_slots", "gauge",
        "live pending-broadcast ring slots across the cluster",
        reads["pend_live"],
    )
    emit(
        "corro_broadcast_ring_capacity", "gauge",
        "pending-broadcast ring slots total", reads["pend_size"],
    )

    # ---- value universe / layout (sqlite freelist + db size analog)
    uni = cluster.universe
    emit(
        "corro_db_interned_values", "gauge",
        "distinct interned SQLite values (rank universe size)", len(uni),
    )
    layout = cluster.layout
    used = sum(layout._used.values())
    cap = sum(c for _, c in layout._ranges.values())
    emit(
        "corro_db_row_slots_used", "gauge",
        "allocated row slots across tables", used,
    )
    emit(
        "corro_db_row_slots_capacity", "gauge",
        "row slot capacity across tables", cap,
    )

    # ---- lock registry (lock queue timing gauges, agent.rs:716-723)
    snap = cluster.locks.snapshot()
    emit(
        "corro_lock_registry_active", "gauge",
        "currently tracked lock acquisitions", len(snap),
    )

    # ---- subscription queue depths (channel capacity gauges analog)
    qdepth = sum(
        len(q) for qs in cluster._sub_queues.values() for q in qs
    )
    emit(
        "corro_subs_queued_events", "gauge",
        "events buffered in subscriber queues", qdepth,
    )
    lines.append(
        "# HELP corro_subs_change_id latest change id per matcher"
    )
    lines.append("# TYPE corro_subs_change_id gauge")
    for sub_id, m in cluster.subs._by_id.items():
        lines.append(
            f'corro_subs_change_id{{id="{sub_id}"}} {m.change_id}'
        )

    # ---- SWIM state breakdown (gossip/SWIM counts, broadcast/mod.rs)
    # the per-node belief counts sum to the (observer, member) totals
    if cluster.cfg.swim_enabled:
        emit(
            "corro_swim_suspected_entries", "gauge",
            "suspect beliefs across all (observer, member) pairs",
            int(reads["suspected_by"].sum()),
        )
        emit(
            "corro_swim_down_entries", "gauge",
            "down beliefs across all (observer, member) pairs",
            int(reads["down_by"].sum()),
        )
        emit(
            "corro_swim_incarnation_max", "gauge",
            "highest self-incarnation (refutation count)",
            int(reads["self_inc"].max()),
        )

    # ---- flight recorder summary gauges (the durable per-round
    # timeline; full curve via GET /v1/flight / `corro-sim flight`)
    fl = getattr(cluster, "flight", None)
    if fl is not None:
        diag = fl.diagnostics()
        emit("corro_flight_rounds_recorded", "gauge",
             "rounds held in the flight-recorder ring",
             diag["rounds_recorded"])
        emit("corro_flight_events_recorded", "gauge",
             "annotation events held in the flight recorder",
             diag["events_recorded"])
        emit("corro_flight_converged_round", "gauge",
             "first round of the trailing gap==0 run (-1: not converged)",
             diag["converged_round"]
             if diag["converged_round"] is not None else -1)
        if diag["gap_half_life_rounds"] is not None:
            emit("corro_flight_gap_half_life_rounds", "gauge",
                 "gossip mixing rate: rounds for the gap to halve "
                 "(log-linear fit over the decay tail)",
                 diag["gap_half_life_rounds"])
        if diag["epidemic_window_rounds"] is not None:
            emit("corro_flight_epidemic_window_rounds", "gauge",
                 "rounds the gap spent above 10% of its peak",
                 diag["epidemic_window_rounds"])

    # ---- probe tracer + per-node lag observatory (obs/probes.py): the
    # /metrics face of the gossip provenance — full infection trees ride
    # GET /v1/probes / `corro-sim probes`. The lag observatory renders
    # with probes off too (only its sync-age column needs the tracer).
    lag = reads["node_lag"]
    emit("corro_node_lag_rows_behind_sum", "gauge",
         "versions written cluster-wide not yet applied, summed over "
         "live nodes", lag["rows_behind_total"])
    emit("corro_node_lag_rows_behind_max", "gauge",
         "worst live node's unapplied-version backlog",
         lag["rows_behind_max"])
    emit("corro_node_lag_nodes_lagging", "gauge",
         "live nodes with a nonzero unapplied-version backlog",
         lag["lagging_nodes"])
    if lag["last_sync_age_max"] is not None:
        emit("corro_node_lag_last_sync_age_max", "gauge",
             "rounds since the stalest live node took part in an "
             "anti-entropy sweep", lag["last_sync_age_max"])
    if lag["top_laggards"]:
        lines.append("# HELP corro_node_lag_rows_behind top-k "
                     "laggards: unapplied-version backlog per node")
        lines.append("# TYPE corro_node_lag_rows_behind gauge")
        for row in lag["top_laggards"]:
            lines.append(
                f'corro_node_lag_rows_behind{{node="{row["node"]}"}} '
                f'{row["rows_behind"]}'
            )
        if "suspected_by" in lag["top_laggards"][0]:
            lines.append("# HELP corro_node_lag_suspected_by top-k "
                         "laggards: SWIM observers suspecting the node")
            lines.append("# TYPE corro_node_lag_suspected_by gauge")
            for row in lag["top_laggards"]:
                lines.append(
                    f'corro_node_lag_suspected_by'
                    f'{{node="{row["node"]}"}} {row["suspected_by"]}'
                )
        if "last_sync_age" in lag["top_laggards"][0]:
            lines.append("# HELP corro_node_lag_last_sync_age top-k "
                         "laggards: rounds since the node's last "
                         "anti-entropy sweep (-1 = never)")
            lines.append("# TYPE corro_node_lag_last_sync_age gauge")
            for row in lag["top_laggards"]:
                lines.append(
                    f'corro_node_lag_last_sync_age'
                    f'{{node="{row["node"]}"}} {row["last_sync_age"]}'
                )
    tr = reads["probe"]
    if tr is not None:
        emit("corro_probe_count", "gauge",
             "versions tracked by the on-device probe tracer",
             tr.num_probes)
        fams = (
            ("coverage", "corro_probe_coverage",
             "fraction of the cluster holding the probe's version"),
            ("infected", "corro_probe_infected",
             "nodes holding the probe's version"),
            ("dup_deliveries", "corro_probe_dup_total",
             "delivered probe chunks that landed on already-infected "
             "nodes (redundancy)"),
            ("delivery_round_p50", "corro_probe_delivery_round_p50",
             "median delivery round relative to the origin commit"),
            ("delivery_round_p99", "corro_probe_delivery_round_p99",
             "p99 delivery round relative to the origin commit"),
            ("hop_max", "corro_probe_hop_max",
             "longest gossip path from the origin, in hops"),
            ("redundancy_ratio", "corro_probe_redundancy_ratio",
             "duplicate deliveries per non-origin infection"),
        )
        summaries = [tr.summary(k) for k in range(tr.num_probes)]
        for field, name, help_ in fams:
            rows_out = [
                f'{name}{{probe="{s["probe"]}"}} {s[field]}'
                for s in summaries if s[field] is not None
            ]
            if rows_out:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} gauge")
                lines.extend(rows_out)

    # ---- tracing (tokio-metrics / runtime introspection analog)
    from corro_sim_torch.utils.tracing import tracer as _tracer

    spans = _tracer.recent(10**9)
    emit(
        "corro_trace_spans_buffered", "gauge",
        "finished spans held in the tracer ring", len(spans),
    )
    if spans:
        emit(
            "corro_trace_span_max_ms", "gauge",
            "slowest buffered span duration (ms)",
            round(max(s.duration for s in spans) * 1000, 3),
        )

    # ---- transport path stats (corro.transport.*, transport.rs +
    # quinn path stats): the sim's wire is the delivery pipeline — sends,
    # deliveries, losses (sends into dead/partitioned links), in-flight
    # occupancy, and the modeled byte volume. frame_tx/rx split by the
    # protocol that produced the lane, like the reference's per-frame-type
    # gauges.
    sent = int(totals.get("msgs_sent", 0))
    delivered = int(totals.get("delivered", 0))
    lost = max(sent - delivered, 0)
    sync_pairs_t = int(totals.get("sync_pairs", 0))
    lines.append("# HELP corro_transport_frame_tx frames sent by type "
                 "(corro.transport.frame_tx)")
    lines.append("# TYPE corro_transport_frame_tx gauge")
    lines.append(f'corro_transport_frame_tx{{frame_type="changes"}} {sent}')
    lines.append(
        f'corro_transport_frame_tx{{frame_type="sync"}} {sync_pairs_t}'
    )
    lines.append("# HELP corro_transport_frame_rx frames received by type "
                 "(corro.transport.frame_rx)")
    lines.append("# TYPE corro_transport_frame_rx gauge")
    lines.append(
        f'corro_transport_frame_rx{{frame_type="changes"}} {delivered}'
    )
    lines.append(
        f'corro_transport_frame_rx{{frame_type="sync"}} {sync_pairs_t}'
    )
    emit("corro_transport_connections", "gauge",
         "sync connections granted in the last sweep "
         "(corro.transport.connections)",
         int(lasts.get("sync_pairs", 0)))
    emit("corro_transport_connect_errors_total", "counter",
         "sync admissions rejected by the server semaphore "
         "(corro.transport.connect.errors)",
         int(totals.get("sync_rejections", 0)))
    emit("corro_transport_path_sent_packets", "gauge",
         "gossip datagrams emitted (corro.transport.path.sent_packets)",
         sent)
    emit("corro_transport_path_lost_packets", "gauge",
         "sends into dead/partitioned links "
         "(corro.transport.path.lost_packets)", lost)
    emit("corro_transport_path_lost_bytes", "gauge",
         "modeled bytes of lost sends (corro.transport.path.lost_bytes)",
         lost * CHUNK_HEADER_BYTES)
    emit("corro_transport_path_congestion_events", "gauge",
         "pending-ring overflow clobbers "
         "(corro.transport.path.congestion_events)",
         int(lasts.get("queue_overflow", 0)))
    emit("corro_transport_path_cwnd", "gauge",
         "per-round emission budget, lanes "
         "(corro.transport.path.cwnd analog)",
         cluster.cfg.num_nodes
         * (cluster.cfg.emit_slots or cluster.cfg.pend_slots)
         * cluster.cfg.fanout)
    emit("corro_transport_path_black_holes_detected", "gauge",
         "nodes believed up that ground truth says are unreachable "
         "(corro.transport.path.black_holes_detected analog)",
         int(lasts.get("swim_down", 0)))
    udp_tx_b = sent * CHUNK_HEADER_BYTES + int(
        totals.get("cells_written", 0)
    ) * CHANGE_WIRE_BYTES
    for d, dat, byt in (
        ("tx", sent, udp_tx_b),
        ("rx", delivered, bcast_bytes),
    ):
        emit(f"corro_transport_udp_{d}_datagrams", "gauge",
             f"modeled UDP datagrams {d} (corro.transport.udp_{d})", dat)
        emit(f"corro_transport_udp_{d}_bytes", "gauge",
             f"modeled UDP bytes {d}", byt)
        emit(f"corro_transport_udp_{d}_transmits", "gauge",
             f"modeled UDP transmit ops {d} (batched sends count once)",
             dat)
    # PLPMTUD probes: the transport runs on modeled links with a fixed
    # MTU — the probe machinery exists in the reference's quinn stack
    # only; emitted as explicit zeros so dashboards resolve.
    emit("corro_transport_path_sent_plpmtud_probes", "gauge",
         "path-MTU probes sent (no analog: fixed-MTU modeled links)", 0)
    emit("corro_transport_path_lost_plpmtud_probes", "gauge",
         "path-MTU probes lost (no analog: fixed-MTU modeled links)", 0)

    # ---- SWIM notification counters (corro.swim.notification, foca
    # event granularity): transitions accumulated per round by the
    # metrics fold (positive deltas of the belief-state gauges).
    lines.append("# HELP corro_swim_notification_total membership "
                 "notifications by event (corro.swim.notification)")
    lines.append("# TYPE corro_swim_notification_total counter")
    lines.append(
        f'corro_swim_notification_total{{event="probe_failed"}} '
        f"{int(totals.get('swim_probe_failures', 0))}"
    )
    lines.append(
        f'corro_swim_notification_total{{event="member_down"}} '
        f"{int(totals.get('swim_down_events', 0))}"
    )
    lines.append(
        f'corro_swim_notification_total{{event="member_suspect"}} '
        f"{int(totals.get('swim_suspect_events', 0))}"
    )
    lines.append(
        f'corro_swim_notification_total{{event="member_up"}} '
        f"{int(totals.get('swim_up_events', 0))}"
    )

    # ---- host-runtime introspection (corro.tokio.* analogs; the
    # reference reports tokio worker stats, command/agent.rs:122-204).
    # This runtime is a single tick thread + API handler threads — the
    # honest analogs are below; min/max/total collapse to the same value
    # where the stat is process-global. Work-stealing stats have no
    # analog (no stealing scheduler) and are omitted — see
    # doc/metrics_parity.md.
    import threading as _threading

    emit("corro_tokio_workers_count", "gauge",
         "live threads (tick + API handlers; corro.tokio.workers_count "
         "analog)", _threading.active_count())
    try:
        import resource as _resource

        ru = _resource.getrusage(_resource.RUSAGE_SELF)
        emit("corro_tokio_total_busy_seconds", "gauge",
             "process CPU seconds (corro.tokio.*_busy_seconds analog)",
             round(ru.ru_utime + ru.ru_stime, 3))
    except Exception:
        pass
    rounds_t = int(totals.get("rounds", 0))
    emit("corro_tokio_total_polls_count", "gauge",
         "device dispatches (rounds ticked; corro.tokio.total_polls_count "
         "analog)", rounds_t)
    emit("corro_tokio_total_park_count", "gauge",
         "tick-loop iterations (corro.tokio.total_park_count analog)",
         rounds_t)
    emit("corro_tokio_total_noop_count", "gauge",
         "rounds with no local writes (corro.tokio.total_noop_count "
         "analog)", max(rounds_t - int(totals.get("writes", 0)), 0))
    emit("corro_tokio_total_local_queue_depth", "gauge",
         "queued changesets across write queues "
         "(corro.tokio.total_local_queue_depth analog)", pending)
    emit("corro_tokio_injection_queue_depth", "gauge",
         "events buffered for subscribers "
         "(corro.tokio.injection_queue_depth analog)", qdepth)
    emit("corro_tokio_total_local_schedule_count", "gauge",
         "changesets enqueued (corro.tokio.total_local_schedule_count "
         "analog)",
         int(_ch.snapshot().get("write_queue", {}).get("send", 0))
         if _ch is not None else 0)
    emit("corro_tokio_num_remote_schedules", "gauge",
         "cross-thread event deliveries "
         "(corro.tokio.num_remote_schedules analog)",
         int(_ch.snapshot().get("subs_events", {}).get("send", 0))
         if _ch is not None else 0)
    emit("corro_tokio_total_overflow_count", "gauge",
         "bounded-queue overflows (corro.tokio.total_overflow_count "
         "analog)", int(totals.get("queue_overflow", 0)))
    emit("corro_tokio_io_driver_ready_count", "gauge",
         "API requests served (corro.tokio.io_driver_ready_count analog)",
         int(getattr(cluster, "_api_requests", 0)))
    emit("corro_tokio_budget_forced_yield_count", "gauge",
         "chunked tick dispatches "
         "(corro.tokio.budget_forced_yield_count analog)",
         int(getattr(cluster, "_chunk_dispatches", 0)))

    # ---- bucketed histograms (VERDICT r4 #7: real histograms, not EWMA).
    # The cluster-scoped registry first (tick stages, queue waits, lock
    # waits, connect times); the process-global one carries only
    # cluster-less instrumentation (consul client).
    ch_reg = getattr(cluster, "histograms", None)
    if ch_reg is not None and ch_reg is not histograms:
        lines.extend(ch_reg.render())
    lines.extend(histograms.render())
    lines.extend(counters.render())
    lines.extend(gauges.render())
    return "\n".join(lines) + "\n"


_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"{}]*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"{}]*\")*\})?"
    r" (-?[0-9.eE+-]+|NaN|[+-]Inf)$")


def validate_exposition(text: str) -> None:
    """Raise ``ValueError`` unless ``text`` keeps the contract a
    Prometheus scraper enforces: one ``# TYPE`` and one ``# HELP`` per
    metric name, every sample parseable (``name{labels} value``) with a
    ``# TYPE``, valid label syntax, and every histogram's buckets
    cumulative per label set with sorted bounds and a ``+Inf`` bucket
    equal to its ``_count``. (The check of the JAX package's
    tests/test_metrics.py, as a function.)"""

    def check(ok: bool, msg: str) -> None:
        if not ok:
            raise ValueError(msg)

    check(text.endswith("\n"), "the exposition does not end in a newline")
    types: dict[str, str] = {}
    helps: set[str] = set()
    buckets: dict[tuple, list] = {}
    counts: dict[str, dict] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            check(name not in types, f"duplicate # TYPE for {name}")
            check(kind in ("counter", "gauge", "histogram", "summary"),
                  f"line {ln}: unknown type {kind!r}")
            types[name] = kind
            continue
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            check(name not in helps, f"duplicate # HELP for {name}")
            helps.add(name)
            continue
        check(not line.startswith("#"), f"line {ln}: stray comment")
        m = _SAMPLE.match(line)
        check(m is not None, f"line {ln}: unparseable sample {line!r}")
        name, labels = m.group(1), m.group(2) or ""
        base = name
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and name[: -len(sfx)] in types:
                base = name[: -len(sfx)]
                break
        check(base in types, f"line {ln}: sample {name} missing # TYPE")
        if types[base] == "histogram" and name.endswith("_bucket"):
            le = re.search(r'le="([^"]*)"', labels)
            check(le is not None,
                  f"line {ln}: histogram bucket without le label")
            rest = re.sub(r',?le="[^"]*"', "", labels)
            buckets.setdefault((base, rest), []).append(
                (le.group(1), float(m.group(4))))
        if types[base] == "histogram" and name.endswith("_count"):
            counts.setdefault(base, {})[labels] = float(m.group(4))
    check(bool(types), "no # TYPE lines rendered")
    for (base, rest), series in buckets.items():
        cum = [c for _, c in series]
        check(cum == sorted(cum), f"{base}{rest}: buckets not cumulative")
        check(series[-1][0] == "+Inf", f"{base}: last bucket not +Inf")
        bounds = [float(b) for b, _ in series[:-1]]
        check(bounds == sorted(bounds), f"{base}: le bounds not sorted")
        total = counts.get(base, {}).get(rest.replace("{}", "") or "")
        if total is None:
            total = counts.get(base, {}).get(rest)
        check(total == cum[-1], f"{base}{rest}: +Inf bucket != _count")
