"""Process-wide counters and histograms of the run loop.

The part of ``corro_sim/utils/metrics.py`` that ``run_sim``, ``run_sweep``
and ``LiveCluster`` write to: :data:`counters`, :data:`histograms` (the
reference exporter's ``SECONDS_BUCKETS``, and ``CHUNK_SIZE_BUCKETS`` for
the changes-per-round histogram), :data:`gauges`, the per-queue
:class:`ChannelMetrics`, and the names
of the chunk-pipeline, fleet-sweep, subscription and digital-twin
series (the twin's help strings are the JAX package's, word for word);
each registry keeps its series by ``(name, labels)``, labels in the
Prometheus text format (``'{reason="converged"}'``).
"""

from __future__ import annotations

import bisect
import threading

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
PIPELINE_SPECULATIVE_TOTAL = "corro_pipeline_speculative_total"
PIPELINE_SPECULATIVE_WASTED = "corro_pipeline_speculative_wasted_total"
PIPELINE_OVERLAP_SECONDS = "corro_pipeline_overlap_seconds_total"


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
