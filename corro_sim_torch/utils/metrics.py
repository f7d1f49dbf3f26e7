"""Process-wide counters and histograms of the run loop.

The part of ``corro_sim/utils/metrics.py`` that ``run_sim`` writes to:
:data:`counters`, :data:`histograms` (the reference exporter's
``SECONDS_BUCKETS``) and the names of the chunk-pipeline series; each
registry keeps its series by ``(name, labels)``, labels in the
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
