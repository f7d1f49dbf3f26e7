"""Spans: a process-local recorder of timed host regions.

The part of ``corro_sim/utils/tracing.py`` that ``run_sim`` uses:
:data:`tracer` and its :meth:`Tracer.span` context manager, which keeps
a bounded ring of finished spans (name, ids, wall times, attributes) and
logs a warning when a span runs longer than ``slow_warn_s``.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time

log = logging.getLogger("corro_sim_torch.tracing")


class TraceContext:
    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "duration",
        "attrs",
    )

    def __init__(self, name, trace_id, span_id, parent_id, start,
                 duration, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.duration = duration
        self.attrs = attrs


class Tracer:
    """Bounded recorder of finished spans; thread-safe."""

    def __init__(self, capacity: int = 2048, slow_warn_s: float = 1.0):
        self.capacity = capacity
        self.slow_warn_s = slow_warn_s
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=capacity
        )
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextlib.contextmanager
    def span(self, name: str, slow_warn: bool = True, **attrs):
        """Record one span; spans opened inside it are its children.
        ``slow_warn=False`` opts out of the slow-span warning."""
        parent = getattr(self._local, "ctx", None)
        trace_id = parent.trace_id if parent else _new_id(16)
        ctx = TraceContext(trace_id, _new_id(8))
        self._local.ctx = ctx
        t0 = time.time()
        p0 = time.perf_counter()
        try:
            yield ctx
        finally:
            dur = time.perf_counter() - p0
            self._local.ctx = parent
            sp = Span(
                name, trace_id, ctx.span_id,
                parent.span_id if parent else None, t0, dur, attrs,
            )
            with self._lock:
                self._spans.append(sp)
            if slow_warn and dur > self.slow_warn_s:
                log.warning("slow span %r took %.3fs", name, dur)

    def recent(self, n: int = 100, name: str | None = None) -> list[Span]:
        with self._lock:
            spans = list(self._spans)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans[-n:]


# the process-default tracer
tracer = Tracer()
