"""Tracing: spans and W3C trace-context propagation.

Port of ``corro_sim/utils/tracing.py``, host Python only:

- :class:`Tracer`, a process-local span recorder: a bounded ring of
  finished spans (name, ids, wall times, attributes), read through the
  admin socket (``traces``) and the ``/metrics`` exposition;
- :func:`parse_traceparent` and :meth:`TraceContext.to_traceparent`,
  the W3C header codec: the HTTP API parents each request's span under
  an incoming ``traceparent``, so a caller's distributed trace goes on
  through the cluster;
- slow-span warnings: spans longer than ``slow_warn_s`` log a warning;
- ranges on the profiler's clock: while a ``torch.profiler`` records,
  :meth:`Tracer.stage` and every :meth:`Tracer.span` open a
  ``record_function`` range named ``corro.<name>``, so the host's stages
  line up with the device's work in the profiler's trace. With no
  profiler recording they cost one check and build nothing.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import sys
import threading
import time

log = logging.getLogger("corro_sim_torch.tracing")

_TRACEPARENT_LEN = 55  # 00-<32 hex>-<16 hex>-<2 hex>

# every range the program opens on the profiler's clock starts with this
RANGE_PREFIX = "corro."
_NO_RANGE = contextlib.nullcontext()


class TraceContext:
    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: int = 1):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    def __repr__(self):
        return f"TraceContext({self.to_traceparent()})"


def parse_traceparent(header: str | None) -> TraceContext | None:
    """W3C traceparent: ``00-{trace_id:32x}-{span_id:16x}-{flags:02x}``.
    Malformed headers are ignored (the spec says restart the trace)."""
    if not header or len(header) != _TRACEPARENT_LEN:
        return None
    parts = header.split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(trace_id) != 32 or len(span_id) != 16 or version == "ff":
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
        f = int(flags, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return TraceContext(trace_id, span_id, f)


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

    def as_json(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "duration_ms": round(self.duration * 1000, 3),
            "attrs": self.attrs,
        }

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)


class Tracer:
    """Bounded recorder of finished spans; thread-safe."""

    def __init__(self, capacity: int = 2048, slow_warn_s: float = 1.0):
        self.capacity = capacity
        self.slow_warn_s = slow_warn_s
        # deque(maxlen=...) evicts in O(1) per append; the old list +
        # del-slicing ring paid an O(capacity) shift on every overflow —
        # this sits on the hot instrumentation path (every span end)
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=capacity
        )
        self._lock = threading.Lock()
        self._local = threading.local()

    # --------------------------------------------------------- recording
    def stage(self, name: str):
        """Context manager: a ``record_function`` range called ``name``
        (``corro.``-prefixed) while a profiler records; otherwise one
        shared null context, with no ids, no clock read and no ring
        entry. (No profiler records before torch is imported.)"""
        torch = sys.modules.get("torch")
        if torch is None or not torch._C._autograd._profiler_enabled():
            return _NO_RANGE
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def span(self, name: str, parent: TraceContext | None = None,
             slow_warn: bool = True, **attrs):
        """Context manager recording one span. Child spans inside inherit
        the current span's context unless ``parent`` overrides it.
        ``slow_warn=False`` opts out of the slow-span watchdog — for
        spans that are *expected* to run long (kernel builds), where the
        warning would be noise rather than signal. While a profiler
        records, the span is also a range ``corro.<name>``, spaces as
        underscores (:meth:`stage`)."""
        cur = getattr(self._local, "ctx", None)
        if parent is None:
            parent = cur
        trace_id = parent.trace_id if parent else _new_id(16)
        ctx = TraceContext(trace_id, _new_id(8))
        self._local.ctx = ctx
        t0 = time.time()
        p0 = time.perf_counter()
        try:
            with self.stage(RANGE_PREFIX + name.replace(" ", "_")):
                yield ctx
        finally:
            dur = time.perf_counter() - p0
            self._local.ctx = cur
            sp = Span(
                name, trace_id, ctx.span_id,
                parent.span_id if parent else None, t0, dur, attrs,
            )
            with self._lock:
                self._spans.append(sp)  # maxlen evicts the oldest
            if slow_warn and dur > self.slow_warn_s:
                # foca-loop slow-branch watchdog (broadcast/mod.rs:317-321)
                log.warning("slow span %r took %.3fs", name, dur)

    def current(self) -> TraceContext | None:
        return getattr(self._local, "ctx", None)

    # ----------------------------------------------------------- reading
    def recent(self, n: int = 100, name: str | None = None) -> list[Span]:
        with self._lock:
            spans = list(self._spans)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans[-n:]

    def trace(self, trace_id: str) -> list[Span]:
        with self._lock:
            return [s for s in self._spans if s.trace_id == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


# The process-default tracer (the reference's global tracing subscriber).
tracer = Tracer()
