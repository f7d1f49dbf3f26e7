"""Milliseconds per simulated round that SWIM's exchange spans on the
card's clock: the ``swim_gossip_peers`` pull/push rounds of a tick, each
a pass over the belief plane, with the card's waits on the host's
launches inside them.

Sample: the first tick after the clean traced window, in the same
cluster (the step's call of ``swim_step``, as ``swim_roofline_pct``
samples it). Around that call the swim module's tracer is stood in for,
so that where ``membership/swim.py::swim_step`` opens and closes its
``corro.swim.exchange`` range a CUDA event is recorded on the current
stream; their interval is on the card's clock, idle gaps inside it
included (the harness drains the queue before the sampled tick, so on a
host-paced cell the span exceeds the work's device time). A tick every
``swim_interval`` rounds gives the share a round.

Read from a sample, not from the window: a window range listed here
would take its launches from the listed ranges around it
(``simbench.swim_block``, ``corro.step.swim``), and those readers would
then read SWIM without its exchange. A program that opens no such range
reads nothing."""

import contextlib
import importlib
import time

UNIT = "ms/round"
LAYER = "membership (membership/swim.py)"
MOVES = "round_ms"
SOURCE = "program_span"
SAMPLE = {"target": ("corro_sim_torch.engine.step", "swim_step"),
          "calls": 1, "kernel": ""}
RANGE = "corro.swim.exchange"


class _Timed:
    """The swim module's tracer for one tick: marks the ends of the
    exchange's range on the card's clock (the host's on the CPU) and
    passes everything else through."""

    def __init__(self, inner, device):
        self.inner = inner
        self.cuda = device.type == "cuda"
        self.marks = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def stage(self, name):
        with self.inner.stage(name):
            if name != RANGE:
                yield
                return
            start = self._mark()
            yield
            self.marks.append((start, self._mark()))

    def ms(self):
        if not self.marks:
            return None
        if not self.cuda:
            return sum(e - s for s, e in self.marks) * 1e3
        self.marks[-1][1].synchronize()
        return sum(s.elapsed_time(e) for s, e in self.marks)


def sample_call(fn, args, kwargs):
    """Run one tick, returning its result and its exchange's
    milliseconds a round (None where the tick opened no such range)."""
    swim = importlib.import_module("corro_sim_torch.membership.swim")
    inner = getattr(swim, "tracer", None)
    if inner is None:
        return fn(*args, **kwargs), None
    timed = _Timed(inner, args[1].p.device)
    swim.tracer = timed
    try:
        out = fn(*args, **kwargs)
    finally:
        swim.tracer = inner
    ms = timed.ms()
    return out, None if ms is None else ms / int(args[0].swim_interval)


def read(run):
    works = [w for w in run.sample_work.get("swim_exchange_ms_per_round")
             or [] if w is not None]
    return sum(works) / len(works) if works else None
