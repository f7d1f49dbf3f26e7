"""The port's ranges on the profiler's clock and the host's waits on the
card as registry series, on the CPU at a tiny size.

- Under ``torch.profiler`` one round of the full step and one of the
  repair step open ``corro.step`` and, inside it, their stages as
  disjoint siblings; ``run_sim``'s chunk loop opens its own ranges and
  the tracer's spans as ``corro.``-prefixed ranges.
- With no profiler recording, neither ``Tracer.stage`` nor
  ``Tracer.span`` builds a ``record_function`` (counted through a
  monkeypatch), and the tracer's ring keeps its spans.
- A read of the sweep gate's device predicate adds one sample to
  ``corro_sweep_gate_wait_seconds``, and the ``/metrics`` exposition
  that carries it passes ``validate_exposition``.
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig
from corro_sim_torch.engine import step as step_mod
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.utils import metrics
from corro_sim_torch.utils.runtime import start_async_fetch
from corro_sim_torch.utils.tracing import tracer

CFG = SimConfig(
    num_nodes=16, num_rows=16, num_cols=2, log_capacity=64,
    write_rate=0.5, swim_enabled=True, swim_interval=1, sync_interval=1,
)
FULL_STAGES = {"corro.step.writes", "corro.step.gossip",
               "corro.step.delivery", "corro.step.swim",
               "corro.step.sync_gate", "corro.step.sync",
               "corro.step.bookkeeping"}
# the repair step runs no writes' gossip and no delivery
REPAIR_STAGES = FULL_STAGES - {"corro.step.gossip", "corro.step.delivery"}


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _round(repair: bool):
    state = init_state(CFG, seed=0, device="cpu")
    alive = torch.ones(CFG.num_nodes, dtype=torch.bool)
    part = torch.zeros(CFG.num_nodes, dtype=torch.int32)
    return step_mod.sim_step(CFG, state, prng.PRNGKey(3), alive, part,
                             not repair, 0, repair=repair)


class Recorder:
    """Stands in for ``torch.profiler.record_function`` and logs each
    range's entry and exit in order, entering the real range too."""

    def __init__(self, monkeypatch):
        self.log = []
        real = torch.profiler.record_function
        rec = self

        class Range:
            def __init__(self, name):
                self.name, self.inner = name, real(name)

            def __enter__(self):
                rec.log.append(("enter", self.name))
                return self.inner.__enter__()

            def __exit__(self, *exc):
                rec.log.append(("exit", self.name))
                return self.inner.__exit__(*exc)

        monkeypatch.setattr(torch.profiler, "record_function", Range)

    def intervals(self) -> list:
        """``(name, enter index, exit index)`` of each range, by entry."""
        open_, out = {}, []
        for i, (what, name) in enumerate(self.log):
            if what == "enter":
                open_.setdefault(name, []).append(len(out))
                out.append([name, i, None])
            else:
                out[open_[name].pop()][2] = i
        return [tuple(x) for x in out]


@pytest.mark.parametrize("repair", [False, True], ids=["full", "repair"])
def test_step_stages_are_disjoint_siblings_inside_the_round(repair,
                                                            monkeypatch):
    rec = Recorder(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        _round(repair)
    ranges = rec.intervals()
    assert ranges[0][0] == "corro.step" and ranges[0][1] == 0
    step = ranges[0]
    assert step[2] == len(rec.log) - 1  # the round holds every stage
    # the step's stages: the ranges directly inside it (SWIM's own lie
    # inside corro.step.swim)
    stages = [r for r in ranges[1:] if not any(
        o[1] < r[1] and r[2] < o[2] for o in ranges[1:])]
    assert {r[0] for r in stages} == (REPAIR_STAGES if repair
                                      else FULL_STAGES)
    if not repair:  # gossip opens twice: before and after delivery
        assert [r[0] for r in stages].count("corro.step.gossip") == 2
    for (_, _, e), (_, s_next, _) in zip(stages, stages[1:]):
        assert s_next > e  # siblings, never nested


def test_chunk_loop_ranges_and_tracer_spans(monkeypatch):
    """A pipelined run under the profiler: the chunk loop's ranges, the
    tracer's spans as ``corro.`` ranges (spaces as underscores), every
    range ``corro.``-prefixed, none open while the caller's callback
    runs, and the ring's spans as before."""
    rec = Recorder(monkeypatch)
    t0 = len(tracer.recent(4096, name="chunk dispatch"))
    open_at_callback = []

    def on_chunk(info):
        # a caller's profiler may stop here: no program range is open
        open_at_callback.append(sum(1 if what == "enter" else -1
                                    for what, _ in rec.log))

    with profile(activities=[ProfilerActivity.CPU]):
        res = run_sim(CFG, init_state(CFG, seed=0, device="cpu"),
                      Schedule(write_rounds=2), max_rounds=4, chunk=2,
                      seed=0, device="cpu", pipeline=True,
                      stop_on_convergence=False, on_chunk=on_chunk)
    assert open_at_callback == [0, 0]
    names = {r[0] for r in rec.intervals()}
    assert {"corro.chunk_dispatch", "corro.chunk.stage",
            "corro.chunk.spec_copy", "corro.chunk.resolve",
            "corro.chunk.commit", "corro.step"} | FULL_STAGES <= names
    assert all(n.startswith("corro.") for n in names)
    queued = len(tracer.recent(4096, name="chunk dispatch")) - t0
    assert queued >= res.rounds // 2


def test_ranges_land_on_the_profilers_trace():
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.stage("corro.step.sync"):
            x.add(1)
        with tracer.span("chunk dispatch", slow_warn=False):
            x.mul(2)
    names = [e.name for e in prof.events()]
    assert "corro.step.sync" in names and "corro.chunk_dispatch" in names
    assert tracer.recent(1)[0].name == "chunk dispatch"


def test_no_profiler_builds_no_range(monkeypatch):
    built = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: built.append(name) or real(name))
    _round(repair=False)
    _round(repair=True)
    with tracer.span("chunk dispatch", slow_warn=False):
        pass
    assert built == []
    assert tracer.recent(1)[0].name == "chunk dispatch"
    # the same patch point counts the ranges once a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.stage("corro.step.sync"):
            pass
    assert built == ["corro.step.sync"]


def test_gate_read_is_a_wait_sample_in_the_exposition():
    from corro_sim_torch.harness.cluster import LiveCluster

    def series():
        h = metrics.histograms.get(metrics.SWEEP_GATE_WAIT)
        return (0, 0.0) if h is None else (h.count, h.sum)

    count0, sum0 = series()
    reads0 = step_mod.SWEEP_GATES["read_on"]
    assert step_mod._sync_due(start_async_fetch(torch.tensor(True))) is True
    count, total = series()
    assert count == count0 + 1 and total >= sum0
    assert step_mod.SWEEP_GATES["read_on"] == reads0 + 1
    # a gate the host decided is no read and no sample
    assert step_mod._sync_due(False) is False
    assert series()[0] == count
    c = LiveCluster("CREATE TABLE kv (k TEXT PRIMARY KEY, v TEXT);",
                    num_nodes=2, default_capacity=8, device="cpu")
    text = metrics.render_prometheus(c)
    metrics.validate_exposition(text)
    assert f"# TYPE {metrics.SWEEP_GATE_WAIT} histogram" in text
    assert f"{metrics.SWEEP_GATE_WAIT}_count {count}" in text
