"""The readers of the program's own ranges (``simbench/spans.py`` and the
``stage_*`` metrics), on a synthetic traced round, and the ranges a tiny
CPU run opens under the harness's profiler.

Run with ``python -m pytest simbench/tests`` from the repository root.
"""

from __future__ import annotations

import json
import types

import pytest
import torch

from simbench import cells, run, spans, trace
from simbench.metrics import (
    stage_delivery_ms_per_round,
    stage_gossip_ms_per_round,
    stage_swim_ms_per_round,
    stage_sync_ms_per_round,
    stage_writes_ms_per_round,
)
from simbench.tests.test_simbench_harness import _ev

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
STAGES = {
    "corro.step.writes": stage_writes_ms_per_round,
    "corro.step.gossip": stage_gossip_ms_per_round,
    "corro.step.delivery": stage_delivery_ms_per_round,
    "corro.step.swim": stage_swim_ms_per_round,
    "corro.step.sync": stage_sync_ms_per_round,
}


def _round_events() -> list:
    """One traced round: the program's ranges, the harness's wrappers
    inside three stages, a launch in ``corro.step`` between stages, the
    host's waits in the gate and the metric fetch, and the device's
    slices (ids pair each launch with its slice)."""
    ranges = [("corro.chunk_dispatch", 0, 902), ("corro.step", 5, 895),
              ("corro.step.writes", 10, 90), ("corro.step.gossip", 110, 40),
              ("corro.step.delivery", 160, 140),
              ("simbench.delivery_pass", 170, 120),
              ("corro.step.gossip", 310, 20), ("corro.step.swim", 340, 60),
              ("simbench.swim_block", 345, 50),
              ("corro.step.sync_gate", 420, 80), ("corro.step.sync", 510, 190),
              ("simbench.sync_round", 540, 150),
              ("corro.step.bookkeeping", 710, 180),
              ("corro.chunk.resolve", 910, 80)]
    # (launch at, kernel start, kernel duration)
    launches = [(20, 30, 10), (120, 150, 20), (180, 200, 40), (315, 320, 5),
                (350, 360, 30), (405, 412, 2), (515, 520, 10),
                (550, 560, 100), (720, 730, 6), (880, 900, 5), (991, 995, 3)]
    evs = [_ev("user_annotation", n, s, d) for n, s, d in ranges]
    evs += [_ev("cuda_runtime", "cudaEventSynchronize", 425, 70),
            _ev("cuda_runtime", "cudaEventSynchronize", 915, 70),
            _ev("cpu_op", "aten::copy_", 992, 8)]
    for i, (at, ks, kd) in enumerate(launches, start=1):
        evs.append(_ev("cuda_runtime", "cudaLaunchKernel", at, 2, corr=i))
        evs.append(_ev("kernel", f"k{i}", ks, kd, tid=7, corr=i))
    return evs


def _source(events, ranges):
    return types.SimpleNamespace(trace=trace.reduce_trace(events, ranges),
                                 traced_rounds=1, window_rounds=8,
                                 counters={"host_reads": 4},
                                 sample_work={},
                                 sample_kernel_us=lambda frag: (0, 0.0))


def _ranges(per_layer) -> list:
    return [r for _m, mod in per_layer for r in getattr(mod, "RANGES", {})]


@pytest.mark.parametrize("name", CELLS)
def test_existing_readings_are_unchanged_by_the_program_ranges(name):
    """Each cell's earlier readers read the same with the stage readers'
    program ranges added to the first reduction, on a round with the
    program's ranges and on one without (an older program)."""
    cell = cells.resolve_cell(BENCH, name)
    older = [(m, mod) for m, mod in cell.per_layer
             if not m["name"].startswith("stage_")]
    assert len(older) < len(cell.per_layer)
    with_ranges = _round_events()
    without = [e for e in with_ranges if not e["name"].startswith("corro.")]
    for events in (with_ranges, without):
        before = _source(events, _ranges(older))
        after = _source(events, _ranges(cell.per_layer))
        for _m, mod in older:
            assert mod.read(after) == mod.read(before)
        assert (trace.breakdown(after.trace)
                == trace.breakdown(before.trace))


def test_stages_take_the_launches_of_their_innermost_program_range():
    """A launch inside a harness wrapper inside a stage counts for the
    stage; a launch in ``corro.step`` between stages counts for none."""
    cell = cells.resolve_cell(BENCH, CELLS[0])
    src = _source(_round_events(), _ranges(cell.per_layer))
    got = {name: mod.read(src) for name, mod in STAGES.items()}
    assert got == pytest.approx({
        "corro.step.writes": 0.010, "corro.step.gossip": 0.025,
        "corro.step.delivery": 0.040, "corro.step.swim": 0.030,
        # the pair mask's launch beside the sweep's
        "corro.step.sync": 0.110})
    # the same launches through the second reduction the stage readers
    # stand for: every program range, no harness wrapper
    second = trace.reduce_trace(_round_events(),
                                spans.range_names(_round_events()))
    assert second["range_us"]["corro.step.sync"] == 110
    assert second["range_us"]["corro.step.delivery"] == 40
    assert second["range_us"]["corro.step"] == 2
    assert second["range_us"]["corro.chunk_dispatch"] == 0


def test_stages_read_nothing_from_an_older_program():
    cell = cells.resolve_cell(BENCH, CELLS[0])
    events = [e for e in _round_events() if not e["name"].startswith("corro.")]
    src = _source(events, _ranges(cell.per_layer))
    assert all(mod.read(src) is None for mod in STAGES.values())
    assert src.trace["range_us"]["simbench.sync_round"] == 100


def test_idle_gaps_are_labelled_by_the_innermost_program_range():
    events = _round_events()
    idle = spans.idle_by_range(events, spans.range_names(events))
    assert idle == {
        "corro.step.writes": 30 + 110, "corro.step.delivery": 30 + 80,
        "corro.step.swim": 35, "corro.step": 22,
        "corro.step.sync_gate": 106, "corro.step.sync": 30 + 70,
        "corro.step.bookkeeping": 164, "corro.chunk.resolve": 90,
        spans.NO_RANGE: 2}
    red = trace.reduce_trace(events)
    assert sum(idle.values()) == red["window_us"] - red["busy_us"]


def test_a_traced_cpu_run_holds_the_program_ranges(tmp_path, monkeypatch,
                                                   capsys):
    """A whole ``--trace 1`` run of the north-star cell at a tiny size on
    the CPU: the window's trace holds the step's and the driver's ranges,
    and the harness leaves the never-called target as it found it."""
    from simbench.tests.tiny_root import make_tiny_root

    make_tiny_root(tmp_path)
    loaded = []
    load = trace.load_events
    monkeypatch.setattr(run.trace_mod, "load_events",
                        lambda path: loaded.append(load(path)) or loaded[-1])
    target = spans.program_range
    # the import check has its own test, in a fresh process
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    rc = run.main(["--workload", CELLS[0], "--seed", str(2 ** 31 + 11),
                   "--seconds", "0.5", "--trace", "1"],
                  device=torch.device("cpu"), root=tmp_path)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    names = set(spans.range_names(loaded[0]))
    assert set(STAGES) | {"corro.step", "corro.step.sync_gate",
                          "corro.step.bookkeeping", "corro.chunk_dispatch",
                          "corro.chunk.stage", "corro.chunk.resolve"} <= names
    assert spans.program_range is target
