"""The port's SWIM tick against the benchmark's plain reference, and the
churn cell's configuration, on the CPU.

``simbench/reference/swim.py`` works a tick out in plain ``torch`` from
the protocol's description, with its draws from ``draws.py``'s threefry.
On seeded belief planes at 64-512 nodes, ``membership/swim.py::
swim_step`` must give its plane bit for bit (integers: tolerance 0), in
both layouts, with bounded datagrams and the full view, across a split
with down nodes, on announce ticks and others, and across the wrap of
the suspicion clock. Each planted fault in the reference (pushes
combined by sum, the timeout a round late, the header dropped) makes the
comparison fail. Then ``simbench/configs/churn_10k.json`` is config 4
field for field, and its cell reports what the benchmark says it does.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig
from corro_sim_torch.engine.step import _reachable_fn
from corro_sim_torch.membership import swim as p_swim
from corro_sim_torch.profile_slice import config4_config
from simbench import cells
from simbench.reference import swim as r_swim

SUSPECT_ROUNDS = 3


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _plane(rng, n: int, narrow: bool, round_idx: int) -> torch.Tensor:
    """A plane mid-protocol: mostly ALIVE, some SUSPECT and DOWN at low
    incarnations. Suspicions began up to twice the timeout ago, so some
    time out exactly this tick and some one tick later; the rest of the
    clocks are spread over the field."""
    dtype = p_swim.belief_dtype(narrow)
    mask = p_swim.swim_layout(dtype).since_mask
    status = rng.choice(3, size=(n, n), p=[0.7, 0.2, 0.1])
    inc = rng.integers(0, 4, size=(n, n))
    since = rng.integers(0, mask + 1, size=(n, n))
    recent = (round_idx - rng.integers(0, 2 * SUSPECT_ROUNDS + 1,
                                       size=(n, n))) & mask
    since = np.where(status == p_swim.SUSPECT, recent, since)
    return p_swim.pack_swim(status, inc, since, dtype)


def _truth(rng, n: int, split: bool):
    """Who is up and each node's side: with ``split``, a tenth of the
    nodes down and the upper half cut off."""
    alive = np.ones(n, bool)
    part = np.zeros(n, np.int32)
    if split:
        alive[rng.choice(n, n // 10, replace=False)] = False
        part[n // 2:] = 1
    return torch.as_tensor(alive), torch.as_tensor(part)


def _tick(n, narrow, payload, split, round_idx, seed=0):
    """``(port plane, reference plane)`` after one tick from the same
    plane, keys and ground truth."""
    cfg = SimConfig(num_nodes=n, swim_enabled=True, narrow_state=narrow,
                    swim_payload_members=payload,
                    swim_suspect_rounds=SUSPECT_ROUNDS)
    rng = np.random.default_rng([seed, n, round_idx])
    plane = _plane(rng, n, narrow, round_idx)
    alive, part = _truth(rng, n, split)
    key = prng.fold_in(prng.PRNGKey(11 + seed), round_idx)
    got, _ = p_swim.swim_step(cfg, p_swim.SwimState(p=plane.clone()), key,
                              alive, _reachable_fn(alive, part), round_idx)
    want = r_swim.swim_tick(plane, key, alive, part, round_idx,
                            r_swim.Params.from_sim(cfg), block_rows=40)
    return got.p, want


def _round(narrow: bool, announce: bool, wrap: bool) -> int:
    """A round of the kind asked for; ``wrap``: just past the suspicion
    clock's wrap, so recent suspicions began before it."""
    base = (1 << (8 if narrow else 16)) if wrap else 40
    r = base + 1
    while p_swim.announce_round(SimConfig(), r) != announce:
        r += 1
    return r


CASES = [
    pytest.param(n, narrow, view, split, announce, wrap,
                 id=f"{'narrow' if narrow else 'wide'}-{view}-"
                    f"{'split' if split else 'calm'}-"
                    f"{'announce' if announce else 'plain'}-"
                    f"{'wrap' if wrap else 'mid'}-n{n}")
    for i, (narrow, view, split, announce, wrap) in enumerate(
        (narrow, view, split, announce, wrap)
        for narrow in (False, True) for view in ("bounded", "full")
        for split in (True, False) for announce in (True, False)
        for wrap in (False, True))
    for n in ((64, 96, 160)[i % 3],)
] + [
    pytest.param(512, narrow, "bounded", True, True, False,
                 id=f"{'narrow' if narrow else 'wide'}-bounded-split-"
                    "announce-mid-n512")
    for narrow in (False, True)
]


@pytest.mark.parametrize("n,narrow,view,split,announce,wrap", CASES)
def test_port_tick_equals_the_plain_reference(n, narrow, view, split,
                                              announce, wrap):
    payload = 8 if view == "bounded" else n
    got, want = _tick(n, narrow, payload, split,
                      _round(narrow, announce, wrap))
    assert got.dtype == want.dtype == p_swim.belief_dtype(narrow)
    assert torch.equal(got, want)


def test_ticks_in_a_row_stay_equal():
    """Five ticks from one plane, each side fed its own output."""
    n, narrow = 96, False
    cfg = SimConfig(num_nodes=n, swim_enabled=True,
                    swim_payload_members=16,
                    swim_suspect_rounds=SUSPECT_ROUNDS)
    rng = np.random.default_rng(5)
    port = ref = _plane(rng, n, narrow, 14)
    alive, part = _truth(rng, n, True)
    params = r_swim.Params.from_sim(cfg)
    for r in range(14, 19):
        key = prng.fold_in(prng.PRNGKey(3), r)
        port = p_swim.swim_step(cfg, p_swim.SwimState(p=port), key, alive,
                                _reachable_fn(alive, part), r)[0].p
        ref = r_swim.swim_tick(ref, key, alive, part, r, params)
        assert torch.equal(port, ref), r


def _summed(a, b):
    return a + b


def _late(elapsed, suspect_rounds):
    return elapsed >= suspect_rounds + 1


def _headless(plane, peer, can, diag):
    return plane


FAULTS = {
    # the full view: every push carries every member, so pushes meet
    "push_summed": ("combine_pushes", _summed, "full"),
    "timeout_late": ("timed_out", _late, "bounded"),
    "header_dropped": ("with_header", _headless, "bounded"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("narrow", [False, True], ids=["wide", "narrow"])
def test_a_planted_fault_fails_the_comparison(fault, narrow, monkeypatch):
    attr, planted, view = FAULTS[fault]
    n = 64
    args = (n, narrow, 8 if view == "bounded" else n, True,
            _round(narrow, False, False))
    got, want = _tick(*args)
    assert torch.equal(got, want)  # sound before the fault
    monkeypatch.setattr(r_swim, attr, planted)
    got, want = _tick(*args)
    assert not torch.equal(got, want)


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    tree = ast.parse(Path(r_swim.__file__).read_text())
    names = {a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert not {m for m in names if m.split(".")[0] in (
        "jax", "jaxlib", "corro_sim", "corro_sim_torch")}


def test_the_churn_configuration_is_config4_field_for_field():
    sim = json.loads((cells.ROOT / "simbench/configs/churn_10k.json")
                     .read_text())["sim"]
    want = dataclasses.asdict(config4_config(10000))
    assert {k: want[k] for k in sim} == sim
    assert SimConfig(**sim) == config4_config(10000)


def test_the_churn_cell_reports_the_north_stars_group():
    bench = cells.load_benchmark()
    cell = cells.resolve_cell(bench, "churn_10k.steady")
    e2e = {m["name"] for m, _ in cell.end_to_end}
    assert e2e == {"round_ms.north_star", "peak_gib", "setup_s"}
    layer = {m["name"] for m, _ in cell.per_layer}
    assert {"swim_exchange_ms_per_round", "swim_roofline_pct",
            "stage_swim_ms_per_round", "swim_ms_per_round"} <= layer
    assert cell.chips == 1
    assert cell.traffic["mode"] == "fixed"
    assert cell.traffic["partition"]["rounds"] == [16, 32]
    names = [c["name"] for c in bench["configs"]]
    assert names[-1] == "churn_10k"
    assert bench["workloads"][-1]["name"] == "churn_10k.steady"


# the churn cell cut to its tiny size (``simbench/tests/tiny_sizes.py``),
# under its own mix and readers; run in a process of its own, since
# simbench refuses to run where JAX is loaded (this suite loads it)
TINY_RUN = """
import sys
from pathlib import Path
import torch
from simbench import run
from simbench.tests import tiny_sizes
from simbench.tests.tiny_root import make_tiny_root

root = make_tiny_root(Path(sys.argv[1]))
rc = run.main(["--workload", "churn_10k.steady", "--seed",
               str(2 ** 31 + 23), "--seconds", "1", "--trace", "0"],
              device=torch.device("cpu"), root=root)
sys.exit(rc)
"""


def test_the_churn_cell_runs_correct_at_a_tiny_size(tmp_path):
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c", TINY_RUN, str(tmp_path)],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"round_ms.north_star", "peak_gib",
                                    "setup_s"}
    # 40 fixed rounds a cluster, the split among them
    assert "rounds 40, converged at None" in proc.stderr


def test_no_window_range_lies_inside_swim():
    """No cell lists a window range inside SWIM's stage: the reduction
    credits a launch to the innermost listed range, so one there would
    take its launches from ``swim_ms_per_round`` and
    ``stage_swim_ms_per_round``."""
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cell = cells.resolve_cell(bench, w["name"])
        listed = [r for _m, mod in cell.per_layer
                  for r in getattr(mod, "RANGES", {})]
        assert not [r for r in listed if r.startswith("corro.swim.")]


class _Run:
    """What a reader sees of a traced run."""

    def __init__(self, works, kernels, name="swim_roofline_pct"):
        self.sample_work = {name: works}
        self.sample_kernel_us = lambda frag: kernels


def _tick_args(n=64, interval=1):
    cfg = SimConfig(num_nodes=n, swim_enabled=True, swim_payload_members=8,
                    swim_interval=interval)
    rng = np.random.default_rng(1)
    plane = _plane(rng, n, False, 8)
    alive, part = _truth(rng, n, True)
    return (cfg, p_swim.SwimState(p=plane), prng.PRNGKey(2), alive,
            _reachable_fn(alive, part), 8)


def test_the_swim_readers_read_what_the_program_gives(monkeypatch):
    """The roofline's sample runs the tick it wraps and counts its bytes
    from the tick's shapes; the exchange's times the tick's exchange
    range, a share of it a round, and reads nothing where the program
    opens none (an older checkout)."""
    from simbench import swim_work

    roof = cells._module(cells.ROOT, "metrics", "swim_roofline_pct")
    exch = cells._module(cells.ROOT, "metrics", "swim_exchange_ms_per_round")
    args = _tick_args()
    want = p_swim.swim_step(*args)[0].p
    (out, _), work = roof.sample_call(p_swim.swim_step, args, {})
    assert torch.equal(out.p, want)
    assert work == swim_work.tick_bytes(64, 64, False, 8, 3, True)
    assert roof.read(_Run([work], (10, 1000.0))) == pytest.approx(
        100.0 * work / 3.35e12 / 1e-3)
    assert roof.read(_Run([], (0, 0.0))) is None

    tracer = p_swim.tracer
    (out, _), ms = exch.sample_call(p_swim.swim_step, args, {})
    assert torch.equal(out.p, want) and p_swim.tracer is tracer
    assert ms > 0
    # a tick every 4th round: a quarter of it a round
    (_, _), quarter = exch.sample_call(p_swim.swim_step,
                                       _tick_args(interval=4), {})
    assert 0 < quarter < ms
    name = "swim_exchange_ms_per_round"
    assert exch.read(_Run([ms], (0, 0.0), name)) == ms
    assert exch.read(_Run([], (0, 0.0), name)) is None
    # a program that opens no exchange range, or has no tracer, reads
    # nothing

    def no_exchange(*a, **k):
        with p_swim.tracer.stage("corro.swim.probe"):
            return "tick"

    assert exch.sample_call(no_exchange, args, {}) == ("tick", None)
    monkeypatch.delattr(p_swim, "tracer")
    assert exch.sample_call(lambda *a, **k: "tick", args, {}) == (
        "tick", None)
    assert exch.read(_Run([None], (0, 0.0), name)) is None



def test_both_swim_samples_take_one_tick(monkeypatch):
    """In a traced run both SWIM readers sample the step's same call of
    ``swim_step``, wrapped one inside the other, and sampling ends with
    it."""
    import types

    from simbench import run, swim_work
    from corro_sim_torch.engine import step as step_mod

    bench = cells.load_benchmark()
    cell = cells.resolve_cell(bench, "churn_10k.steady")
    monkeypatch.setattr(run, "Profiler", lambda *a, **k:
                        types.SimpleNamespace(stop=lambda: None))
    plan = run.TracePlan(cell, torch.device("cpu"))
    assert sorted(plan.works) == ["swim_exchange_ms_per_round",
                                  "swim_roofline_pct"]
    args = _tick_args()
    want = p_swim.swim_step(*args)[0].p
    plan.install(cell.per_layer)
    try:
        plan.sampling = True
        out = step_mod.swim_step(*args)[0].p
        step_mod.swim_step(*args)  # past the sample: run as it is
    finally:
        plan.uninstall()
    assert torch.equal(out, want)
    assert step_mod.swim_step is p_swim.swim_step
    assert plan.works["swim_roofline_pct"] == [
        swim_work.tick_bytes(64, 64, False, 8, 3, True)]
    (ms,) = plan.works["swim_exchange_ms_per_round"]
    assert ms > 0 and not plan.sampling
