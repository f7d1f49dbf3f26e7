"""Parity, the fleet scheduler (``run_sweep(compact=True)``), the
workload-coupled plan and per-lane SimConfig knobs, on the CPU.

The workload plan of tests/test_sweep.py (12 nodes; crash-amnesia,
stale-rejoin and straggler lanes, each coupled to a lane-seeded zipf
workload; chunks of 8) in lockstep equals the JAX package's lanes and
the port's serial twins; compacted at width 2, with and without the
pipelined dispatch, every lane equals its lockstep lane, and
``fleet_occupancy`` and the compaction record equal the JAX package's
field for field (tolerance: exact). The JAX package's own compact
occupancy test asserts that compaction wastes strictly fewer frozen
lane-rounds than lockstep on this grid; both waste 32 in the JAX
package, and the port reproduces that number rather than the
inequality (ROADMAP.md queue 3). A ``sim_knobs`` grid and a forked plan
are held against the port's serial twins.
"""

import types

import numpy as np
import pytest

from corro_sim.obs.lanes import fleet_occupancy as ref_fleet_occupancy
from corro_sim.sweep import build_plan as ref_build_plan
from corro_sim.sweep.engine import run_sweep as ref_run_sweep
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.faults import InvariantChecker, ResilienceScorecard
from corro_sim_torch.io.checkpoint import (
    load_sim_checkpoint,
    save_fork_checkpoint,
)
from corro_sim_torch.obs.lanes import fleet_occupancy
from corro_sim_torch.sweep import build_plan
from corro_sim_torch.sweep.engine import run_sweep
from test_torch_sweep import (
    BASE,
    CHUNK,
    MAX_ROUNDS,
    REF_BASE,
    WL_SCENARIOS,
    WL_SPEC,
    _json,
    assert_lane_equal,
    assert_twin,
    ref_leaves,
    run_twin,
)


def _wl_plan(build, base):
    return build(base, WL_SCENARIOS, [0], rounds=64, write_rounds=8,
                 workload_spec=WL_SPEC)


@pytest.fixture(scope="module")
def wl():
    ref_lock = ref_run_sweep(_wl_plan(ref_build_plan, REF_BASE),
                             max_rounds=MAX_ROUNDS, chunk=CHUNK)
    ref_comp = ref_run_sweep(_wl_plan(ref_build_plan, REF_BASE),
                             max_rounds=MAX_ROUNDS, chunk=CHUNK,
                             compact=True, width=2)
    plan = _wl_plan(build_plan, BASE)
    runs = {
        "lock": run_sweep(plan, max_rounds=MAX_ROUNDS, chunk=CHUNK,
                          device="cpu"),
        "compact": run_sweep(_wl_plan(build_plan, BASE),
                             max_rounds=MAX_ROUNDS, chunk=CHUNK,
                             compact=True, width=2, device="cpu"),
        "compact_pipelined": run_sweep(_wl_plan(build_plan, BASE),
                                       max_rounds=MAX_ROUNDS, chunk=CHUNK,
                                       compact=True, width=2,
                                       pipeline=True, device="cpu"),
    }
    return types.SimpleNamespace(plan=plan, ref_lock=ref_lock,
                                 ref_comp=ref_comp, **runs)


@pytest.mark.parametrize("li", range(3))
def test_workload_lane_equals_reference_lane(wl, li):
    got, want = wl.lock.lanes[li], wl.ref_lock.lanes[li]
    assert_lane_equal(got, ref_leaves(want.state), want)
    assert _json(got.invariants) == _json(want.invariants)


@pytest.mark.parametrize("li", range(3))
def test_workload_lane_equals_serial_twin(wl, li):
    """An early lane stays frozen at its convergence chunk while the
    straggler lane runs on; each equals the twin that stopped there."""
    serial, inv = run_twin(wl.plan.lanes[li])
    assert_twin(wl.lock.lanes[li], serial, inv)


def test_workload_lanes_settle_at_different_chunks(wl):
    rounds = [lr.rounds for lr in wl.lock.lanes]
    assert len(set(rounds)) > 1, rounds
    by_spec = {lr.spec.split(":")[0]: lr for lr in wl.lock.lanes}
    assert by_spec["stale_rejoin"].resilience["resync_rows"] > 0
    assert by_spec["crash_amnesia"].resilience["rows_lost"] == 0


@pytest.mark.parametrize("mode", ["compact", "compact_pipelined"])
@pytest.mark.parametrize("li", range(3))
def test_compact_lane_equals_lockstep_lane(wl, mode, li):
    got, want = getattr(wl, mode).lanes[li], wl.lock.lanes[li]
    assert_lane_equal(got, state_to_numpy(want.state), want)
    assert _json(got.invariants) == _json(want.invariants)


@pytest.mark.parametrize("mode", ["lock", "compact"])
def test_fleet_occupancy_equals_the_reference(wl, mode):
    """Field for field, the JAX package's books: executed = width ×
    rounds per dispatch, useful + wasted == executed."""
    got = fleet_occupancy(getattr(wl, mode))
    want = ref_fleet_occupancy(wl.ref_lock if mode == "lock"
                               else wl.ref_comp)
    assert got == want
    assert (got["useful_lane_rounds"] + got["wasted_frozen_lane_rounds"]
            == got["executed_lane_rounds"])


def test_compaction_record_equals_the_reference(wl):
    got, want = wl.compact, wl.ref_comp
    assert got.compaction == want.compaction
    assert got.compaction["refills"] > 0 and got.compaction["slot_reuse"]
    assert (got.rounds, got.dispatches) == (want.rounds, want.dispatches)


def test_compact_waste_matches_lockstep_on_this_grid(wl):
    """The reference's numbers on the 3-lane workload grid at width 2:
    compaction wastes as many frozen lane-rounds as lockstep (32), the
    same useful work, and the pipelined scheduler the same books."""
    lock = fleet_occupancy(wl.lock)
    comp = fleet_occupancy(wl.compact)
    assert comp["useful_lane_rounds"] == lock["useful_lane_rounds"]
    assert (comp["wasted_frozen_lane_rounds"]
            == lock["wasted_frozen_lane_rounds"]
            == fleet_occupancy(wl.ref_lock)["wasted_frozen_lane_rounds"])
    piped = fleet_occupancy(wl.compact_pipelined)
    assert piped == comp
    pipe = wl.compact_pipelined.pipeline
    assert 0 < pipe["speculative_wasted"] <= pipe["speculative_dispatched"]


SIM_KNOB_COMBOS = [
    {"write_rate": 0.3},
    {"sync_interval": 8},
    {"swim_suspect_rounds": 3},
    {"zipf_alpha": 1.2},
    {"write_rate": 0.8, "sync_interval": 2},
]


@pytest.fixture(scope="module")
def sim_knobs():
    plan = build_plan(BASE, ["lossy:p=0.1"], [0],
                      knob_combos=SIM_KNOB_COMBOS, rounds=48,
                      write_rounds=8)
    res = run_sweep(plan, max_rounds=MAX_ROUNDS, chunk=CHUNK,
                    compact=True, width=2, pipeline=True, device="cpu")
    return plan, res


@pytest.mark.parametrize("li", range(len(SIM_KNOB_COMBOS)))
def test_sim_knob_lane_equals_serial_twin(sim_knobs, li):
    """Write rate and delete rate as float32 thresholds, the sync and
    suspicion cadences, and zipf_alpha's row_cdf plane: each lane equals
    the twin whose config holds its value."""
    plan, res = sim_knobs
    assert plan.union_cfg.sweep.sim_knobs
    serial, inv = run_twin(plan.lanes[li])
    assert_twin(res.lanes[li], serial, inv)


def test_sim_knob_plan_equals_the_reference():
    plan = build_plan(BASE, ["lossy:p=0.1"], [0],
                      knob_combos=SIM_KNOB_COMBOS, rounds=48,
                      write_rounds=8)
    ref = ref_build_plan(REF_BASE, ["lossy:p=0.1"], [0],
                         knob_combos=SIM_KNOB_COMBOS, rounds=48,
                         write_rounds=8)
    assert _json(plan.union_cfg.__dict__) == _json(ref.union_cfg.__dict__)
    for lane, rl in zip(plan.lanes, ref.lanes):
        assert lane.cell == rl.cell
        for k, v in rl.knobs.items():
            assert np.array_equal(lane.knobs[k], v)
            assert np.asarray(lane.knobs[k]).dtype == np.asarray(v).dtype


FORK_SCENARIOS = ["lossy:p=0.2", "crash_amnesia:nodes=2,at=4,down=4"]


@pytest.fixture(scope="module")
def forked(tmp_path_factory):
    """A 16-round run's state as a fork token, and a compacted sweep of
    what-if lanes from it."""
    import dataclasses

    base_run = run_sim(BASE, init_state(BASE, device="cpu"),
                       Schedule(write_rounds=8), max_rounds=16, chunk=CHUNK,
                       device="cpu", stop_on_convergence=False)
    path = str(tmp_path_factory.mktemp("fork") / "fork.npz")
    save_fork_checkpoint(path, cfg=BASE, state=base_run.state, seed=0,
                         chunk=CHUNK, fork_round=base_run.rounds)
    tok = load_sim_checkpoint(path)
    base = dataclasses.replace(BASE, write_rate=0.0).validate()
    plan = build_plan(base, FORK_SCENARIOS, [0, 1], rounds=48,
                      write_rounds=0, fork=tok)
    res = run_sweep(plan, max_rounds=MAX_ROUNDS, chunk=CHUNK, compact=True,
                    width=2, device="cpu")
    return tok, plan, res


@pytest.mark.parametrize("li", range(4))
def test_forked_lane_equals_serial_fork_resume(forked, li):
    tok, plan, res = forked
    assert tok.is_fork and plan.fork_round == 16
    lane, lr = plan.lanes[li], res.lanes[li]
    card = ResilienceScorecard(lane.cfg, scenario=lane.scenario,
                               round_offset=plan.fork_round)
    inv = InvariantChecker(lane.cfg, round_offset=plan.fork_round)
    serial = run_sim(
        lane.cfg, init_state(lane.cfg, seed=lane.seed, device="cpu"),
        lane.scenario.schedule(), max_rounds=MAX_ROUNDS, chunk=CHUNK,
        seed=lane.seed, min_rounds=lane.min_rounds, device="cpu",
        invariants=inv, scorecard=card,
        resume=tok.refit(lane.cfg, lane.seed, CHUNK),
    )
    assert_twin(lr, serial, inv)
    assert "--fork" in lr.repro_cmd
    if lane.spec.startswith("crash"):
        # the wipes fired in the fork's frame
        assert lr.resilience["wipes"] == 2
