"""Parity, the fleet sweep (corro_sim_torch.sweep) against the JAX
package's, on the CPU.

The mixed plan of tests/test_sweep.py (12 nodes; lossy, crash-amnesia
and clock-skew lanes at seeds 0 and 1; chunks of 8): every port lane
equals the JAX package's ``run_sweep`` lane and the port's own serial
``run_sim`` twin, bit for bit (tolerance: exact) — every state leaf,
every metric, the rounds, the converged round, the resilience block and
the invariant report. The JAX sweep is one vmapped compile, shared by a
module fixture. The host side (knobs, grid grammar, validation, the
frontier) is held equal on the same inputs.
"""

import json
import types

import jax
import numpy as np
import pytest

from corro_sim.config import SimConfig as RefSimConfig
from corro_sim.sweep import build_plan as ref_build_plan
from corro_sim.sweep import knobs as ref_knobs
from corro_sim.sweep import parse_grid as ref_parse_grid
from corro_sim.sweep.engine import run_sweep as ref_run_sweep
from corro_sim.sweep.frontier import build_frontier as ref_build_frontier
from corro_sim.sweep.frontier import check_frontier as ref_check_frontier
from corro_sim_torch import config as pconfig
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.faults import (
    InvariantChecker,
    ResilienceScorecard,
    load_thresholds,
)
from corro_sim_torch.sweep import build_plan, knobs, parse_grid
from corro_sim_torch.sweep.engine import run_sweep
from corro_sim_torch.sweep.frontier import build_frontier, check_frontier

CHUNK = 8
MAX_ROUNDS = 256
BASE_KW = dict(
    num_nodes=12, num_rows=16, num_cols=2, log_capacity=64,
    write_rate=0.6, sync_interval=4, swim_enabled=True,
)
BASE = pconfig.SimConfig(**BASE_KW).validate()
REF_BASE = RefSimConfig(**BASE_KW).validate()
MIXED_SCENARIOS = [
    "lossy:p=0.2", "crash_amnesia:nodes=2,at=6,down=4",
    "clock_skew:nodes=3",
]
WL_SCENARIOS = [
    "crash_amnesia:nodes=2,at=6,down=4",
    "stale_rejoin:nodes=2,snap=2,at=6,down=4",
    "stragglers:frac=0.3,period=8,active=2",
]
WL_SPEC = "zipf:alpha=1.1,rate=0.5,keys=12"


def ref_leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True, default=str))


def assert_lane_equal(got, want_state: dict, want):
    """A port lane (or serial run) against a reference: state leaves,
    metrics, rounds, convergence, poison, resilience and invariants."""
    tag = (getattr(want, "spec", None), getattr(want, "seed", None))
    assert got.converged_round == want.converged_round, tag
    assert got.rounds == want.rounds, tag
    assert got.poisoned == want.poisoned, tag
    assert set(got.metrics) == set(want.metrics), tag
    for k in want.metrics:
        assert np.array_equal(np.asarray(got.metrics[k]),
                              np.asarray(want.metrics[k])), (*tag, k)
    have = state_to_numpy(got.state)
    assert set(have) == set(want_state), tag
    for k, v in want_state.items():
        assert have[k].dtype == v.dtype and np.array_equal(have[k], v), (
            *tag, k)
    assert _json(got.resilience) == _json(want.resilience), tag


def run_twin(lane, **kw):
    """The lane's serial ``run_sim`` twin on the port."""
    card = ResilienceScorecard(lane.cfg, scenario=lane.scenario,
                               workload=lane.workload)
    inv = InvariantChecker(lane.cfg)
    res = run_sim(
        lane.cfg, init_state(lane.cfg, seed=lane.seed, device="cpu"),
        lane.scenario.schedule(), max_rounds=MAX_ROUNDS, chunk=CHUNK,
        seed=lane.seed, min_rounds=lane.min_rounds, device="cpu",
        invariants=inv, scorecard=card, workload=lane.workload, **kw,
    )
    return res, inv


def assert_twin(lane_result, serial, inv):
    """A lane against its serial twin, as tests/test_sweep.py's
    ``_assert_twin`` does: every metric the twin computes (the union
    config may add zero-valued families), every leaf the twin's state
    holds (the lane adds its knob leaf), the scorecard and the
    verdict."""
    tag = (lane_result.spec, lane_result.seed)
    assert serial.converged_round == lane_result.converged_round, tag
    assert serial.rounds == lane_result.rounds, tag
    assert serial.poisoned == lane_result.poisoned, tag
    for k in serial.metrics:
        assert np.array_equal(np.asarray(serial.metrics[k]),
                              np.asarray(lane_result.metrics[k])), (*tag, k)
    lane_leaves = state_to_numpy(lane_result.state)
    for k, v in state_to_numpy(serial.state).items():
        assert np.array_equal(v, lane_leaves[k]), (*tag, k)
    assert _json(serial.resilience) == _json(lane_result.resilience), tag
    assert inv.ok == lane_result.invariants["ok"], tag
    assert _json(inv.report()) == _json(lane_result.invariants), tag


@pytest.fixture(scope="module")
def mixed():
    ref_plan = ref_build_plan(REF_BASE, MIXED_SCENARIOS, [0, 1], rounds=48,
                              write_rounds=8)
    ref = ref_run_sweep(ref_plan, max_rounds=MAX_ROUNDS, chunk=CHUNK)
    plan = build_plan(BASE, MIXED_SCENARIOS, [0, 1], rounds=48,
                      write_rounds=8)
    got = run_sweep(plan, max_rounds=MAX_ROUNDS, chunk=CHUNK, device="cpu")
    return types.SimpleNamespace(plan=plan, ref_plan=ref_plan, ref=ref,
                                 got=got)


def test_plan_union_and_lanes_equal_the_reference(mixed):
    plan, ref_plan = mixed.plan, mixed.ref_plan
    assert plan.num_lanes == ref_plan.num_lanes == 6
    assert _json(plan.union_cfg.__dict__) == _json(ref_plan.union_cfg.__dict__)
    for lane, rl in zip(plan.lanes, ref_plan.lanes):
        assert (lane.spec, lane.seed, lane.cell, lane.min_rounds) == (
            rl.spec, rl.seed, rl.cell, rl.min_rounds)
        assert set(lane.knobs) == set(rl.knobs)
        for k, v in rl.knobs.items():
            assert np.asarray(lane.knobs[k]).dtype == np.asarray(v).dtype
            assert np.array_equal(lane.knobs[k], v), (lane.spec, k)
        assert lane.repro_cmd(BASE, 48, 8, MAX_ROUNDS, CHUNK) == \
            rl.repro_cmd(REF_BASE, 48, 8, MAX_ROUNDS, CHUNK)


@pytest.mark.parametrize("li", range(6))
def test_mixed_lane_equals_reference_lane(mixed, li):
    """Every state leaf (the knob leaf included), metric, round count,
    resilience block and invariant report of the port's lane equals the
    JAX package's vmapped lane."""
    got, want = mixed.got.lanes[li], mixed.ref.lanes[li]
    assert_lane_equal(got, ref_leaves(want.state), want)
    assert _json(got.invariants) == _json(want.invariants)
    assert got.repro_cmd == want.repro_cmd


@pytest.mark.parametrize("li", range(6))
def test_mixed_lane_equals_serial_twin(mixed, li):
    """The lane runs under the union config with its knob leaf; its twin
    runs its own config — bit for bit the same run."""
    lane = mixed.plan.lanes[li]
    serial, inv = run_twin(lane)
    assert_twin(mixed.got.lanes[li], serial, inv)


def test_sweep_result_books_equal_the_reference(mixed):
    got, ref = mixed.got, mixed.ref
    assert (got.rounds, got.dispatches, got.chunk, got.devices) == (
        ref.rounds, ref.dispatches, ref.chunk, ref.devices)
    assert got.occupancy == ref.occupancy
    assert got.ok == ref.ok
    assert got.clusters_per_second_per_device > 0
    # one sync sweep per run: what the merge kernel launches per lane
    runs = sum(int(np.asarray(lr.metrics["sync_pairs"]).astype(bool).sum())
               for lr in got.lanes)
    assert got.sweeps["sweeps_run"] >= runs > 0


def test_frontier_equals_the_reference(mixed):
    got = build_frontier(mixed.got.lanes)
    want = ref_build_frontier(mixed.ref.lanes)
    assert _json(got) == _json(want)
    th = load_thresholds()
    assert check_frontier(got, th) == ref_check_frontier(want, th)
    strict = {"default": {"require_converged": True, "rows_lost_max": 0},
              "scenarios": {"lossy": {"recovery_rounds_worst_max": 0,
                                      "recovery_rounds_p95_max": 0}}}
    assert check_frontier(got, strict) == ref_check_frontier(want, strict)
    assert check_frontier(build_frontier(mixed.got.lanes, projected=True),
                          strict) == check_frontier(got, strict)


def test_progress_lines_match_the_reference():
    """The per-chunk progress dicts (less their walls) equal the JAX
    package's, on a one-scenario plan."""
    ref_lines, got_lines = [], []
    ref_run_sweep(ref_build_plan(REF_BASE, ["lossy:p=0.2"], [0, 1],
                                 rounds=48, write_rounds=8),
                  max_rounds=MAX_ROUNDS, chunk=CHUNK,
                  on_chunk=ref_lines.append)
    run_sweep(build_plan(BASE, ["lossy:p=0.2"], [0, 1], rounds=48,
                         write_rounds=8),
              max_rounds=MAX_ROUNDS, chunk=CHUNK, device="cpu",
              on_chunk=got_lines.append)
    for line in ref_lines + got_lines:
        line.pop("chunk_wall_s")
    assert got_lines == ref_lines


def test_sweep_leaf_absent_off_sweep(mixed):
    """Off the sweep the leaf is absent; under the union config it holds
    the neutral knobs, in the JAX package's dtypes."""
    assert "sweep_knobs" not in init_state(BASE, device="cpu").features
    union = mixed.plan.union_cfg
    leaf = init_state(union, device="cpu").features["sweep_knobs"]
    ref_union = mixed.ref_plan.union_cfg
    want = jax.tree.map(np.asarray, ref_knobs.neutral_knobs(ref_union))
    assert set(leaf) == set(want)
    for k, v in want.items():
        got = leaf[k].numpy()
        assert got.dtype == v.dtype and np.array_equal(got, v), k


@pytest.mark.parametrize("over", [
    dict(), dict(write_rate=0.3, sync_interval=2, swim_suspect_rounds=3,
                 delete_rate=0.1),
])
def test_neutral_and_lane_knobs_equal_the_reference(over):
    sweep = pconfig.SweepConfig(
        lanes=2, link_faults=True, burst=True, wipes=True, stale=True,
        skew=True, straggle=True, workload=True, sim_knobs=True)
    cfg = pconfig.SimConfig(**{**BASE_KW, **over}, sweep=sweep).validate()
    ref_cfg = RefSimConfig(**{**BASE_KW, **over},
                           sweep=_ref_sweep(sweep)).validate()
    got = knobs.neutral_knobs(cfg, device="cpu")
    want = jax.tree.map(np.asarray, ref_knobs.neutral_knobs(ref_cfg))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, k
        assert np.array_equal(got[k].numpy(), v), k
    lane_kw = dict(
        faults=dict(loss=0.25, dup=0.1, burst_enter=0.05, burst_exit=0.5,
                    burst_loss=0.75, sync_loss=0.2),
        node_faults=dict(crash=((1, 5),), stale=((3, 2, 7),),
                         skew=((2, 9),), straggle=((4, 5, 2),),
                         epoch_jump=7),
        write_rate=0.45, sync_interval=3,
    )
    lane = pconfig.sim_config_from_dict({**BASE_KW, **lane_kw})
    from corro_sim.config import FaultConfig, NodeFaultConfig

    ref_lane = RefSimConfig(
        **{**BASE_KW, **{k: v for k, v in lane_kw.items()
                         if k not in ("faults", "node_faults")}},
        faults=FaultConfig(**lane_kw["faults"]),
        node_faults=NodeFaultConfig(**lane_kw["node_faults"]),
    )
    got = knobs.lane_knobs(cfg, lane, use_workload=True)
    want = ref_knobs.lane_knobs(ref_cfg, ref_lane, use_workload=True)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        assert np.array_equal(got[k], v), k


def _ref_sweep(sweep):
    from corro_sim.config import SweepConfig

    return SweepConfig(**sweep.__dict__)


def test_lane_knobs_refuse_two_wipes_like_the_reference():
    union = build_plan(BASE, ["crash_amnesia:nodes=2,at=6,down=4"], [0],
                       rounds=48, write_rounds=8).union_cfg
    lane = pconfig.sim_config_from_dict({
        **BASE_KW, "node_faults": dict(crash=((1, 5), (1, 9)))})
    with pytest.raises(ValueError, match="more than one scheduled wipe"):
        knobs.lane_knobs(union, lane)


GRIDS = [
    ["scenario=lossy:p=0.1,dup=0.2,crash_amnesia:nodes=2,at=6,churn",
     "seed=0..3,8", "knob.loss=0.05,0.2"],
    ["scenario=lossy:p=0.1;churn", "knob.write_rate=0.3,0.5",
     "knob.sync_interval=2,4"],
    ["scenario=lossy", "knob.nosuch=1", "weird=2", "seed=a..b"],
    ["scenario=lossy:p=0.1", "knob.sync_peers=2,3"],
    ["scenario=lossy:p=0.1", "knob.loss=x"],
    ["nokey"],
]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", _json(fn(*args, **kw)))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("tokens", GRIDS)
def test_grid_grammar_equals_the_reference(tokens):
    assert _outcome(parse_grid, tokens) == _outcome(ref_parse_grid, tokens)


PLAN_CASES = [
    # unknown scenario, a coupling whose fault window never overlaps the
    # writes (both seeds), all in one error
    (["nosuch_scenario", "lossy:p=0.1",
      "crash_amnesia:nodes=2,at=40,down=4"], [0, 1],
     dict(rounds=64, write_rounds=8, workload_spec=WL_SPEC)),
    ([], [0], dict(rounds=48, write_rounds=8)),
    (["lossy:p=0.1"], [0], dict(rounds=48, write_rounds=8,
                                knob_combos=[{"loss": 2.0}])),
    (["lossy:p=0.1", "blackhole_one_way"], [0], dict(rounds=48,
                                                    write_rounds=8)),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_validation_reports_all_errors_like_the_reference(case):
    scenarios, seeds, kw = PLAN_CASES[case]
    got = _outcome(lambda: build_plan(BASE, scenarios, seeds, **kw).lanes
                   and None)
    want = _outcome(lambda: ref_build_plan(REF_BASE, scenarios, seeds,
                                           **kw).lanes and None)
    assert got == want
    if case == 0:
        assert got[0] == "error" and "nosuch_scenario" in got[1]
        assert got[1].count("never overlap") >= 2


def test_knob_axis_lands_in_lane_config_and_repro():
    plan = build_plan(BASE, ["lossy:p=0.1"], [0, 1],
                      knob_combos=[{"loss": 0.3}, {"zipf_alpha": 1.2}],
                      rounds=48, write_rounds=8)
    ref = ref_build_plan(REF_BASE, ["lossy:p=0.1"], [0, 1],
                         knob_combos=[{"loss": 0.3}, {"zipf_alpha": 1.2}],
                         rounds=48, write_rounds=8)
    for lane, rl in zip(plan.lanes, ref.lanes):
        assert lane.cell == rl.cell
        assert lane.repro_cmd(BASE, 48, 8, MAX_ROUNDS, CHUNK) == \
            rl.repro_cmd(REF_BASE, 48, 8, MAX_ROUNDS, CHUNK)
    assert plan.lanes[0].cfg.faults.loss == pytest.approx(0.3)
    assert "--knob loss=0.3" in plan.lanes[0].repro_cmd(
        BASE, 48, 8, MAX_ROUNDS, CHUNK)
    # zipf_alpha arms no leaf knob: a pure row_cdf swap
    assert not plan.union_cfg.sweep.sim_knobs


def test_mesh_is_refused_naming_the_multi_device_item():
    plan = build_plan(BASE, ["lossy:p=0.1"], [0], rounds=48,
                      write_rounds=8)
    with pytest.raises(NotImplementedError, match="queue 1.*multi-device"):
        run_sweep(plan, mesh=object(), device="cpu")
