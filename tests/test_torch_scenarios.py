"""Parity, the host side of faults: the scenario catalog, the invariant
checker and the resilience scorecard (corro_sim_torch.faults) against
the JAX package's, and whole soak runs under runtime schedules, on the
CPU.

The catalog must compile every spec to the same arrays, knobs and
events; the checker and the scorecard must report the same on the same
inputs (no compile). The soak runs (``profile_slice.run_soak`` against
the JAX package's serial soak loop) hold every state leaf, every metric,
the invariant report and the resilience block equal (tolerance:
exact). Scenarios whose faults are schedules (churn, rolling restarts,
split brain) share one config, so the JAX package compiles once. One
fault digest (config 8's lane base, 256 nodes) is held to its pinned JAX
run.
"""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest

from corro_sim.config import SimConfig
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.faults import scenarios as ref_scenarios
from corro_sim.faults import scorecard as ref_scorecard
from corro_sim.faults.invariants import InvariantChecker as RefChecker
from corro_sim.faults.scorecard import ResilienceScorecard as RefScorecard
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.faults import (
    SCENARIOS,
    InvariantChecker,
    check_thresholds,
    fifo_delivery_quantiles,
    load_thresholds,
    make_scenario,
    parse_scenario_spec,
)
from corro_sim_torch.faults import scenarios as port_scenarios
from corro_sim_torch.faults.scorecard import THRESHOLDS_PATH
from corro_sim_torch.profile_slice import (
    DIGESTS,
    FAULT_PINS,
    config8_lane_config,
    fault_digest_record,
    fault_digest_run,
    run_soak,
)

CFG = SimConfig(
    num_nodes=24, num_rows=32, num_cols=2, log_capacity=128,
    write_rate=0.4, swim_enabled=True, swim_interval=1, sync_interval=4,
    narrow_state=True,
)


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


# ------------------------------------------------------- the catalog (host)

CATALOG_SPECS = sorted(ref_scenarios.SCENARIOS) + [
    "lossy:p=0.3", "rolling_restart:batch=5,down=3,stagger=2",
    "split_brain_heal:at=0,heal=20,parts=3", "churn:rate=0.2,down=3",
    "crash_amnesia:nodes=4,at=6,down=2,jump=9",
    "stale_rejoin:nodes=3,snap=2,at=9", "clock_skew:nodes=5,max_skew=9",
    "stragglers:frac=0.3,period=5,active=3", "flapper:frac=0.25,period=3",
]


@pytest.mark.parametrize("spec", CATALOG_SPECS)
def test_catalog_compiles_identically(spec):
    for seed in (0, 5):
        want = ref_scenarios.make_scenario(spec, 24, rounds=64,
                                           write_rounds=16, seed=seed)
        got = make_scenario(spec, 24, rounds=64, write_rounds=16, seed=seed)
        for f in ("name", "params", "rounds", "write_rounds", "faults",
                  "node_faults", "events", "spec", "heal_round"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.fault_window() == want.fault_window()
        for f in ("alive", "part"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b)
        applied = got.apply(sim_config_from_dict(dataclasses.asdict(CFG)))
        assert dataclasses.asdict(applied) == dataclasses.asdict(
            want.apply(CFG))
        sched = got.schedule()
        assert sched.name == want.spec and sched.events == want.events


def test_catalog_tables_and_grammar_match():
    assert sorted(SCENARIOS) == sorted(ref_scenarios.SCENARIOS)
    assert port_scenarios.SOAK_DEFAULT == ref_scenarios.SOAK_DEFAULT
    for n in (5, 12):
        assert (port_scenarios.ring_blackhole(n)
                == ref_scenarios.ring_blackhole(n))
        assert (port_scenarios.star_blackhole(n, 2)
                == ref_scenarios.star_blackhole(n, 2))
    assert parse_scenario_spec("churn:rate=0.1") == (
        ref_scenarios.parse_scenario_spec("churn:rate=0.1"))
    with pytest.raises(ValueError, match="unknown scenario"):
        parse_scenario_spec("nope:x=1")


def _without_comments(d):
    if isinstance(d, dict):
        return {k: _without_comments(v) for k, v in d.items()
                if k != "_comment"}
    return d


def test_thresholds_golden_is_a_copy():
    """Every threshold of the port's golden equals the JAX package's;
    only the ``_comment`` entries differ."""
    with open(THRESHOLDS_PATH, encoding="utf-8") as fh:
        port = json.load(fh)
    want = ref_scorecard.load_thresholds(ref_scorecard.THRESHOLDS_PATH)
    assert _without_comments(port) == _without_comments(want)
    assert _without_comments(port)["scenarios"]["crash_amnesia"][
        "recovery_rounds_max"] == 48
    assert load_thresholds() == port


# ------------------------------------------- checker and scorecard (host)

def _stub(head, swim=None, table=None):
    return types.SimpleNamespace(
        book=types.SimpleNamespace(head=head), swim=swim, table=table)


def _both(cfg_kw):
    cfg = SimConfig(**cfg_kw)
    return RefChecker(cfg), InvariantChecker(
        sim_config_from_dict(dataclasses.asdict(cfg)))


@pytest.mark.parametrize("case", [
    "head_regression", "wipe_exempt", "conservation", "disagreement",
    "agreement", "swim_false_down", "swim_inside_window",
])
def test_invariant_checker_reports_match(case):
    """The same synthetic chunk fed to both checkers gives the same
    report, on each checker's own violation and the sanctioned cases."""
    rng = np.random.default_rng(0)
    alive = np.ones((2, 4), bool)
    part = np.zeros((2, 4), np.int32)
    kw = dict(num_nodes=4)
    if case == "wipe_exempt":
        from corro_sim.config import NodeFaultConfig

        kw["node_faults"] = NodeFaultConfig(crash=((0, 3),))
    if case.startswith("swim"):
        kw["swim_enabled"] = True
    checkers = _both(kw)
    reports = []
    for inv in checkers:
        h0 = np.array([[2, 1, 0, 0], [1, 1, 0, 0]] * 2, np.int32)
        if case in ("head_regression", "wipe_exempt"):
            inv.on_chunk(_stub(h0), {}, alive, part, 0)
            h1 = h0.copy()
            h1[0, 0] = 1
            inv.on_chunk(_stub(h1), {}, alive, part, 2)
        elif case == "conservation":
            m = {k: np.zeros(2, np.int64) for k in (
                "fault_matured", "fault_parked", "fault_emit_lost",
                "fault_unreachable", "fault_blackholed")}
            m.update(msgs_sent=np.array([10, 10]),
                     fault_delivered=np.array([8, 7]),
                     fault_lost=np.array([2, 2]))
            inv.on_chunk(_stub(h0), m, alive, part, 0)
        elif case in ("disagreement", "agreement"):
            cv = rng.integers(0, 2, (1, 4, 2)).repeat(4, 0).astype(np.int32)
            if case == "disagreement":
                cv[2, 1, 0] += 9
            table = types.SimpleNamespace(
                cv=cv, vr=np.zeros((4, 4, 2), np.int32),
                cl=np.zeros((4, 4), np.int32))
            inv.on_converged(_stub(h0, table=table), np.ones(4, bool),
                             np.zeros(4, np.int32))
        else:
            window = inv._swim_window_rounds()
            rounds = window + 4 if case == "swim_false_down" else window - 2
            status = np.zeros((4, 4), np.int8)
            status[0, 2] = 2
            inv.on_chunk(_stub(h0, swim=types.SimpleNamespace(status=status)),
                         {}, np.ones((rounds, 4), bool),
                         np.zeros((rounds, 4), np.int32), 0)
        reports.append(inv.report())
    assert reports[1] == reports[0]
    assert reports[0]["ok"] == (case in ("wipe_exempt", "agreement",
                                         "swim_inside_window"))


@pytest.mark.parametrize("pattern", ["steady", "flapping", "runs"])
def test_reach_streak_matches(pattern):
    """The port folds runs of equal schedule rows into one step of the
    streak clock; the clock must equal the JAX package's round-by-round
    one after every chunk."""
    rng = np.random.default_rng(len(pattern))
    n, chunk = 12, 8
    ref, port = _both(dict(num_nodes=n))
    for c in range(4):
        if pattern == "steady":
            alive = np.ones((chunk, n), bool)
            part = np.zeros((chunk, n), np.int32)
        elif pattern == "flapping":
            alive = rng.random((chunk, n)) < 0.8
            part = rng.integers(0, 2, (chunk, n)).astype(np.int32)
        else:
            rows = rng.random((3, n)) < 0.7
            alive = rows[np.sort(rng.integers(0, 3, chunk))]
            part = np.zeros((chunk, n), np.int32)
            part[chunk // 2:, : n // 2] = c % 2
        ref._update_reach_streak(alive, part)
        port._update_reach_streak(alive, part)
        np.testing.assert_array_equal(port._reach_streak, ref._reach_streak)


def test_scorecard_host_functions_match():
    rng = np.random.default_rng(2)
    applied = rng.integers(0, 9, 60)
    gap = np.cumsum(rng.integers(-3, 5, 60)).clip(0).astype(np.float32)
    for lo, hi, first in ((0, 20, 0), (10, 40, 0), (30, 59, 5), (70, 80, 0)):
        assert fifo_delivery_quantiles(applied, gap, lo, hi, first) == (
            ref_scorecard.fifo_delivery_quantiles(applied, gap, lo, hi,
                                                  first))
    thresholds = load_thresholds()
    for block in (
        dict(scenario="crash_amnesia", converged_round=None,
             recovery_rounds=None, rows_lost=0),
        dict(scenario="stale_rejoin:nodes=2", converged_round=70,
             recovery_rounds=60, rows_lost=3, resync_rows=0,
             swim_false_down=2),
        dict(scenario="lossy:p=0.1", converged_round=30,
             recovery_rounds=10, rows_lost=0),
    ):
        assert check_thresholds(block, thresholds) == (
            ref_scorecard.check_thresholds(block, thresholds))


# ---------------------------------------------------------- soak whole runs

def _ref_soak(cfg, spec, rounds, write_rounds, seed, **kw):
    """The JAX package's serial soak loop body (corro_sim/cli.py)."""
    sc = ref_scenarios.make_scenario(spec, cfg.num_nodes, rounds=rounds,
                                     write_rounds=write_rounds, seed=seed)
    c = sc.apply(cfg)
    inv = RefChecker(c)
    card = RefScorecard(c, scenario=sc)
    res = ref_run_sim(c, ref_init_state(c, seed=seed), sc.schedule(),
                      seed=seed,
                      min_rounds=max(sc.heal_round or 0, write_rounds),
                      invariants=inv, scorecard=card, **kw)
    return res, inv


@pytest.mark.parametrize("spec", [
    "churn:rate=0.05", "rolling_restart:batch=6,down=4",
    "split_brain_heal:at=4,heal=20", "crash_amnesia:nodes=3,at=6,down=3",
])
def test_soak_runs_match(spec):
    """Whole soak runs with the checker and the scorecard armed: state,
    metrics, invariant report and resilience block equal, pipelined and
    sequential. The schedule scenarios share CFG (one JAX compile)."""
    args = dict(rounds=48, write_rounds=8, seed=1)
    run_kw = dict(max_rounds=160, chunk=8)
    ref, ref_inv = _ref_soak(CFG, spec, **args, **run_kw)
    pcfg = sim_config_from_dict(dataclasses.asdict(CFG))
    for pipeline in (True, False):
        soak = run_soak(pcfg, spec, scorecard=True, pipeline=pipeline,
                        device="cpu", **args, **run_kw)
        got = soak.result
        assert got.rounds == ref.rounds
        assert got.converged_round == ref.converged_round is not None
        assert got.repair_chunks == ref.repair_chunks
        have, want = state_to_numpy(got.state), _leaves(ref.state)
        assert set(have) == set(want)
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=k)
        assert set(got.metrics) == set(ref.metrics)
        for k in ref.metrics:
            np.testing.assert_array_equal(got.metrics[k],
                                          np.asarray(ref.metrics[k]),
                                          err_msg=k)
        assert soak.invariants.report() == ref_inv.report()
        assert got.resilience == ref.resilience
        assert got.check_seconds["invariants"] >= 0
        events = [(e["r"], e["name"]) for e in got.flight.events()
                  if e["name"] in ("fault_event", "resilience", "converged",
                                   "invariant_violation")]
        assert events == [(e["r"], e["name"]) for e in ref.flight.events()
                          if e["name"] in ("fault_event", "resilience",
                                           "converged",
                                           "invariant_violation")]


def test_fault_digest_on_the_cpu():
    """Config 8's lane base (256 nodes) under crash_amnesia, seed 0, as
    chip_smoke.py's fault_digests phase runs it: the JAX package's
    pinned digest, rounds, invariant report and resilience integers."""
    case = "crash_amnesia@0"
    run = fault_digest_run(case, device="cpu")
    rec = fault_digest_record(case, run)
    assert rec["digest"] == DIGESTS[f"soak:{case}"]
    assert rec["match"], (rec, FAULT_PINS[case])
    assert run.cfg.num_nodes == config8_lane_config().num_nodes == 256
    assert run.result.resilience["rows_lost"] == 0
