"""Parity of the digital twin (corro_sim_torch.engine.twin) with the JAX
package's ``corro_sim/engine/twin.py`` on the CPU.

- The committed fixture (``flyio_small.ndjson``, 4 lines per chunk, a
  cursor token every chunk) shadows to the JAX package's run: every
  state leaf, every per-round metric, every headline, the report and
  the flight record's ``(round, name, attrs)`` events. The JAX
  package's last headline carries ``gap == 1.0`` (its own
  tests/test_twin.py expects 0.0 there and fails; ROADMAP.md queue 3):
  the port carries the same 1.0, and the drain then takes the gap to 0.
- A shadow killed after chunk 1 resumes from its token field-identical
  to the uninterrupted run, and tokens cross backends both ways.
- The strict refusal's message and the quarantining run equal the JAX
  package's.
- The forecast grid of tests/test_twin.py from the fork: the frontier,
  the trend, the lane details and every lane's state and metrics equal
  the JAX package's; a lane equals its serial ``run_sim`` resumed from
  the fork token.
- ``TwinConfig`` adds no state leaves.
- A seeded Consul-schema feed (``profile_slice.twin_feed``, hostile
  lines quarantined) at 48 nodes, the port under ``merge_kernel="on"``
  (the plain merge through the mailbox) against the JAX package's run.

Tolerance: exact (the float ``gap`` as ROADMAP.md queue 3 says: the
port's exact sum equals the JAX package's float32 sum below 2**24).
"""

import dataclasses
import json
import pathlib
import shutil

import numpy as np
import pytest

from corro_sim.config import TwinConfig as RefTwinConfig
from corro_sim.engine import twin as rt
from corro_sim.engine.replay import read_table as r_read_table
from corro_sim.io.checkpoint import _simconfig_from_dict as ref_cfg_from
from corro_sim.io.checkpoint import load_sim_checkpoint as r_load
from corro_sim.sweep.engine import run_sweep as r_run_sweep
from corro_sim.sweep.plan import build_plan as r_build_plan
from corro_sim_torch.config import (
    TwinConfig,
    sim_config_from_dict,
    validate_torch_slice,
)
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine import twin as pt
from corro_sim_torch.engine.driver import run_sim
from corro_sim_torch.engine.replay import read_table
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.faults import InvariantChecker, ResilienceScorecard
from corro_sim_torch.io.checkpoint import load_sim_checkpoint
from corro_sim_torch.profile_slice import feed_config, twin_feed
from corro_sim_torch.profile_slice import (
    twin_forecast_record,
    twin_shadow_record,
    universe_view,
)
from test_torch_sweep import assert_twin, ref_leaves
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

FIXTURE = (pathlib.Path(__file__).parent / "fixtures" / "traces"
           / "flyio_small.ndjson")
# tests/test_twin.py's hand-derived converged table
EXPECTED = {
    ("services", ("web-1",)): {"name": "web", "port": 8082},
    ("services", ("api-1",)): {"name": "api", "port": 9191},
    ("services", ("blob-1",)): {"meta": b"\x00\x01\xfe\xff"},
    ("checks", ("api-1-http",)): {"status": "passing"},
}
FORECAST_SCENARIOS = ["lossy:p=0.3", "crash_amnesia:nodes=2,at=4,down=4"]
FORECAST_SEEDS = [0, 1]
FORECAST_ROUNDS, CHUNK, MAX_ROUNDS = 32, 8, 256
THRESHOLDS = {"twin_forecast": {
    "default": {"require_converged": True, "rows_lost_max": 0},
    "scenarios": {"crash_amnesia": {"recovery_rounds_worst_max": 48}},
}}


def _fixture_lines() -> list:
    with open(FIXTURE, encoding="utf-8") as f:
        return [ln for ln in f if ln.strip()]


def _ref_cfg(lines, **twin_kw):
    """The fixture's shadow config, as tests/test_twin.py builds it."""
    uni = rt.twin_universe(lines, 0)
    heads = rt.probe_feed_heads(lines, uni)
    return dataclasses.replace(
        uni.suggest_config(rounds=int(heads.max()) + 1),
        twin=RefTwinConfig(enabled=True, chunk_lines=4, **twin_kw),
    ).validate()


def _port_cfg(ref_cfg):
    return sim_config_from_dict(dataclasses.asdict(ref_cfg))


def _events(flight) -> list:
    return [(e["r"], e["name"],
             {k: v for k, v in e["attrs"].items() if k != "path"})
            for e in flight.events()]


def assert_same_shadow(got, want, ref_state=True):
    """A port shadow against a reference shadow: report, headlines,
    every metric (dtype too), every state leaf."""
    assert got.report == want.report
    assert got.headlines == want.headlines
    assert (got.rounds, got.feed_rounds, got.converged_round,
            got.poisoned) == (want.rounds, want.feed_rounds,
                              want.converged_round, want.poisoned)
    assert set(got.metrics) == set(want.metrics)
    for k, v in want.metrics.items():
        g = np.asarray(got.metrics[k])
        assert g.dtype == np.asarray(v).dtype and np.array_equal(g, v), k
    have = state_to_numpy(got.state)
    want_leaves = (ref_leaves(want.state) if ref_state
                   else state_to_numpy(want.state))
    assert set(have) == set(want_leaves)
    for k, v in want_leaves.items():
        assert have[k].dtype == v.dtype and np.array_equal(have[k], v), k


def _grab(ckpt, kill):
    def on_chunk(headline):
        # the token on disk when chunk 1's headline lands was written at
        # the previous chunk boundary: a genuine mid-feed cursor
        if headline["chunk"] == 1 and pathlib.Path(ckpt).exists():
            shutil.copy(ckpt, kill)
    return on_chunk


@pytest.fixture(scope="module")
def lines():
    return _fixture_lines()


@pytest.fixture(scope="module")
def shadows(lines, tmp_path_factory):
    """The fixture shadowed by both packages, each cursor-checkpointed
    every chunk with its mid-feed token kept."""
    tmp = tmp_path_factory.mktemp("twin")
    cfg = _ref_cfg(lines)
    ref = rt.run_twin(
        feed=str(FIXTURE), cfg=cfg, lines=lines, seed=0,
        checkpoint_path=str(tmp / "ref.npz"),
        on_chunk=_grab(tmp / "ref.npz", tmp / "ref.kill.npz"),
    )
    got = pt.run_twin(
        feed=str(FIXTURE), cfg=_port_cfg(cfg), lines=lines, seed=0,
        checkpoint_path=str(tmp / "port.npz"),
        on_chunk=_grab(tmp / "port.npz", tmp / "port.kill.npz"),
        device="cpu",
    )
    return {"ref": ref, "got": got, "cfg": cfg, "tmp": tmp,
            "ref_kill": str(tmp / "ref.kill.npz"),
            "port_kill": str(tmp / "port.kill.npz")}


def test_shadow_matches_the_jax_package(shadows):
    ref, got = shadows["ref"], shadows["got"]
    assert_same_shadow(got, ref)
    assert _events(got.flight) == _events(ref.flight)
    # the reference's headline fact: the last chunk ends at gap 1.0 and
    # the drain takes it to 0
    assert [h["gap"] for h in got.headlines][-1] == 1.0
    assert got.report["final_gap"] == 0.0 and got.converged_round
    assert got.report["chunks"] == 3 and got.report["late_clears"] == 1
    kinds = {e["name"] for e in got.flight.events()}
    assert {"twin_chunk", "twin_checkpoint", "twin_late_clear"} <= kinds
    view = universe_view(got.universe)
    for node in range(got.cfg.num_nodes):
        assert read_table(got.state, view, node) == EXPECTED
        assert r_read_table(ref.state, universe_view(ref.universe),
                            node) == EXPECTED
    # one blocking metric read per round run
    assert got.host_reads == got.rounds
    assert set(got.seconds) == {"feed", "late_clears", "refresh",
                                "checkpoint"}


def test_kill_and_resume_field_identical(shadows, lines):
    full = shadows["got"]
    tok = load_sim_checkpoint(shadows["port_kill"])
    assert 0 < tok.rounds < full.rounds  # genuinely mid-feed
    resumed = pt.run_twin(feed=str(FIXTURE), cfg=full.cfg, lines=lines,
                          seed=0, resume=tok, device="cpu")
    assert_same_shadow(resumed, full, ref_state=False)
    assert resumed.host_reads == full.rounds - tok.rounds


def test_tokens_cross_backends(shadows, lines):
    """The JAX package's mid-feed token resumes on the port to the JAX
    package's uninterrupted shadow; the port's resumes in the JAX
    package to the same."""
    ref = shadows["ref"]
    on_port = pt.run_twin(
        feed=str(FIXTURE), cfg=shadows["got"].cfg, lines=lines, seed=0,
        resume=load_sim_checkpoint(shadows["ref_kill"]), device="cpu")
    assert_same_shadow(on_port, ref)
    on_jax = rt.run_twin(feed=str(FIXTURE), cfg=shadows["cfg"],
                         lines=lines, seed=0,
                         resume=r_load(shadows["port_kill"]))
    assert on_jax.report == ref.report
    assert on_jax.headlines == ref.headlines
    for k, v in ref.metrics.items():
        assert np.array_equal(on_jax.metrics[k], v), k
    want = ref_leaves(ref.state)
    for k, v in ref_leaves(on_jax.state).items():
        assert np.array_equal(v, want[k]), k


def test_resume_refuses_a_different_feed(shadows, lines):
    tok = load_sim_checkpoint(shadows["port_kill"])
    cfg = shadows["got"].cfg
    with pytest.raises(ValueError, match="only has"):
        pt.run_twin(lines=lines[:2], cfg=cfg, seed=0, resume=tok,
                    device="cpu")
    edited = [lines[1]] + [lines[0]] + lines[2:]
    with pytest.raises(ValueError, match="feed mismatch"):
        pt.run_twin(lines=edited, cfg=cfg, seed=0, resume=tok,
                    device="cpu")


def test_strict_refusal_and_quarantine_match(lines):
    cfg = _ref_cfg(lines)
    hostile = lines + ["{nope", lines[0]]  # malformed + duplicate
    with pytest.raises(ValueError) as want:
        rt.run_twin(lines=hostile, cfg=cfg, seed=0)
    with pytest.raises(ValueError) as got:
        pt.run_twin(lines=hostile, cfg=_port_cfg(cfg), seed=0,
                    device="cpu")
    assert str(got.value) == str(want.value)
    assert "2 bad lines" in str(got.value)
    skip = _ref_cfg(lines, skip_bad=True)
    ref = rt.run_twin(lines=hostile, cfg=skip, seed=0)
    res = pt.run_twin(lines=hostile, cfg=_port_cfg(skip), seed=0,
                      device="cpu")
    assert_same_shadow(res, ref)
    assert res.report["bad_by_reason"] == {"malformed": 1,
                                           "stale_version": 1}


@pytest.fixture(scope="module")
def forecasts(shadows):
    """The forecast grid from each package's fork of its shadow, and the
    JAX package's sweep of the same plan (its lanes' states)."""
    tmp = shadows["tmp"]
    r_tok = rt.fork_twin(shadows["ref"], str(tmp / "ref.fork.npz"),
                         chunk=CHUNK)
    p_tok = pt.fork_twin(shadows["got"], str(tmp / "port.fork.npz"),
                         chunk=CHUNK)
    kw = dict(rounds=FORECAST_ROUNDS, max_rounds=MAX_ROUNDS, chunk=CHUNK,
              thresholds=THRESHOLDS)
    r_fc = rt.run_forecast(r_tok, FORECAST_SCENARIOS, FORECAST_SEEDS, **kw)
    p_fc = pt.run_forecast(p_tok, FORECAST_SCENARIOS, FORECAST_SEEDS,
                           device="cpu", **kw)
    from corro_sim.config import FaultConfig, NodeFaultConfig

    base = dataclasses.replace(
        r_tok.cfg, faults=FaultConfig(), node_faults=NodeFaultConfig(),
        write_rate=0.0).validate()
    r_plan = r_build_plan(base, FORECAST_SCENARIOS, FORECAST_SEEDS,
                          rounds=FORECAST_ROUNDS, write_rounds=0,
                          fork=r_tok)
    r_sweep = r_run_sweep(r_plan, max_rounds=MAX_ROUNDS, chunk=CHUNK)
    return r_tok, p_tok, r_fc, p_fc, r_sweep


def _block(fc: dict, fork_path: str) -> dict:
    out = {k: v for k, v in fc.items()
           if k not in ("fork", "wall_seconds", "compile_seconds",
                        "compile_cache", "sweep")}
    return json.loads(json.dumps(out, sort_keys=True, default=str)
                      .replace(fork_path, "<fork>"))


def test_forecast_matches_the_jax_package(forecasts):
    r_tok, p_tok, r_fc, p_fc, r_sweep = forecasts
    assert p_tok.is_fork and p_tok.fork_round == r_tok.fork_round
    assert set(p_tok.state_flat) == set(r_tok.state_flat)
    for k, v in r_tok.state_flat.items():
        assert p_tok.state_flat[k].dtype == v.dtype, k
        assert np.array_equal(p_tok.state_flat[k], v), k
    assert _block(p_fc, p_tok.path) == _block(r_fc, r_tok.path)
    assert p_fc["ok"] and p_fc["lanes"] == 4
    assert p_fc["frontier"]["projected"] is True
    assert p_fc["trend"]["fork_round"] == r_tok.fork_round
    lanes = p_fc["sweep"].lanes
    assert len(lanes) == len(r_sweep.lanes) == 4
    for got, want in zip(lanes, r_sweep.lanes):
        assert (got.spec, got.seed) == (want.spec, want.seed)
        assert (got.rounds, got.converged_round, got.poisoned) == (
            want.rounds, want.converged_round, want.poisoned)
        for k, v in want.metrics.items():
            assert np.array_equal(np.asarray(got.metrics[k]),
                                  np.asarray(v)), (got.spec, k)
        have = state_to_numpy(got.state)
        for k, v in ref_leaves(want.state).items():
            assert np.array_equal(have[k], v), (got.spec, got.seed, k)


def test_forecast_lane_equals_serial_fork_resume(forecasts):
    """The crash lane at seed 0 against the serial ``run_sim`` resumed
    from the same fork token: the wipes fire in the fork's frame."""
    _, tok, _, p_fc, _ = forecasts
    from corro_sim_torch.config import FaultConfig, NodeFaultConfig
    from corro_sim_torch.sweep.plan import build_plan

    base = dataclasses.replace(
        tok.cfg, faults=FaultConfig(), node_faults=NodeFaultConfig(),
        write_rate=0.0).validate()
    plan = build_plan(base, FORECAST_SCENARIOS, FORECAST_SEEDS,
                      rounds=FORECAST_ROUNDS, write_rounds=0, fork=tok)
    li = next(i for i, lane in enumerate(plan.lanes)
              if lane.spec.startswith("crash") and lane.seed == 0)
    lane = plan.lanes[li]
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
    lr = p_fc["sweep"].lanes[li]
    assert_twin(lr, serial, inv)
    assert serial.resilience == lr.resilience
    assert lr.resilience["wipes"] == 2


def test_twin_config_adds_no_state_leaves():
    from corro_sim_torch.config import SimConfig

    base = SimConfig(num_nodes=8, num_rows=8, num_cols=2,
                     log_capacity=16).validate()
    on = dataclasses.replace(base, twin=TwinConfig(
        enabled=True, chunk_lines=4, skip_bad=True)).validate()
    assert validate_torch_slice(on) is on
    a = state_to_numpy(init_state(base, seed=0, device="cpu"))
    b = state_to_numpy(init_state(on, seed=0, device="cpu"))
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def consul_feed():
    return twin_feed(1, 32, 8, keys=32, hostile=0.02)


def test_consul_feed_shadow_matches_the_jax_package(consul_feed):
    """A Consul-schema feed with hostile lines, EmptySets and deletes,
    at 48 nodes with config 3's protocol knobs: the port under
    ``merge_kernel="on"`` against the JAX package's run."""
    feed = consul_feed
    pcfg = feed_config(feed.lines, 48, chunk_lines=64, drain_rounds=512)
    assert (pcfg.num_rows, pcfg.num_cols) == (64, 6)
    ref = rt.run_twin(cfg=ref_cfg_from(dataclasses.asdict(pcfg)),
                      lines=feed.lines, seed=0)
    got = pt.run_twin(
        cfg=dataclasses.replace(pcfg, merge_kernel="on"), lines=feed.lines,
        seed=0, device="cpu")
    assert got.report == dict(ref.report)
    assert got.headlines == ref.headlines
    for k, v in ref.metrics.items():
        assert np.array_equal(got.metrics[k], v), k
    have, want = state_to_numpy(got.state), ref_leaves(ref.state)
    for k, v in want.items():
        assert np.array_equal(have[k], v), k
    assert got.converged_round is not None and not got.poisoned
    assert got.report["bad_by_reason"] == feed.expected_bad(64)
    assert got.report["late_clears"] + got.report["late_applied"] > 0
    view = universe_view(got.universe)
    tables = [read_table(got.state, view, i) for i in range(48)]
    assert all(t == tables[0] for t in tables)
    assert len(tables[0]) > 0


def test_pin_records_agree_across_backends(shadows, forecasts):
    """The records chip_smoke.py holds to ``TWIN_PINS`` come out the same
    from either package's run."""
    r_tok, p_tok, r_fc, p_fc, r_sweep = forecasts
    got = twin_shadow_record(state_to_numpy(shadows["got"].state),
                             shadows["got"])
    assert got == twin_shadow_record(ref_leaves(shadows["ref"].state),
                                     shadows["ref"])
    got = twin_forecast_record(p_fc, p_tok.path, [
        (lr.spec, lr.seed, state_to_numpy(lr.state), lr.metrics)
        for lr in p_fc["sweep"].lanes])
    assert got == twin_forecast_record(r_fc, r_tok.path, [
        (lr.spec, lr.seed, ref_leaves(lr.state), lr.metrics)
        for lr in r_sweep.lanes])
    assert len(got["lanes"]) == 4


def jax_twin_pins(tmp_dir) -> dict:
    """``profile_slice.TWIN_PINS``: the JAX package's runs on the CPU of
    chip_smoke.py's twin phases (about a minute):

    - "twin_digests": ``twin_feed(**TWIN_DIGEST_FEED)`` shadowed at
      ``TWIN_DIGEST_NODES`` nodes (``feed_config``, chunks of
      ``TWIN_DIGEST_CHUNK`` lines, seed 0), its ``twin_shadow_record``;
      then ``fork_twin`` (chunk 8) and ``run_forecast`` of the
      ``TWIN_FORECAST`` grid with ``TWIN_THRESHOLDS``, and the sweep of
      the same plan for the lanes' states: its
      ``twin_forecast_record``;
    - "twin_10k": ``twin_feed(**TWIN_10K_FEED)`` shadowed at
      ``TWIN_PIN_NODES`` nodes in chunks of ``TWIN_10K_CHUNK`` lines:
      node 0's decoded table (``table_digest`` of ``read_table``), its
      live rows and the quarantine tallies.

    Run: ``cd tests && JAX_PLATFORMS=cpu python -c "import
    test_torch_twin as t, tempfile; print(t.jax_twin_pins(
    tempfile.mkdtemp()))"``."""
    import os

    from corro_sim.config import FaultConfig, NodeFaultConfig
    from corro_sim_torch.profile_slice import (
        TWIN_10K_CHUNK,
        TWIN_10K_FEED,
        TWIN_DIGEST_CHUNK,
        TWIN_DIGEST_FEED,
        TWIN_DIGEST_NODES,
        TWIN_FORECAST,
        TWIN_PIN_NODES,
        TWIN_THRESHOLDS,
        table_digest,
    )

    fc_kw = dict(TWIN_FORECAST)
    scenarios, seeds = fc_kw.pop("scenarios"), fc_kw.pop("seeds")
    feed = twin_feed(**TWIN_DIGEST_FEED)
    cfg = ref_cfg_from(dataclasses.asdict(feed_config(
        feed.lines, TWIN_DIGEST_NODES, TWIN_DIGEST_CHUNK)))
    res = rt.run_twin(cfg=cfg, lines=feed.lines, seed=0)
    tok = rt.fork_twin(res, os.path.join(tmp_dir, "fork.npz"),
                       chunk=fc_kw["chunk"])
    fc = rt.run_forecast(tok, scenarios, seeds, thresholds=TWIN_THRESHOLDS,
                         **fc_kw)
    base = dataclasses.replace(
        tok.cfg, faults=FaultConfig(), node_faults=NodeFaultConfig(),
        write_rate=0.0).validate()
    plan = r_build_plan(base, scenarios, seeds, rounds=fc_kw["rounds"],
                        write_rounds=0, fork=tok)
    sweep = r_run_sweep(plan, max_rounds=fc_kw["max_rounds"],
                        chunk=fc_kw["chunk"])
    digests = {
        "shadow": twin_shadow_record(ref_leaves(res.state), res),
        **twin_forecast_record(fc, tok.path, [
            (lr.spec, lr.seed, ref_leaves(lr.state), lr.metrics)
            for lr in sweep.lanes]),
    }
    feed = twin_feed(**TWIN_10K_FEED)
    cfg = ref_cfg_from(dataclasses.asdict(feed_config(
        feed.lines, TWIN_PIN_NODES, TWIN_10K_CHUNK)))
    res = rt.run_twin(cfg=cfg, lines=feed.lines, seed=0)
    table = r_read_table(res.state, universe_view(res.universe), 0)
    return {"twin_digests": digests, "twin_10k": {
        "table": table_digest(table), "live_rows": len(table),
        "bad_by_reason": res.report["bad_by_reason"],
        "rounds_at_256": res.rounds,
    }}
