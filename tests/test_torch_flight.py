"""The port's flight recorder against the JAX package's.

``corro_sim_torch.obs.flight.FlightRecorder`` is a copy of
``corro_sim/obs/flight.py``: the recorder cases of tests/test_flight.py
that need no live cluster run here on the port's copy (record, export
and load round-trip byte for byte; derived diagnostics; torn-tail load;
the journal; the bounded ring; an unwritable sink). Then one seeded run
through both packages' ``run_sim`` must record the same per-round
records, and the same ``(round, name)`` event sequence once the JAX
package's compile events and the wall-time and jit/aot attributes are
dropped (tolerance: exact).
"""

import dataclasses

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest

from corro_sim.config import SimConfig as RefSimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.obs.flight import FlightRecorder as RefFlightRecorder
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.obs import FlightRecorder


def _synthetic(cls=FlightRecorder):
    """An exponential gap decay: 64 / 2^(r/4) — half-life 4 rounds."""
    fl = cls()
    fl.set_meta(driver="test", nodes=8)
    gaps = [0.0, 16.0, 64.0] + [64.0 * 2 ** (-(r - 2) / 4.0)
                                for r in range(3, 28)] + [0.0, 0.0]
    fl.record_rounds(1, {"gap": gaps, "pend_live": [1.0] * len(gaps)})
    fl.annotate(2, "schedule_transition", kind="write_phase_end")
    fl.annotate(16, "chunk", chunk=0, runner="full", wall_s=0.5)
    fl.annotate(30, "chunk", chunk=1, runner="repair", wall_s=0.25)
    fl.record_phase("setup", 1.5)
    fl.record_phase("execute", 0.75)
    return fl


def test_diagnostics_convergence_curve():
    d = _synthetic().diagnostics()
    assert d["rounds_recorded"] == 30
    assert d["peak_gap"] == 64.0
    assert d["final_gap"] == 0.0
    assert d["converged_round"] == 29
    assert d["gap_half_life_rounds"] == pytest.approx(4.0, rel=0.05)
    assert d["epidemic_window_rounds"] >= 1
    assert d["wall_s_by_phase"] == {"setup": 1.5, "execute": 0.75}
    assert d["chunk_wall_s_by_runner"] == {"full": 0.5, "repair": 0.25}
    # the copy derives exactly what the JAX package's recorder derives
    assert d == _synthetic(RefFlightRecorder).diagnostics()


def test_not_converged_and_poisoned():
    fl = FlightRecorder()
    fl.record_rounds(1, {"gap": [4.0, 2.0, 1.0]})
    assert fl.diagnostics()["converged_round"] is None
    fl2 = FlightRecorder()
    fl2.record_rounds(1, {"gap": [4.0, 0.0]})
    fl2.annotate(2, "log_wrapped")
    d = fl2.diagnostics()
    assert d["poisoned"] is True and d["converged_round"] is None


def test_ndjson_roundtrip_bit_identical(tmp_path):
    fl = _synthetic()
    p1, p2 = str(tmp_path / "a.ndjson"), str(tmp_path / "b.ndjson")
    fl.dump(p1)
    back = FlightRecorder.load(p1)
    back.dump(p2)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    assert back.diagnostics() == fl.diagnostics()
    assert back.timeline() == fl.timeline()
    # the JAX package's export is the same bytes, and loads here
    p3 = str(tmp_path / "ref.ndjson")
    _synthetic(RefFlightRecorder).dump(p3)
    assert open(p1, "rb").read() == open(p3, "rb").read()
    assert FlightRecorder.load(p3).timeline() == fl.timeline()


def test_ingest_ndjson_roundtrip_bit_identical(tmp_path):
    fl = _synthetic()
    p1, p2 = str(tmp_path / "a.ndjson"), str(tmp_path / "b.ndjson")
    fl.dump(p1)
    fresh = FlightRecorder()
    fresh.ingest_ndjson(p1)
    fresh.dump(p2)
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_load_tolerates_torn_tail(tmp_path):
    fl = _synthetic()
    p = str(tmp_path / "torn.ndjson")
    fl.dump(p)
    with open(p, "a") as f:
        f.write('{"t": "round", "r": 99, "m": {"ga')  # killed mid-write
    back = FlightRecorder.load(p)
    assert back.diagnostics()["rounds_recorded"] == 30


def test_sink_journal_matches_state(tmp_path):
    p = str(tmp_path / "journal.ndjson")
    fl = FlightRecorder(sink_path=p)
    fl.set_meta(driver="test")
    fl.record_rounds(1, {"gap": [2.0, 0.0]})
    fl.annotate(2, "converged")
    fl.close()
    back = FlightRecorder.load(p)
    assert back.series("gap") == ([1, 2], [2.0, 0.0])
    assert back.diagnostics()["converged_round"] == 2


def test_ring_is_bounded():
    fl = FlightRecorder(capacity=8)
    fl.record_rounds(1, {"gap": list(range(32, 0, -1))})
    rs, _ = fl.series("gap")
    assert rs == list(range(25, 33))


def test_attach_sink_unwritable_is_survivable(tmp_path):
    fl = _synthetic()
    fl.attach_sink(str(tmp_path / "no-such-dir" / "x.ndjson"))
    fl.record_rounds(100, {"gap": [1.0]})  # must not raise
    assert fl.sink_path != str(tmp_path / "x.ndjson")


# one run through both run_sims: writes for 4 rounds, a partition for
# rounds 2-5, adaptive sync, convergence tested from round 20 on (the
# repair switch lands mid-run)
REF_CFG = RefSimConfig(
    num_nodes=16, num_rows=16, num_cols=2, log_capacity=64,
    write_rate=0.5, swim_enabled=False, sync_interval=4, sync_adaptive=True,
    sync_actor_topk=8, sync_cap_per_actor=2,
)


def _part(r, num):
    p = np.zeros(num, np.int32)
    if 2 <= r < 6:
        p[num // 2:] = 1
    return p


# attributes that carry host walls or the JAX package's compile mode
_TIMING = {"wall_s", "aot", "fetch_wait_s", "execute_wall_s",
           "overlap_ratio", "speculative_copy_bytes"}


def _events(fl):
    return [
        (e["r"], e["name"],
         {k: v for k, v in e["attrs"].items() if k not in _TIMING})
        for e in fl.events() if e["name"] != "compile"
    ]


@pytest.fixture(scope="module")
def ref_runs():
    return {
        pipeline: ref_run_sim(
            REF_CFG, ref_init_state(REF_CFG, seed=0),
            RefSchedule(write_rounds=4, part_fn=_part),
            max_rounds=64, chunk=4, seed=0, min_rounds=20,
            pipeline=pipeline,
        )
        for pipeline in (False, True)
    }


@pytest.mark.parametrize("pipeline", [False, True])
def test_run_sim_flight_matches_reference(ref_runs, pipeline):
    ref = ref_runs[pipeline]
    cfg = sim_config_from_dict(dataclasses.asdict(REF_CFG))
    res = run_sim(cfg, init_state(cfg, seed=0, device="cpu"),
                  Schedule(write_rounds=4, part_fn=_part), max_rounds=64,
                  chunk=4, seed=0, min_rounds=20, device="cpu",
                  pipeline=pipeline)
    assert res.converged_round == ref.converged_round is not None
    assert res.repair_chunks == ref.repair_chunks > 0
    got, want = res.flight.timeline(), ref.flight.timeline()
    assert got["rounds"] == want["rounds"]
    assert _events(res.flight) == _events(ref.flight)
    names = {e[1] for e in _events(res.flight)}
    assert {"chunk", "converged", "schedule_transition",
            "repair_program_switch"} <= names
    d = res.flight.diagnostics()
    assert d["converged_round"] == want["diagnostics"]["converged_round"]
    assert set(d["wall_s_by_phase"]) >= {"setup", "execute", "drain"}
    assert res.pipeline["enabled"] is pipeline


def test_on_chunk_gets_the_reference_keys(ref_runs):
    got, want = [], []
    cfg = sim_config_from_dict(dataclasses.asdict(REF_CFG))
    run_sim(cfg, init_state(cfg, seed=0, device="cpu"),
            Schedule(write_rounds=4, part_fn=_part), max_rounds=16, chunk=4,
            seed=0, device="cpu", on_chunk=got.append)
    ref_run_sim(REF_CFG, ref_init_state(REF_CFG, seed=0),
                RefSchedule(write_rounds=4, part_fn=_part), max_rounds=16,
                chunk=4, seed=0, on_chunk=want.append)
    assert [set(g) for g in got] == [set(w) for w in want]
    for g, w in zip(got, want):
        for k in ("chunk", "rounds_done", "runner", "gap", "pend_live"):
            assert g[k] == w[k], k


def test_schedule_events_land_as_fault_events():
    cfg = sim_config_from_dict(dataclasses.asdict(REF_CFG))
    sched = Schedule(write_rounds=4, part_fn=_part, name="split",
                     events=[(2, "split", {"side": "upper"}),
                             (6, "heal", {})])
    res = run_sim(cfg, init_state(cfg, seed=0, device="cpu"), sched,
                  max_rounds=16, chunk=4, seed=0, device="cpu",
                  stop_on_convergence=False)
    faults = [(e["r"], e["attrs"]["kind"]) for e in res.flight.events()
              if e["name"] == "fault_event"]
    assert faults == [(3, "split"), (7, "heal")]
    assert res.flight.meta["scenario"] == "split"
    assert sched.events_in(0, 4) == [(2, "split", {"side": "upper"})]
