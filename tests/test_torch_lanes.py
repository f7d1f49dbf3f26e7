"""Parity, the fleet observatory (corro_sim_torch.obs.lanes), on the CPU.

Each lane flight demuxed from the port's sweep of the mixed plan of
tests/test_sweep.py equals the JAX package's demuxed flight on every
comparable field (``comparable_timeline``: meta, diagnostics, every
per-round series and the deterministic annotations; tolerance: exact),
and equals the port's own serial twin's flight. Heatmaps, their ASCII
rendering, the export filenames, the flight directory, the occupancy
books and the attached threshold breaches are held equal to the JAX
package's on the same inputs.
"""

import json
import types

import pytest

from corro_sim.obs import lanes as ref_lanes
from corro_sim.obs.flight import FlightRecorder as RefFlightRecorder
from corro_sim.sweep import build_plan as ref_build_plan
from corro_sim.sweep.engine import run_sweep as ref_run_sweep
from corro_sim.sweep.frontier import build_frontier as ref_build_frontier
from corro_sim.sweep.frontier import check_frontier as ref_check_frontier
from corro_sim_torch.obs.flight import FlightRecorder
from corro_sim_torch.obs.lanes import (
    comparable_timeline,
    demux_flights,
    fleet_occupancy,
    grid_heatmaps,
    lane_flight,
    lane_flight_filename,
    render_heatmap,
    sweep_status,
    write_lane_flights,
)
from corro_sim_torch.sweep import build_plan
from corro_sim_torch.sweep.engine import LaneResult, run_sweep
from corro_sim_torch.sweep.frontier import build_frontier, check_frontier
from test_torch_sweep import (
    BASE,
    CHUNK,
    MAX_ROUNDS,
    MIXED_SCENARIOS,
    REF_BASE,
    _json,
    run_twin,
)
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

# an impossible recovery bound: every cell with a recovery number breaches
IMPOSSIBLE = {"default": {"recovery_rounds_worst_max": -1},
              "scenarios": {}}


@pytest.fixture(scope="module")
def mixed():
    ref_plan = ref_build_plan(REF_BASE, MIXED_SCENARIOS, [0, 1], rounds=48,
                              write_rounds=8)
    ref = ref_run_sweep(ref_plan, max_rounds=MAX_ROUNDS, chunk=CHUNK)
    ref_status = ref_lanes.sweep_status()
    plan = build_plan(BASE, MIXED_SCENARIOS, [0, 1], rounds=48,
                      write_rounds=8)
    got = run_sweep(plan, max_rounds=MAX_ROUNDS, chunk=CHUNK, device="cpu")
    return types.SimpleNamespace(
        plan=plan, got=got, ref_plan=ref_plan, ref=ref,
        ref_status=ref_status, flights=demux_flights(plan, got),
        ref_flights=ref_lanes.demux_flights(ref_plan, ref))


@pytest.mark.parametrize("li", range(6))
def test_demuxed_flight_equals_the_reference(mixed, li):
    got = comparable_timeline(mixed.flights[li])
    want = ref_lanes.comparable_timeline(mixed.ref_flights[li])
    assert _json(got) == _json(want)
    # the lane-only annotations too
    for name in ("lane_freeze", "fault_window"):
        assert mixed.flights[li].events(name) == \
            mixed.ref_flights[li].events(name)
    assert mixed.flights[li].meta == mixed.ref_flights[li].meta


@pytest.mark.parametrize("li", [0, 2, 4])
def test_demuxed_flight_equals_serial_twin(mixed, li):
    """A link-fault, a node-wipe and a clock-skew lane: the demuxed
    flight equals the serial twin's recorder, with no re-run."""
    serial, _ = run_twin(mixed.plan.lanes[li])
    want = comparable_timeline(serial.flight)
    got = comparable_timeline(mixed.flights[li],
                              metrics=set(want["series"]))
    for key in ("meta", "diagnostics", "series", "events"):
        assert got[key] == want[key], (li, key)
    (freeze,) = mixed.flights[li].events("lane_freeze")
    assert freeze["r"] == mixed.got.lanes[li].rounds


def test_grid_heatmaps_and_render_equal_the_reference(mixed):
    got = grid_heatmaps(mixed.got.lanes)
    want = ref_lanes.grid_heatmaps(mixed.ref.lanes)
    assert _json(got) == _json(want)
    for metric in ("recovery_rounds", "rounds_to_convergence",
                   "rows_lost"):
        assert render_heatmap(got, metric) == \
            ref_lanes.render_heatmap(want, metric)


def _fake(spec, seed, cell, recovery, converged=10, poisoned=False):
    return LaneResult(
        index=0, spec=spec, seed=seed, cell=cell,
        converged_round=converged, rounds=32, poisoned=poisoned,
        heal_round=8, recovery_rounds=recovery, metrics={},
        resilience={"rows_lost": 0, "resync_rows": 1, "swim_false_down": 0,
                    "sub_delivery": {"degradation_p99": 1.5}},
        invariants={"ok": True, "violations": []},
        repro_cmd=f"corro-sim run --scenario '{spec}' --seed {seed}",
    )


def test_heatmap_holes_and_states_equal_the_reference():
    """Holes in the grid are null; unconverged and poisoned lanes mark
    their cells."""
    lanes = [_fake("lossy:p=0.1", s, "lossy:p=0.1", r)
             for s, r in enumerate([4, 6, 5, 40])] + [
        _fake("churn", 0, "churn", None, converged=None),
        _fake("churn", 2, "churn", 9, converged=None, poisoned=True)]
    got = grid_heatmaps(lanes)
    assert got == ref_lanes.grid_heatmaps(lanes)
    assert got["maps"]["recovery_rounds"][0][1] is None
    text = render_heatmap(got)
    assert text == ref_lanes.render_heatmap(got)
    churn = next(ln for ln in text.splitlines() if ln.startswith("churn"))
    assert "!" in churn and "P" in churn


@pytest.mark.parametrize("cell,seed", [
    ("lossy:p=0.1", 0), ("lossy#p=0.1", 0), ("lossy:p=0.1", 1),
    ("churn", 3), ("crash_amnesia:at=8,down=4#loss=0.2", 7),
])
def test_lane_flight_filename_equals_the_reference(cell, seed):
    assert lane_flight_filename(cell, seed) == \
        ref_lanes.lane_flight_filename(cell, seed)


def test_lane_flight_filenames_never_collide(mixed):
    names = {lane_flight_filename(c, s)
             for c in ("lossy:p=0.1", "lossy#p=0.1", "lossy-p=0.1",
                       "lossy:p-0.1")
             for s in (0, 1)}
    assert len(names) == 8
    assert lane_flight_filename("churn", 3) == "churn.seed3.ndjson"
    grid = {lane_flight_filename(lr.cell, lr.seed)
            for lr in mixed.got.lanes}
    assert len(grid) == len(mixed.got.lanes)


def test_flight_dir_round_trips(mixed, tmp_path):
    """Per-lane ND-JSON exports re-ingest bit for bit, and load in the
    JAX package's recorder with the same timeline."""
    paths = write_lane_flights(mixed.flights, str(tmp_path / "lanes"))
    assert len(paths) == mixed.plan.num_lanes
    lr0 = mixed.got.lanes[0]
    assert paths[0].endswith(lane_flight_filename(lr0.cell, lr0.seed))
    for path, fl in zip(paths, mixed.flights):
        fresh = FlightRecorder()
        fresh.ingest_ndjson(path)
        rt = str(tmp_path / "roundtrip.ndjson")
        fresh.dump(rt)
        assert open(path, "rb").read() == open(rt, "rb").read()
        other = RefFlightRecorder.load(path)
        assert _json(ref_lanes.comparable_timeline(other)) == \
            _json(comparable_timeline(fl))


def test_roundless_violation_anchors_at_convergence_round():
    sched = types.SimpleNamespace(name="lossy:p=0.1", write_rounds=0,
                                  events_in=lambda a, b: [])
    lane = types.SimpleNamespace(cfg=types.SimpleNamespace(num_nodes=4),
                                 schedule=sched, workload=None,
                                 scenario=None)
    lr = _fake("lossy:p=0.1", 0, "lossy:p=0.1", None)
    lr.invariants = {"ok": False, "violations": [
        {"round": None, "invariant": "convergence_disagreement",
         "detail": "nodes 0 and 1 differ"},
        {"round": 6, "invariant": "conservation", "detail": "x"},
    ]}
    got = lane_flight(lane, lr, chunk=8)
    want = ref_lanes.lane_flight(lane, lr, chunk=8)
    assert got.timeline()["events"] == want.timeline()["events"]
    anchors = {e["attrs"]["invariant"]: e["r"]
               for e in got.events("invariant_violation")}
    assert anchors == {"convergence_disagreement": 10, "conservation": 7}


def test_fleet_occupancy_and_status_equal_the_reference(mixed):
    got, want = fleet_occupancy(mixed.got), ref_lanes.fleet_occupancy(
        mixed.ref)
    assert got == want
    assert got["useful_lane_rounds"] == sum(lr.rounds
                                            for lr in mixed.got.lanes)
    actives = [e["lanes_active"] for e in got["curve"]]
    assert all(a >= b for a, b in zip(actives, actives[1:]))
    st = sweep_status()
    assert st is not None and st["phase"] == "done"
    for k in ("lanes", "rounds", "dispatches", "lanes_converged",
              "lanes_poisoned", "lanes_unsettled",
              "wasted_lane_rounds_total", "lane_states", "projected"):
        assert st[k] == mixed.ref_status[k], k
    json.dumps(st)


def test_demux_attaches_threshold_breaches_like_the_reference(mixed):
    breaches = check_frontier(build_frontier(mixed.got.lanes), IMPOSSIBLE)
    ref_breaches = ref_check_frontier(ref_build_frontier(mixed.ref.lanes),
                                      IMPOSSIBLE)
    assert breaches == ref_breaches
    flights = demux_flights(mixed.plan, mixed.got, breaches=breaches)
    ref_flights = ref_lanes.demux_flights(mixed.ref_plan, mixed.ref,
                                          breaches=ref_breaches)
    crash = [b for b in breaches
             if b.startswith(mixed.got.lanes[2].cell + ": ")]
    assert crash
    evs = flights[2].events("threshold_breach")
    assert evs and evs[0]["attrs"]["breach"] in crash
    assert not flights[0].events("threshold_breach")  # lossy: no heal
    for fl, rfl in zip(flights, ref_flights):
        assert fl.events("threshold_breach") == \
            rfl.events("threshold_breach")
