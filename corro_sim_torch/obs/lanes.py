"""Fleet observatory: per-lane flight timelines of a sweep.

Port of ``corro_sim/obs/lanes.py``, host-side, on what ``run_sweep``
returns:

- :func:`lane_flight` / :func:`demux_flights` rebuild each lane's
  :class:`~corro_sim_torch.obs.flight.FlightRecorder` timeline, equal to
  its serial twin's (per-round series, derived diagnostics, fault,
  workload, schedule, convergence, poison and resilience annotations)
  plus lane annotations (the freeze round, the fault window through a
  fork's ``round_offset``, threshold breaches from
  :func:`~corro_sim_torch.sweep.frontier.check_frontier`);
  :func:`comparable_timeline` is the equality oracle (host wall-clock
  fields are left out);
- :func:`grid_heatmaps` / :func:`render_heatmap`: cell × seed maps of
  rounds to convergence, recovery, rows lost and degradation, as JSON
  and ASCII;
- :func:`fleet_occupancy`: the per-dispatch occupancy curve and the
  wasted frozen-lane rounds, by the JAX package's definitions (a
  dispatch executes its width × its rounds), so its numbers equal the
  JAX package's for the same plan; the port's host loop skips a frozen
  lane's rounds rather than selecting them away;
- :func:`sweep_status`: the process-wide snapshot ``run_sweep``
  publishes per chunk.

Everything here is duck-typed against
:class:`~corro_sim_torch.sweep.plan.SweepLane` and
:class:`~corro_sim_torch.sweep.engine.LaneResult`, with no sweep import
at module scope.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from corro_sim_torch.obs.flight import FlightRecorder

__all__ = [
    "comparable_timeline",
    "demux_flights",
    "fleet_occupancy",
    "grid_heatmaps",
    "lane_flight",
    "lane_flight_filename",
    "publish_sweep_progress",
    "publish_sweep_result",
    "render_heatmap",
    "sweep_status",
    "write_lane_flights",
]


# ------------------------------------------------------------ lane flights

def _scalar_attrs(block: dict) -> dict:
    """The annotation-safe subset of a report block — exactly the filter
    the serial driver applies to its ``resilience`` annotation."""
    return {
        k: v for k, v in block.items()
        if isinstance(v, (int, float, str, bool)) or v is None
    }


def lane_flight(
    lane,
    result,
    *,
    chunk: int = 16,
    round_offset: int = 0,
    projected: bool = False,
    breaches: list | tuple = (),
    capacity: int = 65536,
) -> FlightRecorder:
    """One lane's :class:`FlightRecorder`, rebuilt from the dispatch's
    own outputs (``LaneResult.metrics`` + the plan's schedules) with no
    re-execution.

    Field-identity contract (tests/test_torch_lanes.py, via
    :func:`comparable_timeline`): the per-round metric series,
    the derived diagnostics, and every serial-comparable annotation
    (``fault_event``, ``workload_event``, ``schedule_transition``,
    ``converged``, ``log_wrapped``, ``invariant_violation``,
    ``resilience``) equal the serial twin's flight — a consequence of
    the sweep's per-lane bit-identity (tests/test_torch_sweep.py) plus the
    serial driver's annotation rules reproduced here host-side.

    ``chunk`` is the sweep's dispatch chunk (the serial twin's chunking
    — chunk-boundary annotations like the write-phase end depend on
    it). ``round_offset`` is the fork frame of a what-if lane
    (``SweepPlan.fork_round``): the driver-frame timeline is identical
    to the serial ``run --fork`` repro's (fork tokens are round-0
    resume points), and the offset maps the scenario's fault window
    onto the twin's absolute clock in the ``fault_window`` annotation.
    ``projected=True`` marks a forecast lane's flight so no dashboard
    can mistake a projection for a measurement."""
    fl = FlightRecorder(capacity=capacity)
    meta = {
        "driver": "sweep_lane",
        "lane": int(result.index),
        "cell": result.cell,
        "nodes": int(lane.cfg.num_nodes),
        "chunk": int(chunk),
        "seed": int(result.seed),
    }
    if getattr(lane.schedule, "name", None):
        meta["scenario"] = lane.schedule.name
    if lane.workload is not None:
        meta["workload"] = lane.workload.spec
    if projected:
        meta["projected"] = True
        meta["fork_round"] = int(round_offset)
    fl.set_meta(**meta)
    rounds = int(result.rounds)
    if result.metrics:
        fl.record_rounds(1, result.metrics)

    # the serial driver's write-phase-end rule: annotated at base+1 of
    # the first non-writing chunk, when a writing chunk preceded it and
    # the run still executed that chunk
    wr = int(lane.schedule.write_rounds)
    if wr > 0:
        base = ((wr + chunk - 1) // chunk) * chunk
        if base < rounds:
            fl.annotate(
                base + 1, "schedule_transition", kind="write_phase_end",
            )

    # scheduled fault + workload events inside the executed window —
    # the same events_in() read the serial loop makes per chunk
    for ev_r, ev_name, ev_attrs in lane.schedule.events_in(0, rounds):
        fl.annotate(ev_r + 1, "fault_event", kind=ev_name, **ev_attrs)
    if lane.workload is not None:
        for ev_r, ev_name, ev_attrs in lane.workload.events_in(0, rounds):
            fl.annotate(ev_r + 1, "workload_event", kind=ev_name,
                        **ev_attrs)

    # round-less violations come from on_converged (the convergence-
    # honesty check) — the serial driver anchors those at the
    # convergence round, chunk violations at their round + 1
    conv_anchor = (
        int(result.converged_round)
        if result.converged_round is not None else rounds
    )
    for v in (result.invariants or {}).get("violations", []):
        r = v.get("round")
        fl.annotate(
            (r + 1) if r is not None else conv_anchor,
            "invariant_violation",
            invariant=v.get("invariant"), detail=v.get("detail"),
        )

    if result.poisoned and "log_wrapped" in (result.metrics or {}):
        lw = np.asarray(result.metrics["log_wrapped"])
        fl.annotate(1 + int(np.argmax(lw != 0)), "log_wrapped")
    if result.converged_round is not None:
        fl.annotate(int(result.converged_round), "converged")
    if result.resilience is not None:
        fl.annotate(rounds, "resilience",
                    **_scalar_attrs(result.resilience))

    # ---- lane-specific annotations (no serial counterpart) ----------
    reason = (
        "poisoned" if result.poisoned
        else "converged" if result.converged_round is not None
        else "budget"
    )
    fl.annotate(rounds, "lane_freeze", reason=reason,
                chunk=max(rounds // chunk - 1, 0) if chunk else 0)
    window = lane.scenario.fault_window() if lane.scenario else None
    if window is not None:
        # the fork frame shift, made visible: lane-relative window plus
        # its projection onto the twin's absolute state.round clock
        fl.annotate(
            window[0] + 1, "fault_window",
            first=int(window[0]), last=int(window[1]),
            first_absolute=int(window[0] + round_offset),
            last_absolute=int(window[1] + round_offset),
        )
    anchor = (
        int(result.converged_round)
        if result.converged_round is not None else rounds
    )
    for b in breaches:
        fl.annotate(anchor, "threshold_breach", cell=result.cell,
                    breach=b)
    return fl


def demux_flights(plan, result, *, breaches: list | tuple = (),
                  projected: bool = False) -> list:
    """Every lane's flight recorder off one
    :class:`~corro_sim_torch.sweep.engine.SweepResult` — the whole fleet's
    timelines from the ONE dispatch. ``breaches`` are
    :func:`~corro_sim_torch.sweep.frontier.check_frontier` strings; each lane
    gets the ones naming its cell."""
    from corro_sim_torch.sweep.frontier import breaches_by_cell

    by_cell = breaches_by_cell(breaches)
    chunk = int(getattr(result, "chunk", 16))
    out = []
    for lane, lr in zip(plan.lanes, result.lanes):
        cell_breaches = by_cell.get(lr.cell, [])
        out.append(lane_flight(
            lane, lr, chunk=chunk, round_offset=plan.fork_round,
            projected=projected or plan.fork is not None,
            breaches=cell_breaches,
        ))
    return out


def lane_flight_filename(cell: str, seed: int) -> str:
    """The per-lane export filename under ``--flight-dir`` — a pure
    function of (cell, seed), which is unique across a grid, so the CI
    gate can reconstruct a lane's path without listing the directory.
    Sanitization maps punctuation to ``-``; when it changed anything, a
    short hash of the RAW cell rides along so two cells differing only
    in stripped punctuation (``lossy:p=0.1`` vs cell ``lossy#p=0.1``)
    never collide on the same file."""
    safe = "".join(
        ch if ch.isalnum() or ch in "._-" else "-" for ch in cell
    )
    if safe != cell:
        import hashlib

        safe += "-" + hashlib.sha1(cell.encode()).hexdigest()[:6]
    return f"{safe}.seed{int(seed)}.ndjson"


def write_lane_flights(flights, directory: str) -> list:
    """Dump each lane flight as ND-JSON under ``directory`` (created if
    missing); returns the written paths. Files round-trip bit-identical
    through :meth:`FlightRecorder.ingest_ndjson` and load in
    ``corro-sim flight <path>``."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for fl in flights:
        meta = fl.meta
        path = os.path.join(
            directory,
            lane_flight_filename(meta.get("cell", "lane"),
                                 meta.get("seed", 0)),
        )
        fl.dump(path)
        paths.append(path)
    return paths


# ------------------------------------------------ the comparability oracle

# Annotations whose (round, attrs) are a pure function of the lane's
# simulated behavior. Everything else a serial flight carries — compile/
# chunk/pipeline walls, repair program switches, checkpoints, probe
# regressions — is host-process provenance and excluded by construction.
_COMPARABLE_EVENTS = frozenset({
    "fault_event", "workload_event", "schedule_transition", "converged",
    "log_wrapped", "invariant_violation", "resilience",
})
_COMPARABLE_DIAG = (
    "rounds_recorded", "first_round", "last_round", "converged_round",
    "gap_half_life_rounds", "epidemic_window_rounds", "peak_gap",
    "final_gap", "poisoned",
)
_COMPARABLE_META = ("nodes", "seed", "chunk", "scenario", "workload")


def comparable_timeline(flight: FlightRecorder, metrics=None) -> dict:
    """The serial-comparable view of a flight: meta identity fields,
    behavior-derived diagnostics, per-round metric series, and the
    deterministic annotations, canonically ordered. Two flights of the
    same simulated run — however they were produced — compare equal
    here; wall-clock phases and dispatch provenance never enter.

    ``metrics``: restrict the series to these names — the demuxed lane
    records the UNION program's metric families (a superset of its
    serial twin's), so comparisons pass the serial side's family set."""
    tl = flight.timeline()
    series: dict[str, list] = {}
    for rec in tl["rounds"]:
        for k, v in rec["m"].items():
            if metrics is None or k in metrics:
                series.setdefault(k, []).append((rec["r"], v))
    events = sorted(
        (
            {"r": e["r"], "name": e["name"], "attrs": e["attrs"]}
            for e in tl["events"] if e["name"] in _COMPARABLE_EVENTS
        ),
        key=lambda e: (
            e["r"], e["name"], json.dumps(e["attrs"], sort_keys=True),
        ),
    )
    diag = tl["diagnostics"]
    return {
        "meta": {
            k: tl["meta"][k] for k in _COMPARABLE_META
            if k in tl["meta"]
        },
        "diagnostics": {k: diag.get(k) for k in _COMPARABLE_DIAG},
        "series": series,
        "events": events,
    }


# ------------------------------------------------------------- heatmaps

# heatmap metric -> extractor over a LaneResult
_HEATMAP_METRICS = {
    "rounds_to_convergence": lambda lr: lr.converged_round,
    "recovery_rounds": lambda lr: lr.recovery_rounds,
    "rows_lost": lambda lr: (lr.resilience or {}).get("rows_lost"),
    "degradation_p99": lambda lr: (
        ((lr.resilience or {}).get("sub_delivery") or {})
        .get("degradation_p99")
    ),
}


def grid_heatmaps(lane_results) -> dict:
    """The grid heatmap artifact: one cell × seed matrix per metric
    (``rounds_to_convergence``, ``recovery_rounds``, ``rows_lost``,
    ``degradation_p99``) plus a lane-state matrix (converged / poisoned
    / unconverged). ``null`` marks a value the lane does not have (an
    unconverged lane has no convergence round). JSON-ready; render with
    :func:`render_heatmap`."""
    cells = sorted({lr.cell for lr in lane_results})
    seeds = sorted({int(lr.seed) for lr in lane_results})
    by_key = {(lr.cell, int(lr.seed)): lr for lr in lane_results}

    def grid(fn):
        return [
            [
                fn(by_key[(c, s)]) if (c, s) in by_key else None
                for s in seeds
            ]
            for c in cells
        ]

    def state(lr):
        if lr.poisoned:
            return "poisoned"
        return (
            "converged" if lr.converged_round is not None
            else "unconverged"
        )

    return {
        "rows": cells,
        "cols": seeds,
        "maps": {
            name: grid(fn) for name, fn in _HEATMAP_METRICS.items()
        },
        "state": grid(state),
    }


_SHADES = " .:-=+*#%@"


def render_heatmap(doc: dict, metric: str = "recovery_rounds") -> str:
    """ASCII rendering of one heatmap (rows = cells, cols = seeds):
    shade density scales to the metric's max, ``P`` marks a poisoned
    lane, ``!`` an unconverged one, ``.`` a missing value. The text
    summary that rides next to the JSON artifact in CI logs."""
    grid = doc["maps"][metric]
    state = doc["state"]
    flat = [v for row in grid for v in row if v is not None]
    peak = max(flat) if flat else 0
    width = max((len(c) for c in doc["rows"]), default=4)
    lines = [
        f"{metric} over cell x seed (max {peak}; "
        "P=poisoned !=unconverged)",
        " " * width + "  " + " ".join(
            f"{s:>2d}" for s in doc["cols"]
        ),
    ]
    for cell, row, srow in zip(doc["rows"], grid, state):
        marks = []
        for v, st in zip(row, srow):
            if st == "poisoned":
                marks.append(" P")
            elif st == "unconverged":
                marks.append(" !")
            elif v is None:
                marks.append(" .")
            else:
                shade = _SHADES[
                    min(int(v / peak * (len(_SHADES) - 1)), 9)
                ] if peak > 0 else _SHADES[0]
                marks.append(f" {shade}")
        lines.append(f"{cell:<{width}}  " + " ".join(marks))
    return "\n".join(lines) + "\n"


# ----------------------------------------------------- fleet occupancy

def fleet_occupancy(result) -> dict:
    """The occupancy story of one sweep: per-dispatch lane-state curve
    plus the waste totals. ``wasted_frozen_lane_rounds`` counts rounds
    the dispatch executed for slots holding no racing lane — under
    lockstep dispatch that is lanes that had ALREADY settled (their
    carries ride the freeze select untouched, the committed
    before-number for on-device lane freezing); under the compacted
    fleet scheduler it is only the residual pad/frozen slots the
    re-pack could not eliminate. Invariant: ``useful + wasted ==
    executed == Σ width × rounds`` per dispatch — each dispatch is
    judged against its OWN batch width (curve entries carry ``width``
    when the scheduler compacted; lockstep entries fall back to the
    full lane count), so a compacted run's occupancy honestly reflects
    the smaller programs it actually dispatched."""
    curve = [dict(e) for e in (getattr(result, "occupancy", None) or [])]
    lanes = len(result.lanes)
    executed = sum(e.get("width", lanes) * e["rounds"] for e in curve)
    useful = sum(e["lanes_active"] * e["rounds"] for e in curve)
    wasted = executed - useful
    return {
        "lanes": lanes,
        "dispatches": len(curve),
        "executed_lane_rounds": executed,
        "useful_lane_rounds": useful,
        "wasted_frozen_lane_rounds": wasted,
        "occupancy_ratio": (
            round(useful / executed, 4) if executed else None
        ),
        "curve": curve,
    }


# ------------------------------------------------- live sweep status

_STATUS_LOCK = threading.Lock()
_STATUS: dict | None = None


def publish_sweep_progress(snapshot: dict) -> None:
    """Install the running sweep's per-chunk snapshot (called by
    ``run_sweep`` between dispatches — JSON-safe values only)."""
    global _STATUS
    with _STATUS_LOCK:
        _STATUS = {"phase": "running", **snapshot}


def publish_sweep_result(summary: dict) -> None:
    """Install the finished sweep's summary (terminal snapshot)."""
    global _STATUS
    with _STATUS_LOCK:
        _STATUS = {"phase": "done", **summary}


def sweep_status() -> dict | None:
    """The last published sweep snapshot in this process (None when no
    sweep has run) — the ``GET /v1/sweep`` body."""
    with _STATUS_LOCK:
        return dict(_STATUS) if _STATUS is not None else None
