"""The resilience frontier: quantile-over-seeds grading of a chaos matrix.

Port of ``corro_sim/sweep/frontier.py``. The frontier aggregates every
sweep lane into per-cell (scenario spec × knob overrides) rows: worst
and p95 ``recovery_rounds`` across seeds, worst ``rows_lost``, worst
``degradation_p99``, SWIM churn extremes, and it names the worst seed
with the one serial command that reproduces it
(``SweepLane.repro_cmd``). :func:`check_frontier` grades the frontier
against the threshold golden (``faults/resilience_thresholds.json``):
``default`` merged under the scenario's base name, as
:func:`corro_sim_torch.faults.scorecard.check_thresholds` does.
"""

from __future__ import annotations

import numpy as np

__all__ = ["breaches_by_cell", "build_frontier", "check_frontier"]


def breaches_by_cell(breaches) -> dict:
    """Group :func:`check_frontier` breach strings by the cell tag each
    leads with. Every breach is formatted ``<cell>: <msg> (worst seed
    ...)`` and cell tags never contain spaces (scenario specs + knob
    suffixes), so the tag is everything before the first ``": "`` —
    a format contract the fleet observatory depends on to pin
    ``threshold_breach`` annotations onto the right lane flights
    (corro_sim_torch/obs/lanes.py demux_flights)."""
    out: dict[str, list] = {}
    for b in breaches:
        out.setdefault(b.split(": ", 1)[0], []).append(b)
    return out


def _p95(values: list) -> float | None:
    return float(np.percentile(np.asarray(values, float), 95)) \
        if values else None


def build_frontier(lane_results: list, projected: bool = False) -> dict:
    """Aggregate :class:`~corro_sim_torch.sweep.engine.LaneResult`s into the
    frontier artifact: one cell per (scenario spec × knob overrides),
    statistics across that cell's seeds.

    ``projected=True`` marks a what-if FORECAST frontier (lanes
    warm-started from a fork token): the
    numbers are projections of faults the real cluster has NOT taken,
    and the artifact says so — a dashboard must never present a
    forecast as a measurement."""
    cells: dict[str, list] = {}
    for lane in lane_results:
        cells.setdefault(lane.cell, []).append(lane)
    out = []
    for cell, members in cells.items():
        recoveries = [
            lr.recovery_rounds for lr in members
            if lr.recovery_rounds is not None
        ]
        unconverged = sorted(
            lr.seed for lr in members if lr.converged_round is None
        )
        rows_lost = [
            (lr.resilience or {}).get("rows_lost") for lr in members
        ]
        rows_lost = [v for v in rows_lost if v is not None]
        resyncs = [
            (lr.resilience or {}).get("resync_rows", 0) for lr in members
        ]
        false_down = [
            (lr.resilience or {}).get("swim_false_down", 0)
            for lr in members
        ]
        degradations = []
        for lr in members:
            sub = (lr.resilience or {}).get("sub_delivery") or {}
            d = sub.get("degradation_p99")
            if d is not None:
                degradations.append(float(d))

        # the arg-max "worst seed": an unconverged lane beats any
        # converged recovery time; ties break to the larger recovery
        def badness(lr):
            return (
                lr.converged_round is None or lr.poisoned,
                lr.recovery_rounds
                if lr.recovery_rounds is not None else -1,
                (lr.resilience or {}).get("rows_lost") or 0,
            )

        worst = max(members, key=badness)
        out.append({
            "cell": cell,
            "scenario": members[0].spec,
            "lanes": len(members),
            "seeds": sorted(lr.seed for lr in members),
            "converged": len(members) - len(unconverged),
            "unconverged_seeds": unconverged,
            "poisoned_seeds": sorted(
                lr.seed for lr in members if lr.poisoned
            ),
            "recovery_rounds": {
                "worst": max(recoveries) if recoveries else None,
                "p95": _p95(recoveries),
                "mean": (
                    float(np.mean(recoveries)) if recoveries else None
                ),
            },
            "rows_lost_worst": max(rows_lost) if rows_lost else None,
            "resync_rows_min": min(resyncs) if resyncs else 0,
            "swim_false_down_worst": (
                max(false_down) if false_down else 0
            ),
            "degradation_p99_worst": (
                max(degradations) if degradations else None
            ),
            "worst_seed": worst.seed,
            "worst_repro": worst.repro_cmd,
            "invariants_ok": all(
                (lr.invariants or {}).get("ok", True) for lr in members
            ),
        })
    doc = {"cells": sorted(out, key=lambda c: c["cell"])}
    if projected:
        doc["projected"] = True
    return doc


def check_frontier(frontier: dict, thresholds: dict,
                   section: str | None = None) -> list[str]:
    """Grade the frontier against the committed threshold golden —
    quantile-over-seeds semantics. Per cell, the ``default`` table
    merges under the scenario's base-name entry (the
    ``check_thresholds`` rule); ``recovery_rounds_worst_max`` falls
    back to the serial ``recovery_rounds_max`` bound so a scenario
    graded before the sweep era keeps its tripwire. Every breach names
    the worst seed's one-command repro.

    ``section``: grade against a sub-table of the golden instead of its
    top level — the twin's what-if forecasts use ``"twin_forecast"``
    (projected bounds live apart from measured ones; an absent section
    gates nothing, exit-6 semantics unchanged where it exists)."""
    if section is not None:
        thresholds = thresholds.get(section) or {}
    breaches: list[str] = []
    for cell in frontier.get("cells", []):
        base = (cell["scenario"] or "").split(":", 1)[0]
        merged = dict(thresholds.get("default", {}))
        merged.update(thresholds.get("scenarios", {}).get(base, {}))
        tag = cell["cell"]

        def breach(msg):
            breaches.append(
                f"{tag}: {msg} (worst seed {cell['worst_seed']}; "
                f"repro: {cell['worst_repro']})"
            )

        if merged.get("require_converged") and cell["unconverged_seeds"]:
            breach(
                f"seeds {cell['unconverged_seeds']} did not re-converge"
            )
        if cell["poisoned_seeds"]:
            breach(f"seeds {cell['poisoned_seeds']} poisoned")
        rec = cell["recovery_rounds"]
        worst_max = merged.get(
            "recovery_rounds_worst_max", merged.get("recovery_rounds_max")
        )
        if (
            worst_max is not None and rec["worst"] is not None
            and rec["worst"] > worst_max
        ):
            breach(
                f"recovery_rounds worst {rec['worst']} > {worst_max}"
            )
        p95_max = merged.get("recovery_rounds_p95_max")
        if (
            p95_max is not None and rec["p95"] is not None
            and rec["p95"] > p95_max
        ):
            breach(f"recovery_rounds p95 {rec['p95']:.1f} > {p95_max}")
        if (
            merged.get("rows_lost_max") is not None
            and cell["rows_lost_worst"] is not None
            and cell["rows_lost_worst"] > merged["rows_lost_max"]
        ):
            breach(
                f"rows_lost worst {cell['rows_lost_worst']} > "
                f"{merged['rows_lost_max']}"
            )
        if (
            merged.get("resync_rows_min") is not None
            and cell["resync_rows_min"] < merged["resync_rows_min"]
        ):
            breach(
                f"resync_rows min {cell['resync_rows_min']} < "
                f"{merged['resync_rows_min']} (the stale-rejoin "
                "repayment evidence is missing)"
            )
        if (
            merged.get("swim_false_down_max") is not None
            and cell["swim_false_down_worst"]
            > merged["swim_false_down_max"]
        ):
            breach(
                f"swim_false_down worst {cell['swim_false_down_worst']}"
                f" > {merged['swim_false_down_max']}"
            )
    return breaches
