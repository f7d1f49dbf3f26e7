"""The fleet sweep: a scenario × seed × knob grid raced as lanes.

Port of ``corro_sim/sweep/``: :mod:`knobs` (the ``sweep_knobs`` leaf),
:mod:`plan` (the grid grammar, all-errors-at-once validation and the
union config), :mod:`engine` (``run_sweep``: lockstep, and the compact
fleet scheduler) and :mod:`frontier` (worst and p95 over seeds, with
each cell's worst-seed repro command). Every lane is bit-identical to
its serial ``run_sim`` twin.
"""

# engine/state.py imports the knob module (leaf registration) and so
# this package: the other modules load lazily, as in the JAX package
from corro_sim_torch.sweep.knobs import (  # noqa: F401
    SIM_KNOB_FIELDS,
    SWEEP_KNOB_FIELDS,
    lane_knobs,
    neutral_knobs,
)

__all__ = [
    "SIM_KNOB_FIELDS",
    "SWEEP_KNOB_FIELDS",
    "LaneResult",
    "SweepLane",
    "SweepPlan",
    "SweepResult",
    "build_frontier",
    "build_plan",
    "check_frontier",
    "lane_knobs",
    "neutral_knobs",
    "parse_grid",
    "run_sweep",
]

_LAZY = {
    "LaneResult": "corro_sim_torch.sweep.engine",
    "SweepResult": "corro_sim_torch.sweep.engine",
    "run_sweep": "corro_sim_torch.sweep.engine",
    "build_frontier": "corro_sim_torch.sweep.frontier",
    "check_frontier": "corro_sim_torch.sweep.frontier",
    "SweepLane": "corro_sim_torch.sweep.plan",
    "SweepPlan": "corro_sim_torch.sweep.plan",
    "build_plan": "corro_sim_torch.sweep.plan",
    "parse_grid": "corro_sim_torch.sweep.plan",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)
