"""Chaos engine: fault injection, named failure scenarios, invariant
checks and the resilience scorecard.

Port of ``corro_sim/faults/``:

- :mod:`inject` — link faults at the two transport points of
  ``engine/step.py`` (broadcast delivery and the anti-entropy grant):
  seeded Bernoulli loss and duplication, Gilbert burst loss, blackholes;
- :mod:`nodes` — node-lifecycle faults: crash-restart with amnesia,
  stale rejoin from a snapshot leaf, HLC clock skew, stragglers;
- :mod:`scenarios` — the named, seeded failure catalog, compiled into
  ``Schedule`` arrays and fault-config overrides from ``name[:k=v,...]``
  specs;
- :mod:`invariants` — the per-chunk assertions that must hold under any
  fault mix;
- :mod:`scorecard` — the resilience scorecard graded against the
  threshold golden.
"""

from corro_sim_torch.faults.invariants import (
    InvariantChecker,
    InvariantViolation,
    merge_reports,
)
from corro_sim_torch.faults.scenarios import (
    SCENARIOS,
    Scenario,
    make_scenario,
    parse_scenario_spec,
)
from corro_sim_torch.faults.scorecard import (
    ResilienceScorecard,
    check_thresholds,
    fifo_delivery_quantiles,
    load_thresholds,
)

__all__ = [
    "SCENARIOS",
    "Scenario",
    "InvariantChecker",
    "InvariantViolation",
    "ResilienceScorecard",
    "check_thresholds",
    "fifo_delivery_quantiles",
    "load_thresholds",
    "make_scenario",
    "merge_reports",
    "parse_scenario_spec",
]
