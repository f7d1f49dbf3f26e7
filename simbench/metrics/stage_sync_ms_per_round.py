"""Device milliseconds per simulated round of the work launched inside
the program's ``corro.step.sync`` ranges: on a sweep round the pair
mask, the anti-entropy sweep (``sync_round``) and the probe sync marks,
and on the other rounds the sweep's zero metrics. The step opens the
range itself (``engine/step.py``); the harness's own range around
``sync_round`` (``sync_ms_per_round``) lies inside it, and its launches
are added back."""

from simbench import spans

UNIT = "ms/round"
LAYER = "step (engine/step.py::sim_step)"
MOVES = "round_ms"
SOURCE = "device_trace"
RANGES = spans.program_ranges("corro.step.sync")
INNER = ("simbench.sync_round",)


def read(run):
    return spans.stage_ms(run, "corro.step.sync", INNER)
