"""Device milliseconds per simulated round of the work launched inside
the program's ``corro.step.swim`` ranges: the SWIM block on its tick
rounds and the standing beliefs' metrics between them. The step opens
the range itself (``engine/step.py``); the harness's own range around
``_swim_block`` (``swim_ms_per_round``) lies inside it, and its launches
are added back."""

from simbench import spans

UNIT = "ms/round"
LAYER = "step (engine/step.py::sim_step)"
MOVES = "round_ms"
SOURCE = "device_trace"
RANGES = spans.program_ranges("corro.step.swim")
INNER = ("simbench.swim_block",)


def read(run):
    return spans.stage_ms(run, "corro.step.swim", INNER)
