"""Device milliseconds per simulated round of the work launched inside
the program's ``corro.step.delivery`` ranges: the fused delivery merge
(``delivery_pass``) and the RTT samples and ring recomputation. The
step opens the range itself (``engine/step.py``); the harness's own
range around ``delivery_pass`` (``delivery_ms_per_round``) lies inside
it, and its launches are added back."""

from simbench import spans

UNIT = "ms/round"
LAYER = "step (engine/step.py::sim_step)"
MOVES = "round_ms"
SOURCE = "device_trace"
RANGES = spans.program_ranges("corro.step.delivery")
INNER = ("simbench.delivery_pass",)


def read(run):
    return spans.stage_ms(run, "corro.step.delivery", INNER)
