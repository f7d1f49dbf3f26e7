"""Device milliseconds per simulated round of the work launched inside
the program's ``corro.step.gossip`` ranges: the eager ring-0 messages,
gossip dissemination (the broadcast targets' draws), the in-flight
latency ring, link faults and the probe origins before delivery, and the
rebroadcast and enqueue after it (two ranges a round, summed). The step
opens the ranges itself (``engine/step.py``)."""

from simbench import spans

UNIT = "ms/round"
LAYER = "step (engine/step.py::sim_step)"
MOVES = "round_ms"
SOURCE = "device_trace"
RANGES = spans.program_ranges("corro.step.gossip")


def read(run):
    return spans.stage_ms(run, "corro.step.gossip")
