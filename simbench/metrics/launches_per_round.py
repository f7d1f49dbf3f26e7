"""Kernels launched per simulated round in the traced window. The step
is eager, so each launch costs the host its dispatch; the count is the
step's launch overhead, whatever the kernels do."""

UNIT = "launches/round"
LAYER = "step (engine/step.py::sim_step)"
MOVES = "round_ms"
SOURCE = "device_trace"


def read(run):
    if not run.trace or not run.traced_rounds:
        return None
    return run.trace["kernels"] / run.traced_rounds
