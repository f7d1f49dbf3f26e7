"""Host milliseconds spent inside the CUDA launch calls per simulated
round in the traced window (``obs/profile.py``'s ``dispatch_ms``
arithmetic)."""

UNIT = "ms/round"
LAYER = "step (engine/step.py::sim_step)"
MOVES = "round_ms"
SOURCE = "device_trace"


def read(run):
    if not run.trace or not run.traced_rounds:
        return None
    return run.trace["dispatch_us"] / 1000.0 / run.traced_rounds
