"""Device milliseconds per simulated round of the work gossip delivery
launches: the kernels, copies and fills launched inside a host range
around ``engine.step.delivery_pass``."""

UNIT = "ms/round"
LAYER = "delivery (core/delivery.py::delivery_pass)"
MOVES = "round_ms"
SOURCE = "device_trace"
RANGES = {"simbench.delivery_pass": ("corro_sim_torch.engine.step",
                                     "delivery_pass")}


def read(run):
    if not run.trace or not run.traced_rounds:
        return None
    return (run.trace["range_us"]["simbench.delivery_pass"] / 1000.0
            / run.traced_rounds)
