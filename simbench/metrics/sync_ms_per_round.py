"""Device milliseconds per simulated round of the work the anti-entropy
sync sweep launches: the kernels, copies and fills launched inside a
host range around ``engine.step.sync_round``, the point where the step
calls the sweep (no synchronize is added)."""

UNIT = "ms/round"
LAYER = "sync sweep (sync/sync.py::sync_round)"
MOVES = "round_ms"
SOURCE = "device_trace"
RANGES = {"simbench.sync_round": ("corro_sim_torch.engine.step",
                                  "sync_round")}


def read(run):
    if not run.trace or not run.traced_rounds:
        return None
    return (run.trace["range_us"]["simbench.sync_round"] / 1000.0
            / run.traced_rounds)
