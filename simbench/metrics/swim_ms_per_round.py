"""Device milliseconds per simulated round of the work the SWIM
membership block launches (its tick rounds and its skipped rounds): the
kernels, copies and fills launched inside a host range around
``engine.step._swim_block``. Only configurations that run SWIM launch
any."""

UNIT = "ms/round"
LAYER = "membership (membership/swim.py)"
MOVES = "round_ms"
SOURCE = "device_trace"
RANGES = {"simbench.swim_block": ("corro_sim_torch.engine.step",
                                  "_swim_block")}


def read(run):
    if not run.trace or not run.traced_rounds:
        return None
    us = run.trace["range_us"]["simbench.swim_block"]
    return us / 1000.0 / run.traced_rounds if us > 0 else None
