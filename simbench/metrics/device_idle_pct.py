"""Share of the traced window in which the card ran no kernel, copy or
fill: the time the host keeps the device waiting."""

UNIT = "%"
LAYER = "device (H100)"
MOVES = "round_ms"
SOURCE = "device_trace"


def read(run):
    if not run.trace or run.trace["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_us"] / run.trace["window_us"])
