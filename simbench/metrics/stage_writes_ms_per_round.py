"""Device milliseconds per simulated round of the work launched inside
the program's ``corro.step.writes`` ranges: the round's key split, the
node-fault prologue, local writes (the sampler's draws), the changelog
append, self-bookkeeping, the lag signals and the sweep gate's copy, and
the ownership fold through the cleared stamps. The step opens the range
itself (``engine/step.py``; the repair step's prologue carries the same
name), so the reading does not depend on the names of the functions
inside it."""

from simbench import spans

UNIT = "ms/round"
LAYER = "step (engine/step.py::sim_step)"
MOVES = "round_ms"
SOURCE = "device_trace"
RANGES = spans.program_ranges("corro.step.writes")


def read(run):
    return spans.stage_ms(run, "corro.step.writes")
