"""Host reads of the sweep gate's device predicate per simulated round:
``RunResult.pipeline["host_reads"]``'s counter (``engine/step.py``'s
``SWEEP_GATES``, read on and read off), over every round the window
completed. A read waits for the card's queue, so fewer reads let the
host run further ahead."""

UNIT = "reads/round"
LAYER = "driver (engine/driver.py::run_sim)"
MOVES = "round_ms"
SOURCE = "program_counter"


def read(run):
    if not run.window_rounds:
        return None
    return run.counters["host_reads"] / run.window_rounds
