"""Window wall over every simulated round the window completed. The
window holds each cluster's ``init_state`` and everything between
``run_sim`` calls; it leaves out only the judge's copies of the
sampled clusters' outputs, made while the card is idle."""

UNIT = "ms"


def read(win):
    if not win.rounds:
        return None
    return 1000.0 * win.wall_s / win.rounds
