"""Mean wall of the clusters that converged in the window, each from
its ``init_state`` to ``run_sim``'s return: how long until the answer.
Where the window's first cluster answers only after the window, its
wall stands alone."""

UNIT = "s"


def read(win):
    done = [c for c in win.clusters if c["converged_round"] is not None]
    inside = [c for c in done if not c.get("late")]
    walls = [c["wall_s"] for c in (inside or done)]
    if not walls:
        return None
    return sum(walls) / len(walls)
