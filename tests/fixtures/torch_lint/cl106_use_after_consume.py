"""CL106 fixture: a state read after sim_step consumed it (fires once)."""
from corro_sim_torch.engine.step import sim_step


def one_round(cfg, state, key, alive, part):
    new_state, metrics = sim_step(cfg, state, key, alive, part, True, 0)
    stale = state.round  # BAD: the step may have merged it in place
    return new_state, metrics, stale
