"""CL102 fixture: one key consumed by two draws (fires once)."""
from corro_sim_torch import prng


def draw(seed, device):
    key = prng.PRNGKey(seed)
    a = prng.uniform(key, (4,), device)
    b = prng.uniform(key, (4,), device)  # BAD: the same stream again
    return a, b
