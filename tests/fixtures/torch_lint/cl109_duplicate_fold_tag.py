"""CL109 fixture: one tag folded onto one key at two sites (fires once)."""
from corro_sim_torch import prng

GOSSIP_TAG = 7


def streams(key):
    a = prng.fold_in(key, GOSSIP_TAG)
    b = prng.fold_in(key, 7)  # BAD: the same child stream as `a`
    return a, b
