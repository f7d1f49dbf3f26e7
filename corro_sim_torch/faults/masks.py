"""The blackhole wildcard-pair semantics, in one place.

Port of ``corro_sim/faults/masks.py`` (host numpy). ``FaultConfig.
blackhole`` is a tuple of directed ``(src, dst)`` pairs with ``-1`` as a
wildcard; the transport point and the sync grant
(:mod:`corro_sim_torch.faults.inject`) expand it the same way.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pairs_to_mask"]


def pairs_to_mask(pairs, n: int) -> np.ndarray:
    """(N, N) bool: True where src→dst is blackholed.

    ``(s, d)`` drops that directed edge; ``(s, -1)`` drops everything s
    sends (one-way blackhole: it still receives); ``(-1, d)`` drops
    everything d receives. A ``(-1, -1)`` wildcard is ignored — it would
    drop every edge. Vectorized: topology scenarios carry O(N^2) pairs.
    """
    m = np.zeros((n, n), bool)
    if not len(pairs):
        return m
    arr = np.asarray(pairs, dtype=np.int64)
    s, d = arr[:, 0], arr[:, 1]
    exact = (s >= 0) & (d >= 0)
    m[s[exact], d[exact]] = True
    m[s[(s >= 0) & (d < 0)], :] = True
    m[:, d[(s < 0) & (d >= 0)]] = True
    return m
