"""Parity of rank translation (corro_sim_torch.utils.ranks) with the JAX
package's ``corro_sim/utils/ranks.py`` on the CPU.

The numpy path, the torch path and the JAX package's numpy and jitted
paths give the same array for the same values and tables: with values
missing from ``old``, negative values (the NEG fill and -1), and in
each carrier dtype (int16, int32, int64). Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.utils import ranks as r_ranks
from corro_sim_torch.utils import ranks as p_ranks

NEG = -(2 ** 31)


def _case(rng, dtype, n_old=40, span=300, shape=(7, 5, 3)):
    """An ascending old-rank table, a permutation-free new table (a
    re-sorted universe's ranks) and values that mix members of ``old``,
    non-members and negatives."""
    info = np.iinfo(dtype)
    hi = min(span, int(info.max))
    old = np.sort(rng.choice(hi, size=n_old, replace=False)).astype(np.int64)
    new = rng.choice(hi, size=n_old, replace=False).astype(np.int64)
    vals = rng.integers(-3, hi, size=shape).astype(dtype)
    flat = vals.reshape(-1)
    flat[::4] = old[rng.integers(0, n_old, size=flat[::4].size)]
    flat[1::9] = -1
    if dtype != np.int16:
        flat[2::11] = NEG
    return vals, old, new


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.int64])
@pytest.mark.parametrize("seed", [0, 1])
def test_translate_ranks_paths_agree(dtype, seed):
    rng = np.random.default_rng(seed)
    vals, old, new = _case(rng, dtype)
    want = r_ranks.translate_ranks(vals, old, new)
    want_jit = np.asarray(r_ranks.translate_ranks(
        jnp.asarray(vals), old, new, xp=jnp))
    got_np = p_ranks.translate_ranks(vals, old, new)
    got_t = p_ranks.translate_ranks(torch.as_tensor(vals), old, new)
    assert got_np.dtype == want.dtype and got_t.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    if dtype != np.int64:  # jax without x64 carries int64 as int32
        np.testing.assert_array_equal(want_jit, want)
    # members move, non-members and negatives pass through
    member = np.isin(vals, old) & (vals >= 0)
    assert (got_np[~member] == vals[~member]).all()
    assert member.any() and (~member).any() and (vals < 0).any()


def test_translate_ranks_edges():
    vals = np.array([5, 9, -1, 0, 12], np.int32)
    for old, new in (([], []), ([9], [3]), ([0, 5, 9, 12], [12, 9, 5, 0])):
        want = r_ranks.translate_ranks(vals, old, new)
        got = p_ranks.translate_ranks(torch.as_tensor(vals), old, new)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            p_ranks.translate_ranks(vals, old, new), want)
    # an empty table hands the very object back
    t = torch.as_tensor(vals)
    assert p_ranks.translate_ranks(t, [], []) is t
    assert p_ranks.rank_map([1, 2], [2, 1]) == r_ranks.rank_map([1, 2],
                                                                [2, 1])
