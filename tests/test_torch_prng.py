"""Parity: corro_sim_torch.prng reproduces jax.random bit for bit.

Every key derivation and every (sampler, shape, range) the ported main
path draws is compared with jax.random on the same key data. Tolerance:
exact equality (integer key words, integer draws, float32 bit patterns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corro_sim.engine.driver import chunk_keys as ref_chunk_keys
from corro_sim.engine.driver import round_key as ref_round_key
from corro_sim_torch import prng
from corro_sim_torch.engine.driver import chunk_keys, round_key


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 - 1])
def test_prng_key(seed):
    rk, pk = _keys(seed)
    np.testing.assert_array_equal(np.asarray(rk), pk)


@pytest.mark.parametrize("op", [
    ("split", 2), ("split", 3), ("split", 9), ("split", 16),
    ("fold_in", 0), ("fold_in", 7), ("fold_in", 2**31 + 5),
    ("chunk_keys", (0, 16)), ("chunk_keys", (5, 8)), ("round_key", 41),
])
def test_key_derivation(op):
    name, arg = op
    rk, pk = _keys(7)
    if name == "split":
        want, got = jax.random.split(rk, arg), prng.split(pk, arg)
    elif name == "fold_in":
        want = jax.random.fold_in(rk, np.uint32(arg))
        got = prng.fold_in(pk, arg)
    elif name == "chunk_keys":
        want, got = ref_chunk_keys(rk, *arg), chunk_keys(pk, *arg)
    else:
        want, got = ref_round_key(rk, arg), round_key(pk, arg)
    np.testing.assert_array_equal(np.asarray(want), got)


@pytest.mark.parametrize("shape", [(), (1,), (32,), (64,), (10000,)])
def test_uniform(shape):
    rk, pk = _keys(11)
    want = np.asarray(jax.random.uniform(rk, shape))
    got = prng.uniform(pk, shape, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("shape,lo,hi", [
    ((32, 1), 0, 4),  # write column
    ((64, 1), 0, 1),  # single-column table
    ((32, 1), 0, 1 << 20),  # written value
    ((32, 8, 2), 0, 32),  # broadcast targets
    ((64, 16, 3), 0, 64),
    ((1000, 10), 0, 1000),  # sync candidates
    ((96,), 0, 1 << 30),  # server admission priority
    ((), 0, 64),  # hot-window phase
    ((), 0, 10000),
    ((50,), -5, 3),
])
def test_randint(shape, lo, hi):
    rk, pk = _keys(5)
    want = np.asarray(jax.random.randint(rk, shape, lo, hi, dtype=jnp.int32))
    got = prng.randint(pk, shape, lo, hi, "cpu").numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("a,k", [(64, 64), (64, 16), (32, 16), (10000, 64),
                                 (1024, 64), (1, 1)])
def test_choice_without_replacement(a, k):
    rk, pk = _keys(9)
    want = np.asarray(jax.random.choice(rk, a, (k,), replace=False))
    got = prng.choice(pk, a, (k,), device="cpu").numpy()
    np.testing.assert_array_equal(want, got)
    assert len(set(got.tolist())) == k


@pytest.mark.parametrize("n", [5, 64, 10000])
def test_permutation(n):
    rk, pk = _keys(2)
    want = np.asarray(jax.random.permutation(rk, n))
    np.testing.assert_array_equal(want, prng.permutation(pk, n, "cpu").numpy())


def test_choice_with_replacement_refused():
    with pytest.raises(NotImplementedError):
        prng.choice(prng.PRNGKey(0), 8, (2,), replace=True, device="cpu")
