"""``jax.random`` as the simulator's main path uses it, bit for bit.

The JAX package draws every random number from threefry2x32 keys under
``jax_threefry_partitionable=True``. The port reproduces those draws
exactly, so a seeded PyTorch run walks the same trajectory as the JAX
run with the same seed:

- a key is its raw data, a numpy ``uint32`` array of shape ``(2,)``
  (``(num, 2)`` for a batch of keys), passed explicitly — there is no
  global generator state;
- key derivation (:func:`split`, :func:`fold_in`) depends only on the
  seed, the chunk index and the round, so it runs on the host in numpy
  and never waits for the device;
- bulk draws (:func:`random_bits` and the samplers built on it) run on
  the device of the caller's choosing, as elementwise int64 tensor ops.

Torch has no uint32 shifts or compares on the CPU, so 32-bit words ride
int64 carriers and are masked back to 32 bits after every add and shift.
The algorithms follow ``jax/_src/prng.py`` (``threefry2x32``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``)
and ``jax/_src/random.py`` (``_uniform``, ``_randint``, ``_shuffle``,
``choice``) of jax 0.9.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_UINT32_MAX = 4294967295


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counter words ``(x0, x1)`` under key
    ``(k0, k1)``. Works on python ints, numpy int64 arrays and torch
    int64 tensors alike (every word in ``[0, 2**32)``)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _words(key) -> tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key is uint32 data of shape (2,), got {k.shape}")
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    seed = int(seed)
    return np.array([0, seed & M32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys; key ``i`` is the
    hash of the counter ``(0, i)``."""
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(
        k0, k1, np.zeros(num, np.int64), np.arange(num, dtype=np.int64)
    )
    return np.stack([y0, y1], axis=1).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of ``(0, data)``."""
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, 0, int(data) & M32)
    return np.array([y0, y1], dtype=np.uint32)


def random_bits(key, shape, device, offset: int = 0) -> torch.Tensor:
    """32 random bits per element (row-major counters), as int64 values
    in ``[0, 2**32)``. ``offset``: the counter of the first element, so
    that rows ``[r, r + k)`` of a larger draw whose rows hold ``m``
    elements are ``random_bits(key, (k, m), device, r * m)``."""
    shape = tuple(int(d) for d in shape)
    k0, k1 = _words(key)
    lo = torch.arange(offset, offset + math.prod(shape), dtype=torch.int64,
                      device=device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0, offset: int = 0) -> torch.Tensor:
    """float32 ``jax.random.uniform``: 23 random mantissa bits under
    exponent 0, minus one, scaled. ``offset`` as in
    :func:`random_bits`."""
    bits = random_bits(key, shape, device, offset)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """int32 ``jax.random.randint`` in ``[minval, maxval)``: two 32-bit
    draws combined modulo the span, with uint32 wrap-around emulated."""
    minval, maxval = int(minval), int(maxval)
    if not (-(2 ** 31) <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint takes int32 bounds")
    k = split(key)
    hi = random_bits(k[0], shape, device)
    lo = random_bits(k[1], shape, device)
    span = (maxval - minval) & M32 if maxval > minval else 1
    if span > 2 ** 31:
        raise ValueError("randint spans above 2**31 are not supported")
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (((hi % span) * mult) & M32) + (lo % span)
    off = (off & M32) % span
    return (off + minval).to(torch.int32)


def permutation(key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: jax's sort-based shuffle of
    ``arange(n)`` (int32) — one stable sort on fresh 32-bit keys per
    round, with the round count jax derives from ``n``."""
    x = torch.arange(n, dtype=torch.int32, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))
    key = np.asarray(key, np.uint32)
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = random_bits(sub, (n,), device)
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def choice(key, a: int, shape, replace: bool = False,
           device=None) -> torch.Tensor:
    """``jax.random.choice(key, a, shape, replace=False)`` for an integer
    population: the head of :func:`permutation`."""
    if replace:
        raise NotImplementedError("only choice(replace=False) is ported")
    shape = tuple(int(d) for d in shape)
    n_draws = math.prod(shape)
    if n_draws > a:
        raise ValueError("cannot draw more than the population without "
                         "replacement")
    return permutation(key, a, device)[:n_draws].reshape(shape)
