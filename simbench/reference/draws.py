"""The write draws of a seeded cluster, worked out again in numpy.

A cluster's writes are the program's only input besides its
configuration and schedule. The program draws them on the card from
threefry2x32 keys (the counter-based generator of Salmon et al., SC'11,
in the key-derivation and float conventions of ``jax.random``). This
module reproduces those draws from the published algorithm alone, so
that the judge knows which writes a run had to carry without reading
them from the run.

Keys are ``(2,)`` uint32 arrays. Round ``r`` of a run keyed by ``seed``
and stepped in chunks of ``chunk`` rounds uses
``split(fold_in(PRNGKey(seed), r // chunk), chunk)[r % chunk]``, and
splits that key into the step's nine streams, of which the first four
are the write coin, the row, the column and the value.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
STREAMS = 9  # write, row, col, val, del, ncell, bcast, swim, sync
WRITE, ROW, COL, VAL = range(4)


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64."""
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


def _words(key) -> tuple:
    k = np.asarray(key, dtype=np.uint32)
    return int(k[0]), int(k[1])


def root_key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & M32], dtype=np.uint32)


def split(key, num: int) -> np.ndarray:
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, np.zeros(num, np.int64),
                          np.arange(num, dtype=np.int64))
    return np.stack([y0, y1], axis=1).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    k0, k1 = _words(key)
    y0, y1 = threefry2x32(k0, k1, np.zeros(1, np.int64),
                          np.full(1, int(data) & M32, np.int64))
    return np.array([y0[0], y1[0]], dtype=np.uint32)


def bits(key, count: int) -> np.ndarray:
    """32 random bits for each of ``count`` counters, as int64."""
    k0, k1 = _words(key)
    lo = np.arange(count, dtype=np.int64)
    b0, b1 = threefry2x32(k0, k1, np.zeros_like(lo), lo)
    return b0 ^ b1


def uniform(key, count: int) -> np.ndarray:
    """float32 in [0, 1): 23 mantissa bits under exponent 0, minus one."""
    fb = ((bits(key, count) >> 9) | 0x3F800000).astype(np.uint32)
    return fb.view(np.float32) - np.float32(1.0)


def randint(key, count: int, lo: int, hi: int) -> np.ndarray:
    """int32 in [lo, hi): two 32-bit draws combined modulo the span."""
    k = split(key, 2)
    hi_b = bits(k[0], count)
    lo_b = bits(k[1], count)
    span = hi - lo
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (((hi_b % span) * mult) & M32) + (lo_b % span)
    off = (off & M32) % span
    return (off + lo).astype(np.int32)


def round_streams(seed: int, rounds: int, chunk: int) -> list:
    """The nine stream keys of each of the first ``rounds`` rounds."""
    root = root_key(seed)
    out = []
    for ci in range(-(-rounds // chunk)):
        for key in split(fold_in(root, ci), chunk):
            out.append(split(key, STREAMS))
    return out[:rounds]


def row_cdf(num_rows: int, zipf_alpha: float) -> np.ndarray:
    """The float32 cumulative Zipf(``zipf_alpha``) distribution over rows,
    summed in float64."""
    if zipf_alpha <= 0.0:
        w = np.ones(num_rows, np.float64)
    else:
        w = 1.0 / np.power(np.arange(1, num_rows + 1, dtype=np.float64),
                           zipf_alpha)
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    return cdf.astype(np.float32)


def draw_writes(sim: dict, seed: int, alive: np.ndarray, write_rounds: int,
                chunk: int, precision: str = "float32") -> dict:
    """Every write of a cluster, in the order each writer made them.

    ``sim``: the configuration's simulator fields; ``alive``: ``(R, N)``
    bool, the schedule's liveness per round (a node that is down does not
    write); ``write_rounds``: the rounds in which writes are drawn.
    ``precision``: the precision of the write coin's compare, the one
    float stage of the draws; ``"bfloat16"`` rounds both sides of it, as
    a cheaper draw would.

    Returns ``{"round", "node", "row", "col", "val"}``, int arrays of one
    entry per write, sorted by ``(round, node)``."""
    n = int(sim["num_nodes"])
    rate = np.float32(sim["write_rate"])
    cdf = row_cdf(int(sim["num_rows"]), float(sim["zipf_alpha"]))
    if int(sim.get("seqs_per_version", 1)) != 1:
        raise ValueError("the reference draws one cell per write")
    if float(sim.get("delete_rate", 0.0)) != 0.0:
        raise ValueError("the reference draws no deletes")
    universe = int(sim.get("value_universe", 1 << 20))
    cols = int(sim["num_cols"])
    out = {k: [] for k in ("round", "node", "row", "col", "val")}
    for r, ks in enumerate(round_streams(seed, write_rounds, chunk)):
        u = uniform(ks[WRITE], n)
        if precision == "float32":
            coin = u < rate
        elif precision == "bfloat16":
            coin = _bf16(u) < _bf16(np.array([rate]))[0]
        else:
            raise ValueError(f"no such precision: {precision}")
        who = np.nonzero(coin & alive[min(r, len(alive) - 1)])[0]
        if who.size == 0:
            continue
        row = np.searchsorted(cdf, uniform(ks[ROW], n), side="left")
        row = np.clip(row, 0, len(cdf) - 1).astype(np.int32)
        col = randint(ks[COL], n, 0, cols)
        val = randint(ks[VAL], n, 0, universe)
        out["round"].append(np.full(who.size, r, np.int32))
        out["node"].append(who.astype(np.int32))
        out["row"].append(row[who])
        out["col"].append(col[who])
        out["val"].append(val[who])
    return {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
            for k, v in out.items()}


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)
