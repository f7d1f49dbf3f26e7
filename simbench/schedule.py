"""The one generator of traffic: a mix's parameters to a cluster's
per-round ground truth.

A mix (``simbench/traffic/<name>.json``) states its write rounds, an
optional partition and an optional outage, each as the ``fraction`` of
the nodes cut off, the ``side`` of the id range they sit on (``lower``:
ids below ``fraction * N``; ``upper``: ids from ``(1 - fraction) * N``)
and the half-open ``rounds`` it lasts; its ``mode`` (``converge``: each
cluster runs to its converged round, tested after ``min_rounds``, at
most ``max_rounds``; ``fixed``: each runs exactly ``rounds`` rounds);
the ``chunk`` of rounds per ``run_sim`` step; the rounds its warm-up
cluster runs; and the rounds its traced window covers.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _side(spec: dict, n: int) -> np.ndarray:
    f = float(spec["fraction"])
    ids = np.arange(n)
    if spec["side"] == "lower":
        return ids < int(n * f)
    if spec["side"] == "upper":
        return ids >= int(n * (1.0 - f))
    raise ValueError(f"no such side: {spec['side']!r}")


def _during(spec, r: int) -> bool:
    return spec is not None and spec["rounds"][0] <= r < spec["rounds"][1]


def alive_row(traffic: dict, r: int, n: int) -> np.ndarray:
    """Who is up in round ``r``."""
    if _during(traffic.get("outage"), r):
        return ~_side(traffic["outage"], n)
    return np.ones(n, bool)


def part_row(traffic: dict, r: int, n: int) -> np.ndarray:
    """Each node's partition id in round ``r``."""
    p = np.zeros(n, np.int32)
    if _during(traffic.get("partition"), r):
        p[_side(traffic["partition"], n)] = 1
    return p


def alive_rows(traffic: dict, rounds: int, n: int) -> np.ndarray:
    """``(rounds, n)``: who is up, round by round."""
    return np.stack([alive_row(traffic, r, n) for r in range(rounds)])


def run_args(traffic: dict) -> dict:
    """``run_sim``'s arguments for one cluster of the mix."""
    fixed = traffic["mode"] == "fixed"
    return dict(
        chunk=int(traffic["chunk"]),
        max_rounds=int(traffic["rounds"] if fixed else traffic["max_rounds"]),
        min_rounds=int(traffic["min_rounds"]),
        stop_on_convergence=not fixed,
    )


def cluster_seed(seed: int, i: int) -> int:
    """Cluster ``i``'s seed in a run keyed by ``seed``: 31 bits of
    sha-256 over both, so that any whole-number seed works."""
    h = hashlib.sha256(f"simbench:{int(seed)}:{int(i)}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def judged_clusters(seed: int) -> tuple:
    """The clusters whose answers a run judges: the first, and one of the
    next three drawn from the seed."""
    h = hashlib.sha256(f"simbench-judge:{int(seed)}".encode()).digest()
    return (0, 1 + h[0] % 3)
