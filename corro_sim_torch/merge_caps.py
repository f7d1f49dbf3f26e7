"""The merge kernel's time at each mailbox cap the simulator's sweeps
use, for an A/B of two checkouts on one card.

    python -m corro_sim_torch.merge_caps --out DIR --label NAME

Times ``grouped_merge`` in place (each call on a fresh copy of the
pre-merge planes) beside its ``merge_work`` byte bound, on sync-style
mailboxes of :mod:`corro_sim_torch.merge_probe`'s generators (80 %
valid lanes, node-major) at these shapes:

- cap 128: 10 000 nodes × 256 rows × 4 columns (the north-star cluster);
- cap 512: 10 000 nodes × 2048 rows × 2 columns (config 6 at 10 000);
- cap 1024: 1000 nodes × 512 rows × 6 columns (config 3);
- cap 8192: 16 384 nodes × 128 rows × 2 columns (config 5), where the
  checkout's kernel takes it; else the record says why not.

It calls nothing but ``grouped_merge``, ``merge_work``, ``bound_ms`` and
merge_probe's generators and timer, so the file copied into an older
checkout's ``corro_sim_torch/`` times that checkout's kernel on the same
inputs. Prints one JSON object and writes it to
``DIR/merge_caps_NAME.json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from corro_sim_torch.core import merge_kernel as mk
from corro_sim_torch.merge_probe import (
    nvidia_smi,
    populated_table,
    random_lanes,
    sync_box,
    time_in_place_ms,
)

# (nodes, rows, cols, cap) of each timed mailbox
SHAPES = ((10000, 256, 4, 128), (10000, 2048, 2, 512), (1000, 512, 6, 1024),
          (16384, 128, 2, 8192))


def _box(rng, n, r, c, cap, dev):
    """The sync-style mailbox; drawn on the device at cap 8192 (134 M
    lanes), where the checkout has the device generator."""
    if cap <= 1024:
        return sync_box(random_lanes(rng, n, r, c, n * cap), c, dev)
    from corro_sim_torch.merge_probe import device_sync_box

    return device_sync_box(n, r, c, cap, 5, dev)


def time_cap(n, r, c, cap, dev) -> dict:
    rng = np.random.default_rng(11)
    state = populated_table(rng, n, r, c, dev)
    pristine = (state.cv.view(n, -1), state.vr.view(n, -1),
                state.site.view(n, -1), state.cl)
    rec = {"nodes": n, "cells": r * c, "cols": c, "cap": cap}
    try:
        box = _box(rng, n, r, c, cap, dev)
        after = tuple(t.clone() for t in pristine)
        mk.grouped_merge(*after, box, cap, c)
    except (ImportError, ValueError) as e:
        return dict(rec, refused=str(e))
    rec["kernel_ms"] = time_in_place_ms(
        lambda p: mk.grouped_merge(*p, box, cap, c), pristine, 20)
    rec["bound_ms"] = mk.bound_ms(mk.merge_work(pristine, box, cap, c,
                                                after))[0]
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="bench_out")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("merge_caps: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    dev = torch.device("cuda")
    mk.build_kernel()
    caps = []
    for shape in SHAPES:
        caps.append(time_cap(*shape, dev))
        torch.cuda.empty_cache()
    report = {"label": args.label, "nvidia_smi": nvidia_smi(), "caps": caps}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"merge_caps_{args.label}.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
