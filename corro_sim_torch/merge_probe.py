"""Where the merge kernel's time goes: the kernel beside the DRAM traffic
it makes, on one populated 10 000-node table.

    python -m corro_sim_torch.merge_probe [--out DIR]

On one table of 10 000 nodes × 256 rows × 4 columns, populated from
seed 11 by ``chip_smoke.py``'s generator, and three mailboxes of cap
128 — the lanes of chip_smoke.py's sync-style case (80 % valid), the
same lanes with a quarter of the valid ones kept (about the density of
the slice's own sweeps), and none valid — it times, each call on a
fresh copy of the pre-merge planes:

- the merge kernel (``grouped_merge``), beside its in-place bound
  (``merge_work``) and the same words counted in whole 32-byte DRAM
  sectors (``merge_sector_bytes``);
- ``csrc/dram_probe.cu`` touching the rows the mailbox hits, and only
  them, as the kernel does: written; read; read, then written — in
  ascending row order, as the kernel visits them, and once more in a
  shuffled order. Then the 128-byte lines holding those rows, read and
  written whole; and every line (a dense in-place copy of the three
  planes). Apart, the mailbox read as the kernel stages it (every valid
  word, the other fields of the valid lanes), each call on its own
  copy of the mailbox.

Prints one JSON object and writes it to ``DIR/merge_probe.json``. Needs
a CUDA device; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from corro_sim_torch.core import merge_kernel as mk
from corro_sim_torch.core.crdt import NEG, apply_cell_changes, make_table_state

PROBE_SOURCE = mk.KERNEL_SOURCE.with_name("dram_probe.cu")
PROBE_MODES = ("write_rows", "read_rows", "read_write_rows",
               "read_write_lines", "read_write_all")

_probe_lib = None


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_lanes(rng, n, r, c, m):
    """``(dst, row, col, cv, vr, site, cl, valid)`` numpy lanes: deletes,
    resurrections, invalid lanes and same-cell conflicts."""
    dst = rng.integers(0, n, m).astype(np.int32)
    row = rng.integers(0, r, m).astype(np.int32)
    col = rng.integers(0, c, m).astype(np.int32)
    cv = rng.integers(1, 6, m).astype(np.int32)
    vr = rng.integers(-3, 50, m).astype(np.int32)
    site = rng.integers(0, n, m).astype(np.int32)
    cl = rng.integers(1, 4, m).astype(np.int32)
    valid = rng.random(m) < 0.8
    is_del = rng.random(m) < 0.2
    vr = np.where(is_del, NEG, vr).astype(np.int32)
    cl = np.where(is_del, cl + (cl % 2), cl).astype(np.int32)
    return dst, row, col, cv, vr, site, cl, valid


def device_sync_box(n, r, c, cap, seed, device) -> torch.Tensor:
    """A sync-style mailbox of :func:`random_lanes`' distribution drawn
    on the device from ``seed`` (drawing 134 M lanes on the host takes
    minutes): node-major, ``cap`` lanes per node."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m = n * cap

    def ints(lo, hi):
        return torch.randint(lo, hi, (m,), generator=g, device=device,
                             dtype=torch.int32)

    cell = ints(0, r) * c + ints(0, c)
    cv, vr, site, cl = ints(1, 6), ints(-3, 50), ints(0, n), ints(1, 4)
    valid = torch.rand(m, generator=g, device=device) < 0.8
    is_del = torch.rand(m, generator=g, device=device) < 0.2
    vr = torch.where(is_del, NEG, vr)
    cl = torch.where(is_del, cl + cl % 2, cl)
    return torch.stack([cell, cv, vr, site, cl, valid.to(torch.int32)])


def populated_table(rng, n, r, c, device):
    """A table after one merge of ``n * 64`` random lanes."""
    return apply_cell_changes(
        make_table_state(n, r, c, device),
        *[torch.as_tensor(x, device=device)
          for x in random_lanes(rng, n, r, c, n * 64)],
    )


def sync_box(lanes, c, device) -> torch.Tensor:
    """Sync-style mailbox of numpy ``lanes``: node-major, ``m / n`` lanes
    per node, the mailbox a stack of the fields."""
    _dst, row, col, cv, vr, site, cl, valid = lanes
    return torch.as_tensor(np.stack([
        row * c + col, cv, vr, site, cl, valid.astype(np.int32),
    ]).astype(np.int32), device=device).contiguous()


def time_ms(fn, reps: int, batch: int = 10) -> float:
    """Median device milliseconds per call: CUDA events around ``batch``
    back-to-back calls, ``reps`` times. One call is queued before the
    first event of each batch, so the host's launch cost overlaps device
    work instead of opening a gap."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def time_in_place_ms(launch, pristine, reps: int, batch: int = 10) -> float:
    """Median device milliseconds per call of an in-place ``launch(planes)``
    that consumes its planes: each call gets its own fresh copy of the
    ``pristine`` planes, refreshed before the batch's first event. The
    card sleeps before that event while the host queues the batch, so the
    launches run back to back. The first batch is a warm-up."""
    bufs = [tuple(t.clone() for t in pristine) for _ in range(batch)]
    times = []
    for _ in range(reps + 1):
        for buf in bufs:
            for t, p in zip(buf, pristine):
                t.copy_(p)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        for buf in bufs:
            launch(buf)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    del bufs
    return float(np.median(times[1:]))


def hit_rows(lanes: torch.Tensor, cap: int, cols: int,
             cells: int) -> torch.Tensor:
    """``(N, width)`` int32: per node, the rows its valid in-range lanes
    hit, ascending, padded with -1 (``width`` the most any node hits, at
    least 1)."""
    n = lanes.shape[1] // cap
    rows = cells // cols
    dev = lanes.device
    node = torch.arange(n * cap, device=dev) // cap
    cell = lanes[mk.LANE_CELL].long()
    hit = (lanes[mk.LANE_VALID] != 0) & (cell >= 0) & (cell < cells)
    key = torch.unique(node[hit] * rows + cell[hit] // cols)
    kn = key // rows
    counts = torch.bincount(kn, minlength=n)
    width = max(int(counts.max()) if key.numel() else 0, 1)
    rank = torch.arange(key.numel(), device=dev) - (
        torch.cumsum(counts, 0) - counts)[kn]
    out = torch.full((n, width), -1, dtype=torch.int32, device=dev)
    out[kn, rank] = (key % rows).to(torch.int32)
    return out


def build_probe() -> ctypes.CDLL:
    global _probe_lib
    if _probe_lib is None:
        lib, _info = mk.build_library(PROBE_SOURCE, "dram_probe")
        lib.dram_probe_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        lib.dram_probe_launch.restype = ctypes.c_int
        lib.lane_probe_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p]
        lib.lane_probe_launch.restype = ctypes.c_int
        _probe_lib = lib
    return _probe_lib


def probe(planes, rows: torch.Tensor, mode: int, sink: torch.Tensor):
    """Touch the cv/vr/site planes (``planes[:3]``, ``(N, cells)`` int32,
    4 columns per row, at most 1024 cells) in pattern ``mode``
    (:data:`PROBE_MODES`) over the ``rows`` of :func:`hit_rows`. Every
    mode but ``write_rows`` leaves the planes' values as they were."""
    cv, vr, site = planes[:3]
    n, cells = cv.shape
    if cells % 32 or cells > 1024:
        raise ValueError("dram probe: cells must be a multiple of 32, "
                         "at most 1024")
    stream = torch.cuda.current_stream(cv.device).cuda_stream
    err = build_probe().dram_probe_launch(
        cv.data_ptr(), vr.data_ptr(), site.data_ptr(), rows.data_ptr(),
        n, cells, rows.shape[1], mode, 0, sink.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dram probe: CUDA launch failed (error {err})")


def probe_lanes(lanes: torch.Tensor, cap: int, sink: torch.Tensor):
    """Read a ``(6, N * cap)`` mailbox as the merge kernel stages it."""
    stream = torch.cuda.current_stream(lanes.device).cuda_stream
    err = build_probe().lane_probe_launch(
        lanes.data_ptr(), lanes.shape[1] // cap, cap, sink.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"lane probe: CUDA launch failed (error {err})")


def _case(label, pristine, box, cap, c, sink) -> dict:
    n, cells = pristine[0].shape
    after = tuple(t.clone() for t in pristine)
    mk.grouped_merge(*after, box, cap, c)
    work = mk.merge_work(pristine, box, cap, c, after)
    sector_bytes = mk.merge_sector_bytes(pristine, box, cap, c, after)
    rows = hit_rows(box, cap, c, cells)
    out = {
        "case": label,
        "valid_lanes_per_node": int((box[mk.LANE_VALID] != 0).sum()) / n,
        "rows_hit_per_node": int((rows >= 0).sum()) / n,
        "rows_wiped_per_node": int((after[3] > pristine[3]).sum()) / n,
        "kernel_ms": time_in_place_ms(
            lambda p: mk.grouped_merge(*p, box, cap, c), pristine, 20),
        "bound_ms": mk.bound_ms(work)[0],
        "bytes": work[0],
        "sector_bytes": sector_bytes,
        "sector_bound_ms": 1e3 * sector_bytes / mk.HBM_BYTES_PER_S,
    }
    for mode, name in enumerate(PROBE_MODES):
        out[f"probe_{name}_ms"] = time_in_place_ms(
            lambda p, mode=mode: probe(p, rows, mode, sink), pristine, 10)
    # the same rows, each node's list in one shuffled order
    perm = torch.randperm(rows.shape[1],
                          generator=torch.Generator().manual_seed(0))
    shuffled = rows[:, perm.to(rows.device)].contiguous()
    out["probe_read_write_rows_shuffled_ms"] = time_in_place_ms(
        lambda p: probe(p, shuffled, 2, sink), pristine, 10)
    out["probe_read_lanes_ms"] = time_in_place_ms(
        lambda p: probe_lanes(p[0], cap, sink), (box,), 10)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="bench_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("merge_probe: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    dev = torch.device("cuda")
    n, r, c, cap = 10000, 256, 4, 128
    rng = np.random.default_rng(11)
    state = populated_table(rng, n, r, c, dev)
    random_lanes(rng, n, r, c, n * 64)  # chip_smoke.py's routed mailbox
    lanes = random_lanes(rng, n, r, c, n * cap)
    box = sync_box(lanes, c, dev)
    keep = np.random.default_rng(12).random(n * cap) < 0.25
    sparse = sync_box(lanes[:7] + (lanes[7] & keep,), c, dev)
    empty = box.clone()
    empty[mk.LANE_VALID] = 0
    pristine = (state.cv.view(n, -1), state.vr.view(n, -1),
                state.site.view(n, -1), state.cl)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    report = {
        "card": torch.cuda.get_device_name(dev), "nvidia_smi": nvidia_smi(),
        "nodes": n, "cells": r * c, "cols": c, "cap": cap,
        "cases": [_case(label, pristine, b, cap, c, sink) for label, b in
                  (("valid_80", box), ("valid_20", sparse),
                   ("valid_0", empty))],
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "merge_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
