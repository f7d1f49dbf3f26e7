#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each kernel against its plain PyTorch version on the card, drives
the port's main path (``corro_sim_torch.engine.driver.run_sim``) on a
10 000-node anti-entropy cluster until it converges, and checks the
kernel arm of a whole simulation against the scatter arm. Every phase
prints one JSON line; any failure raises and exits non-zero. The last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 33.5e12  # H100 SXM5 non-tensor INT32 (NVIDIA whitepaper)
NEG = -(2 ** 31)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_lanes(rng, n, r, c, m):
    """Deletes, resurrections, invalid lanes and same-cell conflicts."""
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


def time_ms(fn, reps: int, batch: int = 10) -> float:
    """Median device milliseconds per call: CUDA events around ``batch``
    back-to-back calls, ``reps`` times. One call is queued before the
    first event of each batch, so the host's launch cost overlaps device
    work instead of opening a gap."""
    import torch

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


def merge_work(args, want):
    """The least bytes and integer operations the merge needs on these
    inputs. Bytes: each input the function needs read once, each output
    written once — the (N, rows) cl plane; the stored cv/vr/site of the
    rows the merge does not wipe; of the lanes, the valid word of every
    lane, cell and cl of valid lanes, vr of valid lanes at their row's
    merged generation, cv of those that carry a value, site of those
    tying the merged cv and vr; and the four output planes. Operations:
    one max per lane that competes in a pass, one select per cell for
    each of the three pass bases and one compare per row."""
    import torch

    cv, _vr, _site, cl, lanes, cap, cols = args
    cv1, vr1, _site1, cl1 = want
    n, cells = cv.shape
    rows = cl.shape[1]
    node = torch.arange(n * cap, device=cv.device) // cap
    cell = lanes[0].long()
    valid = (lanes[5] != 0) & (cell >= 0) & (cell < cells)
    flat = node * cells + cell.clamp(0, cells - 1)
    gen = valid & (lanes[4] == cl1.reshape(-1)[flat // cols])
    value = gen & (lanes[2] != NEG)
    tie = (value & (lanes[1] == cv1.reshape(-1)[flat])
           & (lanes[2] == vr1.reshape(-1)[flat]))
    counts = [int(x.sum()) for x in (valid, gen, value, tie)]
    kept_rows = int((cl1 == cl).sum())
    lane_words = n * cap + 2 * counts[0] + counts[1] + counts[2] + counts[3]
    words = (n * rows + 3 * kept_rows * cols  # inputs
             + 3 * n * cells + n * rows  # outputs
             + lane_words)
    ops = counts[0] + counts[2] + 2 * counts[3] + 3 * n * cells + n * rows
    return 4 * words, ops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.core.crdt import apply_cell_changes, make_table_state
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.profile_slice import (
        RUN_ARGS,
        slice_config,
        slice_schedule,
    )
    from corro_sim_torch.utils.slots import ranks_within_group

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    mk.build_kernel()
    ptxas = [ln.strip() for ln in mk.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": mk.BUILD_INFO["library"], "ptxas": ptxas})

    # ------------------------------------ kernel against its plain version
    def to_dev(lanes):
        return [torch.as_tensor(x, device=dev) for x in lanes]

    def routed_box(dst, row, col, cv, vr, site, cl, valid, n, c, cap):
        """Delivery-style mailbox: lanes ranked within their dst."""
        order = torch.argsort(torch.where(valid, dst, n + 1), stable=True)
        s_dst = torch.where(valid, dst, n + 1)[order]
        rank = ranks_within_group(s_dst)
        return mk.route_lanes(
            dst[order], rank, (row * c + col)[order], cv[order], vr[order],
            site[order], cl[order], valid[order], n, cap,
        )

    def planes(state):
        n, r, c = state.cv.shape
        return (state.cv.reshape(n, r * c), state.vr.reshape(n, r * c),
                state.site.reshape(n, r * c), state.cl)

    def compare(state, box, cap, c, label):
        args = (*planes(state), box, cap, c)
        got = mk.grouped_merge(*args)
        want = mk.grouped_merge_reference(*args)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        if err != 0:
            raise AssertionError(f"kernel != plain version on {label}")
        return err, args, want

    checks = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        n, r, c = 16, 32, 4
        state = make_table_state(n, r, c, dev)
        state = apply_cell_changes(state, *to_dev(random_lanes(rng, n, r, c, 200)))
        lanes = to_dev(random_lanes(rng, n, r, c, 400))
        box = routed_box(*lanes, n, c, 128)
        compare(state, box, 128, c, f"random_lanes seed {seed}")
        # the mailbox path also equals the scatter merge on the raw lanes
        want = apply_cell_changes(state, *lanes)
        got = mk.merge_grouped(state, box, 128)
        for f in ("cv", "vr", "site", "cl"):
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"mailbox merge != scatter merge: {f}")
        checks.append(f"random_lanes[{seed}]")

    # cap overflow: node 0 gets 150 valid lanes, only the first 128 merge
    rng = np.random.default_rng(7)
    n, r, c, m0 = 8, 32, 4, 150
    state = make_table_state(n, r, c, dev)
    lanes = to_dev((
        np.zeros(m0, np.int32), rng.integers(0, r, m0).astype(np.int32),
        rng.integers(0, c, m0).astype(np.int32),
        rng.integers(1, 5, m0).astype(np.int32),
        rng.integers(0, 50, m0).astype(np.int32),
        rng.integers(0, n, m0).astype(np.int32), np.ones(m0, np.int32),
        np.ones(m0, bool),
    ))
    box = routed_box(*lanes, n, c, 128)
    compare(state, box, 128, c, "cap overflow")
    want = apply_cell_changes(
        state, *lanes[:7], lanes[7] & (torch.arange(m0, device=dev) < 128)
    )
    got = mk.merge_grouped(state, box, 128)
    if not (torch.equal(got.vr, want.vr) and torch.equal(got.cl, want.cl)):
        raise AssertionError("cap overflow: kernel != masked scatter merge")
    checks.append("cap_overflow")

    # both mailbox styles at the slice's shape
    n, r, c, cap = 10000, 256, 4, 128
    cells = r * c
    rng = np.random.default_rng(11)
    base_state = apply_cell_changes(
        make_table_state(n, r, c, dev),
        *to_dev(random_lanes(rng, n, r, c, n * 64)),
    )
    routed = routed_box(*to_dev(random_lanes(rng, n, r, c, n * 64)),
                        n, c, cap)
    err_routed, _, _ = compare(base_state, routed, cap, c, "routed 10k")
    checks.append("routed_10000x1024x128")
    # sync style: node-major lanes, the mailbox is a reshape
    sl = random_lanes(rng, n, r, c, n * cap)
    sl_t = to_dev(sl)
    sync_box = torch.stack([
        (sl_t[1] * c + sl_t[2]), sl_t[3], sl_t[4], sl_t[5], sl_t[6],
        sl_t[7].to(torch.int32),
    ]).to(torch.int32).contiguous()
    err_sync, sync_args, sync_want = compare(
        base_state, sync_box, cap, c, "sync 10k")
    checks.append("sync_10000x1024x128")
    kernel_ms = time_ms(lambda: mk.grouped_merge(*sync_args), 20)
    plain_ms = time_ms(lambda: mk.grouped_merge_reference(*sync_args), 5,
                       batch=5)
    kernel_bytes, kernel_ops = merge_work(sync_args, sync_want)
    bytes_ms = 1e3 * kernel_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * kernel_ops / INT32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    emit({"phase": "kernel_check", "kernel": "grouped_merge",
          "checks": checks, "bit_equal": True,
          "shape": {"nodes": n, "cells": cells, "cap": cap},
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": kernel_bytes, "bytes_ms": bytes_ms,
          "ops": kernel_ops, "ops_ms": ops_ms})
    del base_state, routed, sync_box, sync_args, sync_want, sl_t
    torch.cuda.empty_cache()

    # ------------------------------------ the main path at full size
    cfg = slice_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mk.reset_launch_counts()
    res = run_sim(cfg, state, slice_schedule(), device="cuda", **RUN_ARGS)
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    final_gap = float(res.metrics["gap"][-1])
    sweeps = int(res.state.sync_rounds)
    table = res.state.table
    uniform = all(
        bool((getattr(table, f) == getattr(table, f)[:1]).all())
        for f in ("cv", "vr", "site", "cl")
    )
    emit({"phase": "slice", "nodes": cfg.num_nodes,
          "cells": cfg.num_rows * cfg.num_cols,
          "rounds_to_convergence": res.converged_round,
          "rounds_run": res.rounds, "repair_chunks": res.repair_chunks,
          "final_gap": final_gap, "sync_sweeps": sweeps,
          "writes": int(res.metrics["writes"].sum()),
          "setup_s": init_s + res.setup_seconds, "sim_s": res.wall_seconds,
          "wall_per_round_ms": res.wall_per_round_ms,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "tables_agree": uniform, "launches": launches})
    if res.converged_round is None or final_gap != 0.0:
        raise AssertionError("the 10k-node slice did not converge")
    if not uniform:
        raise AssertionError("converged replicas hold different tables")
    if launches["grouped_merge"] != sweeps or sweeps == 0:
        raise AssertionError(
            f"expected one kernel launch per sync sweep ({sweeps}), "
            f"counted {launches['grouped_merge']}"
        )
    del res, state, table
    torch.cuda.empty_cache()

    # ----------------------- kernel arm against scatter arm, whole run
    runs = {}
    for arm in ("on", "off"):
        cfg_arm = slice_config(1024, arm)
        mk.reset_launch_counts()
        res = run_sim(
            cfg_arm, init_state(cfg_arm, seed=0, device="cuda"),
            slice_schedule(), max_rounds=24, chunk=8, seed=0,
            stop_on_convergence=False, device="cuda",
        )
        runs[arm] = (state_to_numpy(res.state), res.metrics,
                     mk.LAUNCHES["grouped_merge"])
    (s_on, m_on, l_on), (s_off, m_off, l_off) = runs["on"], runs["off"]
    diff = [k for k in s_off if not np.array_equal(s_on[k], s_off[k])]
    diff += [k for k in m_off if not np.array_equal(m_on[k], m_off[k])]
    emit({"phase": "kernel_vs_scatter", "nodes": 1024, "rounds": 24,
          "launches_on": l_on, "launches_off": l_off,
          "state_leaves": len(s_off), "metrics": len(m_off),
          "differing": diff})
    if diff or l_on == 0 or l_off != 0:
        raise AssertionError("merge_kernel='on' and 'off' runs differ")

    emit({"kernels": [{
        "name": "grouped_merge",
        "route": "cuda",
        "source": "corro_sim_torch/core/csrc/merge_kernel.cu",
        "replaces": "corro_sim/core/merge_kernel.py:184",
        "launches": launches["grouped_merge"],
        "max_abs_err": max(err_routed, err_sync),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
