"""Where a round of the port's main path spends its time.

    python -m corro_sim_torch.profile_slice [--out DIR]

Defines the slice's cell — the north-star cluster without SWIM, its
partition schedule and run arguments — which ``chip_smoke.py`` drives
too, and runs it on the card from the same seed: once to warm the
allocator and the kernel build (discarded), then three times:

1. plain, timed — the wall per round a user sees;
2. with each stage of the step wrapped in a device synchronize and a
   host timer — the wall of each stage, inclusive of its launches
   (nested stages, such as the draws inside the sync sweep, count in
   both);
3. under ``torch.profiler`` — device time by kernel name, the number of
   kernels launched, and the device's busy share of the profiled wall;
4. with the sync sweep's merge wrapped — the merge kernel's in-place
   and out-of-place bounds (``merge_work``), its words counted in whole
   DRAM sectors (``merge_sector_bytes``) and what each real mailbox
   holds (valid lanes, rows hit, rows wiped), set beside the kernel's
   device time per launch from run 3.

Prints one JSON object and writes it, with the full kernel table, to
``DIR/profile_slice.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from corro_sim_torch import merge_probe as mp
from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig
from corro_sim_torch.core import merge_kernel as mk
from corro_sim_torch.engine import step as step_mod
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.sync import sync as sync_mod

# (module, attribute) of each timed stage, as the step calls it
STAGES = (
    (step_mod, "local_write"),
    (step_mod, "append_changesets"),
    (step_mod, "update_ownership"),
    (step_mod, "broadcast_step"),
    (step_mod, "delivery_pass"),
    (step_mod, "enqueue_own"),
    (step_mod, "enqueue_broadcasts"),
    (step_mod, "sync_round"),
    (step_mod, "_gap"),
    (sync_mod, "choose_sync_peers"),
    (sync_mod, "merge_grouped"),
    (sync_mod, "advance_heads"),
    (prng, "uniform"),
    (prng, "randint"),
    (prng, "choice"),
)


# run_sim arguments of the slice's cell: about 1 000 writes over 8
# rounds, convergence tested from round 16 on
RUN_ARGS = dict(max_rounds=512, chunk=16, seed=0, min_rounds=16)


def slice_config(n: int = 10000, merge_kernel: str = "auto") -> SimConfig:
    """The north-star cluster (the JAX package's config 0,
    ``corro_sim/benchmarks.py:237-282``) with SWIM off."""
    return SimConfig(
        num_nodes=n, num_rows=256, num_cols=4, log_capacity=512,
        write_rate=1000.0 / (n * 8), zipf_alpha=0.8, swim_enabled=False,
        sync_interval=8, pend_slots=8, fanout=2, sync_adaptive=True,
        sync_floor_rounds=1, sync_actor_topk=128, sync_cap_per_actor=1,
        sync_req_actors=128, sync_need_sample=64, sync_deal_probes=0,
        merge_kernel=merge_kernel,
    )


def partition_upper_half(r: int, num: int) -> np.ndarray:
    """The upper half of the cluster cut off for rounds 4-11."""
    p = np.zeros(num, np.int32)
    if 4 <= r < 12:
        p[num // 2:] = 1
    return p


def slice_schedule() -> Schedule:
    return Schedule(write_rounds=8, part_fn=partition_upper_half)


def _run(cfg, device):
    state = init_state(cfg, seed=0, device=device)
    return run_sim(cfg, state, slice_schedule(), device=device, **RUN_ARGS)


@contextlib.contextmanager
def _stage_timers(device, totals, counts):
    def sync():
        torch.cuda.synchronize(device)

    saved = []
    for mod, name in STAGES:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        @functools.wraps(fn)
        def timed(*a, _fn=fn, _name=name, **kw):
            sync()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            sync()
            totals[_name] += time.perf_counter() - t0
            counts[_name] += 1
            return out

        setattr(mod, name, timed)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _merge_bounds(cfg, device) -> list:
    """Run the cell with the sync sweep's merge wrapped; per launch, a
    dict of the merge's in-place and out-of-place work, its sector bytes
    and the mailbox's counts. The wrapper copies the pre-merge planes,
    which the merge consumes."""
    works = []
    merge = sync_mod.merge_grouped

    def counted(table, lanes, cap):
        n, r, c = table.cv.shape
        before = tuple(t.reshape(n, -1).clone() for t in
                       (table.cv, table.vr, table.site, table.cl))
        out = merge(table, lanes, cap)
        after = tuple(t.reshape(n, -1) for t in
                      (out.cv, out.vr, out.site, out.cl))
        valid = lanes[mk.LANE_VALID] != 0
        works.append({
            "in_place": mk.merge_work(before, lanes, cap, c, after),
            "out_of_place": mk.merge_work_out_of_place(before, lanes, cap,
                                                       c, after),
            "sector_bytes": mk.merge_sector_bytes(before, lanes, cap, c,
                                                  after),
            "valid_lanes": int(valid.sum()),
            "nodes_with_lanes": int(valid.view(n, cap).any(1).sum()),
            "rows_hit": int((mp.hit_rows(lanes, cap, c, r * c) >= 0).sum()),
            "rows_wiped": int((after[3] > before[3]).sum()),
        })
        return out

    sync_mod.merge_grouped = counted
    try:
        _run(cfg, device)
    finally:
        sync_mod.merge_grouped = merge
    return works


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in ms."""
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="bench_out")
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    cfg = slice_config()

    _run(cfg, device)  # warm-up: allocator growth, kernel build
    torch.cuda.reset_peak_memory_stats(device)
    plain = _run(cfg, device)
    rounds = plain.rounds
    smi = mp.nvidia_smi()
    report = {
        "nodes": cfg.num_nodes, "card": torch.cuda.get_device_name(device),
        "nvidia_smi": smi, "rounds": rounds,
        "converged_round": plain.converged_round,
        "wall_per_round_ms": plain.wall_per_round_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
    }

    totals, counts = defaultdict(float), defaultdict(int)
    with _stage_timers(device, totals, counts):
        timed = _run(cfg, device)
    report["timed_wall_per_round_ms"] = timed.wall_per_round_ms
    report["stage_ms_per_round"] = {
        k: 1e3 * v / rounds for k, v in sorted(
            totals.items(), key=lambda kv: -kv[1])
    }
    report["stage_calls"] = dict(counts)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = _run(cfg, device)
        torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    table = sorted(
        ({"kernel": k, "ms": v[0], "launches": v[1]}
         for k, v in by_name.items()),
        key=lambda r: -r["ms"],
    )
    busy = _busy_ms([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    report.update({
        "profiled_rounds": profiled.rounds,
        "profiled_wall_ms": wall_ms,
        "kernel_launches": len(kernels),
        "kernel_launches_per_round": len(kernels) / profiled.rounds,
        "device_kernel_ms": sum(r["ms"] for r in table),
        "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms,
        "top_kernels": table[:15],
    })
    merge_rows = [r for r in table if "grouped_merge" in r["kernel"]]
    works = _merge_bounds(cfg, device)
    launches = sum(r["launches"] for r in merge_rows)
    def mean(f):
        return float(np.mean([f(w) for w in works]))

    report["merge_kernel"] = {
        "launches": launches,
        "ms_per_launch": (sum(r["ms"] for r in merge_rows) / launches
                          if launches else None),
        "bound_ms_per_launch": mean(lambda w: mk.bound_ms(w["in_place"])[0]),
        "bound_out_of_place_ms_per_launch": mean(
            lambda w: mk.bound_ms(w["out_of_place"])[0]),
        "bytes_per_launch": mean(lambda w: w["in_place"][0]),
        "sector_bound_ms_per_launch": mean(
            lambda w: 1e3 * w["sector_bytes"] / mk.HBM_BYTES_PER_S),
        "valid_lanes_per_launch": mean(lambda w: w["valid_lanes"]),
        "nodes_with_lanes_per_launch": mean(lambda w: w["nodes_with_lanes"]),
        "rows_hit_per_launch": mean(lambda w: w["rows_hit"]),
        "rows_wiped_per_launch": mean(lambda w: w["rows_wiped"]),
        "bounded_launches": len(works),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_slice.json"), "w") as f:
        json.dump(dict(report, kernels=table), f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
