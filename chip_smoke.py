#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each kernel against its plain PyTorch version on the card, drives
the port's main path (``corro_sim_torch.engine.driver.run_sim``) on the
10 000-node north-star cluster until it converges, with SWIM off (the
first slice's path) and with full SWIM on (the JAX package's config 0
exactly), holds two SWIM-on runs against digests of the JAX package's
runs, and checks the kernel arm of a whole simulation against the
scatter arm. Then the same for multi-cell, multi-chunk changesets: the
JAX package's config 3 (the Consul-schema cluster: 4-cell changesets in
2 chunks) at its own 1000 nodes to convergence, held to the round and
the digest of the JAX package's run; config 3's shape at 10 000 nodes
for 64 rounds; and its kernel arm against its scatter arm. Then the
workload engine and trace replay: the batched half of the JAX package's
config 6 (Zipf + churn-storm traffic through ``run_sim(workload=...)``
under an egress cap) at 1000 nodes, held to the JAX package's round and
digest, and at its own 10 000 nodes to convergence; its kernel arm
against its scatter arm; and the replay of the repository's
``corro-api-types`` changeset fixtures, held to the JAX package's final
tables, rounds and digests. Then this slice: the kernel at config 5's
8192-lane mailbox (merged tile by tile); the JAX package's config 4
(the headline: its rate, ms per round and peak) at 10 000 nodes and its
digest run; configs 5 and 7 at the node count the card's memory and the
JAX package's one-device rules give, to convergence, and their digest
runs; config 6 at 4000 nodes held to the JAX package's round and
digest; and the pipelined driver against the sequential one. Then
faults: config 8's chaos lanes run as their serial twins (its lane base
at 256 nodes under each soak scenario, through the JAX package's serial
soak loop with the invariant checker armed), held to the digests,
rounds, invariant reports and resilience blocks of the JAX package's
runs; and config 0's 10 000-node cluster soaked under config 8's four
scenarios, each to re-convergence with a final gap of 0. Then the rest
of the step: config 0's 10 000-node cluster across four latency regions
with the in-flight ring, RTT rings and 8 probes, to convergence, its
probe trees held to the BFS oracle and its RTT plane to the link delays
("latency_10k"); config 0 at 10 000 nodes on the legacy sync schedule
and on two deal probes ("legacy_sync_10k"); and those three shapes at
256 and 1000 nodes held to the JAX package's digests and rounds
("slice8_digests"); a lossy soak under the latency ring runs among the
fault digests. Then the fleet sweep and resumable checkpoints: the
kernel at config 8's lane shape; config 8's grid through
``corro_sim_torch.sweep.engine.run_sweep`` in lockstep (seeds 0-3 of its
eight), every lane held to the JAX package's lane digests and the
frontier to its digest, beside the four seed-0 lanes' serial twins
("config8_sweep"); its four seed-0 lanes through the compact fleet
scheduler at width 2, pipelined ("config8_compact"); its lane base at
1024 nodes (windowed SWIM in the lanes), the lossy and churn lanes, the
lossy one against its serial twin ("config8_1024"); and config 0 at
10 000 nodes under crash_amnesia checkpointed every chunk, killed after
chunk 1 and resumed from its token to the uninterrupted run of
"soak_10k", then the JAX package's committed token resumed to its pin
("checkpoint_10k"). Then the digital twin: a seeded Consul-schema
changeset feed with hostile lines shadowed at 256 nodes through
``corro_sim_torch.engine.twin.run_twin``, killed after chunk 1 and
resumed from its cursor token, and forecast from its fork under the
what-if grid, each held to the JAX package's pins ("twin_digests"); and
a Consul-schema feed of 128 actors shadowed at 10 000 nodes to one
converged table, the JAX package's, then forecast from its fork at
10 000 nodes (seed 0's two lanes) with one lane held to its serial
fork resume ("twin_10k"). Then the subscription engine
(``corro_sim_torch.subs``): that feed without its hostile lines replayed
on the card cut after 8 rounds and to convergence (the merge kernel on
the sync sweeps), and config 6's live-half population — 64 matchers
(32 Consul-sync queries on two observers each) and 1024 subscribers
through ``SubsManager.get_or_insert`` — primed on the cut table and
stepped on the converged one: at 256 nodes, every initial and step event
held to the JAX package's digests ("subs_digests"); at 10 000 nodes,
batched evaluation against single, every plain matcher's mask against
the host SQL oracle, the observers of each query against each other, and
the host seconds, group dispatches and device→host reads per step
("subs_10k"). Every phase
prints one JSON line with its seconds; any failure raises and exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
import types

import numpy as np

# the round at which the 10k-node slice converges from seed 0, with SWIM
# off and with SWIM on
SLICE_ROUNDS = 22
SWIM_SLICE_ROUNDS = 22
# the round at which config 3 converges at 1000 nodes from seed 0, as the
# JAX package's run does (the run behind DIGESTS["config3_1000"])
CONFIG3_ROUNDS = 1144
# rounds of config 3's shape run at 10 000 nodes
CONFIG3_10K_ROUNDS = 64
# config 8's seeds in the "config8_sweep" phase: config 8 runs seeds 0-7;
# seed 0 (4 lanes) keeps the script inside its time budget
CONFIG8_SMOKE_SEEDS = 1
# config 6's kernel arm against its scatter arm: nodes and rounds; the
# row count is pinned to 2048 (config 6's formula gives 2046 at 256
# nodes) so that the 4096-cell space lets the kernel run
CONFIG6_TWIN_NODES, CONFIG6_TWIN_ROUNDS, CONFIG6_TWIN_ROWS = 256, 48, 2048

# The converged tables of tests/fixtures/replay_parity.ndjson on every
# node, hand-derived from the reference's semantics (the JAX package's
# tests/test_replay_parity.py::EXPECTED).
REPLAY_EXPECTED = {
    ("tests", (1,)): {"text": "hello world 1 bis"},
    ("tests", (2,)): {"text": "zzz"},
    ("tests", (3,)): {"text": "three v2"},
}


_T0 = [time.perf_counter(), time.perf_counter()]


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries its seconds."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = dict(obj, phase_s=now - _T0[1], total_s=now - _T0[0])
    _T0[1] = now
    print(json.dumps(obj), flush=True)


def tables_agree(table) -> bool:
    """Whether every node holds the same table (cv, vr, site, cl)."""
    return all(bool((getattr(table, f) == getattr(table, f)[:1]).all())
               for f in ("cv", "vr", "site", "cl"))


def soak_record(run, launches: int) -> dict:
    """One soak run's JSON record: rounds, convergence, the fault
    counters, the checkers' verdicts and host seconds, the walls, the
    peak memory and the merge launches."""
    import torch

    res = run.result
    m = res.metrics
    return {
        "scenario": run.scenario.spec, "nodes": run.cfg.num_nodes,
        "rounds_run": res.rounds, "converged_round": res.converged_round,
        "heal_round": run.scenario.heal_round,
        "final_gap": float(m["gap"][-1]),
        "tables_agree": tables_agree(res.state.table),
        "log_wrapped_max": int(m["log_wrapped"].max()),
        "fault_totals": {k: int(v.sum()) for k, v in sorted(m.items())
                         if k.startswith(("fault_", "node_fault_"))},
        "invariants": (None if run.invariants is None
                       else run.invariants.report()),
        "resilience": None if res.resilience is None else {
            k: v for k, v in res.resilience.items()
            if isinstance(v, (int, str)) or v is None},
        "check_seconds": res.check_seconds,
        "sim_s": res.wall_seconds, "setup_s": res.setup_seconds,
        "wall_per_round_ms": res.wall_per_round_ms,
        "sync_sweeps": int(res.state.sync_rounds),
        "sweeps_run": res.pipeline["sweeps_run"], "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def fault_digest_phase(emit) -> int:
    """Phase ``fault_digests``: config 8's lane base at 256 nodes under
    each ``FAULT_DIGEST_CHIP_CASES`` scenario at seed 0 (the seed-1
    repeats stay pinned for the CPU; config 8's own four scenarios run as
    serial twins in "config8_sweep"), and under lossy links across four
    latency regions (the ring's conservation counters checked by the
    invariant checker), through ``run_soak`` with config 8's run
    arguments (blackhole_one_way for a fixed 96 rounds), held to the JAX
    package's digest, rounds, converged round, invariant violations and
    resilience integers (``FAULT_PINS``). Returns the merge launches (the
    count reset just before each run and read just after)."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import (
        FAULT_DIGEST_CHIP_CASES,
        fault_digest_record,
        fault_digest_run,
    )

    launches = {"fault_digests": 0}
    cases = {}
    for case in FAULT_DIGEST_CHIP_CASES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launch_counts()
        run = fault_digest_run(case, device="cuda")
        torch.cuda.synchronize()
        n_launch = mk.LAUNCHES["grouped_merge"]
        launches["fault_digests"] += n_launch
        rec = soak_record(run, n_launch)
        rec.update(fault_digest_record(case, run))
        rec["invariants_report"] = run.invariants.report()
        cases[case] = rec
        del run
        if not rec["match"]:
            emit({"phase": "fault_digests", "cases": cases})
            raise AssertionError(f"fault digest {case} on the card differs "
                                 "from the JAX package's run")
        if n_launch != rec["sweeps_run"] or n_launch < rec["sync_sweeps"]:
            raise AssertionError(f"{case}: expected one kernel launch per "
                                 f"sweep run ({rec['sweeps_run']}), counted "
                                 f"{n_launch}")
    emit({"phase": "fault_digests", "nodes": 256,
          "launches": launches["fault_digests"], "cases": cases})
    return launches["fault_digests"]


def soak_phase(emit) -> tuple:
    """Phase ``soak_10k``: config 0's cluster at 10 000 nodes under
    config 8's four scenarios with the soak CLI's arguments, the
    scorecard and the invariant checker armed on each, each run
    sequential so that its wall is the simulation's alone (the checkers'
    host seconds apart). Each must re-converge with a final gap of 0 and
    identical tables, and lose no row. Returns the merge launches and the
    crash_amnesia run's result."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import (
        CONFIG8_SCENARIOS,
        SOAK_ARGS,
        run_soak,
        soak_config,
    )

    launches = {"soak_10k": 0}
    soaks = {}
    kept = None
    for spec in CONFIG8_SCENARIOS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launch_counts()
        run = run_soak(soak_config(10000), spec, device="cuda",
                       scorecard=True, pipeline=False, **SOAK_ARGS)
        torch.cuda.synchronize()
        n_launch = mk.LAUNCHES["grouped_merge"]
        launches["soak_10k"] += n_launch
        soaks[spec] = rec = soak_record(run, n_launch)
        if spec == "crash_amnesia":
            kept = run.result  # the uninterrupted run "checkpoint_10k"
            # resumes to
        del run
        emit(dict(phase="soak_10k_run", **rec))
        if (rec["converged_round"] is None or rec["final_gap"] != 0.0
                or not rec["tables_agree"] or rec["log_wrapped_max"]):
            raise AssertionError(f"{spec} at 10 000 nodes did not "
                                 "re-converge to identical tables")
        if rec["resilience"]["rows_lost"] != 0:
            raise AssertionError(f"{spec} at 10 000 nodes lost rows")
        if n_launch != rec["sweeps_run"] or n_launch < rec["sync_sweeps"]:
            raise AssertionError(f"{spec} at 10k: expected one kernel "
                                 "launch per sweep run")
    torch.cuda.empty_cache()
    emit({"phase": "soak_10k", "nodes": 10000,
          "launches": launches["soak_10k"],
          "converged_rounds": {k: v["converged_round"]
                               for k, v in soaks.items()},
          "wall_per_round_ms": {k: v["wall_per_round_ms"]
                                for k, v in soaks.items()},
          "check_seconds": {k: v["check_seconds"] for k, v in soaks.items()},
          "invariants_ok": {k: v["invariants"]["ok"]
                            for k, v in soaks.items()}})
    return launches["soak_10k"], kept


def _sweep(plan, **kw) -> tuple:
    """``run_sweep`` of ``plan`` on the card, config 8's arguments, the
    merge launches counted around it; returns ``(result, launches,
    wall_s)``."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import CONFIG8_SWEEP_ARGS
    from corro_sim_torch.sweep.engine import run_sweep

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_sweep(plan, **CONFIG8_SWEEP_ARGS, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mk.LAUNCHES["grouped_merge"]
    committed = sum(int(lr.state.sync_rounds) for lr in res.lanes)
    if launches != res.sweeps["sweeps_run"] or launches < committed:
        raise AssertionError(
            f"sweep: expected one kernel launch per sweep run "
            f"({res.sweeps['sweeps_run']}; {committed} committed), "
            f"counted {launches}")
    return res, launches, wall


def config8_sweep_phase(emit, seeds: int) -> tuple:
    """Phase ``config8_sweep``: config 8's grid exactly (its lane base at
    256 nodes, its four scenarios × ``seeds`` seeds, ``run_sweep`` in
    lockstep with checkers armed), every lane held to the JAX package's
    lane (``SWEEP_PINS``) and the frontier to its digest; the kernel's
    mailbox cap checked against ``sync_mailbox_lanes``; then the four
    seed-0 lanes' serial twins through ``run_soak``, held to
    ``FAULT_PINS`` and to their lanes' rounds. Returns the launches of
    the sweep and of the serial twins."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import (
        CONFIG8_FRONTIERS,
        CONFIG8_SERIAL_CASES,
        config8_plan,
        fault_digest_record,
        fault_digest_run,
        frontier_digest,
        sweep_books,
        sweep_lane_record,
        sync_mailbox_lanes,
    )
    from corro_sim_torch.sweep import build_frontier
    from corro_sim_torch.sync import sync as sync_mod

    plan = config8_plan(range(seeds))
    caps = set()
    merge = sync_mod.merge_grouped

    def spy(table, box, cap):
        caps.add(cap)
        return merge(table, box, cap)

    sync_mod.merge_grouped = spy
    try:
        res, launches, wall = _sweep(plan)
    finally:
        sync_mod.merge_grouped = merge
    lanes = [sweep_lane_record(lr) for lr in res.lanes]
    fd = frontier_digest(build_frontier(res.lanes))
    books = dict(sweep_books(res, wall), launches=launches)
    want_cap = sync_mailbox_lanes(plan.union_cfg)
    by_lane = {rec["lane"]: rec for rec in lanes}
    del res
    torch.cuda.empty_cache()
    serial = {}
    serial_launches = 0
    for case in CONFIG8_SERIAL_CASES:
        mk.reset_launch_counts()
        run = fault_digest_run(case, device="cuda")
        torch.cuda.synchronize()
        n_launch = mk.LAUNCHES["grouped_merge"]
        serial_launches += n_launch
        rec = fault_digest_record(case, run)
        lane = next(r for k, r in by_lane.items()
                    if k.split(":")[0] == case.split(":")[0].split("@")[0]
                    and k.endswith("@0"))
        rec.update(sim_s=run.result.wall_seconds,
                   check_seconds=run.result.check_seconds,
                   sweeps_run=run.result.pipeline["sweeps_run"],
                   launches=n_launch,
                   lane_rounds_equal=(lane["rounds"] == rec["rounds"]
                                      and lane["converged_round"]
                                      == rec["converged_round"]))
        serial[case] = rec
        del run
    emit({"phase": "config8_sweep", "nodes": 256, "seeds": seeds,
          "seeds_note": ("seeds 0-7 (32 lanes), config 8 exactly"
                         if seeds == 8 else
                         f"seeds 0-{seeds - 1} ({4 * seeds} lanes), cut "
                         "from config 8's 8 for the time budget"),
          **books,
          "mailbox_caps": sorted(caps), "want_cap": want_cap,
          "frontier_digest": fd,
          "frontier_match": fd == CONFIG8_FRONTIERS[seeds],
          "lanes_match": sum(r["match"] for r in lanes),
          "lane_records": lanes, "serial_twins": serial,
          "serial_launches": serial_launches})
    bad = [r["lane"] for r in lanes if not r["match"]]
    if bad:
        raise AssertionError(f"config 8 sweep lanes differ from the JAX "
                             f"package's: {bad}")
    if fd != CONFIG8_FRONTIERS[seeds]:
        raise AssertionError("config 8's frontier differs from the JAX "
                             "package's")
    if caps != {want_cap}:
        raise AssertionError(f"the lanes' mailbox caps {sorted(caps)} are "
                             f"not {want_cap}")
    for case, rec in serial.items():
        if not (rec["match"] and rec["lane_rounds_equal"]):
            raise AssertionError(f"serial twin {case} differs from its pin "
                                 "or its lane")
        if rec["launches"] != rec["sweeps_run"]:
            raise AssertionError(f"{case}: expected one kernel launch per "
                                 "sweep run")
    return launches, serial_launches


def config8_compact_phase(emit) -> int:
    """Phase ``config8_compact``: config 8's four scenarios at seed 0
    (4 lanes) through the fleet scheduler (``compact=True``,
    ``width=2``, ``pipeline=True``), every lane held to ``SWEEP_PINS``;
    prints the occupancy curve with its refills. Returns the launches."""
    from corro_sim_torch.profile_slice import (
        config8_plan,
        sweep_books,
        sweep_lane_record,
    )

    plan = config8_plan(range(1))
    res, launches, wall = _sweep(plan, compact=True, width=2,
                                       pipeline=True)
    lanes = [sweep_lane_record(lr) for lr in res.lanes]
    emit({"phase": "config8_compact", "nodes": 256, "seeds": 1,
          "width": 2, **sweep_books(res, wall), "launches": launches,
          "lanes_match": sum(r["match"] for r in lanes),
          "lane_records": lanes})
    bad = [r["lane"] for r in lanes if not r["match"]]
    if bad:
        raise AssertionError(f"compacted config 8 lanes differ from the "
                             f"JAX package's: {bad}")
    if not res.compaction["refills"]:
        raise AssertionError("the compacted sweep refilled no slot")
    return launches


def config8_1024_phase(emit) -> int:
    """Phase ``config8_1024``: config 8's lane base at 1024 nodes (its
    rule gives 256 rows and a SWIM view of 64: windowed SWIM inside the
    lanes) under two of its scenarios at seed 0, lockstep: lossy, and
    churn, whose lane carries the JAX package's SWIM false-DOWNs. Every
    lane must converge with no row lost and the invariant verdict of the
    JAX package's run (``CONFIG8_1024_VIOLATIONS``), and the lossy lane
    equal its serial twin run on the card. Returns the launches of the
    sweep and of the twin."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.faults import InvariantChecker, ResilienceScorecard
    from corro_sim_torch.profile_slice import (
        CONFIG8_1024_CHURN,
        CONFIG8_1024_VIOLATIONS,
        CONFIG8_SCENARIOS,
        CONFIG8_SWEEP_ARGS,
        config8_plan,
        sweep_books,
        twin_match,
    )

    plan = config8_plan([0], n=1024, scenarios=CONFIG8_SCENARIOS[:2])
    if [lane.spec.split(":")[0] for lane in plan.lanes] != ["lossy",
                                                            "churn"]:
        raise AssertionError("config8_1024 expects the lossy and churn "
                             "lanes")
    res, launches, wall = _sweep(plan)
    books = sweep_books(res, wall)
    lanes = {}
    for lr in res.lanes:
        base = lr.spec.split(":")[0]
        viol = [(v["round"], v["invariant"])
                for v in (lr.invariants or {}).get("violations", [])]
        lanes[lr.cell] = d = {
            "rounds": lr.rounds, "converged_round": lr.converged_round,
            "rows_lost": (lr.resilience or {}).get("rows_lost"),
            "invariants_ok": (lr.invariants or {}).get("ok"),
            "violations": viol,
            "swim_false_down": (lr.resilience or {}).get("swim_false_down"),
        }
        d["verdict_match"] = viol == CONFIG8_1024_VIOLATIONS[base]
        if base == "churn":
            d["verdict_match"] &= all(d[k] == v for k, v in
                                      CONFIG8_1024_CHURN.items())
    twins = {}
    for li in (0,):
        lane = plan.lanes[li]
        torch.cuda.empty_cache()
        mk.reset_launch_counts()
        serial = run_sim(
            lane.cfg, init_state(lane.cfg, seed=lane.seed, device="cuda"),
            lane.scenario.schedule(), seed=lane.seed,
            min_rounds=lane.min_rounds, device="cuda",
            invariants=InvariantChecker(lane.cfg),
            scorecard=ResilienceScorecard(lane.cfg, scenario=lane.scenario),
            **CONFIG8_SWEEP_ARGS,
        )
        torch.cuda.synchronize()
        twins[lane.cell] = dict(twin_match(res.lanes[li], serial),
                                sim_s=serial.wall_seconds,
                                launches=mk.LAUNCHES["grouped_merge"])
        launches += twins[lane.cell]["launches"]
        del serial
    emit({"phase": "config8_1024", "nodes": 1024,
          "swim_view_size": plan.union_cfg.swim_view_size,
          "rows": plan.union_cfg.num_rows,
          **books, "launches": launches, "lanes_detail": lanes,
          "twins": twins})
    for cell, d in lanes.items():
        if (d["converged_round"] is None or d["rows_lost"] != 0
                or not d["verdict_match"]):
            raise AssertionError(f"config 8 at 1024 nodes: {cell} did not "
                                 "converge, lost rows or differs from the "
                                 "JAX package's verdict")
    for cell, d in twins.items():
        if not d["match"]:
            raise AssertionError(f"config 8 at 1024 nodes: {cell} differs "
                                 "from its serial twin")
    del res
    torch.cuda.empty_cache()
    return launches


class _Kill(Exception):
    """Raised from ``on_chunk``: the in-process stand-in for a lost
    device."""


def checkpoint_phase(emit, soak_ref) -> int:
    """Phase ``checkpoint_10k``: config 0 at 10 000 nodes under
    crash_amnesia with the soak's arguments, pipelined, a token written
    after every chunk; killed from ``on_chunk`` after chunk 1 (chunk 0's
    token on disk), then resumed from the token. Its state and every
    metric must equal the uninterrupted run of "soak_10k" (``soak_ref``;
    the two loops give the same run). Prints the token's bytes and its
    save, load and install seconds. Then the JAX package's committed
    token (``TOKEN_FIXTURE``) resumes on the card to its pin. Returns
    the launches."""
    import os

    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.io.checkpoint import load_sim_checkpoint
    from corro_sim_torch.profile_slice import (
        DIGESTS,
        SOAK_ARGS,
        TOKEN_FIXTURE,
        TOKEN_ROUNDS,
        run_digest,
        run_soak,
        soak_config,
        token_case,
    )
    from corro_sim_torch.utils.metrics import histograms

    spec = "crash_amnesia"
    os.makedirs("bench_out", exist_ok=True)
    path = os.path.join("bench_out", "checkpoint_10k.npz")
    hist = "corro_soak_checkpoint_seconds"
    h = histograms.get(hist)
    saves0 = (h.count, h.sum) if h is not None else (0, 0.0)

    def bomb(info):
        if info["chunk"] >= 1:
            raise _Kill

    launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        run_soak(soak_config(10000), spec, device="cuda", invariants=False,
                 scorecard=False, pipeline=True, checkpoint_path=path,
                 checkpoint_every=1, on_chunk=bomb, **SOAK_ARGS)
        raise AssertionError("the checkpointed run was not killed")
    except _Kill:
        pass
    killed_s = time.perf_counter() - t0
    launches += mk.LAUNCHES["grouped_merge"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    h = histograms.get(hist)
    saves = (h.count - saves0[0], h.sum - saves0[1])
    token_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    ck = load_sim_checkpoint(path)
    load_s = time.perf_counter() - t0
    cfg = ck.cfg
    t0 = time.perf_counter()
    probe = ck.install_state(init_state(cfg, seed=0, device="cuda"))
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    del probe
    torch.cuda.empty_cache()
    mk.reset_launch_counts()
    run = run_soak(soak_config(10000), spec, device="cuda",
                   invariants=False, scorecard=False, pipeline=True,
                   resume=ck, **SOAK_ARGS)
    torch.cuda.synchronize()
    launches += mk.LAUNCHES["grouped_merge"]
    res = run.result
    peak = torch.cuda.max_memory_allocated()
    ref_leaves = state_to_numpy(soak_ref.state)
    got_leaves = state_to_numpy(res.state)
    same_leaves = (set(ref_leaves) == set(got_leaves) and all(
        np.array_equal(got_leaves[k], v) for k, v in ref_leaves.items()))
    del ref_leaves, got_leaves
    same_metrics = (set(res.metrics) == set(soak_ref.metrics) and all(
        np.array_equal(res.metrics[k], v)
        for k, v in soak_ref.metrics.items()))
    rec = {"nodes": 10000, "scenario": run.scenario.spec,
           "token_bytes": token_bytes, "token_rounds": ck.rounds,
           "next_chunk": ck.next_chunk, "saves": saves[0],
           "save_s": saves[1], "load_s": load_s, "install_s": install_s,
           "killed_run_s": killed_s, "rounds": res.rounds,
           "converged_round": res.converged_round,
           "want": [soak_ref.rounds, soak_ref.converged_round],
           "resumed_sim_s": res.wall_seconds, "leaves_equal": same_leaves,
           "metrics_equal": same_metrics, "max_memory_allocated": peak}
    del run, res, ck
    os.remove(path)
    torch.cuda.empty_cache()

    # the JAX package's token, resumed on the card
    mk.reset_launch_counts()
    tok = load_sim_checkpoint(TOKEN_FIXTURE)
    tcfg, sched, kw = token_case(device="cuda")
    tres = run_sim(tcfg, init_state(tcfg, seed=0, device="cuda"), sched,
                   resume=tok, **kw)
    torch.cuda.synchronize()
    launches += mk.LAUNCHES["grouped_merge"]
    tdigest = run_digest(state_to_numpy(tres.state), tres.metrics)
    rec["jax_token"] = {
        "path": TOKEN_FIXTURE, "nodes": tcfg.num_nodes,
        "resumed_at_round": tok.rounds,
        "rounds": [tres.rounds, tres.converged_round],
        "want_rounds": list(TOKEN_ROUNDS), "digest": tdigest,
        "match": (tdigest == DIGESTS["token_jax_64"]
                  and (tres.rounds, tres.converged_round) == TOKEN_ROUNDS),
    }
    emit({"phase": "checkpoint_10k", "launches": launches, **rec})
    if not (same_leaves and same_metrics
            and rec["rounds"] == soak_ref.rounds
            and rec["converged_round"] == soak_ref.converged_round):
        raise AssertionError("the resumed 10k soak differs from the "
                             "uninterrupted run")
    if not rec["jax_token"]["match"]:
        raise AssertionError("the JAX package's token resumed on the card "
                             "misses its pin")
    return launches


def _forecast(tok, emit_kw: dict, grid: dict) -> dict:
    """``run_forecast`` of the twin ``grid`` (``TWIN_FORECAST`` or its
    10k form) from ``tok`` on the card, the merge launches counted into
    ``emit_kw``."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine.twin import run_forecast
    from corro_sim_torch.profile_slice import TWIN_THRESHOLDS

    kw = dict(grid)
    scenarios, seeds = kw.pop("scenarios"), kw.pop("seeds")
    mk.reset_launch_counts()
    fc = run_forecast(tok, scenarios, seeds, thresholds=TWIN_THRESHOLDS,
                      device="cuda", **kw)
    torch.cuda.synchronize()
    sweep = fc["sweep"]
    emit_kw.update(
        forecast_launches=mk.LAUNCHES["grouped_merge"],
        forecast_ok=fc["ok"], forecast_lanes=fc["lanes"],
        forecast_wall_s=sweep.wall_seconds,
        clusters_per_second_per_device=(
            sweep.clusters_per_second_per_device),
        lanes_detail=[dict({k: d[k] for k in (
            "scenario", "seed", "converged_round", "rounds_run",
            "recovery_rounds", "rows_lost", "invariants_ok")},
            violations=sorted({v["invariant"] for v in (
                lr.invariants or {}).get("violations", [])}))
            for d, lr in zip(fc["lanes_detail"], sweep.lanes)])
    return fc


def twin_digest_phase(emit) -> int:
    """Phase ``twin_digests``: a seeded Consul-schema feed
    (``TWIN_DIGEST_FEED``: 64 actors, 16 versions, hostile lines)
    shadowed at 256 nodes with a cursor token every chunk, killed after
    chunk 1 (the token of chunk 0's boundary on disk) and resumed from
    that token; the resumed shadow equals the JAX package's uninterrupted
    one (``TWIN_PINS["twin_digests"]["shadow"]``: state, metrics,
    headlines, report). Then the forecast grid from the fork of the
    shadow: the frontier, the trend and each lane equal the JAX
    package's. Returns the merge launches."""
    import os

    import torch

    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine.twin import fork_twin, run_twin
    from corro_sim_torch.io.checkpoint import load_sim_checkpoint
    from corro_sim_torch.profile_slice import (
        TWIN_DIGEST_CHUNK,
        TWIN_DIGEST_FEED,
        TWIN_DIGEST_NODES,
        TWIN_FORECAST,
        TWIN_PINS,
        feed_config,
        twin_feed,
        twin_forecast_record,
        twin_shadow_record,
    )

    pins = TWIN_PINS["twin_digests"]
    os.makedirs("bench_out", exist_ok=True)
    ckpt = os.path.join("bench_out", "twin_digests.npz")
    feed = twin_feed(**TWIN_DIGEST_FEED)
    cfg = feed_config(feed.lines, TWIN_DIGEST_NODES, TWIN_DIGEST_CHUNK)

    def bomb(headline):
        if headline["chunk"] >= 1:
            raise _Kill

    torch.cuda.empty_cache()
    mk.reset_launch_counts()
    try:
        run_twin(cfg=cfg, lines=feed.lines, seed=0, checkpoint_path=ckpt,
                 on_chunk=bomb, device="cuda")
        raise AssertionError("the checkpointed shadow was not killed")
    except _Kill:
        pass
    tok = load_sim_checkpoint(ckpt)
    resumed = run_twin(cfg=cfg, lines=feed.lines, seed=0, resume=tok,
                       device="cuda")
    launches = mk.LAUNCHES["grouped_merge"]
    got = twin_shadow_record(state_to_numpy(resumed.state), resumed)
    rec = {"nodes": cfg.num_nodes, "actors": resumed.universe.num_actors,
           "cells": cfg.num_rows * cfg.num_cols,
           "lines": len(feed.lines), "resumed_at_round": tok.rounds,
           "resumed_at_chunk": tok.meta["twin"]["chunk_index"],
           "bad_by_reason": resumed.report["bad_by_reason"],
           "late_clears": resumed.report["late_clears"],
           "late_applied": resumed.report["late_applied"],
           "shadow_launches": launches,
           "shadow_wall_s": resumed.wall_seconds,
           "host_reads": resumed.host_reads,
           "shadow": dict(got, match=(got == pins["shadow"]))}
    path = os.path.join("bench_out", "twin_digests.fork.npz")
    fork = fork_twin(resumed, path, chunk=TWIN_FORECAST["chunk"])
    del resumed
    fc = _forecast(fork, rec, TWIN_FORECAST)
    got = twin_forecast_record(fc, fork.path, [
        (lr.spec, lr.seed, state_to_numpy(lr.state), lr.metrics)
        for lr in fc["sweep"].lanes])
    rec.update(frontier_match=got["frontier"] == pins["frontier"],
               trend_match=got["trend"] == pins["trend"],
               lanes_match={k: v == pins["lanes"].get(k)
                            for k, v in got["lanes"].items()})
    launches += rec["forecast_launches"]
    del fc
    for f in (ckpt, path):
        os.remove(f)
    torch.cuda.empty_cache()
    emit({"phase": "twin_digests", "launches": launches, **rec})
    if not rec["shadow"]["match"]:
        raise AssertionError("twin_digests: the resumed shadow differs from "
                             "the JAX package's")
    if rec["resumed_at_chunk"] != 1 or not 0 < tok.rounds:
        raise AssertionError("twin_digests: the token is not the cursor of "
                             "chunk 0's boundary")
    if not (rec["frontier_match"] and rec["trend_match"]
            and len(rec["lanes_match"]) == 4
            and all(rec["lanes_match"].values())):
        raise AssertionError("twin_digests: the forecast differs from the "
                             "JAX package's")
    if rec["bad_by_reason"] != feed.expected_bad(TWIN_DIGEST_CHUNK):
        raise AssertionError("twin_digests: the quarantine tallies differ "
                             "from the feed's hostile lines")
    return launches


def twin_10k_phase(emit) -> int:
    """Phase ``twin_10k``: the Consul-schema feed ``TWIN_10K_FEED`` (128
    actors × 24 versions over both tables' 512 rows × 6 columns, Zipf
    1.1, 1-4 cells, conflicts, EmptySets, deletes and about 0.5 %
    hostile lines) shadowed at 10 000 nodes with config 3's protocol
    knobs, chunks of 2048 lines, quarantine on. The shadow must
    converge with a final gap of 0, quarantine exactly the feed's
    hostile lines, hold one table on every node, and decode node 0's to
    the JAX package's table for the same feed (``TWIN_PINS``), with the
    merge kernel launched. Then the forecast grid from its fork at
    10 000 nodes (``TWIN_10K_FORECAST``: chunks of 16 rounds), one lane
    held leaf for leaf to its serial ``run_sim`` resumed from the fork
    token. Prints the host seconds of the scan,
    ``probe_feed_heads``, ``validate_feed`` and the per-chunk encode,
    the wall and host reads per round, the late clears and refreshes,
    the forecast's clusters per second per device and the peak memory.
    Returns the merge launches."""
    import os

    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.replay import read_table
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.twin import (
        fork_twin,
        probe_feed_heads,
        run_twin,
        twin_universe,
    )
    from corro_sim_torch.faults import InvariantChecker, ResilienceScorecard
    from corro_sim_torch.io.traces import validate_feed
    from corro_sim_torch.profile_slice import (
        TWIN_10K_CHUNK,
        TWIN_10K_FEED,
        TWIN_10K_FORECAST,
        TWIN_PINS,
        table_digest,
        twin_config,
        twin_feed,
        twin_match,
        universe_view,
    )

    pins = TWIN_PINS["twin_10k"]
    secs = {}
    t0 = time.perf_counter()
    feed = twin_feed(**TWIN_10K_FEED)
    secs["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    uni = twin_universe(feed.lines, 0)
    secs["scan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    heads = probe_feed_heads(feed.lines, uni)
    secs["probe_feed_heads"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bad = validate_feed(feed.lines, uni, chunk_lines=TWIN_10K_CHUNK)
    secs["validate_feed"] = time.perf_counter() - t0
    cfg = twin_config(uni, heads, 10000, TWIN_10K_CHUNK)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_twin(cfg=cfg, lines=feed.lines, seed=0, universe=uni,
                   device="cuda")
    torch.cuda.synchronize()
    secs["run_twin_call"] = time.perf_counter() - t0
    launches = mk.LAUNCHES["grouped_merge"]
    peak = torch.cuda.max_memory_allocated()
    chunks = res.report["chunks"]
    t0 = time.perf_counter()
    table = read_table(res.state, universe_view(res.universe), 0)
    secs["read_table"] = time.perf_counter() - t0
    rep = res.report
    rec = {"nodes": cfg.num_nodes, "actors": uni.num_actors,
           "rows": cfg.num_rows, "cols": cfg.num_cols,
           "log_capacity": cfg.log_capacity, "lines": len(feed.lines),
           "hostile": len(feed.malformed) + len(feed.copies),
           "empties": feed.empties, "deletes": feed.deletes,
           "validate_bad": len(bad), "rounds": res.rounds,
           "feed_rounds": res.feed_rounds,
           "converged_round": res.converged_round,
           "final_gap": rep["final_gap"], "chunks": chunks,
           "bad_by_reason": rep["bad_by_reason"],
           "late_clears": rep["late_clears"],
           "late_applied": rep["late_applied"],
           "changes_applied": rep["changes_applied"],
           "shadow_delivery": rep["shadow_delivery"],
           "tables_agree": tables_agree(res.state.table),
           "live_rows": len(table), "table": table_digest(table),
           "table_match": table_digest(table) == pins["table"],
           "shadow_launches": launches,
           "sync_sweeps": int(res.state.sync_rounds),
           "host_seconds": dict(secs, **{
               f"run_{k}": v for k, v in res.seconds.items()}),
           "encode_s_per_chunk": res.seconds["feed"] / max(chunks, 1),
           "shadow_wall_s": res.wall_seconds,
           "wall_per_round_ms": 1000.0 * res.wall_seconds / res.rounds,
           "host_reads_per_round": res.host_reads / res.rounds,
           "max_memory_allocated": peak}
    os.makedirs("bench_out", exist_ok=True)
    path = os.path.join("bench_out", "twin_10k.fork.npz")
    t0 = time.perf_counter()
    tok = fork_twin(res, path, chunk=TWIN_10K_FORECAST["chunk"])
    rec["fork_s"] = time.perf_counter() - t0
    del res
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fc = _forecast(tok, rec, TWIN_10K_FORECAST)
    rec["forecast_call_s"] = time.perf_counter() - t0
    launches += rec["forecast_launches"]
    # one lane against its serial run resumed from the fork token
    plan_lanes = fc["sweep"].lanes
    lr = next(x for x in plan_lanes if x.spec.startswith("lossy")
              and x.seed == 0)
    from corro_sim_torch.config import FaultConfig, NodeFaultConfig
    from corro_sim_torch.sweep.plan import build_plan

    kw = dict(TWIN_10K_FORECAST)
    base = dataclasses.replace(
        tok.cfg, faults=FaultConfig(), node_faults=NodeFaultConfig(),
        write_rate=0.0).validate()
    plan = build_plan(base, kw["scenarios"], kw["seeds"],
                      rounds=kw["rounds"], write_rounds=0, fork=tok)
    lane = plan.lanes[lr.index]
    for other in plan_lanes:
        if other is not lr:
            other.state = None
    torch.cuda.empty_cache()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    serial = run_sim(
        lane.cfg, init_state(lane.cfg, seed=lane.seed, device="cuda"),
        lane.scenario.schedule(), max_rounds=kw["max_rounds"],
        chunk=kw["chunk"], seed=lane.seed, min_rounds=lane.min_rounds,
        device="cuda",
        invariants=InvariantChecker(lane.cfg, round_offset=plan.fork_round),
        scorecard=ResilienceScorecard(lane.cfg, scenario=lane.scenario,
                                      round_offset=plan.fork_round),
        resume=tok.refit(lane.cfg, lane.seed, kw["chunk"]))
    torch.cuda.synchronize()
    rec["serial_call_s"] = time.perf_counter() - t0
    launches += mk.LAUNCHES["grouped_merge"]
    rec["serial_lane"] = dict(twin_match(lr, serial),
                              lane=f"{lane.spec}@{lane.seed}",
                              sim_s=serial.wall_seconds,
                              resilience_equal=(serial.resilience
                                                == lr.resilience))
    del fc, serial, lr, plan_lanes
    os.remove(path)
    torch.cuda.empty_cache()
    emit({"phase": "twin_10k", "launches": launches, **rec})
    if (rec["converged_round"] is None or rec["final_gap"] != 0.0
            or not rec["tables_agree"]):
        raise AssertionError("twin_10k: the shadow did not converge to one "
                             "table on every node")
    if rec["bad_by_reason"] != feed.expected_bad(TWIN_10K_CHUNK):
        raise AssertionError("twin_10k: the quarantine tallies differ from "
                             "the feed's hostile lines")
    if not rec["table_match"] or rec["live_rows"] != pins["live_rows"]:
        raise AssertionError("twin_10k: node 0's table differs from the JAX "
                             "package's")
    if rec["shadow_launches"] == 0 or rec["shadow_launches"] != (
            rec["sync_sweeps"]):
        raise AssertionError("twin_10k: expected one merge launch per sync "
                             "sweep")
    if not all(d["converged_round"] is not None and d["rows_lost"] == 0
               for d in rec["lanes_detail"]):
        raise AssertionError("twin_10k: a forecast lane did not converge "
                             "or lost a row")
    if not (rec["serial_lane"]["match"]
            and rec["serial_lane"]["resilience_equal"]):
        raise AssertionError("twin_10k: the forecast lane differs from its "
                             "serial fork resume")
    return launches


def subs_tables(n: int) -> tuple:
    """The subscription phases' table: ``SUBS_FEED`` without its hostile
    lines, ingested against the Consul schema and replayed at ``n``
    nodes on the card, cut after ``SUBS_CUT_ROUNDS`` rounds and to
    convergence. Returns the layout, the trace, the two replay results
    (their states cut down to the table), the host seconds and the merge
    launches of the replays."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine.replay import replay
    from corro_sim_torch.io.traces import ingest
    from corro_sim_torch.profile_slice import (
        SUBS_CUT_ROUNDS,
        SUBS_FEED,
        SUBS_MAX_ROUNDS,
        subs_capacities,
        subs_lines,
        twin_feed,
    )
    from corro_sim_torch.schema import (
        TableLayout,
        consul_schema_sql,
        parse_and_constrain,
    )

    secs = {}
    t0 = time.perf_counter()
    lines = subs_lines(twin_feed(**SUBS_FEED))
    lay = TableLayout(parse_and_constrain(consul_schema_sql()),
                      capacities=subs_capacities(SUBS_FEED["keys"]))
    tr = ingest(lines, layout=lay)
    secs["ingest"] = time.perf_counter() - t0
    cfg = tr.suggest_config(num_nodes=n)
    mk.reset_launch_counts()
    out = []
    for label, rounds in (("cut", SUBS_CUT_ROUNDS),
                          ("full", SUBS_MAX_ROUNDS)):
        t0 = time.perf_counter()
        res = replay(tr, cfg, max_rounds=rounds, device="cuda")
        torch.cuda.synchronize()
        secs[f"replay_{label}"] = time.perf_counter() - t0
        res.state = types.SimpleNamespace(table=res.state.table,
                                          sync_rounds=res.state.sync_rounds)
        torch.cuda.empty_cache()
        out.append(res)
    return lay, tr, out[0], out[1], secs, mk.LAUNCHES["grouped_merge"]


def subs_digest_phase(emit) -> int:
    """Phase ``subs_digests``: the subscription population at
    ``SUBS_PIN_NODES`` nodes — 64 matchers (32 queries × 2 observers)
    registered by 1024 subscribers through ``SubsManager.get_or_insert``
    on the cut table, then one step on the converged table — its initial
    and step events held to the JAX package's (``SUBS_PINS``), with the
    replays' rounds and the merge kernel launched. Returns the merge
    launches."""
    from corro_sim_torch import subs
    from corro_sim_torch.profile_slice import (
        SUBS_FEED,
        SUBS_PIN_NODES,
        SUBS_PINS,
        SUBS_SEED,
        subs_drive,
        subs_queries,
        subs_record,
        subs_subscribers,
    )

    lay, tr, cut, full, secs, launches = subs_tables(SUBS_PIN_NODES)
    subscribers = subs_subscribers(
        subs_queries(SUBS_SEED, SUBS_PIN_NODES, SUBS_FEED["keys"]),
        SUBS_SEED)
    run = subs_drive(subs, lay, tr, cut.state.table, full.state.table,
                     subscribers)
    got = dict(subs_record(run), cut_rounds=cut.rounds,
               converged_round=full.converged_round)
    pins = SUBS_PINS["subs_digests"]
    rec = {"nodes": SUBS_PIN_NODES, "subscribers": len(subscribers),
           **got, "match": {k: got[k] == v for k, v in pins.items()
                            if k in got},
           "sync_sweeps": int(full.state.sync_rounds),
           "host_seconds": dict(secs, prime=run["prime_s"],
                                step=run["step_s"])}
    emit({"phase": "subs_digests", "launches": launches, **rec})
    if not all(rec["match"].values()):
        raise AssertionError("subs_digests: the events differ from the JAX "
                             "package's")
    if launches == 0:
        raise AssertionError("subs_digests: the replays launched no merge")
    return launches


def subs_10k_phase(emit) -> int:
    """Phase ``subs_10k``: the same population at 10 000 nodes, observers
    spread over all of them. The replays of the table (cut and to
    convergence) launch the merge kernel on their sync sweeps. Checks:
    ``SubsManager(batch=True)`` and ``batch=False`` give identical
    events; every plain matcher's mask on both tables equals the host
    SQL oracle (``eval_predicate_py`` over its observer's decoded cells);
    at convergence the matchers of one query hold the same rows on every
    observer. Prints the host seconds of the replays, of the prime and of
    the step, batched and single (a first step, then a repeat on the same
    table), the group dispatches and the host syncs of the repeat step
    (its device→host reads and the groups' uploads), the rows matched,
    the merge launches and the peak memory. Returns the merge
    launches."""
    import warnings

    import torch

    from corro_sim_torch import subs
    from corro_sim_torch.profile_slice import (
        SUBS_FEED,
        SUBS_SEED,
        subs_disagreements,
        subs_drive,
        subs_oracle_mismatches,
        subs_queries,
        subs_record,
        subs_subscribers,
        subs_views,
    )
    from corro_sim_torch.utils.metrics import (
        SUBS_BATCH_GROUPS_TOTAL,
        counters,
    )

    n = 10000
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lay, tr, cut, full, secs, launches = subs_tables(n)
    subscribers = subs_subscribers(
        subs_queries(SUBS_SEED, n, SUBS_FEED["keys"]), SUBS_SEED)
    runs, steps = {}, {}
    for mode, batch in (("batched", True), ("single", False)):
        runs[mode] = run = subs_drive(subs, lay, tr, cut.state.table,
                                      full.state.table, subscribers,
                                      batch=batch)
        mgr = run["manager"]
        # a repeat step on the same table (no events): the card's sync
        # debug mode warns at every host wait — one per device→host read
        # of an evaluation (one per group, one per single matcher) and
        # one per group's host→device copy of its inputs
        groups0 = counters.get(SUBS_BATCH_GROUPS_TOTAL)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                again = mgr.step(full.state.table)
                repeat_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        steps[mode] = {
            "prime_s": run["prime_s"], "step_s": run["step_s"],
            "repeat_step_s": repeat_s,
            "group_dispatches_per_step": (
                counters.get(SUBS_BATCH_GROUPS_TOTAL) - groups0),
            "host_syncs_per_step": sum(
                "synchroniz" in str(w.message) for w in caught),
            "repeat_events": sum(len(v) for v in again.values()),
        }
    b, s = runs["batched"], runs["single"]
    identical = (subs_record(b) == subs_record(s)
                 and b["initial"] == s["initial"]
                 and {k: [vars(e) for e in v] for k, v in b["events"].items()}
                 == {k: [vars(e) for e in v] for k, v in s["events"].items()})
    t0 = time.perf_counter()
    oracle = {"cut": subs_oracle_mismatches(b["manager"], cut.state.table),
              "full": subs_oracle_mismatches(b["manager"], full.state.table)}
    oracle_s = time.perf_counter() - t0
    disagree = subs_disagreements(b)
    views = subs_views(b)
    rec = {"nodes": n, "subscribers": len(subscribers),
           "observers": len({node for _, node in subscribers}),
           **subs_record(b),
           "cut_rounds": cut.rounds, "converged_round": full.converged_round,
           "tables_agree": tables_agree(full.state.table),
           "sync_sweeps": int(full.state.sync_rounds),
           "rows_matched_after_step": sum(len(v) for v in views.values()),
           "batched_equals_single": identical,
           "oracle_mismatches": oracle, "oracle_s": oracle_s,
           "disagreeing_queries": disagree, "steps": steps,
           "host_seconds": secs,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del runs, b, s, cut, full
    torch.cuda.empty_cache()
    emit({"phase": "subs_10k", "launches": launches, **rec})
    if rec["converged_round"] is None or not rec["tables_agree"]:
        raise AssertionError("subs_10k: the replay did not converge")
    if not identical:
        raise AssertionError("subs_10k: batched and single evaluation "
                             "differ")
    if oracle["cut"] or oracle["full"]:
        raise AssertionError("subs_10k: a matcher's mask differs from the "
                             "host SQL oracle")
    if disagree:
        raise AssertionError("subs_10k: observers of one query disagree at "
                             "convergence")
    if launches == 0 or rec["matchers"] != 64 or rec["subscribers"] != 1024:
        raise AssertionError("subs_10k: no merge launch, or not config 6's "
                             "population")
    return launches


def drive(cfg, schedule=None, run_args=None, workload=None, prepare=None,
          **kw):
    """One seeded run of the cell on the card (to convergence, under the
    slice's schedule and arguments by default), the merge kernel's launch
    count read around it; returns the run's JSON record and result.
    ``prepare``: called on the initial state before the run."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.profile_slice import RUN_ARGS, slice_schedule

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, seed=0, device="cuda")
    if prepare is not None:
        prepare(state)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mk.reset_launch_counts()
    res = run_sim(cfg, state, schedule or slice_schedule(),
                  device="cuda", workload=workload,
                  **(RUN_ARGS if run_args is None else run_args), **kw)
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    del state
    uniform = tables_agree(res.state.table)
    rec = {"nodes": cfg.num_nodes, "cells": cfg.num_rows * cfg.num_cols,
           "rounds_to_convergence": res.converged_round,
           "rounds_run": res.rounds, "repair_chunks": res.repair_chunks,
           "final_gap": float(res.metrics["gap"][-1]),
           "sync_sweeps": int(res.state.sync_rounds),
           "sweeps_run": res.pipeline["sweeps_run"],
           "writes": int(res.metrics["writes"].sum()),
           "deletes": int(res.metrics["deletes"].sum()),
           "log_wrapped_max": int(res.metrics["log_wrapped"].max()),
           "setup_s": init_s + res.setup_seconds,
           "sim_s": res.wall_seconds,
           "wall_per_round_ms": res.wall_per_round_ms,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "tables_agree": uniform, "launches": launches,
           "pipeline": res.pipeline}
    return rec, res


def one_launch_per_sweep(label, rec):
    """Each sweep run launches the kernel once: the committed sweeps
    and those of the rounds a discarded speculative chunk queued."""
    sweeps, run = rec["sync_sweeps"], rec["sweeps_run"]
    got = rec["launches"]["grouped_merge"]
    if got != run or sweeps == 0 or run < sweeps:
        raise AssertionError(
            f"{label}: expected one kernel launch per sweep run ({run}; "
            f"{sweeps} committed), counted {got}")


def check_run(label, rec, want_round):
    if rec["rounds_to_convergence"] is None or rec["final_gap"] != 0.0:
        raise AssertionError(f"the {label} did not converge")
    if rec["rounds_to_convergence"] != want_round:
        raise AssertionError(
            f"the {label} converged at round "
            f"{rec['rounds_to_convergence']}, not {want_round}: the "
            "port is deterministic, so its trajectory changed")
    if not rec["tables_agree"]:
        raise AssertionError(f"converged replicas of the {label} hold "
                             "different tables")
    one_launch_per_sweep(label, rec)


@contextlib.contextmanager
def call_events(mod, name: str):
    """Bracket each call of ``mod.name`` with CUDA events, without a host
    sync; yields the list of ``(start, end)`` event pairs, readable once
    the device has run them."""
    import torch

    fn = getattr(mod, name)
    pairs = []

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a, **kw)
        end.record()
        pairs.append((start, end))
        return out

    setattr(mod, name, timed)
    try:
        yield pairs
    finally:
        setattr(mod, name, fn)


def event_ms(pairs) -> list:
    return [a.elapsed_time(b) for a, b in pairs]


def probe_checks(cfg, trace) -> dict:
    """The probe trace against the gossip bounds (the JAX package's
    tests/test_probes.py checks): each probe whose origin wrote its
    version is held by every node; hop >= the BFS hop count over the
    ground-truth adjacency (stretch >= 1); every gossip infector held the
    version no later than the node it infected, one hop closer to the
    origin (hop + 1, saturating at the int8 plane's 127)."""
    from corro_sim_torch.obs.probes import ground_truth_adjacency

    n = cfg.num_nodes
    t0 = time.perf_counter()
    adj = ground_truth_adjacency(np.ones(n, bool), np.zeros(n, np.int32))
    report = trace.report(adj)
    report_s = time.perf_counter() - t0
    origins = [k for k in range(trace.num_probes)
               if trace.origin_round(k) is not None]
    causal = True
    edges = 0
    for k in origins:
        inf, seen, hop = (trace.infector[k], trace.first_seen[k],
                          trace.hop[k].astype(np.int32))
        g = inf >= 0
        par = inf[g]
        edges += int(g.sum())
        causal &= bool((seen[par] >= 0).all() and (seen[par] <= seen[g]).all()
                       and (hop[g] == np.minimum(np.maximum(hop[par], 0) + 1,
                                                 127)).all())
    stretch = [s["stretch"]["min"] for s in report["summaries"]
               if "stretch" in s]
    return {
        "probes": trace.num_probes, "origins": len(origins),
        "all_seen": all(bool((trace.first_seen[k] >= 0).all())
                        for k in origins),
        "gossip_edges": edges, "causal": causal,
        "stretch_min": min(stretch) if stretch else None,
        "sync_joins": sum(s["sync_joins"] for s in report["summaries"]),
        "delivery_p99": trace.delivery_p99(),
        "hop_max": max((s["hop_max"] or 0) for s in report["summaries"]),
        "report_s": report_s,
    }


def latency_phase(emit) -> int:
    """Phase ``latency_10k``: config 0 at 10 000 nodes across four
    latency regions (``inflight_slots`` 3), RTT rings recomputed every 8
    rounds and 8 probes aimed at actors that write, to convergence. Gap 0
    and identical tables; the probe trees against the gossip bounds; every
    observed RTT equal to the link delay (1 within a region, 4 across);
    ring-0 moved off its seeded table; one merge launch per sweep. Prints
    the ring recompute's device ms per call inside the run and the probe
    extraction's host seconds. Returns the merge launches."""
    import torch

    from corro_sim_torch.engine import step as step_mod
    from corro_sim_torch.engine.state import _ring0
    from corro_sim_torch.obs.probes import ProbeTrace
    from corro_sim_torch.profile_slice import (
        RUN_ARGS,
        aim_probes,
        latency_config,
        launches_per_round,
        slice_config,
        slice_schedule,
        writing_actors,
    )

    cfg = latency_config(10000)
    actors = writing_actors(cfg, slice_schedule(), RUN_ARGS["chunk"])
    with call_events(step_mod, "recompute_ring0") as ring_ev:
        rec, res = drive(cfg, prepare=lambda st: aim_probes(st, actors))
    torch.cuda.synchronize()
    ring_ms = event_ms(ring_ev)
    st = res.state
    t0 = time.perf_counter()
    p99 = ProbeTrace.from_state(cfg, st).delivery_p99()
    extract_s = time.perf_counter() - t0
    probes = probe_checks(cfg, res.probe)
    region = torch.arange(cfg.num_nodes, device=st.rtt.device) * 4 // (
        cfg.num_nodes)
    same = region[:, None] == region[None, :]
    one, four = (torch.tensor(v, dtype=torch.uint8, device=st.rtt.device)
                 for v in (1, 4))
    observed = st.rtt != 255
    rtt_ok = bool(((~observed) | (st.rtt == torch.where(same, one, four)))
                  .all())
    rtt_obs = {"intra": int((observed & same).sum()),
               "inter": int((observed & ~same).sum())}
    ring_moved = not torch.equal(st.ring0.cpu(),
                                 torch.as_tensor(_ring0(cfg, 0)))
    m = res.metrics
    del res, st, same, observed
    torch.cuda.empty_cache()
    # launches per round against the fault-free config 0, first 16 rounds
    launches = {name: launches_per_round(c, slice_schedule())
                for name, c in (("latency", cfg),
                                ("config0", slice_config(swim=True)))}
    torch.cuda.empty_cache()
    emit(dict(phase="latency_10k", latency_regions=cfg.latency_regions,
              latency_inter=cfg.latency_inter,
              inflight_slots=cfg.inflight_slots,
              ring_update_interval=cfg.ring_update_interval,
              probe_actors=actors.size, probe_checks=probes,
              probe_extract_s=extract_s, probe_extract_p99=p99,
              probe_infected_final=int(m["probe_infected"][-1]),
              ring_recompute_ms=ring_ms, launches_per_round=launches,
              rtt_observed=rtt_obs,
              rtt_equal_link_delay=rtt_ok, ring0_moved=ring_moved,
              **rec))
    if (rec["rounds_to_convergence"] is None or rec["final_gap"] != 0.0
            or not rec["tables_agree"] or rec["log_wrapped_max"]):
        raise AssertionError("config 0 across four regions at 10k did not "
                             "converge to identical tables")
    if not (probes["origins"] and probes["all_seen"] and probes["causal"]
            and probes["stretch_min"] is not None
            and probes["stretch_min"] >= 1.0):
        raise AssertionError("the probe trace at 10k breaks a gossip bound")
    if not (rtt_ok and rtt_obs["intra"] and rtt_obs["inter"] and ring_moved
            and ring_ms):
        raise AssertionError("the RTT plane or ring-0 at 10k is wrong")
    one_launch_per_sweep("config 0 across four regions at 10k", rec)
    return rec["launches"]["grouped_merge"]


def legacy_phase(emit) -> int:
    """Phase ``legacy_sync_10k``: config 0 at 10 000 nodes on the legacy
    full-axis sync schedule, with the exact argmax and with two deal
    probes, each to convergence with gap 0 and identical tables and one
    merge launch per sweep; prints each sweep's device ms inside the
    run. Returns the merge launches."""
    import torch

    from corro_sim_torch.engine import step as step_mod
    from corro_sim_torch.profile_slice import legacy_config

    runs = {}
    launches = 0
    for deal in (0, 2):
        cfg = legacy_config(10000, deal)
        with call_events(step_mod, "sync_round") as ev:
            rec, res = drive(cfg)
        torch.cuda.synchronize()
        del res
        torch.cuda.empty_cache()
        sweep_ms = event_ms(ev)
        label = "deal_probes_2" if deal else "argmax"
        runs[label] = dict(rec, sweep_ms=sweep_ms,
                           sweep_ms_median=float(np.median(sweep_ms)))
        if (rec["rounds_to_convergence"] is None or rec["final_gap"] != 0.0
                or not rec["tables_agree"] or rec["log_wrapped_max"]):
            raise AssertionError(f"config 0 on the legacy schedule "
                                 f"({label}) at 10k did not converge")
        one_launch_per_sweep(f"legacy schedule ({label}) at 10k", rec)
        launches += rec["launches"]["grouped_merge"]
    emit({"phase": "legacy_sync_10k", "nodes": 10000, "runs": runs})
    return launches


def slice8_digest_phase(emit) -> int:
    """Phase ``slice8_digests``: the latency shape and the two legacy
    shapes at 256 and 1000 nodes, each to convergence, held to the JAX
    package's digest (every state leaf, the RTT plane, the in-flight
    ring, ring-0 and the probe planes among them, and every metric) and
    converged round. Returns the merge launches."""
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.profile_slice import (
        DIGESTS,
        SLICE8_DIGEST_CASES,
        SLICE8_ROUNDS,
        run_digest,
        slice8_config,
    )

    cases = {}
    launches = 0
    for case in SLICE8_DIGEST_CASES:
        rec, res = drive(slice8_config(case))
        got = run_digest(state_to_numpy(res.state), res.metrics)
        del res
        cases[case] = {
            "nodes": rec["nodes"], "converged_round":
                rec["rounds_to_convergence"],
            "want_round": SLICE8_ROUNDS[case],
            "wall_per_round_ms": rec["wall_per_round_ms"],
            "sweeps_run": rec["sweeps_run"],
            "launches": rec["launches"]["grouped_merge"],
            "digest": got, "match": got == DIGESTS[case],
        }
        one_launch_per_sweep(case, rec)
        launches += rec["launches"]["grouped_merge"]
    emit({"phase": "slice8_digests", "cases": cases})
    for case, d in cases.items():
        if not d["match"] or d["converged_round"] != d["want_round"]:
            raise AssertionError(f"{case} on the card differs from the JAX "
                                 "package's run")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.core.crdt import apply_cell_changes, make_table_state
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine import step as step_mod
    from corro_sim_torch.engine.replay import read_table, replay
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.io.traces import ingest_file
    from corro_sim_torch.merge_probe import (
        device_sync_box,
        nvidia_smi,
        populated_table,
        random_lanes,
        sync_box,
        time_in_place_ms,
        time_ms,
    )
    from corro_sim_torch.engine.state import clone_state, state_nbytes
    from corro_sim_torch.profile_slice import (
        CONFIG_DIGEST_CASES,
        CONFIG3_RUN_ARGS,
        CONFIG4_RUN_ARGS,
        CONFIG5_RUN_ARGS,
        CONFIG7_RUN_ARGS,
        CONFIG_DIGEST_ROUNDS,
        CONFIG6_DIGEST_EXCLUDE,
        CONFIG6_ROUNDS,
        CONFIG6_RUN_ARGS,
        DIGEST_RUN_ARGS,
        DIGESTS,
        REPLAY_CASES,
        REPLAY_MAX_ROUNDS,
        REPLAY_ROUNDS,
        SWIM_DIGEST_CASES,
        config3_config,
        config3_schedule,
        config4_config,
        config4_rate,
        config4_schedule,
        config5_config,
        config5_schedule,
        config6_config,
        config6_workload,
        config7_config,
        config7_schedule,
        config8_lane_config,
        config_digest_case,
        digest_config,
        run_digest,
        size_config5,
        size_config7,
        slice_config,
        slice_schedule,
        state_bytes,
        sync_mailbox_lanes,
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
        return (state.cv.view(n, r * c), state.vr.view(n, r * c),
                state.site.view(n, r * c), state.cl)

    cases = []

    def check(label, state, box, cap, c):
        """Kernel against the plain version on the same inputs, bit for
        bit; the kernel must write into the planes it was given. Returns
        the pre-merge planes (copies) and the merged planes."""
        ins = planes(state)
        before = tuple(t.clone() for t in ins)
        want = mk.grouped_merge_reference(*ins, box, cap, c)
        got = mk.grouped_merge(*ins, box, cap, c)
        torch.cuda.synchronize()
        if any(g.data_ptr() != t.data_ptr() for g, t in zip(got, ins)):
            raise AssertionError(f"kernel output does not alias its input "
                                 f"on {label}")
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        if err != 0:
            raise AssertionError(f"kernel != plain version on {label}")
        n, cells = ins[0].shape
        cases.append({"case": label, "nodes": n, "cells": cells,
                      "cols": c, "cap": cap, "max_abs_err": err,
                      "aliases": True})
        return before, got

    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        n, r, c = 16, 32, 4
        state = populated_table(rng, n, r, c, dev)
        lanes = to_dev(random_lanes(rng, n, r, c, 400))
        box = routed_box(*lanes, n, c, 128)
        # the mailbox path also equals the scatter merge on the raw lanes
        want = apply_cell_changes(state, *lanes)
        check(f"random_lanes[{seed}]", state, box, 128, c)
        for f in ("cv", "vr", "site", "cl"):
            if not torch.equal(getattr(state, f), getattr(want, f)):
                raise AssertionError(f"mailbox merge != scatter merge: {f}")

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
    want = apply_cell_changes(
        state, *lanes[:7], lanes[7] & (torch.arange(m0, device=dev) < 128)
    )
    check("cap_overflow", state, box, 128, c)
    if not (torch.equal(state.vr, want.vr) and torch.equal(state.cl, want.cl)):
        raise AssertionError("cap overflow: kernel != masked scatter merge")

    # both mailbox styles at the slice's shape
    n, r, c, cap = 10000, 256, 4, 128
    shape = {"nodes": n, "cells": r * c, "cap": cap}
    rng = np.random.default_rng(11)
    state = populated_table(rng, n, r, c, dev)
    routed = routed_box(*to_dev(random_lanes(rng, n, r, c, n * 64)),
                        n, c, cap)
    check("routed_10000x1024x128", state, routed, cap, c)
    del routed
    box = sync_box(random_lanes(rng, n, r, c, n * cap), c, dev)
    sync_before, sync_after = check("sync_10000x1024x128", state, box, cap, c)

    def launch(cap, c, box):
        return lambda p: mk.grouped_merge(*p, box, cap, c)

    kernel_ms = time_in_place_ms(launch(cap, c, box), sync_before, 20)
    plain_ms = time_ms(
        lambda: mk.grouped_merge_reference(*sync_before, box, cap, c), 5,
        batch=5)
    work = mk.merge_work(sync_before, box, cap, c, sync_after)
    work_oop = mk.merge_work_out_of_place(sync_before, box, cap, c,
                                          sync_after)
    bound_ms, bound_by = mk.bound_ms(work)
    sector_bytes = mk.merge_sector_bytes(sync_before, box, cap, c, sync_after)
    bound_oop_ms, _ = mk.bound_ms(work_oop)
    del state, sync_after

    # an all-invalid mailbox changes nothing and reads only valid words
    empty = box.clone()
    empty[mk.LANE_VALID] = 0
    state = populated_table(rng, n, r, c, dev)
    pre, got = check("all_invalid_10000x1024x128", state, empty, cap, c)
    if not all(torch.equal(a, b) for a, b in zip(pre, got)):
        raise AssertionError("an all-invalid mailbox changed the table")
    empty_ms = time_in_place_ms(launch(cap, c, empty), pre, 10)
    empty_bound_ms, _ = mk.bound_ms(mk.merge_work(pre, empty, cap, c, got))
    del pre, got, empty

    # every lane of node 0 on one row (hot row): atomics contend
    hot = box.clone()
    hot[mk.LANE_VALID] = 0
    hot[mk.LANE_VALID, :cap] = 1
    hot[mk.LANE_CELL, :cap] = 7 * c + hot[mk.LANE_CELL, :cap] % c
    check("hot_row_10000x1024x128", state, hot, cap, c)
    del state, hot, box, sync_before
    torch.cuda.empty_cache()

    # other cell layouts and a wider mailbox
    for n, r, c, cap in ((2048, 8192, 1, 128), (10000, 128, 8, 128),
                         (10000, 256, 4, 256), (1024, 64, 16, 128),
                         (1024, 128, 3, 128)):
        state = populated_table(rng, n, r, c, dev)
        box = sync_box(random_lanes(rng, n, r, c, n * cap), c, dev)
        check(f"sync_{n}x{r * c}x{cap}_cols{c}", state, box, cap, c)
        del state, box
        torch.cuda.empty_cache()

    # config 3's shapes: 1000 nodes, 512 x 6 cells (the run-time cols
    # instance); the sync sweep's mailbox holds K' * cap * S = 32 * 8 * 4
    # = 1024 lanes per node, delivery's under "on" apply_queue_cap * S =
    # 512 (one warp per block at cap 1024: 74.6 KB of shared memory)
    n, r, c = 1000, 512, 6
    state = populated_table(rng, n, r, c, dev)
    routed = routed_box(*to_dev(random_lanes(rng, n, r, c, n * 400)),
                        n, c, 512)
    check("routed_1000x3072x512_cols6", state, routed, 512, c)
    del routed
    box3 = sync_box(random_lanes(rng, n, r, c, n * 1024), c, dev)
    c3_before, c3_after = check("sync_1000x3072x1024_cols6", state, box3,
                                1024, c)
    c3_ms = time_in_place_ms(launch(1024, c, box3), c3_before, 20)
    c3_plain_ms = time_ms(
        lambda: mk.grouped_merge_reference(*c3_before, box3, 1024, c), 5,
        batch=5)
    c3_work = mk.merge_work(c3_before, box3, 1024, c, c3_after)
    c3_bound_ms, c3_bound_by = mk.bound_ms(c3_work)
    empty3 = box3.clone()
    empty3[mk.LANE_VALID] = 0
    state = populated_table(rng, n, r, c, dev)
    pre, got = check("all_invalid_1000x3072x1024_cols6", state, empty3,
                     1024, c)
    if not all(torch.equal(a, b) for a, b in zip(pre, got)):
        raise AssertionError("an all-invalid cap-1024 mailbox changed the "
                             "table")
    del state, box3, empty3, pre, got, c3_before, c3_after
    torch.cuda.empty_cache()
    config3_kernel = {
        "shape": {"nodes": n, "cells": r * c, "cols": c, "cap": 1024},
        "kernel_ms": c3_ms, "plain_ms": c3_plain_ms,
        "bound_ms": c3_bound_ms, "bound_by": c3_bound_by,
        "bytes": c3_work[0], "ops": c3_work[1],
        "share_of_bound": c3_bound_ms / c3_ms,
        "smem_bytes_per_warp": mk.build_kernel().grouped_merge_smem_bytes(
            1024, r * c, c),
    }

    # config 6's shape at 10 000 nodes: 2048 x 2 cells (the cols-2
    # template instance); the sweep's mailbox holds K' * cap * S =
    # min(64, 32 * 10, A) * 8 * 1 = 512 lanes per node
    n, r, c, cap6 = 10000, 2048, 2, 512
    state = populated_table(rng, n, r, c, dev)
    box6 = sync_box(random_lanes(rng, n, r, c, n * cap6), c, dev)
    c6_before, c6_after = check(f"sync_{n}x{r * c}x{cap6}_cols{c}", state,
                                box6, cap6, c)
    c6_ms = time_in_place_ms(launch(cap6, c, box6), c6_before, 20)
    c6_plain_ms = time_ms(
        lambda: mk.grouped_merge_reference(*c6_before, box6, cap6, c), 5,
        batch=5)
    c6_work = mk.merge_work(c6_before, box6, cap6, c, c6_after)
    c6_bound_ms, c6_bound_by = mk.bound_ms(c6_work)
    del state, box6, c6_before, c6_after
    torch.cuda.empty_cache()
    config6_kernel = {
        "shape": {"nodes": n, "cells": r * c, "cols": c, "cap": cap6},
        "kernel_ms": c6_ms, "plain_ms": c6_plain_ms,
        "bound_ms": c6_bound_ms, "bound_by": c6_bound_by,
        "bytes": c6_work[0], "ops": c6_work[1],
        "share_of_bound": c6_bound_ms / c6_ms,
    }
    emit(dict(phase="kernel_check_config6", kernel="grouped_merge",
              bit_equal=True, **config6_kernel))

    # config 8's lane shape: 256 nodes, 64 x 2 cells (the cols-2
    # instance); each lane's sweep mailbox holds K' * cap * S = 64 * 8 *
    # 1 = 512 lanes per node (sync_mailbox_lanes; "config8_sweep" checks
    # it against the lanes' own launches)
    c8cfg = config8_lane_config(256)
    n, r, c = c8cfg.num_nodes, c8cfg.num_rows, c8cfg.num_cols
    cap8l = sync_mailbox_lanes(c8cfg)
    state = populated_table(rng, n, r, c, dev)
    box8l = sync_box(random_lanes(rng, n, r, c, n * cap8l), c, dev)
    c8_before, c8_after = check(f"sync_{n}x{r * c}x{cap8l}_cols{c}", state,
                                box8l, cap8l, c)
    c8_ms = time_in_place_ms(launch(cap8l, c, box8l), c8_before, 20)
    c8_plain_ms = time_ms(
        lambda: mk.grouped_merge_reference(*c8_before, box8l, cap8l, c), 5,
        batch=5)
    c8_work = mk.merge_work(c8_before, box8l, cap8l, c, c8_after)
    c8_bound_ms, c8_bound_by = mk.bound_ms(c8_work)
    del state, box8l, c8_before, c8_after
    config8_kernel = {
        "shape": {"nodes": n, "cells": r * c, "cols": c, "cap": cap8l},
        "kernel_ms": c8_ms, "plain_ms": c8_plain_ms,
        "bound_ms": c8_bound_ms, "bound_by": c8_bound_by,
        "bytes": c8_work[0], "ops": c8_work[1],
        "share_of_bound": c8_bound_ms / c8_ms,
    }
    emit(dict(phase="kernel_check_config8_lane", kernel="grouped_merge",
              bit_equal=True, **config8_kernel))

    # config 5's sweep mailbox at its sized 16 384 nodes: K' * cap * S =
    # 512 * 16 * 1 = 8192 lanes per node over 128 x 2 cells, more than a
    # warp's share of shared memory: merged tile by tile in lane order
    n, r, c, cap8 = 16384, 128, 2, 8192
    tile = mk.merge_tile(cap8, r * c, c, dev)
    state = populated_table(rng, n, r, c, dev)
    box8 = device_sync_box(n, r, c, cap8, 5, dev)
    c8_before, c8_after = check(f"sync_{n}x{r * c}x{cap8}_cols{c}", state,
                                box8, cap8, c)
    c8_ms = time_in_place_ms(launch(cap8, c, box8), c8_before, 10)
    c8_plain_ms = time_ms(
        lambda: mk.grouped_merge_reference(*c8_before, box8, cap8, c), 2,
        batch=1)
    c8_work = mk.merge_work(c8_before, box8, cap8, c, c8_after)
    c8_bound_ms, c8_bound_by = mk.bound_ms(c8_work)
    del state, c8_before, c8_after
    # the tile boundary inside one row's lanes, and a delete at a higher
    # cl in a later tile than a value at a lower cl, on node 0 of a box
    # that holds nothing else
    for label, lanes8 in (
        ("tile_boundary_in_row", {
            tile - 2: (10, 7, 10, 1, 1), tile - 1: (11, 9, 3, 2, 1),
            tile: (10, 7, 11, 0, 1), tile + 1: (11, 9, 3, 3, 1),
            tile + 2: (10, 2, 20, 1, 3)}),
        ("later_tile_delete", {
            3: (18, 5, 40, 2, 1), tile + 17: (19, 1, mk.NEG, 1, 2),
            3 * tile + 1: (19, 6, 50, 3, 1)})):
        one = torch.zeros((mk.LANE_FIELDS, 64 * cap8), dtype=torch.int32,
                          device=dev)
        for pos, fields in lanes8.items():
            one[:5, pos] = torch.tensor(fields, dtype=torch.int32)
            one[mk.LANE_VALID, pos] = 1
        check(f"{label}_cap{cap8}", populated_table(rng, 64, r, c, dev),
              one, cap8, c)
    empty8 = box8[:, :64 * cap8].clone()
    empty8[mk.LANE_VALID] = 0
    state = populated_table(rng, 64, r, c, dev)
    pre, got = check(f"all_invalid_cap{cap8}", state, empty8, cap8, c)
    if not all(torch.equal(a, b) for a, b in zip(pre, got)):
        raise AssertionError("an all-invalid cap-8192 mailbox changed the "
                             "table")
    del box8, empty8, one, state, pre, got
    torch.cuda.empty_cache()
    cap8_kernel = {
        "shape": {"nodes": n, "cells": r * c, "cols": c, "cap": cap8},
        "tile": tile, "kernel_ms": c8_ms, "plain_ms": c8_plain_ms,
        "bound_ms": c8_bound_ms, "bound_by": c8_bound_by,
        "bytes": c8_work[0], "ops": c8_work[1],
        "share_of_bound": c8_bound_ms / c8_ms,
    }
    emit(dict(phase="kernel_check_cap8192", kernel="grouped_merge",
              bit_equal=True, **cap8_kernel))

    emit({"phase": "kernel_check", "kernel": "grouped_merge",
          "cases": cases, "bit_equal": True, "shape": shape,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": work[0], "ops": work[1],
          "bound_out_of_place_ms": bound_oop_ms,
          "bytes_out_of_place": work_oop[0],
          "sector_bytes": sector_bytes,
          "sector_bound_ms": 1e3 * sector_bytes / mk.HBM_BYTES_PER_S,
          "share_of_bound": bound_ms / kernel_ms,
          "all_invalid_ms": empty_ms, "all_invalid_bound_ms": empty_bound_ms,
          "config3": config3_kernel})
    max_abs_err = max(x["max_abs_err"] for x in cases)

    # ------------------------------------ the main path at full size
    slice_rec, res = drive(slice_config())
    del res
    emit(dict(phase="slice", **slice_rec))
    check_run("10k-node slice", slice_rec, SLICE_ROUNDS)

    # ------------- SWIM on: bit checks against the JAX package's digests
    digests = {}
    for case in SWIM_DIGEST_CASES:
        want = DIGESTS[case]
        cfg = digest_config(case)
        res = run_sim(cfg, init_state(cfg, seed=0, device="cuda"),
                      slice_schedule(), device="cuda", **DIGEST_RUN_ARGS)
        got = run_digest(state_to_numpy(res.state), res.metrics)
        digests[case] = {"nodes": cfg.num_nodes, "rounds": res.rounds,
                         "view_size": cfg.swim_view_size, "digest": got,
                         "match": got == want}
        del res
    emit({"phase": "swim_digest", "cases": digests})
    if not all(d["match"] for d in digests.values()):
        raise AssertionError("a SWIM-on run on the card differs from the "
                             "JAX package's run")

    # ------------------ SWIM on: config 0 exactly, 10 000 nodes
    cfg = slice_config(swim=True)
    with call_events(step_mod, "sync_round") as sweep_ev:
        swim_rec, res = drive(cfg)
    m = res.metrics
    del res
    torch.cuda.synchronize()
    swim_rec["sweep_ms"] = event_ms(sweep_ev)
    swim_max = {k: int(m[k].max()) for k in
                ("swim_suspects", "swim_down", "swim_probe_failures")}
    emit(dict(phase="swim_slice", swim_interval=cfg.swim_interval,
              swim_suspect_rounds=cfg.swim_suspect_rounds,
              narrow_state=cfg.narrow_state,
              swim_max_per_round=swim_max, **swim_rec))
    check_run("10k-node SWIM-on cluster", swim_rec, SWIM_SLICE_ROUNDS)
    if swim_max["swim_suspects"] == 0:
        raise AssertionError("SWIM raised no suspicion across the partition")
    del m
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
    del runs, s_on, s_off, m_on, m_off
    torch.cuda.empty_cache()

    # ------- config 3 exactly, 1000 nodes: multi-cell, multi-chunk
    cfg = config3_config(1000)
    c3_rec, res = drive(cfg, config3_schedule(), CONFIG3_RUN_ARGS)
    got = run_digest(state_to_numpy(res.state), res.metrics)
    m = res.metrics
    del res
    emit(dict(
        phase="config3", seqs_per_version=cfg.seqs_per_version,
        chunks_per_version=cfg.chunks_per_version,
        rows=cfg.num_rows, cols=cfg.num_cols,
        digest=got, match=got == DIGESTS["config3_1000"],
        max_buffered_partials=int(m["buffered_partials"].max()),
        sync_cells=int(m["sync_cells"].sum()),
        cells_written=int(m["cells_written"].sum()),
        dropped_window=int(m["dropped_window"].sum()),
        **c3_rec))
    check_run("config-3 cluster", c3_rec, CONFIG3_ROUNDS)
    if got != DIGESTS["config3_1000"]:
        raise AssertionError("config 3 on the card differs from the JAX "
                             "package's run")
    del m
    torch.cuda.empty_cache()

    # ------- config 3's shape at 10 000 nodes, a fixed number of rounds
    cfg = config3_config(10000)
    c3k_rec, res = drive(cfg, config3_schedule(), dict(
        max_rounds=CONFIG3_10K_ROUNDS, chunk=8, seed=0,
        stop_on_convergence=False))
    m = res.metrics
    del res
    emit(dict(
        phase="config3_10k", max_buffered_partials=int(
            m["buffered_partials"].max()),
        sync_cells=int(m["sync_cells"].sum()),
        cells_written=int(m["cells_written"].sum()),
        **{k: v for k, v in c3k_rec.items() if k != "tables_agree"}))
    if c3k_rec["rounds_run"] != CONFIG3_10K_ROUNDS or m["log_wrapped"].any():
        raise AssertionError("config 3 at 10k: the run stopped early or the "
                             "change log wrapped")
    one_launch_per_sweep("config 3 at 10k", c3k_rec)
    del m
    torch.cuda.empty_cache()

    # --------- config 3's kernel arm against its scatter arm, whole run:
    # delivery merges S = 4 cells per lane (cap 512), the sweep cap 1024
    runs = {}
    for arm in ("on", "off"):
        cfg_arm = config3_config(256, arm)
        mk.reset_launch_counts()
        res = run_sim(
            cfg_arm, init_state(cfg_arm, seed=0, device="cuda"),
            config3_schedule(), max_rounds=48, chunk=8, seed=0,
            stop_on_convergence=False, device="cuda",
        )
        runs[arm] = (state_to_numpy(res.state), res.metrics,
                     mk.LAUNCHES["grouped_merge"])
    (s_on, m_on, l3_on), (s_off, m_off, l3_off) = runs["on"], runs["off"]
    diff = [k for k in s_off if not np.array_equal(s_on[k], s_off[k])]
    diff += [k for k in m_off if not np.array_equal(m_on[k], m_off[k])]
    emit({"phase": "kernel_vs_scatter_config3", "nodes": 256, "rounds": 48,
          "launches_on": l3_on, "launches_off": l3_off,
          "state_leaves": len(s_off), "metrics": len(m_off),
          "partials_max": int(m_off["buffered_partials"].max()),
          "differing": diff})
    if diff or l3_on == 0 or l3_off != 0:
        raise AssertionError("config 3: merge_kernel='on' and 'off' runs "
                             "differ")

    del runs, s_on, s_off, m_on, m_off
    torch.cuda.empty_cache()

    # ------- config 6 exactly, 1000 nodes: the workload engine, emit cap
    # (2046 rows: 4092 cells, so every merge takes the scatter arm)
    wl = config6_workload(1000)
    cfg = config6_config(1000)
    c6_rec, res = drive(cfg, Schedule(), CONFIG6_RUN_ARGS, workload=wl)
    got = run_digest(state_to_numpy(res.state), res.metrics,
                     exclude=CONFIG6_DIGEST_EXCLUDE)
    del res
    emit(dict(phase="config6_1000", spec=wl.spec, rows=cfg.num_rows,
              emit_slots=cfg.emit_slots, pend_slots=cfg.pend_slots,
              schedule_writes=wl.total_writes,
              schedule_deletes=wl.total_deletes, digest=got,
              match=got == DIGESTS["config6_1000"], **c6_rec))
    if (c6_rec["rounds_to_convergence"] != CONFIG6_ROUNDS
            or c6_rec["final_gap"] != 0.0 or got != DIGESTS["config6_1000"]):
        raise AssertionError("config 6 at 1000 nodes differs from the JAX "
                             "package's run")
    if (c6_rec["writes"], c6_rec["deletes"]) != (wl.total_writes,
                                                 wl.total_deletes):
        raise AssertionError("config 6 at 1000 nodes: writes or deletes "
                             "differ from the schedule's")
    if not c6_rec["tables_agree"] or c6_rec["log_wrapped_max"]:
        raise AssertionError("config 6 at 1000 nodes: replicas disagree or "
                             "the change log wrapped")
    if c6_rec["launches"]["grouped_merge"] != 0:
        raise AssertionError("config 6 at 1000 nodes has 4092 cells: no "
                             "kernel launch expected")
    del wl
    torch.cuda.empty_cache()

    # ------- config 6 exactly, 10 000 nodes, to convergence
    t0 = time.perf_counter()
    wl = config6_workload(10000)
    gen_s = time.perf_counter() - t0
    cfg = config6_config(10000)
    c6k_rec, res = drive(cfg, Schedule(), CONFIG6_RUN_ARGS, workload=wl)
    stage_s = res.stage_seconds
    del res
    emit(dict(phase="config6_10k", spec=wl.spec, rows=cfg.num_rows,
              emit_slots=cfg.emit_slots, pend_slots=cfg.pend_slots,
              schedule_writes=wl.total_writes,
              schedule_deletes=wl.total_deletes,
              schedule_generation_s=gen_s, schedule_staging_s=stage_s,
              **c6k_rec))
    if c6k_rec["rounds_to_convergence"] is None or c6k_rec["final_gap"]:
        raise AssertionError("config 6 at 10k did not converge")
    if not c6k_rec["tables_agree"] or c6k_rec["log_wrapped_max"]:
        raise AssertionError("config 6 at 10k: replicas disagree or the "
                             "change log wrapped")
    if (c6k_rec["writes"], c6k_rec["deletes"]) != (wl.total_writes,
                                                   wl.total_deletes):
        raise AssertionError("config 6 at 10k: writes or deletes differ "
                             "from the schedule's")
    one_launch_per_sweep("config 6 at 10k", c6k_rec)
    del wl
    torch.cuda.empty_cache()

    # --------- config 6's kernel arm against its scatter arm, whole run:
    # delivery under the emit window at cap 128, the sweep at cap 512
    runs = {}
    wl = config6_workload(CONFIG6_TWIN_NODES)
    for arm in ("on", "off"):
        cfg_arm = dataclasses.replace(config6_config(CONFIG6_TWIN_NODES, arm),
                                      num_rows=CONFIG6_TWIN_ROWS)
        mk.reset_launch_counts()
        res = run_sim(
            cfg_arm, init_state(cfg_arm, seed=0, device="cuda"), Schedule(),
            max_rounds=CONFIG6_TWIN_ROUNDS, chunk=8, seed=0,
            stop_on_convergence=False, device="cuda", workload=wl,
        )
        runs[arm] = (state_to_numpy(res.state), res.metrics,
                     mk.LAUNCHES["grouped_merge"])
    (s_on, m_on, l6_on), (s_off, m_off, l6_off) = runs["on"], runs["off"]
    diff = [k for k in s_off if not np.array_equal(s_on[k], s_off[k])]
    diff += [k for k in m_off if not np.array_equal(m_on[k], m_off[k])]
    emit({"phase": "kernel_vs_scatter_config6", "nodes": CONFIG6_TWIN_NODES,
          "rows": CONFIG6_TWIN_ROWS, "rounds": CONFIG6_TWIN_ROUNDS,
          "launches_on": l6_on, "launches_off": l6_off,
          "state_leaves": len(s_off), "metrics": len(m_off),
          "writes": int(m_off["writes"].sum()), "differing": diff})
    if diff or l6_on == 0 or l6_off != 0:
        raise AssertionError("config 6: merge_kernel='on' and 'off' runs "
                             "differ")
    del runs, s_on, s_off, m_on, m_off, wl
    torch.cuda.empty_cache()

    # ------- trace replay of the corro-api-types changeset fixtures
    replays = {}
    replay_launches = 0
    for case, (path, overrides) in REPLAY_CASES.items():
        trace = ingest_file(path)
        cfg = trace.suggest_config(**overrides)
        mk.reset_launch_counts()
        res = replay(trace, cfg, max_rounds=REPLAY_MAX_ROUNDS, device="cuda")
        torch.cuda.synchronize()
        replay_launches += mk.LAUNCHES["grouped_merge"]
        got = run_digest(state_to_numpy(res.state), res.metrics)
        tables = [read_table(res.state, trace, i)
                  for i in range(cfg.num_nodes)]
        cleared = res.state.log.cleared.cpu().numpy()
        replays[case] = {
            "actors": trace.num_actors, "rounds": trace.rounds,
            "nodes": cfg.num_nodes, "converged_round": res.converged_round,
            "poisoned": res.poisoned, "digest": got,
            "match": got == DIGESTS[case],
            "tables_agree": all(t == tables[0] for t in tables),
        }
        if case == "replay_parity":
            replays[case]["tables_expected"] = all(
                t == REPLAY_EXPECTED for t in tables)
            replays[case]["cleared_0_3_and_0_1"] = bool(
                cleared[0, 3] and cleared[0, 1])
        del res
    emit({"phase": "replay", "cases": replays,
          "launches": replay_launches})
    for case, rec in replays.items():
        if (rec["converged_round"] != REPLAY_ROUNDS[case] or not rec["match"]
                or not rec["tables_agree"]):
            raise AssertionError(f"replay of {case} differs from the JAX "
                                 "package's")
    rp = replays["replay_parity"]
    if not (rp["tables_expected"] and rp["cleared_0_3_and_0_1"]):
        raise AssertionError("replay of replay_parity.ndjson does not reach "
                             "the expected tables and cleared versions")

    # ------- config 4, the headline: 10 000 nodes, 40 rounds, no stop;
    # chunk by chunk, each chunk's wall its own (as the JAX package's
    # headline reads each chunk's metrics before the next)
    cfg = config4_config(10000)
    walls = {}
    c4_rec, res = drive(cfg, config4_schedule(), CONFIG4_RUN_ARGS,
                        pipeline=False,
                        on_chunk=lambda d: walls.__setitem__(
                            d["chunk"], d["chunk_wall_s"]))
    rate = config4_rate(walls, res.metrics)
    c4_metrics = res.metrics
    del res
    torch.cuda.empty_cache()
    emit(dict(phase="config4",
              metric=f"crdt_changes_applied_per_sec_{cfg.num_nodes}_node_sim",
              value=rate, unit="changes/s", chunk_walls_s=walls,
              state_bytes=state_bytes(cfg),
              swim_suspects_max=int(c4_metrics["swim_suspects"].max()),
              **c4_rec))
    if c4_rec["rounds_run"] != 40 or c4_rec["log_wrapped_max"] or rate <= 0:
        raise AssertionError("config 4 at 10k: the run stopped early, the "
                             "change log wrapped or nothing was applied")
    one_launch_per_sweep("config 4 at 10k", c4_rec)
    del c4_metrics

    # ------- configs 5 and 7 at the node count the one-device rules give
    device_bytes = torch.cuda.mem_get_info()[1]
    sized = {}
    for name, size, make, sched, run_args in (
            ("config5", size_config5, config5_config, config5_schedule,
             CONFIG5_RUN_ARGS),
            ("config7", size_config7, config7_config,
             lambda n: config7_schedule(), CONFIG7_RUN_ARGS)):
        n, reason = size(device_bytes)
        cfg = make(n)
        rec, res = drive(cfg, sched(n), run_args)
        flight_events = {}
        for e in res.flight.events():
            flight_events[e["name"]] = flight_events.get(e["name"], 0) + 1
        del res
        torch.cuda.empty_cache()
        sized[name] = rec
        emit(dict(phase=name, sized_by=reason, device_bytes=device_bytes,
                  state_bytes=state_bytes(cfg),
                  hot_actors=cfg.sync_hot_actors,
                  mailbox_lanes_per_node=min(
                      cfg.sync_req_actors, cfg.sync_actor_topk * 4,
                      cfg.num_actors) * cfg.sync_cap_per_actor,
                  flight_events=flight_events, **rec))
        if (rec["rounds_to_convergence"] is None or rec["final_gap"] != 0.0
                or not rec["tables_agree"] or rec["log_wrapped_max"]):
            raise AssertionError(f"{name} at {n} nodes did not converge to "
                                 "identical tables")
        one_launch_per_sweep(f"{name} at {n} nodes", rec)

    # ------- the configuration digests: JAX package CPU runs
    cdig = {}
    cdig_launches = {}
    for case in CONFIG_DIGEST_CASES:
        spec = config_digest_case(case)
        rec, res = drive(spec["cfg"], spec["schedule"], spec["run_args"],
                         workload=spec["workload"])
        got = run_digest(state_to_numpy(res.state), res.metrics,
                         exclude=spec["exclude"])
        del res
        torch.cuda.empty_cache()
        cdig[case] = {"nodes": rec["nodes"], "rounds_run": rec["rounds_run"],
                      "converged_round": rec["rounds_to_convergence"],
                      "want_round": CONFIG_DIGEST_ROUNDS[case],
                      "sync_sweeps": rec["sync_sweeps"],
                      "wall_per_round_ms": rec["wall_per_round_ms"],
                      "digest": got, "match": got == DIGESTS[case]}
        cdig_launches[case] = rec["launches"]["grouped_merge"]
        if mk.kernel_supported(spec["cfg"], "sync", dev):
            one_launch_per_sweep(case, rec)
    emit({"phase": "config_digests", "cases": cdig})
    for case, d in cdig.items():
        if not d["match"] or d["converged_round"] != d["want_round"]:
            raise AssertionError(f"{case} on the card differs from the JAX "
                                 "package's run")

    # ------- the pipelined driver against the sequential one: config 6
    # at 1000 nodes, both to the JAX package's round and digest
    pipe = {}
    wl = config6_workload(1000)
    cfg = config6_config(1000)
    for pipelined in (True, False):
        rec, res = drive(cfg, Schedule(), CONFIG6_RUN_ARGS, workload=wl,
                         pipeline=pipelined)
        got = run_digest(state_to_numpy(res.state), res.metrics,
                         exclude=CONFIG6_DIGEST_EXCLUDE)
        events = {}
        for e in res.flight.events():
            events[e["name"]] = events.get(e["name"], 0) + 1
        pipe["pipelined" if pipelined else "sequential"] = {
            "converged_round": rec["rounds_to_convergence"],
            "digest": got, "match": got == DIGESTS["config6_1000"],
            "wall_per_round_ms": rec["wall_per_round_ms"],
            "pipeline": res.pipeline, "flight_events": events,
            "flight_phases": res.flight.diagnostics()["wall_s_by_phase"],
        }
        del res
    # host syncs per round: the card's sync debug mode warns at every
    # host wait on the device; 16 rounds of config 6's load
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = run_sim(cfg, init_state(cfg, seed=0, device="cuda"),
                          Schedule(), max_rounds=16, chunk=8, seed=0,
                          device="cuda", workload=wl, pipeline=False,
                          stop_on_convergence=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del res
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    # the speculative chunk's copy of a 10k state (config 6)
    st10 = init_state(config6_config(10000), seed=0, device="cuda")
    clone_ms = time_ms(lambda: clone_state(st10), 3, batch=5)
    clone_bytes = state_nbytes(st10)
    del st10
    torch.cuda.empty_cache()
    emit({"phase": "pipeline", "nodes": 1000, "runs": pipe,
          "host_syncs_per_round_sequential_load": syncs / 16,
          "speculative_copy": {"state_bytes": clone_bytes,
                               "ms": clone_ms, "nodes": 10000}})
    for mode, d in pipe.items():
        if d["converged_round"] != CONFIG6_ROUNDS or not d["match"]:
            raise AssertionError(f"config 6 at 1000 nodes, {mode}: differs "
                                 "from the JAX package's run")
    if not pipe["pipelined"]["pipeline"]["enabled"]:
        raise AssertionError("the default run is not pipelined")
    del wl
    torch.cuda.empty_cache()

    # ------- faults: config 8's lanes as serial twins, and the 10k soak
    fault_launches = {"fault_digests": fault_digest_phase(emit)}
    fault_launches["soak_10k"], soak_ref = soak_phase(emit)

    # ------- the rest of the step: latency ring, RTT rings, probes, the
    # legacy and deal-probe sync schedules
    fault_launches["latency_10k"] = latency_phase(emit)
    fault_launches["legacy_sync_10k"] = legacy_phase(emit)
    fault_launches["slice8_digests"] = slice8_digest_phase(emit)

    # ------- the fleet sweep and resumable checkpoints
    (fault_launches["config8_sweep"],
     fault_launches["config8_serial"]) = config8_sweep_phase(
         emit, CONFIG8_SMOKE_SEEDS)
    fault_launches["config8_compact"] = config8_compact_phase(emit)
    fault_launches["config8_1024"] = config8_1024_phase(emit)
    fault_launches["checkpoint_10k"] = checkpoint_phase(emit, soak_ref)
    del soak_ref

    # ------- the digital twin: a Consul-schema feed shadowed, resumed and
    # forecast at 256 nodes against the JAX package's pins, then at 10k
    fault_launches["twin_digests"] = twin_digest_phase(emit)
    fault_launches["twin_10k"] = twin_10k_phase(emit)

    # ------- the subscription engine: config 6's live-half population of
    # 64 matchers and 1024 subscribers on a replayed Consul table, at 256
    # nodes against the JAX package's pins, then at 10k
    fault_launches["subs_digests"] = subs_digest_phase(emit)
    fault_launches["subs_10k"] = subs_10k_phase(emit)

    by_path = {label: rec["launches"]["grouped_merge"] for label, rec in (
        ("slice", slice_rec), ("swim_slice", swim_rec), ("config3", c3_rec),
        ("config3_10k", c3k_rec), ("config6_1000", c6_rec),
        ("config6_10k", c6k_rec), ("config4", c4_rec),
        ("config5", sized["config5"]), ("config7", sized["config7"]))}
    by_path["kernel_vs_scatter_config6"] = l6_on
    by_path["replay"] = replay_launches
    by_path.update(cdig_launches)
    by_path.update(fault_launches)
    emit({"kernels": [{
        "name": "grouped_merge",
        "route": "cuda",
        "source": "corro_sim_torch/core/csrc/merge_kernel.cu",
        "replaces": "corro_sim/core/merge_kernel.py:184",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_out_of_place_ms": bound_oop_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "config3_cap1024": {k: config3_kernel[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
        "config6_cap512": {k: config6_kernel[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
        "config5_cap8192": {k: cap8_kernel[k] for k in (
            "tile", "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
        "config8_lane": {k: config8_kernel[k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
