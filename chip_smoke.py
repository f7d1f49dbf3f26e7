#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each kernel against its plain PyTorch version on the card (the
sync sweep's serve kernel on every sweep of a north-star and a catch-up
cluster run to convergence: "serve_north_star", "serve_catchup"), holds
the JAX package's config 4 at 10 000 nodes (the benchmark's
``churn_10k.steady``) to the plain SWIM reference of
``simbench/reference/swim.py`` on three ticks, bit for bit, and reads
the device time of SWIM's ranges ("churn_10k_swim"), drives
the port's main path (``corro_sim_torch.engine.driver.run_sim``) on the
10 000-node north-star cluster until it converges, with SWIM off (the
first slice's path) and with full SWIM on (the JAX package's config 0
exactly), holds two SWIM-on runs against digests of the JAX package's
runs, and checks the kernel arm of a whole simulation against the
scatter arm. Then the same for multi-cell, multi-chunk changesets: the
JAX package's config 3 (the Consul-schema cluster: 4-cell changesets in
2 chunks) at its own 1000 nodes to convergence, held to the round and
the digest of the JAX package's run; config 3's shape at 10 000 nodes
for 32 rounds; and its kernel arm against its scatter arm. Then the
workload engine and trace replay: the batched half of the JAX package's
config 6 (Zipf + churn-storm traffic through ``run_sim(workload=...)``
under an egress cap) at 1000 nodes, held to the JAX package's round and
digest, and at its own 10 000 nodes through its load and as many rounds
again; its kernel arm
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
runs; and config 0's 10 000-node cluster soaked under crash_amnesia
to re-convergence with a final gap of 0, and its
churn soak at 4096 nodes, where a ``swim_false_down`` verdict first
shows, held to the JAX package's verdict, violation and digest
("swim_churn_4096"). Then the rest
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
("config8_sweep"); two of its seed-0 lanes through the compact fleet
scheduler at width 1, pipelined ("config8_compact"); its lane base at
1024 nodes (windowed SWIM in the lanes), the lossy and churn lanes to
the JAX package's verdicts ("config8_1024"); and config 0 at
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
10 000 nodes (seed 0's lossy lane) with the lane held to its serial
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
("subs_10k"). Then the live cluster
(``corro_sim_torch.harness.cluster.LiveCluster``): the JAX package's
config 1 through ``corro_sim_torch.benchmarks`` (1000 INSERTs through the
live write path to convergence) at 3 agents and at the 64 of the
north-star bench's devcluster leg, each held to the JAX package's round
and final-state digest, with no merge launch (its 1016 cells are not a
multiple of 128) and its wall, inserts per second and ms per insert
("config1"); a Consul-schema LiveCluster at 256 nodes with config 0's
SWIM and sync knobs driven only through its public API — seeded SQL
transactions from 64 writer nodes in waves, config 6's 1024 subscribers
attached with ``subscribe_attached``, a lossy scenario armed and
cleared, 4 nodes down and rejoined, ``reconcile_gaps``,
``run_until_converged``, then a checkpoint saved, warm-booted and
ticked — held bit for bit to the JAX package's run of the same script
("live_digests"); and the same at 10 000 nodes, 1024 transactions from
128 writers, 8 nodes down for 16 rounds, every tick a single round with
its notify: the tables agree, two queries equal the host SQL oracle,
every plain matcher's mask does too, each subscriber's folded events
equal its query's rows, one merge launch per sync sweep, with the
rounds, ms per round, the host seconds of ``execute`` and of the notify,
stage timings, host syncs per tick, peak memory and the checkpoint's
bytes and seconds ("live_10k"). Then the serving surfaces: config 6's
live half exactly as the JAX package defines it
(``corro_sim_torch.benchmarks.config6_live_run``: the Zipf + churn-storm
schedule as SQL through ``workload.harness.run_live_load`` at 256 nodes,
64 matchers, 1024 subscribers), held to the JAX package's run, with the
sub-delivery quantiles in rounds and seconds ("config6_live"); the same
schedule with the one-shot queries rotating over the direct, HTTP
(``api.http.ApiServer``) and pgwire (``api.pg.PgServer``) surfaces on
2048 row slots, so the merge kernel runs on every sync sweep, held to
the JAX package's run ("serve_256"); and both servers over the
"live_10k" cluster: one HTTP transaction, the same rows over HTTP,
pgwire and directly, the write's event on an HTTP subscription, the
members and table-stats routes, and one ``/metrics`` scrape that
validates, with its seconds, bytes and host syncs ("serve_10k"). Then
the command line (``corro_sim_torch.cli``) and the cluster tooling:
right after "swim_slice", config 0 at 10 000 nodes written as a TOML
file and run through ``run --config`` in this process, its report held
to the same config's direct ``run_sim``, one merge launch per sweep, its
flight export read back by ``flight --diag``, and ``load
--verify-vacuous`` on the card ("cli_run_10k"); after "serve_10k",
``python -m corro_sim_torch agent --resume`` of the checkpoint
"live_10k" wrote, as a child process: its info line, "live_10k"'s two
oracle queries through ``query``, one ``exec`` read back on another node
within 256 rounds, ``cluster members`` and ``backup`` over the admin
socket, and exit 0 on SIGTERM ("cli_agent_10k"; its launches happen in
the child, listed under ``child_process_paths``); and ``devcluster`` of
64 agents in two components in this process, with ``consul-sync``,
``template``, ``exec`` and ``reload`` against it, each component holding
exactly its own rows, every ``node.json`` bootstrap list as
``generate_bootstrap`` resolves it and one merge launch per sweep
("devcluster_64"). From the end of the kernel checks the phases that
share no state with the rest (the twin's, the fault digests, the
slice-8 digests, the three config 8 phases, the 256-node subscription,
live and serving runs and the configuration digests) run in a second
process on the same card (``chip_smoke.py --helper``, killed if this
one ends first), so that the two share the card's idle time; its phase
lines print when it ends, and its launches join this process's in the
``kernels`` line. The helper ends with the analysis tools' phases:
config 0 at 10 000 nodes through ``run_sim(transfer_guard=True)`` under
``torch.cuda.set_sync_debug_mode("error")``, held to the unguarded run,
with its reads per sanctioned point per round ("transfer_guard_10k"),
and the C++ pk codec built with g++ and held to the Python codec on the
trace fixtures ("native_codec"). Every phase
prints one JSON line with its seconds; any failure raises and exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np

# the round at which the 10k-node slice converges from seed 0, with SWIM
# off and with SWIM on
SLICE_ROUNDS = 22
SWIM_SLICE_ROUNDS = 22
# the round at which the bench's north star (config 0 at 10k, keyed in
# chunks of 8 where the slice runs keyed in chunks of 16) converges on
# the card, in every repeat: the port's own run, held as a regression
# pin (the JAX package's north star at 64 nodes is held on the CPU by
# tests/test_torch_bench.py)
NORTH_STAR_ROUNDS = 20
# the round at which config 3 converges at 1000 nodes from seed 0, as the
# JAX package's run does (the run behind DIGESTS["config3_1000"])
CONFIG3_ROUNDS = 1144
# rounds of config 3's shape run at 10 000 nodes
CONFIG3_10K_ROUNDS = 32
# rounds of config 6 run at its own 10 000 nodes: its 64-round load and
# as many again (its 1054-round tail to convergence, the JAX package's
# round, is recorded in PERF.md; config 6 converges pinned at 1000 and
# 4000 nodes)
CONFIG6_10K_ROUNDS = 128
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


# the serve kernel's launches by phase line: those counted since the
# previous phase line (sync/serve.py's LAUNCHES, zeroed here)
SERVE_BY_PHASE: dict = {}


def take_serve_launches(phase: str) -> None:
    sv = sys.modules.get("corro_sim_torch.sync.serve")
    if sv is not None and sv.LAUNCHES["serve_lanes"]:
        SERVE_BY_PHASE[phase] = (SERVE_BY_PHASE.get(phase, 0)
                                 + sv.LAUNCHES["serve_lanes"])
        sv.LAUNCHES["serve_lanes"] = 0


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries its seconds, and the
    serve kernel's launches since the previous phase line go to it."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = dict(obj, phase_s=now - _T0[1], total_s=now - _T0[0])
        take_serve_launches(obj["phase"])
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


def swim_churn_phase(emit, n: int = 4096) -> int:
    """Phase ``swim_churn_4096``: config 0's churn soak (the
    ``soak_10k`` run's scenario and arguments) at 4096 nodes, the
    smallest size at which it reports a ``swim_false_down`` verdict,
    held to the JAX package's run (``SWIM_CHURN_PINS``): rounds,
    converged round, the violations with their details, and the digest.
    Returns the merge launches."""
    import torch

    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import (
        SOAK_ARGS,
        SWIM_CHURN_PINS,
        SWIM_CHURN_SPEC,
        run_digest,
        run_soak,
        soak_config,
    )

    torch.cuda.empty_cache()
    mk.reset_launch_counts()
    run = run_soak(soak_config(n), SWIM_CHURN_SPEC, device="cuda",
                   **SOAK_ARGS)
    res = run.result
    launches = mk.LAUNCHES["grouped_merge"]
    rep = run.invariants.report()
    got = (res.rounds, res.converged_round,
           [(v["round"], v["invariant"], v["detail"])
            for v in rep["violations"]],
           run_digest(state_to_numpy(res.state), res.metrics))
    rec = {"phase": f"swim_churn_{n}", "nodes": n,
           "scenario": run.scenario.spec, "rounds_run": got[0],
           "converged_round": got[1], "violations": got[2],
           "digest": got[3], "match": got == SWIM_CHURN_PINS[n],
           "wall_per_round_ms": res.wall_per_round_ms,
           "launches": launches, "sweeps_run": res.pipeline["sweeps_run"]}
    del run, res
    emit(rec)
    if not rec["match"]:
        raise AssertionError(f"swim_churn_{n}: differs from the JAX "
                             "package's run (SWIM_CHURN_PINS)")
    if launches != rec["sweeps_run"]:
        raise AssertionError(f"swim_churn_{n}: not one merge launch per "
                             "sweep run")
    return launches


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
    crash_amnesia, one of config 8's scenarios (lossy, churn and
    clock_skew are left out for the time budget: churn's SWIM verdict is
    held at 4096 nodes by "swim_churn_4096", and the lossy lanes at 256
    and 1024 nodes) with the soak CLI's arguments, the
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
    for spec in (CONFIG8_SCENARIOS[2],):
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

    def spy(table, box, cap, mesh=None):
        caps.add(cap)
        return merge(table, box, cap, mesh=mesh)

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
    """Phase ``config8_compact``: two of config 8's scenarios at seed 0
    (the lossy and crash-amnesia lanes, 64 rounds each) through the fleet
    scheduler (``compact=True``, ``width=1``, ``pipeline=True``: the
    second lane refills the slot the first frees); prints the occupancy
    curve with its refills. The two-lane plan arms fewer sweep
    dimensions than the four-lane one, so its lanes are held to the JAX
    package's run of the same plan (``CONFIG8_COMPACT_PINS``). The
    other two lanes are left out for the time budget; "config8_sweep"
    runs all four. Returns the launches."""
    from corro_sim_torch.profile_slice import (
        CONFIG8_COMPACT_PINS,
        CONFIG8_COMPACT_SCENARIOS,
        config8_plan,
        sweep_books,
        sweep_lane_record,
    )

    plan = config8_plan(range(1), scenarios=CONFIG8_COMPACT_SCENARIOS)
    res, launches, wall = _sweep(plan, compact=True, width=1,
                                       pipeline=True)
    lanes = [sweep_lane_record(lr, CONFIG8_COMPACT_PINS)
             for lr in res.lanes]
    emit({"phase": "config8_compact", "nodes": 256, "seeds": 1,
          "width": 1, **sweep_books(res, wall), "launches": launches,
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
    JAX package's run (``CONFIG8_1024_VIOLATIONS``). Lanes are held to
    their serial twins in "config8_sweep", so none runs here. Returns
    the launches."""
    import torch

    from corro_sim_torch.profile_slice import (
        CONFIG8_1024_CHURN,
        CONFIG8_1024_VIOLATIONS,
        CONFIG8_SCENARIOS,
        config8_plan,
        sweep_books,
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
    emit({"phase": "config8_1024", "nodes": 1024,
          "swim_view_size": plan.union_cfg.swim_view_size,
          "rows": plan.union_cfg.num_rows,
          **books, "launches": launches, "lanes_detail": lanes})
    for cell, d in lanes.items():
        if (d["converged_round"] is None or d["rows_lost"] != 0
                or not d["verdict_match"]):
            raise AssertionError(f"config 8 at 1024 nodes: {cell} did not "
                                 "converge, lost rows or differs from the "
                                 "JAX package's verdict")
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
    merge kernel launched. Then the forecast from its fork at 10 000
    nodes (``TWIN_10K_FORECAST``: seed 0's lossy lane, chunks of 16
    rounds), the lane held leaf for leaf to its serial ``run_sim``
    resumed from the fork token. Prints the host seconds of the scan,
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


def config1_phase(emit) -> int:
    """Phase ``config1``: the JAX package's config 1 through
    ``corro_sim_torch.benchmarks`` (1000 INSERTs through the live write
    path to convergence) at 3 agents and at the 64 of the north-star
    bench's devcluster leg, each held to the JAX package's converged
    round and final-state digest (``CONFIG1_PINS``). Its layout is 1016
    rows x 1 column: 1016 cells are not a multiple of 128, so every
    merge takes the scatter arm and the kernel must not launch. Prints
    the wall, inserts per second and ms per insert of each. Returns the
    merge launches (0)."""
    import torch

    from corro_sim_torch.benchmarks import config1_report, config1_run
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.harness.cluster import LiveCluster
    from corro_sim_torch.profile_slice import (
        CONFIG1_INSERTS,
        CONFIG1_PINS,
        run_digest,
    )

    runs, launches = {}, 0
    for nodes in sorted(CONFIG1_PINS):
        mk.reset_launch_counts()
        run = config1_run(LiveCluster, CONFIG1_INSERTS, nodes,
                          device="cuda")
        launched = mk.LAUNCHES["grouped_merge"]
        launches += launched
        cfg = run["cluster"].cfg
        got = (run["converged_round"],
               run_digest(state_to_numpy(run["cluster"].state), {}))
        runs[nodes] = {
            **config1_report(run, CONFIG1_INSERTS, nodes),
            "converged_round": run["converged_round"],
            "digest": got[1], "match": got == CONFIG1_PINS[nodes],
            "want_round": CONFIG1_PINS[nodes][0],
            "cells": cfg.num_rows * cfg.num_cols,
            "kernel_supported": mk.kernel_supported(cfg, "sync", "cuda"),
            "launches": launched,
            "stage_timings": run["cluster"].stage_timings(),
        }
        del run
        torch.cuda.empty_cache()
    emit({"phase": "config1", "runs": runs, "launches": launches,
          "no_launch_reason": "1016 rows x 1 column = 1016 cells, not a "
                              "multiple of 128: kernel_supported sends "
                              "every merge to the scatter arm"})
    for nodes, rec in runs.items():
        if not rec["match"]:
            raise AssertionError(f"config1 at {nodes} agents: differs from "
                                 "the JAX package's round or final state")
    if launches or any(r["kernel_supported"] for r in runs.values()):
        raise AssertionError("config1: the merge kernel launched on a "
                             "1016-cell space")
    return launches


def _live_backend():
    import types

    from corro_sim_torch.harness.cluster import LiveCluster
    from corro_sim_torch.io.checkpoint import load_checkpoint, save_checkpoint

    return types.SimpleNamespace(LiveCluster=LiveCluster,
                                 save_checkpoint=save_checkpoint,
                                 load_checkpoint=load_checkpoint)


class _SyncCount:
    """Counts the card's host waits (``set_sync_debug_mode`` warnings)
    inside a ``with``."""

    def __init__(self):
        self.count = 0

    def __call__(self):
        import contextlib
        import warnings

        import torch

        @contextlib.contextmanager
        def counting():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
            self.count += sum("synchroniz" in str(w.message)
                              for w in caught)

        return counting()


def _live_run(n: int, run_kw: dict, ckpt_dir: str,
              keep: bool = False) -> tuple:
    """One live run on the card: the run, the merge launches it made,
    the sync sweeps it ran, the host syncs per tick after convergence
    and the peak memory. ``keep``: leave the checkpoint file
    (``run["checkpoint"]``) in place."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import (
        LIVE_KEYS,
        LIVE_SEED,
        LIVE_TAIL_TICKS,
        live_drive,
        subs_queries,
        subs_subscribers,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    subscribers = subs_subscribers(subs_queries(LIVE_SEED, n, LIVE_KEYS),
                                   LIVE_SEED)
    syncs = _SyncCount()
    mk.reset_launch_counts()
    path = os.path.join(ckpt_dir, f"live_{n}.npz")
    run = live_drive(_live_backend(), n, subscribers=subscribers,
                     ckpt_path=path, wrap_ticks=syncs, device="cuda",
                     **run_kw)
    launches = mk.LAUNCHES["grouped_merge"]
    if keep:
        run["checkpoint"] = path
    else:
        os.remove(path)
    # the warm-booted cluster continues the saved one's sweep counter
    sweeps = int(run["warm"].state.sync_rounds)
    return (run, launches, sweeps, syncs.count / LIVE_TAIL_TICKS,
            torch.cuda.max_memory_allocated())


def _live_stats(run: dict) -> dict:
    c = run["cluster"]
    secs = run["host_seconds"]
    notify = c.histograms.get(
        "corro_subs_changes_processing_duration_seconds")
    return {
        "converged_round": run["converged_round"],
        "rounds": c._rounds_ticked,
        "converge_rounds": secs["converge_rounds"],
        "ms_per_round_converging": (
            1000.0 * secs["converge"] / max(secs["converge_rounds"], 1)),
        "execute_s_per_transaction": (
            secs["execute"] / max(secs["transactions"], 1)),
        "notify_s_per_tick": notify.sum / max(notify.count, 1),
        "notify_ticks": notify.count,
        "host_seconds": secs,
        "stage_timings": c.stage_timings(),
        "checkpoint_bytes": run["checkpoint_bytes"],
        "subscribers": len(run["queues"]),
        "events": sum(len(q) for q in run["queues"]),
    }


def live_digests_phase(emit, ckpt_dir: str) -> int:
    """Phase ``live_digests``: a LiveCluster over the Consul schema (512
    rows x 6 columns, so every sync sweep's merge runs the kernel) at
    256 nodes with config 0's SWIM and sync knobs, driven through its
    public API by ``profile_slice.live_drive``: seeded SQL transactions
    (INSERT, UPDATE, DELETE on both tables, Zipf 1.1 keys, LWW conflicts)
    from 64 writer nodes in waves, config 6's 1024 subscribers attached
    with ``subscribe_attached``, a lossy scenario armed and cleared, 4
    nodes down and rejoined, ``reconcile_gaps``, ``run_until_converged``,
    then a checkpoint saved, warm-booted and ticked. Held bit for bit to
    the JAX package's run of the same script (``LIVE_PINS``). Returns
    the merge launches."""
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.profile_slice import (
        LIVE_DIGESTS_RUN,
        LIVE_PIN_NODES,
        LIVE_PINS,
        live_folded_mismatches,
        live_record,
    )

    run, launches, sweeps, syncs, peak = _live_run(
        LIVE_PIN_NODES, LIVE_DIGESTS_RUN, ckpt_dir)
    rec = live_record(run, state_to_numpy(run["cluster"].state),
                      state_to_numpy(run["warm"].state))
    match = {k: rec[k] == v for k, v in LIVE_PINS.items()}
    folded = live_folded_mismatches(run)
    emit({"phase": "live_digests", "nodes": LIVE_PIN_NODES,
          "match": match, "launches": launches, "sync_sweeps": sweeps,
          "host_syncs_per_tick": syncs, "max_memory_allocated": peak,
          "folded_mismatches": len(folded), **_live_stats(run)})
    if not all(match.values()):
        raise AssertionError("live_digests: differs from LIVE_PINS in "
                             f"{sorted(k for k, v in match.items() if not v)}")
    if folded or launches == 0 or launches != sweeps:
        raise AssertionError("live_digests: a subscriber's folded events "
                             "differ from its query, or not one merge "
                             "launch per sync sweep")
    return launches


def live_10k_phase(emit, ckpt_dir: str) -> int:
    """Phase ``live_10k``: the same schema, knobs and population at
    10 000 nodes with the observers spread over all of them: 1024
    transactions from 128 writer nodes (8 each), 8 nodes down for 16
    rounds then rejoined, ``run_until_converged`` with the subscribers
    attached (every tick a single round with its notify), then the
    checkpoint. No JAX run exists at this size; checks: every node's
    table agrees, ``query`` on two observers equals the host SQL oracle
    (``eval_predicate_py`` over the decoded table), every plain
    matcher's mask equals the oracle, each subscriber's initial rows
    folded with its events equal its query's final rows, one merge
    launch per sync sweep. Prints the rounds, ms per round, the host
    seconds of ``execute`` per transaction and of the notify per tick,
    ``stage_timings()``, host syncs per tick, peak memory and the
    checkpoint's bytes and seconds. Returns the merge launches."""
    from corro_sim_torch.profile_slice import (
        LIVE_10K_RUN,
        live_folded_mismatches,
        live_oracle_rows,
        subs_oracle_mismatches,
    )
    from corro_sim_torch.subs.manager import Matcher
    from corro_sim_torch.subs.query import parse_query

    n = 10000
    run, launches, sweeps, syncs, peak = _live_run(n, LIVE_10K_RUN,
                                                   ckpt_dir, keep=True)
    c = run["cluster"]
    ckpt = run["checkpoint"]
    t0 = time.perf_counter()
    folded = live_folded_mismatches(run)
    # two plain queries on two observers, against the host SQL oracle
    checked = []
    for sql, node in run["subscribers"]:
        if len(checked) == 2:
            break
        if node in {nd for _, nd in checked}:
            continue
        if type(c._matcher_for(parse_query(sql).base(), node)) is Matcher:
            checked.append((sql, node))
    oracle = [(sql, node, live_oracle_rows(c, sql, node))
              for sql, node in checked]
    oracle_diff = [
        sql for sql, node, rows in oracle
        if sorted(c.query_rows(sql, node)[1], key=repr)
        != sorted(rows, key=repr)]
    mask_diff = subs_oracle_mismatches(c.subs, c.state.table)
    check_s = time.perf_counter() - t0
    rec = {"nodes": n, "launches": launches, "sync_sweeps": sweeps,
           "tables_agree": tables_agree(c.state.table),
           "oracle_queries": checked, "oracle_mismatches": oracle_diff,
           "mask_mismatches": mask_diff,
           "folded_mismatches": len(folded), "check_s": check_s,
           "host_syncs_per_tick": syncs, "max_memory_allocated": peak,
           **_live_stats(run)}
    del run
    import torch

    torch.cuda.empty_cache()
    emit({"phase": "live_10k", **rec})
    if rec["converged_round"] is None or not rec["tables_agree"]:
        raise AssertionError("live_10k: did not converge to one table")
    if oracle_diff or mask_diff or folded or len(checked) != 2:
        raise AssertionError("live_10k: a query, a matcher's mask or a "
                             "subscriber's folded events differ from the "
                             "host SQL oracle")
    if launches == 0 or launches != sweeps:
        raise AssertionError("live_10k: not one merge launch per sync "
                             "sweep")
    # what "cli_agent_10k" restarts from and holds its queries to: the
    # checkpoint and the two oracle queries' rows, both taken before
    # "serve_10k" writes to the cluster
    agent = {"checkpoint": ckpt, "nodes": n, "writer": 7, "reader": n - 3,
             "queries": oracle}
    return launches, c, agent


def _timed_cluster_cls():
    """The port's LiveCluster on the card, timing ``execute`` on the
    host (``exec_s``, ``exec_n``)."""
    import functools

    from corro_sim_torch.harness.cluster import LiveCluster

    class TimedCluster(LiveCluster):
        exec_s = 0.0
        exec_n = 0

        def execute(self, *a, **kw):
            t = time.perf_counter()
            try:
                return super().execute(*a, **kw)
            finally:
                self.exec_s += time.perf_counter() - t
                self.exec_n += 1

    return functools.partial(TimedCluster, device="cuda")


@contextlib.contextmanager
def _surface_timers():
    """Host seconds and counts of the load harness's one-shot HTTP and
    pgwire queries (client side: request to last row), while entered."""
    from corro_sim_torch.api.pg import SimplePgClient
    from corro_sim_torch.client import ApiClient

    secs = {"http": [0.0, 0], "pg": [0.0, 0]}
    saved = (ApiClient.query_rows, SimplePgClient.query)

    def timed(fn, key):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[key][0] += time.perf_counter() - t
                secs[key][1] += 1
        return call

    ApiClient.query_rows = timed(saved[0], "http")
    SimplePgClient.query = timed(saved[1], "pg")
    try:
        yield secs
    finally:
        ApiClient.query_rows, SimplePgClient.query = saved


def _live_load_phase(emit, name: str, pins: dict, extra: dict) -> tuple:
    """One run of config 6's live half on the card
    (``benchmarks.config6_live_run`` with ``extra``), held to ``pins``.
    Returns the phase's record, the merge launches and the sync sweeps."""
    import torch

    from corro_sim_torch.benchmarks import config6_live_run
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import (
        CONFIG6_LIVE_NODES,
        live_load_record,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    with _surface_timers() as surf:
        t0 = time.perf_counter()
        report, c = config6_live_run(
            CONFIG6_LIVE_NODES, cluster_cls=_timed_cluster_cls(), **extra)
        wall = time.perf_counter() - t0
    launches = mk.LAUNCHES["grouped_merge"]
    rep = report.as_json()
    got = live_load_record(rep, state_to_numpy(c.state))
    match = {k: got[k] == v for k, v in pins.items()}
    rounds = c._rounds_ticked
    rec = {
        "phase": name, "nodes": CONFIG6_LIVE_NODES, "match": match,
        "record": got, "latency_rounds": rep["latency_rounds"],
        "latency_seconds": rep["latency_seconds"],
        "harness_wall_s": rep["wall_seconds"], "wall_s": wall,
        "rounds": rounds, "ms_per_round": 1000.0 * wall / max(rounds, 1),
        "execute_s_per_transaction": c.exec_s / max(c.exec_n, 1),
        "transactions": c.exec_n, "queries": rep["queries"],
        "universe_respaces": c.universe.version,
        "http_s_per_query": surf["http"][0] / max(surf["http"][1], 1),
        "pg_s_per_query": surf["pg"][0] / max(surf["pg"][1], 1),
        "cells": c.cfg.num_rows * c.cfg.num_cols,
        "kernel_supported": mk.kernel_supported(c.cfg, "sync", "cuda"),
        "launches": launches, "sync_sweeps": int(c.state.sync_rounds),
        "stage_timings": c.stage_timings(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    c.tripwire.trip()
    del c
    torch.cuda.empty_cache()
    emit(rec)
    if not all(match.values()):
        raise AssertionError(f"{name}: differs from the JAX package's run "
                             f"in {sorted(k for k, v in match.items() if not v)}")
    return rec


def config6_live_phase(emit) -> int:
    """Phase ``config6_live``: config 6's live half exactly as the JAX
    package defines it (``benchmarks.config6_live_run``: the Zipf 1.1 +
    churn-storm schedule at 256 nodes, 64 matchers, 1024 subscribers, 64
    latency-tracked, 4 direct queries per round, settle 512), held to the
    JAX package's run (``CONFIG6_LIVE_PINS``). Its layout is 2046 rows x
    2 columns = 4 092 cells, not a multiple of 128, so every merge takes
    the scatter arm and the kernel must not launch. Prints the
    sub-delivery quantiles in rounds and seconds, the wall and
    ``execute``'s host seconds per transaction. Returns the merge
    launches (0)."""
    from corro_sim_torch.profile_slice import CONFIG6_LIVE_PINS

    rec = _live_load_phase(emit, "config6_live", CONFIG6_LIVE_PINS, {})
    if rec["launches"] or rec["kernel_supported"]:
        raise AssertionError("config6_live: the merge kernel launched on a "
                             "4092-cell space")
    return rec["launches"]


def serve_256_phase(emit) -> int:
    """Phase ``serve_256``: the same schedule through
    ``run_live_load(http=True, pg=True)`` on 2048 row slots (4 096 cells:
    every sync sweep's merge runs the kernel), the one-shot queries
    rotating over direct, HTTP and pgwire, held to the JAX package's run
    (``SERVE_256_PINS``). Prints the queries per surface, the HTTP and
    pgwire seconds per query and the sub-delivery p50/p99 in rounds and
    seconds. Returns the merge launches."""
    from corro_sim_torch.profile_slice import SERVE_256_PINS, SERVE_RUN

    rec = _live_load_phase(emit, "serve_256", SERVE_256_PINS, SERVE_RUN)
    if set(rec["queries"]) != {"direct", "http", "pg"} or not all(
            rec["queries"].values()):
        raise AssertionError("serve_256: a surface answered no query")
    if rec["launches"] == 0 or rec["launches"] != rec["sync_sweeps"]:
        raise AssertionError("serve_256: not one merge launch per sync "
                             "sweep")
    return rec["launches"]


def serve_10k_phase(emit, c) -> int:
    """Phase ``serve_10k``: an ApiServer and a PgServer over the 10 000
    node cluster "live_10k" leaves behind (``profile_slice.serve_check``):
    one HTTP transaction acknowledged, the same query answered equal over
    HTTP, pgwire and directly, the write's event on an HTTP subscription,
    ``/v1/cluster/members`` and ``/v1/table_stats`` answering, and one
    ``/metrics`` scrape that passes ``validate_exposition``. Prints the
    scrape's seconds, bytes and host syncs (the sync debug mode's
    warnings, as "live_10k" counts them), the surfaces' seconds and the
    merge launches, one per sync sweep. Returns the launches."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import serve_agrees, serve_check
    from corro_sim_torch.utils.metrics import validate_exposition

    n = c.cfg.num_nodes
    syncs = _SyncCount()
    mk.reset_launch_counts()
    sweeps0 = int(c.state.sync_rounds)
    rounds0 = c._rounds_ticked
    out = serve_check(c, writer=7, reader=n - 3, scrape_wrap=syncs)
    launches = mk.LAUNCHES["grouped_merge"]
    sweeps = int(c.state.sync_rounds) - sweeps0
    text = out.pop("metrics")
    try:
        validate_exposition(text)
        valid = True
    except ValueError as e:
        valid = str(e)
    rec = {
        "phase": "serve_10k", "nodes": n, "agree": serve_agrees(out),
        "execute": out["execute"], "sub_event": out["sub_event"],
        "rows": out["direct_rows"], "converged_round": out[
            "converged_round"], "rounds": c._rounds_ticked - rounds0,
        "members": len(out["members"]),
        "table_stats_rows": out["table_stats"]["total_row_count"],
        "scrape_valid": valid, "scrape_bytes": len(text.encode()),
        "scrape_lines": text.count("\n"), "scrape_host_syncs": syncs.count,
        "seconds": out["seconds"], "launches": launches,
        "sync_sweeps": sweeps,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    emit(rec)
    if not rec["agree"] or rec["execute"]["version"] is None:
        raise AssertionError("serve_10k: the surfaces disagree or the write "
                             "was not acknowledged")
    if valid is not True or rec["members"] != n:
        raise AssertionError("serve_10k: the scrape does not validate or "
                             "the members route is short")
    if launches != sweeps:
        raise AssertionError("serve_10k: not one merge launch per sync "
                             "sweep")
    return launches


class ThreadStdout:
    """``sys.stdout`` routed by thread: a thread that registered a buffer
    in :attr:`bufs` writes there, every other thread to the real stream.
    Lets a command that runs on a thread (``devcluster``) print while
    this thread captures the output of the commands it calls."""

    def __init__(self, real):
        self.real = real
        self.bufs = {}

    def _out(self):
        import threading

        return self.bufs.get(threading.get_ident(), self.real)

    def write(self, s):
        return self._out().write(s)

    def flush(self):
        self._out().flush()


@contextlib.contextmanager
def captured_stdout():
    """This thread's standard output into a buffer (yielded)."""
    import io
    import threading

    buf = io.StringIO()
    out = sys.stdout
    if isinstance(out, ThreadStdout):
        out.bufs[threading.get_ident()] = buf
        try:
            yield buf
        finally:
            del out.bufs[threading.get_ident()]
    else:
        with contextlib.redirect_stdout(buf):
            yield buf


def cli_call(argv) -> tuple:
    """``corro_sim_torch.cli.main(argv)`` in this process: its exit code,
    its standard output and its seconds."""
    from corro_sim_torch import cli

    t = time.perf_counter()
    with captured_stdout() as buf:
        rc = cli.main(list(argv))
    return rc, buf.getvalue(), time.perf_counter() - t


def cli_json(argv) -> tuple:
    rc, out, secs = cli_call(argv)
    return rc, json.loads(out), secs


def cli_run_phase(emit, work_dir: str, n: int = 10000) -> int:
    """Phase ``cli_run_10k``: the north-star cluster (config 0 exactly,
    ``profile_slice.slice_config(n, swim=True)``) written as a TOML file
    and run through the command line in this process, ``run --config F
    --write-rounds 8 --seed 0 --chunk 8 --flight-out G``, then through
    ``run_sim`` directly with ``Schedule(write_rounds=8)`` and the
    command's defaults. The report's rounds, writes, changes applied,
    window drops and final gap must equal the direct run's, the command
    must exit 0, the kernel must launch once per sync sweep run, and
    ``flight G --diag`` must read the export back. Then ``load
    --verify-vacuous`` at the JAX package's default shape (12 nodes).
    Prints both runs' wall per round and the launches. Returns the merge
    launches of the command's run."""
    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.profile_slice import sim_toml, slice_config

    cfg = slice_config(n, swim=True)
    conf = os.path.join(work_dir, "north_star.toml")
    with open(conf, "w") as f:
        f.write(sim_toml(cfg))
    flight = os.path.join(work_dir, "cli_run.ndjson")
    mk.reset_launch_counts()
    rc, report, cli_s = cli_json([
        "run", "--config", conf, "--write-rounds", "8",
        "--seed", "0", "--chunk", "8", "--flight-out", flight])
    launches = mk.LAUNCHES["grouped_merge"]
    torch.cuda.empty_cache()
    mk.reset_launch_counts()
    t = time.perf_counter()
    res = run_sim(cfg, init_state(cfg, seed=0, device="cuda"),
                  Schedule(write_rounds=8), max_rounds=4096, chunk=8,
                  seed=0, device="cuda")
    direct_s = time.perf_counter() - t
    m = res.metrics
    direct = {
        "converged_round": res.converged_round, "rounds_run": res.rounds,
        "writes": int(m["writes"].sum()),
        "changes_applied": int(m["fresh"].sum())
        + int(m["sync_versions"].sum()),
        "dropped_window": int(m["dropped_window"].sum()),
        "final_gap": float(m["gap"][-1]),
    }
    direct_launches = mk.LAUNCHES["grouped_merge"]
    sweeps = {"sync_sweeps": int(res.state.sync_rounds),
              "sweeps_run": res.pipeline["sweeps_run"]}
    direct_wall = res.wall_per_round_ms
    del res, m
    rc_flight, diag, _ = cli_json(["flight", flight, "--diag"])
    rc_load, load, load_s = cli_json([
        "load", "zipf:alpha=1.0,rate=0.5,keys=12",
        "--nodes", "12", "--rounds", "8", "--chunk", "8", "--path",
        "batched", "--verify-vacuous"])
    rec = {
        "phase": "cli_run_10k", "nodes": n, "rc": rc,
        "report": {k: report[k] for k in direct},
        "direct": direct, "match": all(report[k] == v
                                       for k, v in direct.items()),
        "wall_per_round_ms": {"cli": report["wall_per_round_ms"],
                              "direct": direct_wall},
        "cli_s": cli_s, "direct_s": direct_s,
        "launches": launches, "direct_launches": direct_launches, **sweeps,
        "report_sweeps_run": report["pipeline"]["sweeps_run"],
        "flight_rc": rc_flight,
        "flight_rounds": diag["diagnostics"].get("rounds_recorded"),
        "load_rc": rc_load, "load_vacuous": load.get("vacuous"),
        "load_batched": load.get("batched"), "load_s": load_s,
    }
    emit(rec)
    if rc != 0 or not rec["match"] or direct["converged_round"] is None:
        raise AssertionError("cli_run_10k: the command's report differs "
                             "from the direct run's, or it did not "
                             "converge")
    if (launches == 0 or launches != direct_launches
            or launches != sweeps["sweeps_run"]
            or launches != rec["report_sweeps_run"]):
        raise AssertionError("cli_run_10k: not one merge launch per sync "
                             "sweep run")
    if rc_flight != 0 or rec["flight_rounds"] != direct["rounds_run"]:
        raise AssertionError("cli_run_10k: flight --diag did not read the "
                             "run's export back")
    if rc_load != 0 or rec["load_vacuous"] is not True:
        raise AssertionError("cli_run_10k: load --verify-vacuous failed")
    return launches


BENCH_SERIES = ("north_star_wall@cuda", "devcluster_wall@cuda",
                "north_star_throughput@cuda")


def bench_phase(emit, work_dir: str) -> int:
    """Phase ``bench``: ``python -m corro_sim_torch bench`` as a user runs
    it, its droppings and perf ledger redirected into ``work_dir``
    (``CORRO_BENCH_OUT``, ``CORRO_PERF_LEDGER``). Config 0, the north star
    at 10 000 nodes, in this process: every repeat converges at
    ``NORTH_STAR_ROUNDS``, the devcluster leg converges (its drift from
    the frozen wall is printed, not held: the leg's spread between
    processes on the card is wider than the 20 % band the bench flags),
    and the kernel launches once per sweep run. Config 2 (64
    nodes) as a child process: one line, exit 0, the JAX package's round
    and changes (``CONFIG2_PINS``), a ledger record, no kernel build.
    Config 4, the headline, in this process: a positive rate, its four
    measured chunks (32 rounds) journaled, one launch per sweep. Then the
    ledger (``perf --show``, ``perf --check --update`` and ``--check``
    against bands outside ``work_dir``), ``doctor`` over ``work_dir``
    (every file classified), and ``run --profile-dir`` on a small config,
    whose trace ``obs/profile.py`` reads device time from. Returns the
    merge launches of this process."""
    import subprocess

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine import step as step_mod
    from corro_sim_torch.obs.profile import analyze_profile_dir
    from corro_sim_torch.profile_slice import CONFIG2_PINS

    out_dir = os.path.join(work_dir, "bench")
    ledger = os.path.join(out_dir, "perf_ledger.ndjson")
    env = {"CORRO_BENCH_OUT": out_dir, "CORRO_PERF_LEDGER": ledger}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    rec = {}
    try:
        def sweeps_since(gates0) -> int:
            return sum(step_mod.SWEEP_GATES[k] - gates0[k]
                       for k in ("host_on", "read_on"))

        # ---- config 0: the north star
        mk.reset_launch_counts()
        rc, ns, secs = cli_json(["--device", "cuda", "bench", "--config",
                                 "0"])
        l0 = mk.LAUNCHES["grouped_merge"]
        sweeps0 = sum(r["pipeline"]["sweeps_run"] for r in ns["runs"])
        rec["config0"] = {
            "rc": rc, "seconds": secs, "launches": l0, "sweeps_run": sweeps0,
            **{k: ns.get(k) for k in (
                "value", "vs_baseline", "sim_rounds_to_convergence",
                "sim_wall_per_round_ms", "sim_converged",
                "devcluster_64_agents_wall_s", "devcluster_converged",
                "baseline_frozen_wall_s", "baseline_drift_pct",
                "baseline_drift_exceeded", "run_total_wall_spread_s",
                "donate", "env")},
            "repeat_rounds": [r["converged_round"] for r in ns["runs"]],
            "repeat_walls_s": [r["wall_s"] for r in ns["runs"]],
            "chunk_walls_s": [r["chunk_walls_s"] for r in ns["runs"]],
            "compile_cache": [r["compile_cache"] for r in ns["runs"]],
        }

        # ---- config 2: a child process, as a user runs it
        with open(ledger) as f:
            before = len(f.read().splitlines())
        t = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "corro_sim_torch", "bench", "--config",
             "2"], capture_output=True, text=True, timeout=600)
        c2_lines = child.stdout.splitlines()
        c2 = json.loads(c2_lines[-1]) if c2_lines else {}
        with open(ledger) as f:
            after = len(f.read().splitlines())
        rec["config2"] = {
            "rc": child.returncode, "seconds": time.perf_counter() - t,
            "stdout_lines": len(c2_lines), "ledger_records_added":
            after - before, "want": list(CONFIG2_PINS),
            **{k: c2.get(k) for k in (
                "metric", "value", "changes_applied", "wall_per_round_ms",
                "compile_seconds", "compile_cache", "env")},
        }

        # ---- config 4: the headline (config 0 and 2 ran the preflight)
        mk.reset_launch_counts()
        gates0 = dict(step_mod.SWEEP_GATES)
        os.environ["CORRO_BENCH_NO_PREFLIGHT"] = "1"
        try:
            rc4, c4, secs4 = cli_json(["--device", "cuda", "bench",
                                       "--config", "4"])
        finally:
            del os.environ["CORRO_BENCH_NO_PREFLIGHT"]
        l4 = mk.LAUNCHES["grouped_merge"]
        sweeps4 = sweeps_since(gates0)
        with open(os.path.join(out_dir, "BENCH_flight_config4.ndjson")) as f:
            flight4 = [json.loads(ln) for ln in f]
        rounds4 = [x["r"] for x in flight4 if x.get("t") == "round"]
        rec["config4"] = {"rc": rc4, "seconds": secs4, "launches": l4,
                          "sweeps_run": sweeps4,
                          "journaled_rounds": len(rounds4),
                          "first_round": min(rounds4, default=None),
                          **{k: c4.get(k) for k in (
                              "metric", "value", "vs_baseline", "env")}}

        # ---- the ledger and the doctor over the bench's droppings
        perf_dir = os.path.join(work_dir, "perf")
        os.makedirs(perf_dir, exist_ok=True)
        traj_path = os.path.join(perf_dir, "trajectory.json")
        bands = os.path.join(perf_dir, "bands.json")
        rc_show, show, _ = cli_call(["perf", "--show", "--out", traj_path])
        with open(traj_path) as f:
            series = sorted(json.load(f)["series"])
        rc_upd, _, _ = cli_call(["perf", "--check", "--update", "--bands",
                                 bands])
        rc_chk, chk, _ = cli_call(["perf", "--check", "--bands", bands])
        report_path = os.path.join(perf_dir, "doctor.json")
        rc_doc, doc_text, doc_s = cli_call(["doctor", out_dir, "--out",
                                            report_path])
        with open(report_path) as f:
            doc = json.load(f)
        rec["perf"] = {"rc_show": rc_show, "series": series,
                       "trajectory": show.splitlines(),
                       "rc_update": rc_upd, "rc_check": rc_chk,
                       "checked": len(json.loads(chk)["checked"])}
        rec["doctor"] = {"rc": rc_doc, "seconds": doc_s,
                         "scanned": doc["scanned"],
                         "skipped": doc["skipped"],
                         "counts": doc["counts"],
                         "findings": doc_text.splitlines()}

        # ---- the profile reader on the port's own trace
        prof_dir = os.path.join(work_dir, "profile")
        mk.reset_launch_counts()
        rc_run, run, _ = cli_json([
            "--device", "cuda", "run", "--nodes", "256", "--rows", "64",
            "--cols", "2", "--write-rounds", "4", "--chunk", "8",
            "--max-rounds", "8", "--profile-dir", prof_dir])
        l_prof = mk.LAUNCHES["grouped_merge"]
        analysis = analyze_profile_dir(prof_dir)
        chunk_wall_ms = run["wall_per_round_ms"] * run["rounds_run"]
        (trace,) = analysis["traces"]
        rec["profile"] = {
            "rc": rc_run, "rounds_run": run["rounds_run"], "launches": l_prof,
            "wall_ms": chunk_wall_ms,
            "device_ms": analysis["device_ms"],
            "device_share_of_wall": analysis["device_ms"] / chunk_wall_ms,
            "host_ms": analysis["host_ms"],
            "dispatch_ms": trace.get("dispatch_ms"),
            "fetch_gap_ms": analysis["fetch_gap_ms"],
            "events": trace.get("events"),
            "top_programs": trace.get("programs", [])[:3],
            "parsed": analysis["parsed"], "skipped": analysis["skipped"]}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit({"phase": "bench", **rec})

    bad = []
    c0 = rec["config0"]
    if (c0["rc"] != 0 or not c0["sim_converged"]
            or c0["repeat_rounds"] != [NORTH_STAR_ROUNDS] * 3
            or c0["sim_rounds_to_convergence"] != NORTH_STAR_ROUNDS):
        bad.append("config 0 did not converge at NORTH_STAR_ROUNDS in "
                   "every repeat")
    if not c0["devcluster_converged"]:
        bad.append("config 0's devcluster leg did not converge")
    if c0["launches"] != c0["sweeps_run"] or not c0["launches"]:
        bad.append("config 0: not one kernel launch per sweep run")
    c2 = rec["config2"]
    if (c2["rc"] != 0 or c2["stdout_lines"] != 1
            or [c2["value"], c2["changes_applied"]] != c2["want"]
            or c2["ledger_records_added"] != 1
            or (c2["compile_cache"] or {}).get("misses") != 0):
        bad.append("config 2's child: not one line, the JAX package's "
                   "round and changes, one ledger record and no build")
    c4 = rec["config4"]
    if (c4["rc"] != 0 or not c4["value"] or c4["value"] <= 0
            or c4["journaled_rounds"] != 32 or c4["first_round"] != 9
            or c4["launches"] != c4["sweeps_run"] or not c4["launches"]):
        bad.append("config 4: no rate, not its 32 measured rounds "
                   "journaled, or not one launch per sweep run")
    pf = rec["perf"]
    if (pf["rc_show"] or pf["rc_update"] or pf["rc_check"]
            or not set(BENCH_SERIES) <= set(pf["series"])):
        bad.append("perf: a mode failed or a bench series is missing")
    dr = rec["doctor"]
    if dr["rc"] or dr["skipped"] or not dr["scanned"]:
        bad.append("doctor: failed or skipped a bench artifact")
    pr = rec["profile"]
    # exit 3: not converged in the 8 rounds the profiled run is given
    if pr["rc"] not in (0, 3) or pr["parsed"] != 1 or not pr["device_ms"] > 0:
        bad.append("run --profile-dir: no device time read from its trace")
    if bad:
        raise AssertionError("bench: " + "; ".join(bad))
    return c0["launches"] + c4["launches"] + pr["launches"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_agent_phase(emit, agent: dict, work_dir: str) -> dict:
    """Phase ``cli_agent_10k``: ``python -m corro_sim_torch agent
    --resume <the checkpoint "live_10k" wrote>`` as a child process on
    the card, with its HTTP API, admin socket and pgwire listener. Its
    info line must name the checkpoint's node count; ``query`` through
    the command line must return, for "live_10k"'s two oracle queries,
    the rows "live_10k" checked against the host SQL oracle; one
    ``exec`` INSERT must be read back by ``query`` on another node
    within ``AGENT_MAX_ROUNDS`` rounds of the agent's own ticking
    (counted by ``flight --diag``); ``cluster members`` and ``backup``
    must answer over the admin socket; SIGTERM must end the agent with
    exit 0 within 30 s and no traceback. Prints the seconds from spawn
    to the info line, per CLI query and per call, and the rounds until
    the write is read back. The merge launches happen in the child and
    are not counted here."""
    import select
    import signal
    import subprocess

    sock = os.path.join(work_dir, "agent.sock")
    err_path = os.path.join(work_dir, "agent.stderr")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "corro_sim_torch", "agent",
             "--resume", agent["checkpoint"], "--api-addr", "127.0.0.1:0",
             "--admin-path", sock, "--pg-addr", "127.0.0.1:0"],
            cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
    label = "cli_agent_10k"
    rec = {"phase": label}
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 600)
        line = proc.stdout.readline() if ready else ""
        if not line:
            raise AssertionError(
                f"{label}: the agent printed no info line:\n"
                + open(err_path).read()[-4000:])
        info = json.loads(line)
        rec["info_s"] = time.perf_counter() - t0
        rec["info"] = info
        api = info["api"]
        got_rows, query_s = [], []
        for sql, node, want in agent["queries"]:
            rc, out, secs = cli_call(["query", "--api", api, "--node",
                                      str(node), sql])
            query_s.append(secs)
            lines = sorted(out.splitlines())
            want_lines = sorted("|".join(str(v) for v in row)
                                for row in want)
            got_rows.append({"sql": sql, "node": node, "rc": rc,
                             "rows": len(lines),
                             "match": lines == want_lines})
        rec["oracle_queries"] = got_rows
        rec["query_s"] = query_s

        def rounds() -> int:
            rc, diag, _ = cli_json(["flight", "--admin-path", sock,
                                    "--diag"])
            return diag["diagnostics"]["rounds_recorded"]

        writer, reader = agent["writer"], agent["reader"]
        r0 = rounds()
        rc, out, exec_s = cli_call([
            "exec", "--api", api, "--node", str(writer), AGENT_WRITE])
        rec["exec_rc"], rec["exec_s"] = rc, exec_s
        rec["exec_reply"] = json.loads(out)
        read_back = None
        polls = 0
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            polls += 1
            _, out, _ = cli_call(["query", "--api", api, "--node",
                                  str(reader), AGENT_READ])
            if out.strip() == AGENT_ROW:
                read_back = rounds() - r0
                break
            if rounds() - r0 > AGENT_MAX_ROUNDS:
                break
            time.sleep(0.05)
        rec["write_read_back_rounds"] = read_back
        rec["read_polls"] = polls
        rc, members, members_s = cli_json(["cluster", "members",
                                           "--admin-path", sock])
        rec["members_rc"], rec["members_s"] = rc, members_s
        rec["members"] = len(members) if isinstance(members, list) else (
            len(members.get("members", [])))
        bkp = os.path.join(work_dir, "agent-backup.npz")
        rc, reply, backup_s = cli_json(["backup", "--admin-path", sock, bkp])
        rec["backup_rc"], rec["backup_s"] = rc, backup_s
        rec["backup_bytes"] = (os.path.getsize(bkp)
                               if os.path.exists(bkp) else None)
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rec["exit_code"] = proc.wait(timeout=30)
        rec["sigterm_s"] = time.perf_counter() - t
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    stderr = open(err_path).read()
    rec["traceback"] = "Traceback" in stderr
    emit(rec)
    if rec["info"]["nodes"] != agent["nodes"]:
        raise AssertionError(f"{label}: the info line names "
                             f"{rec['info']['nodes']} nodes")
    if not all(q["rc"] == 0 and q["match"] for q in got_rows):
        raise AssertionError(f"{label}: a CLI query differs from the rows "
                             "the host SQL oracle gave")
    if rec["exec_rc"] != 0 or read_back is None:
        raise AssertionError(f"{label}: the exec write was not read back "
                             f"within {AGENT_MAX_ROUNDS} rounds")
    if rec["members_rc"] != 0 or rec["backup_rc"] != 0 or not (
            rec["backup_bytes"]):
        raise AssertionError(f"{label}: members or backup did not answer")
    if rec["exit_code"] != 0 or rec["traceback"]:
        raise AssertionError(f"{label}: SIGTERM did not end the agent "
                             "cleanly:\n" + stderr[-4000:])
    return rec


# the write "cli_agent_10k" makes through the agent and reads back, within
# this many of the agent's rounds
AGENT_MAX_ROUNDS = 256
AGENT_WRITE = ("INSERT INTO consul_services (node, id, name, tags, meta, "
               "port, address, updated_at) VALUES ('node-agent', "
               "'svc-agent', 'agent', '', '', 9443, '10.9.9.8', 2)")
AGENT_READ = ("SELECT node, id, port FROM consul_services "
              "WHERE id = 'svc-agent'")
AGENT_ROW = "node-agent|svc-agent|9443"


def devcluster_topology(per: int = 32) -> str:
    """Two components of ``per`` names each (A00.., B00..), each a ring
    with chords: node i bootstraps i+1, i+5 and i+11 of its ring (three
    edges, at most ten)."""
    lines = []
    for comp in "AB":
        for i in range(per):
            for step in (1, 5, 11):
                lines.append(f"{comp}{i:02d} -> {comp}{(i + step) % per:02d}")
    return "\n".join(lines) + "\n"


def consul_file(count: int) -> dict:
    """A Consul agent's services and checks, ``count`` of each."""
    return {
        "services": {f"svc{i:02d}": {
            "ID": f"svc{i:02d}", "Service": f"app{i % 8}", "Tags": ["t"],
            "Meta": {"app_id": i}, "Port": 8000 + i,
            "Address": f"10.0.{i // 8}.{i % 8}"} for i in range(count)},
        "checks": {f"chk{i:02d}": {
            "CheckID": f"chk{i:02d}", "Name": f"check {i}",
            "Status": "passing", "Output": "ok", "ServiceID": f"svc{i:02d}",
            "ServiceName": f"app{i % 8}"} for i in range(count)},
    }


DEVCLUSTER_TEMPLATE = ('<% for s in sql("SELECT id, port FROM '
                       'consul_services") %><%= s.id %>:<%= s.port %>\n'
                       '<% end %>')


def devcluster_phase(emit, work_dir: str, per: int = 32,
                     capacity: int = 192) -> int:
    """Phase ``devcluster_64``: the ``corro-devcluster`` analog at the 64
    agents of the north-star bench's devcluster leg. ``devcluster TOPO
    --schema <Consul schema> --statedir D`` runs in this process on a
    thread (its signal tripwire replaced by one the phase trips), over
    two components of 32 names, each a ring with chords. Against its
    API: ``consul-sync --once`` of 64 services and 64 checks into a node
    of component A, twice (the second writes nothing); ``template
    --once`` renders the services on another node of A; 64 ``exec``
    transactions go into a node of component B; ``reload`` adds a table,
    which one more ``exec`` writes. Checks: every node of A holds A's
    services and none of B's rows, and the other way round; the render
    is the expected text; every ``node.json`` lists its neighbours'
    gossip addresses as ``generate_bootstrap`` resolves them; one merge
    launch per sync sweep (``--capacity 192``: 2 x 192 rows x 6 columns
    = 2304 cells, 3456 once the reload's table is in, both multiples of
    128). Prints the rounds until each component holds its rows, the ms
    per round and the seconds of each CLI call. Returns the launches."""
    import threading

    from corro_sim_torch import cli
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.harness import devcluster as dc
    from corro_sim_torch.membership.bootstrap import generate_bootstrap
    from corro_sim_torch.schema import consul_schema_sql
    from corro_sim_torch.utils.runtime import Tripwire

    topo = os.path.join(work_dir, "topology.txt")
    with open(topo, "w") as f:
        f.write(devcluster_topology(per))
    schema = os.path.join(work_dir, "consul.sql")
    with open(schema, "w") as f:
        f.write(consul_schema_sql())
    state_dir = os.path.join(work_dir, "state")
    sock = os.path.join(work_dir, "devcluster.sock")
    port = _free_port()
    api = f"http://127.0.0.1:{port}"
    trip = Tripwire()
    built = {}
    orig_signals, orig_build = Tripwire.new_signals, dc.build_cluster

    def build(*a, **kw):
        built["cluster"], built["ordinals"] = orig_build(*a, **kw)
        return built["cluster"], built["ordinals"]

    Tripwire.new_signals = staticmethod(lambda: trip)
    dc.build_cluster = build
    mk.reset_launch_counts()
    out = {}
    argv = ["devcluster", topo, "--schema", schema,
            "--statedir", state_dir, "--capacity", str(capacity),
            "--api-addr", f"127.0.0.1:{port}", "--admin-path", sock,
            "--tick-interval", "0.002"]
    def serve():
        with captured_stdout() as buf:
            out["info"] = buf
            out["rc"] = cli.main(argv)

    router = sys.stdout = ThreadStdout(sys.stdout)
    th = threading.Thread(target=serve)
    t0 = time.perf_counter()
    th.start()
    rec = {"phase": "devcluster_64", "agents": 2 * per}
    secs = {}
    try:
        import urllib.request

        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(f"{api}/v1/health", timeout=5)
                break
            except OSError as e:
                if getattr(e, "code", None):
                    break
                if not th.is_alive():
                    raise AssertionError("devcluster_64: the command ended "
                                         f"with {out.get('rc')}")
                time.sleep(0.1)
        secs["start"] = time.perf_counter() - t0
        c, ordinals = built["cluster"], built["ordinals"]
        comp = {name: name[0] for name in ordinals}
        a0, a5, b0 = ordinals["A00"], ordinals["A05"], ordinals["B00"]
        consul = os.path.join(work_dir, "consul.json")
        with open(consul, "w") as f:
            json.dump(consul_file(per * 2), f)
        sync_argv = ["consul-sync", "--api", api, "--node", str(a0),
                     "--consul-file", consul, "--node-name", "nodeA",
                     "--state-path", os.path.join(work_dir, "hashes.json"),
                     "--once"]
        rc1, first, secs["consul_sync_1"] = cli_json(sync_argv)
        rc2, second, secs["consul_sync_2"] = cli_json(sync_argv)
        wrote = {"A": c._rounds_ticked}
        rec["consul_sync"] = [first, second]
        exec_s = []
        for i in range(2 * per):
            rc, _, s = cli_call([
                "exec", "--api", api, "--node", str(b0),
                "INSERT INTO consul_services (node, id, name, port) VALUES "
                f"('nodeB', 'bsvc{i:02d}', 'b', {9000 + i})"])
            if rc != 0:
                raise AssertionError("devcluster_64: an exec failed")
            exec_s.append(s)
        wrote["B"] = c._rounds_ticked
        secs["exec_mean"] = sum(exec_s) / len(exec_s)
        ids = [f"{i:02d}" for i in range(2 * per)]
        want = {"A": ({f"svc{i}" for i in ids}, {f"chk{i}" for i in ids}),
                "B": ({f"bsvc{i}" for i in ids}, set())}

        def held(node) -> tuple:
            out = []
            for table in ("consul_services", "consul_checks"):
                _, text, _ = cli_call(["query", "--api", api, "--node",
                                       str(node), f"SELECT id FROM {table}"])
                out.append({ln.split("|")[1] for ln in text.splitlines()})
            return tuple(out)

        # every node of each component holds its rows and none of the
        # other's: polled until then, the rounds counted from its writes.
        # Rows are only added, so a node that held is not asked again
        # (the check after the loop asks every node once more); the
        # polls are spaced so that they do not slow the ticks they wait on
        waiting = {name_c: [node for name, node in ordinals.items()
                            if comp[name] == name_c] for name_c in "AB"}
        held_at = {}
        t = time.perf_counter()
        while time.perf_counter() - t < 600 and len(held_at) < 2:
            for name_c, nodes in waiting.items():
                while nodes and held(nodes[0]) == want[name_c]:
                    nodes.pop(0)
                if not nodes and name_c not in held_at:
                    held_at[name_c] = c._rounds_ticked - wrote[name_c]
            time.sleep(0.25)
        secs["converge"] = time.perf_counter() - t
        rec["rounds_until_held"] = held_at
        leaks = {}
        for name, node in ordinals.items():
            got = held(node)
            if got != want[comp[name]]:
                leaks[name] = [sorted(g ^ w) for g, w in
                               zip(got, want[comp[name]])]
        rec["rows_wrong"] = leaks
        src = os.path.join(work_dir, "services.tpl")
        dst = os.path.join(work_dir, "services.txt")
        with open(src, "w") as f:
            f.write(DEVCLUSTER_TEMPLATE)
        rc_t, _, secs["template"] = cli_call([
            "template", "--api", api, "--node", str(a5), f"{src}:{dst}",
            "--once"])
        rendered = open(dst).read() if os.path.exists(dst) else ""
        rec["render_lines"] = len(rendered.splitlines())
        rec["render_ok"] = sorted(rendered.splitlines()) == sorted(
            f"svc{i:02d}:{8000 + i}" for i in range(2 * per))
        extra = os.path.join(work_dir, "extra.sql")
        with open(extra, "w") as f:
            f.write("CREATE TABLE extra (id INTEGER NOT NULL PRIMARY KEY, "
                    "v TEXT NOT NULL DEFAULT '');\n")
        rc_r, plan, secs["reload"] = cli_json(["reload", "--api", api,
                                               extra])
        rc_x, _, _ = cli_call(["exec", "--api", api, "--node", str(a0),
                               "INSERT INTO extra (id, v) VALUES (1, 'x')"])
        r1, w1 = c._rounds_ticked, time.perf_counter()
        time.sleep(1.0)
        r2, w2 = c._rounds_ticked, time.perf_counter()
        rec["ms_per_round"] = 1000.0 * (w2 - w1) / max(r2 - r1, 1)
        rec["cells"] = c.cfg.num_rows * c.cfg.num_cols
        boot_bad = []
        gossip = {n: ("127.0.0.1", 9000 + i) for n, i in ordinals.items()}
        for name in ordinals:
            with open(os.path.join(state_dir, name, "node.json")) as f:
                meta = json.load(f)
            want_b = generate_bootstrap(
                [f"{b}:{gossip[b][1]}" for b in meta["bootstrap"]],
                resolve=lambda h, p, d: [gossip[h]])
            if (meta["bootstrap_addrs"] != [list(a) for a in want_b]
                    or len(meta["bootstrap"]) > 10
                    or comp[name] != {comp[b] for b in meta["bootstrap"]}
                    .pop()):
                boot_bad.append(name)
        rec["bootstrap_bad"] = boot_bad
    finally:
        trip.trip()
        th.join(timeout=60)
        sys.stdout = router.real
        Tripwire.new_signals, dc.build_cluster = orig_signals, orig_build
    info = json.loads(out["info"].getvalue().splitlines()[0])
    launches = mk.LAUNCHES["grouped_merge"]
    sweeps = int(built["cluster"].state.sync_rounds) if built else None
    rec.update({"rc": out.get("rc"), "info_nodes": len(info["nodes"]),
                "consul_rc": [rc1, rc2],
                "template_rc": rc_t, "reload_rc": rc_r,
                "reload_new_tables": plan.get("new_tables"),
                "extra_exec_rc": rc_x, "launches": launches,
                "sync_sweeps": sweeps, "seconds": secs})
    emit(rec)
    if rec["rc"] != 0 or th.is_alive() or info["nodes"] != ordinals:
        raise AssertionError("devcluster_64: the command did not end with "
                             "exit 0 once tripped")
    if ([rc1, rc2] != [0, 0] or first["services_upserted"] != 2 * per
            or first["checks_upserted"] != 2 * per
            or any(second.values())):
        raise AssertionError("devcluster_64: consul-sync did not write the "
                             "file once and then nothing")
    if len(held_at) != 2 or leaks:
        raise AssertionError("devcluster_64: a component does not hold "
                             "exactly its own rows")
    if rc_t != 0 or not rec["render_ok"]:
        raise AssertionError("devcluster_64: the template render differs")
    if rc_r != 0 or "extra" not in plan.get("new_tables", ()) or rc_x != 0:
        raise AssertionError("devcluster_64: reload did not add the table")
    if boot_bad:
        raise AssertionError("devcluster_64: node.json bootstrap addresses "
                             f"differ for {boot_bad}")
    if launches == 0 or launches != sweeps:
        raise AssertionError("devcluster_64: not one merge launch per sync "
                             "sweep")
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


def serve_equal(got, want) -> bool:
    """Whether two ``serve_lanes`` results agree where the merge reads
    them: the mailbox's live row everywhere, its other rows on live
    lanes, the per-node stamps and the two counts."""
    import torch

    from corro_sim_torch.core.merge_kernel import LANE_FIELDS, LANE_VALID

    box, box_cap, stamp, counts = got
    w_box, w_cap, w_stamp, w_counts = want
    live = w_box[LANE_VALID] != 0
    return (box_cap == w_cap
            and torch.equal(box[LANE_VALID], w_box[LANE_VALID])
            and all(torch.equal(box[f][live], w_box[f][live])
                    for f in range(LANE_FIELDS - 1))
            and torch.equal(stamp, w_stamp)
            and torch.equal(counts, w_counts))


def serve_kernel_phase(emit) -> dict:
    """Phases ``serve_north_star`` and ``serve_catchup``: the sync sweep's
    serve kernel (``corro_sim_torch/sync/csrc/serve_kernel.cu``) on the
    main path's own inputs. The north-star cluster (config 0 at 10 000
    nodes, SWIM off: 128 lanes a node) and config 5's catch-up cluster
    (16 384 nodes: 8192 lanes a node) run to convergence with every
    sweep's ``serve_lanes`` call held to ``serve_lanes_reference`` on the
    same inputs (:func:`serve_equal`), and one launch per sweep run. Then
    ``kernel_check_serve_<case>``: on the inputs of the run's heaviest
    sweep (most versions served), the kernel and its plain version timed
    with CUDA events, against the least bytes the call moves
    (``serve_work``) at the card's HBM rate. Returns the timings by
    case."""
    import dataclasses

    import torch

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.merge_probe import time_ms
    from corro_sim_torch.profile_slice import (
        CONFIG5_RUN_ARGS,
        config5_config,
        config5_schedule,
        slice_config,
        slice_schedule,
    )
    from corro_sim_torch.sync import serve as sv
    from corro_sim_torch.sync import sync as sync_mod

    real = sync_mod.serve_lanes
    catchup = config5_config()
    out = {}
    for case, cfg, schedule, run_args, want_round in (
            ("north_star", slice_config(), slice_schedule(), None,
             SLICE_ROUNDS),
            ("catchup", catchup, config5_schedule(catchup.num_nodes),
             CONFIG5_RUN_ARGS, None)):
        seen = {"sweeps": 0, "most": -1, "args": None}

        def spy(*a, case=case, seen=seen):
            got = real(*a)
            seen["sweeps"] += 1
            if not serve_equal(got, sv.serve_lanes_reference(*a)):
                raise AssertionError(
                    f"serve_{case}: sweep {seen['sweeps']}: serve_lanes "
                    "differs from serve_lanes_reference")
            versions = int(a[1].sum())
            if versions > seen["most"]:
                topa, take, base, win, log, chl = a[:6]
                seen["most"] = versions
                seen["args"] = (
                    topa.clone(), take.clone(), base.clone(), win.clone(),
                    dataclasses.replace(
                        log, cells=log.cells.clone(),
                        ncells=log.ncells.clone(), live=log.live.clone(),
                        cleared=log.cleared.clone(), head=log.head.clone()),
                    chl.clone(), *a[6:])
            return got

        sv.LAUNCHES["serve_lanes"] = 0
        sync_mod.serve_lanes = spy
        try:
            rec, res = drive(cfg, schedule, run_args)
        finally:
            sync_mod.serve_lanes = real
        del res
        launches = sv.LAUNCHES["serve_lanes"]
        label = f"serve_{case}"
        emit({"phase": label, "nodes": cfg.num_nodes,
              "rounds_to_convergence": rec["rounds_to_convergence"],
              "final_gap": rec["final_gap"],
              "sync_sweeps": rec["sync_sweeps"],
              "sweeps_run": rec["sweeps_run"], "launches": launches,
              "sweeps_checked": seen["sweeps"], "bit_equal": True,
              "heaviest_sweep_versions": seen["most"],
              "max_memory_allocated": rec["max_memory_allocated"]})
        if want_round is not None:
            check_run(label, rec, want_round)
        elif rec["rounds_to_convergence"] is None or rec["final_gap"]:
            raise AssertionError(f"{label}: the cluster did not converge")
        if launches != rec["sweeps_run"] or seen["sweeps"] != launches:
            raise AssertionError(
                f"{label}: {launches} serve launches, {seen['sweeps']} "
                f"checked, for {rec['sweeps_run']} sweeps run")

        a = seen["args"]
        del seen
        torch.cuda.empty_cache()
        topa, take, base, _win, log, _chl, cap = a[:7]
        got = sv.serve_lanes(*a)
        if not serve_equal(got, sv.serve_lanes_reference(*a)):
            raise AssertionError(f"{label}: the kept sweep differs")
        box_cap = got[1]
        del got
        torch.cuda.empty_cache()
        kernel_ms = time_ms(lambda: sv.serve_lanes(*a), 5)
        plain_ms = time_ms(lambda: sv.serve_lanes_reference(*a), 3, 1)
        nbytes, served = sv.serve_work(topa, take, base, log, cap)
        bound, bound_by = mk.bound_ms((nbytes, 0))
        out[case] = {
            "shape": {"nodes": topa.shape[0], "kprime": topa.shape[1],
                      "cap": cap, "seqs": log.seqs, "box_cap": box_cap},
            "served": served, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
            "share_of_bound": bound / kernel_ms,
        }
        emit(dict(phase=f"kernel_check_{label}", kernel="serve_lanes",
                  bit_equal=True, **out[case]))
        del a, topa, take, base, log
        torch.cuda.empty_cache()
    return out


# the ticks "churn_10k_swim" holds to the plain reference: an announce
# tick before the split, one inside it (with the control), one after it
CHURN_CHECK_ROUNDS = (8, 17, 33)
# the rounds it profiles for SWIM's ranges: the split's start
CHURN_TRACE_ROUNDS = (8, 24)
SWIM_RANGES = ("corro.swim.probe", "corro.swim.timeout",
               "corro.swim.exchange", "corro.swim.announce",
               "corro.swim.refute")


def churn_swim_phase(emit, n: int = 10000, device: str = "cuda") -> dict:
    """Phase ``churn_10k_swim``: the JAX package's config 4 (the
    benchmark's ``churn_10k.steady``: wide full-view SWIM every round,
    writes at 0.5 per node per round, the upper half split in rounds
    16-31) at ``n`` nodes through ``run_sim`` for its 40 rounds. Every
    call of the step's ``swim_step`` in the rounds of
    ``CHURN_CHECK_ROUNDS`` (speculative ones too) is held bit for bit to
    ``simbench/reference/swim.py`` ticked from a copy of the plane before
    it (integers: tolerance 0). Then a second cluster runs its 40 rounds
    with ``torch.profiler`` over ``CHURN_TRACE_ROUNDS``, and the device
    time of the work launched inside each ``corro.swim.*`` range and the
    rest of ``corro.step.swim`` is read per round
    (``simbench/trace.py::reduce_trace``). ``device``: "cpu" rehearses
    the phase at a small ``n``. Returns the phase's record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine import step as step_mod
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.profile_slice import (
        CONFIG4_RUN_ARGS,
        config4_config,
        config4_schedule,
        partition_upper_half_16_32,
    )
    from simbench import trace as trace_mod
    from simbench.reference import swim as ref_swim

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        mk.build_kernel()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg = config4_config(n)
    params = ref_swim.Params.from_sim(cfg)
    real = step_mod.swim_step
    checks = []

    def spy(cfg_, swim, key, alive, reach, round_idx, mesh=None):
        if round_idx not in CHURN_CHECK_ROUNDS:
            return real(cfg_, swim, key, alive, reach, round_idx, mesh=mesh)
        before = swim.p.clone()
        out = real(cfg_, swim, key, alive, reach, round_idx, mesh=mesh)
        sync()
        t0 = time.perf_counter()
        part = torch.as_tensor(partition_upper_half_16_32(round_idx, n),
                               device=before.device)
        want = ref_swim.swim_tick(before, key, alive, part, round_idx,
                                  params)
        differ = int((want != out[0].p).sum())
        sync()
        check = {"round": round_idx, "differ": differ,
                 "announce": ref_swim.is_announce(params, round_idx),
                 "reference_s": time.perf_counter() - t0}
        del want
        if round_idx == CHURN_CHECK_ROUNDS[1]:
            # the control, inside the split where suspicions start: the
            # reference in the narrow layout, the nearest below the
            # configuration's, must differ
            narrow = dataclasses.replace(params, narrow=True)
            control = ref_swim.swim_tick(before, key, alive, part,
                                         round_idx, narrow)
            check["control_differ"] = int((control != out[0].p).sum())
            del control
        checks.append(check)
        del before
        return out

    step_mod.swim_step = spy
    try:
        t0 = time.perf_counter()
        state = init_state(cfg, seed=0, device=device)
        res = run_sim(cfg, state, config4_schedule(), device=device,
                      **CONFIG4_RUN_ARGS)
        sync()
        run_s = time.perf_counter() - t0
    finally:
        step_mod.swim_step = real
    rounds = res.rounds
    plane = res.state.swim.p
    plane_bytes = plane.numel() * plane.element_size()
    plane_dtype = plane.dtype
    del state, res, plane
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    checked = sorted({c["round"] for c in checks})
    if (checked != list(CHURN_CHECK_ROUNDS)
            or any(c["differ"] for c in checks)
            or not any(c.get("control_differ") for c in checks)):
        raise AssertionError(f"churn_10k_swim: the plane differs from the "
                             f"plain reference or a tick went unchecked: "
                             f"{checks}")

    # SWIM's ranges over the split's start, in a clean cluster
    lo, hi = CHURN_TRACE_ROUNDS
    session = {}

    def on_chunk(info):
        done = info["rounds_done"]
        if done == lo:
            sync()
            session["prof"] = profile(activities=[ProfilerActivity.CPU]
                                      + [ProfilerActivity.CUDA] * cuda)
            session["prof"].start()
        elif done == hi and "prof" in session:
            sync()
            session["prof"].stop()
            session["path"] = os.path.join("bench_out",
                                           "churn_10k_swim_trace.json")
            os.makedirs("bench_out", exist_ok=True)
            session["prof"].export_chrome_trace(session["path"])

    if cuda:
        torch.cuda.empty_cache()
    state = init_state(cfg, seed=0, device=device)
    res = run_sim(cfg, state, config4_schedule(), device=device,
                  on_chunk=on_chunk, **CONFIG4_RUN_ARGS)
    del state, res
    names = ("corro.step", "corro.step.swim") + SWIM_RANGES
    red = trace_mod.reduce_trace(trace_mod.load_events(session["path"]),
                                 names)
    os.remove(session["path"])
    traced = hi - lo
    ms = {k: v / 1000.0 / traced for k, v in red["range_us"].items()}
    inner = sum(ms[k] for k in SWIM_RANGES)
    swim_ms = inner + ms["corro.step.swim"]
    out = {"phase": "churn_10k_swim", "nodes": n, "rounds": rounds,
           "rounds_compared": checked, "calls_compared": len(checks),
           "checks": checks, "bit_equal": True, "tolerance": 0,
           "plane_bytes": plane_bytes, "plane_dtype": str(plane_dtype),
           "run_s": run_s, "max_memory_allocated": peak,
           "traced_rounds": [lo, hi],
           "swim_ms_per_round": swim_ms,
           "ranges_ms_per_round": {k: ms[k] for k in SWIM_RANGES},
           "swim_rest_ms_per_round": ms["corro.step.swim"],
           "ranges_cover": inner / swim_ms if swim_ms else None,
           "busy_share": (red["busy_us"] / red["window_us"]
                          if red.get("window_us") else None)}
    emit(out)
    return out


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


def config_digest_phase(emit) -> dict:
    """Phase ``config_digests``: each ``CONFIG_DIGEST_CASES`` case (configs
    4, 5, 7 and 6 at the node counts the JAX package's CPU runs took) on
    the card, held to that run's digest and converged round, with one
    merge launch per sweep where the kernel runs. Returns the launches
    by case."""
    import torch

    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.profile_slice import (
        CONFIG_DIGEST_CASES,
        CONFIG_DIGEST_ROUNDS,
        DIGESTS,
        config_digest_case,
        run_digest,
    )

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
        if mk.kernel_supported(spec["cfg"], "sync", torch.device("cuda")):
            one_launch_per_sweep(case, rec)
    emit({"phase": "config_digests", "cases": cdig})
    for case, d in cdig.items():
        if not d["match"] or d["converged_round"] != d["want_round"]:
            raise AssertionError(f"{case} on the card differs from the JAX "
                                 "package's run")
    return cdig_launches


@contextlib.contextmanager
def big_memory():
    """Held around the phases whose peak would not fit beside the other
    process's largest (config 5 at 52 GB, the 10k twin at 13 GB): the
    two processes never run such phases at once."""
    import fcntl

    os.makedirs("bench_out", exist_ok=True)
    with open(os.path.join("bench_out", ".big_memory.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def mesh_1rank_phase(emit) -> int:
    """"mesh_1rank": the device mesh as one NCCL rank on the card. A
    one-rank world (``engine/ranks.py::init_single``, a FileStore
    rendezvous) runs config 0 at 10 000 nodes with the merge kernel
    forced, once through ``run_sim(mesh=make_mesh())`` — delivery through
    ``route_merge_sharded``, the sync sweep through
    ``merge_grouped(mesh=)``, the step's collectives on NCCL — and once
    without a mesh; the digests and rounds must agree, the sharding block
    must name one device and no downgrade, and both mesh sites must
    launch the kernel. Then ``route_merge_sharded`` on one round's real
    delivery lanes: held to ``grouped_merge_reference``, timed with CUDA
    events, with its ``all_to_all_single`` timed alone and the same merge
    through ``route_lanes`` + ``merge_grouped`` without a mesh. Returns
    the mesh run's merge launches."""
    import tempfile

    import torch

    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import delivery
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.core.crdt import TableState
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.ranks import init_single, shutdown
    from corro_sim_torch.engine.sharding import (
        gather_state,
        make_mesh,
        mesh_shardings,
        resolve_shard_log,
    )
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.merge_probe import nvidia_smi
    from corro_sim_torch.profile_slice import (
        RUN_ARGS,
        run_digest,
        slice_config,
        slice_schedule,
    )

    t_phase = time.perf_counter()
    os.makedirs("bench_out", exist_ok=True)
    init_single("cuda", tempfile.mkdtemp(prefix="mesh_", dir="bench_out"))
    try:
        mesh = make_mesh()
        cfg = slice_config(10000, merge_kernel="on", swim=True)
        runs = {}
        for label, m in (("mesh", mesh), ("plain", None)):
            mk.reset_launch_counts()
            t0 = time.perf_counter()
            res = run_sim(cfg, init_state(cfg, seed=0, device="cuda",
                                          mesh=m),
                          slice_schedule(), device="cuda", mesh=m,
                          **RUN_ARGS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the mesh run's state stays sharded: gathered to the host
            final = (res.state if m is None else gather_state(
                res.state, m, mesh_shardings(cfg, m)))
            runs[label] = {
                "converged_round": res.converged_round,
                "final_gap": float(res.metrics["gap"][-1]),
                "digest": run_digest(state_to_numpy(final), res.metrics),
                "wall_s": wall,
                "wall_per_round_ms": res.wall_per_round_ms,
                "launches": dict(mk.LAUNCHES),
                "site_launches": dict(mk.MESH_SITE_LAUNCHES),
                "sweeps_run": res.pipeline["sweeps_run"],
                "sharding": res.sharding,
            }
            del res, final
        want_sharding = {"devices": 1, "mesh_shape": {"nodes": 1},
                         "shard_log": ("actor_sharded" if resolve_shard_log(
                             cfg) else "replicated"),
                         "merge_kernel": "on", "downgrades": []}
        mr, pr = runs["mesh"], runs["plain"]
        sites = mr["site_launches"]
        bad = []
        if (mr["digest"], mr["converged_round"]) != (
                pr["digest"], pr["converged_round"]):
            bad.append("the mesh run differs from the run without one")
        if mr["converged_round"] is None or mr["final_gap"] != 0.0:
            bad.append("the mesh run did not converge")
        if mr["sharding"] != want_sharding:
            bad.append(f"sharding {mr['sharding']} != {want_sharding}")
        if min(sites.values()) == 0:
            bad.append(f"a mesh site launched no kernel: {sites}")
        if sum(sites.values()) != mr["launches"]["grouped_merge"]:
            bad.append("launches outside the two mesh sites")
        if sites["merge_grouped_mesh"] != mr["sweeps_run"]:
            bad.append("not one mesh sync launch per sweep run")

        # one round's real delivery lanes: the call with the most cells
        caught = {}
        real = delivery.route_merge_sharded

        def capture(state, *args):
            live = int(args[7].sum())
            if live > caught.get("live", -1):
                caught.update(live=live, args=[
                    a.clone() if torch.is_tensor(a) else a for a in args],
                    planes=[t.clone() for t in (state.cv, state.vr,
                                                state.site, state.cl)])
            return real(state, *args)

        delivery.route_merge_sharded = capture
        try:
            run_sim(cfg, init_state(cfg, seed=0, device="cuda", mesh=mesh),
                    slice_schedule(), device="cuda", mesh=mesh,
                    **dict(RUN_ARGS, max_rounds=16, min_rounds=16))
        finally:
            delivery.route_merge_sharded = real
        args, planes = caught["args"], caught["planes"]
        dst, rank, cell, cv, vr, site, cl, valid, cap, _ = args
        n, r, c = planes[0].shape

        def fresh():
            return TableState(*(t.clone() for t in planes))

        box = mk.route_lanes(dst, rank, cell, cv, vr, site, cl, valid, n,
                             cap)
        flat0 = [t.reshape(n, r * c) for t in planes[:3]] + [planes[3]]
        ref = mk.grouped_merge_reference(*flat0, box, cap, c)
        got = mk.route_merge_sharded(fresh(), *args[:8], cap, mesh)
        max_abs_err = max(
            int((g.reshape(n, -1).long() - w.long()).abs().max())
            for g, w in zip((got.cv, got.vr, got.site, got.cl), ref))
        if max_abs_err:
            bad.append(f"route_merge_sharded differs from the plain "
                       f"merge by {max_abs_err}")

        def timed(fn, reps=20):
            out = []
            for _ in range(reps):
                st = fresh()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn(st)
                e1.record()
                torch.cuda.synchronize()
                out.append(e0.elapsed_time(e1))
            return float(np.median(out))

        mk.reset_launch_counts()
        route_ms = timed(lambda st: mk.route_merge_sharded(
            st, *args[:8], cap, mesh))
        plain_path_ms = timed(lambda st: mk.merge_grouped(st, mk.route_lanes(
            dst, rank, cell, cv, vr, site, cl, valid, n, cap), cap))
        buckets = torch.zeros((1, dst.shape[0], mk.BUCKET_FIELDS),
                              dtype=torch.int32, device="cuda")
        exchange_ms = timed(lambda st: mesh.all_to_all(buckets))
        # the function's parts apart: bucket sort + exchange, placement
        # scatter, the kernel on the placed mailbox
        route_args = (*args[:8], cap, n, mesh)
        routed = mk.route_to_shards(*route_args)
        placed = mk.place_lanes(routed, 0, n, cap)
        parts_ms = {
            "route_to_shards_ms": timed(
                lambda st: mk.route_to_shards(*route_args)),
            "place_lanes_ms": timed(
                lambda st: mk.place_lanes(routed, 0, n, cap)),
            "grouped_merge_ms": timed(lambda st: mk.merge_grouped(
                st, placed, cap)),
        }
        reference_ms = timed(lambda st: mk.grouped_merge_reference(
            *flat0, box, cap, c))
        work = mk.merge_work(flat0, box, cap, c, ref)
        exchange_bytes = 32 * dst.shape[0]
        bound, bound_by = mk.bound_ms((work[0] + exchange_bytes, work[1]))
        timing = {
            "lanes": int(dst.shape[0]), "live_cells": caught["live"],
            "cap": cap, "route_merge_sharded_ms": route_ms,
            "all_to_all_ms": exchange_ms,
            "all_to_all_share": exchange_ms / route_ms, **parts_ms,
            "route_lanes_merge_grouped_ms": plain_path_ms,
            "plain_ms": reference_ms, "bound_ms": bound,
            "bound_by": bound_by, "exchange_bytes": exchange_bytes,
            "max_abs_err": max_abs_err,
        }
    finally:
        shutdown()
    emit({"phase": "mesh_1rank", "nodes": 10000, "card": nvidia_smi(),
          "runs": runs, "route_merge_sharded": timing,
          "phase_s": time.perf_counter() - t_phase})
    if bad:
        raise AssertionError("mesh_1rank: " + "; ".join(bad))
    return mr["launches"]["grouped_merge"]


def transfer_guard_phase(emit, n: int = 10000) -> int:
    """"transfer_guard_10k": config 0 at 10 000 nodes, the bench's north
    star shape (the "swim_slice" run), through ``run_sim(
    transfer_guard=True)`` with ``torch.cuda.set_sync_debug_mode("error")``
    armed over the chunk loop: it must converge with the merge kernel
    launched and equal, in round and digest, the unguarded run of the
    same seed, which runs first, under the sync debug mode's "warn" so
    that every host sync it makes is counted. The guarded run's reads per
    sanctioned point per round are printed and the ``sync_gate`` reads
    held to the pipeline's ``host_reads``; a deliberate ``.item()``
    inside a guarded region, outside every point, must raise. The host's
    waits are printed per round for both runs: on the sweep gate's reads
    (event waits, which the sync debug mode does not see) and on the
    chunks' metrics (the pipeline's ``fetch_wait_s``). Returns the
    guarded run's merge launches."""
    import warnings

    import torch

    from corro_sim_torch.analysis.transfer_guard import guarded, sanctioned
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.core import merge_kernel as mk
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.merge_probe import nvidia_smi
    from corro_sim_torch.profile_slice import (
        RUN_ARGS,
        run_digest,
        slice_config,
        slice_schedule,
    )
    from corro_sim_torch.utils.metrics import SWEEP_GATE_WAIT, histograms

    def gate_wait_s() -> float:
        h = histograms.get(SWEEP_GATE_WAIT)
        return 0.0 if h is None else h.sum

    t_phase = time.perf_counter()
    cfg = slice_config(n, swim=True)
    runs = {}
    syncs = None
    for guard in (False, True):
        state = init_state(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        mk.reset_launch_counts()
        gate_wait0 = gate_wait_s()
        caught = contextlib.nullcontext([])
        if not guard:
            caught = warnings.catch_warnings(record=True)
        with caught as seen:
            if not guard:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            try:
                res = run_sim(cfg, state, slice_schedule(), device="cuda",
                              transfer_guard=guard, **RUN_ARGS)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        if not guard:
            syncs = sum("synchroniz" in str(w.message) for w in seen)
        del state
        runs["guarded" if guard else "unguarded"] = {
            "converged_round": res.converged_round,
            "rounds": res.rounds,
            "final_gap": float(res.metrics["gap"][-1]),
            "digest": run_digest(state_to_numpy(res.state), res.metrics),
            "wall_per_round_ms": res.wall_per_round_ms,
            "launches": mk.LAUNCHES["grouped_merge"],
            "sweeps_run": res.pipeline["sweeps_run"],
            "host_reads": res.pipeline["host_reads"],
            "sanctioned": res.transfer_guard,
            "gate_wait_ms_per_round": 1e3 * (
                gate_wait_s() - gate_wait0) / res.rounds,
            "fetch_wait_ms_per_round": (
                1e3 * res.pipeline["fetch_wait_s"] / res.rounds),
        }
        del res
        torch.cuda.empty_cache()
    g, u = runs["guarded"], runs["unguarded"]
    per_round = {k: v / g["rounds"] for k, v in g["sanctioned"].items()}
    # a host read inside a guarded region, outside every point
    x = torch.arange(8, device="cuda")
    refused = None
    with guarded(True, "cuda"):
        try:
            x.sum().item()
        except RuntimeError as e:
            refused = str(e).splitlines()[0]
        with sanctioned("smoke_check"):
            allowed = x.sum().item() == 28
    emit({"phase": "transfer_guard_10k", "nodes": n, "card": nvidia_smi(),
          "runs": runs, "sanctioned_per_round": per_round,
          "sync_gate_equals_host_reads": (
              g["sanctioned"].get("sync_gate", 0) == g["host_reads"]),
          "warn_mode_syncs_unguarded_run": syncs,
          "unsanctioned_item_refused": refused, "sanctioned_item": allowed,
          "guard_cost_ms_per_round": (g["wall_per_round_ms"]
                                      - u["wall_per_round_ms"]),
          "phase_s": time.perf_counter() - t_phase})
    bad = []
    if g["converged_round"] is None or g["final_gap"] != 0.0:
        bad.append("the guarded run did not converge")
    if (g["converged_round"], g["digest"]) != (u["converged_round"],
                                               u["digest"]):
        bad.append("the guarded run differs from the unguarded one")
    if g["launches"] <= 0 or g["launches"] != g["sweeps_run"]:
        bad.append("the guarded run did not launch the kernel once per "
                   "sweep")
    if g["sanctioned"].get("sync_gate", 0) != g["host_reads"]:
        bad.append("sync_gate reads differ from the pipeline's host reads")
    if refused is None or not allowed:
        bad.append("the guard let an unsanctioned .item() through")
    if bad:
        raise AssertionError("transfer_guard_10k: " + "; ".join(bad))
    return g["launches"]


def native_codec_phase(emit, chunk: int = 2048) -> None:
    """"native_codec": the C++ pk codec built with g++ on the card's
    machine (``io/native.py``; it must be available, not the fallback),
    and the trace fixtures ``tests/fixtures/traces/flyio_small.ndjson``
    and ``flyio_live.ndjson`` decoded through the batch path: their
    parseable lines cycled into chunks of ``chunk`` lines, each chunk
    parsed by ``io/traces.py::parse_trace_lines`` with the native codec
    and with the Python codec, which must agree; ms per chunk for both.
    Then end to end on twin_10k's feed (``profile_slice.TWIN_10K_FEED``)
    with either codec, in turns: the twin's seconds per chunk in
    ``TraceStream.feed`` (a line at a time, a few blobs per call: below
    the batch threshold, so both decode in Python) and the seconds of
    ``ingest`` of its parseable lines (one bulk batch, the path the C++
    codec serves)."""
    import itertools

    from corro_sim_torch.engine.twin import twin_universe
    from corro_sim_torch.io import columns, native, traces
    from corro_sim_torch.merge_probe import nvidia_smi
    from corro_sim_torch.profile_slice import (
        TWIN_10K_CHUNK,
        TWIN_10K_FEED,
        twin_feed,
    )

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError(f"native_codec: {native.reason()}")
    lines = []
    for name in ("flyio_small.ndjson", "flyio_live.ndjson"):
        with open(os.path.join("tests", "fixtures", "traces", name)) as f:
            for ln in f.read().splitlines():
                try:
                    traces.parse_trace_line(ln)
                except (ValueError, KeyError, TypeError):
                    continue  # the live feed's hostile lines
                lines.append(ln)
    chunks = [list(itertools.islice(itertools.cycle(lines), i, i + chunk))
              for i in range(3)]
    blobs = [bytes(c["pk"]) for ln in chunks[0]
             for c in json.loads(ln).get("changes", ())
             if "versions" not in json.loads(ln)]

    def python_batch(bs):
        return [columns.unpack_columns(b) for b in bs]

    def timed(fn) -> float:
        best = []
        for c in chunks * 3:
            t0 = time.perf_counter()
            fn(c)
            best.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(best))

    native_ms = timed(traces.parse_trace_lines)
    got = [traces.parse_trace_lines(c) for c in chunks]
    batch_native = native.unpack_columns_batch(blobs)
    plain = traces.unpack_columns_batch
    traces.unpack_columns_batch = python_batch
    try:
        python_ms = timed(traces.parse_trace_lines)
        want = [traces.parse_trace_lines(c) for c in chunks]
    finally:
        traces.unpack_columns_batch = plain
    equal = got == want and batch_native == python_batch(blobs)

    feed = twin_feed(**TWIN_10K_FEED)
    uni = twin_universe(feed.lines, 0)
    bulk, seen = [], set()
    for ln in feed.lines:
        try:
            ev = traces.parse_trace_line(ln)
        except (ValueError, KeyError, TypeError):
            continue  # the feed's hostile lines
        if isinstance(ev, traces.TraceChangeset):
            if (ev.actor_id, ev.version) in seen:
                continue  # a copy: strict ingest refuses it
            seen.add((ev.actor_id, ev.version))
        bulk.append(ln)

    def twin_feed_s() -> float:
        stream = traces.TraceStream(uni)
        t0 = time.perf_counter()
        for i in range(0, len(feed.lines), TWIN_10K_CHUNK):
            stream.feed(feed.lines[i:i + TWIN_10K_CHUNK], skip_bad=True)
        return (time.perf_counter() - t0) / -(-len(feed.lines)
                                              // TWIN_10K_CHUNK)

    def ingest_s() -> float:
        t0 = time.perf_counter()
        traces.ingest(bulk)
        return time.perf_counter() - t0

    e2e = {"native": [], "python": []}
    for _ in range(3):
        for name in ("native", "python"):
            traces.unpack_columns_batch = (plain if name == "native"
                                           else python_batch)
            try:
                e2e[name].append((twin_feed_s(), ingest_s()))
            finally:
                traces.unpack_columns_batch = plain
    twin_10k = {"lines": len(feed.lines), "chunk_lines": TWIN_10K_CHUNK,
                "ingest_lines": len(bulk)}
    for name, rows in e2e.items():
        twin_10k[f"{name}_feed_s_per_chunk"] = [r[0] for r in rows]
        twin_10k[f"{name}_ingest_s"] = [r[1] for r in rows]
    emit({"phase": "native_codec", "card": nvidia_smi(),
          "library": native.BUILD_INFO.get("library"),
          "build": native.BUILD_INFO.get("status"),
          "build_s": native.BUILD_INFO.get("seconds"),
          "fixture_lines": len(lines), "chunk_lines": chunk,
          "blobs_per_chunk": len(blobs), "equal": equal,
          "native_ms_per_chunk": native_ms,
          "python_ms_per_chunk": python_ms, "twin_10k_feed": twin_10k,
          "phase_s": time.perf_counter() - t_phase})
    if not equal:
        raise AssertionError("native_codec: the native codec's parse "
                             "differs from the Python codec's")


def helper_phases(emit) -> dict:
    """The phases that share no state with the rest: the 256- to
    4000-node runs held to the JAX package's digests, the fleet sweeps,
    the 10k twin and the 256-node live and serving runs. A second
    process runs them on the same card while this one runs the others
    (``spawn_helper``). Returns their merge launches by path."""
    launches = {}
    launches["twin_digests"] = twin_digest_phase(emit)
    with big_memory():
        launches["twin_10k"] = twin_10k_phase(emit)
    launches["fault_digests"] = fault_digest_phase(emit)
    launches["slice8_digests"] = slice8_digest_phase(emit)
    (launches["config8_sweep"],
     launches["config8_serial"]) = config8_sweep_phase(
         emit, CONFIG8_SMOKE_SEEDS)
    launches["config8_compact"] = config8_compact_phase(emit)
    launches["config8_1024"] = config8_1024_phase(emit)
    launches["subs_digests"] = subs_digest_phase(emit)
    os.makedirs("bench_out", exist_ok=True)
    launches["live_digests"] = live_digests_phase(emit, "bench_out")
    launches["config6_live"] = config6_live_phase(emit)
    launches["serve_256"] = serve_256_phase(emit)
    launches.update(config_digest_phase(emit))
    launches["mesh_1rank"] = mesh_1rank_phase(emit)
    launches["transfer_guard_10k"] = transfer_guard_phase(emit)
    native_codec_phase(emit)
    return launches


def spawn_helper():
    """Starts ``chip_smoke.py --helper`` (``helper_phases`` in a process
    of its own, on the same card; it dies with this one), its standard
    output into a file under bench_out. Returns ``(process, path)``."""
    import ctypes
    import signal
    import subprocess
    import tempfile

    os.makedirs("bench_out", exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="helper_", suffix=".jsonl",
                                dir="bench_out")

    def die_with_parent():
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)

    with os.fdopen(fd, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--helper"],
            stdout=out, preexec_fn=die_with_parent)
    return proc, path


def stop_helper(proc) -> None:
    """Kills the helper if it still runs (this process is ending)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def join_helper(proc, path: str, timeout: float = 900.0) -> tuple:
    """Waits for the helper, prints its phase lines here and returns its
    merge and serve kernel launches by path; raises if it failed."""
    import subprocess

    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"the helper process ran past {timeout} s")
    with open(path) as f:
        lines = f.read().splitlines()
    os.remove(path)
    launches = serve = None
    for ln in lines:
        obj = json.loads(ln)
        if "helper_launches" in obj:
            launches = obj["helper_launches"]
            serve = obj["helper_serve_launches"]
        else:
            print(ln, flush=True)
    if rc != 0 or launches is None:
        raise AssertionError(f"the helper process failed (exit {rc})")
    return launches, serve


def helper_main() -> int:
    """``chip_smoke.py --helper``: ``helper_phases`` on the card, one
    JSON line per phase and then ``{"helper_launches": {...},
    "helper_serve_launches": {...}}``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from corro_sim_torch.core import merge_kernel as mk

    mk.build_kernel()
    launches = helper_phases(emit)
    print(json.dumps({"helper_launches": launches,
                      "helper_serve_launches": SERVE_BY_PHASE}), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["--helper"]:
        return helper_main()
    if argv:
        print("usage: chip_smoke.py", file=sys.stderr)
        return 2
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
        CONFIG3_RUN_ARGS,
        CONFIG4_RUN_ARGS,
        CONFIG5_RUN_ARGS,
        CONFIG7_RUN_ARGS,
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

    # ------------------ the serve kernel on the main path's own sweeps
    serve_kernel = serve_kernel_phase(emit)
    churn_swim_phase(emit)

    # the phases that share nothing with the rest run in a second process
    # on the card from here on, after the kernels' timings above
    helper = spawn_helper()
    atexit.register(stop_helper, helper[0])

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

    # ------------------ the same cluster through the command line
    import tempfile

    os.makedirs("bench_out", exist_ok=True)
    cli_run_launches = cli_run_phase(
        emit, tempfile.mkdtemp(prefix="cli_run_", dir="bench_out"))
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

    # ------- config 6 exactly, 10 000 nodes, its load and as many rounds
    t0 = time.perf_counter()
    wl = config6_workload(10000)
    gen_s = time.perf_counter() - t0
    cfg = config6_config(10000)
    c6k_rec, res = drive(cfg, Schedule(), dict(
        CONFIG6_RUN_ARGS, max_rounds=CONFIG6_10K_ROUNDS,
        stop_on_convergence=False), workload=wl)
    stage_s = res.stage_seconds
    del res
    emit(dict(phase="config6_10k", spec=wl.spec, rows=cfg.num_rows,
              emit_slots=cfg.emit_slots, pend_slots=cfg.pend_slots,
              schedule_writes=wl.total_writes,
              schedule_deletes=wl.total_deletes,
              schedule_generation_s=gen_s, schedule_staging_s=stage_s,
              **c6k_rec))
    if (c6k_rec["rounds_run"] != CONFIG6_10K_ROUNDS
            or c6k_rec["log_wrapped_max"]):
        raise AssertionError("config 6 at 10k: the run stopped early or "
                             "the change log wrapped")
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
        with big_memory():
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

    # ------- faults: the 10k soak and the churn soak at 4096 nodes
    fault_launches = {}
    fault_launches["soak_10k"], soak_ref = soak_phase(emit)
    fault_launches["swim_churn_4096"] = swim_churn_phase(emit)

    # ------- the rest of the step: latency ring, RTT rings, probes, the
    # legacy and deal-probe sync schedules
    fault_launches["latency_10k"] = latency_phase(emit)
    fault_launches["legacy_sync_10k"] = legacy_phase(emit)

    # ------- resumable checkpoints
    fault_launches["checkpoint_10k"] = checkpoint_phase(emit, soak_ref)
    del soak_ref

    # ------- the subscription engine: config 6's live-half population of
    # 64 matchers and 1024 subscribers on a replayed Consul table at 10k
    fault_launches["subs_10k"] = subs_10k_phase(emit)

    # ------- the live cluster: config 1 (no kernel: 1016 cells), then the
    # Consul-schema LiveCluster driven through its API at 10k, and the
    # HTTP and pgwire servers over it
    os.makedirs("bench_out", exist_ok=True)
    fault_launches["config1"] = config1_phase(emit)
    fault_launches["live_10k"], live_cluster, agent = live_10k_phase(
        emit, "bench_out")
    fault_launches["serve_10k"] = serve_10k_phase(emit, live_cluster)
    live_cluster.tripwire.trip()
    del live_cluster
    torch.cuda.empty_cache()

    # ------- the command line and the cluster tooling: the 10k agent
    # restarted from "live_10k"'s checkpoint in a child process, then the
    # 64-agent devcluster in this process
    import tempfile

    cli_agent_phase(emit, agent, tempfile.mkdtemp(prefix="cli_agent_",
                                                  dir="bench_out"))
    os.remove(agent["checkpoint"])
    fault_launches["devcluster_64"] = devcluster_phase(
        emit, tempfile.mkdtemp(prefix="devcluster_", dir="bench_out"))

    # ------- the helper's phases: fault digests, fleet sweeps, the twin,
    # the 256-node subscription, live and serving runs, config digests
    helper_launches, helper_serve = join_helper(*helper)
    fault_launches.update(helper_launches)

    # ------- the bench as a user runs it, alone on the card: its walls
    # (the north star's, the devcluster leg's against its frozen wall)
    # are measured with nothing else running
    fault_launches["bench"] = bench_phase(
        emit, tempfile.mkdtemp(prefix="bench_", dir="bench_out"))

    by_path = {label: rec["launches"]["grouped_merge"] for label, rec in (
        ("slice", slice_rec), ("swim_slice", swim_rec), ("config3", c3_rec),
        ("config3_10k", c3k_rec), ("config6_1000", c6_rec),
        ("config6_10k", c6k_rec), ("config4", c4_rec),
        ("config5", sized["config5"]), ("config7", sized["config7"]))}
    by_path["kernel_vs_scatter_config6"] = l6_on
    by_path["cli_run_10k"] = cli_run_launches
    by_path["replay"] = replay_launches
    by_path.update(fault_launches)
    serve_by_path = {}
    for part in (SERVE_BY_PHASE, helper_serve):
        for label, n in part.items():
            if not label.startswith("kernel_check"):
                serve_by_path[label] = serve_by_path.get(label, 0) + n
    emit({"kernels": [{
        "name": "grouped_merge",
        "route": "cuda",
        "source": "corro_sim_torch/core/csrc/merge_kernel.cu",
        "replaces": "corro_sim/core/merge_kernel.py:184",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "no_launch_paths": {
            "config1": "1016 rows x 1 column = 1016 cells, not a multiple "
                       "of 128: every merge takes the scatter arm",
            "config6_1000": "2046 rows x 2 columns = 4092 cells, not a "
                            "multiple of 128: every merge takes the "
                            "scatter arm",
            "config6_live": "2046 rows x 2 columns = 4092 cells, not a "
                            "multiple of 128: every merge takes the "
                            "scatter arm",
        },
        "child_process_paths": {
            "cli_agent_10k": "python -m corro_sim_torch agent runs as a "
                             "child process: its merge launches are "
                             "counted in that process, not in this one",
            "bench_config2": "python -m corro_sim_torch bench --config 2 "
                             "runs as a child process (64 nodes x 64 "
                             "cells: no kernel there either)",
        },
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
    }, {
        "name": "serve_lanes",
        "route": "cuda",
        "source": "corro_sim_torch/sync/csrc/serve_kernel.cu",
        "replaces": "the serve step of corro_sim/sync/sync.py::sync_round "
                    "(XLA array ops; no TPU kernel)",
        "launches": sum(serve_by_path.values()),
        "launches_by_path": serve_by_path,
        "no_launch_paths": {
            label: "the scatter merge (cells not a multiple of 128): the "
                   "sweep serves its lanes in plain PyTorch"
            for label in ("config1", "config6_1000", "config6_live")},
        "child_process_paths": {
            "cli_agent_10k": "python -m corro_sim_torch agent runs as a "
                             "child process: its serve launches are "
                             "counted there",
            "bench_config2": "python -m corro_sim_torch bench --config 2 "
                             "runs as a child process (64 cells: the "
                             "scatter merge, no serve kernel)",
        },
        "bit_equal": True,
        "ms": serve_kernel["catchup"]["kernel_ms"],
        "plain_ms": serve_kernel["catchup"]["plain_ms"],
        "bound_ms": serve_kernel["catchup"]["bound_ms"],
        "bound_by": serve_kernel["catchup"]["bound_by"],
        "catchup": serve_kernel["catchup"],
        "north_star": serve_kernel["north_star"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
