"""`corro-sim-torch` command line — the PyTorch port of ``corro_sim/cli.py``,
the analog of the reference's `corrosion` CLI.

``python -m corro_sim_torch`` (or ``python -m corro_sim_torch.cli``) takes
the JAX package's subcommands with the same flags, defaults, exit codes and
JSON report keys, so a script written for `corro-sim` runs unchanged. One
top-level option is new: ``--device`` (default ``cuda``), where every
command that builds tensors runs; it is the port's counterpart of the JAX
package's ``JAX_PLATFORMS``. Without a card, those commands raise
``resolve_device``'s error unless ``--device cpu`` is given; nothing falls
back to the CPU. The client commands (query, exec and the admin calls)
take no device.

What the port does not have yet refuses with exit 2 and one line naming
the missing module: ``lint``, ``audit``, ``perf``, ``doctor``, ``bench``,
``run --mesh``, ``sweep --mesh`` and ``run --transfer-guard``
(:data:`WAITING`). ``soak``, ``sweep`` and ``twin`` print the JAX
package's reports but append no perf-ledger line, and nothing here
enables a compile cache: the port compiles nothing per shape.

Command surface vs the reference's Command enum
(``crates/corrosion/src/main.rs:626-801``):

  run          — run a simulation config to convergence, print a report
                 (--fork replays a what-if off a twin fork token)
  twin         — shadow a changeset feed + forecast what-if chaos
                 (streaming ingest, cursor resume; doc/twin.md)
  bench        — BASELINE benchmark configs 0-7        [waits: item 11]
  agent        — live cluster: HTTP API + admin socket (+ --pg-addr
                 pgwire, + --tls-* for TLS/mTLS)      [Command::Agent]
  devcluster   — run an `A -> B` topology file        [corro-devcluster]
  query / exec — SELECT / DML against a running agent [Query/Exec]
  backup / restore — actor-neutral snapshots          [Backup/Restore]
  reload       — re-apply schema files                [Command::Reload]
  cluster      — members / membership-states / rejoin / set-id
  sync         — generate / reconcile-gaps            [Command::Sync]
  actor        — version bookkeeping introspection    [Command::Actor]
  subs         — list / inspect subscriptions         [Command::Subs]
  locks        — lock registry dump                   [Command::Locks]
  traces       — recent tracer spans                  [telemetry analog]
  lint         — corro-lint trace-safety analyzer     [waits: item 12]
  audit        — jaxpr vacuity + golden fingerprint   [waits: item 12]
  flight       — per-round telemetry timeline         [flight recorder]
  probes       — gossip provenance + lag observatory  [probe tracer]
  db lock      — hold the write lock around a command [DbCommand::Lock]
  tls          — ca / server / client cert generation [Command::Tls]
  template     — render templates w/ live re-render   [Command::Template]
  consul-sync  — mirror Consul services/checks        [Command::Consul]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


_FLAG_TO_FIELD = {
    "nodes": "num_nodes",
    "rows": "num_rows",
    "cols": "num_cols",
    "log_capacity": "log_capacity",
    "write_rate": "write_rate",
    "zipf": "zipf_alpha",
    "swim": "swim_enabled",
    "swim_view": "swim_view_size",
    "sync_interval": "sync_interval",
    "probes": "probes",
    "pipeline": "pipeline",
}

# what the port does not have yet: the module each refusal names and the
# ROADMAP.md queue 1 item that brings it
WAITING = {
    "lint": ("analysis/lint.py", 12),
    "audit": ("analysis/jaxpr_audit.py", 12),
    "perf": ("obs/ledger.py", 12),
    "doctor": ("obs/doctor.py", 12),
    "bench": ("benchmarks.py's bench main", 11),
    "run --mesh": ("engine/sharding.py's make_mesh", 10),
    "sweep --mesh": ("engine/sharding.py's make_sweep_mesh", 10),
    "run --transfer-guard": ("run_sim(transfer_guard=)", 12),
}


def _waiting(what: str) -> int:
    """Refuse ``what`` with exit 2 and one line naming what it waits for."""
    module, item = WAITING[what]
    print(
        f"error: `{what}` is not in corro_sim_torch yet: it waits for "
        f"{module} (ROADMAP.md queue 1 item {item})",
        file=sys.stderr,
    )
    return 2


def _device(args: argparse.Namespace):
    """The ``--device`` the command runs on, resolved (``cuda`` by
    default; raises without a card unless ``--device cpu``)."""
    from corro_sim_torch.device import resolve_device

    return resolve_device(getattr(args, "device", None))


def _cmd_run(args: argparse.Namespace) -> int:
    import dataclasses

    import numpy as np

    if getattr(args, "mesh", False):
        return _waiting("run --mesh")
    if getattr(args, "transfer_guard", False):
        return _waiting("run --transfer-guard")
    device = _device(args)

    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.io.config_file import load_config

    # --config (+ CORRO_SIM__* env) provides the base; explicit CLI flags
    # win — the reference's TOML < env < CLI precedence
    # (corro-types/src/config.rs:284-291, corrosion/src/main.rs:558-624).
    overrides = {
        field: getattr(args, flag)
        for flag, field in _FLAG_TO_FIELD.items()
        if getattr(args, flag) is not None
    }
    if getattr(args, "shard_log", None) is not None:
        # tri-state: an explicit regime beats the size heuristic
        overrides["shard_log"] = {
            "on": True, "off": False, "auto": None
        }[args.shard_log]
    fork_tok = None
    if getattr(args, "fork", None):
        # what-if fork repro (corro_sim_torch/engine/twin.py; doc/twin.md):
        # the run warm-starts from a twin's fork token — the token OWNS
        # the base shape, so shape flags are refused rather than
        # silently diverging the repro from the forecast lane it names
        from corro_sim_torch.io.checkpoint import load_sim_checkpoint

        try:
            fork_tok = load_sim_checkpoint(args.fork)
        except (OSError, ValueError) as e:
            print(f"error: --fork {args.fork!r}: {e}", file=sys.stderr)
            return 2
        if not fork_tok.is_fork:
            print(
                f"error: {args.fork!r} is a mid-run soak cursor, not a "
                "fork token (corro-sim twin --fork-out writes one)",
                file=sys.stderr,
            )
            return 2
        if overrides:
            print(
                "error: --fork carries the base config in the token — "
                f"drop {sorted(overrides)} (only --scenario/--knob/"
                "--seed/--chunk/--max-rounds compose with a fork)",
                file=sys.stderr,
            )
            return 2
        if getattr(args, "workload", None):
            print(
                "error: --fork does not compose with --workload (the "
                "forked state IS the load; run_sim resume refuses "
                "workload schedules)",
                file=sys.stderr,
            )
            return 2
        cfg = fork_tok.cfg
    else:
        cfg = load_config(args.config)
        cfg = dataclasses.replace(cfg, **overrides).validate()
    schedule = Schedule(write_rounds=args.write_rounds)
    scenario = None
    if args.scenario:
        from corro_sim_torch.faults import make_scenario

        scenario = make_scenario(
            args.scenario, cfg.num_nodes,
            # --scenario-rounds pins the fault-timeline horizon a sweep
            # lane was compiled with (corro_sim_torch/sweep/ repro commands):
            # generators truncate/derive waves against `rounds`, so a
            # different horizon is a different timeline
            rounds=getattr(args, "scenario_rounds", None)
            or args.max_rounds,
            write_rounds=args.write_rounds, seed=args.seed,
        )
        cfg = scenario.apply(cfg)
        schedule = scenario.schedule()
    if getattr(args, "knob", None):
        # `--knob loss=0.2` / `--knob write_rate=0.3` knob overrides —
        # the sweep frontier's worst-seed repro surface (corro_sim_torch/
        # sweep/plan.py repro_cmd): a knob-axis grid cell reproduces as
        # one serial run with the same override applied on top of the
        # scenario. Link-fault fields land on cfg.faults; SimConfig
        # sim-knob fields (write_rate/zipf_alpha/sync_interval/...)
        # land on cfg itself, int-cast where the field is integral.
        from corro_sim_torch.sweep import SIM_KNOB_FIELDS, SWEEP_KNOB_FIELDS
        from corro_sim_torch.sweep.plan import _SIM_INT_FIELDS

        fault_over, sim_over = {}, {}
        for kv in args.knob:
            field, _, value = kv.partition("=")
            try:
                num = float(value)
            except ValueError:
                num = None
            if field in SWEEP_KNOB_FIELDS and num is not None:
                fault_over[field] = num
            elif field in SIM_KNOB_FIELDS and num is not None:
                sim_over[field] = (
                    int(num) if field in _SIM_INT_FIELDS else num
                )
            else:
                print(
                    f"error: --knob {kv!r} (expected field=value with "
                    "field one of "
                    f"{', '.join(SWEEP_KNOB_FIELDS + SIM_KNOB_FIELDS)} "
                    "and a numeric value)",
                    file=sys.stderr,
                )
                return 2
        if fault_over:
            cfg = dataclasses.replace(
                cfg, faults=dataclasses.replace(cfg.faults, **fault_over)
            )
        if sim_over:
            cfg = dataclasses.replace(cfg, **sim_over)
        cfg = cfg.validate()
    if fork_tok is not None and cfg.node_faults.enabled:
        # the what-if frame shift (config.shift_node_faults): the forked
        # state's round counter continues the twin's timeline, so
        # scenario-relative wipe rounds become absolute (fork + k) —
        # exactly what the forecast lane this command reproduces baked
        from corro_sim_torch.config import shift_node_faults

        cfg = dataclasses.replace(
            cfg, node_faults=shift_node_faults(
                cfg.node_faults, fork_tok.fork_round
            )
        ).validate()
    workload = None
    if getattr(args, "workload", None):
        # the unified spec surface: --scenario X --workload Y in ONE run
        # (load + faults overlapping is where the latency-under-load
        # story lives) — coupling validated up front, not after compile
        from corro_sim_torch.workload import make_workload

        workload = make_workload(
            args.workload, cfg.num_nodes, rounds=args.write_rounds,
            seed=args.seed,
        )
        if scenario is not None:
            scenario.check_workload(workload)
    round_offset = fork_tok.fork_round if fork_tok is not None else 0
    invariants = None
    if args.check_invariants or args.scenario:
        from corro_sim_torch.faults import InvariantChecker

        invariants = InvariantChecker(cfg, round_offset=round_offset)
    scorecard = None
    if getattr(args, "scorecard", False) or (
        scenario is not None and cfg.node_faults.enabled
    ):
        # node-fault scenarios are graded by default — the scorecard is
        # the evidence their catalog entry exists to produce
        from corro_sim_torch.faults import ResilienceScorecard

        scorecard = ResilienceScorecard(
            cfg, scenario=scenario, workload=workload,
            round_offset=round_offset,
        )
    flight = None
    if args.flight_out:
        from corro_sim_torch.obs.flight import FlightRecorder

        # journaled chunk-by-chunk: a killed run still leaves the curve
        flight = FlightRecorder(sink_path=args.flight_out)
        if not flight.sink_active:
            print(
                f"warning: cannot write flight timeline to "
                f"{args.flight_out!r} — continuing without it",
                file=sys.stderr,
            )
    res = run_sim(
        cfg,
        init_state(cfg, seed=args.seed, device=device),
        schedule,
        max_rounds=args.max_rounds,
        chunk=args.chunk,
        seed=args.seed,
        device=device,
        flight=flight,
        profile_dir=args.profile_dir,
        invariants=invariants,
        scorecard=scorecard,
        workload=workload,
        resume=(
            fork_tok.refit(cfg, args.seed, args.chunk)
            if fork_tok is not None else None
        ),
        min_rounds=(
            max(
                scenario.heal_round or 0, args.write_rounds,
                workload.rounds if workload is not None else 0,
            )
            if scenario is not None else None
        ),
    )
    diag = res.flight.diagnostics()
    # the metric series are host copies already (one read per chunk)
    report = {
        "nodes": cfg.num_nodes,
        "converged_round": res.converged_round,
        "rounds_run": res.rounds,
        "writes": int(res.metrics["writes"].sum()),
        "changes_applied": int(res.metrics["fresh"].sum())
        + int(res.metrics["sync_versions"].sum()),
        "dropped_window": int(res.metrics["dropped_window"].sum()),
        "wall_per_round_ms": round(res.wall_per_round_ms, 3),
        # the kernel build and load before the first chunk
        "compile_seconds": round(res.setup_seconds, 2),
        # no compile cache: the port compiles nothing per shape
        "compile_cache": None,
        "sim_seconds_per_round": cfg.round_ms / 1000.0,
        "final_gap": float(np.asarray(res.metrics["gap"])[-1]),
        # curve-shaped convergence diagnostics off the flight record
        "gap_half_life_rounds": diag["gap_half_life_rounds"],
        "epidemic_window_rounds": diag["epidemic_window_rounds"],
        # chunk-pipeline stats (overlap ratio, speculation, fetch-wait
        # wall; doc/performance.md) — present in both modes so a
        # pipelined-vs-sequential pair is directly comparable
        "pipeline": res.pipeline,
    }
    if args.flight_out:
        # a sink that died mid-run (ENOSPC, deleted dir) must not be
        # reported as a written artifact
        wrote = res.flight.sink_active
        res.flight.close()
        report["flight"] = args.flight_out if wrote else None
    if res.probe is not None:
        # probe artifacts land next to the flight record: NDJSON journal
        # + Perfetto-loadable Chrome trace-event JSON. An unwritable
        # path must not eat the completed run's report (same manners as
        # the flight sink above).
        prefix = args.probe_out or (
            args.flight_out + ".probes" if args.flight_out else "probes"
        )
        try:
            res.probe.dump_ndjson(prefix + ".ndjson")
            res.probe.dump_chrome_trace(prefix + ".trace.json")
            report["probe_artifacts"] = [
                prefix + ".ndjson", prefix + ".trace.json",
            ]
        except OSError as e:
            print(
                f"warning: cannot write probe artifacts to {prefix!r}* "
                f"({e}) — continuing without them",
                file=sys.stderr,
            )
            report["probe_artifacts"] = None
        summaries = [
            res.probe.summary(k) for k in range(res.probe.num_probes)
        ]
        report["probe_delivery_p99_rounds"] = res.probe.delivery_p99()
        report["probe_coverage"] = [s["coverage"] for s in summaries]
    if args.profile_dir:
        report["profile_dir"] = args.profile_dir
    if fork_tok is not None:
        report["fork"] = args.fork
        report["fork_round"] = fork_tok.fork_round
    if scenario is not None:
        report["scenario"] = scenario.spec
        report["heal_round"] = scenario.heal_round
        if (
            scenario.heal_round is not None
            and res.converged_round is not None
        ):
            # the soak headline: rounds from heal to re-convergence
            report["recovery_rounds"] = (
                res.converged_round - scenario.heal_round
            )
    if workload is not None:
        report["workload"] = workload.spec
    if res.resilience is not None:
        report["resilience"] = res.resilience
    if cfg.faults.enabled:
        fault_keys = [
            k for k in res.metrics
            if k.startswith("fault_") and k != "fault_burst_nodes"
        ]  # burst_nodes is a gauge — summing it would lie
        report["fault_totals"] = {
            k: int(res.metrics[k].sum()) for k in sorted(fault_keys)
        }
    if invariants is not None:
        report["invariants"] = invariants.report()
    if res.poisoned:
        # ring-wrap tripwire (engine/step.py): state may be silently wrong —
        # distinct from an ordinary round-budget miss (exit 3)
        report["poisoned"] = True
    print(json.dumps(report, indent=2))
    if res.poisoned:
        return 4
    if invariants is not None and not invariants.ok:
        return 5
    return 0 if res.converged_round is not None else 3


def _cmd_soak(args: argparse.Namespace) -> int:
    """`corro-sim soak` — sweep chaos scenarios under invariant checking.

    Each scenario runs to (re-)convergence with every invariant checker
    armed; the report carries per-scenario recovery time (rounds from the
    scheduled heal to re-convergence), injected-fault totals and the
    invariant verdicts. Exit codes: 0 all green; 5 an invariant broke;
    3 a scenario failed to re-converge within the round budget.

    By default the scenarios race as lanes of ONE sweep dispatch
    (corro_sim_torch/sweep/ — bit-identical per-scenario numbers, one compile
    instead of one per scenario; doc/sweeping.md). ``--serial`` keeps
    the sequential loop below; ``--resume`` and an explicit
    ``--checkpoint`` imply it (resume tokens are a sequential-loop
    concept).

    Multi-hour soaks survive device loss in SERIAL mode:
    with an artifact prefix (``--out``) or an explicit ``--checkpoint``
    / ``--checkpoint-every`` (either implies ``--serial``), a resumable
    checkpoint is written every ``--checkpoint-every`` chunks and a run
    that dies leaves ``<prefix>.partial.json`` (last completed chunk +
    the resume token) instead of rc=1 with no state. The default swept
    path finishes in one dispatch and writes no token. ``soak --resume
    <ckpt>`` reconstructs the sweep from the token — same config, seed
    and chunking — and continues the killed scenario BIT-IDENTICALLY
    (state, metrics and flight timeline match the uninterrupted run;
    tests/test_soak_resume.py), then finishes the remaining scenarios.

    ``--workload SPEC`` couples a traffic schedule into EVERY scenario
    run (load + faults in one spec — the SWARM latency-under-load
    posture); coupling is validated up front (the fault window and the
    write range must overlap) and checkpoints are disabled for coupled
    runs (the workload cursor is not checkpointed). ``--scorecard
    [PATH]`` arms the resilience scorecard on every scenario, writes the
    per-scenario blocks as a JSON artifact, and gates them against the
    committed threshold golden
    (``corro_sim_torch/faults/resilience_thresholds.json``) —
    breaches exit 6.
    """
    import dataclasses
    import os

    import numpy as np

    device = _device(args)

    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.faults import InvariantChecker, make_scenario
    from corro_sim_torch.config import sim_config_from_dict
    from corro_sim_torch.io.checkpoint import _cfg_json, load_sim_checkpoint
    from corro_sim_torch.io.config_file import load_config
    from corro_sim_torch.obs.flight import FlightRecorder

    resume_ck = None
    runs: list = []
    if args.resume and getattr(args, "workload", None):
        print(
            "--resume does not compose with --workload (coupled runs "
            "are not checkpointed; re-run the sweep)",
            file=sys.stderr,
        )
        return 2
    if args.resume:
        resume_ck = load_sim_checkpoint(args.resume)
        soak_meta = resume_ck.meta.get("soak") or {}
        if not soak_meta:
            print(
                f"{args.resume!r} is a sim checkpoint but carries no "
                "soak sweep cursor — resume it via run_sim(resume=...)",
                file=sys.stderr,
            )
            return 2
        # the token is self-contained: CLI shape flags are ignored and
        # the killed sweep's own args/config continue (anything else
        # would break the bit-identity contract)
        base = sim_config_from_dict(soak_meta["base_cfg"]).validate()
        sweep = dict(soak_meta["args"])
        specs = list(soak_meta["specs"])
        start_idx = int(soak_meta["index"])
        runs = list(soak_meta.get("completed", []))
        print(
            f"# resuming soak from {args.resume} — scenario "
            f"{start_idx + 1}/{len(specs)} at round {resume_ck.rounds}",
            file=sys.stderr, flush=True,
        )
    else:
        base = load_config(args.config)
        overrides = {
            field: getattr(args, flag)
            for flag, field in _FLAG_TO_FIELD.items()
            if getattr(args, flag) is not None
        }
        base = dataclasses.replace(base, **overrides).validate()
        from corro_sim_torch.faults.scenarios import SOAK_DEFAULT

        # the default sweep covers the RECOVERABLE catalog — scenarios
        # whose faults persist forever by design (blackhole_one_way,
        # ring/star topology studies) can never re-converge and are
        # opt-in by name
        specs = args.scenario or list(SOAK_DEFAULT)
        start_idx = 0
        sweep = {
            "rounds": args.rounds,
            "write_rounds": args.write_rounds,
            "max_rounds": args.max_rounds,
            "chunk": args.chunk,
            "seed": args.seed,
            "out": args.out,
            "checkpoint": args.checkpoint,
            "checkpoint_every": args.checkpoint_every,
        }
    out = sweep.get("out")
    ckpt_path = sweep.get("checkpoint") or (
        f"{out}.ckpt.npz" if out else None
    )
    # None = the flag was not given (argparse default): serial mode
    # still checkpoints every 4 chunks when a path resolves
    _ck = sweep.get("checkpoint_every")
    ckpt_every = 4 if _ck is None else int(_ck)

    # ------------------------------------------------- sweep-engine path
    # The sequential scenario loop below is the ESCAPE HATCH: by
    # default the whole sweep races as lanes of ONE sweep dispatch
    # (corro_sim_torch/sweep/), with identical per-scenario report fields and
    # exit codes. Serial mode remains for --resume (checkpoint tokens
    # are a serial-loop concept), --serial, or an EXPLICIT checkpoint
    # request (--checkpoint or a hand-set --checkpoint-every) — a user
    # who asked for resumability must get the loop that provides it,
    # not a silent fast path that drops it.
    if not (
        args.resume or getattr(args, "serial", False)
        or sweep.get("checkpoint")
        # an explicit NONZERO cadence asks for checkpoints; an explicit
        # 0 asks for none — which is what the swept path provides
        or sweep.get("checkpoint_every")
    ):
        if out:
            print(
                "# swept soak: scenarios race as one sweep dispatch; "
                "no resume checkpoint and no per-scenario flight "
                "journals are written (pass --serial for the "
                "checkpointed, journaling loop)",
                file=sys.stderr,
            )
        return _soak_swept(
            base, specs, sweep, getattr(args, "workload", None),
            getattr(args, "scorecard", None), device,
        )

    workload = None
    if getattr(args, "workload", None):
        from corro_sim_torch.workload import make_workload

        workload = make_workload(
            args.workload, base.num_nodes,
            rounds=sweep["write_rounds"], seed=sweep["seed"],
        )
        # validate EVERY scenario's coupling up front (cheap host-side
        # compiles) — a bad spec at index 3 must fail in seconds, not
        # after minutes of earlier scenarios whose results would then
        # be discarded without a report
        for spec in specs[start_idx:]:
            try:
                make_scenario(
                    spec, base.num_nodes, rounds=sweep["rounds"],
                    write_rounds=sweep["write_rounds"],
                    seed=sweep["seed"],
                ).check_workload(workload)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
        if ckpt_path:
            print(
                "# --workload coupled: checkpointing disabled (the "
                "workload cursor is not checkpointed)",
                file=sys.stderr,
            )
            ckpt_path = None
    scorecard_path = getattr(args, "scorecard", None)

    any_violation = any(
        not r.get("invariants", {}).get("ok", True) for r in runs
    )
    any_unconverged = any(r.get("converged_round") is None for r in runs)
    # a resumed sweep must keep gating on breaches its pre-kill
    # scenarios already recorded — the exit-6 tripwire survives resume
    breaches: list = [
        b for r in runs for b in r.get("threshold_breaches", [])
    ]
    from corro_sim_torch.faults import check_thresholds, load_thresholds

    thresholds = load_thresholds()  # raises on a corrupt golden
    if thresholds is None and scorecard_path:
        print(
            "warning: no resilience threshold golden committed — the "
            "scorecard artifact is written but nothing gates it "
            "(faults/resilience_thresholds.json)",
            file=sys.stderr,
        )
    for i in range(start_idx, len(specs)):
        spec = specs[i]
        sc = make_scenario(
            spec, base.num_nodes, rounds=sweep["rounds"],
            write_rounds=sweep["write_rounds"], seed=sweep["seed"],
        )
        cfg = sc.apply(base)
        inv = InvariantChecker(cfg)
        card = None
        if scorecard_path or cfg.node_faults.enabled:
            # node-fault scenarios are graded by default; --scorecard
            # grades the whole sweep and writes the artifact
            from corro_sim_torch.faults import ResilienceScorecard

            card = ResilienceScorecard(
                cfg, scenario=sc, workload=workload
            )
        flight = None
        if out:
            # filename from the FULL spec (sanitized), indexed — two
            # parameterizations of one scenario must not share a journal
            safe = "".join(
                ch if ch.isalnum() or ch in "._-" else "-"
                for ch in sc.spec
            )
            flight = FlightRecorder(
                sink_path=f"{out}.{i:02d}.{safe}.ndjson"
            )
        ck_meta = {"soak": {
            "specs": specs,
            "index": i,
            "completed": list(runs),
            "base_cfg": _cfg_json(base),
            "args": sweep,
        }}
        try:
            res = run_sim(
                cfg, init_state(cfg, seed=sweep["seed"], device=device),
                sc.schedule(),
                max_rounds=sweep["max_rounds"], chunk=sweep["chunk"],
                seed=sweep["seed"], device=device,
                min_rounds=max(
                    sc.heal_round or 0, sweep["write_rounds"],
                    workload.rounds if workload is not None else 0,
                ),
                flight=flight, invariants=inv, scorecard=card,
                workload=workload,
                resume=resume_ck if i == start_idx else None,
                checkpoint_path=ckpt_path,
                checkpoint_every=ckpt_every if ckpt_path else 0,
                checkpoint_meta=ck_meta,
            )
        except Exception as e:  # device loss / kill-adjacent failures
            # a dying soak leaves a partial artifact
            # naming how far it got and the token that resumes it,
            # instead of rc=1 with no state
            # only advertise a resume token that actually exists on
            # disk — a death before the first checkpoint write must not
            # hand the operator a recovery command that FileNotFounds.
            # The token may predate this scenario (died before ITS
            # first checkpoint): resuming is still correct — it replays
            # the tokened scenario's tail and re-derives everything
            # after — but the artifact says which scenario restarts.
            token = None
            token_index = None
            if ckpt_path and os.path.exists(ckpt_path):
                token = ckpt_path
                try:
                    token_index = load_sim_checkpoint(ckpt_path).meta[
                        "soak"]["index"]
                except Exception:
                    token_index = None
            partial = {
                "status": "died",
                "error": f"{type(e).__name__}: {e}",
                "scenario": sc.spec,
                "scenario_index": i,
                "scenarios_total": len(specs),
                "completed": runs,
                "resume_token": token,
                "resume_resumes_scenario_index": token_index,
                "resume_cmd": (
                    f"corro-sim soak --resume {token}"
                    if token else None
                ),
                "flight": (
                    flight.sink_path
                    if flight is not None and flight.sink_active else None
                ),
            }
            from corro_sim_torch.utils.runtime import atomic_json_dump

            path = f"{out or 'soak'}.partial.json"
            if atomic_json_dump(path, partial, indent=2):
                partial["partial_artifact"] = path
            if flight is not None:
                flight.close()
            print(json.dumps(partial, indent=2))
            return 1
        resume_ck = None
        heal = sc.heal_round
        recovery = (
            res.converged_round - heal
            if heal is not None and res.converged_round is not None
            else None
        )
        fault_totals = {
            k: int(np.asarray(res.metrics[k]).sum())
            for k in sorted(res.metrics)
            if k.startswith("fault_") and k != "fault_burst_nodes"
        }
        run = {
            "scenario": sc.spec,
            "converged_round": res.converged_round,
            "rounds_run": res.rounds,
            "heal_round": heal,
            "recovery_rounds": recovery,
            "poisoned": res.poisoned,
            "fault_totals": fault_totals,
            "invariants": inv.report(),
            "compile_cache": None,
        }
        if workload is not None:
            run["workload"] = workload.spec
        if res.resilience is not None:
            run["resilience"] = res.resilience
            if thresholds is not None:
                run_breaches = check_thresholds(res.resilience, thresholds)
                run["threshold_breaches"] = run_breaches
                breaches.extend(run_breaches)
        if flight is not None:
            run["flight"] = (
                flight.sink_path if flight.sink_active else None
            )
            flight.close()
        runs.append(run)
        any_violation |= not inv.ok
        any_unconverged |= res.converged_round is None
        print(
            f"# {sc.spec}: converged={res.converged_round} "
            f"recovery={recovery} invariants="
            f"{'ok' if inv.ok else 'VIOLATED'}",
            file=sys.stderr, flush=True,
        )
    report = {
        "nodes": base.num_nodes,
        "rounds": sweep["rounds"],
        "seed": sweep["seed"],
        "scenarios": runs,
        "ok": not (any_violation or any_unconverged or breaches),
    }
    if workload is not None:
        report["workload"] = workload.spec
    if resume_ck is not None or args.resume:
        report["resumed_from"] = args.resume
    if ckpt_path:
        report["checkpoint"] = ckpt_path
    if breaches:
        report["threshold_breaches"] = breaches
    if scorecard_path:
        # the scorecard artifact: per-scenario resilience blocks + the
        # threshold verdict, one JSON the CI leg uploads and asserts on
        scorecard_doc = {
            "nodes": base.num_nodes,
            "seed": sweep["seed"],
            "workload": workload.spec if workload is not None else None,
            "scenarios": [
                {
                    "scenario": r["scenario"],
                    "resilience": r.get("resilience"),
                    "threshold_breaches": r.get("threshold_breaches", []),
                }
                for r in runs
            ],
            "thresholds_ok": not breaches,
            "breaches": breaches,
        }
        with open(scorecard_path, "w", encoding="utf-8") as f:
            json.dump(scorecard_doc, f, indent=2)
            f.write("\n")
        report["scorecard"] = scorecard_path
    if out:
        with open(f"{out}.report.json", "w") as f:
            json.dump(report, f, indent=2)
        report["report"] = f"{out}.report.json"
    print(json.dumps(report, indent=2))
    if any_violation:
        return 5
    if any_unconverged:
        return 3
    return 6 if breaches else 0


def _soak_swept(base, specs, sweep, workload_spec, scorecard_path,
                device) -> int:
    """The soak sweep as lanes of ONE sweep dispatch: the
    per-scenario report fields, threshold gating and exit codes of the
    sequential loop, produced from the fleet-of-clusters engine. Every
    lane is bit-identical to the serial run it replaces
    (tests/test_sweep.py), so the report numbers are THE soak numbers."""
    import numpy as np

    from corro_sim_torch.faults import check_thresholds, load_thresholds
    from corro_sim_torch.sweep import build_plan, run_sweep

    try:
        plan = build_plan(
            base, specs, [sweep["seed"]], rounds=sweep["rounds"],
            write_rounds=sweep["write_rounds"],
            workload_spec=workload_spec,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    thresholds = load_thresholds()  # raises on a corrupt golden
    if thresholds is None and scorecard_path:
        print(
            "warning: no resilience threshold golden committed — the "
            "scorecard artifact is written but nothing gates it "
            "(faults/resilience_thresholds.json)",
            file=sys.stderr,
        )
    res = run_sweep(
        plan, max_rounds=sweep["max_rounds"], chunk=sweep["chunk"],
        device=device,
        on_chunk=lambda p: print(
            f"# sweep chunk {p['chunk']}: rounds {p['rounds_done']}, "
            f"{p['lanes_active']}/{plan.num_lanes} lanes racing",
            file=sys.stderr, flush=True,
        ),
    )
    runs: list = []
    breaches: list = []
    any_violation = False
    any_unconverged = False
    for lr, lane in zip(res.lanes, plan.lanes):
        # fault totals restricted to the families the lane's SERIAL
        # config emits — the union program accounts link flow for every
        # lane, but the report must match the serial soak's
        fault_totals = (
            {
                k: int(np.asarray(lr.metrics[k]).sum())
                for k in sorted(lr.metrics)
                if k.startswith("fault_") and k != "fault_burst_nodes"
            }
            if lane.cfg.faults.enabled else {}
        )
        inv = lr.invariants or {"ok": True, "violations": []}
        run = {
            "scenario": lr.spec,
            "converged_round": lr.converged_round,
            "rounds_run": lr.rounds,
            "heal_round": lr.heal_round,
            "recovery_rounds": lr.recovery_rounds,
            "poisoned": lr.poisoned,
            "fault_totals": fault_totals,
            "invariants": inv,
            "repro_cmd": lr.repro_cmd,
            # the serial loop's per-run fields, kept present so report
            # consumers never key-error on the (default) swept path:
            # compile cost lives on the ONE shared program (the
            # report-level "sweep" block) and flight journals are a
            # serial-mode feature
            "compile_cache": None,
            "flight": None,
        }
        if workload_spec is not None and lane.workload is not None:
            run["workload"] = lane.workload.spec
        if scorecard_path or lane.cfg.node_faults.enabled:
            run["resilience"] = lr.resilience
            if thresholds is not None and lr.resilience is not None:
                run_breaches = check_thresholds(lr.resilience, thresholds)
                run["threshold_breaches"] = run_breaches
                breaches.extend(run_breaches)
        runs.append(run)
        any_violation |= not inv.get("ok", True)
        any_unconverged |= lr.converged_round is None
        print(
            f"# {lr.spec}: converged={lr.converged_round} "
            f"recovery={lr.recovery_rounds} invariants="
            f"{'ok' if inv.get('ok', True) else 'VIOLATED'}",
            file=sys.stderr, flush=True,
        )
    report = {
        "nodes": base.num_nodes,
        "rounds": sweep["rounds"],
        "seed": sweep["seed"],
        "scenarios": runs,
        "ok": not (any_violation or any_unconverged or breaches),
        "sweep": {
            "lanes": plan.num_lanes,
            "dispatches": res.dispatches,
            "wall_seconds": round(res.wall_seconds, 3),
            "compile_seconds": round(res.compile_seconds, 3),
            "clusters_per_second_per_device": (
                round(res.clusters_per_second_per_device, 3)
                if res.clusters_per_second_per_device is not None
                else None
            ),
            "compile_cache": res.compile_cache,
        },
    }
    if workload_spec is not None:
        report["workload"] = workload_spec
    if breaches:
        report["threshold_breaches"] = breaches
    if scorecard_path:
        # keep this artifact's shape in lockstep with the serial loop's
        # scorecard_doc in _cmd_soak — CI asserts on either path
        scorecard_doc = {
            "nodes": base.num_nodes,
            "seed": sweep["seed"],
            "workload": workload_spec,
            "scenarios": [
                {
                    "scenario": r["scenario"],
                    "resilience": r.get("resilience"),
                    "threshold_breaches": r.get("threshold_breaches", []),
                }
                for r in runs
            ],
            "thresholds_ok": not breaches,
            "breaches": breaches,
        }
        with open(scorecard_path, "w", encoding="utf-8") as f:
            json.dump(scorecard_doc, f, indent=2)
            f.write("\n")
        report["scorecard"] = scorecard_path
    out = sweep.get("out")
    if out:
        with open(f"{out}.report.json", "w") as f:
            json.dump(report, f, indent=2)
        report["report"] = f"{out}.report.json"
    # the JAX package appends this report to its perf ledger; the port's
    # ledger (obs/ledger.py) waits for ROADMAP.md queue 1 item 12
    print(json.dumps(report, indent=2))
    if any_violation:
        return 5
    if any_unconverged:
        return 3
    return 6 if breaches else 0


def _cmd_sweep(args: argparse.Namespace) -> int:
    """`corro-sim sweep` — race a (scenario × seed × knob) chaos matrix
    as lanes of ONE sweep dispatch (corro_sim_torch/sweep/).

    Grid axes are positional ``KEY=VALUES`` tokens::

        corro-sim sweep scenario=crash_amnesia,lossy seed=0..31 \\
            knob.loss=0.05,0.2 --nodes 64

    The report carries every lane's convergence/recovery numbers plus
    the **resilience frontier**: per-cell worst/p95 recovery across
    seeds with the arg-max worst seed named and the one serial
    ``corro-sim run`` command that reproduces it. Threshold gating is
    quantile-over-seeds against the committed golden — breaches exit 6
    (the soak tripwire, unchanged through the sweep path); exit 5 on
    an invariant violation, 3 when a lane fails to settle.
    """
    import dataclasses

    if args.mesh:
        return _waiting("sweep --mesh")
    device = _device(args)

    from corro_sim_torch.faults import load_thresholds
    from corro_sim_torch.io.config_file import load_config
    from corro_sim_torch.sweep import (
        build_frontier,
        build_plan,
        check_frontier,
        parse_grid,
        run_sweep,
    )

    base = load_config(args.config)
    overrides = {
        field: getattr(args, flag)
        for flag, field in _FLAG_TO_FIELD.items()
        if getattr(args, flag, None) is not None
    }
    base = dataclasses.replace(base, **overrides).validate()
    try:
        grid = parse_grid(args.grid)
        if not grid["scenario"]:
            raise ValueError("the grid needs a scenario=... axis")
        plan = build_plan(
            base, grid["scenario"], grid["seed"], grid["knobs"],
            rounds=args.rounds, write_rounds=args.write_rounds,
            workload_spec=args.workload,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(
        f"# sweeping {plan.num_lanes} lanes "
        f"({len(grid['scenario'])} scenarios x {len(grid['seed'])} seeds"
        + (f" x {len(grid['knobs'])} knob combos" if grid["knobs"] != [{}]
           else "")
        + ") in one dispatch",
        file=sys.stderr, flush=True,
    )
    def _on_chunk(p):
        if args.progress:
            # per-chunk lane-state line (fleet observatory): one char
            # per lane — A racing, C bit-frozen converged, P poisoned
            # (+ Q queued and width/pending under the fleet scheduler)
            fleet = (
                f" | w{p['width']} q{p['pending']}"
                if "width" in p else ""
            )
            print(
                f"# chunk {p['chunk']}: rounds {p['rounds_done']} | "
                f"{p['lanes_active']}A {p['lanes_converged']}C "
                f"{p['lanes_poisoned']}P | wasted "
                f"{p['wasted_lane_rounds_total']} frozen lane-rounds"
                f"{fleet} | "
                f"{p['lane_states']} ({p['chunk_wall_s']}s)",
                file=sys.stderr, flush=True,
            )
        else:
            print(
                f"# chunk {p['chunk']}: rounds {p['rounds_done']}, "
                f"{p['lanes_active']} lanes racing, "
                f"{p['lanes_settled']} settled "
                f"({p['chunk_wall_s']}s)",
                file=sys.stderr, flush=True,
            )

    with _profiled(args.profile_dir, device):
        res = run_sweep(
            plan, max_rounds=args.max_rounds, chunk=args.chunk,
            device=device, on_chunk=_on_chunk,
            compact=args.compact, width=args.width,
            pipeline=bool(args.pipeline),
        )
    frontier = build_frontier(res.lanes)
    thresholds = load_thresholds()
    breaches = (
        check_frontier(frontier, thresholds)
        if thresholds is not None else []
    )
    frontier["thresholds_ok"] = not breaches
    frontier["breaches"] = breaches
    from corro_sim_torch.faults.invariants import merge_reports

    inv_summary = merge_reports([lr.invariants for lr in res.lanes])
    any_violation = not inv_summary["ok"]
    any_unsettled = any(
        lr.converged_round is None or lr.poisoned for lr in res.lanes
    )
    report = {
        "nodes": base.num_nodes,
        "lanes": plan.num_lanes,
        "rounds": args.rounds,
        "dispatches": res.dispatches,
        "wall_seconds": round(res.wall_seconds, 3),
        "compile_seconds": round(res.compile_seconds, 3),
        "clusters_per_second_per_device": (
            round(res.clusters_per_second_per_device, 3)
            if res.clusters_per_second_per_device is not None else None
        ),
        "devices": res.devices,
        "compile_cache": res.compile_cache,
        "lanes_detail": [
            {
                "scenario": lr.spec,
                "seed": lr.seed,
                "cell": lr.cell,
                "converged_round": lr.converged_round,
                "rounds_run": lr.rounds,
                "recovery_rounds": lr.recovery_rounds,
                "poisoned": lr.poisoned,
                "rows_lost": (lr.resilience or {}).get("rows_lost"),
                "invariants_ok": (lr.invariants or {}).get("ok", True),
                "repro_cmd": lr.repro_cmd,
            }
            for lr in res.lanes
        ],
        "frontier": frontier,
        "invariants": inv_summary,
        "ok": not (any_violation or any_unsettled or breaches),
    }
    if args.profile_dir:
        report["profile_dir"] = args.profile_dir
    # fleet observatory artifacts (corro_sim_torch/obs/lanes.py): occupancy
    # stats always ride the report; per-lane flight timelines and the
    # grid heatmap are demuxed from the dispatch's own outputs — no
    # lane is ever re-run for its telemetry
    from corro_sim_torch.obs.lanes import (
        demux_flights,
        fleet_occupancy,
        grid_heatmaps,
        render_heatmap,
        write_lane_flights,
    )

    report["occupancy"] = fleet_occupancy(res)
    if res.compaction is not None:
        # fleet-scheduler provenance: bucket widths visited, refill/
        # shrink counts, and the slot-reuse ledger (doc/sweeping.md)
        report["compaction"] = res.compaction
    if res.pipeline is not None:
        report["pipeline"] = res.pipeline
    if args.flight_dir:
        paths = write_lane_flights(
            demux_flights(plan, res, breaches=breaches),
            args.flight_dir,
        )
        report["lane_flights"] = {
            "dir": args.flight_dir, "count": len(paths),
        }
    if args.heatmap:
        heatmaps = grid_heatmaps(res.lanes)
        with open(args.heatmap, "w", encoding="utf-8") as f:
            json.dump(heatmaps, f, indent=2)
            f.write("\n")
        report["heatmap_artifact"] = args.heatmap
        metric = (
            "recovery_rounds"
            if any(
                v is not None
                for row in heatmaps["maps"]["recovery_rounds"]
                for v in row
            )
            else "rounds_to_convergence"
        )
        print(render_heatmap(heatmaps, metric), file=sys.stderr, end="")
    if args.workload:
        report["workload"] = args.workload
    if args.frontier:
        with open(args.frontier, "w", encoding="utf-8") as f:
            json.dump(frontier, f, indent=2)
            f.write("\n")
        report["frontier_artifact"] = args.frontier
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    # no perf-ledger line: obs/ledger.py waits for item 12 (see
    # _soak_swept)
    print(json.dumps(report, indent=2))
    if any_violation:
        return 5
    if any_unsettled:
        return 3
    return 6 if breaches else 0


def _cmd_twin(args: argparse.Namespace) -> int:
    """`corro-sim twin` — shadow a changeset feed and forecast what-if
    chaos (corro_sim_torch/engine/twin.py, doc/twin.md).

    Streams the ND-JSON feed chunk by chunk against a frozen scan-window
    universe, publishes per-chunk convergence + FIFO delivery headlines
    scored against the feed's own `ts` stamps, writes a resumable cursor
    checkpoint at chunk boundaries (`--resume` continues a SIGKILL'd
    twin bit-identically), and — with `--forecast` — forks the live twin
    state and races the scenario × seed grid as warm-start lanes of ONE
    sweep dispatch, graded against the `twin_forecast` threshold
    section (breach = exit 6, the soak tripwire semantics).

    `--tail` is the LIVE operator loop (doc/twin.md §9): FEED becomes a
    growing source — a polled file tail (rotation re-binds, truncation
    refuses) or an http(s):// `/v1/changes` watch (reconnect with a
    backoff budget) — shadowed chunk by chunk as lines arrive,
    bit-identical to file-mode replay of the same lines. Source death
    past the backoff/idle budget is the tail's normal end: final
    partial chunk, drain, report, exit 5 with a resumable cursor.
    `--forecast-every N` re-forks the live state every N chunks and
    races the `--forecast` grid continuously; `--forecast-load R`
    additionally replays up to R rounds of the trailing feed window
    into every lane as coupled workload.

    Exit codes: 0 ok; 2 hostile feed refused (strict mode) / bad args;
    3 the shadow failed to drain to convergence; 4 poisoned (log ring
    wrapped); 5 live source died (tail mode — the cursor checkpoint
    resumes); 6 forecast threshold breach. Precedence: 4 > 5 > 3 > 6.
    """
    import dataclasses

    device = _device(args)

    from corro_sim_torch.config import TwinConfig
    from corro_sim_torch.engine.twin import (
        fork_twin,
        load_feed_lines,
        probe_feed_heads,
        run_forecast,
        run_twin,
        twin_universe,
    )
    from corro_sim_torch.faults import load_thresholds
    from corro_sim_torch.io.checkpoint import load_sim_checkpoint
    from corro_sim_torch.sweep import parse_grid

    forecast_grid = None
    if args.forecast:
        try:
            forecast_grid = parse_grid(args.forecast)
            if not forecast_grid["scenario"]:
                raise ValueError(
                    "--forecast needs a scenario=... axis"
                )
            if forecast_grid["knobs"] != [{}]:
                raise ValueError(
                    "--forecast takes scenario/seed axes (knob axes "
                    "ride the scenario specs or `run --fork --knob`)"
                )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    resume = None
    universe = None
    if args.resume:
        try:
            resume = load_sim_checkpoint(args.resume)
        except (OSError, ValueError) as e:
            print(f"error: --resume {args.resume!r}: {e}",
                  file=sys.stderr)
            return 2

    source = None
    if args.tail:
        from corro_sim_torch.io.feedsource import (
            FeedSourceError,
            FileTailSource,
            HTTPWatchSource,
        )

        scan = (
            resume.cfg.twin.scan_lines if resume is not None
            else args.scan_lines
        )
        if scan <= 0:
            print(
                "error: --tail needs --scan-lines N: a closed world "
                "cannot be frozen from 'the whole feed' while the feed "
                "is still growing",
                file=sys.stderr,
            )
            return 2
        kw = dict(
            poll_ms=args.tail_poll_ms,
            reconnect_max_s=args.reconnect_max_s,
            idle_timeout_s=args.idle_timeout_s,
            max_lag_lines=args.max_lag_lines,
            jitter_seed=args.seed,
        )
        if args.feed.startswith(("http://", "https://")):
            source = HTTPWatchSource(args.feed, **kw)
        else:
            source = FileTailSource(args.feed, **kw)
        # block until the scan window (plus, on resume, the already-
        # consumed prefix the cursor's feed_sha guards) is available
        need0 = scan
        if resume is not None:
            need0 = max(need0, int(
                ((resume.meta or {}).get("twin") or {})
                .get("cursor", {}).get("lines_seen", 0)
            ))
        try:
            lines = source.wait_lines(need0)
        except FeedSourceError as e:
            print(f"error: {e}", file=sys.stderr)
            return 5
        if len(lines) < need0:
            print(
                f"error: live source died ({source.death_reason}) "
                f"after {len(lines)}/{need0} lines — before the "
                "universe scan window (or the resume prefix) filled",
                file=sys.stderr,
            )
            return 5
    else:
        try:
            lines = load_feed_lines(args.feed)
        except OSError as e:
            print(f"error: cannot read feed {args.feed!r}: {e}",
                  file=sys.stderr)
            return 2
    if resume is not None:
        # the token is self-contained (the soak --resume posture): the
        # killed twin's own config continues, shape flags are ignored
        cfg = resume.cfg
    else:
        try:
            twin_knobs = TwinConfig(
                enabled=True,
                scan_lines=args.scan_lines,
                chunk_lines=args.chunk_lines,
                skip_bad=args.skip_bad,
                drain_rounds=args.drain_rounds,
                checkpoint_every=args.checkpoint_every,
                tail_poll_ms=args.tail_poll_ms,
                reconnect_max_s=args.reconnect_max_s,
                idle_timeout_s=args.idle_timeout_s,
                max_lag_lines=args.max_lag_lines,
                refresh_threshold=args.refresh_threshold,
                refresh_window_lines=args.refresh_window,
                forecast_every=args.forecast_every,
            )
        except AssertionError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        universe = twin_universe(lines, twin_knobs.scan_lines)
        heads = probe_feed_heads(lines, universe)
        overrides = {}
        if args.log_capacity is not None:
            overrides["log_capacity"] = args.log_capacity
        if args.nodes is not None:
            overrides["num_nodes"] = args.nodes
        try:
            cfg = dataclasses.replace(
                universe.suggest_config(
                    rounds=int(heads.max(initial=0)) + 1, **overrides
                ),
                twin=twin_knobs,
            ).validate()
        except AssertionError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    flight = None
    if args.flight_out:
        from corro_sim_torch.obs.flight import FlightRecorder

        flight = FlightRecorder(sink_path=args.flight_out)
    checkpoint_path = args.checkpoint or (
        f"{args.out}.ckpt.npz" if args.out else None
    )

    on_cycle = None
    cycles: list = []
    if args.forecast_every > 0:
        if forecast_grid is None:
            print(
                "error: --forecast-every needs a --forecast grid to "
                "re-race",
                file=sys.stderr,
            )
            return 2
        from corro_sim_torch.engine.twin import save_fork
        from corro_sim_torch.workload.inject import trace_workload

        cycle_thresholds = load_thresholds()
        cycle_base = args.fork_out or (
            f"{args.out}.fork.npz" if args.out else "TWIN.fork.npz"
        )

        def on_cycle(ctx):
            # the cadence re-fork loop: fork the IN-FLIGHT state, race
            # the grid, append a trend point. One failed cycle logs and
            # degrades — it never kills the tail it grades.
            n = len(cycles) + 1
            path = f"{cycle_base}.cycle{n}.npz"
            try:
                tok = save_fork(
                    path, cfg=ctx["cfg"], state=ctx["state"],
                    seed=ctx["seed"], rounds=ctx["round"],
                    feed=args.feed,
                    lines_seen=ctx["stream"].lines_seen,
                    chunk=args.chunk,
                )
                wl = None
                if args.forecast_load > 0:
                    wl = trace_workload(ctx["window_chunks"], ctx["cfg"])
                    if wl is not None and wl.rounds > args.forecast_load:
                        k = args.forecast_load
                        wl = dataclasses.replace(
                            wl, rounds=k, writers=wl.writers[-k:],
                            rows=wl.rows[-k:], cols=wl.cols[-k:],
                            vals=wl.vals[-k:], dels=wl.dels[-k:],
                            ncells=wl.ncells[-k:], events=[],
                        )
                fc = run_forecast(
                    tok, forecast_grid["scenario"],
                    forecast_grid["seed"], rounds=args.forecast_rounds,
                    max_rounds=args.max_rounds, chunk=args.chunk,
                    thresholds=cycle_thresholds, coupled_workload=wl,
                    device=device,
                )
            except (ValueError, AssertionError, OSError) as e:
                print(
                    f"# forecast cycle {n} @ chunk {ctx['chunk']} "
                    f"failed (degrading, tail continues): {e}",
                    file=sys.stderr, flush=True,
                )
                cycles.append({
                    "cycle": n, "chunk": ctx["chunk"], "error": str(e),
                })
                return None
            cycles.append({
                "cycle": n, "chunk": ctx["chunk"], "fork": path,
                "fork_round": fc["fork_round"], "lanes": fc["lanes"],
                "ok": fc["ok"],
                "breaches": len(fc["frontier"]["breaches"]),
                **(
                    {"coupled_load": fc["coupled_load"]}
                    if "coupled_load" in fc else {}
                ),
            })
            print(
                f"# forecast cycle {n} @ chunk {ctx['chunk']}: "
                f"{fc['lanes']} lanes from round {fc['fork_round']}"
                + (
                    f", coupled {wl.rounds} load rounds"
                    if wl is not None else ""
                )
                + ("" if fc["ok"] else " [NOT OK]"),
                file=sys.stderr, flush=True,
            )
            return {"trend": fc["trend"]}

    try:
        # the profiler hook, extended to the twin path: the shadow's
        # scan chunks and the forecast dispatch trace into separate
        # subdirs (two phases, two Perfetto-loadable traces)
        with _profiled(
            args.profile_dir
            and os.path.join(args.profile_dir, "shadow"), device,
        ):
            res = run_twin(
                feed=args.feed, cfg=cfg, lines=lines, seed=args.seed,
                checkpoint_path=checkpoint_path, resume=resume,
                flight=flight, universe=universe, source=source,
                on_cycle=on_cycle, device=device,
                on_chunk=lambda h: print(
                    f"# twin chunk {h['chunk']}: {h['lines']} lines "
                    f"({h['bad']} bad), {h['rounds']} rounds, "
                    f"gap {h['gap']:.0f}",
                    file=sys.stderr, flush=True,
                ),
            )
    except ValueError as e:
        # the strict hostile-feed refusal: ONE error naming every bad
        # line, before any sim work (io/traces.py validate_feed)
        print(f"error: {e}", file=sys.stderr)
        return 2
    except Exception as e:
        from corro_sim_torch.io.feedsource import FeedSourceError

        if not isinstance(e, FeedSourceError):
            raise
        # feed truncation mid-tail: committed history rewound under the
        # shadow — refuse loudly (exit 5; the last chunk-boundary
        # cursor, if any, is still resumable against an intact feed)
        print(f"error: {e}", file=sys.stderr)
        return 5
    finally:
        if source is not None:
            source.close()
    report = dict(res.report)
    if checkpoint_path:
        report["checkpoint"] = checkpoint_path
    if args.resume:
        report["resumed_from"] = args.resume

    rc = 0
    if res.poisoned:
        rc = 4
    elif source is not None and source.dead:
        # the tail's NORMAL end: every live source eventually dies
        # (idle timeout when the writer finishes, backoff budget when
        # it vanishes) — distinct exit, full report, resumable cursor
        rc = 5
    elif res.converged_round is None:
        rc = 3
    if cycles:
        report["forecast_cycles"] = cycles
    if forecast_grid is not None and not res.poisoned:
        fork_path = args.fork_out or (
            f"{args.out}.fork.npz" if args.out
            else (args.feed + ".fork.npz")
        )
        tok = fork_twin(res, fork_path, chunk=args.chunk)
        thresholds = load_thresholds()  # raises on a corrupt golden
        with _profiled(
            args.profile_dir
            and os.path.join(args.profile_dir, "forecast"), device,
        ):
            fc = run_forecast(
                tok, forecast_grid["scenario"], forecast_grid["seed"],
                rounds=args.forecast_rounds, max_rounds=args.max_rounds,
                chunk=args.chunk, thresholds=thresholds,
                flight_dir=args.flight_dir, device=device,
                on_chunk=lambda p: print(
                    f"# forecast chunk {p['chunk']}: rounds "
                    f"{p['rounds_done']}, {p['lanes_active']} lanes "
                    "racing",
                    file=sys.stderr, flush=True,
                ),
            )
        # the port's forecast also returns its SweepResult; the report
        # keeps the JAX package's block
        fc = {k: v for k, v in fc.items() if k != "sweep"}
        report["fork"] = fork_path
        report["forecast"] = fc
        # the projected-recovery trend next to the shadow headlines:
        # one point per fork (continuous re-forking appends points —
        # the list IS the trend line: cadence cycles first, the final
        # fork last), and the final point annotates the shadow's
        # flight record at the fork round
        report["forecast_trend"] = list(res.trend) + [fc["trend"]]
        for cell in fc["trend"]["cells"]:
            rec = cell["recovery_rounds"] or {}
            res.flight.annotate(
                res.rounds, "forecast_trend",
                cell=cell["cell"], projected=True,
                fork_round=fc["trend"]["fork_round"],
                recovery_worst=rec.get("worst"),
                recovery_p95=rec.get("p95"),
                rows_lost_worst=cell["rows_lost_worst"],
            )
        if args.frontier:
            with open(args.frontier, "w", encoding="utf-8") as f:
                json.dump(fc["frontier"], f, indent=2)
                f.write("\n")
            report["frontier_artifact"] = args.frontier
        if rc == 0 and fc["frontier"]["breaches"]:
            rc = 6
        if rc == 0 and not fc["ok"]:
            rc = 3
    elif args.fork_out and not res.poisoned:
        fork_twin(res, args.fork_out, chunk=args.chunk)
        report["fork"] = args.fork_out
    if args.flight_out:
        # closed AFTER the forecast so the forecast_trend annotations
        # journal into the shadow timeline they grade
        wrote = res.flight.sink_active
        res.flight.close()
        report["flight"] = args.flight_out if wrote else None
    if args.profile_dir:
        report["profile_dir"] = args.profile_dir
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    # no perf-ledger line: obs/ledger.py waits for item 12 (see
    # _soak_swept)
    print(json.dumps(report, indent=2))
    return rc


def _cmd_load(args: argparse.Namespace) -> int:
    """`corro-sim load` — drive a production-shaped traffic workload
    (corro_sim_torch/workload/, doc/workloads.md) through the simulator.

    Paths: `batched` runs the compiled write schedule through
    ``run_sim``'s scan (convergence under load); `live` maps the same
    schedule to SQL against a LiveCluster with concurrent subscriptions
    + query fans (sub-delivery latency under load); `both` (default)
    runs both and merges the reports. Exit 3 when the batched path fails
    to converge inside the round budget."""
    import time as _time

    device = _device(args)

    from corro_sim_torch.workload import (
        assert_workload_vacuous,
        make_workload,
    )

    wl = make_workload(
        args.spec, args.nodes, rounds=args.rounds, seed=args.seed
    )
    report: dict = {
        "spec": wl.spec,
        "nodes": args.nodes,
        "load_rounds": wl.rounds,
        "schedule": {
            "writes": wl.total_writes,
            "deletes": wl.total_deletes,
            "events": len(wl.events),
            "key_universe": wl.key_universe(),
        },
    }
    rc = 0
    if args.verify_vacuous:
        # the workload-off vacuity claim, verified in-process: the
        # all-idle schedule runs bit-identical to the disabled sampler
        # (the trace-level half waits for item 12's audit)
        t0 = _time.perf_counter()
        assert_workload_vacuous(device=device)
        report["vacuous"] = True
        report["vacuity_check_seconds"] = round(
            _time.perf_counter() - t0, 2
        )
    if args.path in ("batched", "both"):
        import dataclasses

        import numpy as np

        from corro_sim_torch.engine.driver import run_sim
        from corro_sim_torch.engine.state import init_state
        from corro_sim_torch.io.config_file import load_config

        cfg = load_config(args.config)
        cfg = dataclasses.replace(
            cfg,
            num_nodes=args.nodes,
            num_rows=max(args.rows or 0, wl.key_universe(), 16),
            num_cols=max(args.cols or cfg.num_cols, 1),
            seqs_per_version=max(
                cfg.seqs_per_version, wl.cells_width
            ),
        ).validate()
        res = run_sim(
            cfg,
            init_state(cfg, seed=args.seed, device=device),
            max_rounds=args.max_rounds,
            chunk=args.chunk,
            seed=args.seed,
            device=device,
            workload=wl,
        )
        report["batched"] = {
            "converged_round": res.converged_round,
            "rounds_run": res.rounds,
            "writes": int(res.metrics["writes"].sum()),
            "deletes": int(res.metrics["deletes"].sum()),
            "changes_applied": int(res.metrics["fresh"].sum())
            + int(res.metrics["sync_versions"].sum()),
            "final_gap": float(np.asarray(res.metrics["gap"])[-1]),
            "wall_per_round_ms": round(res.wall_per_round_ms, 3),
            "workload_events_annotated": len(
                res.flight.events("workload_event")
            ),
            "poisoned": res.poisoned,
        }
        if args.flight_out:
            res.flight.dump(args.flight_out)
            report["flight"] = args.flight_out
        if res.poisoned:
            rc = 4
        elif res.converged_round is None:
            rc = 3
    if args.path in ("live", "both"):
        from corro_sim_torch.workload.harness import run_live_load

        rep = run_live_load(
            wl,
            subs=args.subs,
            subscribers_per_sub=args.subscribers,
            queries_per_round=args.queries_per_round,
            http=args.http,
            pg=args.pg,
            seed=args.seed,
            settle_rounds=args.settle_rounds,
            device=device,
        )
        report["live"] = rep.as_json()
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    print(json.dumps(report, indent=2))
    return rc


def _cmd_lint(args: argparse.Namespace) -> int:
    """`corro-sim lint` — the trace-safety analyzer; waits (:data:`WAITING`)."""
    return _waiting("lint")


def _cmd_audit(args: argparse.Namespace) -> int:
    """`corro-sim audit` — the program auditors; waits (:data:`WAITING`)."""
    return _waiting("audit")


def _cmd_bench(args: argparse.Namespace) -> int:
    """`corro-sim bench` — the BASELINE configs; waits (:data:`WAITING`)."""
    return _waiting("bench")


def _cmd_perf(args: argparse.Namespace) -> int:
    """`corro-sim perf` — the perf ledger; waits (:data:`WAITING`)."""
    return _waiting("perf")


def _cmd_doctor(args: argparse.Namespace) -> int:
    """`corro-sim doctor` — run diagnosis; waits (:data:`WAITING`)."""
    return _waiting("doctor")


def _profiled(profile_dir: str | None, device=None):
    """The ``--profile-dir`` hook of the sweep and twin paths, on
    ``torch.profiler``: the work inside runs under the profiler (CUDA
    activity too on a card) and its Chrome trace lands in
    ``profile_dir/trace.json``, as ``run_sim(profile_dir=)`` writes it. A
    profiler that fails to start or export never kills the work it
    instruments: it counts ``corro_profile_trace_failures_total`` and the
    work goes on unprofiled."""
    import contextlib

    def _failed():
        from corro_sim_torch.utils.metrics import counters

        counters.inc(
            "corro_profile_trace_failures_total",
            help_="torch.profiler trace failures (profile skipped)",
        )

    @contextlib.contextmanager
    def _cm():
        prof = None
        if profile_dir:
            try:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA]
                    if device is not None and device.type == "cuda"
                    else []
                )
                prof = profile(activities=acts)
                prof.__enter__()
            except Exception:
                prof = None
                _failed()
        try:
            yield
        finally:
            if prof is not None:
                try:
                    prof.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(
                        os.path.join(profile_dir, "trace.json")
                    )
                except Exception:
                    _failed()

    return _cm()


def _cmd_agent(args: argparse.Namespace) -> int:
    """`corrosion agent` analog: run a live cluster behind the HTTP API
    and the admin socket until SIGINT/SIGTERM
    (``corrosion/src/command/agent.rs:16-93``)."""
    from corro_sim_torch.admin import AdminServer
    from corro_sim_torch.api.http import ApiServer
    from corro_sim_torch.harness.cluster import LiveCluster
    from corro_sim_torch.io.checkpoint import load_checkpoint
    from corro_sim_torch.utils.runtime import Tripwire, wait_for_all_pending_handles

    device = _device(args)
    tripwire = Tripwire.new_signals()
    if not args.resume and not args.schema:
        print("agent needs --schema or --resume", file=sys.stderr)
        return 2
    # TLS flag validation (and context build) runs BEFORE the cluster is
    # constructed — a misconfiguration must not cost minutes of compile
    ssl_ctx = None
    if (args.tls_key or args.tls_ca or args.tls_client_auth) \
            and not args.tls_cert:
        # a TLS flag without --tls-cert would silently serve plain HTTP
        print("TLS flags require --tls-cert", file=sys.stderr)
        return 2
    if args.tls_cert:
        from corro_sim_torch.tls import server_ssl_context

        if not args.tls_key:
            print("--tls-cert requires --tls-key", file=sys.stderr)
            return 2
        if args.tls_client_auth and not args.tls_ca:
            print("--tls-client-auth requires --tls-ca", file=sys.stderr)
            return 2
        ssl_ctx = server_ssl_context(
            args.tls_cert, args.tls_key, ca_file=args.tls_ca,
            require_client_auth=args.tls_client_auth,
        )
    if args.resume:
        cluster = load_checkpoint(
            args.resume, tripwire=tripwire, device=device
        )
    else:
        with open(args.schema) as f:
            schema_sql = f.read()
        cluster = LiveCluster(
            schema_sql,
            num_nodes=args.nodes,
            seed=args.seed,
            default_capacity=args.capacity,
            tripwire=tripwire,
            cfg_overrides=(
                {"probes": args.probes} if args.probes else None
            ),
            device=device,
        )
    host, _, port = args.api_addr.partition(":")
    api = ApiServer(
        cluster,
        host=host or "127.0.0.1",
        port=int(port or 0),
        authz_token=args.authz_token,
        tick_interval=args.tick_interval or None,
        ssl_context=ssl_ctx,
    ).start()
    admin = AdminServer(cluster, args.admin_path).start()
    pg = None
    if args.pg_addr:
        from corro_sim_torch.api.pg import PgServer

        pg_host, _, pg_port = args.pg_addr.partition(":")
        pg = PgServer(
            cluster, host=pg_host or "127.0.0.1", port=int(pg_port or 0)
        ).start()
    info = {
        "api": api.url,
        "admin": args.admin_path,
        "nodes": cluster.cfg.num_nodes,
    }
    if pg is not None:
        info["pg"] = f"{pg.addr[0]}:{pg.addr[1]}"
    print(json.dumps(info), flush=True)
    try:
        tripwire.wait()
    finally:
        if pg is not None:
            pg.close()
        api.close()
        admin.close()
        wait_for_all_pending_handles(timeout=10)
    return 0


def _client(args):
    from corro_sim_torch.client import ApiClient

    return ApiClient(args.api, node=args.node, token=args.authz_token)


def _cmd_query(args: argparse.Namespace) -> int:
    """`corrosion query` — streams rows (``main.rs:368-412`` analog)."""
    client = _client(args)
    code = 0
    for e in client.query(args.sql):
        if args.raw:
            print(json.dumps(e))
        elif "row" in e:
            print("|".join(str(v) for v in e["row"][1]))
        elif "error" in e:
            print(f"error: {e['error']}", file=sys.stderr)
            code = 1
    return code


def _cmd_exec(args: argparse.Namespace) -> int:
    """`corrosion exec` — one transaction of statements."""
    resp = _client(args).execute(list(args.sql))
    print(json.dumps(resp))
    return 0 if all("error" not in r for r in resp["results"]) else 1


def _admin(args):
    from corro_sim_torch.admin import AdminClient

    return AdminClient(args.admin_path)


def _print_json(obj) -> int:
    print(json.dumps(obj, indent=2))
    return 0


def _cmd_backup(args: argparse.Namespace) -> int:
    return _print_json(
        _admin(args).call("backup", path=args.path, node=args.node)
    )


def _cmd_restore(args: argparse.Namespace) -> int:
    return _print_json(
        _admin(args).call("restore", path=args.path, node=args.node)
    )


def _cmd_locks(args: argparse.Namespace) -> int:
    return _print_json(_admin(args).call("locks", top=args.top))


def _cmd_sync(args: argparse.Namespace) -> int:
    if args.what == "reconcile-gaps":
        return _print_json(_admin(args).call("sync_reconcile_gaps"))
    return _print_json(
        _admin(args).call("sync_generate", node=args.node)
    )


def _cmd_actor(args: argparse.Namespace) -> int:
    return _print_json(
        _admin(args).call("actor_version", actor=args.actor)
    )


def _cmd_subs(args: argparse.Namespace) -> int:
    if args.id:
        return _print_json(_admin(args).call("subs_info", id=args.id))
    return _print_json(_admin(args).call("subs_list"))


def _cmd_cluster(args: argparse.Namespace) -> int:
    if args.what == "members":
        return _print_json(_admin(args).call("cluster_members"))
    if args.what == "rejoin":
        return _print_json(
            _admin(args).call("cluster_rejoin", node=args.node)
        )
    if args.what == "set-id":
        if args.cluster_id is None:
            print("set-id requires --cluster-id", file=sys.stderr)
            return 2
        return _print_json(
            _admin(args).call(
                "cluster_set_id", node=args.node,
                cluster_id=args.cluster_id,
            )
        )
    return _print_json(_admin(args).call("cluster_membership_states"))


def _cmd_template(args: argparse.Namespace) -> int:
    """`corrosion template` — render + live re-render config files
    (``corrosion/src/command/tpl.rs``)."""
    from corro_sim_torch.tpl import TemplateWatcher
    from corro_sim_torch.utils.runtime import Tripwire

    src, _, dst = args.template.partition(":")
    if not dst:
        dst = src + ".out"
    w = TemplateWatcher(
        _client(args), src, dst, node=args.node,
        tripwire=Tripwire.new_signals(),
    )
    if args.once:
        w.render_once()
        return 0
    w.run()
    return 0


def _cmd_consul_sync(args: argparse.Namespace) -> int:
    """`corrosion consul sync` — poll the local Consul agent and mirror
    services/checks into the cluster (``command/consul/sync.rs``)."""
    from corro_sim_torch.integrations.consul import (
        ConsulAgentClient,
        ConsulSync,
        FileConsulSource,
    )
    from corro_sim_torch.utils.runtime import Tripwire

    source = (
        FileConsulSource(args.consul_file) if args.consul_file
        else ConsulAgentClient(args.consul_addr)
    )
    sync = ConsulSync(
        source, _client(args), node_name=args.node_name,
        state_path=args.state_path, target_node=args.node,
    )
    if args.once:
        print(json.dumps(sync.sync_once()))
        return 0
    sync.run(Tripwire.new_signals(), interval=args.interval)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="corro-sim-torch",
        description="simulator of Corrosion's replication protocols "
                    "(the PyTorch/CUDA port)",
    )
    p.add_argument(
        "--device",
        help="where the commands that build tensors run (default cuda; "
             "pass cpu for the plain PyTorch path). The client commands "
             "take no device",
    )
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("run", help="run a simulation to convergence")
    pr.add_argument("--config", help="TOML config file ([sim] table)")
    pr.add_argument("--nodes", type=int)
    pr.add_argument("--rows", type=int)
    pr.add_argument("--cols", type=int)
    pr.add_argument("--log-capacity", type=int)
    pr.add_argument("--write-rate", type=float)
    pr.add_argument("--zipf", type=float)
    pr.add_argument("--swim", action="store_const", const=True)
    pr.add_argument(
        "--swim-view", type=int,
        help="windowed SWIM: members tracked per node (0 = full view)",
    )
    pr.add_argument("--sync-interval", type=int)
    pr.add_argument(
        "--no-pipeline", dest="pipeline", action="store_const", const=False,
        help="disable pipelined chunk dispatch (speculative next-chunk "
             "dispatch + async metric fetch; doc/performance.md) and run "
             "the sequential chunk loop — results are bit-identical, "
             "only dispatch order changes",
    )
    pr.add_argument("--write-rounds", type=int, default=32)
    pr.add_argument("--max-rounds", type=int, default=4096)
    pr.add_argument("--chunk", type=int, default=16)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument(
        "--flight-out",
        help="journal the per-round flight-recorder timeline (ND-JSON) "
             "to this path, chunk by chunk",
    )
    pr.add_argument(
        "--probes", type=int,
        help="track K sampled versions through the gossip fabric "
             "on-device (probe tracer; 0 = off)",
    )
    pr.add_argument(
        "--probe-out",
        help="path prefix for the probe artifacts (<prefix>.ndjson + "
             "<prefix>.trace.json, Perfetto-loadable); defaults next to "
             "--flight-out",
    )
    pr.add_argument(
        "--profile-dir",
        help="capture a torch.profiler trace of the chunk loop into "
             "this directory (trace.json, Perfetto-loadable)",
    )
    pr.add_argument(
        "--scenario",
        help="chaos scenario spec `name[:k=v,...]` (faults/scenarios.py: "
             "lossy:p=0.1, rolling_restart, split_brain_heal, churn, "
             "flapper, blackhole_one_way, ...); arms the invariant "
             "checkers and reports recovery time",
    )
    pr.add_argument(
        "--workload",
        help="couple a traffic workload spec `name[:k=v,...][+...]` "
             "(corro_sim_torch/workload/) into the run — accepted TOGETHER "
             "with --scenario (load + faults in one spec); the fault "
             "window and the write range must overlap, validated up "
             "front",
    )
    pr.add_argument(
        "--knob", action="append", metavar="FIELD=VALUE",
        help="link-fault threshold override on top of the scenario "
             "(loss/dup/burst_*/sync_loss); repeatable — the sweep "
             "frontier's worst-seed repro surface (doc/sweeping.md)",
    )
    pr.add_argument(
        "--scenario-rounds", type=int,
        help="fault-timeline horizon the scenario compiles against "
             "(default: --max-rounds). Sweep worst-seed repro commands "
             "pin this to the lane's horizon — wave-shaped generators "
             "derive different timelines from different horizons",
    )
    pr.add_argument(
        "--fork", metavar="TOKEN",
        help="warm-start from a twin fork token (corro-sim twin "
             "--fork-out; doc/twin.md): the run resumes the forked "
             "state under the --scenario applied on top — the what-if "
             "forecast's one-command serial repro. The token owns the "
             "base shape (shape flags refused); node-fault rounds "
             "shift into the fork's absolute frame automatically",
    )
    pr.add_argument(
        "--scorecard", action="store_true",
        help="arm the resilience scorecard (faults/scorecard.py): the "
             "report gains a `resilience` block (recovery_rounds, "
             "rows_lost, resync_rows, SWIM churn, sub-delivery "
             "degradation under a coupled --workload); armed "
             "automatically for node-fault scenarios",
    )
    pr.add_argument(
        "--check-invariants", action="store_true",
        help="run the fault invariant checkers (faults/invariants.py) "
             "even without a scenario; violations exit 5",
    )
    pr.add_argument(
        "--transfer-guard", action="store_true",
        help="refuse host syncs outside the sanctioned staging and "
             "resolve points of the chunk loop; not in the port yet "
             "(exits 2)",
    )
    pr.add_argument(
        "--mesh", action="store_true",
        help="shard the cluster state over all visible devices; not in "
             "the port yet (exits 2)",
    )
    pr.add_argument(
        "--shard-log", choices=("on", "off", "auto"),
        help="change-log placement on the mesh: on = actor-sharded "
             "(per-device log HBM drops by the mesh size, delivery/sync "
             "gathers become collectives), off = replicated, auto = the "
             "SHARD_LOG_ACTORS size heuristic (default; doc/multichip.md)",
    )
    pr.set_defaults(fn=_cmd_run)

    plo = sub.add_parser(
        "load",
        help="drive a production-shaped traffic workload (Zipf, bursts, "
             "churn storms) through the batched and/or live paths",
    )
    plo.add_argument(
        "spec",
        help="workload spec `name[:k=v,...][+name2...]` "
             "(corro_sim_torch/workload/: zipf, uniform, burst, multiwriter, "
             "churn_storm; `+` composes — doc/workloads.md)",
    )
    plo.add_argument("--config", help="TOML config file ([sim] table)")
    plo.add_argument("--nodes", type=int, default=32)
    plo.add_argument("--rounds", type=int, default=32,
                     help="load-phase rounds to schedule")
    plo.add_argument("--rows", type=int,
                     help="row-slot capacity (default: the schedule's "
                          "key universe)")
    plo.add_argument("--cols", type=int)
    plo.add_argument("--seed", type=int, default=0)
    plo.add_argument(
        "--path", choices=("batched", "live", "both"), default="both",
        help="batched = run_sim convergence under load; live = "
             "LiveCluster + subscriptions + query fans (sub-delivery "
             "latency)",
    )
    plo.add_argument("--max-rounds", type=int, default=4096,
                     help="batched-path round budget")
    plo.add_argument("--chunk", type=int, default=16)
    plo.add_argument("--subs", type=int, default=16,
                     help="distinct subscription queries (live path)")
    plo.add_argument("--subscribers", type=int, default=1,
                     help="subscriber streams per subscription")
    plo.add_argument("--queries-per-round", type=int, default=0,
                     help="one-shot queries fanned per round")
    plo.add_argument("--http", action="store_true",
                     help="fan queries through a real HTTP API server")
    plo.add_argument("--pg", action="store_true",
                     help="fan queries through a real pgwire server")
    plo.add_argument("--settle-rounds", type=int, default=256,
                     help="post-load rounds allowed for the live cluster "
                          "to drain")
    plo.add_argument("--verify-vacuous", action="store_true",
                     help="prove the workload-off claim in-process: an "
                          "all-idle schedule must run bit-identical to "
                          "the disabled sampler")
    plo.add_argument("--flight-out",
                     help="dump the batched run's flight timeline "
                          "(ND-JSON) with workload_event annotations")
    plo.add_argument("--out", help="also write the report JSON here")
    plo.set_defaults(fn=_cmd_load)

    ps = sub.add_parser(
        "soak",
        help="sweep chaos scenarios under invariant checking; report "
             "recovery time per scenario",
    )
    ps.add_argument("--config", help="TOML config file ([sim] table)")
    ps.add_argument("--nodes", type=int)
    ps.add_argument("--rows", type=int)
    ps.add_argument("--cols", type=int)
    ps.add_argument("--log-capacity", type=int)
    ps.add_argument("--write-rate", type=float)
    ps.add_argument("--zipf", type=float)
    ps.add_argument("--swim", action="store_const", const=True)
    ps.add_argument("--swim-view", type=int)
    ps.add_argument("--sync-interval", type=int)
    ps.add_argument("--probes", type=int)
    ps.add_argument(
        "--no-pipeline", dest="pipeline", action="store_const", const=False,
        help="disable pipelined chunk dispatch for every scenario run",
    )
    ps.add_argument(
        "--scenario", action="append",
        help="scenario spec `name[:k=v,...]`; repeatable (default: sweep "
             "the recoverable catalog — permanent-fault scenarios like "
             "blackhole_one_way and ring/star are opt-in by name)",
    )
    ps.add_argument(
        "--workload",
        help="couple a traffic workload spec into EVERY scenario run "
             "(load + faults in one spec; corro_sim_torch/workload/). "
             "Coupling is validated (fault window must overlap the "
             "write range) and checkpointing is disabled for coupled "
             "runs",
    )
    ps.add_argument(
        "--scorecard", nargs="?", const="SCORECARD.json", metavar="PATH",
        help="arm the resilience scorecard on every scenario, write the "
             "per-scenario blocks + threshold verdict to PATH (default "
             "SCORECARD.json), and gate against faults/"
             "resilience_thresholds.json — breaches exit 6",
    )
    ps.add_argument(
        "--rounds", type=int, default=128,
        help="scenario length in rounds (fault timeline horizon)",
    )
    ps.add_argument("--write-rounds", type=int, default=16)
    ps.add_argument("--max-rounds", type=int, default=4096)
    ps.add_argument("--chunk", type=int, default=16)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument(
        "--out",
        help="artifact path prefix: <out>.<scenario>.ndjson flight "
             "journals + <out>.report.json (+ <out>.ckpt.npz resume "
             "token and <out>.partial.json if the run dies)",
    )
    ps.add_argument(
        "--checkpoint",
        help="resumable-checkpoint path (default: <out>.ckpt.npz when "
             "--out is set; io/checkpoint.py sim checkpoints)",
    )
    ps.add_argument(
        "--checkpoint-every", type=int, default=None,
        help="chunks between resumable checkpoints (default 4 in the "
             "serial loop; only active when a checkpoint path "
             "resolves). An explicit nonzero cadence implies --serial "
             "— the swept path writes no resume tokens; 0 "
             "keeps the swept path (no checkpoints either way)",
    )
    ps.add_argument(
        "--resume",
        help="continue a killed soak from its checkpoint file — the "
             "token reconstructs the sweep (config, seed, chunking, "
             "remaining scenarios) and the killed scenario continues "
             "bit-identically; other flags are ignored (implies "
             "--serial: resume tokens are a sequential-loop concept)",
    )
    ps.add_argument(
        "--serial", action="store_true",
        help="run the sequential one-run_sim-per-scenario loop instead "
             "of the default sweep dispatch (corro_sim_torch/sweep/) "
             "— the escape hatch for checkpointed multi-hour soaks and "
             "schedules the lane encoding cannot carry; also implied "
             "by --resume and an explicit --checkpoint",
    )
    ps.set_defaults(fn=_cmd_soak)

    psw = sub.add_parser(
        "sweep",
        help="race a scenario x seed x knob chaos matrix as lanes of "
             "ONE dispatch; resilience frontier + worst-seed "
             "repro (doc/sweeping.md)",
    )
    psw.add_argument(
        "grid", nargs="+", metavar="AXIS=VALUES",
        help="grid axes: scenario=name[:k=v,..][,name2...] (';' hard-"
             "separates), seed=0..31 or comma list, knob.loss=0.05,0.2 "
             "(link-fault threshold axes cross-product)",
    )
    psw.add_argument("--config", help="TOML config file ([sim] table)")
    psw.add_argument("--nodes", type=int)
    psw.add_argument("--rows", type=int)
    psw.add_argument("--cols", type=int)
    psw.add_argument("--log-capacity", type=int)
    psw.add_argument("--write-rate", type=float)
    psw.add_argument("--zipf", type=float)
    psw.add_argument("--swim", action="store_const", const=True)
    psw.add_argument("--swim-view", type=int)
    psw.add_argument("--sync-interval", type=int)
    psw.add_argument("--probes", type=int)
    psw.add_argument(
        "--rounds", type=int, default=128,
        help="scenario length in rounds (fault timeline horizon)",
    )
    psw.add_argument("--write-rounds", type=int, default=16)
    psw.add_argument("--max-rounds", type=int, default=4096)
    psw.add_argument("--chunk", type=int, default=16)
    psw.add_argument(
        "--workload",
        help="couple a traffic workload spec into EVERY lane "
             "(lane-seeded; fault-window overlap validated per lane "
             "up front, all errors in one report)",
    )
    psw.add_argument(
        "--mesh", action="store_true",
        help="shard the lane axis over all visible devices; not in the "
             "port yet (exits 2)",
    )
    psw.add_argument(
        "--compact", action="store_true",
        help="the fleet scheduler (doc/sweeping.md §fleet-scheduler): "
             "evict settled lanes at chunk boundaries, refill their "
             "slots from the pending-grid queue, shrink the batch to "
             "power-of-2 buckets once the queue drains — every lane "
             "stays bit-identical to its serial twin; does not compose "
             "with --mesh",
    )
    psw.add_argument(
        "--width", type=int, metavar="W",
        help="cap the compacted lane-batch width (rounded up to a "
             "power-of-2 bucket; lanes beyond it queue). Default: the "
             "whole grid in one batch",
    )
    psw.add_argument(
        "--pipeline", action="store_true",
        help="speculative dispatch: enqueue chunk N+1 before chunk N's "
             "convergence scalar lands (predicted on 'no lane "
             "settles'; a mispredict discards the speculative result "
             "and re-dispatches, so committed chunks are exactly the "
             "sequential ones — doc/performance.md §chunk-pipelining)",
    )
    psw.add_argument(
        "--frontier", nargs="?", const="FRONTIER.json", metavar="PATH",
        help="write the resilience-frontier artifact (per-cell "
             "worst/p95 over seeds + worst-seed repro commands) to "
             "PATH (default FRONTIER.json)",
    )
    psw.add_argument(
        "--progress", action="store_true",
        help="per-chunk lane-state progress lines (fleet observatory): "
             "racing/converged/poisoned counts, cumulative wasted "
             "frozen-lane rounds, and a one-char-per-lane state string",
    )
    psw.add_argument(
        "--flight-dir", metavar="DIR",
        help="demux every lane's flight timeline (per-round metrics + "
             "derived diagnostics + annotations, field-identical to "
             "its serial twin's) into per-lane ND-JSON files under DIR "
             "— no lane is re-run; read them with `corro-sim flight "
             "<file>` (doc/observability.md §lane-observatory)",
    )
    psw.add_argument(
        "--heatmap", metavar="PATH",
        help="write the cell x seed grid heatmap artifact "
             "(rounds-to-convergence / recovery / rows_lost / "
             "degradation_p99 matrices) to PATH "
             "and print an ASCII rendering to stderr",
    )
    psw.add_argument(
        "--profile-dir",
        help="capture a torch.profiler trace of the fleet dispatch "
             "into this directory (trace.json, Perfetto-loadable)",
    )
    psw.add_argument("--out", help="also write the full report JSON here")
    psw.set_defaults(fn=_cmd_sweep)

    pt2 = sub.add_parser(
        "twin",
        help="shadow a changeset feed (streaming ingest + per-chunk "
             "headlines) and forecast what-if chaos off a forked twin "
             "state (doc/twin.md)",
    )
    pt2.add_argument(
        "feed",
        help="ND-JSON changeset feed (corro-api-types wire shapes — "
             "io/traces.py module docstring)",
    )
    pt2.add_argument(
        "--scan-lines", type=int, default=0,
        help="universe scan window in feed lines (0 = scan the whole "
             "feed); lines naming actors/tables/values outside the "
             "frozen window quarantine",
    )
    pt2.add_argument(
        "--chunk-lines", type=int, default=64,
        help="feed lines consumed per shadow chunk (the checkpoint "
             "cursor granularity)",
    )
    pt2.add_argument(
        "--skip-bad", action="store_true",
        help="quarantine hostile feed lines with per-reason counters "
             "(corro_twin_bad_lines_total) + flight annotations instead "
             "of refusing the whole feed with one up-front error",
    )
    pt2.add_argument("--seed", type=int, default=0)
    pt2.add_argument(
        "--nodes", type=int,
        help="shadow cluster size (default: the feed's actor count)",
    )
    pt2.add_argument(
        "--log-capacity", type=int,
        help="change-log ring size (default: the feed's deepest actor "
             "history + 1)",
    )
    pt2.add_argument(
        "--drain-rounds", type=int, default=256,
        help="post-feed round budget chasing gap -> 0",
    )
    pt2.add_argument(
        "--checkpoint",
        help="cursor-checkpoint path (default: <out>.ckpt.npz when "
             "--out is set)",
    )
    pt2.add_argument(
        "--checkpoint-every", type=int, default=1,
        help="feed chunks between cursor checkpoints (0 = none)",
    )
    pt2.add_argument(
        "--resume", metavar="TOKEN",
        help="continue a SIGKILL'd twin from its cursor token — the "
             "remaining feed plays out bit-identically to the "
             "uninterrupted run (shape flags are ignored; the token "
             "carries the config)",
    )
    pt2.add_argument(
        "--tail", action="store_true",
        help="LIVE mode: treat FEED as a growing source — a polled "
             "file tail (rotation re-binds via inode + consumed-prefix "
             "sha, truncation refuses) or, for an http(s):// FEED, a "
             "reconnecting /v1/changes watch — and shadow chunks as "
             "they arrive, bit-identically to file-mode replay of the "
             "same lines; needs --scan-lines; exits 5 with a resumable "
             "cursor when the source dies past its backoff/idle budget",
    )
    pt2.add_argument(
        "--tail-poll-ms", type=int, default=250,
        help="tail poll interval in ms (file stat / HTTP request "
             "cadence between arrivals)",
    )
    pt2.add_argument(
        "--reconnect-max-s", type=float, default=30.0,
        help="total jittered-backoff budget retrying a vanished "
             "source before declaring it dead",
    )
    pt2.add_argument(
        "--idle-timeout-s", type=float, default=10.0,
        help="a reachable source delivering NOTHING for this long is "
             "dead (the tail's clean end when the writer finishes)",
    )
    pt2.add_argument(
        "--max-lag-lines", type=int, default=65536,
        help="backpressure bound: stop reading ahead when this many "
             "fetched lines await the shadow",
    )
    pt2.add_argument(
        "--refresh-threshold", type=float, default=0.0,
        help="stale-universe refresh trigger: when the windowed "
             "unknown-actor/row/col/value quarantine rate crosses this "
             "fraction, re-freeze the closed world from the trailing "
             "window at the next chunk boundary "
             "(corro_twin_refresh_total; 0 = never; needs --skip-bad)",
    )
    pt2.add_argument(
        "--refresh-window", type=int, default=256, metavar="LINES",
        help="trailing feed-line window the refresh rate is measured "
             "over (also the re-scan window on refresh)",
    )
    pt2.add_argument(
        "--forecast-every", type=int, default=0, metavar="CHUNKS",
        help="cadence re-fork loop: every N shadowed chunks, fork the "
             "live state and race the --forecast grid, appending one "
             "forecast_trend point per cycle (0 = only the final "
             "forecast)",
    )
    pt2.add_argument(
        "--forecast-load", type=int, default=0, metavar="ROUNDS",
        help="with --forecast-every: replay up to ROUNDS of the "
             "trailing feed window into every forecast lane as coupled "
             "workload (workload/inject.py trace_workload) so recovery "
             "is graded under the live traffic (0 = uncoupled)",
    )
    pt2.add_argument(
        "--forecast", nargs="+", metavar="AXIS=VALUES",
        help="what-if grid (the sweep grammar: scenario=crash_amnesia:"
             "nodes=2,at=4,down=4,lossy:p=0.2 seed=0..3): fork the "
             "final twin state and race every (scenario x seed) lane "
             "in ONE dispatch, graded against the "
             "twin_forecast threshold section (breach = exit 6)",
    )
    pt2.add_argument(
        "--forecast-rounds", type=int, default=64,
        help="fault-timeline horizon of each forecast lane (relative "
             "to the fork)",
    )
    pt2.add_argument("--max-rounds", type=int, default=1024,
                     help="forecast round budget")
    pt2.add_argument("--chunk", type=int, default=8,
                     help="forecast dispatch chunk")
    pt2.add_argument(
        "--fork-out", metavar="PATH",
        help="write the fork token here (default <out>.fork.npz with "
             "--forecast; also usable without --forecast to hand the "
             "token to `corro-sim run --fork`)",
    )
    pt2.add_argument(
        "--frontier", nargs="?", const="TWIN_frontier.json",
        metavar="PATH",
        help="write the projected resilience-frontier artifact "
             "(per-cell worst/p95 + worst-seed `run --fork` repro "
             "commands)",
    )
    pt2.add_argument("--flight-out",
                     help="journal the shadow's flight timeline "
                          "(ND-JSON) with twin_chunk/twin_bad_line "
                          "annotations")
    pt2.add_argument(
        "--flight-dir", metavar="DIR",
        help="with --forecast: demux every forecast lane's flight "
             "timeline (projected: true in its meta) into per-lane "
             "ND-JSON files under DIR — the fleet observatory surface "
             "(doc/observability.md §lane-observatory)",
    )
    pt2.add_argument(
        "--profile-dir",
        help="capture torch.profiler traces of the shadow "
             "(<dir>/shadow/trace.json) and the forecast dispatch "
             "(<dir>/forecast/trace.json)",
    )
    pt2.add_argument("--out", help="also write the report JSON here")
    pt2.set_defaults(fn=_cmd_twin)

    pli = sub.add_parser(
        "lint",
        help="corro-lint: static trace-safety analysis; not in the "
             "port yet (exits 2)",
    )
    pli.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: corro_sim)",
    )
    pli.add_argument(
        "--format", choices=["text", "json"], default="text",
        help="report format on stdout",
    )
    pli.add_argument(
        "--strict", action="store_true",
        help="exit 1 on warnings too, not just errors",
    )
    pli.add_argument(
        "--out",
        help="also write the JSON findings report to this path "
             "(the CI artifact)",
    )
    pli.set_defaults(fn=_cmd_lint)

    pau = sub.add_parser(
        "audit",
        help="program audit: feature-off vacuity + golden op-count "
             "fingerprint; not in the port yet (exits 2)",
    )
    pau.add_argument(
        "--update-golden", action="store_true",
        help="re-baseline analysis/golden/jaxpr_fingerprint.json from "
             "the current tree (commit the diff with the change that "
             "moved the op counts)",
    )
    pau.add_argument(
        "--json", action="store_true", help="print the full JSON report"
    )
    pau.add_argument(
        "--diff", action="store_true",
        help="print (and embed in the report) the per-primitive eqn "
             "delta vs the committed golden — the PR's op-budget cost "
             "at a glance, shown pass or fail",
    )
    pau.add_argument(
        "--contracts", action="store_true",
        help="also run the program-contract auditor: jaxpr dataflow "
             "vacuity proofs for every registered feature x program, "
             "collective budgets of the sharded/sweep programs, "
             "determinism lints, and the static peak-HBM golden "
             "(analysis/golden/program_contracts.json; "
             "doc/static_analysis.md)",
    )
    pau.add_argument(
        "--keys", action="store_true",
        help="also run the key-lineage auditor: reconstruct every "
             "program's PRNG derivation forest and prove K1 single-"
             "consumption, K2 stream disjointness (declared == "
             "observed fold tags), and K3 lane/fork independence "
             "(analysis/golden/key_lineage.json; "
             "doc/static_analysis.md §4)",
    )
    pau.add_argument(
        "--out", help="also write the JSON report to this path"
    )
    pau.set_defaults(fn=_cmd_audit)

    pb = sub.add_parser(
        "bench",
        help="run a BASELINE benchmark config; not in the port yet "
             "(exits 2)",
    )
    pb.add_argument(
        "--config", dest="bench_config", type=int,
        choices=[0, 1, 2, 3, 4, 5, 6, 7, 8],
        help="0=north-star (10k sim convergence wall vs 64-agent "
             "devcluster wall) 1=devcluster 2=64-node slice 3=1k zipf "
             "4=10k headline 5=50k outage catch-up 6=workload engine "
             "7=weak-scaling multichip (100k @ 8 devices, actor-sharded "
             "log, windowed SWIM; doc/multichip.md) 8=chaos-matrix "
             "sweep (scenario x seed grid in one dispatch, "
             "clusters/sec/device; doc/sweeping.md)",
    )
    pb.add_argument("--nodes", dest="bench_nodes", type=int,
                    help="override the config's cluster size")
    pb.set_defaults(fn=_cmd_bench)

    pp = sub.add_parser(
        "perf",
        help="performance ledger & regression sentinel: platform-keyed "
             "trajectories for every bench/sweep/twin number, gated by "
             "committed tolerance bands; not in the port yet (exits 2)",
    )
    pp.add_argument(
        "artifacts", nargs="*", metavar="ARTIFACT",
        help="with --ingest: perf artifacts to normalize and append "
             "(BENCH_rNN/MULTICHIP_rNN round wrappers, bench one-line "
             "JSON, sweep/twin reports; default: the BENCH_r*/"
             "MULTICHIP_r* round artifacts in the cwd)",
    )
    pp.add_argument(
        "--ingest", action="store_true",
        help="normalize the artifacts into ledger records and append "
             "them (append-only ND-JSON; one record per number, keyed "
             "by config, platform, device_kind, git rev, seq)",
    )
    pp.add_argument(
        "--show", action="store_true",
        help="per-(config, platform) trajectories with ASCII "
             "sparklines (the default mode)",
    )
    pp.add_argument(
        "--check", action="store_true",
        help="grade each series' latest measured value against the "
             "committed tolerance bands — exit 6 on breach; "
             "cross-platform comparisons honest-skip and unmeasured "
             "records never grade",
    )
    pp.add_argument(
        "--update", action="store_true",
        help="with --check: re-baseline the bands from the ledger's "
             "latest measured values (the audit-golden discipline — "
             "commit the diff with the change that moved the number)",
    )
    pp.add_argument(
        "--ledger", metavar="PATH",
        help="ND-JSON ledger path (default: the committed "
             "analysis/golden/perf_ledger.ndjson when it exists, else "
             "the bench_out/ working ledger)",
    )
    pp.add_argument(
        "--bands", metavar="PATH",
        help="tolerance-bands file (default: the committed "
             "analysis/golden/perf_bands.json)",
    )
    pp.add_argument(
        "--tolerance-pct", type=float, default=25.0,
        help="default band width for --update (per-band values in the "
             "committed file survive re-baselines)",
    )
    pp.add_argument(
        "--out", metavar="PATH",
        help="also write the JSON trajectory artifact here",
    )
    pp.set_defaults(fn=_cmd_perf)

    pdoc = sub.add_parser(
        "doctor",
        help="cross-artifact run diagnosis: classify flight/sweep/twin/"
             "ledger/profile artifacts by shape, join the evidence, and "
             "rank findings with citations, actions and repro commands; "
             "not in the port yet (exits 2)",
    )
    pdoc.add_argument(
        "artifacts", nargs="*", metavar="ARTIFACT",
        help="artifact files or directories to diagnose (flight "
             "journals, sweep/soak/twin reports, frontiers, perf "
             "ledgers/bands/check results, --profile-dir traces; "
             "default: the committed golden ledger plus bench_out/)",
    )
    pdoc.add_argument(
        "--check", action="store_true",
        help="exit 6 when a critical finding fires (the soak/frontier/"
             "perf tripwire code)",
    )
    pdoc.add_argument(
        "--out", metavar="PATH",
        help="also write the deterministic JSON report here",
    )
    pdoc.set_defaults(fn=_cmd_doctor)

    pa = sub.add_parser("agent", help="run a live cluster (HTTP API + admin)")
    pa.add_argument("--schema", help="schema DDL file")
    pa.add_argument("--resume", help="warm-boot from a checkpoint file")
    pa.add_argument("--nodes", type=int, default=4)
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--capacity", type=int, default=256)
    pa.add_argument("--api-addr", default="127.0.0.1:0")
    pa.add_argument(
        "--pg-addr",
        help="also serve the Postgres wire protocol on host:port "
             "(api.pg.addr analog; off when omitted)",
    )
    pa.add_argument("--admin-path", default="./corro-sim-admin.sock")
    pa.add_argument("--authz-token")
    pa.add_argument("--tls-cert", help="serve the HTTP API over TLS")
    pa.add_argument("--tls-key", help="private key for --tls-cert")
    pa.add_argument("--tls-ca", help="CA bundle for client verification")
    pa.add_argument(
        "--tls-client-auth", action="store_true",
        help="require client certificates (mutual TLS)",
    )
    pa.add_argument(
        "--tick-interval", type=float, default=0.1,
        help="background gossip cadence in seconds (0 disables)",
    )
    pa.add_argument(
        "--probes", type=int, default=0,
        help="track K sampled versions on-device (probe tracer; "
             "read via /v1/probes or `corro-sim probes`)",
    )
    pa.set_defaults(fn=_cmd_agent)

    def api_args(sp):
        sp.add_argument("--api", default="127.0.0.1:8080",
                        help="agent HTTP address")
        sp.add_argument("--node", type=int, default=0)
        sp.add_argument("--authz-token")

    def admin_args(sp):
        sp.add_argument("--admin-path", default="./corro-sim-admin.sock")

    pq = sub.add_parser("query", help="run a SELECT against an agent")
    api_args(pq)
    pq.add_argument("--raw", action="store_true", help="print raw events")
    pq.add_argument("sql")
    pq.set_defaults(fn=_cmd_query)

    pe = sub.add_parser("exec", help="execute DML statements (one tx)")
    api_args(pe)
    pe.add_argument("sql", nargs="+")
    pe.set_defaults(fn=_cmd_exec)

    pbk = sub.add_parser("backup", help="portable actor-neutral snapshot")
    admin_args(pbk)
    pbk.add_argument("--node", type=int, default=0)
    pbk.add_argument("path")
    pbk.set_defaults(fn=_cmd_backup)

    prs = sub.add_parser("restore", help="restore a backup into the agent")
    admin_args(prs)
    prs.add_argument("--node", type=int, default=0)
    prs.add_argument("path")
    prs.set_defaults(fn=_cmd_restore)

    pl = sub.add_parser("locks", help="lock registry dump")
    admin_args(pl)
    pl.add_argument("--top", type=int)
    pl.set_defaults(fn=_cmd_locks)

    psy = sub.add_parser("sync", help="sync state tooling")
    admin_args(psy)
    psy.add_argument(
        "what", nargs="?", default="generate",
        choices=["generate", "reconcile-gaps"],
    )
    psy.add_argument("--node", type=int, default=0)
    psy.set_defaults(fn=_cmd_sync)

    pac = sub.add_parser("actor", help="actor version bookkeeping")
    admin_args(pac)
    pac.add_argument("actor", type=int)
    pac.set_defaults(fn=_cmd_actor)

    psb = sub.add_parser("subs", help="list/inspect subscriptions")
    admin_args(psb)
    psb.add_argument("id", nargs="?")
    psb.set_defaults(fn=_cmd_subs)

    pc = sub.add_parser("cluster", help="membership introspection + ops")
    admin_args(pc)
    pc.add_argument(
        "what",
        choices=["members", "membership-states", "rejoin", "set-id"],
    )
    pc.add_argument("--node", type=int, default=0)
    pc.add_argument("--cluster-id", type=int)
    pc.set_defaults(fn=_cmd_cluster)

    pt = sub.add_parser(
        "template", help="render a template (live re-render on change)"
    )
    api_args(pt)
    pt.add_argument("template", help="src[:dst] template/output paths")
    pt.add_argument("--once", action="store_true")
    pt.set_defaults(fn=_cmd_template)

    pcs = sub.add_parser(
        "consul-sync", help="mirror Consul services/checks into the cluster"
    )
    api_args(pcs)
    pcs.add_argument("--consul-addr", default="http://127.0.0.1:8500")
    pcs.add_argument("--consul-file",
                     help="JSON file source instead of a live agent")
    pcs.add_argument("--node-name", default="corro-sim-node")
    pcs.add_argument(
        "--state-path", default="./corro-consul-state.json",
        help="hash-state sidecar file (persisting it lets deletions that "
             "happen while the daemon is down propagate on restart)",
    )
    pcs.add_argument("--interval", type=float, default=1.0)
    pcs.add_argument("--once", action="store_true")
    pcs.set_defaults(fn=_cmd_consul_sync)

    pdc = sub.add_parser(
        "devcluster",
        help="run an `A -> B` topology file as one simulated cluster",
    )
    pdc.add_argument("topology", help="topology file of `A -> B` lines")
    pdc.add_argument("--schema", required=True, help="schema DDL file")
    pdc.add_argument(
        "--statedir", help="write per-node state dirs with node.json maps"
    )
    pdc.add_argument("--seed", type=int, default=0)
    pdc.add_argument("--capacity", type=int, default=256)
    pdc.add_argument("--api-addr", default="127.0.0.1:0")
    pdc.add_argument("--admin-path", default="./corro-devcluster-admin.sock")
    pdc.add_argument("--tick-interval", type=float, default=0.1)
    pdc.set_defaults(fn=_cmd_devcluster)

    prl = sub.add_parser(
        "reload", help="re-apply schema files through the running agent"
    )
    api_args(prl)
    prl.add_argument("schema_files", nargs="+")
    prl.set_defaults(fn=_cmd_reload)

    pfl = sub.add_parser(
        "flight", help="per-round telemetry timeline (flight recorder)"
    )
    admin_args(pfl)
    pfl.add_argument(
        "path", nargs="?",
        help="read a flight ND-JSON export directly (a `run "
             "--flight-out` journal, or a per-lane file from `sweep/"
             "twin --flight-dir`) instead of dialing the admin socket",
    )
    pfl.add_argument("-n", type=int, help="only the last N rounds")
    pfl.add_argument(
        "--diag", action="store_true",
        help="print only the derived convergence diagnostics",
    )
    pfl.add_argument(
        "--export", help="dump the full ND-JSON timeline to this path "
        "(written by the agent process)",
    )
    pfl.set_defaults(fn=_cmd_flight)

    ppb = sub.add_parser(
        "probes",
        help="probe-tracer provenance + per-node lag observatory",
    )
    admin_args(ppb)
    ppb.add_argument(
        "--lag", action="store_true",
        help="print only the per-node lag observatory",
    )
    ppb.add_argument(
        "--top", type=int, default=8,
        help="laggards listed by the observatory",
    )
    ppb.add_argument(
        "--export",
        help="write <prefix>.ndjson + <prefix>.trace.json server-side",
    )
    ppb.set_defaults(fn=_cmd_probes)

    ptr = sub.add_parser("traces", help="recent spans from the tracer")
    admin_args(ptr)
    ptr.add_argument("-n", type=int, default=100)
    ptr.add_argument("--name", help="filter by span name")
    ptr.add_argument("--trace-id", help="all spans of one trace")
    ptr.set_defaults(fn=_cmd_traces)

    pdb = sub.add_parser("db", help="database-level operations")
    db_sub = pdb.add_subparsers(dest="db_cmd", required=True)
    pdbl = db_sub.add_parser(
        "lock", help="hold the write lock while a command runs"
    )
    admin_args(pdbl)
    pdbl.add_argument("cmd", help="shell command to run under the lock")
    pdbl.add_argument(
        "--timeout", type=float, default=600.0,
        help="crash-safety auto-release deadline (seconds); must exceed "
             "the command's runtime or its tail runs unprotected",
    )
    pdbl.set_defaults(fn=_cmd_db_lock)

    ptls = sub.add_parser(
        "tls", help="certificate authority / server / client cert tooling"
    )
    tls_sub = ptls.add_subparsers(dest="tls_cmd", required=True)
    tca = tls_sub.add_parser("ca", help="certificate authority commands")
    tca_sub = tca.add_subparsers(dest="tls_sub_cmd", required=True)
    tcag = tca_sub.add_parser("generate", help="generate a root CA")
    tcag.add_argument("--output-dir", default=".")
    tcag.set_defaults(fn=_cmd_tls_ca_generate)
    tsv = tls_sub.add_parser("server", help="server certificate commands")
    tsv_sub = tsv.add_subparsers(dest="tls_sub_cmd", required=True)
    tsvg = tsv_sub.add_parser(
        "generate", help="generate a server cert from a CA"
    )
    tsvg.add_argument("ip", help="IP address for the subject alt name")
    tsvg.add_argument("--ca-key", required=True)
    tsvg.add_argument("--ca-cert", required=True)
    tsvg.add_argument("--output-dir", default=".")
    tsvg.set_defaults(fn=_cmd_tls_server_generate)
    tcl = tls_sub.add_parser(
        "client", help="client certificate commands (mutual TLS)"
    )
    tcl_sub = tcl.add_subparsers(dest="tls_sub_cmd", required=True)
    tclg = tcl_sub.add_parser(
        "generate", help="generate a client cert from a CA"
    )
    tclg.add_argument("--ca-key", required=True)
    tclg.add_argument("--ca-cert", required=True)
    tclg.add_argument("--output-dir", default=".")
    tclg.set_defaults(fn=_cmd_tls_client_generate)
    return p


def _cmd_devcluster(args) -> int:
    """`corro-devcluster simple <topology>` analog: run the topology file
    as one simulated cluster behind the HTTP API + admin socket
    (`corro-devcluster/src/main.rs:104-216`)."""
    from corro_sim_torch.admin import AdminServer
    from corro_sim_torch.api.http import ApiServer
    from corro_sim_torch.harness.devcluster import TopologyError, build_cluster
    from corro_sim_torch.utils.runtime import Tripwire, wait_for_all_pending_handles

    device = _device(args)
    tripwire = Tripwire.new_signals()
    with open(args.topology) as f:
        topo_text = f.read()
    with open(args.schema) as f:
        schema_sql = f.read()
    try:
        cluster, ordinals = build_cluster(
            topo_text,
            schema_sql,
            state_dir=args.statedir,
            seed=args.seed,
            default_capacity=args.capacity,
            tripwire=tripwire,
            device=device,
        )
    except TopologyError as e:
        print(str(e), file=sys.stderr)
        return 2
    host, _, port = args.api_addr.partition(":")
    api = ApiServer(
        cluster,
        host=host or "127.0.0.1",
        port=int(port or 0),
        tick_interval=args.tick_interval or None,
    ).start()
    admin = AdminServer(cluster, args.admin_path).start()
    print(
        json.dumps(
            {
                "api": api.url,
                "admin": args.admin_path,
                "nodes": ordinals,
            }
        ),
        flush=True,
    )
    try:
        tripwire.wait()
    finally:
        api.close()
        admin.close()
        wait_for_all_pending_handles(timeout=10)
    return 0


def _cmd_reload(args) -> int:
    """`corrosion reload` analog: re-apply schema files through the
    migrations endpoint (`corrosion/src/command/reload.rs`)."""
    client = _client(args)
    plan = client.schema_from_paths(args.schema_files)
    print(json.dumps(plan))
    return 0


def _cmd_flight(args) -> int:
    """Dump the agent's flight-recorder timeline (or just diagnostics).

    With a positional PATH, the timeline is read from an ND-JSON
    export on disk instead — the fleet-observatory workflow: every
    per-lane file a `sweep --flight-dir` demuxed loads here with the
    full diagnostics/timeline surface, no agent required."""
    if args.path:
        from corro_sim_torch.obs.flight import FlightRecorder

        try:
            fl = FlightRecorder.load(args.path)
        except OSError as e:
            print(f"error: cannot read flight export "
                  f"{args.path!r}: {e}", file=sys.stderr)
            return 2
        tl = fl.timeline()
        if not (tl["meta"] or tl["rounds"] or tl["events"]):
            # load() tolerates unparseable lines (the torn-tail case),
            # so a non-NDJSON file decodes to nothing — say so instead
            # of printing an empty timeline with rc 0
            print(f"error: no flight records in {args.path!r} "
                  "(not a flight ND-JSON export?)", file=sys.stderr)
            return 2
        if args.export:
            fl.dump(args.export)
        if args.diag:
            out = {"diagnostics": fl.diagnostics()}
        else:
            out = fl.timeline(last_rounds=args.n)
        if args.export:
            out["exported"] = args.export
        return _print_json(out)
    return _print_json(
        _admin(args).call(
            "flight", n=args.n, diag_only=args.diag, export=args.export
        )
    )


def _cmd_probes(args) -> int:
    """Dump the agent's probe provenance / lag observatory."""
    return _print_json(
        _admin(args).call(
            "probes", lag_only=args.lag, top=args.top, export=args.export
        )
    )


def _cmd_traces(args) -> int:
    """Dump recent spans from the agent's tracer."""
    return _print_json(
        _admin(args).call(
            "traces", n=args.n, name=args.name, trace_id=args.trace_id
        )
    )


def _cmd_db_lock(args) -> int:
    """`corrosion db lock "cmd"` analog (``main.rs:492-530``): hold the
    cluster write lock while a shell command runs."""
    import shlex
    import subprocess
    import time as _time

    admin = _admin(args)
    t0 = _time.perf_counter()
    resp = admin.call("db_lock_acquire", timeout=args.timeout)
    token = resp["token"]
    print(f"lock acquired after {_time.perf_counter() - t0:.3f}s "
          f"(token {token})", file=sys.stderr)
    try:
        argv = shlex.split(args.cmd)
        exit_code = subprocess.run(argv).returncode
    finally:
        from corro_sim_torch.admin import AdminError

        try:
            rel = admin.call("db_lock_release", token=token)
        except AdminError as e:
            if "unknown db lock token" not in str(e):
                raise  # a real admin failure, not an expired hold
            # the holder pruned the token itself: the hold expired
            rel = {"expired": True}
    if rel.get("expired"):
        print(
            "WARNING: the lock auto-released (timeout "
            f"{args.timeout}s) BEFORE the command finished — its tail ran "
            "unprotected; re-run with a larger --timeout",
            file=sys.stderr,
        )
        return exit_code or 1
    return exit_code


def _write_pem(path, content) -> None:
    import os

    with open(path, "w") as f:
        f.write(content)
    os.chmod(path, 0o600)
    print(f"wrote {path}")


def _cmd_tls_ca_generate(args) -> int:
    """`corrosion tls ca generate` (command/tls.rs:7-28): ca_cert.pem +
    ca_key.pem in the output dir."""
    import os

    from corro_sim_torch.tls import generate_ca

    cert, key = generate_ca()
    _write_pem(os.path.join(args.output_dir, "ca_cert.pem"), cert)
    _write_pem(os.path.join(args.output_dir, "ca_key.pem"), key)
    return 0


def _cmd_tls_server_generate(args) -> int:
    """`corrosion tls server generate <ip>` (command/tls.rs:30-62)."""
    import os

    from corro_sim_torch.tls import generate_server_cert

    with open(args.ca_cert) as f:
        ca_cert = f.read()
    with open(args.ca_key) as f:
        ca_key = f.read()
    cert, key = generate_server_cert(ca_cert, ca_key, args.ip)
    _write_pem(os.path.join(args.output_dir, "server_cert.pem"), cert)
    _write_pem(os.path.join(args.output_dir, "server_key.pem"), key)
    return 0


def _cmd_tls_client_generate(args) -> int:
    """`corrosion tls client generate` (command/tls.rs:64-96)."""
    import os

    from corro_sim_torch.tls import generate_client_cert

    with open(args.ca_cert) as f:
        ca_cert = f.read()
    with open(args.ca_key) as f:
        ca_key = f.read()
    cert, key = generate_client_cert(ca_cert, ca_key)
    _write_pem(os.path.join(args.output_dir, "client_cert.pem"), cert)
    _write_pem(os.path.join(args.output_dir, "client_key.pem"), key)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout piped into a pager/head that exited — standard CLI manners
        try:
            sys.stdout.close()
        except Exception:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
