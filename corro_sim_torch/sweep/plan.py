"""Sweep planning: the grid grammar and the union-config construction.

Port of ``corro_sim/sweep/plan.py``; the grammar, the lanes, the union
config and every message are the JAX package's.

A sweep is specified as a grid of axes (CLI ``corro-sim sweep``)::

    scenario=crash_amnesia,lossy  seed=0..31  knob.loss=0.05,0.2

- ``scenario`` — scenario specs (:mod:`corro_sim_torch.faults.scenarios`).
  Commas separate scenarios; a comma followed by a bare ``k=v`` piece
  continues the PREVIOUS spec's parameters, so
  ``crash_amnesia:nodes=3,at=6,lossy:p=0.1`` is two scenarios. ``;`` is
  always a hard separator when the heuristic is unwanted.
- ``seed`` — ``0..31`` inclusive ranges or comma lists.
- ``knob.<field>`` — per-lane overrides: link-fault thresholds
  (:data:`corro_sim_torch.sweep.knobs.SWEEP_KNOB_FIELDS`) or SimConfig
  scalars (:data:`corro_sim_torch.sweep.knobs.SIM_KNOB_FIELDS` —
  ``write_rate``, ``delete_rate``, ``zipf_alpha``, ``sync_interval``,
  ``swim_suspect_rounds``); multiple knob axes cross-product.
  Shape-affecting fields (``sync_peers``, ``sync_actor_topk``,
  ``swim_view_size``) are refused by name: they change program
  structure, so lanes differing in them cannot share one dispatch.

The cartesian product of the axes is the lane list; every lane's config
is the exact config a serial ``run_sim`` of that cell would use (its
*twin* — the bit-identity oracle and the worst-seed repro target).

Validation is ALL-AT-ONCE: every invalid grid entry — unparseable
scenario spec, unknown knob field, a fault window that never overlaps
the coupled workload's write range (``Scenario.check_workload``), a
schedule the plane encoding cannot carry, mixed blackhole topologies —
is collected and raised as ONE ValueError, so a bad cell at index 37
fails in milliseconds with the full list instead of dying mid-sweep.
"""

from __future__ import annotations

import dataclasses

from corro_sim_torch.config import (
    FaultConfig,
    NodeFaultConfig,
    SimConfig,
    SweepConfig,
    shift_node_faults,
)
from corro_sim_torch.faults.scenarios import make_scenario
from corro_sim_torch.sweep.knobs import (
    SIM_KNOB_FIELDS,
    SIM_KNOB_LEAF_FIELDS,
    SWEEP_KNOB_FIELDS,
    lane_knobs,
)

__all__ = ["SweepLane", "SweepPlan", "build_plan", "parse_grid"]


@dataclasses.dataclass
class SweepLane:
    """One (scenario × knobs × seed) grid cell — one vmapped lane."""

    index: int
    spec: str  # the scenario spec (canonical form)
    seed: int
    knob_overrides: dict  # the knob-axis FaultConfig overrides (may be {})
    scenario: object  # compiled Scenario
    cfg: SimConfig  # the serial twin's config (scenario + knobs applied)
    knobs: dict  # sweep_knobs leaf values (corro_sim_torch/sweep/knobs.py)
    workload: object | None  # compiled Workload, lane-seeded
    min_rounds: int
    schedule: object = None  # the lane's driver Schedule (attached at
    # plan time, the serial driver's workload write-round rule applied)
    workload_prebuilt: bool = False  # workload handed in as a built
    # object (e.g. a trace_workload replay window) rather than a spec —
    # make_workload cannot re-parse it, so repro_cmd omits --workload

    @property
    def cell(self) -> str:
        """The frontier cell key: scenario spec + knob suffix (seeds
        aggregate within a cell)."""
        if not self.knob_overrides:
            return self.spec
        kv = ",".join(
            f"{k}={v:g}" for k, v in sorted(self.knob_overrides.items())
        )
        return f"{self.spec}#{kv}"

    # base-config fields expressible as `corro-sim run` flags — the
    # repro command emits the ones differing from SimConfig defaults
    # so the serial twin runs the LANE's exact base shape
    _REPRO_FLAGS = (
        ("--nodes", "num_nodes"),
        ("--rows", "num_rows"),
        ("--cols", "num_cols"),
        ("--log-capacity", "log_capacity"),
        ("--write-rate", "write_rate"),
        ("--zipf", "zipf_alpha"),
        ("--swim", "swim_enabled"),
        ("--swim-view", "swim_view_size"),
        ("--sync-interval", "sync_interval"),
        ("--probes", "probes"),
    )

    def repro_cmd(self, base_cfg, rounds: int, write_rounds: int,
                  max_rounds: int, chunk: int,
                  fork_path: str | None = None) -> str:
        """The ONE serial command that reproduces this lane — what a
        failing frontier cell prints next to its worst seed. ``rounds``
        pins the lane's fault-timeline horizon (``--scenario-rounds``):
        wave-shaped generators truncate against it, so the horizon is
        part of the timeline's identity even though the canonical spec
        pins every resolved parameter.

        ``fork_path``: a what-if forecast lane reproduces as ``run
        --fork <token>`` — the base config, seed-independent state and
        fork-round frame all ride the token, so base-shape flags are
        omitted (``run --fork`` refuses them)."""
        defaults = SimConfig()
        cmd = f"corro-sim run --scenario '{self.spec}' --seed {self.seed}"
        if fork_path is not None:
            cmd += f" --fork {fork_path}"
        else:
            for flag, field in self._REPRO_FLAGS:
                v = getattr(base_cfg, field)
                if v == getattr(defaults, field):
                    continue
                if isinstance(v, bool):
                    if v:
                        cmd += f" {flag}"
                else:
                    cmd += f" {flag} {v:g}" if isinstance(v, float) \
                        else f" {flag} {v}"
        cmd += (
            f" --scenario-rounds {rounds} --write-rounds {write_rounds} "
            f"--max-rounds {max_rounds} --chunk {chunk} --scorecard"
        )
        for k, v in sorted(self.knob_overrides.items()):
            cmd += f" --knob {k}={v:g}"
        if self.workload is not None and not self.workload_prebuilt:
            cmd += f" --workload '{self.workload.spec}'"
        return cmd


@dataclasses.dataclass
class SweepPlan:
    """A validated sweep: the lanes and the ONE union config whose
    vmapped program races them all."""

    base_cfg: SimConfig
    union_cfg: SimConfig
    lanes: list
    rounds: int
    write_rounds: int
    workload_spec: str | None = None
    fork: object | None = None  # SimCheckpoint fork token — every lane
    # warm-starts from its state (corro_sim/engine/twin.py what-if
    # forecasts) instead of a fresh init_state
    fork_round: int = 0  # the twin's absolute state.round at the fork
    # (node-fault schedules are shifted into this frame; scorecards and
    # invariant checkers map them back via round_offset)

    @property
    def num_lanes(self) -> int:
        return len(self.lanes)

    @property
    def fork_path(self) -> str | None:
        return getattr(self.fork, "path", None)


# ------------------------------------------------------------- grid spec

# SimConfig fields a knob axis must refuse BY NAME: each one shapes an
# array extent or a traced loop count, so two values mean two programs.
_SHAPE_AFFECTING = frozenset((
    "sync_peers", "sync_actor_topk", "swim_view_size", "swim_interval",
    "num_nodes", "num_rows", "num_cols", "log_capacity",
))

# the SimConfig int fields a knob axis casts back from the float grid
_SIM_INT_FIELDS = frozenset(("sync_interval", "swim_suspect_rounds"))


def _split_scenarios(value: str) -> list[str]:
    """Scenario-axis splitting: ';' is a hard separator; ',' starts a
    new spec unless the piece is a bare ``k=v`` parameter continuation
    (no ':' before its first '=')."""
    out: list[str] = []
    for group in value.split(";"):
        for piece in group.split(","):
            piece = piece.strip()
            if not piece:
                continue
            eq = piece.find("=")
            colon = piece.find(":")
            continuation = eq >= 0 and not (0 <= colon < eq)
            if continuation and out:
                out[-1] += "," + piece
            else:
                out.append(piece)
    return out


def _split_ints(value: str) -> list[int]:
    out: list[int] = []
    for piece in value.split(","):
        piece = piece.strip()
        if ".." in piece:
            lo, hi = piece.split("..", 1)
            out.extend(range(int(lo), int(hi) + 1))
        elif piece:
            out.append(int(piece))
    return out


def parse_grid(tokens: list[str]) -> dict:
    """``KEY=VALUES`` grid tokens → ``{"scenario": [...], "seed": [...],
    "knobs": [{...}, ...]}`` (knob axes cross-producted). Errors
    collect into one ValueError (the up-front-validation posture)."""
    scenarios: list[str] = []
    seeds: list[int] = []
    knob_axes: dict[str, list[float]] = {}
    errors: list[str] = []
    for tok in tokens:
        key, _, value = tok.partition("=")
        key = key.strip()
        if not value:
            errors.append(f"grid token {tok!r} is not KEY=VALUES")
            continue
        if key == "scenario":
            scenarios.extend(_split_scenarios(value))
        elif key == "seed":
            try:
                seeds.extend(_split_ints(value))
            except ValueError:
                errors.append(f"seed axis {value!r} is not ints/ranges")
        elif key.startswith("knob."):
            field = key[len("knob."):]
            if field in _SHAPE_AFFECTING:
                errors.append(
                    f"knob field {field!r} is shape-affecting — it "
                    "changes program structure, so lanes differing in "
                    "it cannot share one dispatch; sweep it as "
                    "separate runs"
                )
                continue
            if field not in SWEEP_KNOB_FIELDS + SIM_KNOB_FIELDS:
                errors.append(
                    f"unknown knob field {field!r} (sweepable: "
                    f"{', '.join(SWEEP_KNOB_FIELDS + SIM_KNOB_FIELDS)})"
                )
                continue
            try:
                knob_axes[field] = [
                    float(v) for v in value.split(",") if v.strip()
                ]
            except ValueError:
                errors.append(f"knob axis {tok!r} is not floats")
        else:
            errors.append(
                f"unknown grid axis {key!r} (have: scenario, seed, "
                "knob.<field>)"
            )
    if errors:
        raise ValueError(
            "invalid sweep grid:\n  " + "\n  ".join(errors)
        )
    # cross-product the knob axes into override dicts
    knob_combos: list[dict] = [{}]
    for field, values in knob_axes.items():
        knob_combos = [
            {**combo, field: v} for combo in knob_combos for v in values
        ]
    return {
        "scenario": scenarios,
        "seed": seeds or [0],
        "knobs": knob_combos,
    }


# ------------------------------------------------------------ plan build

def build_plan(
    base_cfg: SimConfig,
    scenarios: list[str],
    seeds: list[int],
    knob_combos: list[dict] | None = None,
    rounds: int = 128,
    write_rounds: int = 16,
    workload_spec: str | None = None,
    fork=None,
    workload=None,
) -> SweepPlan:
    """Compile the grid into a validated :class:`SweepPlan`.

    Every error across the WHOLE grid lands in one ValueError — the
    satellite contract: a sweep must refuse up front, never die on lane
    37 mid-dispatch.

    ``fork``: a :class:`corro_sim_torch.io.checkpoint.SimCheckpoint` fork
    token (``save_fork_checkpoint``) — the what-if forecast grid: every
    lane warm-starts from the token's state, and each lane's node-fault
    schedule shifts into the fork's absolute round frame
    (:func:`corro_sim_torch.config.shift_node_faults`), so "wipe at relative
    round k" fires k rounds after the fork on a ``state.round`` that
    keeps counting from the twin's timeline.

    ``workload``: a PREBUILT
    :class:`~corro_sim_torch.workload.generators.Workload` shared by every
    lane — the coupled-load forecast path
    (:func:`corro_sim.workload.inject.trace_workload` replaying a live
    feed's trailing window into a fork). Unlike ``workload_spec`` it
    composes with ``fork``: the sweep engine plays workload rounds in
    the SWEEP-relative frame, i.e. immediately after the fork, which is
    exactly when the replayed traffic happened. Mutually exclusive with
    ``workload_spec`` (a spec is re-seeded per lane; a prebuilt object
    is one fixed tape)."""
    knob_combos = knob_combos or [{}]
    errors: list[str] = []
    fork_round = 0
    prebuilt = workload  # the loop below rebinds `workload` per lane
    if workload is not None and workload_spec is not None:
        raise ValueError(
            "build_plan takes workload_spec (per-lane seeded generator) "
            "or workload (one prebuilt tape), not both"
        )
    if fork is not None:
        if not fork.is_fork:
            raise ValueError(
                "build_plan(fork=...) needs a fork token "
                "(io/checkpoint.py save_fork_checkpoint), not a mid-run "
                "soak cursor"
            )
        if workload_spec is not None:
            raise ValueError(
                "a what-if forecast does not couple a workload — the "
                "forked state IS the load (run_sim resume does not "
                "compose with workload schedules)"
            )
        fork_round = fork.fork_round
    lanes: list[SweepLane] = []
    blackholes: set = set()
    index = 0
    for spec in scenarios:
        for knobs_over in knob_combos:
            for seed in seeds:
                cell = f"scenario={spec!r} seed={seed}" + (
                    f" knobs={knobs_over}" if knobs_over else ""
                )
                try:
                    sc = make_scenario(
                        spec, base_cfg.num_nodes, rounds=rounds,
                        write_rounds=write_rounds, seed=seed,
                    )
                except (ValueError, TypeError) as e:
                    errors.append(f"{cell}: {e}")
                    continue
                cfg = sc.apply(base_cfg)
                if fork_round and cfg.node_faults.enabled:
                    # the what-if frame shift: scenario-relative wipe
                    # rounds become absolute state rounds (fork + k)
                    cfg = dataclasses.replace(
                        cfg, node_faults=shift_node_faults(
                            cfg.node_faults, fork_round
                        )
                    ).validate()
                if knobs_over:
                    fault_over = {
                        k: v for k, v in knobs_over.items()
                        if k in SWEEP_KNOB_FIELDS
                    }
                    sim_over = {
                        k: (int(v) if k in _SIM_INT_FIELDS else float(v))
                        for k, v in knobs_over.items()
                        if k in SIM_KNOB_FIELDS
                    }
                    try:
                        if fault_over:
                            cfg = dataclasses.replace(
                                cfg, faults=dataclasses.replace(
                                    cfg.faults, **fault_over
                                )
                            )
                        if sim_over:
                            cfg = dataclasses.replace(cfg, **sim_over)
                        cfg = cfg.validate()
                    except AssertionError as e:
                        errors.append(f"{cell}: {e}")
                        continue
                workload = None
                if workload_spec is not None:
                    from corro_sim_torch.workload import make_workload

                    try:
                        workload = make_workload(
                            workload_spec, base_cfg.num_nodes,
                            rounds=write_rounds, seed=seed,
                        )
                        workload.validate(cfg)
                        sc.check_workload(workload)
                    except (ValueError, AssertionError) as e:
                        errors.append(f"{cell}: {e}")
                        continue
                elif prebuilt is not None:
                    try:
                        prebuilt.validate(cfg)
                        sc.check_workload(prebuilt)
                    except (ValueError, AssertionError) as e:
                        errors.append(f"{cell}: {e}")
                        continue
                    workload = prebuilt
                blackholes.add(tuple(cfg.faults.blackhole))
                sched = sc.schedule()
                if (
                    workload is not None
                    and sched.write_rounds < workload.rounds
                ):
                    # the serial driver's rule: the load phase counts as
                    # write rounds for convergence gating (run_sim)
                    sched = dataclasses.replace(
                        sched, write_rounds=workload.rounds
                    )
                lanes.append(SweepLane(
                    index=index, spec=sc.spec, seed=int(seed),
                    knob_overrides=dict(knobs_over), scenario=sc, cfg=cfg,
                    knobs={}, workload=workload,
                    workload_prebuilt=prebuilt is not None,
                    min_rounds=max(
                        sc.heal_round or 0, write_rounds,
                        workload.rounds if workload is not None else 0,
                    ),
                    schedule=sched,
                ))
                index += 1
    if len(blackholes) > 1:
        errors.append(
            "lanes disagree on blackhole topology — static (N, N) "
            "masks are baked per program, so one dispatch cannot mix "
            "them; sweep topology studies separately or run serially"
        )
    if not lanes and not errors:
        errors.append("the grid is empty (no scenario axis?)")
    if errors:
        raise ValueError(
            f"invalid sweep grid ({len(errors)} bad entries):\n  "
            + "\n  ".join(errors)
        )

    # ---- union gates: which machinery the ONE program must trace
    union_sweep = SweepConfig(
        lanes=len(lanes),
        link_faults=any(lane.cfg.faults.enabled for lane in lanes),
        burst=any(lane.cfg.faults.burst_enter > 0 for lane in lanes),
        wipes=any(lane.cfg.node_faults.crash for lane in lanes),
        stale=any(lane.cfg.node_faults.stale for lane in lanes),
        skew=any(lane.cfg.node_faults.skew for lane in lanes),
        straggle=any(lane.cfg.node_faults.straggle for lane in lanes),
        workload=workload_spec is not None or prebuilt is not None,
        # arm the sim-knob leaf iff some lane's SimConfig scalar differs
        # from the base program's baked value — zipf_alpha excluded (it
        # rides the row_cdf plane, not the leaf)
        sim_knobs=any(
            getattr(lane.cfg, f) != getattr(base_cfg, f)
            for lane in lanes for f in SIM_KNOB_LEAF_FIELDS
        ),
    )
    union_cfg = dataclasses.replace(
        base_cfg,
        faults=FaultConfig(blackhole=next(iter(blackholes), ())),
        node_faults=NodeFaultConfig(),
        sweep=union_sweep,
    ).validate()
    # per-lane knob values under the UNION key set (knobs.py raises on
    # schedules the plane form cannot carry — collected like the rest)
    for lane in lanes:
        try:
            lane.knobs = lane_knobs(
                union_cfg, lane.cfg,
                use_workload=lane.workload is not None,
            )
        except ValueError as e:
            errors.append(f"scenario={lane.spec!r} seed={lane.seed}: {e}")
    if errors:
        raise ValueError(
            f"invalid sweep grid ({len(errors)} bad entries):\n  "
            + "\n  ".join(errors)
        )
    return SweepPlan(
        base_cfg=base_cfg, union_cfg=union_cfg, lanes=lanes,
        rounds=rounds, write_rounds=write_rounds,
        workload_spec=workload_spec, fork=fork, fork_round=fork_round,
    )
