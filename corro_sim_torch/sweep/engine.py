"""The fleet sweep's dispatch loop: every lane of a plan, chunk by chunk.

Port of ``corro_sim/sweep/engine.py``. The JAX package stacks the lanes'
states on a leading axis and ``vmap``s the serial scan body; the port's
step is eager (it decides the sweep gate, wipes and snapshots on the
host, has branches of data-dependent size, merges in place and calls a
ctypes-loaded kernel), so here a dispatch is a host loop over the slots
and the lanes' states are a list. Each slot's lane runs one chunk of
rounds of :func:`~corro_sim_torch.engine.step.sim_step` under the plan's
**union** config with its own ``sweep_knobs`` leaf, exactly as the JAX
lane does:

- its keys are the serial driver's ``chunk_keys(PRNGKey(seed), ci)``,
  and its schedule and workload rows are sliced at its own base;
- a lane always runs the full step, never the repair step (the JAX
  lanes do the same; the repair step is bit-for-bit the full step where
  the serial twin takes it);
- a settled (converged or poisoned) lane is not stepped again: its state
  stays at its convergence chunk's boundary, where the JAX freeze select
  leaves it and where its serial twin stopped.

So every lane equals its serial ``run_sim`` twin bit for bit (the twin
runs the lane's own config, so this holds only if the value-neutral
knobs are neutral) and the JAX package's lane.

Convergence is the serial rule (:func:`~corro_sim_torch.engine.driver.
converged_at`) per lane, between chunks, on the host. ``compact=True``
runs the JAX package's fleet scheduler: each lane owns a ``(ci, base)``
cursor, a settled lane's slot refills from the pending queue, and once
the queue drains the survivors re-pack into the smallest power-of-2
width that holds them. ``pipeline=True`` queues chunk N+1 of every slot
(on copies of the committed states: a step consumes its input) before
chunk N's metrics are read, predicted on "no lane settles"; a mispredict
discards it, so committed chunks are the sequential ones.

The occupancy records keep the JAX package's definitions (a dispatch
executes its width × its rounds), so ``fleet_occupancy`` equals the JAX
package's for the same plan, though the port skips a frozen slot's
rounds instead of selecting them away.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from corro_sim_torch import prng
from corro_sim_torch.core.merge_kernel import build_kernel, kernel_supported
from corro_sim_torch.utils.compile_cache import CompileCacheProbe
from corro_sim_torch.device import resolve_device
from corro_sim_torch.engine import step as step_mod
from corro_sim_torch.engine.driver import (
    _boundary_fetch,
    _boundary_view,
    chunk_keys,
    converged_at,
    pack_metrics,
    unpack_metrics,
)
from corro_sim_torch.engine.state import _row_cdf, clone_state, init_state
from corro_sim_torch.engine.step import sim_step
from corro_sim_torch.obs.lanes import (
    publish_sweep_progress,
    publish_sweep_result,
)
from corro_sim_torch.sweep.knobs import knob_tensors
from corro_sim_torch.utils.metrics import (
    PIPELINE_SPECULATIVE_TOTAL,
    PIPELINE_SPECULATIVE_WASTED,
    ROUNDS_BUCKETS,
    SWEEP_LANES_ACTIVE,
    SWEEP_LANES_ACTIVE_HELP,
    SWEEP_LANES_CONVERGED,
    SWEEP_LANES_CONVERGED_HELP,
    SWEEP_LANES_POISONED,
    SWEEP_LANES_POISONED_HELP,
    SWEEP_RECOVERY_ROUNDS,
    SWEEP_RECOVERY_ROUNDS_HELP,
    SWEEP_WASTED_LANE_ROUNDS_HELP,
    SWEEP_WASTED_LANE_ROUNDS_TOTAL,
    counters,
    gauges,
    histograms,
)
from corro_sim_torch.utils.runtime import start_async_fetch, upload
from corro_sim_torch.utils.tracing import tracer

__all__ = ["LaneResult", "SweepResult", "build_lane_states", "run_sweep"]


@dataclasses.dataclass
class LaneResult:
    """One lane's serial-equivalent outcome."""

    index: int
    spec: str
    seed: int
    cell: str  # frontier cell key (spec + knob suffix)
    converged_round: int | None
    rounds: int  # rounds this lane executed before freezing
    poisoned: bool
    heal_round: int | None
    recovery_rounds: int | None
    metrics: dict  # name -> (rounds,) np arrays, the twin's series
    resilience: dict | None
    invariants: dict | None
    repro_cmd: str
    state: object = None  # the lane's final SimState (on its device)


@dataclasses.dataclass
class SweepResult:
    lanes: list
    rounds: int  # rounds the longest-running lane executed
    dispatches: int
    wall_seconds: float
    compile_seconds: float  # here the kernel build before the first chunk
    devices: int
    compile_cache: dict | None = None  # the kernel-library lookup of
    # the setup, hit or miss (utils/compile_cache.py); nothing on the CPU
    chunk: int = 16  # the dispatch chunk (the lane flights' chunking)
    occupancy: list | None = None  # per-dispatch lane-state history:
    # {chunk, base, rounds, lanes_active, lanes_frozen, lanes_poisoned,
    # wasted_lane_rounds}, plus {width, pending, refills} when compacted
    compaction: dict | None = None  # {widths, refills, shrinks,
    # max_pending, slot_reuse: [{dispatch, slot, admitted, prev}]}
    pipeline: dict | None = None  # {enabled, speculative_dispatched,
    # speculative_wasted} when pipelined
    sweeps: dict | None = None  # how the queued rounds' sync sweeps were
    # decided (speculative chunks included): host_decided, host_reads,
    # sweeps_run — each sweep run launches the merge kernel once where
    # the kernel takes the sweep

    @property
    def clusters_per_second_per_device(self) -> float | None:
        if self.wall_seconds <= 0:
            return None
        return len(self.lanes) / self.wall_seconds / max(self.devices, 1)

    @property
    def ok(self) -> bool:
        return all(
            lane.converged_round is not None and not lane.poisoned
            and (lane.invariants or {}).get("ok", True)
            for lane in self.lanes
        )


def _lane_state(plan, lane, device):
    """One lane's fresh state under the union config: its own seed, its
    own knob values in the sweep leaf and, where it sweeps
    ``zipf_alpha``, its own ``row_cdf`` plane; a fork plan installs the
    token's state first, as the lane's serial twin
    (``run_sim(resume=token.refit(...))``) does."""
    st = init_state(plan.union_cfg, seed=lane.seed, device=device)
    if plan.fork is not None:
        st = plan.fork.install_state(st)
    feats = dict(st.features)
    feats["sweep_knobs"] = knob_tensors(lane.knobs, device)
    st = dataclasses.replace(st, features=feats)
    if lane.cfg.zipf_alpha != plan.union_cfg.zipf_alpha:
        st = dataclasses.replace(st, row_cdf=torch.as_tensor(
            _row_cdf(lane.cfg), device=device))
    return st


def build_lane_states(plan, device=None) -> list:
    """Every lane's fresh state (:func:`_lane_state`), in plan order."""
    dev = resolve_device(device)
    return [_lane_state(plan, lane, dev) for lane in plan.lanes]


@dataclasses.dataclass
class _LaneChunk:
    """One lane's queued chunk."""

    state_out: object
    fetch: object  # the packed metric stacks on their way to the host
    ikeys: list
    boundary: object  # the checkers' leaves of state_out, or None
    alive: np.ndarray
    part: np.ndarray


def _bucket(n: int) -> int:
    """Smallest power of two >= n (the compacted widths)."""
    return 1 << max(n - 1, 0).bit_length()


class _Fleet:
    """What both loops share: the plan, the lanes' roots and first
    rounds, the checkers, and the one-lane chunk dispatch."""

    def __init__(self, plan, chunk, scorecards, invariants, device,
                 mesh=None):
        from corro_sim_torch.faults import (
            InvariantChecker,
            ResilienceScorecard,
        )

        self.plan = plan
        # a lane group of several ranks: each lane's nodes over them
        self.mesh = mesh if mesh is not None and mesh.nodes > 1 else None
        self.cfg = plan.union_cfg
        self.chunk = chunk
        self.dev = resolve_device(device)
        lanes = plan.lanes
        self.roots = [prng.PRNGKey(lane.seed) for lane in lanes]
        self.round0 = [0] * len(lanes)
        self.cards = [
            ResilienceScorecard(
                lane.cfg, scenario=lane.scenario, workload=lane.workload,
                round_offset=plan.fork_round,
            ) if scorecards else None
            for lane in lanes
        ]
        self.checks = [
            InvariantChecker(lane.cfg, round_offset=plan.fork_round)
            if invariants else None
            for lane in lanes
        ]
        self.armed = scorecards or invariants
        t0 = time.perf_counter()
        self.cache_probe = CompileCacheProbe()
        if self.dev.type == "cuda" and (
            kernel_supported(self.cfg, "sync", self.dev)
            or kernel_supported(self.cfg, "delivery", self.dev)
        ):
            build_kernel(probe=self.cache_probe)
        self.setup_seconds = time.perf_counter() - t0
        self.gates0 = dict(step_mod.SWEEP_GATES)

    def fresh(self, li: int):
        """Lane ``li``'s fresh state; notes its first round on the host
        (a fork token's state starts at the fork's round)."""
        st = _lane_state(self.plan, self.plan.lanes[li], self.dev)
        self.round0[li] = int(st.round)
        if self.mesh is not None:
            from corro_sim_torch.engine.sharding import shard_state

            st = shard_state(st, self.mesh, self.cfg.num_nodes,
                             shard_log=self.cfg.shard_log)
        return st

    def whole(self, state):
        """A lane's state whole on the host of its lane group's first
        rank, gathered from the group's ranks; None on the others."""
        if self.mesh is None or state is None:
            return state
        from corro_sim_torch.engine.sharding import (
            gather_state,
            mesh_shardings,
        )

        return gather_state(state, self.mesh,
                            mesh_shardings(self.cfg, self.mesh))

    def dispatch(self, li: int, ci: int, base: int, state) -> _LaneChunk:
        """Queue chunk ``ci`` (rounds from ``base``) of lane ``li`` on
        ``state``, which the chunk consumes, and start the copies of its
        metrics and of the checkers' leaves."""
        lane = self.plan.lanes[li]
        cfg, chunk, dev = self.cfg, self.chunk, self.dev
        alive, part, we = lane.schedule.slice(base, chunk, cfg.num_nodes)
        keys = chunk_keys(self.roots[li], ci, chunk)
        alive_t = upload(alive, dev)
        part_t = upload(part, dev)
        staged, quiesced = None, [None] * chunk
        if cfg.sweep.workload and lane.workload is not None:
            rows = lane.workload.slice(base, chunk, cfg.seqs_per_version)
            staged = tuple(upload(x, dev) for x in rows)
            quiesced = [not (rows[0][r] & alive[r]).any()
                        for r in range(chunk)]
        st = state
        per_round = []
        for r in range(chunk):
            st, m = sim_step(
                cfg, st, keys[r], alive_t[r], part_t[r], bool(we[r]),
                self.round0[li] + base + r,
                writes=None if staged is None else tuple(
                    x[r] for x in staged),
                quiesced=quiesced[r], knobs=lane.knobs, mesh=self.mesh,
            )
            per_round.append(m)
        i_s, f_s, ikeys = pack_metrics(per_round)
        # the checkers read on the lane group's first rank
        full = self.whole(st) if self.armed else None
        return _LaneChunk(
            state_out=st, fetch=start_async_fetch(i_s, f_s), ikeys=ikeys,
            boundary=(_boundary_fetch(cfg, full) if full is not None
                      else None),
            alive=alive, part=part,
        )

    def commit(self, li: int, lc: _LaneChunk, m: dict, base: int):
        """Feed lane ``li``'s checkers one committed chunk; returns
        ``"poisoned"``, ``("converged", round)`` or None."""
        lane = self.plan.lanes[li]
        card, check = self.cards[li], self.checks[li]
        if lc.boundary is not None:
            view = _boundary_view(lc.boundary)
            if card is not None:
                card.on_chunk(view, m, lc.alive, lc.part, base)
            if check is not None:
                check.on_chunk(view, m, lc.alive, lc.part, base)
        if m["log_wrapped"].any():
            return "poisoned"
        conv = converged_at(m["gap"], base, self.chunk, lane.min_rounds)
        if conv is None:
            return None
        a, p = lc.alive[-1], lc.part[-1]
        final = None
        if card is not None or check is not None:
            final = self.whole(lc.state_out)
        if card is not None and final is not None:
            card.on_converged(final, a, p)
        if check is not None and final is not None:
            check.on_converged(final, a, p)
        return ("converged", conv)

    def sweeps(self) -> dict:
        g = {k: step_mod.SWEEP_GATES[k] - self.gates0[k]
             for k in self.gates0}
        return {"host_decided": g["host_on"] + g["host_off"],
                "host_reads": g["read_on"] + g["read_off"],
                "sweeps_run": g["host_on"] + g["read_on"]}

    def results(self, lane_metrics, converged, poisoned, lane_rounds,
                final_states, max_rounds, owned=None) -> list:
        plan = self.plan
        out = []
        for li, lane in enumerate(plan.lanes):
            if owned is not None and not owned[li]:
                continue
            metrics = (
                {k: np.concatenate([c[k] for c in lane_metrics[li]])
                 for k in lane_metrics[li][0]}
                if lane_metrics[li] else {}
            )
            lane_state = final_states[li]
            resilience = None
            if self.cards[li] is not None and lane_state is not None:
                resilience = self.cards[li].finalize(
                    converged_round=None if poisoned[li] else converged[li],
                    rounds=lane_rounds[li], final_state=lane_state,
                )
            heal = lane.scenario.heal_round
            conv = None if poisoned[li] else converged[li]
            out.append(LaneResult(
                index=lane.index, spec=lane.spec, seed=lane.seed,
                cell=lane.cell, converged_round=conv,
                rounds=lane_rounds[li], poisoned=poisoned[li],
                heal_round=heal,
                recovery_rounds=(conv - heal if conv is not None
                                 and heal is not None else None),
                metrics=metrics, resilience=resilience,
                invariants=(self.checks[li].report()
                            if self.checks[li] is not None else None),
                repro_cmd=lane.repro_cmd(
                    plan.base_cfg, plan.rounds, plan.write_rounds,
                    max_rounds, self.chunk, fork_path=plan.fork_path,
                ),
                state=lane_state,
            ))
        for lr in out:
            if lr.recovery_rounds is not None:
                histograms.observe(
                    SWEEP_RECOVERY_ROUNDS, float(lr.recovery_rounds),
                    labels=f'{{cell="{lr.cell}"}}',
                    help_=SWEEP_RECOVERY_ROUNDS_HELP,
                    buckets=ROUNDS_BUCKETS,
                )
        return out


def _publish_gauges(active: int, converged: int, poisoned: int) -> None:
    gauges.set(SWEEP_LANES_ACTIVE, active, help_=SWEEP_LANES_ACTIVE_HELP)
    gauges.set(SWEEP_LANES_CONVERGED, converged,
               help_=SWEEP_LANES_CONVERGED_HELP)
    gauges.set(SWEEP_LANES_POISONED, poisoned,
               help_=SWEEP_LANES_POISONED_HELP)


def _count_waste(wasted: int) -> None:
    if wasted:
        counters.inc(SWEEP_WASTED_LANE_ROUNDS_TOTAL, n=wasted,
                     help_=SWEEP_WASTED_LANE_ROUNDS_HELP)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lane_block(num_lanes: int, mesh):
    """``(owned, total)``: which lanes this rank races (a contiguous
    block over the ``"sweep"`` axis, shared by its lane group's ranks;
    all of them off a mesh), and a function that sums host ints over the
    lane groups (a tuple, one sum per argument; each group counts
    once)."""
    owned = np.ones(num_lanes, bool)
    if mesh is None:
        return owned, lambda *xs: xs
    s = mesh.shape["sweep"]
    if num_lanes % s:
        raise ValueError(f"{num_lanes} lanes do not split over {s} ranks")
    per = num_lanes // s
    me = mesh.coords["sweep"]
    owned[:] = False
    owned[me * per:(me + 1) * per] = True
    group = _sweep_group(mesh)
    first = mesh.coords["nodes"] == 0  # the lane group's voice

    def total(*xs):
        t = torch.tensor(xs if first else [0] * len(xs),
                         dtype=torch.int64, device=mesh.device)
        torch.distributed.all_reduce(t, group=group)
        return tuple(int(v) for v in t.tolist())

    return owned, total


def _sweep_group(mesh):
    """The process group of every rank of the mesh."""
    if len(mesh.ranks) == torch.distributed.get_world_size():
        return torch.distributed.group.WORLD
    return mesh.sweep_group


def _gather_lanes(results: list, mesh) -> list:
    """Every rank's lane results, in plan order, on every rank (states
    on the host)."""
    for r in results:
        if r.state is not None:
            r.state = _to_host(r.state)
    parts = [None] * len(mesh.ranks)
    torch.distributed.all_gather_object(
        parts, results if mesh.coords["nodes"] == 0 else [],
        group=_sweep_group(mesh))
    return sorted((r for part in parts for r in part),
                  key=lambda r: r.index)


def _to_host(state):
    from corro_sim_torch.engine.state import _map_tensors

    return _map_tensors(state, lambda t: t.detach().cpu())


def run_sweep(
    plan,
    max_rounds: int = 4096,
    chunk: int = 16,
    mesh=None,
    scorecards: bool = True,
    invariants: bool = True,
    on_chunk=None,
    compact: bool = False,
    width: int | None = None,
    pipeline: bool = False,
    device=None,
) -> SweepResult:
    """Race the whole plan, chunk by chunk, on ``device`` (default
    ``cuda``).

    ``scorecards``/``invariants``: arm a per-lane
    :class:`~corro_sim_torch.faults.ResilienceScorecard` /
    :class:`~corro_sim_torch.faults.InvariantChecker`, fed each lane's
    own metric rows and schedule slices on the serial cadence.

    ``compact``: the fleet scheduler (module docstring); ``width`` caps
    the slot table (rounded up to a power of 2), lanes beyond it queue.
    ``pipeline``: queue chunk N+1 before chunk N's metrics are read.
    Both keep every lane bit-identical to its serial twin.

    ``mesh``: a :func:`~corro_sim_torch.engine.sharding.make_sweep_mesh`
    mesh; call ``run_sweep`` on every rank. The lanes go in contiguous
    blocks over the ``"sweep"`` axis and each lane group races its
    block, its lanes' nodes sharded over the group's ``"nodes"`` ranks
    (``sim_step(mesh=)``) when ``node_shards`` > 1, in lockstep with the
    others: every chunk's lane counts are summed over the groups, so the
    dispatch count and the occupancy books are the unsharded sweep's.
    Every rank returns the whole result, its lanes in plan order,
    ``devices`` the mesh size; a rank outside the mesh returns None.
    Compaction and the pipeline refuse a mesh (``check_compact_mesh``)."""
    if mesh is not None:
        from corro_sim_torch.engine.sharding import check_compact_mesh

        if compact or pipeline:
            check_compact_mesh(mesh)
        if mesh.coords is None:
            return None
        device = mesh.device
    if compact or pipeline:
        return _run_compact(
            plan, max_rounds=max_rounds, chunk=chunk,
            scorecards=scorecards, invariants=invariants,
            on_chunk=on_chunk, compact=compact, width=width,
            pipeline=pipeline, device=device,
        )
    fleet = _Fleet(plan, chunk, scorecards, invariants, device, mesh=mesh)
    lanes = plan.lanes
    L = len(lanes)
    owned, total = _lane_block(L, mesh)
    states = [fleet.fresh(li) if owned[li] else None for li in range(L)]

    active = owned.copy()
    converged: list = [None] * L
    poisoned = [False] * L
    lane_rounds = [0] * L
    lane_metrics: list[list] = [[] for _ in range(L)]
    final_states: list = [None] * L
    wall = 0.0
    dispatches = 0
    rounds = 0
    ci = 0
    occupancy: list[dict] = []
    wasted_total = 0
    while rounds < max_rounds:
        pre_active, pre_poisoned = total(int(active.sum()), sum(poisoned))
        if not pre_active:
            break
        racing = [li for li in range(L) if active[li]]
        t0 = time.perf_counter()
        with tracer.span("sweep chunk", ci=ci, lanes=pre_active,
                         slow_warn=False):
            queued = {li: fleet.dispatch(li, ci, rounds, states[li])
                      for li in racing}
            got = {li: unpack_metrics(*queued[li].fetch.resolve(),
                                      queued[li].ikeys)
                   for li in racing}
        elapsed = time.perf_counter() - t0
        wall += elapsed
        dispatches += 1
        counters.inc("corro_sweep_dispatch_total",
                     help_="sweep chunk dispatches "
                           "(corro_sim_torch/sweep/engine.py)")
        base = rounds
        rounds += chunk
        for li in racing:
            lc, lm = queued[li], got[li]
            states[li] = lc.state_out
            lane_metrics[li].append(lm)
            lane_rounds[li] = rounds
            verdict = fleet.commit(li, lc, lm, base)
            if verdict is None:
                continue
            active[li] = False
            final_states[li] = lc.state_out
            if verdict == "poisoned":
                poisoned[li] = True
            else:
                converged[li] = verdict[1]
        # occupancy by the JAX package's books: a settled lane rides
        # every later dispatch there, so its rounds count as executed
        wasted = (L - pre_active) * chunk
        wasted_total += wasted
        _count_waste(wasted)
        occupancy.append({
            "chunk": ci,
            "base": base,
            "rounds": chunk,
            "lanes_active": pre_active,
            "lanes_frozen": L - pre_active - pre_poisoned,
            "lanes_poisoned": pre_poisoned,
            "wasted_lane_rounds": wasted,
        })
        n_active, n_poisoned = total(int(active.sum()), sum(poisoned))
        n_converged = L - n_active - n_poisoned
        _publish_gauges(n_active, n_converged, n_poisoned)
        codes = total(*(
            (1 if active[li] else (2 if poisoned[li] else 3))
            if owned[li] else 0 for li in range(L)))
        progress = {
            "chunk": ci,
            "rounds_done": rounds,
            "lanes_active": n_active,
            "lanes_settled": L - n_active,
            "lanes_converged": n_converged,
            "lanes_poisoned": n_poisoned,
            "wasted_lane_rounds_total": wasted_total,
            # one char per lane: A racing, C converged, P poisoned
            "lane_states": "".join(" APC"[c] for c in codes),
            "chunk_wall_s": round(elapsed, 3),
        }
        publish_sweep_progress({"lanes": L, "dispatches": ci + 1,
                                **progress})
        if on_chunk is not None:
            on_chunk(progress)
        ci += 1
    t0 = time.perf_counter()
    _sync(fleet.dev)
    wall += time.perf_counter() - t0
    histograms.observe("corro_sweep_wall_seconds", wall,
                       help_="whole-sweep execution wall (kernel build "
                             "separate)")
    for li in range(L):
        if final_states[li] is None:  # round budget spent unsettled
            final_states[li] = states[li]
        final_states[li] = fleet.whole(final_states[li])
    results = fleet.results(lane_metrics, converged, poisoned, lane_rounds,
                            final_states, max_rounds, owned=owned)
    gates = fleet.sweeps()
    if mesh is not None:
        results = _gather_lanes(results, mesh)
        converged = [r.converged_round for r in results]
        poisoned = [r.poisoned for r in results]
    n_poisoned = sum(poisoned)
    n_converged = sum(1 for li in range(L)
                      if converged[li] is not None and not poisoned[li])
    publish_sweep_result({
        "lanes": L,
        "rounds": rounds,
        "dispatches": dispatches,
        "wall_seconds": round(wall, 3),
        "compile_seconds": round(fleet.setup_seconds, 3),
        "lanes_converged": n_converged,
        "lanes_poisoned": n_poisoned,
        "lanes_unsettled": L - n_converged - n_poisoned,
        "wasted_lane_rounds_total": wasted_total,
        "lane_states": "".join(
            "P" if poisoned[li]
            else ("C" if converged[li] is not None else "A")
            for li in range(L)
        ),
        "projected": plan.fork is not None,
    })
    return SweepResult(
        lanes=results, rounds=rounds, dispatches=dispatches,
        wall_seconds=wall, compile_seconds=fleet.setup_seconds,
        devices=1 if mesh is None else mesh.size,
        compile_cache=fleet.cache_probe.summary(),
        chunk=chunk, occupancy=occupancy,
        sweeps=dict(zip(gates, total(*gates.values()))),
    )


@dataclasses.dataclass
class _SlotDispatch:
    """One queued, uncommitted dispatch: its slots' lane chunks and the
    slot table that staged it."""

    chunks: list  # per slot: a _LaneChunk, or None for an idle slot
    states_in: list  # per slot: the state the dispatch started from
    entries: list  # [(lane_index, lane_ci, lane_base)] per slot
    act: np.ndarray  # (W,) bool — slot activity at dispatch time
    width: int
    pending_depth: int  # refill-queue depth when dispatched
    speculative: bool

    def states_out(self) -> list:
        """The committed slot states: a racing slot's chunk output, an
        idle slot's untouched input."""
        return [lc.state_out if lc is not None else st
                for lc, st in zip(self.chunks, self.states_in)]


def _run_compact(plan, max_rounds: int, chunk: int, scorecards: bool,
                 invariants: bool, on_chunk, compact: bool,
                 width: int | None, pipeline: bool,
                 device=None) -> SweepResult:
    """The fleet scheduler: a slot table with per-lane cursors (module
    docstring), the JAX package's ``_run_compact`` move for move."""
    fleet = _Fleet(plan, chunk, scorecards, invariants, device)
    lanes = plan.lanes
    L = len(lanes)

    # per-lane scheduler state, indexed by plan lane, not slot
    lane_ci = [0] * L
    lane_base = [0] * L
    converged: list = [None] * L
    poisoned = [False] * L
    lane_rounds = [0] * L
    lane_metrics: list[list] = [[] for _ in range(L)]
    final_states: list = [None] * L

    # the slot table: initial admission and the pending queue
    if compact:
        W = _bucket(min(width, L)) if width else _bucket(L)
    else:
        W = L  # fixed full width: pipelined dispatch only
    slots = list(range(min(W, L)))
    slot_active = [True] * len(slots)
    pending: deque = deque(range(len(slots), L))
    states = [fleet.fresh(li) for li in slots]
    while len(slots) < W:  # pad the first bucket to its width
        slots.append(slots[0])
        slot_active.append(False)
        states.append(states[0])

    wall = 0.0
    dispatches = 0
    occupancy: list[dict] = []
    wasted_total = 0
    refills_total = 0
    shrinks = 0
    slot_reuse: list[dict] = []
    widths_used: list[int] = []
    max_pending = len(pending)
    spec_dispatched = 0
    spec_wasted = 0

    def dispatch(st_list, entries, act_list, speculative) -> _SlotDispatch:
        chunks = []
        with tracer.span("sweep chunk", width=len(entries),
                         lanes=int(np.asarray(act_list, bool).sum()),
                         slow_warn=False):
            for (li, ci_, base), st, a in zip(entries, st_list, act_list):
                chunks.append(fleet.dispatch(li, ci_, base, st) if a
                              else None)
        counters.inc("corro_sweep_dispatch_total",
                     help_="sweep chunk dispatches "
                           "(corro_sim_torch/sweep/engine.py)")
        return _SlotDispatch(
            chunks=chunks, states_in=list(st_list), entries=list(entries),
            act=np.asarray(act_list, bool), width=len(entries),
            pending_depth=len(pending), speculative=speculative,
        )

    def entries_now():
        return [(li, lane_ci[li], lane_base[li]) for li in slots]

    inflight = (dispatch(states, entries_now(), slot_active, False)
                if slots and max_rounds > 0 else None)
    last_commit = time.perf_counter()
    di = 0
    while inflight is not None:
        # speculate chunk N+1 while N's metrics are in flight, predicted
        # on "no lane settles", and only where every racing lane's next
        # base is inside the round budget
        spec = None
        if pipeline and any(inflight.act) and all(
            base + chunk < max_rounds
            for (_, _, base), a in zip(inflight.entries, inflight.act) if a
        ):
            spec_entries = [
                (li, ci_ + (1 if a else 0), base + (chunk if a else 0))
                for (li, ci_, base), a
                in zip(inflight.entries, inflight.act)
            ]
            # the speculative chunks run on copies: the committed states
            # stay the re-dispatch source
            spec_src = [clone_state(lc.state_out) if lc is not None else st
                        for lc, st in zip(inflight.chunks,
                                          inflight.states_in)]
            spec = dispatch(spec_src, spec_entries, list(inflight.act),
                            True)
            spec_dispatched += 1
            counters.inc(
                PIPELINE_SPECULATIVE_TOTAL,
                help_="chunks dispatched before the previous chunk's "
                      "metrics were read",
            )
        # resolve and commit strictly in order
        ms = [unpack_metrics(*lc.fetch.resolve(), lc.ikeys)
              if lc is not None else None for lc in inflight.chunks]
        now = time.perf_counter()
        elapsed = now - last_commit
        last_commit = now
        wall += elapsed
        dispatches += 1
        states = inflight.states_out()
        W_d = inflight.width
        if W_d not in widths_used:
            widths_used.append(W_d)
        pre_active = int(inflight.act.sum())
        pre_pois = sum(poisoned)
        pre_conv = sum(1 for li in range(L)
                       if converged[li] is not None and not poisoned[li])

        settled: list[int] = []  # slot indices that settled this chunk
        for si, ((li, ci_, base), a) in enumerate(
            zip(inflight.entries, inflight.act)
        ):
            if not a:
                continue
            lc, lm = inflight.chunks[si], ms[si]
            lane_metrics[li].append(lm)
            lane_ci[li] = ci_ + 1
            lane_base[li] = base + chunk
            lane_rounds[li] = base + chunk
            verdict = fleet.commit(li, lc, lm, base)
            if verdict == "poisoned":
                poisoned[li] = True
            elif verdict is not None:
                converged[li] = verdict[1]
            elif lane_base[li] < max_rounds:
                continue
            # settled, or the round budget spent unsettled (the serial
            # twin stops there too; the lane stays "A" fleet-wide)
            final_states[li] = lc.state_out
            settled.append(si)

        # occupancy, judged against the batch width
        wasted = (W_d - pre_active) * chunk
        wasted_total += wasted
        _count_waste(wasted)
        occupancy.append({
            "chunk": di,
            "base": min((base for (_, _, base), a
                         in zip(inflight.entries, inflight.act) if a),
                        default=0),
            "rounds": chunk,
            "lanes_active": pre_active,
            "lanes_frozen": pre_conv,
            "lanes_poisoned": pre_pois,
            "wasted_lane_rounds": wasted,
            "width": W_d,
            "pending": inflight.pending_depth,
            "refills": 0,
        })

        # the boundary: evict settled slots, refill, maybe shrink
        refill_count = 0
        if settled and not compact:
            # fixed width: settled lanes freeze in place
            for si in settled:
                slot_active[si] = False
        elif settled:
            old_slots = list(slots)
            new_slots = list(slots)
            new_active = list(slot_active)
            for si in settled:
                new_active[si] = False
            # refill evicted slots in place from the pending queue
            admits: dict[int, int] = {}
            for si in range(len(old_slots)):
                if new_active[si] or not pending:
                    continue
                admits[si] = pending.popleft()
            if admits:
                for si, li in admits.items():
                    states[si] = fleet.fresh(li)
                    new_slots[si] = li
                    new_active[si] = True
                    refill_count += 1
                    slot_reuse.append({
                        "dispatch": di, "slot": si, "admitted": li,
                        "prev": old_slots[si],
                    })
            elif not pending:
                # queue drained: shrink survivors into the smallest
                # bucket that holds them (the normal tail)
                live = [si for si in range(len(old_slots))
                        if new_active[si]]
                nb = _bucket(len(live)) if live else 0
                if nb and nb < len(old_slots):
                    shrinks += 1
                    states = [states[si] for si in live]
                    new_slots = [old_slots[si] for si in live]
                    new_active = [True] * len(live)
                    while len(states) < nb:
                        states.append(states[0])
                        new_slots.append(new_slots[0])
                        new_active.append(False)
                elif not live:
                    new_slots, new_active = [], []
            slots, slot_active = new_slots, new_active
            refills_total += refill_count
            occupancy[-1]["refills"] = refill_count
        max_pending = max(max_pending, len(pending))

        n_pois = sum(poisoned)
        n_conv = sum(1 for li in range(L)
                     if converged[li] is not None and not poisoned[li])
        n_slot_active = sum(slot_active)
        _publish_gauges(n_slot_active, n_conv, n_pois)
        pending_set = set(pending)
        progress = {
            "chunk": di,
            "rounds_done": max(lane_rounds, default=0),
            "lanes_active": n_slot_active,
            "lanes_queued": len(pending),
            "lanes_settled": n_conv + n_pois,
            "lanes_converged": n_conv,
            "lanes_poisoned": n_pois,
            "wasted_lane_rounds_total": wasted_total,
            # one char per plan lane: A racing (or unsettled at the
            # budget), Q queued, C converged, P poisoned
            "lane_states": "".join(
                "P" if poisoned[li]
                else "C" if converged[li] is not None
                else "Q" if li in pending_set
                else "A"
                for li in range(L)
            ),
            "chunk_wall_s": round(elapsed, 3),
            "width": W_d,
            "pending": len(pending),
            "refills": refill_count,
        }
        publish_sweep_progress({"lanes": L, "dispatches": di + 1,
                                **progress})
        if on_chunk is not None:
            on_chunk(progress)
        di += 1

        # promote the speculative dispatch, or discard it and dispatch
        # again from the committed states (mispredict)
        fleet_live = any(slot_active)
        if spec is not None and (settled or not fleet_live):
            spec_wasted += 1
            counters.inc(
                PIPELINE_SPECULATIVE_WASTED,
                labels='{reason="lane_settled"}',
                help_="speculative chunk results discarded, by reason",
            )
            spec = None
        if not fleet_live:
            inflight = None
        elif spec is not None:
            inflight = spec
        else:
            inflight = dispatch(states, entries_now(), slot_active, False)

    t0 = time.perf_counter()
    _sync(fleet.dev)
    wall += time.perf_counter() - t0
    histograms.observe("corro_sweep_wall_seconds", wall,
                       help_="whole-sweep execution wall (kernel build "
                             "separate)")
    rounds_total = max(lane_rounds, default=0)
    results = fleet.results(lane_metrics, converged, poisoned, lane_rounds,
                            final_states, max_rounds)
    n_poisoned = sum(poisoned)
    n_converged = sum(1 for li in range(L)
                      if converged[li] is not None and not poisoned[li])
    publish_sweep_result({
        "lanes": L,
        "rounds": rounds_total,
        "dispatches": dispatches,
        "wall_seconds": round(wall, 3),
        "compile_seconds": round(fleet.setup_seconds, 3),
        "lanes_converged": n_converged,
        "lanes_poisoned": n_poisoned,
        "lanes_unsettled": L - n_converged - n_poisoned,
        "wasted_lane_rounds_total": wasted_total,
        "lane_states": "".join(
            "P" if poisoned[li]
            else ("C" if converged[li] is not None else "A")
            for li in range(L)
        ),
        "projected": plan.fork is not None,
        "compact": compact,
        "pipelined": pipeline,
        "refills": refills_total,
    })
    return SweepResult(
        lanes=results, rounds=rounds_total, dispatches=dispatches,
        wall_seconds=wall, compile_seconds=fleet.setup_seconds, devices=1,
        compile_cache=fleet.cache_probe.summary(),
        chunk=chunk, occupancy=occupancy,
        compaction=({
            "widths": widths_used,
            "refills": refills_total,
            "shrinks": shrinks,
            "max_pending": max_pending,
            "slot_reuse": slot_reuse,
        } if compact else None),
        pipeline=({
            "enabled": True,
            "speculative_dispatched": spec_dispatched,
            "speculative_wasted": spec_wasted,
        } if pipeline else None),
        sweeps=fleet.sweeps(),
    )
