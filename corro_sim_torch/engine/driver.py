"""Run loop: chunks of rounds with a host-side convergence exit.

Port of the sequential loop of ``corro_sim/engine/driver.py::run_sim``.
The simulator's contract is rounds-to-convergence: drive rounds until
every live node has applied every written version (``gap == 0``) after
the write phase ends. Rounds run in chunks; after each chunk the host
reads the chunk's metrics (one transfer), applies the convergence rule
and decides whether the next chunk may run on the repair-specialized
step. Keys, schedule rows and chunk boundaries are the JAX package's, so
a seeded run walks the same trajectory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig, validate_torch_slice
from corro_sim_torch.core.merge_kernel import build_kernel, kernel_supported
from corro_sim_torch.device import resolve_device
from corro_sim_torch.engine.state import SimState
from corro_sim_torch.engine.step import sim_step


@dataclasses.dataclass
class Schedule:
    """Per-round ground truth: who is up, partition ids, write phase.

    Default: everybody up, one partition, writes for ``write_rounds``
    rounds, then quiesce. ``alive``/``part`` may be precomputed ``(R,
    n)`` arrays (rounds past the end hold the last row) or callables
    ``(round, n) -> (n,)``, each evaluated once per round."""

    write_rounds: int = 16
    alive_fn: Callable[[int, int], np.ndarray] | None = None
    part_fn: Callable[[int, int], np.ndarray] | None = None
    alive: np.ndarray | None = None  # (R, n) bool
    part: np.ndarray | None = None  # (R, n) int32
    _alive_rows: list = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )
    _part_rows: list = dataclasses.field(
        default_factory=list, repr=False, compare=False
    )

    def _materialize(self, upto: int, n: int) -> None:
        if self.alive_fn is not None:
            for r in range(len(self._alive_rows), upto):
                self._alive_rows.append(np.asarray(self.alive_fn(r, n), bool))
        if self.part_fn is not None:
            for r in range(len(self._part_rows), upto):
                self._part_rows.append(
                    np.asarray(self.part_fn(r, n), np.int32)
                )

    @staticmethod
    def _rows(src, idx: np.ndarray):
        if src is None or len(src) == 0:
            return None
        if isinstance(src, list):
            last = len(src) - 1
            return np.stack([src[min(int(i), last)] for i in idx])
        return src[np.minimum(idx, len(src) - 1)]

    def slice(self, start: int, length: int, n: int):
        """``(alive, part, write_enable)`` rows for rounds
        ``[start, start + length)``."""
        idx = np.arange(start, start + length)
        self._materialize(start + length, n)
        alive = self._rows(
            self.alive if self.alive is not None
            else (self._alive_rows if self.alive_fn is not None else None),
            idx,
        )
        if alive is None:
            alive = np.ones((length, n), bool)
        part = self._rows(
            self.part if self.part is not None
            else (self._part_rows if self.part_fn is not None else None),
            idx,
        )
        if part is None:
            part = np.zeros((length, n), np.int32)
        we = idx < self.write_rounds
        return (
            np.ascontiguousarray(alive, dtype=bool),
            np.ascontiguousarray(part, dtype=np.int32),
            np.ascontiguousarray(we, dtype=bool),
        )


def chunk_keys(root, ci: int, chunk: int) -> np.ndarray:
    """The ``chunk`` per-round keys of chunk ``ci``:
    ``split(fold_in(root, ci), chunk)``."""
    return prng.split(prng.fold_in(root, ci), chunk)


def round_key(root, r: int) -> np.ndarray:
    """The single-round key ``fold_in(root, r)`` of engines that step one
    absolute round at a time (not round ``r`` of :func:`chunk_keys`)."""
    return prng.fold_in(root, r)


def converged_at(gaps, base: int, chunk: int, min_rounds: int) -> int | None:
    """The convergence rule on one chunk's per-round ``gap`` series: the
    first round strictly past ``min_rounds`` with a zero gap, and only
    when the chunk ends converged."""
    rounds = base + chunk
    if not (rounds > min_rounds and gaps[-1] == 0.0):
        return None
    idx = np.arange(1, chunk + 1) + base
    eligible = (gaps == 0.0) & (idx > min_rounds)
    return int(idx[np.argmax(eligible)])


@dataclasses.dataclass
class RunResult:
    state: SimState
    metrics: dict  # name -> (rounds,) np.ndarray
    rounds: int
    converged_round: int | None
    repair_chunks: int  # chunks run on the repair-specialized step
    wall_seconds: float  # chunk execution wall, device-synchronized
    setup_seconds: float  # kernel build/load before the first chunk
    poisoned: bool = False  # change-log ring wrapped past a live laggard
    stage_seconds: float = 0.0  # of wall_seconds: workload schedule
    # uploads, host to device

    @property
    def wall_per_round_ms(self) -> float:
        return 1000.0 * self.wall_seconds / max(self.rounds, 1)


def metrics_to_numpy(per_round: list) -> dict:
    """Per-round metric dicts of device scalars → ``name -> (rounds,)``
    numpy series, in two transfers: the integer metrics as int32, ``gap``
    as float32."""
    ikeys = [k for k in sorted(per_round[0]) if k != "gap"]
    i_stack = torch.stack([
        torch.stack([m[k] for m in per_round]).to(torch.int32)
        for k in ikeys
    ]).cpu().numpy()
    gaps = torch.stack([m["gap"] for m in per_round]).cpu().numpy()
    out = {k: i_stack[j] for j, k in enumerate(ikeys)}
    out["gap"] = gaps.astype(np.float32)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sim(
    cfg: SimConfig,
    state: SimState,
    schedule: Schedule | None = None,
    max_rounds: int = 4096,
    chunk: int = 16,
    seed: int = 0,
    stop_on_convergence: bool = True,
    min_rounds: int | None = None,
    device=None,
    workload=None,
) -> RunResult:
    """Run ``state`` forward in chunks of ``chunk`` rounds until
    convergence (or ``max_rounds``) — the JAX package's sequential
    ``run_sim`` loop.

    Consumes ``state``, as :func:`~corro_sim_torch.engine.step.sim_step`
    does: its tensors may be updated in place; read the result's state.

    ``device``: where the run happens (default ``cuda``; the state must
    already live there). ``min_rounds``: do not test convergence before
    this round (default: the write phase length).

    ``workload``: a compiled
    :class:`~corro_sim_torch.workload.generators.Workload`. Its load
    phase is the write phase (``schedule.write_rounds`` extends to its
    rounds), and every full chunk feeds its rows through ``sim_step``'s
    ``writes`` port in place of the sampler; the rows are uploaded once
    per chunk, and past the schedule's end one all-idle chunk is
    uploaded once and reused."""
    validate_torch_slice(cfg)
    want = resolve_device(device)
    if state.hlc.device.type != want.type:
        raise ValueError(
            f"state lives on {state.hlc.device}, asked to run on {want}"
        )
    dev = state.hlc.device
    schedule = schedule or Schedule()
    if workload is not None:
        workload.validate(cfg)
        if schedule.write_rounds < workload.rounds:
            schedule = dataclasses.replace(
                schedule, write_rounds=workload.rounds
            )
    if min_rounds is None:
        min_rounds = schedule.write_rounds
    n = cfg.num_nodes

    t0 = time.perf_counter()
    if dev.type == "cuda" and (
        kernel_supported(cfg, "sync", dev)
        or kernel_supported(cfg, "delivery", dev)
    ):
        build_kernel()
    setup_seconds = time.perf_counter() - t0

    # the round counter on the host, for the SWIM cadence: one read here,
    # none per round
    round0 = int(state.round)
    root = prng.PRNGKey(seed)
    metrics_chunks: list = []
    converged_round = None
    poisoned = False
    rounds = 0
    wall = 0.0
    last_pend_live = None
    repair_chunks = 0
    stage_seconds = 0.0
    idle_writes = None

    def stage_writes(base: int) -> tuple:
        """The chunk's write-schedule rows on the device."""
        nonlocal idle_writes, stage_seconds
        if base >= workload.rounds and idle_writes is not None:
            return idle_writes
        t = time.perf_counter()
        staged = tuple(
            torch.as_tensor(x, device=dev)
            for x in workload.slice(base, chunk, cfg.seqs_per_version)
        )
        _sync(dev)
        stage_seconds += time.perf_counter() - t
        if base >= workload.rounds:
            idle_writes = staged
        return staged

    ci = 0
    while rounds < max_rounds:
        alive, part, we = schedule.slice(rounds, chunk, n)
        keys = chunk_keys(root, ci, chunk)
        # validate_torch_slice refuses in-flight slots and RTT rings, the
        # features that keep the JAX package's driver off the repair step
        use_repair = bool(last_pend_live == 0 and not we.any())
        _sync(dev)
        t_chunk = time.perf_counter()
        alive_t = torch.as_tensor(alive, device=dev)
        part_t = torch.as_tensor(part, device=dev)
        staged = (stage_writes(rounds)
                  if workload is not None and not use_repair else None)
        per_round = []
        for r in range(chunk):
            state, m = sim_step(
                cfg, state, keys[r], alive_t[r], part_t[r], bool(we[r]),
                round0 + rounds + r, repair=use_repair,
                writes=None if staged is None else tuple(
                    x[r] for x in staged),
            )
            per_round.append(m)
        m_np = metrics_to_numpy(per_round)
        _sync(dev)
        wall += time.perf_counter() - t_chunk
        if use_repair:
            repair_chunks += 1
        metrics_chunks.append(m_np)
        last_pend_live = int(m_np["pend_live"][-1])
        base = rounds
        rounds = base + chunk
        ci += 1
        if m_np["log_wrapped"].any():
            poisoned = True
            break
        if stop_on_convergence:
            conv = converged_at(m_np["gap"], base, chunk, min_rounds)
            if conv is not None:
                converged_round = conv
                break
    metrics = {
        k: np.concatenate([c[k] for c in metrics_chunks])
        for k in metrics_chunks[0]
    }
    return RunResult(
        state=state,
        metrics=metrics,
        rounds=rounds,
        converged_round=None if poisoned else converged_round,
        repair_chunks=repair_chunks,
        wall_seconds=wall,
        setup_seconds=setup_seconds,
        poisoned=poisoned,
        stage_seconds=stage_seconds,
    )
