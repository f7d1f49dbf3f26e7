"""Trace replay: drive the simulator with a recorded changeset history.

Port of ``corro_sim/engine/replay.py``. The reference replays
real-cluster state by re-inserting ``crsql_changes`` rows
(``doc/crdts.md:105-112``); the simulator's equivalent injects an
:class:`~corro_sim_torch.io.traces.EncodedTrace` round by round — round
``r`` commits version ``r+1`` of every actor locally (write path of
``make_broadcastable_changes``, ``api/public/mod.rs:36-101``) and
enqueues it for gossip; dissemination, delivery, merge and anti-entropy
then run the normal :func:`~corro_sim_torch.engine.step.sim_step` until
convergence. Injection is the shared
:func:`corro_sim_torch.workload.inject.inject_round`.

The step is the port's own ``sim_step`` on an everyone-up schedule with
writes disabled; the round number it reads (the emit window, the SWIM
cadence) is the loop's host counter, which starts, as the JAX package's
``state.round`` does, at ``init_state``'s round 0.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig, validate_torch_slice
from corro_sim_torch.core.merge_kernel import build_kernel, kernel_supported
from corro_sim_torch.device import resolve_device
from corro_sim_torch.engine.driver import metrics_to_numpy, round_key
from corro_sim_torch.engine.state import SimState, init_state
from corro_sim_torch.engine.step import sim_step
from corro_sim_torch.io.traces import EncodedTrace
from corro_sim_torch.workload.inject import (
    inject_round,
    pad_trace_cells,
    trace_round_args,
)

__all__ = [
    "ReplayResult",
    "inject_round",
    "make_injector",
    "make_shadow_step",
    "read_table",
    "replay",
]


def make_injector(cfg: SimConfig):
    """The between-rounds changeset injector ``(state, *round_args) ->
    state``."""
    return functools.partial(inject_round, cfg)


def make_shadow_step(cfg: SimConfig, device):
    """The everyone-up single-round step ``(state, key, round_idx) ->
    (state, metrics)`` a replay drives between injections (no fault
    schedule: the shadow mirrors the feed's reality)."""
    n = cfg.num_nodes
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    part = torch.zeros((n,), dtype=torch.int32, device=device)

    def step(state, key, round_idx: int):
        return sim_step(cfg, state, key, alive, part, False, round_idx)

    return step


@dataclasses.dataclass
class ReplayResult:
    state: SimState
    rounds: int
    converged_round: int | None
    metrics: dict
    wall_seconds: float
    poisoned: bool = False  # log ring wrapped (engine/step.py tripwire) —
    # convergence is never reported once this latches


def replay(
    trace: EncodedTrace,
    cfg: SimConfig | None = None,
    seed: int = 0,
    max_rounds: int = 4096,
    device=None,
) -> ReplayResult:
    """Inject the whole trace, then run gossip+sync rounds to convergence
    on ``device`` (default ``cuda``)."""
    cfg = validate_torch_slice(cfg or trace.suggest_config())
    dev = resolve_device(device)
    for have, cap, what in (
        (trace.num_actors, cfg.num_nodes, "actors > nodes"),
        (trace.seqs_per_version, cfg.seqs_per_version,
         "cells per changeset > cfg.seqs_per_version"),
        (trace.num_rows, cfg.num_rows, "row slots > cfg.num_rows"),
        (trace.num_cols, cfg.num_cols, "column planes > cfg.num_cols"),
    ):
        if have > cap:
            raise ValueError(f"trace has {have} {what}={cap}")
    # Pad cell planes up to the config's seq capacity (extra lanes are
    # dead: ncells masks them out everywhere).
    cells = pad_trace_cells(trace, cfg.seqs_per_version)
    state = init_state(cfg, seed=seed, device=dev)
    if dev.type == "cuda" and (
        kernel_supported(cfg, "sync", dev)
        or kernel_supported(cfg, "delivery", dev)
    ):
        build_kernel()
    inject = make_injector(cfg)
    step = make_shadow_step(cfg, dev)
    root = prng.PRNGKey(seed)
    t0 = time.perf_counter()
    metrics_rounds = []
    converged = None
    poisoned = False
    r = 0
    while r < max_rounds:
        if r < trace.rounds:
            state = inject(state, *trace_round_args(trace, cells, r, dev))
        state, m = step(state, round_key(root, r), r)
        r += 1
        m_np = {k: v[0] for k, v in metrics_to_numpy([m]).items()}
        metrics_rounds.append(m_np)
        if m_np["log_wrapped"] > 0:
            # ring-wrap tripwire (engine/step.py): state may be silently
            # wrong — stop; never report convergence
            poisoned = True
            break
        if r >= trace.rounds and m_np["gap"] == 0.0:
            converged = r
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    metrics = {
        k: np.stack([mr[k] for mr in metrics_rounds])
        for k in metrics_rounds[0]
    }
    return ReplayResult(
        state=state,
        rounds=r,
        converged_round=None if poisoned else converged,
        metrics=metrics,
        wall_seconds=wall,
        poisoned=poisoned,
    )


def read_table(state: SimState, trace: EncodedTrace, node: int) -> dict:
    """Decode one node's table back to Python values — the query surface a
    replay validation compares against the reference cluster's SQLite
    state.

    Returns {(table, pk_tuple): {cid: value}} for live rows (odd cl,
    causal-length liveness — ``doc/crdts.md:13``).
    """
    cl = state.table.cl[node].cpu().numpy()
    vr = state.table.vr[node].cpu().numpy()
    out = {}
    for ri, key in enumerate(trace.row_keys):
        if key is None or cl[ri] % 2 != 1:
            continue
        cells = {}
        for tbl, cid, ci in trace.col_keys:
            if tbl != key[0]:
                continue
            rank = vr[ri, ci]
            if rank != np.iinfo(np.int32).min and 0 <= rank < len(trace.values):
                cells[cid] = trace.values[rank]
        out[key] = cells
    return out
