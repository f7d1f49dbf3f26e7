"""The port's pipelined chunk loop against its sequential loop and the
JAX package's ``run_sim``, on the CPU.

Mirrors tests/test_pipeline.py (the fault scenario and the donation
cases aside: faults are not ported, and the port's step always consumes
its input). ``run_sim(pipeline=True)`` queues chunk N+1 before chunk N's
metrics are read, on a copy of chunk N's state, and checks the
speculative program choice against the sequential repair-switch rule,
running the chunk again on a mispredict. Every case requires the
pipelined port, the sequential port and the JAX package's run to agree
in every state leaf, every metric of every round, ``rounds``,
``converged_round``, ``repair_chunks`` and ``poisoned`` (tolerance:
exact).
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

from corro_sim.config import SimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.utils.metrics import (
    PIPELINE_FETCH_WAIT,
    PIPELINE_SPECULATIVE_TOTAL,
    PIPELINE_SPECULATIVE_WASTED,
    counters,
    histograms,
)
from corro_sim_torch.utils.tracing import tracer

CFG = SimConfig(
    num_nodes=16, num_rows=16, num_cols=2, log_capacity=64,
    write_rate=0.5, swim_enabled=False, sync_interval=4,
)

# the repair-switch boundary case: SWIM every 2 rounds, a partition,
# adaptive sync; convergence is not tested before round 48
SWITCH_CFG = SimConfig(
    num_nodes=24, num_rows=16, num_cols=2, log_capacity=128,
    write_rate=0.5, swim_enabled=True, swim_interval=2,
    swim_suspect_rounds=3, sync_interval=4, sync_adaptive=True,
    sync_actor_topk=8, sync_cap_per_actor=2,
)


def _switch_part(r, n):
    p = np.zeros(n, np.int32)
    if 4 <= r < 10:
        p[n // 2:] = 1
    return p


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _assert_same(got, want_state: dict, want):
    have = state_to_numpy(got.state)
    assert set(have) == set(want_state)
    for k in want_state:
        np.testing.assert_array_equal(have[k], want_state[k], err_msg=k)
    assert set(got.metrics) == set(want.metrics)
    for k in want.metrics:
        np.testing.assert_array_equal(got.metrics[k],
                                      np.asarray(want.metrics[k]), err_msg=k)
    assert got.rounds == want.rounds
    assert got.converged_round == want.converged_round
    assert got.repair_chunks == want.repair_chunks
    assert got.poisoned == want.poisoned


def _triple(cfg, schedule_fn, **kw):
    """The JAX package's run and the port's pipelined and sequential
    runs of the same config, schedule and arguments."""
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=kw.get("seed", 0)),
                      schedule_fn(RefSchedule), **kw)
    pcfg = sim_config_from_dict(dataclasses.asdict(cfg))
    runs = {
        pipeline: run_sim(pcfg, init_state(pcfg, seed=kw.get("seed", 0),
                                           device="cpu"),
                          schedule_fn(Schedule), device="cpu",
                          pipeline=pipeline, **kw)
        for pipeline in (True, False)
    }
    return ref, runs[True], runs[False]


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_equivalence_across_chunk_sizes(chunk):
    ref, rp, rs = _triple(CFG, lambda S: S(write_rounds=4), max_rounds=64,
                          chunk=chunk, seed=0)
    want = _leaves(ref.state)
    _assert_same(rp, want, ref)
    _assert_same(rs, want, ref)
    assert rp.converged_round is not None
    assert rp.pipeline["enabled"] and not rs.pipeline["enabled"]
    assert rp.pipeline["fetch_wait_s"] >= 0 and rs.pipeline["fetch_wait_s"] >= 0
    assert rp.pipeline["speculative_dispatched"] >= 1
    assert set(rp.pipeline) >= {
        "enabled", "speculative_dispatched", "speculative_wasted",
        "fetch_wait_s", "execute_wall_s", "overlap_ratio"}


def test_equivalence_across_repair_switch_boundary():
    """At the switch the speculative chunk ran the full step where the
    sequential rule picks the repair step: it is discarded and run again,
    so the committed chunks ran exactly the sequential programs."""
    ref, rp, rs = _triple(
        SWITCH_CFG, lambda S: S(write_rounds=8, part_fn=_switch_part),
        max_rounds=256, chunk=8, seed=3, min_rounds=48,
    )
    want = _leaves(ref.state)
    _assert_same(rp, want, ref)
    _assert_same(rs, want, ref)
    assert rp.repair_chunks == rs.repair_chunks > 0
    discards = [e["attrs"]["reason"] for e in rp.flight.events()
                if e["name"] == "pipeline_discard"]
    assert discards.count("program_switch") == 1
    assert rp.pipeline["speculative_wasted"] == len(discards)
    # the JAX package's pipelined loop discards the same chunks
    ref_discards = [(e["r"], e["attrs"]["reason"]) for e in ref.flight.events()
                    if e["name"] == "pipeline_discard"]
    assert [(e["r"], e["attrs"]["reason"]) for e in rp.flight.events()
            if e["name"] == "pipeline_discard"] == ref_discards


def test_speculation_discard_at_convergence():
    """The look-ahead chunk past the converged chunk is discarded and
    counted; the committed rounds are the sequential loop's."""
    pcfg = sim_config_from_dict(dataclasses.asdict(CFG))
    runs = [
        run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                Schedule(write_rounds=4), max_rounds=256, chunk=4, seed=0,
                device="cpu", pipeline=pipeline)
        for pipeline in (True, False)
    ]
    rp, rs = runs
    assert rp.converged_round is not None and rp.rounds < 256
    assert rp.rounds == rs.rounds
    assert rp.pipeline["speculative_wasted"] >= 1
    discards = [e["attrs"]["reason"] for e in rp.flight.events()
                if e["name"] == "pipeline_discard"]
    assert "converged" in discards
    assert rp.flight.diagnostics()["pipeline"]["speculative_wasted"] >= 1
    # each speculative chunk ran on a copy of a whole state
    assert rp.pipeline["speculative_copy_bytes"] > 0


def test_pipeline_counters_and_spans():
    """The pipelined loop's process-wide series: one speculative dispatch
    counted per speculation, one discard by reason, the fetch waits by
    mode, and one "chunk dispatch" span per queued chunk."""
    pcfg = sim_config_from_dict(dataclasses.asdict(CFG))
    spec = (PIPELINE_SPECULATIVE_TOTAL, "")
    wasted = (PIPELINE_SPECULATIVE_WASTED, '{reason="converged"}')
    before = {k: counters.get(*k) for k in (spec, wasted)}
    waits = histograms.get(PIPELINE_FETCH_WAIT, '{mode="pipelined"}')
    waits0 = waits.count if waits is not None else 0
    t0 = time.time()
    res = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                  Schedule(write_rounds=4), max_rounds=256, chunk=4, seed=0,
                  device="cpu", pipeline=True)
    assert (counters.get(*spec) - before[spec]
            == res.pipeline["speculative_dispatched"])
    assert counters.get(*wasted) - before[wasted] == 1
    committed = res.rounds // 4
    assert (histograms.get(PIPELINE_FETCH_WAIT, '{mode="pipelined"}').count
            - waits0 == committed)
    queued = [s for s in tracer.recent(4096, name="chunk dispatch")
              if s.start >= t0]
    # every committed chunk, and the speculative ones, were queued
    assert committed <= len(queued) <= committed + res.pipeline[
        "speculative_wasted"]


def test_pipeline_follows_cfg_pipeline():
    pcfg = dataclasses.replace(sim_config_from_dict(
        dataclasses.asdict(CFG)), pipeline=False)
    res = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                  Schedule(write_rounds=4), max_rounds=8, chunk=4, seed=0,
                  device="cpu")
    assert res.pipeline["enabled"] is False
    assert res.flight.meta["pipeline"] is False
