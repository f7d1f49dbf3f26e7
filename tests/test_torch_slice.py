"""Parity, whole runs: corro_sim_torch.engine.driver.run_sim against
corro_sim.engine.driver.run_sim on the CPU.

Every state leaf, every metric of every round, ``converged_round`` and
``repair_chunks`` must be equal (tolerance: exact — the main path is
integer arithmetic plus float32 threshold compares, and ``gap`` sums
stay far below 2**24 at these sizes). The SWIM-on runs keep
``swim_payload_members < swim_view_size`` where the view is windowed:
beyond it the JAX package leaves a duplicate write's winner unspecified.
tests/test_torch_swim.py holds a long SWIM-on run and the digests.
"""

import dataclasses

import jax
import numpy as np
import pytest

from corro_sim.config import SimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.schema import TableLayout, consul_schema_sql, parse_and_constrain
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_from_reference, state_to_numpy
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _part(r, num):
    p = np.zeros(num, np.int32)
    if 4 <= r < 12:
        p[num // 2:] = 1
    return p


def north_star_small(merge_kernel="on"):
    """The north-star cluster (benchmarks.py config 0) without SWIM, cut
    to 32 nodes: only what N forces is scaled."""
    return SimConfig(
        num_nodes=32, num_rows=32, num_cols=4, log_capacity=512,
        write_rate=0.5, zipf_alpha=0.8, swim_enabled=False,
        sync_interval=8, pend_slots=8, fanout=2, sync_adaptive=True,
        sync_floor_rounds=1, sync_actor_topk=16, sync_cap_per_actor=1,
        sync_req_actors=16, sync_need_sample=16, sync_deal_probes=0,
        narrow_state=True, merge_kernel=merge_kernel,
    )


def north_star_swim(narrow=True, interval=4, **kw):
    """The north-star cluster with SWIM on, as config 0 runs it
    (``swim_suspect_rounds=6``, narrow layout, a tick every 4 rounds), at
    32 nodes."""
    return dataclasses.replace(
        north_star_small("on"), swim_enabled=True, swim_suspect_rounds=6,
        swim_interval=interval, narrow_state=narrow, **kw,
    )


def north_star_swim_wide():
    return north_star_swim(narrow=False, interval=1)


def north_star_swim_windowed():
    return north_star_swim(swim_view_size=8, swim_payload_members=4)


def north_star_swim_windowed_wide():
    return north_star_swim(narrow=False, swim_view_size=8,
                           swim_payload_members=4)


def config_2():
    """benchmarks.py config 2: 64 nodes, one column, SWIM off."""
    return SimConfig(
        num_nodes=64, num_rows=64, num_cols=1, log_capacity=256,
        write_rate=0.5, fanout=3, swim_enabled=False, sync_interval=8,
    )


def config3_ref(n=1000, **kw):
    """The JAX package's config 3 exactly as ``run_config_3`` builds it
    (its layout from the Consul schema), with ``kw`` replaced."""
    layout = TableLayout(
        parse_and_constrain(consul_schema_sql()), default_capacity=256
    )
    cfg = SimConfig(
        num_nodes=n, num_rows=layout.num_rows,
        num_cols=max(layout.num_cols, 1), log_capacity=512,
        write_rate=0.5, zipf_alpha=1.1, seqs_per_version=4,
        chunks_per_version=2, swim_enabled=True, sync_interval=8,
        sync_actor_topk=16,
    )
    return dataclasses.replace(cfg, **kw)


def config3_small(n=32, **kw):
    """Config 3's shape cut to ``n`` nodes and 64 row slots."""
    return config3_ref(n, num_rows=64, **kw)


def config3_cpv4_pend2():
    """The degenerate ring: more chunks per version than ring slots."""
    return config3_small(32, chunks_per_version=4, pend_slots=2)


def config3_s8_cols4():
    """More cell lanes per changeset than columns (S > num_cols)."""
    return config3_small(32, seqs_per_version=8, num_cols=4)


def _assert_runs_equal(ref, got):
    assert got.rounds == ref.rounds
    assert got.converged_round == ref.converged_round
    assert got.repair_chunks == ref.repair_chunks
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        np.testing.assert_array_equal(got.metrics[k], np.asarray(v),
                                      err_msg=k)
    want, have = _leaves(ref.state), state_to_numpy(got.state)
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


NORTH_STAR = {
    "north_star_32_kernel_on": lambda: north_star_small("on"),
    "north_star_swim_32": north_star_swim,
    "north_star_swim_32_wide": north_star_swim_wide,
    "north_star_swim_32_windowed": north_star_swim_windowed,
}

# multi-cell, multi-chunk changesets: config 3's shape with the merge
# kernel forced on both sites and off, at 64 nodes, the degenerate ring
# (cpv > pend_slots) and more cell lanes than columns (S > num_cols)
CONFIG3 = {
    "config3_32_kernel_on": lambda: config3_small(32, merge_kernel="on"),
    "config3_32_kernel_off": lambda: config3_small(32, merge_kernel="off"),
    "config3_64": lambda: config3_small(64),
    "config3_cpv4_pend2": config3_cpv4_pend2,
    "config3_s8_cols4": config3_s8_cols4,
}


@pytest.mark.parametrize("case", [*NORTH_STAR, "config_2_64", *CONFIG3])
def test_run_sim_bit_identical(case):
    if case == "config_2_64":
        cfg, kw = config_2(), dict(max_rounds=256, chunk=16, seed=0)
        ref_sched, sched = RefSchedule(write_rounds=16), Schedule(write_rounds=16)
    elif case in CONFIG3:
        cfg, kw = CONFIG3[case](), dict(max_rounds=512, chunk=8, seed=0)
        ref_sched, sched = RefSchedule(write_rounds=32), Schedule(write_rounds=32)
    else:
        cfg = NORTH_STAR[case]()
        kw = dict(max_rounds=512, chunk=16, seed=0, min_rounds=16)
        ref_sched = RefSchedule(write_rounds=8, part_fn=_part)
        sched = Schedule(write_rounds=8, part_fn=_part)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0), ref_sched, **kw)
    pcfg = sim_config_from_dict(dataclasses.asdict(cfg))
    got = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"), sched,
                  device="cpu", **kw)
    assert ref.converged_round is not None
    assert float(ref.metrics["gap"][-1]) == 0.0
    if case == "config_2_64":
        assert ref.repair_chunks > 0  # the repair step is exercised
    if cfg.swim_enabled and case not in CONFIG3:
        assert ref.metrics["swim_suspects"].max() > 0  # the cut is seen
    if cfg.chunks_per_version > 1:
        assert ref.metrics["buffered_partials"].max() > 0  # chunks buffer
        m = ref.metrics
        assert m["cells_written"].sum() > m["writes"].sum()  # S > 1 cells
    if cfg.chunks_per_version > cfg.pend_slots:
        assert ref.metrics["queue_overflow"][-1] > 0  # the ring overflows
    _assert_runs_equal(ref, got)


@pytest.mark.parametrize("cfg_fn", [
    north_star_small, config_2, north_star_swim, north_star_swim_wide,
    north_star_swim_windowed, north_star_swim_windowed_wide,
    config3_small, config3_cpv4_pend2, config3_s8_cols4,
])
def test_convert_round_trip(cfg_fn):
    """reference init_state -> port -> numpy equals the original, and the
    port's own init_state builds the same leaves."""
    cfg = cfg_fn()
    want = _leaves(ref_init_state(cfg, seed=5))
    have = state_to_numpy(state_from_reference(want, "cpu"))
    assert set(have) == set(want)
    pcfg = sim_config_from_dict(dataclasses.asdict(cfg))
    built = state_to_numpy(init_state(pcfg, seed=5, device="cpu"))
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
        assert built[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(built[k], want[k], err_msg=k)


def test_convert_round_trip_mid_run():
    """A multi-chunk state mid-run — chunk fields in the gossip rings,
    partly set window groups, S-cell log entries — crosses to the port
    and back unchanged."""
    cfg = config3_small(32)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0),
                      RefSchedule(write_rounds=32), max_rounds=16, chunk=8,
                      seed=0, stop_on_convergence=False)
    want = _leaves(ref.state)
    assert (want["gossip.pend"][..., 2] > 0).any()  # chunk 1 in a ring
    assert (want["log.ncells"] > 1).any()
    have = state_to_numpy(state_from_reference(want, "cpu"))
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
