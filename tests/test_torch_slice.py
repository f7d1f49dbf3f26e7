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


@pytest.mark.parametrize("case", [*NORTH_STAR, "config_2_64"])
def test_run_sim_bit_identical(case):
    if case == "config_2_64":
        cfg, kw = config_2(), dict(max_rounds=256, chunk=16, seed=0)
        ref_sched, sched = RefSchedule(write_rounds=16), Schedule(write_rounds=16)
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
    if cfg.swim_enabled:
        assert ref.metrics["swim_suspects"].max() > 0  # the cut is seen
    _assert_runs_equal(ref, got)


@pytest.mark.parametrize("cfg_fn", [
    north_star_small, config_2, north_star_swim, north_star_swim_wide,
    north_star_swim_windowed, north_star_swim_windowed_wide,
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
