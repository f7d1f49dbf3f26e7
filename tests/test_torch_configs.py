"""Parity, whole runs of the JAX package's configs 4, 5 and 7 at small
sizes: the port's ``run_sim`` (pipelined, the default) against
``corro_sim.engine.driver.run_sim`` on the CPU.

Each configuration is ``corro_sim_torch.profile_slice``'s definition cut
in node count only, with the hot-actor window narrowed below the actor
count where the full size rotates it (configs 5 and 7: 8192 of 12 500 to
16 384 actors; here 16 of 64), and config 7's SWIM view cut to 16 with
8 payload members (below the view, where the JAX package's duplicate
writes are defined). Config 5 runs its outage schedule to convergence,
config 7 its 8 write rounds to convergence, config 4 its 40 rounds with
no convergence stop. Configs 5 and 7 take the mailbox merge
(``merge_kernel="on"``: its plain version on the CPU, at 1024 lanes per
node) against the JAX package's scatter merge. Every state leaf, every
metric of every round, ``converged_round`` and ``repair_chunks`` must
be equal (tolerance: exact; the lag sums stay below 2**24 here).
"""

import dataclasses

import jax
import numpy as np
import pytest

from corro_sim.config import SimConfig as RefSimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim_torch import profile_slice as ps
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import Schedule
from corro_sim_torch.engine.driver import run_sim
from corro_sim_torch.engine.state import init_state
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

HOT = dict(sync_hot_actors=16)


def _ref_cfg(cfg) -> RefSimConfig:
    return RefSimConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(RefSimConfig)
        if f.init
    })


def _ref_schedule(sched: Schedule) -> RefSchedule:
    return RefSchedule(write_rounds=sched.write_rounds,
                       alive_fn=sched.alive_fn, part_fn=sched.part_fn)


def _leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _run_both(cfg, sched_fn, run_args, ref_merge="auto"):
    ref_cfg = dataclasses.replace(_ref_cfg(cfg), merge_kernel=ref_merge)
    ref = ref_run_sim(ref_cfg, ref_init_state(ref_cfg, seed=0),
                      _ref_schedule(sched_fn()), **run_args)
    got = run_sim(cfg, init_state(cfg, seed=0, device="cpu"), sched_fn(),
                  device="cpu", **run_args)
    want, have = _leaves(ref.state), state_to_numpy(got.state)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert set(got.metrics) == set(ref.metrics)
    for k in ref.metrics:
        np.testing.assert_array_equal(got.metrics[k],
                                      np.asarray(ref.metrics[k]), err_msg=k)
    assert got.rounds == ref.rounds
    assert got.converged_round == ref.converged_round
    assert got.repair_chunks == ref.repair_chunks
    return got


def test_config4_shape_40_rounds():
    cfg = ps.config4_config(32)
    got = _run_both(cfg, ps.config4_schedule, ps.CONFIG4_RUN_ARGS)
    assert got.rounds == 40 and got.converged_round is None
    assert int(got.metrics["writes"].sum()) > 0
    assert int(got.metrics["swim_suspects"].max()) > 0  # the cut shows
    walls = {c: 1.0 for c in range(5)}
    applied = (got.metrics["writes"] + got.metrics["fresh"]
               + got.metrics["sync_versions"])
    assert ps.config4_rate(walls, got.metrics) == float(np.median(
        [applied[8 * c:8 * c + 8].sum() for c in (1, 2, 3, 4)]))


def test_config5_shape_outage_narrow_window():
    n = 64
    cfg = dataclasses.replace(ps.config5_config(n, "on"), **HOT)
    got = _run_both(cfg, lambda: ps.config5_schedule(n),
                    ps.CONFIG5_RUN_ARGS)
    assert got.converged_round is not None
    assert float(got.metrics["gap"][-1]) == 0.0
    # the outage victims caught up through the sweeps
    assert int(got.metrics["sync_versions"].sum()) > 0
    assert got.pipeline["host_reads"] > 0
    # more actors wrote than the window holds: the window rotated
    assert int((got.state.log.head > 0).sum()) > HOT["sync_hot_actors"]


def test_config7_shape_windowed_swim_narrow_window():
    n = 64
    cfg = dataclasses.replace(ps.config7_config(n, "on"), swim_view_size=16,
                              swim_payload_members=8, **HOT)
    got = _run_both(cfg, ps.config7_schedule, ps.CONFIG7_RUN_ARGS)
    assert got.converged_round is not None
    assert float(got.metrics["gap"][-1]) == 0.0
    assert int((got.state.log.head > 0).sum()) > HOT["sync_hot_actors"]


def test_configs_are_the_jax_packages():
    from corro_sim.benchmarks import config5_cfg, config7_cfg

    for mine, theirs in ((ps.config5_config(4096), config5_cfg(4096)),
                         (ps.config7_config(4096), config7_cfg(4096))):
        assert dataclasses.asdict(_ref_cfg(mine)) == dataclasses.asdict(
            theirs)


def test_one_device_sizing():
    """The H100's 80 GB admits config 5's compute cap and config 7's
    weak-scaling share; a small card halves each by the memory rule."""
    gb = 1024 ** 3
    assert ps.size_config5(80 * gb) == (
        16384, "compute-time cap (one device runs the whole cluster)")
    assert ps.size_config7(80 * gb)[0] == 12500
    n5, why5 = ps.size_config5(4 * gb)
    assert n5 < 16384 and why5 == "device memory budget"
    assert (ps.state_bytes(ps.config5_config(n5)) + 12 * n5 * n5
            <= 0.85 * 4 * gb)
    n7, why7 = ps.size_config7(2 * gb)
    assert n7 < 12500 and why7 == "device memory budget"


@pytest.mark.parametrize("case", ps.CONFIG_DIGEST_CASES)
def test_config_digest_case_matches_the_jax_packages_config(case):
    """The digest runs are the JAX package's configurations with the
    documented cuts (node count, the hot window)."""
    from corro_sim.benchmarks import config5_cfg, config7_cfg

    spec = ps.config_digest_case(case)
    cfg, n = spec["cfg"], int(case.split("_")[1])
    assert cfg.num_nodes == n
    if case.startswith("config5"):
        want = dataclasses.replace(config5_cfg(n), sync_hot_actors=1024)
        assert dataclasses.asdict(_ref_cfg(cfg)) == dataclasses.asdict(want)
    elif case.startswith("config7"):
        want = dataclasses.replace(config7_cfg(n), sync_hot_actors=1024)
        assert dataclasses.asdict(_ref_cfg(cfg)) == dataclasses.asdict(want)
    assert case in ps.DIGESTS and case in ps.CONFIG_DIGEST_ROUNDS
