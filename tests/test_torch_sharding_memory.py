"""Change-log sharding and the large-cluster memory fit, on the port:
``tests/test_sharding_memory.py``'s five cases with the budget of one
H100 (80 GB) and the port's widened carriers (``convert.WIDENED``: the
book window rides int64, the wide SWIM beliefs int64).

Shape-only cases build the state on the ``meta`` device; the run case
holds an 8-rank actor-sharded run to the JAX package's one-device run,
bit for bit."""

import dataclasses

import jax
import numpy as np
import torch

from corro_sim.config import SimConfig as RefSimConfig
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim_torch import config as pconfig
from corro_sim_torch.engine.mesh_jobs import batch
from corro_sim_torch.engine.ranks import run_ranks
from corro_sim_torch.engine.sharding import (
    SHARD_LOG_ACTORS,
    Mesh,
    _specs,
    state_bytes,
    state_bytes_breakdown,
    state_shardings,
)
from corro_sim_torch.engine.state import init_state
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

H100_HBM = 80 * 10**9  # bytes of one H100 SXM's HBM3
MESH8 = Mesh(("nodes",), {"nodes": 8}, {"nodes": 0}, None, "cpu")


def _config5(nodes):
    # keep in lockstep with profile_slice.config5_config
    return pconfig.SimConfig(
        num_nodes=nodes, num_rows=128, num_cols=2, log_capacity=256,
        write_rate=0.2, swim_enabled=False, sync_interval=4,
        sync_actor_topk=64, sync_cap_per_actor=8,
    )


def test_50k_state_fits_one_h100_on_8_mesh():
    """Config 5 at 50 000 nodes: each of 8 ranks holds an eighth of the
    bookkeeping planes, with room for the sweep's temporaries; config
    7's 100 000-node target does not fit one H100 at all, and its
    8-rank share does."""
    cfg = _config5(50_000)
    total, per_dev = state_bytes(cfg, sharded_over=8)
    book = state_bytes_breakdown(cfg, sharded_over=8)["book"]
    # the port's carriers: head int32 + the window int64, (N, A) each
    assert book["total"] == 12 * cfg.num_nodes * cfg.num_actors
    assert book["per_device"] * 8 == book["total"]
    temporaries = 3 * 4 * (cfg.num_nodes // 8) * cfg.num_actors
    assert per_dev + temporaries < 0.85 * H100_HBM, (
        f"per-device {per_dev/2**30:.1f} GiB + {temporaries/2**30:.1f} GiB"
    )
    big = dataclasses.replace(_config5(100_000), shard_log=True)
    total, per_dev = state_bytes(big, sharded_over=8)
    assert total > H100_HBM, f"total {total/2**30:.1f} GiB"
    temporaries = 3 * 4 * (big.num_nodes // 8) * big.num_actors
    assert per_dev + temporaries < 0.85 * H100_HBM


def test_log_shards_over_actors_at_scale():
    small = init_state(_config5(64), seed=0, device="meta")
    bigger = init_state(_config5(SHARD_LOG_ACTORS), seed=0, device="meta")
    sh_small = _specs(state_shardings(small, MESH8, 64))
    sh_big = _specs(state_shardings(bigger, MESH8, SHARD_LOG_ACTORS))
    assert sh_small["log.cells"].spec == ()
    assert sh_big["log.cells"].spec == ("nodes",)
    # bookkeeping planes are node-sharded in both regimes
    assert sh_big["book.head"].spec == ("nodes",)
    assert sh_small["book.win"].spec == ("nodes",)


def test_sharded_log_run_matches_single_device():
    """An 8-rank run with the log actor-sharded equals the JAX package's
    one-device run: the gap series, the table and the log."""
    cfg = RefSimConfig(num_nodes=16, num_rows=8, num_cols=2,
                       log_capacity=64)
    r_plain = ref_run_sim(cfg, ref_init_state(cfg, seed=7), max_rounds=16,
                          chunk=8, seed=7, stop_on_convergence=False)
    pcfg = dataclasses.replace(
        pconfig.sim_config_from_dict(dataclasses.asdict(cfg)),
        shard_log=True)
    (got,) = run_ranks(batch, 8, [("run_sim_job", (
        dataclasses.asdict(pcfg), 7,
        dict(max_rounds=16, chunk=8, seed=7, stop_on_convergence=False)),
        {"write_rounds": None})], timeout=300)
    assert got["sharding"]["shard_log"] == "actor_sharded"
    np.testing.assert_array_equal(r_plain.metrics["gap"],
                                  got["metrics"]["gap"])
    np.testing.assert_array_equal(np.asarray(r_plain.state.table.vr),
                                  got["state"]["table.vr"])
    np.testing.assert_array_equal(np.asarray(r_plain.state.log.cells),
                                  got["state"]["log.cells"])


def test_50k_windowed_swim_fits_hbm_budget():
    """Windowed SWIM at 50k: the O(N·K) view fits beside the state under
    the per-rank budget, where the full-view (N, N) plane alone would
    take a quarter of an H100."""
    cfg = dataclasses.replace(_config5(50_000), swim_enabled=True,
                              swim_view_size=128)
    total, per_dev = state_bytes(cfg, sharded_over=8)
    n, k = cfg.num_nodes, cfg.swim_view_size
    swim = state_bytes_breakdown(cfg)["swim"]["total"]
    # member int32 + belief int64 (the wide layout's carrier) + cursor
    assert swim == n * k * (4 + 8) + n * 4
    assert swim < 100 * 2**20, swim
    p = min(cfg.swim_payload_members, k)
    match_tmp = (n // 8) * k * p * 4
    assert per_dev + match_tmp < 0.85 * H100_HBM
    # the full-view plane in the wide carrier: int64 (N, N)
    assert 8 * n * n >= 0.25 * H100_HBM


def test_windowed_swim_tick_builds_no_n_by_n_tensor():
    """The windowed tick allocates nothing with two axes of length N: a
    dispatch mode records every tensor one tick at 2048 nodes makes (the
    JAX package traces its step at 50k shapes for the same claim)."""
    from corro_sim_torch import prng
    from corro_sim_torch.engine.mesh_jobs import AllocationWatch
    from corro_sim_torch.membership.swim_window import swim_window_step

    n = 2048
    cfg = dataclasses.replace(_config5(n), swim_enabled=True,
                              swim_view_size=128, swim_interval=1)
    st = init_state(cfg, seed=0, device="cpu")
    alive = torch.ones(n, dtype=torch.bool)

    def reach(src, dst):
        return alive[src.long()] & alive[dst.long()]

    watch = AllocationWatch(n)
    with watch():
        swim, _ = swim_window_step(cfg, st.swim, prng.PRNGKey(0), alive,
                                   reach, 0)
    assert watch.count > 0
    assert watch.worst <= 1, watch.shapes
    assert tuple(swim.member.shape) == (n, cfg.swim_view_size)
    # the reference keeps the same (N, K) shape
    ref = jax.eval_shape(lambda: ref_init_state(
        RefSimConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(RefSimConfig)
                        if f.name in ("num_nodes", "num_rows", "num_cols",
                                      "log_capacity", "swim_enabled",
                                      "swim_view_size")}), seed=0))
    assert ref.swim.member.shape == tuple(swim.member.shape)
