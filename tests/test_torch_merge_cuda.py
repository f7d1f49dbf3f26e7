"""The CUDA merge kernel against its plain version, on the card.

Every test is marked ``cuda`` and skips without a CUDA device: the
kernel has no CPU mode. The file imports no JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_merge_cuda.py -q -m cuda

Inputs come from a seeded numpy generator. The kernel merges in place;
each case computes the plain version first (it is functional), then
launches the kernel on the same planes and requires the result in those
planes, bit for bit (tolerance: exact).
"""

import numpy as np
import pytest
import torch

from corro_sim_torch.core import crdt
from corro_sim_torch.core import merge_kernel as mk

NEG = crdt.NEG


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _lanes(rng, n, rows, cols, m):
    """Deletes, resurrections, invalid lanes and same-cell conflicts."""
    row = rng.integers(0, rows, m)
    col = rng.integers(0, cols, m)
    vr = rng.integers(-3, 50, m)
    cl = rng.integers(1, 4, m)
    is_del = rng.random(m) < 0.2
    fields = np.stack([
        row * cols + col, rng.integers(1, 6, m),
        np.where(is_del, NEG, vr), rng.integers(0, n, m),
        np.where(is_del, cl + cl % 2, cl), rng.random(m) < 0.8,
    ]).astype(np.int32)
    return fields


def _state(rng, n, rows, cols, device):
    pre = _lanes(rng, n, rows, cols, n * 64)
    dst = rng.integers(0, n, n * 64).astype(np.int32)
    f = torch.as_tensor(pre, device=device)
    return crdt.apply_cell_changes(
        crdt.make_table_state(n, rows, cols, device),
        torch.as_tensor(dst, device=device), f[0] // cols, f[0] % cols,
        f[1], f[2], f[3], f[4], f[5] != 0,
    )


def _check(state, box, cap, cols):
    n = state.cl.shape[0]
    planes = (state.cv.view(n, -1), state.vr.view(n, -1),
              state.site.view(n, -1), state.cl)
    want = mk.grouped_merge_reference(*planes, box, cap, cols)
    before = mk.LAUNCHES["grouped_merge"]
    got = mk.grouped_merge(*planes, box, cap, cols)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["grouped_merge"] == before + 1
    for g, p, w in zip(got, planes, want):
        assert g.data_ptr() == p.data_ptr()
        assert torch.equal(p, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,cols,cap", [
    (512, 256, 4, 128),  # the slice's cell layout
    (256, 8192, 1, 128),
    (512, 128, 8, 128),
    (512, 256, 4, 256),
    (256, 64, 16, 128),  # the general (run-time cols) path
    (256, 128, 3, 128),
    (64, 32, 4, 100),  # cap not a multiple of 32
    (1000, 512, 6, 1024),  # config 3's sync mailbox: one warp per block
    (1000, 512, 6, 512),  # config 3's delivery mailbox under "on"
    (1000, 2048, 2, 512),  # config 6's sync mailbox (4096 cells)
    (1000, 2048, 2, 128),  # config 6's delivery mailbox under "on"
])
def test_cuda_kernel_matches_plain_version(dev, n, rows, cols, cap):
    rng = np.random.default_rng(n + rows + cols + cap)
    state = _state(rng, n, rows, cols, dev)
    box = torch.as_tensor(_lanes(rng, n, rows, cols, n * cap), device=dev)
    _check(state, box, cap, cols)


@pytest.mark.cuda
def test_kernel_hot_row_and_empty_mailbox(dev):
    rng = np.random.default_rng(5)
    n, rows, cols, cap = 64, 256, 4, 128
    state = _state(rng, n, rows, cols, dev)
    box = torch.as_tensor(_lanes(rng, n, rows, cols, n * cap), device=dev)
    box[mk.LANE_VALID] = 0
    _check(state, box, cap, cols)  # nothing valid: nothing changes
    box[mk.LANE_VALID, :cap] = 1  # every lane of node 0 on row 7
    box[mk.LANE_CELL, :cap] = 7 * cols + box[mk.LANE_CELL, :cap] % cols
    _check(state, box, cap, cols)


@pytest.mark.cuda
def test_dram_probe_keeps_the_planes(dev):
    """The probe's read and read-write patterns leave the planes as they
    were; its write pattern fills exactly the listed rows."""
    from corro_sim_torch import merge_probe as mp

    rng = np.random.default_rng(9)
    n, rows, cols, cap = 64, 256, 4, 128
    state = _state(rng, n, rows, cols, dev)
    box = torch.as_tensor(_lanes(rng, n, rows, cols, n * cap), device=dev)
    hit = mp.hit_rows(box, cap, cols, rows * cols)
    planes = (state.cv.view(n, -1), state.vr.view(n, -1),
              state.site.view(n, -1))
    before = [p.clone() for p in planes]
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for mode in range(1, len(mp.PROBE_MODES)):
        mp.probe(planes, hit, mode, sink)
        torch.cuda.synchronize()
        assert all(torch.equal(p, b) for p, b in zip(planes, before))
    mp.probe(planes, hit, 0, sink)
    torch.cuda.synchronize()
    listed = torch.zeros((n, rows), dtype=torch.bool, device=dev)
    listed[torch.arange(n, device=dev)[:, None].expand_as(hit)[hit >= 0],
           hit[hit >= 0].long()] = True
    written = listed.repeat_interleave(cols, dim=1)
    for p, b in zip(planes, before):
        assert bool((p[written] == 0).all())
        assert torch.equal(p[~written], b[~written])


# config 5's and config 7's sync mailbox: K' * cap * S = 512 * 16 * 1 =
# 8192 lanes per node over 128 rows x 2 columns, more than a warp's share
# of shared memory holds: the kernel merges it tile by tile
BIG_CAP, BIG_ROWS, BIG_COLS = 8192, 128, 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 1024])
def test_cuda_kernel_tiles_a_cap_8192_mailbox(dev, n):
    tile = mk.merge_tile(BIG_CAP, BIG_ROWS * BIG_COLS, BIG_COLS, dev)
    assert 0 < tile < BIG_CAP and tile % 128 == 0
    rng = np.random.default_rng(n)
    state = _state(rng, n, BIG_ROWS, BIG_COLS, dev)
    box = torch.as_tensor(
        _lanes(rng, n, BIG_ROWS, BIG_COLS, n * BIG_CAP), device=dev)
    _check(state, box, BIG_CAP, BIG_COLS)


def _one_node_box(n, cap, lanes, dev):
    """A mailbox whose node 0 holds ``lanes`` — ``{position: (cell, cv,
    vr, site, cl)}`` — and nothing else valid."""
    box = torch.zeros((mk.LANE_FIELDS, n * cap), dtype=torch.int32,
                      device=dev)
    for pos, fields in lanes.items():
        box[:5, pos] = torch.tensor(fields, dtype=torch.int32)
        box[mk.LANE_VALID, pos] = 1
    return box


@pytest.mark.cuda
def test_cuda_kernel_tile_boundary_inside_a_row(dev):
    """One row's lanes straddle the first tile boundary: the winner of
    each cell comes from either side, and the row's cl grows in the
    second tile."""
    n = 4
    tile = mk.merge_tile(BIG_CAP, BIG_ROWS * BIG_COLS, BIG_COLS, dev)
    rng = np.random.default_rng(3)
    state = _state(rng, n, BIG_ROWS, BIG_COLS, dev)
    row = 5
    lanes = {
        tile - 2: (row * 2, 7, 10, 1, 1),  # cell 0 at cl 1, first tile
        tile - 1: (row * 2 + 1, 9, 3, 2, 1),
        tile: (row * 2, 7, 11, 0, 1),  # ties cv, wins on vr, second tile
        tile + 1: (row * 2 + 1, 9, 3, 3, 1),  # ties cv and vr, wins site
        tile + 2: (row * 2, 2, 20, 1, 3),  # cl 3 wins over both
    }
    _check(state, _one_node_box(n, BIG_CAP, lanes, dev), BIG_CAP, BIG_COLS)


@pytest.mark.cuda
def test_cuda_kernel_later_tile_delete_wipes_earlier_value(dev):
    """A delete at a higher cl in a later tile than a value at a lower cl
    wipes the row the earlier tile wrote; a later value at the lower cl
    stays out."""
    n = 4
    tile = mk.merge_tile(BIG_CAP, BIG_ROWS * BIG_COLS, BIG_COLS, dev)
    state = crdt.make_table_state(n, BIG_ROWS, BIG_COLS, dev)
    row = 9
    lanes = {
        3: (row * 2, 5, 40, 2, 1),  # a value at cl 1, tile 0
        tile + 17: (row * 2 + 1, 1, NEG, 1, 2),  # delete at cl 2, tile 1
        3 * tile + 1: (row * 2 + 1, 6, 50, 3, 1),  # value at cl 1, tile 3
    }
    _check(state, _one_node_box(n, BIG_CAP, lanes, dev), BIG_CAP, BIG_COLS)
    assert int(state.cl[0, row]) == 2
    assert int(state.vr[0, row, 0]) == NEG and int(state.vr[0, row, 1]) == NEG


@pytest.mark.cuda
def test_cuda_kernel_all_invalid_cap_8192_mailbox(dev):
    n = 256
    rng = np.random.default_rng(4)
    state = _state(rng, n, BIG_ROWS, BIG_COLS, dev)
    before = [t.clone() for t in (state.cv, state.vr, state.site, state.cl)]
    box = torch.as_tensor(
        _lanes(rng, n, BIG_ROWS, BIG_COLS, n * BIG_CAP), device=dev)
    box[mk.LANE_VALID] = 0
    _check(state, box, BIG_CAP, BIG_COLS)
    for t, b in zip((state.cv, state.vr, state.site, state.cl), before):
        assert torch.equal(t, b)


@pytest.mark.cuda
def test_cuda_kernel_on_a_crash_amnesia_catch_up_mailbox(dev, monkeypatch):
    """A real sweep mailbox: config 0's shape (256 x 4 = 1024 cells) at
    512 nodes under crash_amnesia, the first sweep after the wiped nodes
    rejoin, which carries their catch-up lanes. The kernel must equal
    the plain version on it."""
    from corro_sim_torch.engine import driver
    from corro_sim_torch.profile_slice import run_soak, soak_config
    from corro_sim_torch.sync import sync as sync_mod

    n = 512
    now = {"round": -1}
    captured = []
    real_step, real_merge = driver.sim_step, sync_mod.merge_grouped

    def step(cfg, state, key, alive, part, we, round_idx, **kw):
        now["round"] = round_idx
        return real_step(cfg, state, key, alive, part, we, round_idx, **kw)

    def merge(table, box, cap):
        if not captured and now["round"] >= rejoin:
            victims = torch.as_tensor(nodes_down, device=box.device)
            lanes = box[mk.LANE_VALID].view(n, cap)[victims]
            if int(lanes.sum()) > 0:
                captured.append((crdt.TableState(
                    cv=table.cv.clone(), vr=table.vr.clone(),
                    site=table.site.clone(), cl=table.cl.clone()),
                    box.clone(), cap))
        return real_merge(table, box, cap)

    from corro_sim_torch.faults import make_scenario

    sc = make_scenario("crash_amnesia", n, rounds=64, write_rounds=16)
    nodes_down = [node for node, _r in sc.node_faults["crash"]]
    rejoin = sc.node_faults["crash"][0][1]
    monkeypatch.setattr(driver, "sim_step", step)
    monkeypatch.setattr(sync_mod, "merge_grouped", merge)
    run = run_soak(soak_config(n), "crash_amnesia", rounds=64,
                   write_rounds=16, chunk=8, max_rounds=64, device="cuda",
                   invariants=False, stop_on_convergence=False)
    assert run.result.metrics["node_fault_wipes"].sum() == len(nodes_down)
    assert captured, "no sweep after the rejoin reached the wiped nodes"
    state, box, cap = captured[0]
    assert state.cv.shape == (n, 256, 4)
    _check(state, box, cap, 4)


@pytest.mark.cuda
def test_live_cluster_on_the_card_equals_the_cpu(dev, tmp_path):
    """A Consul-schema LiveCluster (512 rows x 6 columns: the sync
    sweep's merge takes the kernel on the card, the scatter arm on the
    CPU) driven through its API with writers, subscribers, a node down
    and rejoined, to convergence: the card's run equals the CPU's leaf
    for leaf, in its events and metric totals, and launched the kernel."""
    import types

    from corro_sim_torch import profile_slice as ps
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.harness.cluster import LiveCluster
    from corro_sim_torch.io.checkpoint import load_checkpoint, save_checkpoint

    n = 48
    subscribers = ps.subs_subscribers(
        ps.subs_queries(ps.LIVE_SEED, n, ps.LIVE_KEYS), ps.LIVE_SEED,
        per=2)
    backend = types.SimpleNamespace(LiveCluster=LiveCluster,
                                    save_checkpoint=save_checkpoint,
                                    load_checkpoint=load_checkpoint)
    runs = {}
    for d in ("cpu", "cuda"):
        mk.reset_launch_counts()
        run = ps.live_drive(backend, n, subscribers=subscribers,
                            ckpt_path=str(tmp_path / f"{d}.npz"),
                            device=d, **dict(ps.LIVE_DIGESTS_RUN,
                                             writers=12, per_writer=4,
                                             down_at=2))
        runs[d] = (run, ps.live_record(run, state_to_numpy(
            run["cluster"].state), state_to_numpy(run["warm"].state)),
            mk.LAUNCHES["grouped_merge"])
    assert runs["cuda"][1] == runs["cpu"][1]
    assert runs["cpu"][2] == 0 and runs["cuda"][2] > 0
    assert ps.live_folded_mismatches(runs["cuda"][0]) == []


@pytest.mark.cuda
def test_api_server_on_the_card_equals_the_cpu(dev):
    """An ApiServer (and a PgServer) over a 48-node Consul-schema
    LiveCluster (512 rows x 6 columns: its sync sweeps merge through the
    kernel on the card): a transaction, a query on three surfaces and a
    subscription event over HTTP, then 16 more rounds, on the card equal
    the same on the CPU, leaf for leaf, and the card launched the
    kernel."""
    from corro_sim_torch import profile_slice as ps
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.harness.cluster import LiveCluster
    from corro_sim_torch.schema import consul_schema_sql

    runs = {}
    for d in ("cpu", "cuda"):
        c = LiveCluster(consul_schema_sql(), num_nodes=48, seed=0,
                        capacities=ps.subs_capacities(ps.LIVE_KEYS),
                        cfg_overrides=dict(ps.LIVE_OVERRIDES), device=d)
        mk.reset_launch_counts()
        out = ps.serve_check(c, writer=5, reader=40)
        c.tick(16)
        launches = mk.LAUNCHES["grouped_merge"]
        out.pop("seconds")
        out.pop("metrics")
        assert ps.serve_agrees(out)
        runs[d] = (out, state_to_numpy(c.state), launches)
        c.tripwire.trip()
    assert runs["cuda"][0] == runs["cpu"][0]
    a, b = runs["cpu"][1], runs["cuda"][1]
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []
    assert runs["cpu"][2] == 0 and runs["cuda"][2] > 0


@pytest.mark.cuda
def test_cli_run_on_the_card_equals_the_cpu(dev, tmp_path):
    """``python -m corro_sim_torch run`` in a child process at a 1024-cell
    config (256 rows x 4 columns: the sync sweep's merge takes the kernel
    on the card) gives the report ``--device cpu`` gives, but for the
    wall-clock fields: ``wall_per_round_ms``, ``compile_seconds`` and
    the timing fields of ``pipeline``."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wall = {"wall_per_round_ms", "compile_seconds"}
    timing = {"fetch_wait_s", "execute_wall_s", "overlap_ratio"}
    reports = {}
    for device in ("cpu", "cuda"):
        r = subprocess.run(
            [sys.executable, "-m", "corro_sim_torch", "--device", device,
             "run", "--nodes", "64", "--rows", "256", "--cols", "4",
             "--write-rounds", "8", "--chunk", "8", "--seed", "3",
             "--flight-out", str(tmp_path / "flight.ndjson")],
            cwd=root, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert r.returncode == 0, r.stderr
        rep = {k: v for k, v in json.loads(r.stdout).items()
               if k not in wall}
        rep["pipeline"] = {k: v for k, v in rep["pipeline"].items()
                           if k not in timing}
        reports[device] = rep
    assert reports["cuda"] == reports["cpu"]
    assert reports["cuda"]["converged_round"] is not None
    assert reports["cuda"]["pipeline"]["sweeps_run"] > 0
