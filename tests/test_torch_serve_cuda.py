"""The CUDA serve kernel against the sync sweep's torch serve path, on
the card.

Every test is marked ``cuda`` and skips without a CUDA device: the kernel
has no CPU mode. The file imports no JAX:

    python -m pytest tests/test_torch_serve_cuda.py -q -m cuda

The lane tests draw a change log and an (N, K') schedule from a seeded
numpy generator (cleared versions, nodes whose every ``take`` is 0,
versions past the window, slots that wrap the log ring) and hold
:func:`~corro_sim_torch.sync.serve.serve_lanes` to
:func:`~corro_sim_torch.sync.serve.serve_lanes_reference`, the torch
path's own lanes: the mailbox's live row everywhere, its other rows on
live lanes, the per-node stamp maximum, ``last_cleared`` folded from it
and the two counts (tolerance: exact, integer arithmetic). The run test
holds whole catch-up runs on the kernel path to the same runs on the
torch path, state leaf for leaf and metric for metric.
"""

import numpy as np
import pytest
import torch

from corro_sim_torch.core import merge_kernel as mk
from corro_sim_torch.core.changelog import ChangeLog
from corro_sim_torch.core.crdt import NEG
from corro_sim_torch.sync import serve as sv
from corro_sim_torch.utils.sort import scatter_max


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _log(rng, actors, lcap, seqs, rows, cols):
    cells = np.stack([
        rng.integers(0, rows, (actors, lcap, seqs)),
        rng.integers(0, cols, (actors, lcap, seqs)),
        np.where(rng.random((actors, lcap, seqs)) < 0.2, NEG,
                 rng.integers(-5, 1000, (actors, lcap, seqs))),
        rng.integers(0, 50, (actors, lcap, seqs)),
        rng.integers(1, 6, (actors, lcap, seqs)),
    ], axis=-1).astype(np.int32)
    ncells = rng.integers(0, seqs + 1, (actors, lcap)).astype(np.int32)
    cleared = rng.random((actors, lcap)) < 0.15
    head = rng.integers(0, 4 * lcap, actors).astype(np.int32)
    hlc = rng.integers(-10, 1 << 30, (actors, lcap)).astype(np.int32)
    return cells, ncells, cleared, head, hlc


def _schedule(rng, n, kprime, actors, lcap, cap, halved):
    topa = rng.integers(0, actors, (n, kprime)).astype(np.int32)
    if halved:
        # per-lane caps of a connection's halved chunk size (rtt rings)
        lane_cap = cap >> rng.integers(0, 4, (n, kprime))
        take = np.minimum(rng.integers(0, cap + 1, (n, kprime)),
                          np.maximum(lane_cap, 1))
    else:
        take = rng.integers(0, cap + 1, (n, kprime))
    take = np.where(rng.random((n, kprime)) < 0.3, 0, take)
    take[rng.random(n) < 0.1] = 0  # nodes served nothing
    base = rng.integers(0, 3 * lcap, (n, kprime))
    win = rng.integers(0, 1 << 32, (n, kprime), dtype=np.int64)
    return topa, take.astype(np.int32), base.astype(np.int32), win


SHAPES = [
    # (n, K', cap, S, bpv, halved)
    (512, 512, 16, 1, 1, False),  # catch-up's lane shape: 8192 a node
    (1000, 128, 1, 1, 1, False),  # the north star's: 128 a node
    (300, 3, 5, 1, 1, False),  # 15 lanes padded to 128
    (256, 64, 20, 2, 2, False),  # S 2, 2 chunks a version, past vwin 16
    (512, 512, 16, 1, 1, True),  # rtt-halved caps
    (128, 40, 12, 4, 4, False),  # S 4, vwin 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,kprime,cap,s,bpv,halved", SHAPES)
def test_serve_kernel_equals_the_torch_lanes(dev, n, kprime, cap, s, bpv,
                                             halved):
    rng = np.random.default_rng(n + kprime + cap + s + bpv + int(halved))
    actors, lcap, rows, cols = 700, 64, 128, 2
    cells, ncells, cleared, head, hlc = _log(rng, actors, lcap, s, rows,
                                             cols)
    topa, take, base, win = _schedule(rng, n, kprime, actors, lcap, cap,
                                      halved)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    log = ChangeLog(cells=t(cells), ncells=t(ncells),
                    live=t(ncells), cleared=t(cleared), head=t(head))
    args = (t(topa), t(take), t(base), t(win), log, t(hlc), cap, cols, bpv)
    want_box, want_cap, want_stamp, want_counts = sv.serve_lanes_reference(
        *args)
    before = sv.LAUNCHES["serve_lanes"]
    box, box_cap, stamp, counts = sv.serve_lanes(*args)
    torch.cuda.synchronize()
    assert sv.LAUNCHES["serve_lanes"] == before + 1
    assert box_cap == want_cap == sv.box_capacity(kprime * cap * s)
    live = want_box[mk.LANE_VALID] != 0
    assert int(live.sum()) > 0
    assert torch.equal(box[mk.LANE_VALID], want_box[mk.LANE_VALID])
    for f in range(mk.LANE_FIELDS - 1):
        assert torch.equal(box[f][live], want_box[f][live]), f
    assert torch.equal(stamp, want_stamp)
    assert torch.equal(counts, want_counts)
    assert int(counts[0]) > 0 and int(counts[1]) > 0
    assert int((stamp == NEG).sum()) > 0  # nodes with nothing cleared
    # last_cleared: the kernel's fold against the torch path's scatter
    lc = t(rng.integers(-(1 << 20), 1 << 30, n).astype(np.int32))
    lanes = sv.served_lanes(log, *args[:4], torch.arange(
        n, dtype=torch.int32, device=dev), cap, bpv)
    want_lc = scatter_max(lc, (lanes.dst,), t(hlc)[
        lanes.g_actor.long(), lanes.g_slot.long()],
        lanes.valid & lanes.cleared)
    assert torch.equal(torch.maximum(lc, stamp), want_lc)


@pytest.mark.cuda
def test_serve_kernel_with_nothing_served(dev):
    rng = np.random.default_rng(3)
    cells, ncells, cleared, head, hlc = _log(rng, 64, 32, 1, 64, 2)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    log = ChangeLog(cells=t(cells), ncells=t(ncells), live=t(ncells),
                    cleared=t(cleared), head=t(head))
    topa, _take, base, win = _schedule(rng, 64, 16, 64, 32, 4, False)
    take = np.zeros_like(topa)
    box, _cap, stamp, counts = sv.serve_lanes(
        t(topa), t(take), t(base), t(win), log, t(hlc), 4, 2, 1)
    torch.cuda.synchronize()
    # only the live row is written where nothing is live
    assert int(box[mk.LANE_VALID].abs().sum()) == 0
    assert bool((stamp == NEG).all())
    assert counts.tolist() == [0, 0]


@pytest.mark.cuda
def test_serve_kernel_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(4)
    cells, ncells, cleared, head, hlc = _log(rng, 64, 32, 1, 64, 2)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    log = ChangeLog(cells=t(cells), ncells=t(ncells), live=t(ncells),
                    cleared=t(cleared), head=t(head))
    topa, take, base, win = (t(x) for x in _schedule(
        rng, 64, 16, 64, 32, 4, False))
    with pytest.raises(ValueError, match="win_k"):
        sv.serve_lanes(topa, take, base, win.to(torch.int32), log, t(hlc),
                       4, 2, 1)
    with pytest.raises(ValueError, match="topa"):
        sv.serve_lanes(topa[:, ::2], take, base, win, log, t(hlc), 4, 2, 1)
    with pytest.raises(ValueError, match="cleared_hlc"):
        sv.serve_lanes(topa, take, base, win, log, t(hlc)[:32], 4, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["config5", "north_star"])
def test_sync_runs_on_the_kernel_equal_the_torch_path(dev, monkeypatch,
                                                      which):
    """Whole runs, kernel against torch serve path on the same card: the
    merged table, the book, every other leaf and every per-round metric,
    over the sweeps of 40 rounds; the kernel serves each sweep."""
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.profile_slice import (
        config5_config,
        config5_schedule,
        slice_config,
    )
    from corro_sim_torch.sync import sync as sync_mod
    from corro_sim_torch.utils.metrics import SYNC_SERVE_TOTAL, counters

    if which == "config5":
        cfg, sched = config5_config(1024), config5_schedule(1024)
    else:
        cfg, sched = slice_config(1024), Schedule(write_rounds=16)

    def run():
        st = init_state(cfg, seed=5, device=dev)
        return run_sim(cfg, st, sched, max_rounds=40, chunk=8, seed=5,
                       stop_on_convergence=False, device=dev)

    kernel = '{path="kernel"}'
    k0, l0 = counters.get(SYNC_SERVE_TOTAL, kernel), sv.LAUNCHES[
        "serve_lanes"]
    got = run()
    sweeps = int(got.state.sync_rounds)
    assert sweeps > 0
    assert counters.get(SYNC_SERVE_TOTAL, kernel) - k0 == sweeps
    assert sv.LAUNCHES["serve_lanes"] - l0 == sweeps
    monkeypatch.setattr(sync_mod, "serve_path", lambda *a: "torch")
    want = run()
    assert sv.LAUNCHES["serve_lanes"] - l0 == sweeps
    a, b = state_to_numpy(got.state), state_to_numpy(want.state)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got.metrics.keys() == want.metrics.keys()
    for k in got.metrics:
        np.testing.assert_array_equal(got.metrics[k], want.metrics[k],
                                      err_msg=k)
    assert int(np.sum(got.metrics["sync_cells"])) > 0
