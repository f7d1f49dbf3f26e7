"""The sync sweep's serve step on the CPU: which path a sweep takes, the
counter that says so, and the plain version the CUDA kernel is held to.

The kernel itself runs only on the card (tests/test_torch_serve_cuda.py);
here the choice is checked by device and by what the inputs show, the
counter ``corro_sync_serve_total{path}`` once per sweep, and the fold the
kernel path relies on (the per-node stamp maxima into ``last_cleared``)
against the torch path's scatter
(:func:`~corro_sim_torch.sync.serve.fold_served`), and the kernel's byte
bound (:func:`~corro_sim_torch.sync.serve.serve_work`). Inputs come from
a seeded numpy generator; tolerance: exact (integer arithmetic). The
file imports no JAX.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from corro_sim_torch.config import SimConfig
from corro_sim_torch.core.changelog import ChangeLog, make_changelog
from corro_sim_torch.core.crdt import NEG
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.sharding import Mesh
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.sync import serve as sv
from corro_sim_torch.utils.metrics import SYNC_SERVE_TOTAL, counters
from corro_sim_torch.utils.sort import scatter_max


def _cfg(**kw):
    base = dict(
        num_nodes=32, num_rows=32, num_cols=4, log_capacity=64,
        write_rate=0.5, swim_enabled=False, sync_interval=2, fanout=2,
        sync_actor_topk=8, sync_cap_per_actor=2, sync_req_actors=16,
        sync_peers=4,
    )
    return SimConfig(**{**base, **kw})


def _mesh(shards):
    """A placement mesh of ``shards`` ranks on the "nodes" axis (no
    process group: :func:`serve_path` reads only its shape)."""
    return Mesh(("nodes",), {"nodes": shards}, None, None, "cpu")


@pytest.mark.parametrize("device,merge_kernel,sharded,shards,want", [
    ("cpu", "auto", False, 0, "torch"),  # CPU tensors
    ("cpu", "on", False, 0, "torch"),  # the mailbox on the CPU: plain lanes
    ("cuda", "off", False, 0, "torch"),  # the scatter merge
    ("cuda", "auto", True, 4, "torch"),  # an actor-sharded mesh log
    ("cuda", "on", True, 4, "torch"),
    ("cuda", "auto", False, 4, "torch"),  # whole log, nodes on 4 ranks
    ("cuda", "on", False, 2, "torch"),
    ("cuda", "auto", False, 1, "kernel"),  # a mesh of one shard
    ("cuda", "auto", False, 0, "kernel"),
    ("cuda", "on", False, 0, "kernel"),
])
def test_serve_path_by_device_and_inputs(device, merge_kernel, sharded,
                                         shards, want):
    cfg = _cfg(merge_kernel=merge_kernel)
    log = make_changelog(32, 8, 1, "cpu", rows=8 if sharded else None)
    mesh = _mesh(shards) if shards else None
    assert sv.serve_path(cfg, log, device, mesh) == want


def test_serve_path_needs_the_mailbox_cell_space():
    # 32 x 3 cells: no multiple of 128, so no mailbox merge at all
    cfg = _cfg(num_cols=3, merge_kernel="on")
    log = make_changelog(32, 8, 1, "cpu")
    assert sv.serve_path(cfg, log, "cuda") == "torch"


@pytest.mark.parametrize("kprime,cap,seqs,want", [
    (512, 16, 1, 8192), (128, 1, 1, 128), (3, 5, 1, 128), (64, 20, 2, 2560),
    (40, 12, 4, 1920), (1, 1, 1, 128),
])
def test_box_capacity_pads_to_128(kprime, cap, seqs, want):
    assert sv.box_capacity(kprime * cap * seqs) == want


@pytest.mark.parametrize("merge_kernel", ["auto", "on", "off"])
def test_serve_counter_counts_each_sweep_on_the_torch_path(merge_kernel):
    cfg = _cfg(merge_kernel=merge_kernel)
    torch_lbl, kernel_lbl = '{path="torch"}', '{path="kernel"}'
    t0 = counters.get(SYNC_SERVE_TOTAL, torch_lbl)
    k0 = counters.get(SYNC_SERVE_TOTAL, kernel_lbl)
    res = run_sim(cfg, init_state(cfg, seed=1, device="cpu"),
                  Schedule(write_rounds=4), max_rounds=16, chunk=8, seed=1,
                  stop_on_convergence=False, device="cpu")
    sweeps = int(res.state.sync_rounds)
    assert sweeps > 0
    assert counters.get(SYNC_SERVE_TOTAL, torch_lbl) - t0 == sweeps
    assert counters.get(SYNC_SERVE_TOTAL, kernel_lbl) == k0


def _inputs(seed, n=24, kprime=6, cap=5, seqs=2, actors=40, lcap=16):
    rng = np.random.default_rng(seed)
    cells = np.stack([
        rng.integers(0, 32, (actors, lcap, seqs)),
        rng.integers(0, 4, (actors, lcap, seqs)),
        np.where(rng.random((actors, lcap, seqs)) < 0.2, NEG,
                 rng.integers(0, 100, (actors, lcap, seqs))),
        rng.integers(0, 9, (actors, lcap, seqs)),
        rng.integers(1, 4, (actors, lcap, seqs)),
    ], axis=-1).astype(np.int32)
    log = ChangeLog(
        cells=torch.as_tensor(cells),
        ncells=torch.as_tensor(rng.integers(0, seqs + 1, (actors, lcap))
                               .astype(np.int32)),
        live=torch.zeros((actors, lcap), dtype=torch.int32),
        cleared=torch.as_tensor(rng.random((actors, lcap)) < 0.3),
        head=torch.as_tensor(rng.integers(0, 40, actors).astype(np.int32)),
    )
    take = rng.integers(0, cap + 1, (n, kprime))
    take[: n // 4] = 0
    sched = types.SimpleNamespace(
        topa=torch.as_tensor(rng.integers(0, actors, (n, kprime))
                             .astype(np.int32)),
        take=torch.as_tensor(take.astype(np.int32)),
        base=torch.as_tensor(rng.integers(0, 3 * lcap, (n, kprime))
                             .astype(np.int32)),
        win=torch.as_tensor(rng.integers(0, 1 << 32, (n, kprime),
                                         dtype=np.int64)),
        hlc=torch.as_tensor(rng.integers(0, 1 << 20, (actors, lcap))
                            .astype(np.int32)),
    )
    return log, sched


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stamp_fold_equals_the_scatter(seed):
    """The kernel path raises ``last_cleared`` by the per-node maxima of
    the reference; the torch path scatters every lane. Equal."""
    log, sc = _inputs(seed)
    n = sc.topa.shape[0]
    args = (sc.topa, sc.take, sc.base, sc.win, log, sc.hlc, 5, 4, 2)
    _box, _cap, stamp, counts = sv.serve_lanes_reference(*args)
    lanes = sv.served_lanes(log, sc.topa, sc.take, sc.base, sc.win,
                            torch.arange(n, dtype=torch.int32), 5, 2)
    emptied = lanes.valid & lanes.cleared
    lc = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 1 << 20, n).astype(np.int32))
    want = scatter_max(lc, (lanes.dst,), sc.hlc[lanes.g_actor.long(),
                                                lanes.g_slot.long()], emptied)
    assert torch.equal(torch.maximum(lc, stamp), want)
    assert int(emptied.sum()) == int(counts[0]) > 0
    assert int(lanes.shipped.sum()) == int(counts[1]) > 0
    assert bool((stamp[: n // 4] == NEG).all())  # nodes served nothing


def test_reference_mailbox_rows_of_live_lanes():
    """The mailbox's live lanes carry the log's cells of the served
    version, the site rule (NEG for a delete, else the actor) and the
    padding of every node's lanes to the box capacity."""
    log, sc = _inputs(11)
    n, kprime = sc.topa.shape
    cap, seqs, cols = 5, 2, 4
    box, box_cap, _stamp, _counts = sv.serve_lanes_reference(
        sc.topa, sc.take, sc.base, sc.win, log, sc.hlc, cap, cols, 2)
    box = box.view(6, n, box_cap)
    lanes = kprime * cap * seqs
    assert int(box[:, :, lanes:].abs().sum()) == 0
    live = box[5, :, :lanes].reshape(n, kprime, cap, seqs)
    i, k, o, q = (x for x in torch.nonzero(live, as_tuple=True))
    assert i.numel() > 0
    a = sc.topa[i, k].long()
    slot = ((sc.base[i, k] + o) % log.capacity).long()
    c = log.cells[a, slot, q]
    j = ((k * cap + o) * seqs + q)
    assert bool((o < sc.take[i, k]).all())
    assert not bool(log.cleared[a, slot].any())
    assert torch.equal(box[0, i, j], c[:, 0] * cols + c[:, 1])
    assert torch.equal(box[1, i, j], c[:, 3])
    assert torch.equal(box[2, i, j], c[:, 2])
    assert torch.equal(box[3, i, j], torch.where(c[:, 2] == NEG, NEG,
                                                 a.to(torch.int32)))
    assert torch.equal(box[4, i, j], c[:, 4])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_serve_lanes_refuses_a_device_without_a_kernel(device):
    """The kernel has no CPU mode: the sweep sends CPU tensors to the
    torch path, and :func:`serve_lanes` refuses them."""
    log, sc = _inputs(5)
    on = dataclasses.replace(
        log, cells=log.cells.to(device), ncells=log.ncells.to(device),
        cleared=log.cleared.to(device), head=log.head.to(device))
    with pytest.raises(ValueError, match="no kernel"):
        sv.serve_lanes(sc.topa.to(device), sc.take.to(device),
                       sc.base.to(device), sc.win.to(device), on,
                       sc.hlc.to(device), 5, 4, 2)


@pytest.mark.parametrize("seed", [3, 4])
def test_fold_served_is_the_reference_fold(seed):
    """The torch path's fold into a whole ``last_cleared`` equals the
    kernel path's: the reference's per-node maxima folded in with
    ``torch.maximum``, and the same two counts."""
    log, sc = _inputs(seed)
    n = sc.topa.shape[0]
    args = (sc.topa, sc.take, sc.base, sc.win, log, sc.hlc, 5, 4, 2)
    _box, _cap, stamp, counts = sv.serve_lanes_reference(*args)
    lanes = sv.served_lanes(log, sc.topa, sc.take, sc.base, sc.win,
                            torch.arange(n, dtype=torch.int32), 5, 2)
    lc = torch.as_tensor(np.random.default_rng(seed).integers(
        -(1 << 20), 1 << 20, n).astype(np.int32))
    got, emptied, shipped = sv.fold_served(
        lanes, sc.hlc[lanes.g_actor.long(), lanes.g_slot.long()], lc)
    assert torch.equal(got, torch.maximum(lc, stamp))
    assert [int(emptied), int(shipped)] == counts.tolist()


@pytest.mark.parametrize("seed", [0, 9])
def test_serve_work_counts_each_word_once(seed):
    """The serve kernel's byte bound from its inputs, against a count
    lane by lane: every lane's live word, five more words and a 20-byte
    cell for each live lane, the schedule words of each request that
    serves a version, and 1 + 4 bytes for each version served."""
    log, sc = _inputs(seed)
    n, kprime = sc.topa.shape
    cap, seqs = 5, log.seqs
    nbytes, counts = sv.serve_work(sc.topa, sc.take, sc.base, log, cap)
    req = ver = clr = live = 0
    for i in range(n):
        for k in range(kprime):
            take = int(sc.take[i, k])
            req += take > 0
            a = int(sc.topa[i, k])
            for o in range(take):
                slot = (int(sc.base[i, k]) + o) % log.capacity
                ver += 1
                if bool(log.cleared[a, slot]):
                    clr += 1
                else:
                    live += min(int(log.ncells[a, slot]), seqs)
    assert counts == {"requests": req, "versions": ver, "cleared": clr,
                      "live_lanes": live}
    assert 0 < clr < ver and live > 0
    box_cap = sv.box_capacity(kprime * cap * seqs)
    assert nbytes == (4 * n * box_cap + 40 * live + 4 * n * kprime
                      + 16 * req + 5 * ver)
