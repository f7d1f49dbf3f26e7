"""The sync sweep's serve step: from the (N, K') schedule to the filled
mailbox, the per-node cleared stamp and the lane counts.

Two versions of one function:

- :func:`served_lanes`, :func:`node_major_box` and :func:`fold_served`,
  plain PyTorch: every served (node, request, version, seq) lane as a
  flat plane, gathered from the change log, then reshaped into the
  node-major ``(6, nl * box_cap)`` mailbox, with the lanes' cleared
  stamps scattered into their nodes and the lanes counted. This is the
  torch serve path of :func:`~corro_sim_torch.sync.sync.sync_round`
  (CPU tensors, the scatter merge, a sharded mesh) and, through
  :func:`serve_lanes_reference`, the kernel's oracle.
- :func:`serve_lanes`, the hand-written CUDA kernel
  (``csrc/serve_kernel.cu``), which computes each lane in registers and
  writes nothing of lane size but the mailbox.

:func:`serve_path` makes the sweep's choice, by device and by what the
inputs show: the kernel on CUDA planes on the mailbox path with a whole
log and a mesh of one shard at most. The library is built like the merge
kernel's (:func:`~corro_sim_torch.core.merge_kernel.build_library`: nvcc
for ``sm_90a``, a plain C interface, ``ctypes``, cached by the source's
hash).
"""

from __future__ import annotations

import ctypes
import types
from pathlib import Path

import torch

from corro_sim_torch.core.changelog import fetch_changesets, gather_changesets
from corro_sim_torch.core.crdt import NEG
from corro_sim_torch.core.merge_kernel import (
    BUILD_DIR,
    LANE_FIELDS,
    build_library,
    kernel_supported,
)
from corro_sim_torch.utils.bits import WINDOW_BITS
from corro_sim_torch.utils.compile_cache import fetch_library
from corro_sim_torch.utils.sort import scatter_max

KERNEL_SOURCE = Path(__file__).with_name("csrc") / "serve_kernel.cu"

# kernel launches; chip_smoke.py reads and zeroes it at each phase line
LAUNCHES = {"serve_lanes": 0}

_lib = None


def serve_path(cfg, log, device, mesh=None) -> str:
    """``"kernel"`` where the sweep serves its lanes with
    :func:`serve_lanes`: CUDA planes, the mailbox merge
    (``kernel_supported``), a whole log (every actor's rows on this rank)
    and no more than one shard of nodes. ``"torch"`` otherwise: CPU
    tensors, the scatter merge, an actor-sharded log, or a mesh whose
    nodes lie on several ranks (their cleared stamps are fetched from
    their owners lane by lane)."""
    dev = torch.device(device)
    whole = log.cells.shape[0] == log.head.shape[0]
    one_shard = mesh is None or mesh.nodes == 1
    if (dev.type == "cuda" and whole and one_shard
            and kernel_supported(cfg, "sync", dev)):
        return "kernel"
    return "torch"


def box_capacity(lanes: int) -> int:
    """Mailbox lanes per node for ``lanes`` served lanes a node (``K' *
    cap * S``): padded to a multiple of 128."""
    return lanes + (-lanes) % 128


def served_lanes(log, topa, take, base, win_k, rows, cap: int, bpv: int,
                 mesh=None):
    """The served lanes as flat planes, (N, K', cap) lanes of S cells:
    versions ``base + 1 .. base + take`` of actor ``topa`` for each
    request lane of node ``rows``. ``topa``, ``take``, ``base`` (the
    node's head of the actor) and ``win_k`` (its window) are (N, K').

    ``mesh`` with an actor-sharded log: the served versions come from
    their owners. Returns a namespace of ``dst``, ``valid``, ``g_actor``,
    ``g_slot`` (m,), ``row``, ``col``, ``vr``, ``cv``,
    ``cl``, ``live``, ``site`` and ``shipped`` (m, S), and ``cleared``
    (m,)."""
    dev = topa.device
    s = log.seqs
    offs = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
    vwin = WINDOW_BITS // bpv
    ver = base[:, :, None] + offs[None, None, :]
    lane_valid = offs[None, None, :] <= take[:, :, None]

    actor_l = topa[:, :, None].expand(ver.shape).reshape(-1)
    ver_l = ver.reshape(-1)
    valid_l = lane_valid.reshape(-1)
    dst_l = rows[:, None, None].expand(ver.shape).reshape(-1)

    g_actor_l = torch.where(valid_l, actor_l, 0)
    g_slot_l = (torch.clamp(ver_l, min=1) - 1) % log.capacity
    if mesh is not None and log.cells.shape[0] != log.head.shape[0]:
        # actor-sharded log: the served versions come from their owners
        row, col, vr, cv, cl, ncells, cleared_l = fetch_changesets(
            log, mesh, g_actor_l, torch.clamp(ver_l, min=1))
    else:
        row, col, vr, cv, cl, ncells = gather_changesets(
            log, g_actor_l, torch.clamp(ver_l, min=1)
        )
        # cleared versions are served as empties (api/peer.rs:716-758)
        cleared_l = log.cleared[g_actor_l.long(), g_slot_l.long()]
    m = dst_l.shape[0]
    seq = torch.arange(s, dtype=torch.int32, device=dev)
    cell_live = (
        valid_l[:, None] & ~cleared_l[:, None] & (seq[None, :] < ncells[:, None])
    )
    site_l = torch.where(vr == NEG, NEG, actor_l[:, None].expand(m, s))

    # seq-granular partial serving (SyncNeedV1::Partial): cells whose
    # chunk the receiver already buffered via gossip do not ship, while
    # the merge applies the whole changeset. Served versions are base +
    # o, so the window offset of version o is o - 1.
    chunk_of_seq = torch.arange(s, dtype=torch.int64, device=dev) * bpv // s
    voff_o = (offs - 1).clamp(0, vwin - 1).long()
    bit_off = voff_o[:, None] * bpv + chunk_of_seq[None, :]  # (cap, S)
    buffered = (
        ((win_k[:, :, None, None] >> bit_off[None, None]) & 1) != 0
    ) & ((offs - 1) < vwin)[None, None, :, None]  # (N, K', cap, S)
    shipped = cell_live & ~buffered.reshape(m, s)
    return types.SimpleNamespace(
        dst=dst_l, valid=valid_l, g_actor=g_actor_l,
        g_slot=g_slot_l, row=row, col=col, vr=vr, cv=cv, cl=cl,
        live=cell_live, site=site_l, cleared=cleared_l, shipped=shipped,
    )


def node_major_box(lanes, nl: int, num_cols: int):
    """``(box, box_cap)``: the lanes of :func:`served_lanes` as the
    node-major ``(6, nl * box_cap)`` mailbox. Sync lanes are node-major
    by construction, so the mailbox is a reshape plus pad, no routing
    scatter."""
    lanes_per_node = lanes.live.numel() // nl
    box_cap = box_capacity(lanes_per_node)

    def node_major(x):
        v = x.reshape(nl, lanes_per_node).to(torch.int32)
        if box_cap > lanes_per_node:
            v = torch.nn.functional.pad(v, (0, box_cap - lanes_per_node))
        return v.reshape(-1)

    box = torch.stack([
        node_major(lanes.row * num_cols + lanes.col), node_major(lanes.cv),
        node_major(lanes.vr), node_major(lanes.site), node_major(lanes.cl),
        node_major(lanes.live),
    ])
    return box, box_cap


def fold_served(lanes, stamp, last_cleared):
    """The torch path's stamp and counts of the :func:`served_lanes`:
    ``last_cleared`` raised at each lane's node ``dst`` by the cleared
    stamp ``stamp`` (m,) of every valid, cleared lane, and the
    ``emptied`` (those lanes) and ``shipped`` (cells not yet buffered)
    counts. Returns ``(last_cleared, emptied, shipped)``."""
    emptied = lanes.valid & lanes.cleared
    last_cleared = scatter_max(last_cleared, (lanes.dst,), stamp, emptied)
    return (last_cleared, emptied.sum(dtype=torch.int32),
            lanes.shipped.sum(dtype=torch.int32))


def serve_lanes_reference(topa, take, base, win_k, log, cleared_hlc,
                          cap: int, num_cols: int, bpv: int):
    """The kernel's plain version: :func:`served_lanes`,
    :func:`node_major_box` and :func:`fold_served` on a whole log, on any
    device. Returns ``(box, box_cap, row_stamp, counts)``: the mailbox,
    the per-node maximum of the cleared stamps of the valid, cleared
    lanes (``INT_MIN`` where none) and the ``(emptied, shipped)``
    counts."""
    nl = topa.shape[0]
    dev = topa.device
    rows = torch.arange(nl, dtype=torch.int32, device=dev)
    lanes = served_lanes(log, topa, take, base, win_k, rows, cap, bpv)
    box, box_cap = node_major_box(lanes, nl, num_cols)
    row_stamp, emptied, shipped = fold_served(
        lanes, cleared_hlc[lanes.g_actor.long(), lanes.g_slot.long()],
        torch.full((nl,), NEG, dtype=torch.int32, device=dev))
    return box, box_cap, row_stamp, torch.stack([emptied, shipped])


def serve_work(topa, take, base, log, cap: int) -> tuple:
    """The least bytes a :func:`serve_lanes` call moves on these inputs,
    each word read or written once: the mailbox's live word of every lane
    (``box_cap`` a node) and its other five words of each live lane;
    ``take`` of every request and ``topa``, ``base`` and ``win_k`` of
    each request that serves a version; of each served version its
    cleared byte, then its stamp where cleared or its ``ncells`` where
    not; the 20-byte cell of each live lane. Returns ``(bytes, counts)``,
    ``counts`` the requests, versions, cleared versions and live lanes
    the bytes were counted from."""
    nl, kp = topa.shape
    s = log.seqs
    offs = torch.arange(cap, dtype=torch.int32, device=topa.device)
    valid = offs[None, None, :] < take[:, :, None]  # (nl, K', cap)
    slot = ((base[:, :, None] + offs[None, None, :]) % log.capacity).long()
    actor = topa.long()[:, :, None].expand_as(slot)
    cleared = log.cleared[actor, slot] & valid
    served = valid & ~cleared
    live = torch.where(served, log.ncells[actor, slot], 0).clamp(0, s)
    counts = {
        "requests": int((take > 0).sum()),
        "versions": int(valid.sum()),
        "cleared": int(cleared.sum()),
        "live_lanes": int(live.sum()),
    }
    box_cap = box_capacity(kp * cap * s)
    nbytes = (4 * nl * box_cap + 20 * counts["live_lanes"]  # the mailbox
              + 4 * nl * kp + 16 * counts["requests"]  # the schedule
              + 5 * counts["versions"] + 20 * counts["live_lanes"])  # log
    return nbytes, counts


def build_serve_kernel(probe=None) -> ctypes.CDLL:
    """Compile (once per source hash) and load the serve kernel library;
    ``probe`` as :func:`~corro_sim_torch.core.merge_kernel.build_kernel`'s."""
    global _lib
    if _lib is not None and probe is None:
        return _lib
    if probe is not None:
        probe.begin()
    if _lib is not None:
        info = fetch_library(KERNEL_SOURCE, "serve_kernel", None, BUILD_DIR,
                             loaded=True)
    else:
        lib, info = build_library(KERNEL_SOURCE, "serve_kernel")
        lib.serve_lanes_launch.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.serve_lanes_launch.restype = ctypes.c_int
        _lib = lib
    if probe is not None:
        probe.end("serve_kernel", info["seconds"])
    return _lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"serve_lanes: {name} must be {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"serve_lanes: {name} must be contiguous")


def serve_lanes(topa, take, base, win_k, log, cleared_hlc, cap: int,
                num_cols: int, bpv: int):
    """The sweep's serve step on a whole log: ``(box, box_cap, row_stamp,
    counts)`` as :func:`serve_lanes_reference` gives them. ``topa``,
    ``take``, ``base`` int32 and ``win_k`` int64 are (nl, K'); the log's
    planes and ``cleared_hlc`` cover every actor.

    The kernel runs on CUDA tensors only, on the current stream, with no
    host read. The mailbox's live row is written for every lane; its
    other rows only for live lanes, and hold whatever the allocation held
    elsewhere (the merge reads a lane's fields only where its live word
    is set)."""
    nl, kprime = topa.shape
    a, lcap, s = log.cells.shape[:3]
    if topa.device.type != "cuda":
        raise ValueError(f"serve_lanes: no kernel for {topa.device}")
    for name, t in (("topa", topa), ("take", take), ("base", base)):
        _check(name, t, torch.int32, (nl, kprime))
    _check("win_k", win_k, torch.int64, (nl, kprime))
    _check("log.cells", log.cells, torch.int32, (a, lcap, s, 5))
    _check("log.ncells", log.ncells, torch.int32, (a, lcap))
    _check("log.cleared", log.cleared, torch.bool, (a, lcap))
    _check("cleared_hlc", cleared_hlc, torch.int32, (a, lcap))
    ins = (topa, take, base, win_k, log.cells, log.ncells, log.cleared,
           cleared_hlc)
    devices = {t.device for t in ins}
    if len(devices) != 1:
        raise ValueError(f"serve_lanes: operands on {devices}")
    box_cap = box_capacity(kprime * cap * s)
    dev = topa.device
    box = torch.empty((LANE_FIELDS, nl * box_cap), dtype=torch.int32,
                      device=dev)
    row_stamp = torch.empty((nl,), dtype=torch.int32, device=dev)
    counts = torch.zeros((2,), dtype=torch.int32, device=dev)
    lib = build_serve_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.serve_lanes_launch(
            *(t.data_ptr() for t in ins), box.data_ptr(),
            row_stamp.data_ptr(), counts.data_ptr(), nl, kprime, cap, s,
            lcap, bpv, WINDOW_BITS // bpv, num_cols, box_cap, stream)
    if err != 0:
        raise RuntimeError(f"serve_lanes: CUDA launch failed (error {err})")
    LAUNCHES["serve_lanes"] += 1
    return box, box_cap, row_stamp, counts
