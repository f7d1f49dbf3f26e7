"""Dst-grouped CRDT cell merge: the hand-written CUDA kernel and its
plain PyTorch version.

Port of ``corro_sim/core/merge_kernel.py``. Lanes grouped by destination
node live in a dense per-node mailbox — ``(6, N * cap)`` int32, node
``n``'s lanes at columns ``[n*cap, (n+1)*cap)``, rows cell, cv, vr, site,
cl, valid (the JAX package's two pad rows exist only for the TPU's
sublane tiling and are dropped) — and merge into the table planes: cv,
vr and site flat ``(N, cells)``, cl ``(N, rows)``. :func:`grouped_merge`
launches ``csrc/merge_kernel.cu`` (one warp per node, the rows and
cells the lanes hit numbered in memory order through shared bitmaps,
atomicMax passes, in place; a mailbox larger than a warp's share of
shared memory is merged tile by tile in lane order,
:func:`merge_tile`) on CUDA tensors and runs
:func:`grouped_merge_reference`, which is
:func:`corro_sim_torch.core.crdt.apply_cell_changes` on the unpacked
mailbox, on CPU tensors. The choice is made by device; a CUDA tensor
never falls back to the plain version.

The merge consumes its planes: on both devices :func:`grouped_merge`
writes the merged values into the tensors it was given and returns
them (on the CPU by copying the plain version's result back), so a
caller must not read the pre-merge planes afterwards.
:func:`grouped_merge_reference` stays functional; it is the oracle.

:func:`merge_work` counts the least bytes and operations the in-place
merge needs on given inputs — the kernel's bound —,
:func:`merge_sector_bytes` the same words in whole DRAM sectors, and
:func:`merge_work_out_of_place` the out-of-place count it replaced.

Build (:func:`build_library`): at first use the kernel is compiled from
the package's own source with ``nvcc -O3 -gencode
arch=compute_90a,code=sm_90a`` into a shared library with a plain C
interface under ``corro_sim_torch/_build/`` (named by the source's
hash and the nvcc flags, ``utils/compile_cache.py``, so an edited source
rebuilds) and loaded with ``ctypes``; a failed build raises with nvcc's
output. :func:`build_kernel` takes a
:class:`~corro_sim_torch.utils.compile_cache.CompileCacheProbe`, which
counts the lookup as a hit or a miss.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

from corro_sim_torch.core.crdt import NEG, TableState, apply_cell_changes
from corro_sim_torch.utils.slots import ranks_within_group_masked
from corro_sim_torch.utils.compile_cache import (
    NVCC_FLAGS,
    cache_dir,
    fetch_library,
)

# lane field rows of the packed (6, N*cap) mailbox tensor
LANE_CELL, LANE_CV, LANE_VR, LANE_SITE, LANE_CL, LANE_VALID = range(6)
LANE_FIELDS = 6

KERNEL_SOURCE = Path(__file__).with_name("csrc") / "merge_kernel.cu"
BUILD_DIR = Path(cache_dir())

# the card's peaks the bound is priced at: H100 SXM HBM3 (NVIDIA data
# sheet) and non-tensor INT32 (NVIDIA Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

# kernel launches by wrapper name; chip_smoke.py zeroes and reads these
# around the main path to show it went through the kernel
LAUNCHES = {"grouped_merge": 0}
# of those launches, the ones each mesh merge site made (on CUDA planes)
MESH_SITE_LAUNCHES = {"route_merge_sharded": 0, "merge_grouped_mesh": 0}

_lib = None
BUILD_INFO: dict = {}
_SMEM_LIMIT: dict = {}  # device index -> dynamic shared memory opted in


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in MESH_SITE_LAUNCHES:
        MESH_SITE_LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(source: Path, stem: str):
    """Compile ``source`` with nvcc for ``sm_90a`` into a shared library
    with a plain C interface under :data:`BUILD_DIR` (named by the
    source's hash and the flags, so an edited source rebuilds) and load
    it. Returns ``(library, info)``, ``info`` being
    :func:`~corro_sim_torch.utils.compile_cache.fetch_library`'s: the
    path, hit or miss, the seconds the build took and nvcc's output
    (``-Xptxas -v``: registers, spills)."""

    def nvcc(tmp: Path) -> str:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source}:\n{log}"
            )
        return log

    info = fetch_library(source, stem, nvcc, BUILD_DIR)
    return ctypes.CDLL(info["library"]), info


def build_kernel(probe=None) -> ctypes.CDLL:
    """Compile (once per source hash) and load the merge kernel library.
    ``probe``: a :class:`~corro_sim_torch.utils.compile_cache.
    CompileCacheProbe` that counts this lookup (already loaded or on
    disk: a hit; built: a miss with nvcc's seconds)."""
    global _lib
    if _lib is not None and probe is None:
        return _lib
    if probe is not None:
        probe.begin()
    if _lib is not None:  # loaded: only the lookup is counted
        info = fetch_library(KERNEL_SOURCE, "merge_kernel", None, BUILD_DIR,
                             loaded=True)
    else:
        lib, info = build_library(KERNEL_SOURCE, "merge_kernel")
        lib.grouped_merge_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.grouped_merge_launch.restype = ctypes.c_int
        lib.grouped_merge_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.grouped_merge_smem_bytes.restype = ctypes.c_size_t
        lib.grouped_merge_tile.argtypes = [ctypes.c_int] * 3
        lib.grouped_merge_tile.restype = ctypes.c_int
        lib.grouped_merge_init.argtypes = []
        lib.grouped_merge_init.restype = ctypes.c_longlong
        BUILD_INFO.update(info)
        _lib = lib
    if probe is not None:
        probe.end("merge_kernel", info["seconds"])
    return _lib


def _smem_limit(lib, device: torch.device) -> int:
    """Opt the kernel's instances in to the device's largest per-block
    dynamic shared memory, once per device; returns that size in bytes."""
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    if idx not in _SMEM_LIMIT:
        with torch.cuda.device(idx):
            got = lib.grouped_merge_init()
        if got < 0:
            raise RuntimeError(
                f"grouped_merge: cudaFuncSetAttribute failed (error {-got})"
            )
        _SMEM_LIMIT[idx] = got
    return _SMEM_LIMIT[idx]


def merge_tile(cap: int, cells: int, cols: int, device=None) -> int:
    """Lanes per tile the kernel takes for a ``cap``-lane mailbox over
    ``cells`` cells on ``device`` (default: the current CUDA device):
    ``cap`` itself wherever one warp's share of shared memory holds the
    whole mailbox, else the largest multiple of 128 lanes that fits."""
    lib = build_kernel()
    dev = torch.device("cuda") if device is None else torch.device(device)
    _smem_limit(lib, dev)
    with torch.cuda.device(dev):
        return lib.grouped_merge_tile(cap, cells, cols)


def route_lanes(
    dst: torch.Tensor,  # (M,) destination node per lane
    rank: torch.Tensor,  # (M,) rank of the lane within its dst
    cell: torch.Tensor,  # (M,) row * C + col
    cv: torch.Tensor,
    vr: torch.Tensor,
    site: torch.Tensor,
    cl: torch.Tensor,
    valid: torch.Tensor,  # (M,) bool
    num_nodes: int,
    cap: int,
) -> torch.Tensor:
    """Scatter flat lanes into the dense ``(6, N*cap)`` per-node mailbox
    with one scatter. Lanes with ``rank >= cap`` or ``~valid`` drop."""
    fields = torch.stack([
        cell.to(torch.int32), cv.to(torch.int32), vr.to(torch.int32),
        site.to(torch.int32), cl.to(torch.int32),
        torch.ones_like(cell, dtype=torch.int32),
    ], dim=1)  # (M, 6)
    keep = valid & (rank < cap)
    slots = num_nodes * cap
    pos = torch.where(keep, dst.long() * cap + rank.long(), slots)
    box = torch.zeros((slots + 1, LANE_FIELDS), dtype=torch.int32,
                      device=dst.device)
    box[pos] = fields  # dropped lanes all land in the scratch row
    return box[:slots].T.contiguous()


def grouped_merge_reference(cv, vr, site, cl, lanes, cap: int, cols: int):
    """The kernel's plain version: unpack the mailbox and run
    :func:`apply_cell_changes`. Returns new ``(cv, vr, site, cl)``."""
    n, cells = cv.shape
    rows = cells // cols
    dst = torch.div(
        torch.arange(n * cap, device=cv.device), cap, rounding_mode="floor"
    ).to(torch.int32)
    cell = lanes[LANE_CELL]
    state = TableState(
        cv=cv.reshape(n, rows, cols),
        vr=vr.reshape(n, rows, cols),
        site=site.reshape(n, rows, cols),
        cl=cl,
    )
    out = apply_cell_changes(
        state, dst,
        torch.div(cell, cols, rounding_mode="floor"), cell % cols,
        lanes[LANE_CV], lanes[LANE_VR], lanes[LANE_SITE], lanes[LANE_CL],
        lanes[LANE_VALID] != 0,
    )
    return (
        out.cv.reshape(n, cells), out.vr.reshape(n, cells),
        out.site.reshape(n, cells), out.cl,
    )


def _check(name, t, shape):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"grouped_merge: {name} must be int32 {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"grouped_merge: {name} must be contiguous")


def grouped_merge(cv, vr, site, cl, lanes, cap: int, cols: int):
    """Merge the per-node mailbox into the table planes, in place: ``cv``,
    ``vr``, ``site`` flat ``(N, cells)``, ``cl`` ``(N, rows)``, all
    contiguous.

    CUDA tensors launch the kernel, which updates the planes where they
    lie and allocates nothing, at any ``cap`` (a mailbox larger than a
    warp's share of shared memory is merged tile by tile); CPU tensors run
    :func:`grouped_merge_reference` and copy its result into the planes.
    Returns the planes it was given, ``(cv, vr, site, cl)``."""
    n, cells = cv.shape
    if cells % cols:
        raise ValueError("grouped_merge: cells must be a multiple of cols")
    for name, t in (("cv", cv), ("vr", vr), ("site", site)):
        _check(name, t, (n, cells))
    _check("cl", cl, (n, cells // cols))
    _check("lanes", lanes, (LANE_FIELDS, n * cap))
    devices = {t.device for t in (cv, vr, site, cl, lanes)}
    if len(devices) != 1:
        raise ValueError(f"grouped_merge: operands on {devices}")
    planes = (cv, vr, site, cl)
    if cv.device.type == "cpu":
        merged = grouped_merge_reference(cv, vr, site, cl, lanes, cap, cols)
        for t, m in zip(planes, merged):
            t.copy_(m)
        return planes
    if cv.device.type != "cuda":
        raise ValueError(f"grouped_merge: no kernel for {cv.device}")
    if any(t.data_ptr() % 16 for t in planes):
        raise ValueError("grouped_merge: planes must be 16-byte aligned")
    lib = build_kernel()
    _smem_limit(lib, cv.device)
    with torch.cuda.device(cv.device):
        stream = torch.cuda.current_stream(cv.device).cuda_stream
        err = lib.grouped_merge_launch(
            lanes.data_ptr(), *(t.data_ptr() for t in planes),
            n, cells, cols, cap, stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_merge: CUDA launch failed (error {err})")
    LAUNCHES["grouped_merge"] += 1
    return planes


def merge_grouped(state: TableState, lanes: torch.Tensor, cap: int,
                  mesh=None) -> TableState:
    """:func:`apply_cell_changes` on a dense per-node lane mailbox, via
    :func:`grouped_merge`. Consumes ``state``: its planes are merged in
    place and the returned :class:`TableState` holds the same storage.

    ``mesh``: the sync sweep's form over a device mesh. ``state`` is
    this rank's ``(N/D, R, C)`` shard and ``lanes`` its ``(6, N/D *
    cap)`` slice of the node-major mailbox; the kernel runs on the shard
    with no collective, because sync lanes are built node-major, each
    rank's for its own nodes."""
    n, r, c = state.cv.shape
    flat = [t.view(n, r * c) for t in (state.cv, state.vr, state.site)]
    grouped_merge(*flat, state.cl, lanes, cap, c)
    if mesh is not None and state.cv.device.type == "cuda":
        MESH_SITE_LAUNCHES["merge_grouped_mesh"] += 1
    return TableState(cv=state.cv, vr=state.vr, site=state.site, cl=state.cl)


# the exchange's lane fields: the six mailbox rows, then the global
# destination node and the lane's rank within it
BUCKET_FIELDS = LANE_FIELDS + 2


def route_to_shards(dst, rank, cell, cv, vr, site, cl, valid, cap: int,
                    nl: int, mesh) -> torch.Tensor:
    """Route this rank's slice of flat cell lanes to the shards that own
    their destinations, with one ``all_to_all_single``; returns the
    received lanes as ``(D * m, 8)`` int32 rows (the six mailbox fields,
    then the global ``dst`` and ``rank``), sender by sender.

    Each rank buckets its ``m`` lanes by destination shard (``dst //
    nl``) with a stable sort plus :func:`ranks_within_group_masked`; the
    ``(D, m, 8)`` buckets ride one exchange. Bucket capacity is the
    slice length, so routing drops no lane. Lanes that are invalid or
    past ``cap`` stay home, masked (the JAX package parks them in a drop
    row). A sender's lanes keep their order within each bucket, and
    consecutive ranks hold consecutive slices of the global lane order,
    so concatenating the received buckets in rank order gives each
    shard its lanes in the global order."""
    d = mesh.nodes
    m = dst.shape[0]
    dev = dst.device
    keep = valid & (rank < cap)
    tgt = torch.where(keep, torch.div(dst, nl, rounding_mode="floor"), d)
    order = torch.argsort(tgt, stable=True)
    fields = torch.stack([
        cell.to(torch.int32), cv.to(torch.int32), vr.to(torch.int32),
        site.to(torch.int32), cl.to(torch.int32), keep.to(torch.int32),
        dst.to(torch.int32), rank.to(torch.int32),
    ], dim=1)[order]  # (m, 8)
    tgt_s = tgt[order]
    routed = tgt_s < d
    pos = ranks_within_group_masked(tgt_s, routed)
    buckets = torch.zeros((d + 1, m, BUCKET_FIELDS), dtype=torch.int32,
                          device=dev)
    # unrouted lanes all land in the scratch bucket d
    buckets[torch.where(routed, tgt_s, d).long(), pos.long()] = fields
    return mesh.all_to_all(buckets[:d]).reshape(-1, BUCKET_FIELDS)


def route_merge_sharded(state: TableState, dst, rank, cell, cv, vr, site,
                        cl, valid, cap: int, mesh) -> TableState:
    """The delivery merge over a device mesh: route cross-shard lanes
    with one ``all_to_all_single``, then run :func:`grouped_merge` on
    this rank's shard.

    ``state`` is this rank's ``(N/D, R, C)`` shard, consumed as
    :func:`merge_grouped` consumes it. The lanes are this rank's slice
    of the flat cell-lane stream: ``(m,)`` each, ``m`` equal on every
    rank (the caller pads the global stream to a multiple of D with
    invalid lanes), ``dst`` global, ``rank`` the lane's mailbox rank
    within its destination, computed over the global order.

    :func:`route_to_shards` exchanges the lanes; the receiving shard
    scatters each at its globally computed ``(dst, rank)`` slot of its
    ``(6, N/D * cap)`` mailbox (:func:`place_lanes`). Valid slots are unique, so the mailbox —
    and with it the merge — is a pure function of the global lane order,
    bit for bit the one-device kernel's (:func:`route_lanes` then
    :func:`grouped_merge`) whichever rank sourced a lane."""
    nl, r, c = state.cv.shape
    ex = route_to_shards(dst, rank, cell, cv, vr, site, cl, valid, cap, nl,
                         mesh)
    lbox = place_lanes(ex, mesh.index * nl, nl, cap)
    flat = [t.view(nl, r * c) for t in (state.cv, state.vr, state.site)]
    grouped_merge(*flat, state.cl, lbox, cap, c)
    if state.cv.device.type == "cuda":
        MESH_SITE_LAUNCHES["route_merge_sharded"] += 1
    return TableState(cv=state.cv, vr=state.vr, site=state.site, cl=state.cl)


def place_lanes(ex: torch.Tensor, lo: int, nl: int, cap: int) -> torch.Tensor:
    """The shard's ``(6, nl * cap)`` mailbox from the received ``(L, 8)``
    lanes of :func:`route_to_shards`: each valid lane written straight
    into its field rows at slot ``(dst - lo) * cap + rank`` with one
    scatter; the masked lanes all land on one scratch word past the
    mailbox."""
    slots = nl * cap
    ok = ex[:, LANE_VALID] != 0
    slot = (ex[:, 6].long() - lo) * cap + ex[:, 7].long()
    rows = torch.arange(LANE_FIELDS, device=ex.device)[:, None] * slots
    idx = torch.where(ok[None, :], rows + slot[None, :],
                      LANE_FIELDS * slots)
    buf = torch.zeros(LANE_FIELDS * slots + 1, dtype=torch.int32,
                      device=ex.device)
    buf[idx.reshape(-1)] = ex[:, :LANE_FIELDS].T.reshape(-1)
    return buf[:LANE_FIELDS * slots].view(LANE_FIELDS, slots)


def _lane_classes(lanes, cap: int, cols: int, after):
    """Masks over the mailbox's lanes, by what the merge reads of them:
    valid word set; valid and in range (``hit``); at their row's merged
    generation (``gen``); carrying a value (``value``); tying the merged
    cv (``win1``); tying the merged cv and vr (``win2``). Also each lane's
    flat ``node * cells + cell`` index (clamped)."""
    cv1, vr1, _site1, cl1 = after
    n, cells = cv1.shape
    node = torch.arange(n * cap, device=lanes.device) // cap
    cell = lanes[LANE_CELL].long()
    valid = lanes[LANE_VALID] != 0
    hit = valid & (cell >= 0) & (cell < cells)
    flat = node * cells + cell.clamp(0, cells - 1)
    gen = hit & (lanes[LANE_CL] == cl1.reshape(-1)[flat // cols])
    value = gen & (lanes[LANE_VR] != NEG)
    win1 = value & (lanes[LANE_CV] == cv1.reshape(-1)[flat])
    win2 = win1 & (lanes[LANE_VR] == vr1.reshape(-1)[flat])
    return flat, valid, hit, gen, value, win1, win2


def merge_work(before, lanes, cap: int, cols: int, after):
    """The least bytes and int32 operations the in-place merge needs on
    these inputs: ``before``/``after`` are the ``(cv, vr, site, cl)``
    planes before and after the merge. Returns ``(bytes, ops)``.

    Bytes, each word read or written once: of the lanes, the valid word
    of every lane, the cell of each valid lane, the cl of each in-range
    one, the vr of those at their row's merged generation, the cv of
    those carrying a value and the site of those tying the merged cv and
    vr; the cl of each (node, row) a valid in-range lane hits; the stored
    cv/vr/site of each cell a value lane at its row's merged generation
    hits, in a row whose cl did not grow; writes of each grown cl, of
    cv/vr/site for every cell of a row whose cl grew, and of each changed
    cell of a kept row. Operations: one max per lane competing in each
    pass, one select per hit cell for each of the three pass bases and
    one compare per hit row."""
    cv0, vr0, site0, cl0 = before
    cv1, vr1, site1, cl1 = after
    n, cells = cv0.shape
    flat, valid, hit, gen, value, win1, win2 = _lane_classes(
        lanes, cap, cols, after)

    def count(m):
        return int(m.sum())

    grew = (cl1 > cl0).reshape(-1)  # (n * rows,)
    rows_hit = torch.unique(flat[hit] // cols).numel()
    cells_hit = torch.unique(flat[value])
    kept_cells = count(~grew[cells_hit // cols])
    changed = ((cv1 != cv0) | (vr1 != vr0) | (site1 != site0)).reshape(-1)
    changed_kept = count(changed & ~grew.repeat_interleave(cols))
    lane_words = (n * cap + count(valid) + count(hit) + count(gen)
                  + count(value) + count(win2))
    words = (lane_words + rows_hit + 3 * kept_cells  # reads
             + count(grew) * (1 + 3 * cols) + 3 * changed_kept)  # writes
    ops = (count(hit) + count(value) + count(win1) + count(win2)
           + 3 * cells_hit.numel() + rows_hit)
    return 4 * words, ops


def merge_sector_bytes(before, lanes, cap: int, cols: int, after,
                       sector: int = 32) -> int:
    """The bytes :func:`merge_work`'s words cost when DRAM moves whole
    ``sector``-byte sectors: each sector holding a word read is read once,
    each sector holding a word written is written once, and a sector only
    partly written is read as well (the card merges a partial sector
    write into the sector read from DRAM)."""
    cv0, vr0, site0, cl0 = before
    cv1, vr1, site1, cl1 = after
    n, cells = cv0.shape
    words = sector // 4
    m = n * cap
    flat, valid, hit, gen, value, _win1, win2 = _lane_classes(
        lanes, cap, cols, after)
    lane_idx = torch.arange(m, device=lanes.device)

    def nsec(idx):
        return torch.unique(idx // words).numel()

    lane_sectors = -(-m // words)  # the valid row, read whole
    for f, mask in ((LANE_CELL, valid), (LANE_CL, hit), (LANE_VR, gen),
                    (LANE_CV, value), (LANE_SITE, win2)):
        lane_sectors += nsec(f * m + lane_idx[mask])
    grew = (cl1 > cl0).reshape(-1)
    row_idx = torch.arange(grew.numel(), device=grew.device)
    cl_sectors = nsec(flat[hit] // cols) + nsec(row_idx[grew])
    # cv/vr/site: one plane's pattern, three times
    cells_hit = torch.unique(flat[value])
    kept_hit = cells_hit[~grew[cells_hit // cols]]
    changed = ((cv1 != cv0) | (vr1 != vr0) | (site1 != site0)).reshape(-1)
    wiped = grew.repeat_interleave(cols)
    cell_idx = torch.arange(wiped.numel(), device=grew.device)
    written = cell_idx[wiped | changed]
    wsec, wcount = torch.unique(written // words, return_counts=True)
    partial = wsec[wcount < words]
    read = torch.unique(torch.cat([kept_hit // words, partial]))
    plane_sectors = read.numel() + wsec.numel()
    return sector * (lane_sectors + cl_sectors + 3 * plane_sectors)


def bound_ms(work) -> tuple:
    """``(ms, "bytes" | "operations")``: the least time the card could
    take for a ``(bytes, ops)`` count, and which of the two sets it."""
    nbytes, ops = work
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def merge_work_out_of_place(before, lanes, cap: int, cols: int, after):
    """The out-of-place count :func:`merge_work` replaced, kept beside it
    for comparison: the whole ``(N, rows)`` cl plane read and written,
    the stored cv/vr/site of every kept row read, the three ``(N, cells)``
    planes written whole; lanes as in :func:`merge_work`, with the cell
    word counted only for in-range lanes. Returns ``(bytes, ops)``."""
    cv0, cl0 = before[0], before[3]
    cl1 = after[3]
    n, cells = cv0.shape
    rows = cells // cols
    _flat, _valid, hit, gen, value, _win1, win2 = _lane_classes(
        lanes, cap, cols, after)
    counts = [int(x.sum()) for x in (hit, gen, value, win2)]
    kept_rows = int((cl1 == cl0).sum())
    lane_words = n * cap + 2 * counts[0] + counts[1] + counts[2] + counts[3]
    words = (n * rows + 3 * kept_rows * cols  # inputs
             + 3 * n * cells + n * rows  # outputs
             + lane_words)
    ops = counts[0] + counts[2] + 2 * counts[3] + 3 * n * cells + n * rows
    return 4 * words, ops


def kernel_supported(cfg, path: str = "sync", device=None) -> bool:
    """Whether a merge site routes through :func:`grouped_merge`.

    ``merge_kernel``: "off" never; "on" on both merge sites (the sync
    sweep and gossip delivery) on any device — on the CPU that runs the
    plain version through the mailbox; "auto" on the sync sweep when the
    planes are on CUDA. Either way the flat cell space must be a
    multiple of 128 and at most 8192 cells."""
    if cfg.merge_kernel == "off":
        return False
    cells = cfg.num_rows * cfg.num_cols
    if not (cells % 128 == 0 and cells <= 8192):
        return False
    if cfg.merge_kernel == "on":
        return True
    if path != "sync":
        return False
    return device is not None and torch.device(device).type == "cuda"


def sharded_kernel_downgrade(cfg, n_devices: int, device=None) -> str | None:
    """Why a mesh run cannot keep its merge kernel, or None.

    A reason means the run takes the scatter merge
    (``merge_kernel="off"``) and says so: a ``config_downgrade`` flight
    annotation and ``corro_config_downgrade_total{reason}``.
    ``merge_kernel="off"`` itself is the operator's choice, not a
    downgrade. Under ``"auto"`` the mesh keeps the kernel only where the
    ranks' planes are on CUDA (``sharded_non_cuda`` otherwise; the JAX
    package's reason is ``sharded_non_tpu``)."""
    if cfg.merge_kernel == "off":
        return None
    cells = cfg.num_rows * cfg.num_cols
    if not (cells % 128 == 0 and cells <= 8192):
        return "cell_space_unaligned"
    if cfg.num_nodes % max(n_devices, 1) != 0:
        return "uneven_node_shards"
    if cfg.merge_kernel == "on":
        return None  # forced: the plain version per shard off the card
    if device is None or torch.device(device).type != "cuda":
        return "sharded_non_cuda"
    return None
