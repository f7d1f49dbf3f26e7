"""Dst-grouped CRDT cell merge: the hand-written CUDA kernel and its
plain PyTorch version.

Port of ``corro_sim/core/merge_kernel.py``. Lanes grouped by destination
node live in a dense per-node mailbox — ``(6, N * cap)`` int32, node
``n``'s lanes at columns ``[n*cap, (n+1)*cap)``, rows cell, cv, vr, site,
cl, valid (the JAX package's two pad rows exist only for the TPU's
sublane tiling and are dropped) — and merge into the table planes: cv,
vr and site flat ``(N, cells)``, cl ``(N, rows)``. :func:`grouped_merge`
launches ``csrc/merge_kernel.cu`` (one thread block per node,
shared-memory atomicMax passes, out of place) on CUDA tensors and runs
:func:`grouped_merge_reference`, which is
:func:`corro_sim_torch.core.crdt.apply_cell_changes` on the unpacked
mailbox, on CPU tensors. The choice is made by device; a CUDA tensor
never falls back to the plain version.

Build: at first use the kernel is compiled from the package's own source
with ``nvcc -O3 -gencode arch=compute_90a,code=sm_90a`` into a shared
library with a plain C interface under ``corro_sim_torch/_build/`` (named
by the source's hash, so an edited source rebuilds) and loaded with
``ctypes``; a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from corro_sim_torch.core.crdt import TableState, apply_cell_changes

# lane field rows of the packed (6, N*cap) mailbox tensor
LANE_CELL, LANE_CV, LANE_VR, LANE_SITE, LANE_CL, LANE_VALID = range(6)
LANE_FIELDS = 6

KERNEL_SOURCE = Path(__file__).with_name("csrc") / "merge_kernel.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# kernel launches by wrapper name; chip_smoke.py zeroes and reads these
# around the main path to show it went through the kernel
LAUNCHES = {"grouped_merge": 0}

_lib = None
BUILD_INFO: dict = {}
_SMEM_LIMIT: dict = {}  # device index -> dynamic shared memory opted in


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_kernel() -> ctypes.CDLL:
    """Compile (once per source hash) and load the merge kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = KERNEL_SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libmerge_kernel_{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp), str(KERNEL_SOURCE),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building "
                f"{KERNEL_SOURCE}:\n{log}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.grouped_merge_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.grouped_merge_launch.restype = ctypes.c_int
    lib.grouped_merge_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.grouped_merge_smem_bytes.restype = ctypes.c_size_t
    lib.grouped_merge_init.argtypes = []
    lib.grouped_merge_init.restype = ctypes.c_longlong
    BUILD_INFO.update(
        library=str(so), seconds=time.perf_counter() - t0, log=log
    )
    _lib = lib
    return lib


def _smem_limit(lib, device: torch.device) -> int:
    """Opt the kernel in to the device's largest per-block dynamic shared
    memory, once per device; returns that size in bytes."""
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


def grouped_merge(cv, vr, site, cl, lanes, cap: int, cols: int):
    """Merge the per-node mailbox into the table planes: ``cv``, ``vr``,
    ``site`` flat ``(N, cells)``, ``cl`` ``(N, rows)``.

    CUDA tensors launch the kernel, which writes new planes; CPU tensors
    run :func:`grouped_merge_reference`. Returns ``(cv, vr, site, cl)``."""
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
    if cv.device.type == "cpu":
        return grouped_merge_reference(cv, vr, site, cl, lanes, cap, cols)
    if cv.device.type != "cuda":
        raise ValueError(f"grouped_merge: no kernel for {cv.device}")
    lib = build_kernel()
    smem = lib.grouped_merge_smem_bytes(cells, cols)
    limit = _smem_limit(lib, cv.device)
    if smem > limit:
        raise ValueError(
            f"grouped_merge: {cells} cells need {smem} B of shared memory, "
            f"more than one block holds ({limit} B)"
        )
    ins = [t.contiguous() for t in (lanes, cv, vr, site, cl)]
    outs = [torch.empty_like(t) for t in ins[1:]]
    with torch.cuda.device(cv.device):
        stream = torch.cuda.current_stream(cv.device).cuda_stream
        err = lib.grouped_merge_launch(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            n, cells, cols, cap, stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_merge: CUDA launch failed (error {err})")
    LAUNCHES["grouped_merge"] += 1
    return tuple(outs)


def merge_grouped(state: TableState, lanes: torch.Tensor,
                  cap: int) -> TableState:
    """:func:`apply_cell_changes` on a dense per-node lane mailbox, via
    :func:`grouped_merge`. Returns the merged :class:`TableState`."""
    n, r, c = state.cv.shape
    ncv, nvr, nsite, ncl = grouped_merge(
        state.cv.reshape(n, r * c), state.vr.reshape(n, r * c),
        state.site.reshape(n, r * c), state.cl, lanes, cap, c,
    )
    return TableState(
        cv=ncv.reshape(n, r, c), vr=nvr.reshape(n, r, c),
        site=nsite.reshape(n, r, c), cl=ncl,
    )


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
