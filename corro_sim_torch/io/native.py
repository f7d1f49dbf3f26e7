"""ctypes bridge to the C++ pk codec (``io/csrc/corro_native.cpp``).

The port's counterpart of ``corro_sim/io/native.py``. The pk codec — the
host-side inner loop of trace ingestion — has a C++ implementation,
built at first use with ``g++ -O2 -fPIC -std=c++17 -shared`` into
``corro_sim_torch/_build/`` (keyed by the source's hash and the flags
through :func:`~corro_sim_torch.utils.compile_cache.fetch_library`) and
loaded with ``ctypes``. Where no compiler builds it, callers fall back
to the pure-Python codec in :mod:`corro_sim_torch.io.columns`, which is
semantically identical, and :func:`reason` says why.

Public surface:
    available() -> bool
    reason() -> str | None                   (why the library is absent)
    pack_columns(values) -> bytes            (drop-in, native-backed)
    unpack_columns(data) -> tuple            (drop-in, native-backed)
    unpack_columns_batch(blobs) -> list[tuple]   (the bulk-ingest path)
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from itertools import islice
from pathlib import Path

import numpy as np

from corro_sim_torch.io import columns as _py

SOURCE = Path(__file__).with_name("csrc") / "corro_native.cpp"
# native/Makefile's flags (warnings aside): they key the library
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False
_reason: str | None = None
BUILD_INFO: dict = {}


def _compile(tmp: Path) -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _bind(lib) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.cn_abi_version.restype = ctypes.c_int
    lib.cn_abi_version.argtypes = []
    lib.cn_unpack.restype = ctypes.c_int64
    lib.cn_unpack.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, i64p, f64p, u64p, u64p,
        ctypes.c_char_p, ctypes.c_uint64, u64p,
    ]
    lib.cn_pack.restype = ctypes.c_int64
    lib.cn_pack.argtypes = [
        ctypes.c_uint64, ctypes.c_char_p, i64p, f64p, ctypes.c_char_p,
        u64p, u64p, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.cn_unpack_batch.restype = ctypes.c_int64
    lib.cn_unpack_batch.argtypes = [
        ctypes.c_char_p, u64p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, i64p, f64p, u64p, u64p,
        ctypes.c_char_p, ctypes.c_uint64, i64p, u64p,
    ]


def _load():
    global _lib, _tried, _reason
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from corro_sim_torch.utils.compile_cache import fetch_library

        try:
            info = fetch_library(SOURCE, "corro_native", _compile,
                                 flags=CXX_FLAGS)
            lib = ctypes.CDLL(info["library"])
            _bind(lib)
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as e:
            _reason = f"the C++ codec did not build or load: {e}"
            return None
        if lib.cn_abi_version() != 1:
            _reason = "the C++ codec's ABI version is not 1"
            return None
        BUILD_INFO.update(info)
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ codec is built and loaded (building it at first
    call); :func:`reason` says why not."""
    return _load() is not None


def reason() -> str | None:
    """Why the C++ codec is not available (None when it is)."""
    _load()
    return _reason


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _decode_span(lo, hi, t_l, i_l, f_l, o_l, l_l, arena: bytes):
    """Columns [lo, hi) from bulk-converted Python lists → value tuple
    (one ``.tolist()`` per array: scalar-indexing numpy arrays per
    element is slower than the pure-Python codec)."""
    out = []
    for i in range(lo, hi):
        t = t_l[i]
        if t == _py.TYPE_NULL:
            out.append(None)
        elif t == _py.TYPE_INTEGER:
            out.append(i_l[i])
        elif t == _py.TYPE_FLOAT:
            out.append(f_l[i])
        else:
            raw = arena[o_l[i]:o_l[i] + l_l[i]]
            out.append(raw.decode("utf-8") if t == _py.TYPE_TEXT else raw)
    return tuple(out)


def _as_lists(n, types, ints, floats, offs, lens):
    return (
        types[:n].tolist(), ints[:n].tolist(), floats[:n].tolist(),
        offs[:n].tolist(), lens[:n].tolist(),
    )


def unpack_columns(data: bytes) -> tuple:
    lib = _load()
    if lib is None:
        return _py.unpack_columns(data)
    cap = 256
    types = np.zeros(cap, np.uint8)
    ints = np.zeros(cap, np.int64)
    floats = np.zeros(cap, np.float64)
    offs = np.zeros(cap, np.uint64)
    lens = np.zeros(cap, np.uint64)
    arena = np.zeros(max(len(data), 1), np.uint8)
    used = ctypes.c_uint64(0)
    rc = lib.cn_unpack(
        data, len(data), cap,
        types.ctypes.data_as(ctypes.c_char_p),
        _ptr(ints, ctypes.c_int64), _ptr(floats, ctypes.c_double),
        _ptr(offs, ctypes.c_uint64), _ptr(lens, ctypes.c_uint64),
        arena.ctypes.data_as(ctypes.c_char_p), arena.size,
        ctypes.byref(used),
    )
    if rc < 0:
        raise _py.UnpackError(f"native unpack failed (code {rc})")
    lists = _as_lists(rc, types, ints, floats, offs, lens)
    return _decode_span(0, rc, *lists, arena.tobytes())


def pack_columns(values) -> bytes:
    lib = _load()
    if lib is None:
        return _py.pack_columns(values)
    n = len(values)
    if n > 0xFF:
        raise _py.PackError("more than 255 columns")
    types = np.zeros(max(n, 1), np.uint8)
    ints = np.zeros(max(n, 1), np.int64)
    floats = np.zeros(max(n, 1), np.float64)
    offs = np.zeros(max(n, 1), np.uint64)
    lens = np.zeros(max(n, 1), np.uint64)
    chunks = []
    total = 0
    for i, v in enumerate(values):
        if v is None:
            types[i] = _py.TYPE_NULL
        elif isinstance(v, bool):
            raise _py.PackError("bool is not a SQLite value")
        elif isinstance(v, int):
            types[i] = _py.TYPE_INTEGER
            # two's-complement wrap to 64 bits, like the pure codec's
            # masking
            bits = v & 0xFFFFFFFFFFFFFFFF
            ints[i] = bits - (1 << 64) if bits >> 63 else bits
        elif isinstance(v, float):
            types[i] = _py.TYPE_FLOAT
            floats[i] = v
        elif isinstance(v, (str, bytes, bytearray)):
            raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            types[i] = (
                _py.TYPE_TEXT if isinstance(v, str) else _py.TYPE_BLOB
            )
            offs[i] = total
            lens[i] = len(raw)
            chunks.append(raw)
            total += len(raw)
        else:
            raise _py.PackError(f"not a SQLite value: {type(v)!r}")
    payload = b"".join(chunks)
    out_cap = 1 + n * 10 + total
    out = ctypes.create_string_buffer(out_cap)
    rc = lib.cn_pack(
        n, types.ctypes.data_as(ctypes.c_char_p),
        _ptr(ints, ctypes.c_int64), _ptr(floats, ctypes.c_double),
        payload,
        _ptr(offs, ctypes.c_uint64), _ptr(lens, ctypes.c_uint64),
        out, out_cap,
    )
    if rc < 0:
        raise _py.PackError(f"native pack failed (code {rc})")
    return out.raw[:rc]


# Below this many blobs the fixed cost of the array set-up outweighs the
# native decode; the pure-Python codec wins (the JAX package's threshold).
_BATCH_THRESHOLD = 256


def unpack_columns_batch(blobs) -> list:
    """Decode many pk blobs in one native call — the trace-ingest path."""
    lib = _load()
    if lib is None or len(blobs) < _BATCH_THRESHOLD:
        return [_py.unpack_columns(b) for b in blobs]
    data = b"".join(blobs)
    blob_offs = np.zeros(len(blobs) + 1, np.uint64)
    blob_offs[1:] = np.cumsum([len(b) for b in blobs])
    cap = sum(max(b[0], 0) if b else 0 for b in blobs) + len(blobs)
    types = np.zeros(cap, np.uint8)
    ints = np.zeros(cap, np.int64)
    floats = np.zeros(cap, np.float64)
    offs = np.zeros(cap, np.uint64)
    lens = np.zeros(cap, np.uint64)
    arena = np.zeros(max(len(data), 1), np.uint8)
    counts = np.zeros(len(blobs), np.int64)
    err_blob = ctypes.c_uint64(0)
    rc = lib.cn_unpack_batch(
        data, _ptr(blob_offs, ctypes.c_uint64), len(blobs), cap,
        types.ctypes.data_as(ctypes.c_char_p),
        _ptr(ints, ctypes.c_int64), _ptr(floats, ctypes.c_double),
        _ptr(offs, ctypes.c_uint64), _ptr(lens, ctypes.c_uint64),
        arena.ctypes.data_as(ctypes.c_char_p), arena.size,
        _ptr(counts, ctypes.c_int64), ctypes.byref(err_blob),
    )
    if rc < 0:
        raise _py.UnpackError(
            f"native batch unpack failed (code {rc}, blob {err_blob.value})"
        )
    t_l, i_l, f_l, o_l, l_l = _as_lists(rc, types, ints, floats, offs, lens)
    arena_b = arena.tobytes()
    it = zip(t_l, i_l, f_l, o_l, l_l)
    T_NULL, T_INT, T_FLT, T_TXT = (
        _py.TYPE_NULL, _py.TYPE_INTEGER, _py.TYPE_FLOAT, _py.TYPE_TEXT,
    )
    out = []
    for c in counts.tolist():
        out.append(
            tuple(
                None if t == T_NULL
                else iv if t == T_INT
                else fv if t == T_FLT
                else arena_b[o:o + ln].decode("utf-8") if t == T_TXT
                else arena_b[o:o + ln]
                for t, iv, fv, o, ln in islice(it, c)
            )
        )
    return out
