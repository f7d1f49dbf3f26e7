"""The port's C++ pk codec (``corro_sim_torch/io/native.py``) against the
JAX package's (``corro_sim.io.native``) and the port's pure-Python codec,
on the inputs of ``tests/test_native.py``'s eight cases: random tuples
packed and unpacked, the sign-extension quirk, the batch path against
the sequential one (above and below its threshold), truncation,
malformed widths, out-of-range ints, trace parsing through the batch
path, and a throughput floor. Also: the codec builds here, says why
when it cannot, and falls back to the Python codec then.

Tolerance: exact (the throughput case: the native batch path within 2x
of the Python codec's time, the JAX package's bound).
"""

import json
import random
import time

import pytest

from corro_sim.io import columns as r_py
from corro_sim.io import native as r_native
from corro_sim_torch.io import columns as py
from corro_sim_torch.io import native
from test_native import random_value


def test_codec_builds_into_the_port_build_dir():
    assert native.available(), native.reason()
    assert native.reason() is None
    assert "corro_sim_torch/_build/libcorro_native_" in \
        native.BUILD_INFO["library"].replace("\\", "/")
    assert r_native.available()


def test_differential_pack_unpack():
    rng = random.Random(7)
    for _ in range(300):
        vals = tuple(random_value(rng) for _ in range(rng.randint(0, 12)))
        enc = py.pack_columns(vals)
        assert native.pack_columns(vals) == enc == r_native.pack_columns(
            vals) == r_py.pack_columns(vals), vals
        assert native.unpack_columns(enc) == py.unpack_columns(enc) == \
            r_native.unpack_columns(enc)


def test_sign_extension_quirk_matches():
    for v in (255, 65535):
        enc = py.pack_columns((v,))
        assert native.unpack_columns(enc) == r_native.unpack_columns(
            enc) == py.unpack_columns(enc) == (-1,)
    s = "x" * 128
    enc = py.pack_columns((s,))
    assert native.unpack_columns(enc) == r_native.unpack_columns(enc) == (s,)


def test_batch_matches_sequential():
    rng = random.Random(11)
    blobs = [
        py.pack_columns(
            tuple(random_value(rng) for _ in range(rng.randint(0, 6)))
        )
        for _ in range(600)  # above the batch threshold: native runs
    ]
    batch = native.unpack_columns_batch(blobs)
    assert batch == [py.unpack_columns(b) for b in blobs]
    assert batch == r_native.unpack_columns_batch(blobs)
    assert native.unpack_columns_batch(blobs[:10]) == batch[:10]


def test_native_truncation_errors():
    enc = py.pack_columns((12345, "hello"))
    for cut in range(1, len(enc)):
        for codec in (native, r_native, py):
            with pytest.raises(py.UnpackError if codec is not r_native
                               else r_py.UnpackError):
                codec.unpack_columns(enc[:cut])


def test_trace_parse_uses_batch_path(monkeypatch):
    from corro_sim.io.traces import parse_trace_line as r_parse
    from corro_sim_torch.io import traces

    calls = []
    batch = traces.unpack_columns_batch
    monkeypatch.setattr(traces, "unpack_columns_batch",
                        lambda blobs: calls.append(len(blobs)) or batch(
                            blobs))
    line = json.dumps({
        "actor_id": 0, "version": 1, "ts": 0, "seqs": [0, 0],
        "last_seq": 0,
        "changes": [{
            "table": "t", "pk": list(py.pack_columns(("k1", 7))),
            "cid": "v", "val": "x", "col_version": 1, "db_version": 1,
            "seq": 0, "cl": 1,
        }],
    })
    cs = traces.parse_trace_line(line)
    assert cs.changes[0].pk == ("k1", 7) == r_parse(line).changes[0].pk
    assert traces.parse_trace_lines([line, line])[1].changes[0].pk == (
        "k1", 7)
    assert calls == [1, 2]
    assert batch is native.unpack_columns_batch


def test_batch_throughput_not_pathological():
    rng = random.Random(3)
    blobs = [py.pack_columns((f"key-{i}", i, rng.random()))
             for i in range(5000)]

    def time_min(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    native.unpack_columns_batch(blobs)
    t_native = time_min(lambda: native.unpack_columns_batch(blobs))
    t_py = time_min(lambda: [py.unpack_columns(b) for b in blobs])
    assert t_native < t_py * 2.0, (t_native, t_py)


def test_malformed_width_rejected_identically():
    bad_int = bytes([1, (31 << 3) | py.TYPE_INTEGER]) + b"\x01" * 31
    bad_len = bytes([1, (9 << 3) | py.TYPE_TEXT]) + b"\x00" * 9
    for bad in (bad_int, bad_len):
        for codec in (py, native):
            with pytest.raises(py.UnpackError):
                codec.unpack_columns(bad)
        with pytest.raises(r_py.UnpackError):
            r_native.unpack_columns(bad)


def test_out_of_range_int_wraps_like_python():
    for v in (2**63, -(2**63) - 1, 2**64 + 5):
        assert native.pack_columns((v,)) == py.pack_columns((v,)) == \
            r_native.pack_columns((v,))


def test_no_compiler_falls_back_and_says_why(monkeypatch, tmp_path):
    """A source the compiler refuses leaves the codec unavailable with
    the reason, and every entry point answers through the Python
    codec."""
    bad = tmp_path / "corro_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_reason", None)
    from corro_sim_torch.utils import compile_cache

    monkeypatch.setattr(compile_cache, "cache_dir", lambda: str(tmp_path))
    assert not native.available()
    assert "did not build" in native.reason()
    enc = py.pack_columns(("a", 1, None))
    assert native.pack_columns(("a", 1, None)) == enc
    assert native.unpack_columns(enc) == ("a", 1, None)
    assert native.unpack_columns_batch([enc] * 300) == [("a", 1, None)] * 300
