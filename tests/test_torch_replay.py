"""Parity of trace ingest and replay: corro_sim_torch.io and
corro_sim_torch.engine.replay against the JAX package on the CPU.

- the pk codec (``pack_columns``/``unpack_columns``) and the value keys
  agree with the JAX package's on seeded values of every SQLite type;
- ``ingest_file`` of the three fixtures gives every ``EncodedTrace``
  field of the JAX package's (value ranks included: they decide the LWW
  winner);
- ``inject_round`` commits a round into a mid-run cluster exactly as the
  JAX package's does, with fewer actors than nodes and cleared lanes;
- ``replay`` of the parity fixture and of ``flyio_small`` equals the JAX
  package's in every state leaf, metric and round, and reaches the
  reference's converged tables on every node.

Tolerance: exact.
"""

import dataclasses
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corro_sim.engine.replay import read_table as r_read_table
from corro_sim.engine.replay import replay as r_replay
from corro_sim.io import columns as r_columns
from corro_sim.io import traces as r_traces
from corro_sim.io import values as r_values
from corro_sim.workload import inject as r_inject
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.replay import read_table, replay
from corro_sim_torch.io import columns as p_columns
from corro_sim_torch.io import traces as p_traces
from corro_sim_torch.io import values as p_values
from corro_sim_torch.workload import inject as p_inject
from test_replay_parity import EXPECTED
from test_torch_workload import _leaves, _mid_pair
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
TRACES = {
    "replay_parity": FIXTURES / "replay_parity.ndjson",
    "flyio_small": FIXTURES / "traces" / "flyio_small.ndjson",
    "flyio_live": FIXTURES / "traces" / "flyio_live.ndjson",
}
# the JAX package's replay-parity config (tests/test_replay_parity.py)
PARITY_CFG = dict(seqs_per_version=4, chunks_per_version=2, fanout=2,
                  sync_interval=2, pend_slots=8)
ARRAYS = ("valid", "empty", "delete", "ncells", "row", "col", "vr", "cv",
          "cl", "ts")


def _values(rng, m):
    """Seeded SQLite values of every type, edge widths included."""
    out = [None, 0, 1, -1, 127, 128, 255, 256, 32767, 32768, 65535,
           2 ** 31 - 1, -2 ** 31, 2 ** 63 - 1, -2 ** 63, 0.0, -0.0, 1.5,
           float("inf"), float("-inf"), "", "é", "x" * 128, b"", b"\x00",
           bytes(range(200))]
    for _ in range(m):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            out.append(None)
        elif kind == 1:
            out.append(int(rng.integers(-2 ** 62, 2 ** 62))
                       >> int(rng.integers(0, 62)))
        elif kind == 2:
            out.append(float(rng.normal() * 10.0 ** rng.integers(-5, 5)))
        elif kind == 3:
            out.append("".join(chr(int(c)) for c in
                               rng.integers(32, 0x2FF, rng.integers(0, 40))))
        else:
            out.append(rng.integers(0, 256, rng.integers(0, 300)).astype(
                np.uint8).tobytes())
    return out


def test_pk_codec_agrees_and_round_trips():
    rng = np.random.default_rng(0)
    vals = _values(rng, 400)
    for i in range(0, len(vals), 3):
        tup = tuple(vals[i:i + 3])
        packed = p_columns.pack_columns(tup)
        assert packed == r_columns.pack_columns(tup)
        got = p_columns.unpack_columns(packed)
        assert got == r_columns.unpack_columns(packed)
        # the reference's sign-extension quirk: an int whose minimal
        # width has its top bit set reads back as its negative alias
        for v, g in zip(tup, got):
            if isinstance(v, int) and v != g:
                n = p_columns._int_len(v, 64)
                assert g == int.from_bytes(
                    (v & ((1 << 8 * n) - 1)).to_bytes(n, "big"), "big",
                    signed=True)
            elif isinstance(v, float) and v != v:
                assert g != g
            else:
                assert g == v or (isinstance(v, float) and struct.pack(
                    ">d", v) == struct.pack(">d", g))
    for bad in (b"", b"\x01", b"\x01\x4a", b"\x01\x49", b"\x01\x06",
                b"\x01\x02\x00"):
        with pytest.raises(p_columns.UnpackError):
            p_columns.unpack_columns(bad)
        with pytest.raises(r_columns.UnpackError):
            r_columns.unpack_columns(bad)
    with pytest.raises(p_columns.PackError):
        p_columns.pack_columns((True,))


def test_value_keys_and_interner_agree():
    rng = np.random.default_rng(1)
    vals = _values(rng, 300) + [True, False, bytearray(b"ab"), 3, 3.0]
    for v in vals:
        assert p_values.sqlite_sort_key(v) == r_values.sqlite_sort_key(v)
        assert p_values.crsql_conflict_key(v) == r_values.crsql_conflict_key(
            v)
    pi, ri = p_values.ValueInterner(), r_values.ValueInterner()
    for v in vals:
        pi.add(v)
        ri.add(v)
    pi.freeze()
    ri.freeze()
    assert len(pi) == len(ri)
    assert [pi.rank(v) for v in vals] == [ri.rank(v) for v in vals]
    with pytest.raises(TypeError):
        p_values.crsql_conflict_key(object())


@pytest.mark.parametrize("name", sorted(TRACES))
def test_ingest_matches_the_jax_package(name):
    want = r_traces.ingest_file(TRACES[name])
    got = p_traces.ingest_file(TRACES[name])
    for f in ARRAYS:
        w, g = getattr(want, f), getattr(got, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.actors == want.actors
    assert got.row_keys == want.row_keys
    assert got.col_keys == want.col_keys
    assert got.values == want.values
    assert [type(v) for v in got.values] == [type(v) for v in want.values]
    assert (got.rounds, got.num_actors, got.num_rows, got.num_cols,
            got.seqs_per_version) == (
        want.rounds, want.num_actors, want.num_rows, want.num_cols,
        want.seqs_per_version)
    assert dataclasses.asdict(got.suggest_config(**PARITY_CFG)) == (
        dataclasses.asdict(want.suggest_config(**PARITY_CFG)))
    lines = [ln for ln in TRACES[name].read_text().splitlines() if ln]
    for ln in lines:
        assert dataclasses.asdict(p_traces.parse_trace_line(ln)) == (
            dataclasses.asdict(r_traces.parse_trace_line(ln)))


def test_ingest_refuses_layouts_and_duplicates():
    """Schema-driven ingest refuses a table the layout does not hold, as
    the JAX package's does; a duplicated version is refused."""
    from corro_sim_torch.schema import (
        SchemaError,
        TableLayout,
        parse_and_constrain,
    )

    lay = TableLayout(parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"))
    bad = p_traces.dump_changeset(
        "00000000-0000-0000-0000-000000000000", 1, 0,
        [("nope", (1,), "v", "x", 1, 1)])
    with pytest.raises(SchemaError, match="no such"):
        p_traces.ingest([bad], layout=lay)
    line = TRACES["flyio_small"].read_text().splitlines()[0]
    with pytest.raises(ValueError, match="duplicate version"):
        p_traces.ingest([line, line])


def test_inject_round_matches_the_jax_package():
    """Inject the parity fixture's rounds into a mid-run 8-node cluster
    (two actors: the rows past them never write), cleared lanes and a
    tombstone included."""
    trace = p_traces.ingest_file(TRACES["replay_parity"])
    from test_torch_workload import config6_small

    cfg = dataclasses.replace(
        config6_small(32)[0], num_nodes=8, seqs_per_version=4,
        chunks_per_version=2, num_rows=16, num_cols=4, emit_slots=0,
    )
    port, ref = _mid_pair(cfg, rounds=4)
    cells = p_inject.pad_trace_cells(trace, cfg.seqs_per_version)
    assert trace.empty.any() and (trace.vr == np.iinfo(np.int32).min).any()
    inject = jax.jit(r_inject.inject_round, static_argnums=0)
    pcfg = sim_config_from_dict(dataclasses.asdict(cfg))
    for r in range(trace.rounds):
        args = p_inject.trace_round_args(trace, cells, r, "cpu")
        ref = inject(cfg, ref, *(jnp.asarray(a.numpy()) for a in args))
        port = p_inject.inject_round(pcfg, port, *args)
        want, have = _leaves(ref), state_to_numpy(port)
        for k in want:
            np.testing.assert_array_equal(have[k], want[k],
                                          err_msg=f"round {r}: {k}")


@pytest.mark.parametrize("name", ["replay_parity", "flyio_small"])
def test_replay_bit_identical(name):
    want_tr = r_traces.ingest_file(TRACES[name])
    trace = p_traces.ingest_file(TRACES[name])
    overrides = PARITY_CFG if name == "replay_parity" else {}
    cfg = want_tr.suggest_config(**overrides)
    ref = r_replay(want_tr, cfg, max_rounds=256)
    got = replay(trace, sim_config_from_dict(dataclasses.asdict(cfg)),
                 max_rounds=256, device="cpu")
    assert ref.converged_round is not None and not ref.poisoned
    assert (got.rounds, got.converged_round, got.poisoned) == (
        ref.rounds, ref.converged_round, ref.poisoned)
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        np.testing.assert_array_equal(got.metrics[k], v, err_msg=k)
    want, have = _leaves(ref.state), state_to_numpy(got.state)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    for node in range(cfg.num_nodes):
        assert read_table(got.state, trace, node) == r_read_table(
            ref.state, want_tr, node)
        if name == "replay_parity":
            assert read_table(got.state, trace, node) == EXPECTED
    if name == "replay_parity":
        cleared = got.state.log.cleared.numpy()
        assert cleared[0, 3] and cleared[0, 1]


def test_replay_refuses_what_does_not_fit():
    trace = p_traces.ingest_file(TRACES["replay_parity"])
    small = trace.suggest_config(seqs_per_version=2)
    with pytest.raises(ValueError, match="cells per changeset"):
        replay(trace, small, device="cpu")
    with pytest.raises(ValueError, match="row slots"):
        replay(trace, trace.suggest_config(num_rows=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            replay(trace, trace.suggest_config(**PARITY_CFG))
