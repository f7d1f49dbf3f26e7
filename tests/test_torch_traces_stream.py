"""Parity of the streaming half of trace ingest and of schema-driven
ingest (corro_sim_torch.io.traces) with the JAX package's
``corro_sim/io/traces.py`` on the CPU.

On both committed fixtures, on a hostile feed that hits every ``BAD_*``
reason and on a seeded Consul-schema feed (``profile_slice.twin_feed``):

- ``scan_universe`` (strict and lenient) freezes the same universe:
  actor ordinals, row slots, column planes, value ranks and their
  representatives, the seq capacity and the suggested config;
- ``TraceStream.feed`` encodes the same planes chunk by chunk, at every
  chunking, in both postures, with the same quarantine and late-clear
  lists, heads, counters and cursor; a stream rebuilt from the cursor
  continues identically; the strict refusal's message is the same;
- ``validate_feed`` classifies the same lines (torn tails included);
- ``extend_universe`` grows the same universe with the same rank
  translation, and refuses the same extensions; ``rebind`` continues;
- ``ingest(layout=)`` and ``dump_changeset`` give the same planes and
  the same text.

Tolerance: exact.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from corro_sim import schema as r_schema
from corro_sim.io import traces as r_traces
from corro_sim_torch import schema as p_schema
from corro_sim_torch.io import traces as p_traces
from corro_sim_torch.profile_slice import twin_feed

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "traces"
PLANES = ("valid", "empty", "ts", "delete", "ncells", "row", "col", "vr",
          "cv", "cl")
TA1 = "7c2e1a00-0001-4000-8000-000000000001"
TA2 = "7c2e1a00-0002-4000-8000-000000000002"
TA3 = "7c2e1a00-0003-4000-8000-000000000003"
STRANGER = "eeeeeeee-0000-4000-8000-00000000000e"
FIXTURE_DDL = (
    "CREATE TABLE services (id TEXT NOT NULL PRIMARY KEY, name TEXT, "
    "port INTEGER, meta BLOB);"
    "CREATE TABLE checks (id TEXT NOT NULL PRIMARY KEY, status TEXT);"
)


def _lines(name: str) -> list:
    with open(FIXTURES / f"{name}.ndjson", encoding="utf-8") as f:
        return list(f)


def _hostile(traces) -> list:
    """Lines after flyio_small's own: one of every quarantine reason, a
    late clear and a straddling EmptySet, then a torn tail."""
    d = traces.dump_changeset
    svc = ("services", ("web-1",))
    return [
        "{definitely not json\n",  # malformed
        '{"actor_id": "x"}\n',  # malformed: no version
        "\n",  # blank: counted, never classified
        d(STRANGER, 1, 0, [(*svc, "name", "web", 1, 1)]) + "\n",
        d(TA1, 5, 2000, [(*svc, "name", "web", 4, 1)]) + "\n",
        d(TA1, 5, 2001, [(*svc, "name", "api", 4, 1)]) + "\n",  # duplicate
        d(TA2, 4, 2002, [("rockets", ("x",), "thrust", 9, 1, 1)]) + "\n",
        d(TA2, 4, 2003, [(*svc, "colour", "web", 1, 1)]) + "\n",
        d(TA2, 4, 2004, [(*svc, "name", "NEVER-INTERNED", 1, 1)]) + "\n",
        d(TA3, 3, 2005, [(*svc, "name", "web", 5, 1)] * 3) + "\n",
        d(TA1, 2, 2006, [(*svc, "port", 8080, 9, 1)]) + "\n",  # stale
        json.dumps({"actor_id": TA1, "versions": [1, 1], "ts": 2007})
        + "\n",  # late clear
        json.dumps({"actor_id": TA2, "versions": [2, 6], "ts": 2008})
        + "\n",  # straddles the horizon
        d(TA3, 4, 2009, [(*svc, "port", 8081, 6, 1),
                         ("checks", ("web-1-http",), "__crsql_del", None,
                          1, 4)]) + "\n",
        '{"actor_id": "' + TA1 + '", "version": 9, "chan',  # torn tail
    ]


def _same_universe(got, want):
    assert got.actors == want.actors
    assert got.row_of == want.row_of
    assert got.row_keys == want.row_keys
    assert got.col_keys == want.col_keys
    assert got.values == want.values
    assert [type(v) for v in got.values] == [type(v) for v in want.values]
    assert got.seqs_per_version == want.seqs_per_version
    assert got.col_triples() == want.col_triples()
    assert (got.num_actors, got.num_rows, got.num_cols) == (
        want.num_actors, want.num_rows, want.num_cols)
    assert dataclasses.asdict(got.suggest_config(rounds=7)) == (
        dataclasses.asdict(want.suggest_config(rounds=7)))
    assert [got.interner.rank(v) for v in got.values] == [
        want.interner.rank(v) for v in want.values]


def _same_chunk(got, want):
    assert got.rounds == want.rounds
    for name in PLANES:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.bad == want.bad
    assert got.late == want.late
    assert got.late_apply == want.late_apply
    assert (got.lines, got.ts_lo, got.ts_hi) == (want.lines, want.ts_lo,
                                                 want.ts_hi)


def _same_stream(got, want):
    np.testing.assert_array_equal(got.heads, want.heads)
    assert got.heads.dtype == want.heads.dtype
    assert got.cursor() == want.cursor()
    assert (got.bad_lines, got.late_clears) == (want.bad_lines,
                                                want.late_clears)


def _feeds():
    small = _lines("flyio_small")
    synth = twin_feed(3, 12, 8, keys=8, hostile=0.05).lines
    return {
        "flyio_small": (small, small),
        "flyio_live": (_lines("flyio_live"), _lines("flyio_live")),
        "hostile": (small + _hostile(p_traces), small + _hostile(r_traces)),
        "consul_synth": (synth, synth),
    }


FEEDS = _feeds()
# the scan window each feed's universe is frozen from: the hostile
# feed's is the clean fixture, the synthetic feed's its first half
SCAN = {"hostile": len(_lines("flyio_small")),
        "consul_synth": len(FEEDS["consul_synth"][0]) // 2}


def _universes(name):
    got_lines, want_lines = FEEDS[name]
    n = SCAN.get(name, len(want_lines))
    return (p_traces.scan_universe(got_lines[:n], lenient=True),
            r_traces.scan_universe(want_lines[:n], lenient=True))


@pytest.mark.parametrize("name", sorted(FEEDS))
def test_scan_universe_matches(name):
    got_lines, want_lines = FEEDS[name]
    assert got_lines == want_lines
    for window in (len(want_lines), 4):
        _same_universe(
            p_traces.scan_universe(got_lines[:window], lenient=True),
            r_traces.scan_universe(want_lines[:window], lenient=True))
    if name in ("flyio_small", "flyio_live"):
        _same_universe(p_traces.scan_universe(got_lines),
                       r_traces.scan_universe(want_lines))
    else:  # a strict scan refuses what the JAX package's refuses
        with pytest.raises(Exception) as got_e:
            p_traces.scan_universe(got_lines)
        with pytest.raises(Exception) as want_e:
            r_traces.scan_universe(want_lines)
        assert type(got_e.value).__name__ == type(want_e.value).__name__


@pytest.mark.parametrize("name", sorted(FEEDS))
@pytest.mark.parametrize("chunk", [1, 3, 4, 64])
def test_stream_feed_matches(name, chunk):
    got_lines, want_lines = FEEDS[name]
    p_uni, r_uni = _universes(name)
    got = p_traces.TraceStream(p_uni)
    want = r_traces.TraceStream(r_uni)
    for i in range(0, len(want_lines), chunk):
        block = slice(i, i + chunk)
        encode = (i // chunk) % 3 != 2  # some chunks only classify
        _same_chunk(got.feed(got_lines[block], skip_bad=True, encode=encode),
                    want.feed(want_lines[block], skip_bad=True,
                              encode=encode))
        _same_stream(got, want)
        if i == chunk:  # a stream rebuilt from its cursor continues
            got = p_traces.TraceStream.from_cursor(p_uni, got.cursor())
    assert dict(got.counters) == dict(want.counters)


def test_hostile_feed_hits_every_reason():
    got_lines, want_lines = FEEDS["hostile"]
    uni, r_uni = _universes("hostile")
    bad = p_traces.validate_feed(got_lines, uni, chunk_lines=4)
    want = r_traces.validate_feed(want_lines, r_uni, chunk_lines=4)
    assert bad == want
    assert {reason for _, reason, _ in bad} == set(p_traces.BAD_REASONS)
    assert p_traces.BAD_REASONS == r_traces.BAD_REASONS
    assert p_traces.LATE_CLEAR == r_traces.LATE_CLEAR
    # the torn tail is retryable only while it is the feed's last line
    assert bad[-1][1] == p_traces.BAD_TORN_TAIL
    moved = got_lines + got_lines[:1]
    got_moved = p_traces.validate_feed(moved, uni, chunk_lines=4)
    assert got_moved == r_traces.validate_feed(moved, r_uni, chunk_lines=4)
    assert (len(got_lines), "malformed") in [(no, r) for no, r, _ in
                                             got_moved]


@pytest.mark.parametrize("chunk", [4, 64])
def test_strict_refusal_matches(chunk):
    got_lines, want_lines = FEEDS["hostile"]
    p_uni, r_uni = _universes("hostile")
    got = p_traces.TraceStream(p_uni)
    want = r_traces.TraceStream(r_uni)
    for i in range(0, len(want_lines), chunk):
        block = slice(i, i + chunk)
        try:
            w = want.feed(want_lines[block])
        except ValueError as e:
            with pytest.raises(ValueError) as g:
                got.feed(got_lines[block])
            assert str(g.value) == str(e)
            assert "hostile trace feed" in str(e)
            _same_stream(got, want)  # side-effect free, on both
            continue
        _same_chunk(got.feed(got_lines[block]), w)
        _same_stream(got, want)


def _stranger_window(traces):
    """A trailing window naming a new actor, a new row, a new column and
    new values (one between the old ones in the conflict order)."""
    d = traces.dump_changeset
    return [
        d(STRANGER, 1, 3000, [("services", ("zz-9",), "name", "new", 1, 1),
                              ("services", ("web-1",), "port", 8085, 9, 1)]),
        d(STRANGER, 2, 3001, [("services", ("zz-9",), "colour", "blue", 1,
                               1)]),
        d(TA1, 7, 3002, [("checks", ("aa-0",), "status", "critical", 1, 1)]),
        "{junk",
    ]


def test_extend_universe_and_rebind_match():
    lines = _lines("flyio_small")
    p_uni = p_traces.scan_universe(lines)
    r_uni = r_traces.scan_universe(lines)
    kw = dict(max_actors=8, max_rows=16, max_cols=4, max_seqs=4)
    got, g_info = p_traces.extend_universe(
        p_uni, _stranger_window(p_traces), **kw)
    want, w_info = r_traces.extend_universe(
        r_uni, _stranger_window(r_traces), **kw)
    _same_universe(got, want)
    assert set(g_info) == set(w_info)
    for k, v in w_info.items():
        if isinstance(v, np.ndarray):
            assert g_info[k].dtype == v.dtype
            np.testing.assert_array_equal(g_info[k], v)
        else:
            assert g_info[k] == v, k
    assert w_info["rank_moves"] > 0 and w_info["actors_added"] == 1
    # refusals name every violated bound, on both
    for tight in (dict(kw, max_actors=3), dict(kw, max_rows=5),
                  dict(kw, max_cols=2)):
        g, gi = p_traces.extend_universe(
            p_uni, _stranger_window(p_traces), **tight)
        w, wi = r_traces.extend_universe(
            r_uni, _stranger_window(r_traces), **tight)
        assert g is None and w is None
        assert gi["refused"] == wi["refused"] and wi["refused"]
    # a layout-pinned universe refuses outright
    lay = p_schema.TableLayout(p_schema.parse_and_constrain(FIXTURE_DDL))
    pinned = p_traces.scan_universe(lines, layout=lay)
    r_pinned = r_traces.scan_universe(lines, layout=r_schema.TableLayout(
        r_schema.parse_and_constrain(FIXTURE_DDL)))
    _same_universe(pinned, r_pinned)
    assert p_traces.extend_universe(pinned, lines, **kw)[1] == (
        r_traces.extend_universe(r_pinned, lines, **kw)[1])
    # rebind: the extended universe takes over mid-stream
    gs, ws = p_traces.TraceStream(p_uni), r_traces.TraceStream(r_uni)
    gs.feed(lines, skip_bad=True)
    ws.feed(lines, skip_bad=True)
    gs.rebind(got)
    ws.rebind(want)
    _same_stream(gs, ws)
    tail = [ln + "\n" for ln in _stranger_window(p_traces)]
    _same_chunk(gs.feed(tail, skip_bad=True), ws.feed(tail, skip_bad=True))
    _same_stream(gs, ws)


@pytest.mark.parametrize("name", ["flyio_small", "flyio_live"])
def test_ingest_with_layout_matches(name):
    lines = [ln for ln in _lines(name) if ln.strip()]
    got = p_traces.ingest(lines, layout=p_schema.TableLayout(
        p_schema.parse_and_constrain(FIXTURE_DDL), default_capacity=4))
    want = r_traces.ingest(lines, layout=r_schema.TableLayout(
        r_schema.parse_and_constrain(FIXTURE_DDL), default_capacity=4))
    for f in PLANES:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.row_keys, got.col_keys, got.values, got.actors) == (
        want.row_keys, want.col_keys, want.values, want.actors)
    assert got.num_rows == 8 and None in got.row_keys
    # without a layout the batch encoding is the discovered one
    plain = p_traces.ingest(lines)
    assert plain.num_rows == 5 and None not in plain.row_keys


def test_dump_changeset_matches():
    cells = [("services", ("web-1",), "name", "web", 1, 1),
             ("services", ("blob-1",), "meta", b"\x00\xff", 2, 3),
             ("checks", (7, 1.5, None), "__crsql_del", None, 1, 2)]
    for n in range(len(cells) + 1):
        text = p_traces.dump_changeset(TA1, 4, 99, cells[:n])
        assert text == r_traces.dump_changeset(TA1, 4, 99, cells[:n])
        assert dataclasses.asdict(p_traces.parse_trace_line(text)) == (
            dataclasses.asdict(r_traces.parse_trace_line(text)))
