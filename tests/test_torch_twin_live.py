"""Parity of the twin's live operator loop (corro_sim_torch.io.feedsource
and the tail, refresh and cadence paths of corro_sim_torch.engine.twin)
with the JAX package's, on the CPU; the cases of tests/test_twin_live.py.

- The file tail waits for a torn final line, re-binds across rotation
  (by inode, and by the consumed prefix's sha for a superset copy),
  refuses truncation, dies at its backoff budget and at its idle
  timeout: each case runs on the port's source and the JAX package's and
  both deliver the same lines, stats and death.
- The HTTP watch source reads the JAX package's ``/v1/changes`` relay
  (``ApiServer`` over ``LiveCluster``) line for line and dies when the
  endpoint is gone.
- A live-tailed shadow equals the file-mode shadow of the same lines,
  also across a rotation, and the JAX package's file-mode run.
- A stale-universe refresh fires, re-keys the ranks on the state and
  equals the JAX package's run; it stays deterministic across kill and
  resume, and it is refused when the extension cannot fit.
- The cadence hook runs every N chunks with monotone rounds.
- ``trace_workload`` folds a feed window into the JAX package's tape.

Tolerance: exact.
"""

import dataclasses
import json
import os
import pathlib
import shutil
import time

import numpy as np
import pytest

from corro_sim.config import TwinConfig as RefTwinConfig
from corro_sim.engine import twin as rt
from corro_sim.io import feedsource as r_fs
from corro_sim.io.traces import TraceStream as RefTraceStream
from corro_sim.workload.inject import trace_workload as r_trace_workload
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.engine import twin as pt
from corro_sim_torch.io import feedsource as p_fs
from corro_sim_torch.io.checkpoint import load_sim_checkpoint
from corro_sim_torch.io.traces import TraceStream
from corro_sim_torch.workload.inject import trace_workload
from test_torch_twin import assert_same_shadow

FIXTURE = (pathlib.Path(__file__).parent / "fixtures" / "traces"
           / "flyio_live.ndjson")
NEW_ACTOR = "7c2e1a00-000e-4000-8000-00000000000e"
FAST = dict(poll_ms=10, reconnect_max_s=0.4, idle_timeout_s=0.5)
SOURCES = {"port": p_fs, "jax": r_fs}


@pytest.fixture(scope="module")
def live_lines():
    with open(FIXTURE, encoding="utf-8") as f:
        return [ln for ln in f if ln.strip()]


def _ref_cfg(lines, scan_lines=0, **twin_kw):
    uni = rt.twin_universe(lines, scan_lines)
    heads = rt.probe_feed_heads(lines, uni)
    overrides = twin_kw.pop("cfg_overrides", {})
    return dataclasses.replace(
        uni.suggest_config(rounds=int(heads.max(initial=0)) + 1,
                           **overrides),
        twin=RefTwinConfig(enabled=True, scan_lines=scan_lines,
                           chunk_lines=4, **twin_kw),
    ).validate()


def _port(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


def _strip_live(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in ("source", "feed")}


def _same_live(got, want):
    """Everything but the live-source block and the feed name."""
    assert _strip_live(got.report) == _strip_live(want.report)
    g = dataclasses.replace(got, report=_strip_live(got.report))
    w = dataclasses.replace(want, report=_strip_live(want.report))
    assert_same_shadow(g, w, ref_state=not hasattr(want, "host_reads"))


# ---------------------------------------------------------- feed sources

def _torn_tail(fs, tmp):
    feed = tmp / "feed.ndjson"
    feed.write_text('{"a": 1}\n{"a": 2}\n{"a": 3')
    src = fs.FileTailSource(str(feed), **FAST)
    try:
        first = src.wait_lines(2)
        held = (src.lag_lines, src.report()["torn_tail"])
        with open(feed, "a") as f:
            f.write("3}\n")
        return first, held, src.wait_lines(1), src.dead, (
            src.report()["torn_tail"])
    finally:
        src.close()


def _rotation(fs, tmp):
    feed = tmp / "feed.ndjson"
    lines = [f'{{"n": {i}}}\n' for i in range(10)]
    feed.write_text("".join(lines[:6]))
    src = fs.FileTailSource(str(feed), **FAST)
    try:
        first = src.wait_lines(4)
        os.rename(feed, tmp / "feed.ndjson.1")
        feed.write_text("".join(lines[6:]))
        return first, src.wait_lines(6), src.stats["rotations"], src.dead
    finally:
        src.close()


def _superset_copy(fs, tmp):
    feed = tmp / "feed.ndjson"
    lines = [f'{{"n": {i}}}\n' for i in range(6)]
    feed.write_text("".join(lines[:4]))
    src = fs.FileTailSource(str(feed), **FAST)
    try:
        first = src.wait_lines(4)
        os.remove(feed)
        feed.write_text("".join(lines))
        return first, src.wait_lines(2), src.stats["lines_delivered"]
    finally:
        src.close()


def _truncation(fs, tmp):
    feed = tmp / "feed.ndjson"
    feed.write_text('{"n": 0}\n{"n": 1}\n{"n": 2}\n')
    src = fs.FileTailSource(str(feed), **FAST)
    try:
        n = len(src.wait_lines(3))
        with open(feed, "w") as f:
            f.write('{"n": 0}\n')
        with pytest.raises(fs.FeedSourceError, match="truncated"):
            src.wait_lines(1)
        return n, src.dead, src.death_reason
    finally:
        src.close()


def _backoff_death(fs, tmp):
    feed = tmp / "feed.ndjson"
    feed.write_text('{"n": 0}\n')
    src = fs.FileTailSource(str(feed), **FAST)
    try:
        n = len(src.wait_lines(1))
        os.remove(feed)
        t0 = time.monotonic()
        out = src.wait_lines(1)
        fast = time.monotonic() - t0 < 10 * FAST["reconnect_max_s"]
        return (n, out, src.dead, src.death_reason,
                src.stats["retries"] >= 1, fast)
    finally:
        src.close()


def _idle_timeout(fs, tmp):
    feed = tmp / "feed.ndjson"
    feed.write_text('{"n": 0}\n')
    src = fs.FileTailSource(str(feed), **FAST)
    try:
        n = len(src.wait_lines(1))
        return n, src.wait_lines(1), src.dead, src.death_reason
    finally:
        src.close()


TAIL_CASES = {fn.__name__.lstrip("_"): fn for fn in (
    _torn_tail, _rotation, _superset_copy, _truncation, _backoff_death,
    _idle_timeout)}
TAIL_WANT = {
    "torn_tail": (['{"a": 1}\n', '{"a": 2}\n'], (0, True), ['{"a": 33}\n'],
                  False, False),
    "rotation": ([f'{{"n": {i}}}\n' for i in range(4)],
                 [f'{{"n": {i}}}\n' for i in range(4, 10)], 1, False),
    "superset_copy": ([f'{{"n": {i}}}\n' for i in range(4)],
                      ['{"n": 4}\n', '{"n": 5}\n'], 6),
    "truncation": (3, True, "truncated"),
    "backoff_death": (1, [], True, "source_gone", True, True),
    "idle_timeout": (1, [], True, "idle_timeout"),
}


@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_file_tail_case_matches(case, tmp_path):
    out = {}
    for name, fs in SOURCES.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = TAIL_CASES[case](fs, d)
    assert out["port"] == out["jax"] == TAIL_WANT[case]


def test_http_watch_source_against_api_relay(tmp_path, live_lines):
    from corro_sim.api.http import ApiServer
    from corro_sim.harness.cluster import LiveCluster

    feed = tmp_path / "feed.ndjson"
    feed.write_text("".join(live_lines[:8]))
    cluster = LiveCluster(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v INTEGER NOT NULL "
        "DEFAULT 0);",
        num_nodes=2, default_capacity=16,
    )
    try:
        with ApiServer(cluster, feed_path=str(feed)) as srv:
            url = f"http://{srv.addr[0]}:{srv.addr[1]}/v1/changes"
            src = p_fs.HTTPWatchSource(url, **FAST)
            assert src.wait_lines(8) == live_lines[:8]
            with open(feed, "a") as f:
                f.write("".join(live_lines[8:]))
            assert src.wait_lines(3) == live_lines[8:]
            assert src.report()["next_offset"] == len(live_lines)
            src.close()
        src2 = p_fs.HTTPWatchSource(url, **FAST)
        assert src2.wait_lines(1) == []
        assert src2.dead and src2.death_reason == "reconnect_budget"
        assert src2.stats["reconnects"] >= 1
    finally:
        cluster.tripwire.trip()


# ------------------------------------------ live == file == the JAX run

@pytest.mark.parametrize("rotate", [False, True], ids=["plain", "rotated"])
def test_tail_mode_equals_file_mode(tmp_path, live_lines, rotate):
    cfg = _ref_cfg(live_lines, scan_lines=10)
    ref = rt.run_twin(cfg=cfg, lines=live_lines, seed=0)
    filed = pt.run_twin(cfg=_port(cfg), lines=live_lines, seed=0,
                        device="cpu")
    assert_same_shadow(filed, ref)
    feed = tmp_path / "feed.ndjson"
    feed.write_text("".join(live_lines[:10] if rotate else live_lines))
    src = p_fs.FileTailSource(str(feed), **FAST)
    try:
        prefix = src.wait_lines(10)
        if rotate:  # the remaining line arrives on a new inode
            os.rename(feed, tmp_path / "feed.ndjson.1")
            feed.write_text("".join(live_lines[10:]))
        live = pt.run_twin(cfg=_port(cfg), lines=prefix, seed=0,
                           source=src, device="cpu")
    finally:
        src.close()
    assert live.source["dead"]
    assert live.source["death_reason"] == "idle_timeout"
    assert live.source["rotations"] == int(rotate)
    _same_live(live, filed)
    # the fixture's two late clears applied retroactively, on the device
    assert live.report["late_clears"] == 2
    assert live.report["late_applied"] == 2
    cleared = live.state.log.cleared.numpy()
    assert cleared[0, 2] and cleared[1, 0]  # TA1 v3, TA2 v1


# ------------------------------------------------- stale-universe refresh

def _refresh_feed(live_lines):
    """The fixture + 8 lines from an actor outside the frozen scan
    window, writing a value the interner never saw."""
    web1_pk = [1, 11, 5, 119, 101, 98, 45, 49]
    extra = []
    for v in range(1, 9):
        extra.append(json.dumps({
            "actor_id": NEW_ACTOR, "version": v,
            "changes": [{
                "table": "services", "pk": web1_pk, "cid": "name",
                "val": "refreshed", "col_version": 3 + v,
                "db_version": v, "seq": 0, "site_id": [0] * 16, "cl": 1,
            }],
            "seqs": [0, 0], "last_seq": 0, "ts": 1200 + 10 * v,
        }) + "\n")
    return list(live_lines) + extra


def _refresh_cfg(feed_lines, **twin_kw):
    return _ref_cfg(
        feed_lines, scan_lines=10, skip_bad=True, refresh_threshold=0.5,
        refresh_window_lines=4, cfg_overrides={"num_nodes": 4}, **twin_kw)


def test_refresh_fires_and_matches(live_lines):
    feed_lines = _refresh_feed(live_lines)
    cfg = _refresh_cfg(feed_lines)
    ref = rt.run_twin(cfg=cfg, lines=feed_lines, seed=0)
    got = pt.run_twin(cfg=_port(cfg), lines=feed_lines, seed=0,
                      device="cpu")
    assert_same_shadow(got, ref)
    ev = got.report["refresh"]["events"]
    assert got.report["refresh"]["epoch"] == 1 and len(ev) == 1
    assert ev[0]["actors_added"] == 1 and ev[0]["rank_moves"] > 0
    assert got.stream.universe.num_actors == 4
    assert int(got.stream.heads[3]) >= 1
    assert got.universe.values == ref.universe.values
    assert not got.poisoned and got.converged_round is not None


def test_refresh_deterministic_across_kill_resume(live_lines, tmp_path):
    feed_lines = _refresh_feed(live_lines)
    cfg = _port(_refresh_cfg(feed_lines, checkpoint_every=1))
    ckpt, kill = tmp_path / "t.npz", tmp_path / "t.kill.npz"

    def grab(h):
        # chunk 4's headline lands after the refresh fired at the
        # chunk-3 boundary: the copied token carries epoch 1 mid-feed
        if h["chunk"] == 4 and ckpt.exists():
            shutil.copy(ckpt, kill)

    full = pt.run_twin(cfg=cfg, lines=feed_lines, seed=0,
                       checkpoint_path=str(ckpt), on_chunk=grab,
                       device="cpu")
    assert full.report["refresh"]["epoch"] == 1
    tok = load_sim_checkpoint(str(kill))
    assert tok.meta["twin"]["refresh_epoch"] == 1
    resumed = pt.run_twin(cfg=cfg, lines=feed_lines, seed=0, resume=tok,
                          device="cpu")
    assert_same_shadow(resumed, full, ref_state=False)
    assert resumed.report["refresh"] == full.report["refresh"]


def test_refresh_refused_when_it_cannot_fit(live_lines):
    feed_lines = _refresh_feed(live_lines)
    cfg = _ref_cfg(feed_lines, scan_lines=10, skip_bad=True,
                   refresh_threshold=0.5, refresh_window_lines=4)
    assert cfg.num_nodes == 3
    ref = rt.run_twin(cfg=cfg, lines=feed_lines, seed=0)
    got = pt.run_twin(cfg=_port(cfg), lines=feed_lines, seed=0,
                      device="cpu")
    assert_same_shadow(got, ref)
    assert got.report["refresh"]["epoch"] == 0
    assert "actor" in got.report["refresh"]["refused"][0]["reasons"][0]
    assert got.report["bad_by_reason"]["unknown_actor"] == 8


# ------------------------------------------------------ cadence re-forks

def test_cadence_hook_every_n_chunks(live_lines, tmp_path):
    cfg = _port(_ref_cfg(live_lines, scan_lines=10, forecast_every=2,
                         checkpoint_every=1))
    calls = []

    def on_cycle(ctx):
        calls.append(ctx)
        return {"trend": {"fork_round": ctx["round"], "projected": True,
                          "cells": []}}

    ckpt = str(tmp_path / "c.npz")
    res = pt.run_twin(cfg=cfg, lines=live_lines, seed=0, on_cycle=on_cycle,
                      checkpoint_path=ckpt, device="cpu")
    assert [c["chunk"] for c in calls] == [2]
    assert res.trend == [{"fork_round": calls[0]["round"],
                          "projected": True, "cells": []}]
    assert sum(ch.rounds for ch in calls[0]["window_chunks"]) > 0
    assert load_sim_checkpoint(ckpt).meta["twin"]["trend"] == res.trend
    every = _port(_ref_cfg(live_lines, scan_lines=10, forecast_every=1))
    calls.clear()
    quiet = pt.run_twin(cfg=every, lines=live_lines, seed=0,
                        on_cycle=on_cycle, device="cpu")
    assert [c["chunk"] for c in calls] == [1, 2, 3]
    rounds = [c["round"] for c in calls]
    assert rounds == sorted(rounds)
    none = pt.run_twin(cfg=every, lines=live_lines, seed=0,
                       on_cycle=lambda ctx: None, device="cpu")
    assert none.trend == [] and not none.poisoned
    _same_live(none, quiet)


def test_trace_workload_matches(live_lines):
    cfg = _ref_cfg(live_lines)
    got_st = TraceStream(pt.twin_universe(live_lines, 0))
    want_st = RefTraceStream(rt.twin_universe(live_lines, 0))
    got_chunks = [got_st.feed(live_lines[i:i + 4]) for i in range(0, 12, 4)]
    want_chunks = [want_st.feed(live_lines[i:i + 4])
                   for i in range(0, 12, 4)]
    got = trace_workload(got_chunks, _port(cfg))
    want = r_trace_workload(want_chunks, cfg)
    assert got.name == want.name == "trace_window"
    assert (got.params, got.rounds, got.n, got.events) == (
        want.params, want.rounds, want.n, want.events)
    for f in ("writers", "rows", "cols", "vals", "dels", "ncells"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    got.validate(_port(cfg))
    assert got.total_writes == 8 and got.events[0][2]["dropped_sets"] == 1
    assert trace_workload([got_st.feed([])], _port(cfg)) is None
