"""SWIM's own ranges and counters, on the CPU at a tiny size.

- Under ``torch.profiler`` a full-view tick opens ``corro.swim.probe``,
  ``.timeout``, ``.exchange``, ``.announce`` (announce ticks only) and
  ``.refute`` as disjoint siblings inside the step's ``corro.step.swim``.
- With no profiler recording, a tick builds no range.
- ``corro_swim_ticks_total{announce}`` counts the ticks, by whether
  they announce.
- ``simbench/swim_work.py`` gives a hand count's bytes in both layouts.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from test_torch_stage_spans import Recorder
from torch.profiler import ProfilerActivity, profile

from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig
from corro_sim_torch.engine import step as step_mod
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.membership import swim as swim_mod
from corro_sim_torch.utils import metrics
from simbench import swim_work

SWIM_RANGES = ("corro.swim.probe", "corro.swim.timeout",
               "corro.swim.exchange", "corro.swim.announce",
               "corro.swim.refute")


def _cfg(narrow: bool = False) -> SimConfig:
    return SimConfig(num_nodes=16, num_rows=16, num_cols=2, log_capacity=64,
                     write_rate=0.5, swim_enabled=True, swim_interval=1,
                     sync_interval=1, narrow_state=narrow,
                     swim_payload_members=4)


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _round(cfg, round_idx: int):
    state = init_state(cfg, seed=0, device="cpu")
    alive = torch.ones(cfg.num_nodes, dtype=torch.bool)
    part = torch.zeros(cfg.num_nodes, dtype=torch.int32)
    return step_mod.sim_step(cfg, state, prng.PRNGKey(3), alive, part, True,
                             round_idx)


@pytest.mark.parametrize("round_idx,announce", [(8, True), (9, False)],
                         ids=["announce", "plain"])
def test_swim_ranges_are_siblings_inside_the_swim_stage(round_idx, announce,
                                                         monkeypatch):
    rec = Recorder(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        _round(_cfg(), round_idx)
    ranges = rec.intervals()
    (stage,) = [r for r in ranges if r[0] == "corro.step.swim"]
    inner = [r for r in ranges if r[0].startswith("corro.swim.")]
    want = [n for n in SWIM_RANGES if announce or n != "corro.swim.announce"]
    assert [r[0] for r in inner] == want
    assert all(stage[1] < r[1] and r[2] < stage[2] for r in inner)
    for (_, _, e), (_, s_next, _) in zip(inner, inner[1:]):
        assert s_next > e  # siblings, never nested
    # nothing else opens inside the swim stage
    assert [r for r in ranges if stage[1] < r[1] < stage[2]] == inner


def test_a_tick_builds_no_range_without_a_profiler(monkeypatch):
    built = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: built.append(name) or real(name))
    _round(_cfg(), 8)
    assert built == []


@pytest.mark.parametrize("narrow", [False, True], ids=["wide", "narrow"])
def test_the_counter_counts_ticks(narrow):
    cfg = _cfg(narrow)

    def read():
        return (metrics.counters.get(metrics.SWIM_TICKS_TOTAL,
                                     '{announce="1"}'),
                metrics.counters.get(metrics.SWIM_TICKS_TOTAL,
                                     '{announce="0"}'))

    before = read()
    for r in range(8, 13):  # ticks 8 and 12 announce
        _round(cfg, r)
    after = read()
    assert [a - b for a, b in zip(after, before)] == [2, 3]
    # a round between ticks is no tick
    slow = dataclasses.replace(cfg, swim_interval=4)
    assert not swim_mod.tick_round(slow, 9)
    _round(slow, 9)
    assert read() == after


@pytest.mark.parametrize("narrow,b", [(False, 4), (True, 2)],
                         ids=["wide", "narrow"])
@pytest.mark.parametrize("payload", [4, 64], ids=["bounded", "full"])
def test_swim_work_is_the_hand_count(narrow, b, payload):
    n, rows, peers = 16, 16, 3
    plane = 2 * 16 * 16  # read once, written once
    carried = min(payload, n)
    per_peer = 2 * 16 * carried + (2 * 16 if payload < n else 0)
    announce = 2 * 16 * 16
    hand = b * (plane + peers * per_peer)
    assert swim_work.tick_bytes(n, rows, narrow, payload, peers,
                                False) == hand
    assert swim_work.tick_bytes(n, rows, narrow, payload, peers,
                                True) == hand + b * announce
    # wide and bounded, written out: 4 * (512 + 3 * (128 + 32) + 512)
    if not narrow and payload == 4:
        assert swim_work.tick_bytes(n, rows, narrow, payload, peers,
                                    True) == 4 * 1504
