"""Parity of the port's Prometheus exposition with the JAX package's on
the CPU.

- Every case of tests/test_metrics.py, each run as written on both
  packages by tests/test_torch_serving.py's harness, with the names of
  the record modules (``utils/compile_cache.py``, ``obs/ledger.py``,
  ``obs/doctor.py``) and the analysis modules (``analysis/lint.py``,
  ``analysis/transfer_guard.py``, ``analysis/contracts.py``,
  ``analysis/keys.py``) rebound too. The compile-cache case drives its
  probe with the JAX package's cache events; on the port's turn they are
  the port's kernel-library lookup events (a request, and a hit where
  the lookup needed no build). The lint case lints the JAX package's
  fixtures by path; on the port's turn each is the port's fixture of the
  same name (``tests/fixtures/torch_lint/``), which holds the same
  hazard for the port's rules.
- The rendered text of the same clusters driven alike on both packages
  (full and windowed SWIM, the probe tracer, a scenario armed, a
  subscription), compared line by line with the wall-clock series masked
  (stage walls, the buckets and sums of seconds histograms, process CPU
  seconds, thread and span counts) and with the process registries
  fresh on both sides; both texts pass the reference file's exposition
  validator. The help text of ``corro_subs_matcher_evals_total`` names
  the port's group evaluation where the JAX package's names its
  ``vmap``, and is left out. ``corro_db_size_bytes`` is the one line
  that differs by design: the port's resident bytes, larger where it
  keeps a leaf in a wider carrier (``convert.WIDENED``); the port's
  count of the same shapes at the JAX package's dtypes equals the JAX
  package's line.
- ``engine/sharding.py``'s byte counts (the JAX package's breakdown
  once the widened leaves are counted at the JAX dtypes) and
  ``export_metrics`` of the resilience scorecard against the JAX
  package's.

Tolerance: exact.
"""

import importlib
import os
import re
import types

import jax
import numpy as np
import pytest

import corro_sim.engine.sharding as r_sharding
import corro_sim.faults.scorecard as r_scorecard
import corro_sim.utils.metrics as r_metrics
from corro_sim.config import SimConfig as RConfig
from corro_sim_torch.config import SimConfig as PConfig
from corro_sim_torch.convert import _NARROW, WIDENED, _leaves
from corro_sim_torch.engine import sharding as p_sharding
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.faults import scorecard as p_scorecard
from corro_sim_torch.utils import metrics as p_metrics
from test_metrics import _validate_exposition
from test_torch_cluster import BOTH, one_torch_thread  # noqa: F401
from test_torch_serving import (  # noqa: F401 - a module fixture
    _BASIC, PAIRS, Bound, cases, reference_fixtures, run_both)

# cases that wait for a port module: none since the analysis tools
WAITING = ()
PARAMS = cases("test_metrics", WAITING)
# the record and analysis modules whose names the compile-cache,
# perf-ledger, doctor, lint and audit cases import
RECORD_MODULES = ("utils.compile_cache", "obs.ledger", "obs.doctor",
                  "analysis.lint", "analysis.transfer_guard",
                  "analysis.contracts", "analysis.keys")


def _record_pairs() -> list:
    out = []
    for path in RECORD_MODULES:
        rm = importlib.import_module(f"corro_sim.{path}")
        pm = importlib.import_module(f"corro_sim_torch.{path}")
        out += [(rm, attr, obj, getattr(pm, attr))
                for attr, obj in vars(rm).items()
                if not attr.startswith("__") and not isinstance(obj, _BASIC)
                and hasattr(pm, attr)]
    return out


class RecordBound(Bound):
    """:class:`Bound` with the record modules' names too; on the port's
    turn the JAX package's ``utils.compile_cache`` module, as a case
    imports it to drive its probe's events, reads the port's kernel-cache
    events in their place (a lookup served stands for a cache request
    served)."""

    pairs = PAIRS + _record_pairs()

    def port_extra(self, mp) -> None:
        import corro_sim.analysis.lint as r_lint
        import corro_sim.utils as r_utils
        from corro_sim_torch.analysis import lint as p_lint
        from corro_sim_torch.utils import compile_cache as p_cc

        mp.setattr(r_utils, "compile_cache", types.SimpleNamespace(
            _on_jax_event=p_cc._on_cache_event,
            _EVENT_REQUESTS=p_cc._EVENT_REQUESTS,
            _EVENT_HITS=p_cc._EVENT_HITS))
        # the JAX package's lint fixtures read as the port's of the same
        # name
        mp.setattr(r_lint, "lint_paths", lambda paths: p_lint.lint_paths(
            [p.replace(os.sep.join(("fixtures", "lint")),
                       os.sep.join(("fixtures", "torch_lint")))
             for p in paths]))


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, reference_fixtures, request,
                        fresh_registries):
    # fresh registries: the reference cases write fixed series into the
    # process registries, and tests/test_metrics.py, run later by the
    # same worker, asserts those series' exact values
    run_both(mod_name, name, reference_fixtures, request, bound=RecordBound)


SCHEMA = """
CREATE TABLE kv (
    k TEXT NOT NULL PRIMARY KEY,
    v TEXT NOT NULL DEFAULT ''
);
CREATE TABLE tags (
    id INTEGER NOT NULL PRIMARY KEY,
    tag TEXT NOT NULL DEFAULT ''
);
"""
# the lines whose values are wall-clock or process-wide: stage walls,
# the buckets and sums of seconds histograms, CPU seconds, threads and
# the tracer's spans
WALL = re.compile(
    r"^(corro_round_stage_ms|corro_tokio_total_busy_seconds"
    r"|corro_tokio_workers_count|corro_trace_span\w*"
    r"|\w+_seconds(_bucket|_sum))[{ ]")
SIZE = "corro_db_size_bytes "
# help texts the port words for its own mechanism
OWN_HELP = ("# HELP corro_subs_matcher_evals_total ",)
# series only the port has: the sync sweeps by serve path (the JAX
# package has one path) and SWIM's ticks, held by value below
PORT_ONLY = re.compile(r"^(# (HELP|TYPE) )?corro_(sync_serve|swim_ticks)"
                       r"_total[{ ]")


@pytest.fixture()
def fresh_registries(monkeypatch):
    """Empty process registries in both packages while a test runs
    (the modules that imported them keep writing to the same objects)."""
    for m in (r_metrics, p_metrics):
        for reg, field in ((m.counters, "_c"), (m.gauges, "_g"),
                           (m.histograms, "_h")):
            monkeypatch.setattr(reg, field, {})
            monkeypatch.setattr(reg, "_help", {})


def drive(c) -> None:
    c.execute(["INSERT INTO kv (k, v) VALUES ('a', 'x'), ('b', 'y')",
               "INSERT INTO tags (id, tag) VALUES (1, 'p')"], node=0)
    c.subscribe("SELECT k, v FROM kv")
    c.execute(["UPDATE kv SET v = 'z' WHERE k = 'a'"], node=2)
    c.set_alive(3, False)
    c.tick(6)
    c.load_scenario("lossy:p=0.2", rounds=8, seed=1)
    c.tick(5)
    c.set_alive(3, True)
    c.run_until_converged(max_rounds=128)


def masked(text: str) -> list:
    return [ln for ln in text.splitlines()
            if not WALL.match(ln) and not ln.startswith(OWN_HELP)
            and not PORT_ONLY.match(ln)]


OVERRIDES = {
    "full_swim_probes": {"swim_enabled": True, "probes": 2},
    "windowed_swim": {"swim_enabled": True, "swim_view_size": 4,
                      "swim_payload_members": 2, "narrow_state": True},
    "swim_off": {},
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_exposition_line_by_line(case, fresh_registries):
    texts, clusters = {}, {}
    for B in BOTH:
        c = B.LiveCluster(SCHEMA, num_nodes=6, seed=3, default_capacity=8,
                          cfg_overrides=OVERRIDES[case])
        drive(c)
        render = (r_metrics if B.key == "ref" else p_metrics)
        texts[B.key] = render.render_prometheus(c)
        clusters[B.key] = c
        _validate_exposition(texts[B.key])
        p_metrics.validate_exposition(texts[B.key])
    ref, port = masked(texts["ref"]), masked(texts["port"])
    assert len(port) == len(ref) > 150
    differ = [(a, b) for a, b in zip(ref, port) if a != b]
    # corro_db_size_bytes: the port's own bytes, the JAX package's plus
    # the widened leaves' extra bytes
    cfg = clusters["port"].cfg
    port_bytes = p_sharding.state_bytes(cfg)[0]
    assert differ == [(f"{SIZE}{port_bytes - widened_extra(cfg)}",
                       f"{SIZE}{port_bytes}")]
    # every sweep of the port's cluster served its lanes on the CPU path
    sweeps = int(clusters["port"].state.sync_rounds)
    assert sweeps > 0
    serve = [ln for ln in texts["port"].splitlines()
             if PORT_ONLY.match(ln) and "corro_sync_serve" in ln]
    assert serve[2:] == [f'corro_sync_serve_total{{path="torch"}} {sweeps}']
    # every full-view tick counted
    ticks = sum(float(ln.split()[-1]) for ln in texts["port"].splitlines()
                if ln.startswith("corro_swim_ticks_total{"))
    if cfg.swim_enabled and cfg.swim_view_size == 0:
        assert ticks > 0
    else:
        assert ticks == 0
    for c in clusters.values():
        c.tripwire.trip()


SIZES = {
    "config0_swim": dict(num_nodes=64, num_rows=32, num_cols=2,
                         swim_enabled=True),
    "narrow_windowed": dict(num_nodes=48, num_rows=16, num_cols=3,
                            swim_enabled=True, narrow_state=True,
                            swim_view_size=8, swim_payload_members=4),
    "probes_latency": dict(num_nodes=32, num_rows=8, num_cols=2, probes=4,
                           latency_regions=2, latency_inter=2,
                           rtt_rings=True),
    "big_log": dict(num_nodes=2048, num_rows=4, num_cols=1,
                    log_capacity=8),
}


def widened_extra(cfg, component=None) -> int:
    """The bytes by which the port's widened leaves (``convert.WIDENED``)
    outweigh the JAX package's dtypes, in all or in one component."""
    return sum(t.numel() * (t.element_size()
                            - np.dtype(_NARROW[t.dtype]).itemsize)
               for k, t in _leaves(init_state(cfg, device="meta"))
               if k in WIDENED
               and component in (None, p_sharding._component(k)))


@pytest.mark.parametrize("case", sorted(SIZES))
def test_state_bytes_match_the_jax_package(case):
    """``state_bytes_breakdown`` equals the JAX package's component by
    component (placement too: the log's regime flips at 2048 actors),
    but for the widened leaves' extra bytes."""
    kw = SIZES[case]
    rcfg, pcfg = RConfig(**kw).validate(), PConfig(**kw).validate()
    want = r_sharding.state_bytes_breakdown(rcfg)
    got = p_sharding.state_bytes_breakdown(pcfg)
    assert set(got) == set(want)
    for name, comp in got.items():
        extra = widened_extra(pcfg, name)
        assert comp == {"total": want[name]["total"] + extra,
                        "per_device": want[name]["per_device"] + extra,
                        "placement": want[name]["placement"]}, name
    total = r_sharding.state_bytes(rcfg)[0] + widened_extra(pcfg)
    assert p_sharding.state_bytes(pcfg) == (total, total)
    assert widened_extra(pcfg) > 0 or not kw.get("swim_enabled")


def test_resilience_export_matches(fresh_registries):
    """A finalized scorecard block lands in the same corro_resilience_*
    series, with the same help text, in both packages."""
    block = {"scenario": "crash_amnesia:nodes=3", "recovery_rounds": 8,
             "rows_lost": 0, "resync_rows": 153, "swim_false_down": 2,
             "swim_flaps": 1}
    r_scorecard.export_metrics(block)
    p_scorecard.export_metrics(block)
    r_scorecard.export_metrics(dict(block, scenario=None,
                                    recovery_rounds=None))
    p_scorecard.export_metrics(dict(block, scenario=None,
                                    recovery_rounds=None))
    for reg in ("counters", "histograms"):
        assert (getattr(p_metrics, reg).render()
                == getattr(r_metrics, reg).render())


BROKEN = {
    "no_newline": lambda t: t.rstrip("\n"),
    "duplicate_type": lambda t: t + "# TYPE corro_sim_rounds_total counter\n",
    "stray_comment": lambda t: t + "# note\n",
    "bad_label": lambda t: t + 'corro_sim_rounds_total{x=1} 2\n',
    "untyped_sample": lambda t: t + "corro_nowhere 1\n",
    "not_cumulative": lambda t: t.replace(
        'corro_sub_latency_rounds_bucket{le="128.0"} 3',
        'corro_sub_latency_rounds_bucket{le="128.0"} 1'),
    "inf_not_count": lambda t: t.replace(
        "corro_sub_latency_rounds_count 3",
        "corro_sub_latency_rounds_count 4"),
}


@pytest.mark.parametrize("case", [None] + sorted(BROKEN))
def test_validator_agrees_with_the_reference_check(case, fresh_registries):
    """The port's ``validate_exposition`` (what chip_smoke.py runs on a
    scrape) accepts what the reference file's check accepts and refuses
    what it refuses, on a rendered text and on broken copies of it."""
    c = BOTH[1].LiveCluster(SCHEMA, num_nodes=2, default_capacity=8)
    c.execute(["INSERT INTO kv (k, v) VALUES ('a', 'x')"])
    c.tick(2)
    for v in (0.0, 1.0, 2.0):
        c.histograms.observe(p_metrics.SUB_LATENCY_ROUNDS, v,
                             buckets=p_metrics.ROUNDS_BUCKETS)
    text = p_metrics.render_prometheus(c)
    if case is not None:
        broken = BROKEN[case](text)
        assert broken != text
        text = broken
    ref_ok = port_ok = True
    try:
        _validate_exposition(text)
    except AssertionError:
        ref_ok = False
    try:
        p_metrics.validate_exposition(text)
    except ValueError:
        port_ok = False
    assert port_ok == ref_ok == (case is None)


def test_jax_still_imported_only_here():
    """This file compares against the JAX package on the CPU."""
    assert jax.default_backend() == "cpu"
