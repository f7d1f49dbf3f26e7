"""Parity of the port's bench (``corro_sim_torch/benchmarks.py`` and
``python -m corro_sim_torch bench``) and its kernel-library cache probe
(``corro_sim_torch/utils/compile_cache.py``) with the JAX package's on the
CPU.

- tests/test_engine.py::test_baseline_bench_configs_smoke runs as written
  on both packages (``corro_sim.benchmarks`` is, on the port's turn, the
  port's module with ``device="cpu"``); each config's report has the JAX
  package's keys, and its outcome (metric, unit, converged, rounds and
  ``changes_applied``) equals the JAX package's.
- ``run_north_star(n=64)`` with ``CORRO_BENCH_REPEATS=1``: both modules'
  ``run_config_1`` is the same stub (the 64-agent leg is held by
  tests/test_torch_cluster.py's config 1 cases); the report's keys, the
  converged round and the flight's rounds equal the JAX package's.
- ``run_headline_bench(n=256, measured_chunks=2)`` journals the same
  per-round metrics through a ``FlightRecorder`` set as ``_FLIGHT``.
- ``bench --config 2 --nodes 16`` (the port's with ``--device cpu``)
  prints the JAX package's line and appends its ledger record, key for
  key, walls and ``env`` aside; as a child process it prints exactly one
  line.
- Without ``--device cpu`` and without a card, ``bench`` prints the JAX
  package's unmeasured shape, exits 1, writes the partial artifact and
  the ledger record, and runs nothing on the CPU.
- The kernel-library cache: a lookup that builds is a miss with the
  build's seconds, one that finds the library on disk or loaded is a hit,
  without nvcc; a run on the CPU looks nothing up.

Every test sets ``CORRO_BENCH_OUT`` and ``CORRO_PERF_LEDGER`` into
``tmp_path``. Walls (``WALL_FIELDS``, the pipeline's timings, a chunk's
walls) are masked by name; ``step_eqns_*`` (the JAX package's jaxpr
counts, the port's aten-node counts), ``env``, ``sharding`` and
``devices`` (the JAX package's tests run on an 8-device CPU mesh) are
compared by key.
Tolerance: exact.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch

import corro_sim
import corro_sim.benchmarks as r_bench
from corro_sim import cli as r_cli
from corro_sim.obs.flight import FlightRecorder as RFlight
from corro_sim_torch import benchmarks as p_bench
from corro_sim_torch import cli as p_cli
from corro_sim_torch.obs.flight import FlightRecorder as PFlight
from corro_sim_torch.utils import compile_cache as cc
from test_torch_cli import PIPELINE_PORT_ONLY, PIPELINE_TIMING
from test_torch_cluster import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# wall clock, the JAX package's compile provenance and the per-device
# facts its 8-device CPU mesh changes: compared by key only
BY_KEY = {"wall_per_round_ms", "sim_wall_per_round_ms", "compile_seconds",
          "compile_cache", "step_eqns_full", "step_eqns_repair", "env",
          "sharding", "devices", "wall_s", "chunk_walls_s",
          "run_total_wall_spread_s", "wall_seconds"}
CHUNK_WALLS = {"chunk_wall_s", "wall_s", "compile_s"}


def same_shape(ref, got, path="", walls=frozenset()) -> None:
    """``got`` has ``ref``'s keys wherever ``ref`` is a dict (the
    pipeline block: the JAX package's keys), and equal values but for the
    :data:`BY_KEY` fields and ``walls``, the pipeline's timings and a
    chunk's walls."""
    if isinstance(ref, dict):
        keys = set(got)
        if path.endswith("pipeline"):
            keys -= PIPELINE_PORT_ONLY
        assert keys == set(ref), (path, set(got) ^ set(ref))
        for k, v in ref.items():
            if k in BY_KEY or k in walls or (path.endswith("pipeline")
                                             and k in PIPELINE_TIMING):
                continue
            if path.endswith("chunks[]") and k in CHUNK_WALLS:
                continue
            same_shape(v, got[k], f"{path}.{k}", walls)
    elif isinstance(ref, list) and ref and isinstance(ref[0], dict):
        assert len(got) == len(ref), path
        for a, b in zip(ref, got):
            same_shape(a, b, f"{path}[]", walls)
    else:
        assert got == ref, (path, got, ref)


@pytest.fixture(autouse=True)
def bench_out(tmp_path, monkeypatch):
    """The bench's droppings and its working ledger in ``tmp_path``."""
    monkeypatch.setenv("CORRO_BENCH_OUT", str(tmp_path / "bench_out"))
    monkeypatch.setenv("CORRO_PERF_LEDGER", str(tmp_path / "ledger.ndjson"))
    monkeypatch.setenv("CORRO_GIT_REV", "testrev")
    return tmp_path


def _recorder(fns: dict, log: list) -> types.SimpleNamespace:
    """A ``benchmarks`` stand-in whose functions log their reports."""

    def wrap(name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            log.append((name, a, kw, out))
            return out
        return call

    return types.SimpleNamespace(**{k: wrap(k, f) for k, f in fns.items()})


CONFIG_FNS = ("run_config_1", "run_config_2", "run_config_3",
              "run_config_5")


def test_baseline_bench_configs_smoke_on_both_packages(monkeypatch):
    from test_engine import test_baseline_bench_configs_smoke as case

    logs = {"ref": [], "port": []}
    for key, mod, kw in (("ref", r_bench, {}),
                         ("port", p_bench, {"device": "cpu"})):
        fns = {n: (lambda f: lambda *a, **k: f(*a, **k, **kw))(
            getattr(mod, n)) for n in CONFIG_FNS}
        with monkeypatch.context() as mp:
            mp.setattr(corro_sim, "benchmarks",
                       _recorder(fns, logs[key]), raising=False)
            case()
    assert [x[:3] for x in logs["port"]] == [x[:3] for x in logs["ref"]]
    for (name, *_, want), (_, *_, got) in zip(logs["ref"], logs["port"]):
        if name == "run_config_1":  # its value is a wall
            assert set(got) == set(want)
            assert got["converged"] == want["converged"]
            continue
        same_shape(want, got, name)


def _round_records(flight) -> list:
    return [(r, dict(m)) for r, m in flight._rounds]


def test_north_star_at_64_nodes_matches_the_jax_package(monkeypatch):
    monkeypatch.setenv("CORRO_BENCH_REPEATS", "1")
    leg = {"metric": "devcluster_64_agents_1000_inserts_wall_s",
           "value": 0.9, "unit": "s", "inserts_per_sec": 1111.1,
           "per_insert_ms": 0.9, "converged": True}
    got = {}
    for key, mod, flight, kw in (("ref", r_bench, RFlight(), {}),
                                 ("port", p_bench, PFlight(),
                                  {"device": "cpu"})):
        monkeypatch.setattr(mod, "run_config_1", lambda **_: dict(leg))
        monkeypatch.setattr(mod, "_FLIGHT", flight)
        got[key] = (mod.run_north_star(n=64, **kw), flight)
    (want, rf), (out, pf) = got["ref"], got["port"]
    # the sim's wall, and the frozen devcluster wall it is scored against
    # (each package freezes its own)
    same_shape(want, out, "north_star", walls={
        "value", "vs_baseline", "baseline_frozen_wall_s",
        "baseline_frozen_per_insert_ms", "baseline_drift_pct",
        "baseline_drift_exceeded", "baseline_note"})
    assert out["sim_rounds_to_convergence"] == want[
        "sim_rounds_to_convergence"]
    assert out["sim_converged"] and out["donate"] is True
    assert out["devcluster_64_agents_wall_s"] == 0.9
    assert out["baseline_frozen_wall_s"] == p_bench.FROZEN_DEVCLUSTER[
        "wall_s"]
    assert _round_records(pf) == _round_records(rf)
    assert len(_round_records(pf)) == len(out["runs"][0]["chunk_walls_s"]) * 8


def test_headline_bench_journals_the_jax_packages_rounds(monkeypatch):
    got = {}
    for key, mod, flight, kw in (("ref", r_bench, RFlight(), {}),
                                 ("port", p_bench, PFlight(),
                                  {"device": "cpu"})):
        monkeypatch.setattr(mod, "_FLIGHT", flight)
        got[key] = (mod.run_headline_bench(n=256, measured_chunks=2, **kw),
                    flight)
    (want, rf), (out, pf) = got["ref"], got["port"]
    assert set(out) == set(want)
    assert out["metric"] == want["metric"] == (
        "crdt_changes_applied_per_sec_256_node_sim")
    assert out["value"] > 0
    rounds = _round_records(pf)
    assert [r for r, _ in rounds] == list(range(9, 25))
    assert rounds == _round_records(rf)
    assert ([e["attrs"]["chunk"] for e in pf.events("chunk")]
            == [e["attrs"]["chunk"] for e in rf.events("chunk")] == [1, 2])


def _run_cli(main, argv) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# ledger-record fields that are walls, provenance or the run's clock
RECORD_VOLATILE = {"seq", "ts", "wall", "platform", "device_kind",
                   "device_count"}


def test_bench_config2_line_and_ledger_record(tmp_path, monkeypatch):
    monkeypatch.setenv("CORRO_BENCH_NO_PREFLIGHT", "1")
    argv = ["bench", "--config", "2", "--nodes", "16"]
    lines, records = {}, {}
    for key, main in (("ref", r_cli.main),
                      ("port", lambda a: p_cli.main(["--device", "cpu", *a]))):
        led = tmp_path / f"{key}.ndjson"
        monkeypatch.setenv("CORRO_PERF_LEDGER", str(led))
        monkeypatch.setenv("CORRO_BENCH_OUT", str(tmp_path / key))
        rc, out = _run_cli(main, argv)
        assert rc == 0
        (line,) = out.splitlines()
        lines[key] = json.loads(line)
        records[key] = [json.loads(x) for x in led.read_text().splitlines()]
        assert (tmp_path / key / "BENCH_flight_config2.ndjson").exists()
    same_shape(lines["ref"], lines["port"], "config2")
    assert lines["port"]["env"] == {"platform": "cpu", "device_count": 1,
                                    "device_kind": "cpu"}
    assert lines["port"]["compile_cache"]["misses"] == 0
    (want,), (got,) = records["ref"], records["port"]
    assert set(got) == set(want)
    assert set(got["wall"]) == set(want["wall"])
    for k in set(want) - RECORD_VOLATILE - {"extra"}:
        assert got[k] == want[k], k
    assert got["platform"] == "cpu"
    same_shape(want["extra"], got["extra"], "extra")


def test_bench_child_prints_one_line(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "corro_sim_torch", "--device", "cpu", "bench",
         "--config", "2", "--nodes", "16"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    (line,) = r.stdout.splitlines()
    out = json.loads(line)
    assert out["metric"] == "config2_16_node_rounds_to_convergence"
    assert out["converged"]
    (rec,) = [json.loads(x) for x in open(env["CORRO_PERF_LEDGER"])]
    assert rec["source"] == "bench:config2" and rec["status"] == "measured"


def test_bench_without_a_card_is_unmeasured(tmp_path, monkeypatch):
    """No card and no ``--device cpu``: the preflight's child fails its
    three attempts, and ``bench`` prints the JAX package's unmeasured
    line, writes the partial artifact and the ledger record, and exits 1
    before running anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the preflight passes")
    monkeypatch.setattr(p_bench.time, "sleep", lambda s: None)
    monkeypatch.setattr(p_bench, "run_config_2", None)  # never reached
    rc, out = _run_cli(p_cli.main, ["bench", "--config", "2", "--nodes",
                                    "16"])
    assert rc == 1
    (line,) = out.splitlines()
    got = json.loads(line)
    assert set(got) == {"metric", "value", "vs_baseline", "error", "note",
                        "partial_artifact"}
    assert got["metric"] == "bench_run_config_2_unmeasured"
    assert got["value"] is None and got["vs_baseline"] is None
    assert got["error"].startswith("device preflight failed: device probe "
                                   "failed (rc=1)")
    assert got["error"].endswith("(3 attempts, exponential backoff)")
    partial = json.load(open(got["partial_artifact"]))
    assert partial["status"] == "died" and partial["config"] == 2
    assert partial["error"] == got["error"]
    (rec,) = [json.loads(x) for x in
              open(tmp_path / "ledger.ndjson")]
    assert rec["status"] == "unmeasured" and rec["platform"] == "unknown"
    assert rec["config"] == "bench/config_2"


def test_waiting_commands_are_the_auditors_and_the_mesh():
    """Nothing waits any more: the auditors' family (`lint`, `audit`,
    `run --transfer-guard`) runs, as `run --mesh` and `sweep --mesh` do
    (tests/test_torch_cli.py holds their reports)."""
    assert not hasattr(p_cli, "WAITING")
    parser = p_cli.build_parser()
    (sub,) = [a for a in parser._actions if hasattr(a, "choices")
              and isinstance(a.choices, dict) and "lint" in a.choices]
    assert {"lint", "audit"} <= set(sub.choices)
    args = parser.parse_args(["run", "--transfer-guard"])
    assert args.transfer_guard is True


# ------------------------------------------- the kernel-library cache

def _fake_build(calls: list):
    def build(tmp):
        calls.append(tmp)
        tmp.write_bytes(b"\x7fELF")
        return "ptxas info: 0 bytes spill"
    return build


def test_kernel_cache_hit_and_miss_without_nvcc(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("__global__ void k() {}\n")
    build_dir = tmp_path / "_build"
    calls: list = []
    probe = cc.CompileCacheProbe(emit_metrics=False)

    probe.begin()
    first = cc.fetch_library(src, "k", _fake_build(calls), build_dir)
    assert probe.end("k", first["seconds"]) == "miss"
    assert first["status"] == "miss" and len(calls) == 1
    assert first["log"] == "ptxas info: 0 bytes spill"
    key = cc.program_cache_key(src.read_bytes())
    assert first["key"] == key
    assert first["library"] == str(build_dir / f"libk_{key}.so")
    assert os.path.exists(first["library"])
    assert not list(build_dir.glob("*.tmp"))

    probe.begin()  # on disk: found, not built
    again = cc.fetch_library(src, "k", _fake_build(calls), build_dir)
    assert probe.end("k", again["seconds"]) == "hit"
    assert again["status"] == "hit" and len(calls) == 1
    probe.begin()  # loaded already: not even looked for on disk
    loaded = cc.fetch_library(src, "k", None, tmp_path / "elsewhere",
                              loaded=True)
    assert probe.end("k", loaded["seconds"]) == "hit"
    probe.begin()  # nothing looked up
    assert probe.end("k", 0.0) == "unknown"
    s = probe.summary()
    assert (s["hits"], s["misses"], s["unknown"]) == (2, 1, 1)
    assert s["cold_seconds"] == round(first["seconds"], 6)
    assert s["by_program"]["k"]["misses"] == 1

    # an edited source or other flags make another library
    src.write_text("__global__ void k2() {}\n")
    assert cc.program_cache_key(src.read_bytes()) != key
    assert cc.program_cache_key(b"x", ("-O2",)) != cc.program_cache_key(
        b"x", ("-O3",))
    assert cc.fetch_library(src, "k", _fake_build(calls),
                            build_dir)["status"] == "miss"
    assert len(calls) == 2
    assert cc.cache_dir() == os.path.join(
        ROOT, "corro_sim_torch", "_build")


def test_cpu_run_looks_nothing_up():
    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine.state import init_state

    cfg = SimConfig(num_nodes=8, num_rows=8, num_cols=1, log_capacity=64,
                    write_rate=0.5, swim_enabled=False, sync_interval=4)
    before = dict(cc._CACHE_EVENTS)
    res = run_sim(cfg, init_state(cfg, seed=0, device="cpu"),
                  Schedule(write_rounds=2), max_rounds=8, chunk=4, seed=0,
                  device="cpu")
    assert res.compile_cache == {"hits": 0, "misses": 0, "unknown": 0,
                                 "cold_seconds": 0.0, "by_program": {}}
    assert cc._CACHE_EVENTS == before
