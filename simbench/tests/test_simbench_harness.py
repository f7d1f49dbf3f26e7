"""The harness: every cell resolves, names and units keep to their
characters, a run fails without a card, the import check compares whole
top-level names, the trace arithmetic, and that a cell is added by files
and entries alone.

Run with ``python -m pytest simbench/tests`` from the repository root.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from simbench import cells, run, trace
from simbench.e2e import converge_s, peak_gib, round_ms
from simbench.metrics import (
    device_idle_pct,
    dispatch_ms_per_round,
    launches_per_round,
    merge_roofline_pct,
    sync_ms_per_round,
)

ROOT = cells.ROOT
BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = cells.resolve_cell(BENCH, name)
    assert cell.chips == 1
    assert cell.config["sim"]["num_nodes"] > 0
    assert cell.traffic["mode"] in ("converge", "fixed")
    e2e = {m["name"] for m, _ in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for entry, mod in cell.end_to_end + cell.per_layer:
        assert mod.UNIT == entry["unit"]
    for entry, mod in cell.per_layer:
        assert mod.LAYER == entry["layer"]
        assert mod.MOVES == entry["moves"].split(".")[0]
        assert entry["moves"] in e2e
        assert mod.SOURCE == entry["source"]
    # the traced window lies inside what a cluster runs
    t = cell.traffic["trace"]
    assert 0 <= t["from_round"] and t["rounds"] > 0
    assert t["from_round"] % cell.traffic["chunk"] == 0


def test_names_units_and_limits():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(b)) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = []
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"])
        assert c["file"].startswith("simbench/") and (ROOT / c["file"]).is_file()
        assert c["name"] in used and len(c["reduced"]) <= 16
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank")) and "width" not in k
        names.append(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
        for w in m.get("workloads", []):
            assert w in CELLS
    assert len(names) == len(set(names))
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_run_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(2 ** 31 + 7),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA device" in out.err


def test_run_fails_with_too_few_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_import_check_compares_whole_top_level_names(monkeypatch):
    fake = {"corro_sim_torch": None, "corro_sim_torch.engine": None,
            "jax_like": None, "flaxen": None}
    monkeypatch.setattr(sys, "modules", {**fake})
    assert run.forbidden_modules() == []
    for name, top in (("corro_sim.core", "corro_sim"), ("jaxlib", "jaxlib"),
                      ("jax.numpy", "jax"), ("flax", "flax")):
        monkeypatch.setattr(sys, "modules", {**fake, name: None})
        assert run.forbidden_modules() == [top]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run, in a fresh process, on the CPU at a tiny size: main
    returns 4 and prints no result where the window loaded a forbidden
    module."""
    from simbench.tests.tiny_root import make_tiny_root

    make_tiny_root(tmp_path)
    code = ("import sys, torch\n"
            "from pathlib import Path\n"
            "from simbench import run\n"
            f"rc = run.main(['--workload', '{CELLS[0]}', '--seed', '5', "
            "'--seconds', '0.5', '--trace', '0'], "
            f"device=torch.device('cpu'), root=Path({str(tmp_path)!r}))\n"
            "print('RC', rc, run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "RC 0 []"


def test_a_bare_checkout_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and ``simbench/``,
    the command exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "simbench", tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "simbench.run", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


# -- the trace arithmetic, on a fixture: two kernels launched inside a
# "simbench.sync_round" range, one outside, a copy, and the host's ops

def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0 if cat not in trace.DEVICE_CATS else 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


FIXTURE = [
    _ev("cpu_op", "aten::step", 0, 100),
    _ev("user_annotation", "simbench.sync_round", 10, 40),
    _ev("cuda_runtime", "cudaLaunchKernel", 12, 3, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 20, 3, corr=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=3),
    _ev("cuda_runtime", "cudaEventSynchronize", 70, 25),
    _ev("cuda_runtime", "cudaMemcpyAsync", 66, 2, corr=4),
    _ev("kernel", "grouped_merge_kernel<8>", 15, 10, tid=7, corr=1),
    _ev("kernel", "scatter_max", 25, 5, tid=7, corr=2),
    _ev("kernel", "fill", 62, 8, tid=7, corr=3),
    _ev("gpu_memcpy", "Memcpy DtoH", 70, 10, tid=8, corr=4),
]


def test_trace_arithmetic():
    red = trace.reduce_trace(FIXTURE, ["simbench.sync_round"])
    assert red["window_us"] == 100
    # device slices 15-30 and 62-80
    assert red["busy_us"] == 15 + 18
    assert red["kernels"] == 3
    assert red["dispatch_us"] == 11
    assert red["range_us"] == {"simbench.sync_round": 15}
    assert red["by_name"]["fill"] == [1, 8]
    # idle 0-15 in the step before the range, 30-62 with the range open,
    # 80-100 in the event wait
    assert red["idle_by_host"] == {"aten::step": 15,
                                   "simbench.sync_round": 32,
                                   "cudaEventSynchronize": 20}
    run_ns = types.SimpleNamespace(trace=red, traced_rounds=2)
    assert launches_per_round.read(run_ns) == 1.5
    assert dispatch_ms_per_round.read(run_ns) == pytest.approx(0.0055)
    assert sync_ms_per_round.read(run_ns) == pytest.approx(0.0075)
    assert device_idle_pct.read(run_ns) == pytest.approx(67.0)
    b = trace.breakdown(red)
    assert b["device_ops"][0] == ["grouped_merge_kernel<8>", 10 / 1e6]
    assert b["idle_gaps"][0] == ["simbench.sync_round", 32 / 1e6]


def test_nested_ranges_take_the_innermost():
    evs = [_ev("user_annotation", "a", 0, 100),
           _ev("user_annotation", "b", 10, 20),
           _ev("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
           _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
           _ev("kernel", "k", 16, 4, tid=7, corr=1),
           _ev("kernel", "k", 52, 6, tid=7, corr=2)]
    red = trace.reduce_trace(evs, ["a", "b"])
    assert red["range_us"] == {"a": 6, "b": 4}


def test_merge_roofline_reads_bytes_over_kernel_time():
    # 3.35e6 bytes in 2 us at 3.35 TB/s: half the roofline
    run_ns = types.SimpleNamespace(
        sample_work={"merge_roofline_pct": [1.675e6, 1.675e6]},
        sample_kernel_us=lambda frag: trace.kernel_us(
            [_ev("kernel", "void grouped_merge_kernel<640>", 0, 1.0),
             _ev("kernel", "void grouped_merge_kernel<640>", 5, 1.0),
             _ev("kernel", "other", 2, 50.0)], frag))
    assert merge_roofline_pct.read(run_ns) == pytest.approx(50.0)
    run_ns.sample_work = {}
    assert merge_roofline_pct.read(run_ns) is None


def test_merge_bytes_counts_a_small_mailbox():
    from simbench.work import merge_bytes

    n, cells_, cols, cap = 2, 4, 2, 2
    before = (torch.zeros(n, cells_, dtype=torch.int32),
              torch.full((n, cells_), -(2 ** 31), dtype=torch.int32),
              torch.full((n, cells_), -1, dtype=torch.int32),
              torch.zeros(n, cells_ // cols, dtype=torch.int32))
    lanes = torch.zeros(6, n * cap, dtype=torch.int32)
    # one valid lane: node 0, cell 1, cv 1, value 5, site 3, cl 1
    lanes[:, 0] = torch.tensor([1, 1, 5, 3, 1, 1])
    after = tuple(t.clone() for t in before)
    after[0][0, 1], after[1][0, 1], after[2][0, 1] = 1, 5, 3
    after[3][0, 0] = 1
    # lane words: 4 valid words + cell + cl + vr + cv + site = 9; the cl
    # of the hit row 1; the grown row: its cl and 3 planes x 2 cells = 7
    assert merge_bytes(before, lanes, cap, cols, after) == 4 * (9 + 1 + 7)


def test_end_to_end_readers():
    win = types.SimpleNamespace(
        wall_s=10.0, rounds=100, peak_bytes=3 * 2 ** 30, setup_s=4.0,
        clusters=[{"wall_s": 2.0, "converged_round": 20},
                  {"wall_s": 4.0, "converged_round": 22},
                  {"wall_s": 9.0, "converged_round": None}])
    assert round_ms.read(win) == 100.0
    assert converge_s.read(win) == 3.0
    assert peak_gib.read(win) == 3.0
    win.clusters = []
    assert converge_s.read(win) is None


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and "out" not in p.parts}


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    root = tmp_path
    shutil.copytree(ROOT / "simbench", root / "simbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = _digest(root / "simbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg["sim"]["num_nodes"] = 2048
    (root / "simbench/configs/new_2k.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "simbench/traffic/converge.json").read_text())
    mix["write_rounds"] = 4
    (root / "simbench/traffic/burst4.json").write_text(json.dumps(mix))
    (root / "simbench/metrics/rounds_traced.py").write_text(
        'UNIT = "rounds"\nLAYER = "driver (engine/driver.py::run_sim)"\n'
        'MOVES = "round_ms"\nSOURCE = "program_counter"\n\n\n'
        'def read(run):\n    return run.traced_rounds\n')
    bench["configs"].append({"name": "new_2k", "source": "x",
                             "file": "simbench/configs/new_2k.json",
                             "reduced": ["num_nodes"], "why": "x"})
    bench["workloads"].append({"name": "new_2k.burst4", "config": "new_2k",
                               "traffic": "burst4", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "rounds_traced", "unit": "rounds", "better": "higher",
        "source": "program_counter",
        "layer": "driver (engine/driver.py::run_sim)", "moves": "round_ms",
        "workloads": ["new_2k.burst4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.resolve_cell(cells.load_benchmark(root), "new_2k.burst4",
                              root)
    assert cell.config["sim"]["num_nodes"] == 2048
    assert cell.traffic["write_rounds"] == 4
    assert "rounds_traced" in [m["name"] for m, _ in cell.per_layer]
    ns = types.SimpleNamespace(traced_rounds=24)
    mod = dict((m["name"], mod) for m, mod in cell.per_layer)
    assert mod["rounds_traced"].read(ns) == 24
    after = _digest(root / "simbench")
    assert {k: v for k, v in after.items() if k in before} == before
