"""The port stands alone: corro_sim_torch and chip_smoke.py import no JAX
and nothing of the JAX package, and the entry points refuse to run on a
machine without CUDA unless asked for the CPU."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from corro_sim_torch import config as pconfig
from corro_sim_torch import prng
from corro_sim_torch.engine.driver import run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.gossip.broadcast import broadcast_step, make_gossip_state

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "corro_sim_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import corro_sim_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(corro_sim_torch.__path__,"
        " 'corro_sim_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "missing = [m for m in ('corro_sim_torch.utils.spec',"
        " 'corro_sim_torch.workload.generators',"
        " 'corro_sim_torch.workload.inject', 'corro_sim_torch.io.columns',"
        " 'corro_sim_torch.io.values', 'corro_sim_torch.io.traces',"
        " 'corro_sim_torch.engine.replay', 'corro_sim_torch.obs.flight',"
        " 'corro_sim_torch.utils.metrics', 'corro_sim_torch.utils.tracing',"
        " 'corro_sim_torch.utils.runtime', 'corro_sim_torch.engine.features',"
        " 'corro_sim_torch.faults', 'corro_sim_torch.faults.masks',"
        " 'corro_sim_torch.faults.inject', 'corro_sim_torch.faults.nodes',"
        " 'corro_sim_torch.faults.scenarios',"
        " 'corro_sim_torch.faults.invariants',"
        " 'corro_sim_torch.faults.scorecard',"
        " 'corro_sim_torch.membership.rtt', 'corro_sim_torch.engine.probe',"
        " 'corro_sim_torch.obs.probes', 'corro_sim_torch.io.checkpoint',"
        " 'corro_sim_torch.sweep', 'corro_sim_torch.sweep.knobs',"
        " 'corro_sim_torch.sweep.plan', 'corro_sim_torch.sweep.engine',"
        " 'corro_sim_torch.sweep.frontier', 'corro_sim_torch.obs.lanes',"
        " 'corro_sim_torch.utils.ranks', 'corro_sim_torch.schema',"
        " 'corro_sim_torch.io.feedsource', 'corro_sim_torch.engine.twin',"
        " 'corro_sim_torch.functions', 'corro_sim_torch.subs',"
        " 'corro_sim_torch.subs.query', 'corro_sim_torch.subs.manager',"
        " 'corro_sim_torch.api', 'corro_sim_torch.api.exprs',"
        " 'corro_sim_torch.api.statements', 'corro_sim_torch.api.sql_state',"
        " 'corro_sim_torch.api.wire', 'corro_sim_torch.harness',"
        " 'corro_sim_torch.harness.cluster', 'corro_sim_torch.benchmarks',"
        " 'corro_sim_torch.api.http', 'corro_sim_torch.api.pg',"
        " 'corro_sim_torch.client', 'corro_sim_torch.admin',"
        " 'corro_sim_torch.workload.harness',"
        " 'corro_sim_torch.engine.sharding', 'corro_sim_torch.io.config_file',"
        " 'corro_sim_torch.engine.ranks', 'corro_sim_torch.engine.mesh_jobs',"
        " 'corro_sim_torch.membership.bootstrap',"
        " 'corro_sim_torch.harness.devcluster', 'corro_sim_torch.tls',"
        " 'corro_sim_torch.tpl', 'corro_sim_torch.integrations',"
        " 'corro_sim_torch.integrations.consul', 'corro_sim_torch.cli',"
        " 'corro_sim_torch.__main__', 'corro_sim_torch.workload',"
        " 'corro_sim_torch.obs.ledger', 'corro_sim_torch.obs.doctor',"
        " 'corro_sim_torch.obs.profile',"
        " 'corro_sim_torch.utils.compile_cache',"
        " 'corro_sim_torch.analysis', 'corro_sim_torch.analysis.rules',"
        " 'corro_sim_torch.analysis.lint',"
        " 'corro_sim_torch.analysis.transfer_guard',"
        " 'corro_sim_torch.analysis.fx_audit',"
        " 'corro_sim_torch.analysis.dataflow',"
        " 'corro_sim_torch.analysis.contracts',"
        " 'corro_sim_torch.analysis.keys', 'corro_sim_torch.io.native')"
        " if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'corro_sim' or m.startswith('corro_sim.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cli_imports_only_the_standard_library():
    """``import corro_sim_torch.cli`` pulls in no JAX, nothing of the JAX
    package, no ``cryptography`` and no torch: ``--help`` and the client
    commands need neither a card nor the optional packages."""
    code = (
        "import sys\n"
        "import corro_sim_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'corro_sim', 'cryptography', 'torch', 'numpy')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_lint_runs_without_torch_or_numpy(tmp_path):
    """The lint is pure AST, as the JAX package's is: ``python -m
    corro_sim_torch lint`` lints the port's tree and writes its JSON
    report with torch and numpy shadowed by import bombs."""
    for mod in ("torch", "numpy", "jax"):
        (tmp_path / f"{mod}.py").write_text(
            f'raise ImportError("{mod} blocked for the pure-AST test")\n')
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = tmp_path / "lint.json"
    proc = subprocess.run(
        [sys.executable, "-m", "corro_sim_torch", "lint", "corro_sim_torch",
         "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(out.read_text())
    assert rep["findings"] == [] and rep["files_scanned"] > 100


def test_cli_commands_refuse_without_cuda(tmp_path):
    """``run``, ``agent`` and the other commands that build tensors run on
    CUDA unless given ``--device cpu``; without a card they raise
    ``resolve_device``'s error before any work."""
    from corro_sim_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    schema = tmp_path / "s.sql"
    schema.write_text("CREATE TABLE t (id INTEGER PRIMARY KEY);")
    topo = tmp_path / "topo.txt"
    topo.write_text("A -> B\n")
    for argv in (["run", "--nodes", "8"],
                 ["agent", "--schema", str(schema),
                  "--admin-path", str(tmp_path / "a.sock")],
                 ["devcluster", str(topo), "--schema", str(schema)],
                 ["soak", "--nodes", "8"], ["sweep", "scenario=lossy"],
                 ["twin", str(schema)], ["load", "zipf"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert not (tmp_path / "a.sock").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "corro_sim"), (
                f"{path.name} imports {name}"
            )


def _small_cfg(**kw):
    return pconfig.SimConfig(
        num_nodes=8, num_rows=32, num_cols=4, swim_enabled=False, **kw
    )


def test_entry_points_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    cfg = _small_cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg)
    state = init_state(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sim(cfg, state, max_rounds=4, chunk=4)


def test_live_cluster_refuses_without_cuda(tmp_path):
    """LiveCluster, config 1 and the LiveCluster checkpoint loaders run
    on CUDA unless given ``device="cpu"``."""
    from corro_sim_torch.benchmarks import run_config_1
    from corro_sim_torch.harness.cluster import LiveCluster
    from corro_sim_torch.io.checkpoint import (
        load_checkpoint,
        restore,
        save_checkpoint,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    schema = "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveCluster(schema, num_nodes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_config_1(inserts=4, nodes=2)
    c = LiveCluster(schema, num_nodes=2, device="cpu")
    assert c.state.table.vr.device.type == "cpu"
    path = tmp_path / "c.npz"
    save_checkpoint(c, path)
    for load in (load_checkpoint, restore):
        with pytest.raises(RuntimeError, match="CUDA"):
            load(path)
        assert load(path, device="cpu").device.type == "cpu"


def test_serving_entry_points_refuse_without_cuda():
    """The load harness, config 6 and the sweep's neutral knob leaf run
    on CUDA unless given ``device="cpu"``."""
    from corro_sim_torch.benchmarks import config6_live_run, run_config_6
    from corro_sim_torch.sweep.knobs import neutral_knobs
    from corro_sim_torch.workload import make_workload
    from corro_sim_torch.workload.harness import load_cluster, run_live_load

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    wl = make_workload("zipf:alpha=1.0,rate=0.5,keys=8", 2, rounds=2)
    for call in (lambda: run_live_load(wl, subs=1, settle_rounds=4),
                 lambda: load_cluster(wl),
                 lambda: config6_live_run(2, 2, subs=2, sub_queries=1),
                 lambda: run_config_6(nodes=2, subs=2, rounds=2),
                 lambda: neutral_knobs(_small_cfg())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    rep = run_live_load(wl, subs=1, settle_rounds=8, device="cpu")
    assert rep.nodes == 2


@pytest.mark.parametrize("change", [
    dict(sweep=pconfig.SweepConfig(lanes=2)),
])
def test_unported_features_are_refused(change):
    """The sweep's union config runs on one device and over a device
    mesh, its lanes and their nodes sharded; what a mesh still refuses,
    by design, is the compacted dispatch, with its reason."""
    from corro_sim_torch.engine.sharding import Mesh
    from corro_sim_torch.sweep import build_plan
    from corro_sim_torch.sweep.engine import run_sweep

    cfg = dataclasses.replace(_small_cfg(), **change)
    assert pconfig.validate_torch_slice(cfg) is cfg
    plan = build_plan(_small_cfg(), ["lossy:p=0.1"], [0], rounds=16,
                      write_rounds=4)
    with pytest.raises(ValueError, match="power-of-2 buckets"):
        run_sweep(plan, device="cpu", compact=True, mesh=Mesh(
            ("sweep", "nodes"), {"sweep": 1, "nodes": 2},
            {"sweep": 0, "nodes": 0}, None, "cpu"))


def test_serving_entry_points_refuse_without_cuda():
    """The load harness, config 6 and the sweep's neutral knob leaf run
    on CUDA unless given ``device="cpu"``."""
    from corro_sim_torch.benchmarks import config6_live_run, run_config_6
    from corro_sim_torch.sweep.knobs import neutral_knobs
    from corro_sim_torch.workload import make_workload
    from corro_sim_torch.workload.harness import load_cluster, run_live_load

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    wl = make_workload("zipf:alpha=1.0,rate=0.5,keys=8", 2, rounds=2)
    for call in (lambda: run_live_load(wl, subs=1, settle_rounds=4),
                 lambda: load_cluster(wl),
                 lambda: config6_live_run(2, 2, subs=2, sub_queries=1),
                 lambda: run_config_6(nodes=2, subs=2, rounds=2),
                 lambda: neutral_knobs(_small_cfg())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    rep = run_live_load(wl, subs=1, settle_rounds=8, device="cpu")
    assert rep.nodes == 2


@pytest.mark.parametrize("change", [
    dict(swim_enabled=True, rtt_rings=True),
    dict(emit_slots=4, pend_slots=8, sync_hot_actors=0),
    dict(emit_slots=1, sync_deal_probes=2), dict(sync_hot_actors=0),
    dict(sync_deal_probes=1), dict(probes=1), dict(rtt_rings=True),
    dict(latency_regions=2), dict(faults=pconfig.FaultConfig(loss=0.1),
                                  probes=1),
    dict(node_faults=pconfig.NodeFaultConfig(skew=((0, 3),)),
         rtt_rings=True),
    dict(latency_regions=2, rtt_rings=True, probes=2, narrow_state=True),
])
def test_lifted_refusals_are_admitted(change):
    """The legacy and deal-probe sync schedules, the latency ring, RTT
    rings and probes are ported: admitted, and init_state builds their
    planes at full size."""
    cfg = dataclasses.replace(_small_cfg(), **change)
    assert pconfig.validate_torch_slice(cfg) is cfg
    state = init_state(cfg, device="cpu")
    n = cfg.num_nodes
    assert tuple(state.rtt.shape) == ((n, n) if cfg.rtt_rings else (1, 1))
    assert tuple(state.inflight.shape) == (
        (cfg.inflight_slots, 6, cfg.lanes_per_round) if cfg.inflight_slots
        else (1, 6, 1))
    assert tuple(state.probe.first_seen.shape) == (
        (cfg.probes, n) if cfg.probes else (1, 1))


@pytest.mark.parametrize("faults", [
    dict(faults=pconfig.FaultConfig(loss=0.1, dup=0.1, burst_enter=0.2)),
    dict(faults=pconfig.FaultConfig(blackhole=((1, -1),))),
    dict(node_faults=pconfig.NodeFaultConfig(
        crash=((1, 4),), stale=((2, 1, 5),), skew=((0, 3),),
        straggle=((3, 4, 1),))),
], ids=["link", "blackhole", "node"])
def test_fault_configs_are_admitted(faults):
    cfg = dataclasses.replace(_small_cfg(), **faults)
    assert pconfig.validate_torch_slice(cfg) is cfg
    init_state(cfg, device="cpu")


@pytest.mark.parametrize("swim", [
    dict(swim_enabled=True), dict(swim_enabled=True, narrow_state=True),
    dict(swim_enabled=True, swim_view_size=4, swim_payload_members=2),
], ids=["full_view_wide", "full_view_narrow", "windowed"])
def test_swim_configs_are_admitted(swim):
    cfg = dataclasses.replace(_small_cfg(), **swim)
    assert pconfig.validate_torch_slice(cfg) is cfg


def test_emit_slots_cap_and_legacy_schedules_are_admitted():
    """Config 6's egress shape (emit_slots 4 < pend_slots 8) is ported:
    validate_torch_slice and init_state admit it and broadcast_step
    services an emit_slots window. The legacy and deal-probe sync
    schedules are admitted with and without the cap."""
    cfg = dataclasses.replace(_small_cfg(), emit_slots=4, pend_slots=8)
    assert pconfig.validate_torch_slice(cfg) is cfg
    init_state(cfg, device="cpu")
    for change in (dict(sync_hot_actors=0), dict(sync_deal_probes=1),
                   dict(emit_slots=4, pend_slots=8, sync_hot_actors=0),
                   dict(emit_slots=1, sync_deal_probes=2)):
        ok = dataclasses.replace(cfg, **change)
        assert pconfig.validate_torch_slice(ok) is ok
        init_state(ok, device="cpu")
    # the step services 4 of the 8 slots: 8 nodes x 4 slots x fanout 2
    out = broadcast_step(
        make_gossip_state(8, 8, "cpu"), prng.PRNGKey(0),
        torch.ones(8, dtype=torch.bool),
        torch.ones((1, 8), dtype=torch.bool), 2, emit_slots=4,
    )
    assert out[1].shape == (8 * 4 * 2,)
    # emit_slots 0 (service every slot) or >= pend_slots stays admitted
    for emit in (0, 8, 12):
        ok = dataclasses.replace(cfg, emit_slots=emit)
        assert pconfig.validate_torch_slice(ok) is ok


def test_serving_entry_points_refuse_without_cuda():
    """The load harness, config 6 and the sweep's neutral knob leaf run
    on CUDA unless given ``device="cpu"``."""
    from corro_sim_torch.benchmarks import config6_live_run, run_config_6
    from corro_sim_torch.sweep.knobs import neutral_knobs
    from corro_sim_torch.workload import make_workload
    from corro_sim_torch.workload.harness import load_cluster, run_live_load

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    wl = make_workload("zipf:alpha=1.0,rate=0.5,keys=8", 2, rounds=2)
    for call in (lambda: run_live_load(wl, subs=1, settle_rounds=4),
                 lambda: load_cluster(wl),
                 lambda: config6_live_run(2, 2, subs=2, sub_queries=1),
                 lambda: run_config_6(nodes=2, subs=2, rounds=2),
                 lambda: neutral_knobs(_small_cfg())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    rep = run_live_load(wl, subs=1, settle_rounds=8, device="cpu")
    assert rep.nodes == 2


@pytest.mark.parametrize("change", [
    dict(seqs_per_version=4, chunks_per_version=2),
    dict(seqs_per_version=8), dict(chunks_per_version=32),
], ids=["config3_shape", "multi_cell", "max_chunks"])
def test_multi_cell_multi_chunk_configs_are_admitted(change):
    cfg = dataclasses.replace(_small_cfg(), **change)
    assert pconfig.validate_torch_slice(cfg) is cfg
