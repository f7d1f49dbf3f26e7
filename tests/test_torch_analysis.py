"""The port's lint, transfer guard and fx program audit against the JAX
package's analysis tools, on the CPU.

- **lint engine** — the same ``collect_files`` list on the same trees,
  the same suppression map on the same sources, the same report keys
  and exit codes as ``corro_sim/analysis/lint.py``; every port rule
  fires exactly once on its fixture (``tests/fixtures/torch_lint/``) and
  the port's tree lints clean;
- **transfer guard** — an unsanctioned host read raises inside a
  guarded region, a sanctioned one passes and counts; ``run_sim(
  transfer_guard=True)`` at the JAX package's test config
  (``tests/test_analysis.py``) is bit-identical to the unguarded run
  and to the JAX package's guarded run, and the per-point counts equal
  the JAX package's where the loops share the point;
- **fx audit** — the vacuity matrix's verdicts and live feature gates,
  ``step_metric_names`` and the runtime vacuity oracle equal the JAX
  package's on the same configs; the committed fx golden matches the
  tree and drift is detected.

Tolerance: exact.
"""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from corro_sim.analysis import lint as r_lint
from corro_sim_torch.analysis import lint as p_lint
from corro_sim_torch.analysis import transfer_guard as tg
from corro_sim_torch.analysis.rules import RULES
from test_torch_cluster import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_lint")
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")
PKG = os.path.join(REPO, "corro_sim_torch")


# ------------------------------------------------------- lint engine

@pytest.mark.parametrize("rule", sorted(RULES))
def test_each_port_rule_fires_exactly_once_on_its_fixture(rule):
    fixture = os.path.join(
        FIXTURES, f"{rule.lower()}_{RULES[rule].name.replace('-', '_')}.py"
    )
    assert os.path.exists(fixture), fixture
    res = p_lint.lint_paths([fixture])
    assert [f.rule for f in res.findings] == [rule], [
        (f.rule, f.line, f.message) for f in res.findings
    ]
    assert res.findings[0].severity == RULES[rule].severity


@pytest.mark.parametrize("tree", ["repo", "corro_sim_torch", "fixture_file"])
def test_collect_files_equals_the_jax_engines(tree):
    paths = {"repo": [REPO], "corro_sim_torch": [PKG],
             "fixture_file": [os.path.join(FIXTURES, "cl101_host_sync.py"),
                              os.path.join(JAX_FIXTURES,
                                           "cl101_host_sync.py")]}[tree]
    got = p_lint.collect_files(paths)
    assert got == r_lint.collect_files(paths)
    assert got


def test_suppression_maps_equal_the_jax_engines():
    sources = p_lint.collect_files([PKG]) + p_lint.collect_files(
        [FIXTURES, JAX_FIXTURES])
    sources += [os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES)]
    sources += [os.path.join(JAX_FIXTURES, f)
                for f in os.listdir(JAX_FIXTURES)]
    seen = 0
    for path in sorted(set(sources)):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        assert p_lint._suppressions(src) == r_lint._suppressions(src), path
        seen += bool(p_lint._suppressions(src))
    assert seen >= 2
    prose = ("# the `# corro-lint: ignore[CL101]` marker silences a rule\n"
             "x = 1  # corro-lint: ignore[CL103]\n"
             "# corro-lint: ignore\n")
    assert p_lint._suppressions(prose) == r_lint._suppressions(prose) == {
        2: {"CL103"}, 3: None}


def test_report_keys_and_exit_codes_equal_the_jax_engines(tmp_path):
    pairs = [
        (p_lint.lint_paths([FIXTURES]), r_lint.lint_paths([JAX_FIXTURES])),
        (p_lint.lint_paths(["no_such_dir/"]),
         r_lint.lint_paths(["no_such_dir/"])),
        (p_lint.lint_paths([str(tmp_path)]),
         r_lint.lint_paths([str(tmp_path)])),
        (p_lint.lint_paths([os.path.join(FIXTURES,
                                         "cl103_scalar_tensor.py")]),
         r_lint.lint_paths([os.path.join(JAX_FIXTURES,
                                         "cl103_weak_scalar.py")])),
        (p_lint.lint_paths([os.path.join(FIXTURES, "suppressed_clean.py")]),
         r_lint.lint_paths([os.path.join(JAX_FIXTURES,
                                         "suppressed_clean.py")])),
    ]
    for port, ref in pairs[1:]:
        assert port.files_scanned == ref.files_scanned
        assert port.suppressed == ref.suppressed
    for port, ref in pairs:
        assert set(port.as_dict()) == set(ref.as_dict())
        for strict in (False, True):
            assert port.exit_code(strict) == ref.exit_code(strict)
        assert [p for p, _ in port.parse_errors] == [
            p for p, _ in ref.parse_errors]
        pj, rj = json.loads(p_lint.render_json(port)), json.loads(
            r_lint.render_json(ref))
        assert set(pj) == set(rj)
        summary = re.compile(r"^corro-lint: \d+ files, \d+ errors, \d+ "
                             r"warnings(, \d+ suppressed)?$")
        for text in (p_lint.render_text(port), r_lint.render_text(ref)):
            assert summary.match(text.splitlines()[-1]), text
    fixtures = pairs[0][0]
    assert sorted(f.rule for f in fixtures.findings) == sorted(RULES)
    assert fixtures.as_dict()["files_scanned"] == len(RULES) + 1


def test_port_tree_lints_clean(capsys):
    from corro_sim_torch import cli

    res = p_lint.lint_paths([PKG])
    assert res.parse_errors == []
    assert res.findings == [], p_lint.render_text(res)
    assert res.files_scanned > 100
    assert res.exit_code(strict=True) == 0
    # the step path the rules arm on reaches the declared entry points'
    # callees across modules
    import ast

    from corro_sim_torch.analysis.rules import step_path

    trees = {f: ast.parse(open(f).read()) for f in p_lint.collect_files(
        [PKG])}
    path = step_path(trees)
    for fn in (("corro_sim_torch.engine.step", "sim_step"),
               ("corro_sim_torch.sync.sync", "sync_round"),
               ("corro_sim_torch.core.crdt", "apply_cell_changes"),
               ("corro_sim_torch.prng", "random_bits")):
        assert fn in path, fn
    assert cli.main(["lint", PKG]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("corro-lint: ") and ", 0 errors, 0 warnings" \
        in last, last


def test_lint_metrics_export_and_suppression_count():
    from corro_sim_torch.utils.metrics import counters

    res = p_lint.lint_paths([os.path.join(FIXTURES, "cl101_host_sync.py"),
                             os.path.join(FIXTURES, "suppressed_clean.py")])
    assert res.suppressed == {"CL101": 1}
    p_lint.export_metrics(res)
    text = "\n".join(counters.render())
    assert 'corro_lint_findings_total{rule="CL101",severity="error"}' in text
    assert 'corro_lint_suppressions_total{rule="CL101"}' in text
    assert "corro_lint_files_scanned_total" in text


# ---------------------------------------------------- transfer guard

@pytest.mark.parametrize("read", ["item", "bool", "nonzero", "mask_index",
                                  "unique"])
def test_guard_blocks_unsanctioned_allows_sanctioned(read):
    x = torch.arange(6)
    reads = {
        "item": lambda: x.sum().item(),
        "bool": lambda: bool((x > 2).any()),
        "nonzero": lambda: torch.nonzero(x),
        "mask_index": lambda: x[x > 2],
        "unique": lambda: torch.unique(x),
    }
    before = tg.point_counts().get("test_point", 0)
    with tg.guarded(True, "cpu") as armed:
        assert armed and tg.armed()
        with pytest.raises(tg.HostSyncError):
            reads[read]()
        torch.where(x > 2, x, 0).sum()  # device-side work passes
        with tg.sanctioned("test_point"):
            reads[read]()
        with pytest.raises(tg.HostSyncError):
            reads[read]()
    assert not tg.armed()
    assert tg.point_counts()["test_point"] == before + 1
    with tg.guarded(False) as armed:
        assert not armed
        reads[read]()


def test_transfer_guard_env_flag(monkeypatch):
    monkeypatch.delenv("CORRO_SIM_TRANSFER_GUARD", raising=False)
    assert tg.env_enabled() is False
    monkeypatch.setenv("CORRO_SIM_TRANSFER_GUARD", "1")
    assert tg.env_enabled() is True
    monkeypatch.setenv("CORRO_SIM_TRANSFER_GUARD", "0")
    assert tg.env_enabled() is False


GUARD_CFG = dict(num_nodes=16, num_rows=16, num_cols=2, log_capacity=64,
                 write_rate=0.5, swim_enabled=False, sync_interval=4)
RUN_KW = dict(max_rounds=48, chunk=8, seed=0)


def _ref_guarded(pipeline: bool):
    from corro_sim.config import SimConfig
    from corro_sim.engine.driver import Schedule, run_sim
    from corro_sim.engine.state import init_state
    from corro_sim.utils.metrics import counters

    def points():
        out = {}
        for line in counters.render():
            if line.startswith("corro_lint_sanctioned_transfers_total{"):
                point = line.split('point="')[1].split('"')[0]
                out[point] = float(line.rsplit(" ", 1)[1])
        return out

    cfg = SimConfig(**GUARD_CFG, pipeline=pipeline)
    before = points()
    res = run_sim(cfg, init_state(cfg, seed=0), Schedule(write_rounds=4),
                  transfer_guard=True, **RUN_KW)
    after = points()
    return res, {k: v - before.get(k, 0) for k, v in after.items()
                 if v - before.get(k, 0)}


@pytest.mark.parametrize("pipeline", [True, False])
def test_guarded_run_is_bit_identical_and_counts_as_the_jax_package(
        pipeline):
    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine.state import init_state

    cfg = SimConfig(**GUARD_CFG, pipeline=pipeline)
    runs = {}
    for guard in (True, False):
        runs[guard] = run_sim(
            cfg, init_state(cfg, seed=0, device="cpu"),
            Schedule(write_rounds=4), device="cpu", transfer_guard=guard,
            **RUN_KW)
    rg, r0 = runs[True], runs[False]
    sg, s0 = state_to_numpy(rg.state), state_to_numpy(r0.state)
    for k in s0:
        np.testing.assert_array_equal(sg[k], s0[k], err_msg=k)
    assert rg.converged_round == r0.converged_round is not None
    for k in r0.metrics:
        np.testing.assert_array_equal(rg.metrics[k], r0.metrics[k],
                                      err_msg=k)
    assert r0.transfer_guard is None
    ref, ref_points = _ref_guarded(pipeline)
    assert ref.converged_round == rg.converged_round
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref.state)[0]:
        key = jax.tree_util.keystr(path).lstrip(".")
        np.testing.assert_array_equal(sg[key], np.asarray(leaf),
                                      err_msg=key)
    for k, v in ref.metrics.items():
        np.testing.assert_array_equal(rg.metrics[k], np.asarray(v),
                                      err_msg=k)
    # the points both loops have: staging per dispatched chunk and one
    # resolve per committed chunk (the port cuts a doomed speculative
    # chunk before its metric copy starts, so metric_fetch_start is its
    # own)
    for point in ("chunk_stage", "metric_resolve"):
        assert rg.transfer_guard[point] == ref_points[point], point
    assert set(rg.transfer_guard) <= {"chunk_stage", "metric_resolve",
                                      "metric_fetch_start", "metric_peek"}


def test_guard_is_disarmed_when_the_run_fails_inside_its_loop():
    """A run that raises inside its guarded chunk loop leaves the guard
    disarmed: a host read after it goes through."""
    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine.state import init_state

    def boom(_info):
        raise KeyError("stop inside the loop")

    cfg = SimConfig(**GUARD_CFG, pipeline=False)
    try:
        run_sim(cfg, init_state(cfg, seed=0, device="cpu"),
                Schedule(write_rounds=4), device="cpu", transfer_guard=True,
                on_chunk=boom, **RUN_KW)
    except KeyError as e:
        # read while the traceback still holds the run's frame
        assert "stop inside the loop" in str(e)
        assert not tg.armed()
        assert torch.ones(2).sum().item() == 2.0
    else:
        pytest.fail("the run did not raise")


def test_sync_gate_reads_are_the_sanctioned_sync_gate_points():
    """The adaptive sweep gate's host reads are the step's own sanctioned
    point: one ``sync_gate`` per read the pipeline reports."""
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.profile_slice import slice_config, slice_schedule

    cfg = slice_config(64, swim=True)
    res = run_sim(cfg, init_state(cfg, seed=0, device="cpu"),
                  slice_schedule(), max_rounds=64, chunk=8, seed=0,
                  min_rounds=8, device="cpu", transfer_guard=True)
    assert res.pipeline["host_reads"] > 0
    assert res.transfer_guard["sync_gate"] == res.pipeline["host_reads"]
    assert res.converged_round is not None


# ------------------------------------------------------- fx audit

@pytest.fixture(scope="module")
def audit_reports():
    from corro_sim.analysis.jaxpr_audit import audit as r_audit
    from corro_sim_torch.analysis.fx_audit import audit as p_audit

    return p_audit(), r_audit()


def test_vacuity_matrix_verdicts_equal_the_jax_packages(audit_reports):
    port, ref = audit_reports
    assert port["ok"] and ref["ok"]
    assert [(v["variant"], v["expect"], v["identical"], v["ok"])
            for v in port["vacuity"]] == [
        (v["variant"], v["expect"], v["identical"], v["ok"])
        for v in ref["vacuity"]]
    # the live gates grow the program on both
    for p, r in zip(port["vacuity"], ref["vacuity"]):
        assert (p["extra_eqns"] > 0) == (r["extra_eqns"] > 0), p["variant"]
    # the step graphs read nothing to the host
    assert port["hazards"]["full"]["host_reads"] == 0
    assert port["hazards"]["repair"]["host_reads"] == 0


@pytest.mark.parametrize("variant", ["audit", "probes", "faults", "windowed"])
def test_step_metric_names_equal_the_jax_packages(variant):
    from corro_sim.analysis.jaxpr_audit import audit_config as r_cfg
    from corro_sim.analysis.jaxpr_audit import step_metric_names as r_names
    from corro_sim.config import FaultConfig as RFault
    from corro_sim_torch.analysis.fx_audit import audit_config as p_cfg
    from corro_sim_torch.analysis.fx_audit import step_metric_names
    from corro_sim_torch.config import FaultConfig as PFault

    over = {"audit": {}, "probes": {"probes": 2},
            "faults": "faults",
            "windowed": {"swim_view_size": 8, "swim_payload_members": 4,
                         "narrow_state": True}}[variant]
    rc, pc = r_cfg(), p_cfg()
    if over == "faults":
        rc = dataclasses.replace(rc, faults=RFault(trace_vacuous=True))
        pc = dataclasses.replace(pc, faults=PFault(trace_vacuous=True))
    else:
        rc, pc = dataclasses.replace(rc, **over), dataclasses.replace(
            pc, **over)
    assert step_metric_names(pc) == r_names(rc)


def test_fx_golden_matches_the_tree_and_drift_is_detected(audit_reports,
                                                          tmp_path):
    from corro_sim_torch.analysis import fx_audit as fa

    port, _ = audit_reports
    golden = fa.load_golden()
    assert golden is not None
    assert golden["torch_version"] == torch.__version__
    assert fa.check_golden(port) == []
    assert all(d["delta_eqns"] == 0 and d["primitives"] == {}
               for d in fa.golden_diff(port).values())
    bumped = json.loads(json.dumps(golden))
    bumped["programs"]["full"]["eqns"] += 1
    op = next(iter(bumped["programs"]["full"]["primitives"]))
    bumped["programs"]["full"]["primitives"][op] += 1
    p = tmp_path / "golden.json"
    p.write_text(json.dumps(bumped))
    problems = fa.check_golden(port, path=str(p))
    assert len(problems) == 1 and "op-count drift" in problems[0]
    assert op in problems[0]
    assert fa.golden_diff(port, path=str(p))["full"]["delta_eqns"] == -1
    assert fa.check_golden(port, path=str(tmp_path / "nope.json"))


def test_assert_same_program_names_the_op_diff():
    from corro_sim_torch.analysis import fx_audit as fa

    cfg = fa.audit_config()
    fa.assert_same_program(cfg, dataclasses.replace(cfg, pipeline=False))
    with pytest.raises(AssertionError, match="step programs differ"):
        fa.assert_same_program(cfg, dataclasses.replace(cfg, probes=2),
                               label="probes")


def test_runtime_vacuity_oracle_on_the_fault_lane():
    """The JAX package's tests/test_faults.py claim through the port's
    oracle: the trace-vacuous fault program adds nodes, equals the base
    run on every core leaf and metric, adds exactly the fault metrics
    and keeps the effect counters at zero."""
    from corro_sim_torch.analysis.fx_audit import assert_feature_vacuous
    from corro_sim_torch.config import FaultConfig, SimConfig

    base = SimConfig(num_nodes=12, num_rows=16, num_cols=2,
                     log_capacity=128, write_rate=0.6)
    on = dataclasses.replace(base, faults=FaultConfig(trace_vacuous=True))
    assert_feature_vacuous(
        base, on, exclude_leaves=("fault_burst",),
        extra_metrics={
            "fault_lost", "fault_dup", "fault_blackholed",
            "fault_unreachable", "fault_delivered", "fault_parked",
            "fault_emit_lost", "fault_matured", "fault_burst_nodes",
            "fault_sync_lost",
        },
        zero_metrics=("fault_lost", "fault_dup", "fault_blackholed",
                      "fault_sync_lost", "fault_burst_nodes"),
        rounds=16, write_rounds=4, seed=3,
    )
    with pytest.raises(AssertionError, match="same program"):
        assert_feature_vacuous(base, base, rounds=2)


def test_fake_step_trace_allocates_no_n_by_n_plane(monkeypatch):
    """The bench's count on a sharded config (config 7's shape: windowed
    SWIM, actor-sharded log) traces a fake state: a dispatch mode sees
    no tensor holding memory with two axes of length N, where building
    the same state for real makes them (the control). In a world of
    several ranks only rank 0 traces."""
    import torch.distributed as dist

    from corro_sim_torch.benchmarks import _step_eqns, config7_cfg
    from corro_sim_torch.engine.mesh_jobs import AllocationWatch
    from corro_sim_torch.engine.state import init_state

    cfg = config7_cfg(96)
    assert cfg.shard_log and cfg.num_actors == cfg.num_nodes
    control = AllocationWatch(cfg.num_nodes)
    with control():
        init_state(cfg, seed=0, device="cpu")
    assert control.worst == 2, control.shapes
    watch = AllocationWatch(cfg.num_nodes)
    with watch():
        got = _step_eqns(cfg)
    assert watch.worst <= 1, watch.shapes
    assert got["step_eqns_full"] > 0 and got["step_eqns_repair"] > 0
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    assert _step_eqns(cfg) == {}


def test_bench_step_eqns_are_the_graphs_node_counts():
    from corro_sim_torch.analysis.fx_audit import (
        audit_config,
        op_fingerprint,
        step_graph,
    )
    from corro_sim_torch.benchmarks import _step_eqns

    cfg = audit_config()
    got = _step_eqns(cfg)
    assert got == {
        "step_eqns_full": op_fingerprint(step_graph(cfg))["eqns"],
        "step_eqns_repair": op_fingerprint(
            step_graph(cfg, repair=True))["eqns"],
    }
    assert all(isinstance(v, int) and v > 0 for v in got.values())
