"""Parity of the port's command line (``python -m corro_sim_torch``) with
the JAX package's ``corro-sim`` on the CPU.

The reference cases that drive the command line in-process run as
written on both packages through tests/test_torch_tooling.py's
:class:`CliBound`: tests/test_admin_cli.py::test_cli_agent_end_to_end,
tests/test_flight.py's two ``flight`` cases,
tests/test_lanes.py::test_flight_dir_roundtrip_and_flight_cli (its
``mixed`` sweep is the port's own run of the same plan on the port's
turn) and tests/test_sweep.py::test_soak_swept_report_matches_serial.
The cases that start child processes are in
tests/test_torch_cli_procs.py.

Port-only cases: ``run``'s JSON report equals the JAX package's for a
plain config, a ``--scenario`` and a ``--workload`` run, and ``load
--verify-vacuous --path batched``'s too; a ``soak`` cursor written by
one package resumes under the other to the report of the uninterrupted
run; ``assert_workload_vacuous`` holds at its default shape and fails
where a schedule writes; each waiting command exits 2 with one line
naming its module and ROADMAP item; ``--help`` lists every subcommand of
the JAX package's parser.

Reports are compared key for key but for the wall-clock fields, masked
by name (:data:`WALL_FIELDS`): ``wall_per_round_ms``,
``compile_seconds``, ``compile_cache``, ``vacuity_check_seconds`` and
the timing fields of ``pipeline``. ``pipeline`` is compared on the JAX
package's keys; the port adds ``speculative_copy_bytes``,
``host_decided``, ``host_reads`` and ``sweeps_run`` (ROADMAP queue 3).
Tolerance: exact.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from corro_sim import cli as r_cli
from corro_sim_torch import cli as p_cli
from test_torch_cluster import one_torch_thread  # noqa: F401
from test_torch_serving import (  # noqa: F401 - a module fixture
    Fixtures, reference_fixtures, run_both)
from test_torch_tooling import CliBound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# masked by name: wall clock and the JAX package's compile provenance
WALL_FIELDS = {"wall_per_round_ms", "compile_seconds", "compile_cache",
               "vacuity_check_seconds"}
PIPELINE_TIMING = {"fetch_wait_s", "execute_wall_s", "overlap_ratio"}
PIPELINE_PORT_ONLY = {"speculative_copy_bytes", "host_decided",
                      "host_reads", "sweeps_run"}


def masked(report):
    """``report`` without :data:`WALL_FIELDS`, and its ``pipeline`` blocks
    on the JAX package's untimed keys."""
    if isinstance(report, list):
        return [masked(v) for v in report]
    if not isinstance(report, dict):
        return report
    out = {}
    for k, v in report.items():
        if k in WALL_FIELDS:
            continue
        if k == "pipeline" and isinstance(v, dict):
            v = {pk: pv for pk, pv in v.items()
                 if pk not in PIPELINE_TIMING | PIPELINE_PORT_ONLY}
        out[k] = masked(v)
    return out


def run_cli(main, argv) -> tuple:
    """``main(argv)``'s exit code and its JSON report on stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue())


def both_reports(argv) -> tuple:
    """The JAX package's and the port's (``--device cpu``) exit code and
    report for the same arguments."""
    ref = run_cli(r_cli.main, argv)
    got = run_cli(p_cli.main, ["--device", "cpu", *argv])
    return ref, got


# ------------------------------------------------ the reference cases

PARAMS = [
    ("test_admin_cli", "test_cli_agent_end_to_end"),
    ("test_flight", "test_cli_flight_reads_export_file"),
    ("test_flight", "test_cli_flight_command"),
    ("test_lanes", "test_flight_dir_roundtrip_and_flight_cli"),
    ("test_sweep", "test_soak_swept_report_matches_serial"),
]


@pytest.fixture(scope="module")
def port_mixed(reference_fixtures):
    """tests/test_lanes.py's ``mixed`` sweep on the port: the same plan,
    run by the port's ``run_sweep`` on the CPU, stands in for the JAX
    package's on the port's turn."""
    import importlib

    from corro_sim_torch.sweep import build_plan
    from corro_sim_torch.sweep.engine import run_sweep
    from test_torch_sweep import BASE, CHUNK, MAX_ROUNDS, MIXED_SCENARIOS

    plan = build_plan(BASE, MIXED_SCENARIOS, [0, 1], rounds=48,
                      write_rounds=8)
    res = run_sweep(plan, max_rounds=MAX_ROUNDS, chunk=CHUNK, device="cpu")
    fx = reference_fixtures.setdefault(
        "test_lanes", Fixtures(importlib.import_module("test_lanes")))
    fx.module_values[("port", "mixed")] = (plan, res)
    return plan, res


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, reference_fixtures, request):
    if mod_name == "test_lanes":
        request.getfixturevalue("port_mixed")
    run_both(mod_name, name, reference_fixtures, request, bound=CliBound)


# ------------------------------------------------------ reports, both

SMALL = ["--nodes", "16", "--rows", "16", "--cols", "2",
         "--log-capacity", "64", "--write-rate", "0.6"]


@pytest.mark.parametrize("extra", [
    [],
    ["--scenario", "lossy:p=0.2", "--max-rounds", "64"],
    ["--workload", "zipf:alpha=1.0,rate=0.5,keys=12",
     "--check-invariants"],
], ids=["plain", "scenario", "workload"])
def test_run_report_equals_the_reference(extra, tmp_path):
    """``run``'s report, its exit code and its flight export equal the
    JAX package's (wall-clock fields masked)."""
    argv = ["run", *SMALL, "--write-rounds", "8", "--chunk", "8",
            "--seed", "1", *extra]
    (rrc, ref), (prc, got) = both_reports(
        argv + ["--flight-out", str(tmp_path / "ref.ndjson")])
    assert prc == rrc == 0
    got["flight"] = ref["flight"]  # the two export paths
    assert masked(got) == masked(ref)
    assert set(got["pipeline"]) >= set(ref["pipeline"])
    assert got["converged_round"] is not None and got["final_gap"] == 0.0


def test_load_verify_vacuous_report_equals_the_reference():
    (rrc, ref), (prc, got) = both_reports([
        "load", "zipf:alpha=1.0,rate=0.5,keys=12", "--nodes", "12",
        "--rounds", "8", "--chunk", "8", "--path", "batched",
        "--verify-vacuous"])
    assert prc == rrc == 0
    assert got["vacuous"] is True
    assert masked(got) == masked(ref)


SOAK = ["soak", "--serial", "--scenario", "lossy:p=0.1", *SMALL,
        "--rounds", "32", "--write-rounds", "8", "--chunk", "8"]
# tests/test_soak_resume.py's fields; a resumed run's invariant checker
# has seen only the chunks after the cursor (``chunks_checked``)
SOAK_FIELDS = ("scenario", "converged_round", "rounds_run", "heal_round",
               "recovery_rounds", "fault_totals", "poisoned")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_soak_cursor_resumes_across_packages(writer, tmp_path):
    """A serial soak checkpointing every chunk leaves the cursor of its
    last checkpointed chunk; the other package's ``soak --resume`` of it
    ends with the uninterrupted run's report, which both packages give
    alike."""
    mains = {"ref": r_cli.main,
             "port": lambda a: p_cli.main(["--device", "cpu", *a])}
    reader = "port" if writer == "ref" else "ref"
    ckpt = str(tmp_path / "soak.ckpt.npz")
    rc, full = run_cli(mains[writer], SOAK + [
        "--checkpoint", ckpt, "--checkpoint-every", "1"])
    assert rc == 0 and os.path.exists(ckpt)
    rc, other = run_cli(mains[reader], SOAK)
    assert rc == 0
    rc, resumed = run_cli(mains[reader], ["soak", "--resume", ckpt])
    assert rc == 0
    assert resumed["resumed_from"] == ckpt
    full.pop("checkpoint")
    assert masked(other) == masked(full)
    a, b = resumed["scenarios"][-1], full["scenarios"][-1]
    for k in SOAK_FIELDS:
        assert a[k] == b[k], k
    assert a["invariants"]["violations"] == b["invariants"]["violations"]


# ------------------------------------------------------ the port alone

def test_assert_workload_vacuous_at_its_default_shape(monkeypatch):
    import corro_sim_torch.workload as pw
    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.workload import (
        _step_loop,
        assert_workload_vacuous,
        make_workload,
    )

    assert_workload_vacuous(device="cpu")
    # the check has teeth: a schedule that writes is not the idle sampler
    cfg = SimConfig(num_nodes=12, num_rows=16, num_cols=2,
                    log_capacity=128, write_rate=0.6).validate()
    wl = make_workload("uniform:rate=0.5,keys=8", 12, rounds=4, seed=0)
    monkeypatch.setattr(pw, "empty_workload", lambda n, rounds: wl)
    with pytest.raises(AssertionError):
        assert_workload_vacuous(cfg, rounds=6, device="cpu")
    monkeypatch.undo()
    # the sampler loop is the JAX package's run_step_loop, leaf for leaf
    from corro_sim.analysis.jaxpr_audit import run_step_loop
    from corro_sim.config import SimConfig as RefSimConfig

    ref, ref_m = run_step_loop(
        RefSimConfig(num_nodes=12, num_rows=16, num_cols=2,
                     log_capacity=128, write_rate=0.6).validate(),
        6, 4, 3)
    got, got_m = _step_loop(cfg, 6, 4, 3, "cpu")
    import jax
    import numpy as np

    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        key = jax.tree_util.keystr(path).lstrip(".")
        np.testing.assert_array_equal(got[key], np.asarray(leaf),
                                      err_msg=key)
    for r, m in enumerate(ref_m):
        for k, v in m.items():
            assert got_m[k][r] == v, (r, k)


WAITING_ARGV = {
    "lint": ["lint"], "audit": ["audit"], "perf": ["perf"],
    "doctor": ["doctor"], "bench": ["bench"],
    "run --mesh": ["run", "--mesh"],
    "sweep --mesh": ["sweep", "scenario=lossy", "--mesh"],
    "run --transfer-guard": ["run", "--transfer-guard"],
}


@pytest.mark.parametrize("what", sorted(WAITING_ARGV))
def test_waiting_commands_exit_2_naming_the_module(what, capsys):
    rc = p_cli.main(["--device", "cpu", *WAITING_ARGV[what]])
    assert rc == 2
    out, err = capsys.readouterr()
    assert out == ""
    (line,) = err.splitlines()
    module, item = p_cli.WAITING[what]
    assert module in line and f"queue 1 item {item}" in line


def _subcommands(parser) -> set:
    import argparse

    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return set(action.choices)


def test_help_lists_every_reference_subcommand():
    want = _subcommands(r_cli.build_parser())
    assert _subcommands(p_cli.build_parser()) == want
    r = subprocess.run(
        [sys.executable, "-m", "corro_sim_torch", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    usage = r.stdout.split("positional arguments")[0]
    assert all(cmd in usage for cmd in want)
    # the module runs as a script too, as the JAX package's tests spawn it
    r = subprocess.run(
        [sys.executable, "-m", "corro_sim_torch.cli", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("usage: corro-sim-torch")


def test_every_reference_flag_is_taken():
    """Each subcommand takes the JAX package's flags, with the same
    defaults."""
    import argparse

    def flags(parser) -> dict:
        out = {}
        for name, sp in _subparsers(parser).items():
            out[name] = {a.dest: (tuple(a.option_strings), a.default)
                         for a in sp._actions
                         if not isinstance(a, argparse._HelpAction)}
        return out

    def _subparsers(parser) -> dict:
        (action,) = [a for a in parser._actions
                     if isinstance(a, argparse._SubParsersAction)]
        return action.choices

    assert flags(p_cli.build_parser()) == flags(r_cli.build_parser())


def jax_swim_churn_pins(n: int) -> tuple:
    """The recipe behind ``profile_slice.SWIM_CHURN_PINS[n]`` (not a test;
    about 25, 30 and 60 s on the CPU at 1024, 2048 and 4096 nodes): the
    JAX package's serial soak loop, as ``corro-sim soak --serial``
    runs it, over config 0 at ``n`` nodes under ``SWIM_CHURN_SPEC`` with
    ``SOAK_ARGS`` and seed 0, hashed as the card's phase hashes it."""
    import dataclasses

    import jax
    import numpy as np

    from corro_sim.config import SimConfig as RefSimConfig
    from corro_sim.engine.driver import run_sim as r_run_sim
    from corro_sim.engine.state import init_state as r_init_state
    from corro_sim.faults import InvariantChecker, make_scenario
    from corro_sim_torch.profile_slice import (
        SOAK_ARGS,
        SWIM_CHURN_SPEC,
        run_digest,
        soak_config,
    )

    base = RefSimConfig(**{
        f.name: getattr(soak_config(n), f.name)
        for f in dataclasses.fields(RefSimConfig)
        if f.name not in ("faults", "node_faults", "twin", "sweep")})
    sc = make_scenario(SWIM_CHURN_SPEC, n, rounds=SOAK_ARGS["rounds"],
                       write_rounds=SOAK_ARGS["write_rounds"], seed=0)
    cfg = sc.apply(base.validate())
    inv = InvariantChecker(cfg)
    res = r_run_sim(cfg, r_init_state(cfg, seed=0), sc.schedule(),
                    max_rounds=SOAK_ARGS["max_rounds"],
                    chunk=SOAK_ARGS["chunk"], seed=0,
                    min_rounds=max(sc.heal_round or 0,
                                   SOAK_ARGS["write_rounds"]),
                    invariants=inv)
    leaves = {jax.tree_util.keystr(p).lstrip("."): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(res.state)[0]}
    return (res.rounds, res.converged_round,
            [(v["round"], v["invariant"], v["detail"])
             for v in inv.report()["violations"]],
            run_digest(leaves, res.metrics))
