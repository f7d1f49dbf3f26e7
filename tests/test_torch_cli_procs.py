"""The port's command line in child processes, on the CPU.

Reference cases that start ``python -m corro_sim`` (or ``corro_sim.cli``)
run as written on both packages through tests/test_torch_tooling.py's
:class:`CliBound`, whose port turn starts ``python -m corro_sim_torch
--device cpu`` with ``OMP_NUM_THREADS=1`` instead:
tests/test_soak_resume.py::test_soak_cli_sigkill_resume (a soak killed
with SIGKILL at its first cursor and resumed gives the uninterrupted
report) and tests/test_twin_live.py's three command-line cases (a
tailing twin killed and resumed equals the file-mode replay; a dead
source exits 5 with a report and a cursor; ``--tail`` needs
``--scan-lines``).

Port-only: ``agent`` and ``devcluster`` started as child processes serve
their info line, take a write through ``exec`` and read it back through
``query``, and end with exit 0 and no traceback on SIGTERM.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from corro_sim_torch import cli as p_cli
from test_torch_cluster import one_torch_thread  # noqa: F401
from test_torch_serving import (  # noqa: F401 - a module fixture
    reference_fixtures, run_both)
from test_torch_tooling import CliBound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAMS = [
    ("test_soak_resume", "test_soak_cli_sigkill_resume"),
    ("test_twin_live", "test_cli_tail_sigkill_resume_bit_identical"),
    ("test_twin_live", "test_cli_tail_source_death_exits_5_with_report"),
    ("test_twin_live", "test_cli_tail_requires_scan_window"),
]


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, reference_fixtures, request):
    run_both(mod_name, name, reference_fixtures, request, bound=CliBound)


SCHEMA = "CREATE TABLE kv (k TEXT NOT NULL PRIMARY KEY, v TEXT);\n"


def _spawn(tmp_path, argv):
    """``python -m corro_sim_torch --device cpu <argv>`` and its info
    line."""
    err = open(tmp_path / "stderr.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "corro_sim_torch", "--device", "cpu", *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    line = proc.stdout.readline()
    assert line, (tmp_path / "stderr.txt").read_text()
    return proc, json.loads(line)


def _end(proc, tmp_path):
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 0
    err = (tmp_path / "stderr.txt").read_text()
    assert "Traceback" not in err, err


def _write_and_read(api, capsys, table="kv"):
    assert p_cli.main(["exec", "--api", api,
                       f"INSERT INTO {table} (k, v) VALUES ('a', 'b')"]) == 0
    capsys.readouterr()
    assert p_cli.main(["query", "--api", api,
                       f"SELECT k, v FROM {table}"]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("command", ["agent", "devcluster"])
def test_child_process_serves_and_ends_on_sigterm(command, tmp_path, capsys):
    schema = tmp_path / "schema.sql"
    schema.write_text(SCHEMA)
    sock = str(tmp_path / "admin.sock")
    if command == "agent":
        argv = ["agent", "--schema", str(schema), "--nodes", "2",
                "--capacity", "16", "--admin-path", sock,
                "--tick-interval", "0.05", "--pg-addr", "127.0.0.1:0"]
    else:
        topo = tmp_path / "topo.txt"
        topo.write_text("A -> B\nB -> C\n")
        argv = ["devcluster", str(topo), "--schema", str(schema),
                "--capacity", "16", "--admin-path", sock,
                "--statedir", str(tmp_path / "state"),
                "--tick-interval", "0.05"]
    proc, info = _spawn(tmp_path, argv)
    try:
        assert info["admin"] == sock
        assert info["nodes"] == (2 if command == "agent"
                                 else {"A": 0, "B": 1, "C": 2})
        assert "a|b" in _write_and_read(info["api"], capsys)
        assert p_cli.main(["cluster", "members", "--admin-path", sock]) == 0
        members = json.loads(capsys.readouterr().out)
        assert members
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            p_cli.main(["query", "--api", info["api"], "--node", "1",
                        "SELECT k, v FROM kv"])
            if "a|b" in capsys.readouterr().out:
                break
            time.sleep(0.1)
        else:
            raise AssertionError("the write never reached node 1")
    finally:
        if proc.poll() is None:
            _end(proc, tmp_path)
