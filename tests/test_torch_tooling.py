"""Parity of the port's cluster tooling with the JAX package's on the CPU:
DNS bootstrap (every case of tests/test_bootstrap.py), the devcluster
(tests/test_devcluster.py, its command-line case included), TLS
(tests/test_tls.py, the ``tls`` commands included), templates and Consul
sync (tests/test_tpl_consul.py, and
tests/test_joins.py::test_join_template_renders_live), and the TOML
loader (tests/test_io.py's four ``load_config`` cases,
tests/test_node_faults.py::test_node_faults_config_file_roundtrip and
tests/test_multichip.py's two ``shard_log`` config cases, which need no
mesh).

Each reference case runs as written on both packages through
tests/test_torch_serving.py's harness, extended by :class:`CliBound`:
on the port's turn the JAX package's ``cli.main`` is the port's with
``--device cpu`` put first, the names of the tooling modules are rebound
to the port's, and a child process started as ``python -m corro_sim``
(or ``corro_sim.cli``) starts as ``python -m corro_sim_torch --device
cpu`` with ``OMP_NUM_THREADS=1``; each package's run gets its own
``tmp_path``, Consul sync's clock (``updated_at``) reads one fixed time
in both, and the process metric registries start empty and are put back
after each run. The two runs must pass alike, log the
same cluster calls with the same results, get the same admin replies and
leave the same clusters. The cases whose clusters a server also ticks
from a background thread (``ApiServer(tick_interval=0.05)``) leave the
``tick`` calls out and compare the clusters by their rows once both have
converged (:func:`test_torch_serving.run_both`'s ``ticked``).
Tolerance: exact.
"""

import importlib
import os
import subprocess
import sys
import types

import pytest

from corro_sim_torch import cli as p_cli
from test_torch_cluster import one_torch_thread  # noqa: F401
from test_torch_serving import (  # noqa: F401 - a module fixture
    _BASIC, MODULES, Bound, _on_cpu, cases, reference_fixtures, run_both)

# the tooling modules beside the serving harness's
TOOL_MODULES = MODULES + (
    "io.config_file", "membership.bootstrap", "harness.devcluster", "tls",
    "tpl", "integrations.consul", "obs.flight", "cli",
)


def port_main(argv=None):
    """The port's ``cli.main`` on the CPU: ``--device cpu`` goes first."""
    argv = sys.argv[1:] if argv is None else list(argv)
    return p_cli.main(["--device", "cpu", *argv])


def _tool_pairs() -> list:
    """``(ref module, attribute, ref value, port value)`` for every
    non-basic name of :data:`TOOL_MODULES` the port also has; the JAX
    package's ``cli.main`` pairs with :func:`port_main`."""
    out = []
    for path in TOOL_MODULES:
        rm = importlib.import_module(f"corro_sim.{path}")
        pm = importlib.import_module(f"corro_sim_torch.{path}")
        for attr, obj in vars(rm).items():
            if attr.startswith("__") or isinstance(obj, _BASIC):
                continue
            if path == "cli" and attr == "main":
                out.append((rm, attr, obj, port_main))
            elif hasattr(pm, attr):
                out.append((rm, attr, obj, _on_cpu(getattr(pm, attr))))
    return out


_Popen = subprocess.Popen


def port_argv(args) -> list:
    """A child's argv with ``-m corro_sim[.cli]`` as ``-m
    corro_sim_torch[.cli] --device cpu``."""
    args = list(args)
    if "-m" in args:
        i = args.index("-m") + 1
        if args[i] in ("corro_sim", "corro_sim.cli"):
            args[i:i + 1] = [args[i].replace("corro_sim", "corro_sim_torch",
                                             1), "--device", "cpu"]
    return args


class PortPopen(_Popen):
    """``subprocess.Popen`` starting the port's command line where a case
    starts the JAX package's, on one intra-op thread."""

    def __init__(self, args, *a, **kw):
        kw["env"] = dict(kw.get("env") or os.environ, OMP_NUM_THREADS="1")
        super().__init__(port_argv(args), *a, **kw)


# the wall clock Consul sync stamps into ``updated_at``, held fixed in
# both packages' runs so that their statements compare
CONSUL_NOW = 1_800_000_000


def _fixed_clock():
    import time

    clock = types.SimpleNamespace(**{
        k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    clock.time = lambda: float(CONSUL_NOW)
    return clock


class CliBound(Bound):
    """:class:`Bound` with the tooling modules and the command line."""

    pairs = _tool_pairs()
    split_tmp = True

    def __enter__(self):
        super().__enter__()
        for pkg in ("corro_sim", "corro_sim_torch"):
            mod = importlib.import_module(f"{pkg}.integrations.consul")
            self.mp.setattr(mod, "time", _fixed_clock())
            # the process registries as they were, once the case is over:
            # other files of the same worker assert exact series values
            m = importlib.import_module(f"{pkg}.utils.metrics")
            for reg, field in ((m.counters, "_c"), (m.gauges, "_g"),
                               (m.histograms, "_h")):
                self.mp.setattr(reg, field, {})
                self.mp.setattr(reg, "_help", {})
        return self

    def port_extra(self, mp) -> None:
        mp.setattr(subprocess, "Popen", PortPopen)


# the cases whose clusters an ApiServer(tick_interval=0.05) also ticks:
# every case of tests/test_tpl_consul.py, since its module fixture's
# server keeps ticking through the cases that follow the first
TICKED = {("test_tpl_consul", n) for _, n in cases("test_tpl_consul")} | {
    ("test_joins", "test_join_template_renders_live")}

PARAMS = (
    cases("test_bootstrap") + cases("test_devcluster") + cases("test_tls")
    + cases("test_tpl_consul")
    + [("test_joins", "test_join_template_renders_live")]
    + [("test_io", n) for n in (
        "test_load_defaults_without_file", "test_toml_plus_env_override",
        "test_unknown_key_rejected", "test_vendored_flat_toml_parser")]
    + [("test_node_faults", "test_node_faults_config_file_roundtrip")]
    + [("test_multichip", n) for n in (
        "test_shard_log_config_surfaces", "test_shard_log_toml")]
)


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, reference_fixtures, request):
    run_both(mod_name, name, reference_fixtures, request, bound=CliBound,
             ticked=(mod_name, name) in TICKED)


def test_port_argv_rewrites_only_the_package():
    """The child-process rewrite touches ``-m corro_sim[.cli]`` only."""
    py = sys.executable
    assert port_argv([py, "-m", "corro_sim", "soak", "--nodes", "4"]) == [
        py, "-m", "corro_sim_torch", "--device", "cpu", "soak", "--nodes",
        "4"]
    assert port_argv([py, "-m", "corro_sim.cli", "twin", "f"]) == [
        py, "-m", "corro_sim_torch.cli", "--device", "cpu", "twin", "f"]
    assert port_argv(["echo", "-m", "x"]) == ["echo", "-m", "x"]


def test_tls_module_imports_without_cryptography():
    """Importing the port's tls module binds nothing of ``cryptography``;
    the package is imported on the first certificate made."""
    code = (
        "import sys; import corro_sim_torch.tls as t; "
        "assert 'cryptography' not in sys.modules; "
        "assert t.x509 is None; t.generate_ca(); "
        "assert 'cryptography' in sys.modules; print('ok')"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_devcluster_bootstrap_addresses_follow_generate_bootstrap(tmp_path):
    """Every ``node.json`` lists its bootstrap neighbours' gossip
    addresses as ``generate_bootstrap`` resolves them, and equals the
    JAX package's file; the two components never share rows."""
    import json

    from corro_sim.harness.devcluster import build_cluster as r_build
    from corro_sim_torch.harness.devcluster import build_cluster
    from corro_sim_torch.membership.bootstrap import generate_bootstrap

    topo = "A -> B\nB -> C\nC -> A\nD -> E\n"
    schema = "CREATE TABLE kv (k TEXT NOT NULL PRIMARY KEY, v TEXT);"
    c, ordinal = build_cluster(topo, schema, state_dir=str(tmp_path / "p"),
                               default_capacity=16, device="cpu")
    rc, r_ordinal = r_build(topo, schema, state_dir=str(tmp_path / "r"),
                            default_capacity=16)
    assert ordinal == r_ordinal
    gossip = {n: ("127.0.0.1", 9000 + i) for n, i in ordinal.items()}
    for name in ordinal:
        meta = json.loads((tmp_path / "p" / name / "node.json").read_text())
        ref = json.loads((tmp_path / "r" / name / "node.json").read_text())
        assert meta == ref
        want = generate_bootstrap(
            [f"{b}:{gossip[b][1]}" for b in meta["bootstrap"]],
            resolve=lambda h, p, d: [gossip[h]])
        assert meta["bootstrap_addrs"] == [list(a) for a in want]
    for cl in (c, rc):
        cl.execute(["INSERT INTO kv (k, v) VALUES ('a', '1')"],
                   node=ordinal["A"])
        cl.tick(48)
    for cl in (c, rc):
        assert [cl.query_rows("SELECT k FROM kv", node=ordinal[n])[1]
                for n in "ABCDE"] == [[["a"]]] * 3 + [[]] * 2
