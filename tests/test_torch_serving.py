"""Parity of the port's serving surfaces with the JAX package's on the
CPU: the HTTP API and its client (every case of tests/test_http_api.py
but ``test_perf_route`` and ``test_doctor_route``, which wait for the
perf ledger and the doctor) and tracing (every case of
tests/test_tracing.py), and the harness the other serving files use
(tests/test_torch_{pg,admin,metrics}.py).

Each reference case runs as it is written, with its own assertions and
fixtures, twice: once on the JAX package and once with every name the
case's module (and the JAX package's modules, for the cases that import
locally) binds from the JAX package rebound to the port's counterpart:
``LiveCluster`` (``device="cpu"``), ``ApiServer``, ``ApiClient``,
``PgServer``, ``AdminServer``, the tracer, the metric registries and
``render_prometheus``, and every function that takes ``device=`` with
``device="cpu"``. A recorder around every cluster the case builds (its
fixtures' too) logs each method call, its arguments and its result or
error; a server's handler threads call the cluster through it too. The
two runs must pass alike, log the same calls with the same results
(in either order, since handler threads interleave with the case's own
calls; the asynchronous ``sub_detach_queue`` of a closed stream and the
private helpers are left out), get the same replies from the admin
socket and the pgwire client (but where a reply carries wall times or
random ids: ``traces``, ``locks``, ``flight``, the db lock's tokens),
and leave the same clusters
(tests/test_torch_cluster.py::assert_same_cluster). Wall-clock fields
are left out. A scrape's one device read (the port's ``scrape_reads``)
stands for the ``table_stats``, ``node_lag`` and ``probe_trace`` calls
the JAX package's scrape makes, with the same values. Module fixtures
are built once per package and shared by
the cases in the reference file's order, as pytest runs them there.
Tolerance: exact.
"""

import contextlib
import functools
import importlib
import inspect
import types

import pytest

import corro_sim.harness.cluster as r_cluster
from corro_sim_torch.harness import cluster as p_cluster
from test_torch_cluster import (  # noqa: F401 - a module fixture
    BOTH, PORT, assert_same_cluster, one_torch_thread, outcome, plain)
from test_torch_cluster_sql import Recorder, untimed

# the two packages' own LiveCluster classes
CLASSES = {"ref": r_cluster.LiveCluster, "port": p_cluster.LiveCluster}
# the JAX package's modules whose names a reference case may bind; each
# has a counterpart at the same path in the port
MODULES = (
    "harness.cluster", "api.http", "api.pg", "client", "admin",
    "utils.tracing", "utils.metrics", "utils.runtime", "workload",
    "workload.generators", "workload.harness", "faults.scorecard",
    "config", "engine.driver", "engine.state", "io.traces",
    "io.feedsource", "io.checkpoint", "subs.query", "subs.manager",
    "api.statements", "api.sql_state", "schema", "obs.lanes",
)
_BASIC = (str, bytes, int, float, bool, tuple, frozenset, type(None),
          types.ModuleType)
# calls a server's handler threads make after the case has moved on
ASYNC_CALLS = {"sub_detach_queue"}
# calls whose results are wall-clock times
WALL_CALLS = {"stage_timings"}


def _on_cpu(obj):
    """``obj`` with ``device="cpu"`` where it takes a ``device``."""
    if not callable(obj) or isinstance(obj, type) and issubclass(
            obj, BaseException):
        return obj
    try:
        params = inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return obj
    if "device" in params:
        return functools.partial(obj, device="cpu")
    return obj


def _pairs() -> list:
    """``(ref module, attribute, port value)`` for every non-basic name
    of the JAX package's modules that the port's module also has."""
    out = []
    for path in MODULES:
        rm = importlib.import_module(f"corro_sim.{path}")
        pm = importlib.import_module(f"corro_sim_torch.{path}")
        for attr, obj in vars(rm).items():
            if attr.startswith("__") or isinstance(obj, _BASIC):
                continue
            if hasattr(pm, attr):
                out.append((rm, attr, obj, _on_cpu(getattr(pm, attr))))
    return out


PAIRS = _pairs()


# client calls whose replies are recorded too: (module, class, method);
# an admin reply to these commands carries wall times, span or lock ids
CLIENT_CALLS = (("admin", "AdminClient", "call"),
                ("api.pg", "SimplePgClient", "query"),
                ("api.pg", "SimplePgClient", "extended"))
UNRECORDED_COMMANDS = {"traces", "locks", "db_lock_acquire",
                       "db_lock_release", "flight", "ping"}


def _recording(method, log: list):
    """``method`` logging ``(name, args, reply or error)`` into ``log``."""

    def call(client, *a, **kw):
        if a and a[0] in UNRECORDED_COMMANDS:
            return method(client, *a, **kw)
        try:
            r = method(client, *a, **kw)
        except Exception as e:
            log.append((method.__name__, a, kw, (type(e).__name__, str(e))))
            raise
        log.append((method.__name__, a, kw, r))
        return r

    return call


class Bound:
    """While entered, ``LiveCluster`` is ``B``'s recording factory in the
    reference module and in both packages' ``harness.cluster``; on the
    port's turn every pair of :data:`PAIRS` is rebound too, in the JAX
    package's modules and wherever the reference module bound it."""

    def __init__(self, B, mod, made: list, replies: list):
        self.B, self.mod, self.made, self.replies = B, mod, made, replies

    def factory(self, *a, **kw):
        c = Recorder(self.B.LiveCluster(*a, **kw))
        self.made.append(c)
        return c

    def __enter__(self):
        mp = self.mp = pytest.MonkeyPatch()
        if self.B is PORT:
            by_id = {}
            for rm, attr, ref_obj, port_obj in PAIRS:
                mp.setattr(rm, attr, port_obj)
                by_id[id(ref_obj)] = port_obj
            for name, obj in list(vars(self.mod).items()):
                if id(obj) in by_id and not isinstance(obj, _BASIC):
                    mp.setattr(self.mod, name, by_id[id(obj)])
            mp.setattr(p_cluster, "LiveCluster", self.factory)
        mp.setattr(self.mod, "LiveCluster", self.factory, raising=False)
        mp.setattr(r_cluster, "LiveCluster", self.factory)
        pkg = "corro_sim" if self.B.key == "ref" else "corro_sim_torch"
        for path, cls_name, meth in CLIENT_CALLS:
            cls = getattr(importlib.import_module(f"{pkg}.{path}"),
                          cls_name)
            mp.setattr(cls, meth,
                       _recording(getattr(cls, meth), self.replies))
        return self

    def __exit__(self, *exc):
        self.mp.undo()
        return False


class Fixtures:
    """A reference module's fixtures resolved per package: module-scoped
    ones once per package (finalised at :meth:`close`), function-scoped
    ones per case; pytest's own fixtures come from ``request``."""

    def __init__(self, mod):
        self.mod = mod
        self.module_values: dict = {}  # (package, name) -> value
        self.module_gens: list = []
        self.made: dict = {"ref": [], "port": []}
        self.replies: dict = {"ref": [], "port": []}

    def value(self, B, name: str, request, case_gens: list):
        fx = getattr(self.mod, name, None)
        if fx is None or not hasattr(fx, "_fixture_function_marker"):
            return request.getfixturevalue(name)
        scope = fx._fixture_function_marker.scope
        key = (B.key, name)
        if scope == "module" and key in self.module_values:
            return self.module_values[key]
        fn = fx._get_wrapped_function()
        args = [self.value(B, p, request, case_gens)
                for p in inspect.signature(fn).parameters]
        got = fn(*args)
        if inspect.isgenerator(got):
            gen, got = got, next(got)
            (self.module_gens if scope == "module" else case_gens).append(
                gen)
        if scope == "module":
            self.module_values[key] = got
        return got

    def close(self):
        for gen in reversed(self.module_gens):
            with contextlib.suppress(StopIteration):
                next(gen)


def _finish(gens: list) -> None:
    for gen in reversed(gens):
        with contextlib.suppress(StopIteration):
            next(gen)


def _probe(tr):
    """A ``ProbeTrace`` (or None) as its planes."""
    if tr is None:
        return None
    from corro_sim_torch.obs.probes import PROBE_FIELDS

    return {f: getattr(tr, f).tolist() for f in PROBE_FIELDS}


def _expand(call) -> list:
    """The port's ``scrape_reads`` (one device read for a scrape) as the
    calls the JAX package's scrape makes for the same values:
    ``table_stats``, ``node_lag`` and ``probe_trace``."""
    name, a, kw, r = call
    if name in WALL_CALLS:
        return [(name, a, kw, None)]
    if name == "probe_trace":
        return [(name, a, kw, _probe(r))]
    if name != "scrape_reads" or isinstance(r, tuple):
        return [call]
    return [("table_stats", (), {}, r["table_stats"]),
            ("node_lag", (), {}, r["node_lag"]),
            ("probe_trace", (), {}, _probe(r["probe"]))]


def _plain(x):
    """:func:`plain`, with a dict's tuple keys (an overlay's ``(slot,
    plane)``) as their repr."""
    if isinstance(x, dict):
        return {k if isinstance(k, str) else repr(plain(k)): _plain(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return plain(x)


def call_log(c) -> list:
    """A recorded cluster's calls, untimed, in a thread-order-free form."""
    calls = [y for x in c._calls
             if x[0] not in ASYNC_CALLS and not x[0].startswith("_")
             for y in _expand(x)]
    return sorted(repr(untimed(_plain(x))) for x in calls)


def run_both(mod_name: str, name: str, fixtures: dict, request) -> dict:
    """Run reference case ``mod_name::name`` on both packages and hold
    the port to the JAX package. Returns the two outcomes."""
    mod = importlib.import_module(mod_name)
    fx = fixtures.setdefault(mod_name, Fixtures(mod))
    fn = getattr(mod, name)
    got = {}
    for B in BOTH:
        caplog = (request.getfixturevalue("caplog")
                  if "caplog" in inspect.signature(fn).parameters else None)
        if caplog is not None:
            caplog.clear()
        with Bound(B, mod, fx.made[B.key], fx.replies[B.key]):
            case_gens: list = []
            try:
                args = [fx.value(B, p, request, case_gens)
                        for p in inspect.signature(fn).parameters]
                got[B.key] = outcome(fn, *args)
            finally:
                _finish(case_gens)
    assert got["ref"][0] == "ok", got["ref"]
    assert got["port"] == got["ref"]
    assert len(fx.made["port"]) == len(fx.made["ref"])
    assert (sorted(repr(_plain(x)) for x in fx.replies["port"])
            == sorted(repr(_plain(x)) for x in fx.replies["ref"]))
    for rc, pc in zip(fx.made["ref"], fx.made["port"]):
        assert type(rc._inner) is CLASSES["ref"]
        assert type(pc._inner) is CLASSES["port"]
        assert call_log(pc) == call_log(rc)
        assert_same_cluster(rc._inner, pc._inner)
    return got


@pytest.fixture(scope="module")
def reference_fixtures():
    """The reference modules' fixtures, per package, for this file."""
    fixtures: dict = {}
    yield fixtures
    for fx in fixtures.values():
        fx.close()


def cases(mod_name: str, skip=()) -> list:
    """Every test function of a reference module, in file order, but
    ``skip``."""
    mod = importlib.import_module(mod_name)
    return [(mod_name, n) for n, f in vars(mod).items()
            if n.startswith("test_") and inspect.isfunction(f)
            and n not in skip]


# perf and doctor read modules the port does not have yet (the perf
# ledger and the doctor); they wait with them
HTTP_WAITING = ("test_perf_route", "test_doctor_route")
PARAMS = cases("test_http_api", HTTP_WAITING) + cases("test_tracing")


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, reference_fixtures, request):
    run_both(mod_name, name, reference_fixtures, request)


def test_waiting_routes_name_the_missing_module():
    """``/v1/perf`` and ``/v1/doctor`` answer 404 and name the module
    the port does not have yet."""
    import json
    import urllib.error
    import urllib.request

    from corro_sim_torch.api.http import ApiServer

    c = PORT.LiveCluster("CREATE TABLE t (id INTEGER PRIMARY KEY);",
                         num_nodes=2, default_capacity=8)
    with ApiServer(c) as srv:
        for route, module in (("perf", "obs/ledger.py"),
                              ("doctor", "obs/doctor.py")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{srv.url}/v1/{route}", timeout=30)
            assert ei.value.code == 404
            assert module in json.loads(ei.value.read())["error"]
    c.tripwire.trip()


def test_serve_check_on_the_cpu():
    """chip_smoke.py's "serve_10k" check on a 48-node Consul-schema
    cluster on the CPU: one HTTP transaction, the same rows over HTTP,
    pgwire and directly, the write's event on the HTTP subscription,
    members and table stats for every node, and a scrape the reference
    file's exposition validator accepts."""
    from corro_sim_torch import profile_slice as ps
    from corro_sim_torch.schema import consul_schema_sql
    from corro_sim_torch.utils.metrics import validate_exposition
    from test_metrics import _validate_exposition

    c = PORT.LiveCluster(consul_schema_sql(), num_nodes=48, seed=0,
                         capacities=ps.subs_capacities(ps.LIVE_KEYS),
                         cfg_overrides=dict(ps.LIVE_OVERRIDES))
    out = ps.serve_check(c, writer=5, reader=40)
    assert ps.serve_agrees(out)
    assert out["execute"] == {"results": [{"rows_affected": 1}],
                              "version": 1}
    assert len(out["members"]) == 48
    assert out["table_stats"]["tables"]["consul_services"][
        "live_rows_per_node"] == [1] * 48
    _validate_exposition(out["metrics"])
    validate_exposition(out["metrics"])
    assert "corro_db_size_bytes" in out["metrics"]
    c.tripwire.trip()
