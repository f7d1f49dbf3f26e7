"""Parity of the port's LiveCluster SQL surface with the JAX package's on
the CPU: every case of tests/test_{subqueries,sub_aggregates,sql_extras,
dml_exprs,functions,wire_parity,subs_load}.py that builds a LiveCluster
and needs no ApiServer, PgServer or ApiClient (this file the query
modules', tests/test_torch_cluster_sql_dml.py the rest; three cases,
``test_pgwire_aggregate_fields``, ``test_http_expression_dml`` and
``test_pg_expression_dml``, wait for the serving surfaces).

Each reference case runs as it is written, with its own assertions,
twice: once on the JAX package's LiveCluster and once with the name
``LiveCluster`` bound to the port's (``device="cpu"``) in the case's
module and in ``corro_sim.harness.cluster`` for the cases that import it
locally. A recorder around every cluster the case builds (its module
fixture's too) logs each method call: name, arguments and result or
error. The two runs must pass alike, log the same calls with the same
results (events, rows, versions, errors), and leave the same clusters
(tests/test_torch_cluster.py::assert_same_cluster); wall-clock
fields are left out of the logs. Cases on a shared
module fixture run in the reference file's order on one fixture
cluster per package, as pytest runs them there. Tolerance: exact.
"""

import importlib
import types

import pytest

import corro_sim.harness.cluster as r_cluster
import corro_sim.utils.metrics as r_metrics
from corro_sim_torch.subs import manager as p_manager
from corro_sim_torch.subs import query as p_query
from corro_sim_torch.utils import metrics as p_metrics
from test_torch_cluster import (  # noqa: F401 - a module fixture
    BOTH, PORT, assert_same_cluster, one_torch_thread, outcome, plain)

# reference module -> its LiveCluster cases, in file order; the fixture
# scope where its cases take the module's ``cluster`` fixture
CASES = {
    "test_subqueries": (None, [
        "test_in_select_query", "test_in_select_live_subscription",
        "test_range_join_query", "test_range_join_live_subscription",
        "test_not_in_select_null_three_valued",
        "test_dml_delete_with_in_select"]),
    "test_sub_aggregates": (None, [
        "test_in_like_between_query_rows",
        "test_like_subscription_live_events",
        "test_live_aggregate_subscription_under_churn",
        "test_ungrouped_aggregate_subscription",
        "test_aggregate_sub_with_where_and_rebind",
        "test_aggregate_sub_rejections",
        "test_aggregate_unsubscribe_resubscribe",
        "test_min_max_retract_rescan",
        "test_join_aggregate_incremental_group_local"]),
    "test_sql_extras": (None, [
        "test_order_by_and_limit", "test_group_by_aggregates",
        "test_global_aggregates_and_empty_table",
        "test_sum_over_text_coerces_like_sqlite",
        "test_order_by_unselected_column_does_not_leak",
        "test_subscriptions_reject_extras"]),
    "test_dml_exprs": ("module", [
        "test_update_expression_under_gossip",
        "test_update_expression_where", "test_update_case_expression",
        "test_insert_select", "test_delete_expression_where",
        "test_values_expressions", "test_read_your_writes_in_batch"]),
    "test_functions": ("module", [
        "test_query_filter_selector_in_column",
        "test_query_filter_composes_with_device_terms",
        "test_query_filter_column_as_selector",
        "test_subscription_with_containment"]),
    "test_wire_parity": (None, ["test_query_event_stream_shapes"]),
    "test_subs_load": ("function", [
        "test_change_ids_monotone_under_concurrent_writes",
        "test_catch_up_replays_exactly_the_missed_suffix",
        "test_catch_up_compacted_past_returns_none",
        "test_conflicting_writers_surface_one_coherent_stream",
        "test_delete_storm_events_and_catch_up"]),
}
# what a case's module binds from the JAX package and applies to a
# cluster's layout, universe or tables itself: the port's run binds the
# port's
PORT_NAMES = {"make_matcher": p_manager.make_matcher,
              "LayoutAdapter": p_manager.LayoutAdapter,
              "parse_query": p_query.parse_query}
# cases that build their own clusters beside a function fixture module
OWN_CLUSTERS = {("test_subs_load",
                 "test_batched_matcher_eval_matches_per_matcher_path")}
# this file runs the query modules' cases;
# tests/test_torch_cluster_sql_dml.py the rest
QUERY_MODULES = ("test_subqueries", "test_sub_aggregates", "test_sql_extras")


def params(modules) -> list:
    return [(mod, name) for mod, (_, names) in CASES.items()
            if mod in modules for name in names] + sorted(
        c for c in OWN_CLUSTERS if c[0] in modules)


PARAMS = params(QUERY_MODULES)


class Recorder:
    """A cluster whose method calls are logged: (name, args, kwargs,
    result or (error class, message))."""

    def __init__(self, inner):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_calls", [])

    def __getattr__(self, name):
        v = getattr(self._inner, name)
        if not isinstance(v, types.MethodType):
            return v

        def call(*a, **kw):
            try:
                r = v(*a, **kw)
            except Exception as e:
                self._calls.append((name, a, kw, (type(e).__name__, str(e))))
                raise
            self._calls.append((name, a, kw, r))
            return r

        return call

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)


class Bound:
    """Binds ``LiveCluster`` to one package's recording factory in a
    reference module (and in ``corro_sim.harness.cluster``) while
    entered; the port's runs also read the port's counters and matcher
    factory where a case reaches for the JAX package's."""

    def __init__(self, B, mod, made: list):
        self.B, self.mod, self.made = B, mod, made

    def factory(self, *a, **kw):
        c = Recorder(self.B.LiveCluster(*a, **kw))
        self.made.append(c)
        return c

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        self.mp.setattr(self.mod, "LiveCluster", self.factory)
        self.mp.setattr(r_cluster, "LiveCluster", self.factory)
        if self.B is PORT:
            self.mp.setattr(r_metrics, "counters", p_metrics.counters)
            for name, obj in PORT_NAMES.items():
                if hasattr(self.mod, name):
                    self.mp.setattr(self.mod, name, obj)
        return self

    def __exit__(self, *exc):
        self.mp.undo()
        return False


def untimed(x):
    """``x`` without its wall-clock fields (``execute``'s ``time``)."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k != "time"}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def fixture_cluster(B, mod):
    """The reference module's ``cluster`` fixture body, on ``B``."""
    made = []
    with Bound(B, mod, made):
        got = mod.cluster.__wrapped__()
        if isinstance(got, types.GeneratorType):
            got = next(got)
    return got, made


@pytest.fixture(scope="module")
def module_fixtures():
    """One fixture cluster per package per module-scoped reference
    module, built on first use."""
    return {}


def run_both(mod_name: str, name: str, module_fixtures: dict) -> None:
    mod = importlib.import_module(mod_name)
    scope = CASES.get(mod_name, (None, ()))[0]
    if (mod_name, name) in OWN_CLUSTERS:
        scope = None
    got, made = {}, {}
    for B in BOTH:
        args, made[B.key] = [], []
        if scope == "module":
            key = (mod_name, B.key)
            if key not in module_fixtures:
                module_fixtures[key] = fixture_cluster(B, mod)
            c, built = module_fixtures[key]
            made[B.key] = built
            args = [c]
        elif scope == "function":
            c, made[B.key] = fixture_cluster(B, mod)
            args = [c]
        with Bound(B, mod, made[B.key]):
            got[B.key] = outcome(getattr(mod, name), *args)
    assert got["ref"][0] == "ok", got["ref"]
    assert got["port"] == got["ref"]
    assert len(made["port"]) == len(made["ref"]) > 0
    for rc, pc in zip(made["ref"], made["port"]):
        assert untimed(plain(pc._calls)) == untimed(plain(rc._calls))
        assert_same_cluster(rc._inner, pc._inner)


@pytest.mark.parametrize("mod_name,name", PARAMS,
                         ids=[f"{m[5:]}::{n[5:]}" for m, n in PARAMS])
def test_reference_case(mod_name, name, module_fixtures):
    run_both(mod_name, name, module_fixtures)


def test_every_reference_case_is_run():
    """The two files together run every listed case once."""
    listed = {(m, n) for m, (_, names) in CASES.items() for n in names}
    listed |= OWN_CLUSTERS
    rest = {m for m in CASES if m not in QUERY_MODULES}
    assert set(PARAMS) | set(params(rest)) == listed
    assert not set(PARAMS) & set(params(rest))
