"""Parity of the port's subscription engine (corro_sim_torch.subs) with the
JAX package's on the CPU: the query parser and normalization, LIKE, the
rank-space predicate compilers (one matcher and batched), ``SubsManager``
with its plain and structured matchers, and the Consul population that
chip_smoke.py's "subs_digests" and "subs_10k" phases register.

Cases named after a reference case mirror it (tests/test_subs.py,
tests/test_subs_load.py, tests/test_sub_aggregates.py,
tests/test_subqueries.py, tests/test_sql_extras.py, tests/test_functions.py,
tests/test_joins.py; the ones that need no ``LiveCluster``): each runs
once per package, keeps the reference case's own assertions and returns
what it observed (rows, events, normalized SQL, masks, and the class and
message of every error raised); the port must observe exactly what the
JAX package does. Replayed tables come from the JAX package's ``replay``
and reach the port through ``corro_sim_torch.convert``, so both evaluate
identical planes. Tolerance: exact.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import corro_sim.subs as r_subs
import corro_sim.subs.manager as r_manager
import corro_sim.subs.query as r_query
from corro_sim import schema as r_schema
from corro_sim.core.crdt import TableState as RTableState
from corro_sim.engine.replay import replay as r_replay
from corro_sim.engine.state import init_state as r_init_state
from corro_sim.io import traces as r_traces
from corro_sim.io.values import LiveUniverse as RLiveUniverse
import corro_sim_torch.subs as p_subs
import corro_sim_torch.subs.manager as p_manager
import corro_sim_torch.subs.query as p_query
from corro_sim_torch import profile_slice as ps
from corro_sim_torch import schema as p_schema
from corro_sim_torch.convert import state_from_reference
from corro_sim_torch.core.crdt import TableState
from corro_sim_torch.engine.replay import replay as p_replay
from corro_sim_torch.engine.state import init_state as p_init_state
from corro_sim_torch.io import traces as p_traces
from corro_sim_torch.io.values import LiveUniverse as PLiveUniverse
from corro_sim_torch.utils.metrics import SUBS_BATCH_GROUPS_TOTAL, counters
from corro_sim_torch.utils.ranks import translate_ranks

REF = types.SimpleNamespace(
    key="ref", subs=r_subs, manager=r_manager, query=r_query,
    schema=r_schema, traces=r_traces, LiveUniverse=RLiveUniverse,
    tensor=lambda x: jnp.asarray(np.asarray(x, np.int32)),
    host=np.asarray,
    table=lambda vr, cl: RTableState(
        cv=jnp.asarray(np.ones_like(vr)), vr=jnp.asarray(vr),
        site=jnp.asarray(np.zeros_like(vr)), cl=jnp.asarray(cl)))
PORT = types.SimpleNamespace(
    key="port", subs=p_subs, manager=p_manager, query=p_query,
    schema=p_schema, traces=p_traces, LiveUniverse=PLiveUniverse,
    tensor=lambda x: torch.as_tensor(np.asarray(x, np.int32)),
    host=lambda t: t.numpy(),
    table=lambda vr, cl: TableState(
        cv=torch.as_tensor(np.ones_like(vr)), vr=torch.as_tensor(vr),
        site=torch.as_tensor(np.zeros_like(vr)), cl=torch.as_tensor(cl)))

A0 = "aaaaaaaa-0000-0000-0000-000000000000"
A1 = "bbbbbbbb-0000-0000-0000-000000000001"


def outcome(fn, *args):
    """``fn(*args)``'s value, or the error it raised as (class, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return (type(e).__name__, str(e))


def plain(x):
    """``x`` with dataclasses (AST nodes, events) spelled as class name and
    fields and arrays as lists, so that the two packages' objects
    compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, np.generic):
        return x.item()
    return x


def port_table(ref_state) -> TableState:
    """The table of the JAX package's replayed state, converted for the
    port (``corro_sim_torch.convert``)."""
    leaves = {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }
    return state_from_reference(leaves, "cpu").table


def replayed(lines, layouts=None, **cfg_kw):
    """``lines`` ingested by each package (against its own copy of
    ``layouts``' (schema sql, capacities)), the JAX package's replay, and
    its table converted for the port: ``{"ref": (layout, trace, table),
    "port": (layout, trace, table), "result": the JAX ReplayResult}``."""
    out = {}
    for key, P in (("ref", REF), ("port", PORT)):
        lay = None
        if layouts is not None:
            sql, caps = layouts
            lay = P.schema.TableLayout(P.schema.parse_and_constrain(sql),
                                       capacities=caps)
        out[key] = (lay, P.traces.ingest(lines, layout=lay))
    lay, tr = out["ref"]
    max_rounds = cfg_kw.pop("max_rounds", 128)
    res = r_replay(tr, tr.suggest_config(**cfg_kw), max_rounds=max_rounds)
    out["ref"] = (lay, tr, res.state.table)
    out["port"] = out["port"] + (port_table(res.state),)
    out["result"] = res
    return out


# ------------------------------------------------- tests/test_subs.py parse


def parse_and_normalize(P):
    s = P.query.parse_query(
        "select  a , b from t where a = 1 AND (b < 'x' OR b IS NULL)")
    assert s.table == "t"
    assert s.columns == ("a", "b")
    assert (s.normalized()
            == "SELECT a, b FROM t WHERE (a = 1 AND (b < 'x' OR b IS NULL))")
    assert P.query.parse_query(s.normalized()).normalized() == s.normalized()
    return s, s.normalized()


def parse_star_and_ops(P):
    s = P.query.parse_query("SELECT * FROM t WHERE a <> 2")
    assert s.columns == ()
    assert s.normalized() == "SELECT * FROM t WHERE a != 2"
    return s


def parse_rejects_garbage(P):
    out = [outcome(P.query.parse_query, bad) for bad in (
        "SELECT FROM t", "SELECT a FROM", "SELECT a FROM t WHERE",
        "SELECT a FROM t WHERE a ==", "SELECT a FROM t extra stuff",
        "DELETE FROM t")]
    assert all(k == "QueryError" for k, _ in out)
    return out


def referenced_columns(P):
    s = P.query.parse_query(
        "SELECT a FROM t WHERE b = 1 AND NOT (c > 2 OR d IS NULL)")
    assert s.referenced_columns() == {"b", "c", "d"}
    return sorted(s.referenced_columns())


# ------------------------------------------ tests/test_sub_aggregates.py


def parse_in_like_between(P):
    s = P.query.parse_query(
        "SELECT id FROM orders WHERE customer IN ('ana', 'bob') "
        "AND amount BETWEEN 5 AND 25 AND customer NOT LIKE 'z%'")
    norm = s.normalized()
    assert "IN ('ana', 'bob')" in norm
    assert "amount >= 5" in norm and "amount <= 25" in norm
    assert "NOT LIKE 'z%'" in norm
    assert P.query.parse_query(norm).normalized() == norm
    bad = [outcome(P.query.parse_query, q) for q in (
        "SELECT id FROM orders WHERE customer NOT 5",
        "SELECT id FROM orders WHERE customer LIKE 5")]
    assert all(k == "QueryError" for k, _ in bad)
    return norm, bad


def like_prefix_ranges_and_match(P):
    lpr, lm = P.query.like_prefix_ranges, P.query.like_match
    assert sorted(lpr("ab%")) == [
        ("AB", "AC"), ("Ab", "Ac"), ("aB", "aC"), ("ab", "ac")]
    ranges = [lpr(p) for p in ("ab%", "a_b%", "%", "1%", "-2%", "in%",
                               "ind%", "indigo%")]
    assert ranges[1:6] == [None] * 5 and ranges[6] is not None
    assert ranges[7] is None
    matches = [lm("a%", "ANA"), lm("_ob", "bob"), lm("1%", 12),
               lm("a%", b"ana"), lm("a%", None)]
    assert matches == [True, True, True, False, False]
    return [sorted(r) if r else r for r in ranges], matches


def like_ascii_only_case_folding(P):
    lpr, lm = P.query.like_prefix_ranges, P.query.like_match
    assert lpr("ß%") == [("ß", "à")]
    out = [lm("ß%", "SSmith"), lm("ß%", "ßx"), lm("é%", "É")]
    assert out == [False, True, False]
    return out


# --------------------------------------------- tests/test_subqueries.py


def parse_in_select_and_normalize(P):
    s = P.query.parse_query(
        "SELECT id FROM users WHERE team IN (SELECT name FROM vip_teams)")
    assert "IN (SELECT name FROM vip_teams)" in s.normalized()
    s2 = P.query.parse_query(s.normalized())
    assert s2.normalized() == s.normalized()
    return s, s.normalized()


def parse_in_select_rejects_non_scalar(P):
    out = outcome(P.query.parse_query,
                  "SELECT id FROM users WHERE team IN (SELECT name, "
                  "min_score FROM vip_teams)")
    assert out[0] == "QueryError"
    return out


def parse_range_join_on(P):
    s = P.query.parse_query(
        "SELECT u.id, v.name FROM users u JOIN vip_teams v "
        "ON u.score >= v.min_score")
    assert s.joins[0].on_expr is not None
    assert P.query.parse_query(s.normalized()).normalized() == s.normalized()
    return s.normalized()


# ---------------------------------------------- tests/test_sql_extras.py


def parse_and_normalize_extras(P):
    s = P.query.parse_query(
        "SELECT customer, COUNT(*), SUM(amount) FROM orders "
        "GROUP BY customer ORDER BY customer DESC LIMIT 2 OFFSET 1")
    assert s.aggregates[0].fn == "COUNT" and s.aggregates[1].col == "amount"
    assert s.group_by == ("customer",)
    assert s.order_by == (("customer", True),)
    assert s.limit == 2 and s.offset == 1
    assert "GROUP BY customer" in s.normalized()
    b = s.base()
    assert not b.has_extras()
    assert set(b.columns) >= {"customer", "amount"}
    bad = [outcome(P.query.parse_query, q) for q in (
        "SELECT amount FROM orders GROUP BY customer",
        "SELECT customer, SUM(amount) FROM orders",
        "SELECT SUM(*) FROM orders")]
    assert all(k == "QueryError" for k, _ in bad)
    return s, s.normalized(), b, bad


# ------------------------------------------------ tests/test_functions.py


def parse_shapes(P):
    q = P.query.parse_query(
        "SELECT name FROM services WHERE "
        "corro_json_contains('{\"app\": \"web\"}', meta)")
    assert isinstance(q.where, P.query.JsonContains)
    assert q.where.col == "meta" and q.where.col_is_object
    assert "meta" in q.referenced_columns()
    q2 = P.query.parse_query(
        "SELECT name FROM services WHERE corro_json_contains(meta, '{}')")
    assert not q2.where.col_is_object
    bad = [outcome(P.query.parse_query, s) for s in (
        "SELECT name FROM services WHERE corro_json_contains('{', meta)",
        "SELECT name FROM services WHERE corro_json_contains(1, meta)")]
    assert all(k == "QueryError" for k, _ in bad)
    return q.normalized(), q2.normalized(), bad


# ---------------------------------------------------- tests/test_joins.py

JOIN_SQL = ("SELECT s.id, s.name, c.id, c.status FROM services s "
            "JOIN checks c ON s.id = c.service_id")


def parse_and_normalize_join(P):
    sel = P.query.parse_query(JOIN_SQL)
    assert sel.join is not None
    assert sel.alias == "s" and sel.join.alias == "c"
    assert sel.join.on_left == "s.id" and sel.join.on_right == "c.service_id"
    sel2 = P.query.parse_query(
        "SELECT s.id, s.name, c.id, c.status FROM services s "
        "JOIN checks c ON c.service_id = s.id")
    assert sel2.normalized() == sel.normalized()
    bad = outcome(P.query.parse_query,
                  "SELECT x FROM a a2 JOIN b a2 ON a2.x = a2.y")
    assert bad[0] == "QueryError"
    return sel, sel.normalized(), bad


def parse_join_chain(P):
    sel = P.query.parse_query(
        "SELECT s.id, c.status, o.team FROM services s "
        "JOIN checks c ON s.id = c.service_id "
        "JOIN owners o ON s.id = o.service_id")
    assert len(sel.joins) == 2
    assert (sel.joins[1].on_left == "s.id"
            and sel.joins[1].on_right == "o.service_id")
    bad = [outcome(P.query.parse_query, q) for q in (
        "SELECT a.x FROM a JOIN b ON c.x = b.x JOIN c ON a.x = c.x",
        "SELECT a.x FROM a JOIN b ON a.x = b.x JOIN b ON a.x = b.y")]
    assert all(k == "QueryError" for k, _ in bad)
    return sel.normalized(), bad


# --------------------------------------------- tests/test_subs_load.py


def batch_plan_covers_dev_predicates(P):
    uni = P.manager.IdentityUniverse()
    col = {"id": 0, "node": 1, "val": 2}
    p1 = P.query.parse_query("SELECT id FROM services WHERE val >= 7").where
    p2 = P.query.parse_query("SELECT id FROM services WHERE val >= 21").where
    s1, c1 = P.query.predicate_batch_plan(p1, uni, col.get)
    s2, c2 = P.query.predicate_batch_plan(p2, uni, col.get)
    assert s1 == s2
    assert not np.array_equal(c1[0], c2[0])
    fn = P.query.compile_predicate_batched(s1)
    vr = P.tensor([[0, 0, 10], [0, 0, 21], [0, 0, 40]])
    unset = vr != vr
    m1 = [bool(x) for x in P.host(fn(vr, unset, [P.tensor(c1[0])]))]
    m2 = [bool(x) for x in P.host(fn(vr, unset, [P.tensor(c2[0])]))]
    assert m1 == [True, True, True]
    assert m2 == [False, True, True]
    return s1, c1, c2, m1, m2


def batched_like_matches_per_matcher_compile(P):
    uni = P.query.RankUniverse([None, 1, 2, "apple", "apricot", "banana"])
    col = {"id": 0, "val": 1}
    rows = [None, 1, "apple", "apricot", "banana"]
    vr = P.tensor([[0, uni.rank_of(v)[0]] for v in rows])
    unset = vr != vr
    out = []
    for sql in ("SELECT id FROM services WHERE val LIKE 'ap%'",
                "SELECT id FROM services WHERE val NOT LIKE 'ap%'"):
        pred = P.query.parse_query(sql).where
        ref = P.host(P.query.compile_predicate(pred, uni, col.get)(vr, unset))
        skel, consts = P.query.predicate_batch_plan(pred, uni, col.get)
        got = P.host(P.query.compile_predicate_batched(skel)(
            vr, unset, [P.tensor(consts[0])]))
        assert np.array_equal(ref, got), sql
        out.append((skel, consts, got))
    assert [bool(x) for x in out[0][2]] == [False, False, True, True, False]
    return out


PARSE_CASES = [
    parse_and_normalize, parse_star_and_ops, parse_rejects_garbage,
    referenced_columns, parse_in_like_between, like_prefix_ranges_and_match,
    like_ascii_only_case_folding, parse_in_select_and_normalize,
    parse_in_select_rejects_non_scalar, parse_range_join_on,
    parse_and_normalize_extras, parse_shapes, parse_and_normalize_join,
    parse_join_chain, batch_plan_covers_dev_predicates,
    batched_like_matches_per_matcher_compile,
]


@pytest.mark.parametrize("case", PARSE_CASES, ids=lambda f: f.__name__)
def test_query_layer_matches_the_jax_package(case):
    assert plain(case(PORT)) == plain(case(REF))


# ------------------------------------------ tests/test_subs.py end to end

SERVICES_SQL = (
    "CREATE TABLE services (node TEXT NOT NULL, id TEXT NOT NULL, "
    "port INTEGER DEFAULT 0, status TEXT DEFAULT '', "
    "PRIMARY KEY (node, id));")
CONSUL_LINES = [
    ("A0", 1, 0, [("services", ("n0", "web"), "port", 80, 1, 1),
                  ("services", ("n0", "web"), "status", "up", 1, 1)]),
    ("A1", 1, 1, [("services", ("n1", "db"), "port", 5432, 1, 1),
                  ("services", ("n1", "db"), "status", "down", 1, 1)]),
]


def _lines(spec):
    actors = {"A0": A0, "A1": A1}
    return [r_traces.dump_changeset(actors[a], v, ts, cells)
            for a, v, ts, cells in spec]


@pytest.fixture(scope="module")
def consul():
    """tests/test_subs.py::_consul_setup on both packages."""
    out = replayed(_lines(CONSUL_LINES), (SERVICES_SQL, {"services": 16}),
                   fanout=2, sync_interval=2)
    assert out["result"].converged_round is not None
    return out


def _mgr(P, lay, tr, **kw):
    return P.subs.SubsManager(P.subs.LayoutAdapter(layout=lay),
                              P.subs.TraceUniverse(tr), **kw)


def initial_query_rows_and_eoq(P, fx):
    lay, tr, table = fx
    mgr = _mgr(P, lay, tr)
    m, initial = mgr.get_or_insert(
        "SELECT port, status FROM services WHERE status = 'up'", 0, table)
    assert initial[0] == {"columns": ["node", "id", "port", "status"]}
    rows = [e for e in initial if "row" in e]
    assert len(rows) == 1
    assert rows[0]["row"][1] == ["n0", "web", 80, "up"]
    assert initial[-1] == {"eoq": {"change_id": 0}}
    return initial


def dedupe_by_normalized_sql(P, fx):
    lay, tr, table = fx
    mgr = _mgr(P, lay, tr)
    m1, i1 = mgr.get_or_insert(
        "SELECT port FROM services WHERE port > 100", 0, table)
    m2, i2 = mgr.get_or_insert(
        "select  port  from services where port > 100", 0, table)
    assert m1 is m2 and i2 is None
    assert len(mgr) == 1
    m3, i3 = mgr.get_or_insert(
        "SELECT port FROM services WHERE port > 100", 1, table)
    assert m3 is not m1 and i3 is not None
    return [m1.id, i1, m3.id, i3, len(mgr)]


def catch_up_and_purge(P, fx):
    lay, tr, table = fx
    mgr = _mgr(P, lay, tr, max_buffer=4)
    m, first = mgr.get_or_insert("SELECT port FROM services", 0, table)
    ev = m.step(table)
    assert ev == []
    assert m.catch_up(0) == []
    assert m.catch_up(99) is None
    return first, ev


def candidate_filter(P, fx):
    lay, tr, table = fx
    mgr = _mgr(P, lay, tr)
    m, _ = mgr.get_or_insert(
        "SELECT port FROM services WHERE status = 'up'", 0, table)
    out = [m.is_candidate(t) for t in (
        None, {("services", "status")}, {("services", "port")},
        {("services", None)}, {("services", "meta_unwatched")},
        {("other_table", "status")})]
    assert out == [True, True, True, True, False, False]
    return out


def unknown_column_rejected(P, fx):
    lay, tr, table = fx
    mgr = _mgr(P, lay, tr)
    out = [outcome(mgr.get_or_insert, sql, 0, table) for sql in (
        "SELECT nope FROM services",
        "SELECT port FROM services WHERE ghost = 1")]
    assert all(k == "QueryError" for k, _ in out)
    return out


CONSUL_CASES = [initial_query_rows_and_eoq, dedupe_by_normalized_sql,
                catch_up_and_purge, candidate_filter,
                unknown_column_rejected]


@pytest.mark.parametrize("case", CONSUL_CASES, ids=lambda f: f.__name__)
def test_manager_matches_the_jax_package(case, consul):
    assert plain(case(PORT, consul["port"])) == plain(case(REF, consul["ref"]))


def test_change_events_insert_update_delete():
    """tests/test_subs.py::test_change_events_insert_update_delete: primed
    on an empty table, stepped on the replay of both trace segments."""
    lines2 = [
        ("A0", 2, 2, [("services", ("n0", "web"), "status", "degraded", 2,
                       1)]),
        ("A1", 2, 3, [("services", ("n2", "cache"), "port", 11211, 1, 1)]),
        ("A0", 3, 4, [("services", ("n1", "db"), r_traces.DELETE_CID, None,
                       1, 2)]),
    ]
    fx = replayed(_lines(CONSUL_LINES + lines2),
                  (SERVICES_SQL, {"services": 16}), fanout=2,
                  sync_interval=2)
    assert fx["result"].converged_round is not None
    empty = {
        "ref": r_init_state(fx["ref"][1].suggest_config(
            fanout=2, sync_interval=2)).table,
        "port": p_init_state(fx["port"][1].suggest_config(
            fanout=2, sync_interval=2), device="cpu").table,
    }
    seen = {}
    for key, P in (("ref", REF), ("port", PORT)):
        lay, tr, table = fx[key]
        mgr = _mgr(P, lay, tr)
        m, initial = mgr.get_or_insert("SELECT status FROM services", 0,
                                       empty[key])
        assert [e for e in initial if "row" in e] == []
        events = m.step(table)
        assert sorted(e.kind for e in events) == ["insert", "insert"]
        by_row = {tuple(e.cells[:2]): e for e in events}
        assert by_row[("n0", "web")].cells[2] == "degraded"
        assert ("n1", "db") not in by_row
        seen[key] = plain((initial, events))
    assert seen["port"] == seen["ref"]


def test_trace_adapter_without_schema():
    """tests/test_subs.py::test_trace_adapter_without_schema."""
    lines = [r_traces.dump_changeset(A0, 1, 0, [("t", (1,), "v", 10, 1, 1)]),
             r_traces.dump_changeset(A1, 1, 1, [("t", (2,), "v", 20, 1, 1)])]
    fx = replayed(lines, fanout=2, sync_interval=2)
    seen = {}
    for key, P in (("ref", REF), ("port", PORT)):
        _, tr, table = fx[key]
        mgr = P.subs.SubsManager(P.subs.LayoutAdapter(trace=tr),
                                 P.subs.TraceUniverse(tr))
        m, initial = mgr.get_or_insert("SELECT v FROM t WHERE v >= 20", 0,
                                       table)
        rows = [e for e in initial if "row" in e]
        assert len(rows) == 1 and rows[0]["row"][1] == [2, 20]
        seen[key] = initial
    assert seen["port"] == seen["ref"]


# ------------------------------------- the Consul population (the slice)

SLICE_FEED = dict(seed=0, actors=8, versions=8, keys=16)
SLICE_NODES = 16
SLICE_CUT = 4  # half the feed's versions injected


@pytest.fixture(scope="module")
def consul_feed():
    """chip_smoke.py's subscription table at a small size: a Consul feed
    (twin_feed, 8 actors × 8 versions, both tables at 16 keys) without
    its hostile lines, replayed by the JAX package at 16 nodes cut after
    SLICE_CUT rounds and to convergence; the port's own replays of
    the same trace give the same tables."""
    feed = ps.twin_feed(**SLICE_FEED)
    lines = ps.subs_lines(feed)
    layouts = (r_schema.consul_schema_sql(),
               ps.subs_capacities(SLICE_FEED["keys"]))
    cut = replayed(lines, layouts, num_nodes=SLICE_NODES,
                   max_rounds=SLICE_CUT)
    full = replayed(lines, layouts, num_nodes=SLICE_NODES,
                    max_rounds=ps.SUBS_MAX_ROUNDS)
    assert cut["result"].converged_round is None
    assert full["result"].converged_round is not None
    return {"cut": cut, "full": full}


def _run(P, fx, subscribers, batch=True):
    (lay, tr, cut), full = fx["cut"][P.key], fx["full"][P.key][2]
    return ps.subs_drive(P.subs, lay, tr, cut, full, subscribers,
                         batch=batch)


def test_port_replays_the_subscription_tables(consul_feed):
    """The port's replay (what chip_smoke.py runs) of the population's
    trace gives the JAX package's tables, cut and converged."""
    lay, tr, _ = consul_feed["cut"]["port"]
    cfg = tr.suggest_config(num_nodes=SLICE_NODES)
    for key, rounds in (("cut", SLICE_CUT),
                        ("full", ps.SUBS_MAX_ROUNDS)):
        got = p_replay(tr, cfg, max_rounds=rounds, device="cpu")
        want = consul_feed[key]["port"][2]
        assert got.rounds == consul_feed[key]["result"].rounds
        for f in ("cv", "vr", "site", "cl"):
            assert torch.equal(getattr(got.state.table, f),
                               getattr(want, f)), (key, f)


# of subs_queries: two of each shape that forms batched groups (ranges,
# status, LIKE, the pk term), one of each other shape, each on its first
# observer
POPULATION = [0, 1, 10, 11, 14, 17, 18, 21, 22, 24, 26, 28, 30, 31]


def test_population_matches_the_jax_package(consul_feed):
    """The population chip_smoke.py registers, cut to 14 queries on one
    observer each (every shape; 2 subscribers each): the initial
    events and the step's events equal the JAX package's, batched and
    single; the host oracle agrees with every plain matcher's mask."""
    queries = ps.subs_queries(ps.SUBS_SEED, SLICE_NODES, SLICE_FEED["keys"])
    queries = [queries[ps.SUBS_OBSERVERS * i] for i in POPULATION]
    subscribers = ps.subs_subscribers(queries, ps.SUBS_SEED, per=2)
    ref = _run(REF, consul_feed, subscribers)
    before = counters.get(SUBS_BATCH_GROUPS_TOTAL)
    port = _run(PORT, consul_feed, subscribers)
    groups = counters.get(SUBS_BATCH_GROUPS_TOTAL) - before
    single = _run(PORT, consul_feed, subscribers, batch=False)
    want = ps.subs_record(ref)
    assert ps.subs_record(port) == want
    assert ps.subs_record(single) == want
    assert want["matchers"] == len(queries)
    assert want["step_events"] > 0 and want["initial_rows"] > 0
    assert groups > 0
    assert counters.get(SUBS_BATCH_GROUPS_TOTAL) - before == groups
    full = consul_feed["full"]["port"][2]
    assert ps.subs_oracle_mismatches(port["manager"], full) == 0
    assert ps.subs_oracle_mismatches(ps.subs_drive(
        PORT.subs, *consul_feed["cut"]["port"][:2], full, full,
        subscribers)["manager"], full) == 0
    assert ps.subs_views(port) == ps.subs_views(single)


def test_observers_agree_at_convergence(consul_feed):
    """Two observers per query (the phase's layout), port only: at
    convergence every query's matchers hold the same rows, and a
    diverged cut state makes at least one query's observers differ."""
    queries = ps.subs_queries(ps.SUBS_SEED, SLICE_NODES, SLICE_FEED["keys"])
    subscribers = ps.subs_subscribers(queries, ps.SUBS_SEED, per=2)
    run = _run(PORT, consul_feed, subscribers)
    assert len(run["manager"]) == len(queries)
    assert ps.subs_disagreements(run) == []
    cut = consul_feed["cut"]["port"][2]
    frozen = dict(run, events={sid: [] for sid in run["events"]})
    assert ps.subs_disagreements(frozen) != []
    assert ps.subs_oracle_mismatches(run["manager"], cut) == 0


# the structured shapes the population does not hold
STRUCTURED = [
    "SELECT name, COUNT(*), MAX(port), MIN(address) FROM consul_services "
    "WHERE port >= 8010 GROUP BY name",
    "SELECT COUNT(*), SUM(port) FROM consul_services",
    "SELECT s.id, c.status FROM consul_services s LEFT JOIN consul_checks c "
    "ON s.id = c.service_id",
    "SELECT s.name, COUNT(*) FROM consul_services s JOIN consul_checks c "
    "ON s.name = c.service_name GROUP BY s.name",
    "SELECT id FROM consul_checks WHERE service_name NOT IN "
    "(SELECT name FROM consul_services WHERE port > 8040) "
    "AND status = 'critical'",
]


@pytest.mark.parametrize("sql", STRUCTURED, ids=range(len(STRUCTURED)))
def test_structured_matchers_prime_and_step(consul_feed, sql):
    """An aggregate with a WHERE and a text MIN, a global aggregate, a LEFT
    join, a join aggregate and a NOT IN semi-join, primed on an observer's
    cut table and stepped on the converged one: the same events as the
    JAX package's."""
    seen = {}
    for P in (REF, PORT):
        (lay, tr, cut), full = (consul_feed["cut"][P.key],
                                consul_feed["full"][P.key][2])
        mgr = _mgr(P, lay, tr)
        out = []
        m, first = mgr.get_or_insert(sql, 11, cut)
        out.append((type(m).__name__, first))
        out.append(sorted(mgr.step(full).items()))
        seen[P.key] = plain(out)
    assert seen["port"] == seen["ref"]
    assert any(ev for _, ev in seen["port"][-1])


# ---------------------------------------- the compilers on random planes

PRED_SQL = [
    "v = 3", "v != 3", "v = 3.0", "v < 2.5", "v <= 'm'", "v > 'm'",
    "v >= 7", "v > 1e300", "v < -1e300", "v IS NULL", "v IS NOT NULL",
    "v IN (1, 'b', 2.5)", "v NOT IN (1, 'b')", "v NOT IN (1, NULL)",
    "v IN (NULL, 4)", "v LIKE 'b%'", "v NOT LIKE 'ab%'",
    "v > 2 AND w < 'q'", "v = 1 OR NOT (w IS NULL)",
    "NOT (v >= 4 OR w = 'a')", "v = NULL", "v < x'10'", "v >= x'00'",
]
VALUES = [None, -3, 0, 1, 2, 3, 4, 7, 2**40, 0.5, 2.5, 3.0, 1e301, "",
          "a", "ab", "abc", "b", "bz", "m", "q", "z", b"\x00", b"\x10",
          b"\xff"]


@pytest.mark.parametrize("seed", [0, 1])
def test_compilers_match_the_jax_package_on_random_planes(seed):
    """compile_predicate and compile_predicate_batched, both packages, on
    a seeded random rank plane over a universe with NULLs, every type
    band, stored and unstored literals, unset cells, open upper bounds
    and NOT IN over a list with NULL. Batched: every predicate of one
    skeleton evaluated as one group of stacked constants and planes."""
    rng = np.random.default_rng(seed)
    ranks = {}
    for key, P in (("ref", REF), ("port", PORT)):
        uni = P.query.RankUniverse(
            sorted(VALUES, key=P.query.crsql_conflict_key))
        ranks[key] = uni
    R = 64
    vr_np = rng.integers(0, len(VALUES), size=(4, R, 2)).astype(np.int32)
    unset_np = rng.random((4, R, 2)) < 0.15
    vr_np[unset_np] = np.iinfo(np.int32).min
    col = {"v": 0, "w": 1}
    groups: dict = {}
    for i, cond in enumerate(PRED_SQL):
        pred = {k: P.query.parse_query(f"SELECT v FROM t WHERE {cond}").where
                for k, P in (("ref", REF), ("port", PORT))}
        b = i % 4
        one = {}
        for key, P in (("ref", REF), ("port", PORT)):
            vr = P.tensor(vr_np[b])
            unset = P.tensor(unset_np[b]) != 0
            one[key] = P.host(P.query.compile_predicate(
                pred[key], ranks[key], col.get)(vr, unset))
            plan = P.query.predicate_batch_plan(pred[key], ranks[key],
                                                col.get)
            if plan is not None:
                got = P.host(P.query.compile_predicate_batched(plan[0])(
                    vr, unset, [P.tensor(c) for c in plan[1]]))
                assert np.array_equal(got, one[key]), (key, cond)
                if key == "port":
                    groups.setdefault(plan[0], []).append(
                        (b, plan[1], one[key]))
        assert np.array_equal(one["port"], one["ref"]), cond
        # the oracle: SQL over the decoded cells
        want = []
        for r in range(R):
            env = {c: (None if unset_np[b, r, j]
                       else ranks["port"].values[vr_np[b, r, j]])
                   for c, j in col.items()}
            want.append(p_query.eval_predicate_py(pred["port"], env.get))
        assert one["port"].tolist() == want, cond
    # groups of one skeleton, planes and constants stacked
    stacked = 0
    for skel, members in groups.items():
        if len(members) < 2:
            continue
        fn = p_query.compile_predicate_batched(skel)
        bs = [b for b, _, _ in members]
        vr = torch.as_tensor(vr_np[bs])
        unset = torch.as_tensor(unset_np[bs])
        consts = [torch.as_tensor(np.stack(cs))
                  for cs in zip(*(c for _, c, _ in members))]
        got = fn(vr, unset, consts).numpy()
        assert np.array_equal(got, np.stack([m for _, _, m in members]))
        stacked += 1
    assert stacked > 0


# --------------------------------------- a LiveUniverse respace, rebound


LIVE_SQL = ("CREATE TABLE kv (id INTEGER NOT NULL PRIMARY KEY, "
            "v REAL, tag TEXT NOT NULL DEFAULT 'none');")
LIVE_QUERIES = ["SELECT v, tag FROM kv WHERE v > 0.001",
                "SELECT v FROM kv WHERE v <= 0.25 AND tag = 'none'",
                "SELECT id, tag FROM kv WHERE v IS NOT NULL"]


def live_universe_rebind(P):
    """A LiveUniverse over a layout: rows written at four nodes, matchers
    registered (the first query on two observers, a batched group), then
    values crowded into one gap until the universe respaces; the planes
    are translated, ``rebind_all`` adopts the new ranks and the next
    step emits only the real change."""
    lay = P.schema.TableLayout(P.schema.parse_and_constrain(LIVE_SQL),
                               capacities={"kv": 8})
    uni = P.LiveUniverse()
    n, rows, cols = 4, lay.num_rows, lay.num_cols
    vr = np.full((n, rows, cols), np.iinfo(np.int32).min, np.int64)
    cl = np.zeros((n, rows), np.int64)
    vc, tc = lay.col_index("kv", "v"), lay.col_index("kv", "tag")
    for k, (v, tag) in enumerate([(0.5, "a"), (1.0, None), (0.25, "none"),
                                  (2.0, "b"), (0.125, "a")]):
        slot = lay.row_slot("kv", (k,))
        vr[:, slot, vc] = uni.rank(v)
        if tag is not None:
            vr[:, slot, tc] = uni.rank(tag)
        cl[:, slot] = 1

    def table(vr):
        return P.table(vr.astype(np.int32), cl.astype(np.int32))

    mgr = P.subs.SubsManager(P.subs.LayoutAdapter(layout=lay), uni)
    remaps = []
    uni.on_remap(lambda old, new: remaps.append((list(old), list(new))))
    out = [mgr.get_or_insert(q, node, table(vr))[1]
           for q, node in zip(LIVE_QUERIES + LIVE_QUERIES[:1], (0, 2, 3, 1))]
    x = 0.5
    for _ in range(40):
        uni.rank(x)
        x /= 2
    assert remaps, "expected a respace"
    for old, new in remaps:
        vr = translate_ranks(vr, old, new)
        mgr.rebind_all(old, new)
    out.append(sorted(mgr.step(table(vr)).items()))
    assert out[-1] == []  # a respace alone changes no row
    slot = lay.row_slot("kv", (1,))
    vr[:, slot, vc] = uni.rank(0.0009765625)
    out.append(sorted(mgr.step(table(vr)).items()))
    assert out[-1] != []
    return out, remaps


def test_live_universe_respace_and_rebind_all():
    assert plain(live_universe_rebind(PORT)) == plain(
        live_universe_rebind(REF))


def test_slices_outside_the_table_are_refused():
    """The JAX package's dynamic slice clamps a row range past the table's
    end; the port refuses it."""
    vr = torch.zeros((2, 4, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        p_manager.check_slice(vr, 2, 4)
    p_manager.check_slice(vr, 0, 4)


def jax_subs_pins() -> dict:
    """``profile_slice.SUBS_PINS``: the JAX package's run on the CPU of
    chip_smoke.py's "subs_digests" population (a few minutes):
    ``twin_feed(**SUBS_FEED)`` without its hostile lines (``subs_lines``),
    ingested against the Consul schema at ``subs_capacities(keys)``,
    replayed at ``SUBS_PIN_NODES`` nodes (``suggest_config(num_nodes=)``,
    seed 0) cut after ``SUBS_CUT_ROUNDS`` rounds and to convergence
    (``max_rounds=SUBS_MAX_ROUNDS``); the subscribers of
    ``subs_queries(SUBS_SEED, SUBS_PIN_NODES, keys)`` registered on the
    cut table and stepped on the converged one (``subs_drive``): its
    ``subs_record``, and the rounds of both replays.

    Run: ``cd tests && JAX_PLATFORMS=cpu PYTHONPATH=.. python -c "import
    test_torch_subs as t; print(t.jax_subs_pins())"``."""
    keys = ps.SUBS_FEED["keys"]
    lines = ps.subs_lines(ps.twin_feed(**ps.SUBS_FEED))
    lay = r_schema.TableLayout(
        r_schema.parse_and_constrain(r_schema.consul_schema_sql()),
        capacities=ps.subs_capacities(keys))
    tr = r_traces.ingest(lines, layout=lay)
    cfg = tr.suggest_config(num_nodes=ps.SUBS_PIN_NODES)
    cut = r_replay(tr, cfg, max_rounds=ps.SUBS_CUT_ROUNDS)
    full = r_replay(tr, cfg, max_rounds=ps.SUBS_MAX_ROUNDS)
    subscribers = ps.subs_subscribers(
        ps.subs_queries(ps.SUBS_SEED, ps.SUBS_PIN_NODES, keys), ps.SUBS_SEED)
    run = ps.subs_drive(r_subs, lay, tr, cut.state.table, full.state.table,
                        subscribers)
    return dict(ps.subs_record(run), cut_rounds=cut.rounds,
                converged_round=full.converged_round,
                disagreements=len(ps.subs_disagreements(run)))
