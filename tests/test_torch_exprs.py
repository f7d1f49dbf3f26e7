"""Parity of the port's SQL host layer with the JAX package's on the CPU:
``api/exprs.py`` (the scalar-expression parser and evaluator),
``api/statements.py`` (statement shapes, parameter binding, the DML
parser), ``functions.py`` (``corro_json_contains``), ``io/values.py``
(the value orders, the interner and the online ``LiveUniverse`` with its
respace), ``api/wire.py`` and ``api/sql_state.py``.

Each case mirrors a reference case (tests/test_dml_exprs.py,
tests/test_runtime.py, tests/test_functions.py, tests/test_io.py) that
needs no ``LiveCluster``: it runs once per package, keeps the reference
case's own assertions, and returns what it observed (values, and the
class and message of every error raised). The port must observe exactly
what the JAX package does. Tolerance: exact.
"""

import dataclasses
import json
import types

import pytest

import corro_sim.api.exprs as r_exprs
import corro_sim.api.sql_state as r_sql_state
import corro_sim.api.statements as r_statements
import corro_sim.api.wire as r_wire
import corro_sim.functions as r_functions
import corro_sim.io.values as r_values
import corro_sim_torch.api.exprs as p_exprs
import corro_sim_torch.api.sql_state as p_sql_state
import corro_sim_torch.api.statements as p_statements
import corro_sim_torch.api.wire as p_wire
import corro_sim_torch.functions as p_functions
import corro_sim_torch.io.values as p_values

REF = types.SimpleNamespace(
    exprs=r_exprs, statements=r_statements, functions=r_functions,
    values=r_values, wire=r_wire, sql_state=r_sql_state)
PORT = types.SimpleNamespace(
    exprs=p_exprs, statements=p_statements, functions=p_functions,
    values=p_values, wire=p_wire, sql_state=p_sql_state)


def outcome(fn, *args):
    """``fn(*args)``'s value, or the error it raised as (class, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return (type(e).__name__, str(e))


def ev(M, sql, env=None):
    return outcome(lambda: M.exprs.eval_expr(M.exprs.parse_expr(sql),
                                             env or {}))


def plain(x):
    """``x`` with every dataclass (an AST node, a ``WriteOp``) spelled as
    its class name and fields, so that the two packages' objects
    compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    return x


def typed(x):
    """A value with its type, so that 3 and 3.0 and True differ."""
    return (type(x).__name__, x)


# ------------------------------------------------- tests/test_dml_exprs.py


def eval_arithmetic_and_precedence(M):
    out = [ev(M, s) for s in ("1 + 2 * 3", "(1 + 2) * 3", "7 / 2",
                              "7.0 / 2", "-7 / 2", "7 % 3", "1 / 0",
                              "'a' || 'b' || 'c'")]
    assert [v for _, v in out] == [7, 9, 3, 3.5, -3, 1, None, "abc"]
    return [(k, typed(v)) for k, v in out]


def eval_null_propagation_and_3vl(M):
    out = [ev(M, "1 + NULL"), ev(M, "NULL = NULL"),
           ev(M, "x IS NULL", {"x": None}), ev(M, "x IS NOT NULL", {"x": 3}),
           ev(M, "NULL = 1 OR 1 = 1"), ev(M, "NULL = 1 AND 1 = 2"),
           ev(M, "x IN (1, NULL)", {"x": 2})]
    assert [v for _, v in out] == [None, None, True, True, True, False,
                                   None]
    return out


def eval_case_functions_columns(M):
    env = {"v": 5, "name": "ada"}
    sqls = ("CASE WHEN v > 3 THEN 'big' ELSE 'small' END",
            "CASE v WHEN 5 THEN 'five' END", "upper(name) || '!'",
            "coalesce(NULL, NULL, v)", "abs(-v)", "substr(name, 2)",
            "length(name) + v", "iif(v % 2 = 1, 'odd', 'even')",
            "max(v, 3)", "nullif(v, 5)")
    out = [ev(M, s, env) for s in sqls]
    assert [v for _, v in out] == ["big", "five", "ADA!", 5, 5, "da", 8,
                                   "odd", 5, None]
    return [(k, typed(v)) for k, v in out]


def parse_write_shapes(M):
    pw = M.statements.parse_write
    out = []
    op = pw("UPDATE t SET v = v + 1 WHERE id = 1")
    assert op.kind == "update" and not isinstance(op.sets["v"], int)
    out.append(plain(op))
    op = pw("UPDATE t SET v = 1 + 2 WHERE id = 1")
    assert op.sets["v"] == 3  # column-free folds at parse time
    out.append(plain(op))
    op = pw("INSERT INTO t2 (id, v) SELECT id, v + 10 FROM t")
    assert op.kind == "insert_select" and op.cols == ["id", "v"]
    out.append(plain(op))
    op = pw("DELETE FROM t WHERE v * 2 > 6")
    assert op.where_expr is not None
    out.append(plain(op))
    bad = outcome(pw, "INSERT INTO t (id, v) VALUES (1, v + 1)")
    assert bad[0] == "StatementError"
    out.append(bad)
    return out


def fused_negative_literal_with_mul_tail(M):
    out = [ev(M, "v-5*2", {"v": 20}), ev(M, "v -5", {"v": 20})]
    assert [v for _, v in out] == [10, 15]
    return out


def int_division_exact_above_2_53(M):
    big = 2 ** 62
    out = [ev(M, "v / 3", {"v": big}), ev(M, "v % 7", {"v": big}),
           ev(M, "v / 3", {"v": -7}), ev(M, "v % 3", {"v": -7})]
    assert [v for _, v in out] == [big // 3, big % 7, -2, -1]
    return [(k, typed(v)) for k, v in out]


def round_sqlite_semantics(M):
    out = [ev(M, "round(2.5)"), ev(M, "round(-2.5)"), ev(M, "round(5)"),
           ev(M, "round(2.345, 2)")]
    assert [v for _, v in out[:3]] == [3.0, -3.0, 5.0]
    assert isinstance(out[2][1], float)  # REAL, like SQLite
    return [(k, typed(v)) for k, v in out]


def like_ascii_only_case_folding(M):
    out = [ev(M, "name LIKE 'A%'", {"name": "abc"}),
           ev(M, "name LIKE 'É%'", {"name": "étude"})]
    assert [v for _, v in out] == [True, False]
    return out


def cross_type_comparison_orders_like_sqlite(M):
    out = [ev(M, "v < 'abc'", {"v": 9}), ev(M, "v < x'ff'", {"v": "abc"}),
           ev(M, "v > 5", {"v": b"\x00"})]
    assert [v for _, v in out] == [True, True, True]
    return out


def scalar_min_max_mixed_types(M):
    """The reference's scalar ``min``/``max`` compare Python values, so
    mixed types raise ``TypeError`` (a defect the port keeps; ROADMAP
    queue 3), and ``_text`` of an integral float is ``str``."""
    out = [ev(M, "max(v, 'x')", {"v": 3}), ev(M, "min(v, 2.5)", {"v": 3}),
           ev(M, "v || ''", {"v": 2.0})]
    assert out[0][0] == "TypeError"
    return out


# --------------------------------------------------- tests/test_runtime.py


def live_universe_order_preserved(M):
    u = M.values.LiveUniverse()
    ranks = {v: u.rank(v) for v in [5, "b", 1.5, None, "a", b"z", 3]}
    vals = sorted(ranks, key=M.values.crsql_conflict_key)
    got = sorted(ranks, key=lambda v: ranks[v])
    assert [str(v) for v in vals] == [str(v) for v in got]
    assert u.rank(5) == ranks[5]
    return sorted((str(k), v) for k, v in ranks.items())


def live_universe_remap_on_gap_exhaustion(M):
    u = M.values.LiveUniverse()
    remaps = []
    u.on_remap(lambda old, new: remaps.append((list(old), list(new))))
    u.rank(0.0)
    u.rank(1.0)
    x = 0.5
    for _ in range(40):
        u.rank(x)
        x /= 2
    assert remaps, "expected at least one re-spacing"
    old, new = remaps[-1]
    assert len(old) == len(new)
    assert sorted(new) == new
    vs = [u.decode(r) for r in sorted(u._ranks)]
    assert vs == sorted(vs, key=M.values.crsql_conflict_key)
    return remaps, [(r, repr(u.decode(r))) for r in sorted(u._ranks)]


def statement_shapes(M):
    ps = M.statements.parse_statement
    out = [ps("SELECT 1"), ps(["q", [1, 2]]), ps(["q", 1, 2]),
           ps({"query": "q", "params": [3]}),
           ps({"query": "q", "named_params": {"a": 1}})]
    assert out[:4] == [("SELECT 1", []), ("q", [1, 2]), ("q", [1, 2]),
                       ("q", [3])]
    bad = outcome(ps, 42)
    assert bad[0] == "StatementError"
    return out + [bad]


def bind_params(M):
    bp = M.statements.bind_params
    out = [outcome(bp, "INSERT INTO t (a, b) VALUES (?, ?)", [1, "x'y"]),
           outcome(bp, "UPDATE t SET a = :v WHERE b = $w",
                   {"v": None, "w": 2}),
           outcome(bp, "VALUES (?)", []),
           outcome(bp, "WHERE a = ?2 AND b = ?1 AND c = ?", [1, 2, 3]),
           outcome(bp, "WHERE a = ?9", [1])]
    assert out[0][1] == "INSERT INTO t (a, b) VALUES (1, 'x''y')"
    assert out[1][1] == "UPDATE t SET a = NULL WHERE b = 2"
    assert out[3][1] == "WHERE a = 2 AND b = 1 AND c = 3"
    assert out[2][0] == out[4][0] == "StatementError"
    return out


def parse_write_upsert_multi_values(M):
    op = M.statements.parse_write(
        ["INSERT INTO t (id, v) VALUES (?, ?), (?, ?)", [1, "a", 2, "b"]])
    assert op.kind == "upsert" and op.table == "t"
    assert op.rows == [{"id": 1, "v": "a"}, {"id": 2, "v": "b"}]
    return plain(op)


def parse_write_update_delete(M):
    st = M.statements
    op = st.parse_write("UPDATE t SET v = 'x' WHERE id = 3")
    assert op.kind == "update" and op.sets == {"v": "x"}
    out = [plain(op), st.pk_equalities(op.where, ("id",))]
    op = st.parse_write("DELETE FROM t WHERE a = 1 AND b = 2")
    out += [plain(op), st.pk_equalities(op.where, ("a", "b")),
            st.pk_equalities(op.where, ("a",)),
            outcome(st.parse_write, "UPDATE t SET v = 1"),
            outcome(st.parse_write, "CREATE TABLE t (id INTEGER PRIMARY KEY)")]
    assert out[1] == (3,) and out[3] == (1, 2) and out[4] is None
    assert out[5][0] == out[6][0] == "StatementError"
    return out


def insert_or_replace_and_on_conflict_tolerated(M):
    a = M.statements.parse_write("INSERT OR REPLACE INTO t (id) VALUES (1)")
    b = M.statements.parse_write(
        "INSERT INTO t (id) VALUES (1) ON CONFLICT (id) DO NOTHING")
    assert a.kind == b.kind == "upsert"
    return [plain(a), plain(b)]


# ------------------------------------------------- tests/test_functions.py


def containment_matrix(M):
    def j(s, o):
        return M.functions.json_contains(json.loads(s), json.loads(o))

    pairs = [("{}", "{}"), ("{}", '{"key": "value"}'),
             ('{"key": "value"}', "{}"),
             ('{"key": "value"}', '{"key": "value"}'),
             ('{"key": "value"}', '{"key": "value", "key2": "value2"}'),
             ('{"key": "value"}', '{"key": "wrong value"}'),
             ('{"metadata": {"key": "value"}}',
              '{"metadata": {"key": "value"}}'),
             ('{"metadata": {"key": "value"}}',
              '{"metadata": {"key": "wrong value"}}'),
             ("3", "3"), ("3", "4"), ('"x"', '"x"'), ("[1, 2]", "[1, 2, 3]")]
    out = [j(s, o) for s, o in pairs]
    assert out == [True, True, False, True, True, False, True, False, True,
                   False, True, False]
    return out


def text_helper_malformed_is_false(M):
    jt = M.functions.json_contains_text
    out = [jt("{}", "{not json"), jt("{}", None), jt("{}", 42),
           jt("{}", "{}")]
    assert out == [False, False, False, True]
    return out


# ------------------------------------------------------- tests/test_io.py


def sqlite_value_ordering(M):
    vals = ["started", None, 3, b"\x00", 2.5, "destroyed", b"zz", -7]
    ordered = sorted(vals, key=M.values.sqlite_sort_key)
    assert ordered == [None, -7, 2.5, 3, "destroyed", "started", b"\x00",
                       b"zz"]
    return [typed(v) for v in ordered]


def interner_order_preserving(M):
    it = M.values.ValueInterner()
    for v in ["b", 1, None, "a", 2.0, b"x"]:
        it.add(v)
    it.freeze()
    assert it.rank(None) < it.rank(b"x") < it.rank("a") < it.rank("b")
    assert it.rank("b") < it.rank(2.0) < it.rank(1)
    late = outcome(it.add, "late")
    assert late[0] == "RuntimeError"
    return [it.rank(v) for v in ["b", 1, None, "a", 2.0, b"x"]] + [late]


# ------------------------------------------------ the wire and SQLSTATE


def wire_and_sql_state(M):
    tree = {"a": [b"\x00\xff", 1, "x", {"blob": [1, 2]}], "b": None}
    enc = json.dumps(tree, default=M.wire.encode_value)
    out = [enc, M.wire.decode_values(json.loads(enc)),
           outcome(M.wire.decode_values, {"blob": [256]}),
           outcome(M.wire.encode_value, object),
           M.sql_state.code("unique_violation"), M.sql_state.code("nope"),
           sorted(M.sql_state.SQL_STATE.items())]
    assert out[1]["a"][0] == b"\x00\xff" and out[5] == "XX000"
    return [o if not isinstance(o, tuple) else o[0] for o in out]


CASES = [
    eval_arithmetic_and_precedence, eval_null_propagation_and_3vl,
    eval_case_functions_columns, parse_write_shapes,
    fused_negative_literal_with_mul_tail, int_division_exact_above_2_53,
    round_sqlite_semantics, like_ascii_only_case_folding,
    cross_type_comparison_orders_like_sqlite, scalar_min_max_mixed_types,
    live_universe_order_preserved, live_universe_remap_on_gap_exhaustion,
    statement_shapes, bind_params, parse_write_upsert_multi_values,
    parse_write_update_delete, insert_or_replace_and_on_conflict_tolerated,
    containment_matrix, text_helper_malformed_is_false,
    sqlite_value_ordering, interner_order_preserving, wire_and_sql_state,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_host_layer_matches_the_jax_package(case):
    assert plain(case(PORT)) == plain(case(REF))
