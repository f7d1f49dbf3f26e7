"""Parity of the schema manager (corro_sim_torch.schema) with the JAX
package's ``corro_sim/schema.py`` on the CPU: the cases of
tests/test_schema.py, each run on both modules. Every case returns what
it observed (parsed tables, plans, layouts, or the error class and
message a refusal raises), and the port must observe exactly what the
JAX package does; the case's own assertions hold on both. Then
schema-driven ingest (``layout=``): the encoded trace, and its replay
(every state leaf and metric), equal the JAX package's. Tolerance:
exact.
"""

import dataclasses

import numpy as np
import pytest

from corro_sim import schema as r_schema
from corro_sim.engine.replay import read_table as r_read_table
from corro_sim.engine.replay import replay as r_replay
from corro_sim.io import traces as r_traces
from corro_sim_torch import schema as p_schema
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.replay import read_table, replay
from corro_sim_torch.io import traces as p_traces
from test_torch_workload import _leaves
from test_torch_cluster import one_torch_thread  # noqa: E402,F401

ARRAYS = ("valid", "empty", "delete", "ncells", "row", "col", "vr", "cv",
          "cl", "ts")


def _outcome(fn, S):
    """``fn(S)``'s value, or the refusal it raised as (class, message)."""
    try:
        return ("ok", fn(S))
    except S.SchemaError as e:
        return ("SchemaError", str(e))


def _tables(s):
    return {n: dataclasses.asdict(t) for n, t in s.tables.items()}


def parse_basic(S):
    s = S.parse_schema(
        "CREATE TABLE t (id INTEGER NOT NULL PRIMARY KEY, "
        "v TEXT NOT NULL DEFAULT '');"
    )
    t = s.tables["t"]
    assert t.pk == ("id",)
    assert [c.name for c in t.value_columns] == ["v"]
    assert t.columns[0].type == "INTEGER"
    return _tables(s)


def parse_composite_pk_order(S):
    s = S.parse_schema(
        "CREATE TABLE w (b TEXT NOT NULL, a TEXT NOT NULL, "
        "v INTEGER, PRIMARY KEY (b, a));"
    )
    assert s.tables["w"].pk == ("b", "a")
    return _tables(s)


def parse_strips_internal_tables(S):
    s = S.parse_schema(
        "CREATE TABLE ok (id INTEGER PRIMARY KEY, v TEXT);"
        "CREATE TABLE __corro_members (x INTEGER PRIMARY KEY);"
    )
    assert list(s.tables) == ["ok"]
    return _tables(s)


def generated_columns_not_replicated(S):
    svc = S.parse_schema(S.consul_schema_sql()).tables["consul_services"]
    names = [c.name for c in svc.value_columns]
    assert "app_id" not in names and "meta" in names
    return names, [c.default_value for c in svc.columns]


def constrain_rejects_unique_index(S):
    s = S.parse_schema(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"
        "CREATE UNIQUE INDEX tv ON t (v);"
    )
    return _tables(S.constrain(s))


def constrain_allows_plain_index(S):
    s = S.parse_schema(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"
        "CREATE INDEX tv ON t (v);"
    )
    return _tables(S.constrain(s))


def constrain_rejects_foreign_key(S):
    return _tables(S.parse_schema(
        "CREATE TABLE a (id INTEGER PRIMARY KEY);"
        "CREATE TABLE b (id INTEGER PRIMARY KEY, "
        "aid INTEGER REFERENCES a(id));"
    ))


def constrain_rejects_notnull_without_default(S):
    return _tables(S.constrain(S.parse_schema(
        "CREATE TABLE t (id INTEGER NOT NULL PRIMARY KEY, v TEXT NOT NULL);"
    )))


def constrain_accepts_reference_schemas(S):
    return (_tables(S.parse_and_constrain(S.consul_schema_sql())),
            _tables(S.parse_and_constrain(S.test_schema_sql())))


def apply_schema_new_table_and_column(S):
    old = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);")
    new = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT, w INTEGER DEFAULT 0);"
        "CREATE TABLE u (id INTEGER PRIMARY KEY, x TEXT);"
    )
    plan = S.apply_schema(old, new)
    assert plan.new_tables == ("u",)
    assert plan.new_columns == (("t", "w"),)
    assert plan.rebuilt_tables == ()
    return dataclasses.asdict(plan)


def apply_schema_refuses_drop_tables(S):
    old = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"
        "CREATE TABLE u (id INTEGER PRIMARY KEY);"
    )
    new = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);")
    return S.apply_schema(old, new)


def apply_schema_refuses_drop_columns(S):
    old = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"
        "CREATE TABLE u (id INTEGER PRIMARY KEY);"
    )
    new = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY);"
        "CREATE TABLE u (id INTEGER PRIMARY KEY);"
    )
    return S.apply_schema(old, new)


def apply_schema_refuses_pk_change(S):
    old = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);")
    new = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER, v TEXT, PRIMARY KEY (id, v));")
    return S.apply_schema(old, new)


def apply_schema_new_notnull_column_needs_default(S):
    old = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);")
    new = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT, "
        "w INTEGER NOT NULL DEFAULT 1);"
    )
    plan = S.apply_schema(old, new)
    assert plan.new_columns == (("t", "w"),)
    return dataclasses.asdict(plan)


def apply_schema_column_change_rebuilds(S):
    old = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);")
    new = S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v INTEGER);")
    plan = S.apply_schema(old, new)
    assert plan.rebuilt_tables == ("t",)
    return dataclasses.asdict(plan)


def layout_mapping(S):
    lay = S.TableLayout(
        S.parse_and_constrain(S.consul_schema_sql()),
        capacities={"consul_services": 8, "consul_checks": 4},
    )
    assert lay.num_rows == 12 and lay.num_cols == 6
    s0 = lay.row_slot("consul_services", ("n1", "svc-a"))
    s1 = lay.row_slot("consul_checks", ("n1", "chk-a"))
    assert 0 <= s0 < 8 and 8 <= s1 < 12
    assert lay.row_slot("consul_services", ("n1", "svc-a")) == s0
    cols = {(t.name, c.name): lay.col_index(t.name, c.name)
            for t in lay.schema for c in t.value_columns}
    return (lay.num_rows, lay.num_cols, s0, s1, cols, lay.row_keys(),
            lay.key_of(s1), lay.generation)


def layout_overflow_refused(S):
    lay = S.TableLayout(
        S.parse_and_constrain(
            "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"),
        capacities={"t": 2},
    )
    lay.row_slot("t", (1,))
    lay.row_slot("t", (2,))
    return lay.row_slot("t", (3,))


def layout_migrate_appends(S):
    lay = S.TableLayout(
        S.parse_and_constrain(
            "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"),
        capacities={"t": 4},
    )
    s0 = lay.row_slot("t", (1,))
    c0 = lay.col_index("t", "v")
    plan = lay.migrate(
        S.parse_and_constrain(
            "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT, w INTEGER);"
            "CREATE TABLE u (id INTEGER PRIMARY KEY, x TEXT);"
        ),
        capacities={"u": 2},
    )
    assert plan.new_tables == ("u",)
    assert lay.row_slot("t", (1,)) == s0
    assert lay.col_index("t", "w") == c0 + 1
    assert lay.num_rows == 6
    return (dataclasses.asdict(plan), lay.num_rows, lay.num_cols,
            lay.sorted_pks("t"), lay.generation)


def schema_from_history(S):
    s = S.schema_from_history([
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);",
        "CREATE TABLE u (id INTEGER PRIMARY KEY, x TEXT);",
    ])
    return _tables(s)


def schema_from_empty_history(S):
    return S.schema_from_history([])


def layout_unknown_names(S):
    lay = S.TableLayout(S.parse_and_constrain(
        "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"))
    try:
        lay.col_index("t", "nope")
    except S.SchemaError as e:
        return ("col", str(e), lay.row_slot("nope", (1,)))


CASES = {
    fn.__name__: fn for fn in (
        parse_basic, parse_composite_pk_order, parse_strips_internal_tables,
        generated_columns_not_replicated, constrain_rejects_unique_index,
        constrain_allows_plain_index, constrain_rejects_foreign_key,
        constrain_rejects_notnull_without_default,
        constrain_accepts_reference_schemas,
        apply_schema_new_table_and_column, apply_schema_refuses_drop_tables,
        apply_schema_refuses_drop_columns, apply_schema_refuses_pk_change,
        apply_schema_new_notnull_column_needs_default,
        apply_schema_column_change_rebuilds, layout_mapping,
        layout_overflow_refused, layout_migrate_appends,
        schema_from_history, schema_from_empty_history,
        layout_unknown_names,
    )
}
REFUSALS = {
    "constrain_rejects_unique_index": "unique",
    "constrain_rejects_foreign_key": "foreign key",
    "constrain_rejects_notnull_without_default": "NOT NULL",
    "apply_schema_refuses_drop_tables": "drop tables",
    "apply_schema_refuses_drop_columns": "drop columns",
    "apply_schema_refuses_pk_change": "primary key",
    "layout_overflow_refused": "capacity",
    "schema_from_empty_history": "empty schema history",
    "layout_unknown_names": "no such table",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schema_case_matches_the_jax_package(case):
    want = _outcome(CASES[case], r_schema)
    got = _outcome(CASES[case], p_schema)
    assert got == want
    if case in REFUSALS:
        assert got[0] == "SchemaError" and REFUSALS[case] in got[1], got


def _consul_lines(traces):
    a = ["%08d-0000-0000-0000-000000000000" % i for i in range(2)]
    return [
        traces.dump_changeset(a[0], 1, 0, [
            ("consul_services", ("n0", "svc"), "address", "10.0.0.1", 1, 1),
            ("consul_services", ("n0", "svc"), "port", 80, 1, 1),
        ]),
        traces.dump_changeset(a[1], 1, 1, [
            ("consul_checks", ("n1", "chk"), "status", "passing", 1, 1),
        ]),
        traces.dump_changeset(a[0], 2, 2, [
            ("consul_checks", ("n1", "chk"), "__crsql_del", None, 1, 2),
            ("consul_services", ("n0", "svc"), "port", 81, 2, 1),
        ]),
    ]


def test_schema_directed_ingest_and_replay():
    """ingest(layout=) over the Consul layout: the encoded planes, the
    row and column maps, and the replay to convergence equal the JAX
    package's in every leaf and metric."""
    caps = {"consul_services": 8, "consul_checks": 8}
    want = r_traces.ingest(
        _consul_lines(r_traces), layout=r_schema.TableLayout(
            r_schema.parse_and_constrain(r_schema.consul_schema_sql()),
            capacities=caps))
    got = p_traces.ingest(
        _consul_lines(p_traces), layout=p_schema.TableLayout(
            p_schema.parse_and_constrain(p_schema.consul_schema_sql()),
            capacities=caps))
    assert _consul_lines(p_traces) == _consul_lines(r_traces)
    for f in ARRAYS:
        w, g = getattr(want, f), getattr(got, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.row_keys, got.col_keys, got.values, got.actors) == (
        want.row_keys, want.col_keys, want.values, want.actors)
    assert got.num_rows == 16 and got.num_cols == 6
    cfg = want.suggest_config(fanout=2, sync_interval=2)
    ref = r_replay(want, cfg, max_rounds=128)
    res = replay(got, sim_config_from_dict(dataclasses.asdict(cfg)),
                 max_rounds=128, device="cpu")
    assert ref.converged_round is not None
    assert (res.rounds, res.converged_round) == (ref.rounds,
                                                 ref.converged_round)
    for k, v in ref.metrics.items():
        np.testing.assert_array_equal(res.metrics[k], v, err_msg=k)
    w_leaves, g_leaves = _leaves(ref.state), state_to_numpy(res.state)
    for k, v in w_leaves.items():
        np.testing.assert_array_equal(g_leaves[k], v, err_msg=k)
    t = read_table(res.state, got, 1)
    assert t == r_read_table(ref.state, want, 1)
    assert t[("consul_services", ("n0", "svc"))] == {
        "address": "10.0.0.1", "port": 81}
    assert ("consul_checks", ("n1", "chk")) not in t


def test_schema_directed_ingest_rejects_unknown():
    for S, T in ((p_schema, p_traces), (r_schema, r_traces)):
        lay = S.TableLayout(S.parse_and_constrain(
            "CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT);"))
        bad = T.dump_changeset(
            "00000000-0000-0000-0000-000000000000", 1, 0,
            [("t", (1,), "nope", "x", 1, 1)],
        )
        with pytest.raises(S.SchemaError, match="no such column t.nope"):
            T.ingest([bad], layout=lay)
