"""Write-statement surface: the `Statement` wire shapes + a DML parser.

The reference accepts four JSON shapes for a statement
(``corro-api-types/src/lib.rs:181-201``): a bare SQL string,
``[sql, [params…]]``, ``{"query": sql, "params": […]}`` and
``{"query": sql, "named_params": {…}}`` — executed verbatim by SQLite
inside one write transaction (``api/public/mod.rs:104-131``). The simulator
has no SQLite, so the DML subset that makes sense against CRDT
tables is parsed here into *cell operations* against the
:class:`~corro_sim_torch.schema.TableLayout`:

  INSERT INTO t (cols…) VALUES (…) [, (…)]…   -- upsert (CRDT tables are
      ON CONFLICT/REPLACE-natured: every write is a cell-wise LWW merge)
  UPDATE t SET c = v[, …] WHERE <pk-eq or predicate>
  DELETE FROM t WHERE <pk-eq or predicate>

Parameters bind SQLite-style: positional ``?`` against the params list,
named ``:name`` / ``$name`` / ``@name`` against the named map.

Port of ``corro_sim/api/statements.py`` (standard library only).
"""

from __future__ import annotations

import dataclasses
import re

from corro_sim_torch.subs.query import (
    And,
    Cmp,
    QueryError,
    _Parser,
    _tokenize,
)


class StatementError(ValueError):
    pass


@dataclasses.dataclass
class WriteOp:
    """One parsed DML statement, normalized to cell operations."""

    kind: str  # 'upsert' | 'update' | 'delete' | 'insert_select'
    table: str
    # upsert: list of (pk_tuple, {col: value}) — one per VALUES tuple
    rows: list | None = None
    # update: {col: value-or-expression-AST} applied to selected rows
    sets: dict | None = None
    # update/delete row selection: either resolved pk tuples or a predicate
    pks: list | None = None
    where: object | None = None  # predicate AST when not pure pk-equality
    where_expr: object | None = None  # scalar-expression WHERE (api/exprs)
    # insert_select: target column list + the source SELECT
    cols: list | None = None
    select: object | None = None


def parse_statement(stmt) -> tuple[str, list | dict]:
    """Normalize a wire `Statement` into (sql, params)."""
    if isinstance(stmt, str):
        return stmt, []
    if isinstance(stmt, (list, tuple)):
        if not stmt or not isinstance(stmt[0], str):
            raise StatementError(f"bad statement shape: {stmt!r}")
        if len(stmt) == 2 and isinstance(stmt[1], (list, tuple)):
            return stmt[0], list(stmt[1])
        return stmt[0], list(stmt[1:])  # tolerate the flat form
    if isinstance(stmt, dict):
        sql = stmt.get("query")
        if not isinstance(sql, str):
            raise StatementError(f"statement dict needs 'query': {stmt!r}")
        if "named_params" in stmt:
            return sql, dict(stmt["named_params"])
        return sql, list(stmt.get("params", []))
    raise StatementError(f"bad statement shape: {type(stmt)!r}")


_PARAM = re.compile(r"\?\d*|\$\d+|[:$@][A-Za-z_][A-Za-z_0-9]*")


def bind_params(sql: str, params) -> str:
    """Inline bound parameters as SQL literals (the same param-expansion
    trick the reference uses for subscription dedupe, ``expand_sql``,
    ``api/public/pubsub.rs:226-331``). Strings are quoted; None → NULL."""
    pos = 0

    def lit(v):
        if v is None:
            return "NULL"
        if isinstance(v, bool):
            return str(int(v))
        if isinstance(v, (int, float)):
            return repr(v)
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        if isinstance(v, (bytes, bytearray)):
            return "X'" + bytes(v).hex() + "'"  # SQLite blob literal
        raise StatementError(f"unsupported param type {type(v)!r}")

    out = []
    last = 0
    idx = 0
    # incremental quote scan: a quote of one kind inside the other kind's
    # span is literal text (e.g. a '"' inside a 'string' must not open an
    # identifier), so independent parity counts are wrong — track both
    # states sequentially. SQL's '' / "" doubling self-corrects at the
    # character level (close + immediately reopen).
    in_str = in_ident = False
    for m in _PARAM.finditer(sql):
        prefix = sql[last:m.start()]
        out.append(prefix)
        for ch in prefix:
            if in_str:
                in_str = ch != "'"
            elif in_ident:
                in_ident = ch != '"'
            elif ch == "'":
                in_str = True
            elif ch == '"':
                in_ident = True
        if in_str or in_ident:
            # inside a string literal or a "quoted identifier" — e.g.
            # SELECT "a$1" names a column, it does not bind a parameter
            out.append(m.group(0))
            last = m.end()
            continue
        tok = m.group(0)
        if tok == "?":
            if not isinstance(params, (list, tuple)) or idx >= len(params):
                raise StatementError("not enough positional params")
            out.append(lit(params[idx]))
            idx += 1
        elif tok[0] == "?":
            # SQLite ?NNN — 1-based explicit positional; like SQLite, it
            # also advances the implicit cursor past NNN
            i = int(tok[1:]) - 1
            if not isinstance(params, (list, tuple)) or not (
                0 <= i < len(params)
            ):
                raise StatementError(f"missing positional param {tok}")
            out.append(lit(params[i]))
            idx = max(idx, i + 1)
        elif tok[0] == "$" and tok[1:].isdigit():
            # Postgres-style 1-based positional (the pg wire API binds these)
            i = int(tok[1:]) - 1
            if not isinstance(params, (list, tuple)) or not (
                0 <= i < len(params)
            ):
                raise StatementError(f"missing positional param {tok}")
            out.append(lit(params[i]))
        else:
            name = tok[1:]
            if not isinstance(params, dict) or name not in params:
                raise StatementError(f"missing named param {name!r}")
            out.append(lit(params[name]))
        last = m.end()
    out.append(sql[last:])
    return "".join(out)


# ---------------------------------------------------------------- DML parse

_KEYWORDS = {
    "INSERT", "INTO", "VALUES", "UPDATE", "SET", "DELETE", "FROM", "WHERE",
    "OR", "REPLACE", "ON", "CONFLICT", "DO", "NOTHING",
}


def _tok_dml(sql: str):
    """Tokenize, mapping DML keywords that the SELECT tokenizer treats as
    plain identifiers."""
    toks = []
    for k, v in _tokenize(sql):
        if k == "ident" and v.upper() in _KEYWORDS:
            toks.append((v.upper(), v.upper()))
        else:
            toks.append((k, v))
    return toks


def parse_dml(sql: str) -> WriteOp:
    sql = sql.strip().rstrip(";")
    toks = _tok_dml(sql)
    p = _Parser(toks)
    k, _ = p.peek()
    if k == "INSERT":
        return _parse_insert(p)
    if k == "UPDATE":
        return _parse_update(p)
    if k == "DELETE":
        return _parse_delete(p)
    raise StatementError(
        f"unsupported statement (INSERT/UPDATE/DELETE only): {sql[:60]!r}"
    )


def _parse_insert(p: _Parser) -> WriteOp:
    p.expect("INSERT")
    if p.peek()[0] == "OR":  # INSERT OR REPLACE — same thing for a CRDT table
        p.next()
        p.expect("REPLACE")
    p.expect("INTO")
    table = p.expect("ident")
    p.expect("(")
    cols = [p.expect("ident")]
    while p.peek()[0] == ",":
        p.next()
        cols.append(p.expect("ident"))
    p.expect(")")
    if p.peek()[0] == "SELECT":
        # INSERT … SELECT (reference: arbitrary SQL in the write tx,
        # api/public/mod.rs:104-131): the source SELECT evaluates against
        # the writing node's view at plan time, its rows become VALUES.
        # Projections are full scalar expressions (SELECT id, v + 10 …).
        from corro_sim_torch.api.exprs import ExprError, ExprParser

        p.next()
        items = []
        try:
            while True:
                items.append(ExprParser(p).parse_scalar())
                if p.peek()[0] == "AS":
                    p.next()
                    p.expect("ident")
                elif p.peek()[0] == "ident":
                    p.next()  # bare alias
                if p.peek()[0] == ",":
                    p.next()
                    continue
                break
        except ExprError as err:
            raise StatementError(str(err)) from None
        p.expect("FROM")
        src = p.expect("ident")
        where = where_expr = None
        if p.peek()[0] == "WHERE":
            where, where_expr = _parse_where(p)
        elif p.peek()[0] != "eof":
            raise StatementError(f"trailing tokens at {p.peek()!r}")
        return WriteOp(
            kind="insert_select", table=table, cols=cols,
            select=(src, tuple(items)), where=where, where_expr=where_expr,
        )
    p.expect("VALUES")
    tuples = []
    while True:
        p.expect("(")
        vals = [_value(p)]
        while p.peek()[0] == ",":
            p.next()
            vals.append(_value(p))
        p.expect(")")
        if len(vals) != len(cols):
            raise StatementError(
                f"{len(cols)} columns but {len(vals)} values"
            )
        tuples.append(dict(zip(cols, vals)))
        if p.peek()[0] == ",":
            p.next()
            continue
        break
    # ON CONFLICT … is tolerated and ignored: CRDT merge IS the conflict
    # resolution (every insert is an upsert, doc/crdts.md:15-17).
    if p.peek()[0] == "ON":
        while p.peek()[0] != "eof":
            p.next()
    elif p.peek()[0] != "eof":
        raise StatementError(f"trailing tokens at {p.peek()!r}")
    return WriteOp(kind="upsert", table=table, rows=tuples)


def _value(p: _Parser):
    """One VALUES item: any column-free scalar expression, folded to its
    value at parse time (``VALUES (1 + 2, upper('x'))`` works; referencing
    a column inside VALUES is an error, as in SQLite)."""
    from corro_sim_torch.api.exprs import (
        ExprError,
        ExprParser,
        columns_of,
        const_value,
    )

    try:
        e = ExprParser(p).parse_scalar()
        cols = columns_of(e)
        if cols:
            raise StatementError(
                f"VALUES may not reference columns: {sorted(cols)}"
            )
        return const_value(e)
    except ExprError as err:
        raise StatementError(str(err)) from None


def _parse_update(p: _Parser) -> WriteOp:
    from corro_sim_torch.api.exprs import (
        ExprError,
        ExprParser,
        columns_of,
        const_value,
    )

    p.expect("UPDATE")
    table = p.expect("ident")
    p.expect("SET")
    sets = {}
    while True:
        col = p.expect("ident")
        k, v = p.next()
        if k != "op" or v != "=":
            raise StatementError(f"expected '=' after {col!r}")
        try:
            e = ExprParser(p).parse_scalar()
            # column-free expressions fold to plain values (the fast
            # path); column-referencing ones evaluate per target row at
            # plan time (SET v = v + 1 — reference executes these inside
            # the write tx, api/public/mod.rs:104-131)
            sets[col] = e if columns_of(e) else const_value(e)
        except ExprError as err:
            raise StatementError(str(err)) from None
        if p.peek()[0] == ",":
            p.next()
            continue
        break
    where, where_expr = _parse_where(p)
    return WriteOp(
        kind="update", table=table, sets=sets, where=where,
        where_expr=where_expr,
    )


def _parse_delete(p: _Parser) -> WriteOp:
    p.expect("DELETE")
    p.expect("FROM")
    table = p.expect("ident")
    where, where_expr = _parse_where(p)
    return WriteOp(
        kind="delete", table=table, where=where, where_expr=where_expr
    )


def _parse_where(p: _Parser):
    """Returns (predicate_ast, expr_ast): the vectorizable predicate
    grammar when it fits (pk fast path + Matcher evaluation), otherwise
    the scalar-expression fallback evaluated row-wise at plan time —
    arithmetic, functions, CASE in WHERE all land there."""
    from corro_sim_torch.api.exprs import ExprError, ExprParser

    if p.peek()[0] != "WHERE":
        raise StatementError(
            "UPDATE/DELETE require a WHERE clause (full-table writes are "
            "refused, matching the constrained schema posture)"
        )
    p.next()
    mark = p.i
    try:
        where = p.parse_or()
        if p.peek()[0] != "eof":
            raise QueryError(f"trailing tokens at {p.peek()!r}")
        return where, None
    except QueryError:
        p.i = mark
    try:
        expr = ExprParser(p).parse_bool()
    except ExprError as err:
        raise StatementError(str(err)) from None
    if p.peek()[0] != "eof":
        raise StatementError(f"trailing tokens at {p.peek()!r}")
    return None, expr


def pk_equalities(where, pk_cols: tuple) -> tuple | None:
    """If `where` is exactly pk1 = l1 AND pk2 = l2 … (all pk columns, only
    pk columns), return the pk literal tuple — the fast path that skips
    predicate evaluation. Otherwise None."""
    eqs = {}

    def walk(node) -> bool:
        if isinstance(node, Cmp):
            if node.op != "=" or node.col in eqs:
                return False
            eqs[node.col] = node.lit
            return True
        if isinstance(node, And):
            return all(walk(q) for q in node.parts)
        return False

    if where is None or not walk(where):
        return None
    if set(eqs) != set(pk_cols):
        return None
    return tuple(eqs[c] for c in pk_cols)


def parse_write(stmt) -> WriteOp:
    """Wire statement → WriteOp (params bound, DML parsed)."""
    sql, params = parse_statement(stmt)
    try:
        return parse_dml(bind_params(sql, params))
    except QueryError as e:
        raise StatementError(str(e)) from None
