"""Subscription query language: a SELECT subset compiled to rank space.

Port of ``corro_sim/subs/query.py``: the parser, normalization, LIKE,
the aggregate folds and the host predicate evaluator are the reference's
Python; the rank-space compilers build torch expressions that run on the
device the rank plane lies on.

The reference subscribes arbitrary SELECTs: ``Matcher::new`` parses the
statement, extracts the involved table/columns, and rewrites per-table
queries (``corro-types/src/pubsub.rs:640-832,1899-1993``). The simulator's
query surface:

    SELECT <col[, col…] | *> FROM <table> [AS] [alias]
      [ [INNER|LEFT [OUTER]] JOIN <table2> [AS] [alias2]
        ON <q.col> = <q.col> ]
      [WHERE <predicate>]

with predicates over value columns: ``=, !=, <>, <, <=, >, >=``,
``IS [NOT] NULL``, ``AND``, ``OR``, ``NOT``, parentheses, and literals
(integers, floats, 'strings', NULL). With a JOIN, column references must
be alias-qualified (``s.name``) and each WHERE conjunct must reference a
single side (the reference rewrites per-table queries the same way,
``pubsub.rs:697-832``); LEFT joins emit unmatched left rows with NULL
right cells.

Compilation, not interpretation: cell values live on device as
order-preserving interned ranks (:mod:`corro_sim_torch.io.values`), so every
comparison against a literal becomes an *integer* comparison against a
precomputed rank threshold — ``col < 'foo'`` compiles to
``rank < bisect_left(universe, 'foo')``. The whole WHERE clause becomes a
boolean tensor expression over the (rows, cols) rank plane, evaluated for
every row at once on the plane's device. SQL normalization for subscription dedupe
(reference ``normalize_sql``, ``pubsub.rs:2362``) is the canonical
rendering of the parsed AST.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

import torch

from corro_sim_torch.io.values import (
    _BandRanges,
    crsql_conflict_key,
    sqlite_sort_key,
)


class QueryError(ValueError):
    pass


# --------------------------------------------------------------------- AST


@dataclasses.dataclass(frozen=True)
class Cmp:
    op: str  # '=', '!=', '<', '<=', '>', '>='
    col: str
    lit: object


@dataclasses.dataclass(frozen=True)
class IsNull:
    col: str
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InList:
    """``col [NOT] IN (lit, …)``. Carries its own negation (rather than a
    ``Not`` wrapper) for SQL three-valued logic: a NULL column — and, for
    NOT IN, a NULL in the list — yields UNKNOWN, which collapses to False
    under both polarities; plain ``Not`` would flip it to True."""

    col: str
    lits: tuple
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InSelect:
    """``col [NOT] IN (SELECT one_col FROM …)`` — a semi-join. The
    reference matches these because SQLite evaluates the subquery inside
    the rewritten per-table query (``pubsub.rs:697-832``); here the
    subquery runs as its own single-table matcher and the outer predicate
    re-materializes with the subquery's current value set
    (:class:`~corro_sim_torch.subs.manager.SemiJoinMatcher`). Negation lives on
    the node for the same three-valued-logic reason as :class:`InList`."""

    col: str
    select: object  # Select — single-table, exactly one selected column
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Like:
    """``col [NOT] LIKE 'pattern'`` — SQLite semantics: ``%`` any run,
    ``_`` any one char, ASCII-case-insensitive. A pure prefix pattern
    (``abc%``) compiles to rank ranges on device (one range per ASCII case
    variant of the prefix); anything else evaluates host-side over decoded
    values (split_host_predicate routes it). Negation lives on the node for
    the same three-valued-logic reason as :class:`InList`."""

    col: str
    pattern: str
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class And:
    parts: tuple


@dataclasses.dataclass(frozen=True)
class Or:
    parts: tuple


@dataclasses.dataclass(frozen=True)
class Not:
    inner: object


@dataclasses.dataclass(frozen=True)
class JsonContains:
    """``corro_json_contains(a, b)`` predicate term: one argument is a
    column, the other a JSON text literal; true iff the first JSON value
    is contained in the second (the reference's custom SQLite scalar,
    ``sqlite-functions/src/lib.rs:14-51``). Evaluated host-side over
    decoded values — containment has no rank-interval compilation."""

    col: str
    selector: str  # the JSON text literal argument
    col_is_object: bool  # True: literal ⊆ column value; False: reverse
    # parse-time cache of json.loads(selector); compare/hash by the text
    selector_obj: object = dataclasses.field(
        default=None, compare=False, hash=False
    )


@dataclasses.dataclass(frozen=True)
class Join:
    """One join link in a join chain (``… JOIN b ON a.x = b.y``).

    ``on_left`` may reference ANY earlier alias in the chain (the FROM
    table or a previous join's alias); ``on_right`` references this
    join's own alias. A non-equality ON condition (range predicates,
    arithmetic — the reference accepts arbitrary ON because SQLite
    executes it, ``pubsub.rs:697-832``) is carried as ``on_expr``, a
    scalar-expression AST (api/exprs) evaluated per candidate pair by
    the join matcher; ``on_left``/``on_right`` are empty then."""

    table: str  # right table
    alias: str  # right alias (defaults to table name)
    on_left: str  # qualified "alias.col" on an earlier side ('' w/ expr)
    on_right: str  # qualified "alias.col" on this join's side ('' w/ expr)
    kind: str = "inner"  # 'inner' | 'left'
    on_expr: object = None  # expression AST for non-equality ON


@dataclasses.dataclass(frozen=True)
class Agg:
    """Aggregate select item: ``fn(col)`` or ``COUNT(*)`` (col=None)."""

    fn: str  # COUNT | SUM | AVG | MIN | MAX
    col: str | None

    def label(self) -> str:
        return f"{self.fn.lower()}({self.col if self.col else '*'})"


@dataclasses.dataclass(frozen=True)
class Select:
    table: str
    columns: tuple  # () = * (plain selected column names)
    where: object  # predicate AST or None
    alias: str | None = None  # left-table alias (join queries)
    joins: tuple = ()  # join chain, left to right (Join instances)
    items: tuple = ()  # SELECT-list order: ('col', name) | ('agg', Agg)
    group_by: tuple = ()  # column names
    order_by: tuple = ()  # ((name, descending: bool), ...)
    limit: int | None = None
    offset: int = 0

    @property
    def join(self) -> Join | None:
        """First join of the chain (compat accessor; prefer ``joins``)."""
        return self.joins[0] if self.joins else None

    def has_extras(self) -> bool:
        """Anything beyond the matcher's match+project core — evaluated by
        :func:`post_process` on the query path; live subscriptions keep
        aggregates/GROUP BY incrementally (AggregateMatcher) or by
        recompute-and-diff over joins (JoinAggregateMatcher)."""
        return bool(
            self.aggregates or self.group_by or self.order_by
            or self.limit is not None or self.offset
        )

    @property
    def aggregates(self) -> tuple:
        return tuple(a for k, a in self.items if k == "agg")

    def base(self) -> "Select":
        """The matcher-facing core: plain columns + every column the
        aggregates/grouping/ordering need, no post-processing clauses."""
        if not self.has_extras():
            return self
        if not self.columns and not self.aggregates:
            cols = ()  # SELECT *: everything (order keys included) is there
        else:
            need = list(self.columns)
            for c in (
                *self.group_by,
                *(a.col for a in self.aggregates if a.col is not None),
                *(c for c, _ in self.order_by),
            ):
                if c not in need:
                    need.append(c)
            cols = tuple(need)
        return Select(
            table=self.table,
            columns=cols,
            where=self.where,
            alias=self.alias,
            joins=self.joins,
        )

    def normalized(self) -> str:
        if self.items:
            parts = [
                (name if kind == "col" else name.label())
                for kind, name in self.items
            ]
            cols = ", ".join(parts)
        else:
            cols = ", ".join(self.columns) if self.columns else "*"
        sql = f"SELECT {cols} FROM {self.table}"
        if self.alias is not None and self.alias != self.table:
            sql += f" AS {self.alias}"
        for j in self.joins:
            kw = "LEFT JOIN" if j.kind == "left" else "JOIN"
            sql += f" {kw} {j.table}"
            if j.alias != j.table:
                sql += f" AS {j.alias}"
            if j.on_expr is not None:
                from corro_sim_torch.api.exprs import sql_of

                sql += f" ON {sql_of(j.on_expr)}"
            else:
                sql += f" ON {j.on_left} = {j.on_right}"
        if self.where is not None:
            sql += f" WHERE {_render(self.where)}"
        if self.group_by:
            sql += " GROUP BY " + ", ".join(self.group_by)
        if self.order_by:
            sql += " ORDER BY " + ", ".join(
                f"{c} DESC" if d else c for c, d in self.order_by
            )
        if self.limit is not None:
            sql += f" LIMIT {self.limit}"
        if self.offset:
            sql += f" OFFSET {self.offset}"
        return sql

    def referenced_columns(self) -> frozenset:
        """Columns the WHERE clause touches — the match-candidate filter
        set (``filter_matchable_change``, ``pubsub.rs:562-597``)."""
        out = set()

        def walk(p):
            if isinstance(p, (Cmp, IsNull, JsonContains, InList, Like,
                              InSelect)):
                out.add(p.col)
            elif isinstance(p, (And, Or)):
                for q in p.parts:
                    walk(q)
            elif isinstance(p, Not):
                walk(p.inner)

        if self.where is not None:
            walk(self.where)
        return frozenset(out)


def _render(p) -> str:
    if isinstance(p, Cmp):
        return f"{p.col} {p.op} {_render_lit(p.lit)}"
    if isinstance(p, InList):
        lits = ", ".join(_render_lit(v) for v in p.lits)
        return f"{p.col}{' NOT' if p.negated else ''} IN ({lits})"
    if isinstance(p, InSelect):
        neg = " NOT" if p.negated else ""
        return f"{p.col}{neg} IN ({p.select.normalized()})"
    if isinstance(p, Like):
        neg = " NOT" if p.negated else ""
        return f"{p.col}{neg} LIKE {_render_lit(p.pattern)}"
    if isinstance(p, JsonContains):
        lit = _render_lit(p.selector)
        if p.col_is_object:
            return f"corro_json_contains({lit}, {p.col})"
        return f"corro_json_contains({p.col}, {lit})"
    if isinstance(p, IsNull):
        return f"{p.col} IS{' NOT' if p.negated else ''} NULL"
    if isinstance(p, And):
        return "(" + " AND ".join(_render(q) for q in p.parts) + ")"
    if isinstance(p, Or):
        return "(" + " OR ".join(_render(q) for q in p.parts) + ")"
    if isinstance(p, Not):
        return f"NOT ({_render(p.inner)})"
    raise QueryError(f"bad predicate node {p!r}")


def _render_lit(lit) -> str:
    if lit is None:
        return "NULL"
    if isinstance(lit, str):
        return "'" + lit.replace("'", "''") + "'"
    if isinstance(lit, (bytes, bytearray)):
        return "X'" + bytes(lit).hex() + "'"
    return repr(lit)


# ------------------------------------------------------------------ parser

_TOKEN = re.compile(
    r"\s*(?:"
    r"(?P<blob>[xX]'(?:[0-9A-Fa-f][0-9A-Fa-f])*')"
    r"|(?P<str>'(?:[^']|'')*')"
    r"|(?P<num>-?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)"
    r"|(?P<op><=|>=|!=|<>|\|\||=|<|>|\+|-|/|%)"
    r"|(?P<punct>[(),*.])"
    r"|(?P<word>[A-Za-z_][A-Za-z_0-9]*)"
    r")"
)


def _tokenize(sql: str):
    pos, out = 0, []
    while pos < len(sql):
        m = _TOKEN.match(sql, pos)
        if not m:
            if sql[pos:].strip() == "":
                break
            raise QueryError(f"bad token at {sql[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup == "blob":
            out.append(("lit", bytes.fromhex(m.group("blob")[2:-1])))
        elif m.lastgroup == "str":
            out.append(("lit", m.group("str")[1:-1].replace("''", "'")))
        elif m.lastgroup == "num":
            t = m.group("num")
            is_float = "." in t or "e" in t or "E" in t
            out.append(("lit", float(t) if is_float else int(t)))
        elif m.lastgroup == "op":
            op = m.group("op")
            out.append(("op", "!=" if op == "<>" else op))
        elif m.lastgroup == "punct":
            out.append((m.group("punct"), m.group("punct")))
        else:
            w = m.group("word")
            kw = w.upper()
            if kw in (
                "SELECT", "FROM", "WHERE", "AND", "OR", "NOT", "IS", "NULL",
                "JOIN", "INNER", "LEFT", "OUTER", "ON", "AS",
                "GROUP", "ORDER", "BY", "ASC", "DESC", "LIMIT", "OFFSET",
                "IN", "LIKE", "BETWEEN",
            ):
                out.append((kw, kw))
            elif kw == "TRUE":  # SQLite boolean keywords are 1/0 literals
                out.append(("lit", 1))
            elif kw == "FALSE":
                out.append(("lit", 0))
            else:
                out.append(("ident", w))
    out.append(("eof", None))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind):
        k, v = self.next()
        if k != kind:
            raise QueryError(f"expected {kind}, got {k} {v!r}")
        return v

    def qual_ident(self) -> str:
        """``col`` or ``alias.col`` → one (possibly dotted) name string."""
        name = self.expect("ident")
        if self.peek()[0] == ".":
            self.next()
            name = f"{name}.{self.expect('ident')}"
        return name

    def _opt_alias(self, table: str) -> str:
        if self.peek()[0] == "AS":
            self.next()
            return self.expect("ident")
        if self.peek()[0] == "ident":
            return self.expect("ident")
        return table

    _AGG_FNS = ("COUNT", "SUM", "AVG", "MIN", "MAX")

    def _select_item(self):
        name = self.qual_ident()
        if name.upper() in self._AGG_FNS and self.peek()[0] == "(":
            self.next()
            if self.peek()[0] == "*":
                self.next()
                col = None
                if name.upper() != "COUNT":
                    raise QueryError(f"{name}(*) is not valid SQL")
            else:
                col = self.qual_ident()
            self.expect(")")
            return ("agg", Agg(fn=name.upper(), col=col))
        return ("col", name)

    def parse_select(self, embedded: bool = False) -> Select:
        """``embedded=True``: a subselect — stop at the enclosing ')'
        instead of requiring end-of-input."""
        self.expect("SELECT")
        items = []
        if self.peek()[0] == "*":
            self.next()
        else:
            items.append(self._select_item())
            while self.peek()[0] == ",":
                self.next()
                items.append(self._select_item())
        cols = [n for k, n in items if k == "col"]
        self.expect("FROM")
        table = self.expect("ident")
        alias = self._opt_alias(table)
        joins: list = []
        known_aliases = [alias]
        while self.peek()[0] in ("JOIN", "INNER", "LEFT"):
            k = self.peek()[0]
            kind = "inner"
            if k == "INNER":
                self.next()
            elif k == "LEFT":
                self.next()
                kind = "left"
                if self.peek()[0] == "OUTER":
                    self.next()
            self.expect("JOIN")
            jt = self.expect("ident")
            jalias = self._opt_alias(jt)
            if jalias in known_aliases:
                raise QueryError(
                    f"join sides need distinct aliases; {jalias!r} repeats"
                )
            self.expect("ON")
            mark = self.i
            eq = None
            try:
                lhs = self.qual_ident()
                op = self.next()
                if op != ("op", "="):
                    raise QueryError("not a plain equality")
                rhs = self.qual_ident()
                if self.peek()[0] in ("AND", "OR"):
                    raise QueryError("compound ON")
                eq = (lhs, rhs)
            except QueryError:
                self.i = mark

            def side(q):
                return q.split(".", 1)[0] if "." in q else None

            if eq is not None:
                # normalize: on_left references an EARLIER side, on_right
                # the alias this JOIN introduces
                lhs, rhs = eq
                if side(lhs) == jalias and side(rhs) in known_aliases:
                    lhs, rhs = rhs, lhs
                if side(rhs) != jalias or side(lhs) not in known_aliases:
                    raise QueryError(
                        f"JOIN ON must link {jalias!r} to an earlier side: "
                        f"{lhs!r} = {rhs!r}"
                    )
                joins.append(Join(table=jt, alias=jalias, on_left=lhs,
                                  on_right=rhs, kind=kind))
            else:
                # Non-equality / compound ON: a scalar-expression
                # condition evaluated per candidate pair (reference:
                # SQLite executes arbitrary ON, pubsub.rs:697-832).
                from corro_sim_torch.api.exprs import (
                    ExprError,
                    ExprParser,
                    columns_of,
                )

                try:
                    expr = ExprParser(self).parse_bool()
                except ExprError as err:
                    raise QueryError(str(err)) from None
                refs = columns_of(expr)
                sides = {side(c) for c in refs}
                if None in sides:
                    raise QueryError(
                        "JOIN ON columns must be alias-qualified"
                    )
                if jalias not in sides or not (
                    sides - {jalias}
                ) <= set(known_aliases):
                    raise QueryError(
                        f"JOIN ON must link {jalias!r} to earlier sides"
                    )
                joins.append(Join(table=jt, alias=jalias, on_left="",
                                  on_right="", kind=kind, on_expr=expr))
            known_aliases.append(jalias)
        where = None
        if self.peek()[0] == "WHERE":
            self.next()
            where = self.parse_or()
        group_by: list = []
        if self.peek()[0] == "GROUP":
            self.next()
            self.expect("BY")
            group_by.append(self.qual_ident())
            while self.peek()[0] == ",":
                self.next()
                group_by.append(self.qual_ident())
        order_by: list = []
        if self.peek()[0] == "ORDER":
            self.next()
            self.expect("BY")
            while True:
                c = self.qual_ident()
                desc = False
                if self.peek()[0] in ("ASC", "DESC"):
                    desc = self.next()[0] == "DESC"
                order_by.append((c, desc))
                if self.peek()[0] != ",":
                    break
                self.next()
        limit = None
        offset = 0
        if self.peek()[0] == "LIMIT":
            self.next()
            k, v = self.next()
            if k != "lit" or not isinstance(v, int) or v < 0:
                raise QueryError("LIMIT takes a non-negative integer")
            limit = v
            if self.peek()[0] == "OFFSET":
                self.next()
                k, v = self.next()
                if k != "lit" or not isinstance(v, int) or v < 0:
                    raise QueryError("OFFSET takes a non-negative integer")
                offset = v
        if not embedded and self.peek()[0] != "eof":
            raise QueryError(f"trailing tokens at {self.peek()!r}")

        aggs = [a for k, a in items if k == "agg"]
        if group_by and not aggs:
            raise QueryError("GROUP BY requires an aggregate in the "
                             "SELECT list")
        if aggs:
            stray = [c for c in cols if c not in group_by]
            if stray:
                raise QueryError(
                    f"column(s) {stray} must appear in GROUP BY when "
                    "aggregates are selected"
                )
            stray = [c for c, _ in order_by if c not in group_by]
            if stray:
                raise QueryError(
                    f"ORDER BY column(s) {stray} must appear in GROUP BY "
                    "in an aggregate query"
                )
        return Select(
            table=table, columns=tuple(cols), where=where,
            alias=(alias if (alias != table or joins) else None),
            joins=tuple(joins),
            items=tuple(items),
            group_by=tuple(group_by),
            order_by=tuple(order_by),
            limit=limit,
            offset=offset,
        )

    def parse_or(self):
        parts = [self.parse_and()]
        while self.peek()[0] == "OR":
            self.next()
            parts.append(self.parse_and())
        return parts[0] if len(parts) == 1 else Or(tuple(parts))

    def parse_and(self):
        parts = [self.parse_unary()]
        while self.peek()[0] == "AND":
            self.next()
            parts.append(self.parse_unary())
        return parts[0] if len(parts) == 1 else And(tuple(parts))

    def parse_unary(self):
        if self.peek()[0] == "NOT":
            self.next()
            return Not(self.parse_unary())
        if self.peek()[0] == "(":
            self.next()
            inner = self.parse_or()
            self.expect(")")
            return inner
        col = self.qual_ident()
        if col.lower() == "corro_json_contains" and self.peek()[0] == "(":
            return self._parse_json_contains()
        negated = False
        if self.peek()[0] == "NOT":
            self.next()
            negated = True
            if self.peek()[0] not in ("IN", "LIKE", "BETWEEN"):
                raise QueryError(
                    f"expected IN / LIKE / BETWEEN after {col!r} NOT"
                )
        k0 = self.peek()[0]
        if k0 == "IN":
            self.next()
            self.expect("(")
            if self.peek()[0] == "SELECT":
                sub = self.parse_select(embedded=True)
                self.expect(")")
                if sub.joins or sub.aggregates or sub.group_by:
                    raise QueryError(
                        "IN (SELECT …) subqueries must be single-table "
                        "scalar selects"
                    )
                if len(sub.columns) != 1:
                    raise QueryError(
                        "IN (SELECT …) must select exactly one column"
                    )
                return InSelect(col=col, select=sub, negated=negated)
            lits = [self._lit_or_null()]
            while self.peek()[0] == ",":
                self.next()
                lits.append(self._lit_or_null())
            self.expect(")")
            return InList(col=col, lits=tuple(lits), negated=negated)
        if k0 == "LIKE":
            self.next()
            lk, lv = self.next()
            if lk != "lit" or not isinstance(lv, str):
                raise QueryError("LIKE takes a string pattern literal")
            return Like(col=col, pattern=lv, negated=negated)
        if k0 == "BETWEEN":
            # desugar: BETWEEN → >= AND <=; NOT BETWEEN → < OR > (both
            # collapse NULL operands to False like plain comparisons)
            self.next()
            lo = self._lit_or_null()
            self.expect("AND")
            hi = self._lit_or_null()
            if negated:
                return Or((Cmp("<", col, lo), Cmp(">", col, hi)))
            return And((Cmp(">=", col, lo), Cmp("<=", col, hi)))
        k, v = self.next()
        if k == "IS":
            negated = False
            if self.peek()[0] == "NOT":
                self.next()
                negated = True
            self.expect("NULL")
            return IsNull(col, negated)
        if k != "op":
            raise QueryError(f"expected comparison after {col!r}, got {v!r}")
        lk, lv = self.next()
        if lk == "NULL":
            lv = None
        elif lk != "lit":
            raise QueryError(f"expected literal, got {lk} {lv!r}")
        return Cmp(op=v, col=col, lit=lv)

    def _lit_or_null(self):
        k, v = self.next()
        if k == "NULL":
            return None
        if k != "lit":
            raise QueryError(f"expected literal, got {k} {v!r}")
        return v

    def _parse_json_contains(self):
        import json as _json

        self.expect("(")
        args = [self.next()]
        self.expect(",")
        args.append(self.next())
        self.expect(")")
        kinds = tuple(k for k, _ in args)
        if kinds == ("lit", "ident"):
            lit, col, col_is_object = args[0][1], args[1][1], True
        elif kinds == ("ident", "lit"):
            col, lit, col_is_object = args[0][1], args[1][1], False
        else:
            raise QueryError(
                "corro_json_contains needs one column and one JSON text "
                f"literal, got {kinds}"
            )
        if not isinstance(lit, str):
            raise QueryError(
                "corro_json_contains literal argument must be JSON text"
            )
        try:
            sel_obj = _json.loads(lit)
        except ValueError:
            raise QueryError(
                f"corro_json_contains: invalid JSON literal {lit!r}"
            ) from None
        return JsonContains(
            col=col, selector=lit, col_is_object=col_is_object,
            selector_obj=sel_obj,
        )


def parse_query(sql: str) -> Select:
    return _Parser(_tokenize(sql)).parse_select()


# ------------------------------------------------------------ LIKE helpers

_LIKE_RE_CACHE: dict = {}


def _ascii_alpha(ch: str) -> bool:
    return "a" <= ch <= "z" or "A" <= ch <= "Z"


def _like_regex(pattern: str):
    """SQLite LIKE pattern → compiled regex (``%`` any run, ``_`` any one
    char). Case folding is ASCII-ONLY, exactly like SQLite's default LIKE
    — built as per-char ``[aA]`` classes, NOT re.IGNORECASE (which folds
    non-ASCII pairs and even multi-char expansions like 'ß'→'SS', diverging
    from both SQLite and the compiled rank-range form)."""
    rx = _LIKE_RE_CACHE.get(pattern)
    if rx is None:
        parts = []
        for ch in pattern:
            if ch == "%":
                parts.append(".*")
            elif ch == "_":
                parts.append(".")
            elif _ascii_alpha(ch):
                parts.append(f"[{ch.lower()}{ch.upper()}]")
            else:
                parts.append(re.escape(ch))
        rx = re.compile("".join(parts) + r"\Z", re.DOTALL)
        _LIKE_RE_CACHE[pattern] = rx
    return rx


def like_match(pattern: str, value) -> bool:
    """SQLite LIKE: numbers match via their TEXT rendering; a BLOB operand
    never matches (``x'616263' LIKE 'a%'`` is 0)."""
    if value is None or isinstance(value, (bytes, bytearray)):
        return False
    if isinstance(value, (int, float)):
        value = str(value)
    return _like_regex(pattern).match(value) is not None


_MAX_LIKE_VARIANTS = 16


def like_prefix_ranges(pattern: str) -> list[tuple[str, str]] | None:
    """For a pure prefix pattern (``abc%``): the half-open string intervals
    ``[lo, hi)`` whose union is exactly the match set under binary
    collation — one interval per ASCII case variant of the prefix (LIKE is
    case-insensitive, the rank order is not). None = not compilable
    (wildcards beyond the trailing ``%``, empty prefix, too many alpha
    chars, or a prefix ending at the top codepoint)."""
    if not pattern.endswith("%"):
        return None
    prefix = pattern[:-1]
    if not prefix or any(c in "%_" for c in prefix):
        return None
    # A rank interval lives in STRING key space, but LIKE also matches the
    # text rendering of numeric values ('1%' matches the integer 12). Any
    # prefix that could begin a numeric rendering (digits, '-', inf, nan)
    # must take the host path or the compiled form under-matches numerics.
    fold = prefix.lower()
    if (
        fold[0] in "0123456789-+."
        or "inf".startswith(fold) or fold.startswith("inf")
        or "nan".startswith(fold) or fold.startswith("nan")
    ):
        return None
    variants = [""]
    for ch in prefix:
        # ASCII-only case folding (SQLite LIKE default; also keeps each
        # variant the same length — str.upper() can expand 'ß' to 'SS',
        # which would cover strings the pattern does not match)
        opts = (ch.lower(), ch.upper()) if _ascii_alpha(ch) else (ch,)
        if len(variants) * len(opts) > _MAX_LIKE_VARIANTS:
            return None
        variants = [v + o for v in variants for o in opts]
    out = []
    for v in variants:
        last = v[-1]
        if ord(last) >= 0x10FFFF:
            return None
        out.append((v, v[:-1] + chr(ord(last) + 1)))
    return out


def _numeric_twins(v):
    """The cross-band companions a numeric literal's compiled ranges pin:
    its exact float/int twins and, for fractional floats, the int-band
    floor cut (see _BandRanges.sql_ranges)."""
    import math

    yield v
    if isinstance(v, bool):
        yield int(v)
        yield float(v)
    elif isinstance(v, int):
        # always include the (possibly rounded) float twin: sql_ranges
        # pins the nearest double as its float-band cut regardless of
        # exactness, and that pin must be a pure lookup at compile time
        yield float(v)
    elif isinstance(v, float) and v == v and not math.isinf(v):
        if v.is_integer():
            yield int(v)
        else:
            yield math.floor(v)


def predicate_intern_values(p):
    """Every value the compiled form bakes a rank constant for: Cmp/InList
    literals (plus their cross-band numeric twins) and the string
    endpoints of compilable LIKE prefix ranges. Live universes must
    intern these BEFORE compiling so the baked constants are pure
    lookups — a mid-compile insert could re-space the rank space under
    closures compiled earlier in the same predicate."""
    if isinstance(p, Cmp):
        if p.lit is not None:
            yield from _numeric_twins(p.lit) if isinstance(
                p.lit, (int, float)
            ) else (p.lit,)
    elif isinstance(p, InList):
        for v in p.lits:
            if v is not None:
                if isinstance(v, (int, float)):
                    yield from _numeric_twins(v)
                else:
                    yield v
    elif isinstance(p, Like):
        ranges = like_prefix_ranges(p.pattern)
        if ranges:
            for lo, hi in ranges:
                yield lo
                yield hi
    elif isinstance(p, (And, Or)):
        for q in p.parts:
            yield from predicate_intern_values(q)
    elif isinstance(p, Not):
        yield from predicate_intern_values(p.inner)


_NUM_PREFIX = re.compile(r"^\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


def _sql_number(v):
    """SQLite numeric coercion for SUM/AVG: numbers pass through, text and
    blobs contribute their leading numeric prefix (else 0) — ``SUM(name)``
    over TEXT is 0, not a type error."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, (bytes, bytearray)):
        v = bytes(v).decode("utf-8", "replace")
    m = _NUM_PREFIX.match(v) if isinstance(v, str) else None
    if not m:
        return 0
    s = m.group(0)
    try:
        return int(s)
    except ValueError:
        return float(s)


def fold_aggregate(a: "Agg", vals: list):
    """One group's aggregate output from its member values (COUNT(*) gets
    the member rows themselves). THE single definition of the SQL
    aggregate fold — the one-shot query path, the join-aggregate
    recompute, and tests all share it, so NULL filtering, numeric
    coercion and empty-group rules cannot drift between paths."""
    if a.col is None:  # COUNT(*)
        return len(vals)
    vals = [v for v in vals if v is not None]
    if a.fn == "COUNT":
        return len(vals)
    if not vals:
        return None
    if a.fn in ("SUM", "AVG"):
        nums = [_sql_number(v) for v in vals]
        floats = sum(isinstance(x, float) for x in nums)
        if a.fn == "SUM":
            return sum_cell(sum(nums), len(nums), floats)
        return avg_cell(sum(nums), len(nums))
    key = sqlite_sort_key
    return min(vals, key=key) if a.fn == "MIN" else max(vals, key=key)


def sum_cell(total, nonnull: int, floats: int):
    """SQLite SUM output rule, shared by the one-shot query path and the
    incremental AggregateMatcher so the two can never drift: NULL over an
    empty/all-NULL set; integer iff every addend was integral."""
    if nonnull == 0:
        return None
    return total if floats > 0 else int(total)


def avg_cell(total, nonnull: int):
    """SQLite AVG output rule (always REAL; NULL over empty/all-NULL)."""
    return None if nonnull == 0 else total / nonnull


def post_process(select: Select, events: list) -> list:
    """Apply GROUP BY / aggregates / ORDER BY / LIMIT to a matcher's
    one-shot query events (host-side — the reference gets these for free
    from SQLite; a diff-engine can't maintain them incrementally, so
    subscriptions reject them and the query path evaluates them here).

    SQLite semantics: grouping compares values with SQL equality (1 and
    1.0 share a group, NULLs group together); SUM/AVG/MIN/MAX of an empty
    or all-NULL set are NULL; COUNT never is; ORDER BY sorts NULLs first
    ascending; without ORDER BY, groups keep first-seen order.
    """
    header = next(e["columns"] for e in events if "columns" in e)
    rows = [e["row"][1] for e in events if "row" in e]
    rowids = [e["row"][0] for e in events if "row" in e]
    eoq = [e for e in events if "eoq" in e]

    def pos(name):
        try:
            return header.index(name)
        except ValueError:
            raise QueryError(f"no such column {name!r}") from None

    if select.aggregates:
        gpos = [pos(c) for c in select.group_by]
        groups: dict = {}
        for r in rows:
            key = tuple(sqlite_sort_key(r[i]) for i in gpos)
            groups.setdefault(key, []).append(r)
        if not select.group_by and not groups:
            groups[()] = []  # aggregates over an empty table yield one row

        def agg_value(a: Agg, grp: list):
            return fold_aggregate(
                a, grp if a.col is None else [r[pos(a.col)] for r in grp]
            )

        out_cols = [
            (n if k == "col" else n.label()) for k, n in select.items
        ]
        out_rows = []
        for grp in groups.values():
            cells = []
            for k, item in select.items:
                if k == "col":
                    cells.append(grp[0][pos(item)] if grp else None)
                else:
                    cells.append(agg_value(item, grp))
            out_rows.append(cells)
        order_pos = {c: out_cols.index(c) for c, _ in select.order_by}
        rows, header = out_rows, out_cols
        rowids = list(range(len(rows)))

        def sort_key_of(c):
            i = order_pos[c]
            return lambda rc: sqlite_sort_key(rc[0][i])
    else:
        def sort_key_of(c):
            i = pos(c)
            return lambda rc: sqlite_sort_key(rc[0][i])

    paired = list(zip(rows, rowids))
    for c, desc in reversed(select.order_by):  # stable multi-key sort
        paired.sort(key=sort_key_of(c), reverse=desc)
    if select.offset or select.limit is not None:
        end = None if select.limit is None else select.offset + select.limit
        paired = paired[select.offset:end]

    # helper columns base() added for ORDER BY must not leak into the
    # result: project back to the pk prefix + the requested columns
    if not select.aggregates and select.columns:
        drop = {c for c, _ in select.order_by} - set(select.columns)
        if drop:
            keep = [i for i, c in enumerate(header) if c not in drop]
            header = [header[i] for i in keep]
            paired = [([cells[i] for i in keep], rid)
                      for cells, rid in paired]

    out = [{"columns": header}]
    out.extend({"row": [rid, cells]} for cells, rid in paired)
    out.extend(eoq)
    return out


def rewrite_columns(p, fn):
    """Predicate AST with every column name mapped through ``fn`` (used to
    strip alias qualifiers when routing join conjuncts to one side)."""
    if p is None:
        return None
    if isinstance(p, (Cmp, IsNull, JsonContains, InList, Like, InSelect)):
        return dataclasses.replace(p, col=fn(p.col))
    if isinstance(p, And):
        return And(tuple(rewrite_columns(q, fn) for q in p.parts))
    if isinstance(p, Or):
        return Or(tuple(rewrite_columns(q, fn) for q in p.parts))
    if isinstance(p, Not):
        return Not(rewrite_columns(p.inner, fn))
    raise QueryError(f"bad predicate node {p!r}")


def predicate_columns(p) -> frozenset:
    """All columns a predicate AST references."""
    out = set()

    def walk(q):
        if isinstance(q, (Cmp, IsNull, JsonContains, InList, Like, InSelect)):
            out.add(q.col)
        elif isinstance(q, (And, Or)):
            for r in q.parts:
                walk(r)
        elif isinstance(q, Not):
            walk(q.inner)

    if p is not None:
        walk(p)
    return frozenset(out)


def _needs_host(p) -> bool:
    """True when a predicate subtree cannot compile to rank space:
    ``corro_json_contains`` (no rank-interval form) or a LIKE whose
    pattern has no prefix-range compilation."""
    if isinstance(p, JsonContains):
        return True
    if isinstance(p, Like):
        return like_prefix_ranges(p.pattern) is None
    if isinstance(p, (And, Or)):
        return any(_needs_host(q) for q in p.parts)
    if isinstance(p, Not):
        return _needs_host(p.inner)
    return False


def split_host_predicate(where):
    """Partition a (value-column) WHERE AST into (host_pred, dev_pred).

    Terms containing ``corro_json_contains`` or a non-prefix LIKE evaluate
    host-side over decoded values — they have no rank-interval form, and
    values interned after compilation would miss a baked rank mask.
    Top-level AND parts split independently; a part is host as soon as it
    contains such a term anywhere (OR/NOT mixing is fine: host evaluation
    handles the full predicate grammar).
    """
    if where is None:
        return None, None
    parts = where.parts if isinstance(where, And) else (where,)
    host_parts = [p for p in parts if _needs_host(p)]
    dev_parts = [p for p in parts if not _needs_host(p)]

    def join(ps):
        if not ps:
            return None
        return ps[0] if len(ps) == 1 else And(tuple(ps))

    return join(host_parts), join(dev_parts)


def split_pk_predicate(where, pk_cols: frozenset):
    """Partition a WHERE AST into (pk_pred, value_pred).

    Primary-key values are host-side data (the slot allocation map), not
    device ranks, so pk comparisons evaluate on host while value
    comparisons compile to rank space. Top-level AND parts split cleanly;
    a single part mixing pk and value columns (e.g. ``pk = 1 OR v > 2``)
    cannot run half-on-host and is rejected.
    """
    if where is None:
        return None, None
    parts = where.parts if isinstance(where, And) else (where,)
    pk_parts, val_parts = [], []
    for p in parts:
        cs = predicate_columns(p)
        if cs and cs <= pk_cols:
            pk_parts.append(p)
        elif cs & pk_cols:
            raise QueryError(
                "a predicate term mixing primary-key and value columns is "
                f"unsupported: {_render(p)}"
            )
        else:
            val_parts.append(p)

    def join(ps):
        if not ps:
            return None
        return ps[0] if len(ps) == 1 else And(tuple(ps))

    return join(pk_parts), join(val_parts)


def eval_predicate_py(p, get) -> bool:
    """Host-side predicate evaluation with the same semantics as the
    compiled rank-space version: comparisons against NULL (or a missing
    value) are False; ``IS [NOT] NULL`` sees them; Not is plain negation.

    ``get(col)`` returns the column's Python value (None for NULL).
    """
    if isinstance(p, Cmp):
        v = get(p.col)
        if v is None or p.lit is None:
            return False
        kv, kl = sqlite_sort_key(v), sqlite_sort_key(p.lit)
        if p.op == "=":
            return kv == kl
        if p.op == "!=":
            return kv != kl
        if p.op == "<":
            return kv < kl
        if p.op == "<=":
            return kv <= kl
        if p.op == ">":
            return kv > kl
        if p.op == ">=":
            return kv >= kl
        raise QueryError(f"bad op {p.op!r}")
    if isinstance(p, IsNull):
        return (get(p.col) is not None) if p.negated else (get(p.col) is None)
    if isinstance(p, InList):
        v = get(p.col)
        if v is None:
            return False
        kv = sqlite_sort_key(v)
        hit = any(
            l is not None and sqlite_sort_key(l) == kv for l in p.lits
        )
        if p.negated:
            # x NOT IN (…, NULL) is UNKNOWN when x misses → False
            return not hit and not any(l is None for l in p.lits)
        return hit
    if isinstance(p, Like):
        v = get(p.col)
        if v is None:
            return False
        return like_match(p.pattern, v) != p.negated
    if isinstance(p, JsonContains):
        import json as _json

        from corro_sim_torch.functions import json_contains

        v = get(p.col)
        if not isinstance(v, str):
            return False
        try:
            parsed = _json.loads(v)
        except ValueError:
            return False
        sel = p.selector_obj if p.selector_obj is not None \
            else _json.loads(p.selector)
        if p.col_is_object:
            return json_contains(sel, parsed)
        return json_contains(parsed, sel)
    if isinstance(p, And):
        return all(eval_predicate_py(q, get) for q in p.parts)
    if isinstance(p, Or):
        return any(eval_predicate_py(q, get) for q in p.parts)
    if isinstance(p, Not):
        return not eval_predicate_py(p.inner, get)
    raise QueryError(f"bad predicate node {p!r}")


# ------------------------------------------------- rank-space compilation


class RankUniverse(_BandRanges):
    """The frozen, conflict-ordered value universe ranks index into
    (rank order == the extension's equal-cv conflict order; SQL-semantics
    comparisons come from the _BandRanges multi-range compilation)."""

    def __init__(self, sorted_values):
        self.values = list(sorted_values)
        self._keys = [crsql_conflict_key(v) for v in self.values]

    def _edge(self, key, right: bool) -> int:
        return (bisect.bisect_right if right else bisect.bisect_left)(
            self._keys, key
        )

    def rank_of(self, lit):
        """(lo, hi): ranks r with conflict-key == lit's satisfy
        lo <= r < hi (band+value identity; SQL equality = eq_ranges)."""
        k = crsql_conflict_key(lit)
        return self._edge(k, False), self._edge(k, True)


def _none(r, dims: int | None = None):
    """All-False mask of ``r``'s shape (or of its first ``dims`` axes),
    on ``r``'s device."""
    shape = r.shape if dims is None else r.shape[:dims]
    return torch.zeros(shape, dtype=torch.bool, device=r.device)


def compile_predicate(pred, universe: RankUniverse, col_index):
    """Predicate AST → ``fn(vr: (R, C) int32, unset: (R, C) bool) -> (R,) bool``.

    ``vr`` is the rank plane; ``unset`` marks never-written cells (which
    compare as NULL — SQL three-valued logic collapses to False for
    comparisons, True only under IS NULL). The returned function runs
    on ``vr``'s device; its constants are Python ints.
    """

    def comp(p):
        if isinstance(p, Cmp):
            ci = col_index(p.col)
            if p.lit is None:
                # SQL: comparisons with NULL are never true
                return lambda vr, unset: _none(vr, 1)
            # SQL comparison semantics over the conflict-ordered rank
            # space: equality spans the int+real bands (3 == 3.0); order
            # comparisons compile to up to three disjoint rank ranges
            # (numbers sort below text below blob in SQL, but the bands
            # are laid out in the extension's conflict order).
            if p.op in ("=", "!="):
                ranges = universe.eq_ranges(p.lit)
                negate = p.op == "!="
            else:
                ranges = universe.sql_ranges(p.lit, p.op)
                negate = False
            nlo, nhi = universe.rank_of(None)

            def f(vr, unset, ci=ci, ranges=tuple(ranges), negate=negate,
                  nlo=nlo, nhi=nhi):
                r = vr[:, ci]
                # three-valued logic: unset cells AND stored NULLs never
                # satisfy a comparison (NULL < 5 is NULL, not true)
                known = ~unset[:, ci] & ~((r >= nlo) & (r < nhi))
                m = _none(r)
                for lo, hi in ranges:
                    part = r >= lo
                    if hi is not None:  # None = open-ended upper bound
                        part = part & (r < hi)
                    m = m | part
                return (~m if negate else m) & known

            return f
        if isinstance(p, IsNull):
            ci = col_index(p.col)
            lo, hi = universe.rank_of(None)

            def f(vr, unset, ci=ci, lo=lo, hi=hi, neg=p.negated):
                isnull = unset[:, ci] | ((vr[:, ci] >= lo) & (vr[:, ci] < hi))
                return ~isnull if neg else isnull

            return f
        if isinstance(p, InList):
            ci = col_index(p.col)
            bounds = [
                rng
                for v in p.lits if v is not None
                for rng in universe.eq_ranges(v)
            ]
            nlo, nhi = universe.rank_of(None)
            has_null = any(v is None for v in p.lits)

            def f(vr, unset, ci=ci, bounds=tuple(bounds), neg=p.negated,
                  nlo=nlo, nhi=nhi, has_null=has_null):
                r = vr[:, ci]
                known = ~unset[:, ci] & ~((r >= nlo) & (r < nhi))
                hit = _none(r)
                for lo, hi in bounds:
                    hit = hit | ((r >= lo) & (r < hi))
                if neg:
                    if has_null:  # NOT IN over a NULL-bearing list: UNKNOWN
                        return _none(r)
                    return known & ~hit
                return known & hit

            return f
        if isinstance(p, Like):
            ranges = like_prefix_ranges(p.pattern)
            if ranges is None:
                raise QueryError(
                    f"LIKE {p.pattern!r} cannot compile to rank space — "
                    "split it host-side first (split_host_predicate)"
                )
            ci = col_index(p.col)
            # [lo, hi) rank interval per case variant of the prefix; only
            # the low edges matter (rank_of of an un-stored string returns
            # a collapsed edge, which is exactly the cut point we need)
            edges = [
                (universe.rank_of(lo)[0], universe.rank_of(hi)[0])
                for lo, hi in ranges
            ]
            nlo, nhi = universe.rank_of(None)

            def f(vr, unset, ci=ci, edges=tuple(edges), neg=p.negated,
                  nlo=nlo, nhi=nhi):
                r = vr[:, ci]
                known = ~unset[:, ci] & ~((r >= nlo) & (r < nhi))
                hit = _none(r)
                for lo, hi in edges:
                    hit = hit | ((r >= lo) & (r < hi))
                return known & (~hit if neg else hit)

            return f
        if isinstance(p, And):
            fs = [comp(q) for q in p.parts]
            return lambda vr, unset: torch.stack(
                [f(vr, unset) for f in fs]
            ).all(0)
        if isinstance(p, Or):
            fs = [comp(q) for q in p.parts]
            return lambda vr, unset: torch.stack(
                [f(vr, unset) for f in fs]
            ).any(0)
        if isinstance(p, Not):
            f = comp(p.inner)
            return lambda vr, unset: ~f(vr, unset)
        if isinstance(p, JsonContains):
            raise QueryError(
                "corro_json_contains cannot compile to rank space — "
                "split it host-side first (split_host_predicate)"
            )
        raise QueryError(f"bad predicate node {p!r}")

    if pred is None:
        return lambda vr, unset: ~_none(vr, 1)
    return comp(pred)


# ------------------------------------- batched (structure-keyed) compile
#
# One registered query = one evaluation is the simple shape; at 1k+ live
# subscriptions that is 1k dispatches and 1k device→host reads per tick,
# and the live leg stops scaling. The observation: workload-shaped
# subscriber populations differ only in their CONSTANTS (literals,
# columns, observer node) while sharing the predicate's structure. So a
# predicate compiles in two pieces:
#
# - a **skeleton** (:func:`predicate_batch_plan`): the hashable AST
#   structure — node kinds, ops, negations, range counts/open-endedness
#   — everything that shapes the evaluated program;
# - a **constants vector**: one flat int32 array per AST node carrying
#   the column index, NULL band and rank bounds, consumed positionally
#   by the structure-compiled evaluator
#   (:func:`compile_predicate_batched`).
#
# Matchers sharing a skeleton evaluate as ONE group evaluation over their
# stacked constants (subs/manager.py): a leading group axis on the planes
# and the constants, the per-group column read as a gather along the
# column axis. Bit-identical to the per-matcher path, with the per-tick
# dispatch count dropping from O(subscriptions) to O(distinct
# structures).


def predicate_batch_plan(pred, universe, col_index):
    """``(skeleton, consts)`` for the batched evaluator, or None when a
    node cannot batch (JsonContains — host-side anyway). ``consts`` is a
    list of 1-D int32 arrays, one per constant-bearing node in walk
    order; layout per node: ``[ci, nlo, nhi, lo..., hi...]``."""
    import numpy as np

    def null_band():
        lo, hi = universe.rank_of(None)
        return int(lo), int(hi)

    def _open(hi):
        return hi is None

    def walk(p):
        if p is None:
            return ("true",), []
        if isinstance(p, Cmp):
            if p.lit is None:
                return ("false",), []
            if p.op in ("=", "!="):
                ranges = tuple(universe.eq_ranges(p.lit))
                negate = p.op == "!="
            else:
                ranges = tuple(universe.sql_ranges(p.lit, p.op))
                negate = False
            nlo, nhi = null_band()
            open_pat = tuple(_open(hi) for _, hi in ranges)
            consts = np.asarray(
                [col_index(p.col), nlo, nhi]
                + [int(lo) for lo, _ in ranges]
                + [0 if _open(hi) else int(hi) for _, hi in ranges],
                np.int32,
            )
            return ("cmp", negate, len(ranges), open_pat), [consts]
        if isinstance(p, IsNull):
            nlo, nhi = null_band()
            return ("isnull", p.negated), [
                np.asarray([col_index(p.col), nlo, nhi], np.int32)
            ]
        if isinstance(p, InList):
            bounds = tuple(
                rng
                for v in p.lits if v is not None
                for rng in universe.eq_ranges(v)
            )
            has_null = any(v is None for v in p.lits)
            nlo, nhi = null_band()
            consts = np.asarray(
                [col_index(p.col), nlo, nhi]
                + [int(lo) for lo, _ in bounds]
                + [int(hi) for _, hi in bounds],
                np.int32,
            )
            return ("inlist", p.negated, has_null, len(bounds)), [consts]
        if isinstance(p, Like):
            ranges = like_prefix_ranges(p.pattern)
            if ranges is None:
                return None
            edges = tuple(
                (universe.rank_of(lo)[0], universe.rank_of(hi)[0])
                for lo, hi in ranges
            )
            nlo, nhi = null_band()
            consts = np.asarray(
                [col_index(p.col), nlo, nhi]
                + [int(lo) for lo, _ in edges]
                + [int(hi) for _, hi in edges],
                np.int32,
            )
            return ("like", p.negated, len(edges)), [consts]
        if isinstance(p, (And, Or)):
            subs, consts = [], []
            for q in p.parts:
                r = walk(q)
                if r is None:
                    return None
                subs.append(r[0])
                consts.extend(r[1])
            tag = "and" if isinstance(p, And) else "or"
            return (tag, tuple(subs)), consts
        if isinstance(p, Not):
            r = walk(p.inner)
            if r is None:
                return None
            return ("not", r[0]), r[1]
        return None  # JsonContains / unknown node — no batch form

    return walk(pred)


def compile_predicate_batched(skeleton):
    """Structure-only compile of a :func:`predicate_batch_plan` skeleton:
    ``fn(vr, unset, consts) -> bool mask`` with every constant read from
    the ``consts`` tensors — the SAME function evaluates every matcher
    sharing the skeleton.

    Batched: ``vr``/``unset`` are ``(B, R, C)`` and each ``consts[i]``
    is ``(B, L_i)`` int32 (row ``b`` is matcher ``b``'s constants); the
    result is ``(B, R)``. One matcher: ``(R, C)`` planes with ``(L_i,)``
    constants give ``(R,)``, evaluated as a group of one. The per-matcher
    column is a gather along the column axis; everything runs on the
    planes' device."""
    pos_counter = [0]

    def take_pos():
        p = pos_counter[0]
        pos_counter[0] += 1
        return p

    def column(plane, ci):
        # plane (B, R, C), ci (B,) → (B, R): each group member's column
        b = torch.arange(plane.shape[0], device=plane.device)
        return plane[b, :, ci.long()]

    def build(sk):
        tag = sk[0]
        if tag == "true":
            return lambda vr, unset, c: ~_none(vr, 2)
        if tag == "false":
            return lambda vr, unset, c: _none(vr, 2)
        if tag == "cmp":
            _, negate, k, open_pat = sk
            pos = take_pos()

            def f(vr, unset, c, pos=pos, negate=negate, k=k,
                  open_pat=open_pat):
                a = c[pos]
                r = column(vr, a[:, 0])
                known = ~column(unset, a[:, 0]) & ~(
                    (r >= a[:, 1:2]) & (r < a[:, 2:3])
                )
                m = _none(r)
                for j in range(k):
                    part = r >= a[:, 3 + j:4 + j]
                    if not open_pat[j]:
                        part = part & (r < a[:, 3 + k + j:4 + k + j])
                    m = m | part
                return (~m if negate else m) & known

            return f
        if tag == "isnull":
            _, neg = sk
            pos = take_pos()

            def f(vr, unset, c, pos=pos, neg=neg):
                a = c[pos]
                r = column(vr, a[:, 0])
                isnull = column(unset, a[:, 0]) | (
                    (r >= a[:, 1:2]) & (r < a[:, 2:3])
                )
                return ~isnull if neg else isnull

            return f
        if tag in ("inlist", "like"):
            if tag == "inlist":
                _, neg, has_null, k = sk
            else:
                _, neg, k = sk
                has_null = False
            pos = take_pos()

            def f(vr, unset, c, pos=pos, neg=neg, k=k,
                  has_null=has_null, tag=tag):
                a = c[pos]
                r = column(vr, a[:, 0])
                known = ~column(unset, a[:, 0]) & ~(
                    (r >= a[:, 1:2]) & (r < a[:, 2:3])
                )
                hit = _none(r)
                for j in range(k):
                    hit = hit | ((r >= a[:, 3 + j:4 + j])
                                 & (r < a[:, 3 + k + j:4 + k + j]))
                if tag == "inlist" and neg and has_null:
                    return _none(r)  # NOT IN w/ NULL
                return known & (~hit if neg else hit)

            return f
        if tag == "and":
            fs = [build(q) for q in sk[1]]
            return lambda vr, unset, c: torch.stack(
                [f(vr, unset, c) for f in fs]
            ).all(0)
        if tag == "or":
            fs = [build(q) for q in sk[1]]
            return lambda vr, unset, c: torch.stack(
                [f(vr, unset, c) for f in fs]
            ).any(0)
        if tag == "not":
            f = build(sk[1])
            return lambda vr, unset, c: ~f(vr, unset, c)
        raise QueryError(f"bad batch skeleton {sk!r}")

    fn = build(skeleton)

    def evaluate(vr, unset, consts):
        consts = [torch.as_tensor(a, device=vr.device) for a in consts]
        if vr.dim() == 2:  # one matcher: a group of one
            return fn(vr[None], unset[None], [a[None] for a in consts])[0]
        return fn(vr, unset, consts)

    return evaluate
