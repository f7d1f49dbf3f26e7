"""Scalar SQL expressions for the DML surface: parser + SQLite-semantics
evaluator.

The reference executes arbitrary SQL inside the write transaction
(``corro-agent/src/api/public/mod.rs:104-131``) — ``UPDATE t SET v = v+1``,
expressions in WHERE, ``INSERT … SELECT`` all work because SQLite evaluates
them. The simulator's write path plans statements host-side, so the
scalar-expression subset SQLite would evaluate is implemented here:
arithmetic (``+ - * / %``), string concat (``||``), comparisons with SQL
three-valued logic, ``AND/OR/NOT``, ``IS [NOT] NULL``, ``[NOT] LIKE``,
``[NOT] IN (…)``, ``[NOT] BETWEEN``, ``CASE``, and the common scalar
functions. Evaluation is row-at-a-time against a ``{column: value}``
environment (NULL = ``None``), with SQLite's NULL propagation and
integer-division semantics.

Port of ``corro_sim/api/exprs.py`` (standard library only), line
for line, with the reference's behaviour kept where it is a defect:
scalar ``min``/``max`` raise ``TypeError`` on mixed types, and ``_text``
keeps its dead branch (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
import math

from corro_sim_torch.subs.query import QueryError, _Parser, _tokenize


class ExprError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Lit:
    value: object


@dataclasses.dataclass(frozen=True)
class Col:
    name: str


@dataclasses.dataclass(frozen=True)
class Bin:
    op: str
    left: object
    right: object


@dataclasses.dataclass(frozen=True)
class Un:
    op: str  # '-' | 'NOT'
    inner: object


@dataclasses.dataclass(frozen=True)
class Func:
    name: str
    args: tuple


@dataclasses.dataclass(frozen=True)
class Case:
    operand: object | None
    whens: tuple  # of (cond_expr, result_expr)
    default: object | None


@dataclasses.dataclass(frozen=True)
class IsNull:
    inner: object
    negate: bool


@dataclasses.dataclass(frozen=True)
class InExpr:
    inner: object
    items: tuple
    negate: bool


@dataclasses.dataclass(frozen=True)
class Between:
    inner: object
    lo: object
    hi: object
    negate: bool


_CMP_OPS = {"=", "!=", "<", "<=", ">", ">="}
_CASE_WORDS = {"CASE", "WHEN", "THEN", "ELSE", "END"}


def _word(p: _Parser):
    k, v = p.peek()
    if k == "ident" and v.upper() in _CASE_WORDS:
        return v.upper()
    return None


class ExprParser:
    """Pratt-style scalar/boolean expression parser over the query
    tokenizer's stream. Reuses the shared ``_Parser`` cursor so it can be
    embedded mid-statement (e.g. after ``SET col =``)."""

    def __init__(self, p: _Parser):
        self.p = p

    # --- boolean level (WHERE) -----------------------------------------
    def parse_bool(self):
        return self._or()

    def _or(self):
        node = self._and()
        while self.p.peek()[0] == "OR":
            self.p.next()
            node = Bin("OR", node, self._and())
        return node

    def _and(self):
        node = self._not()
        while self.p.peek()[0] == "AND":
            self.p.next()
            node = Bin("AND", node, self._not())
        return node

    def _not(self):
        if self.p.peek()[0] == "NOT":
            self.p.next()
            return Un("NOT", self._not())
        return self._predicate()

    def _predicate(self):
        left = self.parse_scalar()
        k, v = self.p.peek()
        if k == "op" and v in _CMP_OPS:
            self.p.next()
            return Bin(v, left, self.parse_scalar())
        if k == "IS":
            self.p.next()
            negate = False
            if self.p.peek()[0] == "NOT":
                self.p.next()
                negate = True
            self.p.expect("NULL")
            return IsNull(left, negate)
        negate = False
        if k == "NOT" and self.p.toks[self.p.i + 1][0] in ("LIKE", "IN",
                                                           "BETWEEN"):
            self.p.next()
            negate = True
            k, v = self.p.peek()
        if k == "LIKE":
            self.p.next()
            node = Bin("LIKE", left, self.parse_scalar())
            return Un("NOT", node) if negate else node
        if k == "IN":
            self.p.next()
            self.p.expect("(")
            items = [self.parse_scalar()]
            while self.p.peek()[0] == ",":
                self.p.next()
                items.append(self.parse_scalar())
            self.p.expect(")")
            return InExpr(left, tuple(items), negate)
        if k == "BETWEEN":
            self.p.next()
            lo = self.parse_scalar()
            self.p.expect("AND")
            hi = self.parse_scalar()
            return Between(left, lo, hi, negate)
        return left

    # --- scalar level ---------------------------------------------------
    def parse_scalar(self):
        node = self._mul()
        while True:
            k, v = self.p.peek()
            if k == "op" and v in ("+", "-", "||"):
                self.p.next()
                node = Bin(v, node, self._mul())
            elif (
                k == "lit" and isinstance(v, (int, float))
                and not isinstance(v, bool) and v < 0
            ):
                # the tokenizer fuses "-5" into one negative literal, so
                # "a -5" arrives as ident, lit(-5): that is a subtraction.
                # Re-split the token in place so the multiplicative tail
                # still binds tighter ("v-5*2" must parse as v - (5*2)).
                self.p.toks[self.p.i] = ("op", "-")
                self.p.toks.insert(self.p.i + 1, ("lit", -v))
            else:
                return node

    def _mul(self):
        node = self._unary()
        while True:
            k, v = self.p.peek()
            if (k == "op" and v in ("/", "%")) or k == "*":
                self.p.next()
                node = Bin("*" if k == "*" else v, node, self._unary())
            else:
                return node

    def _unary(self):
        k, v = self.p.peek()
        if k == "op" and v == "-":
            self.p.next()
            return Un("-", self._unary())
        if k == "op" and v == "+":
            self.p.next()
            return self._unary()
        return self._primary()

    def _primary(self):
        k, v = self.p.peek()
        if k == "lit":
            self.p.next()
            return Lit(v)
        if k == "NULL":
            self.p.next()
            return Lit(None)
        if k == "(":
            self.p.next()
            node = self.parse_bool()
            self.p.expect(")")
            return node
        if _word(self.p) == "CASE":
            return self._case()
        if k == "ident":
            name = v
            self.p.next()
            if self.p.peek()[0] == "(":
                self.p.next()
                args = []
                if self.p.peek()[0] != ")":
                    args.append(self.parse_bool())
                    while self.p.peek()[0] == ",":
                        self.p.next()
                        args.append(self.parse_bool())
                self.p.expect(")")
                return Func(name.lower(), tuple(args))
            if self.p.peek()[0] == ".":
                self.p.next()
                col = self.p.expect("ident")
                return Col(f"{name}.{col}")
            return Col(name)
        raise ExprError(f"unexpected token {k} {v!r} in expression")

    def _case(self):
        self.p.next()  # CASE
        operand = None
        if _word(self.p) != "WHEN":
            operand = self.parse_scalar()
        whens = []
        while _word(self.p) == "WHEN":
            self.p.next()
            cond = self.parse_bool()
            if _word(self.p) != "THEN":
                raise ExprError("CASE WHEN without THEN")
            self.p.next()
            whens.append((cond, self.parse_bool()))
        default = None
        if _word(self.p) == "ELSE":
            self.p.next()
            default = self.parse_bool()
        if _word(self.p) != "END":
            raise ExprError("CASE without END")
        self.p.next()
        return Case(operand, tuple(whens), default)


def parse_expr(sql: str):
    """Parse a standalone scalar/boolean expression string."""
    p = _Parser(_tokenize(sql))
    e = ExprParser(p).parse_bool()
    if p.peek()[0] != "eof":
        raise ExprError(f"trailing tokens at {p.peek()!r}")
    return e


def columns_of(node) -> set:
    """Column names an expression references."""
    out: set = set()

    def walk(e):
        if isinstance(e, Col):
            out.add(e.name)
        elif isinstance(e, Bin):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, Un):
            walk(e.inner)
        elif isinstance(e, Func):
            for a in e.args:
                walk(a)
        elif isinstance(e, Case):
            if e.operand is not None:
                walk(e.operand)
            for c, r in e.whens:
                walk(c)
                walk(r)
            if e.default is not None:
                walk(e.default)
        elif isinstance(e, (IsNull,)):
            walk(e.inner)
        elif isinstance(e, InExpr):
            walk(e.inner)
            for i in e.items:
                walk(i)
        elif isinstance(e, Between):
            walk(e.inner)
            walk(e.lo)
            walk(e.hi)

    walk(node)
    return out


# ------------------------------------------------------------- evaluation

def _num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _sql_like(text, pat) -> bool:
    import re as _re

    # ASCII-only case folding, matching the predicate grammar's LIKE
    # (query.py builds per-char [aA] classes for the same reason:
    # re.IGNORECASE would fold Unicode, diverging from SQLite's default)
    rx = []
    for ch in str(pat):
        if ch == "%":
            rx.append(".*")
        elif ch == "_":
            rx.append(".")
        elif ch.isascii() and ch.isalpha():
            rx.append("[" + ch.lower() + ch.upper() + "]")
        else:
            rx.append(_re.escape(ch))
    return _re.fullmatch("".join(rx), str(text), _re.DOTALL) is not None


def _cmp(op, a, b):
    """SQL comparison with NULL → UNKNOWN (None). Cross-type operands
    order by SQLite's type order (numbers < text < blob) via the shared
    sort key — the same one eval_predicate_py uses."""
    if a is None or b is None:
        return None
    if _num(a) != _num(b) or isinstance(a, (bytes, bytearray)) != isinstance(
        b, (bytes, bytearray)
    ):
        from corro_sim_torch.io.values import sqlite_sort_key

        a = sqlite_sort_key(a)
        b = sqlite_sort_key(b)
    if op == "=":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    return a >= b


def _arith(op, a, b):
    if op == "||":
        if a is None or b is None:
            return None
        return _text(a) + _text(b)
    if a is None or b is None:
        return None
    if not (_num(a) and _num(b)):
        # SQLite coerces text that looks numeric; non-numeric text → 0
        a = _coerce_num(a)
        b = _coerce_num(b)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if b == 0:
            return None  # SQLite: division by zero yields NULL
        if isinstance(a, int) and isinstance(b, int):
            # exact integer division truncating toward zero — int(a / b)
            # would round-trip through float and corrupt ints > 2^53
            q = a // b
            if q < 0 and q * b != a:
                q += 1
            return q
        return a / b
    if op == "%":
        if b == 0:
            return None
        if isinstance(a, int) and isinstance(b, int):
            q = a // b
            if q < 0 and q * b != a:
                q += 1
            return a - q * b  # sign follows the dividend, exact
        return math.fmod(a, b)
    raise ExprError(f"unknown operator {op!r}")


def _coerce_num(v):
    if _num(v):
        return v
    try:
        f = float(str(v))
        return int(f) if f.is_integer() else f
    except (TypeError, ValueError):
        return 0


def _text(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(v)
    return str(v)


def _truth(v):
    """SQL boolean of a value: NULL→None, 0/0.0→False, else numeric!=0."""
    if v is None:
        return None
    if isinstance(v, bool):
        return v
    if _num(v):
        return v != 0
    return _coerce_num(v) != 0


_FUNCS = {
    "abs": lambda a: None if a[0] is None else abs(_coerce_num(a[0])),
    "length": lambda a: None if a[0] is None else len(_text(a[0])),
    "lower": lambda a: None if a[0] is None else _text(a[0]).lower(),
    "upper": lambda a: None if a[0] is None else _text(a[0]).upper(),
    "hex": lambda a: (
        "" if a[0] is None else (
            a[0].hex().upper() if isinstance(a[0], (bytes, bytearray))
            else _text(a[0]).encode().hex().upper()
        )
    ),
    "round": lambda a: _fn_round(a),
    "trim": lambda a: None if a[0] is None else _text(a[0]).strip(),
    "ltrim": lambda a: None if a[0] is None else _text(a[0]).lstrip(),
    "rtrim": lambda a: None if a[0] is None else _text(a[0]).rstrip(),
    "typeof": lambda a: (
        "null" if a[0] is None else
        "integer" if isinstance(a[0], int) and not isinstance(a[0], bool)
        else "real" if isinstance(a[0], float)
        else "blob" if isinstance(a[0], (bytes, bytearray)) else "text"
    ),
    "instr": lambda a: (
        None if a[0] is None or a[1] is None
        else _text(a[0]).find(_text(a[1])) + 1
    ),
    "replace": lambda a: (
        None if None in a[:3]
        else _text(a[0]).replace(_text(a[1]), _text(a[2]))
    ),
}


def _fn_round(args):
    """SQLite round(): REAL result, half-away-from-zero (Python's round
    is banker's and preserves int — both diverge from SQLite)."""
    if args[0] is None:
        return None
    x = _coerce_num(args[0])
    n = int(args[1]) if len(args) > 1 and args[1] is not None else 0
    m = 10.0 ** n
    return math.copysign(math.floor(abs(x) * m + 0.5) / m, x)


def _fn_substr(args):
    if args[0] is None or args[1] is None:
        return None
    s = _text(args[0])
    start = int(args[1])
    n = int(args[2]) if len(args) > 2 and args[2] is not None else None
    if start > 0:
        i = start - 1
    elif start == 0:
        i = 0
    else:
        i = max(len(s) + start, 0)
    return s[i:] if n is None else s[i:i + max(n, 0)]


def eval_expr(node, env: dict):
    """Evaluate an expression AST against ``{column: value}``.

    Boolean results use three-valued logic internally (None = UNKNOWN);
    callers of WHERE predicates collapse None → False like SQL does.
    """
    if isinstance(node, Lit):
        return node.value
    if isinstance(node, Col):
        name = node.name
        if name in env:
            return env[name]
        bare = name.split(".")[-1]
        if bare in env:
            return env[bare]
        raise ExprError(f"unknown column {name!r}")
    if isinstance(node, Un):
        if node.op == "-":
            v = eval_expr(node.inner, env)
            return None if v is None else -_coerce_num(v)
        t = _truth(eval_expr(node.inner, env))
        return None if t is None else (not t)
    if isinstance(node, Bin):
        if node.op == "AND":
            lt = _truth(eval_expr(node.left, env))
            if lt is False:
                return False
            rt = _truth(eval_expr(node.right, env))
            if rt is False:
                return False
            return None if (lt is None or rt is None) else True
        if node.op == "OR":
            lt = _truth(eval_expr(node.left, env))
            if lt is True:
                return True
            rt = _truth(eval_expr(node.right, env))
            if rt is True:
                return True
            return None if (lt is None or rt is None) else False
        if node.op in _CMP_OPS:
            return _cmp(node.op, eval_expr(node.left, env),
                        eval_expr(node.right, env))
        if node.op == "LIKE":
            a = eval_expr(node.left, env)
            b = eval_expr(node.right, env)
            if a is None or b is None:
                return None
            return _sql_like(a, b)
        return _arith(node.op, eval_expr(node.left, env),
                      eval_expr(node.right, env))
    if isinstance(node, IsNull):
        v = eval_expr(node.inner, env)
        return (v is not None) if node.negate else (v is None)
    if isinstance(node, InExpr):
        v = eval_expr(node.inner, env)
        if v is None:
            return None
        saw_null = False
        for item in node.items:
            iv = eval_expr(item, env)
            if iv is None:
                saw_null = True
            elif _cmp("=", v, iv):
                return not node.negate
        if saw_null:
            return None  # UNKNOWN per SQL IN semantics
        return node.negate
    if isinstance(node, Between):
        v = eval_expr(node.inner, env)
        lo = eval_expr(node.lo, env)
        hi = eval_expr(node.hi, env)
        ge = _cmp(">=", v, lo)
        le = _cmp("<=", v, hi)
        if ge is None or le is None:
            return None
        r = ge and le
        return (not r) if node.negate else r
    if isinstance(node, Case):
        if node.operand is not None:
            opv = eval_expr(node.operand, env)
            for cond, res in node.whens:
                if _cmp("=", opv, eval_expr(cond, env)):
                    return eval_expr(res, env)
        else:
            for cond, res in node.whens:
                if _truth(eval_expr(cond, env)):
                    return eval_expr(res, env)
        return None if node.default is None else eval_expr(node.default, env)
    if isinstance(node, Func):
        name = node.name
        args = [eval_expr(a, env) for a in node.args]
        if name == "coalesce":
            for a in args:
                if a is not None:
                    return a
            return None
        if name == "ifnull":
            return args[0] if args[0] is not None else args[1]
        if name == "nullif":
            return None if _cmp("=", args[0], args[1]) else args[0]
        if name == "iif":
            return args[1] if _truth(args[0]) else (
                args[2] if len(args) > 2 else None
            )
        if name in ("min", "max"):
            vals = [a for a in args if a is not None]
            if len(vals) != len(args) or not vals:
                return None  # scalar min/max: any NULL arg → NULL
            return min(vals) if name == "min" else max(vals)
        if name == "substr" or name == "substring":
            return _fn_substr(args)
        fn = _FUNCS.get(name)
        if fn is None:
            raise ExprError(f"unsupported function {name!r}")
        return fn(args)
    raise ExprError(f"cannot evaluate {node!r}")


def sql_of(node) -> str:
    """Canonical SQL rendering of an expression AST (normalization for
    subscription dedupe, like the predicate _render in subs/query.py)."""
    if isinstance(node, Lit):
        v = node.value
        if v is None:
            return "NULL"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        if isinstance(v, (bytes, bytearray)):
            return "X'" + bytes(v).hex() + "'"
        return repr(v)
    if isinstance(node, Col):
        return node.name
    if isinstance(node, Un):
        if node.op == "NOT":
            return f"NOT ({sql_of(node.inner)})"
        return f"-({sql_of(node.inner)})"
    if isinstance(node, Bin):
        return f"({sql_of(node.left)} {node.op} {sql_of(node.right)})"
    if isinstance(node, IsNull):
        return (
            f"({sql_of(node.inner)} IS"
            f"{' NOT' if node.negate else ''} NULL)"
        )
    if isinstance(node, InExpr):
        items = ", ".join(sql_of(i) for i in node.items)
        return (
            f"({sql_of(node.inner)}{' NOT' if node.negate else ''}"
            f" IN ({items}))"
        )
    if isinstance(node, Between):
        return (
            f"({sql_of(node.inner)}{' NOT' if node.negate else ''} BETWEEN "
            f"{sql_of(node.lo)} AND {sql_of(node.hi)})"
        )
    if isinstance(node, Case):
        parts = ["CASE"]
        if node.operand is not None:
            parts.append(sql_of(node.operand))
        for c, r in node.whens:
            parts.append(f"WHEN {sql_of(c)} THEN {sql_of(r)}")
        if node.default is not None:
            parts.append(f"ELSE {sql_of(node.default)}")
        parts.append("END")
        return " ".join(parts)
    if isinstance(node, Func):
        return f"{node.name}({', '.join(sql_of(a) for a in node.args)})"
    raise ExprError(f"cannot render {node!r}")


def is_literal(node) -> bool:
    return isinstance(node, Lit)


def const_value(node):
    """Evaluate a column-free expression at parse time."""
    return eval_expr(node, {})
