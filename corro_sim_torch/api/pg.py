"""Postgres wire-protocol API over a LiveCluster (corro-pg equivalent).

The reference runs a pgwire-v3 server on ``api.pg.addr`` that lets any
Postgres client/driver talk to a corrosion agent: it peeks for an
SSLRequest (`corro-pg/src/lib.rs:424`), answers the startup handshake,
implements both the simple ('Q') and the extended
(Parse/Bind/Describe/Execute/Close/Sync/Flush) query protocols with
prepared statements + portals (`lib.rs:719-1600`), translates Postgres
SQL to its storage layer, and serves minimal ``pg_catalog`` tables so
drivers' introspection queries work (`vtab/pg_*.rs`). Errors carry real
SQLSTATE codes (`sql_state.rs`).

Port of ``corro_sim/api/pg.py``, host Python only: the same wire
protocol and session machinery, with statements executed against the
simulated cluster: SELECTs through the rank-space query path, DML
through the changeset write path. The ``database`` startup parameter selects the
node ordinal to talk to (``node<K>`` → node K, anything else → node 0),
mirroring "which agent did you connect to".

Transaction semantics: ``BEGIN … COMMIT`` buffers DML and commits it as
ONE changeset batch (atomic, like the reference's single SQLite tx);
autocommit statements are one transaction each. Reads and rows-affected
counts inside an open transaction observe the transaction's own buffered
writes via the cluster's staged-write overlay (``plan_overlay`` — the
same mechanism ``execute()`` uses for in-batch visibility, matching the
reference's single-SQLite-tx semantics, api/public/mod.rs:104-131).
"""

from __future__ import annotations

import re
import socket
import socketserver
import struct
import threading

from corro_sim_torch.api.sql_state import code as sqlstate
from corro_sim_torch.api.statements import StatementError, bind_params
from corro_sim_torch.schema import SchemaError
from corro_sim_torch.subs.query import QueryError, eval_predicate_py, parse_query

PROTO_V3 = 196608  # 3.0
SSL_REQUEST = 80877103
GSSENC_REQUEST = 80877104
CANCEL_REQUEST = 80877102

# type OIDs (pg_type.h)
OID_BOOL = 16
OID_BYTEA = 17
OID_INT8 = 20
OID_INT4 = 23
OID_TEXT = 25
OID_FLOAT8 = 701

_TYPLEN = {OID_BOOL: 1, OID_BYTEA: -1, OID_INT8: 8, OID_INT4: 4,
           OID_TEXT: -1, OID_FLOAT8: 8}


class PgError(Exception):
    """Protocol-level error → ErrorResponse with a SQLSTATE code."""

    def __init__(self, condition: str, message: str):
        super().__init__(message)
        self.condition = condition
        self.code = sqlstate(condition)


def _affinity_oid(decl_type: str) -> int:
    """SQLite declared type → result OID, by SQLite affinity rules
    (schema.rs:803-834 resolves affinity the same way)."""
    t = (decl_type or "").upper()
    if "INT" in t:
        return OID_INT8
    if "CHAR" in t or "CLOB" in t or "TEXT" in t:
        return OID_TEXT
    if t == "" or "BLOB" in t:
        return OID_BYTEA
    if "REAL" in t or "FLOA" in t or "DOUB" in t:
        return OID_FLOAT8
    return OID_TEXT  # NUMERIC affinity: render as text


# ------------------------------------------------------------ wire encoding


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _msg(tag: bytes, payload: bytes = b"") -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def msg_auth_ok() -> bytes:
    return _msg(b"R", struct.pack("!I", 0))


def msg_parameter_status(k: str, v: str) -> bytes:
    return _msg(b"S", _cstr(k) + _cstr(v))


def msg_backend_key(pid: int, secret: int) -> bytes:
    return _msg(b"K", struct.pack("!II", pid, secret))


def msg_ready(status: bytes) -> bytes:
    return _msg(b"Z", status)


def msg_row_description(fields) -> bytes:
    """fields: [(name, oid)]"""
    out = [struct.pack("!H", len(fields))]
    for name, oid in fields:
        out.append(_cstr(name))
        out.append(struct.pack("!IHIhih", 0, 0, oid,
                               _TYPLEN.get(oid, -1), -1, 0))
    return _msg(b"T", b"".join(out))


def msg_data_row(cells: list[bytes | None]) -> bytes:
    out = [struct.pack("!H", len(cells))]
    for c in cells:
        if c is None:
            out.append(struct.pack("!i", -1))
        else:
            out.append(struct.pack("!I", len(c)) + c)
    return _msg(b"D", b"".join(out))


def msg_command_complete(tag: str) -> bytes:
    return _msg(b"C", _cstr(tag))


def msg_error(code_: str, message: str, severity: str = "ERROR") -> bytes:
    body = (b"S" + _cstr(severity) + b"V" + _cstr(severity)
            + b"C" + _cstr(code_) + b"M" + _cstr(message) + b"\x00")
    return _msg(b"E", body)


def msg_notice(code_: str, message: str) -> bytes:
    body = (b"S" + _cstr("WARNING") + b"V" + _cstr("WARNING")
            + b"C" + _cstr(code_) + b"M" + _cstr(message) + b"\x00")
    return _msg(b"N", body)


def msg_parameter_description(oids) -> bytes:
    return _msg(b"t", struct.pack("!H", len(oids))
                + b"".join(struct.pack("!I", o) for o in oids))


# ----------------------------------------------------------- value encoding


def _encode_cell(v, oid: int, fmt: int) -> bytes | None:
    if v is None:
        return None
    if fmt == 0:  # text
        if isinstance(v, bool):
            return b"t" if v else b"f"
        if isinstance(v, bytes):
            return b"\\x" + v.hex().encode()
        if isinstance(v, float):
            return repr(v).encode()
        return str(v).encode()
    # binary
    if oid == OID_INT8:
        return struct.pack("!q", int(v))
    if oid == OID_INT4:
        return struct.pack("!i", int(v))
    if oid == OID_FLOAT8:
        return struct.pack("!d", float(v))
    if oid == OID_BOOL:
        return b"\x01" if v else b"\x00"
    if oid == OID_BYTEA:
        return v if isinstance(v, bytes) else str(v).encode()
    return str(v).encode()  # text-ish


def _decode_param(raw: bytes | None, oid: int, fmt: int):
    if raw is None:
        return None
    if oid == 0 and fmt == 0:
        # Unspecified type: infer, but only from a *canonical* numeric
        # rendering so TEXT-bound values like '007' or '1e3' round-trip
        # unchanged (a real PG resolves unknown params from context; the
        # canonicality check is the conservative approximation).
        s = raw.decode("utf-8", "replace")
        try:
            if str(int(s)) == s:
                return int(s)
        except ValueError:
            pass
        try:
            if repr(float(s)) == s:
                return float(s)
        except ValueError:
            pass
        return s
    if fmt == 1:  # binary
        try:
            if oid == OID_INT8:
                return struct.unpack("!q", raw)[0]
            if oid == OID_INT4:
                return struct.unpack("!i", raw)[0]
            if oid == OID_FLOAT8:
                return struct.unpack("!d", raw)[0]
            if oid == OID_BOOL:
                return raw != b"\x00"
            if oid == OID_BYTEA:
                return raw
        except struct.error:
            raise PgError("invalid_binary_representation",
                          f"bad binary value for oid {oid}") from None
        return raw.decode("utf-8", "replace")
    # text format
    s = raw.decode("utf-8", "replace")
    try:
        if oid in (OID_INT8, OID_INT4):
            return int(s)
        if oid == OID_FLOAT8:
            return float(s)
        if oid == OID_BOOL:
            return s.lower() in ("t", "true", "1", "on", "yes")
        if oid == OID_BYTEA:
            if s.startswith("\\x"):
                return bytes.fromhex(s[2:])
            return s.encode()
    except ValueError:
        raise PgError("invalid_text_representation",
                      f"invalid input for oid {oid}: {s!r}") from None
    return s


# ------------------------------------------------------------- SQL surface

_LEAD = re.compile(r"^\s*(?:--[^\n]*\n\s*|/\*.*?\*/\s*)*([A-Za-z]+)",
                   re.DOTALL)


def classify(sql: str) -> str:
    m = _LEAD.match(sql)
    if not m:
        return "EMPTY"
    w = m.group(1).upper()
    if w == "START":
        return "BEGIN"
    if w == "END":
        return "COMMIT"
    if w == "ABORT":
        return "ROLLBACK"
    return w


def split_statements(sql: str) -> list[str]:
    """Split a simple-query message on top-level semicolons — aware of
    string literals, ``--`` line comments, and ``/* */`` block comments."""
    out, buf = [], []
    for kind, seg in _lex_segments(sql):
        if kind != "text":
            buf.append(seg)
            continue
        while True:
            cut = seg.find(";")
            if cut == -1:
                buf.append(seg)
                break
            buf.append(seg[:cut])
            out.append("".join(buf))
            buf = []
            seg = seg[cut + 1:]
    out.append("".join(buf))
    return [s for s in (x.strip() for x in out) if s]


def _lex_segments(sql: str):
    """One quote/comment-aware scanner for the statement-level helpers.

    Yields (kind, text) with kind ∈ {'text', 'str', 'line', 'block'}:
    string literals (including their quotes), ``--`` line comments
    (excluding the terminating newline), ``/* */`` block comments, and
    the plain SQL text between them."""
    i, n, start = 0, len(sql), 0
    while i < n:
        c = sql[i]
        if c == "'":
            if start < i:
                yield "text", sql[start:i]
            j = i + 1
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        j += 2
                        continue
                    j += 1
                    break
                j += 1
            else:
                j = n
            yield "str", sql[i:j]
            i = start = j
        elif c == "-" and i + 1 < n and sql[i + 1] == "-":
            if start < i:
                yield "text", sql[start:i]
            end = sql.find("\n", i)
            end = n if end == -1 else end
            yield "line", sql[i:end]
            i = start = end  # the newline stays in the next text segment
        elif c == "/" and i + 1 < n and sql[i + 1] == "*":
            if start < i:
                yield "text", sql[start:i]
            end = sql.find("*/", i + 2)
            end = n if end == -1 else end + 2
            yield "block", sql[i:end]
            i = start = end
        else:
            i += 1
    if start < n:
        yield "text", sql[start:n]


def count_params(sql: str) -> int:
    """Highest $n placeholder index outside string literals (0 if none)."""
    high = 0
    for kind, seg in _lex_segments(sql):
        if kind == "text":
            for m in re.finditer(r"\$(\d+)", seg):
                high = max(high, int(m.group(1)))
    return high


def strip_comments(sql: str) -> str:
    """Remove -- and /* */ comments (quote-aware): the rank-space SQL
    tokenizer has no comment syntax, and comments carry no semantics."""
    out = []
    for kind, seg in _lex_segments(sql):
        if kind in ("text", "str"):
            out.append(seg)
        elif kind == "block":
            out.append(" ")
    return "".join(out)


_COPY_RE = re.compile(
    r"COPY\s+(?:\(\s*(?P<query>.+?)\s*\)|"
    r"(?P<table>[A-Za-z_]\w*)\s*(?:\(\s*(?P<cols>[^)]*?)\s*\))?)"
    r"\s+TO\s+STDOUT"
    r"(?:\s+(?:WITH\s+)?\(\s*(?P<opts>[^)]*?)\s*\))?\s*$",
    re.IGNORECASE | re.DOTALL,
)


def _copy_text_field(v, delim: str) -> str:
    """COPY text-format cell: ``\\N`` for NULL, backslash escapes for
    backslash/newline/CR/tab plus the delimiter (the format psql's
    \\copy parses back)."""
    if v is None:
        return r"\N"
    if isinstance(v, (bytes, bytearray)):
        s = "\\x" + bytes(v).hex()
    else:
        s = str(v)
    s = (s.replace("\\", "\\\\").replace("\n", "\\n")
          .replace("\r", "\\r").replace("\t", "\\t"))
    if delim not in ("\t", "\\"):  # tab/backslash already escaped above
        s = s.replace(delim, "\\" + delim)
    return s


def _copy_csv_field(v, delim: str) -> str:
    """COPY csv-format cell: empty for NULL, RFC-4180 quoting."""
    if v is None:
        return ""
    if isinstance(v, (bytes, bytearray)):
        s = "\\x" + bytes(v).hex()
    else:
        s = str(v)
    if any(c in s for c in (delim, '"', "\n", "\r")):
        return '"' + s.replace('"', '""') + '"'
    return s


_TAGS = {
    "INSERT": lambda n: f"INSERT 0 {n}",
    "UPDATE": lambda n: f"UPDATE {n}",
    "DELETE": lambda n: f"DELETE {n}",
    "SELECT": lambda n: f"SELECT {n}",
}


# --------------------------------------------------------------- catalogs


_CATALOG_NAMES = frozenset(
    ("pg_type", "pg_class", "pg_namespace", "pg_database", "pg_attribute",
     "pg_range", "pg_index", "pg_constraint"))


def _catalog_tables(cluster) -> dict[str, tuple[list, list, list]]:
    """Minimal pg_catalog contents, synthesized from the live schema —
    the vtab set the reference implements (`corro-pg/src/vtab/`).

    Each entry is (column names, rows, column OIDs); the static OIDs keep
    the simple and extended protocols' type reporting identical."""
    I8, TX = OID_INT8, OID_TEXT
    types = [
        ("bool", OID_BOOL, 1), ("bytea", OID_BYTEA, -1),
        ("int8", OID_INT8, 8), ("int4", OID_INT4, 4),
        ("text", OID_TEXT, -1), ("float8", OID_FLOAT8, 8),
    ]
    pg_type = (["oid", "typname", "typlen", "typnamespace"],
               [[oid, name, tlen, 11] for name, oid, tlen in types],
               [I8, TX, I8, I8])
    tables = list(cluster.layout.schema.tables)
    pg_class = (["oid", "relname", "relnamespace", "relkind"],
                [[16384 + i, t, 2200, "r"] for i, t in enumerate(tables)],
                [I8, TX, I8, TX])
    pg_namespace = (["oid", "nspname"],
                    [[11, "pg_catalog"], [2200, "public"]], [I8, TX])
    pg_database = (["oid", "datname"], [[1, "corro"]], [I8, TX])
    typlen_of = {oid: tlen for _, oid, tlen in types}
    pg_attribute_rows = []
    pg_index_rows = []
    pg_constraint_rows = []
    for i, t in enumerate(tables):
        tbl = cluster.layout.schema.tables[t]
        attnum = {c.name: j + 1 for j, c in enumerate(tbl.columns)}
        # pk-declaration order, not column order: composite keys reflect
        # as PRIMARY KEY (b, a) declared them (Table.pk preserves it)
        pk_nums = [attnum[name] for name in tbl.pk]
        for j, col in enumerate(tbl.columns):
            oid = _affinity_oid(col.type)
            pg_attribute_rows.append(
                [16384 + i, col.name, j + 1, oid,
                 typlen_of.get(oid, -1), -1,
                 "t" if (col.primary_key or not col.nullable) else "f",
                 "t" if col.default is not None else "f", "f"])
        # WITHOUT ROWID pk as both an index and a 'p' constraint — the
        # two places ORMs look for primary-key columns (corro-pg vtab
        # analog: pg_index.indisprimary / pg_constraint.contype = 'p')
        pg_index_rows.append(
            [24576 + i, 16384 + i, len(pk_nums), "t", "t",
             " ".join(str(x) for x in pk_nums)])
        pg_constraint_rows.append(
            [f"{t}_pkey", 16384 + i, "p", 2200,
             "{" + ",".join(str(x) for x in pk_nums) + "}"])
    pg_attribute = (
        ["attrelid", "attname", "attnum", "atttypid", "attlen",
         "atttypmod", "attnotnull", "atthasdef", "attisdropped"],
        pg_attribute_rows, [I8, TX, I8, I8, I8, I8, TX, TX, TX])
    pg_index = (
        ["indexrelid", "indrelid", "indnatts", "indisunique",
         "indisprimary", "indkey"],
        pg_index_rows, [I8, I8, I8, TX, TX, TX])
    pg_constraint = (
        ["conname", "conrelid", "contype", "connamespace", "conkey"],
        pg_constraint_rows, [TX, I8, TX, I8, TX])
    return {
        "pg_type": pg_type, "pg_class": pg_class,
        "pg_namespace": pg_namespace, "pg_database": pg_database,
        "pg_attribute": pg_attribute, "pg_range": (["rngtypid"], [], [I8]),
        "pg_index": pg_index, "pg_constraint": pg_constraint,
    }


# ---------------------------------------------------------------- session


class _Prepared:
    __slots__ = ("sql", "kind", "param_oids")

    def __init__(self, sql, kind, param_oids):
        self.sql = sql
        self.kind = kind
        self.param_oids = param_oids


class _Portal:
    __slots__ = ("stmt", "bound_sql", "result_formats", "rows", "fields",
                 "pos", "tag_n")

    def __init__(self, stmt, bound_sql, result_formats):
        self.stmt = stmt
        self.bound_sql = bound_sql
        self.result_formats = result_formats
        self.rows = None      # materialized on first Execute
        self.fields = None
        self.pos = 0
        self.tag_n = 0


class _Session:
    """One client connection's state: tx, prepared statements, portals."""

    def __init__(self, server, sock):
        self.server = server
        self.cluster = server.cluster
        self.sock = sock
        self.node = 0
        self.prepared: dict[str, _Prepared] = {}
        self.portals: dict[str, _Portal] = {}
        self.tx_writes: list | None = None  # None = autocommit
        self.tx_failed = False
        # incrementally-built staged-write overlay of the open tx + its
        # validity key (universe/layout generations, planned count)
        self._tx_ov = None
        self._tx_ov_key = None
        self.params = {
            "server_version": "14.0 (corro-sim)",
            "server_encoding": "UTF8",
            "client_encoding": "UTF8",
            "DateStyle": "ISO, MDY",
            "integer_datetimes": "on",
            "standard_conforming_strings": "on",
            "TimeZone": "UTC",
            "is_superuser": "on",
        }

    # --------------------------------------------------------------- io
    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def send(self, *msgs: bytes) -> None:
        self.sock.sendall(b"".join(msgs))

    def tx_status(self) -> bytes:
        if self.tx_writes is None:
            return b"I"
        return b"E" if self.tx_failed else b"T"

    # ------------------------------------------------------------ startup
    def startup(self) -> bool:
        while True:
            (length,) = struct.unpack("!I", self._read_exact(4))
            body = self._read_exact(length - 4)
            (code_,) = struct.unpack("!I", body[:4])
            if code_ in (SSL_REQUEST, GSSENC_REQUEST):
                self.sock.sendall(b"N")  # no TLS on this listener
                continue
            if code_ == CANCEL_REQUEST:
                return False
            if code_ != PROTO_V3:
                self.send(msg_error(sqlstate("protocol_violation"),
                                    f"unsupported protocol {code_}"))
                return False
            kv = body[4:].split(b"\x00")
            opts = {}
            for k, v in zip(kv[::2], kv[1::2]):
                if k:
                    opts[k.decode()] = v.decode()
            db = opts.get("database", "")
            m = re.fullmatch(r"node(\d+)", db)
            if m:
                node = int(m.group(1))
                if not (0 <= node < self.cluster.cfg.num_nodes):
                    self.send(msg_error(sqlstate("invalid_catalog_name"),
                                        f'database "{db}" does not exist'))
                    return False
                self.node = node
            out = [msg_auth_ok()]
            for k, v in self.params.items():
                out.append(msg_parameter_status(k, v))
            out.append(msg_backend_key(threading.get_ident() & 0x7FFFFFFF,
                                       0x5EED))
            out.append(msg_ready(b"I"))
            self.send(*out)
            return True

    # --------------------------------------------------------- execution
    def _fields_for_select(self, select, cols: list) -> list:
        t = self.cluster.layout.schema.tables.get(select.table)
        by_name = {c.name: c for c in t.columns} if t else {}
        fields = []
        for c in cols:
            col = by_name.get(c)
            fields.append((c, _affinity_oid(col.type) if col else OID_TEXT))
        return fields

    @staticmethod
    def _strip_catalog_schema(sql: str) -> str:
        # only in table position, so a 'pg_catalog.x' string literal survives
        return re.sub(r"(\bFROM\s+)pg_catalog\.", r"\1", sql,
                      flags=re.IGNORECASE)

    def run_select(self, sql: str):
        """→ (fields [(name, oid)], rows [list])"""
        sql = self._strip_catalog_schema(sql)
        try:
            select = parse_query(sql)
        except QueryError as e:
            raise PgError("syntax_error", str(e)) from None
        if select.table in _CATALOG_NAMES:
            all_cols, all_rows, all_oids = \
                _catalog_tables(self.cluster)[select.table]
            cols = list(select.columns) if select.columns else all_cols
            idx = {}
            for c in cols:
                if c not in all_cols:
                    raise PgError("undefined_column",
                                  f'column "{c}" does not exist')
                idx[c] = all_cols.index(c)
            rows = []
            col_pos = {c: i for i, c in enumerate(all_cols)}
            for r in all_rows:
                # unmodeled catalog columns read as NULL (drivers probe
                # many pg_catalog columns; erroring would break them)
                get = lambda name: (  # noqa: E731
                    r[col_pos[name]] if name in col_pos else None)
                if select.where is not None and not eval_predicate_py(
                        select.where, get):
                    continue
                rows.append([r[idx[c]] for c in cols])
            fields = [(c, all_oids[idx[c]]) for c in cols]
            return fields, rows
        try:
            cols, rows = self.cluster.query_rows(
                sql, node=self.node, overlay=self._tx_overlay()
            )
        except (QueryError, SchemaError) as e:
            msg = str(e)
            cond = ("undefined_table" if "no such table" in msg
                    else "undefined_column" if "column" in msg
                    else "syntax_error")
            raise PgError(cond, msg) from None
        except KeyError as e:
            raise PgError("undefined_table",
                          f"relation {e} does not exist") from None
        if select.aggregates:
            # post-processed output: cols are already the final labels
            return self._agg_fields(select), rows
        if select.columns:
            # the matcher prepends pk row-key columns (like the reference's
            # injected __corro_pk_* aliases); a pg client gets exactly its
            # projection back
            want = list(select.columns)
            try:
                idx = [cols.index(c) for c in want]
            except ValueError as e:
                raise PgError("undefined_column", str(e)) from None
            rows = [[r[i] for i in idx] for r in rows]
            cols = want
        return self._fields_for_select(select, cols), rows

    def _agg_fields(self, select) -> list:
        """Result fields for an aggregate query, by SQLite type rules:
        COUNT → int8, AVG → float8, SUM/MIN/MAX and group columns → the
        argument column's affinity."""
        t = self.cluster.layout.schema.tables.get(select.table)
        by_name = {c.name: c for c in t.columns} if t else {}

        def col_oid(name):
            c = by_name.get(name)
            return _affinity_oid(c.type) if c else OID_TEXT

        fields = []
        for kind, item in select.items:
            if kind == "col":
                fields.append((item, col_oid(item)))
            elif item.fn == "COUNT":
                fields.append((item.label(), OID_INT8))
            elif item.fn == "AVG":
                fields.append((item.label(), OID_FLOAT8))
            else:  # SUM / MIN / MAX
                fields.append((item.label(), col_oid(item.col)))
        return fields

    def _ov_key(self, n_planned: int):
        cl = self.cluster
        return (
            n_planned,
            getattr(cl.universe, "version", 0),
            cl.layout.generation,
        )

    def _tx_overlay(self):
        """Staged-write overlay of the open transaction, or None.

        Built incrementally as statements buffer (O(1) planning per
        statement — replanning the whole buffer per use made transactions
        quadratic) and replanned wholesale only when a rank respace or a
        schema migration invalidated the staged coordinates. The overlay
        is a snapshot of committed state as of each statement's planning,
        the same visibility a reference SQLite transaction has."""
        if not self.tx_writes:
            return None
        if (
            self._tx_ov is None
            or self._tx_ov_key != self._ov_key(len(self.tx_writes))
        ):
            try:
                self._tx_ov, _ = self.cluster.plan_overlay(
                    self.tx_writes, node=self.node
                )
            except Exception as e:
                self._tx_ov = None
                raise PgError(self._write_cond(e), str(e)) from None
            self._tx_ov_key = self._ov_key(len(self.tx_writes))
        return self._tx_ov

    def run_write(self, sql: str) -> int:
        """Execute (autocommit) or buffer (explicit tx) one DML. Returns
        rows affected (in-tx: counted against the tx's own overlay, so a
        row inserted earlier in the tx is visible to a later UPDATE)."""
        if self.tx_writes is not None:
            base = self._tx_overlay()  # ({}, {}) when first statement
            if base is None:
                base = ({}, {})
            try:
                overlay, counts = self.cluster.plan_overlay(
                    [sql], node=self.node, base=base
                )
            except Exception as e:
                self._tx_ov = None  # base may be half-mutated
                raise PgError(self._write_cond(e), str(e)) from None
            self.tx_writes.append(sql)
            self._tx_ov = overlay
            self._tx_ov_key = self._ov_key(len(self.tx_writes))
            return counts[-1]
        try:
            resp = self.cluster.execute([sql], node=self.node)
        except Exception as e:  # ExecError and friends
            raise PgError(self._write_cond(e), str(e)) from None
        return int(resp["results"][0].get("rows_affected", 0))

    @staticmethod
    def _write_cond(e) -> str:
        msg = str(e)
        if "no such table" in msg:
            return "undefined_table"
        if "column" in msg:
            return "undefined_column"
        if "down" in msg:
            return "cannot_connect_now"
        return "syntax_error"

    def commit_tx(self) -> None:
        writes, self.tx_writes = self.tx_writes, None
        failed, self.tx_failed = self.tx_failed, False
        self._tx_ov = self._tx_ov_key = None
        if failed or not writes:
            return
        try:
            self.cluster.execute(writes, node=self.node)
        except Exception as e:
            raise PgError(self._write_cond(e), str(e)) from None

    def exec_one(self, sql: str) -> list[bytes]:
        """Execute one statement (simple protocol) → wire messages."""
        sql = strip_comments(sql).strip()
        kind = classify(sql)
        if kind == "EMPTY":
            return [_msg(b"I")]
        if self.tx_failed and kind not in ("COMMIT", "ROLLBACK"):
            raise PgError(
                "in_failed_sql_transaction",
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        if kind == "BEGIN":
            if self.tx_writes is not None:
                return [msg_notice(sqlstate("active_sql_transaction"),
                                   "there is already a transaction in "
                                   "progress"),
                        msg_command_complete("BEGIN")]
            self.tx_writes = []
            self.tx_failed = False
            self._tx_ov = self._tx_ov_key = None
            return [msg_command_complete("BEGIN")]
        if kind == "COMMIT":
            was_failed = self.tx_failed
            self.commit_tx()
            return [msg_command_complete(
                "ROLLBACK" if was_failed else "COMMIT")]
        if kind == "ROLLBACK":
            self.tx_writes = None
            self.tx_failed = False
            self._tx_ov = self._tx_ov_key = None
            return [msg_command_complete("ROLLBACK")]
        if kind == "SET":
            return [msg_command_complete("SET")]
        if kind == "SHOW":
            return self._exec_show(sql)
        if kind == "SELECT":
            fields, rows = self.run_select(sql)
            fmts = [0] * len(fields)
            out = [msg_row_description(fields)]
            for r in rows:
                out.append(msg_data_row([
                    _encode_cell(v, fields[i][1], fmts[i])
                    for i, v in enumerate(r)]))
            out.append(msg_command_complete(f"SELECT {len(rows)}"))
            return out
        if kind == "COPY":
            return self._exec_copy(sql)
        if kind in ("INSERT", "UPDATE", "DELETE"):
            n = self.run_write(sql)
            return [msg_command_complete(_TAGS[kind](n))]
        if kind == "CREATE":
            if self.tx_writes is not None:
                # schema changes apply immediately and cannot be rolled
                # back (drops are refused), so refuse transactional DDL
                raise PgError(
                    "active_sql_transaction",
                    "CREATE TABLE cannot run inside a transaction block")
            try:
                self.cluster.migrate(sql)
            except (SchemaError, ValueError) as e:
                raise PgError("invalid_table_definition", str(e)) from None
            return [msg_command_complete("CREATE TABLE")]
        raise PgError("feature_not_supported",
                      f"statement kind {kind} is not supported")

    def _exec_copy(self, sql: str) -> list[bytes]:
        """``COPY (query) TO STDOUT`` / ``COPY table [(cols)] TO STDOUT``
        with ``WITH (FORMAT text|csv [, HEADER])`` — the copy-out half of
        the protocol (CopyOutResponse / CopyData / CopyDone). COPY FROM
        STDIN is not accepted: writes go through INSERT like the
        reference's pg surface (`corro-pg` exposes no COPY either; this
        is the dump/export convenience ORMs and psql's \\copy use)."""
        m = _COPY_RE.match(sql.rstrip().rstrip(";"))
        if m is None:
            if re.search(r"\bFROM\s+STDIN\b", sql, re.IGNORECASE):
                raise PgError("feature_not_supported",
                              "COPY FROM STDIN is not supported; use "
                              "INSERT statements")
            raise PgError("syntax_error", "invalid COPY syntax")
        fmt, header, delim = "text", False, None
        opts_s = (m.group("opts") or "").strip()
        # quote-aware option scan: a comma inside '…' (e.g. DELIMITER ',')
        # must not split the list
        opt_pairs = re.findall(
            r"([A-Za-z_]+)(?:\s+('(?:[^']|'')*'|[^\s,()]+))?\s*(?:,|$)",
            opts_s) if opts_s else []
        if opts_s and sum(
                len(mm[0]) + len(mm[1]) for mm in opt_pairs) == 0:
            raise PgError("syntax_error", "invalid COPY options")
        for k, rawv in opt_pairs:
            k = k.upper()
            v = rawv.strip()
            if v.startswith("'") and v.endswith("'") and len(v) >= 2:
                v = v[1:-1].replace("''", "'")
            if k == "FORMAT":
                if v.lower() not in ("text", "csv"):
                    raise PgError("feature_not_supported",
                                  f'COPY format "{v}" not supported')
                fmt = v.lower()
            elif k == "HEADER":
                header = v.lower() in ("", "true", "on", "1")
            elif k == "DELIMITER":
                if len(v) != 1:
                    raise PgError("syntax_error",
                                  "COPY delimiter must be a single "
                                  "character")
                # Postgres copy.c rejects these outright: an alphanumeric
                # delimiter would collide with backslash escapes in text
                # format (e.g. data 'n' escaping to \n reads back as a
                # newline), and \r \n \\ . are structurally reserved.
                if v.isalnum() or v in "\\\r\n.":
                    raise PgError(
                        "feature_not_supported",
                        f'COPY delimiter cannot be "{v}"',
                    )
                delim = v
            else:
                raise PgError("syntax_error",
                              f'unrecognized COPY option "{k}"')
        if header and fmt != "csv":
            raise PgError("feature_not_supported",
                          "COPY HEADER available only in CSV mode")
        if m.group("query"):
            query = m.group("query")
        else:
            cols = m.group("cols")
            cols = ", ".join(c.strip() for c in cols.split(",")) \
                if cols else "*"
            query = f"SELECT {cols} FROM {m.group('table')}"
        fields, rows = self.run_select(query)
        delim = delim or ("," if fmt == "csv" else "\t")
        out = [_msg(b"H", struct.pack("!bH", 0, len(fields))
                    + struct.pack(f"!{len(fields)}H", *([0] * len(fields))))]
        if fmt == "csv" and header:
            out.append(_msg(b"d", (delim.join(
                _copy_csv_field(f[0], delim) for f in fields)
                + "\n").encode()))
        enc = _copy_csv_field if fmt == "csv" else _copy_text_field
        for r in rows:
            line = delim.join(enc(v, delim) for v in r)
            out.append(_msg(b"d", (line + "\n").encode()))
        out.append(_msg(b"c"))  # CopyDone
        out.append(msg_command_complete(f"COPY {len(rows)}"))
        return out

    def _exec_show(self, sql: str) -> list[bytes]:
        name = sql.split(None, 1)[1].strip().rstrip(";").lower() \
            if len(sql.split(None, 1)) > 1 else "all"
        if name == "all":
            fields = [("name", OID_TEXT), ("setting", OID_TEXT)]
            out = [msg_row_description(fields)]
            for k, v in sorted(self.params.items()):
                out.append(msg_data_row([k.encode(), v.encode()]))
            out.append(msg_command_complete(f"SHOW {len(self.params)}"))
            return out
        # case-insensitive lookup; "transaction isolation level" special
        if name == "transaction isolation level":
            val = "serializable"
        else:
            val = next((v for k, v in self.params.items()
                        if k.lower() == name), None)
            if val is None:
                raise PgError("cant_change_runtime_param",
                              f'unrecognized configuration parameter '
                              f'"{name}"')
        fields = [(name, OID_TEXT)]
        return [msg_row_description(fields), msg_data_row([val.encode()]),
                msg_command_complete("SHOW 1")]

    # --------------------------------------------------- extended protocol
    def handle_parse(self, body: bytes) -> list[bytes]:
        name, rest = body.split(b"\x00", 1)
        sql, rest = rest.split(b"\x00", 1)
        (n,) = struct.unpack("!H", rest[:2])
        oids = list(struct.unpack(f"!{n}I", rest[2:2 + 4 * n]))
        sql_s = sql.decode()
        stmts = split_statements(sql_s)
        if len(stmts) > 1:
            raise PgError("syntax_error",
                          "cannot insert multiple commands into a prepared "
                          "statement")
        one = strip_comments(stmts[0]).strip() if stmts else ""
        kind = classify(one)
        if kind not in ("SELECT", "INSERT", "UPDATE", "DELETE", "BEGIN",
                        "COMMIT", "ROLLBACK", "SET", "SHOW", "EMPTY",
                        "CREATE"):
            raise PgError("feature_not_supported",
                          f"cannot prepare statement kind {kind}")
        # infer unspecified param oids as 0 (decoded as unknown/text)
        n_params = count_params(one)
        while len(oids) < n_params:
            oids.append(0)
        self.prepared[name.decode()] = _Prepared(one, kind, oids)
        return [_msg(b"1")]  # ParseComplete

    def handle_bind(self, body: bytes) -> list[bytes]:
        portal, rest = body.split(b"\x00", 1)
        stmt_name, rest = rest.split(b"\x00", 1)
        pos = 0
        (n_fmt,) = struct.unpack_from("!H", rest, pos)
        pos += 2
        fmts = list(struct.unpack_from(f"!{n_fmt}H", rest, pos))
        pos += 2 * n_fmt
        (n_params,) = struct.unpack_from("!H", rest, pos)
        pos += 2
        prepped = self.prepared.get(stmt_name.decode())
        if prepped is None:
            raise PgError("invalid_sql_statement_name",
                          f'prepared statement "{stmt_name.decode()}" '
                          "does not exist")
        params = []
        for i in range(n_params):
            (plen,) = struct.unpack_from("!i", rest, pos)
            pos += 4
            raw = None
            if plen >= 0:
                raw = rest[pos:pos + plen]
                pos += plen
            fmt = fmts[i] if i < len(fmts) else (fmts[0] if n_fmt == 1 else 0)
            oid = (prepped.param_oids[i]
                   if i < len(prepped.param_oids) else 0)
            params.append(_decode_param(raw, oid, fmt))
        (n_rfmt,) = struct.unpack_from("!H", rest, pos)
        pos += 2
        rfmts = list(struct.unpack_from(f"!{n_rfmt}H", rest, pos))
        if len(params) < len(prepped.param_oids):
            raise PgError(
                "protocol_violation",
                f"bind message supplies {len(params)} parameters, but "
                f"prepared statement requires {len(prepped.param_oids)}")
        try:
            bound = bind_params(prepped.sql, params) if params \
                else prepped.sql
        except StatementError as e:
            raise PgError("undefined_parameter", str(e)) from None
        self.portals[portal.decode()] = _Portal(prepped, bound, rfmts)
        return [_msg(b"2")]  # BindComplete

    def _describe_fields(self, prepped: _Prepared, sql: str):
        if prepped.kind == "SELECT":
            try:
                select = parse_query(self._strip_catalog_schema(sql))
            except QueryError:
                return None
            if select.table in _CATALOG_NAMES:
                all_cols, _, all_oids = \
                    _catalog_tables(self.cluster)[select.table]
                cols = list(select.columns) if select.columns else all_cols
                for c in cols:
                    if c not in all_cols:
                        raise PgError("undefined_column",
                                      f'column "{c}" does not exist')
                return [(c, all_oids[all_cols.index(c)]) for c in cols]
            t = self.cluster.layout.schema.tables.get(select.table)
            if t is None:
                raise PgError("undefined_table",
                              f'relation "{select.table}" does not exist')
            if select.aggregates:
                return self._agg_fields(select)
            if select.columns:
                cols = list(select.columns)
            else:
                # SELECT *: the matcher emits pk row-key columns first,
                # then value columns — Describe must promise that order
                cols = list(t.pk) + [c.name for c in t.value_columns]
            return self._fields_for_select(select, cols)
        if prepped.kind == "SHOW":
            name = sql.split(None, 1)[1].strip().rstrip(";").lower() \
                if len(sql.split(None, 1)) > 1 else "all"
            if name == "all":
                return [("name", OID_TEXT), ("setting", OID_TEXT)]
            # real Postgres names the column after the parameter, and
            # _exec_show's data path does too — Describe must agree
            return [(name, OID_TEXT)]
        return None

    def handle_describe(self, body: bytes) -> list[bytes]:
        target = body[0:1]
        name = body[1:].split(b"\x00", 1)[0].decode()
        if target == b"S":
            prepped = self.prepared.get(name)
            if prepped is None:
                raise PgError("invalid_sql_statement_name",
                              f'prepared statement "{name}" does not exist')
            out = [msg_parameter_description(prepped.param_oids)]
            fields = self._describe_fields(prepped, prepped.sql)
            out.append(msg_row_description(fields) if fields else _msg(b"n"))
            return out
        portal = self.portals.get(name)
        if portal is None:
            raise PgError("invalid_cursor_name",
                          f'portal "{name}" does not exist')
        fields = self._describe_fields(portal.stmt, portal.bound_sql)
        return [msg_row_description(fields) if fields else _msg(b"n")]

    def handle_execute(self, body: bytes) -> list[bytes]:
        name, rest = body.split(b"\x00", 1)
        (max_rows,) = struct.unpack("!I", rest[:4])
        portal = self.portals.get(name.decode())
        if portal is None:
            raise PgError("invalid_cursor_name",
                          f'portal "{name.decode()}" does not exist')
        prepped = portal.stmt
        if self.tx_failed and prepped.kind not in ("COMMIT", "ROLLBACK"):
            raise PgError(
                "in_failed_sql_transaction",
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        if prepped.kind in ("SELECT", "SHOW"):
            if portal.rows is None:
                if prepped.kind == "SHOW":
                    msgs = self._exec_show(portal.bound_sql)
                    # re-use simple-path encoding: rows are already wire
                    # messages; strip RowDescription (Describe sends it)
                    portal.rows = [m for m in msgs if m[0:1] == b"D"]
                    portal.fields = []
                else:
                    fields, rows = self.run_select(portal.bound_sql)
                    fmts = portal.result_formats or [0] * len(fields)
                    if len(fmts) == 1:
                        fmts = fmts * len(fields)
                    portal.fields = fields
                    portal.rows = [msg_data_row([
                        _encode_cell(v, fields[i][1],
                                     fmts[i] if i < len(fmts) else 0)
                        for i, v in enumerate(r)]) for r in rows]
                portal.pos = 0
            out = []
            end = len(portal.rows) if max_rows == 0 \
                else min(portal.pos + max_rows, len(portal.rows))
            out.extend(portal.rows[portal.pos:end])
            n_sent = end - portal.pos
            portal.pos = end
            portal.tag_n += n_sent
            if end < len(portal.rows):
                out.append(_msg(b"s"))  # PortalSuspended
            else:
                out.append(msg_command_complete(
                    f"SELECT {portal.tag_n}" if prepped.kind == "SELECT"
                    else "SHOW"))
            return out
        sql = portal.bound_sql
        # non-row statements run through the simple-path machinery, minus
        # the RowDescription (extended protocol sends it via Describe)
        return [m for m in self.exec_one(sql) if m[0:1] != b"T"]

    def handle_close(self, body: bytes) -> list[bytes]:
        target = body[0:1]
        name = body[1:].split(b"\x00", 1)[0].decode()
        if target == b"S":
            self.prepared.pop(name, None)
        else:
            self.portals.pop(name, None)
        return [_msg(b"3")]  # CloseComplete

    # ---------------------------------------------------------- main loop
    def serve(self) -> None:
        import time as _time

        _histograms = getattr(
            self.cluster, "histograms", None
        )
        if _histograms is None:
            from corro_sim_torch.utils.metrics import histograms as _histograms

        _t0 = _time.perf_counter()
        if not self.startup():
            return
        # wire-session establishment (pgwire startup handshake) — the
        # corro.transport.connect.time.seconds analog
        _histograms.observe(
            "corro_transport_connect_time_seconds",
            _time.perf_counter() - _t0,
            help_="wire-session establishment time (pgwire startup; "
                  "corro.transport.connect.time.seconds analog)",
        )
        buffered: list[bytes] = []
        skip_to_sync = False
        while True:
            tag = self._read_exact(1)
            (length,) = struct.unpack("!I", self._read_exact(4))
            body = self._read_exact(length - 4)
            if tag == b"X":
                return
            if tag == b"Q":
                buffered = []
                skip_to_sync = False
                out = []
                try:
                    stmts = split_statements(body.split(b"\x00", 1)[0]
                                             .decode())
                    if not stmts:
                        out.append(_msg(b"I"))
                    for s in stmts:
                        out.extend(self.exec_one(s))
                except PgError as e:
                    if self.tx_writes is not None:
                        self.tx_failed = True
                    out.append(msg_error(e.code, str(e)))
                except Exception as e:  # internal
                    if self.tx_writes is not None:
                        self.tx_failed = True
                    out.append(msg_error(sqlstate("internal_error"), str(e)))
                out.append(msg_ready(self.tx_status()))
                self.send(*out)
                continue
            if tag == b"S":  # Sync
                buffered.append(msg_ready(self.tx_status()))
                self.send(*buffered)
                buffered = []
                skip_to_sync = False
                continue
            if tag == b"H":  # Flush
                if buffered:
                    self.send(*buffered)
                    buffered = []
                continue
            if skip_to_sync:
                continue
            try:
                if tag == b"P":
                    buffered.extend(self.handle_parse(body))
                elif tag == b"B":
                    buffered.extend(self.handle_bind(body))
                elif tag == b"D":
                    buffered.extend(self.handle_describe(body))
                elif tag == b"E":
                    buffered.extend(self.handle_execute(body))
                elif tag == b"C":
                    buffered.extend(self.handle_close(body))
                else:
                    raise PgError("protocol_violation",
                                  f"unexpected message {tag!r}")
            except PgError as e:
                if self.tx_writes is not None:
                    self.tx_failed = True
                buffered.append(msg_error(e.code, str(e)))
                skip_to_sync = True
            except Exception as e:
                if self.tx_writes is not None:
                    self.tx_failed = True
                buffered.append(msg_error(sqlstate("internal_error"),
                                          str(e)))
                skip_to_sync = True


# ----------------------------------------------------------------- server


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            _Session(self.server.pg, self.request).serve()
        except (ConnectionError, OSError):
            pass


class _TcpServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PgServer:
    """The pg-wire listener (reference: `corro_pg::start`, lib.rs:469)."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster
        self._srv = _TcpServer((host, port), _Handler, bind_and_activate=True)
        self._srv.pg = self
        self._thread = None

    @property
    def addr(self) -> tuple[str, int]:
        return self._srv.server_address[:2]

    def start(self) -> "PgServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="pg-server", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------- minimal client
# (test/tooling helper: enough pgwire to talk to any v3 server)


class SimplePgClient:
    """A tiny blocking pgwire-v3 client for tests and the CLI.

    Speaks both the simple and extended protocols; returns rows as Python
    values (text-format decode by OID)."""

    def __init__(self, host: str, port: int, database: str = "corro",
                 user: str = "corro"):
        self.sock = socket.create_connection((host, port))
        self._send_startup(database, user)
        self.params: dict[str, str] = {}
        self.notices: list = []
        self._drain_until_ready()

    def _send_startup(self, database, user):
        body = struct.pack("!I", PROTO_V3)
        body += _cstr("user") + _cstr(user)
        body += _cstr("database") + _cstr(database)
        body += b"\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)

    def _read_exact(self, n):
        buf = b""
        while len(buf) < n:
            c = self.sock.recv(n - len(buf))
            if not c:
                raise ConnectionError("server closed")
            buf += c
        return buf

    def read_msg(self):
        tag = self._read_exact(1)
        (length,) = struct.unpack("!I", self._read_exact(4))
        return tag, self._read_exact(length - 4)

    def _drain_until_ready(self):
        msgs = []
        while True:
            tag, body = self.read_msg()
            msgs.append((tag, body))
            if tag == b"S":
                k, v = body.split(b"\x00")[:2]
                self.params[k.decode()] = v.decode()
            if tag == b"Z":
                self.status = body
                return msgs

    @staticmethod
    def _decode_row(body, fields):
        (n,) = struct.unpack_from("!H", body, 0)
        pos = 2
        out = []
        for i in range(n):
            (plen,) = struct.unpack_from("!i", body, pos)
            pos += 4
            if plen < 0:
                out.append(None)
                continue
            raw = body[pos:pos + plen]
            pos += plen
            oid = fields[i][1] if i < len(fields) else OID_TEXT
            out.append(_decode_param(raw, oid, 0))
        return out

    @staticmethod
    def _parse_fields(body):
        (n,) = struct.unpack_from("!H", body, 0)
        pos = 2
        fields = []
        for _ in range(n):
            end = body.index(b"\x00", pos)
            name = body[pos:end].decode()
            pos = end + 1
            _, _, oid, _, _, _ = struct.unpack_from("!IHIhih", body, pos)
            pos += 18
            fields.append((name, oid))
        return fields

    def query(self, sql: str):
        """Simple protocol. Returns (fields, rows, tags, errors).

        COPY TO STDOUT data lines land in ``self.copy_lines`` (one str
        per CopyData message, trailing newline stripped)."""
        body = _cstr(sql)
        self.sock.sendall(_msg(b"Q", body))
        fields, rows, tags, errors = [], [], [], []
        self.copy_lines: list[str] = []
        while True:
            tag, b = self.read_msg()
            if tag == b"T":
                fields = self._parse_fields(b)
            elif tag == b"D":
                rows.append(self._decode_row(b, fields))
            elif tag == b"d":  # CopyData
                self.copy_lines.append(b.decode().rstrip("\n"))
            elif tag == b"C":
                tags.append(b.rstrip(b"\x00").decode())
            elif tag == b"E":
                errors.append(self._parse_error(b))
            elif tag == b"Z":
                self.status = b
                return fields, rows, tags, errors

    @staticmethod
    def _parse_error(body) -> dict:
        out = {}
        pos = 0
        while pos < len(body) and body[pos:pos + 1] != b"\x00":
            f = body[pos:pos + 1].decode()
            end = body.index(b"\x00", pos + 1)
            out[f] = body[pos + 1:end].decode()
            pos = end + 1
        return out

    def extended(self, sql: str, params=(), param_oids=(), max_rows=0,
                 binary_results=False):
        """Parse/Bind/Describe/Execute/Sync round. Returns
        (fields, rows, tags, errors, suspended) — ``suspended`` is True
        when a row-limited Execute left the portal resumable."""
        msgs = []
        oids = list(param_oids)
        msgs.append(_msg(b"P", _cstr("") + _cstr(sql)
                         + struct.pack("!H", len(oids))
                         + b"".join(struct.pack("!I", o) for o in oids)))
        pb = [_cstr(""), _cstr(""), struct.pack("!H", 0),
              struct.pack("!H", len(params))]
        for p in params:
            if p is None:
                pb.append(struct.pack("!i", -1))
            else:
                raw = (str(p).encode() if not isinstance(p, bytes)
                       else b"\\x" + p.hex().encode())
                pb.append(struct.pack("!I", len(raw)) + raw)
        pb.append(struct.pack("!HH", 1, 1 if binary_results else 0))
        msgs.append(_msg(b"B", b"".join(pb)))
        msgs.append(_msg(b"D", b"P" + _cstr("")))
        msgs.append(_msg(b"E", _cstr("") + struct.pack("!I", max_rows)))
        msgs.append(_msg(b"S"))
        self.sock.sendall(b"".join(msgs))
        fields, rows, tags, errors = [], [], [], []
        suspended = False
        while True:
            tag, b = self.read_msg()
            if tag == b"T":
                fields = self._parse_fields(b)
            elif tag == b"D":
                rows.append(self._decode_row(b, fields)
                            if not binary_results else (b, fields))
            elif tag == b"C":
                tags.append(b.rstrip(b"\x00").decode())
            elif tag == b"s":
                suspended = True
            elif tag == b"E":
                errors.append(self._parse_error(b))
            elif tag == b"Z":
                self.status = b
                return fields, rows, tags, errors, suspended

    def close(self):
        try:
            self.sock.sendall(_msg(b"X"))
        except OSError:
            pass
        self.sock.close()
