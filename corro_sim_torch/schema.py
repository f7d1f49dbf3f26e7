"""Schema manager: DDL → table/column model → tensor layout.

Port of ``corro_sim/schema.py`` (standard library only). Mirrors the
reference's schema subsystem (``corro-types/src/schema.rs``):

- parse CREATE TABLE/INDEX statements into ``Schema{tables}`` with per-table
  pk and column metadata (reference: sqlite3-parser AST → ``Table{pk,
  columns, indexes}``, ``schema.rs:79-112``). Here the "parser" is SQLite
  itself: the DDL executes against a throwaway in-memory database and the
  model is read back via pragma introspection — real affinity resolution
  (``schema.rs:803-834``) for free.
- ``constrain`` enforces the replication-safety rules (``schema.rs:115-172``):
  no unique indexes, no foreign keys, non-nullable non-pk columns need a
  default, and internal table names are stripped.
- ``apply_schema`` computes a diff-based migration plan
  (``schema.rs:274-646``): new tables are created, new columns added (must
  be nullable or defaulted — the ALTER constraint), changed columns trigger
  a table rebuild, and destructive changes (dropped tables/columns, pk
  changes) are refused.

Tensor mapping: a :class:`TableLayout` assigns every table a contiguous row-
slot range and every replicated column a plane index, embedding a
multi-table schema into the single (nodes, rows, cols) ``TableState``
tensor. Layouts extend monotonically across migrations — existing slots
never move, so a running simulation can adopt a migrated schema without
reshuffling state (the moral of the reference's in-place ``crsql_as_crr``
migration path).
"""

from __future__ import annotations

import dataclasses
import sqlite3

from corro_sim_torch.io.values import sqlite_sort_key


class SchemaError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    type: str  # declared type, upper-cased ("" when untyped)
    nullable: bool
    default: object  # raw default SQL literal or None
    primary_key: bool
    generated: bool  # generated columns are not replicated

    @property
    def default_value(self):
        """The DEFAULT as a Python value (``PRAGMA table_xinfo`` hands back
        the raw SQL expression text: ``''``, ``0``, ``'[]'`` …). Literal
        NULL and unsupported expressions decode to None."""
        d = self.default
        if d is None or not isinstance(d, str):
            return d
        s = d.strip()
        up = s.upper()
        if up == "NULL":
            return None
        if up == "TRUE":  # SQLite materializes boolean keywords as 1/0
            return 1
        if up == "FALSE":
            return 0
        if len(s) >= 2 and s[0] == "'" and s[-1] == "'":
            return s[1:-1].replace("''", "'")
        try:
            return int(s)
        except ValueError:
            pass
        try:
            return float(s)
        except ValueError:
            return None  # expression defaults are not evaluated


@dataclasses.dataclass(frozen=True)
class Table:
    name: str
    columns: tuple  # all Columns in declaration order
    pk: tuple  # pk column names in pk order
    indexes: tuple  # (name, unique) pairs

    @property
    def value_columns(self) -> tuple:
        """Replicated (non-pk, non-generated) columns — the CRDT cells."""
        return tuple(
            c for c in self.columns if not c.primary_key and not c.generated
        )


@dataclasses.dataclass(frozen=True)
class Schema:
    tables: dict  # name -> Table (insertion-ordered)

    def __iter__(self):
        return iter(self.tables.values())


_INTERNAL_PREFIXES = ("__corro", "sqlite_")


def _is_internal(name: str) -> bool:
    return name.startswith(_INTERNAL_PREFIXES) or "crsql" in name


def parse_schema(sql: str) -> Schema:
    """Execute DDL in a scratch SQLite and introspect the result."""
    conn = sqlite3.connect(":memory:")
    try:
        try:
            conn.executescript(sql)
        except sqlite3.Error as e:
            raise SchemaError(f"DDL failed: {e}") from e
        tables = {}
        rows = conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY rowid"
        ).fetchall()
        for (name,) in rows:
            if _is_internal(name):
                continue
            cols = []
            pk_ordered = []
            for (
                _cid, cname, ctype, notnull, dflt, pk, hidden,
            ) in conn.execute(f"PRAGMA table_xinfo({_q(name)})"):
                if hidden == 1:
                    continue
                cols.append(
                    Column(
                        name=cname,
                        type=(ctype or "").upper(),
                        nullable=not notnull,
                        default=dflt,
                        primary_key=pk > 0,
                        generated=hidden in (2, 3),
                    )
                )
                if pk > 0:
                    pk_ordered.append((pk, cname))
            indexes = []
            for (_seq, iname, unique, origin, _partial) in conn.execute(
                f"PRAGMA index_list({_q(name)})"
            ):
                if origin == "pk":
                    continue
                indexes.append((iname, bool(unique)))
            fks = conn.execute(
                f"PRAGMA foreign_key_list({_q(name)})"
            ).fetchall()
            if fks:
                raise SchemaError(
                    f"foreign keys are not replicatable: table {name!r}"
                )
            tables[name] = Table(
                name=name,
                columns=tuple(cols),
                pk=tuple(c for _, c in sorted(pk_ordered)),
                indexes=tuple(indexes),
            )
        return Schema(tables=tables)
    finally:
        conn.close()


def _q(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


def constrain(schema: Schema) -> Schema:
    """The reference's replication-safety checks (``schema.rs:115-172``)."""
    for t in schema:
        if not t.pk:
            raise SchemaError(f"table {t.name!r} has no primary key")
        for iname, unique in t.indexes:
            if unique:
                raise SchemaError(
                    f"unique index {iname!r} on {t.name!r}: uniqueness "
                    "cannot be enforced across actors"
                )
        for c in t.columns:
            if (
                not c.primary_key
                and not c.generated
                and not c.nullable
                and c.default is None
            ):
                raise SchemaError(
                    f"column {t.name}.{c.name} is NOT NULL without a "
                    "default — concurrent row merges could not fill it"
                )
    return schema


def parse_and_constrain(sql: str) -> Schema:
    return constrain(parse_schema(sql))


def schema_from_history(history) -> Schema:
    """Fold a migration history (list of DDL texts) into the live schema.

    Each entry merges into the accumulated schema the same way
    ``LiveCluster.migrate`` does (``execute_schema`` merge semantics,
    ``api/public/mod.rs:443-528``): tables an entry doesn't mention are
    retained. Checkpoint restore replays the whole history — the last
    entry alone may be a partial migration."""
    schema = None
    for sql in history:
        new = parse_and_constrain(sql)
        if schema is None:
            schema = new
        else:
            schema = dataclasses.replace(
                new, tables={**schema.tables, **new.tables}
            )
    if schema is None:
        raise SchemaError("empty schema history")
    return schema


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    new_tables: tuple  # table names
    new_columns: tuple  # (table, column) pairs
    rebuilt_tables: tuple  # tables whose existing columns changed


def apply_schema(old: Schema, new: Schema) -> MigrationPlan:
    """Diff old → new; refuse destructive changes (``schema.rs:274-646``)."""
    constrain(new)
    dropped = set(old.tables) - set(new.tables)
    if dropped:
        raise SchemaError(f"cannot drop tables: {sorted(dropped)}")
    new_tables = []
    new_columns = []
    rebuilt = []
    for name, nt in new.tables.items():
        ot = old.tables.get(name)
        if ot is None:
            new_tables.append(name)
            continue
        if ot.pk != nt.pk:
            raise SchemaError(f"cannot change primary key of {name!r}")
        old_cols = {c.name: c for c in ot.columns}
        new_cols = {c.name: c for c in nt.columns}
        gone = set(old_cols) - set(new_cols)
        if gone:
            raise SchemaError(
                f"cannot drop columns from {name!r}: {sorted(gone)}"
            )
        changed = False
        for cname, nc in new_cols.items():
            oc = old_cols.get(cname)
            if oc is None:
                if nc.generated:
                    continue  # generated columns are not replicated
                if not nc.nullable and nc.default is None:
                    raise SchemaError(
                        f"new column {name}.{cname} must be nullable or "
                        "have a default"
                    )
                new_columns.append((name, cname))
            elif oc != nc:
                changed = True
        if changed:
            rebuilt.append(name)
    return MigrationPlan(
        new_tables=tuple(new_tables),
        new_columns=tuple(new_columns),
        rebuilt_tables=tuple(rebuilt),
    )


class TableLayout:
    """Embeds a multi-table schema into the (rows, cols) tensor planes.

    Each table owns a contiguous row-slot range of size ``capacity`` (its
    pk universe for the run — static shapes) and maps its value columns to
    plane indices ``0..len(value_columns)``. Row slots inside a range are
    allocated to pk tuples on first sight. Layouts only ever grow:
    migrations append ranges/planes, existing coordinates are stable.
    """

    def __init__(self, schema: Schema, capacities=None, default_capacity=256):
        self.schema = schema
        self._ranges: dict[str, tuple[int, int]] = {}  # table -> (start, cap)
        self._used: dict[str, int] = {}  # table -> allocated slot count
        self._cols: dict[tuple, int] = {}  # (table, column) -> plane
        self._slots: dict[tuple, int] = {}  # (table, pk tuple) -> row slot
        self._by_slot: dict[int, tuple] = {}  # row slot -> (table, pk)
        self._next_row = 0
        self.default_capacity = default_capacity
        self.generation = 0  # bumped on every slot allocation / migration
        # (lets cached host-side pk masks invalidate cheaply)
        for t in schema:
            self._add_table(t, (capacities or {}).get(t.name, default_capacity))

    def _add_table(self, t: Table, cap: int):
        self._ranges[t.name] = (self._next_row, cap)
        self._used[t.name] = 0
        self._next_row += cap
        for i, c in enumerate(t.value_columns):
            self._cols[(t.name, c.name)] = i

    @property
    def num_rows(self) -> int:
        return max(1, self._next_row)

    @property
    def num_cols(self) -> int:
        per_table = {}
        for (tname, _), i in self._cols.items():
            per_table[tname] = max(per_table.get(tname, 0), i + 1)
        return max(per_table.values(), default=1)

    def col_index(self, table: str, column: str) -> int:
        try:
            return self._cols[(table, column)]
        except KeyError:
            raise SchemaError(f"no such column {table}.{column}") from None

    def row_slot(self, table: str, pk: tuple) -> int:
        """Slot for a pk tuple; allocates on first sight, refuses overflow."""
        key = (table, pk)
        slot = self._slots.get(key)
        if slot is None:
            start, cap = self._range(table)
            used = self._used[table]
            if used >= cap:
                raise SchemaError(
                    f"table {table!r} pk universe exceeds capacity {cap}"
                )
            slot = start + used
            self._slots[key] = slot
            self._by_slot[slot] = key
            self._used[table] = used + 1
            self.generation += 1
        return slot

    def key_of(self, slot: int):
        """(table, pk) owning a row slot, or None if unallocated."""
        return self._by_slot.get(slot)

    def _range(self, table: str):
        try:
            return self._ranges[table]
        except KeyError:
            raise SchemaError(f"no such table {table!r}") from None

    def row_keys(self) -> list:
        """slot → (table, pk) for every allocated slot, slot-ordered."""
        return [k for k, _ in sorted(self._slots.items(), key=lambda kv: kv[1])]

    def migrate(self, new_schema: Schema, capacities=None) -> MigrationPlan:
        """Adopt a migrated schema; allocations are append-only."""
        plan = apply_schema(self.schema, new_schema)
        for name in plan.new_tables:
            self._add_table(
                new_schema.tables[name],
                (capacities or {}).get(name, self.default_capacity),
            )
        for name, cname in plan.new_columns:
            t = new_schema.tables[name]
            existing = [i for (tn, _), i in self._cols.items() if tn == name]
            nxt = max(existing, default=-1) + 1
            # preserve already-assigned planes; only the new column appends
            if (name, cname) not in self._cols:
                self._cols[(name, cname)] = nxt
        self.schema = new_schema
        self.generation += 1
        return plan

    def sorted_pks(self, table: str) -> list:
        """Allocated pks of a table in SQLite value order (query surface)."""
        pks = [pk for (t, pk) in self._slots if t == table]
        return sorted(pks, key=lambda pk: tuple(sqlite_sort_key(p) for p in pk))


# ---------------------------------------------------------------- builtins

def consul_schema_sql() -> str:
    """The Consul service-discovery schema (BASELINE config 3) — the same
    tables the reference's consul sync daemon maintains
    (``corrosion/src/command/consul/sync.rs:749-773``)."""
    return """
    CREATE TABLE consul_services (
        node TEXT NOT NULL,
        id TEXT NOT NULL,
        name TEXT NOT NULL DEFAULT '',
        tags TEXT NOT NULL DEFAULT '[]',
        meta TEXT NOT NULL DEFAULT '{}',
        port INTEGER NOT NULL DEFAULT 0,
        address TEXT NOT NULL DEFAULT '',
        updated_at INTEGER NOT NULL DEFAULT 0,
        app_id INTEGER AS (CAST(JSON_EXTRACT(meta, '$.app_id') AS INTEGER)),
        PRIMARY KEY (node, id)
    );
    CREATE TABLE consul_checks (
        node TEXT NOT NULL,
        id TEXT NOT NULL,
        service_id TEXT NOT NULL DEFAULT '',
        service_name TEXT NOT NULL DEFAULT '',
        name TEXT NOT NULL DEFAULT '',
        status TEXT NOT NULL DEFAULT '',
        output TEXT NOT NULL DEFAULT '',
        updated_at INTEGER NOT NULL DEFAULT 0,
        PRIMARY KEY (node, id)
    );
    """


def test_schema_sql() -> str:
    """Six-table fixture schema shaped like the reference's TEST_SCHEMA
    (``corro-tests/src/lib.rs:13-53``), incl. a composite-pk wide table."""
    return """
    CREATE TABLE tests (
        id INTEGER NOT NULL PRIMARY KEY,
        text TEXT NOT NULL DEFAULT ''
    ) WITHOUT ROWID;
    CREATE TABLE tests2 (
        id INTEGER NOT NULL PRIMARY KEY,
        text TEXT NOT NULL DEFAULT ''
    ) WITHOUT ROWID;
    CREATE TABLE tests3 (
        id INTEGER NOT NULL PRIMARY KEY,
        text TEXT NOT NULL DEFAULT '',
        text2 TEXT NOT NULL DEFAULT '',
        num INTEGER NOT NULL DEFAULT 0,
        num2 INTEGER NOT NULL DEFAULT 0
    ) WITHOUT ROWID;
    CREATE TABLE testsblob (
        id BLOB NOT NULL PRIMARY KEY,
        text TEXT NOT NULL DEFAULT ''
    ) WITHOUT ROWID;
    CREATE TABLE testsbool (
        id INTEGER NOT NULL PRIMARY KEY,
        b BOOLEAN NOT NULL DEFAULT FALSE
    );
    CREATE TABLE wide (
        id1 BLOB NOT NULL,
        id2 TEXT NOT NULL,
        int INTEGER NOT NULL DEFAULT 1,
        float REAL NOT NULL DEFAULT 1.0,
        blob BLOB,
        PRIMARY KEY (id1, id2)
    );
    """
