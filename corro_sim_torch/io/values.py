"""Value interning: SQLite values → dense int32 ranks, order-preserving.

Port of what trace ingest needs of ``corro_sim/io/values.py``. The
merge compares int32 *value ranks* (:mod:`corro_sim_torch.core.crdt`), so
interning must assign ranks whose ORDER matches the conflict comparison
the real CR-SQLite extension performs on an equal-``col_version`` tie:
the SQLite type code first (descending — lower type code wins), then the
value, giving the total order

    NULL < BLOB (memcmp) < TEXT (memcmp) < REAL (numeric) < INTEGER

with INTEGER and REAL in *separate bands* (int 3 beats float 3.0).
SQL-visible comparisons follow SQLite's own order — NULL < numerics
(int/real interleaved numerically) < TEXT < BLOB — via
:func:`sqlite_sort_key`. The wire shape being interned is the
reference's ``SqliteValue`` tagged union
(``corro-api-types/src/lib.rs:455-715``).
"""

from __future__ import annotations

# conflict-order bands (see module docstring)
B_NULL, B_BLOB, B_TEXT, B_FLOAT, B_INT = 0, 1, 2, 3, 4


def sqlite_sort_key(value):
    """Total-order sort key matching SQLite's cross-type value comparison
    (the SQL-visible order: WHERE/ORDER BY/min()/max() semantics)."""
    if value is None:
        return (0,)
    if isinstance(value, bool):  # JSON true/false arrive as ints in SQLite
        return (1, float(int(value)))
    if isinstance(value, (int, float)):
        return (1, float(value))
    if isinstance(value, str):
        return (2, value.encode("utf-8"))
    if isinstance(value, (bytes, bytearray)):
        return (3, bytes(value))
    raise TypeError(f"not a SQLite value: {type(value)!r}")


def crsql_conflict_key(value):
    """Total-order sort key matching the extension's equal-col_version
    conflict comparison (type-code descending, then natural within-type).
    Also the dict key for interning: it distinguishes int 3 from float
    3.0, which the conflict order treats as different values."""
    if value is None:
        return (B_NULL,)
    if isinstance(value, bool):
        return (B_INT, int(value))
    if isinstance(value, int):
        return (B_INT, value)
    if isinstance(value, float):
        return (B_FLOAT, value)
    if isinstance(value, str):
        return (B_TEXT, value.encode("utf-8"))
    if isinstance(value, (bytes, bytearray)):
        return (B_BLOB, bytes(value))
    raise TypeError(f"not a SQLite value: {type(value)!r}")


class ValueInterner:
    """Assigns conflict-order-preserving dense ranks to a closed set of
    values (rank order == the extension's equal-cv conflict order, so the
    merge's integer max IS the CR-SQLite tie-break).

    Two-phase: collect every value appearing in a trace, then
    ``freeze()`` to get ranks (an online order-preserving assignment
    cannot be dense; traces are replayed from files, so the closed-world
    phase is free).
    """

    def __init__(self):
        self._values: dict = {}  # conflict key -> value
        self._ranks: dict | None = None

    def add(self, value) -> None:
        if self._ranks is not None:
            raise RuntimeError("interner is frozen")
        v = _hashable(value)
        self._values[crsql_conflict_key(v)] = v

    def freeze(self) -> None:
        self._ranks = {k: i for i, k in enumerate(sorted(self._values))}

    def rank(self, value) -> int:
        if self._ranks is None:
            raise RuntimeError("freeze() the interner before ranking")
        return self._ranks[crsql_conflict_key(_hashable(value))]

    def __len__(self) -> int:
        return len(self._values)


def _hashable(value):
    if isinstance(value, bytearray):
        return bytes(value)
    return value
