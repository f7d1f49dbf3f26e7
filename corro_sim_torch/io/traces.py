"""Changeset-trace ingestion: `corro-api-types` JSON → replayable arrays.

Port of the batch half of ``corro_sim/io/traces.py``. A trace is
ND-JSON, one line per broadcast changeset, in the serde JSON shapes of
the reference wire types:

- a **Full** changeset (``Changeset::Full``,
  ``corro-types/src/broadcast.rs:113-132``)::

    {"actor_id": "<uuid>", "version": 3,
     "changes": [{"table": "t", "pk": [u8...], "cid": "c", "val": ...,
                  "col_version": 2, "db_version": 3, "seq": 0,
                  "site_id": [16 x u8], "cl": 1}, ...],
     "seqs": [0, 1], "last_seq": 1, "ts": 123}

  where each element of ``changes`` is a ``Change``
  (``corro-api-types/src/lib.rs:235-245``): ``pk`` is the
  ``pack_columns``-encoded primary-key tuple (decoded by
  :mod:`corro_sim_torch.io.columns`), ``val`` is the untagged
  ``SqliteValue`` JSON (null/int/float/str; blobs as ``{"blob": [u8...]}``),
  and a row DELETE is a cl-only change (``cid == "__crsql_del"``, even
  ``cl``, null ``val`` — the causal-length CRDT, ``doc/crdts.md:13``).

- an **Empty** (cleared) changeset (``Changeset::Empty``)::

    {"actor_id": "<uuid>", "versions": [4, 7], "ts": 124}

  — versions compacted away by overwritten-version clearing
  (``store_empty_changeset``, ``corro-types/src/change.rs:267-389``);
  they fast-forward bookkeeping but carry no cells.

Ingestion is two-phase (closed world, like
:class:`~corro_sim_torch.io.values.ValueInterner`): scan every line to
discover actors, tables, pk universes and values; then encode dense
per-round injection arrays — round ``r`` carries version ``r+1`` of every
actor, the per-actor serialization the reference gets from its single
write connection (``corro-types/src/agent.rs:500-731``).

Schema-driven ingest (``layout=``) and the streaming tail of the digital
twin are not ported yet (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple

import numpy as np

from corro_sim_torch.io.columns import unpack_columns
from corro_sim_torch.io.values import ValueInterner, sqlite_sort_key

DELETE_CID = "__crsql_del"


@dataclasses.dataclass(frozen=True)
class TraceChange:
    table: str
    pk: tuple
    cid: str
    val: object
    col_version: int
    db_version: int
    seq: int
    site_id: bytes
    cl: int


@dataclasses.dataclass(frozen=True)
class TraceChangeset:
    actor_id: str
    version: int
    ts: int
    changes: tuple


@dataclasses.dataclass(frozen=True)
class TraceEmpty:
    actor_id: str
    versions: tuple  # (start, end) inclusive
    ts: int | None


def _parse_val(v):
    if isinstance(v, dict) and set(v) == {"blob"}:
        return bytes(v["blob"])
    if isinstance(v, bool):
        return int(v)
    return v


def _build_event(obj):
    """One parsed-JSON object → a trace event."""
    if "versions" in obj:
        lo, hi = obj["versions"]
        return TraceEmpty(
            actor_id=obj["actor_id"], versions=(int(lo), int(hi)),
            ts=obj.get("ts"),
        )
    changes = tuple(
        TraceChange(
            table=c["table"],
            pk=unpack_columns(bytes(c["pk"])),
            cid=c["cid"],
            val=_parse_val(c.get("val")),
            col_version=int(c["col_version"]),
            db_version=int(c["db_version"]),
            seq=int(c["seq"]),
            site_id=bytes(c.get("site_id", b"\x00" * 16)),
            cl=int(c["cl"]),
        )
        for c in obj.get("changes", ())
    )
    return TraceChangeset(
        actor_id=obj["actor_id"],
        version=int(obj["version"]),
        ts=int(obj.get("ts", 0)),
        changes=changes,
    )


def parse_trace_line(line: str):
    """One ND-JSON line → :class:`TraceChangeset` or :class:`TraceEmpty`."""
    return _build_event(json.loads(line))


def parse_trace_lines(lines) -> list:
    """Parse every line of a trace."""
    return [parse_trace_line(ln) for ln in lines]


@dataclasses.dataclass
class EncodedTrace:
    """Dense injection arrays + the mappings that decode results back.

    Cell planes have shape (rounds, actors, seqs); per-changeset planes
    (rounds, actors). ``valid`` marks a real changeset, ``empty`` a cleared
    version. ``delete`` is workload metadata (changeset is purely a row
    delete); injection identifies tombstone lanes per cell (``vr == NEG``),
    so mixed delete+write transactions replay correctly.
    """

    actors: list  # ordinal → actor_id
    row_keys: list  # row slot → (table, pk tuple)
    col_keys: list  # (table, cid, plane index) triples; planes table-scoped
    interner: ValueInterner
    values: list  # rank → value (inverse interner, for readback)

    valid: np.ndarray
    empty: np.ndarray
    delete: np.ndarray
    ncells: np.ndarray
    row: np.ndarray
    col: np.ndarray
    vr: np.ndarray
    cv: np.ndarray
    cl: np.ndarray
    ts: np.ndarray  # (rounds, actors) int32 — EmptySet ts per cleared
    # lane; -1 = carries no stamp (full changeset, or a lost gap)

    @property
    def rounds(self) -> int:
        return self.valid.shape[0]

    @property
    def num_actors(self) -> int:
        return len(self.actors)

    @property
    def num_rows(self) -> int:
        return len(self.row_keys)

    @property
    def num_cols(self) -> int:
        return max([p + 1 for (_, _, p) in self.col_keys], default=1)

    @property
    def seqs_per_version(self) -> int:
        return self.row.shape[2]

    def suggest_config(self, **overrides):
        """A :class:`~corro_sim_torch.config.SimConfig` sized for this
        trace."""
        from corro_sim_torch.config import SimConfig

        fields = dict(
            num_nodes=max(2, self.num_actors),
            num_rows=self.num_rows,
            num_cols=self.num_cols,
            seqs_per_version=self.seqs_per_version,
            log_capacity=max(2, self.rounds),
            write_rate=0.0,
        )
        fields.update(overrides)
        return SimConfig(**fields)


class _World(NamedTuple):
    """The closed world a trace is encoded against."""

    actors: dict  # actor_id -> ordinal
    row_of: dict  # (table, pk tuple) -> row slot
    row_keys: list  # slot -> (table, pk tuple)
    col_keys: dict  # (table, cid) -> plane index
    interner: ValueInterner
    values: list  # rank -> value
    seqs_per_version: int  # widest changeset the trace carries


def _discover(events) -> tuple:
    """Phase 1 (the closed world) over parsed events → ``(world,
    per-actor version books)``."""
    actors: dict[str, int] = {}
    col_keys: dict[tuple, int] = {}
    pk_raw: set = set()
    interner = ValueInterner()
    seen_vals: list = []
    per_actor: dict[str, dict[int, object]] = {}

    for ev in events:
        actors.setdefault(ev.actor_id, len(actors))
        book = per_actor.setdefault(ev.actor_id, {})
        if isinstance(ev, TraceEmpty):
            for v in range(ev.versions[0], ev.versions[1] + 1):
                # cleared; keep the EmptySet's ts (the stamp each cleared
                # version carries on the wire, change.rs:267-389)
                book[v] = -1 if ev.ts is None else int(ev.ts)
            continue
        if ev.version in book and isinstance(book[ev.version], TraceChangeset):
            raise ValueError(
                f"duplicate version {ev.version} for actor {ev.actor_id}"
            )
        book[ev.version] = ev
        for c in ev.changes:
            pk_raw.add((c.table, c.pk))
            if c.cid != DELETE_CID:
                # table-scoped plane numbering (row ranges are disjoint
                # per table, so planes can be reused across tables)
                if (c.table, c.cid) not in col_keys:
                    nplanes = sum(1 for (t, _) in col_keys if t == c.table)
                    col_keys[(c.table, c.cid)] = nplanes
                interner.add(c.val)
                seen_vals.append(c.val)

    # Row slots ordered by (table, pk) with SQLite value comparison on pk
    # parts — deterministic across runs.
    row_keys = sorted(
        pk_raw,
        key=lambda tp: (tp[0], tuple(sqlite_sort_key(p) for p in tp[1])),
    )
    row_of = {k: i for i, k in enumerate(row_keys)}
    interner.freeze()
    values = [None] * len(interner)
    for v in seen_vals:
        rk = interner.rank(v)
        if values[rk] is None:
            # first-encountered representative per conflict key — bool
            # and int share a key, and read_table decodes through this
            # list, so last-wins would flip 1 -> True in replay output
            values[rk] = v
    s = max(
        (
            len(ev.changes)
            for book in per_actor.values()
            for ev in book.values()
            if isinstance(ev, TraceChangeset)
        ),
        default=1,
    )
    world = _World(
        actors=actors, row_of=row_of, row_keys=row_keys, col_keys=col_keys,
        interner=interner, values=values, seqs_per_version=max(1, s),
    )
    return world, per_actor


def ingest(lines, layout=None) -> EncodedTrace:
    """Two-phase ingest of an iterable of trace lines (str or parsed);
    the universe is discovered from the trace itself."""
    if layout is not None:
        raise NotImplementedError(
            "corro_sim_torch does not run schema-driven ingest (layout=) "
            "yet (queue 1: digital twin)"
        )
    lines = list(lines)
    events = [
        parse_trace_line(ln) if isinstance(ln, str) else ln for ln in lines
    ]

    # --- phase 1: discover the closed world -----------------------------
    world, per_actor = _discover(events)
    actors, col_keys, row_of = world.actors, world.col_keys, world.row_of
    interner = world.interner

    # --- phase 2: encode -------------------------------------------------
    a = len(actors)
    heads = {aid: (max(book) if book else 0) for aid, book in per_actor.items()}
    rounds = max(heads.values(), default=0)
    s = world.seqs_per_version

    valid = np.zeros((rounds, a), bool)
    empty = np.zeros((rounds, a), bool)
    ts = np.full((rounds, a), -1, np.int32)  # EmptySet ts per cleared lane
    delete = np.zeros((rounds, a), bool)
    ncells = np.zeros((rounds, a), np.int32)
    row = np.zeros((rounds, a, s), np.int32)
    col = np.zeros((rounds, a, s), np.int32)
    vr = np.zeros((rounds, a, s), np.int32)
    cv = np.zeros((rounds, a, s), np.int32)
    cl = np.ones((rounds, a, s), np.int32)

    for aid, book in per_actor.items():
        ai = actors[aid]
        for v in range(1, heads[aid] + 1):
            r = v - 1
            ev = book.get(v, None)
            valid[r, ai] = True
            if not isinstance(ev, TraceChangeset):
                # Cleared (or never-seen — a gap the trace itself lost;
                # treat as cleared, the sync path's Empty answer). A real
                # EmptySet carries its ts; a lost gap has none (-1).
                empty[r, ai] = True
                if ev is not None:
                    ts[r, ai] = ev
                continue
            chs = sorted(ev.changes, key=lambda c: c.seq)[:s]
            ncells[r, ai] = len(chs)
            delete[r, ai] = all(c.cid == DELETE_CID for c in chs) and bool(chs)
            for j, c in enumerate(chs):
                row[r, ai, j] = row_of[(c.table, c.pk)]
                cv[r, ai, j] = c.col_version
                cl[r, ai, j] = c.cl
                if c.cid == DELETE_CID:
                    col[r, ai, j] = 0
                    vr[r, ai, j] = np.iinfo(np.int32).min  # NEG: cl-only
                else:
                    col[r, ai, j] = col_keys[(c.table, c.cid)]
                    vr[r, ai, j] = interner.rank(c.val)

    return EncodedTrace(
        actors=list(actors),
        row_keys=world.row_keys,
        col_keys=sorted((t, c, p) for (t, c), p in col_keys.items()),
        interner=interner,
        values=world.values,
        valid=valid,
        empty=empty,
        ts=ts,
        delete=delete,
        ncells=ncells,
        row=row,
        col=col,
        vr=vr,
        cv=cv,
        cl=cl,
    )


def ingest_file(path, layout=None) -> EncodedTrace:
    with open(path) as f:
        return ingest((ln for ln in f if ln.strip()), layout=layout)
