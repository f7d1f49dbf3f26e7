"""Changeset-trace ingestion: `corro-api-types` JSON → replayable arrays.

Port of ``corro_sim/io/traces.py``. A trace is
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

With a :class:`~corro_sim_torch.schema.TableLayout` (``layout=``) the
row slots and column planes come from the schema. The streaming half
(:class:`TraceUniverse`, :class:`TraceStream`, :func:`validate_feed`)
is what the digital twin (:mod:`corro_sim_torch.engine.twin`) tails a
live feed with. The pk codec is the pure-Python one
(:mod:`corro_sim_torch.io.columns`); the JAX package's C batch decoder
is a host-side speed path the port does not carry.
"""

from __future__ import annotations

import dataclasses
import json

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


def _build_event(obj, pks):
    """Assemble one parsed-JSON object into a trace event, consuming its
    changes' decoded pk tuples from the ``pks`` iterator."""
    if "versions" in obj:
        lo, hi = obj["versions"]
        return TraceEmpty(
            actor_id=obj["actor_id"], versions=(int(lo), int(hi)),
            ts=obj.get("ts"),
        )
    changes = tuple(
        TraceChange(
            table=c["table"],
            pk=next(pks),
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
    """One ND-JSON line → :class:`TraceChangeset` or :class:`TraceEmpty`.
    Every pk blob is read before any decodes, and every blob decodes
    before the event is built, so a hostile line raises what the JAX
    package's parse raises."""
    obj = json.loads(line)
    blobs = [bytes(c["pk"]) for c in obj.get("changes", ())]
    return _build_event(obj, iter([unpack_columns(b) for b in blobs]))


def parse_trace_lines(lines) -> list:
    """Bulk parse: every pk blob of the whole trace decodes in one batch
    before the events are built."""
    objs = [json.loads(ln) for ln in lines]
    # mirror _build_event's branch exactly: an empty-set line ("versions")
    # never consumes pk tuples, so its changes (if any) must not be packed
    # into the shared batch or every later pk would misalign
    blobs = [
        bytes(c["pk"])
        for obj in objs
        if "versions" not in obj
        for c in obj.get("changes", ())
    ]
    pks = iter([unpack_columns(b) for b in blobs])
    return [_build_event(obj, pks) for obj in objs]


@dataclasses.dataclass
class EncodedTrace:
    """Dense injection tensors + the mappings that decode results back.

    Cell planes have shape (rounds, actors, seqs); per-changeset planes
    (rounds, actors). ``valid`` marks a real changeset, ``empty`` a cleared
    version. ``delete`` is workload metadata (changeset is purely a row
    delete); injection identifies tombstone lanes per cell (``vr == NEG``),
    so mixed delete+write transactions replay correctly.
    """

    actors: list  # ordinal → actor_id
    row_keys: list  # row slot → (table, pk tuple); None = unallocated slot
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


@dataclasses.dataclass
class TraceUniverse:
    """The frozen closed world a trace is encoded against: actor ordinals,
    row slots, column planes and the interned value space. Batch ingest
    discovers one per call; the streaming twin (:class:`TraceStream`)
    freezes one from an initial scan window and then encodes every later
    feed chunk against it — lines naming anything OUTSIDE the frozen
    universe quarantine instead of growing it (a live feed can contain
    anything; the compiled tensor shapes cannot move)."""

    actors: dict  # actor_id -> ordinal
    row_of: dict  # (table, pk tuple) -> row slot
    row_keys: list  # slot -> (table, pk tuple); None = unallocated
    col_keys: dict  # (table, cid) -> plane index
    interner: ValueInterner
    values: list  # rank -> value
    seqs_per_version: int  # widest changeset the scan window carried

    @property
    def num_actors(self) -> int:
        return len(self.actors)

    @property
    def num_rows(self) -> int:
        return len(self.row_keys)

    @property
    def num_cols(self) -> int:
        return max([p + 1 for p in self.col_keys.values()], default=1)

    def col_triples(self) -> list:
        """The (table, cid, plane) triples in EncodedTrace order."""
        return sorted((t, c, p) for (t, c), p in self.col_keys.items())

    def suggest_config(self, rounds: int = 0, **overrides):
        """A :class:`~corro_sim_torch.config.SimConfig` sized for this
        universe (the twin's shadow shape; ``rounds`` bounds the
        change-log ring — size it for the whole feed, not the window)."""
        from corro_sim_torch.config import SimConfig

        fields = dict(
            num_nodes=max(2, self.num_actors),
            num_rows=max(1, self.num_rows),
            num_cols=self.num_cols,
            seqs_per_version=self.seqs_per_version,
            log_capacity=max(2, rounds),
            write_rate=0.0,
        )
        fields.update(overrides)
        return SimConfig(**fields)


def _discover(events, layout=None) -> tuple:
    """Phase 1 (the closed world) over parsed events → ``(TraceUniverse,
    per-actor version books)`` — shared by batch :func:`ingest` and the
    streaming scan window (:func:`scan_universe`)."""
    actors: dict[str, int] = {}
    col_keys: dict[tuple, int] = {}
    if layout is not None:
        # Full schema surface, not just trace-observed columns.
        for t in layout.schema:
            for c in t.value_columns:
                col_keys[(t.name, c.name)] = layout.col_index(t.name, c.name)
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
                if layout is None:
                    # table-scoped plane numbering (row ranges are disjoint
                    # per table, so planes can be reused across tables)
                    if (c.table, c.cid) not in col_keys:
                        nplanes = sum(
                            1 for (t, _) in col_keys if t == c.table
                        )
                        col_keys[(c.table, c.cid)] = nplanes
                else:
                    col_keys.setdefault(
                        (c.table, c.cid), layout.col_index(c.table, c.cid)
                    )
                interner.add(c.val)
                seen_vals.append(c.val)

    if layout is None:
        # Row slots ordered by (table, pk) with SQLite value comparison on
        # pk parts — deterministic across runs.
        row_keys = sorted(
            pk_raw,
            key=lambda tp: (tp[0], tuple(sqlite_sort_key(p) for p in tp[1])),
        )
        row_of = {k: i for i, k in enumerate(row_keys)}
    else:
        ordered = sorted(
            pk_raw,
            key=lambda tp: (tp[0], tuple(sqlite_sort_key(p) for p in tp[1])),
        )
        row_of = {k: layout.row_slot(*k) for k in ordered}
        row_keys = [None] * layout.num_rows
        for k, slot in row_of.items():
            row_keys[slot] = k
    interner.freeze()
    values = [None] * len(interner)
    for v in seen_vals:
        rk = interner.rank(v)
        if values[rk] is None:
            # first-encountered representative per conflict key — bool
            # and int share a key (crsql_conflict_key(True) == (..., 1))
            # and read_table decodes through this list, so last-wins
            # would flip 1 -> True in replay output
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
    universe = TraceUniverse(
        actors=actors, row_of=row_of, row_keys=row_keys,
        col_keys=col_keys, interner=interner, values=values,
        seqs_per_version=max(1, s),
    )
    return universe, per_actor


def scan_universe(lines, layout=None, lenient: bool = False) -> TraceUniverse:
    """Freeze a :class:`TraceUniverse` from a scan window of trace lines
    (the streaming twin's phase 1 — nothing is encoded).

    ``lenient``: a twin's scan window is the same hostile feed the
    stream later consumes — unparseable lines are skipped here (they
    quarantine with a proper reason at feed/validate time) and a
    duplicated Full changeset keeps its first copy (discovery only
    collects names and values; the duplicate itself is classified
    later). Strict mode (the batch-ingest posture) raises on both."""
    lines = list(lines)
    if not lenient:
        events = parse_trace_lines(lines)
    else:
        events = []
        seen: set = set()
        for ln in lines:
            try:
                ev = parse_trace_line(ln) if isinstance(ln, str) else ln
                if not isinstance(ev, (TraceChangeset, TraceEmpty)):
                    raise TypeError(f"not a trace event: {type(ev)!r}")
            except Exception:
                continue  # classified as `malformed` at feed time
            if isinstance(ev, TraceChangeset):
                key = (ev.actor_id, ev.version)
                if key in seen:
                    continue  # classified as `duplicate` at feed time
                seen.add(key)
            events.append(ev)
    universe, _ = _discover(events, layout=layout)
    return universe


def extend_universe(
    universe: TraceUniverse,
    window_lines,
    *,
    max_actors: int,
    max_rows: int,
    max_cols: int,
    max_seqs: int,
) -> tuple:
    """Grow a frozen :class:`TraceUniverse` from a fresh scan window —
    the stale-universe REFRESH (a scheduled re-key event; doc/twin.md
    §9). Returns ``(new_universe, info)`` or ``(None, info)`` when the
    extension would not fit the shadow's compiled shapes
    (``info["refused"]`` names every violated bound — honest refusal,
    never a silent resize).

    Ordinal discipline: every existing actor ordinal, row slot and
    column plane is PRESERVED (new ones append), so committed state
    tensors stay addressable. Value ranks CANNOT be preserved — the
    interner's dense crsql conflict order (io/values.py) is the merge
    kernel's LWW tiebreak, so the union re-freezes and
    ``info["old_ranks"]/["new_ranks"]`` carry the translation every
    rank-typed state plane must apply
    (:func:`corro_sim_torch.utils.ranks.translate_ranks`; the checkpoint
    installer's exact remap set: table/vr, own/vr, log cells' vr)."""
    if any(k is None for k in universe.row_keys):
        return None, {"refused": [
            "layout-pinned universe (schema row slots) cannot be "
            "extended from a scan window"
        ]}
    fresh = scan_universe(window_lines, lenient=True)

    actors = dict(universe.actors)
    for aid in fresh.actors:  # discovery order — deterministic
        if aid not in actors:
            actors[aid] = len(actors)

    row_keys = list(universe.row_keys)
    row_of = dict(universe.row_of)
    new_rows = sorted(
        (k for k in fresh.row_of if k not in row_of),
        key=lambda tp: (tp[0], tuple(sqlite_sort_key(p) for p in tp[1])),
    )
    for k in new_rows:
        row_of[k] = len(row_keys)
        row_keys.append(k)

    col_keys = dict(universe.col_keys)
    for (t, cid) in sorted(k for k in fresh.col_keys if k not in col_keys):
        col_keys[(t, cid)] = sum(1 for (t2, _) in col_keys if t2 == t)

    interner = ValueInterner()
    for v in universe.values:
        interner.add(v)
    for v in fresh.values:
        interner.add(v)
    interner.freeze()
    values = [None] * len(interner)
    for v in list(universe.values) + list(fresh.values):
        rk = interner.rank(v)
        if values[rk] is None:
            # keep the OLD universe's representatives (readback
            # stability: a refresh must not flip 1 -> True in reports)
            values[rk] = v

    s = max(universe.seqs_per_version, min(fresh.seqs_per_version, max_seqs))
    num_cols = max([p + 1 for p in col_keys.values()], default=1)
    refused = []
    if len(actors) > max_actors:
        refused.append(
            f"{len(actors)} actors > {max_actors} shadow nodes"
        )
    if len(row_keys) > max_rows:
        refused.append(f"{len(row_keys)} rows > {max_rows} row slots")
    if num_cols > max_cols:
        refused.append(f"{num_cols} column planes > {max_cols}")
    old_ranks = np.arange(len(universe.values), dtype=np.int64)
    new_ranks = np.asarray(
        [interner.rank(v) for v in universe.values], np.int64
    )
    info = {
        "refused": refused,
        "actors_added": len(actors) - universe.num_actors,
        "rows_added": len(new_rows),
        "cols_added": len(col_keys) - len(universe.col_keys),
        "values_added": len(values) - len(universe.values),
        "seqs_per_version": s,
        "old_ranks": old_ranks,
        "new_ranks": new_ranks,
        "rank_moves": int((old_ranks != new_ranks).sum()),
    }
    if refused:
        return None, info
    return TraceUniverse(
        actors=actors, row_of=row_of, row_keys=row_keys,
        col_keys=col_keys, interner=interner, values=values,
        seqs_per_version=s,
    ), info


def ingest(lines, layout=None) -> EncodedTrace:
    """Two-phase ingest of an iterable of trace lines (str or parsed).

    With a :class:`~corro_sim_torch.schema.TableLayout`, row slots and column
    planes come from the schema (unknown tables/columns are rejected);
    without one, the universe is discovered from the trace itself.
    """
    lines = list(lines)
    raw = [ln for ln in lines if isinstance(ln, str)]
    parsed = iter(parse_trace_lines(raw))  # one bulk pk-decode batch
    events = [
        next(parsed) if isinstance(ln, str) else ln for ln in lines
    ]

    # --- phase 1: discover the closed world -----------------------------
    uni, per_actor = _discover(events, layout=layout)
    actors = uni.actors
    col_keys = uni.col_keys
    row_of, row_keys = uni.row_of, uni.row_keys
    interner, values = uni.interner, uni.values

    # --- phase 2: encode -------------------------------------------------
    a = len(actors)
    heads = {aid: (max(book) if book else 0)
             for aid, book in per_actor.items()}
    rounds = max(heads.values(), default=0)
    s = uni.seqs_per_version

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
        head = heads[aid]
        for v in range(1, head + 1):
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
                    vr[r, ai, j] = interner.rank(c.val)  # values[] is
                    # pre-filled by _discover

    return EncodedTrace(
        actors=list(actors),
        row_keys=row_keys,
        col_keys=sorted(
            (t, c, p) for (t, c), p in col_keys.items()
        ),
        interner=interner,
        values=values,
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


# --------------------------------------------------------- streaming tail
#
# The digital twin (corro_sim_torch/engine/twin.py) does not get the whole
# trace up front: it tails an ND-JSON feed chunk by chunk against the
# universe a scan window froze. A feed is HOSTILE INPUT — a live
# corrosion agent's broadcast stream can carry actors, tables, values or
# version orderings the scan window never promised — so every line is
# classified and the bad ones QUARANTINE with a reason instead of
# crashing the shadow (counted in corro_twin_bad_lines_total{reason}).

# quarantine reasons, the corro_twin_bad_lines_total label set
BAD_MALFORMED = "malformed"  # unparseable JSON / wrong field shapes
BAD_UNKNOWN_ACTOR = "unknown_actor"  # actor outside the frozen universe
BAD_UNKNOWN_ROW = "unknown_row"  # (table, pk) outside the frozen slots
BAD_UNKNOWN_COLUMN = "unknown_column"  # cid outside the frozen planes
BAD_UNKNOWN_VALUE = "unknown_value"  # value outside the frozen interner
BAD_STALE_VERSION = "stale_version"  # at/below the injected horizon
# (out-of-order arrival across an already-encoded chunk boundary)
BAD_DUPLICATE = "duplicate"  # second Full changeset for one version
BAD_OVERSIZED = "oversized"  # more cells than the frozen seq capacity

# A final feed line with NO trailing newline that fails to parse is a
# TORN TAIL — almost always a writer caught mid-append, not hostile
# bytes. It is RETRYABLE: a live tail simply waits for the rest of the
# line (corro_sim_torch/io/feedsource.py never delivers an unterminated
# line), and the one-shot validation pass (validate_feed) reports it
# under this reason so callers can distinguish "poll again" from
# "quarantine forever". A torn line that is NOT final (or that ends in
# a newline) stays `malformed` — nothing is coming to complete it.
BAD_TORN_TAIL = "torn_tail"

BAD_REASONS = (
    BAD_MALFORMED, BAD_UNKNOWN_ACTOR, BAD_UNKNOWN_ROW,
    BAD_UNKNOWN_COLUMN, BAD_UNKNOWN_VALUE, BAD_STALE_VERSION,
    BAD_DUPLICATE, BAD_OVERSIZED, BAD_TORN_TAIL,
)

# NOT a quarantine reason: an EmptySet entirely at/below the horizon is
# how a NORMAL feed looks — overwritten-version clearings broadcast
# AFTER the superseding version (store_empty_changeset), so the clear
# routinely lands a chunk behind the content it compacts. The
# superseding version is already injected, so the clear is dropped as
# value-neutral for convergence (the uncompacted cells sync identically
# — LWW supersedes them on arrival) and COUNTED, never refused.
LATE_CLEAR = "late_clear"


@dataclasses.dataclass
class StreamChunk:
    """One feed chunk's encoded injection slices, ``(rounds, A, [S])``
    shaped exactly like the matching :class:`EncodedTrace` planes —
    slice ``j`` commits each actor's next pending version (replay's
    per-round injection form, :func:`corro_sim_torch.workload.inject.
    inject_round`)."""

    rounds: int
    valid: np.ndarray
    empty: np.ndarray
    ts: np.ndarray
    delete: np.ndarray
    ncells: np.ndarray
    row: np.ndarray
    col: np.ndarray
    vr: np.ndarray
    cv: np.ndarray
    cl: np.ndarray
    bad: list  # (line_no, reason, detail) quarantined this chunk
    lines: int  # feed lines consumed this chunk (good + bad)
    late: list = dataclasses.field(default_factory=list)  # benign
    # late clears dropped this chunk (module comment at LATE_CLEAR)
    late_apply: list = dataclasses.field(default_factory=list)
    # (actor_ordinal, lo_version, hi_version, ts) ranges from EmptySets
    # whose versions are at/below the injected horizon — the already-
    # committed log slots a sync peer should now serve the Empty answer
    # for. Value-neutral: the superseding content is injected; only the
    # cleared/cleared_hlc bookkeeping moves (engine/twin.py applies
    # these host-side after each chunk's injection).
    ts_lo: int | None = None  # earliest `ts` stamp absorbed this chunk
    ts_hi: int | None = None  # latest — (ts_lo, ts_hi) is the chunk's
    # span on the FEED's own clock, what the shadow's sim wall is
    # scored against (the SWARM replication-latency comparison)


class TraceStream:
    """Incremental phase-2 encoder over a frozen :class:`TraceUniverse`.

    The stream keeps one cursor per actor — the *injected horizon*
    ``heads[a]`` (highest version already encoded) — and drains fully at
    every :meth:`feed` boundary: a chunk's events raise each actor's
    horizon to the highest version the chunk carried, with never-seen
    versions below the new horizon encoded as cleared gaps (the batch
    :func:`ingest` closed-world rule, applied per chunk). A version
    arriving BELOW its actor's horizon is therefore out-of-order across
    a boundary the shadow already committed — it quarantines
    (``stale_version``) rather than rewriting injected history.

    Restart cursor: ``heads``/``counters``/``lines_seen`` are the whole
    resumable state (the pending book is empty between feeds), so a
    SIGKILL'd twin stores them in its checkpoint token and resumes the
    feed bit-identically (:mod:`corro_sim_torch.engine.twin`).
    """

    def __init__(self, universe: TraceUniverse, heads=None,
                 counters: dict | None = None, lines_seen: int = 0,
                 late_clears: int = 0):
        self.universe = universe
        self.heads = (
            np.zeros(universe.num_actors, np.int64) if heads is None
            else np.asarray(heads, np.int64).copy()
        )
        self.counters: dict[str, int] = dict(counters or {})
        self.lines_seen = int(lines_seen)
        self.late_clears = int(late_clears)

    # ------------------------------------------------------------ cursor
    def cursor(self) -> dict:
        """The JSON-serializable resume cursor."""
        return {
            "heads": [int(h) for h in self.heads],
            "counters": dict(self.counters),
            "lines_seen": self.lines_seen,
            "late_clears": self.late_clears,
        }

    @classmethod
    def from_cursor(cls, universe: TraceUniverse, cur: dict):
        return cls(
            universe, heads=cur.get("heads"),
            counters=cur.get("counters"),
            lines_seen=cur.get("lines_seen", 0),
            late_clears=cur.get("late_clears", 0),
        )

    @property
    def bad_lines(self) -> int:
        return sum(self.counters.values())

    # ----------------------------------------------------------- rebind
    def rebind(self, universe: TraceUniverse) -> None:
        """Swap in a refreshed (extended) universe mid-stream — the
        re-key event: new actor ordinals start at horizon 0; every
        existing ordinal keeps its horizon and counters. The caller
        owns the matching state-side rank translation
        (:func:`extend_universe`)."""
        assert universe.num_actors >= self.universe.num_actors, (
            "rebind only grows the universe (ordinals are preserved)"
        )
        heads = np.zeros(universe.num_actors, np.int64)
        heads[: len(self.heads)] = self.heads
        self.universe = universe
        self.heads = heads

    # ---------------------------------------------------- classification
    def _classify(self, ev, book: dict) -> tuple[str, str] | None:
        """One parsed event against the frozen universe + horizon —
        ``(reason, detail)`` when the line must quarantine, else None."""
        uni = self.universe
        if ev.actor_id not in uni.actors:
            return BAD_UNKNOWN_ACTOR, f"actor {ev.actor_id}"
        ai = uni.actors[ev.actor_id]
        head = int(self.heads[ai])
        if isinstance(ev, TraceEmpty):
            if ev.versions[1] <= head:
                # benign (module comment at LATE_CLEAR) — never a
                # strict-mode refusal, counted apart from quarantines
                return LATE_CLEAR, (
                    f"empty versions {ev.versions} <= injected horizon "
                    f"{head} of actor {ev.actor_id}"
                )
            return None
        if ev.version <= head:
            return BAD_STALE_VERSION, (
                f"version {ev.version} <= injected horizon {head} of "
                f"actor {ev.actor_id}"
            )
        pending = book.get(ai, {}).get(ev.version)
        if isinstance(pending, TraceChangeset):
            return BAD_DUPLICATE, (
                f"version {ev.version} of actor {ev.actor_id} already "
                "in this chunk"
            )
        if len(ev.changes) > uni.seqs_per_version:
            return BAD_OVERSIZED, (
                f"{len(ev.changes)} cells > frozen seq capacity "
                f"{uni.seqs_per_version}"
            )
        for c in ev.changes:
            if (c.table, c.pk) not in uni.row_of:
                return BAD_UNKNOWN_ROW, f"row ({c.table}, {c.pk!r})"
            if c.cid != DELETE_CID:
                if (c.table, c.cid) not in uni.col_keys:
                    return BAD_UNKNOWN_COLUMN, (
                        f"column ({c.table}, {c.cid})"
                    )
                try:
                    uni.interner.rank(c.val)
                except KeyError:
                    return BAD_UNKNOWN_VALUE, f"value {c.val!r}"
        return None

    # ------------------------------------------------------------- feed
    def feed(self, lines, skip_bad: bool = False,
             encode: bool = True) -> StreamChunk:
        """Consume one chunk of feed lines (str or pre-parsed events) and
        encode the injection slices they complete.

        ``skip_bad=False`` (the strict posture): ALL bad lines in the
        chunk are collected into ONE ValueError — nothing is encoded and
        the stream cursor does not move, so a validation failure is
        up-front and side-effect-free. ``skip_bad=True`` (``corro-sim
        twin --skip-bad``): bad lines quarantine with per-reason
        counters and the good lines encode normally.

        Blank/whitespace lines are consumed without effect — the cursor
        counts them, so quarantine diagnostics report FILE line numbers
        when the caller passes the file's lines unfiltered
        (:func:`corro_sim_torch.engine.twin.load_feed_lines` does).

        ``encode=False``: classify and advance the horizon without
        allocating or filling the injection planes (the validation /
        head-probe passes — same verdicts, no throwaway tensors)."""
        uni = self.universe
        a = uni.num_actors
        s = uni.seqs_per_version
        book: dict[int, dict[int, object]] = {}
        bad: list = []
        late: list = []
        late_apply: list = []
        n_lines = 0
        ts_lo: int | None = None
        ts_hi: int | None = None
        for ln in lines:
            line_no = self.lines_seen + n_lines + 1
            n_lines += 1
            if isinstance(ln, str) and not ln.strip():
                continue  # blank feed line: counted, never classified
            try:
                ev = parse_trace_line(ln) if isinstance(ln, str) else ln
                if not isinstance(ev, (TraceChangeset, TraceEmpty)):
                    raise TypeError(f"not a trace event: {type(ev)!r}")
            except Exception as e:  # hostile bytes: anything can be here
                bad.append((line_no, BAD_MALFORMED,
                            f"{type(e).__name__}: {e}"))
                continue
            verdict = self._classify(ev, book)
            if verdict is not None:
                if verdict[0] == LATE_CLEAR:
                    late.append((line_no, *verdict))
                    # retroactive application: the slot content stays
                    # (value-neutral) but the cleared bookkeeping moves
                    # so sync peers serve the Empty answer
                    ai = uni.actors[ev.actor_id]
                    late_apply.append((
                        ai, int(ev.versions[0]), int(ev.versions[1]),
                        -1 if ev.ts is None else int(ev.ts),
                    ))
                else:
                    bad.append((line_no, *verdict))
                continue
            ai = uni.actors[ev.actor_id]
            abook = book.setdefault(ai, {})
            if ev.ts is not None:
                ts_lo = int(ev.ts) if ts_lo is None else min(
                    ts_lo, int(ev.ts)
                )
                ts_hi = int(ev.ts) if ts_hi is None else max(
                    ts_hi, int(ev.ts)
                )
            if isinstance(ev, TraceEmpty):
                lo = max(ev.versions[0], int(self.heads[ai]) + 1)
                if ev.versions[0] < lo:
                    # the straddling range's already-injected part gets
                    # the same retroactive clearing a fully-late
                    # EmptySet does (versions ahead encode normally)
                    late_apply.append((
                        ai, int(ev.versions[0]), lo - 1,
                        -1 if ev.ts is None else int(ev.ts),
                    ))
                for v in range(lo, ev.versions[1] + 1):
                    # last-wins, the batch-ingest book rule: a clearing
                    # that follows a Full changeset compacts it (the
                    # overwritten-version clearing a real feed emits);
                    # the [lo, hi] clip only skips already-injected
                    # versions (the stale part of a straddling range)
                    abook[v] = -1 if ev.ts is None else int(ev.ts)
            else:
                abook[ev.version] = ev
        if bad and not skip_bad:
            raise ValueError(
                f"hostile trace feed ({len(bad)} bad lines):\n  "
                + "\n  ".join(
                    f"line {no}: {reason}: {detail}"
                    for no, reason, detail in bad
                )
            )
        self.lines_seen += n_lines
        for _no, reason, _detail in bad:
            self.counters[reason] = self.counters.get(reason, 0) + 1
        self.late_clears += len(late)

        # ---- encode: raise each actor's horizon to its chunk max;
        # unseen versions below the new horizon are lost-gap cleared
        new_heads = self.heads.copy()
        for ai, abook in book.items():
            new_heads[ai] = max(int(new_heads[ai]), max(abook))
        if not encode:
            self.heads = new_heads
            return StreamChunk(
                rounds=0, valid=None, empty=None, ts=None, delete=None,
                ncells=None, row=None, col=None, vr=None, cv=None,
                cl=None, bad=bad, lines=n_lines, late=late,
                late_apply=late_apply, ts_lo=ts_lo, ts_hi=ts_hi,
            )
        slices = int((new_heads - self.heads).max(initial=0))
        valid = np.zeros((slices, a), bool)
        empty = np.zeros((slices, a), bool)
        ts = np.full((slices, a), -1, np.int32)
        delete = np.zeros((slices, a), bool)
        ncells = np.zeros((slices, a), np.int32)
        row = np.zeros((slices, a, s), np.int32)
        col = np.zeros((slices, a, s), np.int32)
        vr = np.zeros((slices, a, s), np.int32)
        cv = np.zeros((slices, a, s), np.int32)
        cl = np.ones((slices, a, s), np.int32)
        for ai in range(a):
            abook = book.get(ai, {})
            for j in range(int(new_heads[ai] - self.heads[ai])):
                v = int(self.heads[ai]) + 1 + j
                ev = abook.get(v)
                valid[j, ai] = True
                if not isinstance(ev, TraceChangeset):
                    # cleared (EmptySet) or a gap this chunk lost — the
                    # batch-ingest closed-world rule, per chunk
                    empty[j, ai] = True
                    if ev is not None:
                        ts[j, ai] = ev
                    continue
                chs = sorted(ev.changes, key=lambda c: c.seq)[:s]
                ncells[j, ai] = len(chs)
                delete[j, ai] = (
                    all(c.cid == DELETE_CID for c in chs) and bool(chs)
                )
                for k, c in enumerate(chs):
                    row[j, ai, k] = uni.row_of[(c.table, c.pk)]
                    cv[j, ai, k] = c.col_version
                    cl[j, ai, k] = c.cl
                    if c.cid == DELETE_CID:
                        col[j, ai, k] = 0
                        vr[j, ai, k] = np.iinfo(np.int32).min
                    else:
                        col[j, ai, k] = uni.col_keys[(c.table, c.cid)]
                        vr[j, ai, k] = uni.interner.rank(c.val)
        self.heads = new_heads
        return StreamChunk(
            rounds=slices, valid=valid, empty=empty, ts=ts,
            delete=delete, ncells=ncells, row=row, col=col, vr=vr,
            cv=cv, cl=cl, bad=bad, lines=n_lines, late=late,
            late_apply=late_apply, ts_lo=ts_lo, ts_hi=ts_hi,
        )


def validate_feed(lines, universe: TraceUniverse,
                  chunk_lines: int = 4096) -> list:
    """Classify EVERY line of a feed against the frozen universe without
    encoding anything — the twin's strict up-front validation pass: all
    malformed / unknown-actor / out-of-order / duplicate lines across
    the whole feed come back as one list, raised as ONE ValueError by
    the caller (the all-errors-at-once posture).

    ``chunk_lines`` must be the chunking the REAL run will use:
    classification is chunk-boundary-dependent (an out-of-order version
    inside one chunk reorders through the pending book; across a
    boundary it is stale), so validating under a different chunking
    would pass feeds the run then refuses mid-stream, or vice versa.

    A FINAL line that fails to parse and carries no trailing newline
    reports as ``torn_tail``, not ``malformed`` — a writer caught
    mid-append, retryable by polling again, never a poisoned feed
    (module comment at :data:`BAD_TORN_TAIL`)."""
    lines = list(lines)
    probe = TraceStream(universe)
    bad: list = []
    for chunk in _chunked(lines, max(1, chunk_lines)):
        out = probe.feed(chunk, skip_bad=True, encode=False)
        bad.extend(out.bad)
    if (
        bad and lines and isinstance(lines[-1], str)
        and not lines[-1].endswith("\n")
        and bad[-1][0] == len(lines) and bad[-1][1] == BAD_MALFORMED
    ):
        no, _reason, detail = bad[-1]
        bad[-1] = (no, BAD_TORN_TAIL, (
            f"unterminated final line ({detail}) — retryable: a live "
            "tail waits for the writer to finish it"
        ))
    return bad


def _chunked(it, n: int):
    buf: list = []
    for x in it:
        buf.append(x)
        if len(buf) >= n:
            yield buf
            buf = []
    if buf:
        yield buf


def dump_changeset(
    actor_id: str,
    version: int,
    ts: int,
    cells,  # iterable of (table, pk_tuple, cid, val, col_version, cl)
) -> str:
    """Serialize one Full changeset back to a trace line (round-trip aid)."""
    from corro_sim_torch.io.columns import pack_columns

    changes = []
    for seq, (table, pk, cid, val, col_version, cl_) in enumerate(cells):
        if isinstance(val, (bytes, bytearray)):
            val = {"blob": list(val)}
        changes.append(
            {
                "table": table,
                "pk": list(pack_columns(pk)),
                "cid": cid,
                "val": val,
                "col_version": col_version,
                "db_version": version,
                "seq": seq,
                "site_id": [0] * 16,
                "cl": cl_,
            }
        )
    n = len(changes)
    return json.dumps(
        {
            "actor_id": actor_id,
            "version": version,
            "changes": changes,
            "seqs": [0, max(0, n - 1)],
            "last_seq": max(0, n - 1),
            "ts": ts,
        }
    )
