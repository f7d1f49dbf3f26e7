"""Subscription engine: registered queries matched against live state.

The reference's ``SubsManager``/``Matcher`` (``corro-types/src/pubsub.rs``)
keeps one matcher per normalized SELECT: it streams the initial result set
(``QueryEvent::{Columns,Row,EndOfQuery}``), then watches committed changes,
filters them by the query's table+columns (``filter_matchable_change``
``:562-597``), diffs matched rows in its own SQLite DB with EXCEPT queries
(``handle_candidates`` ``:1518-1793``) and emits
``QueryEvent::Change(INSERT|UPDATE|DELETE, rowid, cells, change_id)``.
Subscribers re-attach by id with a ``from`` change-id and catch up from the
buffered ``changes`` table (``api/public/pubsub.rs:355-617``).

Port of ``corro_sim/subs/manager.py``. Device shape: a matcher is a
*compiled predicate* over one observer node's slice of the cluster table
tensor. Evaluation runs on the device the table lies on — the WHERE
clause is integer comparisons in rank space
(:mod:`corro_sim_torch.subs.query`), the match mask and projected ranks
come back to the host in one small read — and the host diffs them
against the previous evaluation to materialize events: mask-on =
INSERT, mask-off = DELETE, mask-kept with changed projection = UPDATE.
The per-sub SQLite database, temp-table diffing and EXCEPT dance all
collapse into one vectorized compare. Plain matchers that share a
predicate skeleton evaluate as one group (:class:`SubsManager`): one
evaluation and one device→host read per group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from corro_sim_torch.core.crdt import NEG
from corro_sim_torch.io.values import sqlite_sort_key
from corro_sim_torch.subs.query import (
    And,
    QueryError,
    RankUniverse,
    Select,
    _sql_number,
    avg_cell,
    compile_predicate,
    eval_predicate_py,
    fold_aggregate,
    parse_query,
    predicate_batch_plan,
    predicate_columns,
    predicate_intern_values,
    rewrite_columns,
    split_host_predicate,
    split_pk_predicate,
    sum_cell,
)


def check_slice(vr_all, start: int, cap: int) -> None:
    """A table's row range must lie inside the planes: the JAX package's
    ``dynamic_slice_in_dim`` would clamp the start, a torch slice would
    truncate, so a range past the end is refused."""
    if start < 0 or start + cap > vr_all.shape[1]:
        raise ValueError(
            f"row range [{start}, {start + cap}) outside the table's "
            f"{vr_all.shape[1]} rows"
        )


def read_match_proj(match, proj):
    """``(match, proj)`` as numpy arrays, read from the device in ONE
    copy: the mask rides as a leading int32 column of the projection."""
    both = torch.cat([match.to(proj.dtype)[..., None], proj], dim=-1)
    host = both.cpu().numpy()
    return host[..., 0].astype(bool), np.ascontiguousarray(host[..., 1:])


class IdentityUniverse:
    """Rank space for synthetic workloads: values ARE their ranks
    (single integer band, so SQL order == rank order trivially)."""

    _INT_MIN = -(2**31)
    _INT_MAX = 2**31 - 1

    def _check(self, lit):
        if not isinstance(lit, int):
            raise QueryError(
                f"synthetic workloads store int values, got {lit!r}"
            )

    def rank_of(self, lit):
        if lit is None:
            return (-1, -1)  # NULL never stored in synthetic runs
        self._check(lit)
        return (lit, lit + 1)

    def eq_ranges(self, lit):
        return (self.rank_of(lit),)

    def sql_ranges(self, lit, op):
        self._check(lit)
        # hi=None == open-ended (avoids an int32-overflowing 2^31 bound
        # that would silently exclude a stored INT32_MAX)
        if op == "<":
            return ((self._INT_MIN, lit),)
        if op == "<=":
            return ((self._INT_MIN, lit + 1),)
        if op == ">":
            return ((lit + 1, None),)
        return ((lit, None),)  # >=

    def decode(self, rank: int):
        return int(rank)


class TraceUniverse(RankUniverse):
    """Rank space of an ingested trace (order == SQLite value order)."""

    def __init__(self, trace):
        super().__init__(trace.values)

    def decode(self, rank: int):
        return self.values[rank]


@dataclasses.dataclass
class SubEvent:
    kind: str  # 'insert' | 'update' | 'delete'
    rowid: int  # row slot (stable per run)
    cells: list  # decoded projected values (pk… then selected columns)
    change_id: int
    round: int | None = None  # simulation round the event was emitted at
    # (stamped by the harness notify path; not part of the wire shape —
    # the workload engine's delivery-latency clock, doc/workloads.md)

    def as_json(self):
        # QueryEvent::Change serde shape: [type, rowid, cells, change_id];
        # ChangeType serializes snake_case-lowercase ("insert"/"update"/
        # "delete") — corro-api-types/src/sqlite.rs:11-17, and the
        # documented ND-JSON stream (doc/api/subscriptions.md:61-65)
        return {
            "change": [self.kind, self.rowid, self.cells, self.change_id]
        }


class _EventStream:
    """Shared change-feed machinery: monotone change ids, bounded event
    buffer (the reference prunes changes > last N, ``pubsub.rs:1275``),
    and catch-up-or-404 semantics. Matcher and JoinMatcher must never
    diverge on these — both inherit."""

    def _init_events(self, max_buffer: int) -> None:
        self.max_buffer = max_buffer
        self._change_id = 0
        self._events: list[SubEvent] = []
        self._primed = False

    @property
    def change_id(self) -> int:
        """Latest change id this matcher has emitted (feed position)."""
        return self._change_id

    def _emit(self, events: list, kind: str, rowid: int, cells: list) -> None:
        self._change_id += 1
        events.append(SubEvent(kind=kind, rowid=rowid, cells=cells,
                               change_id=self._change_id))

    def _buffer_events(self, events: list) -> None:
        self._events.extend(events)
        if len(self._events) > self.max_buffer:
            # not [-max_buffer:] — for max_buffer == 0 that keeps ALL
            self._events = self._events[len(self._events) - self.max_buffer:]

    def catch_up(self, from_change_id: int):
        """Buffered events with id > from; None if compacted past it
        (subscriber must re-subscribe — the reference 404s the range)."""
        if self._events and self._events[0].change_id > from_change_id + 1:
            return None
        if not self._events and from_change_id < self._change_id:
            # buffer gone (warm-boot restore / purge) but ids advanced past
            # `from` — the gap is unservable, same 404 as compaction
            return None
        if from_change_id > self._change_id:
            return None
        return [e for e in self._events if e.change_id > from_change_id]


class Matcher(_EventStream):
    """One registered query; owns its compiled eval + diff state."""

    def __init__(self, sub_id, select: Select, node: int, layout, universe,
                 max_buffer: int = 512):
        self.id = sub_id
        self.select = select
        self.node = node
        self.universe = universe
        self._layout_ref = layout

        start, cap = layout.table_range(select.table)
        self._start, self._cap = start, cap
        table = layout.table_columns(select.table)
        pk_names = layout.pk_columns(select.table)
        if select.columns:
            # pk columns are always emitted as the row-key prefix; selecting
            # them explicitly must not double them or hit the rank planes.
            self.columns = [c for c in select.columns if c not in pk_names]
            missing = [c for c in self.columns if c not in table]
            if missing:
                raise QueryError(
                    f"no such column(s) {missing} in {select.table!r}"
                )
        else:
            self.columns = list(table)
        self._proj_idx = [layout.col_index(select.table, c)
                          for c in self.columns]
        # WHERE splits: pk terms run host-side over the slot-allocation
        # map; corro_json_contains terms run host-side over decoded
        # values; the rest compiles to device rank comparisons.
        self._pk_where, rest_where = split_pk_predicate(
            select.where, frozenset(pk_names)
        )
        host_where, dev_where = split_host_predicate(rest_where)
        self._dev_where = dev_where
        self._host_where = host_where
        self._pk_names = tuple(pk_names)
        self._pk_mask_cache = (None, None)  # (layout generation, mask)
        for c in predicate_columns(dev_where) | predicate_columns(host_where):
            if c not in table:
                raise QueryError(f"no such column {select.table}.{c}")
        # host terms need their columns decoded: extend the projection
        # with any not already selected; only the first _n_vis cells are
        # client-visible (emitted / diffed)
        self._n_vis = len(self._proj_idx)
        self._host_cols = sorted(predicate_columns(host_where))
        self._host_pos = {}
        for c in self._host_cols:
            if c in self.columns:
                self._host_pos[c] = self.columns.index(c)
            else:
                self._host_pos[c] = len(self._proj_idx)
                self._proj_idx.append(layout.col_index(select.table, c))
        self._row_key = layout.row_key  # slot -> (table, pk) | None

        self._eval = self._build_eval()
        self._prev_match = np.zeros((cap,), bool)
        self._prev_proj = np.zeros((cap, len(self._proj_idx)), np.int32)
        self._init_events(max_buffer)

    def _build_eval(self):
        """Compile the value-column WHERE terms to the current rank space."""
        select, layout = self.select, self._layout_ref
        start, cap = self._start, self._cap
        # Live universes intern lazily; a literal ranked by its would-be
        # insertion edge would go stale the moment a row stores it (the
        # stored rank lands at a midpoint, not the edge). Interning every
        # literal first gives it a permanent rank, so the baked comparison
        # constants stay correct for values arriving later; any respace
        # this triggers lands before compilation and rebinds other
        # matchers through the normal remap path.
        # Intern EVERY value the compiled program will bake as a constant
        # (predicate literals AND column defaults) BEFORE compiling: a
        # lazy intern can trigger a respace, and constants captured before
        # a respace would be stale. After this block every needed value
        # has a permanent rank, so the rank() calls below are pure lookups.
        col_defaults = []
        if hasattr(self.universe, "rank"):
            self.universe.rank(None)
            for lit in predicate_intern_values(self._dev_where):
                self.universe.rank(lit)
            for c in layout.table_columns(select.table):
                d = layout.column_default(select.table, c)
                if d is not None:
                    self.universe.rank(d)
                    col_defaults.append(
                        (layout.col_index(select.table, c), d)
                    )
        pred = compile_predicate(
            self._dev_where, self.universe,
            lambda c: layout.col_index(select.table, c),
        )
        proj = tuple(self._proj_idx)
        node_idx = self.node

        # Declared column defaults: a never-written cell of a live row
        # reads as its DEFAULT (SQLite materializes it at INSERT). Baked
        # as rank constants; rebind() recompiles after any respace.
        dflt_planes_np = np.asarray([p for p, _ in col_defaults], np.int32)
        dflt_ranks_np = np.asarray(
            [self.universe.rank(d) for _, d in col_defaults], np.int32
        )

        # (device, planes) -> (projection index, default fill), uploaded
        # once
        dev_consts: dict = {}

        def evaluate(vr_all, cl_all):
            check_slice(vr_all, start, cap)
            key = (vr_all.device, vr_all.shape[2])
            if key not in dev_consts:
                fill = None
                if len(dflt_planes_np):
                    fill_np = np.full((vr_all.shape[2],), NEG, np.int32)
                    fill_np[dflt_planes_np] = dflt_ranks_np
                    fill = torch.as_tensor(fill_np, device=key[0])
                dev_consts[key] = (
                    torch.as_tensor(np.asarray(proj, np.int64),
                                    device=key[0]),
                    fill,
                )
            proj_t, fill = dev_consts[key]
            vr = vr_all[node_idx, start:start + cap]
            cl = cl_all[node_idx, start:start + cap]
            if fill is not None:
                vr = torch.where(vr == NEG, fill[None, :], vr)
            unset = vr == NEG
            live = (cl % 2) == 1
            match = pred(vr, unset) & live
            prj = vr[:, proj_t] if proj else vr[:, :0]
            return match, prj

        # Batch plan: the predicate's structure skeleton + flat
        # constant vectors. Matchers sharing (skeleton, table range,
        # projection width, default count) ride ONE group evaluation in
        # SubsManager.step — the observer node, columns, literals and
        # defaults all travel as batched inputs. Rebuilt here so
        # rebind() (rank respace) refreshes the constants with the
        # compiled predicate.
        plan = predicate_batch_plan(
            self._dev_where, self.universe,
            lambda c: layout.col_index(select.table, c),
        )
        if plan is not None:
            skeleton, consts = plan
            self._batch_sig = (
                skeleton, start, cap, len(proj), len(col_defaults),
            )
            self._batch_consts = consts
            self._batch_proj = np.asarray(proj, np.int32)
            self._batch_dflt_planes = dflt_planes_np
            self._batch_dflt_ranks = dflt_ranks_np
        else:
            self._batch_sig = None

        return evaluate

    def rebind(self, old_ranks, new_ranks) -> None:
        """Adopt a re-spaced rank universe (LiveUniverse remap).

        Rank constants baked into the compiled predicate are stale, and the
        previous projection snapshot is in the old space — recompile the
        eval and translate the snapshot so no spurious UPDATE events fire.
        """
        self._eval = self._build_eval()
        if self._prev_proj.size:
            from corro_sim_torch.utils.ranks import translate_ranks

            self._prev_proj = translate_ranks(
                self._prev_proj.astype(np.int64), old_ranks, new_ranks
            ).astype(np.int32)

    # ---- the candidate filter (filter_matchable_change analog) ----------
    def is_candidate(self, touched) -> bool:
        """``touched``: set of (table, column|None) committed this round;
        None column = structural change (insert/delete of a row)."""
        if touched is None:
            return True
        watched = self.select.referenced_columns() | set(self.columns)
        for t, c in touched:
            if t != self.select.table:
                continue
            if c is None or c in watched:
                return True
        return False

    def _decode_row(self, slot: int, proj_row) -> list:
        key = self._row_key(self._start + slot)
        pk = list(key[1]) if key else []
        cells = []
        for rank in proj_row[: self._n_vis]:  # host-only cols stay hidden
            cells.append(
                None if rank == int(NEG) else self.universe.decode(int(rank))
            )
        return pk + cells

    def _pk_mask(self):
        """(cap,) bool of slots whose pk tuple satisfies the pk WHERE terms;
        None when the query has no pk terms. Cached per layout generation
        (slots allocate append-only, so the mask only grows)."""
        if self._pk_where is None:
            return None
        gen = getattr(self._layout_ref, "generation", 0)
        cached_gen, mask = self._pk_mask_cache
        if cached_gen == gen:
            return mask
        mask = np.zeros((self._cap,), bool)
        for s in range(self._cap):
            key = self._row_key(self._start + s)
            if key is None:
                continue
            pk = dict(zip(self._pk_names, key[1]))
            mask[s] = eval_predicate_py(self._pk_where, pk.get)
        self._pk_mask_cache = (gen, mask)
        return mask

    def _evaluate(self, table_state, precomputed=None):
        if precomputed is not None:
            # this matcher's rows of a batched group eval
            # (SubsManager._batched_precompute) — device work and the
            # device→host transfer already happened, once per GROUP
            match, proj = precomputed
        else:
            match, proj = read_match_proj(
                *self._eval(table_state.vr, table_state.cl)
            )
        pk_mask = self._pk_mask()
        if pk_mask is not None:
            match = match & pk_mask
        if self._host_where is not None:
            match = match.copy()
            for s in np.nonzero(match)[0]:
                vals = {
                    c: (None if proj[s, j] == int(NEG)
                        else self.universe.decode(int(proj[s, j])))
                    for c, j in self._host_pos.items()
                }
                if not eval_predicate_py(self._host_where, vals.get):
                    match[s] = False
        return match, proj

    def prime(self, table_state):
        """Initial query run → columns header, row events, end-of-query
        (``Matcher::run`` initial scan, ``pubsub.rs:1298-1430``)."""
        match, proj = self._evaluate(table_state)
        self._prev_match, self._prev_proj = match, proj
        self._primed = True
        pk_cols = [c for c in (self._pk_cols() or ())]
        header = {"columns": pk_cols + self.columns}
        rows = [
            {"row": [int(s) + self._start, self._decode_row(s, proj[s])]}
            for s in np.nonzero(match)[0]
        ]
        eoq = {"eoq": {"change_id": self._change_id}}
        return [header, *rows, eoq]

    def _pk_cols(self):
        key_probe = self._row_key(self._start) or (None, ())
        # pk column names come from the layout's schema when present
        schema = getattr(self._row_key, "schema", None)
        if schema is not None:
            t = schema.tables.get(self.select.table)
            if t is not None:
                return t.pk
        return ("pk",) * len(key_probe[1]) if key_probe[1] else ()

    def step(self, table_state, precomputed=None) -> list:
        """Re-evaluate and emit change events for the delta."""
        if not self._primed:
            raise RuntimeError("matcher not primed — call prime() first")
        match, proj = self._evaluate(table_state, precomputed=precomputed)
        events = []
        ins = match & ~self._prev_match
        dele = ~match & self._prev_match
        # diff only the client-visible cells: a change in a host-predicate
        # column that doesn't flip the match is not an UPDATE (the
        # reference's query-table diff sees only selected columns)
        n = self._n_vis
        upd = (
            match
            & self._prev_match
            & (proj[:, :n] != self._prev_proj[:, :n]).any(axis=1)
        )
        for kind, mask in (("insert", ins), ("update", upd), ("delete", dele)):
            for s in np.nonzero(mask)[0]:
                self._emit(events, kind, int(s) + self._start,
                           self._decode_row(s, proj[s]))
        self._prev_match, self._prev_proj = match, proj
        self._buffer_events(events)
        return events


class JoinMatcher(_EventStream):
    """A registered equi-join-chain query (N-way chains).

    The reference's Matcher rewrites arbitrary multi-table SELECTs into
    per-table queries with pk-alias injection and temp-table constraints
    (``pubsub.rs:697-832``). The tensor shape: each side is a regular
    single-table :class:`Matcher` (device rank-space predicate → match
    mask + projected ranks); the chain then pairs matched row sets link by
    link on join-key *value* (ranks decode through the shared universe, so
    rank equality IS value equality across columns), and the diff-to-events
    machinery runs over the joined tuples. A LEFT link keeps unmatched
    earlier-side rows with NULL cells for its side; each ON may reference
    any earlier alias (``a JOIN b ON a.x=b.x JOIN c ON a.y=c.y``).
    """

    def __init__(self, sub_id, select: Select, node: int, layout, universe,
                 max_buffer: int = 512):
        self.id = sub_id
        self.select = select
        self.node = node
        self.universe = universe
        left_alias = select.alias or select.table
        self._aliases = [left_alias]
        self._alias_tables = {left_alias: select.table}
        for j in select.joins:
            if j.alias in self._alias_tables:
                raise QueryError("join sides need distinct aliases")
            self._alias_tables[j.alias] = j.table
            self._aliases.append(j.alias)

        def split_q(name, what):
            if "." not in name:
                raise QueryError(
                    f"{what} must be alias-qualified in a JOIN: {name!r}"
                )
            a, c = name.split(".", 1)
            if a not in self._alias_tables:
                raise QueryError(f"unknown alias {a!r} in {name!r}")
            return a, c

        # per join link: ("eq", (earlier_alias, col), (new_alias, col),
        # kind) — hash-probe equality — or ("expr", expr_ast, new_alias,
        # kind, {alias: [cols]}) — a non-equality ON evaluated per
        # candidate pair (the reference accepts arbitrary ON because
        # SQLite executes it, pubsub.rs:697-832).
        self._links = []
        on_need: dict = {a: set() for a in self._aliases}
        for i, j in enumerate(select.joins):
            if j.on_expr is not None:
                from corro_sim_torch.api.exprs import columns_of

                refs: dict = {}
                for q in columns_of(j.on_expr):
                    a, c = split_q(q, "ON")
                    refs.setdefault(a, []).append(c)
                    on_need[a].add(c)
                self._links.append(("expr", j.on_expr, j.alias, j.kind,
                                    refs))
                continue
            la, lc = split_q(j.on_left, "ON left")
            ra, rc = split_q(j.on_right, "ON right")
            if ra != j.alias and la == j.alias:
                (la, lc), (ra, rc) = (ra, rc), (la, lc)
            earlier = set(self._aliases[: i + 1])
            if ra != j.alias or la not in earlier:
                raise QueryError(
                    f"JOIN ON must link {j.alias!r} to an earlier side: "
                    f"{j.on_left!r} = {j.on_right!r}"
                )
            self._links.append(("eq", (la, lc), (ra, rc), j.kind))
            on_need[la].add(lc)
            on_need[ra].add(rc)

        # ---- selected output columns, in SELECT order -------------------
        def side_schema(alias):
            t = self._alias_tables[alias]
            return (tuple(layout.pk_columns(t)), list(layout.table_columns(t)))

        if select.columns:
            out_cols = [split_q(c, "a selected column")
                        for c in select.columns]
        else:
            out_cols = []
            for alias in self._aliases:
                pks, vals = side_schema(alias)
                out_cols.extend((alias, c) for c in (*pks, *vals))
        self._out_cols = out_cols
        self.columns = [f"{a}.{c}" for a, c in out_cols]

        # ---- WHERE routing: each conjunct goes to exactly one side ------
        side_where: dict = {a: [] for a in self._aliases}
        parts = (select.where.parts if isinstance(select.where, And)
                 else (select.where,)) if select.where is not None else ()
        for p in parts:
            aliases = {split_q(c, "a WHERE column")[0]
                       for c in predicate_columns(p)}
            if len(aliases) != 1:
                raise QueryError(
                    "each WHERE conjunct in a JOIN must reference exactly "
                    "one side (the reference rewrites per-table queries "
                    "the same way)"
                )
            side_where[aliases.pop()].append(p)

        # ---- per-side single-table matchers -----------------------------
        self._sides = {}
        for alias in self._aliases:
            tbl = self._alias_tables[alias]
            pks, vals = side_schema(alias)
            need = [c for a, c in out_cols if a == alias and c in vals]
            for on_c in sorted(on_need[alias]):
                if on_c in vals and on_c not in need:
                    need.append(on_c)
                if on_c not in vals and on_c not in pks:
                    raise QueryError(
                        f"no such join column {alias}.{on_c}"
                    )
            for c in (c for a, c in out_cols if a == alias):
                if c not in vals and c not in pks:
                    raise QueryError(f"no such column {alias}.{c}")
            ps = side_where[alias]
            w = None if not ps else (ps[0] if len(ps) == 1 else And(tuple(ps)))
            w = rewrite_columns(w, lambda c: c.split(".", 1)[1])
            self._sides[alias] = Matcher(
                f"{sub_id}:{alias}",
                Select(table=tbl, columns=tuple(need), where=w),
                node, layout, universe, max_buffer=0,
            )
        self._rowspan = getattr(layout, "total_rows", 1 << 20)

        self._prev: dict[int, list] = {}
        # incremental tuple engine state (inner-only chains; LEFT links
        # fall back to full rebuilds — a right-side removal can resurrect
        # null-extended tuples, which restricted rebuilds cannot see)
        self._side_cache: dict | None = None
        self._tuples: dict[int, list] = {}
        self._changed: dict[int, list | None] = {}  # rid → pre-build cells
        self._rid_slots: dict[int, tuple] = {}
        self._by_slot: dict[tuple, set] = {}
        self._has_left = any(link[3] == "left" for link in self._links)
        self.stats = {
            "full_joins": 0,
            "incremental_joins": 0,
            "tuples_rebuilt": 0,
            "groups_refolded": 0,
        }
        self._init_events(max_buffer)

    # ------------------------------------------------------------ plumbing
    def rebind(self, old_ranks, new_ranks) -> None:
        for m in self._sides.values():
            m.rebind(old_ranks, new_ranks)
        # self._prev holds DECODED values, not ranks — nothing to translate

    def is_candidate(self, touched) -> bool:
        if touched is None:
            return True
        tables = set(self._alias_tables.values())
        return any(t in tables for t, _ in touched)

    def _cell_pos(self, alias, col):
        """Index of ``col`` in the side matcher's decoded row."""
        m = self._sides[alias]
        if col in m._pk_names:
            return m._pk_names.index(col)
        return len(m._pk_names) + m.columns.index(col)

    def _side_rows(self, alias, table_state):
        """{global slot: decoded [pk…, cols…]} of the side's matched rows."""
        m = self._sides[alias]
        match, proj = m._evaluate(table_state)
        out = {}
        for s in np.nonzero(match)[0]:
            out[int(s) + m._start] = m._decode_row(s, proj[s])
        return out

    def _rid_of(self, slots) -> int:
        rid = slots[0]
        for s in slots[1:]:
            rid = rid * (self._rowspan + 1) + s
        return rid

    def _slot_pairs(self, slots):
        """(alias, slot) pairs a tuple's rows occupy (nulls excluded)."""
        pairs = [(self._aliases[0], slots[0])]
        for i, s in enumerate(slots[1:]):
            if s != 0:
                pairs.append((self._aliases[i + 1], s - 1))
        return pairs

    def _join(self, table_state) -> dict:
        """{rowid: output cells} of the current join-chain result — kept
        incrementally when the chain is inner-only: only tuples touching
        a changed/added/removed side row rebuild (restricted chain
        builds), the rest carry over. The reference diffs candidate pks
        through its temp-table EXCEPT dance the same way
        (``pubsub.rs:1518-1793``)."""
        side_rows = {
            a: self._side_rows(a, table_state) for a in self._aliases
        }
        if self._side_cache is None or self._has_left:
            cur = self._full_build(side_rows)
        else:
            cur = self._incr_build(side_rows)
        if not self._has_left:
            # LEFT chains always full-rebuild: the slot index and side
            # snapshot would never be read — skip maintaining them
            self._side_cache = side_rows
        self._tuples = cur
        return cur

    def _register(self, rid, slots, cells, out) -> None:
        """Install one tuple + its slot-index entries (the invariant the
        incremental drop loop relies on: _rid_slots and _by_slot always
        agree)."""
        out[rid] = cells
        self._rid_slots[rid] = slots
        for pair in self._slot_pairs(slots):
            self._by_slot.setdefault(pair, set()).add(rid)

    def _full_build(self, side_rows) -> dict:
        self.stats["full_joins"] += 1
        parts = self._chain(side_rows)
        self._rid_slots = {}
        self._by_slot = {}
        out = {}
        old = self._tuples
        if self._has_left:
            for slots, sides in parts:
                out[self._rid_of(slots)] = self._project(sides)
        else:
            for slots, sides in parts:
                self._register(
                    self._rid_of(slots), slots, self._project(sides), out
                )
        # changed-rid record for the group-local aggregate step
        self._changed = {
            rid: old.get(rid)
            for rid in (out.keys() | old.keys())
            if out.get(rid) != old.get(rid)
        }
        self.stats["tuples_rebuilt"] += len(out)
        return out

    def _incr_build(self, side_rows) -> dict:
        self.stats["incremental_joins"] += 1
        old = self._side_cache
        diffs = {}
        for a in self._aliases:
            o, nw = old[a], side_rows[a]
            added = nw.keys() - o.keys()
            removed = o.keys() - nw.keys()
            changed = {
                s for s in (nw.keys() & o.keys()) if nw[s] != o[s]
            }
            diffs[a] = (added, removed, changed)

        # drop every tuple touching a removed/changed row
        touched: set = set()
        for a in self._aliases:
            added, removed, changed = diffs[a]
            for s in removed | changed:
                touched |= self._by_slot.get((a, s), set())
        cur = self._tuples  # mutated in place; _join rebinds it anyway
        self._changed = {}
        for rid in touched:
            self._changed[rid] = cur.pop(rid, None)
            for pair in self._slot_pairs(self._rid_slots.pop(rid)):
                self._by_slot.get(pair, set()).discard(rid)

        # rebuild tuples that contain at least one added/changed row:
        # one chain build per changed side, that side restricted to its
        # changed rows (union over sides covers multi-side tuples; the
        # dict assignment dedupes)
        rebuilt = 0
        for a in self._aliases:
            added, removed, changed = diffs[a]
            probe = added | changed
            if not probe:
                continue
            restricted = dict(side_rows)
            restricted[a] = {s: side_rows[a][s] for s in probe}
            for slots, sides in self._chain(restricted):
                rid = self._rid_of(slots)
                if rid in cur:
                    continue
                self._register(rid, slots, self._project(sides), cur)
                self._changed.setdefault(rid, None)
                rebuilt += 1
        # a dropped-and-rebuilt tuple whose cells came back identical is
        # not a change
        self._changed = {
            rid: old for rid, old in self._changed.items()
            if cur.get(rid) != old
        }
        self.stats["tuples_rebuilt"] += rebuilt
        return cur

    def _chain(self, side_rows) -> list:
        """Join tuples as (slots, sides) parts, built link by link: each
        link probes its side's matched rows (indexed by decoded ON-key
        value) from every partial tuple; a LEFT link keeps
        keyless/matchless tuples with a NULL side. The synthetic rowid is
        the mixed-radix (slot+1) tuple over rowspan — stable for a given
        combination of source rows."""
        a0 = self._aliases[0]
        parts = [
            ((ls,), {a0: cells}) for ls, cells in side_rows[a0].items()
        ]
        for link in self._links:
            if link[0] == "expr":
                _, expr, ra, kind, refs = link
                parts = self._expr_link(
                    parts, side_rows, expr, ra, kind, refs
                )
                continue
            _, (la, lc), (ra, rc), kind = link
            rpos = self._cell_pos(ra, rc)
            ridx: dict = {}
            for rs, cells in side_rows[ra].items():
                v = cells[rpos]
                if v is None:
                    continue  # SQL: NULL join keys never match
                ridx.setdefault(sqlite_sort_key(v), []).append(rs)
            lpos = self._cell_pos(la, lc)
            nxt = []
            for slots, sides in parts:
                lcells = sides.get(la)
                v = None if lcells is None else lcells[lpos]
                matches = (
                    ridx.get(sqlite_sort_key(v), []) if v is not None else []
                )
                if matches:
                    for rs in matches:
                        nxt.append(
                            (slots + (rs + 1,),
                             {**sides, ra: side_rows[ra][rs]})
                        )
                elif kind == "left":
                    nxt.append((slots + (0,), {**sides, ra: None}))
            parts = nxt
        return parts

    def _expr_link(self, parts, side_rows, expr, ra, kind, refs):
        """One non-equality join link: nested-loop over (partial tuple ×
        candidate row), keeping pairs whose ON expression is TRUE (SQL
        semantics: UNKNOWN drops the pair; LEFT keeps matchless tuples
        with a NULL side)."""
        from corro_sim_torch.api.exprs import eval_expr

        pos = {
            (a, c): self._cell_pos(a, c)
            for a, cols in refs.items() for c in cols
        }
        cand = list(side_rows[ra].items())
        nxt = []
        for slots, sides in parts:
            env = {}
            for a, cols in refs.items():
                if a == ra:
                    continue
                cells = sides.get(a)
                for c in cols:
                    env[f"{a}.{c}"] = (
                        None if cells is None else cells[pos[(a, c)]]
                    )
            matched = False
            for rs, rcells in cand:
                for c in refs.get(ra, ()):
                    env[f"{ra}.{c}"] = rcells[pos[(ra, c)]]
                if eval_expr(expr, env) is True:
                    matched = True
                    nxt.append(
                        (slots + (rs + 1,), {**sides, ra: rcells})
                    )
            if not matched and kind == "left":
                nxt.append((slots + (0,), {**sides, ra: None}))
        return nxt

    def _project(self, sides) -> list:
        out = []
        for a, c in self._out_cols:
            cells = sides.get(a)
            out.append(None if cells is None else cells[self._cell_pos(a, c)])
        return out

    # ------------------------------------------------------------- surface
    def prime(self, table_state):
        cur = self._join(table_state)
        self._changed = {}
        self._primed = True
        header = {"columns": list(self.columns)}
        rows = [
            {"row": [rid, cur[rid]]} for rid in sorted(cur)
        ]
        eoq = {"eoq": {"change_id": self._change_id}}
        return [header, *rows, eoq]

    def step(self, table_state) -> list:
        """Emit the join diff — driven by the build's changed-rid record
        (old cells per changed rid), so steady-state cost follows the
        CHANGE size, not the join size."""
        if not self._primed:
            raise RuntimeError("matcher not primed — call prime() first")
        cur = self._join(table_state)
        events: list = []
        for rid in sorted(self._changed):
            oc = self._changed[rid]
            nc = cur.get(rid)
            if oc is None and nc is not None:
                self._emit(events, "insert", rid, nc)
            elif nc is None and oc is not None:
                self._emit(events, "delete", rid, oc)
            elif nc is not None and oc is not None:
                self._emit(events, "update", rid, nc)
        self._buffer_events(events)
        return events


class AggregateMatcher(Matcher):
    """Live GROUP BY / aggregate subscription (single table).

    The reference's Matcher maintains ANY SELECT — aggregates included —
    by re-running rewritten SQL and diffing its query table
    (``pubsub.rs:697-832,1518-1793``). Here aggregates are maintained
    *incrementally* from the row-level diff the inner matcher already
    computes: COUNT/SUM/AVG retract-and-add per-group accumulators;
    MIN/MAX additionally keep the group's member set and rescan it when
    the current extremum retracts (a removed non-extremum never needs a
    scan). Each group is one feed row with a stable synthetic rowid;
    events are the same INSERT/UPDATE/DELETE stream row subscriptions
    emit, with group state changes coalesced per round.

    Aggregate state is kept in decoded VALUE space (not ranks), so a
    LiveUniverse respace only translates the inherited row snapshot —
    accumulators survive rebind untouched.
    """

    def __init__(self, sub_id, select: Select, node: int, layout, universe,
                 max_buffer: int = 512):
        self._agg_select = select
        base = select.base()
        super().__init__(sub_id, base, node, layout, universe,
                         max_buffer=max_buffer)
        # the registry keys dedupe/removal on the FULL aggregate SQL —
        # self.select must normalize back to it, not to the base form
        # (which could collide with a plain subscription's key)
        self.select = select
        # decoded-row positions: pk prefix, then the base visible columns
        pk_cols = list(self._pk_cols() or ())
        pos = {c: i for i, c in enumerate(pk_cols + self.columns)}

        def need(col):
            if col not in pos:
                raise QueryError(
                    f"no such column {select.table}.{col}"
                )
            return pos[col]

        self._gpos = [need(c) for c in select.group_by]
        self._items = []  # ('col', pos) | ('agg', Agg, pos|None)
        for kind, it in select.items:
            if kind == "col":
                self._items.append(("col", need(it)))
            else:
                self._items.append(
                    ("agg", it, None if it.col is None else need(it.col))
                )
        # group key -> state; slot -> key; key -> member slot set
        self._groups: dict = {}
        self._grp_of_slot: dict = {}
        self._next_rid = 0

    # ---- group accumulator plumbing -----------------------------------
    def _new_group(self, key, disp):
        rid = self._next_rid
        self._next_rid += 1
        g = {
            "key": key,
            "disp": disp,  # first-seen display values of the group cols
            "rid": rid,
            "count": 0,
            "members": set(),
            # per aggregate item: [int_total, float_total, nonnull,
            # floats] for COUNT/SUM/AVG — the int part is an exact Python
            # int so integer sums never round; [extremum | None] for
            # MIN/MAX
            "acc": [
                ([None] if it[1].fn in ("MIN", "MAX") else [0, 0.0, 0, 0])
                for it in self._items if it[0] == "agg"
            ],
            "mmdirty": set(),  # agg indices needing a member rescan:
            # a MIN/MAX whose extremum retracted, or a SUM/AVG that
            # retracted a FLOAT contribution (float subtraction leaves
            # residue — 1e100 + 1 - 1e100 is 0.0, not 1 — so parity with
            # the one-shot path needs a recompute; int retraction is exact)
            "emitted": None,  # cells last sent to subscribers
        }
        self._groups[key] = g
        return g

    def _row_vals(self, slot, proj_row):
        return self._decode_row(slot, proj_row)

    def _key_of(self, vals):
        return tuple(sqlite_sort_key(vals[i]) for i in self._gpos)

    def _apply(self, g, vals, sign):
        """Add (+1) or retract (-1) one member row's contribution.

        MIN/MAX keep the current extremum cached: an add is one
        comparison; a retract rescans the member set ONLY when the
        retracted value ties the cached extremum (rescan-on-retract,
        deferred to :meth:`_agg_cells` via ``mmdirty``)."""
        g["count"] += sign
        ai = 0
        for item in self._items:
            if item[0] != "agg":
                continue
            agg, p = item[1], item[2]
            acc = g["acc"][ai]
            ai += 1
            if agg.fn == "COUNT":
                if p is None or vals[p] is not None:
                    acc[2] += sign
                continue
            v = vals[p]
            if v is None:
                continue
            if agg.fn in ("SUM", "AVG"):
                if (ai - 1) in g["mmdirty"]:
                    continue  # rescan pending — it recomputes everything
                n = _sql_number(v)
                if isinstance(n, float) and sign < 0:
                    g["mmdirty"].add(ai - 1)  # inexact: rescan
                    continue
                acc[2] += sign
                if isinstance(n, float):
                    acc[1] += n
                    acc[3] += 1
                else:
                    acc[0] += sign * n  # exact Python-int arithmetic
                continue
            # MIN | MAX
            cur = acc[0]
            if sign > 0:
                if (ai - 1) in g["mmdirty"]:
                    continue  # stale cache; rescan already pending
                kv = sqlite_sort_key(v)
                if cur is None or (
                    kv < sqlite_sort_key(cur) if agg.fn == "MIN"
                    else kv > sqlite_sort_key(cur)
                ):
                    acc[0] = v
            elif cur is not None and (
                sqlite_sort_key(v) == sqlite_sort_key(cur)
            ):
                g["mmdirty"].add(ai - 1)

    def _agg_cells(self, g):
        """Output cells for a group; MIN/MAX rescan members only when
        their cached extremum retracted (``mmdirty``)."""
        cells = []
        ai = 0
        scanned: dict = {}
        for item in self._items:
            if item[0] == "col":
                # the parser guarantees plain cols appear in GROUP BY
                cells.append(g["disp"][self._gpos.index(item[1])])
                continue
            agg, p = item[1], item[2]
            acc = g["acc"][ai]
            ai += 1
            if agg.fn == "COUNT":
                cells.append(g["count"] if p is None else acc[2])
            elif agg.fn in ("SUM", "AVG"):
                if (ai - 1) in g["mmdirty"]:
                    # recompute from members in slot order (the same
                    # order the one-shot path folds rows)
                    acc[0], acc[1], acc[2], acc[3] = 0, 0.0, 0, 0
                    for s in sorted(g["members"]):
                        v = self._member_val(s, p)
                        if v is None:
                            continue
                        nv = _sql_number(v)
                        acc[2] += 1
                        if isinstance(nv, float):
                            acc[1] += nv
                            acc[3] += 1
                        else:
                            acc[0] += nv
                    g["mmdirty"].discard(ai - 1)
                total = acc[0] + acc[1] if acc[3] else acc[0]
                if agg.fn == "SUM":
                    cells.append(sum_cell(total, acc[2], acc[3]))
                else:
                    cells.append(avg_cell(total, acc[2]))
            else:  # MIN | MAX
                if (ai - 1) in g["mmdirty"]:
                    if p not in scanned:
                        scanned[p] = [
                            v for v in (
                                self._member_val(s, p) for s in g["members"]
                            ) if v is not None
                        ]
                    vals = scanned[p]
                    if not vals:
                        acc[0] = None
                    elif agg.fn == "MIN":
                        acc[0] = min(vals, key=sqlite_sort_key)
                    else:
                        acc[0] = max(vals, key=sqlite_sort_key)
                    g["mmdirty"].discard(ai - 1)
                cells.append(acc[0])
        return cells

    def _member_val(self, slot, pos):
        row = self._row_vals(slot, self._prev_proj[slot])
        return row[pos]

    # ---- surface -------------------------------------------------------
    def prime(self, table_state):
        """Initial (or re-attach) snapshot. Idempotent: accumulators are
        rebuilt from scratch, but a persisting group keeps its rowid and
        last-emitted cells so earlier subscribers' diffs stay coherent
        (the dedupe path re-primes a live matcher)."""
        match, proj = self._evaluate(table_state)
        self._prev_match, self._prev_proj = match, proj
        self._primed = True
        old_groups = self._groups
        self._groups = {}
        self._grp_of_slot = {}
        for s in np.nonzero(match)[0]:
            s = int(s)
            vals = self._row_vals(s, proj[s])
            key = self._key_of(vals)
            g = self._groups.get(key)
            if g is None:
                g = self._new_group(
                    key, [vals[i] for i in self._gpos] or [None]
                )
                prev = old_groups.get(key)
                if prev is not None:
                    g["rid"] = prev["rid"]
                    g["emitted"] = prev["emitted"]
            g["members"].add(s)
            self._grp_of_slot[s] = key
            self._apply(g, vals, +1)
        if not self._agg_select.group_by and not self._groups:
            # SQLite: an ungrouped aggregate query yields exactly one row
            # even over zero matches (COUNT 0, SUM/MIN/MAX NULL)
            g = self._new_group((), [None])
            prev = old_groups.get(())
            if prev is not None:
                g["rid"] = prev["rid"]
                g["emitted"] = prev["emitted"]
        header = {"columns": [
            (name if kind == "col" else name.label())
            for kind, name in self._agg_select.items
        ]}
        rows = []
        for g in sorted(self._groups.values(), key=lambda g: g["rid"]):
            g["emitted"] = self._agg_cells(g)
            rows.append({"row": [g["rid"], g["emitted"]]})
        eoq = {"eoq": {"change_id": self._change_id}}
        return [header, *rows, eoq]

    def step(self, table_state) -> list:
        if not self._primed:
            raise RuntimeError("matcher not primed — call prime() first")
        match, proj = self._evaluate(table_state)
        prev_match, prev_proj = self._prev_match, self._prev_proj
        n = self._n_vis
        ins = match & ~prev_match
        dele = ~match & prev_match
        upd = (
            match & prev_match
            & (proj[:, :n] != prev_proj[:, :n]).any(axis=1)
        )
        touched: set = set()
        # retract old contributions FIRST (an update may move groups)
        for s in np.nonzero(dele | upd)[0]:
            s = int(s)
            old = self._row_vals(s, prev_proj[s])
            key = self._grp_of_slot.pop(s)
            g = self._groups[key]
            g["members"].discard(s)
            self._apply(g, old, -1)
            touched.add(key)
        # the inherited snapshot feeds _member_val — update it between
        # retract (old ranks) and add/rescan (new ranks)
        self._prev_match, self._prev_proj = match, proj
        for s in np.nonzero(ins | upd)[0]:
            s = int(s)
            vals = self._row_vals(s, proj[s])
            key = self._key_of(vals)
            g = self._groups.get(key) or self._new_group(
                key, [vals[i] for i in self._gpos] or [None]
            )
            g["members"].add(s)
            self._grp_of_slot[s] = key
            self._apply(g, vals, +1)
            touched.add(key)
        events: list = []
        for key in sorted(
            touched, key=lambda k: self._groups[k]["rid"]
        ):
            g = self._groups[key]
            if g["count"] <= 0 and self._agg_select.group_by:
                # group vanished (with GROUP BY; the ungrouped single row
                # stays and reads COUNT 0 / NULL aggregates)
                del self._groups[key]
                if g["emitted"] is not None:
                    self._emit(events, "delete", g["rid"], g["emitted"])
                continue
            cells = self._agg_cells(g)
            if g["emitted"] is None:
                self._emit(events, "insert", g["rid"], cells)
            elif cells != g["emitted"]:
                self._emit(events, "update", g["rid"], cells)
            g["emitted"] = cells
        self._buffer_events(events)
        return events


class JoinAggregateMatcher(JoinMatcher):
    """Live aggregates / GROUP BY over a join chain.

    Strategy: recompute-and-diff — the joined row set is re-derived per
    step (it already is, for plain join subscriptions) and folded into
    groups whose output cells are diffed against the last emitted state.
    This is the reference's own approach for arbitrary SELECTs: it re-runs
    the rewritten SQL and diffs the query table
    (``pubsub.rs:697-832,1518-1793``). Single-table aggregates keep the
    cheaper incremental :class:`AggregateMatcher` path.
    """

    def __init__(self, sub_id, select: Select, node: int, layout, universe,
                 max_buffer: int = 512):
        self._agg_select = select
        super().__init__(sub_id, select.base(), node, layout, universe,
                         max_buffer=max_buffer)
        # dedupe/removal keys on the full aggregate SQL, not the base form
        self.select = select
        pos = {c: i for i, c in enumerate(self.columns)}

        def need(col):
            if col not in pos:
                raise QueryError(f"no such column {col!r} in join output")
            return pos[col]

        self._gpos = [need(c) for c in select.group_by]
        self._items = []  # ('col', pos) | ('agg', Agg, pos|None)
        for kind, it in select.items:
            if kind == "col":
                self._items.append(("col", need(it)))
            else:
                self._items.append(
                    ("agg", it, None if it.col is None else need(it.col))
                )
        self.columns = [
            (name if kind == "col" else name.label())
            for kind, name in select.items
        ]
        self._rid_of_key: dict = {}
        self._next_rid = 0

    def _group_key(self, cells) -> tuple:
        return tuple(sqlite_sort_key(cells[i]) for i in self._gpos)

    def _fold_group(self, rows) -> list:
        out_cells = []
        for item in self._items:
            if item[0] == "col":
                out_cells.append(rows[0][item[1]] if rows else None)
                continue
            agg, p = item[1], item[2]
            out_cells.append(
                fold_aggregate(
                    agg, rows if p is None else [r[p] for r in rows]
                )
            )
        return out_cells

    def _groups_of(self, table_state) -> dict:
        """{group key: output cells} — full fold (prime path); also
        (re)builds the group→tuple index the incremental step maintains."""
        joined = self._join(table_state)
        self._group_rids = {}
        groups: dict = {}
        for rid, cells in sorted(joined.items()):
            key = self._group_key(cells)
            groups.setdefault(key, []).append(cells)
            self._group_rids.setdefault(key, set()).add(rid)
        if not self._agg_select.group_by and not groups:
            groups[()] = []  # SQLite: ungrouped aggregate = exactly one row
        out = {}
        for key, rows in groups.items():
            out[key] = self._fold_group(rows)
            self.stats["groups_refolded"] += 1
        return out

    def _rid(self, key) -> int:
        rid = self._rid_of_key.get(key)
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
            self._rid_of_key[key] = rid
        return rid

    def prime(self, table_state):
        cur = self._groups_of(table_state)
        self._changed = {}  # the snapshot consumed the build's diff
        self._prev = cur
        self._primed = True
        header = {"columns": list(self.columns)}
        rows = [
            {"row": [self._rid(key), cur[key]]}
            for key in sorted(cur, key=self._rid)
        ]
        eoq = {"eoq": {"change_id": self._change_id}}
        return [header, *rows, eoq]

    def step(self, table_state) -> list:
        """Group-local incremental aggregation: the join
        diff routes each changed tuple to its old/new group, and ONLY
        those groups refold — from the tuple store, not the tables. An
        update to one side of a 3-table join adjusts exactly the groups
        it touches (asserted via `stats['groups_refolded']` in
        tests/test_sub_aggregates.py)."""
        if not self._primed:
            raise RuntimeError("matcher not primed — call prime() first")
        cur_tuples = self._join(table_state)
        keys_touched: set = set()
        for rid, oc in self._changed.items():
            if oc is not None:
                k = self._group_key(oc)
                self._group_rids.get(k, set()).discard(rid)
                keys_touched.add(k)
            nc = cur_tuples.get(rid)
            if nc is not None:
                k = self._group_key(nc)
                self._group_rids.setdefault(k, set()).add(rid)
                keys_touched.add(k)
        events: list = []
        for key in sorted(keys_touched, key=self._rid):
            rids = self._group_rids.get(key, ())
            if not rids and (self._agg_select.group_by or key != ()):
                self._group_rids.pop(key, None)
                if key in self._prev:
                    self._emit(
                        events, "delete", self._rid(key),
                        self._prev.pop(key),
                    )
                continue
            cells = self._fold_group(
                [cur_tuples[r] for r in sorted(rids)]
            )
            self.stats["groups_refolded"] += 1
            if key not in self._prev:
                self._emit(events, "insert", self._rid(key), cells)
            elif cells != self._prev[key]:
                self._emit(events, "update", self._rid(key), cells)
            self._prev[key] = cells
        self._buffer_events(events)
        return events


def _has_inselect(p) -> bool:
    from corro_sim_torch.subs.query import And, InSelect, Not, Or

    if isinstance(p, InSelect):
        return True
    if isinstance(p, (And, Or)):
        return any(_has_inselect(q) for q in p.parts)
    if isinstance(p, Not):
        return _has_inselect(p.inner)
    return False


class SemiJoinMatcher(_EventStream):
    """``WHERE col [NOT] IN (SELECT …)`` as a live matcher. The
    reference gets this for free: SQLite evaluates the subquery
    inside the rewritten per-table query (``pubsub.rs:697-832``). Here
    each subquery runs as its own single-table matcher; per evaluation
    the outer predicate re-materializes with the subquery's CURRENT value
    set (InSelect → InList, compiled to rank space as usual), so changes
    to the INNER table re-shape the outer match set — a live semi-join.
    Events diff like the join matchers (recompute-and-diff)."""

    def __init__(self, sub_id, select: Select, node: int, layout, universe,
                 max_buffer: int = 512):
        from corro_sim_torch.subs.query import InSelect

        self.id = sub_id
        self.select = select
        self.node = node
        self.universe = universe
        self._layout = layout
        self._subqueries: list = []  # InSelect nodes, discovery order

        def find(p):
            if isinstance(p, InSelect):
                self._subqueries.append(p)
            elif isinstance(p, (And, Or)):
                for q in p.parts:
                    find(q)
            elif isinstance(p, Not):
                find(p.inner)

        from corro_sim_torch.subs.query import And, Not, Or

        find(select.where)
        self._inner = [
            Matcher(f"{sub_id}:sub{i}", q.select, node, layout, universe,
                    max_buffer=0)
            for i, q in enumerate(self._subqueries)
        ]
        # small LRU keyed by the subquery value sets: a flapping inner
        # table alternating between a few sets must not recompile the
        # outer matcher (a predicate compile each time) on every step
        self._outer_cache: dict = {}
        self._outer_serial = 0
        # column surface comes from a throwaway outer matcher with the
        # subqueries replaced by empty lists
        self._max_buffer = max_buffer
        m = self._outer_matcher(((),) * len(self._subqueries))
        # header matches Matcher.prime: pk prefix + selected value columns
        self.columns = list(m._pk_cols() or ()) + list(m.columns)
        self._pk_names = m._pk_names
        self._prev: dict[int, list] = {}
        self._init_events(max_buffer)

    def _rewrite(self, p, vsets_by_node: dict):
        from corro_sim_torch.subs.query import And, InList, InSelect, Not, Or

        if isinstance(p, InSelect):
            return InList(
                col=p.col, lits=vsets_by_node[id(p)], negated=p.negated
            )
        if isinstance(p, And):
            return And(tuple(self._rewrite(q, vsets_by_node)
                             for q in p.parts))
        if isinstance(p, Or):
            return Or(tuple(self._rewrite(q, vsets_by_node)
                            for q in p.parts))
        if isinstance(p, Not):
            return Not(self._rewrite(p.inner, vsets_by_node))
        return p

    def _outer_matcher(self, vsets: tuple) -> "Matcher":
        m = self._outer_cache.pop(vsets, None)
        if m is None:
            by_node = {
                id(q): vsets[i] for i, q in enumerate(self._subqueries)
            }
            sel = dataclasses.replace(
                self.select, where=self._rewrite(self.select.where, by_node)
            )
            self._outer_serial += 1
            m = Matcher(
                f"{self.id}:outer{self._outer_serial}", sel, self.node,
                self._layout, self.universe, max_buffer=0,
            )
        self._outer_cache[vsets] = m  # re-insert = most recent
        if len(self._outer_cache) > 8:
            self._outer_cache.pop(next(iter(self._outer_cache)))
        return m

    def _subquery_values(self, i: int, table_state) -> tuple:
        m = self._inner[i]
        match, proj = m._evaluate(table_state)
        vals = set()
        saw_null = False
        sq = self._subqueries[i]
        want = sq.select.columns[0]
        for s in np.nonzero(match)[0]:
            row = m._decode_row(s, proj[s])
            # selected column position within the decoded row
            if want in m._pk_names:
                v = row[m._pk_names.index(want)]
            else:
                v = row[len(m._pk_names) + m.columns.index(want)]
            if v is None:
                saw_null = True  # NOT IN with a NULL in the set → UNKNOWN
            else:
                vals.add(v)
        out = tuple(sorted(vals, key=sqlite_sort_key))
        # a NULL in the subquery result set must reach the InList
        # compiler's has_null handling (three-valued NOT IN semantics)
        return ((None,) if saw_null else ()) + out

    def _rows(self, table_state) -> dict:
        vsets = tuple(
            self._subquery_values(i, table_state)
            for i in range(len(self._inner))
        )
        m = self._outer_matcher(vsets)
        match, proj = m._evaluate(table_state)
        return {
            int(s) + m._start: m._decode_row(s, proj[s])
            for s in np.nonzero(match)[0]
        }

    # ------------------------------------------------------------ surface
    def rebind(self, old_ranks, new_ranks) -> None:
        for m in self._inner:
            m.rebind(old_ranks, new_ranks)
        self._outer_cache.clear()  # outer recompiles against fresh ranks

    def is_candidate(self, touched) -> bool:
        if touched is None:
            return True
        tables = {self.select.table} | {
            q.select.table for q in self._subqueries
        }
        return any(t in tables for t, _ in touched)

    def prime(self, table_state):
        cur = self._rows(table_state)
        self._prev = cur
        self._primed = True
        header = {"columns": list(self.columns)}
        rows = [{"row": [rid, cur[rid]]} for rid in sorted(cur)]
        eoq = {"eoq": {"change_id": self._change_id}}
        return [header, *rows, eoq]

    def step(self, table_state) -> list:
        if not self._primed:
            raise RuntimeError("matcher not primed — call prime() first")
        cur = self._rows(table_state)
        events: list = []
        for rid in sorted(cur.keys() - self._prev.keys()):
            self._emit(events, "insert", rid, cur[rid])
        for rid in sorted(cur.keys() & self._prev.keys()):
            if cur[rid] != self._prev[rid]:
                self._emit(events, "update", rid, cur[rid])
        for rid in sorted(self._prev.keys() - cur.keys()):
            self._emit(events, "delete", rid, self._prev[rid])
        self._prev = cur
        self._buffer_events(events)
        return events


def make_matcher(sub_id, select: Select, node: int, layout, universe,
                 max_buffer: int = 512):
    """Matcher factory: single-table, join chain, aggregate (incremental
    single-table / recompute-and-diff over joins), or semi-join
    (IN (SELECT …)) — same public surface."""
    if _has_inselect(select.where):
        if select.joins or select.aggregates:
            raise QueryError(
                "IN (SELECT …) combines with joins/aggregates only "
                "through the query post-processor, not subscriptions"
            )
        return SemiJoinMatcher(sub_id, select, node, layout, universe,
                               max_buffer=max_buffer)
    if select.aggregates:
        cls = JoinAggregateMatcher if select.joins else AggregateMatcher
        return cls(sub_id, select, node, layout, universe,
                   max_buffer=max_buffer)
    cls = JoinMatcher if select.joins else Matcher
    return cls(sub_id, select, node, layout, universe, max_buffer=max_buffer)


class LayoutAdapter:
    """Uniform matcher-facing view over TableLayout or an EncodedTrace."""

    def __init__(self, layout=None, trace=None):
        if (layout is None) == (trace is None):
            raise ValueError("exactly one of layout/trace required")
        self._layout = layout
        self._trace = trace
        if trace is not None:
            self._tcols = {}
            for t, c, p in trace.col_keys:
                self._tcols.setdefault(t, {})[c] = p
            self._ranges = {}
            for slot, key in enumerate(trace.row_keys):
                if key is None:
                    continue
                t = key[0]
                lo, hi = self._ranges.get(t, (slot, slot))
                self._ranges[t] = (min(lo, slot), max(hi, slot))

    def table_range(self, table):
        if self._layout is not None:
            return self._layout._range(table)
        if table not in self._ranges:
            raise QueryError(f"no such table {table!r}")
        lo, hi = self._ranges[table]
        return lo, hi - lo + 1

    def table_columns(self, table):
        if self._layout is not None:
            t = self._layout.schema.tables.get(table)
            if t is None:
                raise QueryError(f"no such table {table!r}")
            return [c.name for c in t.value_columns]
        if table not in self._tcols:
            raise QueryError(f"no such table {table!r}")
        cols = self._tcols[table]
        return [c for c, _ in sorted(cols.items(), key=lambda kv: kv[1])]

    def col_index(self, table, column):
        if self._layout is not None:
            return self._layout.col_index(table, column)
        try:
            return self._tcols[table][column]
        except KeyError:
            raise QueryError(f"no such column {table}.{column}") from None

    def column_default(self, table, column):
        """Declared DEFAULT literal, or None. A never-written cell of a
        live row reads as its column default — SQLite materializes the
        default at INSERT; the tensor layout materializes it at read.
        Traces carry no schema, so no defaults there."""
        if self._layout is None:
            return None
        t = self._layout.schema.tables.get(table)
        if t is None:
            return None
        for c in t.value_columns:
            if c.name == column:
                return c.default_value
        return None

    def pk_columns(self, table) -> tuple:
        """pk column names — () for traces (names aren't in the wire
        format, so pk predicates aren't resolvable there)."""
        if self._layout is not None:
            t = self._layout.schema.tables.get(table)
            return tuple(t.pk) if t is not None else ()
        return ()

    @property
    def generation(self) -> int:
        return self._layout.generation if self._layout is not None else 0

    @property
    def total_rows(self) -> int:
        """Global row-slot bound (joined-row id span)."""
        if self._layout is not None:
            return self._layout.num_rows
        return len(self._trace.row_keys)

    @property
    def row_key(self):
        if self._layout is not None:
            lay = self._layout

            def rk(slot):
                # lazy: rows allocated after matcher creation still resolve
                return lay.key_of(slot)

            rk.schema = lay.schema
            return rk
        keys = self._trace.row_keys

        def rk(slot):
            return keys[slot] if 0 <= slot < len(keys) else None

        return rk


class SubsManager:
    """Registry of matchers, deduped by (normalized SQL, observer node) —
    the ``SubsManager::get_or_insert`` surface (``pubsub.rs:52-118``)."""

    def __init__(self, layout_adapter: LayoutAdapter, universe,
                 max_buffer: int = 512, batch: bool = True):
        self.layout = layout_adapter
        self.universe = universe
        self.max_buffer = max_buffer
        self.batch = batch  # group same-skeleton matchers into one
        # evaluation per step (False = the per-matcher path, kept for
        # the equivalence tests)
        self._by_id: dict[str, Matcher] = {}
        self._by_query: dict[tuple, str] = {}
        self._next_id = 0
        self._batched_cache: dict = {}  # batch sig -> compiled evaluator

    def get_or_insert(self, sql: str, node: int, table_state):
        """Returns (matcher, initial_events | None) — None when deduped to
        an existing matcher (subscriber catches up from its buffer)."""
        select = parse_query(sql)
        if select.order_by or select.limit is not None or select.offset:
            raise QueryError(
                "ORDER BY / LIMIT / OFFSET are not supported in "
                "subscriptions (events are a diff stream, not an ordered "
                "page); use a one-shot query"
            )
        key = (select.normalized(), node)
        sub_id = self._by_query.get(key)
        if sub_id is not None:
            return self._by_id[sub_id], None
        sub_id = f"sub-{self._next_id}"
        self._next_id += 1
        m = make_matcher(
            sub_id, select, node, self.layout, self.universe,
            max_buffer=self.max_buffer,
        )
        initial = m.prime(table_state)
        self._by_id[sub_id] = m
        self._by_query[key] = sub_id
        return m, initial

    def restore_sub(
        self, sub_id: str, sql: str, node: int, table_state,
        change_id: int = 0,
    ) -> Matcher:
        """Re-register a persisted subscription under its original id —
        warm-boot restore (``setup_spawn_subscriptions``,
        ``agent/setup.rs:224-277``). The event buffer is gone (clients
        whose ``from`` predates the restart re-subscribe), but the change
        id continues from where it was so ids never regress."""
        select = parse_query(sql)
        m = make_matcher(
            sub_id, select, node, self.layout, self.universe,
            max_buffer=self.max_buffer,
        )
        m.prime(table_state)
        m._change_id = max(m._change_id, change_id)
        self._by_id[sub_id] = m
        self._by_query[(select.normalized(), node)] = sub_id
        # keep generated ids clear of restored ones
        try:
            n = int(sub_id.rsplit("-", 1)[1])
            self._next_id = max(self._next_id, n + 1)
        except (IndexError, ValueError):
            pass
        return m

    def get(self, sub_id: str) -> Matcher | None:
        return self._by_id.get(sub_id)

    def remove(self, sub_id: str) -> None:
        m = self._by_id.pop(sub_id, None)
        if m is not None:
            self._by_query.pop((m.select.normalized(), m.node), None)

    def _build_batched_eval(self, sig):
        """One group evaluation for a batch signature: evaluates EVERY
        matcher of the group at once — the per-matcher device program
        (slice → defaults → predicate → projection) with a leading group
        axis, node/projection/defaults/predicate constants as stacked
        ``(B, …)`` inputs."""
        skeleton, start, cap, proj_w, n_dflt = sig
        from corro_sim_torch.subs.query import compile_predicate_batched

        pred_fn = compile_predicate_batched(skeleton)

        def evaluate(vr_all, cl_all, nodes, projs, dplanes, dranks,
                     *consts):
            check_slice(vr_all, start, cap)
            nodes = nodes.long()
            vr = vr_all[nodes, start:start + cap]  # (B, cap, C)
            cl = cl_all[nodes, start:start + cap]  # (B, cap)
            b = torch.arange(vr.shape[0], device=vr.device)
            if n_dflt:
                fill = torch.full((vr.shape[0], vr.shape[2]), NEG,
                                  dtype=vr.dtype, device=vr.device)
                fill[b[:, None], dplanes.long()] = dranks.to(vr.dtype)
                vr = torch.where(vr == NEG, fill[:, None, :], vr)
            unset = vr == NEG
            live = (cl % 2) == 1
            match = pred_fn(vr, unset, list(consts)) & live
            prj = (
                torch.gather(vr, 2, projs.long()[:, None, :].expand(
                    -1, vr.shape[1], -1))
                if proj_w else vr[:, :, :0]
            )
            return match, prj

        return evaluate

    @staticmethod
    def _group_inputs(ms, device):
        """The group's stacked inputs on ``device``: nodes, projections,
        default planes and ranks, and one ``(B, L)`` int32 tensor per
        predicate constant, uploaded in one host→device copy."""
        parts = [np.asarray([m.node for m in ms], np.int32)[:, None],
                 np.stack([m._batch_proj for m in ms]).reshape(len(ms), -1),
                 np.stack([m._batch_dflt_planes for m in ms]).reshape(
                     len(ms), -1),
                 np.stack([m._batch_dflt_ranks for m in ms]).reshape(
                     len(ms), -1)]
        parts += [np.stack(cs) for cs in zip(*(m._batch_consts for m in ms))]
        widths = [p.shape[1] for p in parts]
        flat = torch.as_tensor(
            np.concatenate(parts, axis=1).astype(np.int32), device=device)
        out = list(torch.split(flat, widths, dim=1))
        out[0] = out[0][:, 0]
        return out

    def _batched_precompute(self, table_state, matchers) -> dict:
        """{id(matcher): (match, proj)} for every plain matcher riding
        a batched group this step (groups of >= 2 sharing a batch
        signature); singletons and structured matchers fall through to
        their own evaluation. One evaluation + ONE device→host read per
        group instead of per matcher. The JAX package pads each group to
        a power of two to bound its retraces; torch does not retrace, so
        the group runs at its own size."""
        if not self.batch:
            return {}
        groups: dict = {}
        for m in matchers:
            sig = getattr(m, "_batch_sig", None)
            if type(m) is Matcher and sig is not None:
                groups.setdefault(sig, []).append(m)
        out: dict = {}
        for sig, ms in groups.items():
            if len(ms) < 2:
                continue
            ev = self._batched_cache.get(sig)
            if ev is None:
                ev = self._batched_cache[sig] = self._build_batched_eval(
                    sig
                )
            inputs = self._group_inputs(ms, table_state.vr.device)
            match, proj = read_match_proj(
                *ev(table_state.vr, table_state.cl, *inputs)
            )
            from corro_sim_torch.utils.metrics import (
                SUBS_BATCH_GROUPS_TOTAL,
                SUBS_MATCHER_EVALS_TOTAL,
                counters,
            )

            counters.inc(
                SUBS_BATCH_GROUPS_TOTAL,
                help_="batched matcher-group dispatches (one evaluation "
                      "per predicate skeleton per step)",
            )
            counters.inc(
                SUBS_MATCHER_EVALS_TOTAL, n=len(ms),
                labels='{mode="batched"}',
                help_="matcher evaluations by dispatch mode (batched = "
                      "rode a group evaluation)",
            )
            for i, m in enumerate(ms):
                out[id(m)] = (match[i], proj[i])
        return out

    def step(self, table_state, touched=None) -> dict:
        """Advance every (candidate) matcher; returns {sub_id: [events]}.

        Plain matchers sharing a predicate skeleton evaluate as one
        group (``_batched_precompute``); host-side diffing and
        event materialization stay per matcher and bit-identical to the
        unbatched path (tests/test_subs_load.py)."""
        cands = [
            (sub_id, m) for sub_id, m in self._by_id.items()
            if m.is_candidate(touched)
        ]
        pre = self._batched_precompute(
            table_state, [m for _, m in cands]
        )
        singles = sum(1 for _, m in cands if id(m) not in pre)
        if singles:
            from corro_sim_torch.utils.metrics import (
                SUBS_MATCHER_EVALS_TOTAL,
                counters,
            )

            counters.inc(
                SUBS_MATCHER_EVALS_TOTAL, n=singles,
                labels='{mode="single"}',
                help_="matcher evaluations by dispatch mode (batched = "
                      "rode a group evaluation)",
            )
        out = {}
        for sub_id, m in cands:
            p = pre.get(id(m))
            ev = m.step(table_state, precomputed=p) if type(m) is Matcher \
                else m.step(table_state)
            if ev:
                out[sub_id] = ev
        return out

    def __len__(self):
        return len(self._by_id)

    def rebind_all(self, old_ranks, new_ranks) -> None:
        """Propagate a LiveUniverse remap to every registered matcher."""
        for m in self._by_id.values():
            m.rebind(old_ranks, new_ranks)
