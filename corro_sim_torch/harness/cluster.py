"""LiveCluster: the running agent, a whole simulated cluster behind an API.

Port of ``corro_sim/harness/cluster.py``. The reference deploys one agent
process per node (``corro-agent/src/agent/run_root.rs``); clients talk
to their node's HTTP API and gossip spreads the writes. Here one process
holds the cluster: every node's state lives in the same tensors, and one
round of ``sim_step`` per tick advances all nodes together. The API
addresses a node by ordinal (``node=``: the agent a client would have
connected to). Everything a reference agent does per node (accept
writes, commit and version them, gossip, merge, sync, notify
subscriptions) happens here for all nodes at once.

Write path (``make_broadcastable_changes``, ``api/public/mod.rs:36-101``):
:meth:`LiveCluster.execute` parses statements, interns values, queues
one changeset per transaction on the target node, and ticks until the
queue drains. The one write connection per node is the dequeue
discipline: at most one changeset per node per round
(``corro-types/src/agent.rs:500-731``).

What differs from the JAX package, by design:

- The step programs are two plain closures over the port's ``sim_step``:
  one round, and a chunk of ``_CHUNK`` rounds as a host loop whose
  round keys come from the absolute round number (the JAX package's
  ``lax.scan`` over ``start_round + arange(k)``). Nothing compiles, so
  :meth:`warmup` runs the two programs and an identity remap to build
  and load the CUDA merge library before the first client transaction.
- The step consumes its input state (the merge updates the table planes
  in place), so reads that change a plane (``query(..., overlay=)``,
  the write planner's predicate path) work on copies and never touch
  the committed planes.
- Each tick uploads its writes, liveness and partition ids in one
  host-to-device copy, and reads its metrics back in one, started
  before the subscription diff runs.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from corro_sim_torch import prng
from corro_sim_torch.api.statements import (
    StatementError,
    WriteOp,
    parse_write,
    pk_equalities,
)
from corro_sim_torch.config import SimConfig
from corro_sim_torch.core.changelog import CELL_VR
from corro_sim_torch.core.crdt import NEG
from corro_sim_torch.device import resolve_device
from corro_sim_torch.engine.driver import round_key
from corro_sim_torch.engine.state import SimState, init_state
from corro_sim_torch.engine.step import sim_step
from corro_sim_torch.io.values import LiveUniverse
from corro_sim_torch.obs.flight import FlightRecorder
from corro_sim_torch.schema import (
    SchemaError,
    TableLayout,
    parse_and_constrain,
)
from corro_sim_torch.subs.manager import (
    LayoutAdapter,
    Matcher,
    SubsManager,
    make_matcher,
)
from corro_sim_torch.subs.query import QueryError, parse_query, post_process
from corro_sim_torch.utils.metrics import (
    CHUNK_SIZE_BUCKETS,
    PIPELINE_FETCH_WAIT,
    PIPELINE_FETCH_WAIT_HELP,
    ChannelMetrics,
    HistogramRegistry,
    counters,
    histograms as _global_histograms,
)
from corro_sim_torch.utils.ranks import rank_map, translate_ranks
from corro_sim_torch.utils.runtime import (
    LockRegistry,
    Tripwire,
    start_async_fetch,
    upload,
)

_PLAIN = (type(None), bool, int, float, str, bytes)


@dataclasses.dataclass
class _PendingChangeset:
    """One queued transaction: becomes exactly one version when committed."""

    is_delete: bool
    cells: list  # [(row_slot, col_plane, value_rank)]; delete: [(slot, 0, 0)]
    queued_at: float = 0.0  # perf_counter at enqueue, for the
    # corro.agent.changes.queued.seconds histogram at drain time


# Rounds per chunked tick: bulk drains and long convergence runs pay one
# metrics read per _CHUNK rounds.
_CHUNK = 16


class ExecError(ValueError):
    pass


class LiveCluster:
    def __init__(
        self,
        schema_sql: str,
        num_nodes: int = 4,
        seed: int = 0,
        default_capacity: int = 256,
        capacities: dict | None = None,
        cfg_overrides: dict | None = None,
        tripwire: Tripwire | None = None,
        layout: TableLayout | None = None,
        universe: LiveUniverse | None = None,
        device=None,
    ):
        # layout/universe injection is the warm-boot path: checkpoint
        # restore rebuilds them with their exact slot/rank assignments
        # (BookedVersions::from_conn analog, agent.rs:1334-1403)
        self.device = resolve_device(device)
        if layout is not None:
            self.layout = layout
        else:
            schema = parse_and_constrain(schema_sql)
            self.layout = TableLayout(
                schema, capacities=capacities,
                default_capacity=default_capacity,
            )
        self._schema_history: list[str] = [schema_sql]
        self.universe = universe if universe is not None else LiveUniverse()
        # cluster-scoped histograms: a process can host several clusters
        self.histograms = HistogramRegistry()
        self.locks = LockRegistry(histograms=self.histograms)
        self.tripwire = tripwire or Tripwire()
        self._lock = threading.RLock()
        self._seed = seed

        overrides = dict(cfg_overrides or {})
        # seqs_per_version bounds cells per transaction
        overrides.setdefault("seqs_per_version", 8)
        self.cfg = SimConfig(
            num_nodes=num_nodes,
            num_rows=self.layout.num_rows,
            num_cols=max(self.layout.num_cols, 1),
            **overrides,
        ).validate()
        self.state: SimState = init_state(self.cfg, seed=seed,
                                          device=self.device)
        self._root_key = prng.PRNGKey(seed)
        self._alive = np.ones((num_nodes,), bool)
        self._part = np.zeros((num_nodes,), np.int32)
        self._pending: list = [collections.deque() for _ in range(num_nodes)]
        self._staging: list | None = None  # execute()'s in-flight batch
        # in-flight batch overlay: ((slot -> live), ((slot, plane) -> rank))
        # — later statements of a transaction see earlier ones' effects,
        # like the reference's single SQLite tx (api/public/mod.rs:104-131)
        self._staging_overlay: tuple[dict, dict] | None = None
        self._rounds_ticked = 0
        self._totals: dict[str, float] = {}
        self._lasts: dict[str, float] = {}  # last-round gauge snapshots
        # per-stage wall (ms): {stage: (ewma, last)}
        self._stage_ms: dict[str, tuple[float, float]] = {}
        self._gap = 0.0  # last round's convergence gap
        self._prev_swim: dict[str, float] = {}  # transition-counter state
        self._probe_p99 = None  # worst per-probe p99 delivery lag seen
        self._probe_infected_last = -1.0  # change detector for the check
        self._api_requests = 0  # served API requests
        self._api_req_lock = threading.Lock()
        self._chunk_dispatches = 0  # chunked ticks executed
        self._log_poisoned = False  # ring-wrap tripwire latched
        self._partials = 0.0  # last round's buffered-partial gauge
        self._scenario = None  # armed chaos scenario (load_scenario)
        self._scenario_base = 0  # round the scenario was loaded at
        self._scenario_events = 0  # events already annotated
        # the fault knobs the cluster was built with: scenarios apply
        # relative to this baseline, so one never leaks into the next
        self._baseline_faults = self.cfg.faults
        self._sub_queues: dict[str, list] = {}  # sub_id -> [deque]
        # the last load-harness run (workload/harness.py), served at
        # GET /v1/workload
        self.workload_report: dict | None = None
        # the per-round telemetry timeline
        self.flight = FlightRecorder(capacity=16384)
        self.flight.set_meta(driver="live_cluster", nodes=num_nodes,
                             seed=seed)
        self.channels = ChannelMetrics(histograms=self.histograms)
        self.channels.set_capacity("write_queue", 0)  # unbounded deques
        self.channels.set_capacity("subs_events", 0)

        self.subs = SubsManager(
            LayoutAdapter(layout=self.layout), self.universe
        )
        self._query_cache: dict[tuple, Matcher] = {}
        self.universe.on_remap(self._on_remap)
        self._build_step()

    # ------------------------------------------------------------- plumbing
    def _build_step(self):
        """The two step programs over the current config."""
        cfg = self.cfg

        def step(state, key, alive, part, writes, round_idx, quiesced):
            return sim_step(cfg, state, key, alive, part, False, round_idx,
                            writes=writes, quiesced=quiesced)

        # k rounds in one call, draining one queued changeset per node
        # per round exactly like the single-round path, each round's key
        # from its absolute round number; alive/part are per-chunk
        # constants. Returns the state and the per-round metric dicts.
        def multi_step(state, root_key, start_round, alive, part, writes_k,
                       quiesced_k):
            per_round = []
            for r, (w, q) in enumerate(zip(writes_k, quiesced_k)):
                key = round_key(root_key, start_round + r)
                state, m = sim_step(cfg, state, key, alive, part, False,
                                    start_round + r, writes=w, quiesced=q)
                per_round.append(m)
            return state, per_round

        self._step = step
        self._multi_step = multi_step

    def _on_remap(self, old, new):
        """Translate every rank-typed tensor to the re-spaced universe.

        Order-preserving, so merge outcomes are untouched: a pure
        re-labelling (SQLite swapping its interned value ids)."""
        st = self.state
        cells = st.log.cells.clone()
        cells[..., CELL_VR] = translate_ranks(cells[..., CELL_VR], old, new)
        self.state = dataclasses.replace(
            st,
            table=dataclasses.replace(
                st.table, vr=translate_ranks(st.table.vr, old, new)),
            log=dataclasses.replace(st.log, cells=cells),
            own=dataclasses.replace(
                st.own, vr=translate_ranks(st.own.vr, old, new)),
        )
        # queued-but-uncommitted changesets carry ranks too (the batch
        # still being planned inside execute() included)
        trans = rank_map(old, new)
        batches = list(self._pending)
        if self._staging is not None:
            batches.append(self._staging)
        for q in batches:
            for cs in q:
                cs.cells = [
                    (slot, plane, trans.get(rank, rank))
                    for slot, plane, rank in cs.cells
                ]
        if self._staging_overlay is not None:
            _, cells_ov = self._staging_overlay
            for k, rank in cells_ov.items():
                cells_ov[k] = trans.get(rank, rank)
        self.subs.rebind_all(old, new)
        # one-shot query matchers are compiled again on their next use:
        # rebinding each cached one at every respace cost more than the
        # queries that reuse them
        self._query_cache.clear()

    # ------------------------------------------------------------ write path
    def execute(self, statements, node: int = 0, wait: bool = True) -> dict:
        """POST /v1/transactions analog: one changeset per statement batch.

        Returns the ``ExecResponse`` shape (``corro-api-types:209-214``):
        per-statement results plus the committed version.

        ``wait=False`` plans and enqueues without draining: the caller
        ticks later, and the queues of several nodes drain together, one
        changeset per node per round. ``version`` is then None."""
        self._check_node(node)
        t0 = time.perf_counter()
        results = []
        with self.locks.tracked(self._lock, f"execute node={node}", "write"):
            if not self._alive[node]:
                # a down agent's API is unreachable in the reference
                raise ExecError(f"node {node} is down")
            changesets: list[_PendingChangeset] = []
            overlay: tuple[dict, dict] = ({}, {})
            self._staging = changesets
            self._staging_overlay = overlay
            self._bulk_intern(statements)
            try:
                for stmt in statements:
                    st0 = time.perf_counter()
                    try:
                        op = parse_write(stmt)
                        n_rows = self._plan_write(
                            op, node, changesets, overlay
                        )
                    except (StatementError, SchemaError, QueryError) as e:
                        raise ExecError(str(e)) from None
                    results.append({
                        "rows_affected": n_rows,
                        "time": time.perf_counter() - st0,
                    })
            finally:
                self._staging = None
                self._staging_overlay = None
            for cs in changesets:
                self._pending[node].append(cs)
                self.channels.on_send("write_queue")
            version = None
            if wait:
                # commit synchronously: tick until this node's queue
                # drains, as the reference's in-tx HTTP handler returns
                # only once its transaction is durable
                while self._pending[node]:
                    if (
                        len(self._pending[node]) >= _CHUNK // 2
                        and not self._subs_active()
                    ):
                        self._tick_chunk_locked()
                    else:
                        self._tick_locked(1)
                version = int(self.state.book.head[node, node])
        return {
            "results": results,
            "time": time.perf_counter() - t0,
            "version": version,
        }

    def plan_overlay(self, statements, node: int = 0, base=None):
        """Plan a statement batch without enqueueing it: returns
        ``(overlay, rows_affected_per_stmt)``.

        The overlay is the staged-effects structure ``execute()`` uses
        for in-batch read-your-writes; an open ``BEGIN … COMMIT``
        transaction holds one so that its reads see its own writes.
        ``base``: an overlay from an earlier call, extended in place.

        Planning may allocate row slots and intern values for rows that
        never commit (as SQLite burns rowids on rolled-back inserts)."""
        self._check_node(node)
        with self.locks.tracked(
            self._lock, f"plan_overlay node={node}", "write"
        ):
            changesets: list[_PendingChangeset] = []
            overlay: tuple[dict, dict] = base if base is not None else ({}, {})
            self._staging = changesets
            self._staging_overlay = overlay
            self._bulk_intern(statements)
            counts = []
            try:
                for stmt in statements:
                    try:
                        op = parse_write(stmt)
                        counts.append(
                            self._plan_write(op, node, changesets, overlay)
                        )
                    except (StatementError, SchemaError, QueryError) as e:
                        raise ExecError(str(e)) from None
            finally:
                self._staging = None
                self._staging_overlay = None
            return overlay, counts

    def _bulk_intern(self, statements) -> None:
        """Pre-intern every value a statement batch will rank, in bulk.

        Over-approximates (``_plan_write`` decides which cells commit);
        parse errors are left to the planning loop, which raises them
        per statement."""
        vals: list = []
        for stmt in statements:
            try:
                op = parse_write(stmt)
            except StatementError:
                continue
            t = self.layout.schema.tables.get(op.table)
            if t is None:
                continue
            pk = set(t.pk)
            if op.kind == "upsert":
                vals.append(None)
                if t.value_columns:
                    vals.append(t.value_columns[0].default_value)
                for row in op.rows:
                    vals.extend(v for c, v in row.items() if c not in pk)
            elif op.kind == "update":
                # expression SETs evaluate per row at plan time and
                # intern lazily; only plain values prefetch
                vals.extend(v for v in op.sets.values()
                            if isinstance(v, _PLAIN))
        if vals:
            self.universe.intern_many(vals)

    def _plan_write(
        self, op: WriteOp, node: int, out: list, overlay: tuple[dict, dict]
    ) -> int:
        """Expand one WriteOp into pending changesets; returns rows
        affected. ``overlay`` accumulates the batch's staged effects so
        later statements of the transaction observe earlier ones."""
        from corro_sim_torch.api.exprs import eval_expr

        t = self.layout.schema.tables.get(op.table)
        if t is None:
            raise StatementError(f"no such table {op.table!r}")
        s_cap = self.cfg.seqs_per_version
        live_ov, cell_ov = overlay

        if op.kind == "insert_select":
            # INSERT … SELECT: the source SELECT evaluates against the
            # writing node's view (batch overlay included); its rows
            # become the VALUES of a plain upsert
            src_name, items = op.select
            src = self.layout.schema.tables.get(src_name)
            if src is None:
                raise StatementError(f"no such table {src_name!r}")
            if len(items) != len(op.cols):
                raise StatementError(
                    f"INSERT…SELECT arity mismatch: {len(op.cols)} columns "
                    f"vs {len(items)} selected"
                )
            sel_op = WriteOp(
                kind="select", table=src_name, where=op.where,
                where_expr=op.where_expr,
            )
            if op.where is None and op.where_expr is None:
                slots = self._live_slots(src, node, overlay)
            else:
                slots = self._resolve_rows(sel_op, src, node, overlay)
            envs = self._row_envs(src, node, slots, overlay)
            rows = [[eval_expr(e, env) for e in items] for env in envs]
            op = WriteOp(
                kind="upsert", table=op.table,
                rows=[dict(zip(op.cols, r)) for r in rows],
            )

        if op.kind == "upsert":
            # last occurrence wins per (row, col): SQLite upsert
            # semantics, and local_write's invariant that a changeset
            # never carries a (row, col) cell twice
            dedup: dict[tuple[int, int], int] = {}
            touched_slots = []
            for row in op.rows:
                missing = [c for c in t.pk if c not in row]
                if missing:
                    raise StatementError(
                        f"INSERT into {t.name!r} must provide pk column(s) "
                        f"{missing}"
                    )
                pk = tuple(row[c] for c in t.pk)
                slot = self.layout.row_slot(t.name, pk)
                touched_slots.append(slot)
                wrote = False
                for c in t.value_columns:
                    if c.name in row:
                        key = (slot, self.layout.col_index(t.name, c.name))
                        dedup[key] = self.universe.rank(row[c.name])
                        wrote = True
                if not wrote:
                    # pk-only insert: the causal length carries the row's
                    # existence; write the first value column's default
                    if t.value_columns:
                        c = t.value_columns[0]
                        key = (slot, self.layout.col_index(t.name, c.name))
                        dedup.setdefault(
                            key, self.universe.rank(c.default_value)
                        )
                    else:
                        dedup.setdefault((slot, 0), self.universe.rank(None))
            cells = [(r, c, v) for (r, c), v in dedup.items()]
            for i in range(0, len(cells), s_cap):
                out.append(_PendingChangeset(
                    False, cells[i:i + s_cap], time.perf_counter()
                ))
            for slot in touched_slots:
                live_ov[slot] = True
            cell_ov.update(dedup)
            return len(op.rows)

        slots = self._resolve_rows(op, t, node, overlay)
        if op.kind == "update":
            for c in op.sets:
                self.layout.col_index(t.name, c)  # validate
            if all(isinstance(v, _PLAIN) for v in op.sets.values()):
                cells = [
                    (slot, self.layout.col_index(t.name, c),
                     self.universe.rank(v))
                    for slot in slots
                    for c, v in op.sets.items()
                ]
            else:
                # expression SETs (SET v = v + 1, CASE …) evaluate per
                # target row against its values plus the batch overlay
                envs = self._row_envs(t, node, slots, overlay)
                cells = []
                for slot, env in zip(slots, envs):
                    for c, v in op.sets.items():
                        val = v if isinstance(v, _PLAIN) else eval_expr(v, env)
                        cells.append((
                            slot, self.layout.col_index(t.name, c),
                            self.universe.rank(val),
                        ))
            for i in range(0, len(cells), s_cap):
                out.append(_PendingChangeset(
                    False, cells[i:i + s_cap], time.perf_counter()
                ))
            for slot, plane, rank in cells:
                cell_ov[(slot, plane)] = rank
            return len(slots)

        # delete: one cl-only changeset per row (a DELETE bumps the row's
        # causal length; CR-SQLite emits no value changes for it)
        for slot in slots:
            out.append(_PendingChangeset(True, [(slot, 0, 0)],
                                         time.perf_counter()))
            live_ov[slot] = False
        return len(slots)

    def _resolve_rows(
        self, op: WriteOp, t, node: int, overlay: tuple[dict, dict]
    ) -> list[int]:
        """Row slots an UPDATE/DELETE targets: the pk fast path or a
        predicate, over rows live on the target node (odd causal length),
        with rows staged earlier in the batch live or dead per the
        overlay."""
        live_ov, _ = overlay
        if op.where_expr is not None:
            # a scalar-expression WHERE the vectorized grammar cannot
            # express filters the live rows through the expression
            # evaluator (UNKNOWN excludes)
            from corro_sim_torch.api.exprs import eval_expr

            cands = self._live_slots(t, node, overlay)
            envs = self._row_envs(t, node, cands, overlay)
            return [
                s for s, env in zip(cands, envs)
                if eval_expr(op.where_expr, env) is True
            ]
        pk = pk_equalities(op.where, t.pk)
        if pk is not None:
            slot = self.layout._slots.get((t.name, pk))
            if slot is None:
                return []
            if slot in live_ov:
                return [slot] if live_ov[slot] else []
            cl = int(self.state.table.cl[node, slot])
            return [slot] if cl % 2 == 1 else []
        # a general predicate evaluates against the node's view overlaid
        # with the batch's staged writes
        from corro_sim_torch.subs.query import Select

        sel = Select(table=t.name, columns=(), where=op.where)
        matcher = self._matcher_for(sel, node)
        view = self._overlaid_table(node, overlay)
        if hasattr(matcher, "_rows"):
            # semi-join matcher (WHERE … IN (SELECT …)): its row map is
            # the slot set
            return sorted(matcher._rows(view).keys())
        match, _ = matcher._evaluate(view)
        return [int(s) + matcher._start for s in np.nonzero(match)[0]]

    def _live_slots(self, t, node: int, overlay) -> list[int]:
        """Allocated row slots of ``t`` live on ``node`` (overlay-aware)."""
        live_ov, _ = overlay
        start, _cap = self.layout._range(t.name)
        used = self.layout._used[t.name]
        if not used:
            return []
        cl = self.state.table.cl[node, start:start + used].cpu().numpy()
        out = []
        for i in range(used):
            slot = start + i
            if slot in live_ov:
                if live_ov[slot]:
                    out.append(slot)
            elif cl[i] % 2 == 1:
                out.append(slot)
        return out

    def _row_envs(self, t, node: int, slots, overlay) -> list[dict]:
        """``{column: value}`` environments of row slots on ``node``,
        with the batch overlay's staged cells applied: one device read
        per statement, not one per row."""
        _, cell_ov = overlay
        if not slots:
            return []
        idx = torch.as_tensor(np.asarray(slots, np.int64),
                              device=self.device)
        vr = self.state.table.vr[node, idx].cpu().numpy()  # (k, C)
        envs = []
        neg = int(NEG)
        for j, slot in enumerate(slots):
            key = self.layout.key_of(slot)
            env = dict(zip(t.pk, key[1])) if key else {}
            for c in t.value_columns:
                plane = self.layout.col_index(t.name, c.name)
                rank = cell_ov.get((slot, plane))
                if rank is None:
                    rank = int(vr[j, plane])
                env[c.name] = (
                    None if rank == neg else self.universe.decode(int(rank))
                )
            envs.append(env)
        return envs

    def _overlaid_table(self, node: int, overlay: tuple[dict, dict]):
        """The committed table with the batch's staged cells applied on
        the target node: the transaction's own-writes view. The staged
        coordinates scatter into copies of the planes they touch; the
        committed planes are never written."""
        live_ov, cell_ov = overlay
        st = self.state.table
        if not live_ov and not cell_ov:
            return st
        dev = self.device
        vr, cl = st.vr, st.cl
        if cell_ov:
            slots = torch.as_tensor(
                np.fromiter((s for s, _ in cell_ov), np.int64,
                            len(cell_ov)), device=dev)
            planes = torch.as_tensor(
                np.fromiter((p for _, p in cell_ov), np.int64,
                            len(cell_ov)), device=dev)
            ranks = torch.as_tensor(
                np.fromiter(cell_ov.values(), np.int32, len(cell_ov)),
                device=dev)
            vr = vr.index_put((torch.full_like(slots, node), slots, planes),
                              ranks.to(vr.dtype))
        if live_ov:
            ls = torch.as_tensor(np.fromiter(live_ov, np.int64,
                                             len(live_ov)), device=dev)
            want = torch.as_tensor(np.fromiter(
                (1 if v else 0 for v in live_ov.values()), np.int32,
                len(live_ov)), device=dev)
            cur = cl[node, ls]
            bump = ((cur % 2) != want).to(cl.dtype)
            cl = cl.index_put((torch.full_like(ls, node), ls), cur + bump)
        return dataclasses.replace(st, vr=vr, cl=cl)

    # ------------------------------------------------------------ query path
    def _matcher_for(self, select, node: int) -> Matcher:
        # a remap empties the cache (_on_remap)
        key = (select.normalized(), node)
        m = self._query_cache.get(key)
        if m is None:
            m = make_matcher(
                f"query-{len(self._query_cache)}", select, node,
                LayoutAdapter(layout=self.layout), self.universe,
            )
            self._query_cache[key] = m
            if len(self._query_cache) > 128:  # bounded cache
                self._query_cache.pop(next(iter(self._query_cache)))
        return m

    def query(self, sql: str, node: int = 0, overlay=None) -> list:
        """POST /v1/queries analog: the QueryEvent stream as a list of
        dicts (``{"columns"}``, ``{"row"}``…, ``{"eoq"}``).

        ``overlay`` (from :meth:`plan_overlay`) evaluates the query
        against the committed state plus a transaction's staged writes."""
        self._check_node(node)
        with self.locks.tracked(self._lock, f"query node={node}", "read"):
            select = parse_query(sql)
            # the matcher evaluates the match+project core; GROUP BY,
            # aggregates, ORDER BY and LIMIT post-process on the host
            m = self._matcher_for(select.base(), node)
            table = (
                self.state.table if overlay is None
                else self._overlaid_table(node, overlay)
            )
            events = m.prime(table)
            if select.has_extras():
                events = post_process(select, events)
            return events

    def query_rows(
        self, sql: str, node: int = 0, overlay=None
    ) -> tuple[list, list]:
        """(columns, rows) convenience over :meth:`query`."""
        events = self.query(sql, node, overlay=overlay)
        cols, rows = [], []
        for e in events:
            if "columns" in e:
                cols = e["columns"]
            elif "row" in e:
                rows.append(e["row"][1])
        return cols, rows

    # ----------------------------------------------------------- subs path
    def subscribe(self, sql: str, node: int = 0):
        """POST /v1/subscriptions analog: (sub_id, initial events)."""
        sub_id, initial, q = self.subscribe_attached(sql, node)
        self.sub_detach_queue(sub_id, q)
        return sub_id, initial

    def subscribe_attached(self, sql: str, node: int = 0):
        """Subscribe and attach a live queue atomically (no event can
        land between the initial snapshot and the queue registration).

        Returns (sub_id, initial_events, queue)."""
        self._check_node(node)
        with self.locks.tracked(self._lock, f"subscribe node={node}",
                                "write"):
            m, initial = self.subs.get_or_insert(sql, node, self.state.table)
            if initial is None:
                # deduped: replay the initial state from the matcher
                initial = m.prime(self.state.table)
            q: collections.deque = collections.deque()
            self._sub_queues.setdefault(m.id, []).append(q)
            return m.id, initial, q

    def sub_attach(
        self, sub_id: str, from_change_id: int | None = None,
        skip_rows: bool = False,
    ):
        """Re-attach to an existing sub atomically: catch-up (or
        re-prime) and queue registration under one lock.

        Returns (initial_events, queue). Raises KeyError for an unknown
        sub; returns (None, None) when ``from_change_id`` was compacted
        past (the subscriber must re-subscribe)."""
        with self.locks.tracked(self._lock, f"sub_attach {sub_id}", "write"):
            m = self.subs.get(sub_id)
            if m is None:
                raise KeyError(sub_id)
            if from_change_id is not None:
                caught = m.catch_up(from_change_id)
                if caught is None:
                    return None, None
                initial = [e.as_json() for e in caught]
            elif skip_rows:
                # still announce the feed position
                initial = [{"eoq": {"change_id": m.change_id}}]
            else:
                initial = m.prime(self.state.table)
            q: collections.deque = collections.deque()
            self._sub_queues.setdefault(sub_id, []).append(q)
            return initial, q

    def sub_catch_up(self, sub_id: str, from_change_id: int):
        m = self.subs.get(sub_id)
        if m is None:
            return None
        return m.catch_up(from_change_id)

    def sub_attach_queue(self, sub_id: str) -> collections.deque | None:
        """Register a live event queue for a subscriber stream."""
        if self.subs.get(sub_id) is None:
            return None
        q: collections.deque = collections.deque()
        self._sub_queues.setdefault(sub_id, []).append(q)
        return q

    def sub_detach_queue(self, sub_id: str, q) -> None:
        queues = self._sub_queues.get(sub_id)
        if queues and q in queues:
            queues.remove(q)

    def unsubscribe(self, sub_id: str) -> None:
        with self._lock:
            self.subs.remove(sub_id)
            self._sub_queues.pop(sub_id, None)

    # ------------------------------------------------------------- stepping
    def _write_buffer(self, k: int) -> np.ndarray:
        """One zeroed host buffer for ``k`` rounds of writes plus the
        round's liveness and partition ids: per round, ``n`` words each
        of writers, deletes, cell counts, alive and partition, then
        ``n·s`` each of rows, columns and value ranks."""
        n, s = self.cfg.num_nodes, self.cfg.seqs_per_version
        buf = np.zeros((k, 5 * n + 3 * n * s), np.int32)
        buf[:, 3 * n:4 * n] = self._alive
        buf[:, 4 * n:5 * n] = self._part
        return buf

    def _fill_writes(self, buf: np.ndarray, r: int, i: int,
                     cs: _PendingChangeset) -> None:
        n, s = self.cfg.num_nodes, self.cfg.seqs_per_version
        row = buf[r]
        row[i] = 1
        row[n + i] = cs.is_delete
        row[2 * n + i] = len(cs.cells)
        base = 5 * n + i * s
        for j, (slot, plane, rank) in enumerate(cs.cells):
            row[base + j] = slot
            row[base + n * s + j] = plane
            row[base + 2 * n * s + j] = rank

    def _dequeue_writes(self) -> np.ndarray:
        """At most one pending changeset per node, packed into a one-round
        buffer (:meth:`_write_buffer`)."""
        buf = self._write_buffer(1)
        if not any(self._pending):
            return buf
        waits: list[float] = []
        now = time.perf_counter()
        for i, q in enumerate(self._pending):
            if not q:
                continue
            cs: _PendingChangeset = q.popleft()
            self.channels.on_recv("write_queue")
            if cs.queued_at:
                waits.append(now - cs.queued_at)
            self._fill_writes(buf, 0, i, cs)
        self._observe_qwaits(waits)
        return buf

    def _dequeue_writes_chunk(self, k: int) -> np.ndarray:
        """Up to k changesets per node, round-major: round r of the chunk
        commits each node's r-th queued changeset, the same one per node
        per round as the single-round path, packed ahead of time."""
        buf = self._write_buffer(k)
        waits: list[float] = []
        now = time.perf_counter()
        for i, q in enumerate(self._pending):
            take = min(k, len(q))
            for r in range(take):
                cs: _PendingChangeset = q.popleft()
                self.channels.on_recv("write_queue")
                if cs.queued_at:
                    waits.append(now - cs.queued_at)
                self._fill_writes(buf, r, i, cs)
        self._observe_qwaits(waits)
        return buf

    def _stage(self, buf: np.ndarray) -> tuple:
        """Upload a write buffer in one copy. Returns the per-round write
        tuples, alive, part (the first round's: a chunk holds them
        constant) and each round's ``quiesced`` answer from the host."""
        n, s = self.cfg.num_nodes, self.cfg.seqs_per_version
        dev = upload(buf, self.device)
        writes = []
        for r in range(buf.shape[0]):
            d = dev[r]
            writes.append((
                d[:n] != 0, d[5 * n:5 * n + n * s].view(n, s),
                d[5 * n + n * s:5 * n + 2 * n * s].view(n, s),
                d[5 * n + 2 * n * s:].view(n, s), d[n:2 * n] != 0,
                d[2 * n:3 * n],
            ))
        alive = dev[0, 3 * n:4 * n] != 0
        part = dev[0, 4 * n:5 * n]
        quiesced = [not (buf[r, :n].astype(bool) & self._alive).any()
                    for r in range(buf.shape[0])]
        return writes, alive, part, quiesced

    def _observe_qwaits(self, waits: list) -> None:
        """One batched registry touch per drain."""
        self.histograms.observe_many(
            "corro_agent_changes_queued_seconds", waits,
            help_="time a committed changeset waited in the write queue "
                  "(corro.agent.changes.queued.seconds)",
        )

    def _record_metrics(self, packed: np.ndarray, names: list) -> None:
        """Fold a (num_metrics, rounds) float32 block into the totals."""
        k_rounds = packed.shape[1]
        self.flight.record_rounds(
            self._rounds_ticked - k_rounds + 1,
            dict(zip(names, packed)),
        )
        sums = packed.sum(axis=1)
        for k, v in zip(names, sums):
            self._totals[k] = self._totals.get(k, 0.0) + float(v)
        for k in ("pend_live", "queue_overflow", "swim_suspects",
                  "swim_down", "sync_pairs", "fault_burst_nodes"):
            if k in names:
                self._lasts[k] = float(packed[names.index(k), -1])
        # SWIM membership transition counters (corro.swim.notification):
        # positive deltas of the belief-state gauges, round by round
        for k, ev in (("swim_suspects", "swim_suspect_events"),
                      ("swim_down", "swim_down_events")):
            if k in names:
                series = packed[names.index(k)]
                prev = self._prev_swim.get(k, 0.0)
                up_k = 0.0
                down_k = 0.0
                for v in series:
                    d = float(v) - prev
                    if d > 0:
                        up_k += d
                    else:
                        down_k -= d
                    prev = float(v)
                self._prev_swim[k] = prev
                self._totals[ev] = self._totals.get(ev, 0.0) + up_k
                if k == "swim_down":
                    # a shrinking down-count = members back up
                    self._totals["swim_up_events"] = (
                        self._totals.get("swim_up_events", 0.0) + down_k
                    )
        self._gap = float(packed[names.index("gap"), -1])
        self._partials = float(packed[names.index("buffered_partials"), -1])
        if "probe_infected" in names:
            self._lasts["probe_infected"] = float(
                packed[names.index("probe_infected"), -1]
            )
            self._lasts["probe_dups"] = float(
                packed[names.index("probe_dups"), -1]
            )
            self._probe_p99_check()
        if "log_wrapped" in names and packed[names.index("log_wrapped")].any():
            # ring-wrap tripwire: state may be silently wrong from here
            # on, so convergence must never be reported
            if not self._log_poisoned:
                row = packed[names.index("log_wrapped")]
                self.flight.annotate(
                    self._rounds_ticked - k_rounds + 1
                    + int(np.argmax(row != 0)),
                    "log_wrapped",
                )
            self._log_poisoned = True
        self._totals["rounds"] = self._rounds_ticked
        # changes applied per round: the reference's chunk-size histogram
        # (corro.agent.changes.processing.chunk_size; its own buckets)
        if "fresh" in names:
            per_round = packed[names.index("fresh")]
            if "writes" in names:
                per_round = per_round + packed[names.index("writes")]
            self.histograms.observe_many(
                "corro_agent_changes_processing_chunk_size",
                [float(v) for v in per_round],
                help_="changes applied per processing round "
                      "(corro.agent.changes.processing.chunk_size)",
                buckets=CHUNK_SIZE_BUCKETS,
            )

    _STAGE_HISTO = {
        "step": "corro_agent_changes_processing_time_seconds",
        "chunk_step": "corro_agent_changes_processing_time_seconds",
        "subs": "corro_subs_changes_processing_duration_seconds",
    }

    def _observe_stage(self, stage: str, seconds: float, per: int = 1) -> None:
        ms = seconds * 1000.0 / max(per, 1)
        ewma, _ = self._stage_ms.get(stage, (ms, ms))
        self._stage_ms[stage] = (ewma + 0.2 * (ms - ewma), ms)
        name = self._STAGE_HISTO.get(stage)
        if name is not None:
            self.histograms.observe(
                name, seconds / max(per, 1),
                help_=f"per-round {stage} wall (reference histogram analog)",
            )

    def stage_timings(self) -> dict:
        """{stage: {"ewma_ms": .., "last_ms": ..}} per-round wall by stage."""
        with self._lock:
            return {
                k: {"ewma_ms": round(e, 3), "last_ms": round(l, 3)}
                for k, (e, l) in self._stage_ms.items()
            }

    def _tick_locked(self, rounds: int) -> None:
        if rounds > 0:
            counters.inc(
                "corro_chunk_dispatch_total", n=rounds,
                labels='{runner="live_step"}',
                help_="chunk dispatches by program",
            )
        for _ in range(rounds):
            self._apply_scenario_round()
            t0 = time.perf_counter()
            writes, alive, part, quiesced = self._stage(
                self._dequeue_writes())
            self._observe_stage("dequeue", time.perf_counter() - t0)
            t0 = time.perf_counter()
            key = round_key(self._root_key, self._rounds_ticked)
            self.state, metrics = self._step(
                self.state, key, alive, part, writes[0],
                self._rounds_ticked, quiesced[0],
            )
            self._rounds_ticked += 1
            self._finish_tick([metrics], t0, mode="live_step", per=1,
                              stage="step")

    def _tick_chunk_locked(self) -> None:
        """Advance _CHUNK rounds in one call.

        Per-round semantics equal :meth:`_tick_locked`'s (the same keys,
        the same one-changeset-per-node-per-round drain); only the count
        of host round trips changes. Subscription matchers see the
        chunk's final state (diff-based, so events coalesce like the
        reference's candidate batching, ``pubsub.rs:1154-1296``);
        callers gate on ``_subs_active()`` to keep per-round events
        whenever someone watches."""
        if self._scenario is not None and not self._scenario_uniform(_CHUNK):
            # the scenario changes topology inside this window, and a
            # chunk holds alive/part constant: run the rounds singly
            self._tick_locked(_CHUNK)
            return
        self._apply_scenario_round()
        self._chunk_dispatches += 1
        counters.inc(
            "corro_chunk_dispatch_total", labels='{runner="live_chunk"}',
            help_="chunk dispatches by program",
        )
        t0 = time.perf_counter()
        writes, alive, part, quiesced = self._stage(
            self._dequeue_writes_chunk(_CHUNK))
        self._observe_stage("dequeue", time.perf_counter() - t0, per=_CHUNK)
        t0 = time.perf_counter()
        self.state, per_round = self._multi_step(
            self.state, self._root_key, self._rounds_ticked, alive, part,
            writes, quiesced,
        )
        self._rounds_ticked += _CHUNK
        self._finish_tick(per_round, t0, mode="live_chunk", per=_CHUNK,
                          stage="chunk_step")

    def _finish_tick(self, per_round: list, t0: float, mode: str, per: int,
                     stage: str) -> None:
        """Shared tail of both tick paths: pack the step metrics into one
        float32 (metrics, rounds) tensor, start its device-to-host copy,
        run the subscription diff under the copy, then resolve and
        record. ``t0`` is the dispatch start; ``per`` rounds covered."""
        names = sorted(per_round[0])
        stack = torch.stack([
            torch.stack([m[k] for m in per_round]).to(torch.float32)
            for k in names
        ])
        fetch = start_async_fetch(stack)
        t_dispatch = time.perf_counter() - t0
        t1 = time.perf_counter()
        self._notify_subs()
        subs_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        (packed,) = fetch.resolve()
        fetch_wait = time.perf_counter() - t1
        _global_histograms.observe(
            PIPELINE_FETCH_WAIT, fetch_wait,
            labels=f'{{mode="{mode}"}}',
            help_=PIPELINE_FETCH_WAIT_HELP,
        )
        self._observe_stage(stage, t_dispatch + fetch_wait, per=per)
        self._record_metrics(packed, names)
        self._observe_stage("subs", subs_s)

    def _subs_active(self) -> bool:
        return len(self.subs) > 0 or bool(self._sub_queues)

    def warmup(self) -> None:
        """Run the hot paths before real traffic arrives: the single
        round, the chunk and an identity remap. Nothing compiles in the
        port; on the card this builds and loads the merge library before
        the first client transaction."""
        from corro_sim_torch.core.merge_kernel import (
            build_kernel,
            kernel_supported,
        )
        from corro_sim_torch.utils.tracing import tracer

        with self.locks.tracked(self._lock, "warmup", "write"):
            t0 = time.perf_counter()
            with tracer.span("warmup", program="live", slow_warn=False):
                if self.device.type == "cuda" and (
                    kernel_supported(self.cfg, "sync", self.device)
                    or kernel_supported(self.cfg, "delivery", self.device)
                ):
                    build_kernel()
                self._tick_locked(1)
                if not self._subs_active():
                    self._tick_chunk_locked()
                ranks = list(self.universe._ranks)
                if ranks:
                    self._on_remap(ranks, ranks)
            counters.inc(
                "corro_compile_total", labels='{program="live"}',
                help_="hot-path warmups by program (the port compiles "
                      "nothing; the merge library builds here)",
            )
            _global_histograms.observe(
                "corro_compile_seconds", time.perf_counter() - t0,
                labels='{program="live"}',
                help_="warmup wall by program",
            )

    def tick(self, rounds: int = 1) -> None:
        """Advance the cluster ``rounds`` rounds (no new writes)."""
        with self.locks.tracked(self._lock, "tick", "write"):
            remaining = rounds
            while remaining >= _CHUNK and not self._subs_active():
                self._tick_chunk_locked()
                remaining -= _CHUNK
            self._tick_locked(remaining)

    def _notify_subs(self) -> None:
        events = self.subs.step(self.state.table)
        delivered = False
        for sub_id, evs in events.items():
            for ev in evs:
                # emit-round stamp: the delivery-latency clock (change
                # commit round -> this round)
                ev.round = self._rounds_ticked
            queues = self._sub_queues.get(sub_id, ())
            for q in queues:  # live streams
                q.extend(evs)
            if queues:
                delivered = True
                self.channels.on_send("subs_events", len(evs) * len(queues))
        if delivered:
            # depth from ground truth, once per tick: consumers drain
            # their deques directly
            self.channels.set_depth(
                "subs_events",
                sum(len(q) for qs in self._sub_queues.values() for q in qs),
            )

    @property
    def converged(self) -> bool:
        """Every live node caught up right now: version-head gap 0, no
        buffered partial versions and no host-side pending changesets."""
        return (
            self._gap == 0.0
            and self._partials == 0.0
            and not any(self._pending)
        )

    def run_until_converged(self, max_rounds: int = 512) -> int | None:
        """Tick until every live node caught up; returns the round count
        (at chunk granularity once chunks run).

        The first 4 rounds run singly; later ones in _CHUNK-round chunks
        while no subscription is active."""
        with self.locks.tracked(self._lock, "run_until_converged", "write"):
            done = 0
            while done < max_rounds:
                if (
                    done >= 4
                    and max_rounds - done >= _CHUNK
                    and not self._subs_active()
                ):
                    self._tick_chunk_locked()
                    done += _CHUNK
                else:
                    self._tick_locked(1)
                    done += 1
                if self._log_poisoned:
                    return None  # permanent: check .log_poisoned
                if self.converged:
                    return done
        return None

    # ------------------------------------------------------- introspection
    @property
    def log_poisoned(self) -> bool:
        """Ring-wrap tripwire latched: state may be silently wrong, and
        ``run_until_converged`` returns None from here on."""
        return self._log_poisoned

    def _table_live(self) -> torch.Tensor:
        """(T, N) live rows per table per node, on the device (tables in
        schema order)."""
        cl = self.state.table.cl
        live = cl % 2 == 1
        per_table = [live[:, start:start + cap].sum(1)
                     for start, cap in map(self.layout._range,
                                           self.layout.schema.tables)]
        if not per_table:
            return cl.new_zeros((0, cl.shape[0]), dtype=torch.int64)
        return torch.stack(per_table)

    def _table_stats_from(self, live: np.ndarray) -> dict:
        """The ``table_stats`` body from the (T, N) live-row counts."""
        out = {}
        for i, name in enumerate(self.layout.schema.tables):
            _, cap = self.layout._range(name)
            out[name] = {
                "allocated_pks": self.layout._used[name],
                "capacity": cap,
                "live_rows_per_node": live[i].tolist(),
            }
        return out

    def table_stats(self) -> dict:
        """GET /v1/table_stats analog (``api/public/mod.rs:535-590``):
        counted on the device, read in one copy."""
        with self._lock:
            live = self._table_live().cpu().numpy()
        return self._table_stats_from(live)

    def actor_versions(self, actor: int) -> dict:
        """Admin ``actor version`` analog: bookkeeping for one actor."""
        self._check_node(actor)
        with self._lock:
            log = self.state.log
            # one copy: the applied heads, then written and cleared
            packed = torch.cat([
                self.state.book.head[:, actor].to(torch.int64),
                log.head[actor].reshape(1).to(torch.int64),
                log.cleared[actor].sum().reshape(1).to(torch.int64),
            ]).cpu().numpy()
        return {
            "actor": actor,
            "versions_written": int(packed[-2]),
            "versions_cleared": int(packed[-1]),
            "applied_head_per_node": packed[:-2].tolist(),
        }

    def _self_inc_device(self) -> torch.Tensor:
        """(N,) each node's own SWIM incarnation, on the device (SWIM
        on): windowed SWIM keeps self in slot 0, the full plane on the
        diagonal."""
        sw = self.state.swim
        if hasattr(sw, "member"):
            return sw.self_inc
        from corro_sim_torch.membership.swim import swim_layout

        shift = swim_layout(sw.p.dtype).inc_shift
        return (sw.p.diagonal() >> shift).to(torch.int32)

    def _self_inc(self) -> np.ndarray | None:
        """(N,) each node's own SWIM incarnation; None with SWIM off."""
        if not self.cfg.swim_enabled:
            return None
        with self._lock:
            return self._self_inc_device().cpu().numpy()

    def members(self) -> list[dict]:
        """Cluster membership view (admin ``cluster members`` analog)."""
        inc = self._self_inc()
        return [
            {
                "id": i,
                "alive": bool(self._alive[i]),
                "partition": int(self._part[i]),
                "pending_writes": len(self._pending[i]),
                **({"incarnation": int(inc[i])} if inc is not None else {}),
            }
            for i in range(self.cfg.num_nodes)
        ]

    def probe_trace(self):
        """The run's probe provenance (``obs.probes.ProbeTrace``); None
        when ``cfg.probes == 0``."""
        if not self.cfg.probes:
            return None
        from corro_sim_torch.obs.probes import ProbeTrace

        with self._lock:
            return ProbeTrace.from_state(
                self.cfg, self.state, driver="live_cluster",
                rounds=self._rounds_ticked,
            )

    def _belief_device(self) -> torch.Tensor:
        """(2, N) int64 on the device: how many observers hold each node
        SUSPECT (row 0) and DOWN (row 1). SWIM on."""
        n = self.cfg.num_nodes
        sw = self.state.swim
        status = sw.status
        if hasattr(sw, "member"):  # windowed O(N·K) belief state
            member = sw.member
            tracked = member >= 0
            idx = member.clamp_min(0).reshape(-1).long()
            out = torch.zeros((2, n), dtype=torch.int64,
                              device=status.device)
            out[0].scatter_add_(
                0, idx, (tracked & (status == 1)).reshape(-1).long())
            out[1].scatter_add_(
                0, idx, (tracked & (status >= 2)).reshape(-1).long())
            return out
        return torch.stack([(status == 1).sum(0), (status >= 2).sum(0)])

    def _suspected_by(self) -> np.ndarray:
        """(N,): how many observers currently suspect each node (zeros
        with SWIM off)."""
        if not self.cfg.swim_enabled:
            return np.zeros(self.cfg.num_nodes, np.int64)
        with self._lock:
            return self._belief_device()[0].cpu().numpy()

    def _behind_device(self) -> torch.Tensor:
        """(N,) int64 on the device: versions written cluster-wide that
        each node has not applied (dead nodes included)."""
        st = self.state
        return (st.log.head[None, :] - st.book.head).clamp_min(0).sum(1)

    def _lag_from(self, behind, suspected_by, last_sync,
                  top_k: int = 8) -> dict:
        from corro_sim_torch.obs.probes import lag_summary

        return lag_summary(behind, self._alive, self._rounds_ticked,
                           last_sync=last_sync, suspected_by=suspected_by,
                           top_k=top_k)

    def node_lag(self, top_k: int = 8) -> dict:
        """The per-node lag observatory (``obs.probes``): rows behind,
        last-sync age (probe-tracked), SWIM suspicion and the top-k
        laggards. Reduced on the device, read in one copy."""
        n = self.cfg.num_nodes
        with self._lock:
            parts = [self._behind_device()]
            if self.cfg.swim_enabled:
                parts.append(self._belief_device()[0])
            if self.cfg.probes:
                parts.append(self.state.probe.last_sync.to(torch.int64))
            host = torch.cat(parts).cpu().numpy()
        behind, rest = host[:n], host[n:]
        if self.cfg.swim_enabled:
            sus, rest = rest[:n], rest[n:]
        else:
            sus = np.zeros(n, np.int64)
        last_sync = rest if self.cfg.probes else None
        return self._lag_from(behind, sus, last_sync, top_k=top_k)

    def scrape_reads(self) -> dict:
        """What ``/metrics`` reads of the device state, reduced on the
        device and read in one copy under the lock (the probe tracer's
        planes, when probes are on, come in their own copies)::

            head (A,) log heads; behind (N,); live (T, N) rows per table;
            book_sum, cleared, pend_live, pend_size; and with SWIM on
            suspected_by, down_by, self_inc (N,); with probes on
            last_sync (N,) and the ProbeTrace ``probe``.
        """
        n, cfg = self.cfg.num_nodes, self.cfg
        with self._lock:
            st = self.state
            live = self._table_live()
            t = live.shape[0]
            scalars = torch.stack([
                st.book.head.sum(dtype=torch.int64),
                st.log.cleared.sum(dtype=torch.int64),
                (st.gossip.pend_tx > 0).sum(),
            ])
            parts = [st.log.head.to(torch.int64), self._behind_device(),
                     live.reshape(-1).to(torch.int64), scalars]
            if cfg.swim_enabled:
                parts += [self._belief_device().reshape(-1),
                          self._self_inc_device().to(torch.int64)]
            if cfg.probes:
                parts.append(st.probe.last_sync.to(torch.int64))
            host = torch.cat(parts).cpu().numpy()
            pend_size = st.gossip.pend_tx.numel()
            probe = self.probe_trace()
        a = st.log.head.shape[0]
        out = {"head": host[:a], "behind": host[a:a + n]}
        i = a + n
        out["live"] = host[i:i + t * n].reshape(t, n)
        i += t * n
        out["book_sum"], out["cleared"], out["pend_live"] = (
            int(v) for v in host[i:i + 3])
        i += 3
        out["pend_size"] = int(pend_size)
        if cfg.swim_enabled:
            out["suspected_by"] = host[i:i + n]
            out["down_by"] = host[i + n:i + 2 * n]
            out["self_inc"] = host[i + 2 * n:i + 3 * n]
            i += 3 * n
        out["last_sync"] = host[i:i + n] if cfg.probes else None
        out["probe"] = probe
        out["table_stats"] = self._table_stats_from(out["live"])
        out["node_lag"] = self._lag_from(
            out["behind"],
            out.get("suspected_by", np.zeros(n, np.int64)),
            out["last_sync"],
        )
        return out

    def probe_report(self) -> dict:
        """The GET /v1/probes body: per-probe summaries and infection
        trees plus the lag observatory."""
        from corro_sim_torch.obs.probes import ground_truth_adjacency

        tr = self.probe_trace()
        out = {"node_lag": self.node_lag()}
        if tr is None:
            out["probes"] = None
            out["note"] = (
                "probe tracer disabled — start the cluster with "
                "cfg_overrides={'probes': K}"
            )
            return out
        adj = ground_truth_adjacency(
            self._alive, self._part,
            blackhole=self.cfg.faults.blackhole,
        )
        out.update(tr.report(adj=adj))
        return out

    def _probe_p99_check(self) -> None:
        """Flight annotation when a probe's p99 delivery lag worsens;
        runs only when the infected count moved (the check costs a
        (K, N) device read)."""
        cur = self._lasts.get("probe_infected")
        if cur is None or cur == self._probe_infected_last:
            return
        self._probe_infected_last = cur
        tr = self.probe_trace()
        if tr is None:
            return
        p99 = tr.delivery_p99()
        if (
            p99 is not None
            and self._probe_p99 is not None
            and p99 > self._probe_p99
        ):
            self.flight.annotate(
                self._rounds_ticked, "probe_p99_regression",
                p99=p99, prev=self._probe_p99,
            )
        if p99 is not None:
            self._probe_p99 = p99

    def metrics_lasts(self) -> dict:
        """Last-round gauge snapshots (ring depth, cumulative overflow)."""
        with self._lock:
            return dict(self._lasts)

    def metrics_totals(self) -> dict:
        with self._lock:
            return dict(self._totals)

    # ---------------------------------------------------- fault injection
    def load_scenario(self, spec: str, rounds: int = 128,
                      seed: int | None = None) -> dict:
        """Arm a chaos scenario (``faults/scenarios.py``).

        Its alive/partition timeline replays relative to the current
        round (each tick applies the matching row, holding the last one
        once the timeline ends), and its fault-knob overrides go into the
        step programs. Scheduled events annotate the flight record as
        the rounds pass. Returns the POST /v1/faults body."""
        from corro_sim_torch.faults import make_scenario

        with self.locks.tracked(self._lock, "load_scenario", "write"):
            sc = make_scenario(
                spec, self.cfg.num_nodes, rounds=rounds,
                write_rounds=0,  # live writes come from the API
                seed=self._seed if seed is None else seed,
            )
            # relative to the construction-time baseline, never to an
            # earlier scenario's knobs
            new_cfg = sc.apply(dataclasses.replace(
                self.cfg, faults=self._baseline_faults
            ))
            if new_cfg != self.cfg:
                self.cfg = new_cfg
                self._resize_fault_burst()
                self._build_step()
            self._scenario = sc
            self._scenario_base = self._rounds_ticked
            self._scenario_events = 0
            self.flight.annotate(
                self._rounds_ticked + 1, "scenario_loaded",
                scenario=sc.spec, rounds=rounds,
            )
            self.flight.set_meta(scenario=sc.spec)
            return self.fault_report()

    def clear_scenario(self) -> dict:
        """Disarm the scenario: full liveness, one partition and the
        construction-time fault knobs."""
        with self.locks.tracked(self._lock, "clear_scenario", "write"):
            self._scenario = None
            self._alive[:] = True
            self._part[:] = 0
            if self.cfg.faults != self._baseline_faults:
                self.cfg = dataclasses.replace(
                    self.cfg, faults=self._baseline_faults
                )
                self._resize_fault_burst()
                self._build_step()
            self.flight.annotate(
                self._rounds_ticked + 1, "scenario_cleared",
            )
            return self.fault_report()

    def _resize_fault_burst(self) -> None:
        """Match ``state.fault_burst`` to the fault config: per-node (N,)
        with burst loss on, the (1,) placeholder off."""
        want = (
            (self.cfg.num_nodes,) if self.cfg.faults.burst_enter > 0
            else (1,)
        )
        if tuple(self.state.fault_burst.shape) != want:
            self.state = dataclasses.replace(
                self.state,
                fault_burst=torch.zeros(want, dtype=torch.bool,
                                        device=self.device),
            )

    def _apply_scenario_round(self) -> None:
        """Set the alive/partition ground truth of the round about to run
        from the armed scenario's timeline; annotate passing events."""
        sc = self._scenario
        if sc is None:
            return
        r = self._rounds_ticked - self._scenario_base
        if sc.alive is not None:
            self._alive = np.asarray(
                sc.alive[min(r, len(sc.alive) - 1)], bool
            ).copy()
        if sc.part is not None:
            self._part = np.asarray(
                sc.part[min(r, len(sc.part) - 1)], np.int32
            ).copy()
        while self._scenario_events < len(sc.events):
            ev_r, ev_name, ev_attrs = sc.events[self._scenario_events]
            if ev_r > r:
                break
            self.flight.annotate(
                self._scenario_base + ev_r + 1, "fault_event",
                kind=ev_name, **ev_attrs,
            )
            self._scenario_events += 1

    def _scenario_uniform(self, k: int) -> bool:
        """Whether the next ``k`` scenario rows are identical (a chunk
        holds alive/part constant)."""
        sc = self._scenario
        if sc is None:
            return True
        r = self._rounds_ticked - self._scenario_base
        for arr in (sc.alive, sc.part):
            if arr is None:
                continue
            lo = min(r, len(arr) - 1)
            hi = min(r + k - 1, len(arr) - 1)
            window = arr[lo:hi + 1]
            if len(window) and (window != window[0]).any():
                return False
        return True

    def fault_report(self) -> dict:
        """The GET /v1/faults body: armed scenario, fault knobs,
        injected-fault totals and the burst gauge."""
        with self._lock:
            sc = self._scenario
            totals = {
                k: int(v) for k, v in sorted(self._totals.items())
                if k.startswith("fault_") and k != "fault_burst_nodes"
            }
            faults = dataclasses.asdict(self.cfg.faults)
            faults["blackhole"] = [list(p) for p in self.cfg.faults.blackhole]
            return {
                "scenario": sc.spec if sc is not None else None,
                "scenario_round": (
                    self._rounds_ticked - self._scenario_base
                    if sc is not None else None
                ),
                "heal_round": sc.heal_round if sc is not None else None,
                "faults": faults,
                "enabled": self.cfg.faults.enabled,
                "totals": totals,
                "burst_nodes": int(self._lasts.get("fault_burst_nodes", 0)),
                "alive": int(self._alive.sum()),
                "partitions": int(len(set(self._part.tolist()))),
            }

    def set_alive(self, node: int, alive: bool) -> None:
        self._check_node(node)
        with self._lock:
            self._alive[node] = alive
            self.flight.annotate(
                self._rounds_ticked + 1, "schedule_transition",
                kind="set_alive", node=node, alive=bool(alive),
            )

    def set_partition(self, part: list[int]) -> None:
        with self._lock:
            if len(part) != self.cfg.num_nodes:
                raise ValueError(
                    f"partition of {len(part)} ids for "
                    f"{self.cfg.num_nodes} nodes"
                )
            self._part = np.asarray(part, np.int32)
            self.flight.annotate(
                self._rounds_ticked + 1, "schedule_transition",
                kind="set_partition",
                partitions=int(len(set(int(p) for p in part))),
            )

    def rejoin(self, node: int) -> dict:
        """Admin ``cluster rejoin`` analog: revive with a renewed identity.

        The reference sends ``FocaCmd::Rejoin``: foca re-announces with a
        fresh timestamp so peers that declared the node down accept it
        back (``actor.rs:199-210``). Here: mark the node alive and bump
        its self-incarnation, the SWIM refutation that overrides any
        DOWN belief as it gossips out. The belief plane's self entry is
        written in place (the cluster owns its state)."""
        self._check_node(node)
        with self.locks.tracked(self._lock, f"rejoin node={node}", "write"):
            self._alive[node] = True
            inc = None
            if self.cfg.swim_enabled:
                from corro_sim_torch.membership.swim import (
                    pack_swim,
                    swim_layout,
                )

                swim = self.state.swim
                # windowed: self is slot 0; full: the diagonal
                plane, at = ((swim.belief, (node, 0))
                             if hasattr(swim, "member")
                             else (swim.p, (node, node)))
                lo = swim_layout(plane.dtype)
                # saturate like swim_step's refutation: wrapping the
                # packed inc field would reset precedence to zero
                new_inc = min((int(plane[at]) >> lo.inc_shift) + 1,
                              lo.inc_max)
                plane[at] = pack_swim(0, new_inc, 0, dtype=lo.dtype).to(
                    plane.device)
                inc = new_inc
            return {"node": node, "alive": True, "incarnation": inc}

    def set_cluster_id(self, node: int, cluster_id: int) -> dict:
        """Admin ``cluster set-id`` analog: the partition plane is the
        wall between cluster ids (``actor.rs:222``,
        ``api/peer.rs:1488-1499``)."""
        self._check_node(node)
        if not (0 <= cluster_id < 2**16):
            raise ExecError(f"cluster id {cluster_id} out of u16 range")
        with self.locks.tracked(
            self._lock, f"set_cluster_id node={node}", "write"
        ):
            self._part[node] = cluster_id
            return {"node": node, "cluster_id": cluster_id}

    def reconcile_gaps(self) -> dict:
        """Admin ``sync reconcile-gaps`` analog: re-absorb any window
        bits contiguous with the head into the head counter
        (``collapse_gaps``, ``corro-admin/src/lib.rs:315-341``). Normally
        a no-op: the step absorbs eagerly."""
        from corro_sim_torch.core.bookkeeping import Bookkeeping
        from corro_sim_torch.utils.bits import absorb

        with self.locks.tracked(self._lock, "reconcile gaps", "write"):
            book = self.state.book
            head, win = absorb(
                book.head, book.win, self.cfg.chunks_per_version
            )
            changed = (head != book.head).cpu().numpy()
            self.state = dataclasses.replace(
                self.state, book=Bookkeeping(head=head, win=win)
            )
            return {
                "entries_reconciled": int(changed.sum()),
                "actors_reconciled": int(changed.any(axis=0).sum()),
            }

    # --------------------------------------------------------- migrations
    def migrate(self, schema_sql: str, capacities: dict | None = None) -> dict:
        """POST /v1/migrations analog: diff-based and additive-only
        (``apply_schema``, ``corro-types/src/schema.rs:274-646``), merged
        into the current schema as the reference's ``execute_schema``
        does."""
        with self.locks.tracked(self._lock, "migrate", "write"):
            new_schema = parse_and_constrain(schema_sql)
            merged = dataclasses.replace(
                new_schema,
                tables={**self.layout.schema.tables, **new_schema.tables},
            )
            plan = self.layout.migrate(merged, capacities=capacities)
            self._schema_history.append(schema_sql)
            new_rows = self.layout.num_rows
            new_cols = max(self.layout.num_cols, 1)
            grew = (
                new_rows > self.cfg.num_rows or new_cols > self.cfg.num_cols
            )
            if grew:
                self._grow(new_rows, new_cols)
            self._query_cache.clear()
            return {
                "new_tables": sorted(plan.new_tables),
                "new_columns": sorted(plan.new_columns),
                "resized": grew,
            }

    def _grow(self, new_rows: int, new_cols: int) -> None:
        """Pad the row/col axes of every table-shaped tensor and rebuild
        the step programs over the grown config (whose cell space decides
        the merge route)."""
        cfg = dataclasses.replace(
            self.cfg, num_rows=new_rows, num_cols=new_cols
        ).validate()
        st = self.state
        dr = new_rows - self.cfg.num_rows
        dc = new_cols - self.cfg.num_cols

        def pad_rc(x, fill):  # (..., R, C)
            return F.pad(x, (0, dc, 0, dr), value=fill)

        def pad_r(x, fill):  # (..., R)
            return F.pad(x, (0, dr), value=fill)

        table = dataclasses.replace(
            st.table,
            cv=pad_rc(st.table.cv, 0),
            vr=pad_rc(st.table.vr, int(NEG)),
            site=pad_rc(st.table.site, -1),
            cl=pad_r(st.table.cl, 0),
        )
        own = st.own
        own_pads = {}
        for f in dataclasses.fields(own):
            v = getattr(own, f.name)
            if v.ndim == 2:  # (R, C) planes
                fill = int(NEG) if f.name == "vr" else (
                    -1 if f.name in ("site", "actor", "ractor") else 0
                )
                own_pads[f.name] = pad_rc(v, fill)
            elif v.ndim == 1:  # (R,) rows
                fill = -1 if f.name in ("ractor", "rsite") else 0
                own_pads[f.name] = pad_r(v, fill)
        row_cdf = pad_r(st.row_cdf, 1.0)
        self.state = dataclasses.replace(
            st, table=table, own=dataclasses.replace(own, **own_pads),
            row_cdf=row_cdf,
        )
        self.cfg = cfg
        self._build_step()

    def schema_sql(self) -> dict:
        """The current schema, rendered table by table."""
        return {
            name: {
                "pk": list(t.pk),
                "columns": [
                    {
                        "name": c.name,
                        "type": c.type,
                        "nullable": c.nullable,
                        "pk": c.primary_key,
                    }
                    for c in t.columns
                ],
            }
            for name, t in self.layout.schema.tables.items()
        }

    def _check_node(self, node: int) -> None:
        if not (0 <= node < self.cfg.num_nodes):
            raise ExecError(
                f"node {node} out of range (cluster size "
                f"{self.cfg.num_nodes})"
            )
