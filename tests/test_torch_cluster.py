"""Parity of the port's LiveCluster (corro_sim_torch.harness.cluster) with
the JAX package's on the CPU.

Each case runs once per package from the same schema, seed and
statements (the JAX package's ``LiveCluster``; the port's with
``device="cpu"``) and keeps the reference case's own assertions. Both
must observe the same thing: every value the case returns (query rows,
events, versions, admin results, the class and message of every error)
and, after it, the same cluster: every state leaf through
``corro_sim_torch.convert``, ``metrics_totals()``, ``metrics_lasts()``,
the flight record, the round count, liveness, partitions, pending queues,
the value universe and the slot layout. Tolerance: exact.

The cases of tests/test_cluster.py, in its order on one shared pair of
clusters; config 1 (corro_sim_torch.benchmarks.config1_run) at 3 and 8
agents and its pins; chunked against single ticks; an overlay query
leaving the committed planes untouched; the merge kernel forced on a
128-multiple cell space (the JAX package's Pallas kernel in interpret
mode, the port's mailbox path through the plain merge) and a migration
that grows the cell space onto a multiple of 128 (the admin, scenario
and introspection calls under full-view and windowed SWIM are in
tests/test_torch_cluster_admin.py); and the live phase's population at
256 nodes held to the JAX package's pins.
"""

import collections
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

import corro_sim.harness.cluster as r_cluster
import corro_sim.io.checkpoint as r_ckpt
import corro_sim_torch.harness.cluster as p_cluster
import corro_sim_torch.io.checkpoint as p_ckpt
from corro_sim_torch.benchmarks import config1_run
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.profile_slice import CONFIG1_PINS, run_digest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU runs on one intra-op thread: its tensors are small,
    and under the suite's parallel workers a thread pool per process
    oversubscribes the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def ref_leaves(state) -> dict:
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(state)}


REF = types.SimpleNamespace(
    key="ref", LiveCluster=r_cluster.LiveCluster,
    ExecError=r_cluster.ExecError, leaves=ref_leaves,
    save_checkpoint=r_ckpt.save_checkpoint,
    load_checkpoint=r_ckpt.load_checkpoint, backup=r_ckpt.backup,
    restore=r_ckpt.restore, restore_into=r_ckpt.restore_into)
PORT = types.SimpleNamespace(
    key="port",
    LiveCluster=functools.partial(p_cluster.LiveCluster, device="cpu"),
    ExecError=p_cluster.ExecError, leaves=state_to_numpy,
    save_checkpoint=p_ckpt.save_checkpoint,
    load_checkpoint=functools.partial(p_ckpt.load_checkpoint, device="cpu"),
    backup=p_ckpt.backup,
    restore=functools.partial(p_ckpt.restore, device="cpu"),
    restore_into=p_ckpt.restore_into)
BOTH = (REF, PORT)


def plain(x):
    """``x`` in a comparable form: events as their fields, containers as
    lists and dicts, numpy values as Python ones."""
    if hasattr(x, "kind") and hasattr(x, "change_id"):
        return ["event", x.kind, x.rowid, plain(x.cells), x.change_id,
                x.round]
    if isinstance(x, dict):
        return {plain(k) if isinstance(k, tuple) else k: plain(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple, collections.deque)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def outcome(fn, *args):
    """``fn(*args)``'s value, or the error it raised as (class, message)."""
    try:
        return ("ok", plain(fn(*args)))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return (type(e).__name__, str(e))


def cluster_view(c, leaves) -> dict:
    """Everything of a cluster the two packages must agree on, the state
    leaves apart."""
    values, ranks = c.universe.snapshot()
    return {
        "totals": c.metrics_totals(), "lasts": c.metrics_lasts(),
        "flight": c.flight.to_ndjson(), "rounds": c._rounds_ticked,
        "alive": c._alive.tolist(), "part": np.asarray(c._part).tolist(),
        "pending": [[(cs.is_delete, cs.cells) for cs in q]
                    for q in c._pending],
        "universe": (values, ranks),
        "slots": sorted(c.layout._slots.items(), key=repr),
        "ranges": c.layout._ranges, "history": c._schema_history,
        "cfg": dataclasses.asdict(c.cfg), "subs": sorted(
            (sid, m.select.normalized(), m.node, m.change_id)
            for sid, m in c.subs._by_id.items()),
        "converged": c.converged, "poisoned": c.log_poisoned,
        "leaf_keys": sorted(leaves),
    }


def assert_same_cluster(rc, pc) -> None:
    a, b = ref_leaves(rc.state), state_to_numpy(pc.state)
    assert cluster_view(pc, b) == cluster_view(rc, a)
    bad = [k for k in a
           if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    assert not bad, f"state leaves differ: {bad}"


def both(pair: dict, case, *args):
    """Run ``case(backend, cluster, *args)`` on each package's cluster
    and hold the port to the JAX package."""
    got = {B.key: outcome(case, B, pair[B.key], *args) for B in BOTH}
    assert got["ref"][0] == "ok", got["ref"]
    assert got["port"] == got["ref"]
    assert_same_cluster(pair["ref"], pair["port"])
    return got["port"][1]


# ---------------------------------------------- tests/test_cluster.py
SCHEMA = """
CREATE TABLE todos (
    id INTEGER NOT NULL PRIMARY KEY,
    title TEXT NOT NULL DEFAULT '',
    done INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE kv (
    ns TEXT NOT NULL,
    k TEXT NOT NULL,
    v TEXT,
    PRIMARY KEY (ns, k)
);
"""


@pytest.fixture(scope="module")
def pair():
    return {B.key: B.LiveCluster(SCHEMA, num_nodes=4, seed=7,
                                 default_capacity=64) for B in BOTH}


def case_execute_and_local_query(B, c):
    res = c.execute(
        [["INSERT INTO todos (id, title, done) VALUES (?, ?, ?)",
          [1, "write the tests", 0]],
         {"query": "INSERT INTO todos (id, title) VALUES (:id, :t)",
          "named_params": {"id": 2, "t": "ship it"}}],
        node=0,
    )
    assert res["version"] >= 2
    assert [r["rows_affected"] for r in res["results"]] == [1, 1]
    cols, rows = c.query_rows("SELECT title, done FROM todos", node=0)
    assert cols == ["id", "title", "done"]
    got = {tuple(r) for r in rows}
    assert (1, "write the tests", 0) in got
    assert any(r[0] == 2 and r[1] == "ship it" for r in rows)
    return res["version"], [r["rows_affected"] for r in res["results"]], \
        cols, rows


def case_gossip_convergence_to_other_nodes(B, c):
    done = c.run_until_converged(max_rounds=64)
    assert done is not None
    out = [done]
    for node in range(4):
        _, rows = c.query_rows("SELECT title FROM todos", node=node)
        assert "write the tests" in {r[1] for r in rows}
        out.append(rows)
    return out


def case_update_and_delete_propagate(B, c):
    a = c.execute(["UPDATE todos SET done = 1 WHERE id = 1"], node=1)
    b = c.execute(["DELETE FROM todos WHERE id = 2"], node=2)
    done = c.run_until_converged(max_rounds=64)
    assert done is not None
    out = [a["version"], b["version"], done]
    for node in range(4):
        _, rows = c.query_rows("SELECT done FROM todos WHERE id = 1",
                               node=node)
        assert len(rows) == 1 and rows[0][1] == 1
        _, gone = c.query_rows("SELECT title FROM todos WHERE id = 2",
                               node=node)
        assert gone == []
        out.append(rows)
    return out


def case_composite_pk_and_predicate_update(B, c):
    c.execute(
        [["INSERT INTO kv (ns, k, v) VALUES (?, ?, ?)", ["a", "x", "1"]],
         ["INSERT INTO kv (ns, k, v) VALUES (?, ?, ?)", ["a", "y", "1"]],
         ["INSERT INTO kv (ns, k, v) VALUES (?, ?, ?)", ["b", "x", "2"]]],
        node=3,
    )
    res = c.execute(["UPDATE kv SET v = '9' WHERE v = '1'"], node=3)
    assert res["results"][0]["rows_affected"] == 2
    done = c.run_until_converged(max_rounds=64)
    assert done is not None
    _, rows = c.query_rows("SELECT v FROM kv WHERE v = '9'", node=0)
    assert len(rows) == 2
    return res["version"], done, rows


def case_lww_conflict_converges_to_one_winner(B, c):
    c.execute([["INSERT INTO kv (ns, k, v) VALUES (?, ?, ?)",
                ["c", "w", "n0"]]], node=0)
    c.execute([["INSERT INTO kv (ns, k, v) VALUES (?, ?, ?)",
                ["c", "w", "n1"]]], node=1)
    done = c.run_until_converged(max_rounds=64)
    assert done is not None
    vals = set()
    for node in range(4):
        _, rows = c.query_rows("SELECT v FROM kv WHERE ns = 'c'", node=node)
        assert len(rows) == 1
        vals.add(rows[0][-1])
    assert len(vals) == 1
    return done, sorted(vals)


def case_subscription_sees_remote_changes(B, c):
    sub_id, initial = c.subscribe("SELECT v FROM kv WHERE ns = 'sub'",
                                  node=0)
    assert initial[0] == {"columns": ["ns", "k", "v"]}
    assert initial[-1]["eoq"]["change_id"] == 0
    q = c.sub_attach_queue(sub_id)
    c.execute([["INSERT INTO kv (ns, k, v) VALUES (?, ?, ?)",
                ["sub", "e", "hi"]]], node=2)
    done = c.run_until_converged(max_rounds=64)
    kinds = [e.kind for e in q]
    assert "insert" in kinds
    ev = next(e for e in q if e.kind == "insert")
    assert ev.cells == ["sub", "e", "hi"]
    missed = c.sub_catch_up(sub_id, 0)
    assert missed and missed[0].change_id == 1
    return sub_id, initial, done, list(q), missed


def case_errors(B, c):
    out = []
    for stmts in (["DROP TABLE todos"],
                  [["INSERT INTO todos (title) VALUES (?)", ["no pk"]]],
                  ["DELETE FROM todos"],
                  [["INSERT INTO nope (id) VALUES (?)", [1]]]):
        with pytest.raises(B.ExecError) as err:
            c.execute(stmts, node=0)
        out.append(str(err.value))
    return out


def case_migration_adds_table_and_grows_state(B, c):
    plan = c.migrate(SCHEMA + """
    CREATE TABLE notes (
        id INTEGER NOT NULL PRIMARY KEY,
        body TEXT NOT NULL DEFAULT ''
    );
    """)
    assert plan["new_tables"] == ["notes"]
    c.execute([["INSERT INTO notes (id, body) VALUES (?, ?)",
                [1, "post-migrate"]]], node=0)
    done = c.run_until_converged(max_rounds=64)
    assert done is not None
    _, rows = c.query_rows("SELECT body FROM notes", node=3)
    assert rows and rows[0][1] == "post-migrate"
    _, old = c.query_rows("SELECT title FROM todos", node=3)
    assert any(r[1] == "write the tests" for r in old)
    return plan, done, rows, old


def case_pk_range_delete_respects_pk_predicate(B, c):
    c.execute([["INSERT INTO todos (id, title) VALUES (?, ?)", [10, "keep"]],
               ["INSERT INTO todos (id, title) VALUES (?, ?)", [11, "drop"]],
               ["INSERT INTO todos (id, title) VALUES (?, ?)", [12, "drop"]]],
              node=0)
    res = c.execute(["DELETE FROM todos WHERE id > 10"], node=0)
    assert res["results"][0]["rows_affected"] == 2
    _, rows = c.query_rows("SELECT title FROM todos WHERE id >= 10")
    assert [r[1] for r in rows] == ["keep"]
    return res["version"], rows


def case_update_does_not_resurrect_deleted_row(B, c):
    c.execute([["INSERT INTO todos (id, title) VALUES (?, ?)", [20, "gone"]]],
              node=0)
    c.execute(["DELETE FROM todos WHERE id = 20"], node=0)
    res = c.execute(["UPDATE todos SET title = 'back?' WHERE id = 20"],
                    node=0)
    assert res["results"][0]["rows_affected"] == 0
    _, rows = c.query_rows("SELECT title FROM todos WHERE id = 20")
    assert rows == []
    return res["version"]


def case_write_to_down_node_is_refused(B, c):
    c.set_alive(1, False)
    try:
        with pytest.raises(B.ExecError) as err:
            c.execute([["INSERT INTO todos (id) VALUES (?)", [99]]], node=1)
    finally:
        c.set_alive(1, True)
    return str(err.value)


def case_subscription_literal_interned_before_rows_exist(B, c):
    sub_id, initial = c.subscribe(
        "SELECT v FROM kv WHERE v = 'latecomer'", node=0)
    assert not any("row" in e for e in initial)
    q = c.sub_attach_queue(sub_id)
    c.execute([["INSERT INTO kv (ns, k, v) VALUES (?, ?, ?)",
                ["late", "x", "latecomer"]]], node=1)
    done = c.run_until_converged(max_rounds=64)
    assert any(e.kind == "insert" and e.cells[-1] == "latecomer" for e in q)
    return sub_id, initial, done, list(q)


def case_table_stats_and_introspection(B, c):
    stats = c.table_stats()
    assert "todos" in stats and "kv" in stats
    assert stats["todos"]["live_rows_per_node"][0] >= 1
    av = c.actor_versions(0)
    assert av["versions_written"] >= 2
    members = c.members()
    assert len(members) == 4 and all(m["alive"] for m in members)
    return stats, av, members, c.schema_sql()


CLUSTER_CASES = [
    case_execute_and_local_query,
    case_gossip_convergence_to_other_nodes,
    case_update_and_delete_propagate,
    case_composite_pk_and_predicate_update,
    case_lww_conflict_converges_to_one_winner,
    case_subscription_sees_remote_changes,
    case_errors,
    case_migration_adds_table_and_grows_state,
    case_pk_range_delete_respects_pk_predicate,
    case_update_does_not_resurrect_deleted_row,
    case_write_to_down_node_is_refused,
    case_subscription_literal_interned_before_rows_exist,
    case_table_stats_and_introspection,
]


@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=[c.__name__[5:] for c in CLUSTER_CASES])
def test_cluster_case(pair, case):
    both(pair, case)


# ----------------------------------------------------------- config 1
@pytest.mark.parametrize("nodes", [3, 8])
def test_config1_parity(nodes):
    runs = {B.key: config1_run(B.LiveCluster, 64, nodes) for B in BOTH}
    assert runs["port"]["converged_round"] is not None
    assert (runs["port"]["converged_round"]
            == runs["ref"]["converged_round"])
    assert_same_cluster(runs["ref"]["cluster"], runs["port"]["cluster"])


def jax_config1_pins(nodes: int) -> tuple:
    """The recipe of ``profile_slice.CONFIG1_PINS``: the JAX package's
    config 1 (``config1_run`` on its LiveCluster, ``CONFIG1_INSERTS``
    INSERTs) on the CPU, its converged round and the run_digest of its
    final state (about 10 s at 3 agents, 14 s at 64)."""
    from corro_sim_torch.profile_slice import CONFIG1_INSERTS

    run = config1_run(REF.LiveCluster, CONFIG1_INSERTS, nodes)
    return (run["converged_round"],
            run_digest(ref_leaves(run["cluster"].state), {}))


@pytest.mark.parametrize("nodes", sorted(CONFIG1_PINS))
def test_config1_port_meets_pins(nodes):
    """The port's config 1 on the CPU at the pinned sizes reaches the JAX
    package's round and final state (chip_smoke.py's "config1" holds
    the card's run to the same pins)."""
    from corro_sim_torch.profile_slice import CONFIG1_INSERTS

    run = config1_run(PORT.LiveCluster, CONFIG1_INSERTS, nodes)
    got = (run["converged_round"],
           run_digest(state_to_numpy(run["cluster"].state), {}))
    assert got == CONFIG1_PINS[nodes]


# ------------------------------------------------- ticks and overlays
KV = """
CREATE TABLE kv (
    k TEXT PRIMARY KEY,
    v TEXT NOT NULL DEFAULT '',
    n INTEGER NOT NULL DEFAULT 0
);
"""


def queue_writes(c, count: int, nodes: int) -> None:
    for i in range(count):
        c.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)",
                    [f"k{i % 40}", f"v{i}", i]]], node=i % nodes,
                  wait=False)


def test_chunked_ticks_equal_single_ticks():
    """Chunks of 16 rounds (a host loop keyed by absolute round) give the
    state, totals and flight record of 16 single rounds, in both
    packages; and the JAX package's chunks equal the port's singles."""
    got = {}
    for B in BOTH:
        for mode in ("chunk", "single"):
            c = B.LiveCluster(KV, num_nodes=6, seed=3, default_capacity=48)
            queue_writes(c, 60, 6)
            with c._lock:
                if mode == "chunk":
                    c._tick_chunk_locked()
                    c._tick_chunk_locked()
                else:
                    c._tick_locked(32)
            got[B.key, mode] = c
    assert got["port", "chunk"]._chunk_dispatches == 2
    assert got["port", "single"]._chunk_dispatches == 0
    assert_same_cluster(got["ref", "chunk"], got["port", "single"])
    assert_same_cluster(got["ref", "single"], got["port", "chunk"])
    assert_same_cluster(got["ref", "chunk"], got["port", "chunk"])


def test_overlay_query_leaves_the_table_untouched():
    """``query(..., overlay=)`` sees a transaction's staged writes and
    never writes the committed planes."""
    stmts = ["INSERT INTO kv (k, v, n) VALUES ('z', 'staged', 5)",
             "UPDATE kv SET v = 'changed' WHERE k = 'k1'",
             "DELETE FROM kv WHERE k = 'k2'",
             "UPDATE kv SET n = n + 100 WHERE n >= 3"]

    def case(B, c):
        queue_writes(c, 12, 4)
        c.run_until_converged()
        overlay, counts = c.plan_overlay(stmts, node=1)
        before = {f: getattr(c.state.table, f) for f in ("cv", "vr", "site",
                                                          "cl")}
        if B is PORT:
            before = {f: t.clone() for f, t in before.items()}
        staged = c.query_rows("SELECT k, v, n FROM kv", node=1,
                              overlay=overlay)
        where = c.query_rows("SELECT k, n FROM kv WHERE n >= 100", node=1,
                             overlay=overlay)
        committed = c.query_rows("SELECT k, v, n FROM kv", node=1)
        for f, t in before.items():
            now = getattr(c.state.table, f)
            assert np.array_equal(np.asarray(now), np.asarray(t)), f
        # the staged insert, then the staged n + 100 over it
        assert ["z", "staged", 105] in staged[1]
        assert not any(r[0] == "z" for r in committed[1])
        return counts, staged, where, committed

    pair = {B.key: B.LiveCluster(KV, num_nodes=4, seed=1,
                                 default_capacity=32) for B in BOTH}
    both(pair, case)


# --------------------------------------- the merge kernel, forced on
def converge_writes(B, c, count: int):
    queue_writes(c, count, c.cfg.num_nodes)
    c.execute(["UPDATE kv SET v = 'hot' WHERE n < 8"], node=1)
    return c.run_until_converged(max_rounds=256), c.query_rows(
        "SELECT k, v, n FROM kv", node=c.cfg.num_nodes - 1)


def test_merge_kernel_on_matches_interpret_mode():
    """``merge_kernel="on"`` on 64 rows x 2 columns (128 cells): the JAX
    package's Pallas kernel in interpret mode on both merge sites, the
    port's mailbox path through the plain merge."""
    pair = {B.key: B.LiveCluster(
        KV, num_nodes=5, seed=2, default_capacity=64,
        cfg_overrides={"merge_kernel": "on", "sync_interval": 2})
        for B in BOTH}
    assert pair["port"].cfg.num_rows * pair["port"].cfg.num_cols == 128
    both(pair, converge_writes, 50)


def test_migration_grows_the_cell_space_onto_the_kernel():
    """A migration that grows 60 rows x 2 columns (120 cells: the scatter
    arm) to 64 x 2 (128: the kernel under "on"): the planes are padded
    with the JAX package's fills and the merge route follows the grown
    config."""
    from corro_sim_torch.core.merge_kernel import kernel_supported

    def case(B, c):
        first = converge_writes(B, c, 30)
        plan = c.migrate(KV + "CREATE TABLE t2 (id INTEGER PRIMARY KEY, "
                              "w TEXT NOT NULL DEFAULT '');",
                         capacities={"t2": 4})
        c.execute(["INSERT INTO t2 (id, w) VALUES (1, 'grown')"], node=2)
        return first, plan, converge_writes(B, c, 20), c.query_rows(
            "SELECT id, w FROM t2", node=0)

    pair = {B.key: B.LiveCluster(
        KV, num_nodes=5, seed=4, default_capacity=60,
        cfg_overrides={"merge_kernel": "on", "sync_interval": 2})
        for B in BOTH}
    assert not kernel_supported(pair["port"].cfg, "sync", "cpu")
    both(pair, case)
    cfg = pair["port"].cfg
    assert (cfg.num_rows, cfg.num_cols) == (64, 2)
    assert kernel_supported(cfg, "sync", "cpu")


# ------------------------------------------------ the live population
def live_backend(B):
    return types.SimpleNamespace(LiveCluster=B.LiveCluster,
                                 save_checkpoint=B.save_checkpoint,
                                 load_checkpoint=B.load_checkpoint)


def live_run(B, tmp_path):
    from corro_sim_torch import profile_slice as ps

    n = ps.LIVE_PIN_NODES
    subscribers = ps.subs_subscribers(
        ps.subs_queries(ps.LIVE_SEED, n, ps.LIVE_KEYS), ps.LIVE_SEED)
    run = ps.live_drive(live_backend(B), n, subscribers=subscribers,
                        ckpt_path=str(tmp_path / f"live_{B.key}.npz"),
                        **ps.LIVE_DIGESTS_RUN)
    return run, ps.live_record(run, B.leaves(run["cluster"].state),
                               B.leaves(run["warm"].state))


def jax_live_pins(tmp_path) -> dict:
    """The recipe of ``profile_slice.LIVE_PINS``: chip_smoke.py's
    "live_digests" run (``live_drive`` with ``LIVE_DIGESTS_RUN`` at
    ``LIVE_PIN_NODES`` nodes, config 6's 1024 subscribers) on the JAX
    package's LiveCluster and checkpoints on the CPU, recorded by
    ``live_record`` (about 100 s)."""
    return live_run(REF, tmp_path)[1]


def test_live_digests_port_meets_pins(tmp_path):
    """The port on the CPU drives "live_digests" to the JAX package's
    pins: converged round, final and warm-booted state, every
    subscriber's initial events and stream, the statements' outcomes,
    metrics totals, flight record and admin results; and on the host,
    every subscriber's folded events equal its query's rows."""
    from corro_sim_torch import profile_slice as ps

    run, rec = live_run(PORT, tmp_path)
    assert rec == ps.LIVE_PINS
    assert rec["event_count"] > 0 and len(run["queues"]) == 1024
    assert ps.live_folded_mismatches(run) == []
    assert ps.subs_oracle_mismatches(run["cluster"].subs,
                                     run["cluster"].state.table) == 0


def test_concurrent_clients_lose_no_write():
    """Client threads (more than the cores) executing against one port
    cluster while another thread ticks: the cluster's lock serialises
    them, and every acknowledged write reaches every node."""
    import sys
    import threading

    c = PORT.LiveCluster(KV, num_nodes=4, seed=9, default_capacity=160)
    errors = []
    stop = threading.Event()

    def client(t):
        try:
            for i in range(5):
                c.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)",
                            [f"t{t}-{i}", "x", t]]], node=(t + i) % 4,
                          wait=(i % 2 == 0))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def ticker():
        while not stop.is_set():
            c.tick(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(24)]
        tick = threading.Thread(target=ticker)
        tick.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        stop.set()
        tick.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert not any(t.is_alive() for t in threads) and not tick.is_alive()
    assert c.run_until_converged(max_rounds=256) is not None
    for node in range(4):
        _, rows = c.query_rows("SELECT k FROM kv", node=node)
        assert len(rows) == 24 * 5
