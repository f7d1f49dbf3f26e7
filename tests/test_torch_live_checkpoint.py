"""Parity of the port's LiveCluster checkpoints (corro_sim_torch.io.
checkpoint: save_checkpoint, load_checkpoint, backup, restore,
restore_into) with the JAX package's on the CPU, and files crossing
between the two.

The cases of tests/test_checkpoint.py run once per package, each in its
own directory, and keep the reference case's assertions; both must
observe the same values and errors and end with the same clusters (every
state leaf, totals, flight record, layout, universe and subscriptions;
tests/test_torch_cluster.py::assert_same_cluster). Then a warm
checkpoint and a scrubbed backup from ``origin_node != 0`` written by
either package load in the other to the same cluster and subscriptions.
Both keep FORMAT_VERSION 4 and upgrade formats 2 and 3 the same way.
Tolerance: exact.
"""

import io
import json

import numpy as np
import pytest

from test_torch_cluster import (  # noqa: F401 - a module fixture
    BOTH, PORT, REF, assert_same_cluster, one_torch_thread, outcome)

SCHEMA = """
CREATE TABLE kv (
    k TEXT PRIMARY KEY,
    v TEXT NOT NULL DEFAULT '',
    n INTEGER NOT NULL DEFAULT 0
);
"""


def make_cluster(B, **kw):
    kw.setdefault("num_nodes", 4)
    kw.setdefault("default_capacity", 32)
    return B.LiveCluster(SCHEMA, **kw)


def seeded_cluster(B):
    c = make_cluster(B)
    c.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)", ["a", "x", 1]]],
              node=0)
    c.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)", ["b", "y", 2]]],
              node=2)
    c.execute(["UPDATE kv SET v = 'xx' WHERE k = 'a'"], node=1)
    c.run_until_converged()
    return c


def rows_all(c, sql="SELECT k, v, n FROM kv"):
    return [c.query_rows(sql, node=node) for node in range(c.cfg.num_nodes)]


def case_warm_checkpoint_roundtrip(B, d):
    c = seeded_cluster(B)
    sub_id, _ = c.subscribe("SELECT k, v FROM kv WHERE n >= 1", node=3)
    path = d / "ckpt.npz"
    B.save_checkpoint(c, path)
    r = B.load_checkpoint(path)
    assert rows_all(r) == rows_all(c)
    assert np.array_equal(np.asarray(r.state.book.head),
                          np.asarray(c.state.book.head))
    m = r.subs.get(sub_id)
    assert m is not None
    assert m.change_id == c.subs.get(sub_id).change_id
    _, q = r.sub_attach(sub_id, skip_rows=True)
    r.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)",
                ["c", "z", 3]]], node=1)
    r.run_until_converged()
    assert any("change" in (e if isinstance(e, dict) else e.as_json())
               for e in q)
    return [sub_id, list(q), rows_all(r)], [c, r]


def case_warm_checkpoint_resumes_prng_position(B, d):
    c = seeded_cluster(B)
    path = d / "ckpt.npz"
    B.save_checkpoint(c, path)
    r = B.load_checkpoint(path)
    c.tick(3)
    r.tick(3)
    assert np.array_equal(np.asarray(c.state.table.vr),
                          np.asarray(r.state.table.vr))
    assert np.array_equal(np.asarray(c.state.book.head),
                          np.asarray(r.state.book.head))
    return [], [c, r]


def case_backup_is_scrubbed_and_restores_elsewhere(B, d):
    c = seeded_cluster(B)
    c.subscribe("SELECT k FROM kv", node=1)
    path = d / "backup.npz"
    B.backup(c, path, node=2)
    r = B.restore(path, node=2)
    assert len(r.subs) == 0
    assert rows_all(r) == rows_all(c)
    r.execute([["INSERT INTO kv (k, v) VALUES (?, ?)", ["new", "w"]]])
    done = r.run_until_converged()
    _, rows = r.query_rows("SELECT k FROM kv WHERE k = 'new'", node=3)
    assert rows == [["new"]]
    return [done], [c, r]


def case_backup_actor_neutral_identity_swap(B, d):
    c = seeded_cluster(B)
    path = d / "neutral.npz"
    B.backup(c, path, node=2)
    r = B.restore(path, node=1)
    _, rows = r.query_rows("SELECT k, v FROM kv WHERE k = 'b'", node=0)
    assert rows == [["b", "y"]]
    old_heads = np.asarray(c.state.log.head)
    new_heads = np.asarray(r.state.log.head)
    assert new_heads[1] == old_heads[2]
    assert new_heads[2] == old_heads[1]
    return [new_heads], [c, r]


def case_restore_into_live_cluster(B, d):
    c = seeded_cluster(B)
    path = d / "b.npz"
    B.backup(c, path, node=0)
    other = make_cluster(B)
    other.execute([["INSERT INTO kv (k, v) VALUES (?, ?)", ["junk", "j"]]])
    other.subscribe("SELECT k FROM kv")
    B.restore_into(other, path, node=0)
    assert len(other.subs) == 0
    _, rows = other.query_rows("SELECT k, v, n FROM kv", node=0)
    assert sorted(r[0] for r in rows) == ["a", "b"]
    other.execute([["INSERT INTO kv (k, v) VALUES (?, ?)", ["post", "p"]]],
                  node=3)
    other.run_until_converged()
    _, post = other.query_rows("SELECT k FROM kv WHERE k = 'post'", node=1)
    assert post == [["post"]]
    return [rows, post], [c, other]


def case_restore_into_shape_mismatch_rejected(B, d):
    c = seeded_cluster(B)
    path = d / "b.npz"
    B.backup(c, path)
    small = B.LiveCluster(SCHEMA, num_nodes=2, default_capacity=32)
    with pytest.raises(ValueError) as err:
        B.restore_into(small, path)
    return [str(err.value)], [c, small]


def case_checkpoint_after_migration(B, d):
    c = seeded_cluster(B)
    c.migrate(SCHEMA + "CREATE TABLE t2 (id INTEGER PRIMARY KEY, "
                       "w TEXT NOT NULL DEFAULT '');")
    c.execute([["INSERT INTO t2 (id, w) VALUES (?, ?)", [1, "m"]]])
    c.run_until_converged()
    path = d / "mig.npz"
    B.save_checkpoint(c, path)
    r = B.load_checkpoint(path)
    _, rows = r.query_rows("SELECT id, w FROM t2", node=2)
    assert rows == [[1, "m"]]
    r.migrate(SCHEMA
              + "CREATE TABLE t2 (id INTEGER PRIMARY KEY, "
                "w TEXT NOT NULL DEFAULT '');"
              + "CREATE TABLE t3 (id INTEGER PRIMARY KEY);")
    r.execute(["INSERT INTO t3 (id) VALUES (9)"])
    _, t3 = r.query_rows("SELECT id FROM t3")
    assert t3 == [[9]]
    return [rows, t3], [c, r]


def case_restore_into_smaller_backup_rejected_without_corruption(B, d):
    small = B.LiveCluster(SCHEMA, num_nodes=4, default_capacity=16)
    small.execute([["INSERT INTO kv (k, v) VALUES (?, ?)", ["s", "small"]]])
    path = d / "small.npz"
    B.backup(small, path)
    big = make_cluster(B)
    big.execute([["INSERT INTO kv (k, v) VALUES (?, ?)", ["keep", "me"]]])
    sub_id, _ = big.subscribe("SELECT k FROM kv")
    with pytest.raises(ValueError) as err:
        B.restore_into(big, path)
    _, rows = big.query_rows("SELECT k, v FROM kv")
    assert rows == [["keep", "me"]]
    assert big.subs.get(sub_id) is not None
    big.execute([["INSERT INTO kv (k, v) VALUES (?, ?)", ["still", "up"]]])
    _, still = big.query_rows("SELECT k FROM kv WHERE k = 'still'")
    assert still == [["still"]]
    return [str(err.value), rows, still], [small, big]


def case_warm_restore_catch_up_past_buffer_404s(B, d):
    c = seeded_cluster(B)
    sub_id, _ = c.subscribe("SELECT k FROM kv", node=0)
    c.execute(["INSERT INTO kv (k) VALUES ('evt')"])
    c.run_until_converged()
    assert c.subs.get(sub_id).change_id >= 1
    path = d / "warm.npz"
    B.save_checkpoint(c, path)
    r = B.load_checkpoint(path)
    assert r.sub_catch_up(sub_id, 0) is None
    init, q = r.sub_attach(sub_id, from_change_id=None, skip_rows=False)
    assert init is not None and q is not None
    return [init], [c, r]


def case_restore_after_partial_ddl_migration(B, d):
    c = B.LiveCluster(SCHEMA, num_nodes=2, default_capacity=16)
    c.execute(["INSERT INTO kv (k, v) VALUES ('a', 'keep')"])
    c.migrate("CREATE TABLE added (k INTEGER NOT NULL PRIMARY KEY);")
    c.execute(["INSERT INTO added (k) VALUES (7)"])
    path = str(d / "partial.npz")
    B.save_checkpoint(c, path)
    r = B.load_checkpoint(path)
    _, rows = r.query_rows("SELECT k, v FROM kv")
    assert rows == [["a", "keep"]]
    _, added = r.query_rows("SELECT k FROM added")
    assert added == [[7]]
    return [rows, added], [c, r]


def rewrite(path, new_path, edit) -> None:
    """Rewrite a checkpoint file through ``edit(meta, flat)``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    edit(meta, flat)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8), **flat)
    with open(new_path, "wb") as f:
        f.write(buf.getvalue())


def case_v2_checkpoint_converts(B, d):
    c = B.LiveCluster(SCHEMA, num_nodes=2, default_capacity=16)
    c.execute(["INSERT INTO kv (k, v) VALUES ('old', 'fmt')"])
    path = str(d / "v3.npz")
    B.save_checkpoint(c, path)

    def as_v2(meta, flat):
        cells = flat.pop("log/cells")
        for i, f in enumerate(("row", "col", "vr", "cv", "cl")):
            flat[f"log/{f}"] = cells[..., i]
        meta["format"] = 2

    rewrite(path, str(d / "v2.npz"), as_v2)
    r = B.load_checkpoint(str(d / "v2.npz"))
    _, rows = r.query_rows("SELECT k, v FROM kv")
    assert rows == [["old", "fmt"]]

    def as_v3(meta, flat):  # the per-actor cleared stamp of format 3
        flat["cleared_hlc"] = flat["cleared_hlc"].max(axis=1)
        meta["format"] = 3

    rewrite(path, str(d / "v3old.npz"), as_v3)
    r3 = B.load_checkpoint(str(d / "v3old.npz"))
    future = str(d / "v5.npz")
    rewrite(path, future, lambda meta, flat: meta.update(format=5))
    return [rows, outcome(B.load_checkpoint, future)], [c, r, r3]


def case_pre_conflict_order_checkpoint_migrates(B, d):
    from corro_sim.core.changelog import CELL_VR
    from corro_sim.io.checkpoint import _dec_value
    from corro_sim.io.values import sqlite_sort_key
    from corro_sim.utils.ranks import translate_ranks

    c = make_cluster(B)
    c.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)", ["a", "x", 5]]],
              node=0)
    c.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)", ["b", "y", 9]]],
              node=1)
    c.run_until_converged()
    path = d / "old.npz"
    B.save_checkpoint(c, path)

    def as_sql_order(meta, flat):
        values = [_dec_value(v) for v in meta["universe"]["values"]]
        cur = meta["universe"]["ranks"]
        order = sorted(range(len(values)),
                       key=lambda i: sqlite_sort_key(values[i]))
        old_of = {i: j for j, i in enumerate(order)}
        old = [old_of[i] for i in range(len(values))]
        for key in ("table/vr", "own/vr"):
            flat[key] = translate_ranks(np.asarray(flat[key]), cur, old)
        cells = np.array(flat["log/cells"])
        cells[..., CELL_VR] = translate_ranks(cells[..., CELL_VR], cur, old)
        flat["log/cells"] = cells
        meta["universe"]["ranks"] = old

    rewrite(path, path, as_sql_order)
    r = B.load_checkpoint(path)
    assert rows_all(r) == rows_all(c)
    r.execute([["UPDATE kv SET n = ? WHERE k = ?", [100, "a"]]], node=2)
    r.run_until_converged()
    _, rows = r.query_rows("SELECT k, n FROM kv WHERE n >= 100")
    assert [tuple(x) for x in rows] == [("a", 100)]
    return [rows], [c, r]


CASES = [
    case_warm_checkpoint_roundtrip,
    case_warm_checkpoint_resumes_prng_position,
    case_backup_is_scrubbed_and_restores_elsewhere,
    case_backup_actor_neutral_identity_swap,
    case_restore_into_live_cluster,
    case_restore_into_shape_mismatch_rejected,
    case_checkpoint_after_migration,
    case_restore_into_smaller_backup_rejected_without_corruption,
    case_warm_restore_catch_up_past_buffer_404s,
    case_restore_after_partial_ddl_migration,
    case_v2_checkpoint_converts,
    case_pre_conflict_order_checkpoint_migrates,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_checkpoint_case(case, tmp_path):
    got, clusters = {}, {}
    for B in BOTH:
        d = tmp_path / B.key
        d.mkdir()
        clusters[B.key] = []

        def run(B=B, d=d):
            obs, cs = case(B, d)
            clusters[B.key] = cs
            return obs

        got[B.key] = outcome(run)
    assert got["ref"][0] == "ok", got["ref"]
    assert got["port"] == got["ref"]
    assert len(clusters["port"]) == len(clusters["ref"])
    for rc, pc in zip(clusters["ref"], clusters["port"]):
        assert_same_cluster(rc, pc)


# --------------------------------------------- files across packages
def warm_source(B):
    """A cluster with SWIM on, a scenario's fault knobs in its history,
    and two subscriptions, one of them deduped."""
    c = B.LiveCluster(SCHEMA, num_nodes=5, seed=3, default_capacity=24,
                      cfg_overrides={"swim_enabled": True})
    for i in range(10):
        c.execute([["INSERT INTO kv (k, v, n) VALUES (?, ?, ?)",
                    [f"k{i}", f"v{i}", i]]], node=i % 5, wait=False)
    c.run_until_converged()
    c.subscribe("SELECT k, n FROM kv WHERE n >= 4", node=3)
    c.subscribe("SELECT k, n FROM kv WHERE n >= 4", node=3)
    c.subscribe("SELECT v FROM kv", node=1)
    c.execute(["UPDATE kv SET n = 50 WHERE k = 'k1'"], node=2)
    c.tick(3)
    return c


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["warm", "backup_origin_3"])
def test_files_cross_packages(writer, reader, kind, tmp_path):
    """A file written by one package loads in the other to the cluster
    (and, warm, the subscriptions) that the writer's own load gives;
    both then tick on identically. The backup is scrubbed from node 3
    and restored as node 3."""
    src = {B.key: warm_source(B) for B in BOTH}
    assert_same_cluster(src["ref"], src["port"])
    path = tmp_path / "file.npz"
    if kind == "warm":
        writer.save_checkpoint(src[writer.key], path)
        loaded = {B.key: B.load_checkpoint(path) for B in (writer, reader)}
    else:
        writer.backup(src[writer.key], path, node=3)
        loaded = {B.key: B.restore(path, node=3) for B in (writer, reader)}
    with np.load(path) as z:
        keys = sorted(z.files)
    other = tmp_path / "again.npz"
    if kind == "warm":
        reader.save_checkpoint(src[reader.key], other)
    else:
        reader.backup(src[reader.key], other, node=3)
    with np.load(other) as z:
        assert sorted(z.files) == keys  # the same keys from either package
    for c in loaded.values():
        c.execute(["UPDATE kv SET v = 'after' WHERE n >= 4"], node=0)
        c.run_until_converged()
        c.tick(2)
    assert_same_cluster(loaded["ref"], loaded["port"])
    if kind == "warm":
        assert len(loaded["port"].subs) == 2
