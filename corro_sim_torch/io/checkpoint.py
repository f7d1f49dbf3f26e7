"""Checkpoints: the LiveCluster's warm boot, backup and restore, and the
chunk-boundary resume tokens of ``run_sim``.

Port of ``corro_sim/io/checkpoint.py``. The LiveCluster half mirrors the
reference's durability surface:

- :func:`save_checkpoint` / :func:`load_checkpoint`: warm-boot resume.
  Everything a restarted agent reloads from disk in the reference
  (bookkeeping, ``BookedVersions::from_conn``, ``agent.rs:1334-1403``;
  buffered changes; member state; subscriptions, ``setup.rs:224-277``)
  comes back: state tensors, value universe, slot layout, config, the
  round counter, and the subscriptions under their original ids.
- :func:`backup`: ``corrosion backup`` (``corrosion/src/main.rs:155-220``),
  a portable, actor-neutral snapshot. The origin node's actor ordinal is
  rewritten to 0 and volatile per-run state is scrubbed (subscriptions,
  gossip buffers, SWIM membership, the volatile feature leaves).
- :func:`restore` / :func:`restore_into`: ``corrosion restore``
  (``main.rs:221-324``), which swaps the wanted actor ordinal back in (a
  relabel permutation over every actor-indexed tensor) and wipes
  subscriptions; :func:`restore_into` installs under the running
  cluster's write lock.

A LiveCluster file is one ``.npz``: the state tensors under the JAX
package's ``flax.serialization.to_state_dict`` paths (``table/cv``,
``features/node_snapshot/head``) in its dtypes, plus a JSON ``__meta__``
blob (config, schema history, interned values, slot allocations,
subscriptions, counters). ``FORMAT_VERSION`` is the JAX package's 4, and
``_read`` upgrades files of format 2 and 3 as it does, so a file written
by either package loads in the other.

The sim-token half: a multi-hour soak must survive the loss of its
device: ``run_sim(checkpoint_path=, checkpoint_every=)`` writes a token
every few committed chunks, and ``run_sim(resume=load_sim_checkpoint(
path))`` continues bit for bit where the killed run stopped.

A token is one ``np.savez_compressed`` archive, written to ``<path>.tmp``
and renamed over ``path``:

- ``__meta__``: the JSON header (format, kind, the config as
  ``dataclasses.asdict`` round-tripped through JSON, seed, chunk, rounds
  completed, the next chunk index, the repair-selection cursor and the
  caller's meta);
- ``__flight__``: the flight recorder's ND-JSON export;
- ``state/<path>``: every state leaf, ``<path>`` the JAX package's
  ``flax.serialization.to_state_dict`` path (``table/cv``,
  ``features/node_snapshot/head``), in the JAX package's dtypes: the
  leaves the port widens (``convert.WIDENED``) are narrowed back to
  uint32 or uint16 on write and widened on read;
- ``metrics/<name>``: the per-round metric series so far.

So a token crosses backends both ways: the JAX package resumes the
port's tokens and the port resumes the JAX package's.
"""

from __future__ import annotations

import base64
import dataclasses
import io as _io
import json
import os
import time

import numpy as np
import torch

from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import WIDENED, _leaves
from corro_sim_torch.utils.metrics import histograms

__all__ = [
    "FORMAT_VERSION",
    "SIM_CKPT_FORMAT",
    "SimCheckpoint",
    "backup",
    "load_checkpoint",
    "load_sim_checkpoint",
    "restore",
    "restore_into",
    "save_checkpoint",
    "save_fork_checkpoint",
    "save_sim_checkpoint",
    "state_flat",
]

FORMAT_VERSION = 4  # 4: per-version (A, L) cleared_hlc plane
# 3: packed changelog cell tensor (log/cells)

SIM_CKPT_FORMAT = 1

# the carrier dtype of each widened leaf and the unsigned type it
# narrows to on disk
_NARROW = {torch.int64: np.uint32, torch.int32: np.uint16}
_WIDEN = {np.dtype(np.uint32): np.int64, np.dtype(np.uint16): np.int32}


def _path(keystr: str) -> str:
    """A leaf's ``convert`` path (``table.cv``,
    ``features['node_snapshot']['head']``) in the state-dict spelling
    (``table/cv``, ``features/node_snapshot/head``)."""
    return keystr.replace("']['", "/").replace("['", "/").replace(
        "']", "").replace(".", "/")


def _ref_dtype(key: str, t: torch.Tensor) -> np.dtype:
    """The dtype the JAX package keeps leaf ``key`` in."""
    if key in WIDENED:
        return np.dtype(_NARROW[t.dtype])
    return np.dtype(torch.empty((), dtype=t.dtype).numpy().dtype)


def state_flat(state, host=None) -> dict:
    """``{state-dict path: numpy array}`` of a port state, in the JAX
    package's dtypes. ``host``: the leaves already copied to the host,
    in ``state``'s leaf order; else each leaf is copied here."""
    leaves = list(_leaves(state))
    if host is None:
        host = [t.detach().cpu().numpy() for _, t in leaves]
    out = {}
    for (key, t), arr in zip(leaves, host):
        if key in WIDENED:
            arr = arr.astype(_NARROW[t.dtype])
        out[_path(key)] = arr
    return out


def _drop_volatile(flat: dict, core: tuple) -> dict:
    """``flat`` without the keys under ``core`` prefixes and without the
    registry's volatile feature leaves (matched exactly or up to a
    ``/``)."""
    from corro_sim_torch.engine.features import volatile_scrub_prefixes

    feature_keys = volatile_scrub_prefixes()

    def volatile(k: str) -> bool:
        if k.startswith(core):
            return True
        return any(k == p or k.startswith(p + "/") for p in feature_keys)

    return {k: v for k, v in flat.items() if not volatile(k)}


def _merge_tensors(template, src: dict):
    """The state ``template`` with every leaf of ``src`` (a flat
    state-dict of numpy arrays) written over it, on the template's
    device; refuses an unknown leaf, a shape drift or a dtype drift."""
    have = {_path(key): (key, t) for key, t in _leaves(template)}
    new: dict = {}
    for k, v in src.items():
        if k not in have:
            raise ValueError(f"unknown tensor {k!r} in checkpoint")
        key, t = have[k]
        v = np.asarray(v)
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch for {k}: checkpoint {tuple(v.shape)} vs "
                f"cluster {tuple(t.shape)}"
            )
        want = _ref_dtype(key, t)
        if v.dtype != want:
            # the packed SWIM planes have the same shape wide and narrow
            # (narrow_state) but another field layout: refuse, never coerce
            raise ValueError(
                f"dtype mismatch for {k}: checkpoint {v.dtype} vs cluster "
                f"{want} (narrow_state checkpoints restore only into "
                "narrow_state clusters, and vice versa)"
            )
        if v.dtype in _WIDEN:
            v = v.astype(_WIDEN[v.dtype])
        new[key] = torch.as_tensor(np.array(v), device=t.device)
    return _replace_leaves(template, new)


def _replace_leaves(obj, new: dict, prefix: str = ""):
    """``obj`` with the leaves named in ``new`` (``convert`` paths)
    replaced."""
    if isinstance(obj, dict):
        return {
            k: (_replace_leaves(v, new, f"{prefix}['{k}']")
                if isinstance(v, dict) else new.get(f"{prefix}['{k}']", v))
            for k, v in obj.items()
        }
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            kw[f.name] = _replace_leaves(v, new, key + ".")
        elif isinstance(v, dict):
            kw[f.name] = _replace_leaves(v, new, key)
        else:
            kw[f.name] = new.get(key, v)
    return dataclasses.replace(obj, **kw)


def _cfg_json(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` round-tripped through JSON (tuples
    become lists): the form a header holds, and the comparable one."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@dataclasses.dataclass
class SimCheckpoint:
    """One loaded resume token (:func:`load_sim_checkpoint`)."""

    cfg_dict: dict
    seed: int
    chunk: int
    rounds: int  # rounds completed (the next chunk's first round)
    next_chunk: int  # the chunk index the resumed loop dispatches first
    cursor: dict  # the repair-selection cursor (last_pend_live,
    # prev_writes, repair_seen, repair_chunks, probe_p99_last)
    metrics: dict  # name -> (rounds,) np.ndarray, the tail to stitch
    flight_lines: list  # the flight timeline's ND-JSON export
    meta: dict  # the caller's extras
    state_flat: dict  # state-dict path -> np.ndarray
    path: str | None = None

    @property
    def cfg(self):
        return sim_config_from_dict(self.cfg_dict)

    @property
    def is_fork(self) -> bool:
        """Whether this is a what-if fork token
        (:func:`save_fork_checkpoint`), not a mid-run cursor."""
        return "fork" in (self.meta or {})

    @property
    def fork_round(self) -> int:
        """The forked state's absolute ``state.round``, the frame every
        round-scheduled what-if fault shifts by; 0 for a mid-run
        cursor."""
        return int((self.meta or {}).get("fork", {}).get("round", 0))

    def refit(self, cfg, seed: int, chunk: int) -> "SimCheckpoint":
        """A what-if lane's view of a fork token: the same tensors as a
        round-0 resume point under the lane's config, seed and chunking,
        so ``run_sim(resume=token.refit(...))`` is the serial twin of a
        forked sweep lane."""
        if not self.is_fork:
            raise ValueError(
                "refit() is for fork tokens only — a mid-run soak "
                "cursor's config/seed/chunk are part of its identity "
                "(check_compatible)"
            )
        return dataclasses.replace(self, cfg_dict=_cfg_json(cfg),
                                   seed=int(seed), chunk=int(chunk))

    def check_compatible(self, cfg, seed: int, chunk: int) -> None:
        """Refuse to resume under another config, seed or chunking: each
        changes the key stream or the schedule's alignment."""
        if _cfg_json(cfg) != self.cfg_dict:
            raise ValueError(
                "resume config differs from the checkpointed one — a "
                "resumed soak must run the exact killed config"
            )
        if seed != self.seed or chunk != self.chunk:
            raise ValueError(
                f"resume seed/chunk ({seed}/{chunk}) differ from the "
                f"checkpoint's ({self.seed}/{self.chunk}) — the "
                "per-chunk key stream would diverge"
            )

    def install_state(self, template):
        """The token's tensors over an ``init_state``-shaped template, on
        the template's device (shape and dtype drift refuse)."""
        return _merge_tensors(template, self.state_flat)


def _write_sim_token(path: str, *, cfg, flat: dict, seed: int, chunk: int,
                     rounds: int, next_chunk: int, cursor: dict, meta: dict,
                     flight_text: str) -> None:
    """The one token writer (header, archive layout, write-then-rename):
    a kill during the save leaves the previous token whole."""
    header = {
        "format": SIM_CKPT_FORMAT,
        "kind": "sim",
        "cfg": _cfg_json(cfg),
        "seed": int(seed),
        "chunk": int(chunk),
        "rounds": int(rounds),
        "next_chunk": int(next_chunk),
        "cursor": cursor,
        "meta": meta,
    }
    buf = _io.BytesIO()
    np.savez_compressed(
        buf,
        __meta__=np.frombuffer(json.dumps(header).encode(), np.uint8),
        __flight__=np.frombuffer(flight_text.encode(), np.uint8),
        **flat,
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def save_sim_checkpoint(path: str, *, cfg, state, seed: int, chunk: int,
                        rounds: int, next_chunk: int, cursor: dict,
                        metrics: dict, flight=None,
                        meta: dict | None = None) -> None:
    """Write a resume token atomically. ``state`` is a port state, or a
    flat state-dict already on the host (:func:`state_flat`)."""
    t0 = time.perf_counter()
    flat = state if isinstance(state, dict) else state_flat(state)
    flat = {f"state/{k}": v for k, v in flat.items()}
    for k, v in metrics.items():
        flat[f"metrics/{k}"] = np.asarray(v)
    _write_sim_token(
        path, cfg=cfg, flat=flat, seed=seed, chunk=chunk, rounds=rounds,
        next_chunk=next_chunk, cursor=cursor, meta=meta or {},
        flight_text=flight.to_ndjson() if flight is not None else "",
    )
    histograms.observe(
        "corro_soak_checkpoint_seconds", time.perf_counter() - t0,
        help_="chunk-boundary soak checkpoint wall (state snapshot + "
              "serialize + atomic rename)",
    )


def save_fork_checkpoint(path: str, *, cfg, state, seed: int, chunk: int,
                         fork_round: int, meta: dict | None = None) -> None:
    """Write a what-if fork token: the state as a round-0 resume point
    (no cursor, no metrics), so ``run_sim(resume=token.refit(lane_cfg,
    lane_seed, chunk))`` and a forked sweep lane start from the same
    state with their own key streams. The volatile feature leaves (the
    probe and burst placeholders, ``features/*``) are scrubbed: each
    lane rebuilds them from its own ``init_state``; the gossip rings,
    SWIM beliefs and in-flight lanes ride."""
    flat = _drop_volatile(state_flat(state), ())
    flat = {f"state/{k}": v for k, v in flat.items()}
    _write_sim_token(
        path, cfg=cfg, flat=flat, seed=seed, chunk=chunk, rounds=0,
        next_chunk=0, cursor={},
        meta={"fork": {"round": int(fork_round), **(meta or {})}},
        flight_text="",
    )


def load_sim_checkpoint(path: str) -> SimCheckpoint:
    with np.load(path) as z:
        header = json.loads(bytes(z["__meta__"]).decode())
        flight_lines = bytes(z["__flight__"]).decode().splitlines()
        flat = {k[len("state/"):]: z[k] for k in z.files
                if k.startswith("state/")}
        metrics = {k[len("metrics/"):]: z[k] for k in z.files
                   if k.startswith("metrics/")}
    if header.get("kind") != "sim":
        raise ValueError(
            f"{path!r} is not a sim checkpoint (use load_checkpoint/"
            "restore for LiveCluster files)"
        )
    if header.get("format") != SIM_CKPT_FORMAT:
        raise ValueError(
            f"unsupported sim checkpoint format {header.get('format')!r}"
        )
    return SimCheckpoint(
        cfg_dict=header["cfg"], seed=header["seed"], chunk=header["chunk"],
        rounds=header["rounds"], next_chunk=header["next_chunk"],
        cursor=header.get("cursor", {}), metrics=metrics,
        flight_lines=flight_lines, meta=header.get("meta", {}),
        state_flat=flat, path=path,
    )


# ------------------------------------------------ LiveCluster checkpoints
#
# Core volatile per-run state (non-feature): gossip buffers, SWIM
# membership, RTT observations and the in-flight delay ring never travel
# in a portable backup; the volatile feature leaves come from the
# registry (engine/features.py).
_CORE_SCRUB = ("gossip/", "swim/", "rtt", "inflight")
# restore() also re-derives the topology and sampling constants
_RESTORE_SCRUB = _CORE_SCRUB + ("ring0", "row_cdf")


def _enc_value(v):
    """Tag a SQLite value for JSON transport (bytes are not JSON)."""
    if v is None:
        return ["n"]
    if isinstance(v, bool):
        return ["i", int(v)]
    if isinstance(v, int):
        return ["i", v]
    if isinstance(v, float):
        return ["f", v]
    if isinstance(v, str):
        return ["s", v]
    if isinstance(v, (bytes, bytearray)):
        return ["b", base64.b64encode(bytes(v)).decode()]
    raise TypeError(f"not a SQLite value: {type(v)!r}")


def _dec_value(t):
    tag = t[0]
    if tag == "n":
        return None
    if tag == "i":
        return int(t[1])
    if tag == "f":
        return float(t[1])
    if tag == "s":
        return t[1]
    if tag == "b":
        return base64.b64decode(t[1])
    raise ValueError(f"bad value tag {tag!r}")


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _meta_of(cluster, scrub: bool, origin_node: int) -> dict:
    values, ranks = cluster.universe.snapshot()
    layout = cluster.layout
    slots = {}
    for name in layout.schema.tables:
        start, _cap = layout._ranges[name]
        # pk tuples in slot order: re-allocation replays identically
        per = [None] * layout._used[name]
        for (t, pk), slot in layout._slots.items():
            if t == name:
                per[slot - start] = [_enc_value(p) for p in pk]
        slots[name] = per
    subs = []
    if not scrub:
        for sub_id, m in cluster.subs._by_id.items():
            subs.append({"id": sub_id, "sql": m.select.normalized(),
                         "node": m.node, "change_id": m.change_id})
    return {
        "format": FORMAT_VERSION,
        "scrubbed": scrub,
        "origin_node": origin_node,
        "cfg": dataclasses.asdict(cluster.cfg),
        "seed": cluster._seed,
        "rounds_ticked": cluster._rounds_ticked,
        "totals": cluster._totals,
        "alive": cluster._alive.astype(int).tolist(),
        "partition": np.asarray(cluster._part).tolist(),
        "schema_history": list(cluster._schema_history),
        "universe": {
            "values": [_enc_value(v) for v in values],
            "ranks": [int(r) for r in ranks],
        },
        "layout": {
            "ranges": {t: list(r) for t, r in layout._ranges.items()},
            "cols": [[t, c, plane] for (t, c), plane in layout._cols.items()],
            "slots": slots,
            "default_capacity": layout.default_capacity,
            "generation": layout.generation,
        },
        "subs": subs,
    }


def _relabel_values(arr: np.ndarray, a: int, b: int) -> np.ndarray:
    """Swap actor ids a<->b where stored as values (site/actor fields);
    sentinels (negatives) pass through."""
    out = arr.copy()
    out[arr == a] = b
    out[arr == b] = a
    return out


def _swap_axis(arr: np.ndarray, a: int, b: int, axis: int) -> np.ndarray:
    idx = [slice(None)] * arr.ndim
    out = arr.copy()
    ia, ib = list(idx), list(idx)
    ia[axis], ib[axis] = a, b
    out[tuple(ia)], out[tuple(ib)] = arr[tuple(ib)], arr[tuple(ia)]
    return out


def _permute_actors(sd: dict, a: int, b: int) -> dict:
    """Apply the actor relabel a<->b to a nested state-dict.

    Node ordinal == actor id, so the reference's site_id swap and clock
    table rewrite (``main.rs:221-324``) become one permutation of every
    node-axis and every actor-valued tensor."""
    if a == b:
        return sd
    table = sd["table"]
    for f in ("cv", "vr", "site", "cl"):
        table[f] = _swap_axis(table[f], a, b, 0)
    table["site"] = _relabel_values(table["site"], a, b)
    book = sd["book"]
    for f in book:
        book[f] = _swap_axis(_swap_axis(book[f], a, b, 0), a, b, 1)
    log = sd["log"]
    for f in log:
        log[f] = _swap_axis(log[f], a, b, 0)
    own = sd["own"]
    for f in ("site", "actor", "ractor", "rsite"):
        own[f] = _relabel_values(own[f], a, b)
    for f in ("hlc", "last_cleared", "cleared_hlc"):
        sd[f] = _swap_axis(sd[f], a, b, 0)
    # volatile fields may already be filtered out (scrub/restore paths)
    if "rtt" in sd and sd["rtt"].shape[0] > 1:
        sd["rtt"] = _swap_axis(_swap_axis(sd["rtt"], a, b, 0), a, b, 1)
    if "ring0" in sd:
        sd["ring0"] = _relabel_values(_swap_axis(sd["ring0"], a, b, 0), a, b)
    return sd


def save_checkpoint(cluster, path, *, scrub: bool = False,
                    origin_node: int = 0) -> None:
    """Serialize a LiveCluster to ``path`` (.npz)."""
    t0 = time.perf_counter()
    with cluster._lock:
        meta = _meta_of(cluster, scrub, origin_node)
        flat = state_flat(cluster.state)
        if scrub:
            # gossip and SWIM state and every volatile feature leaf do
            # not travel in a portable backup
            flat = _drop_volatile(flat, _CORE_SCRUB)
            if origin_node != 0:
                flat = _flatten(_permute_actors(_unflatten(flat),
                                                origin_node, 0))
        buf = _io.BytesIO()
        np.savez_compressed(
            buf, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8), **flat,
        )
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    histograms.observe(
        "corro_db_wal_truncate_seconds", time.perf_counter() - t0,
        help_="durable snapshot wall (checkpoint save; "
              "corro.db.wal.truncate.seconds analog)",
    )


def _read(path):
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    if meta.get("format") == 2:
        # v2 -> v3: the five changelog cell planes became one tensor
        planes = [flat.pop(f"log/{f}") for f in
                  ("row", "col", "vr", "cv", "cl")]
        flat["log/cells"] = np.stack(planes, axis=-1)
        meta["format"] = 3
    if meta.get("format") == 3 and "cleared_hlc" in flat:
        # v3 -> v4: the per-actor EmptySet ts became per-version (A, L):
        # the old actor stamp goes into that actor's cleared slots, -1
        # elsewhere
        old = flat["cleared_hlc"]  # (A,)
        cleared = flat.get("log/cleared")  # (A, L) bool
        if old.ndim == 1 and cleared is not None:
            flat["cleared_hlc"] = np.where(
                cleared, old[:, None], np.int32(-1)
            ).astype(np.int32)
        meta["format"] = FORMAT_VERSION
    if meta.get("format") == 3:
        meta["format"] = FORMAT_VERSION  # scrubbed checkpoints (no state)
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint format {meta.get('format')!r}"
        )
    return meta, flat


def _rebuild_layout(meta):
    from corro_sim_torch.schema import TableLayout, schema_from_history

    lm = meta["layout"]
    # replay the whole migration history: entries after the first may be
    # partial DDL (migrate() merges)
    layout = TableLayout.__new__(TableLayout)
    layout.schema = schema_from_history(meta["schema_history"])
    layout._ranges = {t: tuple(r) for t, r in lm["ranges"].items()}
    layout._used = {t: len(s) for t, s in lm["slots"].items()}
    layout._cols = {(t, c): plane for t, c, plane in lm["cols"]}
    layout._slots = {}
    layout._by_slot = {}
    for t, per in lm["slots"].items():
        start, _cap = layout._ranges[t]
        for i, pk_enc in enumerate(per):
            pk = tuple(_dec_value(p) for p in pk_enc)
            layout._slots[(t, pk)] = start + i
            layout._by_slot[start + i] = (t, pk)
    layout._next_row = max(
        (start + cap for start, cap in layout._ranges.values()), default=0
    )
    layout.default_capacity = lm["default_capacity"]
    layout.generation = lm["generation"]
    return layout


def _universe_of(meta):
    from corro_sim_torch.io.values import LiveUniverse

    return LiveUniverse.restore(
        [_dec_value(v) for v in meta["universe"]["values"]],
        meta["universe"]["ranks"],
    )


def _cluster_from_meta(meta, tripwire=None, device=None):
    from corro_sim_torch.config import (
        FaultConfig,
        SweepConfig,
        TwinConfig,
        node_faults_from_dict,
    )
    from corro_sim_torch.harness.cluster import LiveCluster

    cfg = dict(meta["cfg"])
    num_nodes = cfg.pop("num_nodes")
    for k in ("num_rows", "num_cols"):
        cfg.pop(k)  # derived from the layout
    # asdict + JSON flattened the nested config blocks: rebuild them
    faults = cfg.pop("faults", None)
    if faults:
        faults["blackhole"] = tuple(
            tuple(int(x) for x in p) for p in faults.get("blackhole", ())
        )
        cfg["faults"] = FaultConfig(**faults)
    node_faults = cfg.pop("node_faults", None)
    if node_faults:
        cfg["node_faults"] = node_faults_from_dict(node_faults)
    sweep = cfg.pop("sweep", None)
    if sweep:
        cfg["sweep"] = SweepConfig(**sweep)
    twin = cfg.pop("twin", None)
    if twin:
        cfg["twin"] = TwinConfig(**twin)
    cluster = LiveCluster(
        meta["schema_history"][-1],
        num_nodes=num_nodes,
        seed=meta["seed"],
        cfg_overrides=cfg,
        tripwire=tripwire,
        layout=_rebuild_layout(meta),
        universe=_universe_of(meta),
        device=device,
    )
    cluster._schema_history = list(meta["schema_history"])
    return cluster


def load_checkpoint(path, tripwire=None, device=None):
    """Warm-boot a LiveCluster from a checkpoint file, on ``device``
    (``None``: CUDA, as every entry point)."""
    meta, flat = _read(path)
    cluster = _cluster_from_meta(meta, tripwire, device)
    _install(cluster, meta, flat, node=None)
    # warm boot restores subscriptions under their original ids
    for s in meta["subs"]:
        cluster.subs.restore_sub(
            s["id"], s["sql"], s["node"], cluster.state.table,
            change_id=s["change_id"],
        )
        cluster._sub_queues.setdefault(s["id"], [])
    return cluster


def _install(cluster, meta, flat, node):
    """Write tensors and counters into ``cluster`` (shapes must match)."""
    pr = getattr(cluster.universe, "pending_remap", None)
    if pr is not None:
        # written under an older rank space: LiveUniverse.restore
        # re-ranked the values; translate every rank-typed tensor
        from corro_sim_torch.core.changelog import CELL_VR
        from corro_sim_torch.utils.ranks import translate_ranks

        old, new = pr
        flat = dict(flat)
        for key in ("table/vr", "own/vr"):
            if key in flat:
                flat[key] = translate_ranks(np.asarray(flat[key]), old, new)
        if "log/cells" in flat:
            cells = np.array(flat["log/cells"])
            cells[..., CELL_VR] = translate_ranks(cells[..., CELL_VR],
                                                  old, new)
            flat["log/cells"] = cells
        cluster.universe.pending_remap = None
    if node is not None and node != 0:
        flat = _flatten(_permute_actors(_unflatten(dict(flat)), 0, node))
    cluster.state = _merge_tensors(cluster.state, flat)
    cluster._rounds_ticked = meta["rounds_ticked"]
    cluster._totals = dict(meta["totals"])
    cluster._alive = np.asarray(meta["alive"], bool)
    cluster._part = np.asarray(meta["partition"], np.int32)


def backup(cluster, path, node: int = 0) -> None:
    """Portable actor-neutral snapshot (``corrosion backup`` analog)."""
    cluster._check_node(node)
    save_checkpoint(cluster, path, scrub=True, origin_node=node)


def restore(path, node: int = 0, tripwire=None, device=None):
    """Build a fresh LiveCluster from a backup, assuming actor ``node``
    (``corrosion restore`` analog: site_id swap-back and subs wipe).
    Any file restores as a portable backup: volatile per-run state never
    survives, the target re-derives its own."""
    meta, flat = _read(path)
    meta = {**meta, "subs": []}
    flat = _drop_volatile(flat, _RESTORE_SCRUB)
    cluster = _cluster_from_meta(meta, tripwire, device)
    if node >= cluster.cfg.num_nodes:
        raise ValueError(
            f"node {node} out of range for cluster of "
            f"{cluster.cfg.num_nodes}"
        )
    _install(cluster, meta, flat, node=node)
    return cluster


def restore_into(cluster, path, node: int = 0) -> None:
    """Swap a backup's data into a running cluster under its write lock
    (the ``sqlite3-restore`` byte-lock swap analog).

    The cluster keeps its identity, config shapes and gossip/SWIM state;
    table data, bookkeeping, change log, value universe and slot layout
    are replaced; subscriptions are wiped. As with the reference,
    restoring a backup older than what peers applied rewinds this
    actor's version counter, so restore into a cluster whose peers are
    restored too (``main.rs:221-324``)."""
    meta, flat = _read(path)
    flat = _drop_volatile(flat, _RESTORE_SCRUB)
    with cluster.locks.tracked(cluster._lock, "restore", "write"):
        new_layout = _rebuild_layout(meta)
        # validate everything before mutating: a failure below this
        # block would leave the cluster half-swapped
        base = state_flat(cluster.state)
        for k, v in flat.items():
            if k not in base:
                raise ValueError(f"unknown tensor {k!r} in backup")
            if tuple(base[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"backup shape mismatch for {k}: "
                    f"{tuple(v.shape)} vs cluster {tuple(base[k].shape)} "
                    "(restore_into needs an identically-shaped cluster)"
                )
        for sub_id in list(cluster.subs._by_id):
            cluster.subs.remove(sub_id)
        cluster._sub_queues.clear()
        cluster._query_cache.clear()
        cluster.layout = new_layout
        cluster.universe = _universe_of(meta)
        cluster.universe.on_remap(cluster._on_remap)
        cluster.subs.universe = cluster.universe
        cluster.subs.layout._layout = new_layout
        cluster._schema_history = list(meta["schema_history"])
        _install(cluster, meta, flat, node=node)
