"""Sim checkpoints: chunk-boundary resume tokens of ``run_sim``.

Port of the sim-token half of ``corro_sim/io/checkpoint.py`` (the
LiveCluster half, ``save_checkpoint``/``backup``/``restore``, comes with
the live cluster). A multi-hour soak must survive the loss of its
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
    "SIM_CKPT_FORMAT",
    "SimCheckpoint",
    "load_sim_checkpoint",
    "save_fork_checkpoint",
    "save_sim_checkpoint",
    "state_flat",
]

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
