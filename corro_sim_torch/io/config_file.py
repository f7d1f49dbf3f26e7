"""TOML config loading with env-var overrides.

The reference loads a TOML ``Config`` and applies ``__``-separated env-var
overrides via the ``config`` crate (``corro-types/src/config.rs:284-291``),
e.g. ``CORROSION__GOSSIP__BIND_ADDR``. Here the file is a flat ``[sim]``
table whose keys are :class:`corro_sim_torch.config.SimConfig` fields, and the
override prefix is ``CORRO_SIM__``::

    [sim]
    num_nodes = 1000
    write_rate = 0.3
    swim_enabled = true
    pipeline = false      # opt out of pipelined chunk dispatch
                          # (doc/performance.md; default on)
    shard_log = true      # mesh change-log regime: true = actor-sharded,
                          # false = replicated, "auto" = size heuristic
                          # (doc/multichip.md; CORRO_SIM__SHARD_LOG)

    [sim.faults]          # chaos injection (corro_sim_torch/faults/)
    loss = 0.05
    dup = 0.01
    blackhole = [[3, -1]] # directed (src, dst) pairs; -1 = wildcard

    CORRO_SIM__NUM_NODES=5000 corro-sim-torch run --config cluster.toml
    CORRO_SIM__FAULTS__LOSS=0.1 corro-sim-torch run ...
    CORRO_SIM__FAULTS__BLACKHOLE="3:-1,0:7" corro-sim-torch run ...

Port of ``corro_sim/io/config_file.py`` (host Python only): the same
file builds the same :class:`~corro_sim_torch.config.SimConfig`, field for
field, with ``shard_log`` parsed as the JAX package parses it.
"""

from __future__ import annotations

import dataclasses
import os

try:  # 3.11+
    import tomllib
except ModuleNotFoundError:  # pragma: no cover - version-dependent
    try:  # the 3.10 backport, same API
        import tomli as tomllib
    except ModuleNotFoundError:
        tomllib = None

from corro_sim_torch.config import FaultConfig, NodeFaultConfig, SimConfig

ENV_PREFIX = "CORRO_SIM__"
FAULTS_ENV_PREFIX = ENV_PREFIX + "FAULTS__"
NODE_FAULTS_ENV_PREFIX = ENV_PREFIX + "NODE_FAULTS__"


def _parse_bool(name: str, raw: str) -> bool:
    if raw.lower() in ("1", "true", "yes", "on"):
        return True
    if raw.lower() in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"invalid bool for {name}: {raw!r}")


def _coerce(field: dataclasses.Field, raw: str):
    if field.type in ("int", int):
        return int(raw)
    if field.type in ("float", float):
        return float(raw)
    if field.type in ("bool | None",):
        # tri-state knobs (shard_log): auto/none = defer to the
        # heuristic, else the usual bool spellings
        if raw.lower() in ("auto", "none", ""):
            return None
        return _parse_bool(field.name, raw)
    if field.type in ("bool", bool):
        return _parse_bool(field.name, raw)
    return raw


def _parse_blackhole(raw) -> tuple:
    """Blackhole pairs from TOML (``[[3, -1], [0, 7]]``) or an env string
    (``"3:-1,0:7"``) into the tuple-of-pairs FaultConfig carries."""
    if isinstance(raw, str):
        pairs = []
        for item in raw.split(","):
            if not item.strip():
                continue
            s, colon, d = item.partition(":")
            if not colon:
                raise ValueError(
                    f"blackhole entry {item!r} must be src:dst"
                )
            pairs.append((int(s), int(d)))
        return tuple(pairs)
    return tuple((int(s), int(d)) for s, d in raw)


def _build_faults(table: dict, env) -> FaultConfig | None:
    """The ``[sim.faults]`` block + ``CORRO_SIM__FAULTS__*`` overrides."""
    ffields = {f.name: f for f in dataclasses.fields(FaultConfig)}
    values: dict = {}
    for k, v in table.items():
        if k not in ffields:
            raise KeyError(f"unknown faults config key: {k!r}")
        values[k] = _parse_blackhole(v) if k == "blackhole" else v
    for k, field in ffields.items():
        env_key = FAULTS_ENV_PREFIX + k.upper()
        if env_key in env:
            raw = env[env_key]
            if k == "blackhole":
                values[k] = _parse_blackhole(raw)
            elif k == "sync_loss":  # `float | None` — not _coerce-able
                values[k] = None if raw.lower() == "none" else float(raw)
            else:
                values[k] = _coerce(field, raw)
    return FaultConfig(**values) if values else None


def _parse_tuples(raw, width: int, what: str) -> tuple:
    """Node-fault schedule rows from TOML (``[[1, 12], [4, 12]]``) or an
    env string (``"1:12,4:12"`` — colon-separated fields, comma-separated
    rows) into the tuple-of-tuples NodeFaultConfig carries."""
    if isinstance(raw, str):
        rows = []
        for item in raw.split(","):
            if not item.strip():
                continue
            parts = item.split(":")
            if len(parts) != width:
                raise ValueError(
                    f"node_faults.{what} entry {item!r} needs "
                    f"{width} colon-separated fields"
                )
            rows.append(tuple(int(p) for p in parts))
        return tuple(rows)
    out = tuple(tuple(int(x) for x in row) for row in raw)
    for row in out:
        if len(row) != width:
            raise ValueError(
                f"node_faults.{what} entry {row!r} needs {width} fields"
            )
    return out


_NODE_FAULT_TUPLES = {"crash": 2, "stale": 3, "skew": 2, "straggle": 3}


def _build_node_faults(table: dict, env) -> NodeFaultConfig | None:
    """The ``[sim.node_faults]`` block + ``CORRO_SIM__NODE_FAULTS__*``
    overrides (schedule tuples via the colon/comma grammar above; the
    vendored flat-TOML fallback parser carries only scalar values, so
    schedule lists need real tomllib or the env spelling)."""
    nfields = {f.name: f for f in dataclasses.fields(NodeFaultConfig)}
    values: dict = {}
    for k, v in table.items():
        if k not in nfields:
            raise KeyError(f"unknown node_faults config key: {k!r}")
        values[k] = (
            _parse_tuples(v, _NODE_FAULT_TUPLES[k], k)
            if k in _NODE_FAULT_TUPLES else v
        )
    for k, field in nfields.items():
        env_key = NODE_FAULTS_ENV_PREFIX + k.upper()
        if env_key in env:
            raw = env[env_key]
            if k in _NODE_FAULT_TUPLES:
                values[k] = _parse_tuples(raw, _NODE_FAULT_TUPLES[k], k)
            else:
                values[k] = _coerce(field, raw)
    return NodeFaultConfig(**values) if values else None


def load_config(path: str | None = None, env=None) -> SimConfig:
    """Build a SimConfig from an optional TOML file + env overrides."""
    env = os.environ if env is None else env
    fields = {f.name: f for f in dataclasses.fields(SimConfig)}
    values: dict = {}
    faults_table: dict = {}
    node_faults_table: dict = {}

    if path is not None:
        if tomllib is not None:
            with open(path, "rb") as fh:
                doc = tomllib.load(fh)
        else:
            with open(path, encoding="utf-8") as fh:
                doc = _parse_flat_toml(fh.read())
        table = doc.get("sim", doc)
        # the vendored flat parser spells nesting as a [sim.faults] table
        faults_table = dict(
            table.pop("faults", None) or doc.get("sim.faults") or {}
        )
        node_faults_table = dict(
            table.pop("node_faults", None)
            or doc.get("sim.node_faults") or {}
        )
        for k, v in table.items():
            if k in ("sim.faults", "sim.node_faults") or isinstance(v, dict):
                continue
            if k not in fields:
                raise KeyError(f"unknown config key in {path}: {k!r}")
            if fields[k].type in ("bool | None",) and isinstance(v, str):
                # tri-state knobs (shard_log): TOML spells them as a
                # bool or the "auto"/"none" string — same type-driven
                # rule as _coerce's env path, so the next bool|None
                # field gets it for free
                v = None if v.lower() in ("auto", "none") else (
                    _parse_bool(k, v)
                )
            values[k] = v

    for k, field in fields.items():
        if k in ("faults", "node_faults", "sweep", "twin"):
            # nested config blocks: faults/node_faults have their own
            # env grammar above; sweep/twin are driver-internal (built
            # by the sweep planner / twin CLI, never from flat env
            # strings — a raw CORRO_SIM__TWIN value cannot coerce)
            continue
        env_key = ENV_PREFIX + k.upper()
        if env_key in env:
            values[k] = _coerce(field, env[env_key])

    faults = _build_faults(faults_table, env)
    if faults is not None:
        values["faults"] = faults
    node_faults = _build_node_faults(node_faults_table, env)
    if node_faults is not None:
        values["node_faults"] = node_faults
    return SimConfig(**values).validate()


def _parse_flat_toml(text: str) -> dict:
    """Minimal vendored parser for the flat ``[section]`` / ``key = value``
    subset this config uses — the last-resort path when neither
    ``tomllib`` (3.11+) nor ``tomli`` is importable. Values: booleans,
    ints, floats, and single/double-quoted strings."""
    doc: dict = {}
    table = doc
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            head = line.split("#", 1)[0].strip()  # `[sim]  # comment`
            if not head.endswith("]"):
                raise ValueError(
                    f"config line {ln}: malformed table header {line!r}"
                )
            table = doc.setdefault(head[1:-1].strip(), {})
            continue
        key, eq, val = line.partition("=")
        if not eq:
            raise ValueError(f"config line {ln}: expected key = value")
        key, val = key.strip(), val.strip()
        if val and val[0] in "\"'":
            # quoted string: ends at the matching quote; anything after
            # it may only be a comment ('#' inside the quotes is data)
            end = val.find(val[0], 1)
            rest = val[end + 1:].strip() if end > 0 else "?"
            if end <= 0 or (rest and not rest.startswith("#")):
                raise ValueError(
                    f"config line {ln} ({key}): malformed string {val!r}"
                )
            table[key] = val[1:end]
            continue
        val = val.split("#", 1)[0].strip()  # trailing comment
        if val.lower() in ("true", "false"):
            table[key] = val.lower() == "true"
            continue
        try:
            table[key] = int(val)
        except ValueError:
            try:
                table[key] = float(val)
            except ValueError:
                raise ValueError(
                    f"config line {ln} ({key}): unsupported value "
                    f"{val!r}"
                ) from None
    return doc
