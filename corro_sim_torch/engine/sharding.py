"""Resident bytes of a cluster state, by component.

Port of the one-device half of ``corro_sim/engine/sharding.py``:
:func:`resolve_shard_log`, :func:`state_bytes` and
:func:`state_bytes_breakdown`. The state is built on the ``meta`` device,
so only shapes and dtypes exist and nothing is allocated. The mesh half
(``make_mesh``, ``state_shardings``, ``sharding_report``) comes with the
port's multi-device work.

The port keeps some leaves in wider carriers than the JAX package
(``convert.WIDENED``: torch has no uint32 or uint16 arithmetic, so the
book window and the SWIM planes ride int64 or int32), so its resident
bytes are larger than the JAX package's for the same config, by those
leaves' extra bytes.
"""

from __future__ import annotations

from corro_sim_torch.convert import _leaves

# Past this many actors the JAX package's change log takes the
# actor-sharded layout (``corro_sim/engine/sharding.py``).
SHARD_LOG_ACTORS = 2048


def resolve_shard_log(cfg=None, num_actors: int | None = None,
                      shard_log: bool | None = None) -> bool:
    """The change-log regime: an explicit ``shard_log`` (the argument,
    else ``SimConfig.shard_log``) beats the ``SHARD_LOG_ACTORS`` shape
    rule."""
    if shard_log is None and cfg is not None:
        shard_log = getattr(cfg, "shard_log", None)
    if shard_log is not None:
        return bool(shard_log)
    if num_actors is None:
        num_actors = cfg.num_actors
    return num_actors >= SHARD_LOG_ACTORS


def _component(key: str) -> str:
    """``"book.win"`` -> ``"book"``; ``"features['x']"`` -> ``"features"``."""
    for i, ch in enumerate(key):
        if ch in ".[":
            return key[:i]
    return key


def state_bytes_breakdown(cfg) -> dict:
    """``{component: {total, per_device, placement}}`` bytes of ``cfg``'s
    state on one device, with the placement the node-axis layout would
    give each component. Shape-only: the state is built on ``meta``."""
    from corro_sim_torch.engine.state import init_state

    state = init_state(cfg, seed=0, device="meta")
    shard_log = resolve_shard_log(cfg)
    out: dict = {}
    for key, t in _leaves(state):
        nbytes = t.numel() * t.element_size()
        name = _component(key)
        is_log = name == "log"
        node_axis = t.dim() >= 1 and t.shape[0] == cfg.num_nodes
        sharded = (node_axis and not is_log) or (
            is_log and shard_log and node_axis
        )
        comp = out.setdefault(
            name, {"total": 0, "per_device": 0, "placement": "replicated"},
        )
        comp["total"] += nbytes
        comp["per_device"] += nbytes
        if sharded:
            comp["placement"] = "actor_sharded" if is_log else "node_sharded"
    return out


def state_bytes(cfg) -> tuple[int, int]:
    """``(total, per_device)`` resident bytes of ``cfg``'s state on one
    device (the two are equal)."""
    breakdown = state_bytes_breakdown(cfg)
    return (
        sum(c["total"] for c in breakdown.values()),
        sum(c["per_device"] for c in breakdown.values()),
    )
