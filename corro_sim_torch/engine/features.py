"""Feature-leaf registry: the extension contract for optional SimState.

Port of ``corro_sim/engine/features.py``. A feature registers a name, an
enabled predicate over :class:`~corro_sim_torch.config.SimConfig`, a
build function for its leaf (a tensor, or a dict of tensors) and a
checkpoint-volatility flag. Enabled features live in
``SimState.features[name]``; a disabled feature contributes nothing. The
names and the layout are the JAX package's, so checkpoints and the fleet
sweep key on the same leaves on both sides.

The Gilbert burst plane predates the registry in the JAX package and
keeps its placeholder-field layout (``SimState.fault_burst``, a ``(1,)``
stub when disabled); it registers as a ``field=`` entry, so the one
registry still owns its build function.

Build functions take ``(cfg, seed, device)`` and make their tensors on that
device. A feature must be a pure function of the config, and the step
threads a feature it does not consume through unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class FeatureLeaf:
    """One registered optional state plane."""

    name: str
    enabled: Callable[[Any], bool]  # SimConfig -> bool (pure in cfg)
    build: Callable[[Any, int, Any], Any]  # (cfg, seed, device) -> leaf
    # the placeholder-field layout (fault_burst only): the leaf is a hard
    # SimState field that exists even when disabled, as a minimal stub
    placeholder: Callable[[Any, Any], Any] | None = None
    field: str | None = None  # the SimState attribute of a field leaf
    volatile: bool = True  # scrubbed from portable backups and restores
    # a node-major plane whose build takes ``rows=`` (one rank's rows)
    row_plane: bool = False

    def materialize(self, cfg, seed: int, device):
        """The enabled form, or the placeholder of a field leaf."""
        if self.enabled(cfg):
            return self.build(cfg, seed, device)
        if self.placeholder is None:
            raise ValueError(
                f"feature {self.name!r} is disabled and has no "
                "placeholder — it contributes no leaf"
            )
        return self.placeholder(cfg, device)


_REGISTRY: dict[str, FeatureLeaf] = {}


def register_feature(leaf: FeatureLeaf, *,
                     replace: bool = False) -> FeatureLeaf:
    """Register a feature leaf. Name collisions raise unless
    ``replace``."""
    if not replace and leaf.name in _REGISTRY:
        raise ValueError(f"feature leaf {leaf.name!r} already registered")
    if leaf.field is not None and leaf.placeholder is None:
        raise ValueError(
            f"field-style feature {leaf.name!r} needs a placeholder"
        )
    _REGISTRY[leaf.name] = leaf
    return leaf


def build_features(cfg, seed: int, device, rows: int | None = None) -> dict:
    """The ``SimState.features`` dict for ``cfg``: one entry per enabled
    dict-style feature, sorted by name. ``rows``: the row planes get
    only that many nodes' rows (one rank's shard)."""
    out = {}
    for name in sorted(_REGISTRY):
        leaf = _REGISTRY[name]
        if leaf.field is None and leaf.enabled(cfg):
            kw = {"rows": rows} if leaf.row_plane and rows is not None else {}
            out[name] = leaf.build(cfg, seed, device, **kw)
    return out


def build_field(name: str, cfg, seed: int, device):
    """Build a field-style leaf (enabled form or placeholder)."""
    return _REGISTRY[name].materialize(cfg, seed, device)


def enabled_feature_names(cfg) -> tuple[str, ...]:
    """Names of every enabled feature under ``cfg`` (field- and
    dict-style)."""
    return tuple(
        name for name in sorted(_REGISTRY) if _REGISTRY[name].enabled(cfg)
    )


def volatile_scrub_prefixes() -> tuple[str, ...]:
    """Flattened state-dict key prefixes of every volatile feature leaf,
    which the checkpoint scrub drops (``io/checkpoint.py``): a field leaf
    under its field name, a dict leaf under ``features/<name>``. The
    caller matches a prefix exactly or up to a ``/``."""
    return tuple(
        leaf.field if leaf.field is not None else f"features/{name}"
        for name, leaf in sorted(_REGISTRY.items()) if leaf.volatile
    )


def feature_registry() -> dict[str, FeatureLeaf]:
    """Snapshot of the registry, insertion-ordered."""
    return dict(_REGISTRY)


def leaf_provenance(path: str) -> str | None:
    """The registry feature that owns a state leaf, or None for core
    state. ``path`` is the leaf's name relative to the state root in the
    JAX package's key-path spelling (``".probe.first_seen"``,
    ``".features['sweep_knobs']['loss']"``). A field-style feature owns
    its field's subtree, a dict-style one its ``features['<name>']``
    subtree: registering a feature IS declaring its taint scope for the
    contract auditor (``analysis/contracts.py``)."""
    for name in sorted(_REGISTRY):
        leaf = _REGISTRY[name]
        if leaf.field is not None:
            if path == f".{leaf.field}" or path.startswith(
                f".{leaf.field}."
            ):
                return name
        elif path.startswith(f".features['{name}']"):
            return name
    return None
