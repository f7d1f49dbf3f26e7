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


def build_features(cfg, seed: int, device) -> dict:
    """The ``SimState.features`` dict for ``cfg``: one entry per enabled
    dict-style feature, sorted by name."""
    return {
        name: _REGISTRY[name].build(cfg, seed, device)
        for name in sorted(_REGISTRY)
        if _REGISTRY[name].field is None and _REGISTRY[name].enabled(cfg)
    }


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
