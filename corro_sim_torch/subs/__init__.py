"""Subscription engine — the reference's pubsub/Matcher subsystem
(``corro-types/src/pubsub.rs``) as compiled predicates over device state.

Port of ``corro_sim/subs/__init__.py``: the same names.
"""

from corro_sim_torch.subs.manager import (
    IdentityUniverse,
    LayoutAdapter,
    Matcher,
    SubEvent,
    SubsManager,
    TraceUniverse,
)
from corro_sim_torch.subs.query import QueryError, Select, parse_query

__all__ = [
    "IdentityUniverse",
    "LayoutAdapter",
    "Matcher",
    "SubEvent",
    "SubsManager",
    "TraceUniverse",
    "QueryError",
    "Select",
    "parse_query",
]
