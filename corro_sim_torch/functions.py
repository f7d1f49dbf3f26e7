"""Custom SQL scalar functions (sqlite-functions crate analog).

The reference registers ``corro_json_contains(a, b)`` on every SQLite
connection (``crates/sqlite-functions/src/lib.rs:14-51``): true iff the
first JSON value is fully contained in the second — recursive key-wise
containment for objects, strict equality for everything else. Consul
integration and templating queries filter on it.

Here the function is a host-evaluated predicate term of the query
language (see ``corro_sim/subs/query.py``): JSON containment has no
rank-interval form, so the matcher evaluates it over decoded column
values, like its pk terms.

Port of ``corro_sim/functions.py`` (standard library only).
"""

from __future__ import annotations

import json


def json_contains(selector, obj) -> bool:
    """True iff ``selector`` is fully contained in ``obj``
    (sqlite-functions/src/lib.rs:34-51)."""
    if isinstance(selector, dict) and isinstance(obj, dict):
        for k, sv in selector.items():
            if k not in obj or not json_contains(sv, obj[k]):
                return False
        return True
    return selector == obj


def json_contains_text(selector_text: str, obj_text) -> bool:
    """Containment over JSON *texts*; non-string or malformed ``obj_text``
    is False (the reference errors the query on malformed JSON — here a
    malformed stored value simply doesn't match)."""
    if not isinstance(obj_text, str):
        return False
    try:
        obj = json.loads(obj_text)
    except ValueError:
        return False
    return json_contains(json.loads(selector_text), obj)
