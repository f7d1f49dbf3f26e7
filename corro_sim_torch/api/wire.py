"""JSON wire codec for non-native SQLite values — one definition shared
by the HTTP server and the Python client.

Blobs travel as the reference's ``SqliteValue`` JSON shape
``{"blob": [u8…]}`` (``corro-api-types``); everything else is JSON-native.

Port of ``corro_sim/api/wire.py`` (standard library only).
"""

from __future__ import annotations


def encode_value(v):
    """``json.dumps`` default hook: bytes → the blob wire shape."""
    if isinstance(v, (bytes, bytearray)):
        return {"blob": list(v)}
    raise TypeError(f"not JSON-serializable: {type(v)!r}")


def decode_values(v):
    """Recursively undo :func:`encode_value` in a decoded JSON tree.

    Raises ValueError on a malformed blob shape (non-int or out-of-range
    elements) — callers translate to their protocol's bad-request error.
    """
    if isinstance(v, dict):
        if set(v) == {"blob"} and isinstance(v["blob"], list):
            try:
                return bytes(v["blob"])
            except (ValueError, TypeError) as e:
                raise ValueError(f"malformed blob value: {e}") from None
        return {k: decode_values(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_values(x) for x in v]
    return v
