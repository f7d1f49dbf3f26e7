"""The least bytes one full-view SWIM tick moves, whatever implements it.

Frozen with the benchmark, so that SWIM's roofline share is counted the
same however the program computes a tick. Of the ``(rows, N)`` belief
plane (the observers' rows, all of them off a mesh), each entry of the
layout's unsigned width (4 bytes wide, 2 narrow), any correct tick must:

- read the plane once and write it once: ``2 * rows * N`` entries;
- per gossip peer, carry one datagram pulled and one pushed per node,
  each ``min(payload_members, N)`` member entries read from the sender's
  row, and where the payload is bounded each datagram's header (the
  sender's own entry) besides: ``2 * rows * min(payload_members, N)``
  entries, plus ``2 * rows`` headers;
- on announce ticks, read two partners' whole rows per node: ``2 * rows
  * N`` entries.

Everything else a tick does (draws, masks, the merge itself) is counted
as free, so the count never exceeds what a tick needs.
"""

from __future__ import annotations

ENTRY_BYTES = {False: 4, True: 2}  # by narrow_state: uint32, uint16


def tick_bytes(n: int, rows: int, narrow: bool, payload_members: int,
               gossip_peers: int, announce: bool) -> int:
    """Bytes one tick needs at least, for ``rows`` observers of ``n``
    members."""
    b = ENTRY_BYTES[bool(narrow)]
    entries = 2 * rows * n
    carried = min(int(payload_members), n)
    headers = 2 * rows if payload_members < n else 0
    entries += gossip_peers * (2 * rows * carried + headers)
    if announce:
        entries += 2 * rows * n
    return b * entries
