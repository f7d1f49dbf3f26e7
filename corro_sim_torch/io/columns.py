"""Primary-key column codec — `pack_columns`/`unpack_columns` parity.

Port of ``corro_sim/io/columns.py``, the pure-Python codec (the JAX
package's C batch decoder is a host-side speed path the port does not
carry). The reference encodes subscription/pk column tuples into a
compact byte string (``corro-types/src/pubsub.rs:2388-2536``):

    [num_columns: u8]
    per column: [type_byte: u8][int payload…]

where ``type_byte = (int_len << 3) | column_type`` — the low 3 bits carry
the column type tag and the high 5 bits carry how many bytes the
following big-endian signed integer occupies (0–8, minimal: the value ``0``
takes zero payload bytes; negative integers always take 8 because their
two's-complement top byte is non-zero). ``Float`` is always a full 8-byte
IEEE-754 big-endian double; ``Text``/``Blob`` store their *length* as the
minimal integer, then the raw bytes. Type tags follow the reference's
``ColumnType`` (``corro-api-types/src/lib.rs:336-342``).

This codec is the contract for pk bytes inside `Change` records
(``corro-api-types/src/lib.rs:235-245``): trace ingestion decodes them back
into value tuples to key row slots.

Fidelity quirk, preserved deliberately: the reference writes the *low*
minimal bytes of an integer but reads them back **sign-extended** (bytes
crate ``put_int``/``get_int``), so a positive integer whose top bit of its
minimal width is set — 128..255 in one byte, 32768..65535 in two, … —
round-trips to its negative alias (255 → -1). Matching this exactly means
traces packed by the reference decode here to the same tuples the
reference's own matcher would see.

Text/blob *lengths* go through the same ``get_int`` in the reference and a
sign-extended length makes it abort on its own output (a 128-byte string
packs its length as ``0x80`` → -128 → ``Abort``). There fidelity would mean
un-ingestable traces, so lengths are decoded **unsigned** here: strictly
more permissive than the reference, byte-format identical on write.
"""

from __future__ import annotations

import struct

TYPE_INTEGER = 1
TYPE_FLOAT = 2
TYPE_TEXT = 3
TYPE_BLOB = 4
TYPE_NULL = 5


class PackError(ValueError):
    pass


class UnpackError(ValueError):
    pass


def _int_len(value: int, width_bits: int) -> int:
    """Minimal payload bytes for a signed integer of the given bit width."""
    bits = value & ((1 << width_bits) - 1)  # two's-complement pattern
    for n in range(width_bits // 8, 1, -1):
        if bits & (0xFF << ((n - 1) * 8)):
            return n
    return 1 if bits else 0


def _put_int(buf: bytearray, value: int, nbytes: int) -> None:
    if nbytes:
        buf += (value & ((1 << (8 * nbytes)) - 1)).to_bytes(nbytes, "big")


def _get_int(data: bytes, pos: int, nbytes: int) -> tuple[int, int]:
    if nbytes > 8:
        # no valid encoder emits >8 payload bytes (ints cap at 8, lengths
        # at 4)
        raise UnpackError(f"integer width {nbytes} out of range")
    if pos + nbytes > len(data):
        raise UnpackError("truncated integer")
    if nbytes == 0:
        return 0, pos
    return int.from_bytes(data[pos : pos + nbytes], "big", signed=True), (
        pos + nbytes
    )


def pack_columns(values) -> bytes:
    """Encode a tuple of SQLite values (None/int/float/str/bytes)."""
    if len(values) > 0xFF:
        raise PackError("more than 255 columns")
    buf = bytearray([len(values)])
    for v in values:
        if v is None:
            buf.append(TYPE_NULL)
        elif isinstance(v, bool):
            raise PackError("bool is not a SQLite value")
        elif isinstance(v, int):
            n = _int_len(v, 64)
            buf.append((n << 3) | TYPE_INTEGER)
            _put_int(buf, v, n)
        elif isinstance(v, float):
            buf.append(TYPE_FLOAT)
            buf += struct.pack(">d", v)
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            n = _int_len(len(raw), 32)
            buf.append((n << 3) | TYPE_TEXT)
            _put_int(buf, len(raw), n)
            buf += raw
        elif isinstance(v, (bytes, bytearray)):
            raw = bytes(v)
            n = _int_len(len(raw), 32)
            buf.append((n << 3) | TYPE_BLOB)
            _put_int(buf, len(raw), n)
            buf += raw
        else:
            raise PackError(f"not a SQLite value: {type(v)!r}")
    return bytes(buf)


def unpack_columns(data: bytes) -> tuple:
    """Decode ``pack_columns`` bytes back into a tuple of Python values."""
    if not data:
        raise UnpackError("empty buffer")
    num, pos = data[0], 1
    out = []
    for _ in range(num):
        if pos >= len(data):
            raise UnpackError("truncated column header")
        tb = data[pos]
        pos += 1
        ctype, ilen = tb & 0x07, tb >> 3
        if ctype == TYPE_NULL:
            out.append(None)
        elif ctype == TYPE_INTEGER:
            v, pos = _get_int(data, pos, ilen)
            out.append(v)
        elif ctype == TYPE_FLOAT:
            if pos + 8 > len(data):
                raise UnpackError("truncated float")
            out.append(struct.unpack(">d", data[pos : pos + 8])[0])
            pos += 8
        elif ctype in (TYPE_TEXT, TYPE_BLOB):
            ln, pos = _get_int(data, pos, ilen)
            if ln < 0:  # undo the sign extension: lengths are unsigned
                ln += 1 << (8 * ilen)
            if pos + ln > len(data):
                raise UnpackError("truncated payload")
            raw = data[pos : pos + ln]
            pos += ln
            out.append(raw.decode("utf-8") if ctype == TYPE_TEXT else raw)
        else:
            raise UnpackError(f"bad column type {ctype}")
    return tuple(out)
