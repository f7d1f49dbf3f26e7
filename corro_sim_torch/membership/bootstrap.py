"""Bootstrap address resolution — ``agent/bootstrap.rs:14-150`` analog.

The reference's ``generate_bootstrap``:

1. parses each configured bootstrap string — ``host:port`` or
   ``host:port@dns_server`` (resolve through that specific DNS server);
2. literal IPs pass straight through; names resolve via trust-dns;
3. if NOTHING resolved, falls back to 5 random rows of the persisted
   ``__corro_members`` table (peers seen in a previous life);
4. returns at most 10 distinct addresses.

The simulator keeps the same contract for its deployment tooling: the
devcluster harness writes per-node bootstrap lists, and a warm-booted
agent falls back to the member addresses recorded in its checkpoint.
Plain names resolve via the host resolver (``socket.getaddrinfo``); a
``@dns_server`` suffix queries THAT server directly with a minimal
RFC-1035 A/AAAA lookup over UDP (the hickory-resolver custom-server
path, ``bootstrap.rs:33-94``), falling back to the host resolver if the
named server does not answer.

Port of ``corro_sim/membership/bootstrap.py`` (host Python only; the same behaviour).
"""

from __future__ import annotations

import dataclasses
import ipaddress
import random
import socket
import struct

BOOTSTRAP_LIMIT = 10  # reference: choose at most 10 (bootstrap.rs:139-148)
MEMBER_FALLBACK = 5  # random member rows when nothing resolves (:96-118)


class BootstrapError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class BootstrapEntry:
    host: str
    port: int
    dns_server: str | None = None  # "host:port@dns" form


def parse_entry(s: str) -> BootstrapEntry:
    """``host:port`` / ``host:port@dns_server`` / ``[v6]:port`` forms."""
    s = s.strip()
    if not s:
        raise BootstrapError("empty bootstrap entry")
    addr, _, dns = s.partition("@")
    dns_server = dns.strip() or None
    addr = addr.strip()
    if addr.startswith("["):  # [v6]:port
        host, bracket, rest = addr[1:].partition("]")
        if not bracket or not rest.startswith(":"):
            raise BootstrapError(f"malformed bootstrap address {addr!r}")
        port_s = rest[1:]
    else:
        host, colon, port_s = addr.rpartition(":")
        if not colon:
            raise BootstrapError(
                f"bootstrap entry {addr!r} needs a port (host:port)"
            )
    try:
        port = int(port_s)
    except ValueError:
        raise BootstrapError(f"bad port in bootstrap entry {addr!r}") from None
    if not (0 < port < 65536):
        raise BootstrapError(f"port {port} out of range in {addr!r}")
    if not host:
        raise BootstrapError(f"empty host in bootstrap entry {addr!r}")
    return BootstrapEntry(host=host, port=port, dns_server=dns_server)


def _encode_qname(name: str) -> bytes:
    out = b""
    for label in name.rstrip(".").split("."):
        raw = label.encode("idna") if not label.isascii() else label.encode()
        if not 0 < len(raw) < 64:
            raise BootstrapError(f"bad DNS label {label!r} in {name!r}")
        out += bytes([len(raw)]) + raw
    return out + b"\x00"


def _skip_name(buf: bytes, off: int) -> int:
    """Return the offset just past a (possibly compressed) domain name."""
    while True:
        if off >= len(buf):
            raise BootstrapError("truncated DNS name")
        n = buf[off]
        if n == 0:
            return off + 1
        if n & 0xC0 == 0xC0:  # compression pointer ends the name
            return off + 2
        off += 1 + n


def _parse_server(server: str) -> tuple[str, int, int]:
    """``host[:port]`` / ``[v6][:port]`` / bare v6 → (host, port, family)."""
    server = server.strip()
    if server.startswith("["):
        host, bracket, rest = server[1:].partition("]")
        if not bracket:
            raise BootstrapError(f"malformed DNS server {server!r}")
        port = int(rest[1:]) if rest.startswith(":") else 53
    else:
        host, colon, port_s = server.rpartition(":")
        if colon and ":" not in host:  # host:port (v4 or name)
            port = int(port_s)
        else:  # no port, or a bare IPv6 literal full of colons
            host, port = server, 53
    try:
        fam = (
            socket.AF_INET6
            if isinstance(ipaddress.ip_address(host), ipaddress.IPv6Address)
            else socket.AF_INET
        )
    except ValueError:
        fam = socket.AF_INET  # a nameserver given by name; resolve as v4
    if not (0 < port < 65536):
        raise BootstrapError(f"bad DNS server port in {server!r}")
    return host, port, fam


def dns_query(
    name: str, server: str, qtype: int = 1, timeout: float = 1.5,
    txid: int | None = None,
) -> list[str]:
    """Minimal RFC-1035 A (qtype=1) / AAAA (28) lookup against ``server``
    over UDP — the custom-``@dns_server`` path of the reference's
    bootstrap resolution (``bootstrap.rs:33-94``, hickory resolver with a
    caller-chosen nameserver). Returns address strings; [] on timeout,
    SERVFAIL/NXDOMAIN, or a malformed/mismatched reply. Stray datagrams
    (wrong txid or wrong source) are ignored and the socket keeps
    listening until the deadline."""
    import time

    try:
        host, port, fam = _parse_server(server)
        txid = random.getrandbits(16) if txid is None else txid
        # header: id, flags=RD, 1 question; then QNAME QTYPE QCLASS(IN)
        q = struct.pack("!HHHHHH", txid, 0x0100, 1, 0, 0, 0)
        q += _encode_qname(name) + struct.pack("!HH", qtype, 1)
        deadline = time.monotonic() + timeout
        with socket.socket(fam, socket.SOCK_DGRAM) as s:
            s.sendto(q, (host, port))
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    return []
                s.settimeout(left)
                buf, src = s.recvfrom(4096)
                if len(buf) < 12 or src[1] != port:
                    continue  # noise; keep waiting for the real reply
                rid, flags, qd, an, _ns, _ar = struct.unpack_from(
                    "!HHHHHH", buf, 0
                )
                if rid != txid:
                    continue  # stray/spoofed datagram
                if not flags & 0x8000 or flags & 0x000F:
                    return []  # not a response, or RCODE != NOERROR
                break
        off = 12
        for _ in range(qd):  # skip echoed questions
            off = _skip_name(buf, off) + 4
        out = []
        for _ in range(an):
            off = _skip_name(buf, off)
            if off + 10 > len(buf):
                break
            rtype, _rc, _ttl, rdlen = struct.unpack_from("!HHIH", buf, off)
            off += 10
            rdata = buf[off:off + rdlen]
            off += rdlen
            if rtype == 1 and rdlen == 4:
                out.append(socket.inet_ntop(socket.AF_INET, rdata))
            elif rtype == 28 and rdlen == 16:
                out.append(socket.inet_ntop(socket.AF_INET6, rdata))
        return out
    except (OSError, ValueError, BootstrapError):
        # unreachable server, bad server string, malformed reply — all
        # degrade to the caller's fallback instead of aborting bootstrap
        return []


def _default_resolve(host: str, port: int, dns_server: str | None,
                     dead_servers: set | None = None):
    """Name → addresses; ``dns_server`` queries that server directly
    (A then AAAA), skipping servers that already failed this pass."""
    if dns_server is not None:
        dead = dead_servers if dead_servers is not None else set()
        if dns_server not in dead:
            addrs = dns_query(host, dns_server)  # A
            if not addrs:
                addrs = dns_query(host, dns_server, qtype=28)  # AAAA
            if addrs:
                return [(a, port) for a in addrs]
            # one timeout costs ≤2 queries; don't re-pay it per entry
            dead.add(dns_server)
        # named server unreachable/empty: degrade to the host resolver
    try:
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_DGRAM)
    except socket.gaierror:
        return []
    return [(info[4][0], port) for info in infos]


def generate_bootstrap(
    entries,
    member_addrs=(),
    limit: int = BOOTSTRAP_LIMIT,
    fallback_n: int = MEMBER_FALLBACK,
    resolve=_default_resolve,
    rng: random.Random | None = None,
):
    """Resolve bootstrap strings to at most ``limit`` distinct addresses.

    ``entries``: strings or :class:`BootstrapEntry`; ``member_addrs``:
    (host, port) pairs from persisted membership (``__corro_members``),
    used as the fallback pool when nothing resolves. Returns a list of
    (host, port) tuples, first-seen order, deduplicated.
    """
    rng = rng or random.Random()
    out: list = []
    seen = set()

    def add(pair):
        if pair not in seen:
            seen.add(pair)
            out.append(pair)

    # one shared dead-server set per pass: an unreachable @dns_server
    # costs its timeout once, not once per entry pointing at it
    dead_servers: set = set()
    if resolve is _default_resolve:
        def resolve(h, p, d, _r=_default_resolve):  # noqa: F811
            return _r(h, p, d, dead_servers=dead_servers)

    for e in entries:
        entry = parse_entry(e) if isinstance(e, str) else e
        try:
            ipaddress.ip_address(entry.host)
            add((entry.host, entry.port))
            continue
        except ValueError:
            pass
        for pair in resolve(entry.host, entry.port, entry.dns_server):
            add(pair)

    if not out:
        # nothing configured or resolvable: fall back to a random sample
        # of previously-seen members (bootstrap.rs:96-118)
        pool = list(member_addrs)
        rng.shuffle(pool)
        for pair in pool[:fallback_n]:
            add(tuple(pair))

    return out[:limit]
