"""TLS helpers: CA / server / client certificate generation + contexts.

Mirrors the reference's cert tooling (``corro-types/src/tls.rs`` — rcgen
ECDSA P-384/SHA-384 certs; CA valid 5 years with keyCertSign/cRLSign,
server cert with an IP SAN valid 1 year, client cert with an empty DN for
mutual TLS) and the ``corrosion tls ca|server|client generate`` CLI
(``corrosion/src/command/tls.rs``, file names ``ca_cert.pem``,
``ca_key.pem``, ``server_cert.pem``…).

Where the reference feeds these into quinn's rustls config for the QUIC
gossip transport (``api/peer.rs:129-343``), the simulator has
no gossip wire — its network surfaces are the HTTP API and the pg wire
listener — so the context builders here produce ``ssl.SSLContext``s for
those servers (server-side, with optional required client auth = mTLS)
and for clients (custom CA, optional client cert, ``insecure`` analog of
the reference's ``InsecureVerifier``).

Port of ``corro_sim/tls.py`` (host Python only). ``cryptography`` is
imported only where a certificate is made or read, so the rest of the
port, the command line included, runs without it.
"""

from __future__ import annotations

import datetime
import ipaddress
import ssl

# bound by _require_cryptography on first use: importing this module (and
# the command line, which imports it only for --tls-cert) never needs the
# optional package
x509 = hashes = serialization = ec = NameOID = None

_DAY = datetime.timedelta(days=1)


def _require_cryptography() -> None:
    global x509, hashes, serialization, ec, NameOID
    if x509 is not None:
        return
    try:
        from cryptography import x509 as _x509
        from cryptography.hazmat.primitives import hashes as _hashes
        from cryptography.hazmat.primitives import (
            serialization as _serialization,
        )
        from cryptography.hazmat.primitives.asymmetric import ec as _ec
        from cryptography.x509.oid import NameOID as _NameOID
    except ModuleNotFoundError as e:
        raise RuntimeError(
            "corro_sim_torch.tls certificate generation requires the "
            "'cryptography' package (pip install cryptography)"
        ) from e
    x509, hashes, serialization, ec, NameOID = (
        _x509, _hashes, _serialization, _ec, _NameOID
    )


def _keypair():
    _require_cryptography()
    return ec.generate_private_key(ec.SECP384R1())


def _pem_key(key) -> str:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    ).decode()


def _pem_cert(cert) -> str:
    return cert.public_bytes(serialization.Encoding.PEM).decode()


def generate_ca() -> tuple[str, str]:
    """Self-signed root CA → (cert_pem, key_pem). 5-year validity,
    keyCertSign + cRLSign key usage (tls.rs:17-39)."""
    key = _keypair()
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "Corro-Sim Root CA")]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + 365 * 5 * _DAY)
        .add_extension(
            x509.BasicConstraints(ca=True, path_length=None), critical=True
        )
        .add_extension(
            x509.KeyUsage(
                digital_signature=False, content_commitment=False,
                key_encipherment=False, data_encipherment=False,
                key_agreement=False, key_cert_sign=True, crl_sign=True,
                encipher_only=False, decipher_only=False,
            ),
            critical=True,
        )
        .add_extension(
            x509.SubjectKeyIdentifier.from_public_key(key.public_key()),
            critical=False,
        )
        .sign(key, hashes.SHA384())
    )
    return _pem_cert(cert), _pem_key(key)


def _load_ca(ca_cert_pem: str, ca_key_pem: str):
    _require_cryptography()
    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem.encode())
    ca_key = serialization.load_pem_private_key(ca_key_pem.encode(), None)
    return ca_cert, ca_key


def _signed(builder, ca_cert, ca_key, key) -> str:
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        builder.issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + 365 * _DAY)
        .add_extension(
            x509.SubjectKeyIdentifier.from_public_key(key.public_key()),
            critical=False,
        )
        .sign(ca_key, hashes.SHA384())
    )
    return _pem_cert(cert)


def generate_server_cert(
    ca_cert_pem: str, ca_key_pem: str, ip: str
) -> tuple[str, str]:
    """CA-signed server cert with an IP SAN → (cert_pem, key_pem).
    1-year validity (tls.rs:42-72)."""
    ca_cert, ca_key = _load_ca(ca_cert_pem, ca_key_pem)
    key = _keypair()
    builder = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name(
                [x509.NameAttribute(NameOID.COMMON_NAME, "corro-sim.local")]
            )
        )
        .add_extension(
            x509.SubjectAlternativeName(
                [x509.IPAddress(ipaddress.ip_address(ip))]
            ),
            critical=False,
        )
    )
    return _signed(builder, ca_cert, ca_key, key), _pem_key(key)


def generate_client_cert(
    ca_cert_pem: str, ca_key_pem: str
) -> tuple[str, str]:
    """CA-signed client cert (empty DN, for mutual TLS) →
    (cert_pem, key_pem). 1-year validity (tls.rs:80-105)."""
    ca_cert, ca_key = _load_ca(ca_cert_pem, ca_key_pem)
    key = _keypair()
    builder = x509.CertificateBuilder().subject_name(x509.Name([]))
    return _signed(builder, ca_cert, ca_key, key), _pem_key(key)


# ----------------------------------------------------------- ssl contexts


def server_ssl_context(
    cert_file: str,
    key_file: str,
    ca_file: str | None = None,
    require_client_auth: bool = False,
) -> ssl.SSLContext:
    """Server-side context; with ``require_client_auth`` this is the mTLS
    posture of the reference's gossip server (peer.rs:168-204)."""
    if require_client_auth and not ca_file:
        raise ValueError(
            "require_client_auth needs a CA bundle (ca_file) — an empty "
            "trust store would reject every client"
        )
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    if ca_file:
        ctx.load_verify_locations(ca_file)
    if require_client_auth:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(
    ca_file: str | None = None,
    cert_file: str | None = None,
    key_file: str | None = None,
    insecure: bool = False,
) -> ssl.SSLContext:
    """Client-side context. ``insecure`` skips verification — the
    reference's ``InsecureVerifier`` (peer.rs:236-273)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    elif ca_file:
        ctx.load_verify_locations(ca_file)
    else:
        ctx.load_default_certs()
    if cert_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx
