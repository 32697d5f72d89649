"""TLS setup: file-based certs, AutoTLS self-signing, client-auth modes.

The port's copy of the JAX package's ``transport/tlsutil.py``.

Re-creates the reference's TLS surface (``tls.go``): load CA/cert/key from
files, or — with ``auto_tls`` — generate a throwaway CA and a per-host
server certificate with SANs for localhost + discovered interface addresses
(``tls.go:293,390``).  Client-auth modes mirror ``config.go:368-373``.

Produces both ``grpc`` credentials (server + channel) and an ``ssl`` context
for the HTTPS gateway.
"""

from __future__ import annotations

import datetime
import ipaddress
import socket
import ssl
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import grpc

# ``cryptography`` is only needed for AutoTLS self-signing; file-based
# certs and plaintext daemons must work without it (slim containers omit
# it), so the import is gated, not required at module load.
try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    HAVE_CRYPTO = True
except ImportError:  # pragma: no cover - depends on container build
    x509 = hashes = serialization = rsa = NameOID = None
    HAVE_CRYPTO = False

from gubernator_tpu_torch.config import TLSSettings

CLIENT_AUTH_MODES = {
    "": False,
    "request": False,
    "verify-if-given": False,
    "require": True,
    "require-and-verify": True,
}


@dataclass
class TLSBundle:
    """Everything the daemon needs: PEM blobs + derived credential objects."""

    ca_pem: bytes = b""
    cert_pem: bytes = b""
    key_pem: bytes = b""
    client_cert_pem: bytes = b""
    client_key_pem: bytes = b""
    client_auth_ca_pem: bytes = b""
    settings: TLSSettings = field(default_factory=TLSSettings)

    # ------------------------------------------------------------------
    def server_credentials(self) -> grpc.ServerCredentials:
        require = CLIENT_AUTH_MODES.get(self.settings.client_auth, False)
        root = self.client_auth_ca_pem or self.ca_pem
        return grpc.ssl_server_credentials(
            [(self.key_pem, self.cert_pem)],
            root_certificates=root if self.settings.client_auth else None,
            require_client_auth=require,
        )

    def channel_credentials(self) -> grpc.ChannelCredentials:
        cert = self.client_cert_pem or self.cert_pem
        key = self.client_key_pem or self.key_pem
        return grpc.ssl_channel_credentials(
            root_certificates=self.ca_pem or None,
            private_key=key or None,
            certificate_chain=cert or None,
        )

    def server_ssl_context(self) -> ssl.SSLContext:
        """SSL context for the HTTPS gateway listener."""
        import tempfile

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        if self.settings.min_version == "1.3":
            ctx.minimum_version = ssl.TLSVersion.TLSv1_3
        else:
            ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        with tempfile.NamedTemporaryFile(suffix=".pem") as cf, \
                tempfile.NamedTemporaryFile(suffix=".pem") as kf:
            cf.write(self.cert_pem)
            cf.flush()
            kf.write(self.key_pem)
            kf.flush()
            ctx.load_cert_chain(cf.name, kf.name)
        if self.settings.client_auth:
            ctx.verify_mode = (
                ssl.CERT_REQUIRED
                if CLIENT_AUTH_MODES.get(self.settings.client_auth, False)
                else ssl.CERT_OPTIONAL
            )
            import tempfile as _tf

            with _tf.NamedTemporaryFile(suffix=".pem") as caf:
                caf.write(self.client_auth_ca_pem or self.ca_pem)
                caf.flush()
                ctx.load_verify_locations(caf.name)
        return ctx

    def client_ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.settings.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        elif self.ca_pem:
            import tempfile

            with tempfile.NamedTemporaryFile(suffix=".pem") as caf:
                caf.write(self.ca_pem)
                caf.flush()
                ctx.load_verify_locations(caf.name)
        if self.client_cert_pem and self.client_key_pem:
            import tempfile

            with tempfile.NamedTemporaryFile(suffix=".pem") as cf, \
                    tempfile.NamedTemporaryFile(suffix=".pem") as kf:
                cf.write(self.client_cert_pem)
                cf.flush()
                kf.write(self.client_key_pem)
                kf.flush()
                ctx.load_cert_chain(cf.name, kf.name)
        return ctx


def _discover_san_addresses() -> Tuple[List[str], List[str]]:
    """DNS names + IPs for the AutoTLS server cert (tls.go SAN discovery via
    net.go:86 interface scan)."""
    names = ["localhost", socket.gethostname()]
    ips = ["127.0.0.1", "::1"]
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None):
            addr = info[4][0]
            if addr not in ips:
                ips.append(addr)
    except OSError:
        pass
    return names, ips


def _gen_key() -> rsa.RSAPrivateKey:
    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


def _key_pem(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )


def generate_self_ca() -> Tuple[bytes, bytes, x509.Certificate, rsa.RSAPrivateKey]:
    """Throwaway CA for AutoTLS (tls.go:390 selfCA)."""
    key = _gen_key()
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "gubernator-tpu auto CA")]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False,
            ),
            critical=True,
        )
        .sign(key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM), _key_pem(key), cert, key


def generate_cert(
    ca_cert: x509.Certificate,
    ca_key: rsa.RSAPrivateKey,
    *,
    client: bool = False,
    common_name: str = "",
    extra_dns: Tuple[str, ...] = (),
) -> Tuple[bytes, bytes]:
    """Server (or client) certificate signed by the auto CA, SANs covering
    localhost + discovered interface addresses (tls.go:293) plus any
    ``extra_dns`` names (compose/k8s service names)."""
    key = _gen_key()
    names, ips = _discover_san_addresses()
    names = list(names) + [n for n in extra_dns if n not in names]
    cn = common_name or (names[1] if len(names) > 1 else "localhost")
    san: List[x509.GeneralName] = [x509.DNSName(n) for n in names]
    for ip in ips:
        try:
            san.append(x509.IPAddress(ipaddress.ip_address(ip)))
        except ValueError:
            pass
    usage = (
        [x509.ExtendedKeyUsageOID.CLIENT_AUTH]
        if client
        else [x509.ExtendedKeyUsageOID.SERVER_AUTH, x509.ExtendedKeyUsageOID.CLIENT_AUTH]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.SubjectAlternativeName(san), critical=False)
        .add_extension(x509.ExtendedKeyUsage(usage), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM), _key_pem(key)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def setup_tls(settings: Optional[TLSSettings]) -> Optional[TLSBundle]:
    """Build the TLS bundle from settings (reference SetupTLS, tls.go:140):
    files when given, AutoTLS generation otherwise; returns None when TLS is
    disabled."""
    if settings is None or not settings.enabled:
        return None
    b = TLSBundle(settings=settings)
    if settings.ca_file:
        b.ca_pem = _read(settings.ca_file)
    if settings.cert_file:
        b.cert_pem = _read(settings.cert_file)
    if settings.key_file:
        b.key_pem = _read(settings.key_file)
    if settings.client_auth_ca_file:
        b.client_auth_ca_pem = _read(settings.client_auth_ca_file)
    if settings.client_auth_cert_file:
        b.client_cert_pem = _read(settings.client_auth_cert_file)
    if settings.client_auth_key_file:
        b.client_key_pem = _read(settings.client_auth_key_file)

    if settings.auto_tls and not (b.cert_pem and b.key_pem):
        if not HAVE_CRYPTO:
            raise RuntimeError(
                "AutoTLS needs the 'cryptography' package; install it or "
                "point GUBER_TLS_CERT/GUBER_TLS_KEY at existing files"
            )
        if settings.ca_file and settings.ca_key_file:
            ca_pem, ca_key_pem = b.ca_pem, _read(settings.ca_key_file)
            ca_cert = x509.load_pem_x509_certificate(ca_pem)
            ca_key = serialization.load_pem_private_key(ca_key_pem, None)
        else:
            ca_pem, _ca_key_pem, ca_cert, ca_key = generate_self_ca()
            b.ca_pem = ca_pem
        b.cert_pem, b.key_pem = generate_cert(ca_cert, ca_key)
        if settings.client_auth:
            b.client_cert_pem, b.client_key_pem = generate_cert(
                ca_cert, ca_key, client=True
            )
            if not b.client_auth_ca_pem:
                b.client_auth_ca_pem = b.ca_pem
    return b


def main(argv=None) -> int:
    """Cert-dir generator for the compose/k8s TLS deployments:

        python -m gubernator_tpu_torch.transport.tlsutil gen <dir> [dns-name ...]

    Writes ``ca.pem``, ``ca.key``, ``gubernator.pem``, ``gubernator.key``
    — the file names docker-compose-tls.yaml mounts (the reference ships
    pre-generated equivalents in contrib/certs)."""
    import argparse
    import os
    import sys

    p = argparse.ArgumentParser(description="gubernator-tpu cert generator")
    p.add_argument("command", choices=["gen"])
    p.add_argument("dir")
    p.add_argument("dns", nargs="*",
                   help="extra SAN dns names (e.g. compose service names)")
    args = p.parse_args(argv)

    if not HAVE_CRYPTO:
        print("the cert generator needs the 'cryptography' package",
              file=sys.stderr)
        return 2
    ca_pem, ca_key_pem, ca_cert, ca_key = generate_self_ca()
    cert_pem, key_pem = generate_cert(
        ca_cert, ca_key, extra_dns=tuple(args.dns)
    )
    os.makedirs(args.dir, exist_ok=True)
    for fname, data in (
        ("ca.pem", ca_pem),
        ("ca.key", ca_key_pem),
        ("gubernator.pem", cert_pem),
        ("gubernator.key", key_pem),
    ):
        path = os.path.join(args.dir, fname)
        mode = 0o600 if fname.endswith(".key") else 0o644
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.chmod(path, mode)  # O_CREAT mode is ignored for existing files
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
