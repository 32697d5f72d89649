"""Lease token signing: Ed25519 when ``cryptography`` is present, stdlib
HMAC-SHA256 otherwise.

Mirrors tlsutil's soft-dependency posture (transport/tlsutil.py): slim
containers without the ``cryptography`` wheel must still mint and verify
leases, so the import is gated and the HMAC fallback is always available.
The two schemes differ in trust shape, not in protocol:

* ``ed25519`` — the minting node holds the private key; anyone holding
  the public key (clients, peers) can verify but not mint.
* ``hmac-sha256`` — one shared secret both mints and verifies
  (``GUBER_LEASE_SECRET``; unset = a random per-process secret, which
  confines verification to clients who received their tokens from this
  process — fine for single-node and loopback deployments).

The signed payload is a canonical length-prefixed encoding of
``(name, key, budget, expires_ms, generation)`` — every field that grants
authority is covered, so no field can be stretched after minting.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import struct

from gubernator_tpu_torch.leases.protocol import LeaseToken

# Gated exactly like tlsutil.HAVE_CRYPTO: the fallback must exercise the
# same code paths the slim container will run.
try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives import serialization
    from cryptography.exceptions import InvalidSignature

    HAVE_CRYPTO = True
except ImportError:  # pragma: no cover - depends on container build
    Ed25519PrivateKey = Ed25519PublicKey = InvalidSignature = None
    serialization = None
    HAVE_CRYPTO = False

_PAYLOAD_MAGIC = b"guber-lease-v1"


def lease_payload(
    name: str, key: str, budget: int, expires_ms: int, generation: int
) -> bytes:
    """Canonical signed bytes for one lease (length-prefixed, so
    ``("ab","c")`` and ``("a","bc")`` never collide)."""
    nb = name.encode()
    kb = key.encode()
    return b"".join((
        _PAYLOAD_MAGIC,
        struct.pack("<I", len(nb)), nb,
        struct.pack("<I", len(kb)), kb,
        struct.pack("<qqq", budget, expires_ms, generation),
    ))


class LeaseVerifier:
    """Verify-only half of a signer: what a client needs (and all a
    client gets — a verifier can never mint)."""

    def __init__(self, scheme: str, material: bytes):
        self.scheme = scheme
        self._material = material
        self._pub = (
            Ed25519PublicKey.from_public_bytes(material)
            if scheme == "ed25519" else None
        )

    def verify(self, token: LeaseToken) -> bool:
        payload = lease_payload(
            token.name, token.key, token.budget,
            token.expires_ms, token.generation,
        )
        if self.scheme == "ed25519":
            try:
                self._pub.verify(token.signature, payload)
                return True
            except InvalidSignature:
                return False
        mac = _hmac.new(self._material, payload, hashlib.sha256).digest()
        return _hmac.compare_digest(mac, token.signature)


class LeaseSigner:
    """Mints (and verifies) lease signatures.

    ``secret`` pins HMAC with that shared secret (multi-node verify);
    ``force_hmac`` pins the stdlib path without a shared secret (tests,
    slim containers).  Otherwise Ed25519 when available.
    """

    def __init__(self, secret: bytes = b"", force_hmac: bool = False):
        if secret or force_hmac or not HAVE_CRYPTO:
            self.scheme = "hmac-sha256"
            self._secret = secret or os.urandom(32)
            self._priv = None
            self._pub_raw = b""
        else:
            self.scheme = "ed25519"
            self._secret = b""
            self._priv = Ed25519PrivateKey.generate()
            pub = self._priv.public_key()
            self._pub_raw = pub.public_bytes(
                serialization.Encoding.Raw,
                serialization.PublicFormat.Raw,
            )

    def sign(
        self, name: str, key: str, budget: int, expires_ms: int,
        generation: int,
    ) -> bytes:
        payload = lease_payload(name, key, budget, expires_ms, generation)
        if self.scheme == "ed25519":
            return self._priv.sign(payload)
        return _hmac.new(self._secret, payload, hashlib.sha256).digest()

    def mint(
        self, name: str, key: str, budget: int, expires_ms: int,
        generation: int,
    ) -> LeaseToken:
        return LeaseToken(
            name=name, key=key, budget=budget, expires_ms=expires_ms,
            generation=generation,
            signature=self.sign(name, key, budget, expires_ms, generation),
        )

    def verifier(self) -> LeaseVerifier:
        if self.scheme == "ed25519":
            return LeaseVerifier("ed25519", self._pub_raw)
        return LeaseVerifier("hmac-sha256", self._secret)

    def verify(self, token: LeaseToken) -> bool:
        return self.verifier().verify(token)
