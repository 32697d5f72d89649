"""Lease protocol types: the nouns shared by the server mint, the client
cache, and the wire frames.

A *quota lease* delegates a slice of one rate limit's budget to a client
for a bounded TTL: the server charges the whole slice against the bucket
up front (one ordinary batched decision), signs ``(name, key, budget,
expiry, generation)``, and the client self-enforces locally — admitting
from the lease without any server round trip — until the lease expires,
exhausts, or is revoked, at which point it syncs the consumed count back
(docs/leases.md).

``generation`` is the revocation handle: the server bumps it whenever the
limit's configuration changes, and a sync carrying a stale generation is
reconciled conservatively (no credit-back) instead of trusted.

``holder`` is the leaseholder identity: several clients may hold leases
on the same key at once, so every spec and sync names the client it
belongs to and the server accounts each holder's delegated slice
separately — one holder's release or renewal can never credit back (or
re-mint) budget delegated to another.  :class:`~gubernator_tpu_torch.leases
.cache.LeaseCache` stamps its own id automatically; callers driving the
manager directly pick any stable string (empty is a valid — shared —
identity).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace as _replace


@dataclass(frozen=True)
class LeaseSpec:
    """A client's request for (or renewal of) one lease."""

    name: str
    key: str
    limit: int
    duration: int              # limit window, ms
    algorithm: int = 0         # types.Algorithm (0 = TOKEN_BUCKET)
    burst: int = 0
    want: int = 0              # requested budget; 0 = server default
    holder: str = ""           # leaseholder identity (per-client slice)

    @property
    def full_key(self) -> str:
        return f"{self.name}_{self.key}"


@dataclass(frozen=True)
class LeaseToken:
    """A signed, TTL-bounded delegation of ``budget`` admissions."""

    name: str
    key: str
    budget: int                # admissions delegated by this grant
    expires_ms: int            # epoch ms; self-enforcement ends here
    generation: int            # monotonic revocation counter
    signature: bytes = b""

    @property
    def full_key(self) -> str:
        return f"{self.name}_{self.key}"

    def with_expiry(self, expires_ms: int, signature: bytes) -> "LeaseToken":
        """A re-signed copy with a pushed-out expiry (the cheap-extension
        and offline-grace paths; budget and generation are unchanged)."""
        return _replace(self, expires_ms=expires_ms, signature=signature)


@dataclass(frozen=True)
class LeaseSync:
    """A client's report of lease consumption since its last sync."""

    name: str
    key: str
    consumed: int              # admissions consumed since the last sync
    generation: int            # generation of the lease consumed under
    release: bool = False      # True = lease is done; credit unused back
    holder: str = ""           # leaseholder identity (per-client slice)

    @property
    def full_key(self) -> str:
        return f"{self.name}_{self.key}"


@dataclass(frozen=True)
class LeaseSyncAck:
    """Server's answer to one LeaseSync item."""

    accepted: bool             # False = generation was stale (revoked)
    generation: int            # the server's current generation
    credited: int = 0          # unused budget credited back to the bucket
    charged: int = 0           # excess beyond grant force-charged


# Introspection/test helper: every record a cache holds, flattened.
@dataclass
class LeaseCacheStats:
    leases: int = 0
    local_admits: int = 0
    local_denies: int = 0
    grants: int = 0
    syncs: int = 0
    offline_extensions: int = 0
    sync_lost: int = 0
    unsynced_consumed: int = 0
    details: dict = field(default_factory=dict)
