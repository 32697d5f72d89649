"""Cooperative quota leases: signed TTL-bounded self-enforcement tier
(the port's copy of the JAX package's ``leases``; it imports nothing of
that package).

Server side: :class:`LeaseManager` mints signed leases and reconciles
consumption as batched engine work.  Client side: :class:`LeaseCache`
answers admissions locally while a lease holds budget.  See
docs/leases.md for the protocol and failure semantics.
"""

from gubernator_tpu_torch.leases.cache import ADMIT, DENY, NEED_LEASE, LeaseCache
from gubernator_tpu_torch.leases.manager import LeaseConfig, LeaseManager
from gubernator_tpu_torch.leases.protocol import (
    LeaseCacheStats,
    LeaseSpec,
    LeaseSync,
    LeaseSyncAck,
    LeaseToken,
)
from gubernator_tpu_torch.leases.signing import (
    HAVE_CRYPTO,
    LeaseSigner,
    LeaseVerifier,
    lease_payload,
)

__all__ = [
    "ADMIT",
    "DENY",
    "NEED_LEASE",
    "HAVE_CRYPTO",
    "LeaseCache",
    "LeaseCacheStats",
    "LeaseConfig",
    "LeaseManager",
    "LeaseSigner",
    "LeaseSpec",
    "LeaseSync",
    "LeaseSyncAck",
    "LeaseToken",
    "LeaseVerifier",
    "lease_payload",
]
