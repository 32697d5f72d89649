"""Multi-region GLOBAL federation (docs/federation.md).

The port's copy of the JAX package's ``federation`` (pure host code).
Partition-tolerant bounded-staleness reconcile between datacenters:
:class:`FederationManager` runs the async inter-region envelope
exchange over the resilience breaker/backoff/redelivery path;
:mod:`~gubernator_tpu_torch.federation.envelope` defines the commutative,
idempotent merge unit it ships (``GFE1`` frames on the wire,
transport/fastwire.py).
"""

from __future__ import annotations

from gubernator_tpu_torch.federation.envelope import (
    FederationAck,
    FederationEnvelope,
    FederationRecord,
    ReceiveLedger,
    merge_records,
)
from gubernator_tpu_torch.federation.manager import (
    FED_ORIGIN_KEY,
    FederationManager,
)

__all__ = [
    "FED_ORIGIN_KEY",
    "FederationAck",
    "FederationEnvelope",
    "FederationManager",
    "FederationRecord",
    "ReceiveLedger",
    "merge_records",
]
