"""The fault-tolerant peer path (the port's copy of the JAX package's
``resilience``): per-peer :class:`CircuitBreaker`,
:class:`DecorrelatedJitterBackoff` for forward retries,
:class:`FaultInjector` schedules for chaos tests (``GUBER_FAULT_*``),
:class:`ManualClock` virtual time, crash-proof background loops
(``spawn_supervised``) and the ``ResilienceConfig`` a ``Config`` carries.
Each breaker and injector draws from its own seeded ``random.Random``,
as the JAX package's do."""

from __future__ import annotations

from dataclasses import dataclass

from gubernator_tpu_torch.resilience.backoff import DecorrelatedJitterBackoff
from gubernator_tpu_torch.resilience.breaker import (
    BreakerOpenError,
    BreakerState,
    CircuitBreaker,
)
from gubernator_tpu_torch.resilience.clock import ManualClock
from gubernator_tpu_torch.resilience.faults import FaultInjector, FaultSpec
from gubernator_tpu_torch.resilience.supervisor import (
    spawn_supervised, spawn_supervised_thread)


@dataclass
class ResilienceConfig:
    """Knobs for the fault-tolerant peer path (reference
    ``resilience/__init__.py:41``; env ``GUBER_BREAKER_*``,
    ``GUBER_FORWARD_*``, ``GUBER_REDELIVERY_LIMIT``)."""

    breaker_enabled: bool = True
    breaker_failure_threshold: float = 0.5
    breaker_min_requests: int = 5
    breaker_window: float = 10.0
    breaker_open_for: float = 2.0
    breaker_open_cap: float = 30.0
    breaker_half_open_probes: int = 1
    forward_max_attempts: int = 5
    forward_backoff_base: float = 0.005
    forward_backoff_cap: float = 0.1
    redelivery_limit: int = 10_000


__all__ = [
    "BreakerOpenError",
    "BreakerState",
    "CircuitBreaker",
    "DecorrelatedJitterBackoff",
    "FaultInjector",
    "FaultSpec",
    "ManualClock",
    "ResilienceConfig",
    "spawn_supervised",
    "spawn_supervised_thread",
]
