"""Adaptive overload control plane (docs/overload.md), the port's copy of
the JAX package's ``admission``.

Three cooperating pieces thread through the serving path:

* :mod:`~gubernator_tpu_torch.admission.deadline` — per-request deadline
  propagation: fastwire/gRPC edges stamp an absolute local deadline on
  arrival (wire carries the *relative* budget in ``guber-deadline-ms``
  metadata), and the tick loop sheds already-expired work before
  packing.
* :mod:`~gubernator_tpu_torch.admission.queue` — the bounded two-class
  pending queue (peer/GLOBAL reconcile traffic outranks client
  traffic) with deadline-ordered drop-oldest-expiring overflow.
* :mod:`~gubernator_tpu_torch.admission.limiter` — the AIMD concurrency
  limiter that adjusts admitted window width against the measured
  window p99 vs. ``GUBER_TARGET_P99_MS``.

Shed answers are never silent: expired/shutdown sheds answer with a
retriable error status, overflow/limiter sheds answer with the
configured degradation policy (``GUBER_SHED_POLICY``) — fail-open
(UNDER_LIMIT, full remaining) or fail-closed (OVER_LIMIT, zero
remaining), mirroring DRAIN_OVER_LIMIT semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

from gubernator_tpu_torch.admission.deadline import (  # noqa: F401
    DEADLINE_METADATA_KEY,
    BudgetExhaustedError,
    batch_deadline,
    budget_header_value,
    deadline_from_header,
    remaining_budget,
)
from gubernator_tpu_torch.admission.limiter import AimdLimiter  # noqa: F401
from gubernator_tpu_torch.admission.queue import (  # noqa: F401
    CLASS_CLIENT,
    CLASS_PEER,
    AdmissionQueue,
    QueueItem,
)
from gubernator_tpu_torch.config import env_knob, parse_duration

# Shed policies (GUBER_SHED_POLICY).  Fail-open answers UNDER_LIMIT with
# the full limit remaining (availability over enforcement: a shed caller
# proceeds as if admitted); fail-closed answers OVER_LIMIT with zero
# remaining (enforcement over availability: a shed caller is throttled).
POLICY_FAIL_OPEN = "fail-open"
POLICY_FAIL_CLOSED = "fail-closed"
SHED_POLICIES = (POLICY_FAIL_OPEN, POLICY_FAIL_CLOSED)

# Retriable shed messages: transported as per-item errors so callers can
# distinguish "shed, retry elsewhere / with a fresh budget" from a real
# rate-limit verdict.  Kept as prefix constants so tests and the bench
# rung can classify responses without string-matching free text.
SHED_EXPIRED_MSG = (
    "request shed: deadline expired before processing; retry with a "
    "fresh deadline"
)
SHED_SHUTDOWN_MSG = (
    "request shed: tick loop shutting down; retry against another peer"
)
SHED_BACKPRESSURE_MSG = (
    "request shed: ingest arena exhausted; retry after backoff"
)
SHED_RESHARD_MSG = (
    "request shed: shard transition in progress; retry after the "
    "cutover window"
)


@dataclass
class AdmissionConfig:
    """Resolved overload-control knobs (see docs/overload.md).

    ``request_timeout`` is the default per-request budget stamped at the
    serving edge when the caller supplied none; ``target_p99_ms`` == 0
    disables the AIMD limiter; ``pending_limit`` == 0 auto-sizes the
    bounded queue to 8x the window limit.
    """

    request_timeout: float = 30.0
    target_p99_ms: float = 0.0
    pending_limit: int = 0
    shed_policy: str = POLICY_FAIL_OPEN

    @classmethod
    def from_env(cls) -> "AdmissionConfig":
        try:
            timeout = env_knob(
                "GUBER_REQUEST_TIMEOUT", 30.0, parse=parse_duration)
        except ValueError:
            timeout = 30.0
        try:
            target = env_knob("GUBER_TARGET_P99_MS", 0.0, parse=float)
        except ValueError:
            target = 0.0
        try:
            pending = env_knob("GUBER_PENDING_LIMIT", 0, parse=int)
        except ValueError:
            pending = 0
        policy = env_knob("GUBER_SHED_POLICY", POLICY_FAIL_OPEN)
        if policy not in SHED_POLICIES:
            policy = POLICY_FAIL_OPEN
        return cls(
            request_timeout=max(0.0, float(timeout)),
            target_p99_ms=max(0.0, float(target)),
            pending_limit=max(0, int(pending)),
            shed_policy=policy,
        )

    def effective_pending_limit(self, window_limit: int) -> int:
        if self.pending_limit > 0:
            return self.pending_limit
        return max(1, 8 * int(window_limit))


def under_pressure(
    limiter: AimdLimiter,
    pending: int,
    pending_limit: int,
    batch_limit: int,
) -> bool:
    """Overload-degrade trigger for the lease tier (docs/leases.md):
    True when the AIMD limiter has backed off below the full window, or
    the pending queue has filled past half its bound.  Under pressure,
    lease grants degrade to cheap TTL extension of already-held budget
    (no decision, no device work) instead of full decisions — the lease
    analog of docs/overload.md's shed-before-pack discipline."""
    if limiter is not None and limiter.enabled:
        if limiter.window_limit < int(batch_limit):
            return True
    return pending >= max(1, int(pending_limit)) // 2
