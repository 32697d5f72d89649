"""Deadline propagation helpers (docs/overload.md).

Deadlines are *absolute local monotonic* timestamps (seconds, same
clock as the component that stamped them).  They never cross a process
boundary directly — the wire carries the *relative* remaining budget in
milliseconds via the ``guber-deadline-ms`` gRPC metadata key, and the
receiving edge re-anchors it against its own clock.  That sidesteps
clock skew entirely: each hop only ever subtracts its own elapsed time
from the budget it was handed.
"""

from __future__ import annotations

from typing import Iterable, Optional

# gRPC metadata key carrying the caller's remaining budget in integer
# milliseconds.  Lowercase per gRPC metadata rules.
DEADLINE_METADATA_KEY = "guber-deadline-ms"


class BudgetExhaustedError(RuntimeError):
    """The caller's propagated deadline budget is already spent — the
    RPC (or retry) must not be attempted at all."""


def remaining_budget(deadline: Optional[float], now: float) -> Optional[float]:
    """Seconds left before ``deadline`` (None = unbounded budget)."""
    if deadline is None:
        return None
    return deadline - now


def budget_header_value(deadline: Optional[float], now: float) -> Optional[str]:
    """Render the remaining budget as a ``guber-deadline-ms`` metadata
    value, or None when there is no deadline to propagate.  A spent
    budget renders as ``"0"`` so the receiver sheds immediately instead
    of inheriting its own generous default."""
    if deadline is None:
        return None
    return str(max(0, int((deadline - now) * 1000.0)))


def deadline_from_header(value: Optional[str], now: float) -> Optional[float]:
    """Re-anchor a ``guber-deadline-ms`` metadata value against the
    local clock.  Malformed values are ignored (None) rather than
    rejected — a bad budget header must never fail an otherwise-valid
    request."""
    if value is None:
        return None
    try:
        ms = int(value)
    except (TypeError, ValueError):
        return None
    if ms < 0:
        return None
    return now + ms / 1000.0


def batch_deadline(reqs: Iterable) -> Optional[float]:
    """The effective deadline for a batch submission: the earliest
    per-request deadline present, or None when no request carries one.
    Shed granularity in the tick loop is the queued item, so a batch
    inherits its most urgent member's budget."""
    best: Optional[float] = None
    for r in reqs:
        d = getattr(r, "deadline", None)
        if d is None:
            continue
        if best is None or d < best:
            best = d
    return best
