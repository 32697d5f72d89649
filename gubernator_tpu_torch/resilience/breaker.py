"""Per-peer circuit breaker: closed / open / half-open.

The port's copy of the JAX package's ``resilience/breaker.py``.

Standard three-state breaker over a sliding failure window:

* **CLOSED** — requests flow; outcomes are recorded into a time-bounded
  window.  When the window holds at least ``min_requests`` samples and the
  failure rate reaches ``failure_threshold``, the breaker trips.
* **OPEN** — requests fail fast (no dial) until the open duration elapses.
  The duration follows a decorrelated-jitter backoff (base ``open_for``,
  cap ``open_cap``) so a peer that keeps failing is probed progressively
  less often.
* **HALF_OPEN** — up to ``half_open_probes`` requests are allowed through
  as probes.  A probe success closes the breaker (window and backoff
  reset); a probe failure re-opens it with a longer duration.

The clock is injectable (tests pass :class:`ManualClock`), transitions
fire an optional callback (PeerClient exports them as Prometheus state /
transition families), and the window is a bounded deque so memory stays
O(1) per peer.
"""

from __future__ import annotations

import collections
import enum
import random
import time
from typing import Callable, Optional

from gubernator_tpu_torch.resilience.backoff import DecorrelatedJitterBackoff

# Bound on the sliding window's sample count; failure *rate* needs only a
# representative recent sample, not every request ever made.
_MAX_WINDOW_SAMPLES = 256


class BreakerState(enum.IntEnum):
    # Gauge values for gubernator_breaker_state (docs/prometheus.md).
    CLOSED = 0
    HALF_OPEN = 1
    OPEN = 2


class BreakerOpenError(ConnectionError):
    """Raised without dialing when the peer's breaker is open."""


class CircuitBreaker:
    def __init__(
        self,
        *,
        failure_threshold: float = 0.5,
        min_requests: int = 5,
        window: float = 10.0,
        open_for: float = 2.0,
        open_cap: float = 30.0,
        half_open_probes: int = 1,
        enabled: bool = True,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        on_transition: Optional[
            Callable[[BreakerState, BreakerState], None]
        ] = None,
        name: str = "",
    ):
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError(
                f"failure_threshold must be in (0, 1]; got {failure_threshold}"
            )
        self.name = name
        self.enabled = enabled
        self.failure_threshold = failure_threshold
        self.min_requests = max(1, min_requests)
        self.window = window
        self.half_open_probes = max(1, half_open_probes)
        self._clock = clock
        self._backoff = DecorrelatedJitterBackoff(open_for, open_cap, rng=rng)
        self._on_transition = on_transition
        self._state = BreakerState.CLOSED
        self._open_until = 0.0
        self._probes = 0
        # (timestamp, ok) outcome samples inside the sliding window.
        self._events: collections.deque = collections.deque(
            maxlen=_MAX_WINDOW_SAMPLES
        )

    # ------------------------------------------------------------------
    @property
    def state(self) -> BreakerState:
        """Current state, promoting OPEN → HALF_OPEN when the open
        duration has elapsed (state reads drive the transition; there is
        no timer task)."""
        if (
            self._state is BreakerState.OPEN
            and self._clock() >= self._open_until
        ):
            self._transition(BreakerState.HALF_OPEN)
            self._probes = 0
        return self._state

    def is_open(self) -> bool:
        """Non-consuming fast-fail check (does not take a probe slot)."""
        return self.enabled and self.state is BreakerState.OPEN

    def allow(self) -> bool:
        """Whether one request may proceed right now.  In HALF_OPEN this
        *consumes* a probe slot — call it once per attempted RPC."""
        if not self.enabled:
            return True
        s = self.state
        if s is BreakerState.CLOSED:
            return True
        if s is BreakerState.OPEN:
            return False
        if self._probes < self.half_open_probes:
            self._probes += 1
            return True
        return False

    # ------------------------------------------------------------------
    def record_success(self) -> None:
        if not self.enabled:
            return
        if self._state is BreakerState.HALF_OPEN:
            # Probe succeeded: close and forget the failing past.
            self._events.clear()
            self._backoff.reset()
            self._transition(BreakerState.CLOSED)
            return
        self._events.append((self._clock(), True))
        self._prune()

    def record_failure(self) -> None:
        if not self.enabled:
            return
        if self._state is BreakerState.HALF_OPEN:
            self._trip()  # probe failed: back to OPEN, longer this time
            return
        if self._state is BreakerState.OPEN:
            return
        self._events.append((self._clock(), False))
        self._prune()
        total = len(self._events)
        if total < self.min_requests:
            return
        failures = sum(1 for _, ok in self._events if not ok)
        if failures / total >= self.failure_threshold:
            self._trip()

    def force_open(self, duration: Optional[float] = None) -> None:
        """Trip the breaker manually (tests, operator tooling)."""
        self._open_until = self._clock() + (
            duration if duration is not None else self._backoff.next()
        )
        self._events.clear()
        self._transition(BreakerState.OPEN)

    # ------------------------------------------------------------------
    def _trip(self) -> None:
        self._open_until = self._clock() + self._backoff.next()
        self._events.clear()
        self._transition(BreakerState.OPEN)

    def _prune(self) -> None:
        cutoff = self._clock() - self.window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def _transition(self, new: BreakerState) -> None:
        old, self._state = self._state, new
        if old is not new and self._on_transition is not None:
            self._on_transition(old, new)
