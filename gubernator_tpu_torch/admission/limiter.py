"""AIMD concurrency limiter (docs/overload.md).

Classic additive-increase / multiplicative-decrease on the admitted
window width, driven by the measured per-window latency (the same
dispatch+resolve time the flight recorder attributes to a window)
against ``GUBER_TARGET_P99_MS``.  Every ``adjust_every`` windows the
limiter computes the sample p99: at or under target, the window widens
by one additive step; over target, it shrinks multiplicatively — so the
system converges to max goodput instead of max queue.  A target of 0
disables the limiter entirely (the tick loop then admits its static
``batch_limit``), which is the default so unconfigured deployments and
tier-1 tests see byte-identical behavior.
"""

from __future__ import annotations

from typing import List


class AimdLimiter:
    """Adjusts the admitted window width from observed window latency."""

    #: multiplicative back-off factor applied when p99 exceeds target.
    DECREASE = 0.8

    def __init__(
        self,
        target_p99_ms: float,
        max_limit: int,
        min_limit: int = 0,
        adjust_every: int = 16,
    ):
        self.target_p99_ms = float(target_p99_ms)
        self.enabled = self.target_p99_ms > 0.0
        self.max_limit = max(1, int(max_limit))
        self.min_limit = (
            max(1, int(min_limit)) if min_limit
            else max(1, self.max_limit // 32)
        )
        self.adjust_every = max(1, int(adjust_every))
        # Start wide open: back off only on evidence of saturation.
        self._limit = self.max_limit
        self._samples: List[float] = []
        self.metric_increases = 0
        self.metric_decreases = 0

    @property
    def window_limit(self) -> int:
        """Current admitted window width, in requests."""
        return self._limit

    def snapshot(self) -> dict:
        """Cheap public view for the control plane (autoscaler,
        /debug/autoscaler); it runs on the controller's sampling
        cadence, never inside a tick."""
        return {
            "window_limit": self._limit,
            "enabled": self.enabled,
            "target_p99_ms": self.target_p99_ms,
            "max_limit": self.max_limit,
            "min_limit": self.min_limit,
            "increases": self.metric_increases,
            "decreases": self.metric_decreases,
        }

    @property
    def step(self) -> int:
        """Additive increase per adjustment, in requests."""
        return max(1, self.max_limit // 64)

    def record(self, window_ms: float) -> None:
        """Feed one window's measured latency; adjusts the limit every
        ``adjust_every`` samples.  No-op when disabled."""
        if not self.enabled:
            return
        self._samples.append(window_ms)
        if len(self._samples) >= self.adjust_every:
            self._adjust()

    def _adjust(self) -> None:
        samples = sorted(self._samples)
        self._samples = []
        idx = min(len(samples) - 1, int(0.99 * len(samples)))
        p99 = samples[idx]
        if p99 <= self.target_p99_ms:
            nxt = min(self.max_limit, self._limit + self.step)
            if nxt > self._limit:
                self.metric_increases += 1
            self._limit = nxt
        else:
            nxt = max(self.min_limit, int(self._limit * self.DECREASE))
            if nxt < self._limit:
                self.metric_decreases += 1
            self._limit = nxt
