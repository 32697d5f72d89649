"""Sustained-window scaling policy with non-overlapping hysteresis bands.

The port's copy of the JAX package's ``autoscale/policy``.

The policy answers exactly one question per sample: does the evidence
*sustained over N consecutive windows* justify a direction?  Scale-up
pressure is p99 over target OR queue depth over high-water (either one
means the current layout is the bottleneck); scale-down pressure is low
hot-table occupancy AND p99 under ``target × hysteresis`` (capacity is
idle and there is latency headroom).  Because ``hysteresis < 1`` is
validated at config load, the up band (``p99 > target``) and the down
band (``p99 < target × hysteresis``) can never overlap — a p99 sitting
between them is a hold, which is what kills ping-pong at its source
(per the Pulsar playbook: react to the sustained bottleneck, not the
noise).  Targets move one power of two at a time (double up, halve
down), clamped to ``[min_shards, max_shards]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from gubernator_tpu_torch.autoscale.signals import SignalSnapshot

UP = "up"
DOWN = "down"


@dataclass
class PolicyConfig:
    """Env surface ``GUBER_AUTOSCALE_*`` (config.py validates)."""

    windows: int = 3                # consecutive samples before acting
    target_p99_ms: float = 5.0      # scale-up latency threshold
    queue_high: int = 1000          # scale-up queue-depth high-water
    hysteresis: float = 0.5         # down band = target × this (< 1)
    occupancy_low: float = 0.3      # scale-down occupancy threshold
    min_shards: int = 1
    max_shards: int = 8


class AutoscalePolicy:
    """Streak-counting policy: one :meth:`observe` per sample."""

    def __init__(self, conf: Optional[PolicyConfig] = None):
        self.conf = conf or PolicyConfig()
        self._up_streak = 0
        self._down_streak = 0

    @property
    def streaks(self) -> dict:
        return {"up": self._up_streak, "down": self._down_streak}

    def observe(self, snap: SignalSnapshot) -> Optional[str]:
        """Feed one sample; returns ``UP``/``DOWN`` when the pressure
        has been sustained for ``windows`` consecutive samples, else
        None (a single spike is a hold by construction).  Samples taken
        while admission is frozen (a cutover in flight) are skipped
        entirely — a freeze inflates queue depth and p99 for reasons
        the controller itself caused."""
        c = self.conf
        if snap.frozen:
            return None
        up = (c.target_p99_ms > 0 and snap.p99_ms > c.target_p99_ms) or \
            snap.queue_depth > c.queue_high
        down = (
            snap.hot_occupancy < c.occupancy_low
            and snap.p99_ms < c.target_p99_ms * c.hysteresis
        )
        if up:
            self._up_streak += 1
            self._down_streak = 0
        elif down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0
        if self._up_streak >= c.windows:
            return UP
        if self._down_streak >= c.windows:
            return DOWN
        return None

    def reset(self) -> None:
        """Clear both streaks (called after an actuated transition so
        the next decision re-earns its N windows on the new layout)."""
        self._up_streak = 0
        self._down_streak = 0

    def target_shards(self, current: int, direction: str) -> int:
        """Next shard count: double up / halve down, clamped."""
        c = self.conf
        cur = max(1, int(current))
        if direction == UP:
            return min(c.max_shards, cur * 2)
        return max(c.min_shards, cur // 2 or 1)
