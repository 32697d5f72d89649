"""Virtual time for deterministic resilience tests.

The port's copy of the JAX package's ``resilience/clock.py``.

The breaker, backoff, and fault injector all take an injectable ``clock``
(and, where they wait, an async ``sleep``); production passes
``time.monotonic``/``asyncio.sleep``, tests pass a :class:`ManualClock` so
open-duration expiry and injected delays advance instantly — the chaos
suite runs in tier-1 with no real sleeps.
"""

from __future__ import annotations

from typing import List


class ManualClock:
    """Monotonic clock that only moves when told to.

    Usable directly as a ``clock`` callable (``clock()`` → now) and as a
    ``sleep`` hook (``await clock.sleep(d)`` records ``d`` and advances
    time by it without ever yielding to the wall clock).
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.sleeps: List[float] = []  # every sleep duration, in order

    def __call__(self) -> float:
        return self._now

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += dt

    async def sleep(self, dt: float) -> None:
        self.sleeps.append(dt)
        self._now += dt
