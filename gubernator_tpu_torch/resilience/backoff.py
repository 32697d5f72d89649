"""Decorrelated-jitter exponential backoff.

The port's copy of the JAX package's ``resilience/backoff.py``.

The "decorrelated jitter" variant from the AWS architecture blog
("Exponential Backoff And Jitter"): each delay is drawn uniformly from
``[base, prev * 3]`` and capped, so concurrent retriers spread out instead
of thundering in lockstep — the failure mode of both plain exponential
backoff (synchronized waves) and full jitter (too many immediate retries).
"""

from __future__ import annotations

import random
from typing import Optional


class DecorrelatedJitterBackoff:
    """``next()`` yields the next delay; ``reset()`` after a success."""

    def __init__(self, base: float, cap: float,
                 rng: Optional[random.Random] = None):
        if base <= 0:
            raise ValueError(f"backoff base must be > 0; got {base}")
        if cap < base:
            raise ValueError(f"backoff cap {cap} must be >= base {base}")
        self.base = base
        self.cap = cap
        self._rng = rng if rng is not None else random.Random()
        self._prev = base

    def next(self) -> float:
        d = min(self.cap, self._rng.uniform(self.base, self._prev * 3))
        self._prev = d
        return d

    def reset(self) -> None:
        self._prev = self.base
