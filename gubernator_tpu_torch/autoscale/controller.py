"""The controller: sample → policy → guardrails → actuate, supervised.

The port's copy of the JAX package's ``autoscale/controller``.

Separation of duties: :mod:`signals` observes, :mod:`policy` proposes a
direction, and this module *disposes* — every proposal runs a guardrail
chain before it may touch :meth:`Instance.reshard`:

``breaker_open``
    An open peer breaker means the cluster is already degraded; a
    freeze/cutover on top of that turns a brownout into an outage.
``reshard_busy``
    A transition is already holding the coordinator lock (checked from
    the sampled snapshot AND from the actuation result — the
    coordinator's ``BUSY_RESULT`` dict is the single source of truth,
    so the autoscaler and the admin endpoint can never double-freeze).
``cooldown_up`` / ``cooldown_down``
    Per-direction quiet period measured from the last actuation in
    either direction: scale-up re-arms fast (load is real), scale-down
    re-arms slow (giving back capacity is never urgent).
``flap_cap``
    Rolling-hour ceiling on actuations — a controller that wants to
    transition more than ``max_per_hour`` times is reacting to noise,
    and every transition costs a freeze window.

Every decision — act, hold, or veto with the guardrail that fired —
lands in a bounded ring (``/debug/autoscaler``) and increments
``gubernator_tpu_autoscale_{decisions,transitions,vetoes}``.  ``dry_run``
(the default) runs the full chain and records the act decision without
calling the executor: stare at the ring for a day before arming it.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from gubernator_tpu_torch.autoscale.policy import DOWN, UP, AutoscalePolicy
from gubernator_tpu_torch.autoscale.signals import SignalSnapshot
from gubernator_tpu_torch.resilience import spawn_supervised

log = logging.getLogger("gubernator.autoscale")

ACT = "act"
HOLD = "hold"
VETO = "veto"

FLAP_WINDOW_S = 3600.0  # the "rolling hour" of the flap suppressor


@dataclass
class Decision:
    """One ring entry: what the controller did and why."""

    ts: float
    action: str                     # act | hold | veto
    reason: str                     # guardrail / policy explanation
    direction: str = ""             # up | down | "" (hold with no signal)
    from_shards: int = 0
    to_shards: int = 0
    dry_run: bool = False
    outcome: str = ""               # committed | aborted | noop | ""
    signals: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "ts": round(self.ts, 3),
            "action": self.action,
            "reason": self.reason,
            "direction": self.direction,
            "from_shards": self.from_shards,
            "to_shards": self.to_shards,
            "dry_run": self.dry_run,
            "outcome": self.outcome,
            "signals": dict(self.signals),
        }


class Autoscaler:
    """Supervised controller loop over a sampler and a reshard executor.

    * ``sample`` — zero-arg callable returning a
      :class:`SignalSnapshot` (production: :func:`instance_sampler`;
      tests: any fake).
    * ``reshard`` — callable taking the target shard count and
      returning the coordinator outcome dict (``{"result": "busy"}``
      for a concurrent transition).  May be sync or async; production
      passes ``Instance.reshard``.
    * ``clock``/``sleep`` — injectable time (tests pass a
      :class:`~gubernator_tpu_torch.resilience.ManualClock`).
    """

    def __init__(
        self,
        sample: Callable[[], SignalSnapshot],
        reshard: Callable[[int], object],
        *,
        policy: Optional[AutoscalePolicy] = None,
        interval: float = 10.0,
        cooldown_up: float = 60.0,
        cooldown_down: float = 300.0,
        max_per_hour: int = 4,
        dry_run: bool = True,
        ring_size: int = 256,
        metrics=None,
        clock=time.monotonic,
        sleep=asyncio.sleep,
    ):
        self.sample = sample
        self.reshard = reshard
        self.policy = policy or AutoscalePolicy()
        self.interval = float(interval)
        self.cooldown = {UP: float(cooldown_up), DOWN: float(cooldown_down)}
        self.max_per_hour = int(max_per_hour)
        self.dry_run = bool(dry_run)
        self.metrics = metrics
        self._clock = clock
        self._sleep = sleep
        self.ring: deque = deque(maxlen=max(1, int(ring_size)))
        self._actuations: deque = deque()   # timestamps, rolling hour
        self._last_actuation: Optional[float] = None
        self._running = False
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Spawn the supervised sampling loop on the running event loop."""
        self._running = True
        self._task = spawn_supervised(
            self._loop, name="autoscaler",
            should_restart=lambda: self._running,
            metrics=self.metrics, loop_label="autoscale",
        )

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:
                pass
            self._task = None

    async def _loop(self) -> None:
        while self._running:
            await self._sleep(self.interval)
            if not self._running:
                return
            await self.step()

    # ------------------------------------------------------------------
    # One control decision
    # ------------------------------------------------------------------
    async def step(self) -> Decision:
        """Sample once, decide once.  Never raises: an executor failure
        is a recorded veto, not a dead control loop."""
        snap = self.sample()
        now = self._clock()
        direction = self.policy.observe(snap)
        if direction is None:
            return self._record(Decision(
                ts=now, action=HOLD, reason="no_sustained_pressure",
                from_shards=snap.shards, to_shards=snap.shards,
                signals=self._sig(snap),
            ))
        target = self.policy.target_shards(snap.shards, direction)
        if target == snap.shards:
            return self._record(Decision(
                ts=now, action=HOLD, reason="at_bound", direction=direction,
                from_shards=snap.shards, to_shards=target,
                signals=self._sig(snap),
            ))
        veto = self._guardrail(snap, direction, now)
        if veto is not None:
            return self._record(Decision(
                ts=now, action=VETO, reason=veto, direction=direction,
                from_shards=snap.shards, to_shards=target,
                signals=self._sig(snap),
            ))
        if self.dry_run:
            # The act decision is recorded (the rollout story: watch the
            # ring agree with your intuition for a day), nothing moves,
            # and no cooldown/flap state is consumed.
            return self._record(Decision(
                ts=now, action=ACT, reason="policy", direction=direction,
                from_shards=snap.shards, to_shards=target, dry_run=True,
                outcome="dry_run", signals=self._sig(snap),
            ))
        return await self._actuate(snap, direction, target, now)

    def _guardrail(self, snap: SignalSnapshot, direction: str,
                   now: float) -> Optional[str]:
        """First guardrail that objects wins; None means clear to act."""
        if snap.breaker_open:
            return "breaker_open"
        if snap.reshard_busy:
            return "reshard_busy"
        if self._last_actuation is not None and \
                now - self._last_actuation < self.cooldown[direction]:
            return f"cooldown_{direction}"
        while self._actuations and now - self._actuations[0] > FLAP_WINDOW_S:
            self._actuations.popleft()
        if len(self._actuations) >= self.max_per_hour:
            return "flap_cap"
        return None

    async def _actuate(self, snap: SignalSnapshot, direction: str,
                       target: int, now: float) -> Decision:
        try:
            res = self.reshard(target)
            if inspect.isawaitable(res):
                res = await res
        except Exception as e:
            log.warning("autoscale reshard %d -> %d failed: %s",
                        snap.shards, target, e)
            return self._record(Decision(
                ts=now, action=VETO, reason="reshard_error",
                direction=direction, from_shards=snap.shards,
                to_shards=target, signals=self._sig(snap),
            ))
        if isinstance(res, dict) and res.get("result") == "busy":
            # Lost the race to the admin endpoint between sample and
            # call — the coordinator's lock, not ours, is authoritative.
            return self._record(Decision(
                ts=now, action=VETO, reason="reshard_busy",
                direction=direction, from_shards=snap.shards,
                to_shards=target, signals=self._sig(snap),
            ))
        # Any real actuation — committed or aborted — consumed a freeze
        # window, so both charge the cooldowns and the flap budget.
        self._last_actuation = now
        self._actuations.append(now)
        self.policy.reset()
        outcome = res.get("outcome", "") if isinstance(res, dict) else ""
        if outcome == "committed" and self.metrics is not None:
            self.metrics.autoscale_transitions.labels(
                direction=direction).inc()
        log.info("autoscale %s: %d -> %d shards (%s)",
                 direction, snap.shards, target, outcome or "done")
        return self._record(Decision(
            ts=now, action=ACT, reason="policy", direction=direction,
            from_shards=snap.shards, to_shards=target, outcome=outcome,
            signals=self._sig(snap),
        ))

    # ------------------------------------------------------------------
    # Bookkeeping / introspection
    # ------------------------------------------------------------------
    def _record(self, d: Decision) -> Decision:
        self.ring.append(d)
        if self.metrics is not None:
            self.metrics.autoscale_decisions.labels(action=d.action).inc()
            if d.action == VETO:
                self.metrics.autoscale_vetoes.labels(reason=d.reason).inc()
        return d

    @staticmethod
    def _sig(snap: SignalSnapshot) -> dict:
        """The compact signal summary kept per ring entry."""
        return {
            "p99_ms": snap.p99_ms,
            "queue_depth": snap.queue_depth,
            "hot_occupancy": snap.hot_occupancy,
            "window_limit": snap.window_limit,
        }

    def transitions_last_hour(self, now: Optional[float] = None) -> int:
        now = self._clock() if now is None else now
        return sum(1 for t in self._actuations if now - t <= FLAP_WINDOW_S)

    def debug_state(self) -> dict:
        """The /debug/autoscaler body: config, streaks, and the ring
        (oldest first)."""
        c = self.policy.conf
        return {
            "running": self._running,
            "dry_run": self.dry_run,
            "interval_s": self.interval,
            "policy": {
                "windows": c.windows,
                "target_p99_ms": c.target_p99_ms,
                "queue_high": c.queue_high,
                "hysteresis": c.hysteresis,
                "occupancy_low": c.occupancy_low,
                "min_shards": c.min_shards,
                "max_shards": c.max_shards,
            },
            "cooldown_s": {"up": self.cooldown[UP], "down": self.cooldown[DOWN]},
            "max_per_hour": self.max_per_hour,
            "streaks": self.policy.streaks,
            "transitions_last_hour": self.transitions_last_hour(),
            "last_decision": self.ring[-1].as_dict() if self.ring else None,
            "decisions": [d.as_dict() for d in self.ring],
        }
