"""Controller inputs: one immutable sample of the telemetry plane.

The port's copy of the JAX package's ``autoscale/signals``.  Every
field comes from a cheap public snapshot accessor — the admission plane
(:meth:`TickLoop.admission_snapshot`), the flight recorder
(:meth:`FlightRecorder.snapshot`), the tier occupancy
(:meth:`V1Instance.occupancy`), and the reshard coordinator — not
from private fields and not from parsing ``/metrics``.  Sampling runs on
the controller's cadence (seconds), never on the tick path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict


@dataclass(frozen=True)
class SignalSnapshot:
    """One controller observation window."""

    ts: float = 0.0                 # controller-clock sample time
    window_limit: int = 0           # AIMD admitted window width
    queue_depth: int = 0            # admission queue depth, in requests
    shed_total: int = 0             # cumulative admission sheds
    p50_ms: float = 0.0             # whole-window p50 (flight recorder)
    p99_ms: float = 0.0             # whole-window p99 (flight recorder)
    stage_p99_ms: Dict[str, float] = field(default_factory=dict)
    hot_occupancy: float = 0.0      # device-table fill fraction [0, 1]
    cold_size: int = 0              # cold-tier resident rows
    shards: int = 1                 # current mesh shard count
    breaker_open: bool = False      # any peer breaker open right now
    reshard_busy: bool = False      # a transition already holds the lock
    frozen: bool = False            # admission frozen (cutover window)


def instance_sampler(instance, clock) -> Callable[[], "SignalSnapshot"]:
    """Build the production sampler over a :class:`V1Instance`.

    The flight recorder is optional (installed only under
    ``GUBER_DEBUG_ENDPOINTS`` or the slow-window watchdog); without one
    the latency fields read 0.0 and the policy can still scale on queue
    depth and occupancy.  Tests bypass this entirely and hand the
    controller a fake sampler.
    """
    from gubernator_tpu_torch.utils import flightrec

    def sample() -> SignalSnapshot:
        adm = instance.tick_loop.admission_snapshot()
        occ = instance.occupancy()
        rec = flightrec.get()
        p50 = p99 = 0.0
        stage_p99: Dict[str, float] = {}
        if rec is not None:
            fr = rec.snapshot()
            p50 = fr["total"]["p50_ms"]
            p99 = fr["total"]["p99_ms"]
            stage_p99 = {s: v["p99_ms"] for s, v in fr["stages"].items()}
        coord = instance.reshard_coord
        return SignalSnapshot(
            ts=clock(),
            window_limit=adm["limiter"]["window_limit"],
            queue_depth=adm["queue"]["requests"],
            shed_total=sum(adm["shed"].values()),
            p50_ms=p50,
            p99_ms=p99,
            stage_p99_ms=stage_p99,
            hot_occupancy=occ["hot_occupancy"],
            cold_size=occ["cold_size"],
            shards=int(coord.status()["shards"]),
            breaker_open=any(
                p.breaker.is_open() for p in instance.get_peer_list()),
            reshard_busy=coord.is_busy(),
            frozen=adm["frozen"],
        )

    return sample
