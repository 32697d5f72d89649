"""Seedable per-peer fault injection for the peer RPC path (the port's
copy of the JAX package's ``resilience/faults.py``; the same seeded draws).

A :class:`FaultInjector` sits between ``PeerClient`` and its gRPC stub
(wired through ``InstanceConfig.fault_injector`` — a test/config hook, not
a hot-path feature): before every peer RPC the client awaits
``before_rpc(peer, method)``, which may delay the call, raise UNAVAILABLE
(``error``/``partition``), or raise DEADLINE_EXCEEDED (``drop`` — a
dropped RPC surfaces to the caller as its deadline expiring).  Faults are
keyed per peer address (``"*"`` matches every peer), draws come from a
seeded RNG so chaos runs replay exactly, and injected faults are counted
per (peer, kind) for test oracles.

WAN schedules (docs/federation.md): faults can additionally be keyed by
*direction* — ``set_fault(dest, from_peer=src, ...)`` applies only to
RPCs from ``src`` to ``dest``, leaving the reverse path clean (the
asymmetric-partition scenario where region A can reach B but B's acks
never come back).  A schedule can also *flap* (``flap_interval``):
it is active only during alternating windows of that length on the
injector clock, modelling a link that comes and goes.

The env surface (``GUBER_FAULT_*``, see :meth:`FaultInjector.from_env`)
lets an operator stage the same schedules in a real deployment.
"""

from __future__ import annotations

import asyncio
import collections
import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple


def rpc_error(code, details: str):
    """A real ``grpc.aio.AioRpcError`` (so retry/breaker paths can't tell
    it from the wire) carrying the injected status.  ``grpc`` is imported
    here: the serving core imports this package without it."""
    import grpc.aio

    return grpc.aio.AioRpcError(
        code,
        grpc.aio.Metadata(),
        grpc.aio.Metadata(),
        details=details,
        debug_error_string="fault-injected",
    )


@dataclass
class FaultSpec:
    """One peer's fault schedule.  Rates are probabilities per RPC."""

    error_rate: float = 0.0      # UNAVAILABLE with this probability
    drop_rate: float = 0.0       # DEADLINE_EXCEEDED with this probability
    delay: float = 0.0           # fixed latency added before the RPC
    partition: bool = False      # unconditional UNAVAILABLE (100% failure)
    methods: Tuple[str, ...] = ()  # restrict to these RPCs; empty = all
    # Link flap: 0 = always active; > 0 = active only during alternating
    # windows of this many (injector-clock) seconds, starting active at
    # install time.
    flap_interval: float = 0.0

    def matches(self, method: str) -> bool:
        return not self.methods or method in self.methods


class FaultInjector:
    """Per-peer fault schedules with a seeded RNG and virtual-clock hooks."""

    def __init__(
        self,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        sleep=asyncio.sleep,
    ):
        self._rng = random.Random(seed)
        self._clock = clock
        self._sleep = sleep
        self._faults: Dict[str, FaultSpec] = {}
        # Directional schedules: (dest, src) → spec, consulted before the
        # per-dest and "*" entries so one direction of a pair can fail
        # while the reverse stays clean.
        self._directional: Dict[Tuple[str, str], FaultSpec] = {}
        # spec id → install time, for flap-window phase.
        self._installed_at: Dict[int, float] = {}
        # (peer, kind) → count; kind in {"error", "drop", "delay"}.
        self.injected: collections.Counter = collections.Counter()

    # ------------------------------------------------------------------
    def set_fault(self, peer: str = "*", from_peer: Optional[str] = None,
                  **spec) -> FaultSpec:
        """Install/replace the schedule for ``peer`` (``"*"`` = every peer);
        pass FaultSpec fields as kwargs, or a prebuilt ``spec=FaultSpec``.
        With ``from_peer`` the schedule is directional: it applies only to
        RPCs whose caller identifies as ``from_peer`` (PeerClient passes
        its own advertise address), leaving the reverse direction — and
        every other caller — untouched."""
        prebuilt = spec.pop("spec", None)
        built = prebuilt if prebuilt is not None else FaultSpec(**spec)
        if from_peer is not None:
            self._directional[(peer, from_peer)] = built
        else:
            self._faults[peer] = built
        self._installed_at[id(built)] = self._clock()
        return built

    def clear(self, peer: Optional[str] = None) -> None:
        if peer is None:
            self._faults.clear()
            self._directional.clear()
            self._installed_at.clear()
        else:
            self._faults.pop(peer, None)
            for k in [k for k in self._directional if k[0] == peer]:
                del self._directional[k]

    def spec_for(self, peer: str, from_peer: str = "") -> Optional[FaultSpec]:
        """The schedule governing an RPC to ``peer`` from ``from_peer``:
        directional match first, then per-dest, then the wildcard."""
        if from_peer:
            spec = self._directional.get((peer, from_peer))
            if spec is not None:
                return spec
        return self._faults.get(peer) or self._faults.get("*")

    def _flap_active(self, spec: FaultSpec) -> bool:
        """True when the schedule is currently live: always for
        non-flapping specs; for flapping ones, during even-numbered
        windows of ``flap_interval`` since install."""
        if spec.flap_interval <= 0:
            return True
        t0 = self._installed_at.get(id(spec), 0.0)
        elapsed = self._clock() - t0
        return int(elapsed / spec.flap_interval) % 2 == 0

    # ------------------------------------------------------------------
    async def before_rpc(self, peer: str, method: str,
                         from_peer: str = "") -> None:
        """Apply ``peer``'s schedule to one outgoing RPC: maybe delay,
        maybe raise.  A no-op when no schedule matches."""
        spec = self.spec_for(peer, from_peer)
        if spec is None or not spec.matches(method):
            return
        if not self._flap_active(spec):
            return
        if spec.delay > 0:
            self.injected[(peer, "delay")] += 1
            await self._sleep(spec.delay)
        if spec.partition or (
            spec.error_rate > 0 and self._rng.random() < spec.error_rate
        ):
            self.injected[(peer, "error")] += 1
            import grpc

            raise rpc_error(
                grpc.StatusCode.UNAVAILABLE,
                f"injected fault: peer {peer} unavailable",
            )
        if spec.drop_rate > 0 and self._rng.random() < spec.drop_rate:
            self.injected[(peer, "drop")] += 1
            import grpc

            raise rpc_error(
                grpc.StatusCode.DEADLINE_EXCEEDED,
                f"injected fault: RPC to peer {peer} dropped",
            )

    # ------------------------------------------------------------------
    @classmethod
    def from_env(cls, reader) -> Optional["FaultInjector"]:
        """Build an injector from ``GUBER_FAULT_*`` (config.py EnvReader);
        None unless ``GUBER_FAULT_PEERS`` names at least one target.

        GUBER_FAULT_PEERS       comma list of peer addresses, or "*"
        GUBER_FAULT_ERROR_RATE  probability of UNAVAILABLE per RPC
        GUBER_FAULT_DROP_RATE   probability of DEADLINE_EXCEEDED per RPC
        GUBER_FAULT_DELAY       added latency (Go-style duration)
        GUBER_FAULT_PARTITION   bool: 100% UNAVAILABLE
        GUBER_FAULT_SEED        RNG seed (default 0)
        """
        peers = reader.list_("GUBER_FAULT_PEERS")
        if not peers:
            return None
        inj = cls(seed=reader.int_("GUBER_FAULT_SEED", 0))
        spec = FaultSpec(
            error_rate=float(reader.str_("GUBER_FAULT_ERROR_RATE", "0") or 0),
            drop_rate=float(reader.str_("GUBER_FAULT_DROP_RATE", "0") or 0),
            delay=reader.float_seconds("GUBER_FAULT_DELAY", 0.0),
            partition=reader.bool_("GUBER_FAULT_PARTITION"),
        )
        for p in peers:
            inj._faults[p] = spec
        return inj
