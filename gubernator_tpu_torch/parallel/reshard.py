"""Live resharding: the n -> m transition state machine.

The port's copy of the JAX package's ``parallel/reshard.py``.  The
coordinator runs a drain-then-cutover protocol around the engine's
relayout (:meth:`MeshTickEngine.reshard`):

``FREEZE``
    New CLIENT windows answer a retriable shed at the admission queue
    (:meth:`TickLoop.freeze`); PEER reconcile traffic keeps draining: it
    outranks clients and must land before the cutover.
``DRAIN``
    Bounded quiesce: every admitted window resolves.  A drain that misses
    its budget aborts: the cutover never runs under traffic.
``RELAYOUT``/``CUTOVER``
    The freeze takes both classes for the bounded cutover, a ``begin``
    record lands in the transition journal, then the engine re-lays its
    table and swaps layouts at once (an engine failure restores the old
    layout before raising).
``VERIFY``
    The post-cutover table is audited: every row live at relayout time is
    present exactly once (``state_loss``, ``double_served``) and the
    routed path agrees with residency (``parity_errors``).

Every failure lands in a defined state: an open peer breaker aborts
before the cutover; a crash mid-cutover leaves a non-terminal journal
record that startup detects (the snapshot, never written mid-flight, is
authoritative); an engine error rolls back and the transition reports
``aborted``.  An engine without ``reshard`` (the single-card
``TickEngine``) runs the degenerate identity transition: the whole
protocol with no relayout.

The verify phase reads an engine's census as columns when the engine
offers ``census()`` (the port's mesh: slot maps and the gathered
``in_use`` word, no dict a key), and ``export_items()`` otherwise; both
give the JAX coordinator's three counts on the same table.  A node's
:class:`FederationManager` pauses its envelope sends from FREEZE to the
end of the transition, so no envelope is compacted from half-relayouted
owner state; every exit path resumes them.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np

from gubernator_tpu_torch.native import crc32_batch
from gubernator_tpu_torch.ops.reqcols import key_groups
from gubernator_tpu_torch.persistence.transition import TransitionRecord

log = logging.getLogger("gubernator.reshard")

PHASE_IDLE = "idle"
PHASE_FREEZE = "freeze"
PHASE_DRAIN = "drain"
PHASE_RELAYOUT = "relayout"
PHASE_CUTOVER = "cutover"
PHASE_VERIFY = "verify"
PHASE_COMMITTED = "committed"
PHASE_ABORTED = "aborted"

# The gubernator_tpu_reshard_phase gauge: terminal phases read as idle.
_PHASE_IDS = {
    PHASE_IDLE: 0,
    PHASE_FREEZE: 1,
    PHASE_DRAIN: 2,
    PHASE_RELAYOUT: 3,
    PHASE_CUTOVER: 4,
    PHASE_VERIFY: 5,
    PHASE_COMMITTED: 0,
    PHASE_ABORTED: 0,
}


class ReshardError(RuntimeError):
    """A transition could not start (already running, or a bad target)."""


# The one answer to a call made while a transition runs: the instance,
# the /debug/reshard 409 and any other caller read this dict; the
# coordinator's non-blocking lock is the only busy check.
BUSY_RESULT = {
    "result": "busy",
    "error": "a reshard transition is already running",
}


def census_counts(census: dict, expected_live: int) -> tuple:
    """``(state_loss, double_served, parity_errors)`` from a column census
    (``MeshTickEngine.census``): the counts the JAX coordinator takes from
    ``export_items()`` and ``routing_parity_errors`` on the same table.
    ``live`` keys are the exported ones; a key is double served for each
    live copy past its first; a live key is a parity error unless it is
    mapped on exactly one shard, the one its CRC-32 routes it to."""
    blob, offsets = census["blob"], census["offsets"]
    live = np.asarray(census["live"], bool)
    if not live.any():
        return max(0, int(expected_live)), 0, 0
    crc = crc32_batch(blob, offsets)
    shard = np.asarray(census["shard"])
    if not (crc % np.uint32(census["n_shards"]) != shard).any():
        # Every mapped key sits on its route, so no key sits on two
        # shards: each live key is one exported item, on its route.
        return max(0, int(expected_live) - int(live.sum())), 0, 0
    gid = key_groups(blob, offsets, crc)
    live_g = np.unique(gid[live])
    loss = max(0, int(expected_live) - len(live_g))
    dup = int(live.sum()) - len(live_g)
    copies = np.bincount(gid)
    sole = np.zeros(len(copies), np.int64)
    sole[gid] = np.arange(len(gid))
    at = sole[live_g]
    route = (crc[at] % np.uint32(census["n_shards"])).astype(np.int64)
    parity = int(((copies[live_g] != 1) | (shard[at] != route)).sum())
    return loss, dup, parity


class ReshardCoordinator:
    """Drives one transition at a time over an engine and its tick loop.

    Every hook is optional: ``tick_loop`` (freeze, quiesce, unfreeze),
    ``transition_log`` (the crash journal, persistence.TransitionLog),
    ``breaker_check`` (True when an open peer breaker makes the cutover
    unsafe; asked after the drain and again just before the cutover),
    ``global_engine`` (a MeshGlobalEngine whose reconcile pauses for the
    transition), ``federation`` (a FederationManager whose envelope
    sends pause for the transition) and ``metrics``."""

    def __init__(
        self,
        engine,
        tick_loop=None,
        transition_log=None,
        breaker_check: Optional[Callable[[], bool]] = None,
        global_engine=None,
        federation=None,
        metrics=None,
        freeze_timeout: float = 5.0,
        verify: bool = True,
    ):
        self.engine = engine
        self.tick_loop = tick_loop
        self.transition_log = transition_log
        self.breaker_check = breaker_check
        self.global_engine = global_engine
        self.federation = federation
        self.metrics = metrics
        self.freeze_timeout = float(freeze_timeout)
        self.verify = bool(verify)
        self._lock = threading.Lock()
        self._epoch = 0
        self.phase = PHASE_IDLE
        self.last: dict = {}

    def status(self) -> dict:
        """The coordinator's phase, epoch, shard count and last outcome
        (``/debug/state``)."""
        return {
            "phase": self.phase,
            "epoch": self._epoch,
            "shards": getattr(self.engine, "n_shards", 1),
            "last": dict(self.last),
        }

    def _set_phase(self, phase: str) -> None:
        self.phase = phase
        if self.metrics is not None:
            self.metrics.reshard_phase.set(_PHASE_IDS[phase])

    def record_interrupted(self, rec) -> None:
        """Report a non-terminal journal record found at startup (the
        process died mid-transition; the restored snapshot is
        authoritative)."""
        log.warning(
            "interrupted reshard transition detected at startup "
            "(%d -> %d shards, epoch %d); serving from the restored "
            "snapshot on the old layout",
            rec.from_shards, rec.to_shards, rec.epoch)
        if self.metrics is not None:
            self.metrics.reshard_transitions.labels(
                result="interrupted").inc()

    def is_busy(self) -> bool:
        """True while a transition holds the lock (advisory: callers that
        must not block use :meth:`try_reshard`)."""
        return self._lock.locked()

    def try_reshard(self, new_shards: int) -> dict:
        """Run one n -> m transition, or return a copy of ``BUSY_RESULT``
        when one is running.  Raises :class:`ReshardError` for a target
        below 1; an aborted transition is an outcome, not an error."""
        new_n = int(new_shards)
        if new_n < 1:
            raise ReshardError(f"target shard count must be >= 1: {new_n}")
        if not self._lock.acquire(blocking=False):
            return dict(BUSY_RESULT)
        try:
            return self._run(new_n)
        finally:
            self._lock.release()

    def reshard(self, new_shards: int) -> dict:
        """:meth:`try_reshard`, with a running transition raised as
        :class:`ReshardError`."""
        out = self.try_reshard(new_shards)
        if out.get("result") == "busy":
            raise ReshardError(out["error"])
        return out

    def _run(self, new_n: int) -> dict:
        from_n = int(getattr(self.engine, "n_shards", 1))
        self._epoch += 1
        t0 = time.monotonic()
        out = {
            "from_shards": from_n,
            "to_shards": new_n,
            "epoch": self._epoch,
            "state_loss": 0,
            "double_served": 0,
            "parity_errors": 0,
            "live_items": 0,
        }
        if new_n == from_n:
            out.update(outcome="noop", duration_s=0.0)
            self.last = out
            return out
        try:
            # FREEZE: clients shed retriable; peers keep draining.
            self._set_phase(PHASE_FREEZE)
            if self.tick_loop is not None:
                self.tick_loop.freeze()
            if self.global_engine is not None:
                self.global_engine.pause_reconcile()
            if self.federation is not None:
                self.federation.pause()
            # DRAIN: bounded quiesce.
            self._set_phase(PHASE_DRAIN)
            if self.tick_loop is not None:
                if not self.tick_loop.quiesce(self.freeze_timeout):
                    return self._abort(out, t0, "drain timeout: in-flight "
                                       "windows did not quiesce")
            if self.breaker_check is not None and self.breaker_check():
                return self._abort(out, t0, "peer breaker open after drain")
            # RELAYOUT/CUTOVER: both classes frozen; the journal's begin
            # record before any state moves.
            self._set_phase(PHASE_RELAYOUT)
            if self.tick_loop is not None:
                self.tick_loop.freeze(shed_peers=True)
            if self.breaker_check is not None and self.breaker_check():
                return self._abort(out, t0, "peer breaker open at cutover")
            self._journal("begin", out)
            self._set_phase(PHASE_CUTOVER)
            try:
                if hasattr(self.engine, "reshard"):
                    info = self.engine.reshard(new_n)
                    out["live_items"] = int(info.get("live_items", 0))
                else:
                    # The degenerate identity transition.
                    out["live_items"] = int(self.engine.cache_size())
                    out["degenerate"] = True
            except Exception as e:  # the engine rolled back before raising
                self._journal("abort", out)
                return self._abort(out, t0, f"engine relayout failed "
                                   f"(rolled back): {e}")
            # VERIFY before unfreezing.
            self._set_phase(PHASE_VERIFY)
            if self.verify:
                loss, dup, parity = self._verify(out["live_items"])
                out.update(state_loss=loss, double_served=dup,
                           parity_errors=parity)
                if self.metrics is not None:
                    if loss:
                        self.metrics.reshard_state_loss.inc(loss)
                    if dup:
                        self.metrics.reshard_double_served.inc(dup)
                if loss or dup or parity:
                    log.error(
                        "reshard verify found damage (loss=%d dup=%d "
                        "parity=%d) after %d -> %d; transition committed "
                        "— investigate before the next one",
                        loss, dup, parity, from_n, new_n)
            self._journal("commit", out)
            return self._finish(out, t0, "committed")
        finally:
            if self.global_engine is not None:
                self.global_engine.resume_reconcile()
            if self.federation is not None:
                self.federation.resume()
            if self.tick_loop is not None:
                self.tick_loop.unfreeze()
            self._set_phase(
                PHASE_COMMITTED if out.get("outcome") == "committed"
                else PHASE_ABORTED if out.get("outcome") == "aborted"
                else PHASE_IDLE)

    def _verify(self, expected_live: int) -> tuple:
        """``(state_loss, double_served, parity_errors)`` of the serving
        table against the relayout-time live count."""
        if hasattr(self.engine, "census"):
            return census_counts(self.engine.census(), expected_live)
        items = self.engine.export_items()
        keys = [it["key"] for it in items]
        unique = set(keys)
        loss = max(0, int(expected_live) - len(unique))
        dup = len(keys) - len(unique)
        parity = 0
        if unique and hasattr(self.engine, "routing_parity_errors"):
            parity = int(self.engine.routing_parity_errors(sorted(unique)))
        return loss, dup, parity

    def _journal(self, phase: str, out: dict) -> None:
        if self.transition_log is None:
            return
        try:
            self.transition_log.append(TransitionRecord(
                phase=phase, from_shards=out["from_shards"],
                to_shards=out["to_shards"], epoch=self._epoch))
        except OSError:
            log.warning("transition journal append failed", exc_info=True)

    def _abort(self, out: dict, t0: float, reason: str) -> dict:
        out.update(outcome="aborted", reason=reason)
        log.warning("reshard %d -> %d aborted: %s",
                    out["from_shards"], out["to_shards"], reason)
        return self._finish(out, t0, "aborted")

    def _finish(self, out: dict, t0: float, outcome: str) -> dict:
        out["outcome"] = outcome
        out["duration_s"] = time.monotonic() - t0
        if self.metrics is not None:
            self.metrics.reshard_transitions.labels(result=outcome).inc()
            self.metrics.reshard_duration.labels(result=outcome).observe(
                out["duration_s"])
            self.metrics.reshard_shards.set(
                getattr(self.engine, "n_shards", 1))
        self.last = out
        return out
