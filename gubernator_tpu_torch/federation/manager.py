"""Inter-region bounded-staleness reconcile: the federation sender/receiver.

The port's copy of the JAX package's ``federation/manager``.  An applied
envelope is an ordinary peer batch: ``get_peer_rate_limits`` ticks it on
this node's engine (one fused-tick launch a window of unique keys) and
queues the intra-region broadcast.

Two-level GLOBAL topology (docs/federation.md): intra-region stays the
existing GlobalManager psum-native reconcile untouched; this manager is
the *inter*-region half.  The intra-region owner of a GLOBAL key — the
one node in its region that sees every hit for it (non-owners forward
theirs through the hits loop) — feeds each owner-side state change here
(:meth:`queue`); deltas accumulate per remote region and per key, and a
supervised loop flushes them every ``GUBER_FEDERATION_INTERVAL`` as
:class:`~gubernator_tpu_torch.federation.envelope.FederationEnvelope` frames
to the owning peer of each key in the remote region's own ring
(RegionPicker — the sender computes remote ownership locally because
every region runs the same hash).

No client request ever waits on a cross-region RPC: requests are
answered from region-local state (the degraded-answer discipline of the
resilience path absorbs WAN latency/partitions), so region isolation degrades to
bounded local over-admission — at most ``federation_interval ×
local_rate`` hits drift per region — and never to an outage.

Delivery rides the resilience machinery: the target peer's circuit breaker
(one owning peer per region per flush, so the per-region breaker IS
that peer's breaker), decorrelated-jitter backoff between retries, and
a merge-on-requeue pending buffer bounded by ``GUBER_REDELIVERY_LIMIT``
distinct keys.  Exactly-once comes from the channel discipline: at most
one envelope is in flight per (this node → target peer) channel, a
failed send retries the *same* envelope (same seq, same records), and
new deltas merge into pending for the next seq — paired with the
receiver's :class:`~gubernator_tpu_torch.federation.envelope.ReceiveLedger`
duplicate gate, a partition heals by replaying the buffer with zero
hit loss and zero double-counts.
"""

from __future__ import annotations

import asyncio
import logging
import secrets
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from gubernator_tpu_torch.federation.envelope import (
    FederationAck,
    FederationEnvelope,
    FederationRecord,
    ReceiveLedger,
    merge_records,
)
from gubernator_tpu_torch.resilience import (
    DecorrelatedJitterBackoff,
    spawn_supervised,
)
from gubernator_tpu_torch.types import (
    MAX_BATCH_SIZE,
    Behavior,
    RateLimitRequest,
    set_behavior,
)

log = logging.getLogger("gubernator.federation")

# Metadata key stamped on federation-applied requests: the receive path
# submits them through the normal owner handler (which re-broadcasts
# intra-region), and GlobalManager's federation feed skips requests
# carrying it — without the tag, region A's hits applied in B would
# federate back to A (and to every third region the origin already
# reached directly), double-counting on each lap.
FED_ORIGIN_KEY = "fed-origin"


@dataclass
class _Channel:
    """One (this node → remote owning peer) envelope stream."""

    peer: object
    region: str
    seq: int = 0                    # last assigned sequence
    inflight: Optional[FederationEnvelope] = None
    inflight_since: float = 0.0
    failing: bool = False           # last send attempt failed
    sending: bool = False           # an RPC is awaiting right now
    orphaned: bool = False          # dropped from the ring mid-send
    next_try: float = 0.0
    backoff: DecorrelatedJitterBackoff = field(
        default=None)  # type: ignore[assignment]


class FederationManager:
    """Owns the inter-region exchange for one V1Instance."""

    def __init__(self, instance, metrics=None, clock=time.monotonic,
                 sleep=asyncio.sleep, epoch: str = ""):
        self.instance = instance
        self.metrics = metrics
        self._clock = clock
        self._sleep = sleep
        conf = instance.conf
        self.home = conf.data_center
        self.interval = conf.federation_interval
        self.batch_limit = conf.federation_batch_limit
        self.timeout = conf.federation_timeout
        self.resilience = conf.resilience
        # Boot nonce: receivers key their ReceiveLedger by (origin,
        # epoch), so a restart of this node (same advertise address,
        # seq back at 1) opens a fresh channel instead of having its
        # envelopes dropped as duplicates of the previous incarnation.
        self.epoch = epoch or secrets.token_hex(8)
        # region → key → accumulated delta (merge-on-requeue buffer).
        self._pending: Dict[str, Dict[str, FederationRecord]] = {}
        # region → enqueue time of the oldest un-flushed delta.
        self._pending_since: Dict[str, float] = {}
        # target grpc address → channel.
        self._channels: Dict[str, _Channel] = {}
        # Channels dropped by a ring update while their RPC was still
        # awaiting: the address is quarantined from _compact until the
        # RPC settles, so a peer that leaves and instantly rejoins can't
        # get a second concurrent envelope racing the orphaned one.
        self._orphans: Dict[str, _Channel] = {}
        # target grpc address → last assigned seq, retained across
        # channel drop/recreate (ring churn): the receiver's ledger for
        # this (origin, epoch) survives the churn, so a recreated
        # channel to the same address must continue the sequence, not
        # restart at 1 and be deduplicated into oblivion.
        self._seqs: Dict[str, int] = {}
        self.ledger = ReceiveLedger()
        # One apply at a time per origin channel: a redelivery racing a
        # still-running slow apply of the same envelope must wait and
        # then read the marked ledger (duplicate), not start a second
        # apply off the not-yet-marked one.
        self._apply_locks: Dict[str, asyncio.Lock] = {}
        # Reshard interlock: while True, no envelope is compacted or
        # sent (the ReshardCoordinator pauses sends for FREEZE→CUTOVER
        # so no envelope snapshots half-relayouted owner state; deltas
        # keep accumulating in _pending and flush after resume()).
        self._paused = False
        self._running = True
        self._task = spawn_supervised(
            self._flush_loop, name="federation-flush",
            should_restart=lambda: self._running,
            metrics=metrics, loop_label="federation_flush",
        )

    @property
    def origin(self) -> str:
        """This node's channel identity: its advertise address."""
        return self.instance.conf.advertise_address

    # ------------------------------------------------------------------
    # Sender side
    # ------------------------------------------------------------------
    def queue(self, req: RateLimitRequest) -> None:
        """Record one owner-side GLOBAL state change for every remote
        region.  Called from GlobalManager.queue_update — the one place
        every hit in this region funnels through exactly once."""
        if req.hits == 0:
            return
        if req.metadata.get(FED_ORIGIN_KEY):
            return  # applied FROM a peer region; never re-federate
        try:
            regions = self.instance.region_picker.regions()
        except Exception:
            return
        limit = self.resilience.redelivery_limit
        now = self._clock()
        dropped_total = 0
        for region in regions:
            if not region or region == self.home:
                continue
            pending = self._pending.setdefault(region, {})
            if not pending:
                self._pending_since[region] = now
            rec = FederationRecord(
                name=req.name, unique_key=req.unique_key, hits=req.hits,
                limit=req.limit, duration=req.duration,
                algorithm=int(req.algorithm), behavior=int(req.behavior),
                burst=req.burst, created_at=req.created_at or 0,
            )
            _, dropped = merge_records(pending, [rec], limit)
            dropped_total += dropped
        if dropped_total:
            # Never silent: a full pending buffer under a long partition
            # means this key's drift will NOT heal on rejoin.
            log.warning(
                "federation pending buffer full (GUBER_REDELIVERY_LIMIT"
                "=%d keys): dropped %d new-key records", limit,
                dropped_total,
            )

    async def _flush_loop(self) -> None:
        while self._running:
            await self._sleep(self.interval)
            if not self._running:
                return
            await self._flush_once()
            self._update_staleness()

    def pause(self) -> None:
        """Stop compacting/sending envelopes (reshard FREEZE→CUTOVER).
        Queued deltas keep merging into ``_pending``; nothing is lost.
        Called from the coordinator's executor thread — a plain bool
        flip read by the flush loop is the whole protocol (same shape
        as MeshGlobalEngine.pause_reconcile)."""
        self._paused = True

    def resume(self) -> None:
        """Re-enable envelope flushes after reshard commit/abort; the
        next flush tick drains everything accumulated under the pause."""
        self._paused = False

    async def _flush_once(self, force_retry: bool = False) -> None:
        """Compact pending deltas into envelopes on idle channels, then
        send every due envelope concurrently.  A pause() (reshard
        cutover in flight) gates the whole flush — including the
        force_retry final flush, which is safe because the coordinator's
        finally block always resumes before the instance closes."""
        if self._paused:
            return
        for region, pending in self._pending.items():
            if not pending:
                continue
            self._compact(region, pending)
            if not pending:
                self._pending_since.pop(region, None)
        now = self._clock()
        due = [
            ch for ch in self._channels.values()
            if ch.inflight is not None and (force_retry or now >= ch.next_try)
        ]
        if due:
            await asyncio.gather(*(self._send(ch) for ch in due))

    def _compact(self, region: str,
                 pending: Dict[str, FederationRecord]) -> None:
        """Route pending keys to their remote-region owners and build the
        next envelope on every channel without one in flight.  Keys whose
        channel is busy (or whose region has no reachable ring yet) stay
        pending — merge-on-requeue keeps accumulating their hits."""
        groups: Dict[str, tuple] = {}
        for key in pending:
            try:
                peer = self.instance.region_picker.get(key, region)
            except Exception:
                return  # no ring for the region yet; keep everything
            addr = peer.info.grpc_address
            if addr in groups:
                groups[addr][1].append(key)
            else:
                groups[addr] = (peer, [key])
        for addr, (peer, keys) in groups.items():
            if addr in self._orphans:
                continue  # quarantined until the orphaned RPC settles
            ch = self._channels.get(addr)
            if ch is None:
                rc = self.resilience
                ch = self._channels[addr] = _Channel(
                    peer=peer, region=region,
                    seq=self._seqs.get(addr, 0),
                    backoff=DecorrelatedJitterBackoff(
                        rc.forward_backoff_base, rc.forward_backoff_cap),
                )
            ch.peer = peer  # ring churn may swap the handle
            if ch.inflight is not None:
                continue
            take = keys[: self.batch_limit]
            ch.seq += 1
            self._seqs[addr] = ch.seq
            ch.inflight = FederationEnvelope(
                origin=self.origin, region=self.home, epoch=self.epoch,
                seq=ch.seq,
                records=[pending.pop(k) for k in take],
            )
            ch.inflight_since = self._clock()

    async def _send(self, ch: _Channel) -> None:
        env = ch.inflight
        ch.sending = True
        try:
            ack = await ch.peer.federation_sync(env, timeout=self.timeout)
        except asyncio.CancelledError:
            raise
        except Exception:
            # BreakerOpenError / AioRpcError / malformed-frame — all the
            # same to the channel: the envelope stays in flight and
            # retries with the SAME seq after a jittered backoff.  The
            # receiver's ledger makes the retry safe even when only the
            # ack was lost.
            self._send_failed(ch)
            return
        finally:
            ch.sending = False
        if ack.seq < env.seq:
            # A stale ack (buggy or mixed-version receiver) is a failed
            # delivery, not limbo: without backoff the envelope would
            # retry every interval with the channel reported healthy.
            self._send_failed(ch)
            return
        ch.inflight = None
        ch.inflight_since = 0.0
        ch.failing = False
        ch.next_try = 0.0
        ch.backoff.reset()
        if ch.orphaned:
            self._release_orphan(ch)
        if self.metrics is not None:
            self.metrics.federation_envelopes.labels(result="sent").inc()

    def _send_failed(self, ch: _Channel) -> None:
        if ch.orphaned:
            # The target left the ring while this RPC was awaiting; the
            # channel is already out of the table, so the decision the
            # reroute deferred lands here: the peer never applied the
            # envelope, requeue its records for the new owner.
            self._requeue_inflight(ch)
            self._release_orphan(ch)
            return
        ch.failing = True
        ch.next_try = self._clock() + ch.backoff.next()
        if self.metrics is not None:
            self.metrics.federation_redeliveries.inc()

    def on_ring_update(self) -> None:
        """Reroute after ``set_peers``: drop channels whose target
        address left its region's ring, requeueing any in-flight records
        into the pending buffer so the next compact rehashes them to the
        new owner.  Without this, an envelope pinned to a departed peer
        retries that dead address forever — its records never reach the
        key's new owner, and the channel's failing flag holds
        :meth:`is_degraded` true and the staleness gauge climbing for
        a peer that no longer exists."""
        pickers = self.instance.region_picker.pickers()
        for addr, ch in list(self._channels.items()):
            ring = pickers.get(ch.region)
            if ring is not None and ring.get_by_address(addr) is not None:
                continue
            del self._channels[addr]
            if ch.sending:
                # An RPC to the departed peer is awaiting right now — it
                # may yet succeed (graceful drain acks in flight), so
                # requeueing here could double-deliver.  Defer: _send's
                # completion either finishes the envelope (delivered,
                # nothing to do) or requeues on failure; until then the
                # address is quarantined from _compact.
                ch.orphaned = True
                self._orphans[addr] = ch
                continue
            self._requeue_inflight(ch)

    def _release_orphan(self, ch: _Channel) -> None:
        addr = getattr(ch.peer.info, "grpc_address", "")
        if self._orphans.get(addr) is ch:
            del self._orphans[addr]

    def _requeue_inflight(self, ch: _Channel) -> None:
        """Fold a dropped channel's in-flight records back into its
        region's pending buffer so the next compact rehashes them."""
        env = ch.inflight
        requeued_at = ch.inflight_since or self._clock()
        ch.inflight = None
        ch.inflight_since = 0.0
        if env is None or not env.records:
            return
        pending = self._pending.setdefault(ch.region, {})
        since = self._pending_since.get(ch.region)
        self._pending_since[ch.region] = (
            requeued_at if since is None else min(since, requeued_at))
        _, dropped = merge_records(
            pending, env.records, self.resilience.redelivery_limit)
        if dropped:
            log.warning(
                "federation reroute of %s (left the %s ring) dropped "
                "%d new-key records: pending buffer full",
                getattr(ch.peer.info, "grpc_address", "?"), ch.region,
                dropped,
            )

    def _update_staleness(self) -> None:
        """Export the worst-case cross-region drift age: the oldest delta
        not yet acked by its target region (pending or in flight)."""
        if self.metrics is None:
            return
        now = self._clock()
        oldest = None
        for ts in self._pending_since.values():
            oldest = ts if oldest is None else min(oldest, ts)
        for ch in self._channels.values():
            if ch.inflight is not None and ch.inflight_since:
                ts = ch.inflight_since
                oldest = ts if oldest is None else min(oldest, ts)
        self.metrics.federation_staleness.set(
            max(0.0, now - oldest) if oldest is not None else 0.0)

    def is_degraded(self) -> bool:
        """True while any remote region is unreachable (its channel's
        breaker is open or its last send failed): MULTI_REGION answers
        served now may over-admit up to the staleness budget."""
        for ch in self._channels.values():
            if ch.failing:
                return True
            breaker = getattr(ch.peer, "breaker", None)
            if breaker is not None and breaker.is_open():
                return True
        return False

    # ------------------------------------------------------------------
    # Receiver side
    # ------------------------------------------------------------------
    async def receive(self, env: FederationEnvelope) -> FederationAck:
        """Apply one envelope from a peer region and ack it.

        Duplicates (a redelivery whose ack was lost) are acked without
        re-applying; a failed apply leaves the ledger unmarked so the
        sender's retry of the same seq lands the records.

        Cancellation-shielded: the sender's RPC deadline cancels the
        transport handler, but an apply that already committed hits to
        the engine MUST still mark the ledger — cancelling between the
        two would turn every slow apply (e.g. a first-use JIT compile)
        into a double-count when the same envelope is redelivered."""
        return await asyncio.shield(self._receive_inner(env))

    async def _receive_inner(self, env: FederationEnvelope) -> FederationAck:
        lock = self._apply_locks.setdefault(env.origin, asyncio.Lock())
        async with lock:
            return await self._apply_locked(env)

    async def _apply_locked(self, env: FederationEnvelope) -> FederationAck:
        if self.ledger.seen(env):
            if self.metrics is not None:
                self.metrics.federation_envelopes.labels(
                    result="duplicate").inc()
            return FederationAck(origin=env.origin, seq=env.seq, applied=0)
        reqs: List[RateLimitRequest] = []
        for rec in env.records:
            reqs.append(RateLimitRequest(
                name=rec.name,
                unique_key=rec.unique_key,
                hits=rec.hits,
                limit=rec.limit,
                duration=rec.duration,
                algorithm=rec.algorithm,
                behavior=set_behavior(rec.behavior, Behavior.GLOBAL, True),
                burst=rec.burst,
                metadata={FED_ORIGIN_KEY: env.region},
                created_at=rec.created_at or None,
            ))
        # The owner-relay handler: forces DRAIN_OVER_LIMIT on GLOBAL
        # hits, applies to the local engine, and queues the intra-
        # region broadcast — the remote region's hits reach every
        # local peer through the existing machinery.  Chunked at
        # MAX_BATCH_SIZE: the handler rejects larger batches outright,
        # which would turn an oversized envelope (mixed-version or
        # misconfigured sender) into a poison message retried forever.
        for i in range(0, len(reqs), MAX_BATCH_SIZE):
            await self.instance.get_peer_rate_limits(
                reqs[i:i + MAX_BATCH_SIZE])
        self.ledger.mark(env)
        if self.metrics is not None:
            self.metrics.federation_envelopes.labels(result="applied").inc()
        return FederationAck(
            origin=env.origin, seq=env.seq, applied=len(reqs))

    # ------------------------------------------------------------------
    # Introspection / shutdown
    # ------------------------------------------------------------------
    def pending_keys(self) -> int:
        return sum(len(p) for p in self._pending.values())

    def inflight_envelopes(self) -> int:
        return sum(
            1 for ch in self._channels.values() if ch.inflight is not None)

    async def _final_flush(self) -> None:
        """Bounded drain rounds through the normal flush path, retrying
        immediately (no backoff waits — the caller's deadline is the
        budget)."""
        for _ in range(4):
            if not (self.pending_keys() or self.inflight_envelopes()):
                return
            await self._flush_once(force_retry=True)

    async def close(self, drain_timeout: float = 0.0) -> None:
        """Stop the flush loop, then (graceful-drain path) push what's
        still buffered under a bounded deadline."""
        self._running = False
        self._task.cancel()
        await asyncio.gather(self._task, return_exceptions=True)
        if drain_timeout > 0 and (
                self.pending_keys() or self.inflight_envelopes()):
            try:
                await asyncio.wait_for(self._final_flush(), drain_timeout)
            except asyncio.TimeoutError:
                log.warning(
                    "federation drain deadline (%.1fs) expired with %d "
                    "pending keys / %d in-flight envelopes",
                    drain_timeout, self.pending_keys(),
                    self.inflight_envelopes(),
                )
            except Exception:
                log.exception("federation drain flush failed")
        self._update_staleness()
