"""GLOBAL-behavior reconciliation: async hit forwarding + owner broadcasts.

The port's copy of the JAX package's ``service/global_manager.py``, the
eventually-consistent half of the system (reference ``global.go``):

* **Hits loop** — non-owner peers answer GLOBAL limits from local state and
  queue the observed hits here; hits aggregate per key (sum ``hits``, OR in
  RESET_REMAINING, ``global.go:99-112``) and flush to the owning peers when
  ``global_batch_limit`` distinct keys accumulate or ``global_sync_wait``
  elapses, grouped per owner, fan-out bounded by
  ``global_peer_requests_concurrency`` (``global.go:144-187``).
* **Broadcast loop** — the owner queues every GLOBAL state change; per
  flush it re-reads current state with ``hits=0`` (a pure query through the
  kernel, ``global.go:241-249``) and pushes authoritative
  :class:`GlobalUpdate` records to every other peer (``global.go:234-283``).

Both loops are asyncio tasks on the daemon's event loop; enqueueing is a
plain dict update (the event loop serializes access, playing the role of
the reference's channel).

Unlike the reference — which drops a failed flush on the floor — failed
sends and broadcasts merge back into a bounded redelivery buffer and
retry each sync window (docs/resilience.md), and both loops run under a
crash supervisor that restarts them instead of letting reconciliation
die silently.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional

from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.resilience import ResilienceConfig, spawn_supervised
from gubernator_tpu_torch.utils import tracing
from gubernator_tpu_torch.types import (
    Behavior,
    GlobalUpdate,
    RateLimitRequest,
    has_behavior,
    set_behavior,
)

log = logging.getLogger("gubernator.global")


class GlobalManager:
    """Owns the two reconciliation loops for one V1Instance."""

    def __init__(self, instance, behaviors: BehaviorConfig, metrics=None,
                 resilience: Optional[ResilienceConfig] = None):
        self.instance = instance
        self.conf = behaviors
        self.metrics = metrics
        self.resilience = resilience or ResilienceConfig()
        self._hits: Dict[str, RateLimitRequest] = {}
        self._updates: Dict[str, RateLimitRequest] = {}
        # The inter-region federation feed: installed by V1Instance with
        # federation on; every owner-side update queued here also feeds
        # the per-region envelope buffers.
        self.federation = None
        # GLOBAL keys this node has answered as owner, key → prototype
        # request (algorithm/limit/duration — what a state re-read
        # needs).  The ownership-handoff working set: after a ring swap,
        # keys here whose new owner is a different peer get their
        # accumulated state pushed to that peer (transfer_ownership).
        # Bounded by the redelivery cap like the other buffers.
        self._owned: Dict[str, RateLimitRequest] = {}
        self._hits_kick = asyncio.Event()
        self._updates_kick = asyncio.Event()
        self._running = True
        # Supervised: a crashed loop logs, counts a restart, and comes
        # back — a silently dead hits loop would stop reconciliation
        # forever while requests keep answering from stale local state.
        self._tasks = [
            spawn_supervised(
                self._hits_loop, name="global-hits",
                should_restart=lambda: self._running,
                metrics=metrics, loop_label="global_hits",
            ),
            spawn_supervised(
                self._broadcast_loop, name="global-broadcast",
                should_restart=lambda: self._running,
                metrics=metrics, loop_label="global_broadcast",
            ),
        ]

    # ------------------------------------------------------------------
    # Enqueue (called from request handlers on the event loop)
    # ------------------------------------------------------------------
    def queue_hit(self, req: RateLimitRequest) -> None:
        """Record a non-owner hit for async forwarding (global.go:74-78);
        zero-hit queries are not forwarded."""
        if req.hits == 0:
            return
        prev = self._hits.get(req.hash_key())
        if prev is not None:
            if has_behavior(req.behavior, Behavior.RESET_REMAINING):
                prev.behavior = set_behavior(
                    prev.behavior, Behavior.RESET_REMAINING, True
                )
            prev.hits += req.hits
        else:
            clone = RateLimitRequest(**vars(req))
            # The caller was already answered locally — no one is waiting
            # on this flush.  A propagated admission budget must not ride
            # the queued copy: an owner outage longer than the budget
            # would otherwise make every redelivery raise BudgetExhausted
            # before the RPC, and the buffered hits could never land.
            clone.deadline = None
            self._hits[req.hash_key()] = clone
        if self.metrics is not None:
            self.metrics.global_send_queue_length.set(len(self._hits))
        self._hits_kick.set()

    def queue_update(self, req: RateLimitRequest) -> None:
        """Record an owner-side state change for broadcast (global.go:80-84)."""
        if req.hits == 0:
            return
        if self.federation is not None:
            # The one funnel every owner-side GLOBAL hit of the region
            # passes exactly once: the tap of the inter-region delta
            # stream (queue() skips requests applied from a peer region).
            self.federation.queue(req)
        key = req.hash_key()
        # Broadcast and ring-handoff redelivery are post-answer background
        # work: a serving-path admission deadline must not ride the stored
        # copy (queue_hit's rule) — an
        # owner outage longer than the budget would otherwise expire every
        # redelivery before its RPC and the state change could never land.
        clone = RateLimitRequest(**vars(req))
        clone.deadline = None
        self._updates[key] = clone
        if key in self._owned or len(self._owned) < self.resilience.redelivery_limit:
            self._owned[key] = clone
        else:
            # Tracker full (GUBER_REDELIVERY_LIMIT): this key's state will
            # NOT ride a ring-swap handoff.  Never silent — at scale a
            # quietly lossy tracker re-creates the bug the
            # handoff machinery exists to prevent.
            if self.metrics is not None:
                self.metrics.ownership_transfers.labels(
                    result="untracked").inc()
            log.warning(
                "ownership tracker full (%d keys, GUBER_REDELIVERY_LIMIT"
                "=%d): %r will not be handed off on a ring change",
                len(self._owned), self.resilience.redelivery_limit, key,
            )
        if self.metrics is not None:
            self.metrics.global_queue_length.set(len(self._updates))
        self._updates_kick.set()

    # ------------------------------------------------------------------
    # Loops
    # ------------------------------------------------------------------
    async def _window(self, kick: asyncio.Event, queue: Dict) -> None:
        """Wait for the first queued item, then let the window fill until
        the sync interval elapses or the batch limit is reached."""
        await kick.wait()
        deadline = asyncio.get_running_loop().time() + self.conf.global_sync_wait
        while len(queue) < self.conf.global_batch_limit:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                break
            kick.clear()
            try:
                await asyncio.wait_for(kick.wait(), remaining)
            except asyncio.TimeoutError:
                break
        kick.clear()

    async def _hits_loop(self) -> None:
        while self._running:
            await self._window(self._hits_kick, self._hits)
            hits, self._hits = self._hits, {}
            # Gauge from actual dict size, not a hardcoded 0: enqueues
            # racing the swap (and requeues during the flush below) must
            # stay visible.
            if self.metrics is not None:
                self.metrics.global_send_queue_length.set(len(self._hits))
            if hits:
                await self._send_hits(list(hits.values()))
                if self.metrics is not None:
                    self.metrics.global_send_queue_length.set(len(self._hits))

    async def _broadcast_loop(self) -> None:
        while self._running:
            await self._window(self._updates_kick, self._updates)
            updates, self._updates = self._updates, {}
            if self.metrics is not None:
                self.metrics.global_queue_length.set(len(self._updates))
            if updates:
                await self._broadcast(list(updates.values()))
                if self.metrics is not None:
                    self.metrics.global_queue_length.set(len(self._updates))

    async def _send_hits(self, hits: List[RateLimitRequest]) -> None:
        """Group accumulated hits per owning peer and forward
        (global.go:144-187).  Span parity: global.go:91 sendHits scope."""
        t0 = time.perf_counter()
        with tracing.maybe_span("GlobalManager.sendHits", {"count": len(hits)},
                                root=True):
            await self._send_hits_traced(hits)
        if self.metrics is not None:
            self.metrics.global_send_duration.observe(time.perf_counter() - t0)

    async def _send_hits_traced(self, hits: List[RateLimitRequest]) -> None:
        by_owner: Dict[str, tuple] = {}
        local: List[RateLimitRequest] = []
        for r in hits:
            try:
                peer = self.instance.get_peer(r.hash_key())
            except Exception:
                continue
            if peer is None or peer.info.is_owner:
                # Ownership moved to this node between queueing and flush
                # (or we're standalone): the hits must still land — the
                # reference forwards to whatever GetPeer resolves
                # (global.go:153-168), which here is our own peer handler.
                local.append(r)
                continue
            addr = peer.info.grpc_address
            if addr in by_owner:
                by_owner[addr][1].append(r)
            else:
                by_owner[addr] = (peer, [r])
        sem = asyncio.Semaphore(self.conf.global_peer_requests_concurrency)
        limit = self.conf.global_batch_limit

        async def send(peer, reqs):
            # Chunk per RPC: queue_hit can outrun the flush window, and the
            # owner rejects batches over MAX_BATCH_SIZE.
            for i in range(0, len(reqs), limit):
                async with sem:
                    chunk = reqs[i : i + limit]
                    try:
                        await peer.get_peer_rate_limits(chunk)
                    except Exception:
                        # Peer records the error for HealthCheck; the hits
                        # must not vanish — merge them back into the
                        # (bounded) redelivery buffer for the next window.
                        self._requeue_hits(chunk)

        async def apply_self(reqs):
            # Same handler an owner applies to relayed batches: forces
            # DRAIN_OVER_LIMIT on GLOBAL hits and queues the broadcast.
            for i in range(0, len(reqs), limit):
                chunk = reqs[i : i + limit]
                try:
                    await self.instance.get_peer_rate_limits(chunk)
                except Exception:
                    self._requeue_hits(chunk)

        await asyncio.gather(
            *(send(p, reqs) for p, reqs in by_owner.values()),
            *((apply_self(local),) if local else ()),
        )

    def _requeue_hits(self, reqs: List[RateLimitRequest]) -> None:
        """Merge a failed flush chunk back into the hits buffer (the same
        per-key aggregation queue_hit applies), bounded by the redelivery
        cap: beyond it records drop and are counted — memory stays
        bounded even against a peer that never recovers."""
        limit = self.resilience.redelivery_limit
        redelivered = dropped = 0
        for r in reqs:
            k = r.hash_key()
            prev = self._hits.get(k)
            if prev is not None:
                if has_behavior(r.behavior, Behavior.RESET_REMAINING):
                    prev.behavior = set_behavior(
                        prev.behavior, Behavior.RESET_REMAINING, True
                    )
                prev.hits += r.hits
                redelivered += 1
            elif len(self._hits) < limit:
                self._hits[k] = r
                redelivered += 1
            else:
                dropped += 1
        if self.metrics is not None:
            if redelivered:
                self.metrics.global_redelivered_hits.inc(redelivered)
            if dropped:
                self.metrics.global_dropped_hits.inc(dropped)
            self.metrics.global_send_queue_length.set(len(self._hits))
        if dropped:
            log.warning(
                "GLOBAL redelivery buffer full (%d keys): dropped %d hit "
                "records", len(self._hits), dropped,
            )
        if redelivered:
            self._hits_kick.set()  # retry next sync window

    async def _broadcast(self, updates: List[RateLimitRequest]) -> None:
        """Re-read current state (hits=0 query) and push it to every other
        peer (global.go:234-283).  Span parity: global.go:193
        broadcastPeers scope."""
        t0 = time.perf_counter()
        with tracing.maybe_span("GlobalManager.broadcastPeers",
                                {"count": len(updates)}, root=True):
            await self._broadcast_traced(updates)
        if self.metrics is not None:
            self.metrics.broadcast_duration.observe(time.perf_counter() - t0)

    async def _broadcast_traced(self, updates: List[RateLimitRequest]) -> None:
        queries = []
        for u in updates:
            q = RateLimitRequest(**vars(u))
            q.hits = 0
            queries.append(q)
        statuses = await self.instance.apply_local(queries)
        globals_: List[GlobalUpdate] = []
        for u, st in zip(updates, statuses):
            if st.error:
                continue
            globals_.append(
                GlobalUpdate(
                    key=u.hash_key(),
                    status=st,
                    algorithm=u.algorithm,
                    duration=u.duration,
                    created_at=u.created_at or 0,
                )
            )
        if not globals_:
            return
        sem = asyncio.Semaphore(self.conf.global_peer_requests_concurrency)
        limit = self.conf.global_batch_limit
        by_key = {u.hash_key(): u for u in updates}
        failed_keys: set = set()

        async def push(peer):
            for i in range(0, len(globals_), limit):
                async with sem:
                    chunk = globals_[i : i + limit]
                    try:
                        await peer.update_peer_globals(chunk)
                    except Exception:
                        # Requeue the source updates: the next flush
                        # re-reads current state and re-pushes to every
                        # peer (idempotent — authoritative state install).
                        failed_keys.update(g.key for g in chunk)

        peers = [
            p for p in self.instance.get_peer_list() if not p.info.is_owner
        ]
        await asyncio.gather(*(push(p) for p in peers))
        if failed_keys:
            self._requeue_updates(
                [by_key[k] for k in failed_keys if k in by_key]
            )

    def _requeue_updates(self, reqs: List[RateLimitRequest]) -> None:
        """Re-enqueue updates whose broadcast failed for some peer, bounded
        by the redelivery cap.  A key already queued again (newer state
        pending) needs nothing — the coming broadcast supersedes this one."""
        limit = self.resilience.redelivery_limit
        redelivered = dropped = 0
        for r in reqs:
            k = r.hash_key()
            if k in self._updates:
                continue
            if len(self._updates) >= limit:
                dropped += 1
                continue
            self._updates[k] = r
            redelivered += 1
        if self.metrics is not None:
            if redelivered:
                self.metrics.global_redelivered_broadcasts.inc(redelivered)
            if dropped:
                self.metrics.global_dropped_broadcasts.inc(dropped)
            self.metrics.global_queue_length.set(len(self._updates))
        if dropped:
            log.warning(
                "GLOBAL broadcast redelivery buffer full (%d keys): "
                "dropped %d update records", len(self._updates), dropped,
            )
        if redelivered:
            self._updates_kick.set()

    # ------------------------------------------------------------------
    # Ownership handoff (ring churn) and graceful drain
    # ------------------------------------------------------------------
    async def transfer_ownership(self) -> int:
        """Push accumulated GLOBAL state to new owners after a ring swap.

        For every tracked owned key whose ``get_peer`` now resolves to a
        *different* peer: re-read current local state (hits=0 query, the
        broadcast's authoritative-read pattern) and install it on the new
        owner via ``UpdatePeerGlobals`` — the key keeps counting from its
        accumulated level instead of resetting (the process-scope twin of
        the tiering fresh-bucket fix).

        Region scoping (docs/federation.md): candidate owners resolve
        through ``get_peer`` — the *local* picker, which ``set_peers``
        builds only from this datacenter's members — never the
        RegionPicker.  GLOBAL state must not be pushed cross-datacenter
        here: remote regions converge through the federation envelope
        stream (bounded staleness, loop-tagged), and a raw
        UpdatePeerGlobals install over the WAN would bypass that
        discipline and double-apply on the next envelope.  A failed push re-enqueues the
        source update into the bounded broadcast redelivery buffer, whose
        next flush re-reads state and pushes to every peer — a slow new
        owner delays the transfer, never loses it.  Returns the number of
        keys pushed."""
        moved: List[tuple] = []  # (key, proto)
        for key in list(self._owned):
            try:
                peer = self.instance.get_peer(key)
            except Exception:
                continue
            if peer is None or peer.info.is_owner:
                continue  # still ours (or standalone)
            moved.append((key, self._owned.pop(key)))
        if not moved:
            return 0
        queries = []
        for _, proto in moved:
            q = RateLimitRequest(**vars(proto))
            q.hits = 0
            q.behavior = set_behavior(q.behavior, Behavior.GLOBAL, False)
            queries.append(q)
        statuses = await self.instance.apply_local(queries)
        by_peer: Dict[str, tuple] = {}
        for (key, proto), st in zip(moved, statuses):
            if st.error:
                continue
            # A bucket answering UNDER with full remaining carries no
            # accumulated state worth shipping — but shipping it is
            # harmless (idempotent install), so no filtering beyond
            # errors: simpler and covers RESET_REMAINING edge states.
            peer = self.instance.get_peer(key)
            if peer is None or peer.info.is_owner:
                continue  # ring moved again mid-read; next swap retries
            upd = GlobalUpdate(
                key=key,
                status=st,
                algorithm=proto.algorithm,
                duration=proto.duration,
                created_at=proto.created_at or 0,
            )
            by_peer.setdefault(
                peer.info.grpc_address, (peer, [], [])
            )
            by_peer[peer.info.grpc_address][1].append(upd)
            by_peer[peer.info.grpc_address][2].append(proto)
        pushed = 0
        limit = self.conf.global_batch_limit

        async def push(peer, updates, protos):
            nonlocal pushed
            for i in range(0, len(updates), limit):
                chunk = updates[i : i + limit]
                try:
                    await peer.update_peer_globals(chunk)
                except Exception:
                    # The new owner is slow/unreachable: the transfer
                    # rides the broadcast redelivery buffer instead of
                    # vanishing — its next flush re-reads and re-pushes.
                    if self.metrics is not None:
                        self.metrics.ownership_transfers.labels(
                            result="requeued"
                        ).inc(len(chunk))
                    self._requeue_updates(protos[i : i + limit])
                    continue
                pushed += len(chunk)
                if self.metrics is not None:
                    self.metrics.ownership_transfers.labels(
                        result="pushed"
                    ).inc(len(chunk))

        await asyncio.gather(
            *(push(p, u, pr) for p, u, pr in by_peer.values())
        )
        if pushed:
            log.info("ring change: transferred %d GLOBAL keys to new "
                     "owners", pushed)
        return pushed

    async def _final_flush(self) -> None:
        """Drain everything still buffered — pending hits, pending/
        redelivery updates — through the normal flush paths.  Failed
        chunks requeue themselves; a few bounded rounds give flapping
        peers a second chance while the caller's deadline caps the total
        (a permanently dead peer exhausts the rounds, not the process)."""
        for _ in range(4):
            if not (self._hits or self._updates):
                return
            hits, self._hits = self._hits, {}
            updates, self._updates = self._updates, {}
            if hits:
                await self._send_hits(list(hits.values()))
            if updates:
                await self._broadcast(list(updates.values()))
            if (len(self._hits) >= len(hits)
                    and len(self._updates) >= len(updates)):
                return  # everything requeued: peers are gone, stop early

    async def close(self, drain_timeout: float = 0.0) -> None:
        """Stop the loops, then (graceful-drain path) flush the GLOBAL
        hit/broadcast/redelivery buffers under a bounded deadline so the
        accounting lands on the owners instead of dying with the process
        — but a dead peer can never wedge shutdown past the budget."""
        self._running = False
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if drain_timeout > 0 and (self._hits or self._updates):
            try:
                await asyncio.wait_for(self._final_flush(), drain_timeout)
            except asyncio.TimeoutError:
                log.warning(
                    "graceful drain deadline (%.1fs) expired with %d hits"
                    " / %d updates unflushed",
                    drain_timeout, len(self._hits), len(self._updates),
                )
            except Exception:
                log.exception("graceful drain flush failed")
