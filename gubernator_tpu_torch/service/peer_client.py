"""Async peer RPC client with request batching.

The port's copy of the JAX package's ``service/peer_client.py``, the
counterpart of the reference's ``peer_client.go``: one gRPC
connection per peer, an app-level batching queue in front of it (flush at
``batch_limit`` items or ``batch_wait`` after the first enqueue — the same
window policy as ``peer_client.go:284-337``), strict order-preserving
response distribution (``:390-398``), a TTL'd error record feeding
HealthCheck (``:206-235``), and graceful drain on shutdown (``:408-435``).

Differences from the reference are idiomatic, not semantic: goroutine +
channel plumbing becomes one asyncio task per peer; the one-shot interval
timer becomes ``asyncio.wait_for`` deadlines.

Fault tolerance (docs/resilience.md): every client owns a per-peer
circuit breaker (open = fail fast with :class:`BreakerOpenError`, no
dial), consults the optional fault injector before each RPC (chaos
hook), runs its batch loop under a crash supervisor, and drains — never
strands — futures enqueued around shutdown.  The quota-lease RPCs and the
federation envelope RPC send fastwire's raw frames through the same
breaker and fault hook.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import List, Optional, Sequence

import grpc
import grpc.aio

from gubernator_tpu_torch.admission import (
    DEADLINE_METADATA_KEY,
    BudgetExhaustedError,
    batch_deadline,
    budget_header_value,
)
from gubernator_tpu_torch.config import BehaviorConfig, env_knob, parse_duration
from gubernator_tpu_torch.pb import peers_pb2 as peers_pb
from gubernator_tpu_torch.resilience import (
    BreakerOpenError,
    BreakerState,
    CircuitBreaker,
    ResilienceConfig,
    spawn_supervised,
)
from gubernator_tpu_torch.transport import convert, fastwire
from gubernator_tpu_torch.transport.grpc_api import PeersV1Stub
from gubernator_tpu_torch.types import (
    Behavior,
    GlobalUpdate,
    PeerInfo,
    RateLimitRequest,
    RateLimitResponse,
    has_behavior,
)
from gubernator_tpu_torch.utils import tracing

log = logging.getLogger("gubernator.peer_client")


class ErrorRecorder:
    """Recent peer-error strings with TTL expiry (reference keeps a 5-minute
    TTL LRU per peer, peer_client.go:206-235); feeds HealthCheck."""

    def __init__(self, ttl: float = 300.0, cap: int = 100):
        self.ttl = ttl
        self.cap = cap
        self._errs: "collections.OrderedDict[str, float]" = collections.OrderedDict()

    def record(self, msg: str) -> None:
        now = time.monotonic()
        self._errs.pop(msg, None)
        self._errs[msg] = now
        while len(self._errs) > self.cap:
            self._errs.popitem(last=False)

    def errors(self) -> List[str]:
        cutoff = time.monotonic() - self.ttl
        for k in [k for k, t in self._errs.items() if t < cutoff]:
            del self._errs[k]
        return list(self._errs.keys())


class PeerClient:
    """RPC client for one peer, with batched GetPeerRateLimits."""

    def __init__(
        self,
        info: PeerInfo,
        behaviors: Optional[BehaviorConfig] = None,
        channel_credentials: Optional[grpc.ChannelCredentials] = None,
        metrics=None,
        resilience: Optional[ResilienceConfig] = None,
        fault_injector=None,
        clock=time.monotonic,
        self_address: str = "",
    ):
        self._info = info
        # This node's own advertise address: the caller identity handed
        # to the fault injector so directional (asymmetric) schedules can
        # fail one direction of a peer pair only.
        self.self_address = self_address
        self.behaviors = behaviors or BehaviorConfig()
        self.credentials = channel_credentials
        self.metrics = metrics
        # Deadline propagation (docs/overload.md): RPC timeouts derive
        # from the forwarded request's remaining budget, floored so a
        # nearly-spent budget still gets one real attempt on the wire.
        self._clock = clock
        try:
            self.timeout_floor = env_knob(
                "GUBER_PEER_TIMEOUT_FLOOR", 0.05, parse=parse_duration)
        except ValueError:
            self.timeout_floor = 0.05
        self.last_errs = ErrorRecorder()
        self.resilience = resilience or ResilienceConfig()
        self.faults = fault_injector
        rc = self.resilience
        self.breaker = CircuitBreaker(
            failure_threshold=rc.breaker_failure_threshold,
            min_requests=rc.breaker_min_requests,
            window=rc.breaker_window,
            open_for=rc.breaker_open_for,
            open_cap=rc.breaker_open_cap,
            half_open_probes=rc.breaker_half_open_probes,
            enabled=rc.breaker_enabled,
            clock=clock,
            on_transition=self._on_breaker_transition,
            name=info.grpc_address,
        )
        if self.metrics is not None:
            self.metrics.breaker_state.labels(
                peerAddr=info.grpc_address
            ).set(int(BreakerState.CLOSED))
        self._channel: Optional[grpc.aio.Channel] = None
        self._stub: Optional[PeersV1Stub] = None
        self._queue: Optional[asyncio.Queue] = None
        self._batch_task: Optional[asyncio.Task] = None
        self._inflight: set = set()
        self._closed = False

    def _on_breaker_transition(
        self, old: BreakerState, new: BreakerState
    ) -> None:
        log.info(
            "peer %s circuit breaker: %s -> %s",
            self._info.grpc_address, old.name, new.name,
        )
        if self.metrics is not None:
            addr = self._info.grpc_address
            self.metrics.breaker_state.labels(peerAddr=addr).set(int(new))
            self.metrics.breaker_transitions.labels(
                peerAddr=addr, to=new.name.lower()
            ).inc()

    # `info` is attribute-or-callable in pickers; plain attribute here.
    @property
    def info(self) -> PeerInfo:
        return self._info

    def _ensure_channel(self) -> PeersV1Stub:
        if self._stub is None:
            if self.credentials is not None:
                self._channel = grpc.aio.secure_channel(
                    self._info.grpc_address, self.credentials
                )
            else:
                self._channel = grpc.aio.insecure_channel(self._info.grpc_address)
            self._stub = PeersV1Stub(self._channel)
        return self._stub

    def _ensure_batch_loop(self) -> asyncio.Queue:
        if self._queue is None:
            self._queue = asyncio.Queue(maxsize=1000)  # peer_client.go:87
            # Supervised: a crashed batch loop restarts (after failing the
            # batch it was holding) instead of leaving every subsequent
            # enqueue hanging forever.
            self._batch_task = spawn_supervised(
                self._batch_loop,
                name=f"peer-batch:{self._info.grpc_address}",
                should_restart=lambda: not self._closed,
                metrics=self.metrics,
                loop_label="peer_batch",
            )
        return self._queue

    # ------------------------------------------------------------------
    # Public surface
    # ------------------------------------------------------------------
    async def get_peer_rate_limit(self, req: RateLimitRequest) -> RateLimitResponse:
        """Forward one request to this peer, batching unless the request or
        config opts out (peer_client.go:125-161).

        The caller's trace context rides inside the request metadata (W3C
        traceparent, peer_client.go:140-141/359-360) — injected here, while
        the caller's span is still current, because the batched send happens
        later on the batch-loop task where the ambient context is gone."""
        if self._closed:
            raise RuntimeError("peer client is shut down")
        if self.breaker.is_open():
            # Fail fast without riding the batch window: the breaker
            # already knows this peer is down (non-consuming check — the
            # half-open probe slot belongs to the RPC layer).
            raise BreakerOpenError(
                f"circuit breaker open for peer {self._info.grpc_address}"
            )
        tracing.inject(req.metadata)
        if (
            has_behavior(req.behavior, Behavior.NO_BATCHING)
            or self.behaviors.disable_batching
        ):
            resp = await self.get_peer_rate_limits([req])
            return resp[0]
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        q = self._ensure_batch_loop()
        if self.metrics is not None:
            self.metrics.batch_queue_length.labels(
                peerAddr=self._info.grpc_address
            ).set(q.qsize())
        await q.put((req, fut))
        return await fut

    def rpc_budget(
        self, reqs: Sequence[RateLimitRequest]
    ) -> tuple:
        """(RPC timeout, ``guber-deadline-ms`` header value) for one
        forwarded batch: the earliest propagated remaining budget,
        floored by GUBER_PEER_TIMEOUT_FLOOR (a nearly-spent budget still
        gets one real wire attempt) and capped by ``batch_timeout``.  No
        propagated deadline → the fixed ``batch_timeout`` and no header.
        Raises :class:`BudgetExhaustedError` when the budget is already
        spent — the RPC must not be attempted at all."""
        deadline = batch_deadline(reqs)
        if deadline is None:
            return self.behaviors.batch_timeout, None
        now = self._clock()
        remaining = deadline - now
        if remaining <= 0:
            raise BudgetExhaustedError(
                "caller budget spent before forwarding to "
                f"{self._info.grpc_address}"
            )
        timeout = min(
            self.behaviors.batch_timeout,
            max(remaining, self.timeout_floor),
        )
        return timeout, budget_header_value(deadline, now)

    async def get_peer_rate_limits(
        self, reqs: Sequence[RateLimitRequest]
    ) -> List[RateLimitResponse]:
        """One unbatched GetPeerRateLimits RPC; responses in request order."""
        addr = self._info.grpc_address
        timeout, budget = self.rpc_budget(reqs)
        if not self.breaker.allow():
            msg_ = f"circuit breaker open for peer {addr}"
            self.last_errs.record(msg_)
            raise BreakerOpenError(msg_)
        stub = self._ensure_channel()
        msg = peers_pb.GetPeerRateLimitsReq(
            requests=[convert.req_to_pb(r) for r in reqs]
        )
        # gRPC-level trace header for the server interceptor; per-request
        # metadata already carries each caller's own context.  The
        # remaining deadline budget rides along so the peer's admission
        # plane sheds what this caller can no longer wait for.
        hdrs: dict = {}
        tracing.inject(hdrs)
        if budget is not None:
            hdrs[DEADLINE_METADATA_KEY] = budget
        try:
            if self.faults is not None:
                await self.faults.before_rpc(
                    addr, "GetPeerRateLimits", from_peer=self.self_address)
            out = await stub.GetPeerRateLimits(
                msg,
                timeout=timeout,
                metadata=tuple(hdrs.items()) or None,
            )
        except grpc.aio.AioRpcError as e:
            self.breaker.record_failure()
            self.last_errs.record(
                f"while fetching rate limits from peer "
                f"{addr}: {e.details()}"
            )
            raise
        self.breaker.record_success()
        if len(out.rate_limits) != len(reqs):
            raise RuntimeError(
                "server responded with incorrect rate limit list size"
            )
        return [convert.resp_from_pb(r) for r in out.rate_limits]

    async def update_peer_globals(self, updates: Sequence[GlobalUpdate]) -> None:
        """Push authoritative GLOBAL state to this peer."""
        addr = self._info.grpc_address
        if not self.breaker.allow():
            msg_ = f"circuit breaker open for peer {addr}"
            self.last_errs.record(msg_)
            raise BreakerOpenError(msg_)
        stub = self._ensure_channel()
        msg = peers_pb.UpdatePeerGlobalsReq()
        for u in updates:
            g = msg.globals.add()
            g.key = u.key
            g.algorithm = u.algorithm
            g.duration = u.duration
            g.created_at = u.created_at
            g.status.CopyFrom(convert.resp_to_pb(u.status))
        try:
            if self.faults is not None:
                await self.faults.before_rpc(
                    addr, "UpdatePeerGlobals", from_peer=self.self_address)
            await stub.UpdatePeerGlobals(msg, timeout=self.behaviors.global_timeout)
        except grpc.aio.AioRpcError as e:
            self.breaker.record_failure()
            self.last_errs.record(
                f"while updating peer globals on {addr}: "
                f"{e.details()}"
            )
            raise
        self.breaker.record_success()

    async def _raw_call(self, method: str, frame: bytes, what: str,
                          timeout: Optional[float] = None):
        """One breaker-gated raw-bytes call of a V1 lease or federation
        method on this peer's channel (both services share the peer's
        port), under ``timeout`` (the batch timeout when unset): an open
        breaker raises :class:`BreakerOpenError` (the client's LeaseCache
        answers it by extending its held lease locally, docs/leases.md;
        the federation channel by retrying the same envelope); an RPC
        error is recorded against the breaker and raised."""
        addr = self._info.grpc_address
        if not self.breaker.allow():
            msg_ = f"circuit breaker open for peer {addr}"
            self.last_errs.record(msg_)
            raise BreakerOpenError(msg_)
        self._ensure_channel()
        rpc = self._channel.unary_unary(
            f"/pb.gubernator.V1/{method}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        try:
            if self.faults is not None:
                await self.faults.before_rpc(
                    addr, method, from_peer=self.self_address)
            out = await rpc(
                frame, timeout=timeout or self.behaviors.batch_timeout)
        except grpc.aio.AioRpcError as e:
            self.breaker.record_failure()
            self.last_errs.record(f"while {what} peer {addr}: {e.details()}")
            raise
        self.breaker.record_success()
        return out

    async def lease_grant(self, specs):
        """Request quota leases from this peer (the key owner)."""
        out = await self._raw_call(
            "LeaseGrant", fastwire.encode_lease_grant_req(list(specs)),
            "granting leases from")
        tokens = fastwire.parse_lease_grant_resp(out)
        if tokens is None:
            raise RuntimeError("malformed LeaseGrant response frame")
        return tokens

    async def lease_sync(self, syncs):
        """Report lease consumption to this peer (the key owner)."""
        out = await self._raw_call(
            "LeaseSync", fastwire.encode_lease_sync_req(list(syncs)),
            "syncing leases to")
        acks = fastwire.parse_lease_sync_resp(out)
        if acks is None:
            raise RuntimeError("malformed LeaseSync response frame")
        return acks

    async def federation_sync(self, env, timeout: Optional[float] = None):
        """Ship one federation envelope to this peer (the key owner in a
        *remote* region) and return its FederationAck.  Breaker-gated
        like every peer RPC: the sender routes a region's keys to one
        owning peer per flush, so the per-region breaker is this peer's
        (docs/federation.md)."""
        out = await self._raw_call(
            "FederationSync", fastwire.encode_federation_envelope(env),
            "federating to", timeout=timeout)
        ack = fastwire.parse_federation_ack(out)
        if ack is None:
            raise RuntimeError("malformed FederationSync response frame")
        return ack

    def get_last_err(self) -> List[str]:
        return self.last_errs.errors()

    # ------------------------------------------------------------------
    # Batch loop
    # ------------------------------------------------------------------
    async def _batch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            item = await self._queue.get()
            if item is None:
                # Shutdown sentinel: anything enqueued after it raced the
                # close — fail those waiters instead of stranding them.
                self._fail_queued("peer client is shut down")
                return
            batch = [item]
            try:
                deadline = loop.time() + self.behaviors.batch_wait
                while len(batch) < self.behaviors.batch_limit:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        nxt = await asyncio.wait_for(self._queue.get(), timeout)
                    except asyncio.TimeoutError:
                        break
                    if nxt is None:
                        await self._send_batch(batch)
                        self._fail_queued("peer client is shut down")
                        return
                    batch.append(nxt)
            except Exception as e:
                # Window assembly crashed: fail this batch's waiters and
                # keep serving — never die holding futures.
                log.exception(
                    "peer %s batch window crashed", self._info.grpc_address
                )
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            # Send concurrently so the window keeps filling during the RPC.
            t = asyncio.create_task(self._send_batch(batch))
            self._inflight.add(t)
            t.add_done_callback(self._inflight.discard)

    def _fail_queued(self, msg: str) -> None:
        """Drain the batch queue, failing every waiter with ``msg``."""
        while self._queue is not None and not self._queue.empty():
            item = self._queue.get_nowait()
            if item is None:
                continue
            _, fut = item
            if not fut.done():
                fut.set_exception(RuntimeError(msg))

    async def _send_batch(self, batch: List[tuple]) -> None:
        """One RPC for the whole window; distribute ordered responses, or
        fail every waiter (peer_client.go:341-404).  Span parity:
        peer_client.go:351 sendBatch."""
        t0 = time.perf_counter()
        reqs = [r for r, _ in batch]
        try:
            # root=True: this runs on the batch-loop task, whose ambient
            # context is whatever request first created the loop — per-item
            # trace continuity rides the request metadata instead.
            with tracing.maybe_span(
                "PeerClient.sendBatch",
                {"batch.size": len(batch),
                 "peer": self._info.grpc_address},
                root=True,
            ):
                out = await self.get_peer_rate_limits(reqs)
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            return
        finally:
            if self.metrics is not None:
                self.metrics.batch_send_duration.labels(
                    peerAddr=self._info.grpc_address
                ).observe(time.perf_counter() - t0)
        for (_, fut), resp in zip(batch, out):
            if not fut.done():
                fut.set_result(resp)

    async def shutdown(self) -> None:
        """Drain queued/in-flight work, then close the channel
        (peer_client.go:408-435)."""
        self._closed = True
        if self._queue is not None:
            await self._queue.put(None)
        if self._batch_task is not None:
            try:
                await asyncio.wait_for(self._batch_task, self.behaviors.batch_timeout)
            except asyncio.TimeoutError:
                self._batch_task.cancel()
        if self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)
        # Stragglers that enqueued between the sentinel drain and the batch
        # task exiting (or after a cancel) must not hang forever.
        self._fail_queued("peer client is shut down")
        if self._channel is not None:
            await self._channel.close()
