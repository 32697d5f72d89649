"""The tick loop: batch accumulation in front of the device engine.

The port's copy of the JAX package's ``service/tickloop``.  Requests
accumulate on the host and flush to the card once per tick: a window
closes when ``batch_limit`` requests wait or ``batch_wait`` has passed
since the first queued one (the reference's peer-batching policy,
``peer_client.go:284-337``), so an idle service adds no latency and a busy
one amortizes the device round trip over the whole window.

Two threads pipeline the ticks: the *dispatch* thread packs window N+1
and queues its device work while the *resolver* thread waits out window
N's D2H (one ``resolve_ticks`` for every window it drains) and completes
the waiters' futures.  ``submit`` / ``submit_columns`` are thread-safe
and return ``concurrent.futures.Future``s.  A reshard transition freezes
admission (:meth:`TickLoop.freeze`): level 1 answers new CLIENT windows
with the retriable reshard shed while PEER windows keep draining, level 2
(the cutover) sheds both; :meth:`TickLoop.quiesce` waits until every
admitted window has resolved.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Sequence

import numpy as np

from gubernator_tpu_torch.admission import (
    CLASS_CLIENT,
    POLICY_FAIL_CLOSED,
    SHED_EXPIRED_MSG,
    SHED_RESHARD_MSG,
    SHED_SHUTDOWN_MSG,
    AdmissionConfig,
    AdmissionQueue,
    AimdLimiter,
    QueueItem,
    under_pressure,
)
from gubernator_tpu_torch.config import env_knob
from gubernator_tpu_torch.ops.engine import resolve_ticks
from gubernator_tpu_torch.ops.reqcols import ReqColumns
from gubernator_tpu_torch.types import (
    RateLimitRequest, RateLimitResponse, Status)
from gubernator_tpu_torch.utils import flightrec

_EMPTY_MATRIX = np.zeros((5, 0), np.int64)

# Dispatched-but-unresolved windows in flight: the resolver drains every
# queued window into one D2H, and the bound is the backpressure (dispatch
# blocks when the device falls behind).  GUBER_TICK_PIPELINE_DEPTH
# overrides; read at construction.
DEFAULT_PIPELINE_DEPTH = 4


def resolve_pipeline_depth(depth=None) -> int:
    """The pipeline depth: an explicit value, else
    GUBER_TICK_PIPELINE_DEPTH, else the default."""
    if depth is not None:
        return max(1, int(depth))
    try:
        return max(1, env_knob(
            "GUBER_TICK_PIPELINE_DEPTH", DEFAULT_PIPELINE_DEPTH, parse=int))
    except ValueError:
        return DEFAULT_PIPELINE_DEPTH


def _complete(fut: Future, result) -> None:
    """set_result tolerating a concurrent cancel (asyncio.wrap_future
    propagates a waiter's cancellation at any moment)."""
    try:
        if not fut.cancelled():
            fut.set_result(result)
    except Exception:  # cancelled between the check and the set
        pass


def _fail_waiters(waiters, exc: Exception) -> None:
    for _, fut in waiters:
        try:
            if not fut.cancelled():
                fut.set_exception(exc)
        except Exception:
            pass


class TickLoop:
    """Accumulates request batches and applies them to an engine per tick."""

    def __init__(
        self,
        engine,
        batch_wait: float = 500e-6,
        batch_limit: int = 1000,
        metrics=None,
        pipeline_depth: int = None,
        admission: AdmissionConfig = None,
        clock=time.monotonic,
    ):
        self.engine = engine
        self.batch_wait = float(batch_wait)
        self.batch_limit = int(batch_limit)
        self.metrics = metrics
        self.pipeline_depth = resolve_pipeline_depth(pipeline_depth)
        # The injected clock drives only deadline math; the batch window
        # stays on real time so a frozen test clock cannot wedge the
        # dispatch thread's timed wait.
        self.admission = (
            admission if admission is not None else AdmissionConfig.from_env())
        self._clock = clock
        self.shed_policy = self.admission.shed_policy
        self.limiter = AimdLimiter(
            self.admission.target_p99_ms, max_limit=self.batch_limit)
        self._queue = AdmissionQueue(
            self.admission.effective_pending_limit(self.batch_limit))
        self.metric_shed_admission = {}  # reason -> shed request count
        self.metric_expired_served = 0  # invariant: stays 0
        # Engine counters already synced into the metric families.
        self._synced = {}
        self._cond = threading.Condition()
        self._pending_count = 0
        self._running = True
        # Reshard admission freeze: level 1 sheds new CLIENT windows with a
        # retriable status while PEER windows keep draining; level 2 (the
        # cutover) sheds both.  Queued work is never dropped by a freeze.
        self._freeze_level = 0
        # Windows popped from the queue and not yet delivered: quiesce()
        # waits for 0 (an empty resolver queue alone races the resolver's
        # item in progress).
        self._inflight_windows = 0
        self._resolve_q: "queue.Queue" = queue.Queue(
            maxsize=self.pipeline_depth)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tick-loop")
        self._resolver = threading.Thread(
            target=self._resolve_loop, daemon=True, name="tick-resolve")
        self._thread.start()
        self._resolver.start()

    def submit(
        self,
        requests: Sequence[RateLimitRequest],
        deadline: float = None,
        klass: int = CLASS_CLIENT,
    ) -> "Future[List[RateLimitResponse]]":
        """Queue a request batch for the next tick.  ``deadline`` is the
        batch's absolute admission deadline on this loop's clock (None:
        never shed); ``klass`` its admission class."""
        return self._enqueue("obj", list(requests), len(requests),
                             deadline, klass)

    def submit_columns(self, cols: ReqColumns, deadline: float = None,
                       klass: int = CLASS_CLIENT) -> "Future":
        """Queue a columnar batch; the future resolves to the
        ``((5, n) matrix, errors)`` pair."""
        return self._enqueue("cols", cols, len(cols), deadline, klass)

    def under_pressure(self) -> bool:
        """True while the overload plane is backing off: the lease tier's
        cue to answer grants with cheap TTL extension instead of full
        decisions (admission.under_pressure)."""
        return under_pressure(
            self.limiter, self._pending_count,
            self.admission.effective_pending_limit(self.batch_limit),
            self.batch_limit)

    def admission_snapshot(self) -> dict:
        """One consistent view of the admission plane for the control
        plane (the autoscaler, /debug/autoscaler): limiter state, queue
        depth, cumulative shed counts, freeze level.  Takes the loop's
        condition briefly, on the controller's cadence, never in a
        tick."""
        with self._cond:
            return {
                "limiter": self.limiter.snapshot(),
                "queue": self._queue.snapshot(),
                "pending": self._pending_count,
                "shed": dict(self.metric_shed_admission),
                "frozen": self._freeze_level > 0,
            }

    def _enqueue(self, kind: str, payload, n: int, deadline: float = None,
                 klass: int = CLASS_CLIENT) -> Future:
        fut: Future = Future()
        if n == 0:
            fut.set_result([] if kind == "obj" else (_EMPTY_MATRIX, {}))
            return fut
        with self._cond:
            if not self._running:
                fut.set_exception(RuntimeError("tick loop is shut down"))
                return fut
            item = QueueItem(kind, payload, n, fut, deadline, klass)
            lvl = self._freeze_level
            if lvl and (lvl >= 2 or klass == CLASS_CLIENT):
                frozen, shed = item, ()
            else:
                frozen = None
                shed = self._queue.push(item)
                self._pending_count = self._queue.requests
                if self.metrics is not None:
                    self.metrics.worker_queue_length.labels(
                        method="GetRateLimits", worker="0"
                    ).set(self._pending_count)
                    self.metrics.admission_queue_depth.set(
                        self._pending_count)
                self._cond.notify()
        if frozen is not None:
            # A frozen window was never queued: it answers the retriable
            # reshard status at once, so its caller retries after the
            # bounded cutover instead of waiting it out.
            self._shed_item(frozen, "reshard")
            return fut
        # Overflow victims are answered outside the lock: they are
        # unlinked already, and answers may release arena leases.
        for victim in shed:
            self._shed_item(victim, "overflow")
        return fut

    def _run(self) -> None:
        while True:
            batch: List[QueueItem] = []
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait()
                if not self._running and not self._queue:
                    break
                # Once something is queued, wait out the tick (or until
                # the batch fills) so more requests coalesce.
                deadline = time.monotonic() + self.batch_wait
                while self._running and self._pending_count < self.batch_limit:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                # The AIMD limiter narrows the admitted width under
                # measured saturation; shutdown drains at full width.
                width = self.batch_limit
                if self._running and self.limiter.enabled:
                    width = min(width, self.limiter.window_limit)
                batch = self._queue.pop_window(width)
                self._pending_count = self._queue.requests
                # In flight from the moment the window leaves the queue:
                # quiesce must see a window inside engine dispatch.
                if batch:
                    self._inflight_windows += 1
            if batch:
                self._flush(batch)
        # The stop sentinel ships outside the condition: the handoff
        # queue is bounded and may park this thread.
        self._resolve_q.put(None)

    def _flush(self, batch: List[QueueItem]) -> None:
        """Dispatch one window: object and columnar submissions each
        coalesce into at most one engine submission; both resolve together
        in one D2H."""
        # Shed what expired before packing: the device never ticks an RPC
        # whose caller has given up (a retriable error, never a drop).
        now = self._clock()
        expired = [it for it in batch if it.expired(now)]
        if expired:
            batch = [it for it in batch if not it.expired(now)]
            for it in expired:
                self._shed_item(it, "expired")
        if not batch:
            self._window_done()
            return
        # The engine notes pack / h2d into the active window.
        fr = flightrec.get()
        wid = None
        if fr is not None:
            wid = fr.begin(sum(it.n for it in batch), self._resolve_q.qsize())
        t0 = time.perf_counter()
        obj_items: List[tuple] = []   # (n, fut)
        reqs: List[RateLimitRequest] = []
        col_parts: List[ReqColumns] = []
        col_items: List[tuple] = []
        for it in batch:
            if it.expired(now):  # invariant counter: the partition regressed
                self.metric_expired_served += it.n
            if it.kind == "cols":
                col_parts.append(it.payload)
                col_items.append((it.n, it.fut))
            else:
                reqs.extend(it.payload)
                obj_items.append((it.n, it.fut))

        subs = []
        if reqs:
            try:
                subs.append(("obj", self.engine.submit(reqs), obj_items,
                             len(reqs)))
            except Exception as e:
                _fail_waiters(obj_items, e)
        if col_parts:
            try:
                subs.append((
                    "cols",
                    self.engine.submit_cols(ReqColumns.concat(col_parts)),
                    col_items,
                    sum(n for n, _ in col_items),
                ))
            except Exception as e:
                _fail_waiters(col_items, e)
            finally:
                # submit_cols packed every column into its own request
                # slab before returning: arena slabs recycle now.
                for p in col_parts:
                    p.release()
        if fr is not None:
            fr.end_dispatch(wid)
        if not subs:
            if fr is not None:
                fr.finish(wid)
            self._window_done()
            return
        # Blocks when pipeline_depth windows are in flight (the device is
        # behind): the backpressure the dispatch thread should feel.  The
        # resolver releases the window's in-flight count.
        self._resolve_q.put((subs, time.perf_counter() - t0, wid))

    def _window_done(self, n: int = 1) -> None:
        """Release ``n`` windows' in-flight count."""
        with self._cond:
            self._inflight_windows = max(0, self._inflight_windows - n)
            self._cond.notify_all()

    def _resolve_loop(self) -> None:
        while True:
            item = self._resolve_q.get()
            if item is None:
                return
            # Every window queued so far resolves with one D2H.
            items = [item]
            stop = False
            while True:
                try:
                    nxt = self._resolve_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                items.append(nxt)
            fr = flightrec.get()
            t_drain = time.perf_counter()
            try:
                resolve_ticks([
                    h
                    for subs, _, _ in items
                    for _, sb, _, _ in subs
                    for h in sb.handles()
                ])
            except Exception:
                pass  # each window's resolution below surfaces the error
            if fr is not None:
                # The drained windows shared one D2H wait; each reports it
                # as its tick time.
                drain_s = time.perf_counter() - t_drain
                for _, _, wid in items:
                    if wid is not None:
                        fr.note(wid, "tick", drain_s)
            for subs, dispatch_s, wid in items:
                for kind, sb, waiters, n_reqs in subs:
                    # Guarded: an exception escaping here would kill the
                    # resolver and wedge the pipeline.
                    try:
                        t1 = time.perf_counter()
                        out = sb.responses() if kind == "obj" else sb.matrix()
                        resolve_s = time.perf_counter() - t1
                        if fr is not None and wid is not None:
                            fr.note(wid, "resolve", resolve_s)
                    except Exception as e:
                        _fail_waiters(waiters, e)
                        continue
                    try:
                        self._deliver(kind, waiters, out, n_reqs,
                                      dispatch_s + resolve_s)
                    except Exception:
                        logging.getLogger("gubernator.tickloop").exception(
                            "tick delivery failed")
                if fr is not None and wid is not None:
                    fr.finish(wid)
            self._window_done(len(items))
            if stop:
                return

    def _deliver(self, kind, waiters, out, n_reqs: int, tick_s: float) -> None:
        """Complete the waiters' futures and sync metrics.  ``tick_s`` is
        the window's own engine time (dispatch + resolve), not the wall
        time since the flush."""
        self._metrics_sync(n_reqs, tick_s)
        off = 0
        if kind == "obj":
            for n, fut in waiters:
                _complete(fut, out[off:off + n])
                off += n
            return
        mat, errors = out
        for n, fut in waiters:
            errs = {
                i - off: msg for i, msg in errors.items()
                if off <= i < off + n
            } if errors else {}
            _complete(fut, (mat[:, off:off + n], errs))
            off += n

    # ------------------------------------------------------------------
    # Reshard admission freeze
    # ------------------------------------------------------------------
    def freeze(self, shed_peers: bool = False) -> None:
        """Stop admitting new windows into the transition: CLIENT
        submissions answer the retriable reshard status at once; PEER
        submissions keep draining until ``shed_peers`` escalates the
        freeze for the cutover itself.  Idempotent; never downgrades an
        escalated freeze."""
        with self._cond:
            self._freeze_level = max(self._freeze_level,
                                     2 if shed_peers else 1)

    def unfreeze(self) -> None:
        with self._cond:
            self._freeze_level = 0
            self._cond.notify_all()

    @property
    def frozen(self) -> bool:
        return self._freeze_level > 0

    def quiesce(self, timeout: float) -> bool:
        """Wait (bounded) until every admitted window has drained: nothing
        queued, nothing inside dispatch, nothing at the resolver.  True
        when that was reached (the cutover's precondition); False when the
        budget ran out with work in flight."""
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            with self._cond:
                idle = (not self._queue and self._pending_count == 0
                        and self._inflight_windows == 0
                        and self._resolve_q.empty())
            if idle:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.001)

    def _shed_item(self, item: QueueItem, reason: str) -> None:
        """Answer one shed submission: expired, shutdown and reshard sheds
        with a retriable per-item error, overflow sheds with the
        degradation policy (fail-open UNDER_LIMIT with full remaining,
        fail-closed OVER_LIMIT with none).  A columnar payload releases
        its arena lease here."""
        self.metric_shed_admission[reason] = (
            self.metric_shed_admission.get(reason, 0) + item.n)
        if self.metrics is not None:
            self.metrics.admission_shed.labels(reason=reason).inc(item.n)
        retriable = reason in ("expired", "shutdown", "reshard")
        msg = {"expired": SHED_EXPIRED_MSG,
               "reshard": SHED_RESHARD_MSG}.get(reason, SHED_SHUTDOWN_MSG)
        if item.kind == "obj":
            if retriable:
                out = [RateLimitResponse(error=msg) for _ in range(item.n)]
            else:
                out = [self._policy_response(r) for r in item.payload]
            _complete(item.fut, out)
            return
        cols = item.payload
        try:
            if retriable:
                mat = np.zeros((5, item.n), np.int64)
                errs = {i: msg for i in range(item.n)}
            else:
                mat = self._policy_matrix(cols, item.n)
                errs = {}
        finally:
            cols.release()
        _complete(item.fut, (mat, errs))

    def _policy_response(self, r: RateLimitRequest) -> RateLimitResponse:
        reset = (getattr(r, "created_at", 0) or 0) + (r.duration or 0)
        if self.shed_policy == POLICY_FAIL_CLOSED:
            return RateLimitResponse(
                status=Status.OVER_LIMIT, limit=r.limit,
                remaining=0, reset_time=reset)
        return RateLimitResponse(
            status=Status.UNDER_LIMIT, limit=r.limit,
            remaining=r.limit, reset_time=reset)

    def _policy_matrix(self, cols: ReqColumns, n: int) -> np.ndarray:
        """Degradation answers for a shed columnar batch (rows: status,
        limit, remaining, reset_time, over_limit)."""
        mat = np.zeros((5, n), np.int64)
        mat[1] = cols.limit
        mat[3] = cols.created_at + cols.duration
        if self.shed_policy == POLICY_FAIL_CLOSED:
            mat[0] = int(Status.OVER_LIMIT)
            mat[4] = 1
        else:
            mat[2] = cols.limit
        return mat

    def _delta(self, name: str, value) -> float:
        """The growth of an engine counter since the last sync."""
        d = value - self._synced.get(name, 0)
        if d > 0:
            self._synced[name] = value
        return d

    def _metrics_sync(self, n_reqs: int, tick_s: float) -> None:
        # Every resolved window's engine time is one AIMD sample.
        self.limiter.record(tick_s * 1000.0)
        if self.metrics is None:
            return
        m = self.metrics
        eng = self.engine
        m.admission_window_limit.set(
            self.limiter.window_limit if self.limiter.enabled
            else self.batch_limit)
        m.admission_queue_depth.set(self._pending_count)
        d = self._delta("expired_served", self.metric_expired_served)
        if d > 0:
            m.admission_expired_served.inc(d)
        m.tick_duration.observe(tick_s)
        m.tick_batch_size.observe(n_reqs)
        m.worker_queue_length.labels(
            method="GetRateLimits", worker="0").set(self._pending_count)
        m.command_counter.labels(
            worker="0", method="GetRateLimits").inc(n_reqs)
        # Engine counters flow as deltas; occupancy levels are set.
        for name, family in (
            ("metric_hits", lambda: m.cache_access_count.labels(type="hit")),
            ("metric_misses",
             lambda: m.cache_access_count.labels(type="miss")),
            ("metric_unexpired_evictions", lambda: m.unexpired_evictions),
            ("metric_cold_hits", lambda: m.cold_hits),
            ("metric_promotions", lambda: m.cold_promotions),
            ("metric_shed_requests", lambda: m.shed_requests),
            ("metric_ssd_hits", lambda: m.ssd_hits),
            ("metric_routed_windows", lambda: m.mesh_routed_windows),
            ("metric_routed_overflows", lambda: m.mesh_routed_overflows),
        ):
            # A labelled series appears only once it has counted.
            d = self._delta(name, getattr(eng, name, 0))
            if d > 0:
                family().inc(d)
        cold = getattr(eng, "cold", None)
        if cold is not None:
            d = self._delta("demotions", cold.metric_demotions)
            if d > 0:
                m.cold_demotions.inc(d)
            m.cold_size.set(len(cold))
        ssd = getattr(eng, "ssd", None)
        if ssd is not None:
            for name, family in (
                ("metric_promotions", m.ssd_promotions),
                ("metric_demotions", m.ssd_demotions),
                ("metric_compactions", m.ssd_compactions),
            ):
                d = self._delta("ssd_" + name, getattr(ssd, name))
                if d > 0:
                    family.inc(d)
            m.ssd_bytes.set(ssd.bytes_used())
            m.ssd_queue_depth.set(ssd.queue_depth())
        if hasattr(eng, "hot_occupancy"):
            m.hot_occupancy.set(eng.hot_occupancy())
        if hasattr(eng, "h2d_overlap_ratio"):
            m.h2d_overlap_ratio.set(eng.h2d_overlap_ratio())

    def _drain_resolve_q(self, err: Exception) -> None:
        """Fail every window still queued for resolution; a drained stop
        sentinel is put back for a resolver that was merely slow."""
        saw_sentinel = False
        while True:
            try:
                item = self._resolve_q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                saw_sentinel = True
                continue
            for _, _, waiters, _ in item[0]:
                _fail_waiters(waiters, err)
        if saw_sentinel:
            self._resolve_q.put(None)

    def close(self) -> None:
        """Shut down: the dispatch thread flushes the backlog (shedding
        what expired) before exiting; if it is wedged, everything still
        queued is answered with a retriable shed instead of abandoned."""
        with self._cond:
            self._running = False
            self._cond.notify()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            with self._cond:
                stuck = self._queue.drain()
                self._pending_count = 0
            for item in stuck:
                self._shed_item(item, "shutdown")
            self._drain_resolve_q(
                RuntimeError("tick loop shut down with requests pending"))
            return
        self._resolver.join(timeout=5)
        if self._resolver.is_alive():
            self._drain_resolve_q(
                RuntimeError("tick loop shut down with requests pending"))
