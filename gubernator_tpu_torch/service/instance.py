"""V1Instance: one standalone node's request handling.

The port's copy of the JAX package's ``service/instance`` for a node with
no peers (reference ``gubernator.go:183-295``): every key is local, so a
GetRateLimits batch is validated, stamped and submitted to the
:class:`TickLoop` as one window's worth of work.  A GLOBAL item is
answered from local state, as the reference's standalone node answers
it; the GLOBAL manager, forwarding, peer clients and the hash ring belong
to the cluster, which is not ported yet (``set_peers`` accepts only this
node's own entry, what discovery ``none`` installs).

Create the instance inside a running event loop (as the reference's,
``instance.py:270``), or through :meth:`V1Instance.create`, which also
restores a Loader's or the snapshot directory's state.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from gubernator_tpu_torch.admission import (
    CLASS_CLIENT,
    CLASS_PEER,
    batch_deadline,
)
from gubernator_tpu_torch.algos import algorithm_error, invalid_algorithm_mask
from gubernator_tpu_torch.config import BehaviorConfig, Config, env_knob
from gubernator_tpu_torch.ops.engine import masked_over_limit
from gubernator_tpu_torch.ops.reqcols import ColumnArena, ReqColumns
from gubernator_tpu_torch.service.tickloop import TickLoop
from gubernator_tpu_torch.types import (
    ALGORITHM_MAX,
    MAX_BATCH_SIZE,
    Algorithm,
    Behavior,
    GlobalUpdate,
    HealthCheckResponse,
    PeerInfo,
    RateLimitRequest,
    RateLimitResponse,
    Status,
    has_behavior,
    set_behavior,
)
from gubernator_tpu_torch.utils import timeutil, tracing
from gubernator_tpu_torch.utils.metrics import Metrics

log = logging.getLogger("gubernator.instance")


class BatchTooLargeError(ValueError):
    """Maps to gRPC OutOfRange at the transport edge (gubernator.go:189-193)."""


@dataclass
class InstanceConfig:
    """Wiring for one V1Instance (reference Config, config.go:73-123)."""

    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    cache_size: int = 50_000
    advertise_address: str = ""          # this node's own grpc address
    tpu_max_batch: int = 4096
    tpu_mesh_shards: int = 0             # 0: TickEngine; N > 1: the mesh
    tpu_platform: str = ""               # "" / "cuda": the card; "cpu"
    tpu_bg_reclaim: str = "auto"
    cold_cache_size: int = 0
    ssd_dir: str = ""
    ssd_capacity_bytes: int = 1 << 30
    ssd_compact_ratio: float = 0.5
    ssd_queue_depth: int = 8
    snapshot_dir: str = ""
    snapshot_interval: float = 5.0
    snapshot_deltas_per_base: int = 64
    loader: Optional[object] = None
    store: Optional[object] = None
    metrics: Optional[Metrics] = None

    @classmethod
    def from_config(cls, conf: Config, advertise_address: str = "", **kw):
        return cls(
            behaviors=conf.behaviors,
            cache_size=conf.cache_size,
            advertise_address=advertise_address,
            tpu_max_batch=conf.tpu_max_batch,
            tpu_mesh_shards=conf.tpu_mesh_shards,
            tpu_platform=conf.tpu_platform,
            tpu_bg_reclaim=conf.tpu_bg_reclaim,
            cold_cache_size=conf.cold_cache_size,
            ssd_dir=conf.ssd_dir,
            ssd_capacity_bytes=conf.ssd_capacity_bytes,
            ssd_compact_ratio=conf.ssd_compact_ratio,
            ssd_queue_depth=conf.ssd_queue_depth,
            snapshot_dir=conf.snapshot_dir,
            snapshot_interval=conf.snapshot_interval,
            snapshot_deltas_per_base=conf.snapshot_deltas_per_base,
            loader=conf.loader,
            store=conf.store,
            **kw,
        )


def _make_engine(conf: InstanceConfig):
    """The port's engine for ``conf``: a ``TickEngine`` with the tiers, or
    with ``tpu_mesh_shards > 1`` a ``MeshTickEngine``.  ``tpu_platform``
    "" means the card (raising when there is none), "cpu" the plain
    versions."""
    device = conf.tpu_platform or None
    if conf.tpu_mesh_shards > 1:
        from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine

        for knob, value in (("a Store", conf.store),
                            ("GUBER_COLD_CACHE_SIZE", conf.cold_cache_size),
                            ("GUBER_SSD_DIR", conf.ssd_dir)):
            if value:
                raise ValueError(
                    f"{knob} with the sharded mesh engine "
                    "(GUBER_TPU_MESH_SHARDS > 1) is not ported yet "
                    "(ROADMAP A.5)")
        n = conf.tpu_mesh_shards
        return MeshTickEngine(
            n_shards=n, local_capacity=max(1, conf.cache_size // n),
            max_batch=conf.tpu_max_batch, device=device)
    from gubernator_tpu_torch.ops.engine import TickEngine

    ssd = None
    if conf.ssd_dir and conf.cold_cache_size > 0:
        from gubernator_tpu_torch.tiering import SsdStore

        ssd = SsdStore(
            conf.ssd_dir,
            capacity_bytes=conf.ssd_capacity_bytes,
            compact_ratio=conf.ssd_compact_ratio,
            queue_depth=conf.ssd_queue_depth,
            metrics=conf.metrics,
        )
    return TickEngine(
        capacity=conf.cache_size,
        max_batch=conf.tpu_max_batch,
        device=device,
        store=conf.store,
        bg_reclaim={"auto": None, "on": True, "off": False}[
            conf.tpu_bg_reclaim],
        cold_capacity=conf.cold_cache_size,
        ssd=ssd,
    )


class V1Instance:
    """One standalone service instance: engine + tick loop + ingest arena."""

    def __init__(self, conf: InstanceConfig, engine=None):
        asyncio.get_running_loop()  # created inside a running event loop
        self.conf = conf
        self.log = log
        self.metrics = conf.metrics or Metrics()
        self.engine = engine if engine is not None else _make_engine(conf)
        # The window fills to the device width unless the operator set
        # GUBER_BATCH_LIMIT: several callers' batches coalesce into one
        # tick.
        window_limit = (
            conf.behaviors.batch_limit if conf.behaviors.batch_limit_set
            else conf.tpu_max_batch)
        self.tick_loop = TickLoop(
            self.engine,
            batch_wait=conf.behaviors.batch_wait,
            batch_limit=window_limit,
            metrics=self.metrics,
        )
        # Wire decode lands in these preallocated slabs; the tick loop
        # releases each once the engine has packed it.  Slab count covers
        # the pipeline depth plus decode concurrency (0: off).
        try:
            slabs = env_knob("GUBER_INGEST_ARENA_SLABS", 8, parse=int)
        except ValueError:
            slabs = 8
        try:
            fallback_limit = env_knob(
                "GUBER_INGEST_FALLBACK_LIMIT", 32, parse=int)
        except ValueError:
            fallback_limit = 32
        self.ingest_arena = (
            ColumnArena(MAX_BATCH_SIZE, slabs=slabs,
                        fallback_limit=fallback_limit)
            if slabs > 0 else None)
        self._peers: List[PeerInfo] = []
        self._snapshot_writer = None
        self.restore_stats: dict = {}
        self._closed = False

    @classmethod
    async def create(cls, conf: InstanceConfig, engine=None) -> "V1Instance":
        inst = cls(conf, engine)
        if conf.loader is not None:
            if hasattr(conf.loader, "load_columns"):
                snap = conf.loader.load_columns()
                if snap is not None:
                    inst.engine.load_columns(snap)
            else:
                inst.engine.load_items(list(conf.loader.load()))
        if conf.snapshot_dir:
            await inst._start_persistence()
        return inst

    async def _start_persistence(self) -> None:
        """Restore base + deltas from the snapshot directory (corrupt tails
        are counted, never fatal), then start the delta-flush loop.  Runs
        before the daemon reports ready."""
        from gubernator_tpu_torch.persistence import (
            SnapshotStore, SnapshotWriter)

        store = SnapshotStore(self.conf.snapshot_dir)
        loop = asyncio.get_running_loop()
        result = await loop.run_in_executor(None, store.load)
        for snap in result.snapshots:
            await loop.run_in_executor(None, self.engine.load_columns, snap)
        self.restore_stats = {
            "generation": result.generation,
            "restored_items": result.items,
            "delta_records": result.delta_records,
            "corrupt_records": result.corrupt_records,
            "manifest_missing": result.manifest_missing,
        }
        if result.corrupt_records:
            self.metrics.snapshot_corrupt_records.inc(result.corrupt_records)
            self.log.warning(
                "snapshot restore skipped %d corrupt/truncated records "
                "(kept the last good prefix)", result.corrupt_records)
        if result.items:
            self.metrics.snapshot_restored_items.inc(result.items)
            self.log.info(
                "restored %d bucket rows from %s (generation %d, %d "
                "delta records)", result.items, self.conf.snapshot_dir,
                result.generation, result.delta_records)
        self._snapshot_writer = SnapshotWriter(
            self.engine, store,
            interval=self.conf.snapshot_interval,
            deltas_per_base=self.conf.snapshot_deltas_per_base,
            metrics=self.metrics,
        )
        self._snapshot_writer.start()

    # ------------------------------------------------------------------
    # Public API: GetRateLimits
    # ------------------------------------------------------------------
    def _too_large(self, n: int, what: str) -> None:
        if n > MAX_BATCH_SIZE:
            self.metrics.check_error_counter.labels(
                error="Request too large").inc()
            raise BatchTooLargeError(
                f"{what} list too large; max size is '{MAX_BATCH_SIZE}'")

    async def get_rate_limits(
        self, requests: Sequence[RateLimitRequest]
    ) -> List[RateLimitResponse]:
        """Responses in request order (gubernator.go:183-295)."""
        self._too_large(len(requests), "Requests.RateLimits")
        self.metrics.concurrent_checks.inc()
        t0 = time.perf_counter()
        try:
            with tracing.maybe_span(
                "V1Instance.GetRateLimits", {"batch.size": len(requests)}
            ):
                return await self._get_rate_limits(requests)
        finally:
            self.metrics.concurrent_checks.dec()
            self.metrics.func_duration.labels(
                name="V1Instance.GetRateLimits"
            ).observe(time.perf_counter() - t0)

    def _invalid(self, req: RateLimitRequest) -> Optional[str]:
        """The per-item validation error of ``req``, if any."""
        if req.unique_key == "":
            return "field 'unique_key' cannot be empty"
        if req.name == "":
            return "field 'namespace' cannot be empty"
        if invalid_algorithm_mask(int(req.algorithm)):
            return algorithm_error(req.algorithm)
        if has_behavior(req.behavior, Behavior.MULTI_REGION):
            return ("Behavior.MULTI_REGION requires GUBER_DATA_CENTER and "
                    "GUBER_FEDERATION_ENABLED on this node")
        return None

    async def _get_rate_limits(
        self, requests: Sequence[RateLimitRequest]
    ) -> List[RateLimitResponse]:
        created_at = timeutil.now_ms()
        out: List[Optional[RateLimitResponse]] = [None] * len(requests)
        local_idx: List[int] = []
        for i, req in enumerate(requests):
            err = self._invalid(req)
            if err is not None:
                self.metrics.check_error_counter.labels(
                    error="Invalid request").inc()
                out[i] = RateLimitResponse(error=err)
                continue
            if req.created_at is None or req.created_at == 0:
                req.created_at = created_at
            if self.conf.behaviors.force_global:
                req.behavior = set_behavior(req.behavior, Behavior.GLOBAL,
                                            True)
            local_idx.append(i)
        if local_idx:
            resps = await self._submit_local(
                [requests[i] for i in local_idx])
            for i, resp in zip(local_idx, resps):
                out[i] = resp
        return out  # type: ignore[return-value]

    def columns_fast_path_ok(self) -> bool:
        """Whether GetRateLimits may run wire -> columns -> device with no
        request objects: no server-forced GLOBAL and no Store (whose
        read-through takes request objects).  The transport takes the
        object path for a batch with GLOBAL items, metadata or per-item
        errors."""
        return (not self.conf.behaviors.force_global
                and self.conf.store is None)

    async def get_rate_limits_columns(self, cols: ReqColumns,
                                      deadline: float = None):
        """Columnar GetRateLimits: ``((5, n) matrix, errors)`` in request
        order; ``deadline`` is the batch's absolute admission deadline."""
        self._too_large(len(cols), "Requests.RateLimits")
        return await self._columns_tick(cols, deadline=deadline)

    async def _columns_tick(self, cols: ReqColumns, public: bool = True,
                            deadline: float = None):
        """One tick-loop submission of a columnar batch, with metrics.
        ``public`` marks the GetRateLimits edge (the concurrent-checks
        gauge and its duration family; the client admission class); the
        peer edge outranks client traffic under overload."""
        if public:
            self.metrics.concurrent_checks.inc()
        t0 = time.perf_counter()
        try:
            mat, errors = await asyncio.wrap_future(
                self.tick_loop.submit_columns(
                    cols, deadline=deadline,
                    klass=CLASS_CLIENT if public else CLASS_PEER))
            self.metrics.getratelimit_counter.labels(calltype="local").inc(
                len(cols) - len(errors))
            self._count_algorithms(cols.algorithm)
            over = masked_over_limit(mat, errors)
            if over:
                self.metrics.over_limit_counter.inc(over)
            return mat, errors
        finally:
            dt = time.perf_counter() - t0
            if public:
                self.metrics.concurrent_checks.dec()
                self.metrics.func_duration.labels(
                    name="V1Instance.GetRateLimits").observe(dt)
            self.metrics.func_duration.labels(
                name="V1Instance.getLocalRateLimit").observe(dt)

    async def _submit_local(self, reqs: List[RateLimitRequest],
                            klass: int = CLASS_CLIENT
                            ) -> List[RateLimitResponse]:
        """One tick-loop submission of an object batch, with metrics; the
        batch inherits its most urgent member's deadline."""
        t0 = time.perf_counter()
        resps = await asyncio.wrap_future(self.tick_loop.submit(
            reqs, deadline=batch_deadline(reqs), klass=klass))
        self.metrics.func_duration.labels(
            name="V1Instance.getLocalRateLimit"
        ).observe(time.perf_counter() - t0)
        self._count_algorithms([r.algorithm for r in reqs])
        for resp in resps:
            self.metrics.getratelimit_counter.labels(calltype="local").inc()
            if resp.status == Status.OVER_LIMIT:
                self.metrics.over_limit_counter.inc()
        return resps

    def _count_algorithms(self, algorithms) -> None:
        """Per-algorithm traffic split (gubernator_tpu_algorithm_requests);
        out-of-range values were rejected at the edge."""
        a = np.asarray(algorithms, np.int64)
        ok = (a >= 0) & (a <= int(ALGORITHM_MAX))
        counts = np.bincount(a[ok], minlength=int(ALGORITHM_MAX) + 1)
        for v, c in enumerate(counts):
            if c:
                self.metrics.algorithm_requests.labels(
                    algorithm=Algorithm(v).name.lower()).inc(int(c))

    # ------------------------------------------------------------------
    # Peer API (PeersV1)
    # ------------------------------------------------------------------
    async def get_peer_rate_limits_columns(self, cols: ReqColumns,
                                           deadline: float = None):
        """Columnar handling of a relayed batch (peer admission class)."""
        self._too_large(len(cols), "'PeerRequest.rate_limits'")
        return await self._columns_tick(cols, public=False,
                                        deadline=deadline)

    async def get_peer_rate_limits(
        self, requests: Sequence[RateLimitRequest]
    ) -> List[RateLimitResponse]:
        """Relayed batches (gubernator.go:462-539): forwarded GLOBAL hits
        get DRAIN_OVER_LIMIT, and each request's W3C trace context in its
        metadata is continued."""
        self._too_large(len(requests), "'PeerRequest.rate_limits'")
        created_at = timeutil.now_ms()
        tracer = tracing.get_tracer()
        traced = tracing.enabled()
        spans = []
        for req in requests:
            remote = tracing.extract(req.metadata) if traced else None
            if remote is not None:
                spans.append(tracer.start_detached(
                    "PeersV1.GetPeerRateLimit",
                    {"ratelimit.key": req.unique_key,
                     "ratelimit.name": req.name},
                    parent=remote))
            if has_behavior(req.behavior, Behavior.GLOBAL):
                req.behavior = set_behavior(
                    req.behavior, Behavior.DRAIN_OVER_LIMIT, True)
            if req.created_at is None or req.created_at == 0:
                req.created_at = created_at
        try:
            return await self._submit_local(list(requests), klass=CLASS_PEER)
        finally:
            for s in spans:
                tracer.finish(s)

    async def update_peer_globals(self, updates: Sequence[GlobalUpdate]) -> None:
        """Install owner-pushed GLOBAL state (gubernator.go:425-459), off
        the event loop (it is device work)."""
        await asyncio.get_running_loop().run_in_executor(
            None, self.engine.install_globals, list(updates))

    # ------------------------------------------------------------------
    # Health / peers
    # ------------------------------------------------------------------
    def health_check(self) -> HealthCheckResponse:
        """A standalone node has no peer errors to report."""
        return HealthCheckResponse(status="healthy", message="",
                                   peer_count=len(self._peers))

    def occupancy(self) -> dict:
        """Tier occupancy: device-table fill, cold size, shed count."""
        eng = self.engine
        return {
            "cache_size": eng.cache_size(),
            "hot_occupancy": round(
                getattr(eng, "hot_occupancy", lambda: 0.0)(), 4),
            "cold_size": getattr(eng, "cold_size", lambda: 0)(),
            "shed_requests": getattr(eng, "metric_shed_requests", 0),
        }

    def set_peers(self, peer_info: Sequence[PeerInfo]) -> None:
        """Install the peer set: only this node's own entry (what discovery
        ``none`` installs), marked owner.  Any other peer raises."""
        others = [p.grpc_address for p in peer_info
                  if p.grpc_address != self.conf.advertise_address]
        if others:
            raise ValueError(
                f"clustered mode is not ported yet: peers {others} besides "
                f"this node ({self.conf.advertise_address!r})")
        self._peers = [
            PeerInfo(grpc_address=p.grpc_address,
                     http_address=p.http_address,
                     datacenter=p.datacenter, is_owner=True)
            for p in peer_info]

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    async def close(self) -> None:
        """Shutdown: the final full snapshot base (or Loader save), then
        the tick loop and the engine."""
        if self._closed:
            return
        self._closed = True
        if self._snapshot_writer is not None:
            await self._snapshot_writer.close(final_base=True)
        if self.conf.loader is not None:
            if hasattr(self.conf.loader, "save_columns"):
                self.conf.loader.save_columns(self.engine.export_columns())
            else:
                self.conf.loader.save(self.engine.export_items())
        self.tick_loop.close()
        if hasattr(self.engine, "close"):
            self.engine.close()
        self.metrics.cache_size.set(self.engine.cache_size())
