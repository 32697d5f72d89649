"""V1Instance: the request router (ownership decision + 3-way dispatch).

The port's copy of the JAX package's ``service/instance`` (reference
``gubernator.go:183-295``): for every item of a GetRateLimits batch it
decides local (this node owns the key on the consistent-hash ring),
GLOBAL (answer from local state, reconcile in the background through the
:class:`GlobalManager`) or forward (a batched RPC to the owning peer,
retried with decorrelated-jitter backoff and ownership re-resolution,
``gubernator.go:311-391``).  All local work flows through the
:class:`TickLoop`, one device tick a window; the local items of one call
are submitted together.  A node with no peers, or only its own entry
(discovery ``none``), treats every key as local and may take the columns
fast path.

Quota leases (docs/leases.md) are minted and reconciled by the
instance's :class:`LeaseManager` over its engine and tick loop.  With a
mesh-resident GLOBAL engine (``parallel/global_mesh.py``, shared through
``InstanceConfig.global_mesh`` or built from the
``GUBER_TPU_GLOBAL_MESH_*`` knobs) GLOBAL items ride that engine instead
of the gRPC hits and broadcast loops, and a reconcile loop drives it on
the ``GlobalSyncWait`` cadence.  Live resharding runs through the
instance's :class:`ReshardCoordinator` (``parallel/reshard.py``) over its
engine and tick loop, journalled in the snapshot directory, gated by the
peers' breakers, with the GLOBAL mesh's reconcile and the federation
sends paused around the cutover (:meth:`V1Instance.reshard`,
``POST /debug/reshard``).  With ``federation_enabled`` and a data center
a :class:`FederationManager` exchanges owner-side GLOBAL deltas with the
other regions and ``MULTI_REGION`` items ride the GLOBAL path; with
``autoscale_enabled`` an :class:`Autoscaler` drives :meth:`reshard` from
the node's telemetry.  Not ported: the edge plane (its knobs raise in
``config``).

Create the instance inside a running event loop (the GLOBAL manager
starts its loops at once, as the reference's ``NewV1Instance`` does), or
through :meth:`V1Instance.create`, which also restores a Loader's or the
snapshot directory's state.
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
    BudgetExhaustedError,
    batch_deadline,
)
from gubernator_tpu_torch.algos import algorithm_error, invalid_algorithm_mask
from gubernator_tpu_torch.autoscale import (
    Autoscaler,
    AutoscalePolicy,
    PolicyConfig,
    instance_sampler,
)
from gubernator_tpu_torch.config import BehaviorConfig, Config, env_knob
from gubernator_tpu_torch.federation import FederationManager
from gubernator_tpu_torch.leases import LeaseManager
from gubernator_tpu_torch.ops.engine import masked_over_limit
from gubernator_tpu_torch.ops.reqcols import ColumnArena, ReqColumns
from gubernator_tpu_torch.parallel.hashring import (
    HASH_FUNCTIONS,
    RegionPicker,
    ReplicatedConsistentHash,
)
from gubernator_tpu_torch.parallel.reshard import ReshardCoordinator
from gubernator_tpu_torch.persistence import TransitionLog, check_interrupted
from gubernator_tpu_torch.resilience import (
    BreakerOpenError,
    DecorrelatedJitterBackoff,
    ResilienceConfig,
)
from gubernator_tpu_torch.service.global_manager import GlobalManager
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

MESH_ALONE = (
    "GUBER_TPU_GLOBAL_MESH_NODES builds a GLOBAL mesh that lives in this "
    "process alone: its GLOBAL items never reach another daemon, so with "
    "other peers each GLOBAL limit would hold per process. One process "
    "holds every node of the mesh: start the daemons with "
    "Cluster.start(n, global_mesh=True) or Daemon(global_mesh=...)")


class BatchTooLargeError(ValueError):
    """Maps to gRPC OutOfRange at the transport edge (gubernator.go:189-193)."""


@dataclass
class InstanceConfig:
    """Wiring for one V1Instance (reference Config, config.go:73-123)."""

    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    cache_size: int = 50_000
    data_center: str = ""
    advertise_address: str = ""          # this node's own grpc address
    picker_hash: str = "fnv1"
    replicas: int = 512
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
    drain_timeout: float = 2.0           # GlobalManager.close's budget
    reshard_freeze_timeout: float = 5.0  # the reshard drain's budget
    reshard_verify: bool = True          # audit the table after a cutover
    # Inter-region federation (federation/): needs data_center.
    federation_enabled: bool = False
    federation_interval: float = 1.0
    federation_batch_limit: int = 1000
    federation_timeout: float = 1.0
    # The shard autoscaler (autoscale/), started by create().
    autoscale_enabled: bool = False
    autoscale_interval: float = 10.0
    autoscale_windows: int = 3
    autoscale_target_p99_ms: float = 5.0
    autoscale_queue_high: int = 1000
    autoscale_hysteresis: float = 0.5
    autoscale_occupancy_low: float = 0.3
    autoscale_min_shards: int = 1
    autoscale_max_shards: int = 8
    autoscale_cooldown_up: float = 60.0
    autoscale_cooldown_down: float = 300.0
    autoscale_max_per_hour: int = 4
    autoscale_dry_run: bool = True
    # GLOBAL collectives data plane (parallel/global_mesh.py): a shared
    # MeshGlobalEngine and this node's index on it.  When set, GLOBAL
    # requests bypass the gRPC hits/broadcast loops.
    global_mesh: Optional[object] = None
    global_mesh_node: int = 0
    tpu_global_mesh_nodes: int = 0       # > 0: build an engine at startup
    tpu_global_mesh_node: int = -1       # -1 = auto: 0 (one process)
    tpu_global_mesh_capacity: int = 1 << 16
    loader: Optional[object] = None
    store: Optional[object] = None
    metrics: Optional[Metrics] = None
    # grpc.ChannelCredentials for peer dials (TLS), or None.
    peer_credentials: Optional[object] = None
    # Breaker, backoff and redelivery knobs, and the optional fault
    # injector the peer clients consult before every RPC.
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    fault_injector: Optional[object] = None

    @classmethod
    def from_config(cls, conf: Config, advertise_address: str = "", **kw):
        return cls(
            behaviors=conf.behaviors,
            resilience=conf.resilience,
            fault_injector=conf.fault_injector,
            cache_size=conf.cache_size,
            data_center=conf.data_center,
            advertise_address=advertise_address,
            picker_hash=conf.local_picker_hash,
            replicas=conf.replicas,
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
            drain_timeout=conf.drain_timeout,
            reshard_freeze_timeout=conf.reshard_freeze_timeout,
            reshard_verify=conf.reshard_verify,
            federation_enabled=conf.federation_enabled,
            federation_interval=conf.federation_interval,
            federation_batch_limit=conf.federation_batch_limit,
            federation_timeout=conf.federation_timeout,
            autoscale_enabled=conf.autoscale_enabled,
            autoscale_interval=conf.autoscale_interval,
            autoscale_windows=conf.autoscale_windows,
            autoscale_target_p99_ms=conf.autoscale_target_p99_ms,
            autoscale_queue_high=conf.autoscale_queue_high,
            autoscale_hysteresis=conf.autoscale_hysteresis,
            autoscale_occupancy_low=conf.autoscale_occupancy_low,
            autoscale_min_shards=conf.autoscale_min_shards,
            autoscale_max_shards=conf.autoscale_max_shards,
            autoscale_cooldown_up=conf.autoscale_cooldown_up,
            autoscale_cooldown_down=conf.autoscale_cooldown_down,
            autoscale_max_per_hour=conf.autoscale_max_per_hour,
            autoscale_dry_run=conf.autoscale_dry_run,
            tpu_global_mesh_nodes=conf.tpu_global_mesh_nodes,
            tpu_global_mesh_node=conf.tpu_global_mesh_node,
            tpu_global_mesh_capacity=conf.tpu_global_mesh_capacity,
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

        if conf.cold_cache_size:
            log.warning(
                "GUBER_COLD_CACHE_SIZE is not supported by the sharded "
                "mesh engine yet; tiering disabled")
        if conf.ssd_dir:
            # A hard error, as in setup_daemon_config: a silently absent
            # third tier leaves the deployment without capacity it was
            # sized around.
            raise ValueError(
                "GUBER_SSD_DIR is not supported by the sharded mesh "
                "engine (GUBER_TPU_MESH_SHARDS > 1): the SSD tier "
                "hangs off the single-chip cold store; unset one")
        n = conf.tpu_mesh_shards
        return MeshTickEngine(
            n_shards=n, local_capacity=max(1, conf.cache_size // n),
            max_batch=conf.tpu_max_batch, device=device, store=conf.store)
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
    """One service instance: engine + tick loop + pickers + GLOBAL manager."""

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
        hash_fn = HASH_FUNCTIONS[conf.picker_hash]
        self._standalone = True  # no remote peer installed; see set_peers
        self.local_picker: ReplicatedConsistentHash = (
            ReplicatedConsistentHash(hash_fn, conf.replicas))
        self.region_picker: RegionPicker = RegionPicker(
            hash_fn, conf.replicas)
        self.global_mgr = GlobalManager(
            self, conf.behaviors, self.metrics, resilience=conf.resilience)
        # Inter-region federation: built only with federation on AND a
        # data center (regions are keyed by it); None makes the transport
        # refuse FederationSync and MULTI_REGION items.  Every owner-side
        # GLOBAL update feeds its per-region pending buffers.
        self.federation: Optional[FederationManager] = None
        if conf.federation_enabled and conf.data_center:
            self.federation = FederationManager(self, metrics=self.metrics)
        self.global_mgr.federation = self.federation
        # GLOBAL collectives data plane: the shared engine if one is
        # given, else one built when GUBER_TPU_GLOBAL_MESH_NODES asks.
        self.global_mesh = conf.global_mesh
        # A mesh built from the knobs lives in this process alone: its
        # GLOBAL items never reach another daemon (see set_peers).
        self.owns_global_mesh = (
            self.global_mesh is None and conf.tpu_global_mesh_nodes > 0)
        if self.owns_global_mesh:
            from gubernator_tpu_torch.parallel.global_mesh import (
                MeshGlobalEngine)

            self.global_mesh = MeshGlobalEngine(
                n_nodes=conf.tpu_global_mesh_nodes,
                capacity=conf.tpu_global_mesh_capacity,
                max_batch=conf.tpu_max_batch,
                min_reconcile_ms=int(conf.behaviors.global_sync_wait * 500),
                device=conf.tpu_platform or None)
            if conf.global_mesh_node == 0 and conf.tpu_global_mesh_node != 0:
                # Env-configured: -1 (auto) is node 0, since one process
                # drives the card (the JAX package takes its process
                # index on a multi-host mesh).
                conf.global_mesh_node = max(0, conf.tpu_global_mesh_node)
        self._mesh_task: Optional[asyncio.Task] = None
        if self.global_mesh is not None:
            if not 0 <= conf.global_mesh_node < self.global_mesh.n_nodes:
                raise ValueError(
                    f"global mesh node {conf.global_mesh_node} is outside "
                    f"the mesh's {self.global_mesh.n_nodes} nodes "
                    f"(GUBER_TPU_GLOBAL_MESH_NODE)")
            self._mesh_task = asyncio.get_running_loop().create_task(
                self._mesh_reconcile_loop(), name="global-mesh-reconcile")
        # Doomed-peer shutdowns, ring-change ownership transfers and
        # per-item forwards run as tasks; tracked so close() awaits them
        # and no failure is swallowed with its task.
        self._peer_shutdown_tasks: set = set()
        self._transfer_tasks: set = set()
        self._forward_tasks: set = set()
        # Cooperative quota leases (docs/leases.md): signed TTL-bounded
        # budget delegations, reconciled as batched decisions through the
        # tick loop, degraded to cheap TTL extension under pressure.
        # Always built: with GUBER_LEASE_ENABLED=0 every grant is declined.
        self.lease_mgr = LeaseManager(
            self.engine, tick_loop=self.tick_loop, metrics=self.metrics)
        # Live resharding: the n -> m transition coordinator over this
        # instance's engine and tick loop.  The journal shares the
        # snapshot directory; the peers' breakers gate the cutover; the
        # GLOBAL mesh's reconcile and the federation sends pause around
        # it (no envelope is built from half-relayouted owner state).
        self.reshard_coord = ReshardCoordinator(
            self.engine,
            tick_loop=self.tick_loop,
            transition_log=TransitionLog(conf.snapshot_dir or None),
            breaker_check=lambda: any(
                p.breaker.is_open() for p in self.get_peer_list()),
            global_engine=self.global_mesh,
            federation=self.federation,
            metrics=self.metrics,
            freeze_timeout=conf.reshard_freeze_timeout,
            verify=conf.reshard_verify,
        )
        # The shard autoscaler: built and started by create() when
        # enabled (its loop needs a running event loop); None answers
        # /debug/autoscaler with 404.
        self.autoscaler: Optional[Autoscaler] = None
        self._snapshot_writer = None
        self.restore_stats: dict = {}
        self._closed = False

    @classmethod
    async def create(cls, conf: InstanceConfig, engine=None) -> "V1Instance":
        inst = cls(conf, engine)
        columnar = hasattr(inst.engine, "load_columns")
        if conf.loader is not None:
            if hasattr(conf.loader, "load_columns") and columnar:
                snap = conf.loader.load_columns()
                if snap is not None:
                    inst.engine.load_columns(snap)
            else:
                inst.engine.load_items(list(conf.loader.load()))
        # The snapshot writer drains export_columns: an engine without the
        # columnar snapshot (the mesh) runs without persistence.
        if conf.snapshot_dir and columnar:
            await inst._start_persistence()
        # A begin record with no terminal record: the process died inside
        # a reshard transition.  The state just restored (never written
        # mid-flight) is authoritative; count and clear the journal.
        rec = check_interrupted(inst.reshard_coord.transition_log)
        if rec is not None:
            inst.reshard_coord.record_interrupted(rec)
        if conf.autoscale_enabled:
            inst._start_autoscaler()
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
        """The 3-way dispatch (gubernator.go:183-295); responses in request
        order."""
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
        if (has_behavior(req.behavior, Behavior.MULTI_REGION)
                and self.federation is None):
            # Past this point MULTI_REGION would be a silent no-op bit: a
            # node that cannot federate says so per item.
            return ("Behavior.MULTI_REGION requires GUBER_DATA_CENTER and "
                    "GUBER_FEDERATION_ENABLED on this node")
        return None

    async def _get_rate_limits(
        self, requests: Sequence[RateLimitRequest]
    ) -> List[RateLimitResponse]:
        created_at = timeutil.now_ms()
        out: List[Optional[RateLimitResponse]] = [None] * len(requests)
        local_idx: List[int] = []
        global_idx: List[tuple] = []   # (i, owner_addr)
        forward: List[tuple] = []      # (i, peer, req, key)
        mesh_idx: List[int] = []       # GLOBAL items on the mesh engine
        for i, req in enumerate(requests):
            err = self._invalid(req)
            if err is not None:
                self.metrics.check_error_counter.labels(
                    error="Invalid request").inc()
                out[i] = RateLimitResponse(error=err)
                continue
            if has_behavior(req.behavior, Behavior.MULTI_REGION):
                # MULTI_REGION rides the GLOBAL plane inside the region:
                # a region-local answer now, an envelope later.
                req.behavior = set_behavior(req.behavior, Behavior.GLOBAL,
                                            True)
                if self.federation.is_degraded():
                    # A peer region is unreachable: this answer may
                    # over-admit up to the staleness budget.
                    self.metrics.federation_degraded_answers.inc()
            if req.created_at is None or req.created_at == 0:
                req.created_at = created_at
            if self.conf.behaviors.force_global:
                req.behavior = set_behavior(req.behavior, Behavior.GLOBAL,
                                            True)
            if self.global_mesh is not None and has_behavior(
                    req.behavior, Behavior.GLOBAL):
                # Mesh-resident GLOBAL: ownership is the slot range on the
                # mesh, not the ring; every node answers from its replica
                # and the reconcile loop folds the hits.
                mesh_idx.append(i)
                continue
            key = req.hash_key()
            peer = self.get_peer(key)
            if peer is None or peer.info.is_owner:
                local_idx.append(i)
            elif has_behavior(req.behavior, Behavior.GLOBAL):
                if peer.breaker.is_open():
                    # Degraded GLOBAL mode: the local answer below is the
                    # partition-tolerant one; count it.
                    self.metrics.degraded_answers.inc()
                global_idx.append((i, peer.info.grpc_address))
            else:
                forward.append((i, peer, req, key))

        # Local items: one tick-loop submission for the whole call.
        locals_done = None
        if local_idx:
            locals_done = self._submit_local(
                [requests[i] for i in local_idx], is_owner=True)
        # GLOBAL non-owner items: answer from local state, reconcile later.
        globals_done = None
        if global_idx:
            globals_done = asyncio.ensure_future(
                self._get_global_rate_limits(
                    [requests[i] for i, _ in global_idx]))
        # GLOBAL items on the mesh data plane: one window, no RPC.
        mesh_done = None
        if mesh_idx:
            mesh_reqs = [requests[i] for i in mesh_idx]
            node = self.conf.global_mesh_node
            mesh_done = asyncio.get_running_loop().run_in_executor(
                None, lambda: self.global_mesh.process(mesh_reqs, node))
        # Forwarded items: a tracked task each, with retries.
        fwd_tasks = [self._spawn_forward(peer, req, key)
                     for _, peer, req, key in forward]

        if locals_done is not None:
            for i, resp in zip(local_idx, await locals_done):
                out[i] = resp
        if globals_done is not None:
            for (i, owner), resp in zip(global_idx, await globals_done):
                resp.metadata = {"owner": owner}
                out[i] = resp
        if mesh_done is not None:
            for i, resp in zip(mesh_idx, await mesh_done):
                self.metrics.getratelimit_counter.labels(
                    calltype="global").inc()
                if resp.status == Status.OVER_LIMIT:
                    self.metrics.over_limit_counter.inc()
                out[i] = resp
        for (i, _, _, _), t in zip(forward, fwd_tasks):
            out[i] = await t
        return out  # type: ignore[return-value]

    def columns_fast_path_ok(self) -> bool:
        """Whether GetRateLimits may run wire -> columns -> device with no
        request objects: every key local (no remote peer installed), no
        server-forced GLOBAL and no Store (whose read-through takes
        request objects), and no mesh GLOBAL engine.  The transport takes
        the object path for a batch with GLOBAL items, metadata or
        per-item errors."""
        return (self._standalone
                and self.global_mesh is None
                and not self.conf.behaviors.force_global
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

    def _submit_local(self, reqs: List[RateLimitRequest], *, is_owner: bool,
                      klass: int = CLASS_CLIENT) -> "asyncio.Future":
        """One tick-loop submission of an object batch, with metrics and
        the owner side of GLOBAL (each GLOBAL hit is queued for
        broadcast); the batch inherits its most urgent member's
        deadline."""

        async def run():
            t0 = time.perf_counter()
            resps = await asyncio.wrap_future(self.tick_loop.submit(
                reqs, deadline=batch_deadline(reqs), klass=klass))
            self.metrics.func_duration.labels(
                name="V1Instance.getLocalRateLimit"
            ).observe(time.perf_counter() - t0)
            self._count_algorithms([r.algorithm for r in reqs])
            for req, resp in zip(reqs, resps):
                if has_behavior(req.behavior, Behavior.GLOBAL):
                    self.global_mgr.queue_update(req)
                if is_owner:
                    self.metrics.getratelimit_counter.labels(
                        calltype="local").inc()
                    if resp.status == Status.OVER_LIMIT:
                        self.metrics.over_limit_counter.inc()
            return resps

        return asyncio.ensure_future(run())

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

    async def apply_local(
        self, reqs: List[RateLimitRequest]
    ) -> List[RateLimitResponse]:
        """Apply requests to the local engine with no routing or queueing:
        the GLOBAL manager's state re-read (global.go:241-249), in the
        peer admission class."""
        t0 = time.perf_counter()
        try:
            return await asyncio.wrap_future(self.tick_loop.submit(
                reqs, deadline=batch_deadline(reqs), klass=CLASS_PEER))
        finally:
            self.metrics.func_duration.labels(
                name="V1Instance.getLocalRateLimit"
            ).observe(time.perf_counter() - t0)

    async def _get_global_rate_limits(
        self, reqs: List[RateLimitRequest]
    ) -> List[RateLimitResponse]:
        """Non-owner GLOBAL path (gubernator.go:395-421): answer from local
        state as if this node owned the key, then queue the hits for the
        owner."""
        sp = tracing.current_span()
        if sp is not None:
            sp.add_event("getGlobalRateLimit", {"count": len(reqs)})
        clones = []
        for r in reqs:
            c = RateLimitRequest(**vars(r))
            c.behavior = set_behavior(c.behavior, Behavior.NO_BATCHING, True)
            c.behavior = set_behavior(c.behavior, Behavior.GLOBAL, False)
            clones.append(c)
        resps = await asyncio.wrap_future(self.tick_loop.submit(
            clones, deadline=batch_deadline(clones)))
        for r in reqs:
            self.global_mgr.queue_hit(r)
            self.metrics.getratelimit_counter.labels(calltype="global").inc()
        return resps

    async def _mesh_reconcile_loop(self) -> None:
        """Drive the mesh engine's reconcile on the GlobalSyncWait cadence
        (global.go:193-283's loops, one device step).  Every node on the
        mesh runs this; the engine's min-interval gate collapses
        concurrent callers into one step."""
        loop = asyncio.get_running_loop()
        while not self._closed:
            await asyncio.sleep(self.conf.behaviors.global_sync_wait)
            try:
                await loop.run_in_executor(None, self._mesh_reconcile_once)
            except Exception:
                self.log.exception("global mesh reconcile failed")

    def _mesh_reconcile_once(self) -> None:
        """One cadence tick: reconcile, and export the deltas of the
        engine's step counters that this call made (the engine is shared
        by the nodes on the mesh)."""
        eng = self.global_mesh
        before = (eng.metric_reconcile_dispatches, eng.metric_dense_fallbacks)
        if not eng.maybe_reconcile():
            return
        self.metrics.mesh_reconcile_count.inc()
        self.metrics.mesh_reconcile_dispatches.inc(
            max(0, eng.metric_reconcile_dispatches - before[0]))
        self.metrics.mesh_dense_fallbacks.inc(
            max(0, eng.metric_dense_fallbacks - before[1]))

    def _spawn_forward(self, peer, req: RateLimitRequest,
                       key: str) -> "asyncio.Task":
        """One tracked forward task; its failure is logged on completion,
        so a forward abandoned by an exception earlier in the dispatch is
        never collected mid-flight with a swallowed error."""
        t = asyncio.ensure_future(self._async_request(peer, req, key))
        self._forward_tasks.add(t)

        def _done(task: "asyncio.Task") -> None:
            self._forward_tasks.discard(task)
            if task.cancelled():
                return
            exc = task.exception()
            if exc is not None:
                self.log.warning("forwarded request for %r failed: %s",
                                 key, exc, exc_info=exc)

        t.add_done_callback(_done)
        return t

    async def _async_request(self, peer, req: RateLimitRequest,
                             key: str) -> RateLimitResponse:
        """Forward one item to its owner (gubernator.go:311-391), traced
        as the reference's asyncRequest span."""
        with tracing.maybe_span(
            "V1Instance.asyncRequest",
            {"ratelimit.key": req.unique_key, "ratelimit.name": req.name,
             "peer": peer.info.grpc_address},
        ):
            return await self._async_request_traced(peer, req, key)

    async def _async_request_traced(self, peer, req: RateLimitRequest,
                                    key: str) -> RateLimitResponse:
        """Up to ``forward_max_attempts`` retries with decorrelated-jitter
        backoff, the owner re-resolved before each (and the item applied
        here once ownership moved to this node), the caller's deadline
        budget respected, and a GLOBAL item behind an open breaker
        answered from local state with ``degraded: "true"``.  A failed
        non-GLOBAL forward answers the reference's per-item error; it
        never becomes a local answer."""
        import grpc  # a forward needs a peer, and a peer needs grpc

        rconf = self.conf.resilience
        backoff = None
        attempts = 0
        last_err: Optional[Exception] = None

        async def retry(err: Exception) -> None:
            nonlocal attempts, last_err, peer, backoff
            attempts += 1
            last_err = err
            self.metrics.batch_send_retries.inc()
            if backoff is None:
                # Made on the first retry: its generator seeds itself
                # from the OS, a cost every forwarded item would pay.
                backoff = DecorrelatedJitterBackoff(
                    rconf.forward_backoff_base, rconf.forward_backoff_cap)
            await asyncio.sleep(backoff.next())
            peer = self.get_peer(key) or peer

        while True:
            if attempts > rconf.forward_max_attempts:
                self.metrics.check_error_counter.labels(
                    error="Peer not connected").inc()
                return RateLimitResponse(
                    error=f"GetPeer() keeps returning peers that are not "
                    f"connected for '{key}': {last_err}")
            if (attempts != 0 and req.deadline is not None
                    and time.monotonic() >= req.deadline):
                self.metrics.check_error_counter.labels(
                    error="Deadline exceeded").inc()
                return RateLimitResponse(
                    error=f"deadline budget spent while forwarding "
                    f"'{key}': {last_err}")
            if attempts != 0 and peer.info.is_owner:
                resps = await self._submit_local([req], is_owner=True)
                return resps[0]
            try:
                resp = await peer.get_peer_rate_limit(req)
            except BudgetExhaustedError as e:
                self.metrics.check_error_counter.labels(
                    error="Deadline exceeded").inc()
                return RateLimitResponse(
                    error=f"deadline budget spent while forwarding "
                    f"'{key}': {e}")
            except BreakerOpenError as e:
                if has_behavior(req.behavior, Behavior.GLOBAL):
                    self.metrics.degraded_answers.inc()
                    resp = (await self._get_global_rate_limits([req]))[0]
                    resp.metadata = {"owner": peer.info.grpc_address,
                                     "degraded": "true"}
                    return resp
                await retry(e)
                continue
            except grpc.aio.AioRpcError as e:
                if e.code() in (grpc.StatusCode.DEADLINE_EXCEEDED,
                                grpc.StatusCode.CANCELLED,
                                grpc.StatusCode.UNAVAILABLE):
                    await retry(e)
                    continue
                return RateLimitResponse(
                    error=f"Error while fetching rate limit '{key}' from "
                    f"peer: {e.details()}")
            except Exception as e:
                return RateLimitResponse(
                    error=f"Error while fetching rate limit '{key}' from "
                    f"peer: {e}")
            self.metrics.getratelimit_counter.labels(calltype="forward").inc()
            resp.metadata = {"owner": peer.info.grpc_address}
            return resp

    # ------------------------------------------------------------------
    # Peer API (PeersV1)
    # ------------------------------------------------------------------
    def peer_columns_fast_path_ok(self) -> bool:
        """Whether GetPeerRateLimits may run wire -> columns -> device: a
        relayed batch is processed here whatever the ring says (the
        reference's peer side, gubernator.go:497-536), so unlike the
        public gate this holds on a clustered node; GLOBAL, metadata and
        error batches still take the object path.  Off on a node with a
        mesh GLOBAL engine."""
        return (self.conf.store is None
                and self.global_mesh is None
                and not self.conf.behaviors.force_global)

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
            return await self._submit_local(
                list(requests), is_owner=True, klass=CLASS_PEER)
        finally:
            for s in spans:
                tracer.finish(s)

    async def update_peer_globals(self, updates: Sequence[GlobalUpdate]) -> None:
        """Install owner-pushed GLOBAL state (gubernator.go:425-459), off
        the event loop (it is device work: one row scatter)."""
        await asyncio.get_running_loop().run_in_executor(
            None, self.engine.install_globals, list(updates))

    # ------------------------------------------------------------------
    # Cooperative quota leases (docs/leases.md)
    # ------------------------------------------------------------------
    async def lease_grant(self, specs):
        """Mint quota leases: [LeaseSpec] -> [Optional[LeaseToken]].  A
        grant is an ordinary batched decision through the tick loop
        (UNDER_LIMIT charges the slice up front; OVER_LIMIT declines with
        None)."""
        return await self.lease_mgr.grant(list(specs))

    async def lease_sync(self, syncs):
        """Reconcile lease consumption: [LeaseSync] -> [LeaseSyncAck].
        Credit-backs and excess force-charges go through the tick loop in
        the peer class."""
        return await self.lease_mgr.sync(list(syncs))

    # ------------------------------------------------------------------
    # Live resharding
    # ------------------------------------------------------------------
    async def reshard(self, new_shards: int) -> dict:
        """Run one n -> m transition (``POST /debug/reshard``).  The
        coordinator's freeze, drain and cutover are blocking device and
        lock work, so they run in a worker thread while the event loop
        keeps answering the freeze's retriable sheds.  A transition
        already running answers the coordinator's busy dict.  After a
        committed transition the tracked GLOBAL keys re-broadcast through
        the ownership hand-off, so a peer holding pre-transition state
        converges."""
        result = await asyncio.get_running_loop().run_in_executor(
            None, self.reshard_coord.try_reshard, int(new_shards))
        if result.get("result") == "busy":
            return result
        if result.get("outcome") == "committed" and self.global_mgr._owned:
            t = asyncio.get_running_loop().create_task(
                self.global_mgr.transfer_ownership(),
                name="reshard-ownership-rebroadcast")
            self._transfer_tasks.add(t)
            t.add_done_callback(self._transfer_tasks.discard)
        return result

    def reshard_status(self) -> dict:
        """The coordinator's phase and last outcome (``/debug/state``)."""
        return self.reshard_coord.status()

    def _start_autoscaler(self) -> None:
        """Build and start the autoscaler over this instance's telemetry
        (:func:`instance_sampler`) and :meth:`reshard`.  Needs a running
        event loop (called from :meth:`create`); :meth:`close` stops it
        first."""
        conf = self.conf
        policy = AutoscalePolicy(PolicyConfig(
            windows=conf.autoscale_windows,
            target_p99_ms=conf.autoscale_target_p99_ms,
            queue_high=conf.autoscale_queue_high,
            hysteresis=conf.autoscale_hysteresis,
            occupancy_low=conf.autoscale_occupancy_low,
            min_shards=conf.autoscale_min_shards,
            max_shards=conf.autoscale_max_shards,
        ))
        self.autoscaler = Autoscaler(
            instance_sampler(self, time.monotonic),
            self.reshard,
            policy=policy,
            interval=conf.autoscale_interval,
            cooldown_up=conf.autoscale_cooldown_up,
            cooldown_down=conf.autoscale_cooldown_down,
            max_per_hour=conf.autoscale_max_per_hour,
            dry_run=conf.autoscale_dry_run,
            metrics=self.metrics,
        )
        self.autoscaler.start()
        self.log.info(
            "autoscaler started (interval=%.1fs, dry_run=%s, shards "
            "[%d, %d])", conf.autoscale_interval, conf.autoscale_dry_run,
            conf.autoscale_min_shards, conf.autoscale_max_shards)

    # ------------------------------------------------------------------
    # Health / peers
    # ------------------------------------------------------------------
    def health_check(self) -> HealthCheckResponse:
        """Recent per-peer errors (gubernator.go:542-586), plus the breaker
        quorum rule: with more than half of the local peers behind open
        circuit breakers this node is cut off from the cluster majority
        and reports unhealthy (the daemon's /healthz answers 503)."""
        errs: List[str] = []
        local_peers = self.local_picker.peers()
        for p in local_peers:
            for msg in p.get_last_err():
                errs.append(
                    f"error returned from local peer.GetLastErr: {msg}")
        region_peers = self.region_picker.peers()
        for p in region_peers:
            for msg in p.get_last_err():
                errs.append(
                    f"error returned from region peer.GetLastErr: {msg}")
        open_breakers = sum(1 for p in local_peers if p.breaker.is_open())
        if local_peers and open_breakers * 2 > len(local_peers):
            errs.append(
                f"{open_breakers}/{len(local_peers)} local peers have open "
                f"circuit breakers")
        return HealthCheckResponse(
            status="unhealthy" if errs else "healthy",
            message="|".join(errs),
            peer_count=len(local_peers) + len(region_peers),
        )

    def occupancy(self) -> dict:
        """Tier occupancy: device-table fill, cold size, shed count.  An
        engine without ``hot_occupancy`` (the mesh, in both packages)
        reads 0.0, so the autoscaler's policy sees a mesh node as empty
        (ROADMAP C.7)."""
        eng = self.engine
        return {
            "cache_size": eng.cache_size(),
            "hot_occupancy": round(
                getattr(eng, "hot_occupancy", lambda: 0.0)(), 4),
            "cold_size": getattr(eng, "cold_size", lambda: 0)(),
            "shed_requests": getattr(eng, "metric_shed_requests", 0),
        }

    def set_peers(self, peer_info: Sequence[PeerInfo]) -> None:
        """Install a new peer set (gubernator.go:616-711): reuse clients of
        unchanged peers, re-dial peers whose info changed, mark this
        node's own entry owner, drain removed peers, and hand the GLOBAL
        keys this node owned to their new owners.

        A node whose GLOBAL mesh was built from the knobs refuses any
        peer but itself: the mesh lives in this process, so its GLOBAL
        limits would be enforced per process across such a cluster."""
        if self.owns_global_mesh and any(
                p.grpc_address != self.conf.advertise_address
                for p in peer_info):
            raise ValueError(MESH_ALONE)
        local = self.local_picker.new()
        region = self.region_picker.new()
        replaced: list = []
        for info in peer_info:
            if info.grpc_address == self.conf.advertise_address:
                info = PeerInfo(
                    grpc_address=info.grpc_address,
                    http_address=info.http_address,
                    datacenter=info.datacenter,
                    is_owner=True,
                )
            if info.datacenter and info.datacenter != self.conf.data_center:
                peer = self.region_picker.get_by_address(info.grpc_address)
                if peer is None:
                    peer = self._new_peer_client(info)
                region.add(peer)
                continue
            peer = self.local_picker.get_by_address(info.grpc_address)
            if peer is not None and peer.info != info:
                replaced.append(peer)  # same address, changed info
                peer = None
            if peer is None:
                peer = self._new_peer_client(info)
            local.add(peer)

        old_local, old_region = self.local_picker, self.region_picker
        # The columns fast path reads one bool: cleared before the picker
        # swap when remote peers arrive, set after it when they leave, so
        # it never sees "standalone" with remote peers live.
        standalone = all(p.info.is_owner for p in local.peers())
        if not standalone:
            self._standalone = False
        self.local_picker, self.region_picker = local, region
        if standalone:
            self._standalone = True
        if self.federation is not None:
            # Channels whose target left its region's ring drop, and
            # their in-flight records rehash to the new owner at the next
            # flush instead of retrying a dead address forever.
            self.federation.on_ring_update()

        doomed = replaced + [
            p for p in old_local.peers()
            if local.get_by_address(p.info.grpc_address) is None]
        for picker in old_region.pickers().values():
            doomed.extend(
                p for p in picker.peers()
                if region.get_by_address(p.info.grpc_address) is None)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (an instance driven synchronously)
        for p in doomed:
            t = loop.create_task(
                self._shutdown_peer(p),
                name=f"peer-shutdown:{p.info.grpc_address}")
            self._peer_shutdown_tasks.add(t)
            t.add_done_callback(self._peer_shutdown_tasks.discard)
        # Ownership handoff: GLOBAL keys this node owned whose new owner
        # is another peer get their accumulated state pushed there.
        if self.global_mgr._owned:
            t = loop.create_task(self.global_mgr.transfer_ownership(),
                                 name="ownership-transfer")
            self._transfer_tasks.add(t)
            t.add_done_callback(self._transfer_tasks.discard)

    async def _shutdown_peer(self, peer) -> None:
        try:
            await peer.shutdown()
        except Exception:
            self.log.warning("shutdown of removed peer %s failed",
                             peer.info.grpc_address, exc_info=True)

    def _new_peer_client(self, info: PeerInfo):
        """A client of ``info`` (this node's own entry too: it is never
        dialled, since its keys are local)."""
        from gubernator_tpu_torch.service.peer_client import PeerClient

        return PeerClient(
            info,
            behaviors=self.conf.behaviors,
            channel_credentials=self.conf.peer_credentials,
            metrics=self.metrics,
            resilience=self.conf.resilience,
            fault_injector=self.conf.fault_injector,
            self_address=self.conf.advertise_address,
        )

    def get_peer(self, key: str):
        """The owning peer of a key; None with no peers set (every key
        local)."""
        if len(self.local_picker) == 0:
            return None
        return self.local_picker.get(key)

    def get_peer_list(self) -> list:
        return self.local_picker.peers()

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    async def close(self) -> None:
        """Graceful drain and shutdown (gubernator.go:151-170): finish
        ownership transfers, flush the GLOBAL buffers under the drain
        budget, await forwards and peer shutdowns, stop the peers, write
        the final snapshot base (or Loader save), then stop the tick loop
        and the engine."""
        if self._closed:
            return
        self._closed = True
        if self.autoscaler is not None:
            # First: no transition may start on a closing instance.
            await self.autoscaler.stop()
        if self._transfer_tasks:
            await asyncio.gather(*list(self._transfer_tasks),
                                 return_exceptions=True)
        await self.global_mgr.close(drain_timeout=self.conf.drain_timeout)
        if self.federation is not None:
            # After the GLOBAL drain (its last flush may queue deltas
            # here) and before the peers stop (envelopes go through them).
            await self.federation.close(drain_timeout=self.conf.drain_timeout)
        if self._mesh_task is not None:
            self._mesh_task.cancel()
            try:
                await self._mesh_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._forward_tasks:
            await asyncio.gather(*list(self._forward_tasks),
                                 return_exceptions=True)
        if self._peer_shutdown_tasks:
            await asyncio.gather(*list(self._peer_shutdown_tasks),
                                 return_exceptions=True)
        for p in (set(self.local_picker.peers())
                  | set(self.region_picker.peers())):
            try:
                await p.shutdown()
            except Exception:
                self.log.warning("peer %s shutdown failed during close",
                                 p.info.grpc_address, exc_info=True)
        if self._snapshot_writer is not None:
            await self._snapshot_writer.close(final_base=True)
        if self.conf.loader is not None:
            if (hasattr(self.conf.loader, "save_columns")
                    and hasattr(self.engine, "export_columns")):
                self.conf.loader.save_columns(self.engine.export_columns())
            else:
                self.conf.loader.save(self.engine.export_items())
        self.tick_loop.close()
        if hasattr(self.engine, "close"):
            self.engine.close()
        self.metrics.cache_size.set(self.engine.cache_size())
