"""In-process multi-daemon cluster for tests and local development.

The port's copy of the JAX package's ``cluster.py``.  The reference proves
"multi-node" behavior without a real cluster by booting N daemons in one
process on loopback with statically injected peer lists
(``cluster/cluster.go:123-189``); this is the same harness for the port:
real gRPC over loopback, real consistent hashing, real batching and
broadcast loops, each node's engine on the card (or, with
``tpu_platform="cpu"``, on the CPU's plain versions).  With
``global_mesh=True`` the nodes share one ``MeshGlobalEngine``
(parallel/global_mesh.py), node i its replica i, and GLOBAL items
reconcile on it instead of over the gRPC loops.  With
``federation=True`` the nodes that have a datacenter exchange GLOBAL
deltas with the other regions (federation/).

Ownership introspection helpers (``FindOwningDaemon``,
``ListNonOwningDaemons``, ``cluster/cluster.go:81-110``) let tests target
the exact peer that owns a key.
"""

from __future__ import annotations

import asyncio
import random
from typing import Dict, List, Optional, Sequence

from gubernator_tpu_torch.config import BehaviorConfig, Config, DaemonConfig
from gubernator_tpu_torch.transport.daemon import Daemon
from gubernator_tpu_torch.types import PeerInfo


def _daemon_config(
    datacenter: str = "",
    behaviors: Optional[BehaviorConfig] = None,
    cache_size: int = 4096,
    resilience=None,
    fault_injector=None,
    tpu_platform: str = "",
    tpu_max_batch: int = 4096,
    federation: bool = False,
    federation_interval: float = 0.05,
) -> DaemonConfig:
    conf = DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address="",  # gateway off by default; tests opt in
        peer_discovery_type="none",
        data_center=datacenter,
    )
    conf.config = Config(
        behaviors=behaviors or BehaviorConfig(),
        cache_size=cache_size,
        data_center=datacenter,
        tpu_platform=tpu_platform,
        tpu_max_batch=tpu_max_batch,
        federation_enabled=federation,
        federation_interval=federation_interval,
    )
    if resilience is not None:
        conf.config.resilience = resilience
    conf.config.fault_injector = fault_injector
    return conf


def _same_config(old: DaemonConfig) -> DaemonConfig:
    """A fresh config with an old daemon's settings (a restart)."""
    c = old.config
    return _daemon_config(old.data_center, c.behaviors, c.cache_size,
                          c.resilience, c.fault_injector, c.tpu_platform,
                          c.tpu_max_batch, c.federation_enabled,
                          c.federation_interval)


def _track_inflight(gm) -> None:
    """Count a GLOBAL manager's hit flushes and broadcasts in flight (an
    instance attribute over each bound method: its loops look them up on
    the instance).  A flush already under way when a manager is first
    tracked is not counted, so a ``Cluster`` tracks each daemon from its
    start and ``wait_quiet`` any other daemon from its first call."""
    if hasattr(gm, "_inflight_n"):
        return
    gm._inflight_n = 0
    for name in ("_send_hits", "_broadcast"):
        inner = getattr(gm, name)

        async def wrapped(batch, inner=inner):
            gm._inflight_n += 1
            try:
                return await inner(batch)
            finally:
                gm._inflight_n -= 1

        setattr(gm, name, wrapped)


def _federation_idle(inst) -> bool:
    fed = getattr(inst, "federation", None)
    return fed is None or not (fed.pending_keys() or fed.inflight_envelopes())


async def wait_quiet(daemons: Sequence, timeout: float = 5.0,
                     federation: bool = True) -> None:
    """Wait until no node has GLOBAL hits or updates queued, a flush or a
    broadcast in flight, or an ownership transfer running, and (with
    ``federation``) no federation delta pending or envelope in flight:
    every GLOBAL change has then reached every node of every region (an
    envelope stays in flight until the remote owner applied it and
    queued its broadcast).  ``federation=False`` waits for the regions
    alone, as during a WAN partition.  Duck-typed over the daemons
    (``daemon.instance.global_mgr``), so it also waits on the JAX
    package's in-process daemons."""
    for d in daemons:
        _track_inflight(d.instance.global_mgr)

    def idle() -> bool:
        return all(not d.instance.global_mgr._hits
                   and not d.instance.global_mgr._updates
                   and d.instance.global_mgr._inflight_n == 0
                   and not d.instance._transfer_tasks
                   and (not federation or _federation_idle(d.instance))
                   for d in daemons)

    async def poll() -> None:
        while not idle():
            await asyncio.sleep(0.002)

    await asyncio.wait_for(poll(), timeout)


class Cluster:
    """N in-process daemons with a static, fully-connected peer list."""

    def __init__(self):
        self.daemons: List[Daemon] = []
        self.peers: List[PeerInfo] = []

    # ------------------------------------------------------------------
    @classmethod
    async def start(
        cls,
        n: int,
        datacenters: Optional[Sequence[str]] = None,
        behaviors: Optional[BehaviorConfig] = None,
        cache_size: int = 4096,
        http_gateway: bool = False,
        global_mesh: bool = False,
        resilience=None,
        fault_injector=None,
        federation: bool = False,
        federation_interval: float = 0.05,
        tpu_platform: str = "",
        tpu_max_batch: int = 4096,
    ) -> "Cluster":
        """Boot ``n`` daemons (dc layout via ``datacenters``, one entry per
        daemon) and wire them into one cluster (cluster.go:123-189).

        ``resilience``/``fault_injector`` thread the fault-tolerant peer
        path's knobs and the chaos hook into every daemon (the injector is
        shared, so one schedule partitions a peer cluster-wide).

        ``tpu_platform`` "" puts every node's engine on the card (raising
        without one), "cpu" on the plain versions.  ``global_mesh`` builds
        one ``MeshGlobalEngine`` over the ``n`` nodes (capacity
        ``min(cache_size, 2^16)``, reconciles at most every half
        ``global_sync_wait``) on the same platform, shared by every
        daemon.  ``federation=True`` enables the inter-region envelope
        exchange (docs/federation.md) on the daemons with a datacenter, at
        the cadence ``federation_interval``.  A failed start stops the
        daemons already up.
        """
        c = cls()
        datacenters = list(datacenters or [""] * n)
        assert len(datacenters) == n
        mesh_engine = None
        if global_mesh:
            from gubernator_tpu_torch.parallel.global_mesh import (
                MeshGlobalEngine)

            sync_ms = int((behaviors or BehaviorConfig()).global_sync_wait
                          * 500)
            mesh_engine = MeshGlobalEngine(
                n_nodes=n, capacity=min(cache_size, 1 << 16),
                min_reconcile_ms=sync_ms, device=tpu_platform or None)
        try:
            for idx, dc in enumerate(datacenters):
                conf = _daemon_config(dc, behaviors, cache_size,
                                      resilience, fault_injector,
                                      tpu_platform, tpu_max_batch,
                                      federation and bool(dc),
                                      federation_interval)
                if http_gateway:
                    conf.http_listen_address = "127.0.0.1:0"
                d = Daemon(conf, global_mesh=mesh_engine,
                           global_mesh_node=idx)
                await d.start()
                _track_inflight(d.instance.global_mgr)
                c.daemons.append(d)
        except BaseException:
            await c.stop()
            raise
        c.peers = [
            PeerInfo(
                grpc_address=d.conf.grpc_listen_address,
                http_address=d.conf.http_listen_address,
                datacenter=d.conf.data_center,
            )
            for d in c.daemons
        ]
        for d in c.daemons:
            d.set_peers(c.peers)
        for d in c.daemons:
            await d.wait_for_connect()
        return c

    async def stop(self) -> None:
        for d in self.daemons:
            await d.close()
        self.daemons = []

    # ------------------------------------------------------------------
    # Ownership introspection (cluster/cluster.go:81-110)
    # ------------------------------------------------------------------
    def find_owning_daemon(self, name: str, key: str) -> Daemon:
        """The daemon whose instance owns ``name_key``."""
        d0 = self.daemons[0]
        owner = d0.instance.get_peer(name + "_" + key)
        addr = owner.info.grpc_address
        for d in self.daemons:
            if d.conf.grpc_listen_address == addr:
                return d
        raise RuntimeError(f"no daemon listening on {addr}")

    def find_owning_daemon_in_region(
        self, name: str, key: str, datacenter: str
    ) -> Daemon:
        """The daemon owning ``name_key`` on ``datacenter``'s own ring.
        Resolution must go through a daemon IN that region — each local
        picker only contains its own datacenter's members."""
        d0 = self.get_random_peer(datacenter)
        owner = d0.instance.get_peer(name + "_" + key)
        addr = d0.conf.grpc_listen_address if owner is None \
            else owner.info.grpc_address
        for d in self.daemons:
            if d.conf.grpc_listen_address == addr:
                return d
        raise RuntimeError(f"no daemon listening on {addr}")

    def list_non_owning_daemons(self, name: str, key: str) -> List[Daemon]:
        owner = self.find_owning_daemon(name, key)
        return [d for d in self.daemons if d is not owner]

    def get_random_peer(self, datacenter: str = "") -> Daemon:
        pool = [
            d for d in self.daemons if d.conf.data_center == datacenter
        ]
        return random.choice(pool)

    def addresses(self) -> List[str]:
        return [d.conf.grpc_listen_address for d in self.daemons]

    async def restart(self, idx: int) -> Daemon:
        """Stop and re-start one daemon on its old port (cluster.go:139-148)."""
        old = self.daemons[idx]
        addr = old.conf.grpc_listen_address
        await old.close()
        conf = _same_config(old.conf)
        conf.grpc_listen_address = addr
        d = Daemon(conf)
        await d.start()
        _track_inflight(d.instance.global_mgr)
        d.set_peers(self.peers)
        await d.wait_for_connect()
        self.daemons[idx] = d
        return d

    # Metrics oracle: scrape one daemon's registry value
    # (the reference scrapes /metrics; same idea, in-process).
    def metric_value(self, idx: int, name: str, labels: Dict[str, str] = None):
        return self.daemons[idx].metrics.sample(name, labels)

    async def wait_for_metric(
        self,
        idx: int,
        name: str,
        minimum: float = 1.0,
        labels: Dict[str, str] = None,
        timeout: float = 5.0,
    ) -> float:
        """Poll one daemon's registry until ``name`` reaches ``minimum``
        — the metrics-as-oracle pattern the reference's distributed tests
        use instead of sleeps (functional_test.go:2184-2276)."""
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            v = self.metric_value(idx, name, labels)
            if v >= minimum:
                return v
            if asyncio.get_running_loop().time() > deadline:
                raise AssertionError(
                    f"metric {name}{labels or ''} on daemon {idx} stuck at"
                    f" {v}, wanted >= {minimum}"
                )
            await asyncio.sleep(0.01)

    async def wait_for_broadcast(
        self, idx: int, count: float = 1.0, timeout: float = 5.0
    ) -> float:
        """Wait until daemon ``idx`` (a GLOBAL owner) has completed
        ``count`` peer broadcasts (functional_test.go:2184 waitForBroadcast)."""
        return await self.wait_for_metric(
            idx, "gubernator_broadcast_duration_count", count, timeout=timeout
        )

    async def wait_for_quiet(self, timeout: float = 5.0,
                             federation: bool = True) -> None:
        """Wait until every GLOBAL change reached every node
        (:func:`wait_quiet`)."""
        await wait_quiet(self.daemons, timeout, federation)

    async def wait_for_update(
        self, idx: int, count: float = 1.0, timeout: float = 5.0
    ) -> float:
        """Wait until daemon ``idx`` (a non-owner) has flushed ``count``
        GLOBAL hit batches to the owner (functional_test.go:2230
        waitForUpdate; ours counts send flushes via global_send_duration)."""
        return await self.wait_for_metric(
            idx, "gubernator_global_send_duration_count", count, timeout=timeout
        )
