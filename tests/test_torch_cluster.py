"""The port's cluster: hash-ring ownership, forwarding, GLOBAL reconcile,
resilience and ring changes over loopback gRPC, on the CPU.

One module-scoped 3-node port cluster (``tpu_platform="cpu"``) carries
the behaviour tests, as ``tests/test_service.py`` does for the JAX
package.  One parity test starts a 3-node JAX ``Cluster`` (the JAX
default ``cache_size``, the programs ``tests/test_service.py`` compiles)
and a fresh 3-node port cluster, drives both with the same seeded serial
sequence under pinned clocks, and holds the responses (apart from the
``owner`` metadata: ephemeral ports put the rings in different places)
and the union of owner-side exports equal.  GLOBAL state is compared
only once every node is quiet (no hits queued, no update queued, no
flush or broadcast in flight), never after a fixed sleep.  Every await
is bounded, so a hang fails one test instead of the suite.
"""

import asyncio
import json
import urllib.error
import urllib.request

import pytest

from gubernator_tpu import cluster as jcluster
from gubernator_tpu import config as jconfig
from gubernator_tpu.types import RateLimitRequest as JRequest
from gubernator_tpu.utils import timeutil as jtimeutil
from gubernator_tpu_torch.cluster import Cluster, wait_quiet
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.resilience import FaultInjector, ResilienceConfig
from gubernator_tpu_torch.types import (
    Behavior, RateLimitRequest, Status)
from gubernator_tpu_torch.utils import timeutil
import chip_smoke as cs
from tests.test_torch_common import NOW

T = 30  # seconds: the bound on every await

GLOBAL = int(Behavior.GLOBAL)


def bounded(aw):
    return asyncio.wait_for(aw, T)


@pytest.fixture(scope="module")
def event_loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


INJECTOR = FaultInjector(seed=5)


@pytest.fixture(scope="module")
def cluster(event_loop):
    c = event_loop.run_until_complete(bounded(Cluster.start(
        3, tpu_platform="cpu", cache_size=1024, tpu_max_batch=64,
        http_gateway=True, fault_injector=INJECTOR,
        behaviors=BehaviorConfig(batch_timeout=T, global_sync_wait=0.02),
        resilience=ResilienceConfig(
            forward_max_attempts=2, forward_backoff_base=0.001,
            forward_backoff_cap=0.002, breaker_min_requests=1000))))
    yield c
    event_loop.run_until_complete(bounded(c.stop()))


def req(name="c", key="k", hits=1, limit=5, duration=60_000, **kw):
    return RateLimitRequest(name=name, unique_key=key, hits=hits,
                            limit=limit, duration=duration, **kw)


async def call(daemon, reqs):
    client = daemon.client()
    try:
        return await bounded(client.get_rate_limits(reqs, timeout=T))
    finally:
        await client.close()


def index_of(c, daemon):
    return c.daemons.index(daemon)


spread = cs.spread_key


async def quiet(daemons):
    await wait_quiet(daemons, T)


def probe(key, limit=10, duration=60_000, algorithm=0):
    return req(name="g", key=key, hits=0, limit=limit, duration=duration,
               algorithm=algorithm, behavior=GLOBAL)


# ----------------------------------------------------------------------
# Behaviour on the module cluster
# ----------------------------------------------------------------------
async def test_forwarding_shares_the_owners_state(cluster):
    owner = cluster.find_owning_daemon("fwd", "shared")
    others = cluster.list_non_owning_daemons("fwd", "shared")
    seen = []
    for d in [others[0], owner, others[1], others[0], owner, others[1]]:
        (r,) = await call(d, [req(name="fwd", key="shared", limit=5)])
        seen.append((r.status, r.remaining, r.error))
        want = {} if d is owner else {
            "owner": owner.conf.grpc_listen_address}
        assert r.metadata == want
    assert seen == [(0, 4, ""), (0, 3, ""), (0, 2, ""), (0, 1, ""),
                    (0, 0, ""), (1, 0, "")]
    assert owner.metrics.sample("gubernator_getratelimit_counter_total",
                                {"calltype": "local"}) >= 6
    assert others[0].metrics.sample("gubernator_getratelimit_counter_total",
                                    {"calltype": "forward"}) >= 2


async def test_batch_order_is_kept(cluster):
    reqs = [req(name="ord", key=spread(i), limit=100 + i, hits=i % 3)
            for i in range(60)]
    reqs[7] = req(name="", key="bad")
    reqs[31] = req(name="ord", key="")
    owners = {cluster.find_owning_daemon("ord", spread(i)).conf
              .grpc_listen_address for i in range(60)}
    here = cluster.daemons[1].conf.grpc_listen_address
    assert here in owners and len(owners) >= 2  # local and forwarded items
    out = await call(cluster.daemons[1], reqs)
    for i, r in enumerate(out):
        if i in (7, 31):
            assert r.error and "cannot be empty" in r.error
        else:
            assert (r.error, r.limit, r.remaining) == ("", 100 + i,
                                                       100 + i - i % 3)


async def test_global_reconciles_with_negative_hits_and_peer_over_limit(
        cluster):
    owner = cluster.find_owning_daemon("g", "recon")
    a, b = cluster.list_non_owning_daemons("g", "recon")
    o = index_of(cluster, owner)
    sent = 0
    for d, hits in ((a, 3), (b, 2), (owner, 1), (a, -1), (b, 4)):
        (r,) = await call(d, [req(name="g", key="recon", hits=hits,
                                  limit=10, behavior=GLOBAL)])
        assert r.error == ""
        sent += hits
        await quiet(cluster.daemons)
    await bounded(cluster.wait_for_broadcast(o, 1, timeout=T))
    for d in cluster.daemons:
        (r,) = await call(d, [probe("recon")])
        assert r.remaining == 10 - sent, d is owner
    # Over the limit from a non-owner: the local answer is OVER_LIMIT and
    # the forwarded hit drains the owner's bucket (DRAIN_OVER_LIMIT).
    (r,) = await call(a, [req(name="g", key="recon", hits=5, limit=10,
                              behavior=GLOBAL)])
    assert r.status == Status.OVER_LIMIT
    await quiet(cluster.daemons)
    for d in cluster.daemons:
        (r,) = await call(d, [probe("recon")])
        assert (r.status, r.remaining) == (Status.UNDER_LIMIT, 0)


async def test_forward_retries_give_up_and_upgrade_to_self(cluster):
    src = cluster.daemons[0]
    key = next(spread(i) for i in range(100)
               if cluster.find_owning_daemon("fail", spread(i)) is not src)
    owner = cluster.find_owning_daemon("fail", key)
    addr = owner.conf.grpc_listen_address
    retries = src.metrics.sample("gubernator_batch_send_retries_total")
    INJECTOR.set_fault(addr, partition=True, methods=("GetPeerRateLimits",))
    try:
        (r,) = await call(src, [req(name="fail", key=key)])
        assert "not connected" in r.error and key in r.error
        assert src.metrics.sample(
            "gubernator_batch_send_retries_total") == retries + 3
        # Ownership moves to the caller while its forward fails: the
        # retry applies the hit here, exactly once.
        inst = src.instance
        me = next(p for p in inst.get_peer_list() if p.info.is_owner)
        calls = []

        def moved(k):
            calls.append(k)
            return me

        inst.get_peer = moved
        try:
            resp = await bounded(inst._async_request(
                inst.local_picker.get(f"fail_{key}"),
                req(name="fail", key=key, hits=2), f"fail_{key}"))
        finally:
            del inst.get_peer
        assert (resp.error, resp.remaining, resp.metadata) == ("", 3, {})
        assert calls == [f"fail_{key}"]
    finally:
        INJECTOR.clear()
    (r,) = await call(owner, [req(name="fail", key=key, hits=0)])
    assert r.remaining == 5  # the owner never saw the failed hits


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=T) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


async def test_health_and_healthz_with_an_open_breaker_majority(cluster):
    d = cluster.daemons[2]
    url = f"http://{d.conf.http_listen_address}/healthz"
    status, body = await asyncio.to_thread(_get, url)
    assert (status, body["status"], body["peer_count"]) == (200, "healthy", 3)
    remote = [p for p in d.instance.get_peer_list() if not p.info.is_owner]
    remote[0].breaker.force_open(60.0)
    assert d.instance.health_check().status == "healthy"  # 1 of 3
    remote[1].breaker.force_open(60.0)
    try:
        h = d.instance.health_check()
        assert h.status == "unhealthy"
        assert "2/3 local peers have open circuit breakers" in h.message
        status, body = await asyncio.to_thread(_get, url)
        assert (status, body["status"]) == (503, "unhealthy")
        # A GLOBAL item whose owner sits behind an open breaker is
        # answered locally and counted as degraded.
        key = next(spread(i) for i in range(200, 300) if not
                   d.instance.get_peer(f"g_{spread(i)}").info.is_owner)
        (r,) = await call(d, [req(name="g", key=key, hits=2, limit=10,
                                  behavior=GLOBAL)])
        assert (r.error, r.remaining) == ("", 8)
        assert d.metrics.sample("gubernator_degraded_answers_total") >= 1
    finally:
        for p in remote:
            p.breaker.force_open(0.0)
            assert p.breaker.allow()
            p.breaker.record_success()
    assert d.instance.health_check().status == "healthy"
    await quiet(cluster.daemons)


async def test_transfer_ownership_on_a_ring_change(cluster):
    leaving = cluster.daemons[2]
    keys = [spread(i) for i in range(300)
            if cluster.find_owning_daemon("g", spread(i)) is leaving][:6]
    assert keys
    for i, k in enumerate(keys):
        (r,) = await call(leaving, [req(name="g", key=k, hits=i + 1,
                                        limit=50, behavior=GLOBAL)])
        assert r.remaining == 50 - (i + 1)
    await quiet(cluster.daemons)
    pushed = leaving.metrics.sample(
        "gubernator_tpu_ownership_transfers_total", {"result": "pushed"})
    # Every GLOBAL key the leaving node owns moves (earlier tests' too).
    owned = set(leaving.instance.global_mgr._owned)
    assert {f"g_{k}" for k in keys} <= owned
    rest = [p for p in cluster.peers
            if p.grpc_address != leaving.conf.grpc_listen_address]
    try:
        for d in cluster.daemons:
            d.set_peers(rest)
        await bounded(asyncio.gather(*leaving.instance._transfer_tasks))
        assert leaving.metrics.sample(
            "gubernator_tpu_ownership_transfers_total",
            {"result": "pushed"}) == pushed + len(owned)
        for i, k in enumerate(keys):
            new = next(d for d in cluster.daemons[:2]
                       if d.instance.get_peer(f"g_{k}").info.is_owner)
            (r,) = await call(new, [probe(k, limit=50)])
            assert r.remaining == 50 - (i + 1), k
            (r,) = await call(new, [req(name="g", key=k, hits=1, limit=50,
                                        behavior=GLOBAL)])
            assert r.remaining == 50 - (i + 2), k
    finally:
        for d in cluster.daemons:
            d.set_peers(cluster.peers)
        await quiet(cluster.daemons)


def test_unported_cluster_options_raise():
    """Every option of the JAX harness is ported: a 2-region federated
    CPU cluster starts (a manager on each node with a datacenter, none on
    the node without one) and stops, and a 1-node CPU mesh cluster
    starts, shares its engine and stops."""

    async def federated_cluster():
        c = await Cluster.start(
            3, datacenters=["us", "eu", ""], federation=True,
            federation_interval=0.5, tpu_platform="cpu", cache_size=64,
            tpu_max_batch=16)
        try:
            feds = [d.instance.federation for d in c.daemons]
            assert [f is not None for f in feds] == [True, True, False]
            assert [f.home for f in feds[:2]] == ["us", "eu"]
            assert all(f.interval == 0.5 for f in feds[:2])
            assert (c.daemons[0].instance.region_picker.regions()
                    == ["eu"])
        finally:
            await c.stop()

    asyncio.run(federated_cluster())

    async def mesh_cluster():
        c = await Cluster.start(1, global_mesh=True, tpu_platform="cpu",
                                cache_size=64, tpu_max_batch=16)
        try:
            eng = c.daemons[0].instance.global_mesh
            assert eng is not None and eng.n_nodes == 1
            assert eng.device.type == "cpu" and eng.capacity == 64
        finally:
            await c.stop()

    asyncio.run(mesh_cluster())


# ----------------------------------------------------------------------
# Parity with the JAX cluster
# ----------------------------------------------------------------------
async def test_cluster_answers_as_the_jax_cluster():
    """The sequence of ``chip_smoke.drive_cluster`` (plain batches with
    every algorithm, RESET / DRAIN rows, negative hits and invalid items;
    GLOBAL token and leaky items sent to their owner or a non-owner, with
    negative hits, RESET and hits over the limit, each step's GLOBAL
    changes waited for) through a 3-node JAX cluster and a 3-node port
    cluster, both clocks pinned to the same values."""
    clock = [NOW]
    jax_now, port_now = jtimeutil.now_ms, timeutil.now_ms
    jtimeutil.now_ms = timeutil.now_ms = lambda: clock[0]
    try:
        # A forwarded batch's deadline well past a first window's compile:
        # a retry after a deadline the owner outlived applies the hits
        # twice (at-least-once forwarding, as in the reference).
        jc = await bounded(jcluster.Cluster.start(
            3, behaviors=jconfig.BehaviorConfig(batch_timeout=T,
                                                global_sync_wait=0.02)))
        try:
            pc = await bounded(Cluster.start(
                3, tpu_platform="cpu", cache_size=1024, tpu_max_batch=64,
                behaviors=BehaviorConfig(batch_timeout=T,
                                         global_sync_wait=0.02)))
            try:
                # The JAX engines compile their programs on first use.
                want = await cs.drive_cluster(jc, JRequest, 21, clock, 20,
                                              3 * T)
                got = await cs.drive_cluster(pc, RateLimitRequest, 21, clock,
                                             20, T)
                assert len(got) == len(want) == 20
                for k, (g, w) in enumerate(zip(got, want)):
                    assert g == w, k
                rows = cs.owner_rows(pc)
                assert rows == cs.owner_rows(jc)
                assert any(k.startswith(b"g_") for k in rows)
            finally:
                await bounded(pc.stop())
        finally:
            await bounded(jc.stop())
    finally:
        jtimeutil.now_ms, timeutil.now_ms = jax_now, port_now
