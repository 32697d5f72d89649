"""The port's discovery pools, against the in-process stubs the JAX
package's ``tests/test_discovery.py`` uses (an etcd v3 JSON gateway, a
k8s API server, gossip peers on loopback, the system resolver on
``localhost``), and port daemons joining a cluster through them.

A gossip ring mixing port and JAX nodes converges: the port speaks the
JAX package's member-list wire format.  Every await is bounded.
"""

import asyncio
import base64
import json

import pytest

from gubernator_tpu.discovery.gossip import MemberlistPool as JMemberlistPool
from gubernator_tpu.types import PeerInfo as JPeerInfo
from gubernator_tpu_torch import discovery
from gubernator_tpu_torch.config import BehaviorConfig, Config, DaemonConfig
from gubernator_tpu_torch.discovery import etcdpool
from gubernator_tpu_torch.transport.daemon import Daemon
from gubernator_tpu_torch.types import PeerInfo, RateLimitRequest
from tests.test_discovery import EtcdStub, K8sStub, _free_addr, serve

T = 30


async def wait_until(predicate, timeout=T, interval=0.02):
    async def poll():
        while not predicate():
            await asyncio.sleep(interval)
    await asyncio.wait_for(poll(), timeout)


def gossip_node(cls, info_cls, addr, seeds, updates):
    return cls(bind_address=addr, known_nodes=seeds,
               info=info_cls(grpc_address=f"grpc-{addr}"),
               on_update=updates.append, gossip_interval=0.05,
               suspect_after=3)


async def test_gossip_ring_of_port_and_jax_nodes_joins_and_leaves():
    addrs = [_free_addr() for _ in range(3)]
    updates = [[] for _ in range(3)]
    pools = [
        gossip_node(discovery.MemberlistPool, PeerInfo, addrs[0], [],
                    updates[0]),
        gossip_node(JMemberlistPool, JPeerInfo, addrs[1], [addrs[0]],
                    updates[1]),
        gossip_node(discovery.MemberlistPool, PeerInfo, addrs[2],
                    [addrs[0]], updates[2]),
    ]
    for p in pools:
        await asyncio.wait_for(p.start(), T)
    try:
        await wait_until(lambda: all(u and len(u[-1]) == 3 for u in updates))
        assert ({p.grpc_address for p in updates[0][-1]}
                == {f"grpc-{a}" for a in addrs})
        # Hard-kill the last port node: failure detection drops it.
        pools[2]._task.cancel()
        pools[2]._server.close()
        await asyncio.wait_for(pools[2]._server.wait_closed(), T)
        await wait_until(lambda: len(updates[0][-1]) == 2
                         and len(updates[1][-1]) == 2)
        # Graceful leave of the JAX node, seen by the port node.
        await asyncio.wait_for(pools[1].close(), T)
        await wait_until(lambda: len(updates[0][-1]) == 1)
    finally:
        await asyncio.wait_for(pools[0].close(), T)


async def test_etcd_register_watch_lease_loss_and_close(monkeypatch):
    monkeypatch.setattr(etcdpool, "LEASE_TTL_S", 0.3)
    stub = EtcdStub()
    async with serve(stub.app()) as endpoint:
        updates = []
        pool = discovery.EtcdPool(
            endpoints=[endpoint], key_prefix="/guber/peers/",
            info=PeerInfo(grpc_address="10.0.0.1:81",
                          http_address="10.0.0.1:80"),
            on_update=updates.append, poll_interval=0.05)
        await asyncio.wait_for(pool.start(), T)
        try:
            await wait_until(lambda: updates)
            assert updates[-1] == [PeerInfo(grpc_address="10.0.0.1:81",
                                            http_address="10.0.0.1:80")]
            key = base64.b64encode(b"/guber/peers/10.0.0.2:81").decode()
            val = base64.b64encode(json.dumps(
                {"grpc_address": "10.0.0.2:81"}).encode()).decode()
            stub.kv[key] = (val, 0)
            await wait_until(lambda: len(updates[-1]) == 2)
            first = pool._lease_id
            stub.fail_keepalive_once = True  # the lease dies server-side
            await wait_until(lambda: pool._lease_id != first
                             and pool._lease_id in stub.leases)
        finally:
            await asyncio.wait_for(pool.close(), T)
    assert all(b"10.0.0.1" not in base64.b64decode(k) for k in stub.kv)
    assert not stub.leases


async def test_dns_pool_resolves_and_emits_once():
    updates = []
    pool = discovery.DNSPool(fqdn="localhost", grpc_port=1051,
                             http_port=1050, on_update=updates.append,
                             poll_interval=0.05)
    await asyncio.wait_for(pool.start(), T)
    try:
        await wait_until(lambda: updates)
        assert "127.0.0.1:1051" in {p.grpc_address for p in updates[-1]}
        assert all(p.http_address.endswith(":1050") for p in updates[-1])
        n = len(updates)
        await asyncio.sleep(0.2)  # stable records: no new emission
        assert len(updates) == n == 1
    finally:
        await asyncio.wait_for(pool.close(), T)
    with pytest.raises(ValueError):
        discovery.DNSPool(fqdn="", grpc_port=1, http_port=1,
                          on_update=lambda p: None)


@pytest.mark.parametrize("mechanism,want", [
    ("endpoints", {"10.1.0.1:1051", "10.1.0.2:1051"}),
    ("pods", {"10.1.0.1:1051"}),
])
async def test_k8s_pool_mechanisms(mechanism, want):
    stub = K8sStub()
    async with serve(stub.app()) as endpoint:
        updates = []
        pool = discovery.K8sPool(
            namespace="default", selector="app=gubernator",
            pod_ip="10.1.0.1", pod_port="1051", on_update=updates.append,
            mechanism=mechanism, poll_interval=0.05,
            api_server=f"http://{endpoint}")
        await asyncio.wait_for(pool.start(), T)
        try:
            await wait_until(lambda: updates)
            assert {p.grpc_address for p in updates[-1]} == want
            if mechanism == "endpoints":
                assert stub.selector_seen == "app=gubernator"
                stub.endpoints_ips.append("10.1.0.3")
                await wait_until(lambda: len(updates[-1]) == 3)
        finally:
            await asyncio.wait_for(pool.close(), T)
    with pytest.raises(ValueError):
        discovery.K8sPool(namespace="d", selector="s", pod_ip="",
                          pod_port="1", on_update=lambda p: None,
                          mechanism="nope")


async def test_static_pool_emits_its_list():
    updates = []
    peers = [PeerInfo(grpc_address="a:1"), PeerInfo(grpc_address="b:1")]
    pool = discovery.StaticPool(peers, updates.append)
    await pool.start()
    await pool.close()
    assert updates == [peers]


def node_conf(kind, **kw):
    conf = DaemonConfig(grpc_listen_address="127.0.0.1:0",
                        http_listen_address="", peer_discovery_type=kind,
                        config=Config(behaviors=BehaviorConfig(
                                          batch_timeout=T),
                                      cache_size=256, tpu_max_batch=64,
                                      tpu_platform="cpu"), **kw)
    return conf


async def _two_daemons_share_a_bucket(make_conf):
    daemons = []
    try:
        for i in range(2):
            d = Daemon(make_conf(i))
            await asyncio.wait_for(d.start(), T)
            daemons.append(d)
        await wait_until(lambda: all(
            len(d.instance.get_peer_list()) == 2 for d in daemons))
        owners = [sum(p.info.is_owner for p in d.instance.get_peer_list())
                  for d in daemons]
        assert owners == [1, 1]
        remaining = []
        for d in daemons + daemons:
            c = d.client()
            try:
                (r,) = await asyncio.wait_for(c.get_rate_limits([
                    RateLimitRequest(name="disc", unique_key="shared",
                                     hits=1, limit=10, duration=60_000)],
                    timeout=T), T)
            finally:
                await c.close()
            remaining.append((r.error, r.remaining))
        assert remaining == [("", 9), ("", 8), ("", 7), ("", 6)]
    finally:
        for d in daemons:
            await asyncio.wait_for(d.close(), T)


async def test_daemons_join_through_member_list():
    seed = _free_addr()

    def make(i):
        return node_conf("member-list",
                         memberlist_address=seed if i == 0 else _free_addr(),
                         memberlist_known_nodes=[] if i == 0 else [seed])

    await _two_daemons_share_a_bucket(make)


async def test_daemons_join_through_etcd():
    stub = EtcdStub()
    async with serve(stub.app()) as endpoint:
        await _two_daemons_share_a_bucket(lambda i: node_conf(
            "etcd", etcd_endpoints=[endpoint],
            etcd_key_prefix="/guber-test/peers/"))
    assert not stub.leases  # each daemon revoked its lease on close


def test_unknown_discovery_type_raises():
    with pytest.raises(ValueError, match="discovery"):
        Daemon(node_conf("consul"))
