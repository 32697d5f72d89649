"""The port's fault-tolerant peer path against the JAX package's.

Backoff, breakers and fault injection draw from their own seeded
``random.Random``, so the same seed and the same script of events give
the same delays, the same breaker states and the same injected faults in
both packages.  The port's ``PeerClient`` drains and refuses work as the
JAX one does, and its ``GlobalManager`` requeues failed flushes into the
bounded redelivery buffer.  Everything runs on virtual time
(``ManualClock``) or sub-second asyncio windows.
"""

import asyncio
import random

import grpc
import pytest

from gubernator_tpu import resilience as jres
from gubernator_tpu_torch import resilience as tres
from gubernator_tpu_torch.resilience import (
    BreakerOpenError,
    BreakerState,
    CircuitBreaker,
    DecorrelatedJitterBackoff,
    FaultInjector,
    FaultSpec,
    ManualClock,
    ResilienceConfig,
)
from gubernator_tpu_torch.resilience.faults import rpc_error
from gubernator_tpu_torch.service.global_manager import GlobalManager
from gubernator_tpu_torch.service.peer_client import ErrorRecorder, PeerClient
from gubernator_tpu_torch.types import (
    PeerInfo,
    RateLimitRequest,
    RateLimitResponse,
)
from gubernator_tpu_torch.utils.metrics import Metrics


def req(key="k", hits=1, **kw):
    return RateLimitRequest(name="res", unique_key=key, hits=hits, limit=10,
                            duration=60_000, **kw)


@pytest.mark.parametrize("seed,base,cap", [(1, 0.005, 0.1), (42, 0.01, 0.5),
                                           (7, 2.0, 30.0)])
def test_backoff_bounds_and_the_jax_draws(seed, base, cap):
    port = DecorrelatedJitterBackoff(base, cap, rng=random.Random(seed))
    ref = jres.DecorrelatedJitterBackoff(base, cap, rng=random.Random(seed))
    got = [port.next() for _ in range(40)]
    assert got == [ref.next() for _ in range(40)]
    assert all(base <= d <= cap for d in got)
    port.reset()
    ref.reset()
    assert port.next() == ref.next() <= 3 * base
    for bad in ((0, 1.0), (1.0, 0.5)):
        with pytest.raises(ValueError):
            DecorrelatedJitterBackoff(*bad)


def breaker_trace(mod, seed):
    """A scripted run of one breaker: each step advances the virtual
    clock, then records a success, a failure, an allow() or a state read;
    the trace is (state, open_until, allowed) after every step."""
    script = random.Random(seed)
    clk = mod.ManualClock()
    changes = []
    b = mod.CircuitBreaker(
        failure_threshold=0.5, min_requests=4, window=5.0, open_for=0.5,
        open_cap=4.0, half_open_probes=2, clock=clk,
        rng=random.Random(seed + 1000),
        on_transition=lambda o, n: changes.append((int(o), int(n))))
    trace = []
    for _ in range(300):
        clk.advance(script.choice([0.0, 0.05, 0.3, 1.0]))
        op = script.random()
        allowed = None
        if op < 0.45:
            b.record_failure()
        elif op < 0.75:
            b.record_success()
        elif op < 0.95:
            allowed = b.allow()
        else:
            b.force_open(script.choice([None, 0.25]))
        trace.append((int(b.state), round(b._open_until, 12), allowed))
    return trace, changes


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_state_sequences_match_the_jax_breaker(seed):
    got, got_changes = breaker_trace(tres, seed)
    want, want_changes = breaker_trace(jres, seed)
    assert got == want
    assert got_changes == want_changes
    states = {s for s, _, _ in got}
    assert states == {0, 1, 2}  # the script reaches every state


def test_breaker_half_open_probe_and_disabled():
    clk = ManualClock()
    b = CircuitBreaker(min_requests=2, open_for=1.0, open_cap=1.0,
                       clock=clk, rng=random.Random(0))
    b.record_failure()
    b.record_failure()
    assert b.is_open() and not b.allow()
    clk.advance(1.0)
    assert b.state is BreakerState.HALF_OPEN
    assert b.allow() and not b.allow()  # one probe slot
    b.record_success()
    assert b.state is BreakerState.CLOSED
    off = CircuitBreaker(enabled=False, min_requests=1, clock=clk)
    for _ in range(10):
        off.record_failure()
    assert off.allow() and not off.is_open()


async def _fault_outcomes(mod, seed):
    clk = mod.ManualClock()
    inj = mod.FaultInjector(seed=seed, clock=clk, sleep=clk.sleep)
    inj.set_fault("*", error_rate=0.3, drop_rate=0.4)
    inj.set_fault("p1", spec=mod.FaultSpec(error_rate=0.7, delay=0.01))
    inj.set_fault("p2", from_peer="p0", partition=True)
    inj.set_fault("p3", error_rate=1.0, flap_interval=1.0)
    inj.set_fault("p4", partition=True, methods=("UpdatePeerGlobals",))
    out = []
    script = random.Random(seed)
    for _ in range(200):
        clk.advance(script.choice([0.0, 0.2, 0.7]))
        peer = script.choice(["p0", "p1", "p2", "p3", "p4", "p5"])
        src = script.choice(["", "p0"])
        method = script.choice(["GetPeerRateLimits", "UpdatePeerGlobals"])
        try:
            await inj.before_rpc(peer, method, from_peer=src)
            out.append(None)
        except grpc.aio.AioRpcError as e:
            out.append((e.code().name, e.details()))
    return out, dict(inj.injected), list(clk.sleeps)


@pytest.mark.parametrize("seed", [11, 12, 13])
async def test_seeded_fault_schedules_match_the_jax_injector(seed):
    got = await _fault_outcomes(tres, seed)
    want = await _fault_outcomes(jres, seed)
    assert got == want
    kinds = {k for _, k in got[1]}
    assert kinds == {"error", "drop", "delay"}


async def test_injected_errors_are_real_rpc_errors():
    inj = FaultInjector(seed=3)
    inj.set_fault("p1", partition=True)
    with pytest.raises(grpc.aio.AioRpcError) as e:
        await inj.before_rpc("p1", "GetPeerRateLimits")
    assert e.value.code() == grpc.StatusCode.UNAVAILABLE
    await inj.before_rpc("p2", "GetPeerRateLimits")
    inj.clear("p1")
    await inj.before_rpc("p1", "GetPeerRateLimits")
    assert isinstance(FaultSpec(partition=True).matches("x"), bool)


def test_error_recorder_expires_and_caps():
    rec = ErrorRecorder(ttl=300.0, cap=3)
    for i in range(5):
        rec.record(f"e{i}")
    rec.record("e2")
    assert rec.errors() == ["e3", "e4", "e2"]
    rec.ttl = -1.0
    assert rec.errors() == []


# ---------------------------------------------------------------------------
# PeerClient: drain and closed behaviour
# ---------------------------------------------------------------------------
async def test_peer_client_drains_requests_enqueued_after_sentinel():
    client = PeerClient(PeerInfo(grpc_address="127.0.0.1:1"))
    q = client._ensure_batch_loop()
    fut = asyncio.get_running_loop().create_future()
    q.put_nowait(None)            # the shutdown sentinel lands first,
    q.put_nowait((req(), fut))    # a straggler right after it
    with pytest.raises(RuntimeError, match="shut down"):
        await asyncio.wait_for(fut, 30)
    await asyncio.wait_for(client.shutdown(), 30)


async def test_peer_client_rejects_after_closed_and_unported_rpcs_raise():
    client = PeerClient(PeerInfo(grpc_address="127.0.0.1:1"))
    await asyncio.wait_for(client.shutdown(), 30)
    with pytest.raises(RuntimeError, match="shut down"):
        await client.get_peer_rate_limit(req())
    # The lease RPCs check no closed state, as the reference's: on a closed
    # client both dial, fail against the dead address and record it as
    # the JAX PeerClient does.
    from gubernator_tpu.service.peer_client import PeerClient as JPeerClient
    from gubernator_tpu.types import PeerInfo as JPeerInfo

    ref = JPeerClient(JPeerInfo(grpc_address="127.0.0.1:1"))
    await asyncio.wait_for(ref.shutdown(), 30)
    try:
        for name in ("lease_grant", "lease_sync"):
            outcomes = []
            for c in (client, ref):
                with pytest.raises(grpc.aio.AioRpcError) as err:
                    await asyncio.wait_for(getattr(c, name)([]), 30)
                outcomes.append((err.value.code(), c.breaker.state.name,
                                 [e.split(": ")[0]
                                  for e in c.get_last_err()]))
            assert outcomes[0] == outcomes[1], name
            assert outcomes[0][0] == grpc.StatusCode.UNAVAILABLE
    finally:
        for c in (client, ref):
            if c._channel is not None:
                await c._channel.close()
    # federation_sync: a round trip to a federated node over gRPC (a GFE1
    # envelope in, its GFA1 ack out), the redelivery of the same envelope
    # acked as a duplicate and applied once.
    from gubernator_tpu_torch.config import Config, DaemonConfig
    from gubernator_tpu_torch.federation import (
        FederationEnvelope, FederationRecord)
    from gubernator_tpu_torch.transport.daemon import spawn_daemon

    d = await asyncio.wait_for(spawn_daemon(DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="",
        data_center="eu", config=Config(
            tpu_platform="cpu", cache_size=1024, tpu_max_batch=64,
            data_center="eu", federation_enabled=True))), 30)
    peer = PeerClient(PeerInfo(grpc_address=d.conf.grpc_listen_address,
                               datacenter="eu"))
    try:
        env = FederationEnvelope(
            origin="us-1:81", region="us", epoch="boot-1", seq=1,
            records=[FederationRecord(name="fed", unique_key="k", hits=3,
                                      limit=10, duration=60_000)])
        acks = [await asyncio.wait_for(peer.federation_sync(env), 30)
                for _ in range(2)]
        assert [(a.origin, a.seq, a.applied) for a in acks] == [
            ("us-1:81", 1, 1), ("us-1:81", 1, 0)]
        (r,) = await d.instance.get_rate_limits([RateLimitRequest(
            name="fed", unique_key="k", hits=0, limit=10,
            duration=60_000)])
        assert r.remaining == 7
        assert d.metrics.sample("gubernator_tpu_federation_envelopes_total",
                                {"result": "duplicate"}) == 1
    finally:
        await asyncio.wait_for(peer.shutdown(), 30)
        await asyncio.wait_for(d.close(), 30)


async def test_peer_client_breaker_open_fails_fast_without_dial():
    metrics = Metrics()
    client = PeerClient(PeerInfo(grpc_address="127.0.0.1:1"),
                        metrics=metrics)
    client.breaker.force_open(60.0)
    with pytest.raises(BreakerOpenError):
        await client.get_peer_rate_limit(req())
    with pytest.raises(BreakerOpenError):
        await client.get_peer_rate_limits([req()])
    with pytest.raises(BreakerOpenError):
        await client.update_peer_globals([])
    assert client._channel is None  # no dial at all
    assert any("circuit breaker open" in m for m in client.get_last_err())
    assert metrics.sample("gubernator_breaker_state",
                          {"peerAddr": "127.0.0.1:1"}) == 2
    await asyncio.wait_for(client.shutdown(), 30)


async def test_peer_client_budget_spent_raises_before_the_rpc():
    from gubernator_tpu_torch.admission import BudgetExhaustedError

    clk = ManualClock(100.0)
    client = PeerClient(PeerInfo(grpc_address="127.0.0.1:1"), clock=clk)
    assert client.rpc_budget([req()]) == (
        client.behaviors.batch_timeout, None)
    timeout, header = client.rpc_budget([req(deadline=100.25)])
    assert timeout == 0.25 and header == "250"
    with pytest.raises(BudgetExhaustedError):
        client.rpc_budget([req(deadline=99.0)])
    await asyncio.wait_for(client.shutdown(), 30)


# ---------------------------------------------------------------------------
# GlobalManager: bounded redelivery against a peer that never answers
# ---------------------------------------------------------------------------
class FailingPeer:
    def __init__(self, addr="10.0.0.9:81"):
        self.info = PeerInfo(grpc_address=addr)
        self.calls = 0
        self.breaker = CircuitBreaker(name=addr)

    async def get_peer_rate_limits(self, reqs):
        self.calls += 1
        raise rpc_error(grpc.StatusCode.UNAVAILABLE, "down")

    async def update_peer_globals(self, updates):
        self.calls += 1
        raise rpc_error(grpc.StatusCode.UNAVAILABLE, "down")


class FakeInstance:
    def __init__(self, peer):
        self.peer = peer

    def get_peer(self, key):
        return self.peer

    def get_peer_list(self):
        return [self.peer]

    async def get_peer_rate_limits(self, reqs):
        return [RateLimitResponse() for _ in reqs]

    async def apply_local(self, reqs):
        return [RateLimitResponse(limit=r.limit, remaining=r.limit)
                for r in reqs]


async def test_failed_flushes_requeue_within_the_redelivery_cap():
    from gubernator_tpu_torch.config import BehaviorConfig

    metrics = Metrics()
    peer = FailingPeer()
    mgr = GlobalManager(
        FakeInstance(peer), BehaviorConfig(global_sync_wait=0.01), metrics,
        resilience=ResilienceConfig(redelivery_limit=3))
    try:
        for i in range(5):
            mgr.queue_hit(req(key=f"h{i}", deadline=1.0))
        assert all(r.deadline is None for r in mgr._hits.values())
        await mgr._send_hits(list(mgr._hits.values()))
        mgr._hits.clear()
        await mgr._send_hits([req(key=f"h{i}") for i in range(5)])
        assert len(mgr._hits) == 3
        assert metrics.sample("gubernator_global_dropped_hits_total") == 2
        assert metrics.sample("gubernator_global_send_queue_length") == 3
        await mgr._broadcast([req(key="u0"), req(key="u1")])
        assert sorted(mgr._updates) == ["res_u0", "res_u1"]
        assert metrics.sample(
            "gubernator_global_redelivered_broadcasts_total") == 2
        assert peer.calls >= 3
    finally:
        await asyncio.wait_for(mgr.close(), 30)
