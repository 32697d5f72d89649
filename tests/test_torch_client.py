"""The port's lease wire, client helpers and command-line tools on the CPU.

A port daemon (``tpu_platform="cpu"``) over loopback gRPC serves
``LeaseGrant`` / ``LeaseSync``: frames made by the JAX package's encoders,
sent raw, come back with the tokens and acks the port's ``DaemonClient``
gets; malformed frames are refused as the reference refuses them; a
``LeaseSession`` admitting N times on a key costs one grant RPC and
loses nothing on ``close()``; ``/metrics`` counts the grants; a
``PeerClient`` leases from its peer and fails fast behind an open
breaker.  ``client.py``'s helpers equal the JAX package's, and
``cmd/cli.py`` / ``cmd/healthcheck.py`` drive a port daemon.  No JAX
engine, daemon or mesh is built here.
"""

import argparse
import asyncio
import dataclasses
import random
import re
import urllib.request

import grpc
import pytest

from gubernator_tpu import client as jclient
from gubernator_tpu import leases as jl
from gubernator_tpu.transport import fastwire as jfw
from gubernator_tpu_torch import client as tclient
from gubernator_tpu_torch import config, leases as tl
from gubernator_tpu_torch.resilience import BreakerOpenError
from gubernator_tpu_torch.service.peer_client import PeerClient
from gubernator_tpu_torch.transport.daemon import spawn_daemon
from gubernator_tpu_torch.types import PeerInfo, RateLimitRequest

NOW_S = 1_700_000_000.0


def tup(x):
    return None if x is None else dataclasses.astuple(x)


async def port_daemon(secret="wire-secret", **conf):
    """A CPU port daemon on loopback with a fixed lease secret and its
    lease manager on a frozen clock (tokens carry expiries)."""
    import os

    os.environ["GUBER_LEASE_SECRET"] = secret
    try:
        d = await spawn_daemon(config.DaemonConfig(
            grpc_listen_address="127.0.0.1:0",
            http_listen_address="127.0.0.1:0",
            config=config.Config(cache_size=1024, tpu_max_batch=64,
                                 tpu_platform="cpu", **conf)))
    finally:
        os.environ.pop("GUBER_LEASE_SECRET", None)
    d.instance.lease_mgr._clock = lambda: NOW_S
    return d


def raw_call(d, method):
    ch = grpc.aio.insecure_channel(d.conf.grpc_listen_address)
    return ch, ch.unary_unary(f"/pb.gubernator.V1/{method}",
                              request_serializer=lambda b: b,
                              response_deserializer=lambda b: b)


async def test_jax_frames_sent_raw_get_what_the_port_client_gets():
    d = await port_daemon()
    ch, grant = raw_call(d, "LeaseGrant")
    _, sync = raw_call(d, "LeaseSync")
    client = d.client()
    try:
        rows = [("wire", f"k{i}", 100, 60_000, i % 2, 0, 5 + i)
                for i in range(6)]
        jspecs = [jl.LeaseSpec(*r, holder="A") for r in rows]
        tspecs = [tl.LeaseSpec(*r, holder="B") for r in rows]
        jtoks = jfw.parse_lease_grant_resp(
            await grant(jfw.encode_lease_grant_req(jspecs), timeout=30))
        ttoks = await client.lease_grant(tspecs)
        # The signed fields name no holder: both holders' tokens are equal.
        assert [tup(t) for t in jtoks] == [tup(t) for t in ttoks]
        assert all(t.budget == 5 + i for i, t in enumerate(ttoks))
        verifier = d.instance.lease_mgr.verifier()
        assert all(verifier.verify(t) for t in ttoks)
        jsyncs = [jl.LeaseSync("wire", s.key, 2, t.generation, True, "A")
                  for s, t in zip(jspecs, jtoks)]
        tsyncs = [tl.LeaseSync("wire", s.key, 2, t.generation, True, "B")
                  for s, t in zip(tspecs, ttoks)]
        jacks = jfw.parse_lease_sync_resp(
            await sync(jfw.encode_lease_sync_req(jsyncs), timeout=30))
        tacks = await client.lease_sync(tsyncs)
        assert [tup(a) for a in jacks] == [tup(a) for a in tacks]
        assert [a.credited for a in tacks] == [3 + i for i in range(6)]
        probes = await client.get_rate_limits([RateLimitRequest(
            name="wire", unique_key=f"k{i}", hits=0, limit=100,
            duration=60_000, algorithm=i % 2) for i in range(6)])
        assert [r.remaining for r in probes] == [96] * 6
        # A malformed frame is refused as the reference refuses it.
        for method, good in ((grant, jfw.encode_lease_grant_req(jspecs)),
                             (sync, jfw.encode_lease_sync_req(jsyncs))):
            with pytest.raises(grpc.aio.AioRpcError) as err:
                await method(good[:-1], timeout=30)
            assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            assert "malformed" in err.value.details()
    finally:
        await ch.close()
        await client.close()
        await d.close()


async def test_lease_session_costs_one_grant_rpc_and_metrics_count_it():
    d = await port_daemon()
    client = d.client()
    rpcs = {"grant": 0, "sync": 0}

    class Counting:
        async def lease_grant(self, specs):
            rpcs["grant"] += 1
            return await client.lease_grant(specs)

        async def lease_sync(self, syncs):
            rpcs["sync"] += 1
            return await client.lease_sync(syncs)

    try:
        n = 12
        sess = tclient.LeaseSession(
            Counting(), verifier=d.instance.lease_mgr.verifier(),
            want_budget=n, clock=lambda: NOW_S)
        spec = tl.LeaseSpec("sess", "k", 1_000, 60_000)
        for _ in range(n):
            assert await sess.admit(spec) is True
        assert rpcs == {"grant": 1, "sync": 0}
        assert sess.stats().grants == 1
        assert await sess.close() == 0
        assert rpcs["sync"] == 1 and await sess.close() == 0
        [probe] = await client.get_rate_limits([RateLimitRequest(
            name="sess", unique_key="k", hits=0, limit=1_000,
            duration=60_000)])
        assert probe.remaining == 1_000 - n

        def scrape():
            url = f"http://{d.conf.http_listen_address}/metrics"
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.read().decode()

        text = await asyncio.to_thread(scrape)
        assert re.search(r"^gubernator_tpu_lease_grants_total 1\.0$", text,
                         re.M)
        assert "gubernator_tpu_lease_sync_dropped_total 0.0" in text
    finally:
        await client.close()
        await d.close()


async def test_peer_client_leases_from_its_peer_and_fails_fast_when_open():
    d = await port_daemon()
    peer = PeerClient(PeerInfo(grpc_address=d.conf.grpc_listen_address))
    try:
        spec = tl.LeaseSpec("peer", "k", 100, 60_000, want=7, holder="n1")
        [tok] = await peer.lease_grant([spec])
        assert tok.budget == 7
        [ack] = await peer.lease_sync([tl.LeaseSync(
            "peer", "k", 7, tok.generation, True, "n1")])
        assert ack.accepted and ack.credited == 0
        for _ in range(20):
            peer.breaker.record_failure()
        assert not peer.breaker.allow()
        with pytest.raises(BreakerOpenError):
            await peer.lease_grant([spec])
        with pytest.raises(BreakerOpenError):
            await peer.lease_sync([])
        assert any("circuit breaker open" in e for e in peer.get_last_err())
    finally:
        await peer.shutdown()
        await d.close()


async def test_lease_session_extends_offline_as_the_jax_session():
    """Both packages' sessions over a failing client: one grant, then
    the owner goes away; the grace extension admits locally and close()
    counts what it could not deliver."""
    outs = []
    for pkg, L in ((tclient, tl), (jclient, jl)):
        signer = L.LeaseSigner(secret=b"s")
        now = [NOW_S]

        class Client:
            fail = False

            async def lease_grant(self, specs):
                if self.fail:
                    raise ConnectionError("owner unreachable")
                return [signer.mint(s.name, s.key, s.want,
                                    int(now[0] * 1000) + 5_000, 1)
                        for s in specs]

            async def lease_sync(self, syncs):
                raise ConnectionError("owner unreachable")

        c = Client()
        sess = pkg.LeaseSession(c, verifier=signer.verifier(),
                                want_budget=3, clock=lambda: now[0],
                                holder_id="h")
        spec = L.LeaseSpec("off", "k", 10, 60_000)
        seq = [await sess.admit(spec), await sess.admit(spec)]
        c.fail = True
        now[0] += 6
        seq += [await sess.admit(spec), await sess.admit(spec)]
        seq.append(await sess.close(deadline=now[0] + 1))
        seq.append(dataclasses.asdict(sess.stats()))
        outs.append(seq)
    assert outs[0] == outs[1]
    assert outs[0][:4] == [True, True, True, False]


def test_client_helpers_match_jax(monkeypatch):
    from gubernator_tpu.utils import timeutil as jtime
    from gubernator_tpu_torch.utils import timeutil as ttime

    monkeypatch.setattr(jtime, "now_ms", lambda: 1_700_000_000_000)
    monkeypatch.setattr(ttime, "now_ms", lambda: 1_700_000_000_000)
    assert (tclient.SECOND, tclient.MINUTE) == (jclient.SECOND,
                                                 jclient.MINUTE)
    for v in (0.0, 1.5, 90.25):
        assert tclient.to_timestamp(v) == jclient.to_timestamp(v)
    for ts in (1_699_999_990_000, 1_700_000_012_345):
        assert tclient.from_timestamp(ts) == jclient.from_timestamp(ts)
        assert tclient.from_unix_milliseconds(ts) == \
            jclient.from_unix_milliseconds(ts)
    tclient.sleep_until_reset(1_699_999_999_000)   # in the past: no wait
    asyncio.run(tclient.asleep_until_reset(1_699_999_999_000))
    peers = [PeerInfo(grpc_address=f"10.0.0.{i}:81") for i in range(5)]
    random.seed(3)
    a = tclient.random_peer(peers)
    random.seed(3)
    assert a is peers[[p.grpc_address for p in peers].index(
        jclient.random_peer(peers).grpc_address)]
    s = tclient.random_string(24)
    assert len(s) == 24 and s.isalnum()
    with pytest.raises(ValueError, match="server is empty"):
        tclient.dial_v1("")

    async def dial():
        c = tclient.dial_v1("127.0.0.1:1")
        assert hasattr(c, "lease_grant") and hasattr(c, "lease_sync")
        await c.close()

    asyncio.run(dial())


async def test_cli_load_generator_drives_a_port_daemon(capsys):
    from gubernator_tpu_torch.cmd import cli

    d = await port_daemon()
    try:
        random.seed(7)
        await cli.run(argparse.Namespace(
            address=d.conf.grpc_listen_address, limits=20, requests=200,
            concurrency=16, timeout=5.0))
    finally:
        await d.close()
    out = capsys.readouterr().out
    assert "200 requests" in out and "errors=0" in out
    assert int(re.search(r"over_limit=(\d+)", out).group(1)) > 0


async def test_healthcheck_probes_a_port_daemon(monkeypatch, capsys):
    from gubernator_tpu_torch.cmd import healthcheck

    d = await port_daemon()
    try:
        monkeypatch.setenv("GUBER_HTTP_ADDRESS",
                           d.conf.http_listen_address)
        monkeypatch.delenv("GUBER_STATUS_HTTP_ADDRESS", raising=False)
        for argv, word in (([], "healthy"), (["--ready"], "ready")):
            rc = await asyncio.to_thread(healthcheck.main, argv)
            assert rc == 0 and capsys.readouterr().out.strip() == word
    finally:
        await d.close()
    monkeypatch.setenv("GUBER_HTTP_ADDRESS", "127.0.0.1:1")
    assert healthcheck.main([]) == 2
    assert "healthcheck failed" in capsys.readouterr().err
