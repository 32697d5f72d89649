"""The port's TLS: the AutoTLS chain and a forward between port daemons
over mutual TLS, with the plaintext status listener (reference
``tls_test.go:73-343``).  Certificates come from the port's own
``tlsutil``; the JAX package checks its copy in ``tests/test_tls.py``.
Every await is bounded.
"""

import asyncio
import json
import socket
import ssl
import urllib.request

import pytest

x509 = pytest.importorskip(
    "cryptography.x509", reason="TLS tests need the cryptography package")
from cryptography.hazmat.primitives import serialization  # noqa: E402

from gubernator_tpu_torch.config import (
    BehaviorConfig, Config, DaemonConfig, TLSSettings)
from gubernator_tpu_torch.transport.daemon import DaemonClient, spawn_daemon
from gubernator_tpu_torch.transport.tlsutil import (
    generate_cert, generate_self_ca, setup_tls)
from gubernator_tpu_torch.types import PeerInfo, RateLimitRequest

T = 30


@pytest.fixture(scope="module")
def ca_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("certs")
    ca_pem, ca_key_pem, ca_cert, ca_key = generate_self_ca()
    srv_pem, srv_key = generate_cert(ca_cert, ca_key)
    cli_pem, cli_key = generate_cert(ca_cert, ca_key, client=True)
    paths = {}
    for name, blob in [("ca.pem", ca_pem), ("server.pem", srv_pem),
                       ("server.key", srv_key), ("client.pem", cli_pem),
                       ("client.key", cli_key)]:
        (d / name).write_bytes(blob)
        paths[name] = str(d / name)
    return paths


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _conf(tls, http=False, status=False):
    return DaemonConfig(
        grpc_listen_address="127.0.0.1:0",
        http_listen_address=f"127.0.0.1:{_free_port()}" if http else "",
        http_status_listen_address=(
            f"127.0.0.1:{_free_port()}" if status else ""),
        tls=tls,
        config=Config(behaviors=BehaviorConfig(batch_timeout=T),
                      cache_size=256, tpu_max_batch=64, tpu_platform="cpu"))


def _req(key):
    return RateLimitRequest(name="tls", unique_key=key, hits=1, limit=100,
                            duration=30_000)


async def _ask(d, key):
    client = DaemonClient(d.conf.grpc_listen_address,
                          credentials=d.tls.channel_credentials())
    try:
        (r,) = await asyncio.wait_for(
            client.get_rate_limits([_req(key)], timeout=T), T)
    finally:
        await client.close()
    return r


async def test_auto_tls_chain_and_round_trip():
    d = await asyncio.wait_for(spawn_daemon(_conf(
        TLSSettings(auto_tls=True, client_auth="require"))), T)
    try:
        b = d.tls
        ca = x509.load_pem_x509_certificate(b.ca_pem)
        srv = x509.load_pem_x509_certificate(b.cert_pem)
        cli = x509.load_pem_x509_certificate(b.client_cert_pem)
        assert srv.issuer == ca.subject and cli.issuer == ca.subject
        san = srv.extensions.get_extension_for_class(
            x509.SubjectAlternativeName)
        assert "localhost" in san.value.get_values_for_type(x509.DNSName)
        key = serialization.load_pem_private_key(b.key_pem, None)
        assert (key.public_key().public_numbers()
                == srv.public_key().public_numbers())
        r = await _ask(d, "auto")
        assert (r.error, r.remaining) == ("", 99)
    finally:
        await asyncio.wait_for(d.close(), T)
    assert setup_tls(None) is None and setup_tls(TLSSettings()) is None


async def test_mtls_forward_and_plaintext_status_listener(ca_files):
    tls = TLSSettings(
        ca_file=ca_files["ca.pem"], cert_file=ca_files["server.pem"],
        key_file=ca_files["server.key"], client_auth="require-and-verify",
        client_auth_ca_file=ca_files["ca.pem"],
        client_auth_cert_file=ca_files["client.pem"],
        client_auth_key_file=ca_files["client.key"])
    d1 = await asyncio.wait_for(
        spawn_daemon(_conf(tls, http=True, status=True)), T)
    d2 = await asyncio.wait_for(spawn_daemon(_conf(tls)), T)
    try:
        peers = [PeerInfo(grpc_address=d.conf.grpc_listen_address)
                 for d in (d1, d2)]
        d1.set_peers(peers)
        d2.set_peers(peers)
        key = next(k for k in (f"{i}mk" for i in range(256))
                   if not d1.instance.get_peer(f"tls_{k}").info.is_owner)
        r = await _ask(d1, key)
        assert (r.error, r.remaining) == ("", 99)
        assert r.metadata == {"owner": d2.conf.grpc_listen_address}
        assert d2.metrics.sample(
            "gubernator_grpc_request_counts_total",
            {"status": "success",
             "method": "/pb.gubernator.PeersV1/GetPeerRateLimits"}) >= 1
        r = await _ask(d2, key)
        assert r.remaining == 98  # the same bucket, on its owner

        def fetch(url, ctx=None):
            with urllib.request.urlopen(url, timeout=T, context=ctx) as f:
                return json.load(f)

        body = await asyncio.wait_for(asyncio.to_thread(
            fetch, f"http://{d1.conf.http_status_listen_address}/healthz"),
            T)
        assert (body["status"], body["peer_count"]) == ("healthy", 2)
        no_cert = ssl.create_default_context(cafile=ca_files["ca.pem"])
        no_cert.check_hostname = False
        url = f"https://{d1.conf.http_listen_address}/v1/HealthCheck"
        with pytest.raises(Exception):
            await asyncio.wait_for(asyncio.to_thread(fetch, url, no_cert), T)
        with_cert = ssl.create_default_context(cafile=ca_files["ca.pem"])
        with_cert.check_hostname = False
        with_cert.load_cert_chain(ca_files["client.pem"],
                                  ca_files["client.key"])
        body = await asyncio.wait_for(
            asyncio.to_thread(fetch, url, with_cert), T)
        assert body["status"] == "healthy"
    finally:
        await asyncio.wait_for(d1.close(), T)
        await asyncio.wait_for(d2.close(), T)
