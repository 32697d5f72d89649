"""Client convenience surface (reference client.go + python/gubernator).

The port's copy of the JAX package's ``client`` module.  The full async
client lives in
:class:`gubernator_tpu_torch.transport.daemon.DaemonClient`; this module adds
the small helpers the reference ships for callers — duration constants,
millisecond-timestamp converters (client.go:70-86), ``sleep_until_reset``
(python/gubernator/__init__.py:14), peer/string randomizers
(client.go:89-105) — and a ``dial_v1`` that mirrors ``DialV1Server``
(client.go:44-65: optional TLS, tracing-instrumented channel), and
:class:`LeaseSession`, which drives a :class:`LeaseCache` over a
dialed daemon's lease RPCs.
"""

from __future__ import annotations

import asyncio
import random
import secrets
import string
import time
from typing import Sequence

from gubernator_tpu_torch.types import PeerInfo
from gubernator_tpu_torch.utils import timeutil

MILLISECOND = 1
SECOND = 1000 * MILLISECOND
MINUTE = 60 * SECOND


def to_timestamp(duration_s: float) -> int:
    """Seconds → the millisecond duration/reset_time unit of the API
    (client.go:70 ToTimeStamp, from Go's time.Duration)."""
    return int(duration_s * 1000)


def from_timestamp(ts_ms: int) -> float:
    """Unix-ms timestamp → seconds from now (client.go:76 FromTimeStamp);
    negative when ``ts_ms`` is in the future."""
    return (timeutil.now_ms() - ts_ms) / 1000.0


def from_unix_milliseconds(ts_ms: int) -> float:
    """Unix-ms timestamp → unix seconds (client.go:84)."""
    return ts_ms / 1000.0


def sleep_until_reset(reset_time_ms: int) -> None:
    """Block until a response's ``reset_time`` has passed
    (python/gubernator/__init__.py:14)."""
    delta = reset_time_ms - timeutil.now_ms()
    if delta > 0:
        time.sleep(delta / 1000.0)


async def asleep_until_reset(reset_time_ms: int) -> None:
    """Async variant of :func:`sleep_until_reset`."""
    delta = reset_time_ms - timeutil.now_ms()
    if delta > 0:
        await asyncio.sleep(delta / 1000.0)


def random_peer(peers: Sequence[PeerInfo]) -> PeerInfo:
    """A random peer from the list (client.go:89 RandomPeer)."""
    return random.choice(list(peers))


def random_string(n: int) -> str:
    """Random alphanumeric string of length ``n`` (client.go:97),
    crypto-sourced like the reference."""
    alphabet = string.digits + string.ascii_uppercase + string.ascii_lowercase
    return "".join(secrets.choice(alphabet) for _ in range(n))


def dial_v1(server: str, tls=None):
    """Connect to a daemon, returning the async client
    (reference DialV1Server, client.go:44-65).

    ``tls`` may be a :class:`gubernator_tpu_torch.transport.tlsutil.TLSBundle`
    (client credentials derived from it) or ready-made
    ``grpc.ChannelCredentials``.
    """
    import grpc

    from gubernator_tpu_torch.transport.daemon import DaemonClient

    if not server:
        raise ValueError("server is empty; must provide a server")
    creds = None
    if tls is not None:
        creds = (
            tls if isinstance(tls, grpc.ChannelCredentials)
            else tls.channel_credentials()
        )
    return DaemonClient(server, credentials=creds)


class LeaseSession:
    """Runs a :class:`~gubernator_tpu_torch.leases.LeaseCache` against a
    dialed daemon, asynchronously (docs/leases.md).

    While a signed lease holds budget, :meth:`admit` answers locally —
    zero server round trips; at the lease edges (grant, exhaustion,
    expiry) it runs one sync+grant round over the client's lease RPCs.
    ``admit`` returning None means the lease tier has no answer (server
    declined to delegate, or budget cap below the hits batch): fall back
    to ``client.get_rate_limits`` for an ordinary server decision.

    ``close()`` flushes unsynced consumption through the normal sync
    path, bounded and deadline-capped — see :meth:`LeaseCache.close`.
    """

    def __init__(self, client, *, verifier=None, want_budget: int = 0,
                 offline_grace_ms: int = 5_000,
                 max_offline_extensions: int = 3, clock=time.time,
                 holder_id: str = None):
        from gubernator_tpu_torch.leases import LeaseCache

        self.client = client
        self.cache = LeaseCache(
            clock=clock, verifier=verifier, want_budget=want_budget,
            offline_grace_ms=offline_grace_ms,
            max_offline_extensions=max_offline_extensions,
            holder_id=holder_id,
        )

    async def admit(self, spec, hits: int = 1):
        """True/False = local lease verdict; None = no lease path, make
        an ordinary server request."""
        from gubernator_tpu_torch.leases.cache import ADMIT, NEED_LEASE

        c = self.cache
        verdict = c.try_admit(spec, hits)
        if verdict == ADMIT:
            return True
        if verdict != NEED_LEASE:
            c.metric_local_denies += hits
            return False
        # One sync+grant round, then one retry (the cache's convenience
        # loop, inlined with awaits; RPC failure → bounded offline
        # extension instead of failing the caller).
        try:
            syncs = c.take_syncs()
            if syncs:
                c.note_synced(syncs, await self.client.lease_sync(syncs))
            tokens = await self.client.lease_grant([c.fill_want(spec)])
        except Exception:
            if c.extend_offline(spec):
                if c.try_admit(spec, hits) == ADMIT:
                    return True
                c.metric_local_denies += hits
                return False
            return None
        if not c.note_grant(spec, tokens[0] if tokens else None):
            return None
        verdict = c.try_admit(spec, hits)
        if verdict == ADMIT:
            return True
        if verdict == NEED_LEASE:
            return None
        c.metric_local_denies += hits
        return False

    async def close(self, deadline: float = None, attempts: int = 2) -> int:
        """Drain unsynced consumption through the server sync path;
        returns admissions left unsynced (also counted in the cache's
        ``metric_sync_lost``)."""
        c = self.cache
        if not c.mark_closed():
            return 0
        for _ in range(max(1, attempts)):
            if deadline is not None and c.now_ms() >= deadline * 1000:
                break
            syncs = c.take_syncs(release=True)
            if not syncs:
                break
            try:
                acks = await self.client.lease_sync(syncs)
            except Exception:
                continue
            c.note_synced(syncs, acks)
        return c.abandon_unsynced()

    def stats(self):
        return self.cache.stats()
