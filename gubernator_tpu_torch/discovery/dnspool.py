"""DNS-based discovery: poll A/AAAA records of an FQDN.

Functional equivalent of the reference's ``dns.go`` (miekg/dns raw
queries + TTL-driven repoll, dns.go:130-214): resolve the FQDN, map each
address to ``ip:grpc_port`` / ``ip:http_port`` peers, re-poll on an
interval, and emit ``on_update`` when membership changes.  Uses the
system resolver (stdlib) instead of raw DNS packets — record TTLs aren't
visible that way, so the poll interval is fixed (the reference also floors
its delay to ~1s and caps it at 300s).
"""

from __future__ import annotations

import asyncio
import logging
import socket
from typing import Callable, List, Optional

from gubernator_tpu_torch.types import PeerInfo

log = logging.getLogger("gubernator.dns")


class DNSPool:
    def __init__(
        self,
        fqdn: str,
        grpc_port: int,
        http_port: int,
        on_update: Callable[[List[PeerInfo]], None],
        poll_interval: float = 15.0,
        datacenter: str = "",
    ):
        if not fqdn:
            raise ValueError("GUBER_DNS_FQDN is required for dns discovery")
        self.fqdn = fqdn
        self.grpc_port = grpc_port
        self.http_port = http_port
        self.on_update = on_update
        self.poll_interval = poll_interval
        self.datacenter = datacenter
        self._task: Optional[asyncio.Task] = None
        self._last: Optional[List[PeerInfo]] = None

    async def _resolve(self) -> List[PeerInfo]:
        loop = asyncio.get_running_loop()
        infos = await loop.getaddrinfo(
            self.fqdn, None, type=socket.SOCK_STREAM
        )
        peers = {}
        for family, _, _, _, sockaddr in infos:
            ip = sockaddr[0]
            host = f"[{ip}]" if family == socket.AF_INET6 else ip
            peers[ip] = PeerInfo(
                grpc_address=f"{host}:{self.grpc_port}",
                http_address=f"{host}:{self.http_port}" if self.http_port else "",
                datacenter=self.datacenter,
            )
        return sorted(peers.values(), key=lambda p: p.grpc_address)

    async def _loop(self) -> None:
        while True:
            try:
                peers = await self._resolve()
                if peers != self._last:
                    self._last = peers
                    self.on_update(list(peers))
            except OSError as e:
                log.warning("dns lookup of %s failed: %s", self.fqdn, e)
            await asyncio.sleep(self.poll_interval)

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="dns-discovery")

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
