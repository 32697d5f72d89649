"""etcd-based discovery over etcd's v3 HTTP/JSON gateway.

Functional equivalent of the reference's ``etcd.go``: register this node
under ``<prefix><grpc_address>`` with a 30s lease kept alive in the
background, re-register if the lease is lost (etcd.go:221-315), watch the
prefix for membership changes (polled here instead of a gRPC watch stream —
the python etcd3 client isn't in the image, so this speaks the JSON gateway
with aiohttp), and delete + revoke on close.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Callable, List, Optional, Sequence

import aiohttp

from gubernator_tpu_torch.types import PeerInfo

log = logging.getLogger("gubernator.etcd")

LEASE_TTL_S = 30  # etcd.go:31-36 etcdLeaseTTL


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


class EtcdPool:
    def __init__(
        self,
        endpoints: Sequence[str],
        key_prefix: str,
        info: PeerInfo,
        on_update: Callable[[List[PeerInfo]], None],
        poll_interval: float = 2.0,
        username: str = "",
        password: str = "",
    ):
        self.base = self._base_url(endpoints)
        self.key_prefix = key_prefix
        self.info = info
        self.on_update = on_update
        self.poll_interval = poll_interval
        self.auth = (username, password) if username else None
        self._lease_id: Optional[int] = None
        self._session: Optional[aiohttp.ClientSession] = None
        self._tasks: List[asyncio.Task] = []
        self._last: Optional[List[PeerInfo]] = None

    @staticmethod
    def _base_url(endpoints: Sequence[str]) -> str:
        ep = endpoints[0] if endpoints else "localhost:2379"
        if not ep.startswith("http"):
            ep = f"http://{ep}"
        return ep.rstrip("/")

    async def _post(self, path: str, payload: dict) -> dict:
        async with self._session.post(
            f"{self.base}{path}", json=payload
        ) as resp:
            resp.raise_for_status()
            return await resp.json()

    # ------------------------------------------------------------------
    async def _register(self) -> None:
        """Grant a lease and put our PeerInfo under it (etcd.go:233-259)."""
        out = await self._post("/v3/lease/grant", {"TTL": LEASE_TTL_S, "ID": 0})
        self._lease_id = int(out["ID"])
        key = self.key_prefix + self.info.grpc_address
        value = json.dumps(
            {
                "grpc_address": self.info.grpc_address,
                "http_address": self.info.http_address,
                "datacenter": self.info.datacenter,
            }
        )
        await self._post(
            "/v3/kv/put",
            {"key": _b64(key), "value": _b64(value), "lease": self._lease_id},
        )

    async def _keepalive_loop(self) -> None:
        """Refresh the lease; re-register from scratch when it's lost."""
        while True:
            await asyncio.sleep(LEASE_TTL_S / 3)
            try:
                out = await self._post(
                    "/v3/lease/keepalive", {"ID": self._lease_id}
                )
                ttl = int(out.get("result", {}).get("TTL", 0))
                if ttl <= 0:
                    raise RuntimeError("lease expired")
            except Exception as e:
                log.warning("etcd keepalive lost (%s); re-registering", e)
                try:
                    await self._register()
                except Exception as e2:
                    log.error("etcd re-register failed: %s", e2)

    async def _watch_loop(self) -> None:
        """Poll the prefix and emit membership changes (etcd.go:109-219)."""
        range_end = self.key_prefix[:-1] + chr(ord(self.key_prefix[-1]) + 1)
        while True:
            try:
                out = await self._post(
                    "/v3/kv/range",
                    {"key": _b64(self.key_prefix), "range_end": _b64(range_end)},
                )
                peers = []
                for kv in out.get("kvs", []):
                    try:
                        v = json.loads(base64.b64decode(kv["value"]))
                        peers.append(
                            PeerInfo(
                                grpc_address=v.get("grpc_address", ""),
                                http_address=v.get("http_address", ""),
                                datacenter=v.get("datacenter", ""),
                            )
                        )
                    except (ValueError, KeyError):
                        continue
                peers.sort(key=lambda p: p.grpc_address)
                if peers != self._last:
                    self._last = peers
                    self.on_update(list(peers))
            except Exception as e:
                log.warning("etcd range failed: %s", e)
            await asyncio.sleep(self.poll_interval)

    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._session = aiohttp.ClientSession(
            auth=aiohttp.BasicAuth(*self.auth) if self.auth else None
        )
        await self._register()
        self._tasks = [
            asyncio.create_task(self._keepalive_loop(), name="etcd-keepalive"),
            asyncio.create_task(self._watch_loop(), name="etcd-watch"),
        ]

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        try:
            key = self.key_prefix + self.info.grpc_address
            await self._post("/v3/kv/deleterange", {"key": _b64(key)})
            if self._lease_id:
                await self._post("/v3/lease/revoke", {"ID": self._lease_id})
        except Exception:
            pass
        if self._session is not None:
            await self._session.close()
