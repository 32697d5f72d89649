"""Kubernetes discovery: poll Endpoints or Pods via the API server.

Functional equivalent of the reference's ``kubernetes.go``: watch ready
addresses behind a label selector, mechanism switchable between
``endpoints`` and ``pods`` (kubernetes.go:45-63,101-110), peers built from
address + ``pod_port``, self detected via ``pod_ip``.  Speaks the k8s REST
API directly with aiohttp using in-cluster credentials (service-account
token + CA), so no kubernetes client package is required.
"""

from __future__ import annotations

import asyncio
import logging
import os
import ssl
from typing import Callable, List, Optional

import aiohttp

from gubernator_tpu_torch.types import PeerInfo

log = logging.getLogger("gubernator.k8s")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class K8sPool:
    def __init__(
        self,
        namespace: str,
        selector: str,
        pod_ip: str,
        pod_port: str,
        on_update: Callable[[List[PeerInfo]], None],
        mechanism: str = "endpoints",
        poll_interval: float = 5.0,
        api_server: str = "",
        datacenter: str = "",
    ):
        if mechanism not in ("endpoints", "pods"):
            raise ValueError(
                "GUBER_K8S_WATCH_MECHANISM must be 'endpoints' or 'pods'"
            )
        self.namespace = namespace or "default"
        self.selector = selector
        self.pod_ip = pod_ip
        self.pod_port = pod_port
        self.on_update = on_update
        self.mechanism = mechanism
        self.poll_interval = poll_interval
        self.datacenter = datacenter
        host = api_server or (
            f"https://{os.environ.get('KUBERNETES_SERVICE_HOST', 'kubernetes.default.svc')}"
            f":{os.environ.get('KUBERNETES_SERVICE_PORT', '443')}"
        )
        self.base = host.rstrip("/")
        self._session: Optional[aiohttp.ClientSession] = None
        self._task: Optional[asyncio.Task] = None
        self._last: Optional[List[PeerInfo]] = None

    def _make_session(self) -> aiohttp.ClientSession:
        headers = {}
        token_path = os.path.join(SA_DIR, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                headers["Authorization"] = f"Bearer {f.read().strip()}"
        ca_path = os.path.join(SA_DIR, "ca.crt")
        if os.path.exists(ca_path):
            ctx = ssl.create_default_context(cafile=ca_path)
        else:
            ctx = ssl.create_default_context()
        return aiohttp.ClientSession(
            headers=headers, connector=aiohttp.TCPConnector(ssl=ctx)
        )

    async def _list_addresses(self) -> List[str]:
        if self.mechanism == "endpoints":
            url = (
                f"{self.base}/api/v1/namespaces/{self.namespace}/endpoints"
                f"?labelSelector={self.selector}"
            )
            async with self._session.get(url) as resp:
                resp.raise_for_status()
                out = await resp.json()
            addrs: List[str] = []
            for item in out.get("items", []):
                for subset in item.get("subsets", []) or []:
                    for addr in subset.get("addresses", []) or []:
                        if addr.get("ip"):
                            addrs.append(addr["ip"])
            return addrs
        url = (
            f"{self.base}/api/v1/namespaces/{self.namespace}/pods"
            f"?labelSelector={self.selector}"
        )
        async with self._session.get(url) as resp:
            resp.raise_for_status()
            out = await resp.json()
        addrs = []
        for pod in out.get("items", []):
            status = pod.get("status", {})
            if status.get("phase") != "Running":
                continue
            conds = {
                c.get("type"): c.get("status")
                for c in status.get("conditions", []) or []
            }
            if conds.get("Ready") == "True" and status.get("podIP"):
                addrs.append(status["podIP"])
        return addrs

    async def _loop(self) -> None:
        while True:
            try:
                ips = sorted(set(await self._list_addresses()))
                peers = [
                    PeerInfo(
                        grpc_address=f"{ip}:{self.pod_port}",
                        datacenter=self.datacenter,
                    )
                    for ip in ips
                ]
                if peers != self._last:
                    self._last = peers
                    self.on_update(list(peers))
            except Exception as e:
                log.warning("k8s discovery poll failed: %s", e)
            await asyncio.sleep(self.poll_interval)

    async def start(self) -> None:
        self._session = self._make_session()
        self._task = asyncio.create_task(self._loop(), name="k8s-discovery")

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._session is not None:
            await self._session.close()
