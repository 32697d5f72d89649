"""Local development cluster: ``python -m gubernator_tpu_torch.cmd.cluster_main``.

The reference's ``cmd/gubernator-cluster/main.go``: a 6-instance in-process
cluster on fixed localhost ports (gRPC 9990-9995, HTTP 10090-10095) for
client development; prints "Ready" once all instances answer health
checks.  The engines run on the card; ``GUBER_TPU_PLATFORM=cpu`` puts
them on the CPU's plain versions.
"""

from __future__ import annotations

import asyncio
import signal
import sys

from gubernator_tpu_torch.config import (
    BehaviorConfig, Config, DaemonConfig, env_knob)
from gubernator_tpu_torch.transport.daemon import Daemon
from gubernator_tpu_torch.types import PeerInfo

GRPC_PORTS = range(9990, 9996)  # reference uses :9990-:9995


async def run() -> None:
    platform = env_knob("GUBER_TPU_PLATFORM", "")
    daemons = []
    for port in GRPC_PORTS:
        conf = DaemonConfig(
            grpc_listen_address=f"127.0.0.1:{port}",
            http_listen_address=f"127.0.0.1:{port + 100}",
            peer_discovery_type="none",
        )
        conf.config = Config(behaviors=BehaviorConfig(), cache_size=50_000,
                             tpu_platform=platform)
        d = Daemon(conf)
        await d.start()
        daemons.append(d)
    peers = [
        PeerInfo(
            grpc_address=d.conf.grpc_listen_address,
            http_address=d.conf.http_listen_address,
        )
        for d in daemons
    ]
    for d in daemons:
        d.set_peers(peers)
    for d in daemons:
        await d.wait_for_connect()
    print("Ready", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    for d in daemons:
        await d.close()


def main() -> int:
    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
