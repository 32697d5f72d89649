"""Static peer list: the no-discovery pool (reference cluster tests inject
peers statically via SetPeers, cluster/cluster.go:151-189)."""

from __future__ import annotations

from typing import Callable, List, Sequence

from gubernator_tpu_torch.types import PeerInfo


class StaticPool:
    def __init__(
        self,
        peers: Sequence[PeerInfo],
        on_update: Callable[[List[PeerInfo]], None],
    ):
        self.peers = list(peers)
        self.on_update = on_update

    async def start(self) -> None:
        self.on_update(list(self.peers))

    async def close(self) -> None:
        pass
