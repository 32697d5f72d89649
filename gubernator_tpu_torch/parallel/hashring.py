"""Replicated consistent hashing: key → owning peer.

The port's copy of the JAX package's ``parallel/hashring.py``.  It
re-implements the reference's cluster-sharding construction
(``replicated_hash.go:29-119``) with bit-identical hash placement so a
mixed cluster (or a client that precomputes ownership) agrees on owners:

* 512 virtual nodes per peer (``defaultReplicas``),
* replica point ``i`` of a peer = ``fnv1_64(str(i) + md5hex(grpc_address))``,
* key owner = first ring point with ``hash >= fnv1_64(key)``, wrapping.

The ring is a sorted ``numpy`` array, so resolving a
whole request batch is one vectorized ``np.searchsorted`` instead of a
per-key binary-search loop — ownership for a 4k-request tick costs one
array op (the reference walks ``sort.Search`` per key,
``replicated_hash.go:104-119``).

Hash functions are pluggable like ``GUBER_PEER_PICKER_HASH``
(``config.go:429-438``): ``fnv1`` (default) or ``fnv1a``, both 64-bit.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Generic, List, Optional, Sequence, TypeVar

import numpy as np

DEFAULT_REPLICAS = 512

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def fnv1_64(data: str) -> int:
    """64-bit FNV-1 (multiply then xor)."""
    h = _FNV_OFFSET
    for b in data.encode():
        h = ((h * _FNV_PRIME) & _MASK) ^ b
    return h


def fnv1a_64(data: str) -> int:
    """64-bit FNV-1a (xor then multiply)."""
    h = _FNV_OFFSET
    for b in data.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


HASH_FUNCTIONS: Dict[str, Callable[[str], int]] = {
    "fnv1": fnv1_64,
    "fnv1a": fnv1a_64,
}

P = TypeVar("P")  # peer handle type (PeerInfo, PeerClient, ...)


class ReplicatedConsistentHash(Generic[P]):
    """Consistent-hash ring mapping keys to peer handles.

    Peers are identified by their ``grpc_address`` (the reference's
    ``PeerInfo.HashKey()``); the stored handle can be any object exposing
    ``.info`` → :class:`PeerInfo` or a :class:`PeerInfo` itself.
    """

    def __init__(
        self,
        hash_fn: Optional[Callable[[str], int]] = None,
        replicas: int = DEFAULT_REPLICAS,
    ):
        self.hash_fn = hash_fn or fnv1_64
        self.replicas = int(replicas)
        self._peers: Dict[str, P] = {}
        self._ring_hashes = np.zeros(0, np.uint64)
        self._ring_peers: List[P] = []

    @staticmethod
    def _address_of(peer) -> str:
        info = getattr(peer, "info", peer)
        if callable(info):
            info = info()
        return info.grpc_address

    def new(self) -> "ReplicatedConsistentHash[P]":
        """Empty picker with the same configuration (reference New())."""
        return ReplicatedConsistentHash(self.hash_fn, self.replicas)

    def __len__(self) -> int:
        return len(self._peers)

    def peers(self) -> List[P]:
        return list(self._peers.values())

    def get_by_address(self, grpc_address: str) -> Optional[P]:
        return self._peers.get(grpc_address)

    def add(self, peer: P) -> None:
        """Insert a peer's 512 replica points (reference Add(),
        ``replicated_hash.go:78-91``)."""
        addr = self._address_of(peer)
        self._peers[addr] = peer
        md5hex = hashlib.md5(addr.encode()).hexdigest()
        pts = np.fromiter(
            (self.hash_fn(str(i) + md5hex) for i in range(self.replicas)),
            np.uint64,
            count=self.replicas,
        )
        hashes = np.concatenate([self._ring_hashes, pts])
        ring_peers = self._ring_peers + [peer] * self.replicas
        order = np.argsort(hashes, kind="stable")
        self._ring_hashes = hashes[order]
        self._ring_peers = [ring_peers[i] for i in order]

    def get(self, key: str) -> P:
        """Owning peer for one key."""
        if not self._peers:
            raise RuntimeError("unable to pick a peer; pool is empty")
        h = np.uint64(self.hash_fn(key))
        idx = int(np.searchsorted(self._ring_hashes, h, side="left"))
        if idx == len(self._ring_hashes):
            idx = 0
        return self._ring_peers[idx]

    def get_batch(self, keys: Sequence[str]) -> List[P]:
        """Owners for a whole batch: one vectorized searchsorted."""
        if not self._peers:
            raise RuntimeError("unable to pick a peer; pool is empty")
        hs = np.fromiter(
            (self.hash_fn(k) for k in keys), np.uint64, count=len(keys)
        )
        idx = np.searchsorted(self._ring_hashes, hs, side="left")
        idx[idx == len(self._ring_hashes)] = 0
        return [self._ring_peers[i] for i in idx]


class RegionPicker(Generic[P]):
    """Datacenter → ring map (reference ``region_picker.go:29-103``).

    ``get_clients(key)`` returns the owning peer in *every* region — the
    hook MULTI_REGION behavior routes through.
    """

    def __init__(
        self,
        hash_fn: Optional[Callable[[str], int]] = None,
        replicas: int = DEFAULT_REPLICAS,
    ):
        self.hash_fn = hash_fn or fnv1_64
        self.replicas = int(replicas)
        self._regions: Dict[str, ReplicatedConsistentHash[P]] = {}

    def new(self) -> "RegionPicker[P]":
        return RegionPicker(self.hash_fn, self.replicas)

    def pickers(self) -> Dict[str, ReplicatedConsistentHash[P]]:
        return dict(self._regions)

    def regions(self) -> List[str]:
        """Known datacenter names, sorted (deterministic fan-out order
        for the federation exchange)."""
        return sorted(self._regions)

    def add(self, peer: P) -> None:
        info = getattr(peer, "info", peer)
        if callable(info):
            info = info()
        region = self._regions.get(info.datacenter)
        if region is None:
            region = ReplicatedConsistentHash(self.hash_fn, self.replicas)
            self._regions[info.datacenter] = region
        region.add(peer)

    def peers(self) -> List[P]:
        out: List[P] = []
        for region in self._regions.values():
            out.extend(region.peers())
        return out

    def get(self, key: str, datacenter: str = "") -> P:
        region = self._regions.get(datacenter)
        if region is None:
            raise RuntimeError(f"no peers in datacenter {datacenter!r}")
        return region.get(key)

    def get_clients(self, key: str) -> List[P]:
        """The owning peer for ``key`` in every region."""
        return [region.get(key) for region in self._regions.values()]

    def get_by_address(self, grpc_address: str) -> Optional[P]:
        for region in self._regions.values():
            p = region.get_by_address(grpc_address)
            if p is not None:
                return p
        return None
