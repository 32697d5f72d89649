"""The port's consistent-hash ring against the JAX package's.

Ring placement decides which node owns a key, so every cluster parity
check rests on it: the port's ``ReplicatedConsistentHash`` must place
every key exactly where the JAX ring does, for the same peer addresses
and hash function.  Fixed addresses here: two clusters on ephemeral
ports own keys differently, so the cluster tests compare answers, never
placements.
"""

import numpy as np
import pytest

from gubernator_tpu.parallel import hashring as jring
from gubernator_tpu.types import PeerInfo as JPeerInfo
from gubernator_tpu_torch.parallel.hashring import (
    DEFAULT_REPLICAS,
    HASH_FUNCTIONS,
    RegionPicker,
    ReplicatedConsistentHash,
    fnv1_64,
    fnv1a_64,
)
from gubernator_tpu_torch.types import PeerInfo

ADDRESSES = ["10.0.0.1:81", "10.0.0.2:81", "gubernator-2.svc:1051",
             "[::1]:9990", "127.0.0.1:41873"]


def seeded_keys(n=10_000, seed=7):
    rng = np.random.default_rng(seed)
    names = rng.integers(0, 50, n)
    ids = rng.integers(0, 1 << 40, n)
    return [f"svc{a}_acct:{b}" for a, b in zip(names, ids)]


def test_fnv_vectors():
    """Published FNV-1 / FNV-1a 64-bit vectors, and the JAX functions'
    values on the seeded keys."""
    assert fnv1_64("") == 0xCBF29CE484222325
    assert fnv1_64("a") == 0xAF63BD4C8601B7BE
    assert fnv1_64("foobar") == 0x340D8765A4DDA9C2
    assert fnv1a_64("a") == 0xAF63DC4C8601EC8C
    assert fnv1a_64("foobar") == 0x85944171F73967E8
    for k in seeded_keys(500) + ["", "ü-ключ"]:
        assert fnv1_64(k) == jring.fnv1_64(k)
        assert fnv1a_64(k) == jring.fnv1a_64(k)
    assert sorted(HASH_FUNCTIONS) == sorted(jring.HASH_FUNCTIONS)
    assert DEFAULT_REPLICAS == jring.DEFAULT_REPLICAS == 512


@pytest.mark.parametrize("hash_name", ["fnv1", "fnv1a"])
@pytest.mark.parametrize("n_peers", [1, 2, 3, 4, 5])
def test_ring_places_every_key_as_the_jax_ring(hash_name, n_peers):
    port = ReplicatedConsistentHash(HASH_FUNCTIONS[hash_name])
    ref = jring.ReplicatedConsistentHash(jring.HASH_FUNCTIONS[hash_name])
    for a in ADDRESSES[:n_peers]:
        port.add(PeerInfo(grpc_address=a))
        ref.add(JPeerInfo(grpc_address=a))
    np.testing.assert_array_equal(port._ring_hashes, ref._ring_hashes)
    keys = seeded_keys()
    got = [p.grpc_address for p in port.get_batch(keys)]
    want = [p.grpc_address for p in ref.get_batch(keys)]
    assert got == want
    assert [port.get(k).grpc_address for k in keys[:1000]] == want[:1000]
    assert len(set(got)) == n_peers


@pytest.mark.parametrize("hash_fn,expected", [
    (fnv1_64, {"a.svc.local": 2948, "b.svc.local": 3592,
               "c.svc.local": 3460}),
    (fnv1a_64, {"a.svc.local": 3110, "b.svc.local": 3856,
                "c.svc.local": 3034}),
])
def test_distribution_golden_vs_reference(hash_fn, expected):
    """The Go reference's pinned per-host counts (replicated_hash_test.go
    :56-100) on 10k IPv4-string keys."""
    ring = ReplicatedConsistentHash(hash_fn)
    for h in expected:
        ring.add(PeerInfo(grpc_address=h))
    keys = [f"192.168.{i >> 8}.{i & 255}" for i in range(10_000)]
    counts = dict.fromkeys(expected, 0)
    for owner in ring.get_batch(keys):
        counts[owner.grpc_address] += 1
    assert counts == expected


def test_adding_a_peer_moves_only_the_keys_it_takes():
    ring = ReplicatedConsistentHash()
    for a in ADDRESSES[:3]:
        ring.add(PeerInfo(grpc_address=a))
    keys = seeded_keys(4000)
    before = [p.grpc_address for p in ring.get_batch(keys)]
    bigger = ring.new()
    for a in ADDRESSES[:4]:
        bigger.add(PeerInfo(grpc_address=a))
    after = [p.grpc_address for p in bigger.get_batch(keys)]
    moved = [(b, a) for b, a in zip(before, after) if b != a]
    assert moved and all(a == ADDRESSES[3] for _, a in moved)
    assert bigger.get_by_address(ADDRESSES[3]).grpc_address == ADDRESSES[3]
    assert len(bigger) == 4 and len(ring.new()) == 0
    with pytest.raises(RuntimeError):
        ring.new().get("k")


def test_region_picker_matches_the_jax_picker():
    port, ref = RegionPicker(), jring.RegionPicker()
    layout = [("10.1.0.1:81", "dc-a"), ("10.1.0.2:81", "dc-a"),
              ("10.2.0.1:81", "dc-b"), ("10.3.0.1:81", "dc-c"),
              ("10.3.0.2:81", "dc-c")]
    for addr, dc in layout:
        port.add(PeerInfo(grpc_address=addr, datacenter=dc))
        ref.add(JPeerInfo(grpc_address=addr, datacenter=dc))
    assert port.regions() == ref.regions() == ["dc-a", "dc-b", "dc-c"]
    assert (sorted(p.grpc_address for p in port.peers())
            == sorted(a for a, _ in layout))
    for k in seeded_keys(300):
        got = [p.grpc_address for p in port.get_clients(k)]
        assert got == [p.grpc_address for p in ref.get_clients(k)]
        assert len({p.datacenter for p in port.get_clients(k)}) == 3
        assert (port.get(k, "dc-c").grpc_address
                == ref.get(k, "dc-c").grpc_address)
    assert port.get_by_address("10.2.0.1:81").datacenter == "dc-b"
    assert port.get_by_address("10.9.9.9:81") is None
    with pytest.raises(RuntimeError, match="no peers"):
        port.get("k", "dc-z")
