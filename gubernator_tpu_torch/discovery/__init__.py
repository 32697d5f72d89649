"""Peer discovery pools: membership sources emitting ``on_update([PeerInfo])``.

The port's copy of the JAX package's ``discovery`` package (host code).

Each pool mirrors one of the reference's discovery backends (``etcd.go``,
``memberlist.go``, ``kubernetes.go``, ``dns.go``): it watches some
membership source and calls ``on_update`` with the full peer list on every
change (the reference's ``UpdateFunc`` contract, config.go:177).  All pools
expose ``await start()`` / ``await close()`` (reference ``PoolInterface``,
etcd.go:38-40).
"""

from gubernator_tpu_torch.discovery.static import StaticPool  # noqa: F401
from gubernator_tpu_torch.discovery.dnspool import DNSPool  # noqa: F401
from gubernator_tpu_torch.discovery.etcdpool import EtcdPool  # noqa: F401
from gubernator_tpu_torch.discovery.k8spool import K8sPool  # noqa: F401
from gubernator_tpu_torch.discovery.gossip import MemberlistPool  # noqa: F401
