"""Tiered bucket state: the host-side cold tier between HBM and a Store.

The engine's device table (L1) is fixed-capacity; before this package,
LRU reclaim *destroyed* victim rows (the evict scatter zeroes them), so
any key cycling out and back in restarted with a full budget — a
rate-limit bypass under churn.  The cold tier is a bounded host-side
columnar store the engine demotes victims into (readback-then-evict)
and promotes misses out of (one batched restore scatter per tick), so
bucket continuity survives hot↔cold cycling.  Below it, the SSD tier
(ssd.py) absorbs the cold store's overflow into append-only mmap slab
files — billions of keys under bounded RAM.  See docs/tiering.md.

The port's copy of the JAX package's ``tiering/__init__.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from gubernator_tpu_torch.tiering.coldstore import ColdStore
from gubernator_tpu_torch.tiering.ssd import SsdStore

__all__ = ["ColdStore", "SsdStore"]
