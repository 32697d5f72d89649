"""Persistence hooks: Store (write/read-through) and Loader (snapshot).

Mirrors the reference's interface-driven persistence (``store.go:21-78``):

* :class:`Store` — continuous write-through: ``on_change`` fires after every
  bucket mutation with the full item state (algorithms.go:149-153 call
  sites); ``get`` is consulted on cache miss (read-through,
  algorithms.go:45-51); ``remove`` on eviction.
* :class:`Loader` — one-shot: ``load()`` streams items into the engine at
  startup (workers.go:329-413), ``save(items)`` drains the table at
  shutdown (workers.go:451-534).

Items are plain dicts with the engine's SoA field names::

    {key, algorithm, limit, remaining, remaining_f, duration,
     created_at, updated_at, burst, status, expire_at}

(the union of the reference's ``TokenBucketItem``/``LeakyBucketItem`` +
``CacheItem``, store.go:29-43 / cache.go:29-41).

No store implementation ships beyond mocks and a JSONL file loader —
persistence is the embedding user's job, as in the reference (README
"Optional Disk Persistence").

The port's copy of the JAX package's ``store.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Protocol

from gubernator_tpu_torch.types import RateLimitRequest


class Store(Protocol):
    """Write-through/read-through hooks (reference store.go:49-65).

    With tiered bucket state enabled (docs/tiering.md) the Store is also
    the cold tier's **write-behind** sink: when the bounded cold store
    sheds an entry to make room, it calls ``on_change(None, item)`` —
    ``req`` is None because no request drove the flush — so a third
    durability tier can absorb what the host tier drops.  ``remove`` is
    fired when an item leaves the tiered cache entirely: hot-tier
    eviction with no cold tier configured, or cold-tier TTL expiry.

    **Batched extension (optional).**  A store may additionally expose
    ``put_batch(items)`` / ``remove_batch(keys)``; tier dispatchers
    (``ColdStore._flush_shed`` / ``_sink_remove``) feature-detect them
    with ``hasattr`` and fall back to the per-item ``on_change`` /
    ``remove`` loop, so one cold-tier evict sweep costs one sink call
    instead of one Python call per key.  The SSD tier
    (:class:`~gubernator_tpu_torch.tiering.ssd.SsdStore`) implements both,
    plus the columnar ``put_columns(keys, cols, now)`` fast path that
    skips dict materialization entirely."""

    def on_change(self, req: Optional[RateLimitRequest], item: dict) -> None:
        """Called after every mutation with the full bucket state (and
        with ``req=None`` for cold-tier write-behind flushes)."""

    def get(self, req: RateLimitRequest) -> Optional[dict]:
        """Called on cache miss; return the persisted item or None."""

    def remove(self, key: str) -> None:
        """Called when an item is evicted from the cache."""


class BatchStore(Store, Protocol):
    """A Store that also accepts batched writes/removals (see the
    batched-extension note on :class:`Store` — detection is by
    ``hasattr``, this Protocol just names the contract)."""

    def put_batch(self, items: List[dict]) -> None:
        """Absorb one write-behind sweep's items in a single call."""

    def remove_batch(self, keys: List[str]) -> None:
        """Drop a batch of keys in a single call."""


class Loader(Protocol):
    """Startup/shutdown snapshot hooks (reference store.go:69-78)."""

    def load(self) -> Iterable[dict]: ...

    def save(self, items: Iterable[dict]) -> None: ...


class MockStore:
    """Dict-backed Store (reference MockStore, store.go:80-112)."""

    def __init__(self):
        self.data: Dict[str, dict] = {}
        self.called = {"OnChange()": 0, "Get()": 0, "Remove()": 0}

    def on_change(self, req: RateLimitRequest, item: dict) -> None:
        self.called["OnChange()"] += 1
        self.data[item["key"]] = dict(item)

    def get(self, req: RateLimitRequest) -> Optional[dict]:
        self.called["Get()"] += 1
        item = self.data.get(req.hash_key())
        return dict(item) if item is not None else None

    def remove(self, key: str) -> None:
        self.called["Remove()"] += 1
        self.data.pop(key, None)


class MockLoader:
    """List-backed Loader (reference MockLoader, store.go:114-150)."""

    def __init__(self, items: Optional[List[dict]] = None):
        self.contents: List[dict] = list(items or [])
        self.called = {"Load()": 0, "Save()": 0}

    def load(self) -> Iterable[dict]:
        self.called["Load()"] += 1
        return list(self.contents)

    def save(self, items: Iterable[dict]) -> None:
        self.called["Save()"] += 1
        self.contents = list(items)


class FileLoader:
    """JSONL snapshot-to-disk Loader (orbax-style host snapshot of the
    device table; the simplest durable Loader)."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> Iterable[dict]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def save(self, items: Iterable[dict]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for it in items:
                f.write(json.dumps(it) + "\n")
        os.replace(tmp, self.path)


class ColumnLoader(Protocol):
    """Bulk-snapshot Loader (v2): whole-table numpy columns + key blob
    instead of per-item dicts.  The engine detects this protocol and skips
    dict materialization entirely — at 10M items that is seconds instead
    of minutes.  See engine.SNAP_FIELDS for the schema."""

    def load_columns(self) -> Optional[dict]: ...

    def save_columns(self, snap: dict) -> None: ...


class ColumnFileLoader:
    """NPZ columnar snapshot Loader — the durable form of the v2 bulk
    format (and, via load()/save(), also a valid dict Loader for engines
    that don't speak columns)."""

    def __init__(self, path: str):
        self.path = path

    def load_columns(self) -> Optional[dict]:
        import numpy as np

        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as z:
            snap = {k: z[k] for k in z.files}
        snap["key_blob"] = snap["key_blob"].tobytes()
        return snap

    def save_columns(self, snap: dict) -> None:
        import numpy as np

        tmp = self.path + ".tmp.npz"
        enc = dict(snap)
        enc["key_blob"] = np.frombuffer(snap["key_blob"], np.uint8)
        with open(tmp, "wb") as f:
            np.savez(f, **enc)
        os.replace(tmp, self.path)

    # Dict-protocol compatibility (Loader): columnar on disk either way.
    def load(self) -> Iterable[dict]:
        from gubernator_tpu_torch.ops.snapshot import items_from_snapshot

        snap = self.load_columns()
        return [] if snap is None else items_from_snapshot(snap)

    def save(self, items: Iterable[dict]) -> None:
        from gubernator_tpu_torch.ops.snapshot import snapshot_from_items

        self.save_columns(snapshot_from_items(list(items)))
