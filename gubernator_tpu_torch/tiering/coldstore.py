"""Host-side columnar cold store for demoted bucket state.

One tier below the device table: struct-of-arrays numpy columns (the
Loader v2 snapshot schema, ``engine.SNAP_FIELDS``) plus a host key map.
The engine demotes LRU victims here via the readback-then-evict path and
promotes misses back out in one batched restore scatter — so bucket
state (remaining / remaining_f / created_at / status) survives hot↔cold
cycling instead of evaporating with the evict scatter.

Bounds:

* **TTL** — entries whose ``expire_at`` has passed are dropped at
  lookup, at insert, and by :meth:`expire` sweeps (the reference's
  expired-on-read removal, lrucache.go:88-103, applied host-side).
* **Entry budget** — ``capacity`` caps live entries; inserting past it
  evicts the cold tier's own LRU tail (by a monotonic touch clock).
  Overflow victims optionally **write-behind** to the :class:`Store`
  protocol (``on_change`` with ``req=None`` — see store.py) so a third
  durability tier can absorb what the host tier sheds.

All operations are batched and vectorized over numpy columns; the only
per-key Python is the dict hop of the key map — the same cost profile
as the engine's host slot map.  Thread-safe: the engine's background
reclaimer demotes concurrently with serving-path promotes.

The port's copy of the JAX package's ``tiering/coldstore.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

# Field schema shared with the engine's columnar snapshot (the Loader v2
# wire format; engine.SNAP_FIELDS + engine.ZOO_SNAP_FIELDS).  Duplicated
# as a literal to keep this package importable without jax.  The trailing
# zoo columns (tat / prev_count, docs/algorithms.md) default to zero when
# a caller's column dict omits them (pre-zoo SSD slabs, legacy stores).
COLD_FIELDS = (
    "algorithm", "limit", "remaining", "remaining_f", "duration",
    "created_at", "updated_at", "burst", "status", "expire_at",
    "tat", "prev_count",
)

# The subset that legacy (pre-zoo) payloads may omit — decoders zero-fill
# these instead of failing (mirrors engine.ZOO_SNAP_FIELDS).
ZOO_COLD_FIELDS = ("tat", "prev_count")

_MIN_ALLOC = 256


class ColdStore:
    """Bounded host tier for evicted bucket rows (see module doc)."""

    def __init__(self, capacity: int, store=None):
        if capacity <= 0:
            raise ValueError("ColdStore capacity must be positive")
        self.capacity = int(capacity)
        # Optional write-behind sink (Store protocol): overflow evictions
        # flow to on_change(None, item); TTL-dropped entries to remove().
        self.store = store
        self._lock = threading.Lock()
        self._map: Dict[bytes, int] = {}
        self._keys: List[Optional[bytes]] = []
        self._free: List[int] = []
        self._alloc = 0
        self._cols: Dict[str, np.ndarray] = {}
        self._touch = np.zeros(0, np.int64)
        self._used = np.zeros(0, bool)
        self._clock = 0
        # Entries demoted since the last export — the cold half of the
        # engine's incremental-snapshot working set (export_columns
        # dirty_only).  Indices, not keys: released entries drop out.
        self._dirty: set = set()
        # Counters (mirrored into Prometheus by the service layer).
        self.metric_demotions = 0
        self.metric_promotions = 0
        self.metric_hits = 0
        self.metric_misses = 0
        self.metric_expired = 0
        self.metric_overflow_evictions = 0
        self.metric_write_behind = 0

    def __len__(self) -> int:
        return len(self._map)

    # ------------------------------------------------------------------
    # Storage management
    # ------------------------------------------------------------------
    def _grow(self, need: int) -> None:
        """Geometric array growth up to the entry budget (amortized O(1)
        per insert; a 10M-entry tier must not reallocate per demote)."""
        new_alloc = max(_MIN_ALLOC, self._alloc)
        while new_alloc < need:
            new_alloc *= 2
        new_alloc = min(new_alloc, max(self.capacity, _MIN_ALLOC))
        if new_alloc <= self._alloc:
            return
        for f in COLD_FIELDS:
            dt = np.float64 if f == "remaining_f" else np.int64
            col = np.zeros(new_alloc, dt)
            if self._alloc:
                col[: self._alloc] = self._cols[f]
            self._cols[f] = col
        for arr_name, fill in (("_touch", 0), ("_used", False)):
            old = getattr(self, arr_name)
            new = np.full(new_alloc, fill, old.dtype)
            new[: self._alloc] = old
            setattr(self, arr_name, new)
        self._keys.extend([None] * (new_alloc - self._alloc))
        self._free.extend(range(new_alloc - 1, self._alloc - 1, -1))
        self._alloc = new_alloc

    def _release(self, idx: np.ndarray) -> None:
        for i in idx:
            i = int(i)
            key = self._keys[i]
            if key is None:
                continue
            del self._map[key]
            self._keys[i] = None
            self._used[i] = False
            self._dirty.discard(i)
            self._free.append(i)

    @staticmethod
    def _cols_item(keys: List[bytes], cols: Dict[str, np.ndarray],
                   j: int) -> dict:
        return {
            "key": keys[j].decode(),
            **{
                f: (float if f == "remaining_f" else int)(cols[f][j])
                for f in COLD_FIELDS
            },
        }

    def _evict_overflow(
        self, want: int
    ) -> Tuple[List[bytes], Dict[str, np.ndarray]]:
        """Free ``want`` entries by the cold tier's own LRU (oldest touch
        clock).  Returns the victims as ``(keys, cols)`` copies when a
        write-behind sink is wired — the CALLER ships them to the sink
        after releasing ``self._lock``: sink I/O under the lock stalls
        every concurrent promote behind the sink's disk."""
        used = np.flatnonzero(self._used)
        n = min(want, len(used))
        if n <= 0:
            return [], {}
        if n >= len(used):
            victims = used
        else:
            # argpartition, not argsort: the tier can hold millions of
            # entries and overflow eviction rides the demote path.
            victims = used[np.argpartition(self._touch[used], n - 1)[:n]]
        self.metric_overflow_evictions += len(victims)
        keys: List[bytes] = []
        cols: Dict[str, np.ndarray] = {}
        if self.store is not None:
            keys = [self._keys[int(i)] for i in victims]
            cols = {f: self._cols[f][victims].copy() for f in COLD_FIELDS}
        self._release(victims)
        return keys, cols

    # ------------------------------------------------------------------
    # Write-behind sink dispatch (always OUTSIDE self._lock)
    # ------------------------------------------------------------------
    def _flush_shed(
        self,
        shed: List[Tuple[List[bytes], Dict[str, np.ndarray]]],
        now: int,
    ) -> None:
        """Ship overflow victims to the sink, one batched call per evict
        sweep: columnar ``put_columns`` (the SSD tier) > ``put_batch``
        (batched Store) > per-item ``on_change`` fallback."""
        if self.store is None:
            return
        for keys, cols in shed:
            if not keys:
                continue
            if hasattr(self.store, "put_columns"):
                self.store.put_columns(keys, cols, now)
            elif hasattr(self.store, "put_batch"):
                self.store.put_batch([
                    self._cols_item(keys, cols, j)
                    for j in range(len(keys))
                ])
            else:
                for j in range(len(keys)):
                    self.store.on_change(
                        None, self._cols_item(keys, cols, j)
                    )
            self.metric_write_behind += len(keys)

    def _sink_remove(self, keys: List[str]) -> None:
        """TTL-dropped keys leave the tiered cache entirely: batched
        sink removal (``remove_batch`` > per-key ``remove``)."""
        if self.store is None or not keys:
            return
        if hasattr(self.store, "remove_batch"):
            self.store.remove_batch(keys)
        else:
            for key in keys:
                self.store.remove(key)

    # ------------------------------------------------------------------
    # Demote (device → cold)
    # ------------------------------------------------------------------
    def put_columns(
        self, keys: List[bytes], cols: Dict[str, np.ndarray], now: int
    ) -> int:
        """Insert demoted rows (COLD_FIELDS columns, one row per key).

        Rows already TTL-expired are dropped (they're dead; resurrecting
        them would hand the next tenant stale state).  Existing keys are
        overwritten in place (the hot tier's copy is always newer).
        Returns the number of rows actually demoted."""
        if not keys:
            return 0
        missing = [f for f in COLD_FIELDS if f not in cols]
        if missing:
            # Legacy callers (pre-zoo slabs, old stores) omit the zoo
            # columns; zero is the safe restore (fresh window/TAT).
            zeros = np.zeros(len(keys), np.int64)
            cols = {**cols, **{f: zeros for f in missing}}
        expire = np.asarray(cols["expire_at"], np.int64)
        keep = expire >= now
        shed: List[Tuple[List[bytes], Dict[str, np.ndarray]]] = []
        with self._lock:
            self._clock += 1
            idx = np.empty(len(keys), np.int64)
            n_new = 0
            for j, key in enumerate(keys):
                if not keep[j]:
                    idx[j] = -1
                    continue
                i = self._map.get(key)
                if i is None:
                    n_new += 1
                    idx[j] = -2  # allocate below, after budget enforcement
                else:
                    idx[j] = i
            if n_new:
                shortfall = len(self._map) + n_new - self.capacity
                if shortfall > 0:
                    shed.append(self._evict_overflow(shortfall))
                self._grow(len(self._map) + n_new)
                for j, key in enumerate(keys):
                    if idx[j] != -2:
                        continue
                    if not self._free:
                        idx[j] = -1  # budget smaller than one demote batch
                        continue
                    i = self._free.pop()
                    self._map[key] = i
                    self._keys[i] = key
                    self._used[i] = True
                    idx[j] = i
            sel = np.flatnonzero(idx >= 0)
            if len(sel) > 0:
                dst = idx[sel]
                for f in COLD_FIELDS:
                    self._cols[f][dst] = np.asarray(cols[f])[sel]
                self._touch[dst] = self._clock
                self._dirty.update(int(i) for i in dst)
                self.metric_demotions += len(sel)
                # One demote batch can exceed the whole budget (a big
                # reclaim into a small tier): enforce it after the writes
                # too, so the excess write-behinds instead of silently
                # over-filling.
                over = len(self._map) - self.capacity
                if over > 0:
                    shed.append(self._evict_overflow(over))
        self._flush_shed(shed, now)
        return len(sel)

    # ------------------------------------------------------------------
    # Promote (cold → device)
    # ------------------------------------------------------------------
    def take(
        self, keys: List[bytes], now: int
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Look up + REMOVE a batch of keys (promotion is a move, not a
        copy: the hot tier becomes the owner; a stale cold copy would
        shadow newer state on the next demote).

        Returns ``(hit_positions, cols)``: positions into ``keys`` that
        hit, and the gathered COLD_FIELDS columns for exactly those
        positions (in hit order).  Expired entries count as misses and
        are dropped."""
        if not keys:
            return np.empty(0, np.int64), {}
        removed: List[str] = []
        with self._lock:
            self._clock += 1
            pos: List[int] = []
            idx: List[int] = []
            expired: List[int] = []
            for j, key in enumerate(keys):
                i = self._map.get(key)
                if i is None:
                    self.metric_misses += 1
                    continue
                if self._cols["expire_at"][i] < now:
                    expired.append(i)
                    self.metric_expired += 1
                    self.metric_misses += 1
                    continue
                pos.append(j)
                idx.append(i)
            if expired:
                exp = np.asarray(expired, np.int64)
                if self.store is not None:
                    removed = [self._keys[int(i)].decode() for i in exp]
                self._release(exp)
            if not idx:
                out_pos, out = np.empty(0, np.int64), {}
            else:
                src = np.asarray(idx, np.int64)
                out = {f: self._cols[f][src].copy() for f in COLD_FIELDS}
                self._release(src)
                self.metric_hits += len(idx)
                self.metric_promotions += len(idx)
                out_pos = np.asarray(pos, np.int64)
        self._sink_remove(removed)
        return out_pos, out

    # ------------------------------------------------------------------
    # Maintenance
    # ------------------------------------------------------------------
    def expire(self, now: int) -> int:
        """Vectorized TTL sweep: drop every entry whose ``expire_at`` has
        passed.  Cheap enough to ride the engine's reclaim cadence (one
        compare over the used columns, no per-key work until the rare
        release)."""
        removed: List[str] = []
        with self._lock:
            if self._alloc == 0:
                return 0
            dead = np.flatnonzero(self._used & (self._cols["expire_at"] < now))
            if len(dead) == 0:
                return 0
            self.metric_expired += len(dead)
            if self.store is not None:
                removed = [self._keys[int(i)].decode() for i in dead]
            self._release(dead)
        self._sink_remove(removed)
        return len(dead)

    def export_columns(
        self, dirty_only: bool = False
    ) -> Tuple[List[bytes], Dict[str, np.ndarray]]:
        """Snapshot the tier's (dirty) entries as (keys, COLD_FIELDS
        columns) — the cold half of the engine's columnar export: demoted
        state must survive a Loader save/restore cycle like hot state
        does.  Entries stay resident; the dirty set drains (like the
        engine's dirty-slot set, any export resets it)."""
        with self._lock:
            if self._alloc == 0:
                return [], {
                    f: np.zeros(
                        0, np.float64 if f == "remaining_f" else np.int64
                    )
                    for f in COLD_FIELDS
                }
            if dirty_only:
                idx = np.fromiter(self._dirty, np.int64, len(self._dirty))
                idx.sort()
            else:
                idx = np.flatnonzero(self._used)
            self._dirty.clear()
            keys = [self._keys[int(i)] for i in idx]
            return keys, {f: self._cols[f][idx].copy() for f in COLD_FIELDS}

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._map),
                "capacity": self.capacity,
                "demotions": self.metric_demotions,
                "promotions": self.metric_promotions,
                "hits": self.metric_hits,
                "misses": self.metric_misses,
                "expired": self.metric_expired,
                "overflow_evictions": self.metric_overflow_evictions,
                "write_behind": self.metric_write_behind,
            }
