"""Columnar request batches: one key blob plus int64 numpy columns.

A request window travels from the caller to the device with no
per-request Python: the key blob goes to the native slot map in one call,
the columns are packed into the REQ32 matrix with vectorized writes
(``ops/engine.pack_cols_req32``).  ``RateLimitRequest`` stays the API-edge
type; :meth:`ReqColumns.from_requests` bridges.  The wire codec
(``transport/fastwire``) decodes a request batch into the slabs of a
:class:`ColumnArena`, whose views become the batch's columns.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from gubernator_tpu_torch.types import RateLimitRequest

# `created_at` sentinel: proto3 optional presence maps to "server stamps
# now" (gubernator.proto:172-182).  0 is a legal client value, so absence
# is encoded as -1.
CREATED_UNSET = -1

_EMPTY_I64 = np.empty(0, np.int64)


@dataclass
class ReqColumns:
    """One request batch as columns.

    ``key_blob``/``key_offsets`` hold the concatenated hash keys
    (``name + "_" + unique_key``): offsets are (n+1,) int64 with
    ``key j = blob[offsets[j]:offsets[j+1]]``, the slot map's batch-resolve
    format.

    ``refs`` optionally carries the originating request objects for the
    Store's read- and write-through hooks, which take a
    ``RateLimitRequest``; the tick path never reads it.  ``name_len`` is
    the byte length of each key's name part, which the wire encoder needs
    to write the two string fields back.  ``lease`` is the arena slab an
    arena-decoded batch lives in (:meth:`release` returns it).
    """

    key_blob: "bytes | np.ndarray | memoryview"
    key_offsets: np.ndarray   # (n+1,) int64
    hits: np.ndarray          # all remaining columns: (n,) int64
    limit: np.ndarray
    duration: np.ndarray
    algorithm: np.ndarray
    behavior: np.ndarray
    created_at: np.ndarray    # CREATED_UNSET where the server stamps now
    burst: np.ndarray
    refs: Optional[Sequence[RateLimitRequest]] = None
    name_len: Optional[np.ndarray] = None
    lease: Optional["ArenaLease"] = field(default=None, repr=False)

    def __len__(self) -> int:
        return len(self.hits)

    def release(self) -> None:
        """Return the backing arena slab (idempotent; a no-op for a batch
        that owns its arrays).  The column views may be overwritten by a
        later batch afterwards: callers release once the engine has
        packed the batch."""
        lease, self.lease = self.lease, None
        if lease is not None:
            lease.release()

    def key_bytes(self, j: int) -> bytes:
        """Key ``j`` as bytes."""
        o = self.key_offsets
        return bytes(self.key_blob[o[j]:o[j + 1]])

    @classmethod
    def empty(cls) -> "ReqColumns":
        return cls(
            b"", np.zeros(1, np.int64), _EMPTY_I64, _EMPTY_I64, _EMPTY_I64,
            _EMPTY_I64, _EMPTY_I64, _EMPTY_I64, _EMPTY_I64,
        )

    @classmethod
    def from_requests(cls, requests: Sequence[RateLimitRequest],
                      keep_refs: bool = False) -> "ReqColumns":
        """Bridge from the dataclass API (one attribute pass); with
        ``keep_refs`` the batch keeps the request objects (``refs``)."""
        n = len(requests)
        if n == 0:
            return cls.empty()
        names = [r.name for r in requests]
        blob, offsets = key_blob_from_parts(
            names, [r.unique_key for r in requests])
        name_len = np.fromiter((len(nm.encode()) for nm in names), np.int64,
                               count=n)
        hits, limit, duration, algo, behav, created, burst = zip(*(
            (
                r.hits, r.limit, r.duration, int(r.algorithm),
                int(r.behavior),
                CREATED_UNSET if r.created_at is None else r.created_at,
                r.burst,
            )
            for r in requests
        ))
        a = lambda v: np.asarray(v, np.int64)  # noqa: E731
        return cls(
            blob, offsets, a(hits), a(limit), a(duration),
            a(algo), a(behav), a(created), a(burst),
            refs=requests if keep_refs else None, name_len=name_len,
        )

    def slice_chunk(self, s: int, e: int) -> "ReqColumns":
        """Contiguous sub-batch [s, e): numpy views plus one blob slice."""
        o = self.key_offsets
        return ReqColumns(
            self.key_blob[o[s] : o[e]],
            o[s : e + 1] - o[s],
            self.hits[s:e], self.limit[s:e], self.duration[s:e],
            self.algorithm[s:e], self.behavior[s:e],
            self.created_at[s:e], self.burst[s:e],
            refs=None if self.refs is None else self.refs[s:e],
            name_len=None if self.name_len is None else self.name_len[s:e],
        )

    @classmethod
    def concat(cls, parts: List["ReqColumns"]) -> "ReqColumns":
        """One batch of several (the tick loop coalescing callers into one
        window).  Refs and name lengths survive only if every part has
        them."""
        if len(parts) == 1:
            return parts[0]
        if not parts:
            return cls.empty()
        sizes = [len(p) for p in parts]
        offsets = np.zeros(sum(sizes) + 1, np.int64)
        base = 0
        at = 1
        for p, sz in zip(parts, sizes):
            offsets[at:at + sz] = p.key_offsets[1:] + base
            base += p.key_offsets[-1]
            at += sz
        cat = lambda f: np.concatenate([getattr(p, f) for p in parts])  # noqa: E731
        refs = (None if any(p.refs is None for p in parts)
                else [r for p in parts for r in p.refs])
        name_len = (cat("name_len")
                    if all(p.name_len is not None for p in parts) else None)
        return cls(
            b"".join(p.key_blob for p in parts), offsets,
            cat("hits"), cat("limit"), cat("duration"), cat("algorithm"),
            cat("behavior"), cat("created_at"), cat("burst"), refs=refs,
            name_len=name_len,
        )


def pack_blob(keys: Sequence[bytes]) -> tuple[bytes, np.ndarray]:
    """Concatenate keys into the (blob, (n+1,) int64 offsets) format."""
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    return b"".join(keys), offsets


def compact_blob(
    blob: bytes, offsets: np.ndarray, keep: np.ndarray
) -> tuple[bytes, np.ndarray]:
    """Filter a (blob, offsets) key pack down to the keep-masked rows,
    fully vectorized."""
    arr = np.frombuffer(blob, np.uint8)
    lens = np.diff(offsets)
    starts = offsets[:-1][keep]
    ls = lens[keep]
    cum = np.zeros(len(ls) + 1, np.int64)
    np.cumsum(ls, out=cum[1:])
    pos = (
        np.arange(int(cum[-1]), dtype=np.int64)
        - np.repeat(cum[:-1], ls)
        + np.repeat(starts, ls)
    )
    return arr[pos].tobytes(), cum



def key_groups(blob: bytes, offsets: np.ndarray,
               crc: np.ndarray) -> np.ndarray:
    """(n,) int64 group ids of the keys of a (blob, offsets) pack, equal
    exactly for equal keys, from their CRC-32s ``crc``: keys with a CRC no
    other key has are alone in their group, and only keys that share a CRC
    are compared byte for byte."""
    n = len(offsets) - 1
    order = np.argsort(crc, kind="stable")
    sc = crc[order]
    start = np.ones(n, bool)
    start[1:] = sc[1:] != sc[:-1]
    gid = np.empty(n, np.int64)
    gid[order] = np.cumsum(start) - 1
    size = np.bincount(gid, minlength=1)
    shared = np.flatnonzero(size[gid] > 1)
    if len(shared):
        mv = memoryview(blob)
        fresh = {}
        nxt = int(size.shape[0])
        for j in shared.tolist():
            k = (int(gid[j]), bytes(mv[offsets[j]:offsets[j + 1]]))
            if k not in fresh:
                fresh[k] = nxt
                nxt += 1
            gid[j] = fresh[k]
    return gid


def key_blob_from_parts(
    names: Sequence[str], unique_keys: Sequence[str]
) -> tuple[bytes, np.ndarray]:
    """(blob, offsets) of the ``name_uniquekey`` hash keys of parallel
    name / key sequences."""
    return pack_blob(
        [(nm + "_" + uk).encode() for nm, uk in zip(names, unique_keys)])


# ----------------------------------------------------------------------
# Ingest column arena: preallocated decode slabs
# ----------------------------------------------------------------------
class IngestOverloadError(RuntimeError):
    """Every arena slab is busy and the per-window budget of plain
    allocations (GUBER_INGEST_FALLBACK_LIMIT) is spent: the serving edge
    answers it as retriable backpressure (RESOURCE_EXHAUSTED)."""


class ArenaLease:
    """One leased slab of a :class:`ColumnArena`: the views the decoder
    writes into and the release token.  Release is idempotent."""

    __slots__ = ("arena", "index", "ints", "flags", "blob")

    def __init__(self, arena: "ColumnArena", index: int,
                 ints: np.ndarray, flags: np.ndarray, blob: np.ndarray):
        self.arena = arena
        self.index = index
        self.ints = ints
        self.flags = flags
        self.blob = blob

    def release(self) -> None:
        arena, self.arena = self.arena, None
        if arena is not None:
            arena._release(self.index)


class ColumnArena:
    """Reusable, bounded decode slabs for the wire → columns edge.

    ``slabs`` fixed-size buffer sets are allocated once and leased one a
    batch; a slab's numpy views become the batch's columns.  A batch wider
    than ``max_batch``, a key blob larger than a slab, or a lease while
    every slab is busy gets None, and the caller allocates (within the
    per-window ``fallback_limit`` when the slabs are busy)."""

    # Key-blob staging bytes a request row: a batch of n rows needs
    # len(data) + n bytes.
    BLOB_PER_ROW = 128

    def __init__(self, max_batch: int, slabs: int = 8,
                 fallback_limit: int = 32):
        self.max_batch = int(max_batch)
        self.n_slabs = max(1, int(slabs))
        self.blob_cap = self.max_batch * self.BLOB_PER_ROW
        self._ints = np.zeros(
            (self.n_slabs, 9, self.max_batch + 1), np.int64)
        self._flags = np.zeros((self.n_slabs, self.max_batch), np.uint8)
        self._blob = np.empty((self.n_slabs, self.blob_cap), np.uint8)
        self._busy = [False] * self.n_slabs
        self._next = 0
        self._lock = threading.Lock()
        # The budget resets whenever a slab recycles (a window completed),
        # so sustained exhaustion, not a burst, sheds.
        self.fallback_limit = max(0, int(fallback_limit))
        self._window_fallbacks = 0
        self.metric_leases = 0
        self.metric_misses = 0
        self.metric_fallbacks = 0

    def lease(self, n: int, blob_cap: int) -> Optional[ArenaLease]:
        """A slab for an ``n``-row decode needing ``blob_cap`` staging
        bytes, zeroed where the decoder needs zeros; None when none fits
        or all are busy."""
        if n > self.max_batch or blob_cap > self.blob_cap:
            self.metric_misses += 1
            return None
        with self._lock:
            idx = -1
            for k in range(self.n_slabs):
                j = (self._next + k) % self.n_slabs
                if not self._busy[j]:
                    idx = j
                    break
            if idx < 0:
                self.metric_misses += 1
                return None
            self._busy[idx] = True
            self._next = (idx + 1) % self.n_slabs
            self.metric_leases += 1
        ints = self._ints[idx]
        ints[:, : n + 1] = 0
        flags = self._flags[idx]
        flags[:n] = 0
        return ArenaLease(self, idx, ints, flags, self._blob[idx])

    def fits(self, n: int, blob_cap: int) -> bool:
        """Whether an ``n``-row decode could ever lease a slab here."""
        return n <= self.max_batch and blob_cap <= self.blob_cap

    def try_fallback(self) -> bool:
        """Spend one plain allocation of the window's budget; False when
        it is spent (the caller sheds)."""
        with self._lock:
            if self._window_fallbacks >= self.fallback_limit:
                return False
            self._window_fallbacks += 1
            self.metric_fallbacks += 1
            return True

    def _release(self, index: int) -> None:
        with self._lock:
            self._busy[index] = False
            self._window_fallbacks = 0

    def in_use(self) -> int:
        with self._lock:
            return sum(self._busy)
