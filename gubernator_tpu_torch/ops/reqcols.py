"""Columnar request batches: one key blob plus int64 numpy columns.

A request window travels from the caller to the device with no
per-request Python: the key blob goes to the native slot map in one call,
the columns are packed into the REQ32 matrix with vectorized writes
(``ops/engine.pack_cols_req32``).  ``RateLimitRequest`` stays the API-edge
type; :meth:`ReqColumns.from_requests` bridges.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

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
    ``RateLimitRequest``; the tick path never reads it.
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

    def __len__(self) -> int:
        return len(self.hits)

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
        if len(requests) == 0:
            return cls.empty()
        blob, offsets = pack_blob([r.hash_key().encode() for r in requests])
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
            refs=requests if keep_refs else None,
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

