"""Vectorized protobuf wire encoding for the hot response path.

The port's copy of the JAX package's numpy response encoder: the
identical wire bytes protobuf would write for a ``GetRateLimitsResp``,
straight from the engine's (5, n) response matrix.  The serving path
encodes with the native codec (``transport/fastwire.encode_resp``); this
is its plain numpy counterpart, byte for byte the same.

Wire layout (proto/gubernator.proto):

  GetRateLimitsResp: field 1, repeated RateLimitResp (len-delimited)
  RateLimitResp:     1 status (varint enum), 2 limit, 3 remaining,
                     4 reset_time (varint int64), 5 error (string),
                     6 metadata (map, unused on the fast path)

Negative int64s encode as 10-byte two's-complement varints, exactly as
protobuf requires (remaining can go negative under DRAIN semantics).
Responses with per-item errors are built as message objects host-side
(they are rare and carry strings); this encoder covers the all-ok path.
"""

from __future__ import annotations

import numpy as np

# Key tags (field << 3 | wire_type): varints are type 0, strings type 2.
_TAG_STATUS = (1 << 3) | 0
_TAG_LIMIT = (2 << 3) | 0
_TAG_REMAINING = (3 << 3) | 0
_TAG_RESET = (4 << 3) | 0
_TAG_RESPONSES = (1 << 3) | 2


def _varint_len(u: np.ndarray) -> np.ndarray:
    """Encoded byte count of each uint64 (1..10)."""
    # bit_length via log2 on float is unsafe past 2^53; use a comparison
    # ladder (9 compares, vectorized).
    n = np.ones(u.shape, np.int64)
    for k in range(1, 10):
        n += (u >= (np.uint64(1) << np.uint64(7 * k))).astype(np.int64)
    return n


def _write_varints(buf: np.ndarray, pos: np.ndarray, u: np.ndarray,
                   lens: np.ndarray) -> None:
    """Scatter each value's varint bytes at buf[pos[i]:pos[i]+lens[i]]."""
    max_len = int(lens.max()) if len(lens) else 0
    for k in range(max_len):
        sel = lens > k
        if not sel.any():
            break
        byte = (u[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)
        cont = (lens[sel] > k + 1)
        buf[pos[sel] + k] = (byte | (cont.astype(np.uint64) << np.uint64(7))
                             ).astype(np.uint8)


def encode_get_rate_limits_resp(mat: np.ndarray) -> bytes:
    """(5, n) int64 response matrix (rows: status, limit, remaining,
    reset_time, over_limit) → serialized ``GetRateLimitsResp`` bytes.
    Matches message-object serialization byte-for-byte for responses
    with no error and no metadata (proto3 omits zero-valued scalars)."""
    n = mat.shape[1]
    if n == 0:
        return b""
    status = mat[0].astype(np.uint64)
    vals = mat[1:4].astype(np.uint64)  # limit, remaining, reset (2's comp)

    # Per-field encoded sizes; proto3 skips fields whose value is 0.
    sl = np.where(status != 0, 1 + _varint_len(status), 0)
    field_lens = np.where(vals != 0, 1 + _varint_len(vals), 0)  # (3, n)
    msg_lens = sl + field_lens.sum(axis=0)          # RateLimitResp bytes
    hdr_lens = 1 + _varint_len(msg_lens.astype(np.uint64))
    total = int((msg_lens + hdr_lens).sum())
    buf = np.empty(total, np.uint8)

    starts = np.zeros(n, np.int64)
    np.cumsum(msg_lens + hdr_lens, out=starts)
    starts -= msg_lens + hdr_lens                    # exclusive prefix sum

    # Submessage headers: tag byte + length varint.
    buf[starts] = _TAG_RESPONSES
    _write_varints(buf, starts + 1, msg_lens.astype(np.uint64),
                   hdr_lens - 1)

    pos = starts + hdr_lens
    for tag, u, ln in (
        (_TAG_STATUS, status, sl),
        (_TAG_LIMIT, vals[0], field_lens[0]),
        (_TAG_REMAINING, vals[1], field_lens[1]),
        (_TAG_RESET, vals[2], field_lens[2]),
    ):
        present = ln > 0
        buf[pos[present]] = tag
        _write_varints(buf, (pos + 1)[present], u[present],
                       (ln - 1)[present])
        pos = pos + ln
    return buf.tobytes()
