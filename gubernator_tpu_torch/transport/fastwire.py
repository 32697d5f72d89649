"""Native wire codec bindings: serialized pb <-> columns, no message objects.

The port's copy of the JAX package's ``transport/fastwire`` for the
rate-limit frames.  The C++ codec (``csrc/wirecodec.cc``, built by
``_build.py`` with ``c++`` at first use) parses ``GetRateLimitsReq``
bytes straight into a :class:`~gubernator_tpu_torch.ops.reqcols.ReqColumns`
and writes ``GetRateLimitsResp`` bytes straight from the engine's (5, n)
response matrix.  A codec that fails to build raises; ``parse_req`` and
``parse_resp`` return None only for malformed bytes.

Request-side semantics match :func:`transport.convert.columns_from_pb`
(empty name / key per-item errors, metadata or GLOBAL / MULTI_REGION ->
``special``, ``created_at`` 0 or absent -> the server stamps now);
response bytes are identical to protobuf's for items without an error or
metadata.

The quota-lease frames (``GLR2`` / ``GLT1`` / ``GSY2`` / ``GSA1``, and the
v1 request frames ``GLR1`` / ``GSY1`` that parsers still accept) and the
federation frames (``GFE1`` envelopes, ``GFA1`` acks) are the reference's
pure-Python struct codecs.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.algos import algorithm_error, invalid_algorithm_mask
from gubernator_tpu_torch.federation.envelope import (
    FederationAck,
    FederationEnvelope,
    FederationRecord,
)
from gubernator_tpu_torch.leases.protocol import (
    LeaseSpec,
    LeaseSync,
    LeaseSyncAck,
    LeaseToken,
)
from gubernator_tpu_torch.native import as_char_p
from gubernator_tpu_torch.ops.reqcols import (
    CREATED_UNSET,
    ColumnArena,
    IngestOverloadError,
    ReqColumns,
)
from gubernator_tpu_torch.types import Behavior

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

# out_flags bits (wirecodec.cc).
_NAME_EMPTY = 1
_KEY_EMPTY = 2
_HAS_METADATA = 4
_HAS_CREATED = 8

# Behaviors that take the object path: GLOBAL and MULTI_REGION.
_SPECIAL_BEHAVIOR = int(Behavior.GLOBAL) | int(Behavior.MULTI_REGION)

_configured = False


def load() -> ctypes.CDLL:
    """The wire codec library with its C signatures set (built at first
    use; a failed build raises with the compiler's output)."""
    global _configured
    lib = _build.load("wirecodec")
    if _configured:
        return lib
    i64, cp = ctypes.c_int64, ctypes.c_char_p
    lib.guber_wire_count.restype = i64
    lib.guber_wire_count.argtypes = [cp, i64]
    lib.guber_parse_req.restype = i64
    lib.guber_parse_req.argtypes = [
        cp, i64, _U8, i64, _I64, _I64,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _U8,
    ]
    lib.guber_parse_resp.restype = i64
    lib.guber_parse_resp.argtypes = [cp, i64, _I64, _I64, _I64, _I64, _U8]
    lib.guber_encode_req.restype = i64
    lib.guber_encode_req.argtypes = [
        cp, _I64, _I64,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _U8,
        i64, _U8, i64,
    ]
    lib.guber_encode_resp.restype = i64
    lib.guber_encode_resp.argtypes = [_I64, _I64, _I64, _I64, i64, _U8, i64]
    _configured = True
    return lib


def parse_req(
    data: bytes, arena: Optional[ColumnArena] = None,
) -> Optional[Tuple[ReqColumns, Dict[int, str], bool]]:
    """Serialized ``GetRateLimitsReq`` -> (cols, per-item errors, special),
    or None for malformed bytes.

    ``special`` is True when an item carries GLOBAL or MULTI_REGION or
    metadata: those take the object path, which parses with protobuf
    (the codec records only metadata's presence).  With ``arena`` the
    decode lands in a leased slab and the columns, key blob included, are
    views into it; the caller releases the lease (``cols.release()``)
    once the engine has packed the batch.  Oversized batches skip the
    arena; when every slab is busy the arena's per-window fallback budget
    allows a plain allocation, past it :class:`IngestOverloadError`."""
    lib = load()
    ln = len(data)
    n = lib.guber_wire_count(data, ln)
    if n < 0:
        return None
    if n == 0:
        return ReqColumns.empty(), {}, False
    blob_cap = ln + n
    lease = arena.lease(n, blob_cap) if arena is not None else None
    if lease is not None:
        ints, blob, flags_full = lease.ints, lease.blob, lease.flags
    else:
        if (arena is not None and arena.fits(n, blob_cap)
                and not arena.try_fallback()):
            raise IngestOverloadError(
                "ingest arena exhausted and fallback budget spent")
        blob = np.empty(blob_cap, np.uint8)
        # One zeroed block for every int64 output: the codec writes only
        # the fields present on the wire, and proto3 absents read 0.
        ints = np.zeros((9, n + 1), np.int64)
        flags_full = np.zeros(n, np.uint8)
    off = ints[8, : n + 1]
    name_len, hits, limit, duration, algorithm, behavior, burst, created = (
        ints[i, :n] for i in range(8))
    flags = flags_full[:n]
    got = lib.guber_parse_req(
        data, ln, blob, len(blob), off, name_len,
        hits, limit, duration, algorithm, behavior, burst, created, flags,
    )
    if got != n:
        if lease is not None:
            lease.release()
        return None
    # created_at absent or 0: the server stamps now.
    created[created == 0] = CREATED_UNSET
    errors: Dict[int, str] = {}
    bad_key = flags & (_NAME_EMPTY | _KEY_EMPTY)
    for i in np.flatnonzero(bad_key):
        errors[int(i)] = (
            "field 'unique_key' cannot be empty" if flags[i] & _KEY_EMPTY
            else "field 'namespace' cannot be empty")
    for i in np.flatnonzero(invalid_algorithm_mask(algorithm)):
        errors.setdefault(int(i), algorithm_error(algorithm[i]))
    special = bool((flags & _HAS_METADATA).any()) or bool(
        (behavior & _SPECIAL_BEHAVIOR).any())
    cols = ReqColumns(
        blob[: off[n]], off, hits, limit, duration,
        algorithm, behavior, created, burst, name_len=name_len,
        lease=lease,
    )
    return cols, errors, special


def parse_resp(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Serialized ``GetRateLimitsResp`` / ``GetPeerRateLimitsResp`` ->
    ((4, n) int64 status / limit / remaining / reset_time, (n,) bool mask
    of items with an error string or metadata, which protobuf re-parses
    for the strings); None for malformed bytes."""
    lib = load()
    ln = len(data)
    n = lib.guber_wire_count(data, ln)
    if n < 0:
        return None
    mat = np.zeros((4, max(n, 1)), np.int64)
    special = np.zeros(max(n, 1), np.uint8)
    if n:
        got = lib.guber_parse_resp(
            data, ln, mat[0], mat[1], mat[2], mat[3], special)
        if got != n:
            return None
    return mat[:, :n], special[:n].astype(bool)


def encode_req(cols: ReqColumns) -> bytes:
    """Columns -> serialized ``GetRateLimitsReq`` bytes (the same outer
    shape serves ``GetPeerRateLimitsReq``).  Needs ``cols.name_len`` to
    split each key back into its name and unique key."""
    n = len(cols)
    if n == 0:
        return b""
    if cols.name_len is None:
        raise ValueError("encode_req needs the columns' name_len")
    lib = load()
    has_created = (cols.created_at != CREATED_UNSET).astype(np.uint8)
    off = np.ascontiguousarray(cols.key_offsets, np.int64)
    name_len = np.ascontiguousarray(cols.name_len, np.int64)
    c = lambda a: np.ascontiguousarray(a, np.int64)  # noqa: E731
    cap = int(off[n]) + 16 * n + 128
    while True:
        out = np.empty(cap, np.uint8)
        wrote = lib.guber_encode_req(
            as_char_p(cols.key_blob), off, name_len,
            c(cols.hits), c(cols.limit), c(cols.duration),
            c(cols.algorithm), c(cols.behavior), c(cols.burst),
            c(cols.created_at), has_created, n, out, cap,
        )
        if wrote >= 0:
            return out[:wrote].tobytes()
        if wrote == -1:
            raise ValueError(
                "encode_req: a key is shorter than its name_len + 1 (an "
                "item with an empty name or key)")
        cap = -wrote


def encode_resp(mat: np.ndarray) -> bytes:
    """(5, n) response matrix -> serialized ``GetRateLimitsResp`` bytes."""
    n = mat.shape[1]
    if n == 0:
        return b""
    lib = load()
    rows = [np.ascontiguousarray(mat[r], np.int64) for r in range(4)]
    # Worst case an item: 4 fields of (1 tag + 10 varint bytes) = 44 B of
    # payload plus a 2-B header (payload < 128).
    cap = 8 + 46 * n
    out = np.empty(cap, np.uint8)
    wrote = lib.guber_encode_resp(rows[0], rows[1], rows[2], rows[3],
                                  n, out, cap)
    if wrote < 0:
        raise RuntimeError(f"encode_resp: codec returned {wrote}")
    return out[:wrote].tobytes()


# ----------------------------------------------------------------------
# Quota-lease frames (docs/leases.md).
#
# Lease traffic happens at lease EDGES (grant, expiry, exhaustion,
# release) — orders of magnitude rarer than decisions — so these frames
# are pure-Python struct codecs, not native: the codec cost is
# irrelevant, while the native library must stay optional.  All frames
# are little-endian with a 4-byte magic + u32 count header; parsers
# return None on a magic/length mismatch (callers treat that exactly
# like a malformed protobuf: reject the RPC).

# Request frames are v2: they carry the leaseholder identity (the
# server accounts per-holder slices — docs/leases.md).  Parsers still
# accept the v1 frames (no holder field → the shared "" identity) so a
# not-yet-upgraded client keeps working against a v2 server.
_LEASE_GRANT_REQ_MAGIC = b"GLR2"
_LEASE_GRANT_REQ_MAGIC_V1 = b"GLR1"
_LEASE_GRANT_RESP_MAGIC = b"GLT1"
_LEASE_SYNC_REQ_MAGIC = b"GSY2"
_LEASE_SYNC_REQ_MAGIC_V1 = b"GSY1"
_LEASE_SYNC_RESP_MAGIC = b"GSA1"


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def _unpack_str(data: bytes, off: int):
    (ln,) = struct.unpack_from("<H", data, off)
    off += 2
    return data[off : off + ln].decode(), off + ln


def encode_lease_grant_req(specs) -> bytes:
    """[LeaseSpec] → LeaseGrant request frame."""
    parts = [_LEASE_GRANT_REQ_MAGIC, struct.pack("<I", len(specs))]
    for s in specs:
        parts.append(struct.pack(
            "<qqqqq", s.limit, s.duration, s.algorithm, s.burst, s.want))
        parts.append(_pack_str(s.name))
        parts.append(_pack_str(s.key))
        parts.append(_pack_str(s.holder))
    return b"".join(parts)


def parse_lease_grant_req(data: bytes):
    """LeaseGrant request frame → [LeaseSpec] (None when malformed)."""
    try:
        magic = data[:4]
        if magic not in (_LEASE_GRANT_REQ_MAGIC,
                         _LEASE_GRANT_REQ_MAGIC_V1):
            return None
        v1 = magic == _LEASE_GRANT_REQ_MAGIC_V1
        (n,) = struct.unpack_from("<I", data, 4)
        off = 8
        out = []
        for _ in range(n):
            limit, duration, algo, burst, want = struct.unpack_from(
                "<qqqqq", data, off)
            off += 40
            name, off = _unpack_str(data, off)
            key, off = _unpack_str(data, off)
            holder = ""
            if not v1:
                holder, off = _unpack_str(data, off)
            out.append(LeaseSpec(
                name=name, key=key, limit=limit, duration=duration,
                algorithm=algo, burst=burst, want=want, holder=holder))
        return out if off == len(data) else None
    except (struct.error, IndexError, UnicodeDecodeError):
        return None


def encode_lease_grant_resp(tokens) -> bytes:
    """[Optional[LeaseToken]] → LeaseGrant response frame (a None slot
    is an explicit declined marker: the bucket was too hot to delegate
    and the client must fall back to per-request decisions)."""
    parts = [_LEASE_GRANT_RESP_MAGIC, struct.pack("<I", len(tokens))]
    for t in tokens:
        if t is None:
            parts.append(b"\x00")
            continue
        parts.append(b"\x01")
        parts.append(struct.pack("<qqq", t.budget, t.expires_ms,
                                  t.generation))
        parts.append(_pack_str(t.name))
        parts.append(_pack_str(t.key))
        parts.append(struct.pack("<H", len(t.signature)))
        parts.append(t.signature)
    return b"".join(parts)


def parse_lease_grant_resp(data: bytes):
    """LeaseGrant response frame → [Optional[LeaseToken]]."""
    try:
        if data[:4] != _LEASE_GRANT_RESP_MAGIC:
            return None
        (n,) = struct.unpack_from("<I", data, 4)
        off = 8
        out = []
        for _ in range(n):
            present = data[off]
            off += 1
            if not present:
                out.append(None)
                continue
            budget, expires_ms, gen = struct.unpack_from("<qqq", data, off)
            off += 24
            name, off = _unpack_str(data, off)
            key, off = _unpack_str(data, off)
            (siglen,) = struct.unpack_from("<H", data, off)
            off += 2
            sig = data[off : off + siglen]
            off += siglen
            out.append(LeaseToken(
                name=name, key=key, budget=budget, expires_ms=expires_ms,
                generation=gen, signature=sig))
        return out if off == len(data) else None
    except (struct.error, IndexError, UnicodeDecodeError):
        return None


def encode_lease_sync_req(syncs) -> bytes:
    """[LeaseSync] → LeaseSync request frame."""
    parts = [_LEASE_SYNC_REQ_MAGIC, struct.pack("<I", len(syncs))]
    for s in syncs:
        parts.append(struct.pack(
            "<qqB", s.consumed, s.generation, 1 if s.release else 0))
        parts.append(_pack_str(s.name))
        parts.append(_pack_str(s.key))
        parts.append(_pack_str(s.holder))
    return b"".join(parts)


def parse_lease_sync_req(data: bytes):
    """LeaseSync request frame → [LeaseSync]."""
    try:
        magic = data[:4]
        if magic not in (_LEASE_SYNC_REQ_MAGIC,
                         _LEASE_SYNC_REQ_MAGIC_V1):
            return None
        v1 = magic == _LEASE_SYNC_REQ_MAGIC_V1
        (n,) = struct.unpack_from("<I", data, 4)
        off = 8
        out = []
        for _ in range(n):
            consumed, gen, release = struct.unpack_from("<qqB", data, off)
            off += 17
            name, off = _unpack_str(data, off)
            key, off = _unpack_str(data, off)
            holder = ""
            if not v1:
                holder, off = _unpack_str(data, off)
            out.append(LeaseSync(
                name=name, key=key, consumed=consumed, generation=gen,
                release=bool(release), holder=holder))
        return out if off == len(data) else None
    except (struct.error, IndexError, UnicodeDecodeError):
        return None


def encode_lease_sync_resp(acks) -> bytes:
    """[LeaseSyncAck] → LeaseSync response frame."""
    parts = [_LEASE_SYNC_RESP_MAGIC, struct.pack("<I", len(acks))]
    for a in acks:
        parts.append(struct.pack(
            "<Bqqq", 1 if a.accepted else 0, a.generation,
            a.credited, a.charged))
    return b"".join(parts)


def parse_lease_sync_resp(data: bytes):
    """LeaseSync response frame → [LeaseSyncAck]."""
    try:
        if data[:4] != _LEASE_SYNC_RESP_MAGIC:
            return None
        (n,) = struct.unpack_from("<I", data, 4)
        off = 8
        out = []
        for _ in range(n):
            accepted, gen, credited, charged = struct.unpack_from(
                "<Bqqq", data, off)
            off += 25
            out.append(LeaseSyncAck(
                accepted=bool(accepted), generation=gen,
                credited=credited, charged=charged))
        return out if off == len(data) else None
    except (struct.error, IndexError, UnicodeDecodeError):
        return None


# ----------------------------------------------------------------------
# Multi-region federation frames (docs/federation.md).
#
# Envelope exchange happens once per GUBER_FEDERATION_INTERVAL per remote
# region — WAN cadence, not decision cadence — so like the lease frames
# these are pure-Python struct codecs.  The version rides the magic
# (GFE1/GFA1): a receiver that doesn't recognize the magic rejects the
# RPC, which the sender's breaker/redelivery path treats like any other
# failure — a mixed-version fleet degrades to intra-region-only instead
# of corrupting state.

_FED_ENVELOPE_MAGIC = b"GFE1"
_FED_ACK_MAGIC = b"GFA1"


def encode_federation_envelope(env) -> bytes:
    """FederationEnvelope → GFE1 frame."""
    parts = [
        _FED_ENVELOPE_MAGIC,
        struct.pack("<q", env.seq),
        _pack_str(env.origin),
        _pack_str(env.region),
        _pack_str(env.epoch),
        struct.pack("<I", len(env.records)),
    ]
    for rec in env.records:
        parts.append(struct.pack(
            "<qqqqqqq", rec.hits, rec.limit, rec.duration, rec.algorithm,
            rec.behavior, rec.burst, rec.created_at))
        parts.append(_pack_str(rec.name))
        parts.append(_pack_str(rec.unique_key))
    return b"".join(parts)


def parse_federation_envelope(data: bytes):
    """GFE1 frame → FederationEnvelope (None when malformed)."""
    try:
        if data[:4] != _FED_ENVELOPE_MAGIC:
            return None
        (seq,) = struct.unpack_from("<q", data, 4)
        off = 12
        origin, off = _unpack_str(data, off)
        region, off = _unpack_str(data, off)
        epoch, off = _unpack_str(data, off)
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        records = []
        for _ in range(n):
            hits, limit, duration, algo, behavior, burst, created = (
                struct.unpack_from("<qqqqqqq", data, off))
            off += 56
            name, off = _unpack_str(data, off)
            key, off = _unpack_str(data, off)
            records.append(FederationRecord(
                name=name, unique_key=key, hits=hits, limit=limit,
                duration=duration, algorithm=algo, behavior=behavior,
                burst=burst, created_at=created))
        env = FederationEnvelope(
            origin=origin, region=region, epoch=epoch, seq=seq,
            records=records)
        return env if off == len(data) else None
    except (struct.error, IndexError, UnicodeDecodeError):
        return None


def encode_federation_ack(ack) -> bytes:
    """FederationAck → GFA1 frame."""
    return b"".join([
        _FED_ACK_MAGIC,
        struct.pack("<qq", ack.seq, ack.applied),
        _pack_str(ack.origin),
    ])


def parse_federation_ack(data: bytes):
    """GFA1 frame → FederationAck (None when malformed)."""
    try:
        if data[:4] != _FED_ACK_MAGIC:
            return None
        seq, applied = struct.unpack_from("<qq", data, 4)
        off = 20
        origin, off = _unpack_str(data, off)
        ack = FederationAck(origin=origin, seq=seq, applied=applied)
        return ack if off == len(data) else None
    except (struct.error, IndexError, UnicodeDecodeError):
        return None
