"""Conversions between wire protos and the engine's dataclasses.

The port's copy of the JAX package's ``transport/convert``.  The engine
and service layers work with plain dataclasses
(:mod:`gubernator_tpu_torch.types`) and need no protobuf; the transport
edge converts.  `created_at` uses proto3 `optional` presence —
absence means "server stamps now" (reference gubernator.proto:172-182).
"""

from __future__ import annotations

from typing import Iterable, List

from gubernator_tpu_torch.pb import gubernator_pb2 as pb
from gubernator_tpu_torch.types import RateLimitRequest, RateLimitResponse


def req_from_pb(m: pb.RateLimitReq) -> RateLimitRequest:
    return RateLimitRequest(
        name=m.name,
        unique_key=m.unique_key,
        hits=m.hits,
        limit=m.limit,
        duration=m.duration,
        algorithm=int(m.algorithm),
        behavior=int(m.behavior),
        burst=m.burst,
        metadata=dict(m.metadata),
        created_at=m.created_at if m.HasField("created_at") else None,
    )


def req_to_pb(r: RateLimitRequest) -> pb.RateLimitReq:
    m = pb.RateLimitReq(
        name=r.name,
        unique_key=r.unique_key,
        hits=r.hits,
        limit=r.limit,
        duration=r.duration,
        algorithm=r.algorithm,
        behavior=r.behavior,
        burst=r.burst,
    )
    for k, v in r.metadata.items():
        m.metadata[k] = v
    if r.created_at is not None:
        m.created_at = r.created_at
    return m


def resp_from_pb(m: pb.RateLimitResp) -> RateLimitResponse:
    return RateLimitResponse(
        status=int(m.status),
        limit=m.limit,
        remaining=m.remaining,
        reset_time=m.reset_time,
        error=m.error,
        metadata=dict(m.metadata),
    )


def resp_to_pb(r: RateLimitResponse) -> pb.RateLimitResp:
    m = pb.RateLimitResp(
        status=r.status,
        limit=r.limit,
        remaining=r.remaining,
        reset_time=r.reset_time,
        error=r.error,
    )
    for k, v in r.metadata.items():
        m.metadata[k] = v
    return m


def reqs_from_pb(ms: Iterable[pb.RateLimitReq]) -> List[RateLimitRequest]:
    return [req_from_pb(m) for m in ms]


def columns_from_pb(ms) -> tuple:
    """Parse a repeated RateLimitReq straight into a columnar batch —
    the wire→device fast path with no per-request dataclasses.

    Returns ``(cols, errors, special)``: per-item validation errors
    (empty name/unique_key, the reference's error-in-item convention,
    gubernator.go:208-216) and ``special`` = True when any item carries
    GLOBAL or MULTI_REGION behavior or metadata (trace context) — those
    need the object-routing path.  ``created_at == 0`` means "server stamps now"
    (matching V1Instance's object path, gubernator.go:218-220).
    """
    import numpy as np

    from gubernator_tpu_torch.algos import algorithm_error, invalid_algorithm_mask
    from gubernator_tpu_torch.ops.reqcols import CREATED_UNSET, ReqColumns, pack_blob
    from gubernator_tpu_torch.types import Behavior

    n = len(ms)
    if n == 0:
        return ReqColumns.empty(), {}, False
    SPECIAL = int(Behavior.GLOBAL) | int(Behavior.MULTI_REGION)
    keys: List[bytes] = [b""] * n
    hits = [0] * n
    limit = [0] * n
    duration = [0] * n
    algorithm = [0] * n
    behavior = [0] * n
    created = [0] * n
    burst = [0] * n
    errors = {}
    special = False
    for i, m in enumerate(ms):
        uk = m.unique_key
        nm = m.name
        if uk == "":
            errors[i] = "field 'unique_key' cannot be empty"
        elif nm == "":
            errors[i] = "field 'namespace' cannot be empty"
        else:
            if invalid_algorithm_mask(int(m.algorithm)):
                # Unknown enum values must NOT fall through the kernels'
                # branchless dispatch as token-bucket (algos/__init__.py).
                errors[i] = algorithm_error(m.algorithm)
            # The key is well-formed even when the algorithm is not —
            # keep it in the blob (fastwire.parse_req parity; batches
            # with errors never reach the columns tick path).
            keys[i] = (nm + "_" + uk).encode()
        hits[i] = m.hits
        limit[i] = m.limit
        duration[i] = m.duration
        algorithm[i] = m.algorithm
        b = behavior[i] = m.behavior
        created[i] = m.created_at or CREATED_UNSET
        burst[i] = m.burst
        if (b & SPECIAL) or m.metadata:
            special = True
    a = lambda v: np.asarray(v, np.int64)  # noqa: E731
    blob, offsets = pack_blob(keys)
    return (
        ReqColumns(
            blob, offsets, a(hits), a(limit), a(duration), a(algorithm),
            a(behavior), a(created), a(burst),
        ),
        errors,
        special,
    )


def resps_to_pb(rs: Iterable[RateLimitResponse]) -> List[pb.RateLimitResp]:
    return [resp_to_pb(r) for r in rs]
