"""Shared inputs for the torch-port parity tests, plus the host-format
checks (REQ32 packing, compact responses, slot maps) of the port against
the JAX package.

Every generator draws from a seeded numpy Generator, so both packages see
the same numbers.  State and request lanes are logical numpy columns
keyed by field name; the ``to_*`` helpers hand them to either side.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gubernator_tpu.ops import engine as jeng
from gubernator_tpu.ops.buckets import BucketState, ReqBatch
from gubernator_tpu.ops.reqcols import ReqColumns as JReqColumns
from gubernator_tpu_torch.native import NativeSlotMap
from gubernator_tpu_torch.ops import engine as teng
from gubernator_tpu_torch.ops.buckets import STATE_FIELDS
from gubernator_tpu_torch.ops.reqcols import ReqColumns as TReqColumns
from gubernator_tpu_torch.types import Behavior

NOW = 1_700_000_000_000

# (duration, limit) pairs whose rate duration/limit is exact in binary:
# the JAX package's triple-float32 leaky arithmetic (transition32) rounds
# like float64 only there.
EXACT_DL = [(30_000, 10), (60_000, 1000), (1_000, 4), (4_096, 1 << 12),
            (3_600_000, 1000), (5_000, 5), (1_000, 1), (0, 10)]
INEXACT_DL = [(1_000, 3), (900, 7), (1_234, 11), (60_000, 13)]

REQ_FIELDS = ("slot", "known", "hits", "limit", "duration", "algorithm",
              "behavior", "created_at", "burst", "greg_exp", "greg_dur",
              "valid")


def gen_lanes(rng, n, exact=True):
    """Random (state, request) lanes over all five algorithms exercising
    every branch: existence, expiry, algorithm switch, limit/duration/
    burst changes, RESET/DRAIN/Gregorian, negative and huge hits."""
    pool = EXACT_DL if exact else EXACT_DL + INEXACT_DL
    d_l = [pool[i] for i in rng.integers(0, len(pool), n)]
    duration = np.array([d for d, _ in d_l], np.int64)
    limit = np.array([l for _, l in d_l], np.int64)

    hits = rng.choice([0, 1, 2, 5, 100, -1, -50, 10**12], n).astype(np.int64)
    algo = rng.integers(0, 5, n).astype(np.int64)
    behavior = np.zeros(n, np.int64)
    pick = rng.random(n)
    behavior[pick < 0.2] = int(Behavior.RESET_REMAINING)
    behavior[(pick >= 0.2) & (pick < 0.35)] = int(Behavior.DRAIN_OVER_LIMIT)
    greg = (pick >= 0.35) & (pick < 0.45)
    behavior[greg] |= int(Behavior.DURATION_IS_GREGORIAN)
    burst = rng.choice([0, 5, 20, 10**6], n).astype(np.int64)

    known = rng.random(n) < 0.8
    in_use = rng.random(n) < 0.85
    s_algo = np.where(rng.random(n) < 0.7, algo, rng.integers(0, 5, n))
    s_limit = np.where(rng.random(n) < 0.6, limit,
                       rng.choice([1, 7, 2000, 10**13], n))
    s_duration = np.where(rng.random(n) < 0.6, duration,
                          rng.choice([500, 2_000, 120_000], n))
    s_remaining = rng.integers(-3, 30, n).astype(np.int64)
    s_remaining[rng.random(n) < 0.2] = 0
    s_rem_f = rng.integers(0, 25, n) + rng.integers(0, 8, n) / 8.0
    s_created = NOW - rng.integers(0, 120_000, n)
    s_updated = NOW - rng.integers(-5_000, 120_000, n)
    s_burst = np.where(rng.random(n) < 0.6, np.where(burst == 0, limit, burst),
                       rng.choice([3, 50], n))
    s_status = (rng.random(n) < 0.2).astype(np.int64)
    s_expire = NOW + rng.choice([-10_000, -1, 0, 1, 60_000], n)
    s_tat = NOW + rng.integers(-60_000, 60_000, n)
    s_prev = rng.integers(0, 30, n).astype(np.int64)
    created = NOW - rng.choice([0, 0, 0, 1_000, 3_000, 61_000, -500], n)
    greg_exp = np.where(greg, NOW + rng.choice([500, 3_600_000], n), 0)
    greg_dur = np.where(greg, rng.choice([3_600_000, 86_400_000], n), 0)

    state = dict(
        algorithm=s_algo.astype(np.int64), limit=s_limit.astype(np.int64),
        remaining=s_remaining, remaining_f=s_rem_f.astype(np.float64),
        duration=s_duration.astype(np.int64),
        created_at=s_created.astype(np.int64),
        updated_at=s_updated.astype(np.int64),
        burst=s_burst.astype(np.int64), status=s_status,
        expire_at=s_expire.astype(np.int64), in_use=in_use,
        tat=s_tat.astype(np.int64), prev_count=s_prev,
    )
    req = dict(
        slot=np.arange(n, dtype=np.int64), known=known, hits=hits,
        limit=limit, duration=duration, algorithm=algo, behavior=behavior,
        created_at=created.astype(np.int64), burst=burst,
        greg_exp=greg_exp.astype(np.int64), greg_dur=greg_dur.astype(np.int64),
        valid=np.ones(n, bool),
    )
    return state, req


def edge_lanes(n_copies=1):
    """Hand-picked lanes at the arithmetic edges: float64 → int64 values
    out of range (saturation), NaN/inf/negative leaky remainders, int64
    product overflow, zero and negative limits/durations."""
    big = 10**13
    rows = [
        # leak = elapsed / 1e-13 overflows int64 → saturates, leaked = true
        dict(alg=1, limit=big, duration=1, hits=1, s_updated=0, s_remf=3.5),
        # negative elapsed, huge negative leak
        dict(alg=1, limit=big, duration=1, hits=1, s_updated=NOW * 2,
             s_remf=2.0),
        # NaN / inf / -inf / negative stored leaky remainders
        dict(alg=1, limit=10, duration=30_000, hits=1, s_remf=float("nan")),
        dict(alg=1, limit=10, duration=30_000, hits=0, s_remf=float("inf")),
        dict(alg=1, limit=10, duration=30_000, hits=2, s_remf=-float("inf")),
        dict(alg=1, limit=10, duration=30_000, hits=1, s_remf=-7.25),
        dict(alg=0, limit=10, duration=30_000, hits=0, s_remf=-7.25,
             behavior=int(Behavior.RESET_REMAINING)),
        # (limit - rem) * rate_i overflows int64 (wraps)
        dict(alg=1, limit=2**62, duration=2**62, hits=10**12, s_remf=1.0,
             known=False),
        dict(alg=1, limit=-(2**62), duration=2**62 - 1, hits=3, known=False),
        # limit 0 / negative, duration 0 / negative across the zoo
        dict(alg=2, limit=0, duration=0, hits=1),
        dict(alg=2, limit=5, duration=-10, hits=2, created=-5),
        dict(alg=3, limit=0, duration=1000, hits=1),
        dict(alg=3, limit=-4, duration=-1000, hits=-2),
        dict(alg=3, limit=7, duration=1000, hits=10**12, burst=2**40),
        dict(alg=4, limit=-1, duration=0, hits=-5),
        dict(alg=4, limit=3, duration=1000, hits=2**62),
        dict(alg=2, limit=5, duration=1000, hits=1, s_prev=2**62,
             s_created=NOW - 1500),
        # unknown algorithm value resolves through the sliding window
        dict(alg=7, limit=5, duration=1000, hits=1),
    ]
    n = len(rows) * n_copies
    state = {f: np.zeros(n, np.float64 if f == "remaining_f" else np.int64)
             for f in STATE_FIELDS}
    state["in_use"] = np.ones(n, bool)
    req = {f: np.zeros(n, np.int64) for f in REQ_FIELDS}
    req["known"] = np.ones(n, bool)
    req["valid"] = np.ones(n, bool)
    req["slot"] = np.arange(n, dtype=np.int64)
    for i in range(n):
        e = rows[i % len(rows)]
        req["algorithm"][i] = e["alg"]
        req["limit"][i] = e["limit"]
        req["duration"][i] = e["duration"]
        req["hits"][i] = e["hits"]
        req["behavior"][i] = e.get("behavior", 0)
        req["burst"][i] = e.get("burst", 0)
        req["created_at"][i] = e.get("created", NOW)
        req["known"][i] = e.get("known", True)
        state["algorithm"][i] = e["alg"]
        state["limit"][i] = e["limit"]
        state["duration"][i] = e["duration"]
        state["remaining_f"][i] = e.get("s_remf", 0.0)
        state["updated_at"][i] = e.get("s_updated", NOW - 5_000)
        state["created_at"][i] = e.get("s_created", NOW - 5_000)
        state["expire_at"][i] = NOW + 60_000
        state["prev_count"][i] = e.get("s_prev", 0)
        state["remaining"][i] = 2
    return state, req


def to_jax(state, req):
    """Logical numpy lanes → the JAX package's x64 BucketState/ReqBatch."""
    i32 = ("algorithm", "status")
    s = BucketState(**{
        f: jnp.asarray(state[f], jnp.int32 if f in i32 else None)
        for f in STATE_FIELDS
    })
    r = ReqBatch(**{
        f: jnp.asarray(req[f], jnp.int32 if f in ("slot", "algorithm", "behavior")
                       else None)
        for f in REQ_FIELDS
    })
    return s, r


def to_torch(cols):
    """Logical numpy columns → int64 torch columns (float64 stays)."""
    return {
        f: torch.from_numpy(np.asarray(
            v, np.float64 if np.asarray(v).dtype == np.float64 else np.int64))
        for f, v in cols.items()
    }


def pack_m32(req, slots, b, capacity):
    """Slot-sorted (19, b) int32 REQ32 matrix from request lanes placed at
    ``slots`` (sorted, unique); lanes past ``len(slots)`` are padding."""
    R = teng.REQ32_INDEX
    n = len(slots)
    m = np.zeros((teng.REQ32_ROWS, b), np.int32)
    m[R["slot"]] = capacity
    m[R["slot"], :n] = slots
    for f in ("known", "algorithm", "behavior", "valid"):
        m[R[f], :n] = np.asarray(req[f][:n], np.int64)
    for f in teng.REQ32_WIDE:
        teng.pack_wide_rows(m, f, req[f][:n], slice(0, n))
    return m


def req_columns(rng, n, keys, exact=True, created=None):
    """Matching JAX and port ReqColumns over ``keys`` (bytes)."""
    _, req = gen_lanes(rng, n, exact=exact)
    blob, offsets = teng_pack(keys)
    greg_pick = rng.random(n) < 0.08
    behavior = req["behavior"] & ~int(Behavior.DURATION_IS_GREGORIAN)
    behavior[greg_pick] |= int(Behavior.DURATION_IS_GREGORIAN)
    duration = np.where(greg_pick, rng.integers(0, 6, n), req["duration"])
    ca = req["created_at"] if created is None else np.full(n, created, np.int64)
    cols = [req["hits"], req["limit"], duration, req["algorithm"], behavior,
            ca, req["burst"]]
    return (JReqColumns(blob, offsets, *[c.copy() for c in cols]),
            TReqColumns(blob, offsets, *[c.copy() for c in cols]))


def teng_pack(keys):
    from gubernator_tpu_torch.ops.reqcols import pack_blob

    return pack_blob(list(keys))


# ----------------------------------------------------------------------
# Host-format parity
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [1, 2])
def test_pack_cols_req32_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, b, cap = 48, 64, 256
    keys = [f"k{i}".encode() for i in range(n)]
    jcols, tcols = req_columns(rng, n, keys)
    jcols.created_at[::5] = -1  # CREATED_UNSET: stamped with now
    tcols.created_at[::5] = -1
    slots = rng.permutation(cap)[:n].astype(np.int64)
    known = (rng.random(n) < 0.5).astype(np.uint8)
    mj = np.zeros((jeng.REQ32_ROWS, b), np.int32)
    mt = np.zeros((teng.REQ32_ROWS, b), np.int32)
    jeng.pack_cols_req32(mj, jcols, slots, known, NOW, slice(0, n))
    teng.pack_cols_req32(mt, tcols, slots, known, NOW, slice(0, n))
    np.testing.assert_array_equal(mt, mj)
    assert teng.REQ32_INDEX == jeng.REQ32_INDEX
    inv_j, dup_j = jeng.sort_packed_by_slot(mj, n, cap)
    inv_t, dup_t = teng.sort_packed_by_slot(mt, n, cap)
    np.testing.assert_array_equal(inv_t, inv_j)
    assert dup_t == dup_j
    np.testing.assert_array_equal(mt, mj)


def test_unpack_resp_compact_matches_jax():
    rng = np.random.default_rng(3)
    raw = rng.integers(-2**31, 2**31, (6, 40)).astype(np.int32)
    limit = rng.integers(-2**62, 2**62, 40)
    np.testing.assert_array_equal(
        teng.unpack_resp_compact(raw, limit),
        jeng.unpack_resp_compact(raw, limit))


@pytest.mark.parametrize("kind", ["native", "python"])
def test_slot_maps_assign_like_jax(kind):
    """Both port slot maps hand out and reuse slots exactly as the JAX
    package's native map does (the engines' slot-for-slot parity rests
    on it)."""
    from gubernator_tpu.ops.engine import make_slot_map as jax_slot_map

    cap = 32
    tm = NativeSlotMap(cap) if kind == "native" else teng.SlotMap(cap)
    jm = jax_slot_map(cap)
    rng = np.random.default_rng(4)
    for _ in range(6):
        keys = [f"key{int(k)}".encode() for k in rng.integers(0, 60, 20)]
        ts, tk = tm.resolve_batch(keys)
        js, jk = jm.resolve_batch(keys)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tk, jk)
        rel = np.flatnonzero(jm.mapped_mask())[::3]
        tm.release_batch(rel)
        jm.release_batch(rel)
        np.testing.assert_array_equal(tm.mapped_mask(), jm.mapped_mask())
