"""The port's wire codec against the JAX package's, on the same bytes.

``gubernator_tpu_torch.transport.fastwire`` (its own build of
``csrc/wirecodec.cc``), ``transport.wire``, ``transport.convert`` and the
ingest ``ColumnArena`` are held against their JAX-package counterparts on
request and response frames made from a numpy seed: empty names and keys,
multi-byte names, metadata, explicit and absent ``created_at``, GLOBAL and
other behavior bits, out-of-range algorithms, negative int64s, 1000-item
batches and malformed frames.  Columns and bytes must be identical.  Pure
host code: no JAX program is compiled.
"""

import numpy as np
import pytest

from gubernator_tpu.ops import reqcols as jreqcols
from gubernator_tpu.pb import gubernator_pb2 as pb
from gubernator_tpu.transport import convert as jconvert
from gubernator_tpu.transport import fastwire as jfastwire
from gubernator_tpu.transport import wire as jwire
from gubernator_tpu_torch.ops import reqcols
from gubernator_tpu_torch.pb import gubernator_pb2 as tpb
from gubernator_tpu_torch.transport import convert, fastwire, wire

SEEDS = range(3)
COLUMNS = ("hits", "limit", "duration", "algorithm", "behavior",
           "created_at", "burst", "name_len")
BEHAVIORS = (0, 1, 2, 4, 8, 16, 32, 2 | 8, 8 | 32, 1 | 32)


def random_msgs(rng, n, *, errors=True, special=True):
    """``n`` RateLimitReq messages: every field drawn from ``rng``."""
    out = []
    for _ in range(n):
        name = f"svc{int(rng.integers(0, 40))}"
        if rng.random() < 0.1:
            name = "naïve-名前"  # multi-byte UTF-8: name_len counts bytes
        key = f"k{int(rng.integers(0, 10**9))}"
        if errors and rng.random() < 0.03:
            name = ""
        if errors and rng.random() < 0.03:
            key = ""
        behavior = int(rng.choice(BEHAVIORS))
        if not special:
            behavior &= ~(2 | 16)
        m = pb.RateLimitReq(
            name=name, unique_key=key,
            hits=int(rng.integers(-3, 1000)),
            limit=int(rng.integers(-10, 2**62)),
            duration=int(rng.integers(0, 2**40)),
            algorithm=int(rng.integers(0, 6 if errors else 5)),
            behavior=behavior,
            burst=int(rng.integers(0, 100)),
        )
        if rng.random() < 0.5:
            m.created_at = int(rng.integers(0, 2**41))
        if special and rng.random() < 0.05:
            m.metadata["traceparent"] = "00-" + "1" * 32 + "-" + "2" * 16 + "-01"
        out.append(m)
    return out


def frame(msgs) -> bytes:
    return pb.GetRateLimitsReq(requests=msgs).SerializeToString()


def assert_same_columns(a, b):
    assert bytes(a.key_blob) == bytes(b.key_blob)
    np.testing.assert_array_equal(a.key_offsets, b.key_offsets)
    for f in COLUMNS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


def assert_same_parse(data, arenas=(None, None)):
    a = jfastwire.parse_req(data, arenas[0])
    b = fastwire.parse_req(data, arenas[1])
    assert (a is None) == (b is None)
    if a is None:
        return None
    assert a[1] == b[1] and a[2] == b[2]
    assert_same_columns(a[0], b[0])
    return a, b


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [7, 1000])
def test_parse_req_matches_the_jax_codec(seed, n):
    rng = np.random.default_rng(seed)
    assert_same_parse(frame(random_msgs(rng, n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_columns_from_pb_matches_the_jax_conversion(seed):
    rng = np.random.default_rng(100 + seed)
    msgs = random_msgs(rng, 300)
    a = jconvert.columns_from_pb(msgs)
    b = convert.columns_from_pb(
        tpb.GetRateLimitsReq.FromString(frame(msgs)).requests)
    assert a[1] == b[1] and a[2] == b[2]
    assert_same_columns(a[0], b[0])
    ra = jconvert.reqs_from_pb(msgs)
    rb = convert.reqs_from_pb(msgs)
    assert [vars(r) for r in ra] == [vars(r) for r in rb]
    assert ([m.SerializeToString() for m in jconvert.resps_to_pb([])]
            == [m.SerializeToString() for m in convert.resps_to_pb([])])


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_req_matches_the_jax_codec_and_round_trips(seed):
    rng = np.random.default_rng(200 + seed)
    msgs = random_msgs(rng, 1000, errors=False)
    a, b = assert_same_parse(frame(msgs))
    raw = fastwire.encode_req(b[0])
    assert raw == jfastwire.encode_req(a[0])
    # The bytes decode to the same requests, created_at 0 stamped later.
    assert_same_parse(raw)
    back = pb.GetRateLimitsReq.FromString(raw).requests
    for m, r in zip(msgs, back):
        assert (r.name, r.unique_key, r.hits, r.limit) == (
            m.name, m.unique_key, m.hits, m.limit)


def test_encode_req_needs_name_lengths():
    cols = reqcols.ReqColumns.from_requests([])
    assert fastwire.encode_req(cols) == b""
    full = fastwire.parse_req(frame(random_msgs(
        np.random.default_rng(7), 3, errors=False)))[0]
    full.name_len = None
    with pytest.raises(ValueError):
        fastwire.encode_req(full)


def random_matrix(rng, n):
    m = np.zeros((5, n), np.int64)
    m[0] = rng.integers(0, 2, n)
    pick = rng.integers(0, 4, (3, n))
    big = rng.integers(-2**63, 2**63 - 1, (3, n), dtype=np.int64)
    small = rng.integers(-200, 200, (3, n))
    m[1:4] = np.where(pick == 0, 0, np.where(pick == 1, big, small))
    m[4] = m[0]
    return m


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [0, 129, 1000])
def test_encode_resp_matches_the_jax_encoders_and_protobuf(seed, n):
    mat = random_matrix(np.random.default_rng(300 + seed), n)
    out = fastwire.encode_resp(mat)
    assert out == jfastwire.encode_resp(mat)
    assert out == wire.encode_get_rate_limits_resp(mat)
    assert out == jwire.encode_get_rate_limits_resp(mat)
    ref = pb.GetRateLimitsResp(responses=[
        pb.RateLimitResp(status=int(mat[0, i]), limit=int(mat[1, i]),
                         remaining=int(mat[2, i]), reset_time=int(mat[3, i]))
        for i in range(n)]).SerializeToString()
    assert out == ref


@pytest.mark.parametrize("seed", SEEDS)
def test_parse_resp_matches_the_jax_codec(seed):
    rng = np.random.default_rng(400 + seed)
    mat = random_matrix(rng, 200)
    resps = []
    for i in range(200):
        r = pb.RateLimitResp(status=int(mat[0, i]), limit=int(mat[1, i]),
                             remaining=int(mat[2, i]),
                             reset_time=int(mat[3, i]))
        if rng.random() < 0.1:
            r.error = "boom"
        if rng.random() < 0.1:
            r.metadata["owner"] = "10.0.0.1:81"
        resps.append(r)
    data = pb.GetRateLimitsResp(responses=resps).SerializeToString()
    a, b = jfastwire.parse_resp(data), fastwire.parse_resp(data)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(b[0], mat[:4])


@pytest.mark.parametrize("seed", SEEDS)
def test_malformed_frames_parse_to_none_in_both(seed):
    rng = np.random.default_rng(500 + seed)
    good = frame(random_msgs(rng, 20))
    bad = [
        good[: int(rng.integers(1, len(good)))],        # truncated
        b"\x0a\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01",  # bad varint
        b"\x0b" + good[1:],                              # wire type 3
        bytes(rng.integers(0, 256, 64, dtype=np.uint8)),  # noise
    ]
    for data in bad:
        a = jfastwire.parse_req(data)
        b = fastwire.parse_req(data)
        assert (a is None) == (b is None)
        if a is not None:
            assert_same_columns(a[0], b[0])
        ra, rb = jfastwire.parse_resp(data), fastwire.parse_resp(data)
        assert (ra is None) == (rb is None)
    assert fastwire.parse_req(b"") is not None
    assert len(fastwire.parse_req(b"")[0]) == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_arena_decode_matches_and_recycles(seed):
    """Decodes into the two packages' arenas agree; leases, misses and
    the per-window fallback budget count alike; a released slab is
    reused, and exhaustion past the budget raises in both."""
    rng = np.random.default_rng(600 + seed)
    ja = jreqcols.ColumnArena(1000, slabs=2, fallback_limit=1)
    pa = reqcols.ColumnArena(1000, slabs=2, fallback_limit=1)
    frames = [frame(random_msgs(rng, int(rng.integers(1, 400))))
              for _ in range(3)]
    held = [assert_same_parse(f, (ja, pa)) for f in frames[:2]]
    assert pa.in_use() == ja.in_use() == 2
    third = assert_same_parse(frames[2], (ja, pa))  # budgeted fallback
    assert third[1][0].lease is None
    with pytest.raises(jreqcols.IngestOverloadError):
        jfastwire.parse_req(frames[0], ja)
    with pytest.raises(reqcols.IngestOverloadError):
        fastwire.parse_req(frames[0], pa)
    for a, b in held:
        a[0].release()
        b[0].release()
        b[0].release()  # idempotent
    assert pa.in_use() == ja.in_use() == 0
    assert_same_parse(frames[1], (ja, pa))
    oversize = frame(random_msgs(rng, 1001))  # wider than any slab
    assert_same_parse(oversize, (ja, pa))
    for f in ("metric_leases", "metric_misses", "metric_fallbacks"):
        assert getattr(pa, f) == getattr(ja, f), f


@pytest.mark.parametrize("seed", SEEDS)
def test_concat_and_slices_match_the_jax_columns(seed):
    rng = np.random.default_rng(700 + seed)
    jparts, pparts = [], []
    for _ in range(3):
        data = frame(random_msgs(rng, int(rng.integers(1, 50)),
                                 errors=False))
        a, b = assert_same_parse(data)
        jparts.append(a[0])
        pparts.append(b[0])
    a = jreqcols.ReqColumns.concat(jparts)
    b = reqcols.ReqColumns.concat(pparts)
    assert_same_columns(a, b)
    s, e = 2, len(b) - 1
    assert_same_columns(a.slice_chunk(s, e), b.slice_chunk(s, e))
    assert fastwire.encode_req(b) == jfastwire.encode_req(a)
    names = [f"n{i}" for i in range(5)]
    keys = [f"k{i}" for i in range(5)]
    ja, jo = jreqcols.key_blob_from_parts(names, keys)
    pa_, po = reqcols.key_blob_from_parts(names, keys)
    assert ja == pa_ and np.array_equal(jo, po)
