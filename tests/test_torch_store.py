"""The port's Store, its loaders and its Store-backed TickEngine against
the JAX package's.

Both engines (``capacity=256, max_batch=64``, the shape of
tests/test_store.py) get a ``MockStore`` of their own package and the same
request objects at the same ``now``.  The (5, n) responses, the Store's
contents and its call counts must be equal after every window: the
write-through (``on_change`` once per distinct slot, ``remove`` for a slot
RESET_REMAINING cleared), the read-through of a fresh engine on the same
Store, and ``export_columns``.  The loaders are held to the reference's on
the same calls, and a ``ColumnFileLoader`` file written from either
package's export loads into the other with an identical export.
"""

import numpy as np
import pytest

from gubernator_tpu import store as jstore
from gubernator_tpu.ops.engine import TickEngine as JaxEngine
from gubernator_tpu.types import RateLimitRequest as JReq
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch.ops.engine import TickEngine
from gubernator_tpu_torch.ops.reqcols import ReqColumns
from gubernator_tpu_torch.types import Behavior, RateLimitRequest as TReq
from tests.test_torch_common import EXACT_DL, NOW
from tests.test_torch_state import assert_same_snapshot


# Time steps between windows: a multiple of every exact pair's
# duration / limit, so every leak is a whole number of tokens (the JAX
# engine adds inexact leaks in triple-float32, ROADMAP C.1).
STEP = 18_000


def request_pair(rng, ids, prefix="s", reset=0.1, algorithms=5):
    """The same requests over keys ``ids`` as both packages' objects: all
    five algorithms (the first ``algorithms``), leaky (duration, limit)
    pairs from the exact pool, a share of RESET_REMAINING rows; the
    server stamps ``created_at``."""
    n = len(ids)
    dl = [EXACT_DL[i] for i in rng.integers(0, len(EXACT_DL) - 1, n)]
    hits = rng.choice([0, 1, 1, 2, 5], n)
    algo = rng.integers(0, algorithms, n)
    beh = np.where(rng.random(n) < reset, int(Behavior.RESET_REMAINING), 0)
    burst = rng.choice([0, 0, 20], n)
    fields = [dict(name=prefix, unique_key=f"k{int(i)}", hits=int(h),
                   limit=int(lim), duration=int(d), algorithm=int(a),
                   behavior=int(b), burst=int(bu))
              for i, h, (d, lim), a, b, bu in zip(ids, hits, dl, algo, beh,
                                                   burst)]
    return [JReq(**f) for f in fields], [TReq(**f) for f in fields]


def resp_tuples(resps):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error)
            for r in resps]


def serve(j, t, rng, ids, now, **kw):
    """One window through both engines; responses held equal."""
    jr, tr = request_pair(rng, ids, **kw)
    want = resp_tuples(j.process(jr, now=now))
    got = resp_tuples(t.process(tr, now=now))
    assert got == want
    return got


def test_store_engine_writes_and_reads_through_like_jax():
    js, ts = jstore.MockStore(), tstore.MockStore()
    j = JaxEngine(capacity=256, max_batch=64, store=js)
    t = TickEngine(capacity=256, max_batch=64, device="cpu", store=ts)
    rng = np.random.default_rng(71)
    now = NOW
    for k in range(6):
        now += STEP * int(rng.integers(0, 3))
        ids = rng.choice(100, 64, replace=False)
        serve(j, t, rng, ids, now)
        assert ts.data == js.data, k
        assert ts.called == js.called, k
    # A window whose keys repeat: one on_change a distinct key.
    before = dict(ts.called)
    now += STEP
    serve(j, t, rng, rng.integers(0, 12, 48), now)
    assert ts.called == js.called and ts.data == js.data
    assert ts.called["OnChange()"] - before["OnChange()"] <= 12
    assert js.called["Remove()"] > 0 and js.called["Get()"] > 0
    assert_same_snapshot(t.export_columns(), j.export_columns())

    # Fresh engines on the same Stores: misses read through, and the
    # buckets go on from the persisted state.
    j2 = JaxEngine(capacity=256, max_batch=64, store=js)
    t2 = TickEngine(capacity=256, max_batch=64, device="cpu", store=ts)
    for k in range(3):
        now += STEP
        serve(j2, t2, rng, rng.choice(120, 64, replace=False), now)
        assert ts.data == js.data and ts.called == js.called
    assert_same_snapshot(t2.export_columns(), j2.export_columns())
    assert t2.metric_misses == j2.metric_misses
    assert t2.metric_hits == j2.metric_hits


def test_store_read_through_needs_request_objects():
    t = TickEngine(capacity=16, max_batch=8, device="cpu",
                   store=tstore.MockStore())
    cols = ReqColumns.from_requests([TReq(name="a", unique_key="b", hits=1,
                                          limit=3, duration=1_000)])
    assert cols.refs is None
    with pytest.raises(ValueError, match="keep_refs"):
        t.process_columns(cols, now=NOW)
    kept = ReqColumns.from_requests(
        [TReq(name="a", unique_key="b", hits=1, limit=3, duration=1_000)],
        keep_refs=True)
    assert kept.slice_chunk(0, 1).refs == kept.refs
    assert kept.key_bytes(0) == b"a_b"
    mat, err = t.process_columns(kept, now=NOW)
    assert not err and mat[2, 0] == 2


def test_loaders_match_jax(tmp_path):
    items = [{"key": f"s_k{i}", "algorithm": i % 2, "limit": 10,
              "remaining": i, "remaining_f": i + 0.5, "duration": 60_000,
              "created_at": NOW, "updated_at": NOW, "burst": 10,
              "status": 0, "expire_at": NOW + 60_000, "tat": i,
              "prev_count": 2 * i} for i in range(5)]
    for name in ("MockLoader", "FileLoader", "ColumnFileLoader"):
        if name == "MockLoader":
            jl, tl = jstore.MockLoader(), tstore.MockLoader()
        else:
            jl = getattr(jstore, name)(str(tmp_path / f"j_{name}"))
            tl = getattr(tstore, name)(str(tmp_path / f"t_{name}"))
        assert list(tl.load()) == list(jl.load())
        jl.save(items)
        tl.save(items)
        assert list(tl.load()) == list(jl.load()) == items
        if name == "MockLoader":
            assert tl.called == jl.called
    # MockStore on the same calls.
    js, ts = jstore.MockStore(), tstore.MockStore()
    for s, r in ((js, JReq), (ts, TReq)):
        s.on_change(r(name="s", unique_key="k0"), dict(items[0]))
        s.get(r(name="s", unique_key="k0"))
        s.get(r(name="s", unique_key="k9"))
        s.remove("s_k0")
        s.remove("s_k9")
    assert ts.data == js.data and ts.called == js.called


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_column_file_loads_across_packages(tmp_path, writer):
    """A ColumnFileLoader file saved from one package's export loads into
    both packages' engines with identical exports."""
    js, ts = jstore.MockStore(), tstore.MockStore()
    j = JaxEngine(capacity=256, max_batch=64, store=js)
    t = TickEngine(capacity=256, max_batch=64, device="cpu", store=ts)
    rng = np.random.default_rng(72 if writer == "jax" else 73)
    serve(j, t, rng, rng.choice(90, 64, replace=False), NOW)
    path = str(tmp_path / "snap.npz")
    src, loader = ((j, jstore.ColumnFileLoader(path)) if writer == "jax"
                   else (t, tstore.ColumnFileLoader(path)))
    loader.save_columns(src.export_columns())
    j2 = JaxEngine(capacity=256, max_batch=64)
    t2 = TickEngine(capacity=256, max_batch=64, device="cpu")
    j2.load_columns(jstore.ColumnFileLoader(path).load_columns(), now=NOW)
    t2.load_columns(tstore.ColumnFileLoader(path).load_columns(), now=NOW)
    assert_same_snapshot(t2.export_columns(), j2.export_columns())
    assert t2.cache_size() == j2.cache_size() > 40
    # The dict face of the same file.
    assert (tstore.ColumnFileLoader(path).load()
            == jstore.ColumnFileLoader(path).load())
