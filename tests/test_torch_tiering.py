"""The port's cold tier and its tiered TickEngine against the JAX
package's, and the port's background reclaim.

* ``ColdStore``: both packages' tiers take the same puts (expired rows,
  overwrites, overflow past the budget into a write-behind ``MockStore``),
  takes, TTL sweeps and exports; every answer, ``stats()`` and the sink's
  contents must be equal, and a tier's export loads into the other
  package's tier with an identical export.
* The engines (``capacity=4, max_batch=8``, the shape of
  tests/test_tiering.py) churn a working set four times the table through
  a cold tier, with and without a Store, and with a cold tier small enough
  to write behind into the Store: the (5, n) responses, ``cold_size``,
  ``export_columns`` (hot and cold rows), the Store's calls and the tier
  counters must be equal.  A snapshot larger than the table overflows
  into the cold tier alike.
* Background reclaim (port only) holds tests/test_engine.py's invariants
  (512/64 and 128/64), keeps every key's count under concurrent ticks,
  and drops the candidates a window touched between its phases.
"""

import time

import numpy as np
import pytest

import chip_smoke as cs
from gubernator_tpu import store as jstore
from gubernator_tpu.ops.engine import TickEngine as JaxEngine
from gubernator_tpu.tiering import coldstore as jcold
from gubernator_tpu.types import RateLimitRequest as JReq
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch.ops import engine as E
from gubernator_tpu_torch.ops.engine import TickEngine
from gubernator_tpu_torch.tiering import coldstore as tcold
from gubernator_tpu_torch.types import RateLimitRequest as TReq
from tests.test_torch_common import NOW
from tests.test_torch_state import assert_same_snapshot
from tests.test_torch_store import STEP, request_pair, resp_tuples

TIER_METRICS = (
    "metric_hits", "metric_misses", "metric_over_limit",
    "metric_unexpired_evictions", "metric_shed_requests",
    "metric_cold_hits", "metric_promotions", "metric_promote_dispatches",
    "metric_promote_ticks", "metric_demote_readbacks",
    "metric_evict_reclaims",
)


def cold_columns(rng, n, now):
    """Random COLD_FIELDS columns; about a fifth of the rows expired."""
    cols = {f: rng.integers(-5, 1000, n).astype(np.int64)
            for f in tcold.COLD_FIELDS}
    cols["remaining_f"] = rng.integers(0, 50, n) + rng.random(n)
    cols["expire_at"] = now + rng.integers(-10_000, 60_000, n)
    return cols


def plain(x):
    """Results as plain Python (arrays to lists), for comparison."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def cold_ops(cold_mod, store_mod, seed):
    """One sequence of tier calls; returns every answer, the stats and the
    write-behind sink."""
    rng = np.random.default_rng(seed)
    sink = store_mod.MockStore()
    c = cold_mod.ColdStore(48, store=sink)
    log = []
    now = NOW
    for _ in range(60):
        op = int(rng.integers(0, 5))
        keys = [f"c{int(i)}".encode()
                for i in rng.choice(120, int(rng.integers(1, 30)),
                                    replace=False)]
        if op <= 1:
            log.append(c.put_columns(keys, cold_columns(rng, len(keys), now),
                                     now))
        elif op == 2:
            log.append(c.take(keys, now))
        elif op == 3:
            log.append(c.expire(now))
        else:
            log.append(c.export_columns(dirty_only=bool(rng.integers(0, 2))))
        log.append(len(c))
        now += int(rng.integers(0, 8_000))
    return plain([log, c.stats(), sink.data, sink.called])


@pytest.mark.parametrize("seed", [81, 82])
def test_coldstore_matches_jax(seed):
    assert tcold.COLD_FIELDS == jcold.COLD_FIELDS
    assert tcold.ZOO_COLD_FIELDS == jcold.ZOO_COLD_FIELDS
    assert cold_ops(tcold, tstore, seed) == cold_ops(jcold, jstore, seed)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cold_exports_load_across_packages(writer):
    rng = np.random.default_rng(83)
    src_mod, dst_mod = (jcold, tcold) if writer == "jax" else (tcold, jcold)
    src = src_mod.ColdStore(64)
    keys = [f"x{i}".encode() for i in range(50)]
    src.put_columns(keys, cold_columns(rng, 50, NOW), NOW)
    # Legacy callers omit the zoo columns: they load as zeros.
    legacy = {f: v for f, v in cold_columns(rng, 5, NOW).items()
              if f not in tcold.ZOO_COLD_FIELDS}
    src.put_columns([f"z{i}".encode() for i in range(5)], legacy, NOW)
    ekeys, ecols = src.export_columns()
    assert len(ekeys) == len(src) > 40
    back = [mod.ColdStore(64) for mod in (src_mod, dst_mod)]
    for c in back:
        c.put_columns(ekeys, ecols, NOW)
    assert plain(back[1].export_columns()) == plain(back[0].export_columns())
    assert plain(back[1].export_columns()) == plain([ekeys, ecols])


def tier_pair(cap=4, max_batch=8, cold=64, store=False):
    js, ts = (jstore.MockStore(), tstore.MockStore()) if store else (None,
                                                                      None)
    return (JaxEngine(capacity=cap, max_batch=max_batch, cold_capacity=cold,
                      store=js),
            TickEngine(capacity=cap, max_batch=max_batch, cold_capacity=cold,
                       store=ts, bg_reclaim=False, device="cpu"),
            js, ts)


def assert_engines_equal(j, t, metrics=TIER_METRICS):
    assert t.cold_size() == j.cold_size()
    assert t.cache_size() == j.cache_size()
    assert t.hot_occupancy() == j.hot_occupancy()
    for m in metrics:
        assert getattr(t, m) == getattr(j, m), m
    assert t.cold.stats() == j.cold.stats()


@pytest.mark.parametrize("variant", ["cold", "cold_store", "small_cold"])
def test_tiered_engine_matches_jax(variant):
    """A working set four times the table churns through the cold tier;
    ``small_cold`` gives the tier 6 entries, so its overflow writes behind
    into the Store (``on_change`` with no request)."""
    j, t, js, ts = tier_pair(cold=6 if variant == "small_cold" else 64,
                             store=variant != "cold")
    rng = np.random.default_rng({"cold": 84, "cold_store": 85,
                                 "small_cold": 86}[variant])
    now = NOW
    try:
        for k in range(40):
            now += STEP * int(rng.integers(0, 2))
            ids = rng.choice(16, int(rng.integers(1, 5)), replace=False)
            jr, tr = request_pair(rng, ids, prefix="t", reset=0.05)
            assert (resp_tuples(t.process(tr, now=now))
                    == resp_tuples(j.process(jr, now=now))), k
            if ts is not None:
                assert ts.called == js.called and ts.data == js.data, k
            assert t.cold_size() == j.cold_size(), k
        assert_engines_equal(j, t)
        assert t.metric_cold_hits > 5 and t.metric_demote_readbacks > 5
        assert t.metric_promote_dispatches == t.metric_promote_ticks
        assert not t._pending
        assert_same_snapshot(t.export_columns(dirty_only=True),
                             j.export_columns(dirty_only=True))
        assert_same_snapshot(t.export_columns(), j.export_columns())
        assert t.last_export_stats.get("cold_items", 0) == t.cold_size()
        if variant == "small_cold":
            assert t.cold.metric_write_behind > 0
    finally:
        j.close()
        t.close()


def test_load_overflow_lands_in_cold_tier_like_jax():
    j, t, _, _ = tier_pair()
    src_j, src_t, _, _ = tier_pair(cap=4, cold=64)
    rng = np.random.default_rng(87)
    for k in range(6):
        jr, tr = request_pair(rng, range(4 * k, 4 * k + 4), prefix="o")
        src_j.process(jr, now=NOW)
        src_t.process(tr, now=NOW)
    snap = src_j.export_columns()
    assert len(snap["key_offsets"]) - 1 == 24
    j.load_columns(snap, now=NOW)
    t.load_columns(snap, now=NOW)
    assert t.cold_size() == j.cold_size() == 20
    assert_same_snapshot(t.export_columns(), j.export_columns())
    jr, tr = request_pair(rng, range(0, 24, 6), prefix="o")
    assert (resp_tuples(t.process(tr, now=NOW + STEP))
            == resp_tuples(j.process(jr, now=NOW + STEP)))
    assert_engines_equal(j, t)


# ----------------------------------------------------------------------
# Background reclaim (the port engine alone)
# ----------------------------------------------------------------------
def req(key, hits=1, limit=10):
    return TReq(name="n", unique_key=key, hits=hits, limit=limit,
                duration=3_600_000)


def test_background_reclaim_keeps_table_under_watermark():
    eng = TickEngine(capacity=512, max_batch=64, bg_reclaim=True,
                     device="cpu")
    try:
        for start in range(0, 2048, 64):
            rs = eng.process([req(f"f{start + i}") for i in range(64)],
                             now=NOW)
            assert all(r.error == "" for r in rs)
        time.sleep(0.2)
        rs = eng.process([req(f"tail{i}") for i in range(64)], now=NOW)
        assert all(r.error == "" for r in rs)
        assert eng.metric_unexpired_evictions > 0
        assert eng.cache_size() <= 512
        assert eng._reclaim_thread is not None
    finally:
        eng.close()
    eng.close()  # idempotent
    assert not eng._reclaim_thread.is_alive()


def test_background_reclaim_no_evictions_without_watermark_pressure():
    # watermark = min(128 // 8, max(2 * 64, 2)) = 16 free slots
    eng = TickEngine(capacity=128, max_batch=64, bg_reclaim=True,
                     device="cpu")
    try:
        fill = [req(f"k{i}", limit=1000) for i in range(100)]
        eng.process(fill[:64], now=NOW)
        eng.process(fill[64:], now=NOW)
        for k in range(5):
            eng.process(fill[:64], now=NOW + k)
        time.sleep(0.2)
        assert eng.metric_unexpired_evictions == 0
        assert eng._reclaim_thread is None
        assert eng.cache_size() == 100
    finally:
        eng.close()


def test_background_reclaim_default_follows_capacity():
    assert TickEngine(capacity=1 << 18, max_batch=8, device="cpu")._bg_reclaim
    assert not TickEngine(capacity=(1 << 18) - 1, max_batch=8,
                          device="cpu")._bg_reclaim


def test_background_reclaim_keeps_every_key_under_concurrent_ticks():
    """A serving thread ticks windows of a working set three times the
    table while the reclaimer demotes into a cold tier that holds it all:
    every answer is the key's exact count, so no key's state was lost
    (an evict before its readback) or shared (two keys on one slot)."""
    info = cs.bg_continuity(None, "cpu", capacity=1024, width=128,
                            working_set=3072, windows=120)
    assert info["bg_rounds"] > 0 and info["evictions"] > 0
    assert info["continuity_errors"] == 0


def test_tier_compare_runs_on_the_cpu(tmp_path):
    """chip_smoke's phase-5 comparison (the card's engine against the
    CPU's) with the CPU on both sides: its windows reach every tier."""
    info = cs.tier_compare(None, "cpu", str(tmp_path), capacity=512,
                           width=256, cold_capacity=256, windows=8,
                           keys=4096)
    assert info["cold_hits"] > 0 and info["ssd_hits"] > 0
    assert info["store_items"] > 0


def test_background_reclaim_revalidates_candidates_touched_after_snap(
        monkeypatch):
    """Phase 1 tests the rows at ``snap``; a window then ticks between the
    victim selection (phase 4) and phase 5, reviving the TTL-dead key and
    re-touching the two LRU keys the round picked.  Phase 5 must free or
    evict none of them: the revived key keeps its new bucket, the
    re-touched keys keep counting; only the round's other victim goes."""
    eng = TickEngine(capacity=64, max_batch=64, bg_reclaim=False,
                     device="cpu")
    short = TReq(name="n", unique_key="short", hits=1, limit=10,
                 duration=1_000)
    eng.process([req("lru0"), req("lru1")], now=NOW)
    eng.process([short], now=NOW + 1)
    eng.process([req(f"k{i}") for i in range(57)], now=NOW + 2)
    # One more tick: the k keys are no longer "this tick" at the snapshot.
    eng.process([req("k0")], now=NOW + 3)
    assert eng.capacity - eng.cache_size() == 4
    # Free slots 4 under the watermark 8: want = min(64 // 16, 16 - 4) = 4:
    # short (dead), then lru0, lru1 and one k key by LRU.
    later = NOW + 5_000  # "short" is dead from here on
    picked, touched = [], []
    orig = E.select_reclaim_victims

    def select_then_tick(*args):
        out = orig(*args)
        picked.append(out)
        touched.append(eng.process([short, req("lru0"), req("lru1")],
                                   now=later))
        return out

    monkeypatch.setattr(E, "select_reclaim_victims", select_then_tick)
    eng._last_now = later
    eng._reclaim_background()
    monkeypatch.undo()
    freed, victims = picked[0]
    keys = eng.slots.keys_batch(np.concatenate([freed, victims]))
    assert sorted(keys[:3]) == [b"n_lru0", b"n_lru1", b"n_short"]
    assert len(freed) == 1 and len(victims) == 3
    assert [r.remaining for r in touched[0]] == [9, 8, 8]
    assert eng.metric_unexpired_evictions == 1
    rs = eng.process([short, req("lru0"), req("lru1")], now=later + 1)
    assert [r.remaining for r in rs] == [8, 7, 7]
    assert eng.cache_size() == 59


def test_background_demote_lands_before_a_window_looks_up_its_keys(
        monkeypatch):
    """The reclaimer releases its victims under the lock and lands their
    readback in the cold tier after it.  A window that asks for a victim
    in between must find its state (the pending demote lands first), not
    a fresh bucket, and the cold tier must not keep a stale copy."""
    eng = TickEngine(capacity=64, max_batch=64, bg_reclaim=False,
                     cold_capacity=256, device="cpu")
    eng.process([req("lru0", hits=3), req("lru1", hits=3)], now=NOW)
    eng.process([req(f"k{i}") for i in range(57)], now=NOW + 1)
    eng.process([req("k0")], now=NOW + 2)
    touched, calls = [], []
    orig = E.run_once

    def run_once_after_a_window(fn):
        once = orig(fn)

        def first():
            calls.append(1)
            if len(calls) == 1:
                touched.append(eng.process([req("lru0"), req("lru1")],
                                           now=NOW + 3))
            once()
        return first

    monkeypatch.setattr(E, "run_once", run_once_after_a_window)
    eng._last_now = NOW + 2
    eng._reclaim_background()
    monkeypatch.undo()
    assert eng.metric_unexpired_evictions == 4
    assert [r.remaining for r in touched[0]] == [6, 6]
    assert eng.metric_cold_hits == 2 and eng.cold_size() == 2
    rs = eng.process([req("lru0", hits=0), req("lru1", hits=0)],
                     now=NOW + 4)
    assert [r.remaining for r in rs] == [6, 6]
