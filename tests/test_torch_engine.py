"""The port's TickEngine (device="cpu") against the JAX package's
TickEngine(table_layout="columns") on identical request windows.

Both engines see the same ``ReqColumns`` windows at the same ``now``.  The
(5, n) response matrices from ``SubmittedBatch.matrix()`` and the per-item
errors must be equal, and so must the per-key bucket state afterwards
(JAX side through ``export_columns()``, port side through its slot map
and the table's logical columns).  The leaky (duration, limit) pairs come
from the exact-quotient pool: the JAX tick programs keep ``remaining_f``
as a triple of float32 and round like float64 only there.
"""

import numpy as np
import pytest

from gubernator_tpu.ops.engine import TickEngine as JaxEngine
from gubernator_tpu.types import RateLimitRequest as JaxRequest
from gubernator_tpu_torch.ops.engine import SlotMap, TickEngine, resolve_ticks
from gubernator_tpu_torch.ops.rowtable import host_columns
from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitRequest
from tests.test_torch_common import NOW, req_columns

STATE_KEYS = ("algorithm", "limit", "remaining", "remaining_f", "duration",
              "created_at", "updated_at", "burst", "status", "expire_at",
              "tat", "prev_count")
GREG = int(Behavior.DURATION_IS_GREGORIAN)


def engines(capacity, max_batch=64):
    return (JaxEngine(capacity=capacity, max_batch=max_batch,
                      table_layout="columns"),
            TickEngine(capacity=capacity, max_batch=max_batch, device="cpu"))


def jax_state(eng):
    snap = eng.export_columns()
    off = snap["key_offsets"]
    keys = [bytes(snap["key_blob"][off[i]:off[i + 1]])
            for i in range(len(off) - 1)]
    return {k: {f: int(snap[f][i]) if f != "remaining_f"
                else float(snap[f][i]) for f in STATE_KEYS}
            for i, k in enumerate(keys)}


def port_state(eng):
    cols = host_columns(eng.table)
    mapped = np.flatnonzero(eng.slots.mapped_mask())
    live = mapped[cols["in_use"][mapped]]
    keys = eng.slots.keys_batch(live)
    return {k: {f: int(cols[f][s]) if f != "remaining_f"
                else float(cols[f][s]) for f in STATE_KEYS}
            for k, s in zip(keys, live)}


def run_windows(jeng, teng, windows):
    """Feed every (jax_cols, port_cols, now) window to both engines and
    hold responses, errors and per-key state equal."""
    for k, (jcols, tcols, now) in enumerate(windows):
        want, werr = jeng.submit_cols(jcols, now).matrix()
        got, gerr = teng.submit_cols(tcols, now).matrix()
        assert gerr == werr, k
        np.testing.assert_array_equal(got, want, err_msg=f"window {k}")
    js, ts = jax_state(jeng), port_state(teng)
    assert ts.keys() == js.keys()
    for key in js:
        assert ts[key] == js[key], key


def keyset(ids):
    return [f"t_k{int(i)}".encode() for i in ids]


def window(rng, ids, now, created_unset=0.5, greg=0.0, bad_greg=0.0,
           behavior=None):
    """One window over keys ``ids`` at ``now``: random requests over all
    five algorithms, a share of them server-stamped (CREATED_UNSET),
    Gregorian or carrying an invalid Gregorian selector."""
    n = len(ids)
    jc, tc = req_columns(rng, n, keyset(ids))
    offs = rng.choice([0, 0, 0, 500, 3_000, -500], n)
    unset = rng.random(n) < created_unset
    pick = rng.random(n)
    g = pick < greg
    bad = (pick >= greg) & (pick < greg + bad_greg)
    for c in (jc, tc):
        c.created_at[:] = np.where(unset, -1, now - offs)
        c.behavior &= ~GREG
        if behavior is not None:
            c.behavior[:] = behavior
        c.behavior[g | bad] |= GREG
    dur = np.where(g, rng.integers(0, 6, n), np.where(bad, 9, jc.duration))
    jc.duration[:] = dur
    tc.duration[:] = dur
    return jc, tc, now


def test_unique_windows_match_jax():
    jeng, teng = engines(256)
    rng = np.random.default_rng(31)
    wins = []
    now = NOW
    for _ in range(6):
        now += int(rng.integers(0, 4_000))
        # 100 distinct keys: two chunked ticks at max_batch 64.
        wins.append(window(rng, rng.choice(160, 100, replace=False), now))
    run_windows(jeng, teng, wins)
    assert teng.metric_rank_rounds == 0


def test_duplicate_windows_match_jax():
    jeng, teng = engines(256)
    rng = np.random.default_rng(32)
    wins = []
    now = NOW
    for k in range(6):
        now += int(rng.integers(0, 3_000))
        pool = 6 if k % 2 else 24
        ids = rng.integers(0, pool, 64)
        wins.append(window(rng, ids, now))
    run_windows(jeng, teng, wins)
    assert teng.metric_rank_rounds > 6


@pytest.mark.parametrize("behavior", [
    int(Behavior.RESET_REMAINING), int(Behavior.DRAIN_OVER_LIMIT),
    int(Behavior.RESET_REMAINING | Behavior.DRAIN_OVER_LIMIT)])
def test_reset_and_drain_windows_match_jax(behavior):
    jeng, teng = engines(128)
    rng = np.random.default_rng(33 + behavior)
    now = NOW
    wins = [window(rng, rng.integers(0, 40, 64), now)]
    for _ in range(4):
        now += int(rng.integers(0, 2_000))
        wins.append(window(rng, rng.integers(0, 40, 64), now,
                           behavior=behavior))
        wins.append(window(rng, rng.integers(0, 40, 64), now))
    run_windows(jeng, teng, wins)


def test_gregorian_windows_match_jax():
    jeng, teng = engines(128)
    rng = np.random.default_rng(34)
    now = NOW
    wins = []
    for _ in range(5):
        now += int(rng.integers(0, 90_000))
        wins.append(window(rng, rng.integers(0, 30, 64), now, greg=0.6))
    run_windows(jeng, teng, wins)


def test_per_item_errors_match_jax():
    jeng, teng = engines(128)
    rng = np.random.default_rng(35)
    now = NOW
    wins = []
    for k in range(4):
        now += 1_000
        ids = rng.integers(0, 30, 64) if k % 2 else rng.choice(30, 30, replace=False)
        wins.append(window(rng, ids, now, greg=0.2, bad_greg=0.25))
    # A window of nothing but errors.
    wins.append(window(rng, np.arange(8), now + 1, bad_greg=1.0))
    run_windows(jeng, teng, wins)


def test_filling_table_reclaims_like_jax():
    """Capacity 64 under a 200-key stream: TTL-dead slots free first,
    then LRU victims are evicted on the device (row_evict)."""
    jeng, teng = engines(64)
    rng = np.random.default_rng(36)
    now = NOW
    wins = []
    for k in range(10):
        now += int(rng.integers(500, 6_000))
        n = 48 if k % 3 else 20
        wins.append(window(rng, rng.choice(200, n, replace=False), now))
    run_windows(jeng, teng, wins)
    assert teng.metric_unexpired_evictions == jeng.metric_unexpired_evictions > 0
    assert teng.metric_shed_requests == jeng.metric_shed_requests


def test_process_and_pipelined_submits_match_jax():
    """The README's object API, and unresolved handles resolved together."""
    jeng, teng = engines(128)
    reqs = [dict(name="api", unique_key=f"u{i % 5}", hits=1 + i % 3, limit=7,
                 duration=60_000, algorithm=i % 5, created_at=NOW + i)
            for i in range(23)]
    want = jeng.process([JaxRequest(**r) for r in reqs], now=NOW)
    got = teng.process([RateLimitRequest(**r) for r in reqs], now=NOW)
    assert [(r.status, r.limit, r.remaining, r.reset_time, r.error)
            for r in got] == [(r.status, r.limit, r.remaining, r.reset_time,
                               r.error) for r in want]

    rng = np.random.default_rng(37)
    wins = [window(rng, rng.choice(100, 50, replace=False), NOW + 10 * k)
            for k in range(4)]
    handles = [teng.submit_columns(tc, now) for _, tc, now in wins]
    resolve_ticks(handles)
    for (jc, _, now), h in zip(wins, handles):
        want, werr = jeng.submit_cols(jc, now).matrix()
        got, gerr = h.result()
        assert gerr == werr
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("option", ["store", "cold_capacity", "ssd",
                                    "bg_reclaim"])
def test_tier_options_build_engines_that_serve(tmp_path, option):
    """Each of the tier options builds an engine that serves: a table of 16
    slots takes 40 keys over three windows (the third reclaims) and a
    query of the first, evicted key answers from its tier."""
    from gubernator_tpu_torch.store import MockStore
    from gubernator_tpu_torch.tiering import SsdStore

    kw = {"store": dict(store=MockStore()),
          "cold_capacity": dict(cold_capacity=64),
          "ssd": dict(cold_capacity=4,
                      ssd=SsdStore(str(tmp_path / "ssd"))),
          "bg_reclaim": dict(bg_reclaim=True)}[option]
    eng = TickEngine(capacity=16, max_batch=16, device="cpu", **kw)
    try:
        for w in range(3):
            rs = eng.process([RateLimitRequest(
                name="o", unique_key=f"k{w * 16 + i}", hits=2, limit=5,
                duration=60_000) for i in range(16 if w < 2 else 8)],
                now=NOW + w)
            assert all(r.error == "" and r.remaining == 3 for r in rs)
        assert eng.metric_unexpired_evictions > 0
        q = eng.process([RateLimitRequest(name="o", unique_key="k0", hits=0,
                                          limit=5, duration=60_000)],
                        now=NOW + 3)[0]
        # The tiers keep k0's two hits; without one it starts afresh (a
        # Store is told to remove an evicted key).
        tiered = option in ("cold_capacity", "ssd")
        assert q.remaining == (3 if tiered else 5)
        if option == "store":
            assert eng.store.called["Get()"] >= 40
            assert eng.store.called["Remove()"] > 0
        if option == "ssd":
            eng.ssd.flush()
            assert eng.ssd.metric_demotions > 0
    finally:
        eng.close()


def test_python_slot_map_engine_matches_native():
    rng = np.random.default_rng(38)
    a = TickEngine(capacity=64, max_batch=64, device="cpu")
    b = TickEngine(capacity=64, max_batch=64, device="cpu")
    b.slots = SlotMap(64)
    for k in range(5):
        _, tc, now = window(rng, rng.choice(120, 40, replace=False),
                            NOW + 2_000 * k)
        ga, ea = a.process_columns(tc, now)
        gb, eb = b.process_columns(tc, now)
        assert ea == eb
        np.testing.assert_array_equal(ga, gb)
    assert port_state(a) == port_state(b)
    assert int(Algorithm.CONCURRENCY) == 4
    # The state methods run on either map: lookups, assignment, key blobs.
    snap = a.export_columns()
    for e in (a, b):
        e.lease_window(keyset([1, 2, 500]), [4, 5, 6], [NOW] * 3, [1] * 3)
        e.load_columns(snap, NOW)
    sa, sb = a.export_columns(), b.export_columns()
    assert bytes(sa["key_blob"]) == bytes(sb["key_blob"])
    for f in sa:
        np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
