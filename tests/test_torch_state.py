"""The port's TickEngine state movement against the JAX package's.

Both engines (``capacity=256, max_batch=64``, the JAX one on the columns
layout: the shapes of tests/test_torch_engine.py) see the same windows,
installs and lease windows at the same ``now``.  Snapshots must agree key
by key in every column, with the same column keys and dtypes: full
exports, ``dirty_only`` deltas after query-only and mutating windows, a
snapshot of either package loaded into the other, item dicts, GLOBAL
installs (token and leaky, a repeated key), lease windows (set and delta,
keys that are not resident), expired rows dropped at load, and a
snapshot written before the zoo and lease columns.  The schema helpers
are held against the reference's on the same snapshots.
"""

import numpy as np
import pytest

from gubernator_tpu.ops import engine as jeng
from gubernator_tpu.types import GlobalUpdate as JGlobalUpdate
from gubernator_tpu.types import RateLimitResponse as JResponse
from gubernator_tpu_torch.ops import snapshot as tsnap
from gubernator_tpu_torch.ops.rowtable import host_columns
from gubernator_tpu_torch.types import GlobalUpdate, RateLimitResponse
from tests.test_torch_common import NOW
from tests.test_torch_engine import engines, keyset, window

ALL_FIELDS = tsnap.SNAP_FIELDS + tsnap.ZOO_SNAP_FIELDS + tsnap.LEASE_SNAP_FIELDS


def by_key(snap):
    """Snapshot → {key: (every column's value)}, after checking that its
    columns line up with its keys."""
    off = snap["key_offsets"]
    blob = bytes(snap["key_blob"])
    keys = [blob[off[i]:off[i + 1]] for i in range(len(off) - 1)]
    assert len(set(keys)) == len(keys)
    cols = [f for f in ALL_FIELDS if f in snap]
    return {k: tuple(snap[f][i].item() for f in cols)
            for i, k in enumerate(keys)}


def assert_same_snapshot(got, want):
    assert got.keys() == want.keys()
    for f in want:
        assert np.asarray(got[f]).dtype == np.asarray(want[f]).dtype, f
    assert by_key(got) == by_key(want)


def run(jeng_, teng_, windows):
    for jc, tc, now in windows:
        want, werr = jeng_.submit_cols(jc, now).matrix()
        got, gerr = teng_.submit_cols(tc, now).matrix()
        assert gerr == werr
        np.testing.assert_array_equal(got, want)


def warm(seed, n_keys=40, windows=3):
    """Both engines after ``windows`` random windows over ``n_keys`` keys
    (repeats included); returns ``(jax, port, rng, now)``."""
    j, t = engines(256)
    rng = np.random.default_rng(seed)
    now = NOW
    wins = []
    for _ in range(windows):
        now += int(rng.integers(0, 3_000))
        wins.append(window(rng, rng.integers(0, n_keys, 64), now,
                           created_unset=1.0))
    run(j, t, wins)
    return j, t, rng, now


def test_exports_match_and_load_into_the_other_package():
    j, t, rng, now = warm(61)
    js, ts = j.export_columns(), t.export_columns()
    assert_same_snapshot(ts, js)
    assert t.cache_size() == j.cache_size() > 30
    assert t.last_export_stats["items"] == len(by_key(js)) > 0
    assert t.last_export_stats["rows"] == t.cache_size()
    assert t.last_export_stats["d2h_bytes"] > t.cache_size() * 128

    # A JAX snapshot into a fresh port engine and the port's into a fresh
    # JAX engine: both hold the rows that had not expired by the load.
    j2, t2 = engines(256)
    t2.load_columns(js, now)
    j2.load_columns(ts, now)
    loaded = t2.export_columns()
    assert_same_snapshot(loaded, j2.export_columns())
    live = js["expire_at"] >= now
    assert 0 < live.sum() < len(live)
    # Each loaded row uploads its slot (8 B), its row (128 B), and its
    # slot again with its three lease columns as int64 (8 + 24 B).
    assert t2.last_load_stats == {"rows": live.sum(),
                                  "h2d_bytes": live.sum() * 168}
    assert by_key(loaded) == {k: v for (k, v), keep in zip(
        by_key(js).items(), live) if keep}
    # Then both serve the same next window from the loaded state.
    run(j2, t2, [window(rng, rng.integers(0, 40, 64), now + 500,
                        created_unset=1.0)])
    assert_same_snapshot(t2.export_columns(), j2.export_columns())


def test_dirty_deltas_match_jax():
    j, t, rng, now = warm(62)
    j.export_columns()
    t.export_columns()
    # A query-only window of known keys: nothing is dirty.
    known = [int(k[3:]) for k in by_key(t.export_columns())]
    jc, tc, _ = window(rng, rng.choice(known, 64), now + 100,
                       created_unset=1.0, behavior=0)
    for c in (jc, tc):
        c.hits[:] = 0
    run(j, t, [(jc, tc, now + 100)])
    jd, td = j.export_columns(dirty_only=True), t.export_columns(
        dirty_only=True)
    assert_same_snapshot(td, jd)
    assert len(td["key_offsets"]) == 1 and td["key_blob"] == b""
    assert t.last_export_stats == {"rows": 0, "d2h_bytes": 0, "items": 0,
                                   "partial": True}
    # A mutating window over a few keys, some new.
    run(j, t, [window(rng, rng.integers(30, 50, 16), now + 200,
                      created_unset=1.0)])
    jd, td = j.export_columns(dirty_only=True), t.export_columns(
        dirty_only=True)
    assert_same_snapshot(td, jd)
    assert 0 < len(by_key(td)) <= 16
    assert_same_snapshot(t.export_columns(dirty_only=True),
                         j.export_columns(dirty_only=True))


def test_install_globals_matches_jax():
    j, t, rng, now = warm(63)
    ups = [(f"t_k{i}" if i < 6 else f"g{i}", i % 2, 60_000 + i,
            (i % 2, 10 + i, i - 1, now + 1_000 * i)) for i in range(12)]
    ups.append(("t_k3", 1, 30_000, (1, 7, 5, now + 77)))   # repeat: last wins
    j.install_globals([JGlobalUpdate(key=k, algorithm=a, duration=d,
                                     status=JResponse(status=s, limit=lim,
                                                      remaining=r,
                                                      reset_time=rt))
                       for k, a, d, (s, lim, r, rt) in ups], now + 10)
    t.install_globals([GlobalUpdate(key=k, algorithm=a, duration=d,
                                    status=RateLimitResponse(
                                        status=s, limit=lim, remaining=r,
                                        reset_time=rt))
                       for k, a, d, (s, lim, r, rt) in ups], now + 10)
    assert (t.metric_hits, t.metric_misses) == (j.metric_hits,
                                                j.metric_misses)
    assert_same_snapshot(t.export_columns(dirty_only=True),
                         j.export_columns(dirty_only=True))
    assert t.cache_size() == j.cache_size()
    # The installed keys serve alike.
    keys = [f"t_k{i}".encode() for i in range(6)] + [
        f"g{i}".encode() for i in range(6, 12)]
    jc, tc, _ = window(rng, np.zeros(12, np.int64), now + 20,
                       created_unset=1.0)
    from gubernator_tpu_torch.ops.reqcols import pack_blob

    for c in (jc, tc):
        c.key_blob, c.key_offsets = pack_blob(keys)
    run(j, t, [(jc, tc, now + 20)])
    assert_same_snapshot(t.export_columns(), j.export_columns())


def test_lease_windows_match_jax():
    j, t, rng, now = warm(64)
    keys = keyset(range(45))   # keys 40-44 are not resident
    for is_set, sel, bud, gen in (
            (True, np.arange(0, 45, 2), 5, 3),
            (False, rng.integers(0, 45, 30), -2, 2),   # repeats add up
            (False, rng.integers(0, 45, 30), 4, 7)):
        ks = [keys[i] for i in sel]
        b = (np.arange(len(ks)) % 7 + bud).tolist()
        e = (now + 100 * np.arange(len(ks))).tolist()
        g = [gen + i % 3 for i in range(len(ks))]
        assert t.lease_window(ks, b, e, g, is_set=is_set) == \
            j.lease_window(ks, b, e, g, is_set=is_set)
        for got, want in zip(t.lease_columns(keys), j.lease_columns(keys)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert (t.metric_lease_dispatches, t.metric_lease_windows,
            t.metric_lease_ops) == (j.metric_lease_dispatches,
                                    j.metric_lease_windows,
                                    j.metric_lease_ops)
    assert_same_snapshot(t.export_columns(dirty_only=True),
                         j.export_columns(dirty_only=True))
    # The lease columns survive a load (of every row: the load's now is
    # before any expiry).
    snap = t.export_columns()
    _, t2 = engines(256)
    t2.load_columns(snap, NOW - 10**6)
    for got, want in zip(t2.lease_columns(keys), j.lease_columns(keys)):
        np.testing.assert_array_equal(got, want)


def test_interleaved_lease_columns_match_jax():
    """The lanes ``pack_lanes`` makes from a window's keys, applied by
    ``lease_apply_plain`` to ``lease_records`` (the three columns as views
    of one 32-B record a slot, the layout B.9 takes on the card), against
    the JAX engine's ``lease_window`` on the same keys: each key's budget,
    expiry and generation equal after every window, every record's
    padding 0.  The windows are test_lease_windows_match_jax's shapes."""
    import torch

    from gubernator_tpu_torch.ops import leasecols as LC
    from gubernator_tpu_torch.ops.reqcols import pack_blob

    j, t, rng, now = warm(64)
    keys = keyset(range(45))   # keys 40-44 are not resident
    cols = LC.lease_records(t.capacity, "cpu")
    records = cols[0]._base
    negative: set = set()
    for is_set, sel, bud, gen in (
            (True, np.arange(0, 45, 2), 5, 3),
            (False, rng.integers(0, 45, 30), -2, 2),
            (False, rng.integers(0, 45, 30), 4, 7)):
        ks = [keys[i] for i in sel]
        b = np.arange(len(ks)) % 7 + bud
        e = now + 100 * np.arange(len(ks))
        g = np.asarray([gen + i % 3 for i in range(len(ks))])
        j.lease_window(ks, b.tolist(), e.tolist(), g.tolist(), is_set=is_set)
        slots = t.slots.lookup_blob(*pack_blob(ks))
        live = slots >= 0
        lanes = LC.pack_lanes(slots[live], b[live], e[live], g[live], is_set,
                              sorted(negative))
        LC.lease_apply_plain(*cols, torch.from_numpy(lanes), is_set)
        if is_set:
            negative |= set(lanes[LC.SLOT][lanes[LC.BUDGET] < 0].tolist())
        else:
            negative.clear()
        at = torch.from_numpy(t.slots.lookup_blob(*pack_blob(keys)))
        res = at >= 0
        for got, want in zip(cols, j.lease_columns(keys)):
            out = np.zeros(len(keys), want.dtype)
            out[res.numpy()] = got[at[res]].numpy()
            np.testing.assert_array_equal(out, want)
        assert not records[:, 3].any()
        assert not records.view(torch.int32)[:, 5].any()


def test_lease_delta_clamps_every_negative_budget_like_jax():
    """The reference clamps the whole budget column after a delta window;
    B.9 clamps the lanes' slots, with the engine adding a zero lane for
    every slot a set window or a load left negative.  Windows of 17-32
    lanes: the JAX program shape test_lease_windows_match_jax builds."""
    j, t, rng, now = warm(67)
    keys = keyset(range(45))
    a, rest = keys[0], keys[1:]
    for eng in (j, t):
        # Key A set to -5; then a delta window (repeats) without A.
        eng.lease_window([a] + rest[:19], [-5] + [7] * 19, [now] * 20,
                         [1] * 20)
        eng.lease_window(rest[10:30] + rest[10:12], [3, -9] * 11,
                         [now + 1] * 22, [2, 0] * 11, is_set=False)
    for got, want in zip(t.lease_columns(keys), j.lease_columns(keys)):
        np.testing.assert_array_equal(got, want)
    assert t.lease_columns([a])[0].tolist() == [0]
    # A negative budget loaded from a snapshot is clamped by the next
    # delta window too, in both packages.
    snap = t.export_columns()
    snap["lease_budget"] = np.where(
        np.arange(len(snap["lease_budget"])) % 3 == 0, -4,
        snap["lease_budget"])
    j2, t2 = engines(256)
    for eng in (j2, t2):
        eng.load_columns(snap, NOW - 10**6)
    assert t2._lease_negative
    for got, want in zip(t2.lease_columns(keys), j2.lease_columns(keys)):
        np.testing.assert_array_equal(got, want)
    for eng in (j2, t2):
        eng.lease_window(rest[20:40], [1] * 20, [now] * 20, [1] * 20,
                         is_set=False)
    for got, want in zip(t2.lease_columns(keys), j2.lease_columns(keys)):
        np.testing.assert_array_equal(got, want)
    assert (t2.lease_columns(keys)[0] >= 0).all()
    assert t2._lease_negative == set()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_lanes_equal_the_eager_window(seed):
    """B.9's host packing and its plain version on the packed lanes equal
    the eager window on the raw lanes (repeats unmerged, the whole budget
    column clamped), with negative slots outside the window."""
    import torch

    from gubernator_tpu_torch.ops import leasecols as LC

    rng = np.random.default_rng(seed)
    cap, n = 512, 300
    neg = rng.choice(cap, 7, replace=False)
    budget = rng.integers(0, 50, cap + 1)
    budget[neg] = -3
    budget[cap] = 0
    cols = [torch.from_numpy(budget),
            torch.from_numpy(rng.integers(0, 10**6, cap + 1)),
            torch.from_numpy(rng.integers(0, 99, cap + 1).astype(np.int32))]
    for c in cols:
        c[cap] = 0
    slots = rng.integers(0, cap, n)
    raw = (slots, rng.integers(-20, 20, n), rng.integers(0, 10**6, n),
           rng.integers(-2**33, 2**33, n))
    for is_set in (True, False):
        lanes = LC.pack_lanes(*raw, is_set, () if is_set else neg)
        assert len(np.unique(lanes[LC.SLOT])) == lanes.shape[1]
        k = [c.clone() for c in cols]
        e = [c.clone() for c in cols]
        LC.lease_apply(*k, torch.from_numpy(lanes), is_set)
        if is_set:
            # The last lane of a repeated slot wins.
            last = {s: j for j, s in enumerate(slots)}
            for s, j in last.items():
                e[0][s] = int(raw[1][j])
                e[1][s] = int(raw[2][j])
                e[2][s] = int(np.int64(raw[3][j]).astype(np.int32))
        else:
            unpacked = np.stack([raw[0], raw[1], raw[2], np.asarray(
                raw[3]).astype(np.int32).astype(np.int64)])
            LC.lease_apply_plain(*e, torch.from_numpy(unpacked), False)
        for x, y in zip(k, e):
            assert torch.equal(x, y)


def test_items_and_old_snapshots_load_like_jax():
    j, t, rng, now = warm(65)
    items = t.export_items()
    assert items == j.export_items()
    # Some rows expired by the load's now, and a snapshot without the zoo
    # and lease columns: expired rows drop, absent columns read as zeros.
    snap = t.export_columns()
    later = int(np.median(snap["expire_at"])) + 1
    old = {k: v for k, v in snap.items()
           if k not in tsnap.ZOO_SNAP_FIELDS + tsnap.LEASE_SNAP_FIELDS}
    for load in (lambda e: e.load_items(items, later),
                 lambda e: e.load_columns(old, later)):
        j2, t2 = engines(256)
        load(j2)
        load(t2)
        js = j2.export_columns()
        assert_same_snapshot(t2.export_columns(), js)
        assert 0 < len(by_key(js)) < len(items)
        assert (js["expire_at"] >= later).all()


@pytest.mark.parametrize("seed", [66])
def test_snapshot_helpers_match_jax(seed):
    j, t, _, _ = warm(seed)
    snap = t.export_columns()
    items = tsnap.items_from_snapshot(snap)
    assert items == jeng.items_from_snapshot(snap)
    assert tsnap.items_from_snapshot(tsnap.snapshot_from_items(items)) == \
        items
    for f, col in tsnap.snapshot_from_items(items).items():
        want = jeng.snapshot_from_items(items)[f]
        assert np.asarray(col).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(col, want)
    mapped = np.flatnonzero(t.slots.mapped_mask())
    keys = t.slots.keys_batch(mapped)
    got = tsnap.items_from_columns(keys, host_columns(t.table), mapped)
    want = {it["key"]: it for it in jeng.items_from_columns(
        j.slots.keys_batch(mapped), j.state, mapped)}
    assert {it["key"]: it for it in got} == want
    assert (tsnap.SNAP_FIELDS, tsnap.LEASE_SNAP_FIELDS,
            tsnap.ZOO_SNAP_FIELDS) == (jeng.SNAP_FIELDS,
                                       jeng.LEASE_SNAP_FIELDS,
                                       jeng.ZOO_SNAP_FIELDS)
