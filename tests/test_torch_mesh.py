"""The port's MeshTickEngine (device="cpu", 4 shards) against the JAX
package's MeshTickEngine on a 4-device CPU mesh.

Both engines see the same ``ReqColumns`` windows at the same ``now``.  The
(5, n) response matrices and the per-item errors must be equal, and so
must every live key's global slot and bucket state and the engines'
counters.  The engines are built once for the module (the JAX one
compiles its programs on first use) and the tests feed them in order:
unique windows, duplicate windows, windows whose keys all route to one
shard, fresh keys that fill shards (reclaim, then shard-full errors),
invalid Gregorian selectors and pipelined submits.

The leaky (duration, limit) pairs come from the exact-quotient pool: the
JAX mesh engine ticks unique windows on the CPU through the parts program
(``tick32``), whose triple-float32 ``remaining_f`` rounds like float64
only there (ROADMAP queue C).
"""

import zlib

import numpy as np
import pytest

import jax

from gubernator_tpu.parallel.mesh_engine import (
    MeshTickEngine as JaxMesh, make_mesh)
from gubernator_tpu_torch.ops.engine import resolve_ticks
from gubernator_tpu_torch.ops.raggedtick import shard_block
from gubernator_tpu_torch.ops.rowtable import host_columns
from gubernator_tpu_torch.parallel import mesh_engine
from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine
from gubernator_tpu_torch.types import Behavior
from tests.test_torch_common import NOW, req_columns

N_SHARDS, LC, MB = 4, 32, 64
STATE_KEYS = ("algorithm", "limit", "remaining", "remaining_f", "duration",
              "created_at", "updated_at", "burst", "status", "expire_at",
              "tat", "prev_count")
GREG = int(Behavior.DURATION_IS_GREGORIAN)
COUNTERS = ("metric_hits", "metric_misses", "metric_over_limit",
            "metric_unexpired_evictions", "metric_routed_windows",
            "metric_routed_overflows", "metric_h2d_windows",
            "metric_h2d_overlapped")


@pytest.fixture(scope="module")
def engines():
    jeng = JaxMesh(mesh=make_mesh(jax.devices()[:N_SHARDS]),
                   local_capacity=LC, max_batch=MB)
    teng = MeshTickEngine(n_shards=N_SHARDS, local_capacity=LC,
                          max_batch=MB, device="cpu")
    return jeng, teng


def jax_state(eng):
    out = {}
    for item in eng.export_items():
        key = item.pop("key").encode()
        d = zlib.crc32(key) % eng.n_shards
        local = int(np.flatnonzero(np.asarray(
            eng.slots[d].keys_batch(np.arange(LC))) == key)[0])
        out[key] = (d * LC + local, item)
    return out


def port_state(eng):
    out = {}
    for d in range(eng.n_shards):
        cols = host_columns(shard_block(eng.table, d, LC))
        mapped = np.flatnonzero(eng.slots[d].mapped_mask())
        live = mapped[cols["in_use"][mapped]]
        for key, s in zip(eng.slots[d].keys_batch(live), live):
            out[key] = (d * LC + int(s), {
                f: int(cols[f][s]) if f != "remaining_f"
                else float(cols[f][s]) for f in STATE_KEYS})
    return out


def assert_same(jeng, teng):
    assert port_state(teng) == jax_state(jeng)
    for c in COUNTERS:
        assert getattr(teng, c) == getattr(jeng, c), c
    assert teng.metric_routed_overflows == 0


def keys_on(shards, count, prefix="m"):
    """``count`` keys whose CRC-32 route lands in ``shards``."""
    out, i = [], 0
    while len(out) < count:
        k = f"{prefix}{i}".encode()
        if zlib.crc32(b"mesh_" + k) % N_SHARDS in shards:
            out.append(k)
        i += 1
    return out


def window(rng, keys, now, bad_greg=0.0):
    """Matching JAX and port columns over ``keys`` at ``now``: random
    requests over all five algorithms, half server-stamped, some
    Gregorian, a share with an invalid Gregorian selector."""
    n = len(keys)
    jc, tc = req_columns(rng, n, [b"mesh_" + k for k in keys])
    created = np.where(rng.random(n) < 0.5, -1,
                       now - rng.choice([0, 0, 500, 3_000], n))
    bad = rng.random(n) < bad_greg
    for c in (jc, tc):
        c.created_at[:] = created
        c.behavior[bad] |= GREG
        c.duration[bad] = 9
    return jc, tc


def run(jeng, teng, wins):
    """Feed every window to both engines; returns the per-item errors."""
    errors = {}
    for k, (jc, tc, now) in enumerate(wins):
        want, werr = jeng.process_columns(jc, now)
        got, gerr = teng.process_columns(tc, now)
        assert gerr == werr, k
        np.testing.assert_array_equal(got, want, err_msg=f"window {k}")
        errors.update(gerr)
    assert_same(jeng, teng)
    return errors


def test_unique_windows_match_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(51)
    pool = keys_on(range(N_SHARDS), 90)
    now, wins = NOW, []
    for _ in range(4):
        now += int(rng.integers(0, 4_000))
        ids = rng.choice(len(pool), 50, replace=False)
        wins.append((*window(rng, [pool[i] for i in ids], now), now))
    run(jeng, teng, wins)
    assert teng.metric_rank_rounds == 0


def test_duplicate_windows_match_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(52)
    pool = keys_on(range(N_SHARDS), 90)
    now, wins = NOW + 20_000, []
    for k in range(4):
        now += int(rng.integers(0, 3_000))
        ids = rng.integers(0, 6 if k % 2 else 30, MB)
        jc, tc = window(rng, [pool[i] for i in ids], now)
        if k >= 2:   # herds: every request of a key is its first one
            first = {int(i): j for j, i in reversed(list(enumerate(ids)))}
            src = np.array([first[int(i)] for i in ids])
            for c in (jc, tc):
                for f in ("hits", "limit", "duration", "algorithm",
                          "behavior", "created_at", "burst"):
                    getattr(c, f)[:] = getattr(c, f)[src]
        wins.append((jc, tc, now))
    rounds = teng.metric_rank_rounds
    run(jeng, teng, wins)
    assert teng.metric_rank_rounds > rounds


def test_skewed_windows_match_jax(engines):
    """Every key on shard 2: one extent covers the batch, unique and with
    repeats."""
    jeng, teng = engines
    rng = np.random.default_rng(53)
    pool = keys_on({2}, 30, prefix="s")
    now = NOW + 40_000
    wins = [(*window(rng, pool, now), now),
            (*window(rng, [pool[i] for i in rng.integers(0, 12, 40)],
                     now + 1), now + 1)]
    run(jeng, teng, wins)


def test_reclaim_and_shard_full_errors_match_jax(engines):
    """Fresh keys overflow shard 1: the first window reclaims (LRU
    evictions, expired slots), the second asks for more new slots than the
    shard holds in one window, so some keys answer the shard-full error."""
    jeng, teng = engines
    rng = np.random.default_rng(54)
    now = NOW + 100_000
    fresh = keys_on({1}, 90, prefix="f")
    wins = [(*window(rng, fresh[:30], now), now),
            (*window(rng, fresh[30:70], now + 10), now + 10),
            (*window(rng, keys_on(range(N_SHARDS), 60, prefix="g"), now + 20),
             now + 20)]
    evicted = teng.metric_unexpired_evictions
    errors = run(jeng, teng, wins)
    assert teng.metric_unexpired_evictions > evicted
    assert "rate-limit shard full; eviction failed" in errors.values()


def test_gregorian_errors_match_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(55)
    pool = keys_on(range(N_SHARDS), 40, prefix="c")
    now = NOW + 200_000
    jc, tc = window(rng, pool, now, bad_greg=0.3)
    want, werr = jeng.process_columns(jc, now)
    got, gerr = teng.process_columns(tc, now)
    assert werr and gerr == werr
    np.testing.assert_array_equal(got, want)
    assert_same(jeng, teng)


def test_pipelined_submits_match_jax(engines):
    """Four windows submitted before any is resolved, then resolved
    together: the uploads count as overlapped, the answers are those of
    one window at a time."""
    jeng, teng = engines
    rng = np.random.default_rng(56)
    pool = keys_on(range(N_SHARDS), 80, prefix="p")
    now = NOW + 300_000
    wins = [window(rng, [pool[i] for i in rng.integers(0, 80, 40)], now + k)
            for k in range(4)]
    jh = [jeng.submit_columns(jc, now + k) for k, (jc, _) in enumerate(wins)]
    th = [teng.submit_columns(tc, now + k) for k, (_, tc) in enumerate(wins)]
    resolve_ticks(th)
    for j, t in zip(jh, th):
        want, werr = j.result()
        got, gerr = t.result()
        assert gerr == werr
        np.testing.assert_array_equal(got, want)
    assert teng.metric_h2d_overlapped >= 3
    assert_same(jeng, teng)


def test_constructor_contract():
    store = object()
    assert MeshTickEngine(n_shards=2, local_capacity=8, device="cpu",
                          store=store).store is store
    with pytest.raises(ValueError, match="int32"):
        MeshTickEngine(n_shards=4, local_capacity=1 << 29, device="cpu")
    with pytest.raises(ValueError, match="routing"):
        MeshTickEngine(n_shards=2, local_capacity=8, device="cpu",
                       routing="host")
    with pytest.warns(DeprecationWarning):
        mesh_engine._LOCAL_WIDTH_WARNED = False
        MeshTickEngine(n_shards=2, local_capacity=8, device="cpu",
                       local_width=64)
