"""The port's SSD slab tier and its three-tier TickEngine against the JAX
package's.

* ``SsdStore``: both packages' stores, each in its own directory, take the
  same puts (expired rows, overwrites of staged and written keys), takes,
  peeks, removals, slab rolls, compactions and capacity evictions (each
  put flushed, so the writer threads' work is in one order); every answer
  and every ``stats()`` count must be equal.  A slab directory written by
  either package reopens in both (rebuild) with the same contents.
* The engines (``capacity=2, max_batch=8, cold_capacity=2`` and
  ``capacity=4, max_batch=16, cold_capacity=4``, the shapes of
  tests/test_ssd.py) churn through hot, cold and SSD tiers: responses,
  ``export_columns``, the tier counters (one ``take_batch`` a window, no
  SSD read on the tick path) and the SSD counts must be equal.  Engines
  of both packages started on a copy of one slab directory promote the
  same rows.
"""

import shutil

import numpy as np
import pytest

from chip_smoke import SSD_COUNTS
from gubernator_tpu.ops.engine import TickEngine as JaxEngine
from gubernator_tpu.tiering import ssd as jssd
from gubernator_tpu_torch.ops.engine import TickEngine
from gubernator_tpu_torch.tiering import ssd as tssd
from tests.test_torch_common import NOW
from tests.test_torch_state import assert_same_snapshot
from tests.test_torch_store import STEP, request_pair, resp_tuples
from tests.test_torch_tiering import TIER_METRICS, cold_columns, plain

SSD_METRICS = TIER_METRICS + (
    "metric_ssd_hits", "metric_ssd_lookups", "metric_ssd_miss_ticks",
    "metric_ssd_tick_path_reads")


def ssd_ops(mod, directory, seed):
    """One sequence of calls on a small store (slabs of 4 KB, a 24 KB
    budget); every put is flushed before the next call."""
    rng = np.random.default_rng(seed)
    s = mod.SsdStore(directory, capacity_bytes=24 << 10, slab_bytes=4096,
                     queue_depth=2)
    log = []
    now = NOW
    try:
        for _ in range(50):
            op = int(rng.integers(0, 5))
            keys = [f"s{int(i)}".encode()
                    for i in rng.choice(80, int(rng.integers(1, 12)),
                                        replace=False)]
            if op <= 1:
                log.append(s.put_columns(keys, cold_columns(rng, len(keys),
                                                            now), now))
                s.flush()
            elif op == 2:
                log.append(s.take_batch(keys, now))
            elif op == 3:
                s.remove_batch([k.decode() for k in keys])
            else:
                log.append([s.get(_Key(k)) for k in keys])
            log.append(len(s))
            now += int(rng.integers(0, 6_000))
        log.append(s.stats())
    finally:
        s.close()
    return plain(log)


class _Key:
    """The Store protocol's request: only ``hash_key()`` is read."""

    def __init__(self, key: bytes):
        self._key = key.decode()

    def hash_key(self):
        return self._key


@pytest.mark.parametrize("seed", [91, 92])
def test_ssd_store_matches_jax(tmp_path, seed):
    got = ssd_ops(tssd, str(tmp_path / "t"), seed)
    want = ssd_ops(jssd, str(tmp_path / "j"), seed)
    assert got == want
    stats = got[-1]
    assert stats["compactions"] + stats["slab_evictions"] > 0


def fill_dir(mod, directory):
    """A closed slab directory holding several records, overwrites and
    tombstones, plus the keys it should hold."""
    rng = np.random.default_rng(93)
    s = mod.SsdStore(directory, slab_bytes=4096)
    for k in range(6):
        keys = [f"d{int(i)}".encode() for i in rng.choice(40, 10,
                                                           replace=False)]
        s.put_columns(keys, cold_columns(rng, 10, NOW), NOW)
    s.remove_batch(["d1", "d2"])
    s.flush()
    s.close()
    return [f"d{i}".encode() for i in range(40)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_slab_directory_reopens_across_packages(tmp_path, writer):
    src = str(tmp_path / "src")
    keys = fill_dir(jssd if writer == "jax" else tssd, src)
    shutil.copytree(src, str(tmp_path / "copy"))
    out = []
    for mod, d in ((jssd, src), (tssd, str(tmp_path / "copy"))):
        s = mod.SsdStore(d)
        try:
            out.append(plain([len(s), s.take_batch(keys, NOW),
                              s.stats()["corrupt_records"]]))
        finally:
            s.close()
    assert out[1] == out[0]
    assert out[0][0] > 20


def ssd_pair(tmp_path, cap, max_batch, cold):
    return (JaxEngine(capacity=cap, max_batch=max_batch, cold_capacity=cold,
                      ssd=jssd.SsdStore(str(tmp_path / "j"))),
            TickEngine(capacity=cap, max_batch=max_batch, cold_capacity=cold,
                       ssd=tssd.SsdStore(str(tmp_path / "t")),
                       bg_reclaim=False, device="cpu"))


def churn(j, t, rng, windows, pool, width, now=NOW):
    for k in range(windows):
        now += STEP * int(rng.integers(0, 2))
        ids = rng.choice(pool, int(rng.integers(1, width + 1)),
                         replace=False)
        jr, tr = request_pair(rng, ids, prefix="d", reset=0.05)
        assert (resp_tuples(t.process(tr, now=now))
                == resp_tuples(j.process(jr, now=now))), k
    return now


def assert_ssd_engines_equal(j, t):
    j.ssd.flush()
    t.ssd.flush()
    for m in SSD_METRICS:
        assert getattr(t, m) == getattr(j, m), m
    js, ts = j.ssd.stats(), t.ssd.stats()
    assert {k: ts[k] for k in SSD_COUNTS} == {k: js[k] for k in SSD_COUNTS}
    assert t.cold.stats() == j.cold.stats()
    assert t.cold_size() == j.cold_size()
    assert_same_snapshot(t.export_columns(), j.export_columns())


@pytest.mark.parametrize("shape", [(2, 8, 2, 2), (4, 16, 4, 4)])
def test_three_tier_engine_matches_jax(tmp_path, shape):
    cap, max_batch, cold, width = shape
    j, t = ssd_pair(tmp_path, cap, max_batch, cold)
    rng = np.random.default_rng(94 + cap)
    try:
        churn(j, t, rng, 40, 8 * cap, width)
        assert_ssd_engines_equal(j, t)
        assert t.metric_ssd_hits > 3
        assert t.metric_ssd_tick_path_reads == 0
        assert t.metric_ssd_lookups <= t.metric_ssd_miss_ticks
        assert t.metric_promote_dispatches == t.metric_promote_ticks
    finally:
        j.close()
        t.close()
    t.close()  # idempotent


def test_engines_on_one_slab_directory_promote_alike(tmp_path):
    """A JAX three-tier engine's slab directory, after close, backs fresh
    engines of both packages: every key comes back from the SSD alike."""
    j, t = ssd_pair(tmp_path / "a", 2, 8, 2)
    rng = np.random.default_rng(96)
    try:
        churn(j, t, rng, 30, 16, 2)
    finally:
        j.close()
        t.close()
    shutil.copytree(str(tmp_path / "a" / "j"), str(tmp_path / "b" / "t"))
    shutil.copytree(str(tmp_path / "a" / "j"), str(tmp_path / "b" / "j"))
    j2, t2 = ssd_pair(tmp_path / "b", 2, 8, 2)
    try:
        assert len(t2.ssd) == len(j2.ssd) > 4
        churn(j2, t2, rng, 16, 16, 2, now=NOW + 40 * STEP)
        assert_ssd_engines_equal(j2, t2)
        assert t2.metric_ssd_hits > 4
    finally:
        j2.close()
        t2.close()


def test_ssd_needs_a_cold_tier(tmp_path):
    s = tssd.SsdStore(str(tmp_path / "s"))
    try:
        with pytest.raises(ValueError, match="cold tier"):
            TickEngine(capacity=4, max_batch=8, ssd=s, device="cpu")
    finally:
        s.close()
