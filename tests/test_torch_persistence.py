"""The port's persistence package against the JAX package's.

* The record codec: a CRC frame written by either package reads in both,
  torn and corrupt tails alike; snapshots encode in one and decode in the
  other.
* ``SnapshotStore`` directories: a writer engine of either package
  (``capacity=128, max_batch=64, cold_capacity=512``, the shape of
  tests/test_persistence.py) drains deltas and a compacted base through a
  ``SnapshotWriter``; both packages read the directory alike, and engines
  of both packages replay it into identical exports (hot and cold rows).
* ``SnapshotWriter`` on the two engines: the same flushes, carried
  failures and compactions give the same counters and the same restore;
  its supervised loop and its final base on close.
* ``TransitionLog`` / ``check_interrupted`` and the supervised thread.
"""

import asyncio
import threading

import numpy as np
import pytest

from gubernator_tpu import persistence as jp
from gubernator_tpu.ops.engine import TickEngine as JaxEngine
from gubernator_tpu_torch import persistence as tp
from gubernator_tpu_torch.ops.engine import TickEngine
from gubernator_tpu_torch.resilience import spawn_supervised_thread
from tests.test_torch_common import NOW
from tests.test_torch_state import ALL_FIELDS, assert_same_snapshot, by_key
from tests.test_torch_store import STEP, request_pair, resp_tuples


def engine_pair():
    return (JaxEngine(capacity=128, max_batch=64, cold_capacity=512),
            TickEngine(capacity=128, max_batch=64, cold_capacity=512,
                       bg_reclaim=False, device="cpu"))


def serve(j, t, rng, now, pool=300):
    jr, tr = request_pair(rng, rng.choice(pool, 64, replace=False),
                          prefix="p")
    assert (resp_tuples(t.process(tr, now=now))
            == resp_tuples(j.process(jr, now=now)))


def frames(path):
    with open(path, "rb") as f:
        return f.read()


def test_record_codec_reads_across_packages(tmp_path):
    j, t = engine_pair()
    rng = np.random.default_rng(101)
    serve(j, t, rng, NOW)
    snap = t.export_columns()
    for enc, dec in ((tp.encode_snapshot, jp.decode_snapshot),
                     (jp.encode_snapshot, tp.decode_snapshot)):
        assert_same_snapshot(dec(enc(snap)), snap)
    payloads = [tp.encode_snapshot(snap), b"x" * 7, b""]
    for mod, name in ((tp, "t.log"), (jp, "j.log")):
        with open(tmp_path / name, "wb") as f:
            for p in payloads:
                assert mod.write_record(f, p) == 16 + len(p)
    assert frames(tmp_path / "t.log") == frames(tmp_path / "j.log")
    # Torn tail, then a flipped payload byte: both read the good prefix.
    data = frames(tmp_path / "t.log")
    (tmp_path / "torn").write_bytes(data[:-3] + data[-3:][:1])
    flipped = bytearray(data)
    flipped[40] ^= 0xFF
    (tmp_path / "flip").write_bytes(bytes(flipped))
    for name in ("t.log", "torn", "flip", "missing"):
        path = str(tmp_path / name)
        assert tp.read_records(path) == jp.read_records(path)
    assert tp.snapshot_items(snap) == jp.snapshot_items(snap) > 30


def fill_directory(eng, path, rng_seed):
    """Windows at one ``now`` (LRU victims demote, none expires), two
    flushed deltas, a compacted base, one more delta."""
    rng = np.random.default_rng(rng_seed)
    mod = tp if isinstance(eng, TickEngine) else jp
    writer = mod.SnapshotWriter(eng, mod.SnapshotStore(path), interval=60,
                                deltas_per_base=99)
    now = NOW + STEP
    for k in range(5):
        jr, tr = request_pair(rng, rng.choice(300, 64, replace=False),
                              prefix="p")
        eng.process(tr if mod is tp else jr, now=now)
        if k in (1, 2, 4):
            writer.flush()
        if k == 3:
            writer.write_base()
    writer.store.close()
    return now


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_directory_restores_across_packages(tmp_path, writer):
    j, t = engine_pair()
    src = j if writer == "jax" else t
    now = fill_directory(src, str(tmp_path), 102)
    assert src.cold_size() > 0
    jr, tr = jp.SnapshotStore(str(tmp_path)).load(), \
        tp.SnapshotStore(str(tmp_path)).load()
    for f in ("generation", "items", "delta_records", "corrupt_records",
              "manifest_missing"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.generation == 1 and tr.delta_records == 1
    assert len(tr.snapshots) == len(jr.snapshots) == 2
    for a, b in zip(tr.snapshots, jr.snapshots):
        assert_same_snapshot(a, b)
    # Both packages' engines replay the directory alike.
    j2, t2 = engine_pair()
    for snap in jr.snapshots:
        j2.load_columns(snap, now=now)
    for snap in tr.snapshots:
        t2.load_columns(snap, now=now)
    assert t2.cold_size() == j2.cold_size() > 0
    got, want = t2.export_columns(), j2.export_columns()
    assert_same_columns(got, want)
    # The restore holds every key the writer engine holds (hot or cold).
    # Not every value: a query (hits 0) that switches a bucket's algorithm
    # moves its state without marking it dirty in either package.
    assert by_key(src.export_columns()).keys() <= first_by_key(got).keys()


def assert_same_columns(got, want):
    """Two exports equal column by column, in order.  A replayed delta
    upserts keys the base left in the cold tier into the table without
    taking them out of the cold tier (the JAX engine's load_columns; the
    port does the same), so an export after such a replay can name a key
    twice, hot first: ``by_key`` does not apply."""
    assert got.keys() == want.keys()
    assert bytes(got["key_blob"]) == bytes(want["key_blob"])
    for f in want:
        if f != "key_blob":
            assert np.asarray(got[f]).dtype == np.asarray(want[f]).dtype, f
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def first_by_key(snap):
    """{key: row} of an export, a key's first (hot) row winning."""
    off = snap["key_offsets"]
    blob = bytes(snap["key_blob"])
    out = {}
    for i in range(len(off) - 1):
        out.setdefault(blob[off[i]:off[i + 1]], tuple(
            snap[f][i].item() for f in ALL_FIELDS if f in snap))
    return out


def test_writer_matches_jax(tmp_path, monkeypatch):
    j, t = engine_pair()
    rng = np.random.default_rng(103)
    writers = [mod.SnapshotWriter(e, mod.SnapshotStore(str(tmp_path / tag)),
                                  interval=60, deltas_per_base=3)
               for mod, e, tag in ((jp, j, "j"), (tp, t, "t"))]
    now = NOW
    counts = []
    for k in range(7):
        now += STEP
        serve(j, t, rng, now)
        if k == 2:
            # A delta that fails to reach the disk is carried, not lost.
            for w in writers:
                def boom(snap):
                    raise OSError("disk full")
                monkeypatch.setattr(w.store, "append_delta", boom)
        written = [w.flush() for w in writers]
        if k == 2:
            monkeypatch.undo()
        counts.append([written] + [
            [w.metric_delta_writes, w.metric_base_writes,
             w.metric_items_written, w.metric_write_failures, len(w._carry),
             w.store.generation, w.store.delta_records] for w in writers])
    for c in counts:
        assert c[0][0] == c[0][1] and c[1] == c[2], c
    assert writers[1].metric_write_failures == 1
    assert writers[1].metric_base_writes >= 1
    for w in writers:
        w.store.close()
    restored = [mod.SnapshotStore(str(tmp_path / tag)).load()
                for mod, tag in ((jp, "j"), (tp, "t"))]
    assert [len(r.snapshots) for r in restored] == [
        len(r.snapshots) for r in restored[::-1]]
    for a, b in zip(*(r.snapshots for r in restored)):
        assert_same_snapshot(b, a)


def test_writer_loop_and_final_base(tmp_path):
    eng = TickEngine(capacity=128, max_batch=64, cold_capacity=512,
                     bg_reclaim=False, device="cpu")
    rng = np.random.default_rng(104)
    writer = tp.SnapshotWriter(eng, tp.SnapshotStore(str(tmp_path)),
                               interval=0.01, deltas_per_base=99)

    async def run():
        writer.start()
        _, tr = request_pair(rng, range(40), prefix="w")
        eng.process(tr, now=NOW)
        for _ in range(3000):  # up to 30 s on a loaded host
            if writer.metric_delta_writes:
                break
            await asyncio.sleep(0.01)
        await writer.close()

    asyncio.run(run())
    assert writer.metric_delta_writes >= 1
    assert writer.metric_base_writes == 1  # the final base on close
    assert writer.flush() == 0             # closed: no more flushes
    res = tp.SnapshotStore(str(tmp_path)).load()
    assert res.generation == 1 and res.items == 40


def test_transition_log_matches_jax(tmp_path):
    recs = [("begin", 4, 8, 1), ("commit", 4, 8, 1), ("begin", 8, 2, 2)]
    logs = {}
    for mod, tag in ((jp, "j"), (tp, "t")):
        d = tmp_path / tag
        d.mkdir()
        log = mod.TransitionLog(str(d))
        for phase, a, b, e in recs:
            log.append(mod.TransitionRecord(phase, a, b, e))
        logs[tag] = (log, d)
    assert (frames(logs["t"][1] / "reshard-transition.log")
            == frames(logs["j"][1] / "reshard-transition.log"))
    got = [(r.phase, r.from_shards, r.to_shards, r.epoch)
           for r in logs["t"][0].records()]
    assert got == recs
    # Each package reads the other's journal; the open "begin" surfaces
    # once and the journal is cleared.
    for mod, other in ((tp, "j"), (jp, "t")):
        rec = mod.check_interrupted(mod.TransitionLog(str(logs[other][1])))
        assert (rec.phase, rec.from_shards, rec.to_shards, rec.epoch) == \
            recs[-1]
        assert mod.check_interrupted(
            mod.TransitionLog(str(logs[other][1]))) is None
    assert tp.TransitionLog(None).records() == []
    assert tp.TransitionRecord.decode(b"not json") is None
    assert set(tp.__all__) == set(jp.__all__)


def test_supervised_thread_restarts_after_a_crash():
    runs = []
    done = threading.Event()

    def loop():
        runs.append(1)
        if len(runs) < 3:
            raise RuntimeError("crash")
        done.set()

    t = spawn_supervised_thread(loop, name="t", restart_delay=0.001)
    assert done.wait(5)
    t.join(5)
    assert len(runs) == 3 and not t.is_alive()
