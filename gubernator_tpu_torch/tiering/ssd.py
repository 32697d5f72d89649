"""SSD-backed third storage tier: append-only mmap slab store.

One tier below the host :class:`~gubernator_tpu_torch.tiering.coldstore.ColdStore`
(docs/tiering.md): when the bounded cold tier sheds its LRU tail, the
victims land here instead of evaporating, so bucket continuity
(``remaining / remaining_f / created_at / status``) survives
hot↔cold↔SSD cycling with RAM bounded by the two upper tiers — the
long Zipf tail of billions of rarely-touched buckets lives on flash.

Layout — log-structured slabs, not a B-tree:

* A slab is an append-only file of CRC-framed records (the
  ``persistence/`` GSNP framing: ``MAGIC | crc32 | len | payload``), one
  record per **demote batch** — an npz-encoded columnar block of keys +
  ``COLD_FIELDS`` rows.  Batched records mean one ``write()`` per cold
  sweep, not per key.
* Reads go through a per-slab ``mmap``: a batch lookup touches only the
  pages holding the records it needs.  A record is decoded once per
  batch no matter how many of its rows hit.
* The only RAM per key is one index entry ``key → (slab, offset, row,
  expire_at)``; TTL is enforced drop-on-read from the index alone (no
  I/O for an expired key).

Write path — asynchronous, bounded, never unbounded RAM:

* ``put_columns`` stages the batch in a **bounded queue**; a supervised
  background thread (``resilience.spawn_supervised_thread``) drains it:
  encode → append → install index entries.  A full queue **blocks the
  demote sweep** (counted: ``backpressure``) rather than buffering
  without bound or dropping rows — continuity beats latency on the
  demote side, which already runs off the tick path.
* Staged-but-unwritten batches are visible to ``take_batch`` (served
  from RAM and tombstoned so the written row is born dead) — a key can
  never fall into a read/write gap.

Compaction and bounds (log-structured maintenance, writer-thread side):

* Overwrites and takes don't touch old records; they just decrement the
  owning slab's live count.  A sealed slab past ``compact_ratio``
  garbage gets its live rows appended to the active slab **and fsynced
  before the old file is unlinked** — the crash-safe retire ordering of
  ``SnapshotStore.write_base``; a crash between the two leaves both
  copies and index rebuild resolves last-wins by (slab, offset) order.
* ``capacity_bytes`` bounds total disk: past it the oldest sealed slab
  retires wholesale (cache semantics, like the tiers above).

Failure modes (documented, tested):

* A torn tail (kill -9 mid-append) is detected by the CRC framing:
  rebuild stops that slab at its last good record and counts the damage
  (``corrupt_records``); on reopen all existing slabs are sealed and
  appends go to a fresh slab, so a bad tail is never appended past.
* ``remove``/``take`` tombstones live only in RAM: after a crash the
  record is still on disk and the row resurrects with its pre-take
  state.  That is at worst *conservative* for admission (the stale copy
  has fewer tokens than a fresh bucket) and heals on the key's next
  demote (newer record wins).

The port's copy of the JAX package's ``tiering/ssd.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from __future__ import annotations

import io
import logging
import mmap
import os
import queue
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from gubernator_tpu_torch.persistence.snapshot import (
    _HEADER, MAGIC, read_records, write_record,
)
from gubernator_tpu_torch.resilience.supervisor import spawn_supervised_thread
from gubernator_tpu_torch.tiering.coldstore import COLD_FIELDS, ZOO_COLD_FIELDS

log = logging.getLogger("gubernator.tiering.ssd")

_SLAB_SUFFIX = ".slab"


def _slab_name(slab_id: int) -> str:
    return f"slab-{slab_id:08d}{_SLAB_SUFFIX}"


def _field_dtype(f: str):
    return np.float64 if f == "remaining_f" else np.int64


def _encode_batch(keys: List[bytes], cols: Dict[str, np.ndarray]) -> bytes:
    """Columnar demote batch → npz payload (key blob + offsets + fields;
    the persistence snapshot encoding, minus the engine-only fields)."""
    blob = b"".join(keys)
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    enc = {
        "key_blob": np.frombuffer(blob, np.uint8),
        "key_offsets": offsets,
    }
    for f in COLD_FIELDS:
        enc[f] = np.ascontiguousarray(cols[f], _field_dtype(f))
    buf = io.BytesIO()
    np.savez(buf, **enc)
    return buf.getvalue()


def _decode_batch(payload: bytes) -> Tuple[List[bytes], Dict[str, np.ndarray]]:
    """Inverse of :func:`_encode_batch`.  Slabs written before the
    algorithm zoo lack the zoo columns: zero-fill them (fresh
    window/TAT) so old slab files keep loading."""
    with np.load(io.BytesIO(payload)) as z:
        blob = z["key_blob"].tobytes()
        offsets = z["key_offsets"]
        n = len(offsets) - 1
        cols = {
            f: (
                z[f] if f in z.files
                else np.zeros(n, _field_dtype(f))
            )
            for f in COLD_FIELDS
        }
    keys = [
        blob[int(offsets[i]): int(offsets[i + 1])]
        for i in range(len(offsets) - 1)
    ]
    return keys, cols


class _Slab:
    """One append-only slab file + its read map and liveness stats."""

    __slots__ = ("slab_id", "path", "file", "map", "tail", "total_rows",
                 "live_rows", "sealed", "keys")

    def __init__(self, slab_id: int, path: str):
        self.slab_id = slab_id
        self.path = path
        self.file = None            # write handle (active slab only)
        self.map: Optional[mmap.mmap] = None
        self.tail = 0               # bytes appended (== file size)
        self.total_rows = 0
        self.live_rows = 0
        self.sealed = False
        self.keys: set = set()      # keys whose index entry points here

    def garbage_ratio(self) -> float:
        if self.total_rows <= 0:
            return 0.0
        return 1.0 - self.live_rows / self.total_rows


class SsdStore:
    """Bounded SSD tier for cold-store overflow (see module doc).

    Implements the :class:`~gubernator_tpu_torch.store.Store` protocol —
    including the batched ``put_batch``/``remove_batch`` extension and
    the columnar ``put_columns`` fast path — so it drops in as the
    ColdStore's write-behind sink unchanged.  Thread-safe: the engine's
    miss path (``take_batch``) runs concurrently with the background
    writer and the reclaimer's demote sweeps.
    """

    def __init__(
        self,
        directory: str,
        capacity_bytes: int = 1 << 30,
        compact_ratio: float = 0.5,
        queue_depth: int = 8,
        slab_bytes: int = 0,
        metrics=None,
    ):
        if capacity_bytes <= 0:
            raise ValueError("SsdStore capacity_bytes must be positive")
        if not (0.0 < compact_ratio <= 1.0):
            raise ValueError("SsdStore compact_ratio must be in (0, 1]")
        if queue_depth <= 0:
            raise ValueError("SsdStore queue_depth must be positive")
        self.dir = directory
        self.capacity_bytes = int(capacity_bytes)
        self.compact_ratio = float(compact_ratio)
        # Slab roll target: small enough that compaction/retire work in
        # slab-sized chunks, large enough to amortize the per-file cost.
        self.slab_bytes = int(slab_bytes) if slab_bytes > 0 else max(
            1 << 20, self.capacity_bytes // 8
        )
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        # key → (slab_id, offset, row, expire_at).  Disjoint from
        # ``_staged`` by construction: staging a key pops its index
        # entry (the old disk row becomes garbage immediately).
        self._index: Dict[bytes, Tuple[int, int, int, int]] = {}
        self._slabs: Dict[int, _Slab] = {}
        # In-flight demote batches: bid → (keys, cols, dead-row set).
        # ``_staged`` maps key → (bid, row) so queued rows stay readable.
        self._pending: Dict[int, Tuple[List[bytes], Dict[str, np.ndarray],
                                       set]] = {}
        self._staged: Dict[bytes, Tuple[int, int]] = {}
        self._next_bid = 0
        self._queue: "queue.Queue[Optional[int]]" = queue.Queue(queue_depth)
        self._running = True
        # Counters (mirrored into Prometheus by the service layer).
        self.metric_demotions = 0
        self.metric_promotions = 0
        self.metric_hits = 0
        self.metric_misses = 0
        self.metric_expired = 0
        self.metric_lookup_calls = 0
        self.metric_write_batches = 0
        self.metric_backpressure = 0
        self.metric_compactions = 0
        self.metric_slab_evictions = 0
        self.metric_corrupt_records = 0
        self._rebuild()
        self._writer = spawn_supervised_thread(
            self._writer_loop,
            name="ssd-writer",
            should_restart=lambda: self._running,
            metrics=metrics,
            loop_label="ssd_writer",
        )

    # ------------------------------------------------------------------
    # Open-time index rebuild
    # ------------------------------------------------------------------
    def _rebuild(self) -> None:
        """Replay every slab's records in (slab, offset) order, last
        write wins.  All pre-existing slabs are sealed — appending past
        a possibly-torn tail would orphan the new record behind the
        first corrupt frame — and writes start a fresh slab."""
        try:
            names = sorted(
                n for n in os.listdir(self.dir)
                if n.startswith("slab-") and n.endswith(_SLAB_SUFFIX)
            )
        except OSError:
            names = []
        max_id = -1
        for name in names:
            try:
                slab_id = int(name[len("slab-"): -len(_SLAB_SUFFIX)])
            except ValueError:
                continue
            max_id = max(max_id, slab_id)
            slab = _Slab(slab_id, os.path.join(self.dir, name))
            slab.sealed = True
            # Registered before replay: a key superseded by a later
            # record in this same slab resolves its old entry here.
            self._slabs[slab_id] = slab
            payloads, corrupt = read_records(slab.path)
            self.metric_corrupt_records += corrupt
            offset = 0
            for payload in payloads:
                try:
                    keys, cols = _decode_batch(payload)
                except Exception:
                    self.metric_corrupt_records += 1
                    break
                expire = np.asarray(cols["expire_at"], np.int64)
                for row, key in enumerate(keys):
                    slab.total_rows += 1
                    old = self._index.pop(key, None)
                    if old is not None:
                        prev = self._slabs[old[0]]
                        prev.live_rows -= 1
                        prev.keys.discard(key)
                    self._index[key] = (
                        slab_id, offset, row, int(expire[row])
                    )
                    slab.live_rows += 1
                    slab.keys.add(key)
                offset += _HEADER.size + len(payload)
            slab.tail = offset
        self._active = self._new_slab(max_id + 1)

    def _new_slab(self, slab_id: int) -> _Slab:
        slab = _Slab(slab_id, os.path.join(self.dir, _slab_name(slab_id)))
        slab.file = open(slab.path, "ab")
        # The open stays outside the lock (G007); only the registry
        # install is guarded — take_batch walks _slabs under _lock while
        # the writer thread rolls slabs.
        with self._lock:
            self._slabs[slab_id] = slab
        return slab

    # ------------------------------------------------------------------
    # Read plumbing
    # ------------------------------------------------------------------
    def _map_slab(self, slab: _Slab, need: int) -> Optional[mmap.mmap]:
        """The slab's read map, remapped when appends outgrew it.  Kept
        out of the batch-lookup body: ``mmap`` is a syscall and remaps
        are rare (once per slab growth spurt, not per lookup)."""
        m = slab.map
        if m is not None and len(m) >= need:
            return m
        if m is not None:
            m.close()
            slab.map = None
        try:
            with open(slab.path, "rb") as f:
                slab.map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            return None  # empty or vanished file: caller counts a miss
        return slab.map if len(slab.map) >= need else None

    def _read_payload(self, slab: _Slab, offset: int) -> Optional[bytes]:
        """One CRC-checked record payload out of the slab map."""
        m = self._map_slab(slab, offset + _HEADER.size)
        if m is None:
            return None
        magic, crc, length = _HEADER.unpack(
            m[offset: offset + _HEADER.size]
        )
        if magic != MAGIC:
            self.metric_corrupt_records += 1
            return None
        end = offset + _HEADER.size + length
        if len(m) < end:
            m = self._map_slab(slab, end)
            if m is None:
                return None
        payload = m[offset + _HEADER.size: end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            self.metric_corrupt_records += 1
            return None
        return payload

    # ------------------------------------------------------------------
    # Demote (cold overflow → SSD)
    # ------------------------------------------------------------------
    def put_columns(
        self, keys: List[bytes], cols: Dict[str, np.ndarray], now: int
    ) -> int:
        """Stage one demote batch (COLD_FIELDS columns, one row per
        key) on the bounded writer queue; returns rows staged.  Already
        TTL-expired rows are dropped.  Blocks (counted) when the queue
        is full — backpressure, never unbounded RAM."""
        if not keys:
            return 0
        missing = [f for f in COLD_FIELDS if f not in cols]
        if missing:
            # Legacy callers omit the zoo columns; zero-fill (see
            # _decode_batch).
            zeros = np.zeros(len(keys), np.int64)
            cols = {**cols, **{f: zeros for f in missing}}
        expire = cols["expire_at"]
        keep = np.flatnonzero(expire >= now)
        if len(keep) == 0:
            return 0
        if len(keep) < len(keys):
            keys = [keys[int(j)] for j in keep]
            cols = {f: cols[f][keep] for f in COLD_FIELDS}
        with self._lock:
            bid = self._next_bid
            self._next_bid = bid + 1
            dead: set = set()
            for row, key in enumerate(keys):
                old = self._staged.get(key)
                if old is not None:
                    # Superseded while queued: the old row is born dead.
                    self._pending[old[0]][2].add(old[1])
                else:
                    ent = self._index.pop(key, None)
                    if ent is not None:
                        prev = self._slabs[ent[0]]
                        prev.live_rows -= 1
                        prev.keys.discard(key)
                self._staged[key] = (bid, row)
            self._pending[bid] = (keys, cols, dead)
            self.metric_demotions += len(keys)
        if self._queue.full():
            self.metric_backpressure += 1
        self._queue.put(bid)
        return len(keys)

    # ------------------------------------------------------------------
    # Promote (SSD → cold/hot): the engine miss path's third hop
    # ------------------------------------------------------------------
    def take_batch(
        self, keys: List[bytes], now: int
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Look up + REMOVE a batch of keys (promotion is a move, like
        ``ColdStore.take``: the upper tier becomes the owner).  Returns
        ``(hit_positions, cols)`` in hit order; expired entries are
        dropped from the index without touching disk."""
        empty = np.empty(0, np.int64)
        if not keys:
            return empty, {}
        with self._lock:
            self.metric_lookup_calls += 1
            pos: List[int] = []
            ram_rows: List[Tuple[int, int, int]] = []  # (out, bid, row)
            # (slab_id, offset) → [(out_row, record_row)]
            disk: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
            for j, key in enumerate(keys):
                staged = self._staged.get(key)
                if staged is not None:
                    bid, row = staged
                    batch = self._pending[bid]
                    if batch[1]["expire_at"][row] < now:
                        del self._staged[key]
                        batch[2].add(row)
                        self.metric_expired += 1
                        self.metric_misses += 1
                        continue
                    ram_rows.append((len(pos), bid, row))
                    pos.append(j)
                    del self._staged[key]
                    batch[2].add(row)  # written row will be born dead
                    continue
                ent = self._index.get(key)
                if ent is None:
                    self.metric_misses += 1
                    continue
                slab_id, offset, row, expire_at = ent
                slab = self._slabs[slab_id]
                del self._index[key]
                slab.live_rows -= 1
                slab.keys.discard(key)
                if expire_at < now:
                    self.metric_expired += 1
                    self.metric_misses += 1
                    continue
                disk.setdefault((slab_id, offset), []).append((len(pos), row))
                pos.append(j)
            n = len(pos)
            if n == 0:
                return empty, {}
            out = {f: np.empty(n, _field_dtype(f)) for f in COLD_FIELDS}
            lost: set = set()
            for (slab_id, offset), rows in disk.items():
                payload = self._read_payload(self._slabs[slab_id], offset)
                if payload is None:
                    lost.update(o for o, _ in rows)
                    continue
                _, rec_cols = _decode_batch(payload)
                dst = np.fromiter((o for o, _ in rows), np.int64, len(rows))
                src = np.fromiter((r for _, r in rows), np.int64, len(rows))
                for f in COLD_FIELDS:
                    out[f][dst] = rec_cols[f][src]
            for o, bid, row in ram_rows:
                batch_cols = self._pending[bid][1]
                for f in COLD_FIELDS:
                    out[f][o] = batch_cols[f][row]
            if lost:
                # Unreadable record (rot under a live index entry):
                # those rows are misses; compact the survivors out.
                keep = np.fromiter(
                    (o for o in range(n) if o not in lost),
                    np.int64, n - len(lost),
                )
                pos = [pos[int(o)] for o in keep]
                out = {f: out[f][keep] for f in COLD_FIELDS}
                self.metric_misses += len(lost)
                n = len(pos)
                if n == 0:
                    return empty, {}
            self.metric_hits += n
            self.metric_promotions += n
            return np.fromiter(pos, np.int64, n), out

    # ------------------------------------------------------------------
    # Background writer
    # ------------------------------------------------------------------
    def _writer_loop(self) -> None:
        """Drain the bounded queue: encode → append → install; then the
        log-structured maintenance (roll / compact / evict) that must
        never run on the demote or miss path."""
        while True:
            bid = self._queue.get()
            try:
                if bid is None:
                    return
                self._write_batch(bid)
                self._maintain()
            finally:
                self._queue.task_done()

    def _write_batch(self, bid: int) -> None:
        with self._lock:
            keys, cols, _dead = self._pending[bid]
        payload = _encode_batch(keys, cols)
        slab = self._active
        offset = slab.tail
        written = write_record(slab.file, payload)
        slab.file.flush()
        with self._lock:
            slab.tail = offset + written
            keys, cols, dead = self._pending.pop(bid)
            expire = cols["expire_at"]
            for row, key in enumerate(keys):
                slab.total_rows += 1
                if row in dead:
                    continue  # taken/removed/superseded while queued
                if self._staged.get(key) != (bid, row):
                    continue
                del self._staged[key]
                self._index[key] = (
                    slab.slab_id, offset, row, int(expire[row])
                )
                slab.live_rows += 1
                slab.keys.add(key)
            self.metric_write_batches += 1

    def _maintain(self) -> None:
        """Roll the active slab past its size target, compact sealed
        slabs past the garbage threshold, retire oldest slabs past the
        byte budget.  Writer-thread only."""
        slab = self._active
        if slab.tail >= self.slab_bytes:
            os.fsync(slab.file.fileno())
            slab.file.close()
            slab.file = None
            with self._lock:
                slab.sealed = True
            self._active = self._new_slab(slab.slab_id + 1)
        for sid in sorted(self._slabs):
            s = self._slabs[sid]
            if (
                s.sealed and s.total_rows > 0
                and s.garbage_ratio() > self.compact_ratio
            ):
                self._compact(s)
        total = sum(s.tail for s in self._slabs.values())
        while total > self.capacity_bytes:
            sealed = sorted(
                sid for sid, s in self._slabs.items() if s.sealed
            )
            if not sealed:
                break
            total -= self._retire(self._slabs[sealed[0]], evict=True)

    def _compact(self, slab: _Slab) -> None:
        """Rewrite a sealed slab's live rows into the active slab, fsync
        the copy, THEN unlink the original (SnapshotStore retire
        ordering: a crash between leaves both copies; index rebuild is
        last-wins by slab order, and the copy lives in a newer slab)."""
        with self._lock:
            entries = [
                (key, ent) for key in list(slab.keys)
                if (ent := self._index.get(key)) is not None
            ]
        if entries:
            by_record: Dict[int, List[Tuple[bytes, int, int]]] = {}
            for key, (sid, offset, row, expire_at) in entries:
                if sid != slab.slab_id:
                    continue  # repointed while we looked
                by_record.setdefault(offset, []).append(
                    (key, row, expire_at)
                )
            live_keys: List[bytes] = []
            live_cols = {
                f: [] for f in COLD_FIELDS
            }  # type: Dict[str, list]
            for offset, rows in sorted(by_record.items()):
                payload = self._read_payload(slab, offset)
                if payload is None:
                    continue
                _, rec_cols = _decode_batch(payload)
                for key, row, _expire in rows:
                    live_keys.append(key)
                    for f in COLD_FIELDS:
                        live_cols[f].append(rec_cols[f][row])
            if live_keys:
                cols = {
                    f: np.asarray(live_cols[f], _field_dtype(f))
                    for f in COLD_FIELDS
                }
                dst = self._active
                offset = dst.tail
                written = write_record(dst.file, _encode_batch(
                    live_keys, cols
                ))
                dst.file.flush()
                os.fsync(dst.file.fileno())
                expire = cols["expire_at"]
                with self._lock:
                    dst.tail = offset + written
                    for row, key in enumerate(live_keys):
                        dst.total_rows += 1
                        ent = self._index.get(key)
                        if ent is None or ent[0] != slab.slab_id:
                            continue  # moved/removed during the copy
                        slab.live_rows -= 1
                        slab.keys.discard(key)
                        self._index[key] = (
                            dst.slab_id, offset, row, int(expire[row])
                        )
                        dst.live_rows += 1
                        dst.keys.add(key)
        self._retire(slab, evict=False)
        self.metric_compactions += 1

    def _retire(self, slab: _Slab, evict: bool) -> int:
        """Drop a sealed slab: index entries, read map, file.  Returns
        the bytes released."""
        with self._lock:
            for key in slab.keys:
                self._index.pop(key, None)
            if evict:
                self.metric_slab_evictions += 1
            slab.keys.clear()
            slab.live_rows = 0
            if slab.map is not None:
                slab.map.close()
                slab.map = None
            freed = slab.tail
            del self._slabs[slab.slab_id]
        try:
            os.unlink(slab.path)
        except OSError:
            pass
        return freed

    # ------------------------------------------------------------------
    # Store protocol (per-item fallback + batched extension)
    # ------------------------------------------------------------------
    def on_change(self, req, item: dict) -> None:
        """Store-protocol write(-behind): one item → a one-row batch."""
        self.put_batch([item])

    def put_batch(self, items: List[dict]) -> None:
        """Batched Store sink: one staged record per call."""
        if not items:
            return
        keys = [it["key"].encode() for it in items]
        cols = {
            f: np.asarray(
                [
                    it.get(f, 0) if f in ZOO_COLD_FIELDS else it[f]
                    for it in items
                ],
                _field_dtype(f),
            )
            for f in COLD_FIELDS
        }
        self.put_columns(keys, cols, now=0)

    def get(self, req) -> Optional[dict]:
        """Store-protocol read-through: peek one key (no removal)."""
        key = req.hash_key().encode()
        with self._lock:
            staged = self._staged.get(key)
            if staged is not None:
                bid, row = staged
                cols = self._pending[bid][1]
                return {
                    "key": key.decode(),
                    **{
                        f: (float if f == "remaining_f" else int)(
                            cols[f][row]
                        )
                        for f in COLD_FIELDS
                    },
                }
            ent = self._index.get(key)
            if ent is None:
                return None
            slab_id, offset, row, _expire = ent
            payload = self._read_payload(self._slabs[slab_id], offset)
        if payload is None:
            return None
        _, cols = _decode_batch(payload)
        return {
            "key": key.decode(),
            **{
                f: (float if f == "remaining_f" else int)(cols[f][row])
                for f in COLD_FIELDS
            },
        }

    def remove(self, key: str) -> None:
        self.remove_batch([key])

    def remove_batch(self, keys: List[str]) -> None:
        """Batched Store removal: tombstone index/staged entries (the
        on-disk rows become compactable garbage)."""
        with self._lock:
            for key_s in keys:
                key = key_s.encode()
                staged = self._staged.pop(key, None)
                if staged is not None:
                    self._pending[staged[0]][2].add(staged[1])
                    continue
                ent = self._index.pop(key, None)
                if ent is not None:
                    slab = self._slabs[ent[0]]
                    slab.live_rows -= 1
                    slab.keys.discard(key)

    # ------------------------------------------------------------------
    # Maintenance / introspection
    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Block until every staged batch is on disk and indexed (test
        and shutdown barrier; serving never calls this)."""
        self._queue.join()

    def __len__(self) -> int:
        # _index and _staged are disjoint (staging pops the index entry).
        with self._lock:
            return len(self._index) + len(self._staged)

    def bytes_used(self) -> int:
        with self._lock:
            return sum(s.tail for s in self._slabs.values())

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._index) + len(self._staged),
                "bytes": sum(s.tail for s in self._slabs.values()),
                "slabs": len(self._slabs),
                "capacity_bytes": self.capacity_bytes,
                "demotions": self.metric_demotions,
                "promotions": self.metric_promotions,
                "hits": self.metric_hits,
                "misses": self.metric_misses,
                "expired": self.metric_expired,
                "lookup_calls": self.metric_lookup_calls,
                "write_batches": self.metric_write_batches,
                "backpressure": self.metric_backpressure,
                "compactions": self.metric_compactions,
                "slab_evictions": self.metric_slab_evictions,
                "corrupt_records": self.metric_corrupt_records,
                "queue_depth": self._queue.qsize(),
            }

    def close(self) -> None:
        """Stop the writer (draining the queue first), fsync, unmap."""
        if not self._running:
            return
        self._running = False
        self._queue.put(None)
        self._writer.join(timeout=10.0)
        for slab in list(self._slabs.values()):
            if slab.file is not None:
                slab.file.flush()
                try:
                    os.fsync(slab.file.fileno())
                except OSError:
                    pass
                slab.file.close()
                slab.file = None
            if slab.map is not None:
                slab.map.close()
                slab.map = None
