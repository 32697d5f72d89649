"""GLOBAL reconciliation as a collectives data plane, on one card.

Port of the TPU package's ``parallel/global_mesh.py``.  The reference
reconciles GLOBAL rate limits with two O(peers) RPC fans (``global.go``):
every non-owner sends its aggregated hits to each key's owner
(sendHits), and every owner pushes its authoritative state to every peer
(broadcastPeers).  When the peers are nodes of one mesh, both fans become
collectives:

* each node keeps a full replica of the GLOBAL table (the non-owner's
  local answer, ``gubernator.go:395-421``) and a hit accumulator a slot
  (``global.go:99-112``);
* slot ownership is by contiguous range: node d owns slots
  ``[d * capacity / n, (d + 1) * capacity / n)``;
* one reconcile step on the ``GlobalSyncWait`` cadence folds every node's
  window into the owners' rows in node order, with DRAIN_OVER_LIMIT forced
  and RESET_REMAINING only where queued, and writes the result into every
  replica.

On one card the n nodes are n replicas in one row table: node d's replica
of slot s is row ``d * capacity + s`` of a (n * capacity + 1, 16) int64
table (the port's row, ``ops/buckets.py``; the last row is the drop row),
beside ``aux`` (n, 9, capacity) and ``accum`` (n, 4, capacity) int64.  Each
collective of the reference (psum, all-gather by one-hot psum, pmax by
write stamp) becomes a read of the other replicas inside one kernel
(``ops/globalmesh.py``):

* a process window packs every node's block into one REQ32 window whose
  slots are flattened to ``d * capacity + s`` and stably sorted: one B.1
  launch (``fused_tick``) when no flattened slot repeats, else one B.5
  launch (``fused_sorted_tick``: the x64 transition applied one request
  after another, as the reference's rank rounds of ``bucket_transition``),
  then one B.8a launch (``global_accumulate``) over the same lanes;
* a dense step (capacity <= 2^16 by default) is one B.8b launch;
* a sparse step (``sparse_k``, on by itself above 2^16 slots) is one B.8c
  probe launch, one word read back (the overflow verdict), then one B.8d
  apply launch, or on overflow one strict B.8b launch instead (state and
  accumulators are untouched by the probe);
* eviction zeroes a victim's row on every replica through one B.2
  scatter a chunk, then its stamp and accumulators.

Each node answers from its own replica between reconciles, and hits on
slots it owns change the authority directly (``gubernator.go:604-606``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch import DeviceLike, resolve_device
from gubernator_tpu_torch.config import validate_global_mesh_capacity
from gubernator_tpu_torch.native import NativeSlotMap
from gubernator_tpu_torch.ops import globalmesh, rowtable
from gubernator_tpu_torch.ops.buckets import (
    NP_DTYPES, STATE_FIELDS, logical_to_rows, rows_to_logical, zeros_table)
from gubernator_tpu_torch.ops.engine import (
    evict_chunked, pack_cols_req32, pack_wide_rows, pad_pow2,
    select_reclaim_victims, sort_packed_by_slot, unpack_resp_compact)
from gubernator_tpu_torch.ops.fusedtick import (
    REQ32_INDEX, REQ32_ROWS, fused_tick)
from gubernator_tpu_torch.ops.globalmesh import (  # noqa: F401
    ACC_COUNT, ACC_HITS, ACC_RESET, ACC_ROWS, ACC_TOUCH, AUX, AUX_ROWS)
from gubernator_tpu_torch.ops.reqcols import ReqColumns
from gubernator_tpu_torch.ops.sortedtick import fused_sorted_tick
from gubernator_tpu_torch.types import (
    Behavior, RateLimitRequest, RateLimitResponse)
from gubernator_tpu_torch.utils import timeutil

# Tables above this many slots take the sparse reconcile by default.
DENSE_MAX_CAPACITY = 1 << 16
DEFAULT_SPARSE_K = 4096

_GREG = int(Behavior.DURATION_IS_GREGORIAN)


def _one_key(key: bytes):
    return key, np.array([0, len(key)], np.int64)


class MeshGlobalEngine:
    """The host side of the replicated GLOBAL table.

    One instance is shared by every service node resident on the mesh (the
    in-process cluster); each node calls :meth:`process` with its node
    index, and any of them calls :meth:`maybe_reconcile` on the
    ``GlobalSyncWait`` cadence (calls closer than ``min_reconcile_ms``
    collapse into one).  ``device`` "cpu" runs the plain versions; None
    means the card and raises without one."""

    def __init__(
        self,
        n_nodes: int,
        capacity: int = 1 << 16,
        max_batch: int = 1024,
        min_reconcile_ms: int = 0,
        strict_sequencing: bool = True,
        sparse_k: Optional[int] = None,
        device: DeviceLike = None,
    ):
        validate_global_mesh_capacity(int(capacity))
        if int(n_nodes) < 1:
            raise ValueError(f"n_nodes must be >= 1; got {n_nodes}")
        self.n_nodes = int(n_nodes)
        # Capacity splits evenly into the owners' slices.
        self.capacity = -(-int(capacity) // self.n_nodes) * self.n_nodes
        self.max_batch = int(max_batch)
        self.min_reconcile_ms = int(min_reconcile_ms)
        if sparse_k is None:
            sparse_k = (DEFAULT_SPARSE_K if self.capacity > DENSE_MAX_CAPACITY
                        else 0)
        self.sparse_k = min(int(sparse_k), self.capacity)
        # The sparse step always sequences the nodes' windows (each applies
        # on its own parameters), so a sparse engine's dense fallback
        # sequences too: otherwise the same traffic would change semantics
        # on whichever steps overflow the envelope.
        self.strict_sequencing = bool(strict_sequencing) or bool(self.sparse_k)
        self.device = resolve_device(device)
        n, cap = self.n_nodes, self.capacity
        self.table = zeros_table(n * cap, self.device)
        self.aux = torch.zeros((n, len(AUX_ROWS), cap), dtype=torch.int64,
                               device=self.device)
        self.accum = torch.zeros((n, ACC_ROWS, cap), dtype=torch.int64,
                                 device=self.device)
        # The probe's verdict and union size, its slot list and counters.
        self._probe_out, self._probe_slots, self._probe_scratch = (
            globalmesh.probe_buffers(n, cap, self.device))
        self.slots = NativeSlotMap(cap)
        self._last_access = np.zeros(cap, np.int64)
        # Slots assigned on the host but not yet written by a window: their
        # rows still look dead, so reclaim must skip them.
        self._pending: set = set()
        self._tick_count = 0
        self._last_reconcile_ms = 0
        self._reconcile_paused = 0
        self._lock = threading.RLock()
        self.metric_reconciles = 0
        # Reconcile programs a step: 1 per sparse or dense step, 2 when an
        # overflowing sparse step runs the dense fallback (the kernel
        # wrappers' launch counts say what the card ran: a sparse step is
        # a probe and an apply launch).
        self.metric_reconcile_dispatches = 0
        self.metric_dense_fallbacks = 0
        # Process windows by route: B.1 (unique flattened slots) or B.5;
        # slots evicted live (LRU victims of a full table).
        self.metric_unique_windows = 0
        self.metric_sorted_windows = 0
        self.metric_evictions = 0

    # ------------------------------------------------------------------
    # Request path (per node)
    # ------------------------------------------------------------------
    def process(self, requests: Sequence[RateLimitRequest], node_idx: int = 0,
                now: Optional[int] = None) -> List[RateLimitResponse]:
        """Apply GLOBAL requests that arrived at node ``node_idx``."""
        blocks: List[Sequence[RateLimitRequest]] = [
            [] for _ in range(self.n_nodes)]
        blocks[node_idx] = requests
        return self.process_blocks(blocks, now)[node_idx]

    def process_blocks(self, blocks: Sequence[Sequence[RateLimitRequest]],
                       now: Optional[int] = None
                       ) -> List[List[RateLimitResponse]]:
        """Apply one window of GLOBAL requests, grouped by receiving node:
        every node's block lands in the same launches; responses mirror
        the block structure."""
        if len(blocks) != self.n_nodes:
            raise ValueError(
                f"expected {self.n_nodes} blocks, got {len(blocks)}")
        out: List[List[Optional[RateLimitResponse]]] = [
            [None] * len(blk) for blk in blocks]
        with self._lock:
            now = now if now is not None else timeutil.now_ms()
            todo = [list(range(len(blk))) for blk in blocks]
            while any(todo):
                left = self._tick_once(blocks, todo, out, now)
                if left == todo:
                    for d, idxs in enumerate(left):
                        for j in idxs:
                            out[d][j] = RateLimitResponse(
                                error="global table full; eviction failed")
                    break
                todo = left
        return out  # type: ignore[return-value]

    def _gregorian(self, reqs, now: int):
        """(greg_exp, greg_dur, errors) for a list of requests: each
        Gregorian selector resolved once at ``now``; a bad selector is the
        item's error."""
        n = len(reqs)
        ge = np.zeros(n, np.int64)
        gd = np.zeros(n, np.int64)
        errors: Dict[int, str] = {}
        memo: Dict[int, object] = {}
        for i, r in enumerate(reqs):
            if not int(r.behavior) & _GREG:
                continue
            sel = int(r.duration)
            if sel not in memo:
                try:
                    memo[sel] = (timeutil.gregorian_expiration(now, sel),
                                 timeutil.gregorian_duration(now, sel))
                except timeutil.GregorianError as e:
                    memo[sel] = str(e)
            v = memo[sel]
            if isinstance(v, str):
                errors[i] = v
            else:
                ge[i], gd[i] = v
        return ge, gd, errors

    def _tick_once(self, blocks, todo, out, now: int):
        """One window: resolve, pack, tick, accumulate.  Returns the
        requests left for the next window (a node's block past
        ``max_batch``, or keys the full table could not place)."""
        self._tick_count += 1
        cand = [(d, j, blocks[d][j]) for d, idxs in enumerate(todo)
                for j in idxs]
        ge, gd, errors = self._gregorian([r for _, _, r in cand], now)
        for i in errors:
            d, j, _ = cand[i]
            out[d][j] = RateLimitResponse(error=errors[i])
        # Keys go to the slot map in node order, as the reference resolves
        # them one by one: in one call when the free slots hold every new
        # key of the nodes' heads, else key by key with reclaim when the
        # table is full.
        heads = self._take(cand, errors, lambda i, r: (0, 0))[0]
        got = self._resolve_batch(
            [cand[i][2].hash_key().encode() for i in heads])
        if got is not None:
            by_lane = dict(zip(heads, zip(*got)))
            take, slots, known, spill = self._take(
                cand, errors, lambda i, r: by_lane[i])
        else:
            take, slots, known, spill = self._take(
                cand, errors,
                lambda i, r: self._resolve_one(r.hash_key().encode(), now))
        if take:
            self._dispatch([cand[i] for i in take], slots, known,
                           ge[take], gd[take], out, now)
        return spill

    def _take(self, cand, errors, resolve):
        """``(take, slots, known, spill)``: each node's block takes its
        first ``max_batch`` requests that ``resolve(i, request)`` gives a
        slot; the rest (a key with slot -1, a block past ``max_batch``)
        spill to the node's next window."""
        spill: List[List[int]] = [[] for _ in range(self.n_nodes)]
        take: List[int] = []
        slots: List[int] = []
        known: List[int] = []
        col = [0] * self.n_nodes
        for i, (d, j, r) in enumerate(cand):
            if i in errors:
                continue
            slot, kn = (resolve(i, r) if col[d] < self.max_batch
                        else (-1, 0))
            if slot < 0:
                spill[d].append(j)
                continue
            take.append(i)
            slots.append(slot)
            known.append(kn)
            col[d] += 1
        return take, slots, known, spill

    def _resolve_batch(self, keys: List[bytes]):
        """``(slots, known)`` of every key in one slot-map call when the
        free slots hold every new key (each key then resolves as it would
        alone, in order), else None."""
        from gubernator_tpu_torch.ops.reqcols import pack_blob

        if not keys:
            return [], []
        blob, offsets = pack_blob(keys)
        have = self.slots.lookup_blob(blob, offsets)
        new = {k for k, s in zip(keys, have.tolist()) if s < 0}
        if len(new) > self.capacity - len(self.slots):
            return None
        slots, known = self.slots.resolve_blob(blob, offsets)
        self._last_access[slots] = self._tick_count
        self._pending.update(slots[known == 0].tolist())
        return slots.tolist(), known.tolist()

    def _resolve_one(self, key: bytes, now: int):
        """The reference's ``_resolve`` of one key: ``(slot, known)``,
        slot -1 when even a reclaim leaves no room."""
        known = int(self.slots.lookup_blob(*_one_key(key))[0]) >= 0
        slot = int(self.slots.assign_blob(*_one_key(key))[0])
        if slot < 0:
            self._reclaim(now)
            known = int(self.slots.lookup_blob(*_one_key(key))[0]) >= 0
            slot = int(self.slots.assign_blob(*_one_key(key))[0])
            if slot < 0:
                return -1, 0
        if not known:
            self._pending.add(slot)
        self._last_access[slot] = self._tick_count
        return slot, int(known)

    def _dispatch(self, packed, slots, known, ge, gd, out, now: int) -> None:
        """Pack the window's requests (``packed``: (node, index, request)
        in node order) at flattened slots, sort, tick and accumulate, and
        answer them."""
        k = len(packed)
        nodes = np.fromiter((d for d, _, _ in packed), np.int64, k)
        cols = ReqColumns.from_requests([r for _, _, r in packed])
        total = self.n_nodes * self.capacity
        m = np.zeros((REQ32_ROWS, pad_pow2(k)), np.int32)
        m[REQ32_INDEX["slot"]] = total
        flat = nodes * self.capacity + np.asarray(slots, np.int64)
        pack_cols_req32(m, cols, flat, np.asarray(known, np.int64), now,
                        slice(0, k))
        greg = np.flatnonzero(ge != 0)
        if len(greg):
            pack_wide_rows(m, "greg_exp", ge[greg], greg)
            pack_wide_rows(m, "greg_dur", gd[greg], greg)
        inv, has_dups = sort_packed_by_slot(m, k, total)
        m_dev = torch.from_numpy(m).to(self.device)
        if has_dups:
            self.metric_sorted_windows += 1
            resp = fused_sorted_tick(self.table, m_dev, now)
        else:
            self.metric_unique_windows += 1
            resp = fused_tick(self.table, m_dev, now)
        globalmesh.global_accumulate(m_dev, self.aux, self.accum,
                                     self.n_nodes, self._tick_count,
                                     bool(self.sparse_k))
        self._pending.clear()
        rm = unpack_resp_compact(resp.cpu().numpy()[:, :k][:, inv],
                                 cols.limit)
        status, limit, remaining, reset = (rm[r].tolist() for r in range(4))
        for t, (d, j, _) in enumerate(packed):
            out[d][j] = RateLimitResponse(
                status=status[t], limit=limit[t], remaining=remaining[t],
                reset_time=reset[t])

    def _reclaim(self, now: int) -> None:
        """TTL-then-LRU reclamation (``select_reclaim_victims``) over the
        replicated table.  Expiry is read from node 0's replica: right at
        reconcile boundaries, and stale (never early) between them, as the
        reference reads it."""
        mapped = self.slots.mapped_mask()
        if self._pending:
            mapped[np.fromiter(self._pending, np.int64)] = False
        cand = np.flatnonzero(mapped & (self._last_access != self._tick_count))
        dead = np.zeros(self.capacity, bool)
        dead[cand] = rowtable.dead_mask(self.table, cand, now)
        freed, victims = select_reclaim_victims(
            mapped, dead, self._last_access, self._tick_count,
            max(1, self.capacity // 16))
        self.slots.release_batch(freed)
        if len(victims) == 0:
            return
        self.slots.release_batch(victims)
        self.metric_evictions += len(victims)
        self.evict(victims)

    def evict(self, victims: np.ndarray) -> None:
        """Zero the victims' rows on every replica (one B.2 scatter a
        chunk), then their stamps and accumulators (B.8e)."""
        v = np.asarray(victims, np.int64)
        nodes = np.arange(self.n_nodes, dtype=np.int64)[:, None]
        evict_chunked(self.table, (nodes * self.capacity + v).ravel())
        vd = torch.from_numpy(v).to(self.device)
        self.aux[:, AUX["stamp"], vd] = 0
        self.accum[:, :, vd] = 0

    # ------------------------------------------------------------------
    # The reconcile (GlobalSyncWait cadence)
    # ------------------------------------------------------------------
    def reconcile(self, now: Optional[int] = None) -> None:
        """One reconcile step.  Sparse: the probe, its verdict and union
        size read back in one copy, then the apply sized by the union (none
        for an empty one), or on overflow the dense fallback on the
        untouched buffers.  Dense: one launch."""
        with self._lock:
            now = now if now is not None else timeutil.now_ms()
            n = self.n_nodes
            if self.sparse_k:
                globalmesh.global_sparse_probe(
                    self.accum, n, self.sparse_k, self._probe_out,
                    self._probe_slots, self._probe_scratch)
                self.metric_reconcile_dispatches += 1
                overflow, union = self._probe_out.tolist()  # one copy
                if overflow:
                    self.metric_dense_fallbacks += 1
                    self.metric_reconcile_dispatches += 1
                    globalmesh.global_dense_reconcile(
                        self.table, self.aux, self.accum, n, now, True)
                else:
                    globalmesh.global_sparse_apply(
                        self.table, self.aux, self.accum, n,
                        self._probe_slots, self._probe_out, union, now)
            else:
                self.metric_reconcile_dispatches += 1
                globalmesh.global_dense_reconcile(
                    self.table, self.aux, self.accum, n, now,
                    self.strict_sequencing)
            self._pending.clear()
            self._last_reconcile_ms = now
            self.metric_reconciles += 1

    def last_overflow(self) -> bool:
        """The overflow verdict of the last sparse step's probe."""
        return bool(self._probe_out[0].item())

    def pause_reconcile(self) -> None:
        """Hold the reconcile cadence (nestable); hits keep accumulating,
        so a paused cadence defers reconciliation and loses nothing."""
        with self._lock:
            self._reconcile_paused += 1

    def resume_reconcile(self) -> None:
        with self._lock:
            self._reconcile_paused = max(0, self._reconcile_paused - 1)

    def maybe_reconcile(self, now: Optional[int] = None) -> bool:
        """Reconcile unless one ran within ``min_reconcile_ms`` (every
        resident node may drive the cadence) or the cadence is paused."""
        if self._reconcile_paused:
            return False
        now = now if now is not None else timeutil.now_ms()
        if now - self._last_reconcile_ms < self.min_reconcile_ms:
            return False
        self.reconcile(now)
        return True

    def cache_size(self) -> int:
        return len(self.slots)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def peek(self, key: str) -> Optional[List[dict]]:
        """Each node's view of one key (remaining, remaining_f, status,
        in_use, limit), or None for an unknown key."""
        slot = int(self.slots.lookup_blob(*_one_key(key.encode()))[0])
        if slot < 0:
            return None
        rows = self.table[[d * self.capacity + slot
                           for d in range(self.n_nodes)]].cpu()
        cols = rows_to_logical(rows)
        return [
            {"remaining": int(cols["remaining"][d]),
             "remaining_f": float(cols["remaining_f"][d]),
             "status": int(cols["status"][d]),
             "in_use": bool(cols["in_use"][d]),
             "limit": int(cols["limit"][d])}
            for d in range(self.n_nodes)
        ]

    def state_fields(self) -> Dict[str, np.ndarray]:
        """Every logical field of every replica as an (n_nodes, capacity)
        numpy array, in the JAX package's ``np_logical`` dtypes."""
        cols = rows_to_logical(self.table[:-1].cpu())
        shape = (self.n_nodes, self.capacity)
        return {f: cols[f].numpy().astype(NP_DTYPES[f]).reshape(shape)
                for f in STATE_FIELDS}


def import_reference_state(engine: MeshGlobalEngine,
                           fields: Dict[str, np.ndarray], aux: np.ndarray,
                           accum: np.ndarray, keys: Dict[str, int],
                           tick_count: Optional[int] = None) -> None:
    """Put a reference engine's state into ``engine``: ``fields`` the
    logical fields as (n_nodes, capacity) arrays (each replica), ``aux``
    (n, 9, capacity), ``accum`` (n, 4, capacity) and ``keys`` the key →
    slot map.  ``tick_count`` (default: the largest stamp in ``aux``) is
    the engine's window count, so later windows stamp above the imported
    ones.  The slot map is rebuilt with each key at its slot; free slots
    below the highest are handed out lowest first, then those above it."""
    n, cap = engine.n_nodes, engine.capacity
    flat = {f: torch.from_numpy(np.ascontiguousarray(
        np.asarray(fields[f]).reshape(n * cap)).astype(
            np.float64 if f == "remaining_f" else np.int64))
        for f in STATE_FIELDS}
    with engine._lock:
        engine.table[:-1] = logical_to_rows(flat).to(engine.device)
        engine.table[-1] = 0
        engine.aux.copy_(torch.from_numpy(np.array(aux, np.int64)))
        engine.accum.copy_(torch.from_numpy(np.array(accum, np.int64)))
        engine.slots = _slot_map(cap, keys)
        engine._last_access[:] = 0
        engine._pending.clear()
        engine._tick_count = int(
            tick_count if tick_count is not None
            else int(np.asarray(aux)[:, AUX["stamp"]].max(initial=0)))


def _slot_map(capacity: int, keys: Dict[str, int]) -> NativeSlotMap:
    """A slot map holding ``keys`` at their slots: slots are assigned in
    order (placeholders in the gaps), then the placeholders released from
    the highest down, so the lowest gap is handed out first."""
    from gubernator_tpu_torch.ops.reqcols import pack_blob

    sm = NativeSlotMap(capacity)
    at = {int(s): k for k, s in keys.items()}
    top = max(at, default=-1)
    names = [at[s].encode() if s in at else b"\0gap%d" % s
             for s in range(top + 1)]
    got = sm.assign_blob(*pack_blob(names))
    if not np.array_equal(got, np.arange(top + 1)):
        raise ValueError("keys do not map one to one onto slots")
    gaps = np.array([s for s in range(top, -1, -1) if s not in at], np.int64)
    sm.release_batch(gaps)
    return sm


__all__ = ["MeshGlobalEngine", "import_reference_state", "AUX_ROWS", "AUX",
           "ACC_HITS", "ACC_RESET", "ACC_COUNT", "ACC_TOUCH", "ACC_ROWS",
           "DENSE_MAX_CAPACITY", "DEFAULT_SPARSE_K"]
