"""The sharded serving table on one card: the mesh engine's tick path.

Port of the TPU package's ``parallel/mesh_engine.py`` ``MeshTickEngine``
(the engine ``GUBER_TPU_MESH_SHARDS=N > 1`` selects there).  The JAX
engine shards the table over a device mesh, shard d owning global slots
``[d * L, (d + 1) * L)`` (``L = local_capacity``).  On one card the shards
are row ranges of one (n_shards * (L + 1), 16) int64 table: shard s owns
rows ``[s * (L + 1), (s + 1) * (L + 1))``, the last of them its guard row
(``raggedtick.shard_block``), so its local slot arithmetic is the
single-card engine's.

The host routes each key to shard ``crc32(key) % n_shards`` (the native
``crc32_batch``), resolves it in that shard's own slot map, packs ONE
slot-sorted (19, B) REQ32 matrix of GLOBAL slots and derives the
per-shard extents ``[offsets[s], offsets[s + 1])`` from the resolve's
counts (parallel/partition.py).  A window whose slots are unique is one
``fused_ragged_tick`` launch (kernel B.4) over every extent; the JAX
engine's ``shard_map`` + ``psum`` becomes that one launch, because the
extents are disjoint.  A window whose slots repeat walks each shard's
extent in tiles through the x64 tile tick of the JAX engine's duplicate
program; on the card that walk is one ``mesh_tile_tick`` launch (kernel
B.6, ops/tiletick.py), whose plain version is the walk itself
(``raggedtick.ragged_walk`` over ``tick.merge_tick``).  Skewed windows
(every key on one shard) take the same paths: one extent covers the batch.

Reclaim is per shard, as in the JAX engine: a full shard frees its
TTL-dead slots, else evicts its least recently used ones, through the
gather and scatter kernels on the shard's block.

State moves as in the JAX engine's state paths: a write/read-through
``Store`` (misses read through ``Store.get`` before the tick, each touched
slot's state goes to ``Store.on_change`` or ``Store.remove`` at resolve),
owner-pushed GLOBAL installs (``install_globals``) and Loader items
(``export_items`` / ``load_items``).  Global slot ``g`` is flat row
``g + g // L`` (shard ``g // L``'s local slot ``g % L``), so every
shard's rows move in ONE gather or scatter launch per ``STATE_CHUNK``
rows, where the JAX engine runs a blocked program per shard; no lane is
ever aimed at a shard's guard row.

Live resharding (:meth:`MeshTickEngine.reshard`, driven by
``parallel/reshard.py``) re-lays the live table over another shard count
under the engine lock: the live rows leave through the gather kernel a
STATE_CHUNK a launch and their keys through the slot maps, a new
``(n_to * (cap_to + 1), 16)`` table with its own slot maps, reclaim
stamps, extents and staging ring is built beside the old one
(``partition.plan_transition`` sizes it), and the cutover swaps every
layout field at once and places the rows as ``load_items`` would place
their items, through one scatter a STATE_CHUNK.  The old table lives
until the cutover commits; any failure restores the old fields.

Not ported, as in the JAX mesh: the cold and SSD tiers and the columnar
snapshot (``export_columns`` / ``load_columns``).  Not ported yet:
placement of shards on several cards.
"""

from __future__ import annotations

import threading
import warnings
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch import DeviceLike, resolve_device
from gubernator_tpu_torch.native import NativeSlotMap, crc32_batch
from gubernator_tpu_torch.ops import rowtable, tick
from gubernator_tpu_torch.ops.buckets import ROW_W, WORD
from gubernator_tpu_torch.ops.engine import (
    BatchFront, StagingRing, TickHandle, evict_chunked, gather_chunked,
    install_rows, masked_over_limit, pack_cols_req32, pack_wide_rows,
    scatter_chunked, select_reclaim_victims, sort_packed_by_slot, store_rows)
from gubernator_tpu_torch.ops.fusedtick import REQ32_ROWS
from gubernator_tpu_torch.ops.raggedtick import (
    choose_tile, fused_ragged_tick, shard_block)
from gubernator_tpu_torch.ops.reqcols import (
    ReqColumns, compact_blob, key_groups, pack_blob)
from gubernator_tpu_torch.ops.snapshot import (
    columns_from_rows, item_rows, items_from_columns, rows_from_items)
from gubernator_tpu_torch.ops.tiletick import mesh_tile_tick
from gubernator_tpu_torch.parallel.partition import (
    LayoutTransition, RaggedExtents, plan_transition)
from gubernator_tpu_torch.types import Behavior, GlobalUpdate
from gubernator_tpu_torch.utils import timeutil

_LOCAL_WIDTH_WARNED = False


def _warn_local_width_deprecated() -> None:
    """One warning per process for the dead ``local_width`` knob: the
    ragged extent walk has no per-shard width to bound."""
    global _LOCAL_WIDTH_WARNED
    if _LOCAL_WIDTH_WARNED:
        return
    _LOCAL_WIDTH_WARNED = True
    warnings.warn(
        "MeshTickEngine(local_width=...) is deprecated and ignored: the "
        "ragged tick dispatch walks each shard's extent directly and has "
        "no per-shard width limit",
        DeprecationWarning,
        stacklevel=3,
    )


class MeshRaggedTickHandle(TickHandle):
    """One dispatched mesh window.  Its flat (6, B) compact response is in
    slot-sorted lane order, as a single-card window's, so it resolves
    through ``ops.engine.resolve_ticks``; resolving also retires the
    window from the engine's in-flight count and, with a Store, runs the
    write-through (its request-order slots are global slots)."""

    __slots__ = ()


class MeshTickEngine(BatchFront):
    """The sharded table on one card, served window by window.

    The single-card ``TickEngine``'s contract over ``n_shards *
    local_capacity`` slots: global slot g lives on shard
    ``g // local_capacity``, which is the shard its key routes to.
    Thread-safe: one lock covers routing, resolution, packing and
    dispatch.  ``store``: a write/read-through Store (store.py)."""

    def __init__(
        self,
        n_shards: int = 8,
        local_capacity: int = 1 << 14,
        max_batch: int = 1024,
        device: DeviceLike = None,
        store=None,
        routing: str = "auto",
        local_width: int = 0,
    ):
        self.store = store
        self.n_shards = int(n_shards)
        self.local_capacity = int(local_capacity)
        if self.n_shards < 1 or self.local_capacity < 1:
            raise ValueError("n_shards and local_capacity must be positive")
        self.capacity = self.n_shards * self.local_capacity
        if self.capacity >= (1 << 31):
            # The flat wire format carries GLOBAL slots in an int32 row.
            raise ValueError(
                f"sharded table capacity {self.capacity} exceeds int32 "
                "global slots")
        self.max_batch = int(max_batch)
        if routing not in ("auto", "device"):
            raise ValueError(
                f"unknown mesh routing {routing!r} (the legacy 'host' "
                "blocked path was removed; the ragged device dispatch "
                "serves every window)")
        if int(local_width):
            _warn_local_width_deprecated()
        self.device = resolve_device(device)
        self.ragged = RaggedExtents(self.n_shards, self.local_capacity)
        self.table = torch.zeros(
            (self.n_shards * (self.local_capacity + 1), ROW_W),
            dtype=torch.int64, device=self.device)
        self.slots = [NativeSlotMap(self.local_capacity)
                      for _ in range(self.n_shards)]
        self._last_access = np.zeros(self.capacity, np.int64)
        # Global slots assigned on the host but not yet written by a tick:
        # their rows still look dead, so reclaim must skip them.
        self._pending: set = set()
        self._tick_count = 0
        self._lock = threading.RLock()
        # One slab width (max_batch); the sentinel is the GLOBAL capacity,
        # so padding lanes sort past every extent.
        self._staging = StagingRing(
            REQ32_ROWS, self.capacity, depth=9,
            pinned=self.device.type == "cuda")
        self._inflight = 0
        self.metric_h2d_windows = 0
        self.metric_h2d_overlapped = 0
        self.metric_routed_windows = 0
        # Pinned at 0: the ragged walk has no per-shard width to overflow.
        self.metric_routed_overflows = 0
        self.metric_hits = 0
        self.metric_misses = 0
        self.metric_over_limit = 0
        self.metric_unexpired_evictions = 0
        # Rank rounds of duplicate windows (ops/tiletick.py), counted on
        # the table's device.  On a card, each duplicate window queues a
        # copy of the counter into a pinned host tensor behind its launch,
        # so reading the metric never waits for the card.
        self._rank_rounds = torch.zeros(1, dtype=torch.int64,
                                        device=self.device)
        self._rank_rounds_host = self._rank_rounds
        if self.device.type == "cuda":
            self._rank_rounds_host = torch.zeros(1, dtype=torch.int64,
                                                 pin_memory=True)

    @property
    def metric_rank_rounds(self) -> int:
        """Rank rounds the duplicate windows' tile walk ran (for each
        chunk, the most followers of one slot that did not fold), up to
        the last duplicate window the card has finished: exact once its
        windows are resolved.  Reading it never waits for the card."""
        return int(self._rank_rounds_host[0])

    def h2d_overlap_ratio(self) -> float:
        """Fraction of windows whose request upload was queued while an
        earlier window was still unresolved."""
        return self.metric_h2d_overlapped / max(1, self.metric_h2d_windows)

    def cache_size(self) -> int:
        return sum(len(sm) for sm in self.slots)

    # ------------------------------------------------------------------
    # Reclaim, per shard
    # ------------------------------------------------------------------
    def _shard_dead_mask(self, shard: int, now: int,
                         local: np.ndarray) -> np.ndarray:
        """Dead mask (unused or TTL-expired) over some of one shard's
        local slots, read through the gather kernel on the shard's
        block."""
        return rowtable.dead_mask(
            shard_block(self.table, shard, self.local_capacity), local, now)

    def _reclaim(self, shard: int, now: int) -> None:
        """Free one shard's TTL-dead slots; fall back to LRU eviction of a
        sixteenth of the shard (the JAX engine's policy,
        ``select_reclaim_victims``).  Only mapped slots not touched this
        tick can be victims, so only their rows are read."""
        sm = self.slots[shard]
        lo = shard * self.local_capacity
        mapped = sm.mapped_mask()
        pend = [g - lo for g in self._pending
                if lo <= g < lo + self.local_capacity]
        if pend:
            mapped[np.asarray(pend, np.int64)] = False
        last = self._last_access[lo:lo + self.local_capacity]
        cand = np.flatnonzero(mapped & (last != self._tick_count))
        dead = np.zeros(self.local_capacity, bool)
        dead[cand] = self._shard_dead_mask(shard, now, cand)
        freed, victims = select_reclaim_victims(
            mapped, dead, last, self._tick_count,
            max(1, self.local_capacity // 16))
        sm.release_batch(freed)
        if len(victims) == 0:
            return
        self.metric_unexpired_evictions += len(victims)
        sm.release_batch(victims)
        self._evict_local(shard, victims)

    def _evict_local(self, shard: int, victims: np.ndarray) -> None:
        """Zero one shard's victim rows through the scatter kernel."""
        evict_chunked(shard_block(self.table, shard, self.local_capacity),
                      victims)

    # ------------------------------------------------------------------
    # Host preparation
    # ------------------------------------------------------------------
    def _gregorian_cols(self, cols: ReqColumns, now: int,
                        errors: Dict[int, str]):
        """Gregorian expiration and duration of the flagged rows, once per
        distinct selector; failures become per-item errors."""
        n = len(cols)
        greg_e = np.zeros(n, np.int64)
        greg_d = np.zeros(n, np.int64)
        greg = np.flatnonzero(
            cols.behavior & int(Behavior.DURATION_IS_GREGORIAN))
        sel_d = cols.duration[greg]
        for d in np.unique(sel_d):
            lanes = greg[sel_d == d]
            try:
                greg_e[lanes] = timeutil.gregorian_expiration(now, int(d))
                greg_d[lanes] = timeutil.gregorian_duration(now, int(d))
            except timeutil.GregorianError as exc:
                errors.update((int(i), str(exc)) for i in lanes)
        return greg_e, greg_d

    def _resolve_columns(self, cols: ReqColumns, now: int,
                         errors: Dict[int, str]):
        """Route every key to its shard (one native CRC-32 batch), regroup
        the key blob by shard, and resolve each shard's keys in its slot
        map with one native call, reclaiming a full shard once.  Keys
        whose shard stays full become per-item errors.  Returns
        ``(sh, slots, known)`` (local slots, -1 where unresolved) with the
        resolved rows stamped live."""
        n = len(cols)
        sh = (crc32_batch(cols.key_blob, cols.key_offsets)
              % np.uint32(self.n_shards)).astype(np.int64)
        order = np.argsort(sh, kind="stable")
        starts = np.searchsorted(sh[order], np.arange(self.n_shards + 1))
        # One byte gather regroups the key blob by shard.
        grouped, g_off = compact_blob(cols.key_blob, cols.key_offsets, order)
        slots = np.full(n, -1, np.int64)
        known = np.zeros(n, np.uint8)
        for s in range(self.n_shards):
            a, z = int(starts[s]), int(starts[s + 1])
            if a == z:
                continue
            rows_s = order[a:z]
            sm = self.slots[s]
            sl, kn = sm.resolve_blob(grouped[g_off[a]:g_off[z]],
                                     g_off[a:z + 1] - g_off[a])
            if (sl < 0).any():
                # Stamp the rows already resolved live before reclaiming,
                # so the reclaim cannot hand their slots to the retries.
                okm = sl >= 0
                g = s * self.local_capacity + sl[okm]
                self._last_access[g] = self._tick_count
                self._pending.update(g[kn[okm] == 0].tolist())
                self._reclaim(s, now)
                retry = np.flatnonzero(sl < 0)
                sl[retry], kn[retry] = sm.resolve_blob(*compact_blob(
                    cols.key_blob, cols.key_offsets, rows_s[retry]))
                for t in np.flatnonzero(sl < 0):
                    errors[int(rows_s[t])] = (
                        "rate-limit shard full; eviction failed")
            slots[rows_s] = sl
            known[rows_s] = kn
        resolved = slots >= 0
        g_res = sh[resolved] * self.local_capacity + slots[resolved]
        self._last_access[g_res] = self._tick_count
        self._pending.update(g_res[known[resolved] == 0].tolist())
        return sh, slots, known

    def _account_misses(self, cols: ReqColumns, sh: np.ndarray,
                        slots: np.ndarray, known: np.ndarray) -> None:
        """Hit and miss counts of one resolved batch, and the Store's
        read-through of its misses (``known`` is set in place for the rows
        it restores).  With a Store, a slot still pending (assigned, never
        written by a tick) counts as a miss, as in the JAX engine."""
        resolved = slots >= 0
        miss = resolved & (known == 0)
        if self.store is not None and self._pending:
            pend = np.fromiter(self._pending, np.int64, len(self._pending))
            miss |= resolved & np.isin(
                sh * self.local_capacity + np.maximum(slots, 0), pend)
        n_miss = int(miss.sum())
        self.metric_hits += int(resolved.sum()) - n_miss
        self.metric_misses += n_miss
        if self.store is not None and n_miss:
            if cols.refs is None:
                raise ValueError(
                    "Store read-through needs request objects; build "
                    "the batch with ReqColumns.from_requests(..., "
                    "keep_refs=True)")
            self._read_through(cols.refs, sh, slots, known,
                               np.flatnonzero(miss))

    def _account_resolved(self, resp_mat: np.ndarray, errors) -> None:
        """Bookkeeping of a resolved window (the caller holds the lock)."""
        self._inflight = max(0, self._inflight - 1)
        self.metric_over_limit += masked_over_limit(resp_mat, errors)

    # ------------------------------------------------------------------
    # The tick
    # ------------------------------------------------------------------
    def submit_columns(self, cols: ReqColumns,
                       now: Optional[int] = None) -> MeshRaggedTickHandle:
        """Build and dispatch one mesh window (≤ max_batch rows); returns
        a handle whose ``result()`` waits for the device.  The upload is
        asynchronous, so packing the next window overlaps this one's
        kernel."""
        n = len(cols)
        if n > self.max_batch:
            raise ValueError(
                f"batch of {n} exceeds engine max {self.max_batch}")
        with self._lock:
            now = now if now is not None else timeutil.now_ms()
            self._tick_count += 1
            errors: Dict[int, str] = {}
            greg_e, greg_d = self._gregorian_cols(cols, now, errors)
            sh, slots, known = self._resolve_columns(cols, now, errors)
            self._account_misses(cols, sh, slots, known)
            ok = slots >= 0
            ok[list(errors)] = False
            handle = self._dispatch_ragged(cols, now, sh, slots, known, ok,
                                           greg_e, greg_d, errors)
            if self.store is not None:
                # The write-through gather must see exactly this window's
                # state.
                handle.result()
            return handle

    def _dispatch_ragged(self, cols, now, sh, slots, known, ok, greg_e,
                         greg_d, errors) -> MeshRaggedTickHandle:
        """Pack ONE slot-sorted (19, B) matrix of global slots into a
        leased staging slab, derive the extent offsets from the per-shard
        counts, and tick: one ``fused_ragged_tick`` launch when the slots
        are unique, else the tile walk of each shard's extent."""
        n = len(cols)
        slab = self._staging.lease(self.max_batch)
        m = slab.numpy()
        ix = np.flatnonzero(ok)
        gslot = sh[ix] * self.local_capacity + slots[ix]
        pack_cols_req32(m, cols, gslot, known[ix], now, ix)
        pack_wide_rows(m, "greg_exp", greg_e[ix], ix)
        pack_wide_rows(m, "greg_dur", greg_d[ix], ix)
        inv, has_dups = sort_packed_by_slot(m, n, self.capacity)
        offs = self.ragged.offsets(self.ragged.counts(sh, ok))
        dev_m, dev_offs = slab, torch.from_numpy(offs)
        if self.device.type == "cuda":
            dev_m = slab.to(self.device, non_blocking=True)
            (dev_offs,) = tick.upload(self.device, offs)
        if has_dups:
            resp = mesh_tile_tick(
                self.table, dev_m, dev_offs, self.n_shards,
                self.local_capacity, choose_tile(m.shape[1], self.n_shards),
                now, self._rank_rounds)
            if self._rank_rounds_host is not self._rank_rounds:
                self._rank_rounds_host.copy_(self._rank_rounds,
                                             non_blocking=True)
        else:
            resp = fused_ragged_tick(self.table, dev_m, dev_offs,
                                     self.n_shards, self.local_capacity, now)
        self._pending.clear()
        self.metric_routed_windows += 1
        gslots = None
        if self.store is not None:
            gslots = np.where(ok, sh * self.local_capacity + slots, -1)
        handle = MeshRaggedTickHandle(self, resp, n, inv, errors, cols.limit,
                                      cols.refs, gslots)
        self.metric_h2d_windows += 1
        if self._inflight > 0:
            self.metric_h2d_overlapped += 1
        self._inflight += 1
        self._staging.retire(handle)
        return handle

    # ------------------------------------------------------------------
    # State paths: all shards' rows in one launch per STATE_CHUNK
    # ------------------------------------------------------------------
    def _flat(self, g: np.ndarray) -> np.ndarray:
        """Flat table rows of global slots: shard ``g // L``'s local slot
        ``g % L`` is row ``(g // L) * (L + 1) + g % L``, never a guard
        row."""
        g = np.asarray(g, np.int64)
        return g + g // self.local_capacity

    def _read_through(self, requests, sh: np.ndarray, slots: np.ndarray,
                      known: np.ndarray, miss: np.ndarray) -> None:
        """``Store.get`` for the window's misses (algorithms.go:45-51), in
        request order, once a slot: the items found land through one
        scatter before the tick, and their requests tick as known
        slots."""
        restored: Dict[int, dict] = {}
        for j in miss.tolist():
            g = int(sh[j]) * self.local_capacity + int(slots[j])
            if g in restored:
                known[j] = 1
                continue
            item = self.store.get(requests[j])
            if item is None:
                continue
            restored[g] = item
            known[j] = 1
            self._pending.discard(g)
        if restored:
            scatter_chunked(
                self.table,
                self._flat(np.fromiter(restored, np.int64, len(restored))),
                rows_from_items(list(restored.values())))

    def _write_through(self, requests, gslots: np.ndarray, n: int,
                       errors: Dict[int, str]) -> None:
        """``Store.on_change`` with each touched slot's state after the
        tick (algorithms.go:149-153), once a slot; a slot the tick cleared
        (RESET_REMAINING) maps to ``Store.remove`` (algorithms.go:78-90).
        The calls go shard by shard, shards in the order the window first
        touches them and slots in request order within each, as the JAX
        engine's blocked readback yields them.  The rows come through one
        gather.  ``gslots`` is in request order, -1 on lanes that did not
        tick."""
        lanes = np.flatnonzero(gslots >= 0)
        if len(lanes) == 0:
            return
        _, first = np.unique(gslots[lanes], return_index=True)
        lanes = lanes[np.sort(first)]
        shard = gslots[lanes] // self.local_capacity
        _, s_first, s_inv = np.unique(shard, return_index=True,
                                      return_inverse=True)
        s_rank = np.argsort(np.argsort(s_first))
        lanes = lanes[np.argsort(s_rank[s_inv], kind="stable")]
        g = gslots[lanes]
        shard = g // self.local_capacity
        keys: List[bytes] = [b""] * len(lanes)
        for s in np.unique(shard).tolist():
            at = np.flatnonzero(shard == s)
            for k, key in zip(at.tolist(), self.slots[s].keys_batch(
                    g[at] - s * self.local_capacity)):
                keys[k] = key
        store_rows(self.store, requests, lanes, keys,
                   gather_chunked(self.table, self._flat(g)))

    def _install_slots(self, keys: List[bytes], now: int) -> np.ndarray:
        """Global slots for installed keys, -1 where the key's shard stays
        full, stamped with this tick.  A shard with room for every new key
        resolves them in one native call; a shard without takes them one
        at a time, reclaiming before each key that does not fit, as the
        JAX engine's per-key resolve does."""
        blob, offsets = pack_blob(keys)
        sh = (crc32_batch(blob, offsets)
              % np.uint32(self.n_shards)).astype(np.int64)
        out = np.full(len(keys), -1, np.int64)
        for s in np.unique(sh).tolist():
            at = np.flatnonzero(sh == s)
            sm, lo = self.slots[s], s * self.local_capacity
            sub = compact_blob(blob, offsets, at)
            new = {keys[i] for i, sl in zip(at.tolist(), sm.lookup_blob(*sub))
                   if sl < 0}
            if len(sm) + len(new) <= self.local_capacity:
                out[at] = lo + sm.resolve_blob(*sub)[0]
            else:
                for i in at.tolist():
                    sl = int(sm.resolve_batch([keys[i]])[0][0])
                    if sl < 0:
                        self._reclaim(s, now)
                        sl = int(sm.resolve_batch([keys[i]])[0][0])
                        if sl < 0:
                            continue
                    out[i] = lo + sl
                    self._last_access[lo + sl] = self._tick_count
                    self._pending.discard(lo + sl)
        got = out[out >= 0]
        self._last_access[got] = self._tick_count
        self._pending.difference_update(got.tolist())
        return out

    def install_globals(self, updates: Sequence[GlobalUpdate],
                        now: Optional[int] = None) -> None:
        """Install owner-pushed GLOBAL state as whole rows
        (``ops.engine.install_rows``), every shard's in one scatter a
        STATE_CHUNK.  The last update of a key wins; a key whose shard
        cannot place it is dropped (the next push retries)."""
        if not updates:
            return
        with self._lock:
            now = now if now is not None else timeutil.now_ms()
            # A new logical tick: the previous tick's slots must not stay
            # protected from reclaim.
            self._tick_count += 1
            g = self._install_slots([u.key.encode() for u in updates], now)
            by_slot: Dict[int, GlobalUpdate] = {}
            for u, s in zip(updates, g.tolist()):
                if s >= 0:
                    by_slot[s] = u
            if not by_slot:
                return
            tgt = np.fromiter(by_slot, np.int64, len(by_slot))
            scatter_chunked(self.table, self._flat(tgt),
                            install_rows(list(by_slot.values()), now))

    def export_items(self) -> List[dict]:
        """The live state as Loader-contract item dicts, in global slot
        order: every shard's mapped rows cross to the host through the
        gather kernel, STATE_CHUNK rows a launch, and rows not in use are
        dropped."""
        with self._lock:
            g = np.flatnonzero(np.concatenate(
                [sm.mapped_mask() for sm in self.slots]))
            rows = gather_chunked(self.table, self._flat(g))
            alive = rows[:, WORD["in_use"]] != 0
            g, rows = g[alive], rows[alive]
            owner = g // self.local_capacity
            keys: List[bytes] = []
            for s in range(self.n_shards):
                sel = g[owner == s] - s * self.local_capacity
                if len(sel):
                    keys.extend(self.slots[s].keys_batch(sel))
            return items_from_columns(keys, columns_from_rows(rows),
                                      np.arange(len(g)))

    def load_items(self, items: Sequence[dict],
                   now: Optional[int] = None) -> None:
        """Load Loader-contract item dicts: items expired by ``now`` are
        dropped, a key that repeats keeps its last item (in its first
        item's place), and the rows are placed by :meth:`_place_rows`."""
        with self._lock:
            now = now if now is not None else timeutil.now_ms()
            self._tick_count += 1  # as install_globals: unblock reclaim
            live = list({it["key"]: it for it in items
                         if it["expire_at"] >= now}.values())
            if not live:
                return
            blob, offsets = pack_blob([it["key"].encode() for it in live])
            self._place_rows(blob, offsets, rows_from_items(live), now)

    def _place_rows(self, blob: bytes, offsets: np.ndarray, rows: np.ndarray,
                    now: int, crc: Optional[np.ndarray] = None) -> None:
        """Place distinct keys with their rows: each key routes to shard
        ``crc32 % n_shards`` (``crc``, when given, is the keys' CRC-32),
        each shard assigns its keys in key order in one native call (a
        full shard stamps what it placed, reclaims once and retries the
        rest; what still does not fit is dropped), and the rows land in one
        scatter a STATE_CHUNK.  The caller holds the lock and has stamped
        the tick."""
        if crc is None:
            crc = crc32_batch(blob, offsets)
        sh = (crc % np.uint32(self.n_shards)).astype(np.int64)
        # A stable sort of 16-bit keys is a radix sort.
        order = np.argsort(sh.astype(np.int16) if self.n_shards < 1 << 15
                           else sh, kind="stable")
        starts = np.searchsorted(sh[order], np.arange(self.n_shards + 1))
        # One byte gather regroups the key blob by shard.
        grouped, g_off = compact_blob(blob, offsets, order)
        local = np.full(len(sh), -1, np.int64)
        for s in range(self.n_shards):
            a, z = int(starts[s]), int(starts[s + 1])
            if a == z:
                continue
            at = order[a:z]
            sm, lo = self.slots[s], s * self.local_capacity
            ls = sm.assign_blob(grouped[g_off[a]:g_off[z]],
                                g_off[a:z + 1] - g_off[a])
            if (ls < 0).any():
                # Stamp the rows just placed first: their device rows are
                # stale until the scatter, and an unstamped reclaim would
                # hand their slots to the retried keys.
                got = lo + ls[ls >= 0]
                self._last_access[got] = self._tick_count
                self._pending.update(got.tolist())
                self._reclaim(s, now)
                retry = np.flatnonzero(ls < 0)
                ls[retry] = sm.assign_blob(
                    *compact_blob(blob, offsets, at[retry]))
            local[at] = ls
        ok = np.flatnonzero(local >= 0)
        g = sh[ok] * self.local_capacity + local[ok]
        self._last_access[g] = self._tick_count
        scatter_chunked(self.table, self._flat(g), rows[ok])

    # ------------------------------------------------------------------
    # Live resharding
    # ------------------------------------------------------------------
    def _mapped_census(self):
        """Every mapped slot as columns, in global slot order: the global
        slots, their keys as one (blob, offsets) pack (from the slot maps,
        one native call a shard)."""
        g = np.flatnonzero(np.concatenate(
            [sm.mapped_mask() for sm in self.slots]))
        owner = g // self.local_capacity
        blobs, offs, base = [], [np.zeros(1, np.int64)], 0
        for s in range(self.n_shards):
            sel = g[owner == s] - s * self.local_capacity
            if len(sel):
                blob, off = self.slots[s].keys_blob(sel)
                blobs.append(blob)
                offs.append(off[1:] + base)
                base += len(blob)
        return g, b"".join(blobs), np.concatenate(offs)

    def census(self) -> dict:
        """The key census of a reshard's verify phase, as columns: every
        mapped slot's key (``blob``, ``offsets``), shard and whether its
        row is in use (the rows through the gather kernel, a STATE_CHUNK a
        launch), and the shard count."""
        with self._lock:
            g, blob, offsets = self._mapped_census()
            rows = gather_chunked(self.table, self._flat(g))
            return {"blob": blob, "offsets": offsets,
                    "shard": g // self.local_capacity,
                    "live": rows[:, WORD["in_use"]] != 0,
                    "n_shards": self.n_shards}

    def _transition_columns(self):
        """The host half of a transition: the live rows (mapped and in
        use) through the gather kernel and their keys from the slot maps,
        in global slot order.  Returns ``(blob, offsets, rows, shard)``,
        ``shard`` each row's shard."""
        g, blob, offsets = self._mapped_census()
        rows = gather_chunked(self.table, self._flat(g))
        alive = rows[:, WORD["in_use"]] != 0
        if not alive.all():
            blob, offsets = compact_blob(blob, offsets, alive)
            rows, g = rows[alive], g[alive]
        return blob, offsets, rows, g // self.local_capacity

    def _build_shard_set(self, tr: LayoutTransition) -> SimpleNamespace:
        """Everything the new layout needs, built beside the old one (which
        keeps serving until the cutover): the zeroed table on the same
        card, slot maps, reclaim stamps, extents and a staging ring whose
        sentinel is the new global capacity."""
        return SimpleNamespace(
            n_shards=tr.n_to, local_capacity=tr.cap_to,
            capacity=tr.capacity_to,
            ragged=RaggedExtents(tr.n_to, tr.cap_to),
            table=torch.zeros((tr.n_to * (tr.cap_to + 1), ROW_W),
                              dtype=torch.int64, device=self.device),
            slots=[NativeSlotMap(tr.cap_to) for _ in range(tr.n_to)],
            last_access=np.zeros(tr.capacity_to, np.int64),
            staging=StagingRing(REQ32_ROWS, tr.capacity_to, depth=9,
                                pinned=self.device.type == "cuda"),
        )

    _LAYOUT = ("n_shards", "local_capacity", "capacity", "ragged", "table",
               "slots", "_last_access", "_staging", "_pending", "_inflight")

    def _cutover(self, new: SimpleNamespace, moved: tuple,
                 now: Optional[int]) -> None:
        """Swap every layout field to ``new`` at once and place the moved
        rows as ``load_items`` would place their items: expired rows
        (``expire_at < now``) dropped, a repeated key's last row in its
        first row's place, keys routed to ``crc32 % n_to``, rows as their
        items load (``snapshot.item_rows``).  Any failure restores the
        saved fields (the old table was never written) and raises."""
        saved = tuple(getattr(self, f) for f in self._LAYOUT)
        n_from = self.n_shards
        self.n_shards = new.n_shards
        self.local_capacity = new.local_capacity
        self.capacity = new.capacity
        self.ragged = new.ragged
        self.table = new.table
        self.slots = new.slots
        self._last_access = new.last_access
        self._staging = new.staging
        self._pending = set()
        self._inflight = 0
        try:
            self._load_moved(*moved, n_from, now)
        except Exception:
            for f, v in zip(self._LAYOUT, saved):
                setattr(self, f, v)
            raise

    def _load_moved(self, blob: bytes, offsets: np.ndarray, rows: np.ndarray,
                    shard: np.ndarray, n_from: int,
                    now: Optional[int]) -> None:
        """``load_items`` of the moved rows, as columns (``shard``: each
        row's shard in the old layout of ``n_from`` shards)."""
        now = now if now is not None else timeutil.now_ms()
        self._tick_count += 1
        keep = rows[:, WORD["expire_at"]] >= now
        if not keep.all():
            blob, offsets = compact_blob(blob, offsets, keep)
            rows, shard = rows[keep], shard[keep]
        if len(rows) == 0:
            return
        crc = crc32_batch(blob, offsets)
        # A key held on two shards is held off its old route on one, so
        # keys can repeat only when some row sat off its route.
        if (crc % np.uint32(n_from) != shard).any():
            gid = key_groups(blob, offsets, crc)
            _, first = np.unique(gid, return_index=True)
            if len(first) < len(gid):
                # A repeated key keeps its last row in its first's place.
                _, rfirst = np.unique(gid[::-1], return_index=True)
                order = np.argsort(first)
                first = first[order]
                rows = rows[(len(gid) - 1 - rfirst)[order]]
                blob, offsets = compact_blob(blob, offsets, first)
                crc = crc[first]
        self._place_rows(blob, offsets, item_rows(rows), now, crc)

    def _same_card(self, d) -> bool:
        d = torch.device(d)
        return d.type == self.device.type and (
            (d.index or 0) == (self.device.index or 0))

    def reshard(self, new_shards: int, devices=None,
                now: Optional[int] = None) -> dict:
        """Re-lay the live table over ``new_shards`` shards on this engine's
        card, in place, under the engine lock (callers quiesce the tick
        pipeline first, as the reshard coordinator does; a window that
        arrives meanwhile serializes behind the lock).  ``devices`` other
        than the engine's card raise: shards on several cards are not
        ported.  Returns a summary dict; raises, with the old layout and
        table untouched, on any failure."""
        new_n = int(new_shards)
        if new_n < 1:
            raise ValueError(f"new_shards must be >= 1; got {new_n}")
        if devices is not None:
            other = [str(d) for d in devices if not self._same_card(d)]
            if other:
                raise ValueError(
                    f"reshard onto {other}: the shards live on the "
                    f"engine's card ({self.device}); placing them on "
                    "several cards is not ported")
        with self._lock:
            if new_n == self.n_shards:
                return {"from_shards": self.n_shards, "to_shards": new_n,
                        "live_items": 0, "noop": True}
            tr = plan_transition(self.n_shards, self.local_capacity, new_n)
            if tr.capacity_to >= (1 << 31):
                raise ValueError(
                    f"resharded capacity {tr.capacity_to} exceeds int32 "
                    "global slots")
            moved = self._transition_columns()
            new = self._build_shard_set(tr)
            self._cutover(new, moved, now)
            return {"from_shards": tr.n_from, "to_shards": tr.n_to,
                    "cap_from": tr.cap_from, "cap_to": tr.cap_to,
                    "live_items": int(len(moved[2])), "noop": False}

    def routing_parity_errors(self, keys: Sequence[str]) -> int:
        """Keys whose routing disagrees with residency: a key must be
        mapped on exactly one shard, the one its CRC-32 routes it to (a
        key on two shards is a double serve, on none a drop).  The JAX
        engine's audit, over the key batch in one native lookup a
        shard."""
        blob, offsets = pack_blob([k.encode() for k in keys])
        with self._lock:
            route = (crc32_batch(blob, offsets)
                     % np.uint32(self.n_shards)).astype(np.int64)
            owners = np.zeros(len(keys), np.int64)
            on_route = np.zeros(len(keys), bool)
            for d in range(self.n_shards):
                present = self.slots[d].lookup_blob(blob, offsets) >= 0
                owners += present
                on_route |= present & (route == d)
        return int(((owners != 1) | ~on_route).sum())
