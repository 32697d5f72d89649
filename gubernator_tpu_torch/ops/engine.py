"""Tick-batched rate-limit engine on one CUDA device.

Port of the TPU package's ``ops/engine.py`` main path.  The whole bucket
table is one device-resident (capacity + 1, 16) int64 tensor (see
ops/buckets.py), and a *tick* applies a window of requests in place:

    host: resolve keys → slots (native slot map), pack the (19, B) int32
          REQ32 matrix, sort it by slot
    device: fused tick kernel (gather row → transition → scatter row →
          compact (6, B) response)
    host: un-permute, rebuild the public (5, n) int64 response matrix

Windows whose slots repeat take the grouped plan (one merged tick kernel
launch that folds each key's identical duplicates in closed form), else
the layered plan (one merged launch per unit layer), else the chained
duplicate tick (ops/sortedtick.py: one launch that applies each key's
requests in window order); each keeps the reference's sequential per-key
semantics.  The host owns the key→slot map, stamps time, resolves
Gregorian calendar math and reclaims slots (TTL first, then LRU),
synchronously when a window does not fit.

State moves in and out through the row kernels: columnar snapshots
(``export_columns`` / ``load_columns``, their item-dict forms, a dirty set
for deltas), owner-pushed GLOBAL installs, and the quota-lease columns
(``lease_window``), three device columns beside the table.

The tiers, also through the row kernels: a write/read-through ``Store``
(store.py: one gather of a window's touched slots feeds ``on_change``,
misses read through ``Store.get`` into one scatter), a host cold tier
and an SSD slab tier below it (tiering/: LRU victims are gathered before
the evict scatter and demoted, misses promote back in one scatter a
window), and reclaim on a background thread (``bg_reclaim``, on by
default at capacity >= 2^18).  persistence/ drains ``export_columns``
to disk.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch import DeviceLike, resolve_device
from gubernator_tpu_torch.native import NativeSlotMap
from gubernator_tpu_torch.ops.buckets import WORD, zeros_table
from gubernator_tpu_torch.ops import leasecols, rowtable, tick
from gubernator_tpu_torch.ops.fusedtick import (  # noqa: F401
    REQ32_INDEX, REQ32_ROWS, REQ32_WIDE, fused_tick)
from gubernator_tpu_torch.ops.reqcols import (
    CREATED_UNSET, ReqColumns, compact_blob, pack_blob)
from gubernator_tpu_torch.ops.snapshot import (
    ITEM_FIELDS, LEASE_SNAP_FIELDS, SNAP_FIELDS, ZOO_SNAP_FIELDS,
    columns_from_rows, empty_snapshot, items_from_snapshot,
    rows_from_columns, rows_from_items, snapshot_from_items)
from gubernator_tpu_torch.ops.sortedtick import (
    fused_sorted_tick, fused_sorted_tick_plain)
from gubernator_tpu_torch.tiering.coldstore import ColdStore
from gubernator_tpu_torch.types import (
    Algorithm, Behavior, GlobalUpdate, RateLimitRequest, RateLimitResponse)
from gubernator_tpu_torch.utils import flightrec, timeutil


def pad_pow2(n: int) -> int:
    """Next power of two ≥ n."""
    return 1 << max(0, (int(n) - 1)).bit_length()


def split_i64(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 → (lo, hi) int32 pair, the wire format's wide encoding."""
    return (
        (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
        (v >> 32).astype(np.int32),
    )


def pack_wide_rows(m32: np.ndarray, name: str, values, ix) -> None:
    """Write an int64 column as its (lo, hi) int32 row pair."""
    lo, hi = split_i64(np.asarray(values, np.int64))
    r = REQ32_INDEX[name]
    m32[r, ix] = lo
    m32[r + 1, ix] = hi


def pack_cols_req32(m32: np.ndarray, cols: ReqColumns, slots, known,
                    now: int, ix) -> None:
    """Write one resolved batch's request columns into a staging slab;
    ``ix`` selects the packed lanes (a slice for the contiguous no-error
    batch, a fancy index when error rows are skipped)."""
    R = REQ32_INDEX
    m32[R["slot"], ix] = slots
    m32[R["known"], ix] = known
    m32[R["algorithm"], ix] = cols.algorithm[ix]
    m32[R["behavior"], ix] = cols.behavior[ix]
    m32[R["valid"], ix] = 1
    pack_wide_rows(m32, "hits", cols.hits[ix], ix)
    pack_wide_rows(m32, "limit", cols.limit[ix], ix)
    pack_wide_rows(m32, "duration", cols.duration[ix], ix)
    ca = cols.created_at[ix]
    pack_wide_rows(
        m32, "created_at", np.where(ca != CREATED_UNSET, ca, now), ix
    )
    pack_wide_rows(m32, "burst", cols.burst[ix], ix)


def sort_packed_by_slot(m32: np.ndarray, n: int, capacity: int):
    """Stable in-place sort of a packed batch's live lanes by slot
    (same-slot requests keep arrival order).  Returns ``(inv, has_dups)``:
    the request → sorted-lane permutation and whether any real slot
    repeats."""
    R = REQ32_INDEX
    order = np.argsort(m32[R["slot"], :n], kind="stable")
    m32[:, :n] = m32[:, :n][:, order]
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    sl = m32[R["slot"], :n]
    has_dups = bool(((sl[1:] == sl[:-1]) & (sl[1:] < capacity)).any())
    return inv, has_dups


def join_i32_pair(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) int32 pair → int64 (two's complement preserved)."""
    return (
        (np.asarray(hi).astype(np.int64) << 32)
        | np.asarray(lo).astype(np.uint32).astype(np.int64)
    )


# ----------------------------------------------------------------------
# Host plans for duplicate windows (copies of the TPU package's
# ops/engine.py group_upad, _param_rows_equal_prev, build_group_plan and
# build_layer_plan: the same arrays, or None, for the same packed window)
# ----------------------------------------------------------------------
def group_upad(b: int, u: int = 0) -> int:
    """The grouped plan's head width for a window width ``b``: at least
    max(256, b/4), a power of two, so serving traffic sees few shapes."""
    return pad_pow2(max(u, 256, b // 4))


def _param_rows_equal_prev(m: np.ndarray, nl: int) -> np.ndarray:
    """(nl,) bool: row i carries the same request parameters as row i-1
    (the 16 REQ32 parameter rows both duplicate plans fold on, so the
    grouped and layered plans agree on unit boundaries)."""
    R = REQ32_INDEX
    rows = (
        R["algorithm"], R["behavior"],
        R["hits"], R["hits"] + 1,
        R["limit"], R["limit"] + 1,
        R["duration"], R["duration"] + 1,
        R["created_at"], R["created_at"] + 1,
        R["burst"], R["burst"] + 1,
        R["greg_exp"], R["greg_exp"] + 1,
        R["greg_dur"], R["greg_dur"] + 1,
    )
    eq = np.ones(nl, bool)
    for r in rows:
        eq[1:] &= m[r, 1:nl] == m[r, : nl - 1]
    return eq


def build_group_plan(m: np.ndarray, n: int, capacity: int, now: int,
                     min_dup_frac: float = 1 / 8):
    """Grouped plan of a slot-sorted packed window: each duplicate group
    collapses to its head when every follower is identical to its head,
    known, hits > 0, free of RESET_REMAINING and Gregorian behaviors,
    token or leaky, and under a head that provably comes out alive
    (duration > 0 and created_at >= now) — the conditions under which the
    closed-form fold is exact.

    Returns ``(mhead (19, Upad), count (Upad,), uidx (B,), rank (B,), u)``
    with ``u`` the live head count, or None when a group is ineligible or
    fewer than ``min_dup_frac`` of the live rows are followers.  Member i
    answers from head column ``uidx[i]`` at rank ``rank[i]``.  Error lanes
    (slot == capacity) form a group of their own and lanes past ``n``
    point at column ``upad - 1``; their responses are unspecified and
    sliced or masked downstream."""
    R = REQ32_INDEX
    b = m.shape[1]
    s = m[R["slot"], :n]
    live = s < capacity
    if n == 0 or not live.any():
        return None
    is_start = np.empty(n, bool)
    is_start[0] = True
    np.not_equal(s[1:], s[:-1], out=is_start[1:])
    # Savings count live followers only: error lanes share slot ==
    # capacity and would otherwise look like one large group.
    dup_rows = int(np.count_nonzero(~is_start & live))
    if dup_rows < max(1, int(min_dup_frac * int(np.count_nonzero(live)))):
        return None
    starts = np.flatnonzero(is_start)
    gid = np.cumsum(is_start) - 1
    rank = np.arange(n, dtype=np.int32) - starts[gid].astype(np.int32)

    eq_prev = _param_rows_equal_prev(m, n)
    hits_pos = join_i32_pair(m[R["hits"], :n], m[R["hits"] + 1, :n]) > 0
    known = m[R["known"], :n] != 0
    no_merge = int(Behavior.RESET_REMAINING | Behavior.DURATION_IS_GREGORIAN)
    beh_ok = (m[R["behavior"], :n] & no_merge) == 0
    dur = join_i32_pair(m[R["duration"], :n], m[R["duration"] + 1, :n])
    created = join_i32_pair(
        m[R["created_at"], :n], m[R["created_at"] + 1, :n])
    alive_ok = (dur > 0) & (created >= now)
    alg_ok = m[R["algorithm"], :n] <= int(Algorithm.LEAKY_BUCKET)
    follower = ~is_start & live
    if np.any(follower
              & ~(eq_prev & known & hits_pos & beh_ok & alive_ok & alg_ok)):
        return None

    u = len(starts)
    upad = group_upad(b, u)
    mhead = np.empty((REQ32_ROWS, upad), np.int32)
    mhead[:, :u] = m[:, starts]
    mhead[:, u:] = 0
    mhead[R["slot"], u:] = capacity  # padding heads aim at the guard row
    count = np.ones(upad, np.int32)
    sizes = np.diff(np.append(starts, n)).astype(np.int32)
    count[:u] = sizes
    uidx = np.full(b, upad - 1, np.int32)
    uidx[:n] = gid
    rank_b = np.zeros(b, np.int32)
    rank_b[:n] = rank
    return mhead, count, uidx, rank_b, u


def build_layer_plan(m: np.ndarray, n: int, capacity: int, now: int,
                     layer_width: int = 512, max_layers: int = 32,
                     min_dup_frac: float = 1 / 8):
    """Unit-layer plan for duplicate windows the grouped plan declines
    (groups broken by RESET rows, parameter changes or queries).

    A *unit* is a maximal run of identical fold-eligible duplicates; layer
    k collects the k-th unit of every slot.  Each layer runs as one narrow
    merged tick, chained through the table, and one expansion maps every
    member's response from its unit's journal row.

    Returns ``(mh0 (19, W0), cnt0 (W0,), mhk (K-1, 19, LW), cntk
    (K-1, LW), uidx (B,), rank (B,), k_pad)`` or None when a count > 1
    unit's head is not provably alive, a slot has more than
    ``max_layers`` units, a layer past the first is wider than
    ``layer_width``, or fewer than ``min_dup_frac`` of the live rows are
    duplicates.  ``uidx`` addresses the flat journal (layer 0's block,
    then the K-1 narrow blocks); error lanes point at position 0 and
    answer unspecified values.  Layers past the last unit's are padding
    (``k_pad`` rounds the layer count up for the JAX package's compiles)."""
    R = REQ32_INDEX
    b = m.shape[1]
    s = m[R["slot"], :n]
    live = s < capacity
    nl = int(np.count_nonzero(live))
    if nl == 0:
        return None
    # Error rows carry slot == capacity and sort to the tail: the live
    # prefix is contiguous.
    s = s[:nl]
    is_start = np.empty(nl, bool)
    is_start[0] = True
    np.not_equal(s[1:], s[:-1], out=is_start[1:])
    dup_rows = int(np.count_nonzero(~is_start))
    if dup_rows < max(1, int(min_dup_frac * nl)):
        return None

    eq_prev = _param_rows_equal_prev(m, nl)
    no_merge = int(Behavior.RESET_REMAINING | Behavior.DURATION_IS_GREGORIAN)
    hits_pos = join_i32_pair(m[R["hits"], :nl], m[R["hits"] + 1, :nl]) > 0
    ok = (
        (is_start | eq_prev)
        & hits_pos
        & ((m[R["behavior"], :nl] & no_merge) == 0)
        & ((m[R["known"], :nl] != 0) | is_start)
        # zoo lanes have no closed-form fold: size-1 units only
        & (m[R["algorithm"], :nl] <= int(Algorithm.LEAKY_BUCKET))
    )
    unit_start = is_start | ~ok
    heads = np.flatnonzero(unit_start)
    u = len(heads)
    sizes = np.diff(np.append(heads, nl)).astype(np.int32)

    # Unit ordinal within its slot.
    seg_of_unit = (np.cumsum(is_start) - 1)[heads]
    first_unit_of_seg = np.full(seg_of_unit[-1] + 1, u, np.int64)
    unit_idx = np.arange(u)
    np.minimum.at(first_unit_of_seg, seg_of_unit, unit_idx)
    ord_ = (unit_idx - first_unit_of_seg[seg_of_unit]).astype(np.int64)
    k_layers = int(ord_.max()) + 1
    if k_layers > max_layers:
        return None
    if k_layers > 1:
        wide = np.bincount(ord_[ord_ >= 1])
        if len(wide) and wide.max() > layer_width:
            return None
    # Count > 1 heads must come out alive (see build_group_plan).
    multi = sizes > 1
    if multi.any():
        hr = heads[multi]
        dur = join_i32_pair(m[R["duration"], :nl][hr],
                            m[R["duration"] + 1, :nl][hr])
        created = join_i32_pair(m[R["created_at"], :nl][hr],
                                m[R["created_at"] + 1, :nl][hr])
        if not ((dur > 0) & (created >= now)).all():
            return None

    w0_n = int(np.count_nonzero(ord_ == 0))
    w0 = group_upad(b, w0_n)
    if k_layers <= 2:
        k_pad = 2
    elif k_layers <= 4:
        k_pad = 4
    else:
        k_pad = -(-k_layers // 4) * 4
    k_pad = min(k_pad, max_layers)

    def head_block(unit_sel, width):
        mh = np.zeros((REQ32_ROWS, width), np.int32)
        mh[R["slot"]] = capacity
        cnt = np.ones(width, np.int32)
        k = len(unit_sel)
        mh[:, :k] = m[:, :nl][:, heads[unit_sel]]
        cnt[:k] = sizes[unit_sel]
        return mh, cnt

    # Per-unit flat journal position, layer 0's block first.
    pos_of_unit = np.empty(u, np.int64)
    lay0 = np.flatnonzero(ord_ == 0)
    pos_of_unit[lay0] = np.arange(len(lay0))
    mh0, cnt0 = head_block(lay0, w0)
    mhk = np.zeros((k_pad - 1, REQ32_ROWS, layer_width), np.int32)
    mhk[:, R["slot"], :] = capacity
    cntk = np.ones((k_pad - 1, layer_width), np.int32)
    for k in range(1, k_layers):
        sel = np.flatnonzero(ord_ == k)
        pos_of_unit[sel] = w0 + (k - 1) * layer_width + np.arange(len(sel))
        mhk[k - 1], cntk[k - 1] = head_block(sel, layer_width)

    gid_unit = np.cumsum(unit_start) - 1        # row → unit
    uidx = np.zeros(b, np.int64)
    uidx[:nl] = pos_of_unit[gid_unit]
    rank = np.zeros(b, np.int32)
    rank[:nl] = np.arange(nl, dtype=np.int32) - heads[gid_unit].astype(np.int32)
    return (mh0, cnt0, mhk, cntk, uidx.astype(np.int32), rank,
            k_pad)


def live_layers(mhk: np.ndarray, capacity: int) -> int:
    """How many of a layer plan's narrow layers hold a real head (the rest
    are padding layers at the tail)."""
    return int(np.count_nonzero(mhk[:, REQ32_INDEX["slot"], 0] < capacity))


def unpack_resp_compact(raw: np.ndarray, limit_req: np.ndarray) -> np.ndarray:
    """(6, n) int32 compact response in request order + the request-order
    limit column → the public (5, n) int64 matrix (status, limit,
    remaining, reset_time, over_limit).  The response ``limit`` is always
    the request's, so the device does not send it."""
    n = raw.shape[1]
    out = np.empty((5, n), np.int64)
    out[0] = raw[0]
    out[1] = limit_req[:n]
    out[2] = join_i32_pair(raw[2], raw[3])
    out[3] = join_i32_pair(raw[4], raw[5])
    out[4] = raw[1]
    return out


def masked_over_limit(resp_mat: np.ndarray, errors) -> int:
    """Over-limit count from a (5, n) response with error lanes zeroed."""
    over = resp_mat[4]
    if errors:
        over = over.copy()
        over[list(errors)] = 0
    return int(over.sum())


class StagingRing:
    """Reusable host staging slabs for the request upload.

    On a CUDA engine the slabs are pinned, so the upload is an
    asynchronous copy (``non_blocking=True``) that overlaps the previous
    window's kernel.  A slab recycles only once the tick handle that
    consumed it has resolved (its copy has completed by then); when every
    slab is in flight the lease falls back to a fresh pageable allocation
    rather than overwrite one.  Callers hold the engine lock."""

    __slots__ = ("rows", "sentinel", "depth", "pinned", "_stage", "_next",
                 "_leased")

    def __init__(self, rows: int, sentinel: int, depth: int, pinned: bool):
        self.rows = int(rows)
        self.sentinel = int(sentinel)
        self.depth = int(depth)
        self.pinned = pinned
        self._stage: Dict[int, list] = {}  # width -> [[slab, handle]]
        self._next: Dict[int, int] = {}
        self._leased: Optional[list] = None

    def _slab(self, b: int) -> torch.Tensor:
        return torch.empty((self.rows, b), dtype=torch.int32,
                           pin_memory=self.pinned)

    def lease(self, b: int) -> torch.Tensor:
        """A zeroed (rows, b) int32 slab with the slot row set to the
        padding sentinel."""
        ring = self._stage.get(b)
        if ring is None:
            ring = self._stage[b] = [
                [self._slab(b), None] for _ in range(self.depth)]
            self._next[b] = 0
        slot = None
        start = self._next[b]
        for k in range(len(ring)):
            cand = ring[(start + k) % len(ring)]
            h = cand[1]
            if h is None or h._done is not None:
                slot = cand
                self._next[b] = (start + k + 1) % len(ring)
                break
        if slot is None:
            m = torch.empty((self.rows, b), dtype=torch.int32)
            self._leased = None
        else:
            slot[1] = None
            m = slot[0]
            self._leased = slot
        m.fill_(0)
        m[REQ32_INDEX["slot"]] = self.sentinel
        return m

    def retire(self, handle) -> None:
        """Bind the most recent lease to the tick handle consuming it;
        ``None`` frees the slab at once."""
        if self._leased is not None:
            self._leased[1] = handle
            self._leased = None


class SlotMap:
    """Pure-Python key→slot map with the native map's interface and its
    slot order (lowest free slot first, released slots reused last
    released first)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._map: Dict[str, int] = {}
        self._keys: List[Optional[str]] = [None] * capacity
        self._free: List[int] = list(range(capacity - 1, -1, -1))

    def __len__(self) -> int:
        return len(self._map)

    def assign(self, key: str) -> Optional[int]:
        """The slot for key, allocating if new; None if the table is full."""
        s = self._map.get(key)
        if s is not None:
            return s
        if not self._free:
            return None
        s = self._free.pop()
        self._map[key] = s
        self._keys[s] = key
        return s

    def release(self, slot: int) -> None:
        key = self._keys[slot]
        if key is not None:
            del self._map[key]
            self._keys[slot] = None
            self._free.append(slot)

    def mapped_mask(self) -> np.ndarray:
        return np.fromiter(
            (k is not None for k in self._keys), np.bool_, count=self.capacity
        )

    def resolve_batch(self, keys: List[bytes]):
        """(slots, known) for a batch of keys; slot -1 = table full."""
        n = len(keys)
        slots = np.empty(n, np.int64)
        known = np.empty(n, np.uint8)
        for j in range(n):
            k = keys[j].decode()
            s = self._map.get(k)
            if s is not None:
                slots[j] = s
                known[j] = 1
            else:
                s = self.assign(k)
                slots[j] = -1 if s is None else s
                known[j] = 0
        return slots, known

    def resolve_blob(self, blob, offsets: np.ndarray):
        mv = memoryview(blob)
        return self.resolve_batch(
            [bytes(mv[offsets[j] : offsets[j + 1]])
             for j in range(len(offsets) - 1)]
        )

    def _keys_of(self, blob, offsets: np.ndarray) -> List[str]:
        mv = memoryview(blob)
        return [bytes(mv[offsets[j]:offsets[j + 1]]).decode()
                for j in range(len(offsets) - 1)]

    def lookup_blob(self, blob, offsets: np.ndarray) -> np.ndarray:
        """The slot of each key, -1 for a key that has none."""
        return np.array([self._map.get(k, -1)
                         for k in self._keys_of(blob, offsets)], np.int64)

    def assign_blob(self, blob, offsets: np.ndarray) -> np.ndarray:
        """The slot of each key, assigned when new; -1 where full."""
        return np.array([-1 if s is None else s for s in map(
            self.assign, self._keys_of(blob, offsets))], np.int64)

    def release_batch(self, slots: np.ndarray) -> None:
        for s in slots:
            self.release(int(s))

    def keys_batch(self, slots: np.ndarray) -> List[bytes]:
        """Keys of a batch of slots (b"" for unassigned)."""
        return [(self._keys[int(s)] or "").encode() for s in slots]

    def keys_blob(self, slots: np.ndarray) -> tuple[bytes, np.ndarray]:
        return pack_blob(self.keys_batch(slots))


def select_reclaim_victims(
    mapped: np.ndarray,
    dead_dev: np.ndarray,
    last_access: np.ndarray,
    tick_count: int,
    want: int,
) -> tuple[np.ndarray, np.ndarray]:
    """TTL-then-LRU victim selection (expired-on-read eviction plus
    evict-oldest, lrucache.go:88-149).  Returns ``(expired, lru_victims)``
    as slot indices.  Expired slots only release on the host; LRU victims
    must also be evicted on the device.  ``mapped`` excludes host-pending
    slots; slots touched this tick are excluded here."""
    mapped = mapped & (last_access != tick_count)
    dead = mapped & dead_dev
    freed = np.flatnonzero(dead)
    none = np.empty(0, np.int64)
    if len(freed) >= want:
        return freed, none
    live = np.flatnonzero(mapped & ~dead)
    n = min(want - len(freed), len(live))
    if n <= 0:
        return freed, none
    if n >= len(live):
        return freed, live
    # argpartition: O(live); the order among victims does not matter.
    return freed, live[np.argpartition(last_access[live], n - 1)[:n]]


def on_stream(stream):
    """A context that makes ``stream`` current (None on a CPU engine)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def run_once(fn):
    """``fn`` wrapped to run at most once, whichever thread calls first;
    a later caller waits until the first call has finished."""
    lock = threading.Lock()
    done = []

    def once():
        with lock:
            if not done:
                done.append(True)
                fn()
    return once


EVICT_CHUNK = 1 << 16

# Rows a state movement (export, load, install) gathers or scatters at a
# time: bounds the row buffer on the card at 128 MB.
STATE_CHUNK = 1 << 20

# Tables at least this large take the layered plan (the JAX engine's gate:
# below it, duplicate windows it declines go to the sequential program).
LAYERED_MIN_CAPACITY = 1 << 14


def scatter_chunked(table: torch.Tensor, slots: np.ndarray,
                    rows: np.ndarray) -> int:
    """Whole host rows to the table at unique ``slots`` through the scatter
    kernel, STATE_CHUNK rows a launch; returns the bytes uploaded."""
    for a in range(0, len(slots), STATE_CHUNK):
        rowtable.scatter_rows(
            table,
            torch.from_numpy(slots[a:a + STATE_CHUNK]).to(table.device),
            torch.from_numpy(rows[a:a + STATE_CHUNK]).to(table.device))
    return slots.nbytes + rows.nbytes


def gather_chunked(table: torch.Tensor, slots: np.ndarray) -> np.ndarray:
    """The table's rows at ``slots`` as one host (k, W) array, through the
    gather kernel, STATE_CHUNK rows a launch."""
    parts = [rowtable.gather_rows(table, torch.from_numpy(np.ascontiguousarray(
        slots[a:a + STATE_CHUNK], np.int64)).to(table.device)).cpu().numpy()
        for a in range(0, len(slots), STATE_CHUNK)]
    if not parts:
        return np.zeros((0, table.shape[1]), np.int64)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def store_rows(store, requests, lanes: np.ndarray, keys: List[bytes],
               rows: np.ndarray) -> None:
    """The Store calls of a write-through (algorithms.go:78-90, 149-153):
    ``rows[j]`` is the state after the tick of key ``keys[j]``, touched by
    request ``requests[lanes[j]]``; a row the tick cleared maps to
    ``Store.remove``, any other to ``Store.on_change``, in order.  A slot
    without a key (b"") is skipped."""
    cols = columns_from_rows(rows)
    in_use = rows[:, WORD["in_use"]] != 0
    for j, i in enumerate(lanes.tolist()):
        if not keys[j]:
            continue
        key = keys[j].decode()
        if not in_use[j]:
            store.remove(key)
            continue
        item = {"key": key}
        for f in ITEM_FIELDS:
            v = cols[f][j]
            item[f] = float(v) if f == "remaining_f" else int(v)
        store.on_change(requests[i], item)


def install_rows(updates: Sequence[GlobalUpdate], now: int) -> np.ndarray:
    """The table rows of owner-pushed GLOBAL updates (the reference's
    UpdatePeerGlobals receive path, gubernator.go:425-459): token buckets
    get status, limit, duration, remaining, ``created_at = now``; leaky
    buckets ``remaining_f``, limit, duration, ``burst = limit``,
    ``updated_at = now``; both ``expire_at = reset_time``."""
    a = np.array([[u.algorithm, u.status.limit, u.status.remaining,
                   u.status.status, u.duration, u.status.reset_time]
                  for u in updates], np.int64).reshape(-1, 6).T
    algo, limit, remaining, status, duration, reset_time = a
    leaky = algo == int(Algorithm.LEAKY_BUCKET)
    zero = np.zeros(len(updates), np.int64)
    cols = dict(
        algorithm=algo, limit=limit,
        remaining=np.where(leaky, 0, remaining),
        remaining_f=np.where(leaky, remaining.astype(np.float64), 0.0),
        duration=duration,
        created_at=np.where(leaky, 0, now),
        updated_at=np.where(leaky, now, 0),
        burst=np.where(leaky, limit, 0),
        status=status, expire_at=reset_time, tat=zero,
        prev_count=zero)
    return rows_from_columns(cols, np.arange(len(updates)))


def evict_chunked(table: torch.Tensor, victims: np.ndarray) -> None:
    """Evict slots on the device in scatters of at most EVICT_CHUNK rows
    (bounds the zero-row scratch at 8 MB)."""
    for start in range(0, len(victims), EVICT_CHUNK):
        part = torch.from_numpy(np.ascontiguousarray(
            victims[start:start + EVICT_CHUNK], np.int64)).to(table.device)
        rowtable.row_evict(table, part)


class TickHandle:
    """One dispatched tick: device work is queued, host readback deferred.

    ``result()`` materializes the (5, n) response matrix in request order.
    Idempotent; safe to call from another thread than the dispatcher."""

    __slots__ = ("_engine", "_resp", "_n", "_inv", "errors", "_limit_req",
                 "_refs", "_slots_req", "_done", "_flock")

    def __init__(self, engine, resp, n, inv, errors, limit_req, refs=None,
                 slots_req=None):
        self._engine = engine
        self._resp = resp
        self._n = n
        self._inv = inv
        self.errors = errors
        # A Store engine's request objects and request-order slots: the
        # write-through at resolve reads them.
        self._refs = refs
        self._slots_req = slots_req
        # Copied: the caller may rewrite its columns before resolving.
        self._limit_req = np.array(limit_req[:n], np.int64, copy=True)
        self._done: Optional[np.ndarray] = None
        self._flock = threading.Lock()

    def _finish(self, raw: np.ndarray) -> None:
        """Complete from the host copy of the (6, W) compact response."""
        with self._flock:
            if self._done is not None:
                return
            rm = unpack_resp_compact(raw[:, : self._n][:, self._inv],
                                     self._limit_req)
            eng = self._engine
            with eng._lock:
                eng._account_resolved(rm, self.errors)
                if self._slots_req is not None:
                    eng._write_through(self._refs, self._slots_req, self._n,
                                       self.errors)
            self._resp = None
            self._done = rm

    def result(self) -> tuple[np.ndarray, Dict[int, str]]:
        if self._done is None:
            self._finish(self._resp.cpu().numpy())
        return self._done, self.errors


def resolve_ticks(handles: Sequence[TickHandle]) -> None:
    """Materialize many ticks' responses: same-shape responses are
    concatenated on the device and cross to the host in one copy."""
    todo = [h for h in handles if h._done is None]
    groups: Dict[tuple, List[TickHandle]] = {}
    for h in todo:
        groups.setdefault(tuple(h._resp.shape), []).append(h)
    for hs in groups.values():
        if len(hs) == 1:
            hs[0].result()
            continue
        stacked = torch.stack([h._resp for h in hs]).cpu().numpy()
        for k, h in enumerate(hs):
            h._finish(stacked[k])


class SubmittedBatch:
    """A dispatched batch of any width (one or more chunked ticks)."""

    __slots__ = ("_handles", "_spans", "_n")

    def __init__(self, handles, spans, n):
        self._handles = handles
        self._spans = spans
        self._n = n

    def handles(self) -> List[TickHandle]:
        return self._handles

    def matrix(self) -> tuple[np.ndarray, Dict[int, str]]:
        """(5, n) response matrix in request order + per-item errors."""
        resolve_ticks(self._handles)
        out = np.empty((5, self._n), np.int64)
        errors: Dict[int, str] = {}
        for h, (s, e) in zip(self._handles, self._spans):
            rm, errs = h.result()
            out[:, s:e] = rm
            for i, msg in errs.items():
                errors[s + i] = msg
        return out, errors

    def responses(self) -> List[RateLimitResponse]:
        mat, errors = self.matrix()
        status, limit, remaining, reset = (mat[r].tolist() for r in range(4))
        return [
            RateLimitResponse(error=errors[i]) if i in errors
            else RateLimitResponse(status=status[i], limit=limit[i],
                                   remaining=remaining[i],
                                   reset_time=reset[i])
            for i in range(self._n)
        ]


class BatchFront:
    """The batch entry points of an engine whose ``submit_columns``
    dispatches one window of at most ``max_batch`` rows."""

    max_batch: int
    store = None

    def submit_cols(self, cols: ReqColumns,
                    now: Optional[int] = None) -> SubmittedBatch:
        """Dispatch a columnar batch of any width without waiting for the
        device (chunked into max_batch ticks)."""
        n = len(cols)
        now = now if now is not None else timeutil.now_ms()
        spans = [
            (s, min(s + self.max_batch, n))
            for s in range(0, n, self.max_batch)
        ]
        handles = [
            self.submit_columns(
                cols if len(spans) == 1 else cols.slice_chunk(s, e), now)
            for s, e in spans
        ]
        return SubmittedBatch(handles, spans, n)

    def process_columns(self, cols: ReqColumns, now: Optional[int] = None
                        ) -> tuple[np.ndarray, Dict[int, str]]:
        """Apply a columnar batch; returns the (5, n) response matrix in
        request order (status, limit, remaining, reset_time, over_limit)
        plus per-item errors."""
        if len(cols) == 0:
            return np.zeros((5, 0), np.int64), {}
        return self.submit_cols(cols, now).matrix()

    def submit(self, requests: Sequence[RateLimitRequest],
               now: Optional[int] = None) -> SubmittedBatch:
        """Dispatch an object-level batch without waiting for the device."""
        return self.submit_cols(ReqColumns.from_requests(
            requests, keep_refs=self.store is not None), now)

    def process(self, requests: Sequence[RateLimitRequest],
                now: Optional[int] = None) -> List[RateLimitResponse]:
        """Apply a batch of requests; responses in request order."""
        if not requests:
            return []
        return self.submit(requests, now).responses()


class TickEngine(BatchFront):
    """Owns the device table and applies request windows tick by tick.

    Thread-safe: one lock covers slot resolution, packing and dispatch.

    ``store``: a write/read-through Store (store.py).  ``cold_capacity``:
    entries of the host cold tier LRU victims demote into (0: eviction
    destroys a row).  ``ssd``: an ``SsdStore`` below the cold tier (needs
    one).  ``bg_reclaim``: reclaim on a background thread when free slots
    run low (default: on at capacity >= 2^18)."""

    def __init__(
        self,
        capacity: int = 1 << 16,
        max_batch: int = 4096,
        device: DeviceLike = None,
        store=None,
        bg_reclaim: Optional[bool] = None,
        cold_capacity: int = 0,
        ssd=None,
    ):
        self.capacity = int(capacity)
        self.max_batch = int(max_batch)
        self.store = store
        # The cold tier's write-behind sink is the Store, or the SSD tier
        # when there is one (the Store keeps its read/write-through role).
        self.cold = (ColdStore(int(cold_capacity), store=store)
                     if cold_capacity > 0 else None)
        self.ssd = ssd
        if ssd is not None:
            if self.cold is None:
                raise ValueError(
                    "SSD tier requires a cold tier (cold_capacity > 0): "
                    "the SSD store only ever holds cold-tier overflow")
            self.cold.store = ssd
        self.device = resolve_device(device)
        self.table = zeros_table(self.capacity, self.device)
        # Width ladder: one narrow width for typical service batches plus
        # the full width, so small windows do not pay max_batch lanes.
        mb = pad_pow2(self.max_batch)
        self._widths = (
            (mb,) if mb < 2048 else tuple(sorted({max(1024, mb // 4), mb}))
        )
        self._staging = StagingRing(
            REQ32_ROWS, self.capacity, depth=9,
            pinned=self.device.type == "cuda")
        self.slots = NativeSlotMap(self.capacity)
        self._last_access = np.zeros(self.capacity, np.int64)
        # Slots assigned on the host but not yet written by a tick: the
        # device row still looks dead, so reclaim must skip them.
        self._pending: set = set()
        self._tick_count = 0
        self._lock = threading.RLock()
        # The CUDA stream the serving path last dispatched on (noted
        # under the lock by _locked): the background reclaimer launches
        # there too.
        self._stream = None
        # Background reclaim: when free slots dip under the low watermark
        # and a window had misses, a thread selects victims outside the
        # lock (_reclaim_background); the sync reclaim in _build_cols
        # still runs when a window does not fit.
        self._bg_reclaim = (bg_reclaim if bg_reclaim is not None
                            else self.capacity >= (1 << 18))
        self._reclaim_low = min(
            self.capacity // 8, max(2 * self.max_batch, self.capacity // 64))
        self._reclaim_evt = threading.Event()
        self._reclaim_closed = False
        self._reclaim_thread: Optional[threading.Thread] = None
        # Demote readbacks the reclaimer dispatched but has not landed in
        # the cold tier yet: their keys are in no tier until they land,
        # so a window with misses, an export or a load lands them first.
        self._demotes: List = []
        # The largest request time a tick has seen: background reclaim
        # judges expiry against it, not the wall clock.
        self._last_now = 0
        self.metric_hits = 0
        self.metric_misses = 0
        self.metric_over_limit = 0
        self.metric_unexpired_evictions = 0
        self.metric_shed_requests = 0
        # Tiering: cold hits on the miss path, slots promoted, promote
        # scatters and the ticks that needed one (one scatter a window:
        # their ratio is 1.0), demote readback gathers, and reclaim rounds
        # that had LRU victims (the only place readbacks happen).
        self.metric_cold_hits = 0
        self.metric_promotions = 0
        self.metric_promote_dispatches = 0
        self.metric_promote_ticks = 0
        self.metric_demote_readbacks = 0
        self.metric_evict_reclaims = 0
        # Reclaim rounds by where they ran: in a window, load or install
        # that did not fit (sync), or on the background thread.
        self.metric_sync_reclaims = 0
        self.metric_bg_reclaims = 0
        # The SSD tier: hits, take_batch calls (at most one a window), the
        # windows that took one, and lookups made while a tick was being
        # dispatched (0 by construction).
        self.metric_ssd_hits = 0
        self.metric_ssd_lookups = 0
        self.metric_ssd_miss_ticks = 0
        self.metric_ssd_tick_path_reads = 0
        # Duplicate windows by route (ops/tick.py, ops/sortedtick.py):
        # grouped, layered and chained windows, and the rank rounds the
        # chained tick's plain version ran (CPU tables only).
        self.metric_grouped_ticks = 0
        self.metric_layered_ticks = 0
        self.metric_sorted_ticks = 0
        self.metric_rank_rounds = 0
        # Slots mutated since the last export (export_columns(dirty_only)).
        self._dirty = np.zeros(self.capacity, bool)
        # Quota-lease columns beside the table, capacity + 1 entries: views
        # of one table of 32-B records, the layout kernel B.9 takes.
        self._lease_budget, self._lease_expire, self._lease_gen = \
            leasecols.lease_records(self.capacity, self.device)
        # Slots whose lease budget is negative (a set window or a load
        # wrote it; normally none): a delta window clamps them too.
        self._lease_negative: set = set()
        self.metric_lease_dispatches = 0
        self.metric_lease_windows = 0
        self.metric_lease_ops = 0
        # H2D overlap: a window counts as overlapped when its upload was
        # issued while an earlier window was still unresolved, the
        # pipelined steady state (h2d_overlap_ratio).
        self._inflight = 0
        self.metric_h2d_windows = 0
        self.metric_h2d_overlapped = 0
        self.last_export_stats: dict = {}
        self.last_load_stats: dict = {}

    @contextlib.contextmanager
    def _locked(self):
        """The engine lock, noting the caller's current CUDA stream."""
        with self._lock:
            if self.device.type == "cuda":
                self._stream = torch.cuda.current_stream(self.device)
            yield

    # ------------------------------------------------------------------
    # Reclaim
    # ------------------------------------------------------------------
    def _reclaim(self, now: int, want: Optional[int] = None) -> None:
        """Free TTL-dead slots; fall back to LRU eviction
        (lrucache.go:115-149).  The dead test reads the candidates' rows
        through the gather kernel; LRU victims are read back (and demoted
        into the cold tier) before they are zeroed on the device through
        the scatter kernel."""
        self.metric_sync_reclaims += 1
        mapped = self.slots.mapped_mask()
        if self._pending:
            mapped[np.fromiter(self._pending, np.int64)] = False
        cand = np.flatnonzero(mapped & (self._last_access != self._tick_count))
        dead = np.zeros(self.capacity, bool)
        dead[cand] = rowtable.dead_mask(self.table, cand, now)
        freed, victims = select_reclaim_victims(
            mapped, dead, self._last_access, self._tick_count,
            want or max(1, self.capacity // 16),
        )
        self.slots.release_batch(freed)
        if len(victims):
            self.metric_unexpired_evictions += len(victims)
            finish = self._demote_dispatch(victims, now)
            self.slots.release_batch(victims)
            evict_chunked(self.table, victims)
            finish()
        if self.cold is not None:
            self.cold.expire(now)

    def _demote_dispatch(self, victims: np.ndarray, now: int):
        """Readback-then-evict, dispatch half: queue the gather of the
        victims' rows *before* the caller's evict scatter and capture
        their keys before the slot map releases them.  Returns a closure
        that reads the rows back (waiting for the card), demotes the live
        ones (``in_use`` and ``expire_at >= now``) into the cold tier and
        calls ``Store.remove`` for rows that leave every tier.  The
        gather and the evict run on one stream, so stream order makes the
        gather see the rows before they are zeroed."""
        self.metric_evict_reclaims += 1
        if self.cold is None and self.store is None:
            return lambda: None
        keys = self.slots.keys_batch(victims)
        if self.cold is None:
            def finish_remove():
                for k in keys:
                    if k:
                        self.store.remove(k.decode())
            return finish_remove
        pending = []
        for a in range(0, len(victims), STATE_CHUNK):
            part = np.ascontiguousarray(victims[a:a + STATE_CHUNK], np.int64)
            self.metric_demote_readbacks += 1
            pending.append(rowtable.gather_rows(
                self.table, torch.from_numpy(part).to(self.device)))

        def finish():
            rows = np.concatenate([p.cpu().numpy() for p in pending])
            live = ((rows[:, WORD["in_use"]] != 0)
                    & (rows[:, WORD["expire_at"]] >= now))
            sel = np.flatnonzero(live)
            if len(sel):
                self.cold.put_columns([keys[j] for j in sel],
                                      columns_from_rows(rows[sel]), now)
            if self.store is not None:
                for j in np.flatnonzero(~live):
                    if keys[j]:
                        self.store.remove(keys[j].decode())

        return finish

    # ------------------------------------------------------------------
    # Background reclaim
    # ------------------------------------------------------------------
    def _maybe_trigger_reclaim(self) -> None:
        """Wake the reclaimer when free slots dip under the watermark.
        Called under the lock from ``_build_cols`` only when the window had
        misses: a full table under pure-hit traffic does not evict (the
        reference evicts on insert pressure only, lrucache.go:88-103)."""
        if not self._bg_reclaim or self._reclaim_closed:
            return
        if self.capacity - len(self.slots) >= self._reclaim_low:
            return
        if self._reclaim_thread is None:
            self._reclaim_thread = threading.Thread(
                target=self._reclaim_loop, daemon=True, name="guber-reclaim")
            self._reclaim_thread.start()
        self._reclaim_evt.set()

    def _reclaim_loop(self) -> None:
        while True:
            self._reclaim_evt.wait()
            self._reclaim_evt.clear()
            if self._reclaim_closed:
                return
            try:
                self._reclaim_background()
            except Exception:
                logging.getLogger("gubernator.engine").exception(
                    "background reclaim failed")

    def _reclaim_background(self) -> None:
        """One reclaim round with the costly work outside the lock.

        1 (lock): note ``snap``, the tick count, and dispatch the dead test
          of the mapped slots (a device bool tensor) against ``_last_now``.
        2 (no lock): read the mask back (waits for the card).
        3 (lock): snapshot mapped, pending and ``_last_access``.
        4 (no lock): TTL-then-LRU victim selection.
        5 (lock): drop every candidate touched after ``snap`` (a later
          window stamps a higher tick), release the rest, dispatch the
          demote gather and then the evict scatter; the demote read and
          the cold-tier insert run after the lock is released.

        The table is updated in place, so the device order matters: every
        launch of a round goes on the stream the serving path last
        dispatched on (noted under the lock), and stream order puts the
        dead test after the windows ticked before ``snap``, the demote
        gather before the evict scatter, and the evict before the tick of
        any later window that reuses a released slot."""
        with self._lock:
            free = self.capacity - len(self.slots)
            want = min(self.capacity // 16, 2 * self._reclaim_low - free)
            if want <= 0 or self._last_now == 0:
                return
            self.metric_bg_reclaims += 1
            snap = self._tick_count
            stream = self._stream
            cand = np.flatnonzero(self.slots.mapped_mask())
            with on_stream(stream):
                dead_dev = rowtable.dead_dispatch(self.table, cand,
                                                  self._last_now)
        with on_stream(stream):
            dead_c = rowtable.dead_read(dead_dev)
        scanned = np.zeros(self.capacity, bool)
        scanned[cand] = True
        dead = np.zeros(self.capacity, bool)
        dead[cand] = dead_c
        with self._lock:
            mapped = self.slots.mapped_mask() & scanned
            if self._pending:
                mapped[np.fromiter(self._pending, np.int64)] = False
            la = self._last_access.copy()
        freed, victims = select_reclaim_victims(mapped, dead, la, snap, want)
        finish = None
        with self._lock:
            stream = self._stream
            freed = freed[self._last_access[freed] <= snap]
            victims = victims[self._last_access[victims] <= snap]
            self.slots.release_batch(freed)
            if len(victims):
                self.metric_unexpired_evictions += len(victims)
                with on_stream(stream):
                    finish = run_once(self._demote_dispatch(
                        victims, self._last_now))
                    self._demotes.append(finish)
                    self.slots.release_batch(victims)
                    evict_chunked(self.table, victims)
        if finish is not None:
            with on_stream(stream):
                finish()
            with self._lock:
                if finish in self._demotes:
                    self._demotes.remove(finish)
        if self.cold is not None:
            self.cold.expire(self._last_now)

    def _land_demotes(self) -> None:
        """Land the reclaimer's pending demotes (the caller holds the lock):
        a key it evicted is in no tier until its readback lands in the
        cold tier, so a lookup, an export or a load must not run before."""
        for finish in self._demotes:
            finish()
        self._demotes.clear()

    def close(self) -> None:
        """Stop the background reclaimer and drain and close the SSD
        tier.  Idempotent."""
        self._reclaim_closed = True
        self._reclaim_evt.set()
        t = self._reclaim_thread
        if t is not None:
            t.join(timeout=5)
        if self.ssd is not None:
            self.ssd.close()

    # ------------------------------------------------------------------
    # Host-side request preparation
    # ------------------------------------------------------------------
    def _resolve_rows(self, cols: ReqColumns, keep: np.ndarray):
        """(slots, known) for the keep-masked rows, in row order, through
        one vectorized blob compaction and one slot-map call."""
        return self.slots.resolve_blob(
            *compact_blob(cols.key_blob, cols.key_offsets, keep))

    def _build_cols(self, cols: ReqColumns, now: int):
        """Resolve keys to slots and pack the padded (19, B) REQ32 slab.
        Returns ``(slab, n, errors, inv, has_dups)``."""
        n = len(cols)
        if n > self.max_batch:
            raise ValueError(f"batch of {n} exceeds engine max {self.max_batch}")
        b = next(w for w in self._widths if w >= n)
        slab = self._staging.lease(b)
        m = slab.numpy()
        errors: Dict[int, str] = {}

        # Gregorian resolution (host calendar math) only for flagged rows,
        # once per distinct selector: every lane with one selector gets
        # the same interval at one ``now``.  Failures become per-item
        # errors.
        greg = np.flatnonzero(
            cols.behavior & int(Behavior.DURATION_IS_GREGORIAN))
        if len(greg):
            sel_d = cols.duration[greg]
            for d in np.unique(sel_d):
                lanes = greg[sel_d == d]
                try:
                    exp = timeutil.gregorian_expiration(now, int(d))
                    dur = timeutil.gregorian_duration(now, int(d))
                except timeutil.GregorianError as exc:
                    errors.update((int(i), str(exc)) for i in lanes)
                    continue
                pack_wide_rows(m, "greg_exp", np.full(len(lanes), exp), lanes)
                pack_wide_rows(m, "greg_dur", np.full(len(lanes), dur), lanes)

        if errors:
            keep = np.ones(n, bool)
            keep[list(errors)] = False
            sel = np.flatnonzero(keep)
            if len(sel) == 0:
                return slab, n, errors, np.arange(n, dtype=np.int64), False
            slots, known = self._resolve_rows(cols, keep)
        else:
            sel = None  # the whole batch, contiguous
            slots, known = self.slots.resolve_blob(
                cols.key_blob, cols.key_offsets)
        if (slots < 0).any():
            # Stamp the resolved rows live before reclaiming, so the
            # reclaim cannot hand their slots to the retried keys.
            ok = slots >= 0
            self._last_access[slots[ok]] = self._tick_count
            self._pending.update(slots[ok & (known == 0)].tolist())
            needed = int((~ok).sum())
            self._reclaim(now, want=max(needed, self.capacity // 16))
            retry = np.flatnonzero(slots < 0)
            retry_src = retry if sel is None else sel[retry]
            want = np.zeros(n, bool)
            want[retry_src] = True
            s2, k2 = self._resolve_rows(cols, want)
            slots[retry] = s2
            known[retry] = k2
            if (slots < 0).any():
                # A truly full table sheds the unplaceable items with
                # per-item errors; the rest of the batch is served.
                shed = np.flatnonzero(slots < 0)
                shed_src = shed if sel is None else sel[shed]
                for j in shed_src:
                    errors[int(j)] = "rate-limit table full; eviction failed"
                self.metric_shed_requests += len(shed)
                keep = slots >= 0
                sel = (np.flatnonzero(keep) if sel is None
                       else np.asarray(sel)[keep]).astype(np.int64)
                slots = slots[keep]
                known = known[keep]
                if len(slots) == 0:
                    return slab, n, errors, np.arange(n, dtype=np.int64), False
        self._last_access[slots] = self._tick_count
        miss = known == 0
        self._pending.update(slots[miss].tolist())
        n_miss = int(miss.sum())
        self.metric_hits += len(miss) - n_miss
        self.metric_misses += n_miss
        if n_miss:
            self._land_demotes()
            self._maybe_trigger_reclaim()
        if self.cold is not None and n_miss:
            miss = self._promote_misses(cols, sel, slots, known, miss, now)
        if self.store is not None and miss.any():
            if cols.refs is None:
                raise ValueError(
                    "Store read-through needs request objects; build the "
                    "batch with ReqColumns.from_requests(..., "
                    "keep_refs=True)")
            rt_sel = np.arange(n, dtype=np.int64) if sel is None else sel
            self._read_through(cols.refs, rt_sel, slots, known, miss)

        ix = slice(0, n) if sel is None else sel
        pack_cols_req32(m, cols, slots, known, now, ix)
        # Error rows keep slot == capacity and sort to the end with the
        # padding; sorted neighbours reveal duplicate slots.
        inv, has_dups = sort_packed_by_slot(m, n, self.capacity)
        return slab, n, errors, inv, has_dups

    def _promote_misses(self, cols: ReqColumns, sel, slots: np.ndarray,
                        known: np.ndarray, miss: np.ndarray,
                        now: int) -> np.ndarray:
        """Take this window's misses out of the cold tier (and, for what
        misses there, out of the SSD tier in one ``take_batch``) and
        install the hits through one scatter before the tick: promotion is
        a move, and the promoted requests tick as known slots, so a bucket
        keeps its consumed budget.  Returns the updated miss mask.  A key
        that repeats in the window misses once (the slot map marks its
        later rows known), so the scatter's slots are distinct."""
        midx = np.flatnonzero(miss)
        src = midx if sel is None else np.asarray(sel)[midx]
        keys = [cols.key_bytes(int(j)) for j in src]
        pos, ccols = self.cold.take(keys, now)
        self.metric_cold_hits += len(pos)
        if self.ssd is not None and len(pos) < len(midx):
            cold_hit = np.zeros(len(midx), bool)
            cold_hit[pos] = True
            rem = np.flatnonzero(~cold_hit)
            spos, scols = self.ssd.take_batch([keys[int(j)] for j in rem], now)
            self.metric_ssd_lookups += 1
            self.metric_ssd_miss_ticks += 1
            if len(spos):
                self.metric_ssd_hits += len(spos)
                srows = rem[spos]
                if len(pos):
                    pos = np.concatenate([pos, srows])
                    ccols = {f: np.concatenate([ccols[f], scols[f]])
                             for f in scols}
                else:
                    pos, ccols = srows, scols
        if len(pos) == 0:
            return miss
        hit_rows = midx[pos]
        known[hit_rows] = 1
        hit_slots = slots[hit_rows]
        # The scatter lands the rows before the tick: no longer pending.
        self._pending.difference_update(hit_slots.tolist())
        self._dirty[hit_slots] = True
        scatter_chunked(self.table, hit_slots,
                         rows_from_columns(ccols, np.arange(len(pos))))
        self.metric_promote_dispatches += 1
        self.metric_promote_ticks += 1
        self.metric_promotions += len(hit_rows)
        return known == 0

    def _read_through(self, requests, sel: np.ndarray, slots: np.ndarray,
                      known: np.ndarray, miss: np.ndarray) -> None:
        """``Store.get`` for the window's misses (algorithms.go:45-51):
        the items found land through one scatter before the tick, and
        their requests tick as known slots."""
        restored: Dict[int, dict] = {}
        for j in np.flatnonzero(miss):
            slot = int(slots[j])
            if slot in restored:
                known[j] = 1
                continue
            item = self.store.get(requests[sel[j]])
            if item is None:
                continue
            restored[slot] = item
            known[j] = 1
            self._pending.discard(slot)
        if restored:
            scatter_chunked(self.table,
                            np.fromiter(restored, np.int64, len(restored)),
                            rows_from_items(list(restored.values())))

    # ------------------------------------------------------------------
    # The tick
    # ------------------------------------------------------------------
    def submit_columns(self, cols: ReqColumns,
                       now: Optional[int] = None) -> TickHandle:
        """Build and dispatch one tick (≤ max_batch rows); returns a handle
        whose ``result()`` waits for the device.  The request upload is
        asynchronous, so packing the next window overlaps this one's
        kernel.  With a Store the handle is resolved before this returns:
        the write-through gather must see exactly this window's state."""
        with self._locked():
            now = now if now is not None else timeutil.now_ms()
            self._last_now = max(self._last_now, now)
            self._tick_count += 1
            # Flight-recorder stages: "pack" is slot resolve, packing and
            # sort; "h2d" the upload and the kernel launches.
            fr = flightrec.get()
            t_pack = time.perf_counter() if fr is not None else 0.0
            slab, n, errors, inv, has_dups = self._build_cols(cols, now)
            if fr is not None:
                fr.note(fr.active(), "pack", time.perf_counter() - t_pack)
            self._mark_dirty(slab.numpy(), n)
            # _build_cols is the only place the SSD tier is read; a lookup
            # made while the tick is dispatched would show here.
            ssd_reads0 = (self.ssd.metric_lookup_calls
                          if self.ssd is not None else 0)
            t_h2d = time.perf_counter() if fr is not None else 0.0
            if has_dups:
                resp, uploaded = self._tick_duplicates(slab, n, now)
            else:
                resp = fused_tick(self.table, self._upload(slab), now)
                uploaded = True
            if fr is not None:
                fr.note(fr.active(), "h2d", time.perf_counter() - t_h2d)
            if self.ssd is not None:
                self.metric_ssd_tick_path_reads += (
                    self.ssd.metric_lookup_calls - ssd_reads0)
            self._pending.clear()
            slots_req = None
            if self.store is not None:
                slots_req = slab.numpy()[REQ32_INDEX["slot"], :n][inv].astype(
                    np.int64)
            handle = TickHandle(self, resp, n, inv, errors, cols.limit,
                                cols.refs, slots_req)
            self.metric_h2d_windows += 1
            if self._inflight > 0:
                self.metric_h2d_overlapped += 1
            self._inflight += 1
            self._staging.retire(handle if uploaded else None)
            if self.store is not None:
                handle.result()
            return handle

    def _upload(self, slab: torch.Tensor) -> torch.Tensor:
        """The staging slab on the table's device (an asynchronous copy
        from pinned memory on a CUDA engine)."""
        if self.device.type == "cuda":
            return slab.to(self.device, non_blocking=True)
        return slab

    def _mark_dirty(self, m: np.ndarray, n: int) -> None:
        """Mark the slots a packed window mutates: hits != 0, a slot new
        to the table, or RESET_REMAINING.  Pure queries read without
        moving state (a leaky query's refill recomputes from
        ``updated_at`` after a restore), so they do not mark."""
        R = REQ32_INDEX
        h = R["hits"]
        mutating = ((m[h, :n] != 0) | (m[h + 1, :n] != 0)
                    | (m[R["known"], :n] == 0)
                    | ((m[R["behavior"], :n]
                        & int(Behavior.RESET_REMAINING)) != 0))
        s = m[R["slot"], :n]
        self._dirty[s[mutating & (s < self.capacity)]] = True

    def _tick_duplicates(self, slab: torch.Tensor, n: int, now: int):
        """Dispatch a window whose slots repeat, in the JAX engine's order:
        the grouped plan (one merged launch and the member expansion),
        else, on serving-size tables, the layered plan (one merged launch
        per unit layer), else the chained duplicate tick (one launch).
        Returns ``(resp, uploaded)``: the (6, ·) device response in the
        window's slot-sorted lane order, and whether the slab itself was
        uploaded (it must outlive the copy)."""
        m = slab.numpy()
        plan = build_group_plan(m, n, self.capacity, now)
        if plan is not None:
            mhead, count, uidx, rank, _ = plan
            self.metric_grouped_ticks += 1
            return tick.merged_pipeline(
                self.table,
                *tick.upload(self.device, mhead, count, uidx, rank),
                now), False
        lplan = (build_layer_plan(m, n, self.capacity, now)
                 if self.capacity >= LAYERED_MIN_CAPACITY else None)
        if lplan is not None:
            mh0, cnt0, mhk, cntk, uidx, rank, _ = lplan
            k = live_layers(mhk, self.capacity)
            self.metric_layered_ticks += 1
            return tick.layered_pipeline(
                self.table, *tick.upload(self.device, mh0, cnt0, mhk[:k],
                                        cntk[:k], uidx, rank), now), False
        self.metric_sorted_ticks += 1
        r0 = fused_sorted_tick_plain.rounds
        resp = fused_sorted_tick(self.table, self._upload(slab), now)
        self.metric_rank_rounds += fused_sorted_tick_plain.rounds - r0
        return resp, True

    def _account_resolved(self, resp_mat: np.ndarray, errors) -> None:
        """Bookkeeping of a resolved window (the caller holds the lock):
        later uploads stop counting it as in flight."""
        self._inflight = max(0, self._inflight - 1)
        self.metric_over_limit += masked_over_limit(resp_mat, errors)

    def _write_through(self, requests, slots: np.ndarray, n: int,
                       errors: Dict[int, str]) -> None:
        """``Store.on_change`` with each touched slot's state after the
        tick (algorithms.go:149-153), once per distinct slot, in request
        order; a slot the tick cleared (RESET_REMAINING) maps to
        ``Store.remove`` (algorithms.go:78-90).  The rows come through one
        gather.  ``slots`` is in request order."""
        lanes = np.arange(n, dtype=np.int64)
        if errors:
            lanes = np.setdiff1d(lanes, np.fromiter(errors, np.int64))
        if len(lanes) == 0:
            return
        _, first = np.unique(slots[lanes], return_index=True)
        lanes = lanes[np.sort(first)]
        tgt = np.ascontiguousarray(slots[lanes])
        store_rows(self.store, requests, lanes, self.slots.keys_batch(tgt),
                   gather_chunked(self.table, tgt))

    # ------------------------------------------------------------------
    # State movement: installs, leases, snapshots
    # ------------------------------------------------------------------
    def _assign_keys(self, blob, offsets: np.ndarray, now: int) -> np.ndarray:
        """Slots for keys whose rows are written directly (installs):
        assigned when new, with one reclaim when the table is full; -1
        where it stays full.  The slots are stamped with this tick, so the
        reclaim spares them."""
        self._land_demotes()
        slots, known = self.slots.resolve_blob(blob, offsets)
        full = slots < 0
        self._last_access[slots[~full]] = self._tick_count
        if full.any():
            self._reclaim(now, want=max(int(full.sum()), self.capacity // 16))
            s2, k2 = self.slots.resolve_blob(
                *compact_blob(blob, offsets, full))
            slots[full], known[full] = s2, k2
            self._last_access[s2[s2 >= 0]] = self._tick_count
        ok = slots >= 0
        n_miss = int(np.count_nonzero(known[ok] == 0))
        self.metric_hits += int(np.count_nonzero(ok)) - n_miss
        self.metric_misses += n_miss
        return slots

    def install_globals(self, updates: Sequence[GlobalUpdate],
                        now: Optional[int] = None) -> None:
        """Install owner-pushed GLOBAL state as whole rows
        (:func:`install_rows`).  The last update of a key wins; keys the
        table cannot place are dropped (the next push retries).  The rows
        are live when this returns."""
        if not updates:
            return
        with self._locked():
            now = now if now is not None else timeutil.now_ms()
            # A new logical tick: the previous tick's slots must not stay
            # protected from reclaim.
            self._tick_count += 1
            slots = self._assign_keys(
                *pack_blob([u.key.encode() for u in updates]), now)
            by_slot: Dict[int, GlobalUpdate] = {}
            for u, s in zip(updates, slots.tolist()):
                if s >= 0:
                    by_slot[s] = u
            if not by_slot:
                return
            tgt = np.fromiter(by_slot, np.int64, len(by_slot))
            self._dirty[tgt] = True
            scatter_chunked(self.table, tgt,
                            install_rows(list(by_slot.values()), now))

    def lease_window(self, keys: Sequence[bytes], budgets: Sequence[int],
                     expires: Sequence[int], gens: Sequence[int],
                     is_set: bool = True) -> int:
        """Apply one window of quota-lease column updates (docs/leases.md):
        the lanes cross to the device in one copy and land in one
        ``lease_apply`` launch (kernel B.9, ops/leasecols.py).  ``is_set``
        installs the (budget, expiry, generation) triple, the last in
        window order for a key that repeats; otherwise budgets add as
        deltas, every budget in the column is clamped at 0, and expiry and
        generation only move forward.  Keys without a slot are skipped.
        Returns the number of updates applied; ``metric_lease_dispatches``
        counts the launches (the plain version's passes on the CPU)."""
        n = len(keys)
        if n == 0:
            return 0
        with self._locked():
            slots = self.slots.lookup_blob(*pack_blob(list(keys)))
            live = np.flatnonzero(slots >= 0)
            lanes = leasecols.pack_lanes(
                slots[live], np.asarray(budgets, np.int64)[live],
                np.asarray(expires, np.int64)[live],
                np.asarray(gens, np.int64)[live], is_set,
                sorted(self._lease_negative))
            if lanes.shape[1]:
                leasecols.lease_apply(
                    self._lease_budget, self._lease_expire, self._lease_gen,
                    torch.from_numpy(lanes).to(self.device), is_set)
                self.metric_lease_dispatches += 1
            if is_set:
                self._note_lease_budgets(lanes[leasecols.SLOT],
                                         lanes[leasecols.BUDGET])
            else:
                self._lease_negative.clear()  # every one was a lane
            self.metric_lease_windows += 1
            self.metric_lease_ops += len(live)
            self._dirty[slots[live]] = True
            return len(live)

    def _note_lease_budgets(self, slots: np.ndarray,
                            budgets: np.ndarray) -> None:
        """Remember which of ``slots`` now hold a negative lease budget:
        the next delta window adds them as zero lanes, so its clamp
        reaches them as the reference's clamp of the whole column does."""
        neg = budgets < 0
        self._lease_negative.difference_update(slots[~neg].tolist())
        self._lease_negative.update(slots[neg].tolist())

    def lease_columns(self, keys: Sequence[bytes]):
        """The lease columns of a batch of keys: (budget, expire_ms,
        generation) as int64 / int64 / int32 arrays, zeros for keys
        without a slot.  For diagnostics and tests."""
        with self._locked():
            slots = self.slots.lookup_blob(*pack_blob(list(keys)))
            live = slots >= 0
            out = np.zeros((3, len(keys)), np.int64)
            out[:, live] = self._leases_at(slots[live])
            return out[0], out[1], out[2].astype(np.int32)

    def _leases_at(self, slots: np.ndarray) -> np.ndarray:
        """(3, k) int64 host copy of the lease columns (budget, expiry,
        generation) at ``slots``."""
        idx = torch.from_numpy(slots).to(self.device)
        return torch.stack([
            self._lease_budget[idx], self._lease_expire[idx],
            self._lease_gen[idx].long()]).cpu().numpy()

    def export_columns(self, dirty_only: bool = False) -> dict:
        """The live state as a columnar snapshot (ops/snapshot.py): the
        mapped slots' rows cross to the host through the gather kernel,
        STATE_CHUNK rows at a time, rows not in use are dropped, and the
        lease columns ride as extra keys.  ``dirty_only`` exports only
        the slots mutated since the previous export, an upsert delta for
        ``load_columns``; every export clears the dirty set.
        ``last_export_stats`` says what crossed: ``rows`` gathered,
        ``d2h_bytes``, ``items`` exported."""
        with self._locked():
            self._land_demotes()
            mask = self.slots.mapped_mask()
            if dirty_only:
                mask &= self._dirty
            mapped = np.flatnonzero(mask)
            self._dirty[:] = False
            parts, chunks = [], []
            for a in range(0, len(mapped), STATE_CHUNK):
                part = mapped[a:a + STATE_CHUNK]
                rows = rowtable.gather_rows(
                    self.table, torch.from_numpy(part).to(self.device))
                rows = rows.cpu().numpy()
                alive = rows[:, WORD["in_use"]] != 0
                parts.append(part[alive])
                chunks.append(columns_from_rows(rows[alive]))
            live = (np.concatenate(parts) if parts
                    else np.zeros(0, np.int64))
            nbytes = len(mapped) * self.table.shape[1] * 8
            snap = empty_snapshot()
            if len(live):
                snap["key_blob"], snap["key_offsets"] = \
                    self.slots.keys_blob(live)
                for f in ITEM_FIELDS:
                    snap[f] = np.concatenate([c[f] for c in chunks])
                lease = self._leases_at(live)
                nbytes += lease.nbytes
                for f, col in zip(LEASE_SNAP_FIELDS, lease):
                    snap[f] = col
            self.last_export_stats = {
                "rows": len(mapped), "d2h_bytes": nbytes, "items": len(live),
                "partial": dirty_only}
            return self._export_with_cold(snap, dirty_only)

    def _export_with_cold(self, snap: dict, dirty_only: bool) -> dict:
        """Append the cold tier's (dirty) entries to a snapshot: demoted
        state is cached state too.  Hot and cold hold disjoint keys
        (promotion is a move), so this is a concatenation; cold rows hold
        no lease, so their lease columns are zeros."""
        if self.cold is None:
            return snap
        ckeys, ccols = self.cold.export_columns(dirty_only)
        if not ckeys:
            return snap
        blob2, offs2 = pack_blob(ckeys)
        off1 = np.asarray(snap["key_offsets"], np.int64)
        snap["key_blob"] = bytes(snap["key_blob"]) + blob2
        snap["key_offsets"] = np.concatenate([off1, offs2[1:] + off1[-1]])
        for f in ITEM_FIELDS:
            snap[f] = np.concatenate([np.asarray(snap[f]), ccols[f]])
        for f in LEASE_SNAP_FIELDS:
            snap[f] = np.concatenate([np.asarray(snap[f]),
                                      np.zeros(len(ckeys), np.int64)])
        self.last_export_stats["items"] += len(ckeys)
        self.last_export_stats["cold_items"] = len(ckeys)
        return snap

    def export_items(self) -> List[dict]:
        """The live state as Loader-contract item dicts."""
        return items_from_snapshot(self.export_columns())

    def load_columns(self, snap: dict, now: Optional[int] = None) -> None:
        """Upsert a columnar snapshot (``export_columns``, either
        package's): rows that expired by ``now`` are dropped, a key that
        repeats keeps its last row, a snapshot without the zoo columns
        loads them as zeros and one without the lease columns leaves the
        engine's as they are, and the rows land through the scatter
        kernel, STATE_CHUNK at a time.  Loaded slots are marked dirty.
        ``last_load_stats`` says what crossed: ``rows`` written and
        ``h2d_bytes`` uploaded (slots, rows and lease columns)."""
        with self._locked():
            now = now if now is not None else timeutil.now_ms()
            self._last_now = max(self._last_now, now)
            self._tick_count += 1  # as install_globals: unblock reclaim
            self._land_demotes()
            offsets = np.asarray(snap["key_offsets"], np.int64)
            n = len(offsets) - 1
            if n == 0:
                return
            cols = {f: np.asarray(snap[f]) for f in SNAP_FIELDS}
            cols.update((f, np.asarray(snap[f]) if f in snap
                         else np.zeros(n, np.int64)) for f in ZOO_SNAP_FIELDS)
            has_lease = all(f in snap for f in LEASE_SNAP_FIELDS)
            if has_lease:
                cols.update((f, np.asarray(snap[f])) for f in LEASE_SNAP_FIELDS)
            blob = snap["key_blob"]
            keep = cols["expire_at"] >= now
            if not keep.all():
                blob, offsets = compact_blob(blob, offsets, keep)
                cols = {f: c[keep] for f, c in cols.items()}
                n = int(keep.sum())
                if n == 0:
                    return
            shortfall = len(self.slots) + n - self.capacity
            if shortfall > 0:
                self._reclaim(now, want=shortfall)
            slots = self.slots.assign_blob(blob, offsets)
            over = np.flatnonzero(slots < 0)
            if self.cold is not None and len(over):
                # A full table's overflow lands in the cold tier instead
                # of being dropped; traffic promotes it back.
                self.cold.put_columns(
                    [bytes(blob[offsets[j]:offsets[j + 1]]) for j in over],
                    {f: cols[f][over] for f in ITEM_FIELDS}, now)
            sel = np.flatnonzero(slots >= 0)  # a full table drops the tail
            if len(sel) == 0:
                return
            # The last occurrence of each slot (one key, one slot).
            s = slots[sel]
            _, ridx = np.unique(s[::-1], return_index=True)
            sel = sel[len(s) - 1 - ridx]
            tgt = slots[sel]
            self._last_access[tgt] = self._tick_count
            self._dirty[tgt] = True
            nbytes = scatter_chunked(self.table, tgt,
                                     rows_from_columns(cols, sel))
            if has_lease:
                lease = np.stack([cols[f][sel].astype(np.int64)
                                  for f in LEASE_SNAP_FIELDS])
                nbytes += tgt.nbytes + lease.nbytes
                self._note_lease_budgets(tgt, lease[0])
                idx = torch.from_numpy(tgt).to(self.device)
                lease = torch.from_numpy(lease).to(self.device)
                self._lease_budget[idx] = lease[0]
                self._lease_expire[idx] = lease[1]
                self._lease_gen[idx] = lease[2].to(torch.int32)
            self.last_load_stats = {"rows": len(tgt), "h2d_bytes": nbytes}

    def load_items(self, items: Sequence[dict],
                   now: Optional[int] = None) -> None:
        """Load Loader-contract item dicts (through ``load_columns``)."""
        items = list(items)
        if items:
            self.load_columns(snapshot_from_items(items), now=now)

    def cache_size(self) -> int:
        """Keys mapped to a slot."""
        return len(self.slots)

    def cold_size(self) -> int:
        """Entries the cold tier holds (0 without one)."""
        return 0 if self.cold is None else len(self.cold)

    def h2d_overlap_ratio(self) -> float:
        """Share of windows whose upload was issued while an earlier
        window was unresolved (0.0 serial, ~1.0 pipelined)."""
        return self.metric_h2d_overlapped / max(1, self.metric_h2d_windows)

    def hot_occupancy(self) -> float:
        """Share of the table's slots mapped to a key."""
        return len(self.slots) / self.capacity if self.capacity else 0.0
