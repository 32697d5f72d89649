"""Ragged windows of the sharded table: each shard ticks only its extent.

Port of the TPU package's ``ops/raggedtick.py``.  A mesh window is one
flat (19, B) REQ32 matrix sorted by GLOBAL slot plus a cumulative
``offsets`` vector (parallel/partition.py): shard s owns the lanes
``[offsets[s], offsets[s + 1])``.  On one card the shards are row ranges
of one table of ``n_shards * (L + 1)`` rows (``L = local_capacity``):
shard s owns rows ``[s * (L + 1), (s + 1) * (L + 1))``, the last of them
its guard row, so a shard's block (:func:`shard_block`) is a table of the
single-card engine's shape and its local slot arithmetic is unchanged.

* :func:`choose_tile`: the tile width the extent walker strides with.
* :func:`ragged_walk`: the walker around a per-shard tile tick (the mesh
  engine's duplicate windows run ``tick.merge_tick`` per tile).
* :func:`fused_ragged_tick`: kernel B.4 (``csrc/fused_ragged_tick.cu``),
  which replaces ``raggedtick.make_fused_ragged_tick_fn``: the fused tick
  over every shard's extent of a unique-slot window in one launch.
  :func:`fused_ragged_tick_plain` is its plain version: the per-shard
  fused tick on each shard's block, summed, which is the JAX engine's
  ``shard_map`` + ``psum`` contract.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.fusedtick import (
    REQ32_INDEX, REQ32_ROWS, RESP_ROWS, _check_table, count_launch,
    fused_tick_plain)


def choose_tile(b: int, n_shards: int) -> int:
    """Tile width for :func:`ragged_walk`: ~B/n so a balanced shard's
    extent is one tile, 64-lane quantized, floored at 64 and capped at the
    batch.  Skewed extents run more tiles of the same width."""
    tile = max(64, -(-int(b) // max(1, int(n_shards))))
    tile = -(-tile // 64) * 64
    return min(tile, int(b))


def shard_block(table: torch.Tensor, shard: int,
                local_capacity: int) -> torch.Tensor:
    """Shard ``shard``'s (L + 1, 16) block of the sharded table, a view."""
    lo = shard * (local_capacity + 1)
    return table[lo:lo + local_capacity + 1]


def ragged_walk(tick_tile: Callable, table: torch.Tensor, m: np.ndarray,
                start: int, count: int, lo: int, local_capacity: int,
                tile: int, out: torch.Tensor) -> torch.Tensor:
    """Walk one shard's ``[start, start + count)`` extent of the flat
    slot-sorted (19, B) host matrix ``m`` in ``tile``-wide steps.

    ``tick_tile(table, blk)`` ticks a (19, tile) host block of LOCAL slots
    on the shard's ``table`` and returns its (6, tile) int32 response on
    the table's device.  Tiles near the batch edge clamp their base into
    ``[0, B - tile]``; lanes a tile re-reads or reads past the extent go in
    as guard lanes (slot = ``local_capacity``, valid = 0) and keep the
    value already in ``out``, so the (6, B) ``out`` (zeros off the extent
    when the caller zeroed it) is written exactly once per extent lane.
    A duplicate run split across two tiles is two sequential ticks of its
    slot, as in the reference's walk."""
    R = REQ32_INDEX
    b = m.shape[1]
    tile = min(int(tile), b)
    end = start + count
    for t in range(-(-count // tile) if tile else 0):
        a = start + t * tile
        actual = min(max(a, 0), b - tile)
        lane = actual + np.arange(tile)
        live = (lane >= a) & (lane < end)
        blk = np.array(m[:, actual:actual + tile])
        blk[R["slot"]] = np.where(live, blk[R["slot"]] - lo, local_capacity)
        blk[R["valid"]] = live & (blk[R["valid"]] != 0)
        resp = tick_tile(table, blk)
        x, y = max(a, actual), min(end, actual + tile)
        out[:, x:y] = resp[:, x - actual:y - actual]
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ragged_tick")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_fused_ragged_tick.restype = ctypes.c_int
    lib.gt_fused_ragged_tick.argtypes = [
        vp, i64, i64, vp, vp, i64, vp, i64, i64, i64, vp]
    return lib


def fused_ragged_tick_plain(table: torch.Tensor, m32: torch.Tensor,
                            offsets: torch.Tensor, n_shards: int,
                            local_capacity: int, now: int,
                            out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ragged tick kernel: for each shard, the
    fused tick's plain version on the shard's block over its extent's
    lanes, slots rebased (a slot outside the shard aims at the block's
    guard row), zeros on every other lane; the shards' responses summed."""
    R = REQ32_INDEX
    L = int(local_capacity)
    bounds = [int(v) for v in offsets.tolist()]
    total = torch.zeros((RESP_ROWS, m32.shape[1]), dtype=torch.int32,
                        device=m32.device)
    for s in range(int(n_shards)):
        a, z = bounds[s], bounds[s + 1]
        if a >= z:
            continue
        ms = m32[:, a:z].clone()
        local = ms[R["slot"]].to(torch.int64) - s * L
        ms[R["slot"]] = torch.where((local >= 0) & (local < L), local,
                                    L).to(torch.int32)
        part = torch.zeros_like(total)
        fused_tick_plain(shard_block(table, s, L), ms, now, part[:, a:z])
        total += part
    out.copy_(total)
    return out


def fused_ragged_tick(table: torch.Tensor, m32: torch.Tensor,
                      offsets: torch.Tensor, n_shards: int,
                      local_capacity: int, now: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply a unique-slot mesh window to the sharded ``table`` in place:
    lane j of shard s (``offsets[s] <= j < offsets[s + 1]``) ticks row
    ``s * (L + 1) + slot - s * L``.  Lanes off every extent, lanes with
    ``valid == 0`` and slots outside their shard touch no row and answer
    zeros.  Returns the (6, B) int32 compact response (``out`` when
    given).

    ``table`` is the contiguous (n_shards * (L + 1), 16) int64 table,
    ``m32`` a (19, B) int32 REQ32 matrix of global slots with unit column
    stride, ``offsets`` a contiguous (n_shards + 1,) int32 vector on the
    table's device, which the launch does not read back."""
    _check_table(table)
    n_shards, L = int(n_shards), int(local_capacity)
    if n_shards < 1 or L < 1 or table.shape[0] != n_shards * (L + 1):
        raise ValueError("table must hold n_shards blocks of "
                         "local_capacity + 1 rows")
    if n_shards * L >= 1 << 31:
        raise ValueError("global slots must fit int32")
    if m32.dim() != 2 or m32.shape[0] != REQ32_ROWS \
            or m32.dtype != torch.int32 or m32.stride(1) != 1:
        raise ValueError("m32 must be (19, B) int32 with unit column stride")
    if offsets.shape != (n_shards + 1,) or offsets.dtype != torch.int32 \
            or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous (n_shards + 1,) int32 "
                         "tensor")
    b = m32.shape[1]
    if out is None:
        out = torch.empty((RESP_ROWS, b), dtype=torch.int32,
                          device=table.device)
    if out.shape != (RESP_ROWS, b) or out.dtype != torch.int32 \
            or out.stride(1) != 1:
        raise ValueError("out must be (6, B) int32 with unit column stride")
    if not (m32.device == offsets.device == out.device == table.device):
        raise ValueError("table, m32, offsets and out must share one device")
    now = int(now)
    if table.device.type == "cpu":
        return fused_ragged_tick_plain(table, m32, offsets, n_shards, L, now,
                                       out)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    rc = _lib().gt_fused_ragged_tick(
        table.data_ptr(), n_shards, L, offsets.data_ptr(), m32.data_ptr(),
        m32.stride(0), out.data_ptr(), out.stride(0), b, now,
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "fused_ragged_tick")
    count_launch(fused_ragged_tick, b)
    return out


fused_ragged_tick.launches = 0
fused_ragged_tick.launches_by_width = {}
