"""The mesh's duplicate tile tick: a mesh window whose slots repeat.

:func:`mesh_tile_tick` launches the CUDA kernel ``csrc/mesh_tile_tick.cu``
(kernel B.6), the counterpart of the TPU package's x64 tile tick
(``engine.make_tick_fn(..., compact_req=True, compact_resp=True)``),
which its mesh engine runs tile after tile over each shard's extent of a
window with a repeated key.  One launch a window: a warp takes each
32-lane window's runs at once (a head lane ticks each, its followers
answer the x64 closed-form fold in parallel or hand their prepared links
to the head lane), a run that leaves its window goes to the warp whole,
and a run past 256 lanes to a run block, which takes its pieces (its
lanes in one chunk of the walk) in order (``csrc/mesh_tile_tick.cuh``).

:func:`mesh_tile_tick_plain` is its plain PyTorch version, run for CPU
tensors only: the tile walk itself, :func:`~.raggedtick.ragged_walk` over
:func:`~.tick.merge_tick` (plain PyTorch throughout) on each shard's
block, chunks ``[a + k * tile, min(z, a + (k + 1) * tile))`` of the
extent ``[a, z)``.

Contract: ``m32`` is a (19, B) int32 REQ32 matrix of GLOBAL slots with
unit column stride, sorted by slot; ``offsets`` the (n_shards + 1,) int32
extent offsets on the table's device; ``tile`` the walk's chunk width
(``raggedtick.choose_tile``).  Lanes off every extent answer zeros.
``rounds`` is an int64 (1,) tensor on the table's device to which the
call adds the window's rank rounds: for each chunk, the most followers of
one of its groups that did not fold in closed form (the rounds the plain
walk runs).  ``scratch`` is a :class:`TileScratch` that one caller (one
stream) keeps for its windows, so a launch needs no memset; without one a
call makes its own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.fusedtick import (
    REQ32_ROWS, RESP_ROWS, _check_table, count_launch)
from gubernator_tpu_torch.ops.raggedtick import ragged_walk, shard_block
from gubernator_tpu_torch.ops.tick import merge_tick


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mesh_tile_tick")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_mesh_tile_tick.restype = ctypes.c_int
    lib.gt_mesh_tile_tick.argtypes = [
        vp, i64, i64, vp, vp, i64, vp, i64, i64, i64, i64, vp, i64, vp, vp]
    lib.gt_mesh_tile_tick_scratch_words.restype = i64
    lib.gt_mesh_tile_tick_scratch_words.argtypes = [i64, i64, i64]
    return lib


class TileScratch:
    """The kernel's scratch for one caller: int64 words zeroed once, and
    the count of launches on them (each launch's epoch, which tags what it
    leaves there, so the next one needs no memset).  Grown, and zeroed
    again, when a window needs more words or the count would wrap."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.words = torch.zeros(0, dtype=torch.int64, device=self.device)
        self.epoch = 0

    def take(self, n_words: int) -> tuple:
        """``(words, epoch)`` for the next launch."""
        if n_words > self.words.numel() or self.epoch >= 0xFFFFFFFF:
            self.words = torch.zeros(max(int(n_words), 1), dtype=torch.int64,
                                     device=self.device)
            self.epoch = 0
        self.epoch += 1
        return self.words, self.epoch


def mesh_tile_tick_plain(table: torch.Tensor, m32: torch.Tensor,
                         offsets: torch.Tensor, n_shards: int,
                         local_capacity: int, tile: int, now: int,
                         rounds: torch.Tensor,
                         out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the mesh's duplicate tile tick: each
    shard's extent walked in ``tile`` chunks, each through the plain
    merge tick on the shard's block; zeros off every extent."""
    m = m32.cpu().numpy()
    bounds = [int(v) for v in offsets.tolist()]
    L = int(local_capacity)
    out.zero_()
    total = 0

    def tick_tile(block, blk):
        nonlocal total
        resp, r = merge_tick(block, blk, now)
        total += r
        return resp

    for s in range(int(n_shards)):
        a, z = bounds[s], bounds[s + 1]
        ragged_walk(tick_tile, shard_block(table, s, L), m, a, z - a, s * L,
                    L, tile, out)
    rounds += total
    return out


def mesh_tile_tick(table: torch.Tensor, m32: torch.Tensor,
                   offsets: torch.Tensor, n_shards: int, local_capacity: int,
                   tile: int, now: int, rounds: torch.Tensor,
                   out: Optional[torch.Tensor] = None,
                   scratch: Optional[TileScratch] = None) -> torch.Tensor:
    """Apply a slot-sorted mesh window that may repeat slots to the
    sharded ``table`` in place (the contract in the module doc); returns
    the (6, B) int32 compact response (``out`` when given)."""
    _check_table(table)
    n_shards, L, tile = int(n_shards), int(local_capacity), int(tile)
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
    if rounds.shape != (1,) or rounds.dtype != torch.int64:
        raise ValueError("rounds must be a (1,) int64 tensor")
    b = m32.shape[1]
    if tile < 1 and b:
        raise ValueError("tile must be positive")
    if out is None:
        out = torch.empty((RESP_ROWS, b), dtype=torch.int32,
                          device=table.device)
    if out.shape != (RESP_ROWS, b) or out.dtype != torch.int32 \
            or out.stride(1) != 1:
        raise ValueError("out must be (6, B) int32 with unit column stride")
    if not (m32.device == offsets.device == out.device == rounds.device
            == table.device):
        raise ValueError("table, m32, offsets, rounds and out must share "
                         "one device")
    if scratch is not None and scratch.device != table.device:
        raise ValueError("scratch must be on the table's device")
    now = int(now)
    if table.device.type == "cpu":
        return mesh_tile_tick_plain(table, m32, offsets, n_shards, L, tile,
                                    now, rounds, out)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if not b:
        return out
    lib = _lib()
    if scratch is None:
        scratch = TileScratch(table.device)
    words, epoch = scratch.take(
        lib.gt_mesh_tile_tick_scratch_words(b, tile, n_shards))
    rc = lib.gt_mesh_tile_tick(
        table.data_ptr(), n_shards, L, offsets.data_ptr(), m32.data_ptr(),
        m32.stride(0), out.data_ptr(), out.stride(0), b, tile, now,
        words.data_ptr(), epoch, rounds.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "mesh_tile_tick")
    count_launch(mesh_tile_tick, b)
    return out


mesh_tile_tick.launches = 0
mesh_tile_tick.launches_by_width = {}
