"""The chained duplicate tick: a slot-sorted window whose slots repeat.

:func:`fused_sorted_tick` launches the CUDA kernel
``csrc/fused_sorted_tick.cu`` (kernel B.5), the counterpart of the TPU
package's ``tick32.make_sorted_tick32_rows_fn`` program, which the JAX
engine runs for duplicate windows that neither the grouped nor the layered
plan takes.  One launch a window, two kinds of block
(``csrc/sorted_tick.cuh``): a segment (the lanes of one slot) of at most
one chunk (the build's, :func:`kernel_config`) runs in one thread; a
longer one gets a block that walks it a chunk at a time, the request-only
half of each transition computed for the chunk's lanes in parallel and
the rest, which reads the row, applied lane after lane by one thread.
The kernel needs no scratch.  :func:`fused_sorted_tick_plain` is its plain PyTorch version:
rank rounds of :func:`~.fusedtick.fused_tick_plain` (round k holds the
k-th request of every slot, so each round is a unique-slot window and
round k + 1 reads the rows round k wrote), run for CPU tensors only.

Contract: ``m32`` is a (19, B) int32 REQ32 matrix with unit column stride,
sorted by slot; a slot may repeat.  The requests of one slot apply one
after another in window order, each through the fused tick's x64
transition: the per-key order of the reference's x64 oracle
``engine._jitted_tick(cap, "columns", sorted_input=True, ...)``.  Lanes
with ``valid == 0`` or a slot outside ``[0, capacity)`` (padding and
per-item errors) touch no row and answer zeros.  Lane k of the (6, B)
int32 response answers lane k of the window.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.fusedtick import (
    REQ32_INDEX, RESP_ROWS, _check_table, check_window, count_launch,
    fused_tick_plain)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_sorted_tick")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_fused_sorted_tick.restype = ctypes.c_int
    lib.gt_fused_sorted_tick.argtypes = [vp, i64, vp, i64, vp, i64, i64, i64,
                                         vp]
    lib.gt_fused_sorted_tick_config.restype = ctypes.c_int
    lib.gt_fused_sorted_tick_config.argtypes = [vp]
    return lib


CONFIG_KEYS = ("chunk", "threads", "smem_bytes")


def kernel_config() -> dict:
    """The built kernel's chunk (the most lanes of a segment that one
    thread runs, and the lanes a longer segment's block stages at a time),
    threads a block and dynamic shared memory bytes a block (builds the
    kernel: needs ``nvcc``)."""
    out = (ctypes.c_int64 * len(CONFIG_KEYS))()
    _lib().gt_fused_sorted_tick_config(out)
    return dict(zip(CONFIG_KEYS, out))


def rank_rounds(slots: np.ndarray, capacity: int):
    """Host plan of the rank rounds of a window with slot row ``slots``
    (sorted).

    Returns ``(perm, bounds)``: ``m[:, perm]`` lays the rounds out one
    after another (each still slot-sorted, each slot at most once), and
    round k is columns ``[bounds[k], bounds[k + 1])``.  Lanes aimed at the
    padding sentinel ``capacity`` (per-item errors) stay in round 0; they
    never write the table."""
    n = len(slots)
    idx = np.arange(n, dtype=np.int64)
    start = np.ones(n, bool)
    start[1:] = slots[1:] != slots[:-1]
    seg_start = np.maximum.accumulate(np.where(start, idx, 0))
    rank = idx - seg_start
    rank[slots >= capacity] = 0
    perm = np.lexsort((idx, rank))
    counts = np.bincount(rank)
    bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    return perm, bounds


def fused_sorted_tick_plain(table: torch.Tensor, m32: torch.Tensor, now: int,
                            out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the chained duplicate tick: the window's
    rank rounds (planned on the host from its slot row) through the fused
    tick's plain version, the responses put back in the window's lane
    order.  ``fused_sorted_tick_plain.rounds`` counts the rounds run."""
    b = m32.shape[1]
    perm, bounds = rank_rounds(m32[REQ32_INDEX["slot"]].cpu().numpy(),
                               table.shape[0] - 1)
    p = torch.from_numpy(perm).to(m32.device)
    rounds = m32[:, p].contiguous()
    resp = torch.empty((RESP_ROWS, b), dtype=torch.int32, device=out.device)
    for a, e in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        fused_tick_plain(table, rounds[:, a:e], now, resp[:, a:e])
    fused_sorted_tick_plain.rounds += len(bounds) - 1
    out[:, p] = resp
    return out


fused_sorted_tick_plain.rounds = 0


def fused_sorted_tick(table: torch.Tensor, m32: torch.Tensor, now: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one slot-sorted window that may repeat slots to ``table`` in
    place; returns the (6, B) int32 compact response (``out`` when
    given), lane k answering window lane k."""
    _check_table(table)
    out = check_window(table, m32, out)
    now = int(now)
    if table.device.type == "cpu":
        return fused_sorted_tick_plain(table, m32, now, out)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    b = m32.shape[1]
    rc = _lib().gt_fused_sorted_tick(
        table.data_ptr(), table.shape[0] - 1, m32.data_ptr(), m32.stride(0),
        out.data_ptr(), out.stride(0), b, now,
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "fused_sorted_tick")
    count_launch(fused_sorted_tick, b)
    return out


fused_sorted_tick.launches = 0
fused_sorted_tick.launches_by_width = {}
