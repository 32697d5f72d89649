"""The fused unique-slot tick: gather, transition, scatter, compact response.

:func:`fused_tick` launches the CUDA kernel ``csrc/fused_tick.cu``, which
replaces the TPU package's ``fusedtick.make_fused_tick_fn`` Pallas kernel;
:func:`fused_tick_plain` is its plain PyTorch version (gather, then
ops/transition.py, then scatter, then pack to (6, B)), which the wrapper
runs for CPU tensors only.

Contract: ``m32`` is a (19, B) int32 REQ32 request matrix (rows as in
``REQ32_INDEX``), slot-sorted with at most one live lane per
real slot; it may be a column slice of a wider matrix (unit column
stride).  Lanes with ``valid == 0`` or ``slot == capacity`` (padding and
per-item errors) read the guard row, write nothing to the table and
answer zeros.  The table is updated in place; ``out`` receives the (6, B)
int32 compact response: status, over_limit, remaining lo/hi,
reset_time lo/hi.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.buckets import logical_to_rows, rows_to_logical
from gubernator_tpu_torch.ops.rowtable import (
    gather_rows_plain, scatter_rows_plain)
from gubernator_tpu_torch.ops.transition import bucket_transition

# Compact int32 request wire format: narrow fields ride one i32 row each,
# 8-byte fields ride (lo, hi) i32 pairs: 76 B a request.  csrc/transition.cuh
# holds the same row numbers.
REQ32_NARROW = ("slot", "known", "algorithm", "behavior", "valid")
REQ32_WIDE = (
    "hits", "limit", "duration", "created_at", "burst",
    "greg_exp", "greg_dur",
)
REQ32_INDEX = {name: i for i, name in enumerate(REQ32_NARROW)}
for _j, _name in enumerate(REQ32_WIDE):
    REQ32_INDEX[_name] = len(REQ32_NARROW) + 2 * _j  # the lo row; hi = +1
REQ32_ROWS = len(REQ32_NARROW) + 2 * len(REQ32_WIDE)  # 19
RESP_ROWS = 6


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_tick")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_fused_tick.restype = ctypes.c_int
    lib.gt_fused_tick.argtypes = [vp, i64, vp, i64, vp, i64, i64, i64, vp]
    return lib


def unpack_req32(m32: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(19, B) int32 REQ32 matrix → logical int64 request columns."""
    r = {name: m32[REQ32_INDEX[name]].to(torch.int64) for name in REQ32_NARROW}
    for name in REQ32_WIDE:
        row = REQ32_INDEX[name]
        lo = m32[row].to(torch.int64) & 0xFFFFFFFF
        r[name] = (m32[row + 1].to(torch.int64) << 32) | lo
    return r


def pack_resp_compact(resp: Dict[str, torch.Tensor],
                      live: torch.Tensor) -> torch.Tensor:
    """Response columns → (6, B) int32; non-live lanes answer zeros."""
    def split(v):
        return (v & 0xFFFFFFFF).to(torch.int32), (v >> 32).to(torch.int32)

    rl, rh = split(resp["remaining"])
    tl, th = split(resp["reset_time"])
    rows = torch.stack([
        resp["status"].to(torch.int32), resp["over_limit"].to(torch.int32),
        rl, rh, tl, th,
    ])
    return torch.where(live, rows, 0)


def fused_tick_plain(table: torch.Tensor, m32: torch.Tensor, now: int,
                     out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused tick kernel (see module doc)."""
    cap = table.shape[0] - 1
    r = unpack_req32(m32)
    live = (r["valid"] != 0) & (r["slot"] >= 0) & (r["slot"] < cap)
    slots = torch.where(live, r["slot"], cap)
    s = rows_to_logical(gather_rows_plain(table, slots))
    new_state, resp = bucket_transition(now, s, r)
    scatter_rows_plain(table, slots, logical_to_rows(new_state))
    out.copy_(pack_resp_compact(resp, live))
    return out


def fused_tick(table: torch.Tensor, m32: torch.Tensor, now: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one unique-slot window to ``table`` in place; returns the
    (6, B) int32 compact response (``out`` when given)."""
    if table.dim() != 2 or table.dtype != torch.int64 \
            or table.shape[1] != 16 or not table.is_contiguous():
        raise ValueError("table must be a contiguous (capacity + 1, 16) int64 tensor")
    if m32.dim() != 2 or m32.shape[0] != REQ32_ROWS or m32.dtype != torch.int32 \
            or m32.stride(1) != 1:
        raise ValueError("m32 must be (19, B) int32 with unit column stride")
    b = m32.shape[1]
    if out is None:
        out = torch.empty((RESP_ROWS, b), dtype=torch.int32, device=table.device)
    if out.shape != (RESP_ROWS, b) or out.dtype != torch.int32 or out.stride(1) != 1:
        raise ValueError("out must be (6, B) int32 with unit column stride")
    if m32.device != table.device or out.device != table.device:
        raise ValueError("table, m32 and out must share one device")
    now = int(now)
    if table.device.type == "cpu":
        return fused_tick_plain(table, m32, now, out)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    rc = _lib().gt_fused_tick(
        table.data_ptr(), table.shape[0] - 1, m32.data_ptr(), m32.stride(0),
        out.data_ptr(), out.stride(0), b, now,
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "fused_tick")
    fused_tick.launches += 1
    return out


fused_tick.launches = 0
