"""The fused ticks: gather, transition, scatter, compact response.

:func:`fused_tick` launches the CUDA kernel ``csrc/fused_tick.cu``, which
replaces the TPU package's ``fusedtick.make_fused_tick_fn`` Pallas kernel;
:func:`fused_tick_plain` is its plain PyTorch version (gather, then
ops/transition.py, then scatter, then pack to (6, B)), which the wrapper
runs for CPU tensors only.  :func:`fused_merged_tick` and
:func:`fused_merged_tick_plain` are the same pair for
``csrc/fused_merged_tick.cu``, which replaces
``fusedtick.make_fused_merged_tick_fn``: unique group heads, the
closed-form duplicate fold, and a row-major (U, 24) journal.

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
from gubernator_tpu_torch.ops.transition import bucket_transition, merged_fold

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


def width_bucket(lanes: int) -> int:
    """The power of two a launch of ``lanes`` lanes is counted under: the
    least one at or above it."""
    return 1 << max(int(lanes) - 1, 0).bit_length()


def count_launch(wrapper, lanes: int) -> None:
    """One launch of a tick wrapper's kernel: its total and its count by
    lane width (``wrapper.launches_by_width``, keyed by width_bucket)."""
    wrapper.launches += 1
    k = width_bucket(lanes)
    wrapper.launches_by_width[k] = wrapper.launches_by_width.get(k, 0) + 1


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


def _transition_lanes(table: torch.Tensor, m32: torch.Tensor, now: int):
    """The plain versions' shared first half: each lane's request
    columns, whether it is live, the slot it reads (the guard row when
    not live), and the transition of its gathered row."""
    cap = table.shape[0] - 1
    r = unpack_req32(m32)
    live = (r["valid"] != 0) & (r["slot"] >= 0) & (r["slot"] < cap)
    slots = torch.where(live, r["slot"], cap)
    s = rows_to_logical(gather_rows_plain(table, slots))
    new_state, resp = bucket_transition(now, s, r)
    return r, live, slots, new_state, resp


def _check_table(table: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.int64 \
            or table.shape[1] != 16 or not table.is_contiguous():
        raise ValueError("table must be a contiguous (capacity + 1, 16) int64 tensor")


def fused_tick_plain(table: torch.Tensor, m32: torch.Tensor, now: int,
                     out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused tick kernel (see module doc)."""
    _, live, slots, new_state, resp = _transition_lanes(table, m32, now)
    scatter_rows_plain(table, slots, logical_to_rows(new_state))
    out.copy_(pack_resp_compact(resp, live))
    return out


def check_window(table: torch.Tensor, m32: torch.Tensor,
                 out: Optional[torch.Tensor]) -> torch.Tensor:
    """Check a (19, B) request window and its (6, B) response against the
    table; returns ``out``, allocated when None."""
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
    return out


def fused_tick(table: torch.Tensor, m32: torch.Tensor, now: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one unique-slot window to ``table`` in place; returns the
    (6, B) int32 compact response (``out`` when given)."""
    _check_table(table)
    out = check_window(table, m32, out)
    b = m32.shape[1]
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
    count_launch(fused_tick, b)
    return out


fused_tick.launches = 0
fused_tick.launches_by_width = {}


# ----------------------------------------------------------------------
# The merged tick: unique heads of duplicate groups (kernel B.3)
# ----------------------------------------------------------------------
# Row-major MERGED24 journal row of one head (transition32.merged24_rows
# order): the six compact response words, the fold's base, q, rate_i (each
# a lo/hi pair), s0 and expire, then the echoed hits, limit, created_at,
# algorithm and behavior; word 23 is 0.
MERGED24_W = 24


@functools.lru_cache(maxsize=None)
def _merged_lib() -> ctypes.CDLL:
    lib = _build.load("fused_merged_tick")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gt_fused_merged_tick.restype = ctypes.c_int
    lib.gt_fused_merged_tick.argtypes = [vp, i64, vp, i64, vp, vp, i64, i64, vp]
    return lib


def pack_merged24(resp: Dict[str, torch.Tensor], head: Dict[str, torch.Tensor],
                  r: Dict[str, torch.Tensor], live: torch.Tensor) -> torch.Tensor:
    """Response, fold extras and request columns → (U, 24) int32 journal
    rows; padding heads get zero rows."""
    def pair(v):
        return [(v & 0xFFFFFFFF).to(torch.int32), (v >> 32).to(torch.int32)]

    cols = [resp["status"].to(torch.int32), resp["over_limit"].to(torch.int32)]
    for v in (resp["remaining"], resp["reset_time"], head["base"], head["q"],
              head["rate_i"]):
        cols += pair(v)
    cols.append(head["s0"].to(torch.int32))
    for v in (head["expire"], r["hits"], r["limit"], r["created_at"]):
        cols += pair(v)
    cols += [r["algorithm"].to(torch.int32), r["behavior"].to(torch.int32),
             torch.zeros_like(cols[0])]
    return torch.where(live[:, None], torch.stack(cols, dim=1), 0)


def fused_merged_tick_plain(table: torch.Tensor, mhead: torch.Tensor,
                            count: torch.Tensor, now: int,
                            out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the merged tick kernel: the fused tick's
    gather and transition, then ops/transition.py merged_fold, then the
    scatter and the journal rows."""
    r, live, slots, new_state, resp = _transition_lanes(table, mhead, now)
    folded, head = merged_fold(now, new_state, r, count)
    scatter_rows_plain(table, slots, logical_to_rows(folded))
    out.copy_(pack_merged24(resp, head, r, live))
    return out


def fused_merged_tick(table: torch.Tensor, mhead: torch.Tensor,
                      count: torch.Tensor, now: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one window of unique group heads to ``table`` in place, each
    folding its ``count - 1`` identical followers; returns the (U, 24)
    int32 MERGED24 journal (``out`` when given).

    ``mhead`` is a (19, U) int32 REQ32 matrix with unit column stride
    (slot-sorted unique live slots; padding heads aim at ``capacity``),
    ``count`` a contiguous (U,) int32 vector of group sizes, ``out`` a
    contiguous (U, 24) int32 tensor, 16-B aligned (for instance a row
    slice of a wider journal)."""
    _check_table(table)
    if mhead.dim() != 2 or mhead.shape[0] != REQ32_ROWS \
            or mhead.dtype != torch.int32 or mhead.stride(1) != 1:
        raise ValueError("mhead must be (19, U) int32 with unit column stride")
    u = mhead.shape[1]
    if count.shape != (u,) or count.dtype != torch.int32 \
            or not count.is_contiguous():
        raise ValueError("count must be a contiguous (U,) int32 tensor")
    if out is None:
        out = torch.empty((u, MERGED24_W), dtype=torch.int32, device=table.device)
    if out.shape != (u, MERGED24_W) or out.dtype != torch.int32 \
            or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("out must be a contiguous, 16-B aligned (U, 24) int32 tensor")
    if not (mhead.device == count.device == out.device == table.device):
        raise ValueError("table, mhead, count and out must share one device")
    now = int(now)
    if table.device.type == "cpu":
        return fused_merged_tick_plain(table, mhead, count, now, out)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    rc = _merged_lib().gt_fused_merged_tick(
        table.data_ptr(), table.shape[0] - 1, mhead.data_ptr(),
        mhead.stride(0), count.data_ptr(), out.data_ptr(), u, now,
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "fused_merged_tick")
    count_launch(fused_merged_tick, u)
    return out


fused_merged_tick.launches = 0
fused_merged_tick.launches_by_width = {}
