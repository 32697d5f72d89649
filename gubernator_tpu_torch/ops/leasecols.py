"""The quota-lease columns: one window of lanes into three columns (B.9).

The kernel (``csrc/lease_apply.cu``) replaces the TPU package's
``ops/engine.py`` ``_jitted_lease_apply``, an XLA program that scatters a
window into the lease columns beside the table (docs/leases.md): budget
(int64), expiry (int64, epoch ms) and generation (int32), each
``capacity + 1`` entries, the last a guard that nothing writes.

The engine keeps the three columns as views of one table of 32-B
records, a slot's budget, expiry and generation side by side in one DRAM
sector (:func:`lease_records`), the only layout the kernel takes: it
writes each record whole, its 12 B of padding staying 0.  Each view reads
and writes as the column it stands for, so everything outside this module
sees three columns.

A window is a (4, n) int64 lane matrix (slot, budget, expiry, generation),
made on the host by :func:`pack_lanes` and copied to the device in one
transfer.  ``is_set`` installs each lane's triple; otherwise the budgets
add as deltas clamped at 0 and expiry and generation only move forward.
The reference clamps the whole budget column after the adds; the kernel
clamps only the lanes' slots, which is the same because :func:`pack_lanes`
gives each slot one lane and adds a zero lane for every slot whose budget
is negative (only a set window or a snapshot load writes one).

:func:`lease_apply` launches the kernel for CUDA tensors (counted in
``lease_apply.launches`` and ``launches_by_width``) and runs the plain
PyTorch version, :func:`lease_apply_plain`, for CPU tensors.  There is no
fallback: a CUDA tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.fusedtick import count_launch

# Lane rows of the (4, n) window matrix.
SLOT, BUDGET, EXPIRE, GEN = range(4)

# int64 words of a slot's record: budget, expiry, generation (the low
# half of the third word), padding.
RECORD_WORDS = 4

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64
_INT64_MIN = np.iinfo(np.int64).min
_INT32_MIN = np.iinfo(np.int32).min


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lease_apply")
    lib.gt_lease_apply.restype = ctypes.c_int
    lib.gt_lease_apply.argtypes = [_vp, _i64, _vp, _i64, ctypes.c_int, _vp]
    return lib


def lease_records(capacity: int, device) -> tuple:
    """Zeroed lease columns of ``capacity`` slots and the guard entry:
    (budget, expire, gen) int64 / int64 / int32 views of one
    (capacity + 1, 4) int64 record table, the layout the kernel takes."""
    rec = torch.zeros((capacity + 1, RECORD_WORDS), dtype=torch.int64,
                      device=device)
    return rec[:, 0], rec[:, 1], rec.view(torch.int32)[:, 4]


def _are_records(budget: torch.Tensor, expire: torch.Tensor,
             gen: torch.Tensor) -> bool:
    """Whether the columns are :func:`lease_records`' views of one record
    table."""
    base = budget.data_ptr()
    return (budget.stride() == (RECORD_WORDS,)
            and expire.stride() == (RECORD_WORDS,)
            and gen.stride() == (2 * RECORD_WORDS,)
            and expire.data_ptr() == base + 8
            and gen.data_ptr() == base + 16
            and budget.untyped_storage().data_ptr()
            == gen.untyped_storage().data_ptr()
            and base % 32 == 0)


def pack_lanes(slots: np.ndarray, budgets: Sequence[int],
               expires: Sequence[int], gens: Sequence[int], is_set: bool,
               negative: Sequence[int] = ()) -> np.ndarray:
    """The (4, m) int64 lane matrix of one window, one lane a slot.

    ``slots`` are the window's resolved slots (every one in the table),
    lane by lane with ``budgets``, ``expires`` and ``gens``; generations
    are cut to int32 as the column stores them.  A set window keeps the
    last lane of a slot that repeats.  A delta window merges a slot's
    lanes (budgets summed, expiry and generation their max) and adds a
    zero lane for each slot of ``negative`` (slots whose budget is below
    0) that the window does not touch, so the clamp reaches it."""
    lanes = np.stack([
        np.asarray(slots, np.int64), np.asarray(budgets, np.int64),
        np.asarray(expires, np.int64),
        np.asarray(gens, np.int64).astype(np.int32).astype(np.int64)]
    ).reshape(4, -1)
    s = lanes[SLOT]
    if is_set:
        _, ridx = np.unique(s[::-1], return_index=True)
        return np.ascontiguousarray(lanes[:, len(s) - 1 - ridx])
    order = np.argsort(s, kind="stable")
    uniq, start = np.unique(s[order], return_index=True)
    if len(uniq) < len(s):
        srt = lanes[:, order]
        lanes = np.stack([
            uniq, np.add.reduceat(srt[BUDGET], start),
            np.maximum.reduceat(srt[EXPIRE], start),
            np.maximum.reduceat(srt[GEN], start)])
    extra = np.setdiff1d(np.asarray(negative, np.int64), uniq)
    if len(extra):
        zero = np.stack([extra, np.zeros_like(extra),
                         np.full_like(extra, _INT64_MIN),
                         np.full_like(extra, _INT32_MIN)])
        lanes = np.concatenate([lanes, zero], axis=1)
    return np.ascontiguousarray(lanes)


def _check(budget: torch.Tensor, expire: torch.Tensor, gen: torch.Tensor,
           lanes: torch.Tensor) -> None:
    n = budget.shape[0] if budget.dim() == 1 else -1
    for col, dt in ((budget, torch.int64), (expire, torch.int64),
                    (gen, torch.int32)):
        if col.dim() != 1 or col.dtype != dt or col.shape[0] != n \
                or col.device != budget.device:
            raise ValueError(
                "lease columns must be 1-D int64 / int64 / int32 tensors of "
                "one length on one device")
    if lanes.dim() != 2 or lanes.shape[0] != 4 or lanes.dtype != torch.int64 \
            or not lanes.is_contiguous() or lanes.device != budget.device:
        raise ValueError("lanes must be a contiguous (4, n) int64 tensor on "
                         "the columns' device")


def lease_apply_plain(budget: torch.Tensor, expire: torch.Tensor,
                      gen: torch.Tensor, lanes: torch.Tensor,
                      is_set: bool) -> None:
    """The window as eager torch ops, in place: three index writes, or an
    accumulating add, a clamp of the whole budget column and two
    scatter-max.  Lanes outside ``[0, capacity)`` are aimed at the guard
    entry, which is zeroed again after (no host sync)."""
    cap = budget.shape[0] - 1
    slot = lanes[SLOT]
    idx = torch.where((slot >= 0) & (slot < cap), slot, cap)
    bud, exp, g = lanes[BUDGET], lanes[EXPIRE], lanes[GEN].to(torch.int32)
    if is_set:
        budget[idx] = bud
        expire[idx] = exp
        gen[idx] = g
    else:
        budget.index_put_((idx,), bud, accumulate=True)
        budget.clamp_(min=0)
        expire.scatter_reduce_(0, idx, exp, "amax")
        gen.scatter_reduce_(0, idx, g, "amax")
    for col in (budget, expire, gen):
        col[cap:].zero_()  # a fill on the device, no host scalar copy


def lease_apply(budget: torch.Tensor, expire: torch.Tensor,
                gen: torch.Tensor, lanes: torch.Tensor, is_set: bool) -> None:
    """Apply one window of :func:`pack_lanes` lanes to the lease columns in
    place: one kernel launch for CUDA tensors (the columns
    :func:`lease_records` views), the plain version for CPU tensors (any
    layout)."""
    _check(budget, expire, gen, lanes)
    if budget.device.type == "cpu":
        lease_apply_plain(budget, expire, gen, lanes, is_set)
        return
    if budget.device.type != "cuda":
        raise ValueError(f"unsupported device {budget.device}")
    if not _are_records(budget, expire, gen):
        raise ValueError("lease columns on the card must be lease_records() "
                         "views of one record table")
    n = lanes.shape[1]
    rc = _lib().gt_lease_apply(
        budget.data_ptr(), budget.shape[0] - 1, lanes.data_ptr(), n,
        1 if is_set else 0,
        torch.cuda.current_stream(budget.device).cuda_stream)
    _build.check(rc, "lease_apply")
    count_launch(lease_apply, n)


lease_apply.launches = 0
lease_apply.launches_by_width = {}


__all__ = ["SLOT", "BUDGET", "EXPIRE", "GEN", "RECORD_WORDS", "lease_records",
           "pack_lanes", "lease_apply", "lease_apply_plain"]
