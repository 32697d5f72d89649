"""The row table: gather, scatter, eviction and the dead-slot scan.

Kernels (``csrc/rows.cu``) replace the TPU package's ``rowtable.gather_rows``
and ``rowtable.scatter_rows`` Pallas kernels.  Each wrapper checks its
tensors, launches its CUDA kernel on the current stream for CUDA tensors
(counting the launch in ``<wrapper>.launches``), and runs the plain
PyTorch version beside it for CPU tensors.  There is no fallback: a CUDA
tensor that the kernel cannot take raises.

The table is (capacity + 1, ROW_W) int64 with the guard row at index
``capacity`` (see ops/buckets.py).  Gathers clamp slots into
``[0, capacity]``; scatters drop lanes aimed at the guard row, and two
lanes with one real slot are a caller bug.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.buckets import (
    NP_DTYPES, ROW_W, STATE_FIELDS, WORD, rows_to_logical)

# Width cap of one dead-scan gather: bounds the gathered-row scratch
# (128 MB at ROW_W = 16).
SCAN_CHUNK = 1 << 20

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rows")
    lib.gt_gather_rows.restype = ctypes.c_int
    lib.gt_gather_rows.argtypes = [_vp, _i64, _i64, _vp, _i64, _vp, _vp]
    lib.gt_scatter_rows.restype = ctypes.c_int
    lib.gt_scatter_rows.argtypes = [_vp, _i64, _i64, _vp, _i64, _vp, _vp]
    return lib


def _check_table(table: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.int64:
        raise ValueError(f"table must be 2-D int64, got {table.dtype} {tuple(table.shape)}")
    if table.shape[1] % 2 or not table.is_contiguous():
        raise ValueError("table rows must be contiguous with an even word count")


def _check_slots(slots: torch.Tensor, table: torch.Tensor) -> None:
    if slots.dim() != 1 or slots.dtype != torch.int64 or not slots.is_contiguous():
        raise ValueError("slots must be a contiguous 1-D int64 tensor")
    if slots.device != table.device:
        raise ValueError(f"slots on {slots.device}, table on {table.device}")


def gather_rows_plain(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``table[clamp(slots, 0, capacity)]``."""
    cap = table.shape[0] - 1
    return table[slots.clamp(0, cap)]


def scatter_rows_plain(table: torch.Tensor, slots: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """``table[slots] = rows`` in place, dropping guard-row lanes."""
    cap = table.shape[0] - 1
    keep = (slots >= 0) & (slots < cap)
    table[slots[keep]] = rows[keep]
    return table


def gather_rows(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Read ``table[slots[j]]`` into a new (B, W) tensor."""
    _check_table(table)
    _check_slots(slots, table)
    if table.device.type == "cpu":
        return gather_rows_plain(table, slots)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    n, w = slots.shape[0], table.shape[1]
    out = torch.empty((n, w), dtype=torch.int64, device=table.device)
    rc = _lib().gt_gather_rows(
        table.data_ptr(), table.shape[0] - 1, w, slots.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def scatter_rows(table: torch.Tensor, slots: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows[j]`` to ``table[slots[j]]`` in place; returns ``table``."""
    _check_table(table)
    _check_slots(slots, table)
    if rows.shape != (slots.shape[0], table.shape[1]) or rows.dtype != torch.int64 \
            or not rows.is_contiguous() or rows.device != table.device:
        raise ValueError("rows must be contiguous int64 (len(slots), W) on the table's device")
    if table.device.type == "cpu":
        return scatter_rows_plain(table, slots, rows)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    rc = _lib().gt_scatter_rows(
        table.data_ptr(), table.shape[0] - 1, table.shape[1],
        slots.data_ptr(), slots.shape[0], rows.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "scatter_rows")
    scatter_rows.launches += 1
    return table


scatter_rows.launches = 0


def row_evict(table: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Zero whole rows (``in_use`` and every field) for evicted slots with
    one scatter.  Zeroing the whole row keeps an evicted tenant's fields
    out of the slot's next tenant."""
    zeros = torch.zeros((slots.shape[0], table.shape[1]), dtype=torch.int64,
                        device=table.device)
    return scatter_rows(table, slots, zeros)


def dead_mask(table: torch.Tensor, slots: np.ndarray, now: int) -> np.ndarray:
    """Host bool mask over ``slots``: True where the device row is dead
    (``in_use == 0`` or ``expire_at < now``).  The rows come through
    :func:`gather_rows` in chunks of SCAN_CHUNK; the test is plain torch
    on the gathered rows, and the mask crosses to the host once."""
    parts = []
    for start in range(0, len(slots), SCAN_CHUNK):
        part = torch.from_numpy(
            np.ascontiguousarray(slots[start:start + SCAN_CHUNK], np.int64)
        ).to(table.device)
        rows = gather_rows(table, part)
        parts.append((rows[:, WORD["in_use"]] == 0)
                     | (rows[:, WORD["expire_at"]] < now))
    if not parts:
        return np.zeros(0, bool)
    return torch.cat(parts).cpu().numpy()


def host_columns(table: torch.Tensor) -> Dict[str, np.ndarray]:
    """The whole table (guard row dropped) as host logical columns, with
    the TPU package's ``np_logical`` dtypes (one D2H of the table)."""
    cols = rows_to_logical(table[:-1].cpu())
    return {f: cols[f].numpy().astype(NP_DTYPES[f]) for f in STATE_FIELDS}


__all__ = [
    "ROW_W", "SCAN_CHUNK", "gather_rows", "gather_rows_plain",
    "scatter_rows", "scatter_rows_plain", "row_evict", "dead_mask",
    "host_columns",
]
