"""Bucket state: the logical fields and the port's row layout.

The logical fields are those of ``gubernator_tpu.ops.buckets.STATE_DTYPES``,
in the same order.  The port stores them as one row of ``ROW_W`` int64
words per slot::

  word 0   algorithm        word 7   burst
  word 1   limit            word 8   status
  word 2   remaining        word 9   expire_at
  word 3   remaining_f      word 10  in_use
           (float64 bits)   word 11  tat
  word 4   duration         word 12  prev_count
  word 5   created_at       words 13-15  zero
  word 6   updated_at

16 words are 128 B: one aligned 128-B line per slot, which a thread of
the tick kernel reads as eight 16-B vector loads.  The i32 and bool
fields are widened to int64 and ``remaining_f`` keeps its float64 bits,
so a row round-trips every logical value exactly.  The TPU package's
128-word int32 row, its (lo, hi) int32 pairs and its triple-float32
``remaining_f`` exist only because Mosaic has no 64-bit types; they are
not ported.  At 10M slots the table is 1.28 GB.

Row ``capacity`` is the guard row: padding lanes read it and nothing
writes it, so it stays zero.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

STATE_FIELDS = (
    "algorithm", "limit", "remaining", "remaining_f", "duration",
    "created_at", "updated_at", "burst", "status", "expire_at", "in_use",
    "tat", "prev_count",
)
WORD = {f: i for i, f in enumerate(STATE_FIELDS)}
ROW_W = 16
FLOAT_FIELDS = ("remaining_f",)

# numpy dtype of each logical field, as the TPU package's np_logical
# returns it (int32 narrow fields, bool in_use).
NP_DTYPES = {
    f: (np.float64 if f in FLOAT_FIELDS
        else np.int32 if f in ("algorithm", "status")
        else np.bool_ if f == "in_use"
        else np.int64)
    for f in STATE_FIELDS
}


def zeros_table(capacity: int, device) -> torch.Tensor:
    """An empty (capacity + 1, ROW_W) int64 table (guard row included)."""
    return torch.zeros((capacity + 1, ROW_W), dtype=torch.int64, device=device)


def rows_to_logical(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, ROW_W) int64 rows → logical columns: int64 everywhere except
    ``remaining_f`` (float64)."""
    out = {f: rows[:, WORD[f]] for f in STATE_FIELDS}
    out["remaining_f"] = out["remaining_f"].contiguous().view(torch.float64)
    return out


def logical_to_rows(cols: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logical columns → (B, ROW_W) int64 rows with zero spare words."""
    b = cols["limit"].shape[0]
    rows = torch.zeros((b, ROW_W), dtype=torch.int64,
                       device=cols["limit"].device)
    for f in STATE_FIELDS:
        v = cols[f]
        if f in FLOAT_FIELDS:
            v = v.to(torch.float64).contiguous().view(torch.int64)
        rows[:, WORD[f]] = v.to(torch.int64)
    return rows
