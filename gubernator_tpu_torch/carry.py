"""Carry bucket state between per-slot logical columns and the port's table.

The logical columns are numpy arrays over slots, keyed by the field names
of ``ops/buckets.STATE_FIELDS`` (the TPU package's ``STATE_DTYPES``), with
the values its ``np_logical`` gives over an engine's state.  Carrying one
table into both packages is how the tests make them compute on the same
state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gubernator_tpu_torch import DeviceLike, resolve_device
from gubernator_tpu_torch.ops.buckets import (
    FLOAT_FIELDS, STATE_FIELDS, logical_to_rows, zeros_table)
from gubernator_tpu_torch.ops.rowtable import host_columns


def table_from_columns(cols: Dict[str, np.ndarray], capacity: int,
                       device: DeviceLike = None) -> torch.Tensor:
    """A (capacity + 1, 16) int64 table holding ``cols`` in slots
    ``[0, len)``; absent fields (``tat``/``prev_count`` of older state)
    and the guard row are zero."""
    device = resolve_device(device)
    n = len(cols["limit"])
    if n > capacity:
        raise ValueError(f"{n} slots of state do not fit capacity {capacity}")
    logical = {
        f: torch.from_numpy(np.asarray(
            cols[f] if f in cols else np.zeros(n),
            np.float64 if f in FLOAT_FIELDS else np.int64))
        for f in STATE_FIELDS
    }
    table = zeros_table(capacity, "cpu")
    table[:n] = logical_to_rows(logical)
    return table.to(device)


def sharded_table_from_columns(cols: Dict[str, np.ndarray], n_shards: int,
                               local_capacity: int,
                               device: DeviceLike = None) -> torch.Tensor:
    """The mesh engine's (n_shards * (local_capacity + 1), 16) int64 table
    holding ``cols`` over GLOBAL slots ``[0, n_shards * local_capacity)``:
    shard s's block holds global slots ``[s * L, (s + 1) * L)``, then its
    zero guard row."""
    L = int(local_capacity)
    return torch.cat([
        table_from_columns({f: v[s * L:(s + 1) * L] for f, v in cols.items()},
                           L, "cpu")
        for s in range(int(n_shards))]).to(resolve_device(device))


def columns_from_table(table: torch.Tensor) -> Dict[str, np.ndarray]:
    """Inverse of :func:`table_from_columns` over every slot."""
    return host_columns(table)
