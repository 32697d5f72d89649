"""The ragged extent spec of the sharded serving table.

Port of ``gubernator_tpu.parallel.partition.RaggedExtents``.  The flat
request matrix of a mesh window carries GLOBAL slots in its slot row and
is sorted by them, and shard s owns global slots
``[s * local_capacity, (s + 1) * local_capacity)``, so each shard's lanes
form one contiguous extent of the window and the host's per-shard counts
compress to a cumulative ``(n_shards + 1,)`` offsets vector, which the
ragged tick (ops/raggedtick.py) walks on the device.

The JAX module's ``ShardLayout`` and ``NodeLayout`` are PartitionSpec
helpers that place arrays over a device mesh; on one card the shards are
row ranges of one table, so they have no counterpart.  Its
``LayoutTransition`` / ``relayout_block`` belong to resharding, which is
not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RaggedExtents:
    """How a resolved batch's per-shard lane counts become the offsets
    vector of one (n_shards, local_capacity) layout."""

    n_shards: int
    local_capacity: int

    def counts(self, sh: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """Per-shard live lane counts of one resolved batch (``sh`` the
        per-request shard route, ``ok`` the live mask)."""
        if not ok.any():
            return np.zeros(self.n_shards, np.int64)
        return np.bincount(sh[ok], minlength=self.n_shards)

    def offsets(self, counts: np.ndarray) -> np.ndarray:
        """Cumulative extent offsets: shard s owns sorted lanes
        ``[offsets[s], offsets[s + 1])``.  Valid because the packed batch
        sorts by global slot, shards ascend with it, and error and padding
        lanes (the sentinel slot) sort past every extent."""
        off = np.zeros(self.n_shards + 1, np.int32)
        off[1:] = np.cumsum(counts)
        return off
