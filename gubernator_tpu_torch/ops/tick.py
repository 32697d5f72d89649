"""Tick dispatch: a slot-sorted REQ32 window to the fused tick kernel.

Counterpart of the TPU package's ``tick32.jitted_tick32``.  A unique-slot
window is one :func:`~.fusedtick.fused_tick` launch.  A window that holds
duplicate slots is split on the host into **rank rounds**: round k holds
the k-th request of every slot, so each round is a unique-slot window and
round k+1 reads the rows round k wrote.  That is exactly the sequential
per-key semantics the reference's duplicate programs are held to; it
answers every window right and costs one launch per round, so a hot key
repeated k times costs k launches.
"""

from __future__ import annotations

import numpy as np
import torch

from gubernator_tpu_torch.ops.fusedtick import REQ32_INDEX, RESP_ROWS, fused_tick


def rank_rounds(m_sorted: np.ndarray, n: int, capacity: int):
    """Host plan of a slot-sorted window's rank rounds.

    Returns ``(perm, bounds)``: ``m_sorted[:, perm]`` lays the rounds out
    one after another (each still slot-sorted, each slot at most once), and
    round k is columns ``[bounds[k], bounds[k + 1])``.  Lanes aimed at the
    padding sentinel ``capacity`` (per-item errors) stay in round 0; they
    never write the table."""
    sl = m_sorted[REQ32_INDEX["slot"], :n]
    idx = np.arange(n, dtype=np.int64)
    start = np.ones(n, bool)
    start[1:] = sl[1:] != sl[:-1]
    seg_start = np.maximum.accumulate(np.where(start, idx, 0))
    rank = idx - seg_start
    rank[sl >= capacity] = 0
    perm = np.lexsort((idx, rank))
    counts = np.bincount(rank)
    bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    return perm, bounds


def tick_rank_rounds(table: torch.Tensor, m_sorted: np.ndarray, n: int,
                     now: int):
    """Apply a duplicate-bearing slot-sorted window round by round.

    Returns ``(resp, perm, rounds)``: the (6, n) int32 response on the
    device with lane k answering sorted lane ``perm[k]``, and the number of
    rounds launched."""
    capacity = table.shape[0] - 1
    perm, bounds = rank_rounds(m_sorted, n, capacity)
    m_dev = torch.from_numpy(
        np.ascontiguousarray(m_sorted[:, :n][:, perm])).to(table.device)
    resp = torch.empty((RESP_ROWS, n), dtype=torch.int32, device=table.device)
    for k in range(len(bounds) - 1):
        a, b = int(bounds[k]), int(bounds[k + 1])
        fused_tick(table, m_dev[:, a:b], now, out=resp[:, a:b])
    return resp, perm, len(bounds) - 1
