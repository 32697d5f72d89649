"""Tick dispatch: a slot-sorted REQ32 window to the fused tick kernels.

Counterpart of the TPU package's ``tick32`` entry points.  A unique-slot
window is one :func:`~.fusedtick.fused_tick` launch.  A window that holds
duplicate slots takes one of three routes, chosen on the host by the
plans in ops/engine.py (the JAX engine's order):

* **grouped** (``build_group_plan``; :func:`merged_pipeline`, the
  counterpart of ``tick32.jitted_merged_pipeline``): every duplicate of a
  key is identical to its first request, so one
  :func:`~.fusedtick.fused_merged_tick` launch ticks each key's head once
  and folds its followers in closed form; :func:`expand_rowmajor` then
  derives every member's response from its head's journal row;
* **layered** (``build_layer_plan``; :func:`layered_pipeline`, the
  counterpart of ``tick32.jitted_layered_pipeline``): keys whose requests
  split into several runs of identical requests ("units") run one merged
  launch per unit layer, chained through the table;
* **rank rounds** (:func:`tick_rank_rounds`), for shapes neither plan
  takes: round k holds the k-th request of every slot, so each round is a
  unique-slot window and round k+1 reads the rows round k wrote.  That is
  the sequential per-key semantics the reference's duplicate programs are
  held to, at one launch per round (the port's stand-in for
  ``tick32.jitted_sorted_tick32``).
"""

from __future__ import annotations

import numpy as np
import torch

from gubernator_tpu_torch.ops.fusedtick import (
    MERGED24_W, REQ32_INDEX, RESP_ROWS, fused_merged_tick, fused_tick)
from gubernator_tpu_torch.types import Algorithm, Behavior, Status


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


def expand_rowmajor(r24: torch.Tensor, uidx: torch.Tensor,
                    rank: torch.Tensor) -> torch.Tensor:
    """Every member's compact response from its head's MERGED24 journal row.

    Port of ``transition32.expand32_rowmajor`` and ``_expand_members``:
    member j reads journal row ``uidx[j]`` (one whole-row gather) and, at
    rank ``rank[j]`` in its group, answers as the rank-th identical
    follower would (a rank-0 member takes its head's own response
    verbatim).  Returns the (6, B) int32 compact response in the window's
    slot-sorted lane order; members whose ``uidx`` points at a padding
    head answer values that callers slice away.

    This is plain elementwise int64 torch code on the journal's device,
    as the JAX package computes it in XLA outside any Pallas kernel: it is
    not a kernel and not a kernel's plain version (fusing it into the
    merged kernel's consumer is open work, ROADMAP A)."""
    g = r24[uidx.long()].to(torch.int64)

    def pair(k):
        return (g[:, k + 1] << 32) | (g[:, k] & 0xFFFFFFFF)

    base, q, rate_i, expire = pair(6), pair(8), pair(10), pair(13)
    s0 = g[:, 12]
    hits, limit, created = pair(15), pair(17), pair(19)
    is_tok = g[:, 21] == int(Algorithm.TOKEN_BUCKET)
    drain = (g[:, 22] & int(Behavior.DRAIN_OVER_LIMIT)) != 0
    h = torch.where(hits > 0, hits, 1)

    i = rank.to(torch.int64)
    under = i <= q
    residue = base - q * h
    rem_over = torch.where(drain, 0, residue)
    rem_resp = torch.where(under, base - i * h, rem_over)
    status = torch.where(under, torch.where(is_tok, s0, int(Status.UNDER_LIMIT)),
                         int(Status.OVER_LIMIT))
    reset_rem = torch.where(
        under, rem_resp, torch.where(drain & (i > q + 1), 0, residue))
    reset = torch.where(is_tok, expire, created + (limit - reset_rem) * rate_i)

    rows = torch.stack([
        status, (~under).to(torch.int64),
        rem_resp & 0xFFFFFFFF, rem_resp >> 32,
        reset & 0xFFFFFFFF, reset >> 32,
    ]).to(torch.int32)
    head6 = g[:, :RESP_ROWS].T.to(torch.int32)
    return torch.where(rank[None, :] == 0, head6, rows)


def merged_pipeline(table: torch.Tensor, mhead: torch.Tensor,
                    count: torch.Tensor, uidx: torch.Tensor,
                    rank: torch.Tensor, now: int) -> torch.Tensor:
    """A grouped window (``build_group_plan``): one merged launch over the
    (19, U) heads, then the member expansion.  Returns the (6, B) int32
    compact response in slot-sorted lane order."""
    return expand_rowmajor(fused_merged_tick(table, mhead, count, now),
                           uidx, rank)


def layered_pipeline(table: torch.Tensor, mh0: torch.Tensor,
                     cnt0: torch.Tensor, mhk: torch.Tensor,
                     cntk: torch.Tensor, uidx: torch.Tensor,
                     rank: torch.Tensor, now: int) -> torch.Tensor:
    """A layered window (``build_layer_plan``): one merged launch over
    layer 0's (19, W0) heads, then one over each further (19, LW) layer
    ``mhk[k]``, in stream order, so layer k + 1 reads the rows layer k
    wrote.  Each launch writes its slice of one flat
    (W0 + K * LW, 24) journal, in the order the plan's ``uidx`` addresses
    it; one expansion over the journal follows.  Returns the (6, B) int32
    compact response in slot-sorted lane order.

    Layers of padding heads alone write nothing; callers may drop them
    from ``mhk`` (their journal rows are addressed by no member)."""
    w0 = mh0.shape[1]
    k_layers, _, lw = mhk.shape
    journal = torch.empty((w0 + k_layers * lw, MERGED24_W), dtype=torch.int32,
                          device=table.device)
    fused_merged_tick(table, mh0, cnt0, now, out=journal[:w0])
    for k in range(k_layers):
        a = w0 + k * lw
        fused_merged_tick(table, mhk[k], cntk[k], now, out=journal[a:a + lw])
    return expand_rowmajor(journal, uidx, rank)
