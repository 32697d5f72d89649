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
* **chained** (:func:`~.sortedtick.fused_sorted_tick`, the counterpart
  of ``tick32.jitted_sorted_tick32``), for shapes neither plan takes: one
  launch applies each slot's requests one after another, the sequential
  per-key semantics the reference's duplicate programs are held to; its
  plain version runs the window as rank rounds.

:func:`merge_tick` is the port of the x64 tile tick the JAX mesh engine
runs on each tile of a duplicate window (``engine.make_tick_fn(capacity,
compact_req=True, compact_resp=True)``): heads through the fused tick,
the closed-form fold of ``transition.apply_merged_followers``, rank rounds
for the rest.  Walked over each shard's extent it is the plain version of
the mesh's duplicate tile tick (ops/tiletick.py, kernel B.6).
"""

from __future__ import annotations

import numpy as np
import torch

from gubernator_tpu_torch.ops.buckets import logical_to_rows, rows_to_logical
from gubernator_tpu_torch.ops.fusedtick import (
    MERGED24_W, REQ32_INDEX, RESP_ROWS, fused_merged_tick,
    fused_tick_plain, pack_resp_compact, unpack_req32)
from gubernator_tpu_torch.ops.rowtable import (
    gather_rows_plain, scatter_rows_plain)
from gubernator_tpu_torch.ops.transition import (
    apply_merged_followers, merge_eligible)
from gubernator_tpu_torch.types import Algorithm, Behavior, Status

I64_MAX = (1 << 63) - 1


def upload(device: torch.device, *arrays: np.ndarray) -> list:
    """Int32 host arrays on ``device`` through one host-to-device copy.
    On a CUDA device the host buffer is pinned and the copy asynchronous;
    PyTorch's pinned-memory allocator keeps the buffer until the copy has
    run."""
    sizes = [a.size for a in arrays]
    host = torch.empty(sum(sizes), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    flat = host.numpy()
    off = 0
    for a, k in zip(arrays, sizes):
        flat[off:off + k] = a.reshape(-1)
        off += k
    dev = host.to(device, non_blocking=True)
    return [part.view(a.shape)
            for part, a in zip(torch.split(dev, sizes), arrays)]


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


def _segments(key: np.ndarray):
    """Host port of ``engine._segments_from_sorted`` over a stable sort of
    ``key``: each lane's rank within its key, its group's size, its head's
    lane and its group's id."""
    t = len(key)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    idx = np.arange(t)
    is_start = np.ones(t, bool)
    is_start[1:] = sk[1:] != sk[:-1]
    seg_start = np.maximum.accumulate(np.where(is_start, idx, 0))
    seg_sorted = np.cumsum(is_start) - 1
    inv = np.empty(t, np.int64)
    inv[order] = idx
    seg = seg_sorted[inv]
    return ((idx - seg_start)[inv], np.bincount(seg_sorted)[seg],
            order[seg_start][inv], seg)


def _plain_tick(table, m32, now, out=None):
    if out is None:
        out = torch.empty((RESP_ROWS, m32.shape[1]), dtype=torch.int32,
                          device=table.device)
    return fused_tick_plain(table, m32, now, out)


def merge_tick(table: torch.Tensor, m: np.ndarray, now: int):
    """One tile of a duplicate-bearing window, as the TPU package's x64 tile
    tick applies it (``make_tick_fn(capacity, compact_req=True,
    compact_resp=True)``: merge_uniform, unsorted input), in plain PyTorch
    ops: the reference that kernel B.6 (ops/tiletick.py) is held to.

    ``m`` is a (19, T) int32 host REQ32 block (lanes with valid == 0 are
    inert).  Every group's head (first valid lane of its slot) ticks from
    the pre-window state through the plain fused tick.  Groups whose
    members are all eligible (``transition.merge_eligible``) fold their
    followers in closed form against the head's post-state: the heads'
    rows are gathered, ``apply_merged_followers`` runs, and the heads'
    group-final rows are scattered back.  Every other follower ticks in
    rank rounds, one plain fused tick per rank.  A fold lane whose head
    might come out expired (its request does not prove ``expire >= now``)
    also rides its rank round, masked when its fold applied.  Returns
    ``(resp, rounds)``: the (6, T) int32 compact response on the table's
    device and the rank rounds run."""
    R = REQ32_INDEX
    cap = table.shape[0] - 1
    dev = table.device
    t = m.shape[1]
    valid = m[R["valid"]] != 0
    key = np.where(valid, m[R["slot"]], cap)
    rank, size, head_idx, seg = _segments(key)
    live = valid & (key < cap)
    if not (live & (rank > 0)).any():
        (m_dev,) = upload(dev, m)
        return _plain_tick(table, m_dev, now), 0

    heads = np.flatnonzero(valid & (rank == 0))
    r_host = unpack_req32(torch.from_numpy(m))
    elig = merge_eligible(r_host, torch.from_numpy(rank),
                          torch.from_numpy(head_idx),
                          torch.from_numpy(seg)).numpy()
    fold = elig & (rank > 0)
    formula = np.flatnonzero(fold | (elig & (rank == 0) & (size > 1)))
    dur = r_host["duration"].numpy()
    created = r_host["created_at"].numpy()
    proven = (dur > 0) & (created >= now) & (created <= I64_MAX - dur)
    maybe = fold & ~proven
    rounds_at = np.flatnonzero(valid & (rank > 0) & (~fold | maybe))
    perm = rounds_at[np.lexsort((rounds_at, rank[rounds_at]))]
    bounds = np.searchsorted(rank[perm], np.arange(1, rank.max() + 2))
    pos = np.full(t, -1, np.int64)
    pos[formula] = np.arange(len(formula))

    m_dev, heads_dev, formula_dev, perm_dev, fidx = upload(
        dev, m, heads.astype(np.int32), formula.astype(np.int32),
        perm.astype(np.int32),
        np.stack([rank[formula], size[formula], pos[head_idx[formula]],
                  elig[formula]]).astype(np.int32))
    out = torch.zeros((RESP_ROWS, t), dtype=torch.int32, device=dev)
    out.index_copy_(1, heads_dev.long(), _plain_tick(
        table, m_dev[:, heads_dev.long()], now))

    merged_all = torch.zeros(t, dtype=torch.bool, device=dev)
    if len(formula):
        f = formula_dev.long()
        head_slot = m_dev[R["slot"]][f[fidx[2].long()]].long()
        state = rows_to_logical(gather_rows_plain(table, head_slot))
        r = unpack_req32(m_dev[:, f])
        zero = torch.zeros(len(formula), dtype=torch.int64, device=dev)
        resp0 = {"status": zero, "remaining": zero, "reset_time": zero,
                 "over_limit": zero != 0}
        rows, resp, merged = apply_merged_followers(
            state, resp0, r, now, fidx[0], fidx[1].long(), fidx[2].long(),
            fidx[3] != 0)
        at_head = fidx[0] == 0
        scatter_rows_plain(table, head_slot[at_head], logical_to_rows(
            {k: v[at_head] for k, v in rows.items()}))
        out[:, f] = torch.where(merged, pack_resp_compact(resp, merged),
                                out[:, f])
        merged_all[f] = merged

    if len(perm):
        p = perm_dev.long()
        mr = m_dev[:, p]
        mr[R["valid"]] = torch.where(merged_all[p], 0, mr[R["valid"]])
        rr = torch.empty((RESP_ROWS, len(perm)), dtype=torch.int32,
                         device=dev)
        for k in range(len(bounds) - 1):
            a, b = int(bounds[k]), int(bounds[k + 1])
            if a < b:
                _plain_tick(table, mr[:, a:b], now, out=rr[:, a:b])
        out[:, p] = torch.where(merged_all[p], out[:, p], rr)
    return out, int(np.count_nonzero(np.diff(bounds)))
