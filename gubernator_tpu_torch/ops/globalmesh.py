"""The GLOBAL mesh's device programs on one card (kernels B.8a-B.8d).

The kernels (``csrc/global_mesh.cu``, per-slot steps in
``csrc/global_mesh.cuh``) replace the XLA programs of the TPU package's
``parallel/global_mesh.py``.  The mesh's n logical nodes are n replicas in
one row table, so the reference's collectives become reads of the other
replicas' words:

* :func:`global_accumulate` (B.8a): the tail of a process window.  Per
  sorted lane, the last lane of a slot writes its node's 9 aux words, a
  hit on a slot its node does not own adds into the node's hit, RESET and
  count accumulators, and with ``track_touch`` every live lane counts a
  touch.
* :func:`global_dense_reconcile` (B.8b): per slot, the owner's row, the
  stamp winner's parameters, each node's window folded in node order (or
  summed when ``strict`` is off), the row written to every replica and
  every accumulator zeroed.
* :func:`global_sparse_probe` (B.8c): every node's window and touch
  counts, the union of those slots (a slot list in any order), each
  owner's share of it and the overflow verdict.
* :func:`global_sparse_apply` (B.8d): per union slot, the owner's row with
  each node's window folded in node order on that node's own parameters,
  written to every replica, the slot's accumulators zeroed.

Buffers: ``table`` (n * capacity + 1, 16) int64, node d's replica of slot s
at row d * capacity + s and the drop row last; ``aux`` (n, 9, capacity)
int64 in ``AUX_ROWS`` order; ``accum`` (n, 4, capacity) int64 in
``ACC_*`` order.  Slot s is owned by node s // (capacity // n).

Each wrapper launches its kernel for CUDA tensors (counted in
``<wrapper>.launches`` and ``launches_by_width``) and runs the plain
PyTorch version beside it for CPU tensors.  There is no fallback: a CUDA
tensor that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.buckets import (
    ROW_W, logical_to_rows, rows_to_logical)
from gubernator_tpu_torch.ops.fusedtick import count_launch, unpack_req32
from gubernator_tpu_torch.ops.transition import bucket_transition
from gubernator_tpu_torch.types import Behavior

# Aux rows: each node's latest request parameters a slot, the write stamp
# last (the reference's AUX_ROWS, global_mesh.py:133-137).
AUX_ROWS = (
    "limit", "duration", "algorithm", "behavior", "burst",
    "greg_exp", "greg_dur", "created_at", "stamp",
)
AUX = {name: i for i, name in enumerate(AUX_ROWS)}
# Accumulator rows (global_mesh.py:144-145).
ACC_HITS, ACC_RESET, ACC_COUNT, ACC_TOUCH = 0, 1, 2, 3
ACC_ROWS = 4

_RESET = int(Behavior.RESET_REMAINING)
_DRAIN = int(Behavior.DRAIN_OVER_LIMIT)
_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("global_mesh")
    for name, args in (
        ("gt_global_accumulate",
         [_vp, _i64, _i64, _vp, _vp, _i64, _i64, _i64, _int, _vp]),
        ("gt_global_dense", [_vp, _vp, _vp, _i64, _i64, _i64, _int, _vp]),
        ("gt_global_probe", [_vp, _i64, _i64, _i64, _vp, _vp, _vp, _vp]),
        ("gt_global_apply", [_vp, _vp, _vp, _i64, _i64, _vp, _i64, _i64, _vp]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def check_state(aux: torch.Tensor, accum: torch.Tensor,
                n_nodes: int) -> int:
    """Check the aux and accumulator buffers of an ``n_nodes`` mesh;
    returns the capacity."""
    if aux.dim() != 3 or aux.shape[:2] != (n_nodes, len(AUX_ROWS)):
        raise ValueError("aux must be (n_nodes, 9, capacity)")
    cap = aux.shape[2]
    if n_nodes < 1 or cap % n_nodes:
        raise ValueError("capacity must be a multiple of n_nodes")
    for t, shape, what in ((aux, (n_nodes, len(AUX_ROWS), cap), "aux"),
                           (accum, (n_nodes, ACC_ROWS, cap), "accum")):
        if tuple(t.shape) != shape or t.dtype != torch.int64 \
                or not t.is_contiguous() or t.device != aux.device:
            raise ValueError(
                f"{what} must be a contiguous {shape} int64 tensor on the "
                f"aux buffer's device")
    return cap


def check_buffers(table: torch.Tensor, aux: torch.Tensor,
                  accum: torch.Tensor, n_nodes: int) -> int:
    """Check the three buffers of an ``n_nodes`` mesh; returns the
    capacity."""
    cap = check_state(aux, accum, n_nodes)
    shape = (n_nodes * cap + 1, ROW_W)
    if tuple(table.shape) != shape or table.dtype != torch.int64 \
            or not table.is_contiguous() or table.device != aux.device:
        raise ValueError(
            f"table must be a contiguous {shape} int64 tensor on the aux "
            f"buffer's device")
    return cap


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ----------------------------------------------------------------------
# B.8a: accumulate
# ----------------------------------------------------------------------
def lane_terms(m32: torch.Tensor, n_nodes: int, capacity: int):
    """The request columns of a sorted window and each lane's node, slot,
    liveness, tail, queue and reset flags (the kernel's ``lane_at``)."""
    r = unpack_req32(m32)
    flat = r["slot"]
    live = (r["valid"] != 0) & (flat >= 0) & (flat < n_nodes * capacity)
    d = torch.where(live, flat // capacity, 0)
    s = torch.where(live, flat - d * capacity, 0)
    next_same = torch.zeros_like(live)
    next_same[:-1] = (flat[1:] == flat[:-1]) & (r["valid"][1:] != 0)
    tail = live & ~next_same
    owned = (s // (capacity // n_nodes)) == d
    queue = live & ~owned & (r["hits"] != 0)
    reset = queue & ((r["behavior"] & _RESET) != 0)
    return r, d, s, live, tail, queue, reset


def global_accumulate_plain(m32: torch.Tensor, aux: torch.Tensor,
                            accum: torch.Tensor, n_nodes: int, stamp: int,
                            track_touch: bool) -> None:
    """Plain PyTorch version of B.8a, in place on ``aux`` and ``accum``."""
    cap = aux.shape[2]
    r, d, s, live, tail, queue, reset = lane_terms(m32, n_nodes, cap)
    vals = (r["limit"], r["duration"], r["algorithm"], r["behavior"],
            r["burst"], r["greg_exp"], r["greg_dur"], r["created_at"],
            torch.full_like(r["limit"], int(stamp)))
    flat_aux = aux.view(-1)
    dt, st = d[tail], s[tail]
    for k, v in enumerate(vals):
        flat_aux[(dt * len(AUX_ROWS) + k) * cap + st] = v[tail]
    flat_acc = accum.view(-1)

    def add(row, mask, v):
        flat_acc.index_put_(((d[mask] * ACC_ROWS + row) * cap + s[mask],),
                            v, accumulate=True)

    add(ACC_HITS, queue, r["hits"][queue])
    add(ACC_RESET, reset, torch.ones_like(r["hits"][reset]))
    add(ACC_COUNT, queue, torch.ones_like(r["hits"][queue]))
    if track_touch:
        add(ACC_TOUCH, live, torch.ones_like(r["hits"][live]))


def global_accumulate(m32: torch.Tensor, aux: torch.Tensor,
                      accum: torch.Tensor, n_nodes: int, stamp: int,
                      track_touch: bool) -> None:
    """B.8a over a (19, B) REQ32 window sorted by flattened slot
    ``d * capacity + s`` (unit column stride, the live lanes of a slot
    contiguous; padding aims at ``n_nodes * capacity``)."""
    if m32.dim() != 2 or m32.shape[0] != 19 or m32.dtype != torch.int32 \
            or m32.stride(1) != 1 or m32.device != aux.device:
        raise ValueError("m32 must be (19, B) int32 with unit column stride "
                         "on the buffers' device")
    cap = check_state(aux, accum, n_nodes)
    if _device_kind(aux) == "cpu":
        global_accumulate_plain(m32, aux, accum, n_nodes, stamp, track_touch)
        return
    lanes = m32.shape[1]
    rc = _lib().gt_global_accumulate(
        m32.data_ptr(), m32.stride(0), lanes, aux.data_ptr(),
        accum.data_ptr(), n_nodes, cap, int(stamp),
        1 if track_touch else 0, _stream(aux))
    _build.check(rc, "global_accumulate")
    count_launch(global_accumulate, lanes)


global_accumulate.launches = 0
global_accumulate.launches_by_width = {}


# ----------------------------------------------------------------------
# The authority's fold (B.8b / B.8d plain versions)
# ----------------------------------------------------------------------
def fold_req(hits, resets, p, havep, fb: Dict[str, torch.Tensor],
             greg_exp, greg_dur, now: int) -> Dict[str, torch.Tensor]:
    """The request columns a reconcile applies (the kernel's ``fold_req``):
    ``p`` the (9, u) parameter rows, ``fb`` the logical columns standing
    in where ``havep`` is false."""
    beh = torch.where(havep, p[AUX["behavior"]], 0).to(torch.int32)
    beh = ((beh & ~_RESET) | _DRAIN).to(torch.int64)
    one = torch.ones_like(hits)
    return dict(
        slot=torch.zeros_like(hits), known=one, valid=one, hits=hits,
        limit=torch.where(havep, p[AUX["limit"]], fb["limit"]),
        duration=torch.where(havep, p[AUX["duration"]], fb["duration"]),
        algorithm=torch.where(havep, p[AUX["algorithm"]], fb["algorithm"])
        .to(torch.int32).to(torch.int64),
        behavior=torch.where(resets > 0, beh | _RESET, beh),
        created_at=torch.where(havep, p[AUX["created_at"]],
                               torch.full_like(hits, int(now))),
        burst=torch.where(havep, p[AUX["burst"]], fb["burst"]),
        greg_exp=greg_exp, greg_dur=greg_dur,
    )


def _apply(rows: torch.Tensor, req: Dict[str, torch.Tensor],
           ok: torch.Tensor, now: int) -> torch.Tensor:
    """``rows`` with the transition of ``req`` where ``ok`` (words 13-15 of
    a transitioned row zero, as the kernels' transition leaves them)."""
    new_state, _ = bucket_transition(int(now), rows_to_logical(rows), req)
    return torch.where(ok[:, None], logical_to_rows(new_state), rows)


def _owner_rows(table: torch.Tensor, slots: torch.Tensor, cap: int,
                n_nodes: int) -> torch.Tensor:
    return table[(slots // (cap // n_nodes)) * cap + slots]


def _replicate(table: torch.Tensor, accum: torch.Tensor, slots: torch.Tensor,
               rows: torch.Tensor, cap: int, n_nodes: int) -> None:
    for d in range(n_nodes):
        table[d * cap + slots] = rows
    accum[:, :, slots] = 0


# ----------------------------------------------------------------------
# B.8b: dense reconcile
# ----------------------------------------------------------------------
def global_dense_reconcile_plain(table: torch.Tensor, aux: torch.Tensor,
                                 accum: torch.Tensor, n_nodes: int, now: int,
                                 strict: bool = True) -> None:
    """Plain PyTorch version of B.8b, in place (make_global_reconcile_fn's
    dense branch: the stamp winner by max, its parameters by the masked
    sum, the windows folded into the owner's row)."""
    cap = aux.shape[2]
    slots = torch.arange(cap, device=table.device)
    rows = _owner_rows(table, slots, cap, n_nodes)
    base = rows_to_logical(rows)
    nodes = torch.arange(n_nodes, device=table.device)[:, None]
    stamp = aux[:, AUX["stamp"]]
    key = torch.where(stamp > 0, stamp * n_nodes + nodes, -1)
    win = key.max(dim=0).values
    mine = (key == win) & (win >= 0)
    params = torch.where(mine[:, None, :], aux, 0).sum(dim=0)
    havep = win >= 0

    def req(hits, resets):
        return fold_req(hits, resets, params, havep, base,
                        params[AUX["greg_exp"]], params[AUX["greg_dur"]],
                        now)

    if strict:
        for d in range(n_nodes):
            rows = _apply(rows, req(accum[d, ACC_HITS], accum[d, ACC_RESET]),
                          accum[d, ACC_COUNT] > 0, now)
    else:
        tot = accum[:, :ACC_TOUCH].sum(dim=0)
        rows = _apply(rows, req(tot[ACC_HITS], tot[ACC_RESET]),
                      tot[ACC_COUNT] > 0, now)
    _replicate(table, accum, slots, rows, cap, n_nodes)


def global_dense_reconcile(table: torch.Tensor, aux: torch.Tensor,
                           accum: torch.Tensor, n_nodes: int, now: int,
                           strict: bool = True) -> None:
    """B.8b: one dense reconcile step of the whole table, in place."""
    cap = check_buffers(table, aux, accum, n_nodes)
    if _device_kind(table) == "cpu":
        global_dense_reconcile_plain(table, aux, accum, n_nodes, now, strict)
        return
    rc = _lib().gt_global_dense(
        table.data_ptr(), aux.data_ptr(), accum.data_ptr(), n_nodes, cap,
        int(now), 1 if strict else 0, _stream(table))
    _build.check(rc, "global_dense_reconcile")
    count_launch(global_dense_reconcile, cap)


global_dense_reconcile.launches = 0
global_dense_reconcile.launches_by_width = {}


# ----------------------------------------------------------------------
# B.8c: sparse probe
# ----------------------------------------------------------------------
def probe_buffers(n_nodes: int, capacity: int, device) -> Tuple[torch.Tensor,
                                                                 ...]:
    """``(out, slots, scratch)`` for :func:`global_sparse_probe`: the
    (2,) int64 verdict and union size, the (capacity,) int32 slot list and
    the kernel's (2 + 3n,) int32 counters."""
    return (torch.zeros(2, dtype=torch.int64, device=device),
            torch.zeros(capacity, dtype=torch.int32, device=device),
            torch.zeros(2 + 3 * n_nodes, dtype=torch.int32, device=device))


def global_sparse_probe_plain(accum: torch.Tensor, n_nodes: int, k: int,
                              out: torch.Tensor, slots: torch.Tensor) -> None:
    """Plain PyTorch version of B.8c: ``out`` = (overflow, union size),
    the union's slots (ascending) at the head of ``slots``."""
    cap = accum.shape[2]
    w = accum[:, ACC_COUNT] > 0
    t = accum[:, ACC_TOUCH] > 0
    union = (w | t).any(dim=0)
    share = union.view(n_nodes, cap // n_nodes).sum(dim=1)
    over = ((w.sum(dim=1) > k).any() | (t.sum(dim=1) > k).any()
            | (share > 2 * k).any())
    u = torch.nonzero(union).flatten()
    slots[:u.numel()] = u.to(torch.int32)
    out[0] = over.to(torch.int64)
    out[1] = u.numel()


def global_sparse_probe(accum: torch.Tensor, n_nodes: int, k: int,
                        out: torch.Tensor, slots: torch.Tensor,
                        scratch: torch.Tensor) -> None:
    """B.8c: the sparse step's probe of ``accum`` against the envelope
    ``k`` (:func:`probe_buffers` makes the outputs).  The kernel lists the
    union in any order; every slot of it once."""
    cap = accum.shape[2] if accum.dim() == 3 else -1
    if tuple(accum.shape) != (n_nodes, ACC_ROWS, cap) \
            or accum.dtype != torch.int64 or not accum.is_contiguous() \
            or cap % max(n_nodes, 1):
        raise ValueError("accum must be a contiguous (n, 4, C) int64 tensor")
    for t, shape, dt in ((out, (2,), torch.int64), (slots, (cap,), torch.int32),
                         (scratch, (2 + 3 * n_nodes,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous() \
                or t.device != accum.device:
            raise ValueError("probe buffers as probe_buffers() makes them")
    if _device_kind(accum) == "cpu":
        global_sparse_probe_plain(accum, n_nodes, k, out, slots)
        return
    rc = _lib().gt_global_probe(
        accum.data_ptr(), n_nodes, cap, int(k), scratch.data_ptr(),
        slots.data_ptr(), out.data_ptr(), _stream(accum))
    _build.check(rc, "global_sparse_probe")
    count_launch(global_sparse_probe, cap)


global_sparse_probe.launches = 0
global_sparse_probe.launches_by_width = {}


# ----------------------------------------------------------------------
# B.8d: sparse apply
# ----------------------------------------------------------------------
def global_sparse_apply_plain(table: torch.Tensor, aux: torch.Tensor,
                              accum: torch.Tensor, n_nodes: int,
                              slots: torch.Tensor, out: torch.Tensor,
                              now: int) -> None:
    """Plain PyTorch version of B.8d, in place: the union slots at the
    head of ``slots`` (``out[1]`` of them)."""
    cap = aux.shape[2]
    s = slots[:int(out[1])].to(torch.int64)
    rows = _owner_rows(table, s, cap, n_nodes)
    for d in range(n_nodes):
        p = aux[d][:, s]
        havep = p[AUX["stamp"]] > 0
        zero = torch.zeros_like(s)
        req = fold_req(accum[d, ACC_HITS, s], accum[d, ACC_RESET, s], p,
                       havep, rows_to_logical(rows),
                       torch.where(havep, p[AUX["greg_exp"]], zero),
                       torch.where(havep, p[AUX["greg_dur"]], zero), now)
        rows = _apply(rows, req, accum[d, ACC_COUNT, s] > 0, now)
    _replicate(table, accum, s, rows, cap, n_nodes)


def global_sparse_apply(table: torch.Tensor, aux: torch.Tensor,
                        accum: torch.Tensor, n_nodes: int,
                        slots: torch.Tensor, out: torch.Tensor,
                        count: int, now: int) -> None:
    """B.8d over the union :func:`global_sparse_probe` left in ``slots`` /
    ``out``: ``count`` is the union's size, ``out[1]``, as the caller read
    it back with the verdict (the kernel's grid is sized by it; an empty
    union launches nothing).  Every nonzero accumulator word lies in the
    union, so zeroing the union's words zeroes the accumulators."""
    cap = check_buffers(table, aux, accum, n_nodes)
    if tuple(slots.shape) != (cap,) or slots.dtype != torch.int32 \
            or tuple(out.shape) != (2,) or out.dtype != torch.int64 \
            or slots.device != table.device or out.device != table.device:
        raise ValueError("slots / out as probe_buffers() makes them")
    if _device_kind(table) == "cpu":
        global_sparse_apply_plain(table, aux, accum, n_nodes, slots, out, now)
        return
    count = int(count)
    if not 0 <= count <= cap:
        raise ValueError(f"union size {count} outside [0, {cap}]")
    if count == 0:
        return
    rc = _lib().gt_global_apply(
        table.data_ptr(), aux.data_ptr(), accum.data_ptr(), n_nodes, cap,
        slots.data_ptr(), count, int(now), _stream(table))
    _build.check(rc, "global_sparse_apply")
    count_launch(global_sparse_apply, count)


global_sparse_apply.launches = 0
global_sparse_apply.launches_by_width = {}

WRAPPERS = {
    "global_accumulate": global_accumulate,
    "global_dense_reconcile": global_dense_reconcile,
    "global_sparse_probe": global_sparse_probe,
    "global_sparse_apply": global_sparse_apply,
}

__all__ = [
    "AUX_ROWS", "AUX", "ACC_HITS", "ACC_RESET", "ACC_COUNT", "ACC_TOUCH",
    "ACC_ROWS", "WRAPPERS", "check_buffers", "check_state", "probe_buffers",
    "global_accumulate", "global_accumulate_plain",
    "global_dense_reconcile", "global_dense_reconcile_plain",
    "global_sparse_probe", "global_sparse_probe_plain",
    "global_sparse_apply", "global_sparse_apply_plain",
]
