#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gubernator_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--against CHECKOUT]

Phases, one output line each:

1. the card (``nvidia-smi`` name and power limit) and the time to build
   every CUDA kernel from ``gubernator_tpu_torch/csrc`` (nvcc, in parallel);
2. each kernel against its plain PyTorch version on the card, bit for bit:
   the fused tick (B.1) on 32768-lane windows over a 2^21-slot random
   table (all five algorithms, every behavior flag, Gregorian rows,
   padding and edge lanes), on column slices of them at every width it is
   timed at and at the edges of its tiles (1, 8, 9, 63, 64, 65, 255-257
   lanes), on whole windows of 255-257 lanes, on windows of EDGE lanes
   only and on the five single-algorithm windows; the merged tick (B.3)
   on 8192 unique heads of the same table (Zipf(1.2) group sizes on token
   and leaky heads, size 1 on the zoo's, the edge lanes, 64 padding
   heads), on its slices at the same tile edges and at 512 and 4096 heads,
   and on windows of token, leaky or zoo heads only; gather and scatter
   on 32768 random slots; and the ragged tick (B.4) on 32768-lane windows of global slots over 8 shards
   of the same size, with balanced extents and with every lane on one
   shard, and on their slices and edge windows as B.1; the chained
   duplicate tick (B.5) on 32768-lane windows of Zipf(1.2) slots (the
   phase-3 fallback window's skew), on their slices, on a 4096-lane
   window of one segment and on a window of EDGE lanes.  CUDA-event times
   (median of 25) of each kernel, its plain version and, for
   gather/scatter, ``index_select`` / ``index_copy_`` as a yardstick; B.1
   at every power of two from 1 to 32768 lanes, B.4 at 1, 64, 4096 and
   32768 and B.3 at 512, 4096 and 8192 heads (``by_width``), B.1 on each
   single-algorithm window and B.3 on each single-class window, rotating
   over windows that touch more than twice the L2 (``working_set_mb``);
   B.5 on its windows and on the one-segment window, whose time over its
   lanes is one link of a segment's chain (``longest_chain_ms``: the
   longest segment's links at that rate, a chain length measured in this
   kernel, not a bound).  ``--against CHECKOUT`` times that checkout's tick kernels in turns with
   these (``against_ms``);
3. the engine at full size: ``TickEngine(capacity=10_000_000,
   max_batch=32768)`` serves windows that are first held against a
   ``device="cpu"`` engine on the same route (a unique window, a random
   Zipf(1.2) window, a revisit, a herd window, a herd window with RESET
   rows), then a 10M-key prefill, 32 pipelined unique windows
   (decisions/s, and the host's time per window split into slot lookup,
   packing and sort), a 32768-wide Zipf(1.2) herd (the grouped plan: one
   merged launch) and a herd with RESET rows on its 256 hottest keys (the
   layered plan), both checked against a scalar token-bucket model, a
   random Zipf(1.2) window of 32768 (neither plan: one B.5 launch), a
   window of fresh keys against the full table (reclaim: gather +
   scatter), and the table's state exported, loaded into a fresh engine
   and exported again (the two exports compared).  Each of these paths
   runs with every kernel's launch count set to 0 just before it and read
   just after;
4. the sharded engine at full size: ``MeshTickEngine(n_shards=8,
   local_capacity=1_250_000, max_batch=32768)`` serves windows first held
   against a ``device="cpu"`` mesh engine of 8 smaller shards (unique,
   random Zipf(1.2), herd, revisit, and a window whose keys all route to
   shard 0), then a prefill of every shard to capacity (10M keys), 32
   pipelined unique windows (decisions/s and the host split: CRC-32
   routing, per-shard resolve, packing, sort), a Zipf(1.2) herd of the
   prefill's token requests (the merge tick, checked against the scalar
   token-bucket model), a skewed unique window of 32768 keys on shard 0
   and a window of fresh keys (per-shard reclaim).  A unique window and
   the skewed window must each take one ``fused_ragged_tick`` launch and
   no other; every path reports its launches.

5. the tiers and persistence: first a ``TickEngine(capacity=2**14,
   max_batch=4096, cold_capacity=2**13)`` with a ``MockStore`` and an
   ``SsdStore`` held bit for bit against the same engine on the CPU over
   16 windows of uniform draws over 2^16 keys, and background reclaim
   under load (every answer a key's exact count); then
   ``TickEngine(capacity=10_000_000, max_batch=32768,
   cold_capacity=2**22, ssd=SsdStore(capacity_bytes=2**33))`` with
   background reclaim at its default (on): eight probe keys, a prefill of
   458 windows of fresh keys (a working set 1.5x the table: hot, cold and
   SSD), 32 churn windows of distinct keys drawn from it (decisions/s,
   p50 and max seconds, the host split: slot lookup, promote with the SSD
   lookup, pack, sort; the row kernels' CUDA-event ms), the probes again
   (each answers its count), and a ``SnapshotWriter`` flush and base of
   the engine, read back and replayed into a fresh engine (seconds and
   bytes of each step, 4096 sampled items held against the original's).
   Phase 2 also times gather and scatter at the shapes the tiers launch
   (``at_tier_shapes``).

Phases 3-5 also report each path's tick launches by lane width
(``launches_by_width``, power-of-two buckets), summed over them on the
``launch_widths`` line.  Then the kernel table as one JSON line, the card
line, and last ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device the script exits non-zero before
printing a result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
NOW = 1_700_000_000_000
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and int32 operations/s
# of the CUDA cores (132 SMs x 64 lanes x 1.98 GHz boost).
HBM_BYTES_PER_S = 3.35e12
L2_MB = 50
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations one fused-tick lane does, counted from
# csrc/transition.cuh: ~200 int64 adds, compares and selects at two int32
# operations each (an estimate; the float64 work is a handful of
# operations a lane and is left out).
FUSED_TICK_INT32_OPS_PER_LANE = 400
# The merged tick does the same plus the duplicate fold (~30 more int64
# operations a lane, csrc/transition.cuh merged_fold): an estimate.
MERGED_TICK_INT32_OPS_PER_LANE = 460
# Bytes a merged-tick head moves besides its row (128 B read + 128 B
# written when live): 76 B of request, 4 B of count, 96 B of journal.
MERGED_BYTES_PER_HEAD = 76 + 4 + 96
LAYER_WIDTH = 512  # a narrow layer of the layered plan
# Head widths phase 2 times the merged tick at besides its full window
# (8192 heads, the grouped plan's): the layered plan's layers.
MERGED_WIDTHS = (LAYER_WIDTH, 4096)
# Lane widths phase 2 times the unique-slot ticks at: a rank round's usual
# single lane, one 64-lane tile, a first rank round or a merge tick's
# heads, the full window.
TICK_WIDTHS = (1, 64, 4096, 32768)
# The fused tick is also timed at every power of two up to the window:
# the buckets its launches are counted in (launches_by_width).
POW2_WIDTHS = tuple(1 << k for k in range(16))
# Widths also held bit for bit against the plain versions: the edges of
# the kernels' one-thread-a-lane path (8 / 9 lanes) and of their 64-lane
# tiles, and 255-257 lanes.
EDGE_WIDTHS = (8, 9, 63, 65, 255, 256, 257)
# The merged tick's: the same tile edges, one head and a layer.
MERGED_EDGE_WIDTHS = (1, 8, 9, 63, 64, 65, 255, 256, 257, LAYER_WIDTH,
                      4096)
ALGORITHMS = ("token", "leaky", "sliding_window", "gcra", "concurrency")
REPS = 25        # timed runs a measurement; the median is kept
INNER = 8        # launches between the two events of one timed run
SLEEP_CYCLES = 4_000_000  # ~2 ms: the card waits while the host queues


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fns, reps: int = REPS) -> float:
    """Device time of one call, from CUDA events: the median over ``reps``
    runs of INNER back-to-back calls, each run queued behind a ~2 ms
    device sleep so the events time the card and not the host's launch
    overhead.  ``fns`` is one callable or a list whose calls rotate:
    phase 2 rotates the ticks over windows whose rows and request and
    response columns add up to more than twice the 50 MB L2
    (``working_set_mb`` on its line), so a window's rows come from HBM as
    in the engine; no L2 flush is used."""
    fns = fns if isinstance(fns, list) else [fns]
    for f in fns:
        f()
    torch.cuda.synchronize()
    times = []
    k = 0
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(INNER):
            fns[k % len(fns)]()
            k += 1
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / INNER)
    return float(np.median(times))


# ----------------------------------------------------------------------
# Inputs (numpy, from SEED)
# ----------------------------------------------------------------------
def random_state(rng, n: int) -> dict:
    """Per-slot logical state over all five algorithms."""
    alg = rng.integers(0, 5, n)
    limit = rng.choice([1, 7, 10, 1000, 2000, 10**13], n)
    return {
        "algorithm": alg,
        "limit": limit,
        "remaining": rng.integers(-3, 30, n),
        "remaining_f": rng.integers(0, 25, n) + rng.integers(0, 8, n) / 8.0,
        "duration": rng.choice([500, 1_000, 2_000, 30_000, 120_000], n),
        "created_at": NOW - rng.integers(0, 120_000, n),
        "updated_at": NOW - rng.integers(-5_000, 120_000, n),
        "burst": rng.choice([0, 3, 5, 50, 10**6], n),
        "status": (rng.random(n) < 0.2).astype(np.int64),
        "expire_at": NOW + rng.choice([-10_000, -1, 0, 1, 60_000], n),
        "in_use": rng.random(n) < 0.85,
        "tat": NOW + rng.integers(-60_000, 60_000, n),
        "prev_count": rng.integers(0, 30, n),
    }


def random_requests(rng, n: int) -> dict:
    """Request columns mixing all algorithms and behavior flags."""
    beh = np.zeros(n, np.int64)
    p = rng.random(n)
    beh[p < 0.15] = 8                       # RESET_REMAINING
    beh[(p >= 0.15) & (p < 0.3)] = 32       # DRAIN_OVER_LIMIT
    beh[(p >= 0.3) & (p < 0.35)] = 8 | 32
    beh |= rng.choice([0, 1, 2, 16], n)     # NO_BATCHING, GLOBAL, MULTI_REGION
    greg = (p >= 0.35) & (p < 0.45)
    beh[greg] |= 4                          # DURATION_IS_GREGORIAN
    return {
        "known": rng.random(n) < 0.8,
        "algorithm": rng.integers(0, 5, n),
        "behavior": beh,
        "hits": rng.choice([0, 1, 2, 5, 100, -1, -50, 10**12], n),
        "limit": rng.choice([3, 10, 1000, 1 << 34], n),
        "duration": rng.choice([0, 1_000, 30_000, 3_600_000], n),
        "created_at": NOW - rng.choice([0, 0, 500, 3_000, 61_000, -500], n),
        "burst": rng.choice([0, 5, 20, 2000], n),
        "greg_exp": np.where(greg, NOW + rng.choice([500, 3_600_000], n), 0),
        "greg_dur": np.where(greg, rng.choice([3_600_000, 86_400_000], n), 0),
    }


# Lanes at the arithmetic edges: float64 -> int64 out of range (the leak
# of a 1e-13 rate), NaN/inf/negative leaky remainders, int64 products
# that wrap, zero/negative limits and durations across the zoo, and an
# algorithm value past the enum.  (request fields, stored-state fields)
EDGE = [
    (dict(algorithm=1, limit=10**13, duration=1, hits=1),
     dict(algorithm=1, updated_at=0, remaining_f=3.5)),
    (dict(algorithm=1, limit=10**13, duration=1, hits=1),
     dict(algorithm=1, updated_at=2 * NOW, remaining_f=2.0)),
    (dict(algorithm=1, limit=10, duration=30_000, hits=1),
     dict(algorithm=1, remaining_f=float("nan"))),
    (dict(algorithm=1, limit=10, duration=30_000, hits=0),
     dict(algorithm=1, remaining_f=float("inf"))),
    (dict(algorithm=1, limit=10, duration=30_000, hits=2),
     dict(algorithm=1, remaining_f=-float("inf"))),
    (dict(algorithm=0, limit=10, duration=30_000, hits=0, behavior=8),
     dict(algorithm=0, remaining_f=-7.25)),
    (dict(algorithm=1, limit=2**62, duration=2**62, hits=10**12, known=0),
     dict(algorithm=1)),
    (dict(algorithm=1, limit=-(2**62), duration=2**62 - 1, hits=3, known=0),
     dict(algorithm=1)),
    (dict(algorithm=2, limit=0, duration=0, hits=1), dict(algorithm=2)),
    (dict(algorithm=2, limit=5, duration=-10, hits=2, created_at=-5),
     dict(algorithm=2)),
    (dict(algorithm=3, limit=-4, duration=-1000, hits=-2), dict(algorithm=3)),
    (dict(algorithm=3, limit=7, duration=1000, hits=10**12, burst=2**40),
     dict(algorithm=3)),
    (dict(algorithm=4, limit=3, duration=1000, hits=2**62), dict(algorithm=4)),
    (dict(algorithm=2, limit=5, duration=1000, hits=1),
     dict(algorithm=2, prev_count=2**62, created_at=NOW - 1500)),
    (dict(algorithm=7, limit=5, duration=1000, hits=1), dict(algorithm=2)),
    # floor division's 32-bit fast path at its edges: operands of 2^31 - 1,
    # 2^32 - 1, 2^32 and negative timestamps through the sliding window
    # and GCRA divisions
    (dict(algorithm=2, limit=5, duration=2**32 - 1, hits=1,
          created_at=2**32 - 1), dict(algorithm=2, created_at=0)),
    (dict(algorithm=2, limit=5, duration=2**31 - 1, hits=1,
          created_at=2**32), dict(algorithm=2, created_at=2**31,
                                  prev_count=2**31)),
    (dict(algorithm=2, limit=9, duration=2**32, hits=2,
          created_at=2**32 + 1), dict(algorithm=2, created_at=1)),
    (dict(algorithm=3, limit=2**32 - 1, duration=2**32 - 1, hits=1,
          created_at=2**31 - 1), dict(algorithm=3, tat=2**32)),
    (dict(algorithm=3, limit=3, duration=2**32, hits=1, created_at=-5),
     dict(algorithm=3, tat=-5)),
    (dict(algorithm=3, limit=2**32, duration=2**32 - 1, hits=2),
     dict(algorithm=3)),
]


def _set_edge(req: dict, state: dict, k: int, slot: int, edge) -> None:
    """Request lane ``k`` and the stored state of ``slot`` set to the EDGE
    entry ``edge`` (request fields, stored-state fields); the lane's other
    request fields stay as they are."""
    r, s = edge
    for f, v in r.items():
        req[f][k] = v
    req["known"][k] = r.get("known", 1)
    for f in state:
        state[f][slot] = 0
    state["expire_at"][slot] = NOW + 60_000
    state["in_use"][slot] = True
    state["remaining"][slot] = 2
    state["updated_at"][slot] = NOW - 5_000
    state["created_at"][slot] = NOW - 5_000
    for f, v in s.items():
        state[f][slot] = v


def _pack(engine_mod, cap: int, lanes: int, slots, req: dict):
    """(19, lanes) REQ32 matrix of the live lanes ``slots`` / ``req``; the
    lanes past them are padding aimed at the guard row."""
    n = len(slots)
    R = engine_mod.REQ32_INDEX
    m = np.zeros((engine_mod.REQ32_ROWS, lanes), np.int32)
    m[R["slot"]] = cap
    m[R["slot"], :n] = slots
    m[R["valid"], :n] = 1
    for f in ("known", "algorithm", "behavior"):
        m[R[f], :n] = req[f]
    for f in engine_mod.REQ32_WIDE:
        engine_mod.pack_wide_rows(m, f, req[f], slice(0, n))
    return m


def fused_window(engine_mod, rng, cap: int, lanes: int, state: dict):
    """A slot-sorted unique (19, lanes) REQ32 window: random live lanes,
    the EDGE lanes (their slots' stored state overwritten in ``state``),
    and 64 padding lanes."""
    n = lanes - 64
    slots = np.sort(rng.choice(cap, n, replace=False))
    req = random_requests(rng, n)
    edge_at = rng.choice(n, len(EDGE), replace=False)
    for k, edge in zip(edge_at, EDGE):
        _set_edge(req, state, k, slots[k], edge)
    return _pack(engine_mod, cap, lanes, slots, req), n


def edge_window(engine_mod, rng, lanes: int, state: dict):
    """A (19, lanes) window of EDGE lanes only (EDGE over and over) on the
    slots 0 to lanes - 1, every lane live."""
    req = random_requests(rng, lanes)
    for k in range(lanes):
        _set_edge(req, state, k, k, EDGE[k % len(EDGE)])
    cap = len(state["algorithm"])
    return _pack(engine_mod, cap, lanes, np.arange(lanes), req)


def merged_window(engine_mod, rng, cap: int, lanes: int, state: dict):
    """Slot-sorted unique heads for the merged tick: a ``fused_window``
    (random heads over all five algorithms, the EDGE lanes, 64 padding
    heads) with group sizes, Zipf(1.2) on token and leaky heads and 1 on
    the zoo's.  Returns ``(m, count, live)``."""
    m, n = fused_window(engine_mod, rng, cap, lanes, state)
    alg = m[engine_mod.REQ32_INDEX["algorithm"], :n]
    count = np.ones(lanes, np.int32)
    count[:n] = np.where((alg >= 0) & (alg <= 1),
                         np.minimum(rng.zipf(1.2, n), 1 << 20), 1)
    return m, count, n


def sorted_window(engine_mod, rng, cap: int, lanes: int, state: dict,
                  one_slot: bool = False):
    """A slot-sorted (19, lanes) window whose slots repeat, for the chained
    duplicate tick: Zipf(1.2) slots over the table (the phase-3 fallback
    window's key skew), or with ``one_slot`` every lane on one random slot
    (one segment as long as the window); random requests over all five
    algorithms and flags, the EDGE lanes' requests and stored state on
    lanes spread over the window, and the last ``lanes // 8`` lanes
    padding aimed at the guard row (none with ``one_slot``)."""
    n = lanes if one_slot else lanes - lanes // 8
    if one_slot:
        slots = np.full(n, rng.integers(0, cap))
    else:
        slots = np.sort((rng.zipf(1.2, n) - 1) % cap)
    req = random_requests(rng, n)
    edge_at = rng.choice(n, min(n, len(EDGE)), replace=False)
    for k, edge in zip(edge_at, EDGE):
        _set_edge(req, state, k, slots[k], edge)
    return _pack(engine_mod, cap, lanes, slots, req)


def longest_segment(engine_mod, m, cap: int) -> int:
    """The most live lanes of one slot in window ``m``."""
    R = engine_mod.REQ32_INDEX
    sl = m[R["slot"]]
    s = sl[(m[R["valid"]] != 0) & (sl >= 0) & (sl < cap)]
    return int(np.bincount(s).max()) if len(s) else 0


RAGGED_SHARDS = 8


def ragged_window(engine_mod, rng, n_shards: int, local_capacity: int,
                  lanes: int, state: dict, skew: bool = False):
    """A slot-sorted unique (19, lanes) window of GLOBAL slots for the
    ragged tick over ``n_shards`` shards of ``local_capacity`` slots: a
    ``fused_window`` (random live lanes, the EDGE lanes, 64 padding lanes
    past every extent) spread over every shard or, with ``skew``, all on
    shard 0.  Returns ``(m, offsets, live)``."""
    cap = n_shards * local_capacity
    R = engine_mod.REQ32_INDEX
    m, n = fused_window(engine_mod, rng, local_capacity if skew else cap,
                        lanes, state)
    m[R["slot"], n:] = cap
    counts = np.bincount(m[R["slot"], :n] // local_capacity,
                         minlength=n_shards)
    offsets = np.zeros(n_shards + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    return m, offsets, n


def key_blob(prefix: bytes, ids) -> tuple[bytes, np.ndarray]:
    """Fixed-width keys ``prefix + 8 decimal digits``, built without a
    per-key Python loop."""
    ids = np.asarray(ids, np.int64)
    p = len(prefix)
    a = np.empty((len(ids), p + 8), np.uint8)
    a[:, :p] = np.frombuffer(prefix, np.uint8)
    for d in range(8):
        a[:, p + 7 - d] = 48 + (ids // 10**d) % 10
    return a.tobytes(), np.arange(len(ids) + 1, dtype=np.int64) * (p + 8)


def window_columns(reqcols, rng, prefix: bytes, ids, now: int, prefill=False):
    """A ReqColumns window over keys ``prefix + id``: the prefill is one
    token hit on a one-hour bucket; other windows mix every algorithm and
    flag, with a few invalid Gregorian selectors (per-item errors)."""
    n = len(ids)
    blob, offsets = key_blob(prefix, ids)
    if prefill:
        one = np.ones(n, np.int64)
        return reqcols.ReqColumns(
            blob, offsets, one, one * 100, one * 3_600_000, one * 0, one * 0,
            one * now, one * 0)
    r = random_requests(rng, n)
    greg = (r["behavior"] & 4) != 0
    dur = np.where(greg, rng.choice([0, 1, 2, 3, 4, 5, 9], n), r["duration"])
    return reqcols.ReqColumns(
        blob, offsets, r["hits"], r["limit"], dur, r["algorithm"],
        r["behavior"], np.where(rng.random(n) < 0.5, -1, r["created_at"]),
        r["burst"])


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------
def _entry(name, source, replaces, err, ms, plain_ms, library_ms,
           nbytes, ops):
    """One kernel's measurements; the bound is the larger of its bytes
    over the HBM rate and its int32 operations over the CUDA cores'."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms, bytes=nbytes, ops=ops,
    )


def _max_abs(torch, a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def check_tick(torch, fn, plain, table, args, what, plain_ms=None):
    """``fn`` and its plain version on two copies of ``table``, the same
    ``args``: the response and the table must be equal bit for bit.
    Returns the largest absolute difference (0).  With a list
    ``plain_ms``, the plain call's wall time (ms, the card synchronized
    before and after) is appended to it."""
    t_k, t_p = table.clone(), table.clone()
    r_k = fn(t_k, *args)
    r_p = torch.empty_like(r_k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain(t_p, *args, r_p)
    torch.cuda.synchronize()
    if plain_ms is not None:
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    err = max(_max_abs(torch, r_k, r_p), _max_abs(torch, t_k, t_p))
    assert torch.equal(r_k, r_p), f"{what}: response differs from plain"
    assert torch.equal(t_k, t_p), f"{what}: table differs from plain"
    return err


def ab_times(torch, ours, theirs=None) -> dict:
    """``ours`` timed; with ``theirs`` (the same work on another checkout's
    kernel) the two are timed in turns, theirs, ours, ours, theirs."""
    if theirs is None:
        return {"ms": time_ms(torch, ours)}
    a = time_ms(torch, theirs)
    b, c = time_ms(torch, ours), time_ms(torch, ours)
    return {"ms": b, "ms_repeat": c, "against_ms": [a, time_ms(torch, theirs)]}


def _bound(nbytes, ops) -> dict:
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def tick_bytes(live: int, lanes: int) -> int:
    """Bytes a unique-slot tick must move: a live lane's 128-B row read and
    written, every lane's 76 B of request and 24 B of response."""
    return live * 256 + lanes * (76 + 24)


def tick_widths(lanes: int, widths=TICK_WIDTHS) -> list:
    """``widths`` below a window of ``lanes`` lanes, and the window."""
    return [w for w in widths if w < lanes] + [lanes]


def working_set_mb(engine_mod, mats) -> float:
    """Rows (distinct live slots) and request and response columns that
    rotating over the windows ``mats`` touches, in MB."""
    R = engine_mod.REQ32_INDEX
    slots = np.concatenate([m[R["slot"], m[R["valid"]] != 0] for m in mats])
    return (len(np.unique(slots)) * 128
            + sum(m.shape[1] for m in mats) * (76 + 24)) / 1e6


def with_algorithm(engine_mod, m, alg: int, live: int):
    """Window ``m`` with every live lane's request algorithm set to ``alg``."""
    m = m.copy()
    m[engine_mod.REQ32_INDEX["algorithm"], :live] = alg
    return m


def build_against(path: str) -> dict:
    """The tick kernels of another checkout at ``path`` (the same C
    interfaces), built from its ``csrc/`` with this checkout's flags, one
    compiler each, all started together: ``{kernel: C function}``."""
    import ctypes

    from gubernator_tpu_torch import _build

    csrc = os.path.join(os.path.abspath(path), "gubernator_tpu_torch", "csrc")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    sigs = {
        "fused_tick": [vp, i64, vp, i64, vp, i64, i64, i64, vp],
        "fused_merged_tick": [vp, i64, vp, i64, vp, vp, i64, i64, vp],
        "fused_ragged_tick": [vp, i64, i64, vp, vp, i64, vp, i64, i64, i64, vp],
    }
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in sigs:
        out = os.path.join(_build.BUILD_DIR, f"against-{name}.so")
        cmd = ([_build._compiler("nvcc")] + _build.NVCC_FLAGS
               + ["-I", csrc, "-o", out, os.path.join(csrc, name + ".cu")])
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), out)
    fns = {}
    for name, (proc, out) in jobs.items():
        log = proc.communicate()[0].decode(errors="replace")
        assert proc.returncode == 0, f"building {out} failed:\n{log}"
        fn = getattr(ctypes.CDLL(out), "gt_" + name)
        fn.restype, fn.argtypes = ctypes.c_int, sigs[name]
        fns[name] = fn
    return fns


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


def merged_single(engine_mod, rng, m, count, live: int, kind: str):
    """Head window ``m`` with every live head of one class: ``token`` or
    ``leaky`` (Zipf(1.2) group sizes), or ``zoo`` (sliding window, GCRA or
    concurrency at random, group sizes as drawn: the fold skips them)."""
    m, count = m.copy(), count.copy()
    A = engine_mod.REQ32_INDEX["algorithm"]
    if kind == "zoo":
        m[A, :live] = rng.integers(2, 5, live)
    else:
        m[A, :live] = ALGORITHMS.index(kind)
        count[:live] = np.minimum(rng.zipf(1.2, live), 1 << 20)
    return m, count


def merged_entry(torch, table, wins, live, singles, against=None):
    """The merged tick against its plain version, bit for bit, on the first
    window of heads, on its column slices at MERGED_EDGE_WIDTHS (ld_m > U,
    as the layered plan's layers pass) and on the single-class windows
    ``singles``; its times at MERGED_WIDTHS and the full window
    (``by_width``: one narrow layer of the layered plan, a mid layer, the
    grouped plan's head block) and on the single-class windows at full
    width."""
    from gubernator_tpu_torch.ops.fusedtick import (
        MERGED24_W, fused_merged_tick, fused_merged_tick_plain)

    u = wins[0][0].shape[1]
    mh0, c0 = wins[0]
    cases = [(f"slice {w}", (mh0[:, :w], c0[:w]))
             for w in MERGED_EDGE_WIDTHS if w < u]
    cases += [(f"window {u}", wins[0])]
    cases += [(f"{kind} window", ws[0]) for kind, ws in singles.items()]
    err = 0
    for what, (mh, c) in cases:
        err = max(err, check_tick(torch, fused_merged_tick,
                                  fused_merged_tick_plain, table,
                                  (mh, c, NOW), "fused_merged_tick " + what))
    scratch = table.clone()
    jr = torch.empty((u, MERGED24_W), dtype=torch.int32, device=table.device)
    cap = table.shape[0] - 1

    def timed(ws, w):
        theirs = None if against is None else [
            lambda x=x: against["fused_merged_tick"](
                scratch.data_ptr(), cap, x[0].data_ptr(), x[0].stride(0),
                x[1].data_ptr(), jr.data_ptr(), w, NOW, _stream(torch))
            for x in ws]
        return ab_times(torch, [lambda x=x: fused_merged_tick(
            scratch, x[0][:, :w], x[1][:w], NOW, out=jr[:w]) for x in ws],
            theirs)

    def bound(w):
        n = min(w, live)
        return _bound(n * 256 + w * MERGED_BYTES_PER_HEAD,
                      n * MERGED_TICK_INT32_OPS_PER_LANE)

    by_width = {w: {**timed(wins, w), **bound(w)}
                for w in tick_widths(u, MERGED_WIDTHS)}
    full = by_width[u]
    e = _entry(
        "fused_merged_tick", "gubernator_tpu_torch/csrc/fused_merged_tick.cu",
        "gubernator_tpu/ops/fusedtick.py:387", err, full["ms"],
        time_ms(torch, [lambda w=w: fused_merged_tick_plain(
            scratch, *w, NOW, jr) for w in wins], reps=5),
        None, live * 256 + u * MERGED_BYTES_PER_HEAD,
        live * MERGED_TICK_INT32_OPS_PER_LANE)
    e.update({k: v for k, v in full.items() if k in ("ms_repeat",
                                                     "against_ms")})
    e["heads"] = u
    e["checked"] = [what for what, _ in cases]
    e["by_width"] = by_width
    e["single_class"] = {kind: timed(ws, u) for kind, ws in singles.items()}
    return e


def tick_entry(torch, dev, rng, lanes: int, table_slots: int, rotate: int,
               against=None):
    """Kernel B.1, the fused tick, on a ``table_slots`` random table:
    held against its plain version bit for bit on the mixed window, on
    column slices of it at every TICK_WIDTHS and EDGE_WIDTHS width (ld_m
    > B, as rank rounds pass), on whole windows of 255, 256 and 257 lanes,
    on a slice from an inner column, on slices of a window of EDGE lanes
    only and on the five single-algorithm windows; then timed at each
    POW2_WIDTHS width of the mixed windows and on the single-algorithm
    windows at full width, rotating over ``rotate`` windows, each with its
    own response buffer."""
    from gubernator_tpu_torch.carry import table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops.fusedtick import fused_tick, fused_tick_plain

    cap = table_slots
    state = random_state(rng, cap)
    mats = [fused_window(E, rng, cap, lanes, state)[0] for _ in range(rotate)]
    whole = [fused_window(E, rng, cap, w, state)[0] for w in (255, 256, 257)]
    edges = edge_window(E, rng, 257, state)
    table = table_from_columns(state, cap, dev)
    live = lanes - 64
    wins = [torch.from_numpy(m).to(dev) for m in mats]
    singles = {name: [torch.from_numpy(with_algorithm(E, m, a, live)).to(dev)
                      for m in mats] for a, name in enumerate(ALGORITHMS)}

    cases = [(f"slice {w}", wins[0][:, :w])
             for w in sorted(set(TICK_WIDTHS + EDGE_WIDTHS)) if w <= lanes]
    cases += [(f"window {m.shape[1]}", torch.from_numpy(m).to(dev))
              for m in whole]
    cases += [("inner slice 100:357", wins[1][:, 100:357])]
    cases += [(f"EDGE slice {w}", torch.from_numpy(edges).to(dev)[:, :w])
              for w in (1, 9, 257)]
    cases += [(f"{name} window", ws[0]) for name, ws in singles.items()]
    err = 0
    for what, m in cases:
        err = max(err, check_tick(torch, fused_tick, fused_tick_plain, table,
                                  (m, NOW), "fused_tick " + what))
    work = table.clone()
    resps = [torch.empty((6, lanes), dtype=torch.int32, device=dev)
             for _ in wins]
    fn = None if against is None else against["fused_tick"]

    def timed(ws, w):
        theirs = None if fn is None else [
            lambda x=x, r=r: fn(work.data_ptr(), cap, x.data_ptr(),
                                x.stride(0), r.data_ptr(), r.stride(0), w,
                                NOW, _stream(torch))
            for x, r in zip(ws, resps)]
        return ab_times(torch, [
            lambda x=x, r=r: fused_tick(work, x[:, :w], NOW, out=r[:, :w])
            for x, r in zip(ws, resps)], theirs)

    by_width = {}
    for w in tick_widths(lanes, POW2_WIDTHS):
        n = min(w, live)
        by_width[w] = {**timed(wins, w), **_bound(
            tick_bytes(n, w), n * FUSED_TICK_INT32_OPS_PER_LANE)}
    full = by_width[lanes]
    e = _entry(
        "fused_tick", "gubernator_tpu_torch/csrc/fused_tick.cu",
        "gubernator_tpu/ops/fusedtick.py:189", err, full["ms"],
        time_ms(torch, [lambda x=x, r=r: fused_tick_plain(work, x, NOW, r)
                        for x, r in zip(wins, resps)], reps=5),
        None, tick_bytes(live, lanes), live * FUSED_TICK_INT32_OPS_PER_LANE)
    e["checked"] = [what for what, _ in cases]
    e["working_set_mb"] = working_set_mb(E, mats)
    e["by_width"] = by_width
    e["single_algorithm"] = {name: timed(ws, lanes)
                             for name, ws in singles.items()}
    return e, table, state


def ragged_entry(torch, dev, rng, lanes: int, table_slots: int,
                 rotate: int, against=None):
    """Kernel B.4, the ragged tick, over RAGGED_SHARDS shards of
    ``table_slots / RAGGED_SHARDS`` slots: held against its plain version
    bit for bit on a window with balanced extents and on one whose every
    lane is on shard 0, on their column slices at every TICK_WIDTHS and
    EDGE_WIDTHS width (offsets clipped to the slice) and on whole windows
    of 255, 256 and 257 lanes; timed on both at each TICK_WIDTHS width,
    rotating over ``rotate`` windows, each with its own response buffer
    (the bound is the fused tick's, whatever the skew)."""
    from gubernator_tpu_torch.carry import sharded_table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops.raggedtick import (
        fused_ragged_tick, fused_ragged_tick_plain)

    n = RAGGED_SHARDS
    L = table_slots // n
    state = random_state(rng, n * L)
    raw = {skew: [ragged_window(E, rng, n, L, lanes, state, skew)
                  for _ in range(rotate)] for skew in (False, True)}
    whole = [ragged_window(E, rng, n, L, w, state) for w in (255, 256, 257)]
    edges = edge_window(E, rng, 257, state)  # all on shard 0
    whole.append((edges, np.array([0] + [257] * n, np.int32), 257))
    table = sharded_table_from_columns(state, n, L, dev)

    def narrow(m, o, w):
        return (m[:, :w], torch.from_numpy(np.minimum(o, w).astype(
            np.int32)).to(dev))

    dwins = {skew: [(torch.from_numpy(m).to(dev), o) for m, o, _ in ws]
             for skew, ws in raw.items()}
    cases = []
    for skew, ws in dwins.items():
        m, o = ws[0]
        cases += [(f"{'skewed' if skew else 'balanced'} slice {w}",
                   narrow(m, o, w))
                  for w in sorted(set(TICK_WIDTHS + EDGE_WIDTHS)) if w <= lanes]
    cases += [(f"window {m.shape[1]}{' EDGE' if k == 3 else ''}",
               (torch.from_numpy(m).to(dev), torch.from_numpy(o).to(dev)))
              for k, (m, o, _) in enumerate(whole)]
    err = 0
    for what, (m, o) in cases:
        err = max(err, check_tick(
            torch, fused_ragged_tick, fused_ragged_tick_plain, table,
            (m, o, n, L, NOW), "fused_ragged_tick " + what))
    work = table.clone()
    resps = [torch.empty((6, lanes), dtype=torch.int32, device=dev)
             for _ in range(rotate)]
    fn = None if against is None else against["fused_ragged_tick"]

    def timed(ws, w):
        cut = [narrow(m, o, w) for m, o in ws]
        theirs = None if fn is None else [
            lambda x=x, r=r: fn(work.data_ptr(), n, L, x[1].data_ptr(),
                                x[0].data_ptr(), x[0].stride(0),
                                r.data_ptr(), r.stride(0), w, NOW,
                                _stream(torch))
            for x, r in zip(cut, resps)]
        return ab_times(torch, [
            lambda x=x, r=r: fused_ragged_tick(work, *x, n, L, NOW,
                                               out=r[:, :w])
            for x, r in zip(cut, resps)], theirs)

    live = lanes - 64
    by_width = {}
    for w in tick_widths(lanes):
        k = min(w, live)
        by_width[w] = {
            "balanced": timed(dwins[False], w), "skewed": timed(dwins[True], w),
            **_bound(tick_bytes(k, w) + (n + 1) * 4,
                     k * FUSED_TICK_INT32_OPS_PER_LANE)}
    full = by_width[lanes]
    full_cut = [narrow(m, o, lanes) for m, o in dwins[False]]
    e = _entry(
        "fused_ragged_tick", "gubernator_tpu_torch/csrc/fused_ragged_tick.cu",
        "gubernator_tpu/ops/raggedtick.py:153", err, full["balanced"]["ms"],
        time_ms(torch, [lambda x=x, r=r: fused_ragged_tick_plain(
            work, *x, n, L, NOW, r) for x, r in zip(full_cut, resps)], reps=5),
        None, tick_bytes(live, lanes) + (n + 1) * 4,
        live * FUSED_TICK_INT32_OPS_PER_LANE)
    e["shards"] = n
    e["checked"] = [what for what, _ in cases]
    e["working_set_mb"] = working_set_mb(E, [m for m, _, _ in raw[False]])
    e["by_width"] = by_width
    e["skewed"] = {**full["skewed"], "bound_ms": e["bound_ms"],
                   "extent_lanes": int(raw[True][0][1][1])}
    return e


# Lanes of the one-segment window phase 2 times the chained duplicate
# tick on: its time over these lanes is one link of a segment's chain.
CHAIN_LANES = 4096
# The chained tick's column slices held against its plain version.
SORTED_EDGE_WIDTHS = (1, 8, 9, 63, 64, 65, 255, 256, 257, 4096)


def sorted_entry(torch, dev, rng, state, lanes: int, rotate: int):
    """Kernel B.5, the chained duplicate tick, on ``state``'s random table
    (the windows' EDGE lanes' stored state in place): held against its plain version (rank rounds of the
    fused tick's plain version, on the card) bit for bit on a Zipf(1.2)
    window of ``lanes`` lanes (the phase-3 fallback window's skew), on
    its column slices at SORTED_EDGE_WIDTHS (ld_m > B), on a window of
    one segment of CHAIN_LANES lanes and on a window of EDGE lanes; timed
    on the Zipf windows, rotating over ``rotate`` of them, and on the
    one-segment window; the plain version is timed by the check's one
    call on the first Zipf window.  ``longest_chain_ms`` is the Zipf
    window's longest segment times one link of the one-segment window's
    chain: what the kernel's own chain costs at that length, not a
    bound."""
    from gubernator_tpu_torch.carry import table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops.sortedtick import (
        fused_sorted_tick, fused_sorted_tick_plain)

    cap = len(state["algorithm"])
    mats = [sorted_window(E, rng, cap, lanes, state) for _ in range(rotate)]
    chain = sorted_window(E, rng, cap, CHAIN_LANES, state, one_slot=True)
    req = random_requests(rng, 257)
    eslots = np.arange(257) // 3
    for k in range(257):
        _set_edge(req, state, k, eslots[k], EDGE[k % len(EDGE)])
    edges = _pack(E, cap, 257, eslots, req)
    table = table_from_columns(state, cap, dev)
    wins = [torch.from_numpy(m).to(dev) for m in mats]
    chain_d = torch.from_numpy(chain).to(dev)
    cases = [(f"slice {w}", wins[0][:, :w]) for w in SORTED_EDGE_WIDTHS
             if w < lanes]
    cases += [(f"zipf window {lanes}", wins[0]),
              (f"one segment {CHAIN_LANES}", chain_d),
              ("EDGE window 257", torch.from_numpy(edges).to(dev))]
    err = 0
    plain_ms = []
    for what, m in cases:
        err = max(err, check_tick(
            torch, fused_sorted_tick, fused_sorted_tick_plain, table,
            (m, NOW), "fused_sorted_tick " + what,
            plain_ms if m is wins[0] else None))
    work = table.clone()
    resps = [torch.empty((6, lanes), dtype=torch.int32, device=dev)
             for _ in wins]
    ms = time_ms(torch, [lambda x=x, r=r: fused_sorted_tick(work, x, NOW,
                                                             out=r)
                         for x, r in zip(wins, resps)])
    chain_ms = time_ms(torch, lambda: fused_sorted_tick(work, chain_d, NOW))
    R = E.REQ32_INDEX
    sl = mats[0][R["slot"]]
    live = (mats[0][R["valid"]] != 0) & (sl >= 0) & (sl < cap)
    distinct = len(np.unique(sl[live]))
    longest = longest_segment(E, mats[0], cap)
    e = _entry(
        "fused_sorted_tick", "gubernator_tpu_torch/csrc/fused_sorted_tick.cu",
        "gubernator_tpu/ops/tick32.py:357", err, ms, plain_ms[0], None,
        distinct * 256 + int(live.sum()) * (76 + 24)
        + int((~live).sum()) * (8 + 24),
        int(live.sum()) * FUSED_TICK_INT32_OPS_PER_LANE)
    e["lanes"] = lanes
    e["distinct_slots"] = distinct
    e["longest_segment"] = longest
    e["chain_lanes"] = CHAIN_LANES
    e["chain_ms"] = chain_ms
    e["longest_chain_ms"] = longest * chain_ms / CHAIN_LANES
    e["checked"] = [what for what, _ in cases]
    return e


def kernel_phase(torch, dev, lanes=32768, table_slots=1 << 21, rotate=16,
                 merged_heads=8192, against=None):
    """Each kernel against its plain version on the card, bit for bit, and
    their times.  Timed inputs rotate over ``rotate`` windows / slot sets
    of the 256 MB table: the ticks' windows touch more than twice the 50 MB
    L2 in rows and columns (``working_set_mb``), so their rows come from
    HBM as in the engine.  ``against`` (build_against) adds another
    checkout's tick kernels, timed in turns with these."""
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops import rowtable

    rng = np.random.default_rng(SEED)
    cap = table_slots
    out = {}
    out["fused_tick"], table, state = tick_entry(
        torch, dev, rng, lanes, table_slots, rotate, against)
    heads = [merged_window(E, rng, cap, merged_heads, state)
             for _ in range(rotate)]
    live = heads[0][2]
    srng = np.random.default_rng(SEED + 1)  # keeps rng's later draws
    singles = {kind: [merged_single(E, srng, mh, c, live, kind)
                      for mh, c, _ in heads]
               for kind in ("token", "leaky", "zoo")}

    def on_dev(ws):
        return [(torch.from_numpy(mh).to(dev), torch.from_numpy(c).to(dev))
                for mh, c in ws]

    out["fused_merged_tick"] = merged_entry(
        torch, table, on_dev([(mh, c) for mh, c, _ in heads]), live,
        {kind: on_dev(ws) for kind, ws in singles.items()}, against)
    scratch = table.clone()

    def slot_sets(n, guard_every=0):
        sets = []
        for _ in range(rotate):
            s = torch.from_numpy(
                rng.choice(cap, n, replace=False).astype(np.int64)).to(dev)
            if guard_every:
                s[::guard_every] = cap  # guard-row lanes: dropped
            sets.append(s)
        return sets

    def check_gather(sets):
        g_k = rowtable.gather_rows(table, sets[0])
        g_p = rowtable.gather_rows_plain(table, sets[0])
        torch.cuda.synchronize()
        assert torch.equal(g_k, g_p), "gather_rows differs from plain"
        n = sets[0].numel()
        return _entry(
            "gather_rows", "gubernator_tpu_torch/csrc/rows.cu",
            "gubernator_tpu/ops/rowtable.py:257", _max_abs(torch, g_k, g_p),
            time_ms(torch, [lambda s=s: rowtable.gather_rows(table, s)
                            for s in sets]),
            time_ms(torch, [lambda s=s: rowtable.gather_rows_plain(table, s)
                            for s in sets]),
            time_ms(torch, [lambda s=s: torch.index_select(table, 0, s)
                            for s in sets]),
            n * (8 + 256), 0)

    def check_scatter(sets, rows):
        s_k, s_p = table.clone(), table.clone()
        rowtable.scatter_rows(s_k, sets[0], rows)
        rowtable.scatter_rows_plain(s_p, sets[0], rows)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p), "scatter_rows differs from plain"
        err = _max_abs(torch, s_k, s_p)
        del s_k, s_p
        n_live = int((sets[0] < cap).sum())
        return _entry(
            "scatter_rows", "gubernator_tpu_torch/csrc/rows.cu",
            "gubernator_tpu/ops/rowtable.py:223", err,
            time_ms(torch, [lambda s=s: rowtable.scatter_rows(scratch, s, rows)
                            for s in sets]),
            time_ms(torch, [lambda s=s: rowtable.scatter_rows_plain(
                scratch, s, rows) for s in sets]),
            time_ms(torch, [lambda s=s: scratch.index_copy_(0, s, rows)
                            for s in sets]),
            sets[0].numel() * 8 + n_live * 256, 0)

    # Its own generator: the other kernels' windows stay those of
    # earlier runs.
    out["fused_sorted_tick"] = sorted_entry(
        torch, dev, np.random.default_rng(SEED + 2), state, lanes, rotate)
    out["fused_ragged_tick"] = ragged_entry(torch, dev, rng, lanes,
                                            table_slots, rotate, against)
    out["gather_rows"] = check_gather(slot_sets(lanes))
    rows = torch.from_numpy(
        rng.integers(-2**62, 2**62, (lanes, 16)).astype(np.int64)).to(dev)
    out["scatter_rows"] = check_scatter(slot_sets(lanes, guard_every=97), rows)

    # The shapes reclaim gives them: the dead-slot scan gathers ascending
    # candidate slots SCAN_CHUNK at a time, eviction scatters zero rows in
    # chunks of EVICT_CHUNK.
    scan = min(rowtable.SCAN_CHUNK, cap)
    main = {
        "gather_rows": check_gather(
            [torch.arange(scan, dtype=torch.int64, device=dev)]),
        "scatter_rows": check_scatter(
            slot_sets(E.EVICT_CHUNK),
            torch.zeros((E.EVICT_CHUNK, 16), dtype=torch.int64, device=dev)),
    }
    for name, e in main.items():
        out[name]["at_reclaim_shape"] = {
            "rows": scan if name == "gather_rows" else E.EVICT_CHUNK,
            **{k: e[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "max_abs_err")}}

    # The shapes the tiers give them (phase 5), on random distinct rows:
    # the demote readback of a sync round's victims (capacity // 16 of
    # the 10M-slot table) and of a background round's (twice the low
    # watermark), a window's promote scatter of tier hits (at most the
    # window) and the write-through gather of a 4096-wide window.
    # Their own generator: the draws above stay those of earlier runs.
    trng = np.random.default_rng(SEED + 3)

    def tier_sets(n):
        return [torch.from_numpy(trng.choice(cap, n, replace=False).astype(
            np.int64)).to(dev) for _ in range(rotate)]

    tiers = {
        "demote_readback_sync": ("gather_rows", 625_000),
        "demote_readback_bg": ("gather_rows", 312_500),
        "promote_scatter": ("scatter_rows", lanes),
        "write_through_gather": ("gather_rows", 4096),
    }
    for shape, (name, n) in tiers.items():
        if name == "gather_rows":
            e = check_gather(tier_sets(n))
        else:
            e = check_scatter(tier_sets(n), torch.from_numpy(trng.integers(
                -2**62, 2**62, (n, 16)).astype(np.int64)).to(dev))
        out[name].setdefault("at_tier_shapes", {})[shape] = {
            "rows": n, **{k: e[k] for k in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "max_abs_err")}}
    return out


@contextlib.contextmanager
def counted(torch, launches: dict, name: str, widths: dict):
    """Every kernel's launch count set to 0 just before the block and read
    into ``launches[name]`` just after; the tick kernels' launches by lane
    width (power-of-two buckets) into ``widths[name]``, ticks that did not
    launch left out."""
    import gubernator_tpu_torch as gt

    torch.cuda.synchronize()
    gt.reset_kernel_launches()
    yield
    torch.cuda.synchronize()
    launches[name] = gt.kernel_launches()
    widths[name] = {k: v for k, v in gt.kernel_launches_by_width().items()
                    if v}


def host_split(eng, wins, now) -> dict:
    """Host time a window of known keys spends in each step of
    ``_build_cols``, re-run outside the engine: the slot-map lookup, the
    REQ32 packing and the sort by slot (mean ms over ``wins``).  Lookups
    of mapped keys change nothing in the map."""
    from gubernator_tpu_torch.ops import engine as E

    t = {"slot_resolve": 0.0, "pack": 0.0, "sort": 0.0}
    for cols in wins:
        t0 = time.perf_counter()
        slots, known = eng.slots.resolve_blob(cols.key_blob, cols.key_offsets)
        t1 = time.perf_counter()
        m = np.zeros((E.REQ32_ROWS, len(cols)), np.int32)
        E.pack_cols_req32(m, cols, slots, known, now, slice(0, len(cols)))
        t2 = time.perf_counter()
        E.sort_packed_by_slot(m, len(cols), eng.capacity)
        t3 = time.perf_counter()
        assert (known == 1).all()
        t["slot_resolve"] += t1 - t0
        t["pack"] += t2 - t1
        t["sort"] += t3 - t2
    return {k: v / len(wins) * 1e3 for k, v in t.items()}


def herd_columns(reqcols, prefix: bytes, ids, reset=None,
                 token_prefill=False):
    """A herd window over keys ``prefix + id``: every request for one key
    is the same request, server-stamped (``created_at`` unset), as the
    clients of one limit send it.  With ``token_prefill`` every key sends
    the prefill's request (one token hit on a one-hour bucket of 100);
    otherwise the key's id picks its parameters (token or leaky, hits,
    limit, duration, DRAIN_OVER_LIMIT, burst).  Rows flagged in ``reset``
    carry RESET_REMAINING instead, which breaks their key's run of
    identical requests into units (the layered plan's shape)."""
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    blob, offsets = key_blob(prefix, ids)
    one = np.ones(n, np.int64)
    if token_prefill:
        hits, limit, duration = one, one * 100, one * 3_600_000
        algorithm, behavior, burst = one * 0, one * 0, one * 0
    else:
        hits = 1 + ids % 3
        limit = np.array([10, 100, 1000, 7])[ids % 4]
        duration = np.array([60_000, 30_000, 3_600_000])[ids % 3]
        algorithm = ids % 2
        behavior = np.where(ids % 5 == 0, 32, 0)   # DRAIN_OVER_LIMIT
        burst = np.array([0, 5])[(ids // 2) % 2]
    if reset is not None:
        behavior = np.where(reset, 8, behavior)   # RESET_REMAINING
    return reqcols.ReqColumns(blob, offsets, hits, limit, duration, algorithm,
                              behavior, -one, burst)


def reset_flags(rng, ids, hot: int, most: int = 3) -> np.ndarray:
    """RESET_REMAINING on 1 to ``most`` random requests of each of the
    ``hot`` most requested keys of a window."""
    ids = np.asarray(ids)
    order = np.argsort(ids, kind="stable")
    keys, first, counts = np.unique(ids[order], return_index=True,
                                    return_counts=True)
    flag = np.zeros(len(ids), bool)
    for k in np.argsort(-counts, kind="stable")[:hot]:
        pos = order[first[k]:first[k] + counts[k]]
        flag[rng.choice(pos, min(int(rng.integers(1, most + 1)), len(pos)),
                        replace=False)] = True
    return flag


def token_reference(ids, reset, now: int, expire0: int, limit=100,
                    duration=3_600_000) -> np.ndarray:
    """Expected (status, remaining, reset_time) of one-hit token requests
    on keys that hold the prefill's bucket (remaining limit - 1, expiring
    at ``expire0``), applied one after another in arrival order: the
    reference's token bucket (decrement, exact remainder, at-zero OVER
    persisted; RESET_REMAINING removes a live bucket and answers the full
    limit; a request on a removed bucket creates a new one)."""
    out = np.empty((3, len(ids)), np.int64)
    held = {}
    reset = np.zeros(len(ids), bool) if reset is None else reset
    for j, (k, r) in enumerate(zip(np.asarray(ids).tolist(), reset.tolist())):
        b = held.setdefault(k, [True, limit - 1, 0, expire0])
        alive, rem, status, expire = b
        if alive and r:
            out[:, j] = (0, limit, 0)
            b[:] = [False, 0, 0, 0]
        elif not alive:
            out[:, j] = (0, limit - 1, now + duration)
            b[:] = [True, limit - 1, 0, now + duration]
        elif rem == 0:
            out[:, j] = (1, 0, expire)
            b[2] = 1
        else:
            out[:, j] = (status, rem - 1, expire)
            b[1] = rem - 1
    return out


def engine_phase(torch, dev, capacity=10_000_000, width=32768, windows=32,
                 ref_capacity=1 << 20, compare_zipf=8192, fused_ms=None):
    """The engine at full size.  Each path (the windows held against the
    CPU engine, the prefill, the unique windows, the herd, layered,
    fallback and reclaim windows) runs with every kernel's launch count
    set to 0 just before it and read just after.  Returns ``(info,
    launches by path)``."""
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.ops.engine import TickEngine, resolve_ticks

    rng = np.random.default_rng(SEED + 1)
    # Background reclaim off (its default is on at these sizes): the
    # reclaim window below then reclaims in the window, as the CPU
    # engine it is compared with does.
    eng = TickEngine(capacity=capacity, max_batch=width, device=dev,
                     bg_reclaim=False)
    ref = TickEngine(capacity=ref_capacity, max_batch=width, device="cpu",
                     bg_reclaim=False)
    info = {}
    launches = {}
    now = NOW

    widths = {}

    def counted_path(name):
        return counted(torch, launches, name, widths)

    def routes(e):
        return (e.metric_grouped_ticks, e.metric_layered_ticks,
                e.metric_sorted_ticks)

    # Windows held against the CPU engine: same keys, same now, same
    # answers (slot numbers differ, state per key does not), and the same
    # route on both: the random Zipf window neither plan takes goes to the
    # chained tick (B.5 on the card, its plain version's rank rounds on
    # the CPU), the herd takes the grouped plan, the herd with RESET rows
    # the layered.
    n_c = width
    herd_ids = (rng.zipf(1.2, compare_zipf) - 1) % (4 * n_c)
    lay_ids = (rng.zipf(1.2, compare_zipf) - 1) % (4 * n_c)
    compare = [
        ("unique", window_columns(reqcols, rng, b"c", np.arange(n_c), now),
         (0, 0, 0)),
        ("zipf", window_columns(
            reqcols, rng, b"c", (rng.zipf(1.2, compare_zipf) - 1) % (4 * n_c),
            now), (0, 0, 1)),
        ("revisit", window_columns(reqcols, rng, b"c", rng.permutation(n_c),
                                   now), (0, 0, 0)),
        ("herd", herd_columns(reqcols, b"h", herd_ids), (1, 0, 0)),
        ("layered", herd_columns(reqcols, b"l", lay_ids,
                                 reset=reset_flags(rng, lay_ids, hot=64)),
         (0, 1, 0)),
    ]
    with counted_path("compare"):
        for name, cols, route in compare:
            now += 1_000
            before = [routes(eng), routes(ref)]
            r0 = ref.metric_rank_rounds
            got, gerr = eng.process_columns(cols, now)
            want, werr = ref.process_columns(cols, now)
            assert gerr == werr, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            for e, b in zip((eng, ref), before):
                d = tuple(x - y for x, y in zip(routes(e), b))
                assert d == route, (name, d)
            assert (ref.metric_rank_rounds > r0) == (route[2] == 1), name
    assert eng.metric_rank_rounds == 0
    info["compared_windows"] = [name for name, _, _ in compare]
    info["per_item_errors"] = len(gerr)

    # Prefill the table to capacity with one-hour token buckets.
    t0 = time.perf_counter()
    base = len(eng.slots)
    todo = capacity - base
    chunk = 32 * width
    prefill_now = now
    with counted_path("prefill"):
        for s in range(0, todo, chunk):
            ids = np.arange(s, min(s + chunk, todo))
            mat, errs = eng.process_columns(
                window_columns(reqcols, rng, b"p", ids, now, prefill=True),
                now)
            assert not errs and (mat[2] == 99).all()
    assert len(eng.slots) == capacity
    info["prefill_s"] = time.perf_counter() - t0
    info["prefill_decisions_per_s"] = todo / info["prefill_s"]

    # Pipelined unique windows over the prefilled keys: submit four, then
    # resolve them with one device-to-host copy.  Host time is split into
    # submitting (slot resolve, pack, sort, upload, launch) and resolving
    # (waiting for the card, the copy back, unpacking).
    uids = [rng.choice(todo, width, replace=False) for _ in range(windows)]
    wins = [window_columns(reqcols, rng, b"p", ids, now + 2_000)
            for ids in uids]
    submit_s = resolve_s = 0.0
    pending, done = [], []
    with counted_path("unique"):
        t0 = time.perf_counter()
        for cols in wins:
            t1 = time.perf_counter()
            pending.append(eng.submit_columns(cols, now + 2_000))
            t2 = time.perf_counter()
            submit_s += t2 - t1
            if len(pending) == 4:
                resolve_ticks(pending)
                resolve_s += time.perf_counter() - t2
                done += pending
                pending = []
        t2 = time.perf_counter()
        resolve_ticks(pending)
        resolve_s += time.perf_counter() - t2
        done += pending
        dt = time.perf_counter() - t0
    assert launches["unique"]["fused_tick"] == windows
    info["unique_windows"] = windows
    info["decisions_per_s"] = windows * width / dt
    info["window_ms"] = dt / windows * 1e3
    info["submit_ms_per_window"] = submit_s / windows * 1e3
    info["resolve_ms_per_window"] = resolve_s / windows * 1e3
    if fused_ms is not None:
        # The fused tick's phase-2 device time at this width over the
        # host's time per window: the card's busy share, estimated.
        info["fused_tick_busy_share_est"] = fused_ms / info["window_ms"]
    for h in done:
        mat, _ = h.result()
        assert mat.shape == (5, width) and np.isin(mat[4], (0, 1)).all()
    info["host_split_ms"] = host_split(eng, wins[:4], now + 2_000)

    # Herd and layered windows over prefilled keys the unique windows left
    # alone (two disjoint pools), whose answers the token_reference model
    # gives exactly.
    free = np.setdiff1d(np.arange(todo), np.concatenate(uids))
    pools = {"herd": free[0::2], "layered": free[1::2]}

    def dup_window(name, route, t):
        ids = pools[name][(rng.zipf(1.2, width) - 1) % len(pools[name])]
        reset = (reset_flags(rng, ids, hot=256) if name == "layered"
                 else None)
        cols = herd_columns(reqcols, b"p", ids, reset=reset,
                            token_prefill=True)
        before = routes(eng)
        with counted_path(name):
            t0 = time.perf_counter()
            mat, errs = eng.process_columns(cols, t)
            info[f"{name}_window_s"] = time.perf_counter() - t0
        assert not errs
        assert tuple(x - y for x, y in zip(routes(eng), before)) == route
        want = token_reference(ids, reset, t, prefill_now + 3_600_000)
        np.testing.assert_array_equal(mat[[0, 2, 3]], want, err_msg=name)
        info[f"{name}_unique_keys"] = int(len(np.unique(ids)))
        b3 = launches[name]["fused_merged_tick"]
        assert launches[name]["fused_tick"] == 0 and b3 >= 1
        return b3

    # One 32768-wide Zipf(1.2) herd: the grouped plan, one merged launch.
    info["herd_b3_launches"] = dup_window("herd", (1, 0, 0), now + 3_000)
    # The same shape with RESET rows on the 256 hottest keys: the layered
    # plan, one merged launch per unit layer.
    info["layered_layers"] = dup_window("layered", (0, 1, 0), now + 3_500)

    # A Zipf(1.2) window of random requests (per-request parameters, so
    # neither plan takes it): the chained tick, one B.5 launch.
    g0, l0, c0 = routes(eng)
    ids = (rng.zipf(1.2, width) - 1) % todo
    zipf = window_columns(reqcols, rng, b"p", ids, now + 4_000)
    with counted_path("fallback"):
        t0 = time.perf_counter()
        mat, _ = eng.process_columns(zipf, now + 4_000)
        info["fallback_window_s"] = time.perf_counter() - t0
    assert mat.shape == (5, width)
    info["fallback_unique_keys"] = int(len(np.unique(ids)))
    info["fallback_longest_segment"] = int(np.bincount(ids).max())
    info["fallback_b5_launches"] = launches["fallback"]["fused_sorted_tick"]
    assert routes(eng) == (g0, l0, c0 + 1) and eng.metric_rank_rounds == 0
    assert info["fallback_b5_launches"] == 1
    assert launches["fallback"]["fused_tick"] == 0

    # Fresh keys against the full table: reclaim evicts LRU victims.
    fresh = window_columns(reqcols, rng, b"f", np.arange(width), now + 5_000)
    with counted_path("reclaim"):
        t0 = time.perf_counter()
        got, gerr = eng.process_columns(fresh, now + 5_000)
        info["reclaim_window_s"] = time.perf_counter() - t0
    want, werr = ref.process_columns(fresh, now + 5_000)
    assert gerr == werr
    np.testing.assert_array_equal(got, want, err_msg="fresh")
    info["evictions"] = eng.metric_unexpired_evictions
    assert eng.metric_unexpired_evictions > 0
    assert launches["reclaim"]["gather_rows"] > 0
    assert launches["reclaim"]["scatter_rows"] > 0

    # The full table's state out and back: export its live rows, load them
    # into a fresh engine and export that; the second export must equal
    # the rows of the first that had not expired by the load.
    info.update(state_round_trip(torch, dev, eng, capacity, width,
                                 now + 5_000, launches, widths))
    info["launches_by_path"] = launches
    info["launches_by_width"] = widths
    total = {k: sum(p[k] for p in launches.values())
             for k in launches["unique"]}
    assert total["fused_ragged_tick"] == 0
    return info, total


@contextlib.contextmanager
def device_timed(torch, module, names, out: dict):
    """``module``'s functions ``names`` wrapped for the block: each call is
    bracketed by two CUDA events on the current stream (no
    synchronisation), and after the block ``out[name]`` holds the summed
    ms between them.  An event pair spans the wrapper's own launch and
    any idle gap before its kernel starts, so the sum bounds the kernels'
    device time from above.  A wrapper counts its launches on the module
    attribute it calls itself by, so each shim carries the original's
    attributes and hands them back when the block ends.  Nest it inside
    ``counted``: the counts are read after the originals are back."""
    orig = {n: getattr(module, n) for n in names}
    marks = {n: [] for n in names}

    def shim(n):
        @functools.wraps(orig[n])
        def call(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            r = orig[n](*args, **kw)
            b.record()
            marks[n].append((a, b))
            return r
        return call

    for n in names:
        setattr(module, n, shim(n))
    try:
        yield
    finally:
        for n in names:
            for attr in vars(orig[n]):
                setattr(orig[n], attr, getattr(getattr(module, n), attr))
            setattr(module, n, orig[n])
    torch.cuda.synchronize()
    for n in names:
        out[n] = sum(a.elapsed_time(b) for a, b in marks[n])


def check_export_sample(torch, eng, snap, rng, k: int = 4096) -> None:
    """``k`` random items of ``eng``'s export held against the engine's
    table decoded apart from the export's codec: each key's slot from a
    slot-map lookup, its row from the table by plain indexing, decoded by
    ``rowtable.host_columns``, and its lease columns read directly."""
    from gubernator_tpu_torch.ops.reqcols import compact_blob
    from gubernator_tpu_torch.ops.rowtable import host_columns
    from gubernator_tpu_torch.ops.snapshot import (
        ITEM_FIELDS, LEASE_SNAP_FIELDS)

    n = len(snap["key_offsets"]) - 1
    pick = np.zeros(n, bool)
    pick[rng.choice(n, min(k, n), replace=False)] = True
    blob, offsets = compact_blob(snap["key_blob"], snap["key_offsets"], pick)
    slots = eng.slots.lookup_blob(blob, offsets)
    assert (slots >= 0).all(), "an exported key is not mapped"
    idx = torch.from_numpy(slots).to(eng.table.device)
    rows = eng.table[idx]
    cols = host_columns(torch.cat([rows, torch.zeros_like(rows[:1])]))
    assert cols["in_use"].all()
    for f in ITEM_FIELDS:
        want = cols[f].view(np.int64) if f == "remaining_f" else cols[f]
        got = (snap[f][pick].view(np.int64) if f == "remaining_f"
               else snap[f][pick])
        np.testing.assert_array_equal(got, want, err_msg=f)
    lease = [eng._lease_budget, eng._lease_expire, eng._lease_gen]
    for f, col in zip(LEASE_SNAP_FIELDS, lease):
        np.testing.assert_array_equal(
            snap[f][pick], col[idx].long().cpu().numpy(), err_msg=f)


def state_round_trip(torch, dev, eng, capacity: int, width: int, now: int,
                     launches: dict, widths: dict) -> dict:
    """``eng``'s live state exported, loaded into a fresh engine of the
    same size at ``now`` and exported again (the ``state`` path's
    launches): the seconds and bytes of each step, the row kernels'
    device ms in each (``device_timed``), a sample of the first export
    held against the table (``check_export_sample``), and the check that
    the second export holds exactly the first's rows that had not
    expired."""
    from gubernator_tpu_torch.ops import rowtable
    from gubernator_tpu_torch.ops.engine import TickEngine
    from gubernator_tpu_torch.ops.reqcols import compact_blob

    out = {}
    kernels = ("gather_rows", "scatter_rows")
    with counted(torch, launches, "state", widths):
        ex, ld = {}, {}
        with device_timed(torch, rowtable, kernels, ex):
            t0 = time.perf_counter()
            snap = eng.export_columns()
            out["state_export_s"] = time.perf_counter() - t0
        out["state_export"] = dict(eng.last_export_stats)
        twin = TickEngine(capacity=capacity, max_batch=width, device=dev,
                          bg_reclaim=False)
        with device_timed(torch, rowtable, kernels, ld):
            t0 = time.perf_counter()
            twin.load_columns(snap, now)
            torch.cuda.synchronize()
            out["state_load_s"] = time.perf_counter() - t0
        out["state_load"] = dict(twin.last_load_stats)
        out["state_export_row_kernels_ms_at_most"] = ex
        out["state_load_row_kernels_ms_at_most"] = ld
        back = twin.export_columns()
    check_export_sample(torch, eng, snap, np.random.default_rng(SEED))
    keep = snap["expire_at"] >= now
    out["state_loaded_items"] = int(keep.sum())
    assert out["state_load"]["rows"] == keep.sum()
    assert keep.sum() > capacity // 2, "most rows must outlive the load"
    blob, offsets = compact_blob(snap["key_blob"], snap["key_offsets"], keep)
    assert bytes(back["key_blob"]) == bytes(blob)
    np.testing.assert_array_equal(back["key_offsets"], offsets)
    for f, col in snap.items():
        if f not in ("key_blob", "key_offsets"):
            np.testing.assert_array_equal(back[f], col[keep], err_msg=f)
    assert launches["state"]["gather_rows"] > 0
    assert launches["state"]["scatter_rows"] > 0
    return out


def mesh_host_split(eng, wins, now) -> dict:
    """Host time a window of known keys spends in each step of the mesh
    engine's submit, re-run outside the engine: CRC-32 routing, the
    per-shard slot-map resolve (blob regroup and one native call a shard),
    REQ32 packing with global slots, and the sort by slot (mean ms over
    ``wins``).  Lookups of mapped keys change nothing in the maps."""
    from gubernator_tpu_torch.native import crc32_batch
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops.reqcols import compact_blob

    t = {"crc32_route": 0.0, "shard_resolve": 0.0, "pack": 0.0, "sort": 0.0}
    for cols in wins:
        n = len(cols)
        t0 = time.perf_counter()
        sh = (crc32_batch(cols.key_blob, cols.key_offsets)
              % np.uint32(eng.n_shards)).astype(np.int64)
        t1 = time.perf_counter()
        order = np.argsort(sh, kind="stable")
        starts = np.searchsorted(sh[order], np.arange(eng.n_shards + 1))
        blob, off = compact_blob(cols.key_blob, cols.key_offsets, order)
        slots = np.empty(n, np.int64)
        for s in range(eng.n_shards):
            a, z = starts[s], starts[s + 1]
            sl, kn = eng.slots[s].resolve_blob(blob[off[a]:off[z]],
                                               off[a:z + 1] - off[a])
            assert (kn == 1).all()
            slots[order[a:z]] = sl
        t2 = time.perf_counter()
        m = np.zeros((E.REQ32_ROWS, n), np.int32)
        E.pack_cols_req32(m, cols, sh * eng.local_capacity + slots,
                          np.ones(n, np.uint8), now, slice(0, n))
        t3 = time.perf_counter()
        E.sort_packed_by_slot(m, n, eng.capacity)
        t4 = time.perf_counter()
        for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            t[k] += dt
    return {k: v / len(wins) * 1e3 for k, v in t.items()}


def mesh_phase(torch, dev, n_shards=8, local_capacity=1_250_000,
               width=32768, windows=32, ref_local_capacity=1 << 17,
               compare_zipf=8192):
    """The sharded engine at full size (module doc, phase 4).  Each path
    runs with every kernel's launch count set to 0 just before it and read
    just after.  Returns ``(info, launches summed over the paths)``."""
    from gubernator_tpu_torch.native import crc32_batch
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.ops.engine import resolve_ticks
    from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine

    rng = np.random.default_rng(SEED + 2)
    eng = MeshTickEngine(n_shards, local_capacity, max_batch=width,
                         device=dev)
    ref = MeshTickEngine(n_shards, ref_local_capacity, max_batch=width,
                         device="cpu")
    info = {"n_shards": n_shards, "local_capacity": local_capacity,
            "table_bytes": eng.table.numel() * 8}
    launches, widths = {}, {}
    now = NOW

    def counted_path(name):
        return counted(torch, launches, name, widths)

    def shard_of(prefix, ids):
        blob, off = key_blob(prefix, ids)
        return (crc32_batch(blob, off) % np.uint32(n_shards)).astype(np.int64)

    def only_ragged(name, count=1):
        got = launches[name]
        assert got["fused_ragged_tick"] == sum(got.values()) == count, (
            name, got)

    # Windows held against the CPU mesh engine: same keys, same now, same
    # answers; the shards' slot maps assign the same local slots, so the
    # rows they hold must be equal too.
    cand = np.arange(16 * width)
    skew_ids = cand[shard_of(b"k", cand) == 0][:width]
    compare = [
        ("unique", window_columns(reqcols, rng, b"c", np.arange(width), now)),
        ("zipf", window_columns(reqcols, rng, b"c", (rng.zipf(
            1.2, compare_zipf) - 1) % (4 * width), now)),
        ("herd", herd_columns(reqcols, b"h", (rng.zipf(
            1.2, compare_zipf) - 1) % (4 * width))),
        ("revisit", window_columns(reqcols, rng, b"c",
                                   rng.permutation(width), now)),
        ("skewed", window_columns(reqcols, rng, b"k", skew_ids, now)),
    ]
    for name, cols in compare:
        now += 1_000
        r0 = (eng.metric_rank_rounds, ref.metric_rank_rounds)
        with counted_path("compare_" + name):
            got, gerr = eng.process_columns(cols, now)
        want, werr = ref.process_columns(cols, now)
        assert gerr == werr, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert (eng.metric_rank_rounds - r0[0]
                == ref.metric_rank_rounds - r0[1]), name
        if name in ("unique", "revisit", "skewed"):
            only_ragged("compare_" + name)
    L_ref = ref_local_capacity
    for s in range(n_shards):
        mapped = ref.slots[s].mapped_mask()
        assert (eng.slots[s].mapped_mask()[:L_ref] == mapped).all()
        assert len(eng.slots[s]) == len(ref.slots[s])
        rows = np.flatnonzero(mapped)
        got = eng.table[torch.from_numpy(
            s * (local_capacity + 1) + rows).to(dev)].cpu()
        assert torch.equal(got, ref.table[s * (L_ref + 1) + rows]), s
    info["compared_windows"] = [name for name, _ in compare]
    info["compare_rank_rounds"] = eng.metric_rank_rounds
    del ref

    # Prefill every shard to capacity with one-hour token buckets: keys
    # picked by their route, so each shard gets exactly what it has left.
    need = [local_capacity - len(sm) for sm in eng.slots]
    cand = np.arange(int(sum(need) * 1.05) + 4096)
    sh = shard_of(b"p", cand)
    ids = np.sort(np.concatenate(
        [cand[sh == s][:need[s]] for s in range(n_shards)]))
    assert len(ids) == sum(need)
    t0 = time.perf_counter()
    chunk = 32 * width
    prefill_now = now
    with counted_path("prefill"):
        for a in range(0, len(ids), chunk):
            mat, errs = eng.process_columns(window_columns(
                reqcols, rng, b"p", ids[a:a + chunk], now, prefill=True), now)
            assert not errs and (mat[2] == 99).all()
    assert eng.cache_size() == eng.capacity
    info["prefill_s"] = time.perf_counter() - t0
    info["prefill_keys"] = int(len(ids))
    info["prefill_decisions_per_s"] = len(ids) / info["prefill_s"]
    assert eng.metric_unexpired_evictions == 0

    # Pipelined unique windows over the prefilled keys (submit four, then
    # resolve them with one device-to-host copy): one ragged launch each.
    pick = rng.permutation(len(ids))
    uids = [ids[pick[k * width:(k + 1) * width]] for k in range(windows)]
    wins = [window_columns(reqcols, rng, b"p", u, now + 2_000) for u in uids]
    submit_s = resolve_s = 0.0
    pending, done = [], []
    with counted_path("unique"):
        t0 = time.perf_counter()
        for cols in wins:
            t1 = time.perf_counter()
            pending.append(eng.submit_columns(cols, now + 2_000))
            t2 = time.perf_counter()
            submit_s += t2 - t1
            if len(pending) == 4:
                resolve_ticks(pending)
                resolve_s += time.perf_counter() - t2
                done += pending
                pending = []
        t2 = time.perf_counter()
        resolve_ticks(pending)
        resolve_s += time.perf_counter() - t2
        done += pending
        dt = time.perf_counter() - t0
    only_ragged("unique", windows)
    info["unique_windows"] = windows
    info["decisions_per_s"] = windows * width / dt
    info["window_ms"] = dt / windows * 1e3
    info["submit_ms_per_window"] = submit_s / windows * 1e3
    info["resolve_ms_per_window"] = resolve_s / windows * 1e3
    for h in done:
        mat, _ = h.result()
        assert mat.shape == (5, width) and np.isin(mat[4], (0, 1)).all()
    info["host_split_ms"] = mesh_host_split(eng, wins[:4], now + 2_000)
    info["h2d_overlap_ratio"] = eng.h2d_overlap_ratio()

    # A Zipf(1.2) herd of the prefill's token requests over keys the unique
    # windows left alone: the merge tick per tile of each shard's extent.
    rest = ids[pick[windows * width:]]
    hids = rest[(rng.zipf(1.2, width) - 1) % len(rest)]
    r0 = eng.metric_rank_rounds
    with counted_path("herd"):
        t0 = time.perf_counter()
        mat, errs = eng.process_columns(herd_columns(
            reqcols, b"p", hids, token_prefill=True), now + 3_000)
        info["herd_window_s"] = time.perf_counter() - t0
    assert not errs
    want = token_reference(hids, None, now + 3_000, prefill_now + 3_600_000)
    np.testing.assert_array_equal(mat[[0, 2, 3]], want, err_msg="mesh herd")
    info["herd_unique_keys"] = int(len(np.unique(hids)))
    info["herd_rank_rounds"] = eng.metric_rank_rounds - r0
    got = launches["herd"]
    assert got["fused_ragged_tick"] == 0 and got["fused_tick"] >= 1
    assert got["gather_rows"] >= 1 and got["scatter_rows"] >= 1

    # Every key of one window on shard 0: one extent covers the batch.
    shard0 = ids[shard_of(b"p", ids) == 0]
    sk = rng.choice(shard0, width, replace=False)
    with counted_path("skewed"):
        t0 = time.perf_counter()
        mat, _ = eng.process_columns(window_columns(
            reqcols, rng, b"p", sk, now + 4_000), now + 4_000)
        info["skewed_window_s"] = time.perf_counter() - t0
    assert mat.shape == (5, width)
    only_ragged("skewed")

    # Fresh keys against full shards: each shard reclaims.
    with counted_path("reclaim"):
        t0 = time.perf_counter()
        mat, errs = eng.process_columns(window_columns(
            reqcols, rng, b"f", np.arange(width), now + 5_000), now + 5_000)
        info["reclaim_window_s"] = time.perf_counter() - t0
    assert mat.shape == (5, width)
    info["reclaim_errors"] = len(errs)
    info["evictions"] = eng.metric_unexpired_evictions
    assert eng.metric_unexpired_evictions > 0
    got = launches["reclaim"]
    assert got["gather_rows"] > 0 and got["scatter_rows"] > 0
    assert got["fused_ragged_tick"] == 1
    info["launches_by_path"] = launches
    info["launches_by_width"] = widths
    total = {k: sum(p[k] for p in launches.values())
             for k in launches["unique"]}
    return info, total


# ----------------------------------------------------------------------
# Phase 5: the Store, the cold and SSD tiers, background reclaim and the
# persistence package
# ----------------------------------------------------------------------
PROBES = 8
PROBE_LIMIT = 1_000_000
PROBE_HITS = 7
TOKEN_LIMIT = 100


def token_columns(reqcols, prefix: bytes, ids, hits: int = 1,
                  limit: int = TOKEN_LIMIT, duration: int = 3_600_000):
    """A window of token-bucket requests over keys ``prefix + id``; the
    server stamps ``created_at``."""
    n = len(ids)
    blob, offsets = key_blob(prefix, ids)
    full = [np.full(n, v, np.int64) for v in
            (hits, limit, duration, 0, 0, reqcols.CREATED_UNSET, 0)]
    return reqcols.ReqColumns(blob, offsets, *full)


def request_objects(types, cols):
    """``cols`` as request objects (the Store hooks take them)."""
    blob = bytes(cols.key_blob)
    off = cols.key_offsets
    out = []
    for j in range(len(cols)):
        name, _, uk = blob[off[j]:off[j + 1]].decode().partition("_")
        ca = int(cols.created_at[j])
        out.append(types.RateLimitRequest(
            name=name, unique_key=uk, hits=int(cols.hits[j]),
            limit=int(cols.limit[j]), duration=int(cols.duration[j]),
            algorithm=int(cols.algorithm[j]), behavior=int(cols.behavior[j]),
            burst=int(cols.burst[j]), created_at=None if ca < 0 else ca))
    return out


# Counts of SsdStore.stats() that do not depend on when its writer thread
# ran (bytes and slabs do, through compaction).
SSD_COUNTS = ("size", "demotions", "promotions", "hits", "misses", "expired",
              "lookup_calls")


def tier_compare(torch, dev, root: str, capacity=1 << 14, width=4096,
                 cold_capacity=1 << 13, windows=16, keys=1 << 16) -> dict:
    """The tiered engine on ``dev`` against the same engine on the CPU, bit
    for bit: each with a MockStore and an SsdStore of its own, background
    reclaim off, ``windows`` windows of uniform draws over ``keys`` keys
    (every algorithm and flag, most buckets an hour long).  Every (5, n)
    response, the final
    ``export_columns()``, ``cold_size()``, the cold and SSD tiers' counts
    and the Store's contents must be equal."""
    from gubernator_tpu_torch import types
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.ops.engine import TickEngine
    from gubernator_tpu_torch.store import MockStore
    from gubernator_tpu_torch.tiering import SsdStore

    rng = np.random.default_rng(SEED + 5)
    engs, stores = [], []
    for tag, d in (("dev", dev), ("cpu", "cpu")):
        st = MockStore()
        engs.append(TickEngine(
            capacity=capacity, max_batch=width, device=d, store=st,
            cold_capacity=cold_capacity, bg_reclaim=False,
            ssd=SsdStore(os.path.join(root, f"ssd_{tag}"))))
        stores.append(st)
    now = NOW
    errors = 0
    try:
        for _ in range(windows):
            now += 1_000
            cols = window_columns(reqcols, rng, b"t_",
                                  rng.integers(0, keys, width), now)
            # Most buckets live an hour, so the table's victims are live
            # and demote (Gregorian lanes keep their selectors).
            long = (rng.random(width) < 0.75) & ((cols.behavior & 4) == 0)
            cols.duration[long] = 3_600_000
            batch = reqcols.ReqColumns.from_requests(
                request_objects(types, cols), keep_refs=True)
            (got, gerr), (want, werr) = (e.process_columns(batch, now)
                                         for e in engs)
            assert gerr == werr
            np.testing.assert_array_equal(got, want, err_msg="tiers")
            errors += len(gerr)
        for e in engs:
            e.ssd.flush()
        a, b = engs
        assert a.cold_size() == b.cold_size() > 0
        assert a.cold.stats() == b.cold.stats()
        sa, sb = a.ssd.stats(), b.ssd.stats()
        assert {k: sa[k] for k in SSD_COUNTS} == {k: sb[k] for k in SSD_COUNTS}
        assert stores[0].data == stores[1].data
        assert stores[0].called == stores[1].called
        ea, eb = a.export_columns(), b.export_columns()
        assert ea.keys() == eb.keys()
        assert bytes(ea["key_blob"]) == bytes(eb["key_blob"])
        for f in ea:
            if f != "key_blob":
                np.testing.assert_array_equal(ea[f], eb[f], err_msg=f)
        metrics = ("metric_cold_hits", "metric_ssd_hits",
                   "metric_promote_dispatches", "metric_promote_ticks",
                   "metric_demote_readbacks", "metric_unexpired_evictions")
        for m in metrics:
            assert getattr(a, m) == getattr(b, m), m
        assert a.metric_ssd_tick_path_reads == 0
        return {"windows": windows, "width": width, "keys": keys,
                "per_item_errors": errors, "cold_size": a.cold_size(),
                "ssd_size": sa["size"], "store_items": len(stores[0].data),
                "exported_items": len(ea["key_offsets"]) - 1,
                **{m[len("metric_"):]: getattr(a, m) for m in metrics}}
    finally:
        for e in engs:
            e.close()


def bg_continuity(torch, dev, capacity=1 << 16, width=4096,
                  working_set=3 << 16, windows=200) -> dict:
    """Background reclaim under load: ``windows`` windows of distinct
    keys drawn from a working set three times the table, each request one
    token hit, served while the reclaimer demotes into a cold tier large
    enough for the whole set.  Every answer must be the key's exact count
    (``continuity_errors`` counts those that are not): a key whose row
    was zeroed before its readback, or two keys on one slot, would
    answer otherwise."""
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.ops.engine import TickEngine

    rng = np.random.default_rng(SEED + 6)
    eng = TickEngine(capacity=capacity, max_batch=width, device=dev,
                     bg_reclaim=True, cold_capacity=2 * working_set)
    count = np.zeros(working_set, np.int64)
    errors = shed = 0
    now = NOW
    try:
        for k in range(windows):
            ids = rng.choice(working_set, width, replace=False)
            count[ids] += 1
            mat, errs = eng.process_columns(
                token_columns(reqcols, b"b", ids, limit=10**9), now + k)
            shed += len(errs)
            errors += int((mat[2] != 10**9 - count[ids]).sum())
    finally:
        eng.close()
    return {"windows": windows, "width": width, "capacity": capacity,
            "working_set": working_set, "continuity_errors": errors,
            "shed": shed, "bg_rounds": eng.metric_bg_reclaims,
            "sync_reclaims": eng.metric_sync_reclaims,
            "evictions": eng.metric_unexpired_evictions,
            "cold_hits": eng.metric_cold_hits}


@contextlib.contextmanager
def host_timed(owner, names, out: dict):
    """``owner``'s callables ``names`` (module functions or an object's
    methods) wrapped for the block; ``out[name]`` collects each call's
    host seconds."""
    orig = {n: getattr(owner, n) for n in names}
    # An object's own attributes are the shims; a module's are replaced.
    own = not isinstance(owner, type(sys))
    for n in names:
        out[n] = []

        def call(*args, _n=n, **kw):
            t0 = time.perf_counter()
            try:
                return orig[_n](*args, **kw)
            finally:
                out[_n].append(time.perf_counter() - t0)
        setattr(owner, n, call)
    try:
        yield
    finally:
        for n in names:
            if own:
                delattr(owner, n)
            else:
                setattr(owner, n, orig[n])


class TimedSlots:
    """A slot map whose ``resolve_blob`` calls are timed into ``out``."""

    def __init__(self, inner, out: list):
        self._inner = inner
        self._out = out

    def __len__(self):
        return len(self._inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def resolve_blob(self, *args):
        t0 = time.perf_counter()
        try:
            return self._inner.resolve_blob(*args)
        finally:
            self._out.append(time.perf_counter() - t0)


def items_of(torch, eng, blob, offsets) -> dict:
    """The state of keys (blob, offsets) in ``eng``, hot or cold, read
    apart from the export's codec: a hot key's row by plain indexing of
    the table, decoded by ``rowtable.host_columns``; a cold key's columns
    straight from the cold tier."""
    from gubernator_tpu_torch.ops.rowtable import host_columns
    from gubernator_tpu_torch.ops.snapshot import ITEM_FIELDS

    slots = eng.slots.lookup_blob(blob, offsets)
    out = {}
    hot = np.flatnonzero(slots >= 0)
    rows = eng.table[torch.from_numpy(slots[hot]).to(eng.table.device)]
    cols = host_columns(torch.cat([rows, torch.zeros_like(rows[:1])]))
    for j, i in enumerate(hot):
        key = bytes(blob[offsets[i]:offsets[i + 1]])
        assert cols["in_use"][j]
        out[key] = tuple(cols[f][j].item() for f in ITEM_FIELDS)
    cold = eng.cold
    with cold._lock:
        for i in np.flatnonzero(slots < 0):
            key = bytes(blob[offsets[i]:offsets[i + 1]])
            c = cold._map[key]
            out[key] = tuple(cold._cols[f][c].item() for f in ITEM_FIELDS)
    return out


def persistence_round_trip(torch, dev, eng, root: str, make_engine,
                           now: int, launches: dict, widths: dict) -> dict:
    """``SnapshotWriter`` over ``eng``: one ``flush()`` (the dirty hot and
    cold rows as a delta), then ``write_base()``; then the directory read
    back by a fresh ``SnapshotStore`` and replayed with ``load_columns``
    into a fresh engine of the same configuration.  The seconds and bytes
    of each step, and 4096 sampled keys' items of the restored engine
    (hot or cold) held against the original's."""
    from gubernator_tpu_torch.persistence import SnapshotStore, SnapshotWriter
    from gubernator_tpu_torch.ops.reqcols import compact_blob

    snap_dir = os.path.join(root, "snap")
    out = {}
    with counted(torch, launches, "persist", widths):
        writer = SnapshotWriter(eng, SnapshotStore(snap_dir))
        t0 = time.perf_counter()
        out["flush_items"] = writer.flush()
        out["flush_s"] = time.perf_counter() - t0
        out["flush_bytes"] = os.path.getsize(
            os.path.join(snap_dir, "delta-00000000.log"))
        t0 = time.perf_counter()
        writer.write_base()
        out["base_s"] = time.perf_counter() - t0
        base = os.path.join(snap_dir, "base-00000001.snap")
        out["base_bytes"] = os.path.getsize(base)
        out["base_items"] = eng.last_export_stats["items"]
        writer.store.close()
        t0 = time.perf_counter()
        res = SnapshotStore(snap_dir).load()
        out["read_s"] = time.perf_counter() - t0
        assert res.corrupt_records == 0 and res.generation == 1
        out["read_items"] = res.items
        twin = make_engine(os.path.join(root, "ssd_twin"))
        try:
            t0 = time.perf_counter()
            for snap in res.snapshots:
                twin.load_columns(snap, now)
            torch.cuda.synchronize()
            out["replay_s"] = time.perf_counter() - t0
            out["replay_hot"] = twin.cache_size()
            out["replay_cold"] = twin.cold_size()
            snap = res.snapshots[-1]
            n = len(snap["key_offsets"]) - 1
            pick = np.zeros(n, bool)
            pick[np.random.default_rng(SEED).choice(n, min(4096, n),
                                                    replace=False)] = True
            blob, offsets = compact_blob(snap["key_blob"],
                                         snap["key_offsets"], pick)
            got = items_of(torch, twin, blob, offsets)
            want = items_of(torch, eng, blob, offsets)
            assert got == want, "restored items differ"
            out["sampled_items_equal"] = len(got)
        finally:
            twin.close()
    return out


def tier_phase(torch, dev, root: str, capacity=10_000_000, width=32768,
               cold_capacity=1 << 22, ssd_bytes=1 << 33, prefill_windows=458,
               windows=32, small=None) -> tuple[dict, dict]:
    """Phase 5.  First the small tiered engine on the card against the same
    engine on the CPU (``tier_compare``) and background reclaim under load
    (``bg_continuity``).  Then ``TickEngine(capacity, max_batch=width,
    cold_capacity, ssd=SsdStore(..., capacity_bytes=ssd_bytes))`` with
    background reclaim at its default (on at this size): eight probe keys
    take ``PROBE_HITS`` of ``PROBE_LIMIT``; ``prefill_windows`` windows of
    fresh keys fill a working set of ``prefill_windows * width`` keys (1.5x
    the table: hot, cold and SSD); ``windows`` churn windows of distinct
    keys drawn uniformly from it (each a B.1 window); the probes again with
    hits 0.  Every answer is the key's exact count (continuity through the
    tiers), one promote scatter a window, no SSD read on the tick path, no
    shed request.  Then the persistence round trip.  Returns ``(info,
    launches by path)``."""
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops import reqcols, rowtable
    from gubernator_tpu_torch.ops.engine import TickEngine
    from gubernator_tpu_torch.tiering import SsdStore

    info = {}
    launches, widths = {}, {}
    with counted(torch, launches, "compare", widths):
        info["compare"] = tier_compare(torch, dev, root, **(small or {}))
    with counted(torch, launches, "bg_reclaim", widths):
        info["bg_reclaim"] = bg_continuity(torch, dev)
    assert info["bg_reclaim"]["continuity_errors"] == 0
    assert info["bg_reclaim"]["bg_rounds"] > 0

    def make_engine(ssd_dir):
        return TickEngine(capacity=capacity, max_batch=width, device=dev,
                          cold_capacity=cold_capacity,
                          ssd=SsdStore(ssd_dir, capacity_bytes=ssd_bytes))

    eng = make_engine(os.path.join(root, "ssd"))
    try:
        assert eng._bg_reclaim == (capacity >= 1 << 18)
        now = NOW
        rng = np.random.default_rng(SEED + 7)
        probe_ids = np.arange(PROBES)
        with counted(torch, launches, "probes", widths):
            mat, errs = eng.process_columns(token_columns(
                reqcols, b"q", probe_ids, hits=PROBE_HITS,
                limit=PROBE_LIMIT), now)
        assert not errs and (mat[2] == PROBE_LIMIT - PROBE_HITS).all()
        ws = prefill_windows * width
        count = np.zeros(ws, np.int64)
        t0 = time.perf_counter()
        with counted(torch, launches, "prefill", widths):
            for k in range(prefill_windows):
                ids = np.arange(k * width, (k + 1) * width)
                count[ids] += 1
                mat, errs = eng.process_columns(
                    token_columns(reqcols, b"w", ids), now + 1)
                assert not errs and (mat[2] == TOKEN_LIMIT - 1).all()
        info["prefill_s"] = time.perf_counter() - t0
        info["working_set"] = ws
        info["after_prefill"] = {"hot": eng.cache_size(),
                                 "cold": eng.cold_size(),
                                 "ssd": len(eng.ssd)}
        m0 = {m: getattr(eng, m) for m in vars(eng) if m.startswith("metric_")}
        dev_ms, host, slot_s, win_s = {}, {}, [], []
        errors = shed = 0
        eng.slots = TimedSlots(eng.slots, slot_s)
        try:
            with counted(torch, launches, "churn", widths), \
                    device_timed(torch, rowtable,
                                 ("gather_rows", "scatter_rows"), dev_ms), \
                    host_timed(E, ("pack_cols_req32", "sort_packed_by_slot"),
                               host), \
                    host_timed(eng, ("_promote_misses",), host):
                for k in range(windows):
                    ids = rng.choice(ws, width, replace=False)
                    count[ids] += 1
                    cols = token_columns(reqcols, b"w", ids)
                    t0 = time.perf_counter()
                    mat, errs = eng.process_columns(cols, now + 2 + k)
                    win_s.append(time.perf_counter() - t0)
                    shed += len(errs)
                    errors += int((mat[2] != TOKEN_LIMIT - count[ids]).sum())
        finally:
            eng.slots = eng.slots._inner
        d = {m[len("metric_"):]: getattr(eng, m) - v for m, v in m0.items()}
        info["churn"] = {
            "windows": windows,
            "decisions_per_s": windows * width / sum(win_s),
            "window_s_p50": float(np.median(win_s)),
            "window_s_max": max(win_s),
            "host_split_ms": {
                "slot_lookup": 1e3 * sum(slot_s) / windows,
                "promote_with_ssd": 1e3 * sum(host["_promote_misses"])
                / windows,
                "pack": 1e3 * sum(host["pack_cols_req32"]) / windows,
                "sort": 1e3 * sum(host["sort_packed_by_slot"]) / windows},
            "continuity_errors": errors,
            "shed": shed,
            "row_kernels_ms_at_most": dev_ms,
            **{k: d[k] for k in (
                "promotions", "cold_hits", "ssd_hits", "promote_dispatches",
                "promote_ticks", "demote_readbacks", "evict_reclaims",
                "ssd_tick_path_reads", "bg_reclaims", "sync_reclaims",
                "unexpired_evictions", "shed_requests")},
        }
        c = info["churn"]
        c["promote_dispatches_per_tick"] = (
            c["promote_dispatches"] / max(1, c["promote_ticks"]))
        c["demote_readbacks_per_evicting_reclaim"] = (
            c["demote_readbacks"] / max(1, c["evict_reclaims"]))
        with counted(torch, launches, "probes_again", widths):
            mat, errs = eng.process_columns(token_columns(
                reqcols, b"q", probe_ids, hits=0, limit=PROBE_LIMIT),
                now + 2 + windows)
        # Stop the reclaimer and drain the SSD writer: the persistence
        # step then reads a table no thread moves.
        eng.close()
        info["probe_continuity_errors"] = int(
            len(errs) + (mat[2] != PROBE_LIMIT - PROBE_HITS).sum())
        info["totals"] = {
            m[len("metric_"):]: getattr(eng, m) for m in (
                "metric_promotions", "metric_cold_hits", "metric_ssd_hits",
                "metric_ssd_tick_path_reads", "metric_unexpired_evictions",
                "metric_shed_requests", "metric_bg_reclaims",
                "metric_sync_reclaims")}
        info["ssd"] = eng.ssd.stats()
        info["cold"] = eng.cold.stats()
        assert info["probe_continuity_errors"] == 0
        assert c["continuity_errors"] == 0 and c["shed"] == 0
        assert c["promote_ticks"] > 0 and c["promote_dispatches_per_tick"] == 1.0
        assert info["totals"]["ssd_tick_path_reads"] == 0
        assert info["totals"]["shed_requests"] == 0
        assert c["ssd_hits"] > 0 and c["cold_hits"] > 0
        info["persistence"] = persistence_round_trip(
            torch, dev, eng, root, make_engine, now + 3 + windows, launches,
            widths)
    finally:
        eng.close()
    info["launches_by_path"] = launches
    info["launches_by_width"] = widths
    total = {k: sum(p[k] for p in launches.values())
             for k in launches["churn"]}
    assert launches["churn"]["gather_rows"] > 0
    assert launches["churn"]["scatter_rows"] > 0
    assert launches["churn"]["fused_tick"] == windows
    return info, total



def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="CHECKOUT",
                    help="another checkout of this repository: its tick "
                         "kernels are timed in turns with these in phase 2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gubernator_tpu_torch import _build

    dev = torch.device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    libs = _build.build(*_build.CUDA_LIBS)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for path in libs:
        with open(path + ".log") as fh:
            ptxas[os.path.basename(path)] = [
                ln.strip() for ln in fh if "registers" in ln or "spill" in ln]
    print("phase1 " + json.dumps({"card": card, "build_s": build_s,
                                  "torch": torch.__version__,
                                  "cuda": torch.version.cuda,
                                  "ptxas": ptxas}), flush=True)

    against = build_against(args.against) if args.against else None
    kernels = kernel_phase(torch, dev, against=against)
    print("phase2 " + json.dumps(kernels), flush=True)
    assert kernels["fused_tick"]["working_set_mb"] > 2 * L2_MB
    assert kernels["fused_ragged_tick"]["working_set_mb"] > 2 * L2_MB

    info, launches = engine_phase(torch, dev,
                                  fused_ms=kernels["fused_tick"]["ms"])
    print("phase3 " + json.dumps(info), flush=True)
    mesh, mesh_launches = mesh_phase(torch, dev)
    print("phase4 " + json.dumps(mesh), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        tiers, tier_launches = tier_phase(torch, dev, root)
    print("phase5 " + json.dumps(tiers), flush=True)
    for name in launches:
        launches[name] += mesh_launches[name] + tier_launches[name]
        assert launches[name] > 0, f"{name} was not launched on the main path"
    # The ticks' launches by lane width over the three phases' paths.
    widths = {}
    for phase in (info, mesh, tiers):
        for per_path in phase["launches_by_width"].values():
            for name, counts in per_path.items():
                for w, c in counts.items():
                    widths.setdefault(name, {})
                    widths[name][w] = widths[name].get(w, 0) + c
    print("launch_widths " + json.dumps(
        {k: dict(sorted(v.items())) for k, v in widths.items()}), flush=True)

    table = []
    for name in ("fused_tick", "fused_merged_tick", "fused_ragged_tick",
                 "fused_sorted_tick", "gather_rows", "scatter_rows"):
        k = kernels[name]
        table.append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    print(json.dumps({"kernels": table}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
