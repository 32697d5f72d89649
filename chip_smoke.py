#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gubernator_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each:

1. the card (``nvidia-smi`` name and power limit) and the time to build
   every CUDA kernel from ``gubernator_tpu_torch/csrc`` (nvcc, in parallel);
2. each kernel against its plain PyTorch version on the card, bit for bit:
   the fused tick on a 32768-lane window over a 2^20-slot random table
   (all five algorithms, every behavior flag, Gregorian rows, padding and
   edge lanes), the merged tick on 8192 unique heads of the same table
   (Zipf(1.2) group sizes on token and leaky heads, size 1 on the zoo's,
   the edge lanes, 64 padding heads) and on a 512-head layer, gather and
   scatter on 32768 random slots, and the ragged tick on 32768-lane
   windows of global slots over 8 shards of a 2^20-slot table, with
   balanced extents and with every lane on one shard; with CUDA-event
   times (median of 25) of each kernel, its plain version and, for
   gather/scatter, ``index_select`` / ``index_copy_`` as a yardstick;
3. the engine at full size: ``TickEngine(capacity=10_000_000,
   max_batch=32768)`` serves windows that are first held against a
   ``device="cpu"`` engine on the same route (a unique window, a random
   Zipf(1.2) window, a revisit, a herd window, a herd window with RESET
   rows), then a 10M-key prefill, 32 pipelined unique windows
   (decisions/s, and the host's time per window split into slot lookup,
   packing and sort), a 32768-wide Zipf(1.2) herd (the grouped plan: one
   merged launch) and a herd with RESET rows on its 256 hottest keys (the
   layered plan), both checked against a scalar token-bucket model, a
   random Zipf(1.2) window of 32768 (the rank-round fallback) and a window
   of fresh keys against the full table (reclaim: gather + scatter).  Each
   of these paths runs with every kernel's launch count set to 0 just
   before it and read just after;
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

Then the kernel table as one JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
NOW = 1_700_000_000_000
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and int32 operations/s
# of the CUDA cores (132 SMs x 64 lanes x 1.98 GHz boost).
HBM_BYTES_PER_S = 3.35e12
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
    overhead.  ``fns`` is one callable or a list whose calls rotate (inputs
    spread over more than the 50 MB L2, as the main path finds them)."""
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
]


def fused_window(engine_mod, rng, cap: int, lanes: int, state: dict):
    """A slot-sorted unique (19, lanes) REQ32 window: random live lanes,
    the EDGE lanes (their slots' stored state overwritten in ``state``),
    and 64 padding lanes."""
    n = lanes - 64
    slots = np.sort(rng.choice(cap, n, replace=False))
    req = random_requests(rng, n)
    edge_at = rng.choice(n, len(EDGE), replace=False)
    for k, (r, s) in zip(edge_at, EDGE):
        for f, v in r.items():
            req[f][k] = v
        req["known"][k] = r.get("known", 1)
        slot = slots[k]
        for f in state:
            state[f][slot] = 0
        state["expire_at"][slot] = NOW + 60_000
        state["in_use"][slot] = True
        state["remaining"][slot] = 2
        state["updated_at"][slot] = NOW - 5_000
        state["created_at"][slot] = NOW - 5_000
        for f, v in s.items():
            state[f][slot] = v
    R = engine_mod.REQ32_INDEX
    m = np.zeros((engine_mod.REQ32_ROWS, lanes), np.int32)
    m[R["slot"]] = cap
    m[R["slot"], :n] = slots
    m[R["valid"], :n] = 1
    for f in ("known", "algorithm", "behavior"):
        m[R[f], :n] = req[f]
    for f in engine_mod.REQ32_WIDE:
        engine_mod.pack_wide_rows(m, f, req[f], slice(0, n))
    return m, n


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


def merged_entry(torch, table, wins, live):
    """The merged tick against its plain version, bit for bit, on the first
    window of heads and on its first LAYER_WIDTH heads, and its times at
    both widths (the grouped plan's head block and one narrow layer of the
    layered plan)."""
    from gubernator_tpu_torch.ops.fusedtick import (
        MERGED24_W, fused_merged_tick, fused_merged_tick_plain)

    u = wins[0][0].shape[1]
    lw = LAYER_WIDTH
    narrow = [(mh[:, :lw], c[:lw]) for mh, c in wins]
    t_k, t_p = table.clone(), table.clone()
    err = 0
    for mh, c in (wins[0], narrow[0]):
        j_k = fused_merged_tick(t_k, mh, c, NOW)
        j_p = fused_merged_tick_plain(t_p, mh, c, NOW, torch.empty_like(j_k))
        torch.cuda.synchronize()
        err = max(err, _max_abs(torch, j_k, j_p), _max_abs(torch, t_k, t_p))
        assert torch.equal(j_k, j_p), "fused_merged_tick journal differs from plain"
        assert torch.equal(t_k, t_p), "fused_merged_tick table differs from plain"
    del t_k, t_p
    scratch = table.clone()
    jr = torch.empty((u, MERGED24_W), dtype=torch.int32, device=table.device)

    def timed(ws, n_live):
        n = ws[0][0].shape[1]
        return (time_ms(torch, [lambda w=w: fused_merged_tick(
                    scratch, *w, NOW, out=jr[:w[0].shape[1]]) for w in ws]),
                n_live * 256 + n * MERGED_BYTES_PER_HEAD,
                n_live * MERGED_TICK_INT32_OPS_PER_LANE)

    ms, nbytes, ops = timed(wins, live)
    e = _entry(
        "fused_merged_tick", "gubernator_tpu_torch/csrc/fused_merged_tick.cu",
        "gubernator_tpu/ops/fusedtick.py:387", err, ms,
        time_ms(torch, [lambda w=w: fused_merged_tick_plain(
            scratch, *w, NOW, jr) for w in wins], reps=5),
        None, nbytes, ops)
    ms, nbytes, ops = timed(narrow, lw)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    e["heads"] = u
    e["at_layer_width"] = {"heads": lw, "ms": ms, "bound_ms": max(b_ms, o_ms),
                           "bound_by": "bytes" if b_ms >= o_ms else "operations"}
    return e


def ragged_entry(torch, dev, rng, lanes: int, table_slots: int,
                 rotate: int):
    """The ragged tick against its plain version, bit for bit, on a window
    with balanced extents and on one whose every lane is on shard 0, and
    its times on both (RAGGED_SHARDS shards of table_slots / RAGGED_SHARDS
    slots; the bound is the fused tick's, whatever the skew)."""
    from gubernator_tpu_torch.carry import sharded_table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops.raggedtick import (
        fused_ragged_tick, fused_ragged_tick_plain)

    n = RAGGED_SHARDS
    L = table_slots // n
    state = random_state(rng, n * L)
    wins = {skew: [ragged_window(E, rng, n, L, lanes, state, skew)
                   for _ in range(rotate)] for skew in (False, True)}
    table = sharded_table_from_columns(state, n, L, dev)
    dwins = {skew: [(torch.from_numpy(m).to(dev), torch.from_numpy(o).to(dev))
                    for m, o, _ in ws] for skew, ws in wins.items()}
    err = 0
    for skew in (False, True):
        m, o = dwins[skew][0]
        t_k, t_p = table.clone(), table.clone()
        r_k = fused_ragged_tick(t_k, m, o, n, L, NOW)
        r_p = fused_ragged_tick_plain(t_p, m, o, n, L, NOW,
                                      torch.empty_like(r_k))
        torch.cuda.synchronize()
        err = max(err, _max_abs(torch, r_k, r_p), _max_abs(torch, t_k, t_p))
        assert torch.equal(r_k, r_p), "fused_ragged_tick response differs"
        assert torch.equal(t_k, t_p), "fused_ragged_tick table differs"
        del t_k, t_p
    work = table.clone()
    resp = torch.empty((6, lanes), dtype=torch.int32, device=dev)

    def timed(ws):
        return time_ms(torch, [lambda w=w: fused_ragged_tick(
            work, *w, n, L, NOW, out=resp) for w in ws])

    live = wins[False][0][2]
    e = _entry(
        "fused_ragged_tick", "gubernator_tpu_torch/csrc/fused_ragged_tick.cu",
        "gubernator_tpu/ops/raggedtick.py:153", err, timed(dwins[False]),
        time_ms(torch, [lambda w=w: fused_ragged_tick_plain(
            work, *w, n, L, NOW, resp) for w in dwins[False]], reps=5),
        None, live * 256 + lanes * (76 + 24) + (n + 1) * 4,
        live * FUSED_TICK_INT32_OPS_PER_LANE)
    e["shards"] = n
    e["skewed"] = {"ms": timed(dwins[True]), "bound_ms": e["bound_ms"],
                   "extent_lanes": int(wins[True][0][1][1])}
    return e


def kernel_phase(torch, dev, lanes=32768, table_slots=1 << 20, rotate=8,
                 merged_heads=8192):
    """Each kernel against its plain version on the card, bit for bit, and
    their times.  Timed inputs rotate over ``rotate`` windows / slot sets
    of the 128 MB table, so most rows come from HBM as in the engine."""
    from gubernator_tpu_torch.carry import table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops import rowtable
    from gubernator_tpu_torch.ops.fusedtick import fused_tick, fused_tick_plain

    rng = np.random.default_rng(SEED)
    cap = table_slots
    state = random_state(rng, cap)
    m, live = fused_window(E, rng, cap, lanes, state)
    heads = [merged_window(E, rng, cap, merged_heads, state)]
    table = table_from_columns(state, cap, dev)
    wins = [torch.from_numpy(m).to(dev)] + [
        torch.from_numpy(fused_window(E, rng, cap, lanes, state)[0]).to(dev)
        for _ in range(rotate - 1)]
    heads += [merged_window(E, rng, cap, merged_heads, state)
              for _ in range(rotate - 1)]
    out = {}

    t_k, t_p = table.clone(), table.clone()
    r_k = fused_tick(t_k, wins[0], NOW)
    r_p = fused_tick_plain(t_p, wins[0], NOW, torch.empty_like(r_k))
    torch.cuda.synchronize()
    err = max(_max_abs(torch, r_k, r_p), _max_abs(torch, t_k, t_p))
    assert torch.equal(r_k, r_p), "fused_tick response differs from plain"
    assert torch.equal(t_k, t_p), "fused_tick table differs from plain"
    del t_k, t_p
    scratch = table.clone()
    resp = torch.empty_like(r_k)
    out["fused_tick"] = _entry(
        "fused_tick", "gubernator_tpu_torch/csrc/fused_tick.cu",
        "gubernator_tpu/ops/fusedtick.py:189", err,
        time_ms(torch, [lambda w=w: fused_tick(scratch, w, NOW, out=resp)
                        for w in wins]),
        time_ms(torch, [lambda w=w: fused_tick_plain(scratch, w, NOW, resp)
                        for w in wins], reps=5),
        None, live * 256 + lanes * (76 + 24),
        live * FUSED_TICK_INT32_OPS_PER_LANE)

    out["fused_merged_tick"] = merged_entry(
        torch, table, [(torch.from_numpy(mh).to(dev), torch.from_numpy(c).to(dev))
                       for mh, c, _ in heads], heads[0][2])

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

    out["fused_ragged_tick"] = ragged_entry(torch, dev, rng, lanes,
                                            table_slots, rotate)
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
    return out


@contextlib.contextmanager
def counted(torch, launches: dict, name: str):
    """Every kernel's launch count set to 0 just before the block and read
    into ``launches[name]`` just after."""
    import gubernator_tpu_torch as gt

    torch.cuda.synchronize()
    gt.reset_kernel_launches()
    yield
    torch.cuda.synchronize()
    launches[name] = gt.kernel_launches()


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
    eng = TickEngine(capacity=capacity, max_batch=width, device=dev)
    ref = TickEngine(capacity=ref_capacity, max_batch=width, device="cpu")
    info = {}
    launches = {}
    now = NOW

    def counted_path(name):
        return counted(torch, launches, name)

    def routes(e):
        return (e.metric_grouped_ticks, e.metric_layered_ticks,
                e.metric_rank_rounds)

    # Windows held against the CPU engine: same keys, same now, same
    # answers (slot numbers differ, state per key does not), and the same
    # route on both: the random Zipf window falls back to rank rounds, the
    # herd takes the grouped plan, the herd with RESET rows the layered.
    n_c = width
    herd_ids = (rng.zipf(1.2, compare_zipf) - 1) % (4 * n_c)
    lay_ids = (rng.zipf(1.2, compare_zipf) - 1) % (4 * n_c)
    compare = [
        ("unique", window_columns(reqcols, rng, b"c", np.arange(n_c), now),
         (0, 0, 0)),
        ("zipf", window_columns(
            reqcols, rng, b"c", (rng.zipf(1.2, compare_zipf) - 1) % (4 * n_c),
            now), None),
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
            got, gerr = eng.process_columns(cols, now)
            want, werr = ref.process_columns(cols, now)
            assert gerr == werr, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            for e, b in zip((eng, ref), before):
                d = tuple(x - y for x, y in zip(routes(e), b))
                if route is None:
                    assert d[:2] == (0, 0) and d[2] > 0, (name, d)
                else:
                    assert d == route, (name, d)
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
    # neither plan takes it): the rank-round fallback.
    g0, l0, r0 = routes(eng)
    ids = (rng.zipf(1.2, width) - 1) % todo
    zipf = window_columns(reqcols, rng, b"p", ids, now + 4_000)
    with counted_path("fallback"):
        t0 = time.perf_counter()
        mat, _ = eng.process_columns(zipf, now + 4_000)
        info["fallback_window_s"] = time.perf_counter() - t0
    assert mat.shape == (5, width)
    info["fallback_unique_keys"] = int(len(np.unique(ids)))
    info["fallback_rank_rounds"] = eng.metric_rank_rounds - r0
    assert routes(eng)[:2] == (g0, l0) and info["fallback_rank_rounds"] > 0
    assert launches["fallback"]["fused_tick"] == info["fallback_rank_rounds"]

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
    info["launches_by_path"] = launches
    total = {k: sum(p[k] for p in launches.values())
             for k in launches["unique"]}
    assert total["fused_ragged_tick"] == 0
    return info, total


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
    launches = {}
    now = NOW

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
        with counted(torch, launches, "compare_" + name):
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
    with counted(torch, launches, "prefill"):
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
    with counted(torch, launches, "unique"):
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
    with counted(torch, launches, "herd"):
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
    with counted(torch, launches, "skewed"):
        t0 = time.perf_counter()
        mat, _ = eng.process_columns(window_columns(
            reqcols, rng, b"p", sk, now + 4_000), now + 4_000)
        info["skewed_window_s"] = time.perf_counter() - t0
    assert mat.shape == (5, width)
    only_ragged("skewed")

    # Fresh keys against full shards: each shard reclaims.
    with counted(torch, launches, "reclaim"):
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
    total = {k: sum(p[k] for p in launches.values())
             for k in launches["unique"]}
    return info, total


def main() -> int:
    import torch

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

    kernels = kernel_phase(torch, dev)
    print("phase2 " + json.dumps(kernels), flush=True)

    info, launches = engine_phase(torch, dev,
                                  fused_ms=kernels["fused_tick"]["ms"])
    print("phase3 " + json.dumps(info), flush=True)
    del info
    mesh, mesh_launches = mesh_phase(torch, dev)
    print("phase4 " + json.dumps(mesh), flush=True)
    for name in launches:
        launches[name] += mesh_launches[name]
        assert launches[name] > 0, f"{name} was not launched on the main path"

    table = []
    for name in ("fused_tick", "fused_merged_tick", "fused_ragged_tick",
                 "gather_rows", "scatter_rows"):
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
