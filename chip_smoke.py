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
   on 32768 random slots, the gather also on 4096, 312500 and 625000
   random slots and on the reclaim scan's 2^20 ascending ones (its
   ``sweep``: ms, bound and share at each shape, timed over slot sets
   whose rows add up to more than twice the L2); and the ragged tick (B.4) on 32768-lane windows of global slots over 8 shards
   of the same size, with balanced extents and with every lane on one
   shard, and on their slices and edge windows as B.1; the chained
   duplicate tick (B.5) on 32768-lane windows of Zipf(1.2) slots (the
   phase-3 fallback window's skew), on their slices, on a 4096-lane
   window of one segment, on 1024-lane one-segment windows of token,
   leaky or zoo requests only, on a window of EDGE lanes and at its chunk
   shapes (segments of CHUNK - 1 to 2 CHUNK + 1 lanes, a segment that
   switches algorithm and flags, inert segments, padding, a column
   slice).  CUDA-event times
   (median of 25) of each kernel, its plain version and, for
   gather/scatter, ``index_select`` / ``index_copy_`` as a yardstick; B.1
   at every power of two from 1 to 32768 lanes, B.4 at 1, 64, 4096 and
   32768 and B.3 at 512, 4096 and 8192 heads (``by_width``), B.1 on each
   single-algorithm window and B.3 on each single-class window, rotating
   over windows that touch more than twice the L2 (``working_set_mb``);
   B.5 on its windows and on the one-segment windows, whose time over
   their lanes is one link of a segment's chain (``link_us`` by class;
   ``longest_chain_ms``: the longest segment's links at the mixed rate, a
   chain length measured in this kernel, not a bound), with its build's
   chunk, shared memory and ``ptxas`` registers and spills; and the
   mesh's duplicate tile tick (B.6) on phase 4's herd window (32768
   Zipf(1.2) lanes over 8 x 1.25M slots) and on a 4096-lane window whose
   runs cross the walk's chunk boundaries (8 x 2^14 random rows), bit
   for bit with its rank rounds, timed (on a scratch kept across its
   calls: one launch a window) beside its plain version and PR 15's time
   (``earlier_ms``), with its share of the bound and its build's
   ``ptxas`` registers, stack frame and spill bytes.
   ``--against CHECKOUT`` times that checkout's tick kernels, B.5
   included, and its row gather at every sweep shape in turns with these
   (``against_ms``, the gather's ``against_share``);
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
   prefill's token requests (one ``mesh_tile_tick`` launch, checked
   against the scalar token-bucket model), a skewed unique window of
   32768 keys on shard 0 and a window of fresh keys (per-shard reclaim).
   A unique window and the skewed window must each take one
   ``fused_ragged_tick`` launch and no other, a window with repeated keys
   one ``mesh_tile_tick`` launch and no other; every path reports its
   launches.  Then the mesh's state
   paths on fresh meshes of the same size, each held against a CPU mesh
   of 8 x 2^17 slots on a seeded sequence: 4096 GLOBAL installs over
   every shard (one scatter a STATE_CHUNK; installed keys answer alike),
   four Store-backed 4096-wide windows over persisted and fresh keys
   (same answers, same Store call sequence and contents), and an
   ``export_items`` -> ``load_items`` round trip of 2^20 live keys into a
   fresh mesh (one gather and one scatter; the exports equal the items);
   no guard row is ever written.

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

6. serving, in process (the reference's ``serve_loopback_10m`` rung):
   one ``V1Instance`` over a ``TickEngine`` prefilled with 10M keys
   (mixed token and leaky, sized with background reclaim's headroom so
   every key stays resident) with 4096-wide ticks and 48 ingest slabs;
   sixteen 1000-request payloads framed by the port's wire codec, parsed
   into arena slabs, ticked through the tick loop and encoded back.
   Traffic A (uniform keys) and B (Zipf(1.2)): 150 serial round trips
   (p50 / p99 ms), then 32 concurrent callers x 96 batches x 4 segments
   (decisions/s of the middle segments, ``h2d_overlap_ratio``); a
   flight-recorder segment (stage p50 / p99); 4096 probed keys, the 64
   hottest among them, hold their exact counts around traffic B;
   ``serve_cpu_ms_per_batch``; a 2^16-slot instance on the card against
   one on the CPU over 64 serial raw batches (all five algorithms, RESET
   rows, Zipf keys, explicit created_at, GLOBAL items as objects), byte
   for byte; and ``spawn_daemon`` over gRPC and HTTP against an
   in-process instance.

7. a cluster (the reference's 4-node ``docker-compose.yaml`` development
   cluster), in process over loopback gRPC with static membership: four
   daemons, each over a ``TickEngine(capacity=2**21, max_batch=4096)`` on
   the card, prefilled with their ring shares of 4M ``bench_`` keys
   (mixed token and leaky, one-hour buckets of a million).  A: 16 serial
   1000-request uniform batches to node 0, about three quarters of the
   items forwarded to their owners (p50 / p99 / max ms, forward counts);
   B: 32 concurrent callers round robin over the nodes (decisions/s, each
   node's windows); C: 16 batches of GLOBAL hits on 1024 keys spread over
   the nodes, then every owner's count exact and every non-owner's
   answer its owner's (``global_converge_ms``: the last hit to all four
   nodes agreeing); D: node 3 leaves the ring (its GLOBAL keys handed to
   their new owners with their counts, its other keys fresh, the other
   nodes' keys untouched; ``transfer_s``); E: a 4-node cluster of
   2^14-slot card engines against one on the CPU, answer for answer
   and owner row for owner row, on a seeded serial sequence (all five
   algorithms, GLOBAL, RESET, negative hits, invalid items).  Launches by
   path: prefill, forward, global, transfer, compare.

8. quota leases (``lease_node``, run on phase 6's node before it
   closes): two holders (``LeaseCache``s of their own ids, as two
   gateways) lease 16384 resident token-bucket keys that phase 6's
   traffic did not touch: grants of 4096 specs a call through
   ``V1Instance.lease_grant`` (want 32), 64 local admissions a key each,
   one batched renewal when the lease runs out (``take_syncs`` +
   ``lease_sync``, then want 64), and a release round that credits the
   unused budget back; over-admission 0, hits=0 probes before and after
   differ by exactly the admissions, one ``lease_apply`` launch a lease
   window, nothing outstanding, no sync loss or drop (grant, sync and
   release round seconds, local admissions a second, server items
   against admissions).  ``lease_wire``: a ``LeaseSession`` over
   phase 6's gRPC daemon takes 256 keys at one grant RPC a key, loses
   nothing on ``close()``, probes exact, ``/metrics`` counting the
   grants.  ``lease_compare``: the seeded edge-case ``lease_sequence`` on
   a 2^14-slot card engine and a CPU one, equal.

9. the GLOBAL mesh (``MeshGlobalEngine``, 8 nodes as 8 replicas in one
   table): A, the reference's ``global_mesh_8`` rung (256 GLOBAL hits a
   node a window over 4096 keys) at the default 2^16 slots, 25 windows
   each followed by a dense reconcile (decisions/s, reconciles/s,
   dispatches a step, launches by kernel; every replica row-equal after
   every reconcile, each key's count its limit less the hits sent); B,
   ``global_sparse_reconcile`` (64 hits a node) at 2^18 and 2^22 slots
   with sparse_k 4096 (loaded and empty step ms), the dense step at 2^18,
   and a window wider than sparse_k against a dense engine (2
   dispatches, one fallback, equal state); C, a 4-node
   ``Cluster(global_mesh=True)`` over gRPC (``global_converge_ms`` beside
   phase 7 C's, exact counts, no peer RPC); D, a card engine against a
   CPU one at 2^14 slots, sparse_k 64 and 0, on a seeded sequence (all
   five algorithms, negative hits, RESET, overdraw, evictions,
   overflowing steps).

10. live resharding (the reference's ``reshard_live`` rung): phase 4's
   mesh (8 x 1.25M slots) prefilled with 10M keys at the wall clock,
   behind a ``TickLoop``; a load thread sends 4096-wide Zipf(1.2)
   windows while a ``ReshardCoordinator`` runs 8 -> 4 -> 8.  Per
   transition: committed, ``state_loss``, ``double_served``,
   ``parity_errors`` (all 0), an independent sweep of 65536 keys the
   load thread never sends (rows equal, each key where its route puts it),
   seconds, frozen seconds, the p99 of windows served while it ran, the
   retriable sheds, the B.2 launches and the card's peak allocated bytes.
   Part B: a card mesh and a CPU mesh of 8 x 2^14 slots, filled, on the
   same windows and transitions (8 -> 4 -> 8 -> 3 -> 8), equal answers,
   tables and slot maps after every step.

11. multi-region federation (the reference's ``federation_2r`` rung):
   four daemons over loopback gRPC in two regions (``us``, ``us``,
   ``eu``, ``eu``; ``Cluster(federation=True)``, a 0.02 s
   ``federation_interval``), each over a ``TickEngine(capacity=2**21,
   max_batch=4096)`` on the card, each region's two nodes prefilled with
   their ring shares of 2M ``bench_`` keys.  A: 32 serial batches of
   1000 MULTI_REGION hits over 8192 keys, round robin over the nodes;
   ``federation_converge_ms`` (the last hit to nothing pending or in
   flight anywhere), every hit key's count on every node of both regions,
   envelopes sent and applied, records an envelope (mean, max), 0
   redeliveries, 0 degraded answers, decisions/s.  B: a WAN partition
   (every link between the regions cut both ways): the loss key takes
   120 + 90 hits, the over key (limit 60) is driven to OVER_LIMIT on both
   sides, 4096 keys take 2 hits on each side; then the heal: hit loss 0,
   the over-admission ratio (at most 1.0), redeliveries, each envelope
   applied once, seconds from the heal to convergence, the exact union on
   the 4096 keys.  C: a 2-region cluster of 2^14-slot card engines
   against one of CPU engines on a seeded serial MULTI_REGION sequence
   (token and leaky keys, explicit created_at, RESET, negative hits, one
   partition and heal), equal answers at every step and equal final
   answers on every node, both regions' owners agreeing.  Launches by
   path: prefill, global, apply (B.1 asserted), partition, heal, compare.

12. the shard autoscaler.  A (the reference's ``diurnal_autoscale`` rung,
   run in phase 10 on its engine before the tick loop closes): a
   compressed day of 96 control windows of 15 simulated minutes on a
   ``ManualClock``, the rung's demand trace and queueing model,
   ``PolicyConfig(windows=3, target_p99_ms=5, queue_high=100,
   hysteresis=0.5, occupancy_low=0.3, min_shards=4, max_shards=8)``,
   cooldowns 1800 / 3600 s, 4 an hour, dry run off; every actuation a
   live transition of the 10M-key mesh while a load thread sends
   4096-wide Zipf(1.2) windows: committed transitions (at least 2), state
   loss (the coordinator's audit and phase 10's 65536-key sweep), flaps,
   the p99 of windows ticked while a transition held the lock, vetoes by
   guardrail, retriable sheds, each transition's seconds and frozen
   seconds, ``chip_seconds_saved``, the B.2 launches.  B: a daemon on the
   card over an 8-shard mesh with its own autoscaler (0.2 s interval, dry
   run, 4 to 8 shards): after ten intervals ``/debug/autoscaler`` holds
   dry-run ``act`` decisions and the node 8 shards, ``/debug/state``
   carries ``autoscaler``; the coordinator's lock held for five
   intervals (reshard_busy vetoes); then dry run off: one transition
   8 -> 4 through ``V1Instance.reshard``, its keys answering as before;
   the three counter families moved on ``/metrics``.

Phase 2 also times one launch of an empty kernel (``empty_launch_ms``,
``csrc/empty.cu``) and B.9, the lease-column window
(``csrc/lease_apply.cu``), on set and delta windows of 4096 and 65536
lanes over a 10M-slot column triple kept as the engine keeps it (32-B
records), bit for bit against its plain version, beside the pre-B.9
eager sequence (``library_ms``), and the GLOBAL mesh's kernels bit for
bit against their plain versions: B.8a (accumulate) and B.8b (dense
reconcile) at 8 nodes x 2^16 slots on global_mesh_8's windows, B.8c
(sparse probe) and B.8d (sparse apply) at 8 x 2^22 with 512 union slots,
B.8d also with 4096 (``by_shape``; a reconcile consumes its
accumulators, so B.8b, strict and summed, and B.8d are timed with a
restore before each call and the restore's own time taken off).  B.6,
B.8b, B.8d and B.9 print their earlier design's time (``earlier_ms``),
their share of the bound and their ``ptxas`` report.  Phases 3-12 also report each path's
tick and lease-window launches by lane width (``launches_by_width``,
power-of-two buckets), summed over them on the ``launch_widths`` line.  Then the kernel table as one JSON line, the
card line, and last ``{"ok": true, "device": {...}}``.  Any failure raises and
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


def _short_runs(rng, n: int) -> list:
    """Run lengths of 1-3 lanes adding up to n."""
    out = []
    while n > 0:
        out.append(min(n, int(rng.integers(1, 4))))
        n -= out[-1]
    return out


def chain_window(engine_mod, rng, cap: int, kind: str, width: int,
                 state: dict, chunk: int):
    """A slot-sorted window at the chained tick's chunk ``chunk`` (its
    build's: ``csrc/sorted_tick.cuh``): ``(m, cols)``, the
    window ``m[:, cols]``.  Runs of 1-3 lanes surround the case's long
    runs; random requests over all algorithms and flags, five of them
    EDGE lanes (their slots' stored state set in ``state``); a run of 8
    lanes or more shares one algorithm, limit, duration and burst.
    ``kind``:

    * ``run``: two segments of ``width`` lanes, the second headed at the
      last lane of a long block's range (a multiple of chunk + 1, minus
      one);
    * ``switch``: a segment of ``width`` lanes whose requests switch
      algorithm (token, leaky, sliding window, GCRA, concurrency, token),
      RESET_REMAINING and DRAIN_OVER_LIMIT mid-run;
    * ``inert``: a segment of ``width`` inert lanes (valid == 0), then one
      of chunk + 9 lanes whose first chunk + 3 are inert;
    * ``padded``: a segment of ``width`` lanes, then chunk + 10 lanes
      of padding;
    * ``slice``: a segment of ``width`` lanes in a column slice of a wider
      matrix (ld_m > B) from column 7, mid 16-B vector."""
    R = engine_mod.REQ32_INDEX
    if kind == "run":
        head = 37 + width
        gap = 5 + (chunk - head - 5) % (chunk + 1)
        runs = (_short_runs(rng, 37) + [width] + _short_runs(rng, gap)
                + [width] + _short_runs(rng, 9))
    elif kind == "switch":
        runs = _short_runs(rng, 11) + [width] + _short_runs(rng, 20)
    elif kind == "inert":
        runs = (_short_runs(rng, 5) + [width, chunk + 9]
                + _short_runs(rng, 13))
    elif kind == "padded":
        runs = _short_runs(rng, 21) + [width]
    else:
        runs = _short_runs(rng, 30) + [width] + _short_runs(rng, 6)
    n = sum(runs)
    slots = np.repeat(np.sort(rng.choice(cap, len(runs), replace=False)),
                      runs)
    req = random_requests(rng, n)
    for k, edge in zip(rng.choice(n, 5, replace=False), EDGE):
        _set_edge(req, state, k, slots[k], edge)
    # The requests of a run of 8 or more lanes share one algorithm, limit,
    # duration and burst, are created within 200 ms of now and live for
    # 30 s or more, few of them RESET_REMAINING, so that each lane's answer
    # depends on the lanes before it on its slot.
    at = 0
    for r in runs:
        if r >= 8:
            run = slice(at, at + r)
            req["algorithm"][run] = rng.integers(0, 5)
            req["limit"][run] = rng.choice([10, 1000])
            req["duration"][run] = rng.choice([30_000, 3_600_000])
            req["burst"][run] = rng.choice([0, 20])
            req["hits"][run] = rng.choice([0, 1, 2, 3], r)
            req["created_at"][run] = NOW - rng.choice([0, 0, 0, 200], r)
            req["behavior"][run] = (np.where(rng.random(r) < 0.03, 8, 0)
                                    | np.where(rng.random(r) < 0.2, 32, 0))
            req["known"][run] = True
        at += r
    start = int(np.argmax(np.repeat(np.array(runs) == width, runs)))
    if kind == "switch":
        i = np.arange(width)
        run = slice(start, start + width)
        req["algorithm"][run] = np.array([0, 1, 2, 3, 4, 0])[i * 6 // width]
        req["behavior"][run] = np.where(i % 97 == 50, 8, 0) | np.where(
            (i > width // 4) & (i < 3 * width // 4), 32, 0)
        req["limit"][run] = 10
        req["hits"][run] = rng.choice([0, 1, 2, 3, 5], width)
        req["known"][run] = i > 0
    pad = chunk + 10 if kind == "padded" else 16
    m = _pack(engine_mod, cap, n + pad, slots, req)
    if kind == "inert":
        m[R["valid"], start:start + width] = 0
        m[R["valid"], start + width:start + width + chunk + 3] = 0
    if kind == "slice":
        wide = np.zeros((m.shape[0], m.shape[1] + 7 + 29), np.int32)
        wide[R["slot"]] = cap
        wide[:, 7:7 + m.shape[1]] = m
        return wide, slice(7, 7 + m.shape[1])
    return m, slice(0, m.shape[1])


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


# Windows of the mesh's duplicate tile tick (B.6): their kinds (a mixed
# Zipf window, one key over a whole extent, runs that cross the walk's
# chunk boundaries, every lane on shard 0, RESET rows, expired heads,
# invalid lanes inside the extents, and one algorithm each).
TILE_KINDS = ("mixed", "herd", "cross", "skewed", "reset", "expired",
              "invalid", "runs") + ALGORITHMS
# The run lengths of tile_window's ``runs`` kind, in turn: a lane, runs
# inside a warp's 32 lanes, a warp's width and one more, runs a warp walks
# (up to 256 lanes) and runs past them (a run block's).
TILE_RUN_LENGTHS = (1, 2, 7, 31, 32, 33, 1, 64, 3, 256, 257, 5, 300, 1, 17)


def tile_window(engine_mod, rng, n_shards: int, local_capacity: int,
                lanes: int, state: dict, kind: str = "mixed"):
    """A slot-sorted (19, lanes) window of GLOBAL slots whose slots repeat,
    for the mesh's duplicate tile tick over ``n_shards`` shards of
    ``local_capacity`` slots, and the walk's chunk width
    (``choose_tile``).  Runs of one slot (Zipf(1.2) over the table, one
    slot for the whole live window with ``herd``, runs of half a chunk to
    two chunks with ``cross``, all on shard 0 with ``skewed``, runs of
    ``TILE_RUN_LENGTHS`` lanes in turn with ``runs``) carry
    random requests over all five algorithms and flags, or (most runs)
    their head's request on every lane, known, so that their groups fold;
    ``reset`` puts RESET_REMAINING on a share of lanes, ``expired``
    expires the stored rows and dates the requests before now, ``invalid``
    clears ``valid`` on a few lanes inside the extents, an algorithm kind
    gives every lane that algorithm.  The last ``lanes // 16`` lanes are
    padding past every extent.  Returns ``(m, offsets, tile)``."""
    from gubernator_tpu_torch.ops.raggedtick import choose_tile

    L = local_capacity
    cap = n_shards * L
    tile = choose_tile(lanes, n_shards)
    n = lanes - lanes // 16
    if kind == "herd":
        slots = np.full(n, rng.integers(0, cap))
    elif kind == "cross":
        runs, total = [], 0
        while total < n:
            runs.append(int(rng.integers(max(1, tile // 2), 2 * tile + 2)))
            total += runs[-1]
        heads = np.sort(rng.choice(cap, len(runs), replace=False))
        slots = np.repeat(heads, runs)[:n]
    elif kind == "skewed":
        slots = np.sort((rng.zipf(1.2, n) - 1) % L)
    elif kind == "runs":
        reps = np.resize(TILE_RUN_LENGTHS, n)
        reps = reps[:int(np.searchsorted(np.cumsum(reps), n)) + 1]
        heads = np.sort(rng.choice(cap, len(reps), replace=False))
        slots = np.repeat(heads, reps)[:n]
    else:
        slots = np.sort((rng.zipf(1.2, n) - 1) % cap)
    req = random_requests(rng, n)
    start = np.ones(n, bool)
    start[1:] = slots[1:] != slots[:-1]
    head = np.maximum.accumulate(np.where(start, np.arange(n), 0))
    same = (rng.random(n) < 0.8)[head]   # a run's head decides
    hits = req["hits"]
    hits[start] = np.where(hits[start] > 0, hits[start], 1 + slots[start] % 3)
    req["algorithm"][start] = np.where(same[start], slots[start] % 2,
                                       req["algorithm"][start])
    req["behavior"][start & same] &= ~(8 | 4)
    for f in ("hits", "limit", "duration", "algorithm", "behavior",
              "created_at", "burst"):
        req[f] = np.where(same, req[f][head], req[f])
    req["known"] = np.where(same & ~start, True, req["known"])
    req["greg_exp"] = np.where(same, 0, req["greg_exp"])
    req["greg_dur"] = np.where(same, 0, req["greg_dur"])
    if kind == "reset":
        req["behavior"] |= np.where(rng.random(n) < 0.05, 8, 0)
    elif kind == "expired":
        state["expire_at"][slots] = NOW - rng.integers(1, 5_000, n)
        req["created_at"] = np.where(same, NOW - 1_000,
                                     NOW - rng.integers(1, 9_000, n))
        req["duration"] = np.where(req["duration"][head] == 0, 0,
                                   rng.choice([500, 1_000], n)[head])
    elif kind in ALGORITHMS:
        req["algorithm"][:] = ALGORITHMS.index(kind)
    m = _pack(engine_mod, cap, lanes, slots, req)
    if kind == "invalid":
        m[engine_mod.REQ32_INDEX["valid"], rng.choice(n, 1 + n // 64,
                                                      replace=False)] = 0
    counts = np.bincount(slots // L, minlength=n_shards)
    offsets = np.zeros(n_shards + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    return m, offsets, tile


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
    """The tick kernels and the row gather (``rows``) of another checkout
    at ``path`` (the same C interfaces), built from its ``csrc/`` with
    this checkout's flags, one compiler each, all started together:
    ``{kernel: C function}``."""
    import ctypes

    from gubernator_tpu_torch import _build

    csrc = os.path.join(os.path.abspath(path), "gubernator_tpu_torch", "csrc")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    sigs = {
        "fused_tick": [vp, i64, vp, i64, vp, i64, i64, i64, vp],
        "fused_merged_tick": [vp, i64, vp, i64, vp, vp, i64, i64, vp],
        "fused_ragged_tick": [vp, i64, i64, vp, vp, i64, vp, i64, i64, i64, vp],
        "fused_sorted_tick": [vp, i64, vp, i64, vp, i64, i64, i64, vp],
        "rows": [vp, i64, i64, vp, i64, vp, vp],
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
        fn = getattr(ctypes.CDLL(out),
                     "gt_gather_rows" if name == "rows" else "gt_" + name)
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


# The mesh's duplicate tile tick (B.6) in phase 2: phase 4's mesh (8
# shards of 1.25M slots) and herd window width, and a smaller mesh for the
# window whose runs cross the walk's chunk boundaries (its plain version
# runs a rank round for each lane of a chain).
TILE_SHARDS, TILE_LOCAL, TILE_LANES = 8, 1_250_000, 32768
TILE_CROSS_LOCAL, TILE_CROSS_LANES = 1 << 14, 4096
# int32 operations of a follower answered in closed form
# (csrc/mesh_tile_tick.cuh fold_answer: ~40 int64 operations, a float64
# division left out): an estimate.
TILE_FOLD_INT32_OPS_PER_LANE = 80
# PR 15's times of the kernels PR 16 redesigned, its proof run b on an
# NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §6): B.6 on the herd and the
# cross window, B.8b at 8 x 2^16 (strict); and the earlier designs of
# B.9 and B.8d (below).  Phase 2 prints them beside this run's as
# "earlier_ms".
EARLIER_MS = {"mesh_tile_tick": 0.03234399855136871,
              "mesh_tile_tick_cross": 0.1566160023212433,
              "global_dense_reconcile": 0.0997119965031743,
              # B.9's and B.8d's designs before their Hopper redesign
              # (one thread a lane, one thread a union slot), timed in
              # turns with the new ones in one call of
              # probes/lease_sparse_breakdown.py on an NVIDIA H100 80GB
              # HBM3, 700.00 W: the call whose figures PERF.md §6's
              # kernel table gives as "earlier ms".  B.9 on its four
              # windows, B.8d at 8 x 2^22 with 512 and 4096 union slots.
              "lease_apply_set_4096": 0.003396000014618039,
              "lease_apply_delta_4096": 0.0037960000336170197,
              "lease_apply_set_65536": 0.014448000118136406,
              "lease_apply_delta_65536": 0.01743599958717823,
              "global_sparse_apply": 0.04582399968057871,
              "global_sparse_apply_4096": 0.05392800038680434}


def kernel_ptxas(lib: str, kernel: str) -> dict:
    """``ptxas -v``'s report for kernel ``kernel`` of library ``lib``
    (``_build``'s log): its registers, its stack frame, and the spill
    bytes (stores and loads) of every function in the library."""
    from gubernator_tpu_torch import _build

    regs = frame = None
    spills = 0
    current = None
    with open(_build.library_path(lib) + ".log") as fh:
        for ln in fh:
            if "Compiling entry function" in ln or "Function properties" in ln:
                current = ln
            elif "spill stores" in ln:
                parts = ln.replace(",", "").split()
                spills += int(parts[4]) + int(parts[8])
                if current is not None and kernel in current \
                        and frame is None:
                    frame = int(parts[0])
            elif "Used" in ln and "registers" in ln and current is not None \
                    and kernel in current and regs is None:
                regs = int(ln.split("Used")[1].split()[0])
    return {"registers": regs, "stack_frame_bytes": frame,
            "spill_bytes": spills}


def herd_tile_window(engine_mod, rng, n_shards: int, local_capacity: int,
                     lanes: int):
    """Phase 4's mesh herd as the tile tick gets it: Zipf(1.2) keys, each
    at a random global slot of the table, every request the prefill's
    token request (one hit on a one-hour bucket of 100), known,
    server-stamped at NOW.  Returns ``(m, offsets, slots)`` with the
    distinct slots."""
    cap = n_shards * local_capacity
    rank = rng.zipf(1.2, lanes) - 1
    uniq, inv = np.unique(rank, return_inverse=True)
    slot_of = rng.choice(cap, len(uniq), replace=False)
    slots = np.sort(slot_of[inv])
    one = np.ones(lanes, np.int64)
    req = {"known": one.astype(bool), "algorithm": one * 0,
           "behavior": one * 0, "hits": one, "limit": one * 100,
           "duration": one * 3_600_000, "created_at": one * NOW,
           "burst": one * 0, "greg_exp": one * 0, "greg_dur": one * 0}
    m = _pack(engine_mod, cap, lanes, slots, req)
    counts = np.bincount(slots // local_capacity, minlength=n_shards)
    offsets = np.zeros(n_shards + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    return m, offsets, np.unique(slots)


def tile_entry(torch, dev, rng, rotate: int = 4):
    """Kernel B.6, the mesh's duplicate tile tick, held bit for bit against
    its plain version (the tile walk through the plain merge tick, on the
    card's tensors): responses, table and rank rounds, on phase 4's herd
    window (32768 lanes over 8 x 1.25M slots whose touched rows hold the
    prefill's token buckets) and on a window whose runs cross the walk's
    chunk boundaries (4096 lanes of tile_window's ``cross`` kind over
    8 x 2^14 random rows).  Timed on both (the herd rotating over
    ``rotate`` windows); the bound counts each lane's request and
    response, each distinct slot's row read and written, a transition a
    distinct slot and a closed-form answer for every other lane.  No
    library call computes it."""
    from gubernator_tpu_torch.carry import sharded_table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops.raggedtick import choose_tile
    from gubernator_tpu_torch.ops.tiletick import (
        TileScratch, mesh_tile_tick, mesh_tile_tick_plain)

    n, L, lanes = TILE_SHARDS, TILE_LOCAL, TILE_LANES
    herds = [herd_tile_window(E, rng, n, L, lanes) for _ in range(rotate)]
    touched = np.unique(np.concatenate([h[2] for h in herds]))
    table = torch.zeros((n * (L + 1), 16), dtype=torch.int64, device=dev)
    k = len(touched)
    prefill = np.zeros((k, 16), np.int64)
    for f, v in (("algorithm", 0), ("limit", 100), ("remaining", 99),
                 ("duration", 3_600_000), ("created_at", NOW - 1_000),
                 ("expire_at", NOW + 3_599_000), ("in_use", 1)):
        prefill[:, E.WORD[f]] = v
    flat = touched + touched // L
    table[torch.from_numpy(flat).to(dev)] = torch.from_numpy(prefill).to(dev)
    tile = choose_tile(lanes, n)

    crng = np.random.default_rng(SEED + 7)
    cstate = random_state(crng, n * TILE_CROSS_LOCAL)
    cm, coffs, ctile = tile_window(E, crng, n, TILE_CROSS_LOCAL,
                                   TILE_CROSS_LANES, cstate, "cross")
    ctable = sharded_table_from_columns(cstate, n, TILE_CROSS_LOCAL, dev)

    def check(tbl, m, offs, local, tl, what):
        mt = torch.from_numpy(m).to(dev)
        ot = torch.from_numpy(offs).to(dev)
        t_k, t_p = tbl.clone(), tbl.clone()
        r_k = torch.zeros(1, dtype=torch.int64, device=dev)
        r_p = torch.zeros(1, dtype=torch.int64, device=dev)
        got = mesh_tile_tick(t_k, mt, ot, n, local, tl, NOW, r_k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = mesh_tile_tick_plain(t_p, mt, ot, n, local, tl, NOW, r_p,
                                    torch.empty_like(got))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(_max_abs(torch, got, want), _max_abs(torch, t_k, t_p))
        assert torch.equal(got, want), f"mesh_tile_tick {what}: response"
        assert torch.equal(t_k, t_p), f"mesh_tile_tick {what}: table"
        assert int(r_k) == int(r_p), f"mesh_tile_tick {what}: rank rounds"
        del t_k, t_p
        return err, plain_ms, int(r_p), (mt, ot)

    err, plain_ms, rounds, _ = check(table, *herds[0][:2], L, tile, "herd")
    cerr, cplain_ms, crounds, cdev = check(ctable, cm, coffs,
                                           TILE_CROSS_LOCAL, ctile, "cross")
    work = table.clone()
    dwins = [(torch.from_numpy(m).to(dev), torch.from_numpy(o).to(dev))
             for m, o, _ in herds]
    resps = [torch.empty((6, lanes), dtype=torch.int32, device=dev)
             for _ in range(rotate)]
    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
    # A scratch kept across the calls, as the mesh engine keeps one: a
    # window is one launch.
    scr = TileScratch(dev)
    ms = time_ms(torch, [lambda x=x, r=r: mesh_tile_tick(
        work, *x, n, L, tile, NOW, cnt, out=r, scratch=scr)
        for x, r in zip(dwins, resps)])
    cwork = ctable.clone()
    cms = time_ms(torch, lambda: mesh_tile_tick(
        cwork, *cdev, n, TILE_CROSS_LOCAL, ctile, NOW, cnt, scratch=scr))
    distinct = len(herds[0][2])

    def work_of(d, w):
        return w * (76 + 24) + d * 256 + (n + 1) * 4, (
            d * FUSED_TICK_INT32_OPS_PER_LANE
            + (w - d) * TILE_FOLD_INT32_OPS_PER_LANE)

    e = _entry("mesh_tile_tick", "gubernator_tpu_torch/csrc/mesh_tile_tick.cu",
               "gubernator_tpu/ops/engine.py:1139", max(err, cerr), ms,
               plain_ms, None, *work_of(distinct, lanes))
    e["herd"] = {"lanes": lanes, "distinct_slots": distinct, "tile": tile,
                 "longest_run": int(np.unique(
                     herds[0][0][E.REQ32_INDEX["slot"]],
                     return_counts=True)[1].max()),
                 "rank_rounds": rounds, "touched_rows": k}
    cd = int(len(np.unique(cm[E.REQ32_INDEX["slot"], :int(coffs[-1])])))
    cb, co = work_of(cd, TILE_CROSS_LANES)
    e["cross"] = {"lanes": TILE_CROSS_LANES, "shards": n,
                  "local_capacity": TILE_CROSS_LOCAL, "tile": ctile,
                  "distinct_slots": cd, "rank_rounds": crounds, "ms": cms,
                  "earlier_ms": EARLIER_MS["mesh_tile_tick_cross"],
                  "plain_ms": cplain_ms, **_bound(cb, co)}
    e["cross"]["share"] = e["cross"]["bound_ms"] / cms
    e["earlier_ms"] = EARLIER_MS["mesh_tile_tick"]
    e["share"] = e["bound_ms"] / ms
    e["ptxas"] = kernel_ptxas("mesh_tile_tick", "mesh_tile_tick_kernel")
    e["checked"] = ["herd", "cross"]
    return e


# Lanes of the one-segment windows phase 2 times the chained duplicate
# tick on: its time over these lanes is one link of a segment's chain.
CHAIN_LANES = 4096
# One-segment windows of one class each, for the link of each path (zoo:
# sliding window, GCRA or concurrency at random), of CLASS_LANES lanes:
# their check (rank rounds on the card) takes milliseconds a lane.
CHAIN_CLASSES = ("token", "leaky", "zoo")
CLASS_LANES = 1024
# The chained tick's column slices held against its plain version.
SORTED_EDGE_WIDTHS = (1, 8, 9, 63, 64, 65, 255, 256, 257, 4096)


# The chained tick's chunk shapes, ``(kind, chunks, lanes)``: a
# ``chain_window`` of that kind whose long run has chunks * chunk + lanes
# lanes for the build's chunk.  Segments around one chunk (one thread or a
# long block) and two (two chunks, two and a lane), a long segment that
# switches algorithm and flags, inert long segments, a long segment
# before padding, a column slice.
CHAIN_SHAPES = (("run", 1, -1), ("run", 1, 0), ("run", 1, 1), ("run", 2, 0),
                ("run", 2, 1), ("switch", 2, 1), ("inert", 1, 5),
                ("padded", 1, 7), ("slice", 1, 1))


def sorted_entry(torch, dev, rng, state, lanes: int, rotate: int,
                 against=None):
    """Kernel B.5, the chained duplicate tick, on ``state``'s random table
    (the windows' EDGE lanes' stored state in place): held against its
    plain version (rank rounds of the fused tick's plain version, on the
    card) bit for bit on a Zipf(1.2) window of ``lanes`` lanes (the
    phase-3 fallback window's skew), on its column slices at
    SORTED_EDGE_WIDTHS (ld_m > B), on a window of one segment of
    CHAIN_LANES lanes, on one-segment windows of CLASS_LANES lanes of each
    of CHAIN_CLASSES, on a window of EDGE lanes and at the kernel's chunk
    shapes (CHAIN_SHAPES); timed on the
    Zipf windows, rotating over ``rotate`` of them, and on the one-segment
    windows (``link_us``: a window's time over its lanes, one link of a
    segment's chain); the plain version is timed by the check's one call
    on the first Zipf window.  ``longest_chain_ms`` is the Zipf window's
    longest segment at the mixed one-segment window's link: what the
    kernel's own chain costs at that length, not a bound.  ``against``
    (build_against) times another checkout's B.5 in turns with this one
    on the same windows."""
    from gubernator_tpu_torch import _build
    from gubernator_tpu_torch.carry import table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops.sortedtick import (
        fused_sorted_tick, fused_sorted_tick_plain, kernel_config)

    cfg = kernel_config()
    cap = len(state["algorithm"])
    mats = [sorted_window(E, rng, cap, lanes, state) for _ in range(rotate)]
    chain = sorted_window(E, rng, cap, CHAIN_LANES, state, one_slot=True)
    req = random_requests(rng, 257)
    eslots = np.arange(257) // 3
    for k in range(257):
        _set_edge(req, state, k, eslots[k], EDGE[k % len(EDGE)])
    edges = _pack(E, cap, 257, eslots, req)
    A = E.REQ32_INDEX["algorithm"]
    singles = {}
    for kind in CHAIN_CLASSES:
        m = chain[:, :CLASS_LANES].copy()
        m[A] = (rng.integers(2, 5, CLASS_LANES) if kind == "zoo"
                else ALGORITHMS.index(kind))
        singles[kind] = m
    shapes = []
    for kind, chunks, extra in CHAIN_SHAPES:
        width = chunks * cfg["chunk"] + extra
        shapes.append((f"{kind} shape {width}", chain_window(
            E, rng, cap, kind, width, state, cfg["chunk"])))
    table = table_from_columns(state, cap, dev)
    wins = [torch.from_numpy(m).to(dev) for m in mats]
    chain_d = torch.from_numpy(chain).to(dev)
    singles_d = {k: torch.from_numpy(m).to(dev) for k, m in singles.items()}
    cases = [(f"slice {w}", wins[0][:, :w]) for w in SORTED_EDGE_WIDTHS
             if w < lanes]
    cases += [(f"zipf window {lanes}", wins[0]),
              (f"one segment {CHAIN_LANES}", chain_d),
              ("EDGE window 257", torch.from_numpy(edges).to(dev))]
    cases += [(f"{k} segment {CLASS_LANES}", m)
              for k, m in singles_d.items()]
    cases += [(what, torch.from_numpy(m).to(dev)[:, cols])
              for what, (m, cols) in shapes]
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

    def timed(ws, rs):
        theirs = None if against is None else [
            lambda x=x, r=r: against["fused_sorted_tick"](
                work.data_ptr(), cap, x.data_ptr(), x.stride(0),
                r.data_ptr(), r.stride(0), x.shape[1], NOW, _stream(torch))
            for x, r in zip(ws, rs)]
        return ab_times(torch, [lambda x=x, r=r: fused_sorted_tick(
            work, x, NOW, out=r) for x, r in zip(ws, rs)], theirs)

    zipf = timed(wins, resps)
    chain_out = [torch.empty((6, CHAIN_LANES), dtype=torch.int32,
                             device=dev)]
    class_out = [torch.empty((6, CLASS_LANES), dtype=torch.int32,
                             device=dev)]
    one = {"mixed": timed([chain_d], chain_out)}
    one.update({k: timed([m], class_out) for k, m in singles_d.items()})
    one_lanes = {k: m.shape[1] for k, m in singles_d.items()}
    one_lanes["mixed"] = CHAIN_LANES
    R = E.REQ32_INDEX
    sl = mats[0][R["slot"]]
    live = (mats[0][R["valid"]] != 0) & (sl >= 0) & (sl < cap)
    distinct = len(np.unique(sl[live]))
    longest = longest_segment(E, mats[0], cap)
    e = _entry(
        "fused_sorted_tick", "gubernator_tpu_torch/csrc/fused_sorted_tick.cu",
        "gubernator_tpu/ops/tick32.py:357", err, zipf["ms"], plain_ms[0],
        None,
        distinct * 256 + int(live.sum()) * (76 + 24)
        + int((~live).sum()) * (8 + 24),
        int(live.sum()) * FUSED_TICK_INT32_OPS_PER_LANE)
    e.update({k: v for k, v in zipf.items() if k != "ms"})
    e["lanes"] = lanes
    e["distinct_slots"] = distinct
    e["longest_segment"] = longest
    e["chain_lanes"] = CHAIN_LANES
    e["chain_ms"] = one["mixed"]["ms"]
    e["one_segment"] = one
    e["one_segment_lanes"] = one_lanes
    e["link_us"] = {k: v["ms"] * 1e3 / one_lanes[k] for k, v in one.items()}
    if against is not None:
        e["against_link_us"] = {
            k: [t * 1e3 / one_lanes[k] for t in v["against_ms"]]
            for k, v in one.items()}
    e["longest_chain_ms"] = longest * e["chain_ms"] / CHAIN_LANES
    e["config"] = cfg
    with open(_build.library_path("fused_sorted_tick") + ".log") as fh:
        e["ptxas"] = [ln.strip() for ln in fh
                      if "registers" in ln or "spill" in ln or "smem" in ln]
    e["checked"] = [what for what, _ in cases]
    return e


def kernel_phase(torch, dev, lanes=32768, table_slots=1 << 21, rotate=16,
                 merged_heads=8192, against=None):
    """Each kernel against its plain version on the card, bit for bit, and
    their times.  Timed inputs rotate over ``rotate`` windows / slot sets
    of the 256 MB table: the ticks' windows touch more than twice the 50 MB
    L2 in rows and columns (``working_set_mb``), so their rows come from
    HBM as in the engine.  ``against`` (build_against) adds another
    checkout's tick kernels and row gather, timed in turns with these.
    The gather's ``sweep`` holds it at 4096, 32768, 312500 and 625000
    random rows and at the reclaim scan's shape."""
    from gubernator_tpu_torch import _build
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

    sweep = {}
    # Its own generator: the draws of the other kernels' inputs stay
    # those of earlier runs.
    grng = np.random.default_rng(SEED + 4)

    def check_gather(sets, shape):
        """The gather on ``sets`` (held bit for bit against its plain
        version, and with ``against`` the other checkout's gather too),
        timed; its ``sweep`` line: ms, bound, share, and the other
        checkout's ms timed in turns with it.  The timed sets are topped
        up with random ones until their rows add up to more than twice
        the L2, so the rows come from HBM as a window's do (at 4096 rows
        16 sets would come back from the caches)."""
        n = sets[0].numel()
        need = -(-2 * L2_MB * 10**6 // (n * 128))
        sets = sets + [torch.from_numpy(grng.choice(
            cap, n, replace=False).astype(np.int64)).to(dev)
            for _ in range(need - len(sets))]
        g_k = rowtable.gather_rows(table, sets[0])
        g_p = rowtable.gather_rows_plain(table, sets[0])
        torch.cuda.synchronize()
        assert torch.equal(g_k, g_p), f"gather_rows differs from plain ({shape})"
        theirs = None
        if against is not None:
            g_t = torch.empty_like(g_k)

            def theirs_on(s):
                _build.check(against["rows"](
                    table.data_ptr(), cap, table.shape[1], s.data_ptr(), n,
                    g_t.data_ptr(), _stream(torch)), "against gather_rows")
            theirs_on(sets[0])
            torch.cuda.synchronize()
            assert torch.equal(g_t, g_p), f"against gather differs ({shape})"
            theirs = [lambda s=s: theirs_on(s) for s in sets]
        ab = ab_times(torch, [lambda s=s: rowtable.gather_rows(table, s)
                              for s in sets], theirs)
        e = _entry(
            "gather_rows", "gubernator_tpu_torch/csrc/rows.cu",
            "gubernator_tpu/ops/rowtable.py:257", _max_abs(torch, g_k, g_p),
            ab["ms"],
            time_ms(torch, [lambda s=s: rowtable.gather_rows_plain(table, s)
                            for s in sets]),
            time_ms(torch, [lambda s=s: torch.index_select(table, 0, s)
                            for s in sets]),
            n * (8 + 256), 0)
        line = {"rows": n, "ms": e["ms"], "bound_ms": e["bound_ms"],
                "share": e["bound_ms"] / e["ms"], "checked": True}
        if theirs is not None:
            line.update(ms_repeat=ab["ms_repeat"], against_ms=ab["against_ms"],
                        against_share=[e["bound_ms"] / t
                                       for t in ab["against_ms"]])
        sweep[shape] = line
        return e

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
        torch, dev, np.random.default_rng(SEED + 2), state, lanes, rotate,
        against)
    out["fused_ragged_tick"] = ragged_entry(torch, dev, rng, lanes,
                                            table_slots, rotate, against)
    # Its own generator: the draws of the other kernels' inputs stay
    # those of earlier runs.
    out["mesh_tile_tick"] = tile_entry(torch, dev,
                                       np.random.default_rng(SEED + 8))
    out["gather_rows"] = check_gather(slot_sets(lanes), str(lanes))
    rows = torch.from_numpy(
        rng.integers(-2**62, 2**62, (lanes, 16)).astype(np.int64)).to(dev)
    out["scatter_rows"] = check_scatter(slot_sets(lanes, guard_every=97), rows)

    # The shapes reclaim gives them: the dead-slot scan gathers ascending
    # candidate slots SCAN_CHUNK at a time, eviction scatters zero rows in
    # chunks of EVICT_CHUNK.
    scan = min(rowtable.SCAN_CHUNK, cap)
    main = {
        "gather_rows": check_gather(
            [torch.arange(scan, dtype=torch.int64, device=dev)],
            "reclaim_scan"),
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
            e = check_gather(tier_sets(n), str(n))
        else:
            e = check_scatter(tier_sets(n), torch.from_numpy(trng.integers(
                -2**62, 2**62, (n, 16)).astype(np.int64)).to(dev))
        out[name].setdefault("at_tier_shapes", {})[shape] = {
            "rows": n, **{k: e[k] for k in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "max_abs_err")}}
    out["gather_rows"]["sweep"] = sweep
    # Its own generator: the draws above stay those of earlier runs.
    out["lease_apply"] = lease_entry(
        torch, dev, np.random.default_rng(SEED + 5))
    out.update(global_kernel_entries(torch, dev,
                                     np.random.default_rng(SEED + 6)))
    out["empty_launch_ms"] = empty_launch_ms(torch, dev)
    return out


# ----------------------------------------------------------------------
# B.9: the lease-column window (ops/leasecols.py)
# ----------------------------------------------------------------------
LEASE_SLOTS = 10_000_000      # phase 6's table: the lease columns of 10M keys
LEASE_WIDTHS = (4096, 65536)  # a grant call's window; a wide window
LEASE_NEGATIVE = 16           # slots holding a negative budget


def lease_lanes(rng, cap: int, n: int) -> tuple:
    """Raw lanes of one window: random slots, one lane in 16 repeating an
    earlier lane's slot; budgets in [-50, 50); expiries; generations."""
    slots = rng.integers(0, cap, n)
    rep = np.flatnonzero(rng.random(n) < 1 / 16)
    rep = rep[rep > 0]
    slots[rep] = slots[(rng.random(len(rep)) * rep).astype(np.int64)]
    return (slots, rng.integers(-50, 50, n), NOW + rng.integers(0, 10**6, n),
            rng.integers(0, 1000, n))


def eager_lease_window(cols, lanes, is_set):
    """The port's lease window before B.9 (its ``TickEngine.lease_window``
    after the host kept only resident lanes): index writes, or an
    accumulating add, a clamp of the whole budget column and two
    scatter-max, as separate torch launches."""
    import torch

    budget, expire, gen = cols
    idx, bud, exp, g = lanes
    g = g.to(torch.int32)
    if is_set:
        budget[idx] = bud
        expire[idx] = exp
        gen[idx] = g
    else:
        budget.index_put_((idx,), bud, accumulate=True)
        budget.clamp_(min=0)
        expire.scatter_reduce_(0, idx, exp, "amax")
        gen.scatter_reduce_(0, idx, g, "amax")


def lease_entry(torch, dev, rng, cap=LEASE_SLOTS, widths=LEASE_WIDTHS,
                rotate=16) -> dict:
    """B.9 on a ``cap``-slot column triple as the engine keeps it
    (``lease_records``: 32-B records, 320 MB, six times the L2): set and
    delta windows of each width in ``widths``, the kernel on the packed
    lanes held bit for bit against the plain version on the same records
    (set: on the same lanes; delta: on the raw lanes, repeats and the
    whole-column clamp included, with LEASE_NEGATIVE slots negative
    before the window), the records' padding still 0, and timed over
    ``rotate`` lane sets beside the plain version on the packed lanes and
    the pre-B.9 eager sequence (``eager_lease_window``, ``library_ms``).
    Bound: 28 B a packed lane in, 20 B of columns written, and for a
    delta window 20 B read.  The kernel table's entry is the set window
    of 4096 lanes, a grant call's, with the earlier design's time from
    ``probes/lease_sparse_breakdown.py`` (``earlier_ms``, also by shape),
    its share of the bound and its ``ptxas`` report."""
    from gubernator_tpu_torch.ops import leasecols as LC

    def col(v, dtype):
        t = torch.from_numpy(np.asarray(v, dtype)).to(dev)
        t[cap] = 0  # the guard entry
        return t

    def records(values):
        r = LC.lease_records(cap, dev)
        for a, v in zip(r, values):
            a.copy_(v)
        return r

    neg = rng.choice(cap, LEASE_NEGATIVE, replace=False)
    budget = col(rng.integers(0, 1000, cap + 1), np.int64)
    budget[torch.from_numpy(neg).to(dev)] = -5
    # The columns as the engine keeps them (lease_records' views).
    cols = records((budget,
                    col(NOW + rng.integers(0, 10**6, cap + 1), np.int64),
                    col(rng.integers(0, 1000, cap + 1), np.int32)))
    torch.cuda.empty_cache()
    scratch = records(cols)
    shapes, err = {}, 0
    for n in widths:
        for is_set in (True, False):
            raw = [lease_lanes(rng, cap, n) for _ in range(rotate)]
            packed = [torch.from_numpy(LC.pack_lanes(
                *r, is_set, () if is_set else neg)).to(dev) for r in raw]
            unpacked = [torch.from_numpy(np.stack(
                [np.asarray(r[0]), r[1], r[2],
                 np.asarray(r[3]).astype(np.int32).astype(np.int64)])).to(dev)
                for r in raw]
            k = records(cols)
            p = records(cols)
            LC.lease_apply(*k, packed[0], is_set)
            LC.lease_apply_plain(*p, packed[0] if is_set else unpacked[0],
                                 is_set)
            torch.cuda.synchronize()
            kind = "set" if is_set else "delta"
            for a, b in zip(k, p):
                assert torch.equal(a, b), f"lease_apply differs ({kind} {n})"
                err = max(err, _max_abs(torch, a, b))
            assert not k[0]._base[:, 3].any(), "lease_apply wrote padding"
            del k, p
            m = packed[0].shape[1]
            nbytes = m * (28 + 20 + (0 if is_set else 20))
            # The engine's lease window before B.9: a set window's lanes
            # deduplicated on the host, a delta window's raw.
            library = [p_ if is_set else u for p_, u in zip(packed, unpacked)]
            shapes[f"{kind}_{n}"] = _entry(
                "lease_apply", "gubernator_tpu_torch/csrc/lease_apply.cu",
                "gubernator_tpu/ops/engine.py:1837", err,
                time_ms(torch, [lambda l=l: LC.lease_apply(*scratch, l, is_set)
                                for l in packed]),
                time_ms(torch, [lambda l=l: LC.lease_apply_plain(
                    *scratch, l, is_set) for l in packed]),
                time_ms(torch, [lambda l=l: eager_lease_window(
                    scratch, l, is_set) for l in library]),
                nbytes, 0)
            shapes[f"{kind}_{n}"]["lanes"] = m
    out = dict(shapes[f"set_{widths[0]}"])
    out["max_abs_err"] = float(err)
    out["by_shape"] = {
        k: {f: v[f] for f in ("lanes", "ms", "plain_ms", "library_ms",
                              "bound_ms", "bytes")}
        for k, v in shapes.items()}
    for k, v in out["by_shape"].items():
        v["share"] = v["bound_ms"] / v["ms"]
        v["earlier_ms"] = EARLIER_MS.get(f"lease_apply_{k}")
    out.update(earlier_ms=EARLIER_MS.get(f"lease_apply_set_{widths[0]}"),
               share=out["bound_ms"] / out["ms"],
               ptxas=kernel_ptxas("lease_apply", "lease_apply_kernel"))
    return out


def empty_launch_ms(torch, dev) -> float:
    """One launch of an empty kernel (``csrc/empty.cu``), timed as the
    kernels are: what a launch alone costs, to read small launches by."""
    import ctypes

    from gubernator_tpu_torch import _build

    lib = _build.load("empty")
    lib.gt_empty_launch.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    return time_ms(torch, lambda: _build.check(
        lib.gt_empty_launch(stream), "empty_launch"))


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


def assert_same_export(ea: dict, eb: dict) -> None:
    """Two ``export_columns`` snapshots equal, key blob and every column."""
    assert ea.keys() == eb.keys()
    assert bytes(ea["key_blob"]) == bytes(eb["key_blob"])
    for f in ea:
        if f != "key_blob":
            np.testing.assert_array_equal(ea[f], eb[f], err_msg=f)


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
               compare_zipf=8192, state=None):
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
        else:   # duplicates: one mesh_tile_tick launch, no rank round
            got = launches["compare_" + name]
            assert got["mesh_tile_tick"] == sum(got.values()) == 1, got
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
    # One mesh_tile_tick launch and nothing else.
    got = launches["herd"]
    assert got["mesh_tile_tick"] == sum(got.values()) == 1, got
    info["herd_launches"] = {k: v for k, v in got.items() if v}

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
    assert guard_rows_zero(eng)
    del eng
    info["state"] = mesh_state_paths(
        torch, dev, n_shards, local_capacity, width, ref_local_capacity,
        launches, widths, **(state or {}))
    info["launches_by_path"] = launches
    info["launches_by_width"] = widths
    total = {k: sum(p[k] for p in launches.values())
             for k in launches["unique"]}
    return info, total


def recording_store():
    """The port's MockStore logging every call in order: ``(op, key)``,
    and for ``on_change`` the item written."""
    from gubernator_tpu_torch.store import MockStore

    class RecordingStore(MockStore):
        def __init__(self):
            super().__init__()
            self.log = []

        def on_change(self, req, item):
            self.log.append(("on_change", req.hash_key(), dict(item)))
            super().on_change(req, item)

        def get(self, req):
            self.log.append(("get", req.hash_key()))
            return super().get(req)

        def remove(self, key):
            self.log.append(("remove", key))
            super().remove(key)
    return RecordingStore()


def global_updates(types, rng, ids, now: int) -> list:
    """GLOBAL updates (token or leaky) over keys ``gl_<8 digits>``."""
    d_l = [(60_000, 10), (3_600_000, 1000), (30_000, 100), (5_000, 5)]
    out = []
    for i in ids.tolist():
        d, lim = d_l[int(rng.integers(len(d_l)))]
        out.append(types.GlobalUpdate(
            key=f"gl_{i:08d}", algorithm=int(rng.integers(0, 2)), duration=d,
            status=types.RateLimitResponse(
                limit=lim, remaining=int(rng.integers(0, lim + 1)),
                status=int(rng.integers(0, 2)),
                reset_time=now + int(rng.integers(60_000, 3_600_000)))))
    return out


def answers(resps) -> list:
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error)
            for r in resps]


def guard_rows_zero(eng) -> bool:
    L = eng.local_capacity
    return bool((eng.table[L::L + 1] == 0).all())


def mesh_state_paths(torch, dev, n_shards: int, local_capacity: int,
                     width: int, ref_local_capacity: int, launches: dict,
                     widths: dict, installs=4096, store_windows=4,
                     store_width=4096, round_trip_per_shard=1 << 17) -> dict:
    """The mesh's state paths at ``local_capacity`` on ``dev``, each held
    against a ``device="cpu"`` mesh of ``ref_local_capacity`` slots a
    shard on the same seeded sequence (phase 4): ``installs`` GLOBAL
    installs over every shard (some keys repeated: the last wins), then
    ``store_windows`` Store-backed windows of ``store_width`` requests over
    persisted (read through) and fresh keys with repeats and RESET rows (same answers, same Store call sequence and contents), and
    an ``export_items`` / ``load_items`` round trip of
    ``round_trip_per_shard`` live keys a shard into a fresh mesh (the
    fresh mesh's and the CPU mesh's exports equal the items).  Each path's
    launches are counted (``counted``): installs and load take one scatter
    a STATE_CHUNK, export one gather a STATE_CHUNK, and no guard row is
    ever written."""
    from gubernator_tpu_torch import types
    from gubernator_tpu_torch.native import crc32_batch
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.ops.engine import STATE_CHUNK
    from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine

    rng = np.random.default_rng(SEED + 7)
    now = NOW + 10_000_000
    out = {}

    def pair(L, d, store=False):
        return MeshTickEngine(n_shards, L, max_batch=width, device=d,
                              store=recording_store() if store else None)

    eng, ref = pair(local_capacity, dev, True), pair(ref_local_capacity,
                                                     "cpu", True)
    # GLOBAL installs over every shard; a sixteenth of the updates repeat
    # a key.
    ids = rng.permutation(installs)
    ids[installs - installs // 16:] = ids[:installs // 16]
    n_unique = len(np.unique(ids))
    ups = global_updates(types, rng, ids, now)
    with counted(torch, launches, "installs", widths):
        t0 = time.perf_counter()
        eng.install_globals(ups, now)
        torch.cuda.synchronize()
        out["installs_s"] = time.perf_counter() - t0
    ref.install_globals(ups, now)
    got = launches["installs"]
    assert got["scatter_rows"] == -(-n_unique // STATE_CHUNK), got
    assert sum(got.values()) == got["scatter_rows"], got
    out["installs"] = {"updates": installs, "keys": n_unique,
                       "launches": got}
    probes = request_objects(types, token_columns(
        reqcols, b"gl_", np.unique(ids), hits=0))
    with counted(torch, launches, "installs_check", widths):
        items = eng.export_items()
        got = eng.process(probes, now + 1)
    assert items == ref.export_items() and len(items) == n_unique
    assert answers(got) == answers(ref.process(probes, now + 1)), (
        "installed keys")

    # Store windows over keys persisted in both stores (read through) and
    # fresh keys; repeats and RESET rows.
    pool = np.arange(3 * store_width)
    persisted = pool[(pool % 3) == 1]
    for st in (eng.store, ref.store):
        for i in persisted.tolist():
            st.data[f"st_{i:08d}"] = {
                "key": f"st_{i:08d}", "algorithm": i % 2, "limit": 100,
                "remaining": i % 97, "remaining_f": float(i % 97),
                "duration": 3_600_000, "created_at": now, "updated_at": now,
                "burst": 100, "status": 0, "expire_at": now + 3_600_000}
    store_s = []
    with counted(torch, launches, "store", widths):
        for w in range(store_windows):
            t = now + 2_000 * (w + 1)
            cols = window_columns(reqcols, rng, b"st_",
                                  rng.choice(pool, store_width), t)
            cols.behavior[rng.random(store_width) < 0.05] = 8  # RESET
            reqs = request_objects(types, cols)
            t0 = time.perf_counter()
            got = eng.process(reqs, t)
            store_s.append(time.perf_counter() - t0)
            assert answers(got) == answers(ref.process(reqs, t)), (
                f"store window {w}")
    assert eng.store.log == ref.store.log, "Store call sequences differ"
    assert eng.store.data == ref.store.data
    ops = [op for op, *_ in eng.store.log]
    out["store"] = {"windows": store_windows, "width": store_width,
                    "window_s": store_s,
                    "calls": {op: ops.count(op) for op in sorted(set(ops))},
                    "launches": launches["store"]}
    assert {"get", "on_change", "remove"} <= set(ops)
    assert guard_rows_zero(eng)
    del eng, ref

    # Export -> load: a mesh holding round_trip_per_shard live keys a
    # shard (keys picked by their route), its items loaded into a fresh
    # mesh and into the CPU mesh.
    src = pair(local_capacity, dev)
    per = round_trip_per_shard
    cand = np.arange(int(per * n_shards * 1.1) + 4096)
    blob, off = key_blob(b"rt_", cand)
    sh = (crc32_batch(blob, off) % np.uint32(n_shards)).astype(np.int64)
    rids = np.sort(np.concatenate([cand[sh == s][:per]
                                   for s in range(n_shards)]))
    assert len(rids) == per * n_shards
    t0 = time.perf_counter()
    for a in range(0, len(rids), width):
        mat, errs = src.process_columns(window_columns(
            reqcols, rng, b"rt_", rids[a:a + width], now, prefill=True), now)
        assert not errs
    out["round_trip_prefill_s"] = time.perf_counter() - t0
    with counted(torch, launches, "export", widths):
        t0 = time.perf_counter()
        items = src.export_items()
        out["export_s"] = time.perf_counter() - t0
    assert len(items) == len(rids)
    assert launches["export"]["gather_rows"] == -(-len(rids) // STATE_CHUNK)
    del src
    dst = pair(local_capacity, dev)
    with counted(torch, launches, "load", widths):
        t0 = time.perf_counter()
        dst.load_items(items, now + 1_000)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
    got = launches["load"]
    assert got["scatter_rows"] == -(-len(rids) // STATE_CHUNK), got
    assert sum(got.values()) == got["scatter_rows"], got
    ref = pair(ref_local_capacity, "cpu")
    ref.load_items(items, now + 1_000)
    back = dst.export_items()
    assert back == items, "card mesh export after load differs"
    assert ref.export_items() == items, "CPU mesh export after load differs"
    assert guard_rows_zero(dst)
    out["round_trip"] = {"items": len(items), "launches_export":
                         launches["export"], "launches_load": got}
    return out


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
        ea = a.export_columns()
        assert_same_export(ea, b.export_columns())
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
    the table: hot, cold and SSD); top-up windows of keys outside it until
    the free slots are under the reclaim watermark; ``windows`` churn windows of distinct
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
        # The churn must evict.  A sync reclaim late in the prefill frees
        # capacity // 16 slots, more than the churn's promotions take, so
        # fresh keys outside the working set bring the free count under
        # the reclaim watermark first.  The churn starts with at most
        # 2 * _reclaim_low free slots (a background round's refill) and
        # its promotions cross the watermark again.
        fill = 0
        with counted(torch, launches, "top_up", widths):
            while eng.capacity - len(eng.slots) >= eng._reclaim_low:
                ids = np.arange(ws + fill * width, ws + (fill + 1) * width)
                mat, errs = eng.process_columns(
                    token_columns(reqcols, b"w", ids), now + 1)
                assert not errs and (mat[2] == TOKEN_LIMIT - 1).all()
                fill += 1
        info["top_up_windows"] = fill
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



# ----------------------------------------------------------------------
# Phase 6: serving (the bench.py serve_loopback_10m rung, in process)
# ----------------------------------------------------------------------
SERVE_BATCH = 1000          # types.MAX_BATCH_SIZE: one GetRateLimits call
SERVE_LIMIT = 1_000_000
SERVE_DURATION = 3_600_000
SERVE_PAYLOADS = 16
GLOBAL_BIT = 2
# Phase 8 (quota leases on phase 6's node).
LEASE_KEYS = 16384
LEASE_CALL = 4096        # specs a grant or sync call: a gateway's batch
LEASE_WANTS = (32, 64)   # the first lease's budget, the renewal's
LEASE_ADMITS = 64        # local admissions a key a holder
LEASE_TTL = "600s"       # GUBER_LEASE_TTL: no lease expires mid-phase
WIRE_KEYS = 256
WIRE_ADMITS = 8
LEASE_SECRET = b"chip-smoke-lease"
SEQUENCE_SLOTS = 1 << 14


def serve_columns(reqcols, name: bytes, ids, hits=1, algorithm=0,
                  limit=SERVE_LIMIT, duration=SERVE_DURATION,
                  behavior=0, burst=0, created_at=None):
    """Requests on keys ``name_<8 digits>`` as a wire client builds them
    (``name_len`` set, so ``fastwire.encode_req`` can frame them); each
    field a scalar or a column."""
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    blob, offsets = key_blob(name + b"_", ids)

    def col(v):
        return np.broadcast_to(np.asarray(v, np.int64), (n,)).copy()

    created = (np.full(n, reqcols.CREATED_UNSET, np.int64)
               if created_at is None else col(created_at))
    return reqcols.ReqColumns(
        blob, offsets, col(hits), col(limit), col(duration), col(algorithm),
        col(behavior), created, col(burst), name_len=col(len(name)))


def mixed_serve_batch(reqcols, rng, n: int, keys: int, now: int):
    """A batch of the bit-for-bit check: Zipf(1.2) keys, all five
    algorithms, RESET and DRAIN rows, explicit created_at."""
    ids = np.minimum(rng.zipf(1.2, n) - 1, keys - 1)
    pairs = np.array([(30_000, 10), (60_000, 1000), (1_000, 4), (1_000, 3),
                      (900, 7), (3_600_000, 1000), (5_000, 5)], np.int64)
    dl = pairs[rng.integers(0, len(pairs), n)]
    behavior = rng.choice([0, 0, 0, 8, 32], n)
    return serve_columns(
        reqcols, b"mix", ids, hits=rng.choice([0, 1, 1, 2, 5, -1], n),
        algorithm=ids % 5, limit=dl[:, 1], duration=dl[:, 0],
        behavior=behavior, burst=rng.choice([0, 0, 20], n),
        created_at=now - rng.integers(0, 3_000, n))


def serve_phase(torch, dev, keys=10_000_000, window=4096, serial=150,
                callers=32, batches=96, segments=4, probe=4096, hot=64,
                small=1 << 16, small_batches=64, small_width=200,
                lease_keys=LEASE_KEYS):
    """The port's serving path on the card, in process: one ``V1Instance``
    over a prefilled ``keys``-key ``TickEngine`` with ``window``-wide
    ticks and 48 ingest slabs; 1000-request wire batches parsed by the
    native codec into arena slabs, ticked through the tick loop, written
    back by the codec.  Traffic A (uniform keys) and B (Zipf(1.2)): serial
    round trips and ``callers`` concurrent callers; a flight-recorder
    segment; each key's count checked around traffic B; a small card
    instance against a CPU one, bit for bit; and the daemon over gRPC
    and HTTP where those packages are installed.  Phase 8 runs on the same
    node before it closes (``lease_node`` over ``lease_keys`` keys), over
    the daemon's gRPC (``lease_wire``) and as the card-against-CPU
    ``lease_sequence``.  Returns ``(info, launches summed over the
    phase's paths, phase 8's info, its launches)``."""
    import asyncio

    return asyncio.run(_serve(torch, dev, keys, window, serial, callers,
                              batches, segments, probe, hot, small,
                              small_batches, small_width, lease_keys))


@contextlib.contextmanager
def env_knobs(**knobs):
    """Set ``GUBER_*`` environment knobs for the block, restoring them
    after."""
    prev = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


async def _serve(torch, dev, keys, window, serial, callers, batches,
                 segments, probe, hot, small, small_batches, small_width,
                 lease_keys):
    import asyncio

    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.ops.engine import TickEngine, resolve_ticks
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.transport import fastwire
    from gubernator_tpu_torch.utils import flightrec

    rng = np.random.default_rng(SEED + 7)
    info, launches, widths = {}, {}, {}

    def path(name):
        return counted(torch, launches, name, widths)

    # The table: every key the traffic sends, mixed token and leaky
    # (the rung's prefill), one-hour buckets of a million.  Background
    # reclaim (on by default at this size) keeps capacity // 64 slots
    # free, evicting live keys to do so: the table is sized with that
    # headroom above the keys, as a deployment would size it, so every
    # key stays resident and no window reclaims.
    capacity = keys + max(keys // 63, 2 * window) + 64
    eng = TickEngine(capacity=capacity, max_batch=window, device=dev)
    info["capacity"] = capacity
    t0 = time.perf_counter()
    with path("serve_prefill"):
        pending = []
        for s in range(0, keys, window):
            ids = np.arange(s, min(s + window, keys))
            pending.append((eng.submit_cols(serve_columns(
                reqcols, b"bench", ids, algorithm=ids & 1)), len(ids)))
            if len(pending) == 16 or s + window >= keys:
                resolve_ticks([h for b, _ in pending for h in b.handles()])
                for b, n in pending:
                    mat, errs = b.matrix()
                    assert not errs and (mat[2] == SERVE_LIMIT - 1).all()
                pending = []
    info["prefill_s"] = time.perf_counter() - t0
    assert len(eng.slots) == keys

    with env_knobs(GUBER_INGEST_ARENA_SLABS="48", GUBER_LEASE_TTL=LEASE_TTL):
        inst = await V1Instance.create(
            InstanceConfig(cache_size=capacity, tpu_max_batch=window),
            engine=eng)
    arena = inst.ingest_arena
    sent = {}

    async def serve(raw, tag):
        """One round trip through the V1 servicer's fast path: decode into
        an arena slab, the instance's columns path, encode, and the
        client's decode of the answer."""
        fr = flightrec.get()
        t1 = time.perf_counter()
        cols, errors, special = fastwire.parse_req(raw, arena)
        if fr is not None:
            fr.edge("decode", time.perf_counter() - t1)
        assert not errors and not special
        mat, errs = await inst.get_rate_limits_columns(cols)
        assert not errs and not mat[0].any()  # all under the limit
        t2 = time.perf_counter()
        out = fastwire.encode_resp(mat)
        if fr is not None:
            fr.edge("encode", time.perf_counter() - t2)
        back, _ = fastwire.parse_resp(out)
        assert back.shape == (4, SERVE_BATCH)
        sent[tag] = sent.get(tag, 0) + 1
        return out

    def payloads(draw):
        ids = [draw() for _ in range(SERVE_PAYLOADS)]
        raws = [fastwire.encode_req(serve_columns(reqcols, b"bench", i))
                for i in ids]
        return ids, raws

    async def traffic(name, raws, recorder=False):
        out = {}
        for j in range(3):  # warm
            await serve(raws[j], (name, j))
        lat = []
        for i in range(serial):
            t1 = time.perf_counter()
            await serve(raws[i % len(raws)], (name, i % len(raws)))
            lat.append((time.perf_counter() - t1) * 1e3)
        out["serial_p50_ms"] = float(np.percentile(lat, 50))
        out["serial_p99_ms"] = float(np.percentile(lat, 99))
        out["serial_max_ms"] = float(max(lat))
        sem = asyncio.Semaphore(callers)

        async def one(i):
            async with sem:
                await serve(raws[i % len(raws)], (name, i % len(raws)))

        async def segment():
            s0 = time.perf_counter()
            await asyncio.gather(*(one(i) for i in range(batches)))
            return batches * SERVE_BATCH / (time.perf_counter() - s0)

        await asyncio.gather(*(one(i) for i in range(callers)))  # warm
        w0, o0 = eng.metric_h2d_windows, eng.metric_h2d_overlapped
        rates = [await segment() for _ in range(segments)]
        core = sorted(rates)[1:-1]  # middle segments
        out["decisions_per_s"] = float(np.median(core))
        out["segments_decisions_per_s"] = rates
        w = eng.metric_h2d_windows - w0
        out["windows"] = w
        out["h2d_overlap_ratio"] = (
            (eng.metric_h2d_overlapped - o0) / max(1, w))
        if recorder:
            rec = flightrec.FlightRecorder(windows=512)
            flightrec.install(rec)
            try:
                await asyncio.gather(*(one(i) for i in range(callers)))
                out["recorded_decisions_per_s"] = await segment()
                out["stage_ms"] = {
                    s: p for s, p in rec.stage_percentiles().items()
                    if p["p99_ms"] > 0}
            finally:
                flightrec.uninstall()
        return out

    async def probe_remaining(ids):
        rem = np.empty(len(ids), np.int64)
        for s in range(0, len(ids), SERVE_BATCH):
            mat, errs = await inst.get_rate_limits_columns(serve_columns(
                reqcols, b"bench", ids[s:s + SERVE_BATCH], hits=0))
            assert not errs
            rem[s:s + SERVE_BATCH] = mat[2]
        return rem

    a_ids, a_raws = payloads(lambda: rng.integers(0, keys, SERVE_BATCH))
    with path("serve_uniform"):
        info["uniform"] = await traffic("A", a_raws, recorder=True)

    b_ids, b_raws = payloads(
        lambda: np.minimum(rng.zipf(1.2, SERVE_BATCH) - 1, keys - 1))
    # Probed keys: the hottest, keys the Zipf payloads send, random keys.
    sent_b = np.unique(np.concatenate(b_ids))
    rest = np.setdiff1d(sent_b, np.arange(hot))
    probe_ids = np.concatenate([
        np.arange(hot),
        rng.choice(rest, min(len(rest), (probe - hot) // 2), replace=False)])
    fill = np.setdiff1d(rng.integers(0, keys, probe), probe_ids)
    probe_ids = np.concatenate([probe_ids, fill[:probe - len(probe_ids)]])
    with path("serve_zipf"):
        before = await probe_remaining(probe_ids)
        info["zipf"] = await traffic("B", b_raws)
        after = await probe_remaining(probe_ids)
    pos = {int(k): i for i, k in enumerate(probe_ids)}
    want = np.zeros(len(probe_ids), np.int64)
    for j, ids in enumerate(b_ids):
        times = sent.get(("B", j), 0)
        for k in ids:
            i = pos.get(int(k))
            if i is not None:
                want[i] += times
    info["exact"] = {
        "probed_keys": int(len(probe_ids)),
        "probed_hits": int(want.sum()),
        "hottest_key_hits": int(want[0]),
        "mismatches": int(np.count_nonzero(before - after != want)),
    }
    assert info["exact"]["mismatches"] == 0, info["exact"]
    # Codec and arena CPU of one batch (the device does not run).
    zero = np.zeros((5, SERVE_BATCH), np.int64)
    zero[1], zero[2] = SERVE_LIMIT, SERVE_LIMIT - 1
    zero[3] = NOW + SERVE_DURATION
    best = 1e9
    for _ in range(7):
        c0 = time.perf_counter()
        cols, _, _ = fastwire.parse_req(a_raws[0], arena)
        fastwire.encode_resp(zero)
        best = min(best, time.perf_counter() - c0)
        cols.release()
    info["serve_cpu_ms_per_batch"] = best * 1e3
    info["reclaims"] = eng.metric_bg_reclaims + eng.metric_sync_reclaims
    assert info["reclaims"] == 0 and len(eng.slots) == keys
    info["arena"] = {"slabs": arena.n_slabs, "leases": arena.metric_leases,
                     "misses": arena.metric_misses,
                     "fallbacks": arena.metric_fallbacks,
                     "in_use_after": arena.in_use()}
    # Phase 8 on this node: token-bucket keys no traffic above touched.
    touched = np.concatenate(a_ids + b_ids + [probe_ids])
    pick = rng.choice(keys // 2, 4 * lease_keys, replace=False) * 2
    lease_ids = np.setdiff1d(pick, touched)[:lease_keys]
    assert len(lease_ids) == lease_keys
    leases = {}
    with path("lease_node"):
        leases["node"] = await lease_node(torch, inst, eng, lease_ids,
                                          probe_remaining)
    assert launches["lease_node"]["lease_apply"] == \
        leases["node"]["lease_windows"], launches["lease_node"]
    assert launches["lease_node"]["fused_tick"] > 0
    await inst.close()
    assert arena.in_use() == 0
    del eng, inst

    with path("serve_bitwise"):
        info["bitwise"] = await bitwise_instances(
            torch, small, window, small_batches, small_width)
    info["daemon"], leases["wire"] = await daemon_check(
        small, window, small_width, path)
    with path("lease_compare"):
        leases["card_vs_cpu"] = lease_compare(torch, dev)
    phases = []
    for tag, out in ((False, info), (True, leases)):
        per = {k: v for k, v in launches.items()
               if k.startswith("lease_") == tag}
        out["launches_by_path"] = per
        out["launches_by_width"] = {k: widths[k] for k in per}
        total = {}
        for counts in per.values():
            for name, c in counts.items():
                total[name] = total.get(name, 0) + c
        phases += [out, total]
    assert phases[1]["fused_tick"] > 0, "no fused_tick launch in phase 6"
    assert phases[3]["lease_apply"] > 0, "no lease_apply launch in phase 8"
    return tuple(phases)


def lease_compare(torch, dev) -> dict:
    """``lease_sequence`` on a SEQUENCE_SLOTS-slot card engine and on the
    same engine on the CPU: tokens, acks, stats, lease columns, probes
    and the exported tables must be equal."""
    from gubernator_tpu_torch import leases, types
    from gubernator_tpu_torch.ops.engine import TickEngine
    from gubernator_tpu_torch.resilience import ManualClock

    runs, snaps = [], []
    for d in (dev, torch.device("cpu")):
        eng = TickEngine(capacity=SEQUENCE_SLOTS, max_batch=64, device=d)
        runs.append(lease_sequence(leases, types, eng, ManualClock, NOW))
        snaps.append(eng.export_columns())
    assert runs[0] == runs[1], (runs[0], runs[1])
    assert_same_export(*snaps)
    return {"equal": True, "grant_calls": len(runs[0]["grants"]),
            "sync_calls": len(runs[0]["acks"]), "stats": runs[0]["stats"],
            "lease_windows": runs[0]["windows"][0],
            "exported_items": len(snaps[0]["key_offsets"]) - 1}


async def _answer_raw(inst, raw):
    """An instance's answer to raw request bytes, as the servicer's fast
    path writes it."""
    from gubernator_tpu_torch.transport import fastwire

    cols, errors, special = fastwire.parse_req(raw)
    assert not errors and not special
    mat, errs = await inst.get_rate_limits_columns(cols)
    assert not errs
    return fastwire.encode_resp(mat)


@contextlib.contextmanager
def pinned_clock(start: int):
    """The port's wall clock (``timeutil.now_ms``), moved only by hand:
    two instances fed the same batches tick at the same ``now``."""
    from gubernator_tpu_torch.utils import timeutil

    clock = [start]
    real = timeutil.now_ms
    timeutil.now_ms = lambda: clock[0]
    try:
        yield clock
    finally:
        timeutil.now_ms = real


def global_requests(types, k: int, n: int = 16):
    return [types.RateLimitRequest(
        name="glob", unique_key=f"g{k}_{i % 5}", hits=i % 3, limit=50,
        duration=3_600_000, algorithm=i % 2, behavior=GLOBAL_BIT)
        for i in range(n)]


async def bitwise_instances(torch, capacity, window, batches, width):
    """A ``capacity``-slot instance on the card and one on the CPU answer
    the same serial raw batches with the same bytes (and the same
    GLOBAL object answers)."""
    from gubernator_tpu_torch import types
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.transport import fastwire

    rng = np.random.default_rng(SEED + 8)
    checked = 0
    with pinned_clock(NOW) as clock:
        card = await V1Instance.create(InstanceConfig(
            cache_size=capacity, tpu_max_batch=window))
        cpu = await V1Instance.create(InstanceConfig(
            cache_size=capacity, tpu_max_batch=window, tpu_platform="cpu"))
        try:
            for k in range(batches):
                clock[0] = NOW + 1_000 * k
                raw = fastwire.encode_req(mixed_serve_batch(
                    reqcols, rng, width, 4096, clock[0]))
                a = await _answer_raw(card, raw)
                b = await _answer_raw(cpu, raw)
                assert a == b, f"batch {k}: card and CPU bytes differ"
                checked += width
                if k % 8 == 7:
                    ga = await card.get_rate_limits(
                        global_requests(types, k))
                    gb = await cpu.get_rate_limits(
                        global_requests(types, k))
                    assert [vars(r) for r in ga] == [vars(r) for r in gb]
                    checked += len(ga)
            routes = {f: getattr(card.engine, f"metric_{f}_ticks")
                      for f in ("grouped", "layered", "sorted")}
        finally:
            await card.close()
            await cpu.close()
    return {"batches": batches, "width": width, "items_equal": checked,
            "card_duplicate_routes": routes}


async def daemon_check(capacity, window, width, path):
    """``spawn_daemon`` on 127.0.0.1:0 answers raw batches over gRPC and
    one JSON batch over HTTP as an in-process CPU instance answers them
    (path ``serve_daemon``), then serves phase 8's ``lease_wire`` (path
    ``lease_wire``); a missing package is named, not caught.  Returns
    the two paths' results."""
    import importlib.util

    missing = [m for m in ("grpc", "aiohttp", "google.protobuf")
               if importlib.util.find_spec(m.split(".")[0]) is None]
    if missing:
        raise RuntimeError(f"the daemon needs {missing}")
    import asyncio
    import urllib.request

    from google.protobuf import json_format

    from gubernator_tpu_torch import config, types
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.pb import gubernator_pb2 as pb
    from gubernator_tpu_torch.service.instance import (
        InstanceConfig, V1Instance)
    from gubernator_tpu_torch.transport import convert, fastwire
    from gubernator_tpu_torch.transport.daemon import spawn_daemon

    rng = np.random.default_rng(SEED + 9)
    out = {"grpc_batches": 0}
    with pinned_clock(NOW) as clock:
        d = await spawn_daemon(config.DaemonConfig(
            grpc_listen_address="127.0.0.1:0",
            http_listen_address="127.0.0.1:0",
            config=config.Config(cache_size=capacity, tpu_max_batch=window)))
        ref = await V1Instance.create(InstanceConfig(
            cache_size=capacity, tpu_max_batch=window, tpu_platform="cpu"))
        client = d.client()
        try:
            with path("serve_daemon"):
                for k in range(4):
                    clock[0] = NOW + 1_000 * k
                    raw = fastwire.encode_req(mixed_serve_batch(
                        reqcols, rng, width, 4096, clock[0]))
                    got = await client.get_rate_limits_raw(raw)
                    assert got == await _answer_raw(ref, raw), k
                    out["grpc_batches"] += 1
                reqs = global_requests(types, 99, 8) + [
                    types.RateLimitRequest(name="http", unique_key=f"h{i}",
                                           hits=1, limit=10, duration=60_000)
                    for i in range(4)]
                body = json.dumps({"requests": [
                    json_format.MessageToDict(
                        convert.req_to_pb(r), preserving_proto_field_name=True)
                    for r in reqs]}).encode()
                url = f"http://{d.conf.http_listen_address}/v1/GetRateLimits"

                def post():
                    req = urllib.request.Request(url, data=body,
                                                 method="POST")
                    with urllib.request.urlopen(req, timeout=60) as r:
                        return json.loads(r.read())

                got = await asyncio.to_thread(post)
                want = json_format.MessageToDict(
                    pb.GetRateLimitsResp(responses=convert.resps_to_pb(
                        await ref.get_rate_limits(reqs))),
                    preserving_proto_field_name=True,
                    always_print_fields_with_no_presence=True)
                assert got == want
                out["http_items"] = len(reqs)
                health = await client.health_check()
                out["health"] = [health.status, health.peer_count]
            with path("lease_wire"):
                wire = await lease_wire(d)
        finally:
            await client.close()
            await d.close()
            await ref.close()
    return out, wire


# ----------------------------------------------------------------------
# Phase 8: quota leases on phase 6's node
# ----------------------------------------------------------------------


class _Pressure:
    """A tick loop stand-in that only answers ``under_pressure``."""

    pressured = False

    def under_pressure(self) -> bool:
        return self.pressured


class _ShedEngine:
    """An engine whose every decision is a retriable shed answer."""

    def __init__(self, response_cls):
        self.response_cls = response_cls

    def process(self, reqs, now=None):
        return [self.response_cls(error="request shed: tick loop shutting "
                                        "down") for _ in reqs]


def lease_sequence(leases, types, eng, clock, now: int) -> dict:
    """The seeded edge-case lease sequence: a ``leases.LeaseManager``
    (HMAC, fixed secret) over ``eng`` through ``grant_local`` /
    ``sync_local`` at virtual ``now``: two holders on one key in one
    window, credit-back on release, excess force-charged, a stale
    generation, a holder the key never delegated to, a config change
    bumping the generation, ``revoke``, the generation monotonic across
    release and regrant, pressure degrading a renewal to cheap
    extension, an expired slice reconciled, excess on a key with no
    config dropped, a shed credit-back counted and a force-charge that
    bounces off an empty bucket.  ``leases``, ``types`` and ``clock`` (a
    ManualClock class) are one package's, the port's or in the CPU tests
    the JAX package's.  Returns plain values: tokens, acks, ``stats()``,
    the lease columns, hits=0 probes of every key and the engine's lease
    window counters."""
    L = leases
    clk = clock(start=now / 1000)
    loop = _Pressure()
    mgr = L.LeaseManager(
        eng, tick_loop=loop,
        config=L.LeaseConfig(ttl_ms=5_000, secret=LEASE_SECRET),
        signer=L.LeaseSigner(secret=LEASE_SECRET), clock=clk)
    t = {"now": now}
    out = {"grants": [], "acks": []}

    def spec(key, want, holder="A", limit=1_000):
        return L.LeaseSpec(name="lease_t", key=key, limit=limit,
                           duration=60_000, want=want, holder=holder)

    def grant(*specs):
        toks = mgr.grant_local(list(specs), now_ms=t["now"])
        out["grants"].append([
            None if x is None else (x.name, x.key, x.budget, x.expires_ms,
                                    x.generation, x.signature.hex())
            for x in toks])
        return toks

    def sync(*items):  # (key, consumed, generation, release, holder)
        acks = mgr.sync_local([
            L.LeaseSync(name="lease_t", key=k, consumed=c, generation=g,
                        release=r, holder=h) for k, c, g, r, h in items],
            now_ms=t["now"])
        out["acks"].append([(a.accepted, a.generation, a.credited, a.charged)
                            for a in acks])

    def advance(ms):
        t["now"] += ms
        clk.advance(ms / 1000)

    ta, tb = grant(spec("k1", 20, "A"), spec("k1", 30, "B"))
    sync(("k1", 5, ta.generation, True, "A"))
    sync(("k1", 40, tb.generation, True, "B"))
    [t2] = grant(spec("k2", 10))
    sync(("k2", 3, t2.generation + 5, False, "A"),
         ("k2", 2, t2.generation, False, "Z"))
    grant(spec("k2", 10, limit=500))
    sync(("k2", 4, t2.generation, False, "A"))
    [t3] = grant(spec("k3", 7))
    out["revoked"] = [mgr.revoke("lease_t", "k3"),
                      mgr.revoke("lease_t", "none")]
    sync(("k3", 2, t3.generation, True, "A"))
    [t4] = grant(spec("k4", 9))
    sync(("k4", 9, t4.generation, True, "A"))
    grant(spec("k4", 9))
    sync(("k4", 1, t4.generation, False, "A"))
    [t5] = grant(spec("k5", 25))
    loop.pressured = True
    advance(2_000)
    grant(spec("k5", 25), spec("k6", 10))
    loop.pressured = False
    advance(6_000)
    sync(("k5", 3, t5.generation, False, "A"))
    sync(("none", 4, 1, False, "A"))
    [t7] = grant(spec("k7", 15))
    mgr.engine = _ShedEngine(types.RateLimitResponse)
    sync(("k7", 5, t7.generation, True, "A"))
    mgr.engine = eng
    [t8] = grant(spec("k8", 10))
    eng.process([types.RateLimitRequest(
        name="lease_t", unique_key="k8", hits=990, limit=1_000,
        duration=60_000)], now=t["now"])
    sync(("k8", 25, t8.generation, True, "A"))
    keys = [f"k{i}" for i in range(1, 9)]
    out["stats"] = mgr.stats()
    out["columns"] = [np.asarray(c).tolist() for c in eng.lease_columns(
        [f"lease_t_{k}".encode() for k in keys])]
    probes = eng.process([types.RateLimitRequest(
        name="lease_t", unique_key=k, hits=0,
        limit=500 if k == "k2" else 1_000, duration=60_000) for k in keys],
        now=t["now"])
    out["probes"] = [(int(r.status), r.limit, r.remaining, r.reset_time)
                     for r in probes]
    out["windows"] = [eng.metric_lease_windows, eng.metric_lease_ops,
                      eng.metric_lease_dispatches]
    return out


async def lease_node(torch, inst, eng, ids, probe) -> dict:
    """Phase 8 on phase 6's node: two holders (LeaseCaches with their own
    ids, as two gateways) lease the token-bucket keys ``ids``: a grant
    round (LEASE_CALL specs a call, want LEASE_WANTS[0]), LEASE_ADMITS
    local admissions a key until the lease runs out, one batched renewal
    (``take_syncs`` + ``lease_sync``, then grants of LEASE_WANTS[1]), the
    rest of the admissions and a release round that credits the unused
    budget back.  ``probe(ids)`` reads the keys' remaining with hits=0
    before and after.  Asserts no over-admission, no drift, one
    ``lease_apply`` launch a lease window (read by the caller), nothing
    outstanding after release and no sync loss or drop."""
    from gubernator_tpu_torch.leases import ADMIT, LeaseCache, LeaseSpec

    mgr = inst.lease_mgr
    specs = [LeaseSpec(name="bench", key=f"{int(i):08d}", limit=SERVE_LIMIT,
                       duration=SERVE_DURATION) for i in ids]
    holders = ("gateway-a", "gateway-b")
    caches = [LeaseCache(verifier=mgr.verifier(), want_budget=LEASE_WANTS[0],
                         holder_id=h) for h in holders]
    n = len(specs)
    granted = np.zeros((len(caches), n), np.int64)
    admitted = np.zeros((len(caches), n), np.int64)
    items = {"grant": 0, "sync": 0}
    seconds = {"grant_rounds": [], "sync_rounds": [], "release_rounds": [],
               "admit_s": 0.0}
    credited = 0
    w0 = (eng.metric_lease_windows, eng.metric_lease_dispatches)
    m0 = (mgr.metric_sync_loss, mgr.metric_sync_dropped)
    before = await probe(ids)

    async def grant_round(k, cache):
        t0 = time.perf_counter()
        for s in range(0, n, LEASE_CALL):
            part = [cache.fill_want(sp) for sp in specs[s:s + LEASE_CALL]]
            toks = await inst.lease_grant(part)
            items["grant"] += len(part)
            for j, (sp, tok) in enumerate(zip(part, toks)):
                assert cache.note_grant(sp, tok), f"grant declined: {sp}"
                granted[k, s + j] += tok.budget
        seconds["grant_rounds"].append(time.perf_counter() - t0)

    async def sync_round(cache, release):
        nonlocal credited
        t0 = time.perf_counter()
        syncs = cache.take_syncs(release=release)
        for s in range(0, len(syncs), LEASE_CALL):
            part = syncs[s:s + LEASE_CALL]
            acks = await inst.lease_sync(part)
            items["sync"] += len(part)
            assert all(a.accepted and not a.charged for a in acks)
            credited += sum(a.credited for a in acks)
            cache.note_synced(part, acks)
        key = "release_rounds" if release else "sync_rounds"
        seconds[key].append(time.perf_counter() - t0)

    def admit(k, cache):
        t0 = time.perf_counter()
        for j, sp in enumerate(specs):
            while admitted[k, j] < LEASE_ADMITS:
                if cache.try_admit(sp) != ADMIT:
                    break
                admitted[k, j] += 1
        seconds["admit_s"] += time.perf_counter() - t0

    for k, cache in enumerate(caches):
        await grant_round(k, cache)
        admit(k, cache)
        assert (admitted[k] == LEASE_WANTS[0]).all()  # ran out once
        await sync_round(cache, release=False)
        cache.want_budget = LEASE_WANTS[1]
        await grant_round(k, cache)
        admit(k, cache)
        assert (admitted[k] == LEASE_ADMITS).all()
        await sync_round(cache, release=True)
        assert cache.stats().leases == 0
    after = await probe(ids)
    keys = [sp.full_key.encode() for sp in specs]
    budget, _, _ = eng.lease_columns(keys)
    windows = eng.metric_lease_windows - w0[0]
    info = {
        "keys": n, "holders": len(caches),
        "admissions": int(admitted.sum()), "granted": int(granted.sum()),
        "credited": int(credited),
        "over_admission": int(np.maximum(admitted - granted, 0).sum()),
        "drift_keys": int(np.count_nonzero(before - after
                                           != admitted.sum(axis=0))),
        "outstanding_after": int(np.abs(budget).sum()),
        "outstanding_total": mgr.stats()["outstanding_total"],
        "sync_loss": mgr.metric_sync_loss - m0[0],
        "sync_dropped": mgr.metric_sync_dropped - m0[1],
        "lease_windows": windows,
        "lease_dispatches": eng.metric_lease_dispatches - w0[1],
        "server_items": items,
        "lease_traffic_reduction": float(admitted.sum())
        / (items["grant"] + items["sync"]),
        "local_admissions_per_s": float(admitted.sum()) / seconds["admit_s"],
        **seconds,
    }
    assert info["over_admission"] == 0, info
    assert info["drift_keys"] == 0, info
    assert info["outstanding_after"] == 0 == info["outstanding_total"], info
    assert info["sync_loss"] == 0 == info["sync_dropped"], info
    assert info["lease_dispatches"] == windows > 0, info
    return info


def scrape_lease_grants(d) -> float:
    """``gubernator_tpu_lease_grants_total`` from the daemon's HTTP
    ``/metrics``."""
    import urllib.request

    url = f"http://{d.conf.http_listen_address}/metrics"
    with urllib.request.urlopen(url, timeout=60) as r:
        for line in r.read().decode().splitlines():
            if line.startswith("gubernator_tpu_lease_grants_total "):
                return float(line.split()[1])
    raise AssertionError("/metrics has no gubernator_tpu_lease_grants_total")


async def lease_wire(d, keys=WIRE_KEYS, admits=WIRE_ADMITS) -> dict:
    """A ``LeaseSession`` over the daemon ``d``'s ``DaemonClient``:
    ``admits`` admissions on each of ``keys`` keys cost one grant RPC a
    key, ``close()`` loses nothing, hits=0 probes read ``limit -
    admits``, and ``/metrics`` counts the grants."""
    import asyncio

    from gubernator_tpu_torch import types
    from gubernator_tpu_torch.client import LeaseSession
    from gubernator_tpu_torch.leases import LeaseSpec

    client = d.client()
    rpcs = {"grant": 0, "sync": 0}

    class Counting:
        async def lease_grant(self, specs):
            rpcs["grant"] += 1
            return await client.lease_grant(specs)

        async def lease_sync(self, syncs):
            rpcs["sync"] += 1
            return await client.lease_sync(syncs)

    limit = 100
    g0 = await asyncio.to_thread(scrape_lease_grants, d)
    sess = LeaseSession(Counting(), verifier=d.instance.lease_mgr.verifier(),
                        want_budget=admits)
    specs = [LeaseSpec(name="wire", key=spread_key(i), limit=limit,
                       duration=60_000) for i in range(keys)]
    t0 = time.perf_counter()
    try:
        for sp in specs:
            for _ in range(admits):
                assert await sess.admit(sp) is True
        lost = await sess.close()
        seconds = time.perf_counter() - t0
        probes = await client.get_rate_limits([types.RateLimitRequest(
            name="wire", unique_key=sp.key, hits=0, limit=limit,
            duration=60_000) for sp in specs])
    finally:
        await client.close()
    scraped = await asyncio.to_thread(scrape_lease_grants, d)
    out = {"keys": keys, "admissions": keys * admits, "lost": lost,
           "grant_rpcs": rpcs["grant"], "sync_rpcs": rpcs["sync"],
           "session_grants": sess.stats().grants,
           "probe_mismatches": sum(r.remaining != limit - admits
                                   for r in probes),
           "metrics_lease_grants": scraped, "seconds": seconds}
    assert lost == 0 and out["probe_mismatches"] == 0, out
    assert rpcs["grant"] == keys == out["session_grants"], out
    assert scraped - g0 == keys, out
    return out


# ----------------------------------------------------------------------
# Phase 7: a 4-node cluster on one card (the reference's docker-compose)
# ----------------------------------------------------------------------
CLUSTER_NODES = 4
CLUSTER_KEYS = 4_000_000
CLUSTER_CAPACITY = 1 << 21
GLOBAL_KEYS = 1024
BATCH_TIMEOUT_S = 10.0  # GUBER_BATCH_TIMEOUT in phase 7 (reference 0.5 s)
# (duration, limit) pairs whose leak over 1000 ms steps is whole tokens
# (the JAX engine's triple-float32 leak rounds like float64 only there,
# ROADMAP C.1): the cluster comparison runs against the JAX package too.
WHOLE_DL = [(1_000, 4), (4_096, 1 << 12), (5_000, 5), (1_000, 1), (0, 10),
            (10_000, 10)]


def spread_key(i: int) -> str:
    """Key ``i`` of a set spread over the hash ring: FNV-1 mixes a short
    key's early bytes little, so keys that share a prefix and differ only
    at the end sit next to each other on the ring."""
    import hashlib

    return hashlib.md5(str(i).encode()).hexdigest()[:12]


def cluster_plain_items(rng) -> list:
    """A batch of unique keys: all five algorithms, RESET / DRAIN rows,
    negative hits and invalid items (field dicts)."""
    keys = rng.choice(40, size=int(rng.integers(4, 24)), replace=False)
    out = []
    for kk in keys:
        d, lim = WHOLE_DL[int(rng.integers(0, len(WHOLE_DL)))]
        f = dict(name="p", unique_key=spread_key(int(kk)),
                 hits=int(rng.choice([0, 1, 1, 2, 5, -1])), limit=lim,
                 duration=d, algorithm=int(rng.integers(0, 5)),
                 behavior=int(rng.choice([0, 0, 0, 8, 32])),
                 burst=int(rng.choice([0, 0, 20])))
        if rng.random() < 0.1:
            bad = [{"name": ""}, {"unique_key": ""}, {"algorithm": 7},
                   {"behavior": 16}]
            f.update(bad[int(rng.integers(0, len(bad)))])
        out.append(f)
    return out


def cluster_global_items(rng) -> list:
    """GLOBAL token and leaky items on unique keys, with negative hits,
    RESET and hits over the limit, each with the role of the node it is
    sent to (0: the key's owner, 1 and 2: non-owners)."""
    keys = rng.choice(8, size=int(rng.integers(1, 5)), replace=False)
    out = []
    for kk in keys:
        algo = int(kk % 2)  # each key keeps one algorithm
        f = dict(name="g", unique_key=spread_key(100 + int(kk)),
                 hits=int(rng.choice([1, 2, 3, -1, 7, 0])), limit=10,
                 duration=10_000 if algo else 3_600_000, algorithm=algo,
                 behavior=GLOBAL_BIT | int(rng.choice([0, 0, 0, 0, 8])))
        out.append((int(rng.integers(0, 3)), f))
    return out


def role_daemon(c, name: str, key: str, role: int):
    owner = c.find_owning_daemon(name, key)
    if role == 0:
        return owner
    return c.list_non_owning_daemons(name, key)[role - 1]


def strip_owner(resps) -> list:
    """Responses as dicts without the ``owner`` metadata (two clusters on
    ephemeral ports place the ring differently)."""
    out = []
    for r in resps:
        v = dict(vars(r))
        v["metadata"] = {k: x for k, x in r.metadata.items() if k != "owner"}
        out.append(v)
    return out


def owner_rows(c) -> dict:
    """The union over a cluster's nodes of each key's exported row on its
    owner."""
    rows = {}
    for d in c.daemons:
        snap = d.instance.engine.export_columns()
        off = snap["key_offsets"]
        fields = sorted(f for f in snap
                        if f not in ("key_blob", "key_offsets"))
        cols = [np.asarray(snap[f]) for f in fields]
        for i in range(len(off) - 1):
            key = bytes(snap["key_blob"][off[i]:off[i + 1]])
            if d.instance.get_peer(key.decode()).info.is_owner:
                assert key not in rows, key
                rows[key] = tuple(col[i].item() for col in cols)
    return rows


def raw_batch(name: bytes, ids, hits=1, behavior=0, limit=SERVE_LIMIT):
    """Serialized GetRateLimitsReq of ``name_<8 digits>`` keys."""
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.transport import fastwire

    return fastwire.encode_req(serve_columns(
        reqcols, name, ids, hits=hits, behavior=behavior, limit=limit))


async def ask(d, raw):
    """One raw GetRateLimits round trip to daemon ``d``; every item must
    answer without an error."""
    from gubernator_tpu_torch.pb import gubernator_pb2 as pb

    client = d.client()
    try:
        out = await client.get_rate_limits_raw(raw, timeout=120)
    finally:
        await client.close()
    msg = pb.GetRateLimitsResp.FromString(out)
    assert not any(r.error for r in msg.responses), [
        r.error for r in msg.responses if r.error][:3]
    return msg.responses


async def global_round(c, rng, keys: int, batches: int,
                       limit=SERVE_LIMIT) -> dict:
    """``batches`` batches of 1000 GLOBAL hits on ``keys`` keys, spread
    round robin over the cluster's nodes; then, once every change reached
    every node, each owner's count must be the limit less the hits sent
    to the key, and every non-owner must answer as the owner does.  Key
    i is ``glob_<gid[i]>``: digits that all vary spread the keys over the
    ring (sequential ids differ only in their last bytes)."""
    n = len(c.daemons)
    gid = (np.arange(keys) * 2_654_435_761) % 10**8
    sent = np.zeros(keys, np.int64)
    for j in range(batches):
        ids = rng.integers(0, keys, SERVE_BATCH)
        np.add.at(sent, ids, 1)
        await ask(c.daemons[j % n], raw_batch(
            b"glob", gid[ids], behavior=GLOBAL_BIT, limit=limit))
    t_last = time.perf_counter()
    await c.wait_for_quiet(timeout=120)
    out = {"converge_ms": (time.perf_counter() - t_last) * 1e3}
    answers = []
    for d in c.daemons:
        rem = []
        for s in range(0, keys, SERVE_BATCH):
            rem += [(r.status, r.remaining, r.reset_time)
                    for r in await ask(d, raw_batch(
                        b"glob", gid[s:s + SERVE_BATCH], hits=0,
                        behavior=GLOBAL_BIT, limit=limit))]
        answers.append(rem)
    where = {d.conf.grpc_listen_address: k for k, d in enumerate(c.daemons)}
    inst = c.daemons[0].instance
    owner_of = [where[inst.get_peer(f"glob_{i:08d}").info.grpc_address]
                for i in gid]
    owner_errors = sum(answers[o][i][1] != limit - sent[i]
                       for i, o in enumerate(owner_of))
    copy_errors = sum(answers[k][i] != answers[o][i]
                      for i, o in enumerate(owner_of) for k in range(n))
    out.update(keys=keys, hits=int(sent.sum()),
               owners=np.bincount(owner_of, minlength=n).tolist(),
               owner_count_errors=int(owner_errors),
               non_owner_disagreements=int(copy_errors),
               broadcasts=[d.metrics.sample(
                   "gubernator_broadcast_duration_count")
                   for d in c.daemons])
    assert owner_errors == 0 and copy_errors == 0, out
    return out, gid, sent, owner_of


async def cluster_call(daemon, reqs, timeout=60.0):
    client = daemon.client()
    try:
        return await client.get_rate_limits(reqs, timeout=timeout)
    finally:
        await client.close()


async def drive_cluster(c, make, seed: int, clock, steps: int,
                        timeout: float = 60.0) -> list:
    """A seeded serial sequence through a 3- or 4-node cluster's gRPC
    edges under the pinned clock ``clock``: even steps a batch of plain
    items to one node, odd steps GLOBAL items each sent to the node of
    its role, then every GLOBAL change waited for (the non-owners'
    flushes, the owners' broadcasts).  ``make`` builds a request from a
    field dict, so the JAX package's cluster runs the same sequence.
    Returns every answer without its ``owner`` metadata."""
    import asyncio

    from gubernator_tpu_torch.cluster import wait_quiet

    rng = np.random.default_rng(seed)
    n = len(c.daemons)
    answers = []
    for k in range(steps):
        clock[0] = NOW + 1000 * k
        if k % 2 == 0:
            fields = cluster_plain_items(rng)
            answers.append(strip_owner(await cluster_call(
                c.daemons[k % n], [make(**f) for f in fields], timeout)))
            continue
        sends = cluster_global_items(rng)
        before = [c.metric_value(i, "gubernator_broadcast_duration_count")
                  for i in range(n)]
        got = await asyncio.gather(*(
            cluster_call(role_daemon(c, "g", f["unique_key"], role),
                         [make(**f)], timeout)
            for role, f in sends))
        answers.append([strip_owner(r) for r in got])
        await wait_quiet(c.daemons, timeout)
        for _, f in sends:
            if f["hits"] != 0:
                o = c.daemons.index(c.find_owning_daemon("g",
                                                         f["unique_key"]))
                await c.wait_for_broadcast(o, before[o] + 1, timeout)
    return answers


def cluster_phase(torch, dev, keys=CLUSTER_KEYS, capacity=CLUSTER_CAPACITY,
                  window=4096, serial=16, callers=32, per_caller=4,
                  global_keys=GLOBAL_KEYS, global_batches=16, small=1 << 14,
                  compare_steps=24):
    """The reference's 4-node development cluster on one card, in process
    over loopback gRPC (``cluster.Cluster``, static membership): A, the
    serial forwarding round trip; B, 32 concurrent callers over the four
    nodes; C, GLOBAL keys reconciled to exact counts on every node; D,
    node 3 leaving the ring (its GLOBAL keys handed over, its other keys
    fresh); E, a 4-node card cluster against a CPU one on a seeded
    sequence.  Returns ``(info, launches summed over the phase's
    paths)``."""
    import asyncio

    return asyncio.run(_cluster(torch, dev, keys, capacity, window, serial,
                                callers, per_caller, global_keys,
                                global_batches, small, compare_steps))


async def _cluster(torch, dev, keys, capacity, window, serial, callers,
                   per_caller, global_keys, global_batches, small,
                   compare_steps):
    import asyncio

    from gubernator_tpu_torch.cluster import Cluster
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.ops.engine import resolve_ticks

    rng = np.random.default_rng(SEED + 10)
    info, launches, widths = {"nodes": CLUSTER_NODES, "keys": keys,
                              "capacity": capacity,
                              "batch_timeout_s": BATCH_TIMEOUT_S}, {}, {}

    def path(name):
        return counted(torch, launches, name, widths)

    def sample(d, name, labels=None):
        return d.metrics.sample(name, labels)

    # The reference's defaults, but for the forwarded batch's deadline:
    # four nodes and every caller share one interpreter here, so a batch
    # waits behind the others' host work far longer than across machines.
    behaviors = BehaviorConfig(batch_timeout=BATCH_TIMEOUT_S)
    c = await Cluster.start(CLUSTER_NODES, cache_size=capacity,
                            tpu_max_batch=window, behaviors=behaviors)
    try:
        engines = [d.instance.engine for d in c.daemons]
        assert all(e.table.device.type == dev.type for e in engines)
        # Each key's owner on the ring (FNV-1 in Python, as the
        # reference hashes), then each node's share into its own engine.
        t0 = time.perf_counter()
        blob, _ = key_blob(b"bench_", np.arange(keys))
        width = len(b"bench_") + 8
        names = [blob[i * width:(i + 1) * width].decode()
                 for i in range(keys)]
        where = {d.conf.grpc_listen_address: n
                 for n, d in enumerate(c.daemons)}
        node_of = np.fromiter(
            (where[p.info.grpc_address]
             for p in c.daemons[0].instance.local_picker.get_batch(names)),
            np.int8, count=keys)
        del names, blob
        info["ring_lookup_s"] = time.perf_counter() - t0
        shares = np.bincount(node_of, minlength=CLUSTER_NODES)
        info["shares"] = shares.tolist()
        assert shares.max() <= capacity - capacity // 64, shares
        t0 = time.perf_counter()
        with path("prefill"):
            for n, eng in enumerate(engines):
                mine = np.flatnonzero(node_of == n)
                pending = []
                for s in range(0, len(mine), window):
                    ids = mine[s:s + window]
                    pending.append(eng.submit_cols(serve_columns(
                        reqcols, b"bench", ids, algorithm=ids & 1)))
                    if len(pending) == 16 or s + window >= len(mine):
                        resolve_ticks([h for b in pending
                                       for h in b.handles()])
                        for b in pending:
                            mat, errs = b.matrix()
                            assert not errs
                            assert (mat[2] == SERVE_LIMIT - 1).all()
                        pending = []
                assert len(eng.slots) == shares[n]
        info["prefill_s"] = time.perf_counter() - t0

        # A: serial forwarding round trips to node 0.
        raws = [raw_batch(b"bench", rng.integers(0, keys, SERVE_BATCH))
                for _ in range(SERVE_PAYLOADS)]
        d0 = c.daemons[0]

        def peer_rpcs():
            """Node 0's forwarded-batch RPCs (the peer clients' sends)."""
            return sum(sample(d0, "gubernator_batch_send_duration_count",
                              {"peerAddr": d.conf.grpc_listen_address})
                       for d in c.daemons[1:])

        fwd0 = sample(d0, "gubernator_getratelimit_counter_total",
                      {"calltype": "forward"})
        loc0 = sample(d0, "gubernator_getratelimit_counter_total",
                      {"calltype": "local"})
        with path("forward"):
            for raw in raws[:3]:  # warm: peer channels dialled
                await ask(d0, raw)
            lat = []
            rpcs0 = peer_rpcs()
            for i in range(serial):
                t1 = time.perf_counter()
                resp = await ask(d0, raws[i % len(raws)])
                lat.append((time.perf_counter() - t1) * 1e3)
                assert all(r.status == 0 and r.remaining < SERVE_LIMIT
                           for r in resp)
            forwarded = sample(d0, "gubernator_getratelimit_counter_total",
                               {"calltype": "forward"}) - fwd0
            local = sample(d0, "gubernator_getratelimit_counter_total",
                           {"calltype": "local"}) - loc0
            info["forward"] = {
                "serial_p50_ms": float(np.percentile(lat, 50)),
                "serial_p99_ms": float(np.percentile(lat, 99)),
                "serial_max_ms": float(max(lat)),
                "batches": serial + 3,
                "forwarded_items": forwarded, "local_items": local,
                "forwarded_share": forwarded / max(1.0, forwarded + local),
                "peer_rpcs_per_batch": (peer_rpcs() - rpcs0) / serial,
            }
            # B: concurrent callers, round robin over the nodes.
            w0 = [e.metric_h2d_windows for e in engines]
            t1 = time.perf_counter()

            async def caller(k):
                for j in range(per_caller):
                    await ask(c.daemons[k % CLUSTER_NODES],
                              raws[(k + j) % len(raws)])

            await asyncio.gather(*(caller(k) for k in range(callers)))
            dt = time.perf_counter() - t1
            info["throughput"] = {
                "callers": callers, "batches": callers * per_caller,
                "decisions_per_s": callers * per_caller * SERVE_BATCH / dt,
                "seconds": dt,
                "windows": [e.metric_h2d_windows - w
                            for e, w in zip(engines, w0)],
            }

        # C: GLOBAL keys, hits from every node, reconciled everywhere.
        glim = SERVE_LIMIT
        with path("global"):
            info_g, gid, sent, owner_of = await global_round(
                c, rng, global_keys, global_batches, glim)
        info_g["installs_by_scatter"] = launches["global"]["scatter_rows"]
        info["global"] = info_g
        info["global_converge_ms"] = info_g["converge_ms"]

        # D: node 3 leaves the ring, then closes.
        leaving = c.daemons[3]
        moved = [i for i, o in enumerate(owner_of) if o == 3]
        # Token keys (even ids): a leaky bucket refills between probes.
        token = np.arange(keys) % 2 == 0
        plain3 = rng.choice(np.flatnonzero((node_of == 3) & token),
                            min(1000, int(shares[3]) // 4), replace=False)
        kept = rng.choice(np.flatnonzero((node_of != 3) & token), 1000,
                          replace=False)
        before_kept = [r.remaining for r in await ask(
            d0, raw_batch(b"bench", kept, hits=0))]
        before3 = [r.remaining for r in await ask(
            d0, raw_batch(b"bench", plain3, hits=0))]
        assert max(before3) <= SERVE_LIMIT - 1
        with path("transfer"):
            t1 = time.perf_counter()
            rest = c.peers[:3]
            for d in c.daemons:
                d.set_peers(rest)
            await asyncio.wait_for(asyncio.gather(
                *leaving.instance._transfer_tasks), 120)
            transfer_s = time.perf_counter() - t1
            await leaving.close()
            c.daemons, c.peers = c.daemons[:3], rest
            await c.wait_for_quiet(timeout=120)
            after = [(r.status, r.remaining) for r in await ask(
                d0, raw_batch(b"glob", gid[moved], hits=0,
                              behavior=GLOBAL_BIT, limit=glim))]
            after3 = [r.remaining for r in await ask(
                d0, raw_batch(b"bench", plain3, hits=0))]
            after_kept = [r.remaining for r in await ask(
                d0, raw_batch(b"bench", kept, hits=0))]
        lost = sum(rem != glim - sent[i] for i, (_, rem) in zip(moved,
                                                                after))
        info["ring_change"] = {
            "transfer_s": transfer_s,
            "global_keys_moved": len(moved),
            "transferred": sample(leaving,
                                  "gubernator_tpu_ownership_transfers_total",
                                  {"result": "pushed"}),
            "global_count_errors": int(lost),
            "plain_keys_fresh": int(sum(r == SERVE_LIMIT for r in after3)),
            "plain_keys_checked": len(plain3),
            "kept_keys_unchanged": int(sum(
                a == b for a, b in zip(after_kept, before_kept))),
        }
        assert lost == 0 and len(moved) > 0, info["ring_change"]
        assert info["ring_change"]["transferred"] == len(moved)
        assert info["ring_change"]["plain_keys_fresh"] == len(plain3)
        assert info["ring_change"]["kept_keys_unchanged"] == len(kept)
        info["reclaims"] = [e.metric_bg_reclaims + e.metric_sync_reclaims
                            for e in engines]
        assert not any(info["reclaims"]), info["reclaims"]
    finally:
        await c.stop()
    del engines, c

    # E: a 4-node card cluster against a CPU one.
    with path("compare"):
        info["compare"] = await compare_clusters(small, window,
                                                 compare_steps)
    info["launches_by_path"] = launches
    info["launches_by_width"] = widths
    total = {}
    for per in launches.values():
        for name, n in per.items():
            total[name] = total.get(name, 0) + n
    assert total["fused_tick"] > 0, "no fused_tick launch in phase 7"
    assert total["scatter_rows"] > 0, "no scatter_rows launch in phase 7"
    return info, total


async def compare_clusters(capacity, window, steps, nodes=CLUSTER_NODES,
                           seed=SEED + 11):
    """Two ``nodes``-node clusters of ``capacity``-slot engines, one on the
    card and one on the CPU, answer the same seeded serial sequence under
    a pinned clock alike (apart from ``owner``), and the union of their
    owner-side rows is the same.  The forwarded batch's deadline is
    phase 7's: a retry after a deadline that passed while the owner was
    still ticking (its first kernel loads, say) applies the hits twice,
    as the reference's at-least-once forwarding does."""
    from gubernator_tpu_torch import types
    from gubernator_tpu_torch.cluster import Cluster
    from gubernator_tpu_torch.config import BehaviorConfig

    behaviors = BehaviorConfig(batch_timeout=BATCH_TIMEOUT_S,
                               global_sync_wait=0.02)
    out = {}
    with pinned_clock(NOW) as clock:
        card = await Cluster.start(nodes, cache_size=capacity,
                                   tpu_max_batch=window, behaviors=behaviors)
        try:
            cpu = await Cluster.start(nodes, cache_size=capacity,
                                      tpu_max_batch=window,
                                      behaviors=behaviors,
                                      tpu_platform="cpu")
            try:
                a = await drive_cluster(card, types.RateLimitRequest, seed,
                                        clock, steps)
                b = await drive_cluster(cpu, types.RateLimitRequest, seed,
                                        clock, steps)
                for k, (x, y) in enumerate(zip(a, b)):
                    assert x == y, (
                        f"step {k}: card and CPU clusters answer "
                        f"differently: {[(i, p, q) for i, (p, q) in enumerate(zip(x, y)) if p != q][:3]}")
                rows, want = owner_rows(card), owner_rows(cpu)
                assert rows == want, ("owner rows differ", [
                    (k, rows.get(k), want.get(k))
                    for k in sorted(set(rows) | set(want))
                    if rows.get(k) != want.get(k)][:3])
                out = {"steps": steps, "answers": sum(len(x) for x in a),
                       "owner_rows_equal": len(rows)}
            finally:
                await cpu.stop()
        finally:
            await card.stop()
    return out


# ----------------------------------------------------------------------
# The GLOBAL mesh: kernels B.8a-B.8d (phase 2) and phase 9
# ----------------------------------------------------------------------
GM_NODES = 8                 # global_mesh_8 / global_sparse_reconcile
GM_CAPACITY = 1 << 16        # GUBER_TPU_GLOBAL_MESH_CAPACITY's default
GM_BATCH = 256               # global_mesh_8: GLOBAL hits a node a window
GM_KEYS = 4096               # both rungs' key space
GM_WINDOWS = 25              # global_mesh_8's timed windows
GM_SPARSE_CAPACITIES = (1 << 18, 1 << 22)
GM_SPARSE_K = 4096           # sparse_k past 2^16 slots
GM_PER_NODE = 64             # global_sparse_reconcile's hits a node a step
GM_REPS = 5                  # its timed steps a measurement
GM_UNION = 512               # phase 2's union slots for B.8c / B.8d
GM_WIDE_UNION = 4096         # and B.8d's at a loaded step's union
GM_LIMIT = 1_000_000
GM_DURATION = 3_600_000
GM_COMPARE_CAPACITY = 1 << 14
GM_COMPARE_NODES = 4
GM_COMPARE_K = 64
GM_CLUSTER_NODES = 4


def gm_blocks(types, rng, n, per_node, keys, name="g", now=None):
    """One window of a rung's traffic: ``per_node`` GLOBAL hits a node on
    keys drawn from ``keys`` (limit 1M, one-hour buckets)."""
    return [[types.RateLimitRequest(
        name=name, unique_key=str(int(k)), hits=1, limit=GM_LIMIT,
        duration=GM_DURATION, behavior=types.Behavior.GLOBAL,
        created_at=now) for k in rng.integers(0, keys, per_node)]
        for _ in range(n)]


def gm_window(E, rng, n, cap, per_node, keys):
    """A global_mesh_8 window as the engine packs it, for the kernel
    timings: ``per_node`` token hits a node on keys drawn from ``keys``,
    slots handed out in first-seen order (the slot map's), flattened to
    ``d * cap + s`` and stably sorted.  Returns the (19, n * per_node)
    REQ32 matrix."""
    ids = rng.integers(0, keys, (n, per_node)).ravel()
    uniq, first = np.unique(ids, return_index=True)
    slot_of = np.zeros(keys, np.int64)
    slot_of[uniq[np.argsort(first)]] = np.arange(len(uniq))
    lanes = n * per_node
    R = E.REQ32_INDEX
    m = np.zeros((E.REQ32_ROWS, lanes), np.int32)
    m[R["slot"]] = np.repeat(np.arange(n), per_node) * cap + slot_of[ids]
    m[R["known"]] = 1
    m[R["behavior"]] = GLOBAL_BIT
    m[R["valid"]] = 1
    for name, v in (("hits", 1), ("limit", GM_LIMIT),
                    ("duration", GM_DURATION), ("created_at", NOW)):
        E.pack_wide_rows(m, name, np.full(lanes, v, np.int64), slice(None))
    E.sort_packed_by_slot(m, lanes, n * cap)
    return m


def time_restored(torch, fns, restores) -> dict:
    """Time a step that consumes its input (a reconcile zeroes the
    accumulators): each call restores the input first, and the restore is
    timed alone and taken off.  ``fns`` / ``restores`` rotate together."""
    both = time_ms(torch, [lambda f=f, r=r: (r(), f())
                           for f, r in zip(fns, restores)])
    restore = time_ms(torch, restores)
    return {"ms": max(both - restore, 0.0), "with_restore_ms": both,
            "restore_ms": restore}


def gm_fold_bytes(acc, slots, n) -> tuple:
    """``(bytes, active)`` a fold of the given slots reads beyond the
    owner's row: each node's count, and for every (node, slot) with a
    window its hits, RESET count and 9 aux words."""
    active = int((acc[:, 2][:, slots] > 0).sum())
    return len(slots) * n * 8 + active * (16 + 72), active


def gm_sparse_inputs(torch, dev, rng, n: int, big: int, union: int):
    """B.8c / B.8d inputs at ``n`` nodes x ``big`` slots with ``union``
    random slots touched: random rows there on every replica, random
    parameters (a stamp on 80% of (node, slot) pairs, so a fifth of the
    windows take the running row's), windows on half the non-owners
    (counts 1-3, hits -3..39, RESET on a tenth), touches on 30% more, and
    node 0 touching every union slot.  Returns ``(table, aux, acc, ut,
    acc_u, accu)``: the buffers, the union's slots on the card, and its
    accumulator words on the card and in numpy (a step's restore)."""
    from gubernator_tpu_torch.carry import table_from_columns

    u = np.sort(rng.choice(big, union, replace=False))
    owner = u // (big // n)
    table = torch.zeros((n * big + 1, 16), dtype=torch.int64, device=dev)
    rows = table_from_columns(random_state(rng, n * union), n * union, dev)
    flat = (np.arange(n)[:, None] * big + u[None, :]).ravel()
    table[torch.from_numpy(flat).to(dev)] = rows[:-1]
    aux = torch.zeros((n, 9, big), dtype=torch.int64, device=dev)
    req = random_requests(rng, n * union)
    params = np.stack([req[f] for f in ("limit", "duration", "algorithm",
                                        "behavior", "burst", "greg_exp",
                                        "greg_dur", "created_at")]
                      + [np.where(rng.random(n * union) < 0.8,
                                  rng.integers(1, 40, n * union), 0)])
    params = params.reshape(9, n, union).transpose(1, 0, 2)
    ut = torch.from_numpy(u).to(dev)
    aux[:, :, ut] = torch.from_numpy(np.ascontiguousarray(params)).to(dev)
    nodes = np.arange(n)[:, None]
    win = (rng.random((n, union)) < 0.5) & (nodes != owner[None, :])
    accu = np.zeros((n, 4, union), np.int64)
    accu[:, 2] = np.where(win, rng.integers(1, 4, (n, union)), 0)
    accu[:, 0] = np.where(win, rng.integers(-3, 40, (n, union)), 0)
    accu[:, 1] = np.where(win & (rng.random((n, union)) < 0.1), 1, 0)
    accu[:, 3] = accu[:, 2] + (rng.random((n, union)) < 0.3)
    accu[0, 3] = np.maximum(accu[0, 3], 1)  # every slot in the union
    acc = torch.zeros((n, 4, big), dtype=torch.int64, device=dev)
    acc_u = torch.from_numpy(accu).to(dev)
    acc[:, :, ut] = acc_u
    return table, aux, acc, ut, acc_u, accu


def sparse_apply_timed(torch, table, aux, acc, ut, acc_u, accu, slots, out,
                       n: int, union: int, plain: bool) -> dict:
    """B.8d on ``gm_sparse_inputs`` buffers whose union B.8c left in
    ``slots`` / ``out``: held bit for bit against the plain version, then
    timed with the union's accumulators restored before each call and
    the restore taken off (and the plain version too where ``plain``).
    Bound: bytes, the list word, the owner's row, n replicas and n x 4
    accumulator words a slot, and the folded windows' words."""
    from gubernator_tpu_torch.ops import globalmesh as GM

    tk, ck, tp, cp = table.clone(), acc.clone(), table.clone(), acc.clone()
    GM.global_sparse_apply(tk, aux, ck, n, slots, out, union, NOW)
    GM.global_sparse_apply_plain(tp, aux, cp, n, slots, out, NOW)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp) and torch.equal(ck, cp), \
        f"global_sparse_apply differs from plain ({union} union slots)"
    err = _max_abs(torch, tk, tp)
    del tk, ck, tp, cp

    def restore():
        acc[:, :, ut] = acc_u

    t = time_restored(torch, [lambda: GM.global_sparse_apply(
        table, aux, acc, n, slots, out, union, NOW)], [restore])
    tp = time_restored(torch, [lambda: GM.global_sparse_apply_plain(
        table, aux, acc, n, slots, out, NOW)], [restore]) if plain else None
    fold_b, active = gm_fold_bytes(accu, np.arange(union), n)
    nbytes = union * (4 + 128 + n * 128 + n * 32) + fold_b
    return {"union": union, "err": err, "ms": t["ms"],
            "plain_ms": tp["ms"] if tp else None,
            "restore_ms": t["restore_ms"], "bytes": nbytes,
            "windows_folded": active,
            **_bound(nbytes, active * FUSED_TICK_INT32_OPS_PER_LANE)}


def global_kernel_entries(torch, dev, rng, n=GM_NODES, cap=GM_CAPACITY,
                          big=GM_SPARSE_CAPACITIES[1], union=GM_UNION,
                          rotate=8) -> dict:
    """B.8a-B.8d against their plain versions bit for bit, and timed
    (B.8b strict and summed, ``summed_ms``, beside PR 15's time,
    ``earlier_ms``, with its share of the bound and its ``ptxas``
    report).  B.8a and B.8b at ``n`` nodes x ``cap`` slots on
    global_mesh_8's windows (B.8b's accumulators and stamps those of two
    windows; random
    rows of all five algorithms); B.8c and B.8d at ``n`` x ``big`` slots
    with ``union`` slots touched (random rows there, random parameters,
    windows with negative hits and RESET counts on the non-owners).
    ``library_ms``: for B.8a, two ``index_put_`` calls (the aux words,
    then the accumulators with ``accumulate=True``) on precomputed indices;
    none for the others."""
    from gubernator_tpu_torch.carry import table_from_columns
    from gubernator_tpu_torch.ops import engine as E
    from gubernator_tpu_torch.ops import globalmesh as GM

    src = "gubernator_tpu_torch/csrc/global_mesh.cu"
    ref = "gubernator_tpu/parallel/global_mesh.py"
    out = {}
    # --- B.8a on global_mesh_8's windows ---
    wins = [torch.from_numpy(gm_window(E, rng, n, cap, GM_BATCH, GM_KEYS))
            .to(dev) for _ in range(rotate)]
    aux = torch.zeros((n, 9, cap), dtype=torch.int64, device=dev)
    acc = torch.zeros((n, 4, cap), dtype=torch.int64, device=dev)
    err = 0
    for touch in (False, True):
        ak, ck, ap, cp = aux.clone(), acc.clone(), aux.clone(), acc.clone()
        for stamp, w in enumerate(wins[:2], 1):
            GM.global_accumulate(w, ak, ck, n, stamp, touch)
            GM.global_accumulate_plain(w, ap, cp, n, stamp, touch)
        torch.cuda.synchronize()
        assert torch.equal(ak, ap) and torch.equal(ck, cp), \
            f"global_accumulate differs from plain (touch {touch})"
        err = max(err, _max_abs(torch, ak, ap), _max_abs(torch, ck, cp))
    b8b_aux, b8b_acc = ak, ck.clone()  # two windows' stamps and hits
    b8b_acc[:, GM.ACC_TOUCH] = 0       # a dense engine keeps no touch row
    terms = [GM.lane_terms(w, n, cap) for w in wins]
    lib_ix = []
    for r, d, s, live, tail, queue, reset in terms:
        vals = (r["limit"], r["duration"], r["algorithm"], r["behavior"],
                r["burst"], r["greg_exp"], r["greg_dur"], r["created_at"],
                torch.full_like(r["limit"], 3))
        ai = torch.cat([(d[tail] * 9 + k) * cap + s[tail] for k in range(9)])
        av = torch.cat([v[tail] for v in vals])
        ci = torch.cat([(d[m] * 4 + row) * cap + s[m] for row, m in
                        ((0, queue), (1, reset), (2, queue))])
        cv = torch.cat([r["hits"][queue], torch.ones_like(r["hits"][reset]),
                        torch.ones_like(r["hits"][queue])])
        lib_ix.append((ai, av, ci, cv))
    fa, fc = aux.view(-1), acc.view(-1)

    def library(ix):
        fa.index_put_((ix[0],), ix[1])
        fc.index_put_((ix[2],), ix[3], accumulate=True)

    r, d, s, live, tail, queue, reset = terms[0]
    lanes = wins[0].shape[1]
    nbytes = (lanes * 76 + int(tail.sum()) * 72 + int(queue.sum()) * 32
              + int(reset.sum()) * 16)
    out["global_accumulate"] = _entry(
        "global_accumulate", src, f"{ref}:213", err,
        time_ms(torch, [lambda w=w: GM.global_accumulate(w, aux, acc, n, 3,
                                                         False)
                        for w in wins]),
        time_ms(torch, [lambda w=w: GM.global_accumulate_plain(
            w, aux, acc, n, 3, False) for w in wins]),
        time_ms(torch, [lambda ix=ix: library(ix) for ix in lib_ix]),
        nbytes, 0)
    out["global_accumulate"].update(
        lanes=lanes, tails=int(tail.sum()), queued=int(queue.sum()))
    del aux, acc

    # --- B.8b: the dense step at n x cap ---
    table = table_from_columns(random_state(rng, n * cap), n * cap, dev)
    err = 0
    for strict in (True, False):
        tk, ck, tp, cp = (table.clone(), b8b_acc.clone(), table.clone(),
                          b8b_acc.clone())
        GM.global_dense_reconcile(tk, b8b_aux, ck, n, NOW, strict)
        GM.global_dense_reconcile_plain(tp, b8b_aux, cp, n, NOW, strict)
        torch.cuda.synchronize()
        assert torch.equal(tk, tp) and torch.equal(ck, cp), \
            f"global_dense_reconcile differs from plain (strict {strict})"
        err = max(err, _max_abs(torch, tk, tp))
        del tk, tp
    work = b8b_acc.clone()

    def restore():
        work.copy_(b8b_acc)

    acc_h = b8b_acc.cpu().numpy()
    fold_b, active = gm_fold_bytes(acc_h, np.arange(cap), n)
    havep = int((b8b_aux[:, GM.AUX["stamp"]] > 0).any(dim=0).sum())
    t = time_restored(torch, [lambda: GM.global_dense_reconcile(
        table, b8b_aux, work, n, NOW, True)], [restore])
    ts = time_restored(torch, [lambda: GM.global_dense_reconcile(
        table, b8b_aux, work, n, NOW, False)], [restore])
    tp = time_restored(torch, [lambda: GM.global_dense_reconcile_plain(
        table, b8b_aux, work, n, NOW, True)], [restore])
    nbytes = cap * (128 + n * 8 + n * 128 + n * 32) + havep * 64 + fold_b
    out["global_dense_reconcile"] = _entry(
        "global_dense_reconcile", src, f"{ref}:577", err, t["ms"], tp["ms"],
        None, nbytes, active * FUSED_TICK_INT32_OPS_PER_LANE)
    out["global_dense_reconcile"].update(
        slots=cap, nodes=n, windows_folded=active, restore_ms=t["restore_ms"],
        summed_ms=ts["ms"], earlier_ms=EARLIER_MS["global_dense_reconcile"],
        share=(out["global_dense_reconcile"]["bound_ms"] / t["ms"]
               if t["ms"] > 0 else None),
        ptxas=kernel_ptxas("global_mesh", "dense_kernel"))
    del table, work, b8b_aux, b8b_acc

    # --- B.8c and B.8d at n x big with `union` slots touched ---
    table, aux, acc, ut, acc_u, accu = gm_sparse_inputs(
        torch, dev, rng, n, big, union)
    po, ps, pscr = GM.probe_buffers(n, big, dev)
    qo, qs, _ = GM.probe_buffers(n, big, dev)
    GM.global_sparse_probe(acc, n, GM_SPARSE_K, po, ps, pscr)
    GM.global_sparse_probe_plain(acc, n, GM_SPARSE_K, qo, qs)
    torch.cuda.synchronize()
    size = int(qo[1])
    assert torch.equal(po, qo) and size == union, "probe verdict differs"
    assert torch.equal(torch.sort(ps[:size]).values, qs[:size]), \
        "probe union differs"
    nbytes = n * big * 16 + union * 4 + (2 + 3 * n) * 4 + 16
    out["global_sparse_probe"] = _entry(
        "global_sparse_probe", src, f"{ref}:400", 0,
        time_ms(torch, lambda: GM.global_sparse_probe(
            acc, n, GM_SPARSE_K, po, ps, pscr)),
        time_ms(torch, lambda: GM.global_sparse_probe_plain(
            acc, n, GM_SPARSE_K, qo, qs)), None, nbytes, 0)
    out["global_sparse_probe"].update(slots=big, nodes=n, union=union,
                                      design="scan")
    b8d = sparse_apply_timed(torch, table, aux, acc, ut, acc_u, accu, ps, po,
                             n, union, plain=True)
    out["global_sparse_apply"] = _entry(
        "global_sparse_apply", src, f"{ref}:442", b8d["err"], b8d["ms"],
        b8d["plain_ms"], None, b8d["bytes"],
        b8d["windows_folded"] * FUSED_TICK_INT32_OPS_PER_LANE)
    out["global_sparse_apply"].update(
        slots=big, nodes=n, union=union,
        windows_folded=b8d["windows_folded"], restore_ms=b8d["restore_ms"],
        earlier_ms=EARLIER_MS["global_sparse_apply"],
        ptxas={f"lanes_{g}": kernel_ptxas("global_mesh",
                                          f"apply_kernelILi{g}E")
               for g in (8, 16, 32)})
    del table, aux, acc, ps, po, pscr, qs, qo
    torch.cuda.empty_cache()
    # --- B.8d at a loaded step's union: 4096 slots ---
    table, aux, acc, ut, acc_u, accu = gm_sparse_inputs(
        torch, dev, np.random.default_rng(SEED + 7), n, big, GM_WIDE_UNION)
    po, ps, pscr = GM.probe_buffers(n, big, dev)
    GM.global_sparse_probe(acc, n, GM_SPARSE_K, po, ps, pscr)
    over, size = po.tolist()
    assert not over and size == GM_WIDE_UNION, (over, size)
    wide = sparse_apply_timed(torch, table, aux, acc, ut, acc_u, accu, ps, po,
                              n, size, plain=False)
    wide.update(earlier_ms=EARLIER_MS["global_sparse_apply_4096"],
                share=wide["bound_ms"] / wide["ms"] if wide["ms"] else None)
    out["global_sparse_apply"]["by_shape"] = {f"union_{size}": wide}
    del table, aux, acc, ps, po, pscr
    torch.cuda.empty_cache()
    for e in out.values():
        e["share"] = e["bound_ms"] / e["ms"] if e["ms"] else None
    return out


def gm_random_buffers(torch, dev, rng, n, cap, touched=0.3):
    """Random mesh buffers for the card tests: replicas of random rows
    (all five algorithms), aux parameters with stamps on 70% of (node,
    slot) pairs, and on a ``touched`` share of them windows (counts 1-3,
    hits -5..19, RESET on a fifth) on non-owned slots and touch counts."""
    from gubernator_tpu_torch.carry import table_from_columns

    table = table_from_columns(random_state(rng, n * cap), n * cap, dev)
    req = random_requests(rng, n * cap)
    aux = np.stack([req[f] for f in ("limit", "duration", "algorithm",
                                     "behavior", "burst", "greg_exp",
                                     "greg_dur", "created_at")]
                   + [np.where(rng.random(n * cap) < 0.7,
                               rng.integers(1, 50, n * cap), 0)])
    aux = np.ascontiguousarray(aux.reshape(9, n, cap).transpose(1, 0, 2))
    hot = rng.random((n, cap)) < touched
    owned = (np.arange(cap)[None, :] // (cap // n)) == np.arange(n)[:, None]
    win = hot & ~owned & (rng.random((n, cap)) < 0.6)
    acc = np.zeros((n, 4, cap), np.int64)
    acc[:, 2] = np.where(win, rng.integers(1, 4, (n, cap)), 0)
    acc[:, 0] = np.where(win, rng.integers(-5, 20, (n, cap)), 0)
    acc[:, 1] = np.where(win & (rng.random((n, cap)) < 0.2), 1, 0)
    acc[:, 3] = np.where(hot, acc[:, 2] + rng.integers(1, 3, (n, cap)), 0)
    return (table, torch.from_numpy(aux).to(dev),
            torch.from_numpy(acc).to(dev))


def replicas_equal(torch, eng) -> bool:
    """Every node's replica row-equal to node 0's."""
    rows = eng.table[:-1].view(eng.n_nodes, eng.capacity, -1)
    return bool((rows == rows[0]).all())


def gm_key_rows(eng, name: str, keys) -> np.ndarray:
    """Node 0's rows of keys ``name_<k>`` (one gather)."""
    import torch

    from gubernator_tpu_torch.ops import rowtable
    from gubernator_tpu_torch.ops.reqcols import pack_blob

    slots = eng.slots.lookup_blob(*pack_blob(
        [f"{name}_{int(k)}".encode() for k in keys]))
    assert (slots >= 0).all()
    return rowtable.gather_rows(
        eng.table, torch.from_numpy(slots).to(eng.device)).cpu().numpy()


def gm_sparse_measure(torch, dev, types, rng, capacity, sparse_k,
                      reps=GM_REPS) -> dict:
    """global_sparse_reconcile's measurement: a step's time loaded with
    one window (64 hits a node over 4096 keys) and empty, medians of
    ``reps`` steps, the card synchronized around each step."""
    from gubernator_tpu_torch.parallel.global_mesh import MeshGlobalEngine

    eng = MeshGlobalEngine(n_nodes=GM_NODES, capacity=capacity,
                           max_batch=GM_PER_NODE, sparse_k=sparse_k,
                           device=dev)
    eng.process_blocks(gm_blocks(types, rng, GM_NODES, GM_PER_NODE, GM_KEYS,
                                 "gs"), now=NOW)
    eng.reconcile(now=NOW)

    def step(load, i):
        if load:
            eng.process_blocks(gm_blocks(types, rng, GM_NODES, GM_PER_NODE,
                                         GM_KEYS, "gs"), now=NOW + i + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.reconcile(now=NOW + i + 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    d0, r0 = eng.metric_reconcile_dispatches, eng.metric_reconciles
    loaded = [step(True, i) for i in range(reps)]
    empty = [step(False, reps + i) for i in range(reps)]
    assert replicas_equal(torch, eng)
    out = {"capacity": capacity, "sparse_k": eng.sparse_k,
           "loaded_ms": float(np.median(loaded)),
           "empty_ms": float(np.median(empty)),
           "loaded_ms_all": loaded, "empty_ms_all": empty,
           "dispatches_per_step": (eng.metric_reconcile_dispatches - d0)
           / max(1, eng.metric_reconciles - r0),
           "dense_fallbacks": eng.metric_dense_fallbacks}
    del eng
    torch.cuda.empty_cache()
    return out


def gm_wide_window(torch, dev, types, rng) -> dict:
    """A sparse engine (2^18 slots, sparse_k 4096) and a dense one fed the
    same windows: two of global_sparse_reconcile's, then one where node 0
    sends more than sparse_k distinct keys.  The wide step must dispatch
    twice (the probe's overflow, then the dense fallback) and both engines
    must hold the same table, aux and accumulators after every step."""
    from gubernator_tpu_torch.parallel.global_mesh import MeshGlobalEngine

    cap = GM_SPARSE_CAPACITIES[0]
    engs = [MeshGlobalEngine(n_nodes=GM_NODES, capacity=cap, max_batch=8192,
                             sparse_k=k, device=dev)
            for k in (GM_SPARSE_K, 0)]
    wide = GM_SPARSE_K + 904
    steps = []
    for i in range(3):
        blocks = gm_blocks(types, rng, GM_NODES, GM_PER_NODE, GM_KEYS, "gw")
        if i == 2:
            blocks[0] = [types.RateLimitRequest(
                name="gw", unique_key=f"wide{k}", hits=1 + k % 3,
                limit=GM_LIMIT, duration=GM_DURATION,
                behavior=types.Behavior.GLOBAL) for k in range(wide)]
        d0 = engs[0].metric_reconcile_dispatches
        for e in engs:
            e.process_blocks(blocks, now=NOW + 10 * i)
            e.reconcile(now=NOW + 10 * i + 5)
        steps.append(engs[0].metric_reconcile_dispatches - d0)
        a, b = engs
        assert torch.equal(a.table, b.table), f"wide: tables differ at {i}"
        assert torch.equal(a.aux, b.aux) and torch.equal(a.accum, b.accum)
    assert steps == [1, 1, 2], steps
    assert engs[0].metric_dense_fallbacks == 1
    assert replicas_equal(torch, engs[0])
    return {"capacity": cap, "wide_keys": wide,
            "dispatches_by_step": steps,
            "dense_fallbacks": engs[0].metric_dense_fallbacks,
            "same_as_dense": True}


def gm_compare_blocks(types, rng, step: int, now: int) -> list:
    """Step ``step`` of phase 9 D's seeded sequence on a 4-node engine:
    steps 0-5 random windows over 48 keys (all five algorithms, negative
    and zero hits, RESET, limits small enough to overdraw), step 6 a
    window where node 0 sends 100 distinct keys (past sparse_k 64), steps
    7-8 2500 fresh keys a node, which fill the 2^14-slot table: the second
    reclaims the buckets that expired, then evicts live ones."""
    GLOBAL = int(types.Behavior.GLOBAL)
    RESET = int(types.Behavior.RESET_REMAINING)
    n = GM_COMPARE_NODES

    def r(key, **kw):
        return types.RateLimitRequest(name="cmp", unique_key=key,
                                      created_at=now, **kw)

    if step <= 5:
        return [[r(f"k{int(rng.integers(0, 48))}",
                   hits=int(rng.choice([-3, -1, 0, 1, 2, 5, 9])),
                   limit=int(rng.choice([4, 10, 100])),
                   duration=int(rng.choice([1_000, 4_000, 60_000])),
                   algorithm=int(rng.integers(0, 5)),
                   behavior=GLOBAL | (RESET if rng.random() < 0.1 else 0),
                   burst=int(rng.choice([0, 3])))
                 for _ in range(int(rng.integers(4, 20)))]
                for _ in range(n)]
    if step == 6:
        blocks = [[r(f"k{int(rng.integers(0, 48))}", hits=1, limit=10,
                     duration=60_000, behavior=GLOBAL) for _ in range(4)]
                  for _ in range(n)]
        blocks[0] = [r(f"ov{k}", hits=1, limit=10, duration=60_000,
                       behavior=GLOBAL) for k in range(100)]
        return blocks
    return [[r(f"f{step}-{d}-{k}", hits=1, limit=5,
               duration=500 if k % 5 == 0 and step > 7 else 60_000,
               behavior=GLOBAL)
             for k in range(2500)] for d in range(n)]


def global_compare(torch, dev, types, seed=SEED + 21, steps=9) -> dict:
    """Phase 9 D: a card engine and a CPU engine at 2^14 slots and 4
    nodes, with sparse_k 64 and with sparse_k 0, take the seeded sequence
    of ``gm_compare_blocks``, each window followed by a reconcile;
    responses and ``state_fields()`` (and aux and accumulators) must be
    equal after every step."""
    from gubernator_tpu_torch.parallel.global_mesh import MeshGlobalEngine

    out = {}
    for k in (GM_COMPARE_K, 0):
        engs = [MeshGlobalEngine(n_nodes=GM_COMPARE_NODES,
                                 capacity=GM_COMPARE_CAPACITY,
                                 max_batch=4096, sparse_k=k, device=d)
                for d in (dev, "cpu")]
        rng = np.random.default_rng(seed)
        answers = 0
        for step in range(steps):
            now = NOW + 1_000 * step
            blocks = gm_compare_blocks(types, rng, step, now)
            got = [e.process_blocks(blocks, now=now) for e in engs]
            assert [[(x.status, x.limit, x.remaining, x.reset_time, x.error)
                     for x in blk] for blk in got[0]] == [
                [(x.status, x.limit, x.remaining, x.reset_time, x.error)
                 for x in blk] for blk in got[1]], f"answers differ ({k}, {step})"
            answers += sum(len(b) for b in blocks)
            for e in engs:
                e.reconcile(now=now + 500)
            fa, fb = (e.state_fields() for e in engs)
            for f in fa:
                np.testing.assert_array_equal(fa[f], fb[f],
                                              err_msg=f"{f} ({k}, {step})")
            assert torch.equal(engs[0].aux.cpu(), engs[1].aux)
            assert torch.equal(engs[0].accum.cpu(), engs[1].accum)
        a, b = engs
        for name in ("metric_reconciles", "metric_reconcile_dispatches",
                     "metric_dense_fallbacks", "metric_evictions",
                     "metric_sorted_windows"):
            assert getattr(a, name) == getattr(b, name), name
        assert a.metric_evictions > 0
        if k:
            assert a.metric_dense_fallbacks > 0
            assert a.metric_reconcile_dispatches > a.metric_reconciles
        out[f"sparse_k_{k}"] = {
            "answers": answers, "steps": steps, "equal": True,
            "dense_fallbacks": a.metric_dense_fallbacks,
            "evictions": a.metric_evictions,
            "sorted_windows": a.metric_sorted_windows}
    return out


async def gm_cluster(torch, types, rng, keys=GLOBAL_KEYS, batches=16,
                     limit=SERVE_LIMIT) -> dict:
    """Phase 9 C: ``Cluster(global_mesh=True)`` with 4 daemons on the card.
    ``batches`` batches of 1000 GLOBAL hits on ``keys`` keys round robin
    over the nodes by gRPC; ``global_converge_ms`` from the last hit to
    every node answering every key's exact count (limit less the hits
    sent), polled with hits=0 probes.  No peer RPC may carry a GLOBAL item
    (no PeersV1 call, no GLOBAL flush or broadcast)."""
    import asyncio
    import re

    from gubernator_tpu_torch.cluster import Cluster

    c = await Cluster.start(GM_CLUSTER_NODES, global_mesh=True,
                            cache_size=1 << 16)
    try:
        n = len(c.daemons)
        gid = (np.arange(keys) * 2_654_435_761) % 10**8
        sent = np.zeros(keys, np.int64)
        t0 = time.perf_counter()
        for j in range(batches):
            ids = rng.integers(0, keys, SERVE_BATCH)
            np.add.at(sent, ids, 1)
            await ask(c.daemons[j % n], raw_batch(
                b"mglob", gid[ids], behavior=GLOBAL_BIT, limit=limit))
        t_last = time.perf_counter()
        polls = 0
        while True:
            polls += 1
            exact = True
            for d in c.daemons:
                for s in range(0, keys, SERVE_BATCH):
                    got = [r.remaining for r in await ask(d, raw_batch(
                        b"mglob", gid[s:s + SERVE_BATCH], hits=0,
                        behavior=GLOBAL_BIT, limit=limit))]
                    exact = exact and got == (
                        limit - sent[s:s + SERVE_BATCH]).tolist()
            if exact:
                break
            assert time.perf_counter() - t_last < 60, "mesh did not converge"
            await asyncio.sleep(0.005)
        converge = (time.perf_counter() - t_last) * 1e3
        eng = c.daemons[0].instance.global_mesh
        peer_calls = 0
        for d in c.daemons:
            text = d.metrics.expose().decode()
            peer_calls += sum(float(v) for v in re.findall(
                r'gubernator_grpc_request_counts_total\{[^}]*PeersV1[^}]*\} '
                r'(\S+)', text))
            peer_calls += d.metrics.sample(
                "gubernator_global_send_duration_count")
            peer_calls += d.metrics.sample(
                "gubernator_broadcast_duration_count")
        assert peer_calls == 0, f"{peer_calls} GLOBAL peer calls"
        assert replicas_equal(torch, eng)
        return {"nodes": n, "keys": keys, "hits": int(sent.sum()),
                "send_s": t_last - t0, "global_converge_ms": converge,
                "polls": polls, "counts_exact": True, "peer_rpcs": 0,
                "reconciles": eng.metric_reconciles,
                "capacity": eng.capacity, "sparse_k": eng.sparse_k}
    finally:
        await c.stop()


def global_phase(torch, dev, grpc_converge_ms=None):
    """Phase 9, the GLOBAL mesh.  A: global_mesh_8 at its own size on the
    card (8 nodes, 256 GLOBAL hits a node a window over 4096 keys) at the
    default 2^16 slots, 25 windows each followed by a dense reconcile:
    decisions/s, reconciles/s, dispatches a step, launches by kernel;
    every replica row-equal after every reconcile and each key's count
    its limit less the hits sent.  B: global_sparse_reconcile (8 nodes,
    64 hits a node) at 2^18 and 2^22 slots with sparse_k 4096, loaded and
    empty step ms, the dense step at 2^18 for contrast, and a window wider
    than sparse_k against a dense engine.  C: the mesh cluster over gRPC.
    D: card against CPU.  Returns ``(info, launches summed over the
    phase's paths)``."""
    import asyncio

    from gubernator_tpu_torch import types
    from gubernator_tpu_torch.ops.buckets import WORD
    from gubernator_tpu_torch.parallel.global_mesh import MeshGlobalEngine

    info, launches, widths = {}, {}, {}

    def path(name):
        return counted(torch, launches, name, widths)

    rng = np.random.default_rng(SEED + 20)
    # A: dense, global_mesh_8.
    eng = MeshGlobalEngine(n_nodes=GM_NODES, capacity=GM_CAPACITY,
                           max_batch=GM_BATCH, device=dev)
    windows = [gm_blocks(types, rng, GM_NODES, GM_BATCH, GM_KEYS)
               for _ in range(8)]
    sent = np.zeros(GM_KEYS, np.int64)

    def count(blocks):
        for blk in blocks:
            np.add.at(sent, [int(r.unique_key) for r in blk], 1)

    eng.process_blocks(windows[0], now=NOW)   # warm, as the rung
    eng.reconcile(now=NOW)
    count(windows[0])
    d0, r0 = eng.metric_reconcile_dispatches, eng.metric_reconciles
    elapsed, unequal = 0.0, 0
    with path("dense"):
        for i in range(GM_WINDOWS):
            blocks = windows[i % len(windows)]
            t0 = time.perf_counter()
            eng.process_blocks(blocks, now=NOW + i + 1)
            eng.reconcile(now=NOW + i + 1)
            torch.cuda.synchronize()
            elapsed += time.perf_counter() - t0
            count(blocks)
            unequal += not replicas_equal(torch, eng)
    steps = eng.metric_reconciles - r0
    seen = np.flatnonzero(sent)
    rows = gm_key_rows(eng, "g", seen)
    wrong = int((rows[:, WORD["remaining"]] != GM_LIMIT - sent[seen]).sum())
    la = launches["dense"]
    info["dense"] = {
        "nodes": GM_NODES, "capacity": GM_CAPACITY, "per_node": GM_BATCH,
        "keys": GM_KEYS, "windows": GM_WINDOWS,
        "decisions_per_s": GM_WINDOWS * GM_NODES * GM_BATCH / elapsed,
        "reconciles_per_s": GM_WINDOWS / elapsed,
        "window_ms": elapsed / GM_WINDOWS * 1e3,
        "dispatches_per_step": (eng.metric_reconcile_dispatches - d0)
        / max(steps, 1),
        "unique_windows": eng.metric_unique_windows,
        "sorted_windows": eng.metric_sorted_windows,
        "replica_mismatches": unequal, "count_errors": wrong,
        "launches": la}
    assert unequal == 0 and wrong == 0, info["dense"]
    assert info["dense"]["dispatches_per_step"] == 1.0
    assert la["global_accumulate"] == GM_WINDOWS
    assert la["global_dense_reconcile"] == GM_WINDOWS
    assert la["fused_tick"] + la["fused_sorted_tick"] == GM_WINDOWS
    assert la["fused_merged_tick"] == 0
    del eng
    # B: sparse, global_sparse_reconcile.
    sparse = {}
    for cap in GM_SPARSE_CAPACITIES:
        with path(f"sparse_{cap}"):
            sparse[str(cap)] = gm_sparse_measure(torch, dev, types, rng, cap,
                                                 GM_SPARSE_K)
        ls = launches[f"sparse_{cap}"]
        sparse[str(cap)]["launches"] = ls
        assert sparse[str(cap)]["dispatches_per_step"] == 1.0
        # A probe every step; an apply every step with a union: the first
        # and the loaded ones (an empty union launches nothing).
        assert ls["global_sparse_probe"] == 2 * GM_REPS + 1
        assert ls["global_sparse_apply"] == GM_REPS + 1
        assert ls["global_dense_reconcile"] == 0
    with path(f"dense_{GM_SPARSE_CAPACITIES[0]}"):
        sparse[f"dense_{GM_SPARSE_CAPACITIES[0]}"] = gm_sparse_measure(
            torch, dev, types, rng, GM_SPARSE_CAPACITIES[0], 0)
    with path("wide"):
        sparse["wide"] = gm_wide_window(torch, dev, types, rng)
    info["sparse"] = sparse
    # C: the mesh cluster over gRPC.
    with path("service"):
        info["service"] = asyncio.run(gm_cluster(torch, types, rng))
    info["service"]["grpc_global_converge_ms"] = grpc_converge_ms
    info["global_converge_ms"] = info["service"]["global_converge_ms"]
    # D: card against CPU.
    with path("compare"):
        info["card_vs_cpu"] = global_compare(torch, dev, types)
    info["launches_by_path"] = launches
    info["launches_by_width"] = widths
    total = {}
    for per in launches.values():
        for name, c in per.items():
            total[name] = total.get(name, 0) + c
    for name in ("global_accumulate", "global_dense_reconcile",
                 "global_sparse_probe", "global_sparse_apply"):
        assert total[name] > 0, f"no {name} launch in phase 9"
    return info, total


# Phase 12: the shard autoscaler.  A: the reference's diurnal_autoscale
# rung (bench.py:2910-3130) on phase 10's mesh before it closes; B: a port
# daemon's own autoscaler, dry run and then armed.
DAY_STEP_S = 900.0       # one control window: 15 simulated minutes
DAY_STEPS = 96           # the compressed day
DAY_CAP = 100.0          # offered windows/s one shard serves (the model)
DAY_BASE_MS = 1.0        # the model's p99 at no load
DAY_MAX_PER_HOUR = 4
DAY_SERVE_S = 0.25       # load served on the new layout after a transition
DAY_POLICY = dict(windows=3, target_p99_ms=5.0, queue_high=100,
                  hysteresis=0.5, occupancy_low=0.3, min_shards=4,
                  max_shards=8)
DAY_COOLDOWNS = (1800.0, 3600.0)   # up, down


# Phase 10: live resharding of phase 4's mesh (8 x 1.25M slots, 10M keys)
# behind a tick loop, the reference's reshard_live rung at a deployment's
# size; 4096-wide Zipf(1.2) windows from a load thread; 8 -> 4 -> 8.
RESHARD_SHARDS, RESHARD_LOCAL = 8, 1_250_000
RESHARD_WIDTH = 4096
RESHARD_STEPS = (4, 8)
RESHARD_SWEEP = 1 << 16        # keys the load never sends, swept around
RESHARD_SETTLE_S = 1.0         # load before each transition
RESHARD_BACKOFF_S = 0.01       # the load's wait after a retriable shed
# Part B: the card mesh against the CPU one at 8 x 2^14, filled.
RESHARD_COMPARE_LOCAL = 1 << 14
RESHARD_COMPARE_STEPS = (4, 8, 3, 8)


def record_freezes(loop) -> list:
    """Wrap ``loop``'s freeze and unfreeze to record ``(kind,
    perf_counter)`` events into the returned list, for the rest of the
    loop's life."""
    events = []
    freeze, unfreeze = loop.freeze, loop.unfreeze

    def on_freeze(shed_peers=False):
        events.append(("freeze", time.perf_counter()))
        freeze(shed_peers)

    def on_unfreeze():
        unfreeze()
        events.append(("unfreeze", time.perf_counter()))

    loop.freeze, loop.unfreeze = on_freeze, on_unfreeze
    return events


def frozen_seconds(events, t0: float, t1: float):
    """The first freeze at or after ``t0`` to the last unfreeze by ``t1``
    (+1 s): how long a transition held clients off."""
    fz = [t for k, t in events if k == "freeze" and t >= t0]
    uf = [t for k, t in events if k == "unfreeze" and t <= t1 + 1.0]
    return (uf[-1] - fz[0]) if fz and uf else None


def wall_ms() -> int:
    return int(time.time() * 1000)


def route_ids(prefix: bytes, n_shards: int, need) -> np.ndarray:
    """Sorted ids whose keys ``prefix + id`` fill each shard s with
    ``need[s]`` keys by their CRC-32 route."""
    from gubernator_tpu_torch.native import crc32_batch

    cand = np.arange(int(sum(need) * 1.05) + 4096)
    sh = (crc32_batch(*key_blob(prefix, cand))
          % np.uint32(n_shards)).astype(np.int64)
    ids = np.sort(np.concatenate(
        [cand[sh == s][:need[s]] for s in range(n_shards)]))
    assert len(ids) == sum(need)
    return ids


def prefill_mesh(reqcols, eng, prefix: bytes, ids, chunk: int) -> float:
    """Every key ``prefix + id`` gets one token hit on a one-hour bucket of
    100 at the wall clock; returns the seconds it took."""
    from gubernator_tpu_torch.ops.engine import resolve_ticks

    t0 = time.perf_counter()
    pending = []
    for a in range(0, len(ids), chunk):
        pending.append(eng.submit_columns(herd_columns(
            reqcols, prefix, ids[a:a + chunk], token_prefill=True)))
        if len(pending) == 4:
            resolve_ticks(pending)
            for h in pending:
                mat, errs = h.result()
                assert not errs and (mat[2] == 99).all()
            pending = []
    resolve_ticks(pending)
    for h in pending:
        mat, errs = h.result()
        assert not errs and (mat[2] == 99).all()
    return time.perf_counter() - t0


def sweep_rows(eng, prefix: bytes, ids) -> np.ndarray:
    """The rows of keys ``prefix + id`` where their CRC-32 route and the
    route's slot map place them, through the gather kernel; -1 rows for a
    key that is not there."""
    from gubernator_tpu_torch.native import crc32_batch
    from gubernator_tpu_torch.ops.engine import gather_chunked
    from gubernator_tpu_torch.ops.reqcols import compact_blob

    blob, off = key_blob(prefix, ids)
    sh = (crc32_batch(blob, off) % np.uint32(eng.n_shards)).astype(np.int64)
    g = np.full(len(ids), -1, np.int64)
    for d in range(eng.n_shards):
        at = np.flatnonzero(sh == d)
        if len(at):
            loc = eng.slots[d].lookup_blob(*compact_blob(blob, off, at))
            g[at] = np.where(loc >= 0, d * eng.local_capacity + loc, -1)
    rows = np.full((len(ids), 16), -1, np.int64)
    ok = g >= 0
    rows[ok] = gather_chunked(eng.table, g[ok] + g[ok] // eng.local_capacity)
    return rows


def reshard_compare(torch, dev, reqcols, rng, local: int, steps,
                    width: int) -> dict:
    """Part B: a card mesh and a CPU mesh of 8 x ``local`` slots, filled to
    capacity, fed the same windows (a Zipf(1.2) herd and a Zipf window of
    random requests) at the same now, resharded through ``steps`` at the
    same now: equal answers, tables, slot maps and reclaim stamps after
    every step."""
    from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine

    engs = [MeshTickEngine(RESHARD_SHARDS, local, max_batch=width, device=d)
            for d in (dev, "cpu")]
    ids = route_ids(b"q", RESHARD_SHARDS, [local] * RESHARD_SHARDS)
    now = NOW
    for a in range(0, len(ids), width):
        cols = window_columns(reqcols, rng, b"q", ids[a:a + width], now,
                              prefill=True)
        outs = [e.process_columns(cols, now) for e in engs]
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
    out = {"keys": int(len(ids)), "steps": list(steps), "live_items": [],
           "compared": 0}

    def same():
        card, cpu = engs
        assert torch.equal(card.table.cpu(), cpu.table), "part B tables"
        for a, b in zip(card.slots, cpu.slots):
            ka = a.keys_blob(np.arange(card.local_capacity))
            kb = b.keys_blob(np.arange(cpu.local_capacity))
            assert ka[0] == kb[0] and np.array_equal(ka[1], kb[1]), \
                "part B slot maps"
        np.testing.assert_array_equal(card._last_access, cpu._last_access)
        out["compared"] += 1

    for n_to in steps:
        for kind in ("herd", "mixed"):
            now += 700
            pick = ids[(rng.zipf(1.2, width) - 1) % len(ids)]
            cols = (herd_columns(reqcols, b"q", pick, token_prefill=True)
                    if kind == "herd" else
                    window_columns(reqcols, rng, b"q", pick, now))
            (ga, ea), (gb, eb) = [e.process_columns(cols, now) for e in engs]
            np.testing.assert_array_equal(ga, gb, err_msg=f"part B {kind}")
            assert ea == eb
        infos = [e.reshard(n_to, now=now + 10) for e in engs]
        assert infos[0] == infos[1]
        out["live_items"].append(infos[0]["live_items"])
        same()
    out["rank_rounds"] = [e.metric_rank_rounds for e in engs]
    assert out["rank_rounds"][0] == out["rank_rounds"][1]
    return out


def reshard_phase(torch, dev, n_shards=RESHARD_SHARDS,
                  local_capacity=RESHARD_LOCAL, width=RESHARD_WIDTH,
                  prefill_width=32768, steps=RESHARD_STEPS,
                  sweep=RESHARD_SWEEP, settle_s=RESHARD_SETTLE_S,
                  compare_local=RESHARD_COMPARE_LOCAL,
                  compare_steps=RESHARD_COMPARE_STEPS, day_steps=DAY_STEPS,
                  day_serve_s=DAY_SERVE_S):
    """Phase 10, live resharding (the reference's ``reshard_live`` rung).
    A: phase 4's mesh prefilled to capacity at the wall clock, behind a
    ``TickLoop``; a load thread sends ``width``-wide Zipf(1.2) windows
    of the prefill's token request over the first half of the keys while
    a ``ReshardCoordinator`` runs ``steps`` (8 -> 4 -> 8).  Per
    transition: its outcome and verify counts, an independent sweep of
    ``sweep`` keys of the other half (rows equal before and after, every
    key where its route puts it), its seconds, the frozen seconds, the
    p99 of load windows answered while it ran (ticked or shed) and of
    those ticked, the retriable sheds, the B.2 launches, and the card's
    peak allocated bytes.  Then phase 12 A on the same engine, tick loop
    and coordinator before the loop closes: the compressed day of
    ``day_steps`` control windows (:func:`diurnal_day`) with the load
    over the same keys and the same sweep.  B: part B
    (reshard_compare).  Returns ``(info, launches summed over the
    phase's paths, phase 12 A's info with its launches)``."""
    import threading

    import gubernator_tpu_torch as gt
    from gubernator_tpu_torch.admission import SHED_RESHARD_MSG
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine
    from gubernator_tpu_torch.parallel.reshard import ReshardCoordinator
    from gubernator_tpu_torch.persistence import TransitionLog
    from gubernator_tpu_torch.service.tickloop import TickLoop
    from gubernator_tpu_torch.utils.metrics import Metrics

    rng = np.random.default_rng(SEED + 30)
    info, launches, widths = {}, {}, {}

    def path(name):
        return counted(torch, launches, name, widths)

    t_phase = time.perf_counter()
    eng = MeshTickEngine(n_shards, local_capacity, max_batch=prefill_width,
                         device=dev)
    ids = route_ids(b"r", n_shards, [local_capacity] * n_shards)
    with path("prefill"):
        info["prefill_s"] = prefill_mesh(reqcols, eng, b"r", ids,
                                         prefill_width)
    assert eng.cache_size() == eng.capacity
    info.update(keys=int(len(ids)), n_shards=n_shards,
                local_capacity=local_capacity, width=width)
    half = len(ids) // 2
    traffic, swept = ids[:half], rng.choice(ids[half:], sweep, replace=False)
    before = sweep_rows(eng, b"r", swept)
    assert (before[:, 10] == 1).all()

    m = Metrics()
    loop = TickLoop(eng, batch_wait=0.0005, batch_limit=width, metrics=m)
    events = record_freezes(loop)
    served, stop, failures = [], threading.Event(), []

    def send_load():
        drng = np.random.default_rng(SEED + 31)
        try:
            while not stop.is_set():
                pick = traffic[(drng.zipf(1.2, width) - 1) % len(traffic)]
                cols = herd_columns(reqcols, b"r", pick, token_prefill=True)
                t0 = time.perf_counter()
                mat, errs = loop.submit_columns(cols).result(timeout=120)
                t1 = time.perf_counter()
                shed = sum(1 for v in errs.values() if v == SHED_RESHARD_MSG)
                assert len(errs) == shed, set(errs.values())
                served.append((t0, t1, shed))
                if shed:
                    time.sleep(RESHARD_BACKOFF_S)   # a client's retry
        except BaseException as e:  # surfaced after the join
            failures.append(e)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_reshard_") as root:
        coord = ReshardCoordinator(
            eng, tick_loop=loop, transition_log=TransitionLog(root),
            metrics=m, freeze_timeout=60.0)
        loader = threading.Thread(target=send_load, name="reshard-load")
        transitions = []
        with path("transitions"):
            loader.start()
            try:
                for n_to in steps:
                    time.sleep(settle_s)
                    from_n = eng.n_shards
                    sheds0 = loop.metric_shed_admission.get("reshard", 0)
                    g0 = gt.kernel_launches()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                    t0 = time.perf_counter()
                    res = coord.try_reshard(n_to)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated(dev)
                    g1 = gt.kernel_launches()
                    # Windows answered while it ran: ticked, or shed
                    # with the retriable status.
                    during = [(b - a, sh) for a, b, sh in served
                              if b >= t0 and a <= t1]
                    ticked = [d for d, sh in during if not sh]
                    pre = [b - a for a, b, sh in served
                           if not sh and b < t0 and b >= t0 - settle_s]
                    rows = sweep_rows(eng, b"r", swept)
                    sweep_errors = int((rows != before).any(axis=1).sum())
                    transitions.append({
                        "from": from_n, "to": n_to,
                        "committed": res.get("outcome") == "committed",
                        "state_loss": res["state_loss"],
                        "double_served": res["double_served"],
                        "parity_errors": res["parity_errors"],
                        "live_items": res["live_items"],
                        "duration_s": res.get("duration_s"),
                        "wall_s": t1 - t0,
                        "frozen_s": frozen_seconds(events, t0, t1),
                        "answered_during": len(during),
                        "served_during": len(ticked),
                        "p99_during_ms": (float(np.percentile(
                            [d for d, _ in during], 99)) * 1e3
                            if during else None),
                        "p99_served_during_ms": (float(np.percentile(
                            ticked, 99)) * 1e3 if ticked else None),
                        "p99_before_ms": (float(np.percentile(pre, 99))
                                          * 1e3 if pre else None),
                        "windows_before": len(pre),
                        "retriable_sheds": (loop.metric_shed_admission.get(
                            "reshard", 0) - sheds0),
                        "b2_launches": {k: g1[k] - g0[k] for k in (
                            "gather_rows", "scatter_rows")},
                        "peak_allocated_bytes": int(peak),
                        "sweep_keys": int(len(swept)),
                        "sweep_errors": sweep_errors,
                        "cap_to": eng.local_capacity,
                    })
                time.sleep(settle_s)
            finally:
                stop.set()
                loader.join(timeout=180)
        try:
            if failures:
                raise failures[0]
            assert not loader.is_alive()
            info["journal"] = [(r.phase, r.from_shards, r.to_shards)
                               for r in TransitionLog(root).records()]

            def committed():
                return m.sample("gubernator_tpu_reshard_transitions_total",
                                {"result": "committed"})

            info["metrics"] = {
                "committed": committed(),
                "shards": m.sample("gubernator_tpu_reshard_shards")}
            day_launches, day_widths = {}, {}
            with counted(torch, day_launches, "autoscale", day_widths):
                day = diurnal_day(
                    eng, loop, coord,
                    lambda drng: herd_columns(
                        reqcols, b"r", traffic[(drng.zipf(1.2, width) - 1)
                                               % len(traffic)],
                        token_prefill=True),
                    lambda: sweep_rows(eng, b"r", swept),
                    serve_s=day_serve_s, steps=day_steps)
            day["launches_by_path"] = day_launches
            day["launches_by_width"] = day_widths
            day["b2_launches"] = {k: day_launches["autoscale"][k] for k in (
                "gather_rows", "scatter_rows")}
            day["metrics_committed"] = (committed()
                                        - info["metrics"]["committed"])
        finally:
            loop.close()
    for t in transitions:
        assert t["committed"], t
        assert t["state_loss"] == t["double_served"] == 0, t
        assert t["parity_errors"] == 0 and t["sweep_errors"] == 0, t
        assert t["live_items"] == len(ids), t
    info["transitions"] = transitions
    info["load_windows"] = len(served)
    info["load_sheds"] = int(sum(sh for _, _, sh in served))
    assert info["metrics"]["committed"] == len(steps)
    assert day["metrics_committed"] == day["autoscale_transitions"], day
    del eng, coord
    with path("compare"):
        info["compare"] = reshard_compare(
            torch, dev, reqcols, np.random.default_rng(SEED + 32),
            compare_local, compare_steps, width)
    info["phase_s"] = time.perf_counter() - t_phase
    info["launches_by_path"] = launches
    info["launches_by_width"] = widths
    total = {k: sum(p[k] for p in launches.values())
             for k in launches["prefill"]}
    return info, total, day


# Phase 11: multi-region federation, the reference's federation_2r rung
# (bench.py:1971-2123) at a deployment's size: two regions of two nodes.
FED_DCS = ("us", "us", "eu", "eu")
FED_KEYS = 2_000_000          # bench_ keys each region holds
FED_INTERVAL = 0.02           # federation_interval, the rung's
FED_BATCHES = 32              # A: serial 1000-request MULTI_REGION batches
FED_UNIFORM = 8192            # A: the keys they draw from
FED_LOSS_HITS = (("us", 120), ("eu", 90))   # B: the rung's non-FAST sizes
FED_OVER_LIMIT = 60
FED_PARTITION_KEYS = 4096     # B: keys hit on both sides of the partition
FED_PARTITION_HITS = 2
FED_COMPARE_CAPACITY = 1 << 14
FED_COMPARE_STEPS = 24
MR_BIT = 16                   # Behavior.MULTI_REGION


def fed_resilience():
    """The rung's fast breaker and backoff knobs."""
    from gubernator_tpu_torch.resilience import ResilienceConfig

    return ResilienceConfig(
        breaker_open_for=0.05, breaker_open_cap=0.1, breaker_min_requests=3,
        forward_backoff_base=0.002, forward_backoff_cap=0.02)


def isolate_regions(inj, c) -> None:
    """Cut every link between the two regions, both ways (directional
    schedules: each region's own links stay up)."""
    for da in c.daemons:
        for db in c.daemons:
            if da.conf.data_center == "us" and db.conf.data_center == "eu":
                inj.set_fault(db.conf.grpc_listen_address,
                              from_peer=da.advertise_address, partition=True)
                inj.set_fault(da.conf.grpc_listen_address,
                              from_peer=db.advertise_address, partition=True)


def fed_totals(c, name, labels=None) -> float:
    return sum(d.metrics.sample(name, labels) for d in c.daemons)


def fed_counters(c) -> dict:
    env = "gubernator_tpu_federation_envelopes_total"
    return {
        "sent": fed_totals(c, env, {"result": "sent"}),
        "applied": fed_totals(c, env, {"result": "applied"}),
        "duplicates": fed_totals(c, env, {"result": "duplicate"}),
        "redeliveries": fed_totals(
            c, "gubernator_tpu_federation_redeliveries_total"),
        "degraded_answers": fed_totals(
            c, "gubernator_tpu_federation_degraded_answers_total")}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


async def region_answers(c, ids, limit=SERVE_LIMIT) -> list:
    """Every node's hits-0 MULTI_REGION answer (status, remaining) for
    ``bench_`` keys ``ids``."""
    out = []
    for d in c.daemons:
        rem = []
        for s in range(0, len(ids), SERVE_BATCH):
            rem += [(r.status, r.remaining) for r in await ask(d, raw_batch(
                b"bench", ids[s:s + SERVE_BATCH], hits=0, behavior=MR_BIT,
                limit=limit))]
        out.append(rem)
    return out


def federation_phase(torch, dev, keys=FED_KEYS, capacity=CLUSTER_CAPACITY,
                     window=4096, batches=FED_BATCHES, uniform=FED_UNIFORM,
                     partition_keys=FED_PARTITION_KEYS,
                     compare_capacity=FED_COMPARE_CAPACITY,
                     compare_steps=FED_COMPARE_STEPS):
    """Phase 11: four daemons over loopback gRPC in two regions
    (``Cluster(federation=True)``, ``FED_DCS``), each over a ``capacity``
    engine on ``dev``, each region's nodes prefilled with their ring
    shares of ``keys`` ``bench_`` keys.  A: ``batches`` serial batches of
    1000 MULTI_REGION hits over ``uniform`` keys, round robin over the
    nodes, then every key's count on every node of both regions; B: a WAN
    partition (the loss key, the over key, ``partition_keys`` keys hit on
    both sides) and its heal; C: the card cluster against a CPU cluster
    (``compare_federated``).  Returns ``(info, launches summed over the
    phase's paths)``."""
    import asyncio

    return asyncio.run(_federation(torch, dev, keys, capacity, window,
                                   batches, uniform, partition_keys,
                                   compare_capacity, compare_steps))


async def _federation(torch, dev, keys, capacity, window, batches, uniform,
                      partition_keys, compare_capacity, compare_steps):
    from gubernator_tpu_torch.cluster import Cluster
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.ops.engine import resolve_ticks
    from gubernator_tpu_torch.resilience import FaultInjector

    rng = np.random.default_rng(SEED + 50)
    info, launches, widths = {"nodes": len(FED_DCS), "regions": 2,
                              "keys_a_region": keys, "capacity": capacity,
                              "federation_interval_s": FED_INTERVAL}, {}, {}

    def path(name):
        return counted(torch, launches, name, widths)

    inj = FaultInjector(seed=SEED + 51)
    behaviors = BehaviorConfig(batch_timeout=BATCH_TIMEOUT_S,
                               global_sync_wait=0.02, batch_wait=0.001)
    c = await Cluster.start(
        len(FED_DCS), datacenters=list(FED_DCS), cache_size=capacity,
        tpu_max_batch=window, behaviors=behaviors,
        resilience=fed_resilience(), fault_injector=inj, federation=True,
        federation_interval=FED_INTERVAL)
    sizes = []
    try:
        engines = [d.instance.engine for d in c.daemons]
        assert all(e.table.device.type == dev.type for e in engines)
        for d in c.daemons:
            fed = d.instance.federation
            # Four nodes and every caller share one interpreter: an
            # envelope's RPC deadline is phase 7's forwarded batch's.
            fed.timeout = BATCH_TIMEOUT_S
            receive = fed.receive

            async def counting(env, receive=receive):
                sizes.append(len(env.records))
                return await receive(env)

            fed.receive = counting
        # Each region's ring shares of every key (FNV-1 in Python).
        t0 = time.perf_counter()
        blob, _ = key_blob(b"bench_", np.arange(keys))
        width = len(b"bench_") + 8
        names = [blob[i * width:(i + 1) * width].decode()
                 for i in range(keys)]
        where = {d.conf.grpc_listen_address: n
                 for n, d in enumerate(c.daemons)}
        node_of = {}
        for region, first in (("us", 0), ("eu", 2)):
            node_of[region] = np.fromiter(
                (where[p.info.grpc_address] for p in
                 c.daemons[first].instance.local_picker.get_batch(names)),
                np.int8, count=keys)
        del names, blob
        info["ring_lookup_s"] = time.perf_counter() - t0
        shares = [int((node_of[dc] == n).sum())
                  for n, dc in enumerate(FED_DCS)]
        info["shares"] = shares
        assert max(shares) <= capacity - capacity // 64, shares
        t0 = time.perf_counter()
        with path("prefill"):
            for n, eng in enumerate(engines):
                mine = np.flatnonzero(node_of[FED_DCS[n]] == n)
                pending = []
                for s in range(0, len(mine), window):
                    ids = mine[s:s + window]
                    pending.append(eng.submit_cols(serve_columns(
                        reqcols, b"bench", ids, algorithm=ids & 1)))
                    if len(pending) == 16 or s + window >= len(mine):
                        resolve_ticks([h for b in pending
                                       for h in b.handles()])
                        for b in pending:
                            mat, errs = b.matrix()
                            assert not errs
                            assert (mat[2] == SERVE_LIMIT - 1).all()
                        pending = []
                assert len(eng.slots) == shares[n]
        info["prefill_s"] = time.perf_counter() - t0

        # A: healthy exchange.  Token keys (even ids), one-hour buckets of
        # a million, each prefilled with one hit in each region.
        pool = rng.choice(np.arange(0, keys, 2), uniform, replace=False)
        sent = np.zeros(uniform, np.int64)
        c0 = fed_counters(c)
        lat = []
        with path("global"):
            t0 = time.perf_counter()
            for j in range(batches):
                pick = rng.integers(0, uniform, SERVE_BATCH)
                np.add.at(sent, pick, 1)
                t1 = time.perf_counter()
                await ask(c.daemons[j % len(c.daemons)], raw_batch(
                    b"bench", pool[pick], behavior=MR_BIT))
                lat.append((time.perf_counter() - t1) * 1e3)
            t_last = time.perf_counter()
        with path("apply"):
            await c.wait_for_quiet(timeout=300)
            converge_ms = (time.perf_counter() - t_last) * 1e3
        # A non-owner holds a GLOBAL key's state once its owner broadcast
        # it: every node answers every key that took hits.
        hit = np.flatnonzero(sent)
        answers = await region_answers(c, pool[hit])
        want = [(0, SERVE_LIMIT - 1 - int(h)) for h in sent[hit]]
        errors = [sum(a != w for a, w in zip(node, want))
                  for node in answers]
        wrong = [(n, int(pool[hit[i]]), a, w)
                 for n, node in enumerate(answers)
                 for i, (a, w) in enumerate(zip(node, want)) if a != w]
        ca = delta(fed_counters(c), c0)
        info["healthy"] = {
            "batches": batches, "keys": uniform, "hits": int(sent.sum()),
            "keys_checked": int(len(hit)),
            "decisions_per_s": batches * SERVE_BATCH / (t_last - t0),
            "serial_p50_ms": float(np.percentile(lat, 50)),
            "serial_p99_ms": float(np.percentile(lat, 99)),
            "federation_converge_ms": converge_ms,
            "count_errors_by_node": errors, "count_errors": wrong[:8],
            "envelopes_sent": ca["sent"], "envelopes_applied": ca["applied"],
            "records_per_envelope_mean": float(np.mean(sizes)),
            "records_per_envelope_max": int(max(sizes)),
            "redeliveries": ca["redeliveries"],
            "degraded_answers": ca["degraded_answers"],
            "duplicates": ca["duplicates"]}
        info["federation_converge_ms"] = converge_ms
        batch_limit = c.daemons[0].instance.federation.batch_limit
        assert not any(errors), info["healthy"]
        assert ca["applied"] == ca["sent"] > 0, ca
        assert max(sizes) <= batch_limit, max(sizes)
        assert ca["redeliveries"] == ca["degraded_answers"] == 0, ca

        # B: partition and heal.
        info["partition"] = await partition_round(
            c, inj, rng, keys, pool, partition_keys, path)
    finally:
        await c.stop()
    del engines, c

    with path("compare"):
        info["compare"] = await compare_federated(
            compare_capacity, window, compare_steps)
    info["launches_by_path"] = launches
    info["launches_by_width"] = widths
    total = {}
    for per in launches.values():
        for name, n in per.items():
            total[name] = total.get(name, 0) + n
    assert launches["apply"]["fused_tick"] > 0, "no B.1 launch on apply"
    return info, total


async def partition_round(c, inj, rng, keys, used, partition_keys, path):
    """The rung's partition on the live cluster: a warm-up hit each side
    on the loss key, every link between the regions cut, the loss key's
    hits on each region's owner, the over key driven to OVER_LIMIT on
    each side, ``partition_keys`` keys taking ``FED_PARTITION_HITS`` on
    each side; then the heal, and every count on every node."""
    from gubernator_tpu_torch.types import RateLimitRequest

    name = "fedbench"

    def mr(key, hits, limit):
        return RateLimitRequest(name=name, unique_key=key, hits=hits,
                                limit=limit, duration=SERVE_DURATION,
                                behavior=MR_BIT)

    owners = {r: {k: c.find_owning_daemon_in_region(name, k, r)
                  for k in ("loss", "over")} for r in ("us", "eu")}
    region_nodes = {r: [d for d in c.daemons if d.conf.data_center == r]
                    for r in ("us", "eu")}
    for r in ("us", "eu"):
        (out,) = await cluster_call(owners[r]["loss"],
                                    [mr("loss", 1, SERVE_LIMIT)])
        assert out.error == ""
    sent = 2
    await c.wait_for_quiet(timeout=120)
    free = np.setdiff1d(np.arange(0, keys, 2), used)
    part = rng.choice(free, partition_keys, replace=False)
    c0 = fed_counters(c)
    isolate_regions(inj, c)
    t0 = time.perf_counter()
    with path("partition"):
        for r, n in FED_LOSS_HITS:
            for _ in range(n):
                (out,) = await cluster_call(owners[r]["loss"],
                                            [mr("loss", 1, SERVE_LIMIT)])
                assert out.error == "", out.error
                sent += 1
        admitted = 0
        for r in ("us", "eu"):
            for _ in range(2 * FED_OVER_LIMIT):
                (out,) = await cluster_call(owners[r]["over"],
                                            [mr("over", 1, FED_OVER_LIMIT)])
                assert out.error == "", out.error
                if out.status == 1:
                    break
                admitted += 1
        for r in ("us", "eu"):
            for j, s in enumerate(range(0, len(part), SERVE_BATCH)):
                await ask(region_nodes[r][j % 2], raw_batch(
                    b"bench", part[s:s + SERVE_BATCH],
                    hits=FED_PARTITION_HITS, behavior=MR_BIT))
        await c.wait_for_quiet(timeout=120, federation=False)
        pending = [d.instance.federation.pending_keys() for d in c.daemons]
    partition_s = time.perf_counter() - t0
    cp = delta(fed_counters(c), c0)
    inj.clear()
    t_heal = time.perf_counter()
    with path("heal"):
        await c.wait_for_quiet(timeout=300)
        heal_s = time.perf_counter() - t_heal
    landed = {}
    for r in ("us", "eu"):
        (out,) = await cluster_call(owners[r]["loss"],
                                    [mr("loss", 0, SERVE_LIMIT)])
        landed[r] = SERVE_LIMIT - out.remaining
    loss = sum(abs(sent - v) for v in landed.values())
    answers = await region_answers(c, part)
    want = (0, SERVE_LIMIT - 1 - 2 * FED_PARTITION_HITS)
    union_errors = [sum(a != want for a in node) for node in answers]
    ch = delta(fed_counters(c), c0)
    out = {
        "loss_key_sent": sent, "loss_key_landed": landed,
        "federation_hit_loss_after_heal": int(loss),
        "over_limit": FED_OVER_LIMIT, "over_admitted": admitted,
        "federation_over_admission_ratio":
            max(0, admitted - FED_OVER_LIMIT) / FED_OVER_LIMIT,
        "partition_keys": int(partition_keys),
        "partition_union_errors_by_node": union_errors,
        "pending_keys_at_heal": pending, "partition_s": partition_s,
        "heal_to_converge_s": heal_s,
        "redeliveries": cp["redeliveries"],
        "degraded_answers": cp["degraded_answers"],
        "envelopes_sent": ch["sent"], "envelopes_applied": ch["applied"],
        "duplicates": ch["duplicates"]}
    assert loss == 0 and not any(union_errors), out
    assert out["federation_over_admission_ratio"] <= 1.0, out
    assert cp["redeliveries"] > 0 and cp["degraded_answers"] > 0, out
    assert ch["applied"] == ch["sent"], out
    return out


FED_COMPARE_KEYS = 24


def fed_item(rng, kk: int, k: int, partitioned: bool) -> dict:
    """One MULTI_REGION item on key ``kk`` of the compare sequence at step
    ``k``: even keys token buckets of 1000 over an hour, odd keys leaky
    buckets of 600 over a minute (ten whole tokens a step); RESET,
    negative hits and explicit ``created_at`` only outside the partition,
    where the regions apply every delta in the order it was made.  No
    item has zero hits: a hits-0 item creates a bucket on the node that
    answers it and reaches no other node (GLOBAL and federation queue
    only hits), so the regions' buckets would start at different times."""
    token = kk % 2 == 0
    f = dict(name="fm", unique_key=spread_key(700 + kk),
             hits=int(rng.choice([1, 2, 3] if partitioned
                                 else [-1, 1, 2, 3])),
             limit=1000 if token else 600,
             duration=3_600_000 if token else 60_000,
             algorithm=0 if token else 1, behavior=MR_BIT)
    if not partitioned:
        if rng.random() < 0.15:
            f["behavior"] |= 8     # RESET_REMAINING
        if rng.random() < 0.3:
            f["created_at"] = NOW + 1000 * k - int(rng.integers(0, 500))
    return f


async def drive_federated(c, inj, make, seed: int, clock, steps: int,
                          cut: tuple, timeout: float = 120.0) -> tuple:
    """A seeded serial MULTI_REGION sequence through a 2-region cluster
    under the pinned clock ``clock``: step k a batch to node k % 4, every
    change waited for in both regions; the regions cut apart from step
    ``cut[0]`` to ``cut[1]`` (the partition's steps touch only token keys
    already in both regions, positive hits, no RESET: the deltas a
    partition can reorder without changing a bucket).  Returns every
    answer without its ``owner`` metadata and each node's final hits-0
    answer (status, remaining, limit, reset_time) a key."""
    rng = np.random.default_rng(seed)
    answers, touched = [], set()
    for k in range(steps):
        clock[0] = NOW + 1000 * k
        if k == cut[0]:
            isolate_regions(inj, c)
        if k == cut[1]:
            inj.clear()
        partitioned = cut[0] <= k < cut[1]
        pool = (sorted(kk for kk in touched if kk % 2 == 0) if partitioned
                else range(FED_COMPARE_KEYS))
        pick = rng.choice(list(pool), size=min(len(pool), int(
            rng.integers(1, 8))), replace=False)
        fields = [fed_item(rng, int(kk), k, partitioned) for kk in pick]
        touched.update(int(kk) for kk in pick)
        answers.append(strip_owner(await cluster_call(
            c.daemons[k % len(c.daemons)], [make(**f) for f in fields],
            timeout)))
        await c.wait_for_quiet(timeout=timeout, federation=not partitioned)
    clock[0] = NOW + 1000 * steps
    final = []
    probes = [fed_item(rng, kk, steps, True) for kk in range(
        FED_COMPARE_KEYS)]
    for d in c.daemons:
        got = await cluster_call(d, [make(**dict(f, hits=0)) for f in probes],
                                 timeout)
        final.append([(r.status, r.remaining, r.limit, r.reset_time, r.error)
                      for r in got])
    return answers, final


async def compare_federated(capacity, window, steps, seed=SEED + 52):
    """Phase 11 C: a 2-region, 4-node cluster of ``capacity``-slot engines
    on the card against the same cluster on the CPU, on one seeded serial
    MULTI_REGION sequence with one partition and heal (drive_federated):
    the answers of every step equal, every node's final answer a key
    equal in both clusters, and both regions' owners agreeing."""
    from gubernator_tpu_torch import types
    from gubernator_tpu_torch.cluster import Cluster
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.resilience import FaultInjector

    behaviors = BehaviorConfig(batch_timeout=BATCH_TIMEOUT_S,
                               global_sync_wait=0.02, batch_wait=0.001)
    cut = (steps // 2, steps // 2 + 4)
    runs = []
    with pinned_clock(NOW) as clock:
        for platform in ("", "cpu"):
            inj = FaultInjector(seed=seed)
            c = await Cluster.start(
                len(FED_DCS), datacenters=list(FED_DCS),
                cache_size=capacity, tpu_max_batch=window,
                behaviors=behaviors, resilience=fed_resilience(),
                fault_injector=inj, federation=True,
                federation_interval=FED_INTERVAL, tpu_platform=platform)
            try:
                runs.append(await drive_federated(
                    c, inj, types.RateLimitRequest, seed, clock, steps,
                    cut))
                owners = [[c.daemons.index(c.find_owning_daemon_in_region(
                    "fm", spread_key(700 + kk), r))
                    for kk in range(FED_COMPARE_KEYS)] for r in ("us", "eu")]
                runs[-1] += (owners,)
            finally:
                await c.stop()
    (card, card_final, card_own), (cpu, cpu_final, cpu_own) = runs
    for k, (x, y) in enumerate(zip(card, cpu)):
        assert x == y, f"step {k}: card and CPU clusters answer differently"
    assert card_final == cpu_final, ("final answers differ", [
        (n, kk, a, b) for n, (x, y) in enumerate(zip(card_final, cpu_final))
        for kk, (a, b) in enumerate(zip(x, y)) if a != b][:6])
    for final, own in ((card_final, card_own), (cpu_final, cpu_own)):
        for kk in range(FED_COMPARE_KEYS):
            us, eu = (final[own[i][kk]][kk] for i in (0, 1))
            assert us == eu, (kk, us, eu)
    return {"steps": steps, "cut": list(cut),
            "answers": sum(len(x) for x in card),
            "keys": FED_COMPARE_KEYS, "final_equal_nodes": len(card_final)}




def day_demand(i: int) -> float:
    """The rung's demand trace, offered windows/s: night, a morning ramp
    to a peak, a midday dip, an evening ramp and peak, night again."""
    if i < 16:
        return 100.0
    if i < 32:
        return 100.0 + 31.25 * (i - 15)
    if i < 48:
        return 600.0
    if i < 60:
        return 200.0
    if i < 68:
        return 200.0 + 50.0 * (i - 59)
    if i < 76:
        return 600.0
    return 100.0


def diurnal_day(eng, loop, coord, send_window, sweep,
                serve_s: float = DAY_SERVE_S, steps: int = DAY_STEPS):
    """The rung's closed loop on a live mesh: 96 control windows of 15
    simulated minutes on a ``ManualClock``, the demand trace through the
    rung's queueing model (p99 = base / (1 - utilisation), queue depth the
    backlog over capacity, utilisation demand over the coordinator's real
    shard count), ``AutoscalePolicy`` / ``Autoscaler`` with the rung's
    policy, cooldowns and flap cap, dry run off, every actuation a live
    ``ReshardCoordinator.try_reshard`` while a load thread sends
    ``send_window(rng)`` windows through ``loop``.  State loss is the
    coordinator's audit and ``sweep()``'s rows before and after; flaps are
    rolling-hour breaches of the cap on the committed actuations."""
    import asyncio
    import threading

    from gubernator_tpu_torch.admission import SHED_RESHARD_MSG
    from gubernator_tpu_torch.autoscale import (
        Autoscaler, AutoscalePolicy, PolicyConfig, SignalSnapshot)
    from gubernator_tpu_torch.autoscale.controller import FLAP_WINDOW_S
    from gubernator_tpu_torch.resilience import ManualClock

    before = sweep()
    clock = ManualClock()
    cur = {"demand": day_demand(0)}

    def sample():
        shards = int(coord.status()["shards"])
        util = cur["demand"] / (DAY_CAP * shards)
        return SignalSnapshot(
            ts=clock(),
            queue_depth=int(max(0.0, cur["demand"] - DAY_CAP * shards) * 2),
            p99_ms=min(50.0, DAY_BASE_MS / max(0.02, 1.0 - util)),
            hot_occupancy=min(1.0, util), shards=shards,
            reshard_busy=coord.is_busy())

    events = record_freezes(loop)
    lat_busy, stop, failures = [], threading.Event(), []
    counts = {"shed": 0, "served": 0}

    def drive():
        drng = np.random.default_rng(SEED + 41)
        try:
            while not stop.is_set():
                cols = send_window(drng)
                busy = coord.is_busy()
                t0 = time.perf_counter()
                _, errs = loop.submit_columns(cols).result(timeout=120)
                dt_ms = (time.perf_counter() - t0) * 1e3
                busy = busy or coord.is_busy()
                shed = sum(1 for v in errs.values() if v == SHED_RESHARD_MSG)
                assert len(errs) == shed, set(errs.values())
                if shed:
                    counts["shed"] += shed   # retriable, not lost
                    time.sleep(RESHARD_BACKOFF_S)
                else:
                    counts["served"] += 1
                    if busy:
                        lat_busy.append(dt_ms)
        except BaseException as e:  # surfaced after the join
            failures.append(e)

    actuations = []

    def exec_reshard(target):
        t0 = time.perf_counter()
        res = coord.try_reshard(int(target))
        t1 = time.perf_counter()
        actuations.append((clock(), res, {
            "from": res.get("from_shards"), "to": res.get("to_shards"),
            "outcome": res.get("outcome"), "seconds": t1 - t0,
            "frozen_s": frozen_seconds(events, t0, t1)}))
        time.sleep(serve_s)   # a beat of load on the new layout
        return res

    scaler = Autoscaler(
        sample, exec_reshard, policy=AutoscalePolicy(PolicyConfig(
            **DAY_POLICY)),
        interval=DAY_STEP_S, cooldown_up=DAY_COOLDOWNS[0],
        cooldown_down=DAY_COOLDOWNS[1], max_per_hour=DAY_MAX_PER_HOUR,
        dry_run=False, ring_size=steps, clock=clock, sleep=clock.sleep)
    saved = [0.0]
    path = [int(coord.status()["shards"])]

    async def day():
        for i in range(steps):
            cur["demand"] = day_demand(i)
            await scaler.step()
            after = int(coord.status()["shards"])
            if after != path[-1]:
                path.append(after)
            saved[0] += (8 - after) * DAY_STEP_S
            clock.advance(DAY_STEP_S)

    loader = threading.Thread(target=drive, name="autoscale-load")
    t_day = time.perf_counter()
    loader.start()
    try:
        asyncio.run(day())
    finally:
        stop.set()
        loader.join(timeout=180)
    if failures:
        raise failures[0]
    assert not loader.is_alive()
    day_s = time.perf_counter() - t_day
    results = [r for _, r, _ in actuations]
    committed = [t for t, r, _ in actuations
                 if r.get("outcome") == "committed"]
    rows = sweep()
    sweep_errors = int((rows != before).any(axis=1).sum())
    loss = max(sum(r.get("state_loss", 0) for r in results), sweep_errors)
    flaps = 0
    for t0 in committed:
        in_hour = sum(1 for t in committed if 0 <= t - t0 <= FLAP_WINDOW_S)
        flaps = max(flaps, in_hour - DAY_MAX_PER_HOUR)
    vetoes = {}
    for d in scaler.ring:
        if d.action == "veto":
            vetoes[d.reason] = vetoes.get(d.reason, 0) + 1
    return {
        "shards_path": "->".join(str(x) for x in path),
        "autoscale_transitions": len(committed),
        "autoscale_state_loss": int(loss),
        "sweep_keys": int(len(before)), "sweep_errors": sweep_errors,
        "double_served": int(sum(r.get("double_served", 0)
                                 for r in results)),
        "parity_errors": int(sum(r.get("parity_errors", 0)
                                 for r in results)),
        "autoscale_flaps": int(max(0, flaps)),
        "autoscale_p99_during_transition_ms": (
            float(np.percentile(lat_busy, 99)) if lat_busy else None),
        "windows_during_transitions": len(lat_busy),
        "chip_seconds_saved": saved[0],
        "static8_chip_seconds": 8 * DAY_STEP_S * steps,
        "autoscale_vetoes": vetoes,
        "autoscale_shed_retriable": counts["shed"],
        "served_windows": counts["served"],
        "transitions": [a for _, _, a in actuations],
        "decisions": {a: sum(1 for d in scaler.ring if d.action == a)
                      for a in ("act", "hold", "veto")},
        "live_items": int(eng.cache_size()),
        "sim_day_s": DAY_STEP_S * steps, "day_wall_s": day_s,
    }


def autoscale_day(torch, dev, keys=1 << 10, n_shards=8, local_capacity=1 << 9,
                  width=256, serve_s=DAY_SERVE_S, steps=DAY_STEPS):
    """The day of :func:`diurnal_day` on a fresh mesh of ``n_shards`` x
    ``local_capacity`` slots on ``dev`` holding ``keys`` prefilled keys
    behind a tick loop: the load sends ``width``-wide Zipf(1.2) windows
    of the prefill's request over the first half of the keys, and the
    sweep reads every key of the other half (the rung's CPU size by
    default)."""
    from gubernator_tpu_torch.ops import reqcols
    from gubernator_tpu_torch.parallel.mesh_engine import MeshTickEngine
    from gubernator_tpu_torch.parallel.reshard import ReshardCoordinator
    from gubernator_tpu_torch.service.tickloop import TickLoop

    eng = MeshTickEngine(n_shards, local_capacity, max_batch=width,
                         device=dev)
    ids = route_ids(b"d", n_shards, [keys // n_shards] * n_shards)
    prefill_mesh(reqcols, eng, b"d", ids, width)
    traffic, swept = ids[:len(ids) // 2], ids[len(ids) // 2:]
    loop = TickLoop(eng, batch_wait=0.0005, batch_limit=width)
    coord = ReshardCoordinator(eng, tick_loop=loop, freeze_timeout=60.0)
    try:
        return diurnal_day(
            eng, loop, coord,
            lambda rng: herd_columns(
                reqcols, b"d", traffic[(rng.zipf(1.2, width) - 1)
                                       % len(traffic)], token_prefill=True),
            lambda: sweep_rows(eng, b"d", swept), serve_s=serve_s,
            steps=steps)
    finally:
        loop.close()


AUTOSCALE_NODE_CACHE = 1 << 20    # phase 12 B: 8 shards of 2^17 slots
AUTOSCALE_NODE_KEYS = 16_000
AUTOSCALE_NODE_INTERVALS = 10


def http_get(url: str):
    """``(status, body text)`` of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def autoscale_counters(text: str) -> dict:
    """The three autoscaler families' samples in a /metrics text."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith("gubernator_tpu_autoscale_") and "_total{" in ln:
            k, v = ln.rsplit(" ", 1)
            out[k] = float(v)
    return out


def autoscaler_node(torch, dev, cache=AUTOSCALE_NODE_CACHE,
                    keys=AUTOSCALE_NODE_KEYS,
                    intervals=AUTOSCALE_NODE_INTERVALS):
    """Phase 12 B: a port daemon on ``dev`` over an 8-shard mesh of
    ``cache`` slots (``GUBER_TPU_MESH_SHARDS=8``) with its own autoscaler
    (``GUBER_AUTOSCALE_ENABLED=1``, 0.2 s interval, dry run, 4 to 8
    shards, a 200 ms p99 target) and the debug endpoints, ``keys`` keys
    sent over gRPC.  After ``intervals`` intervals the dry-run decisions
    (act, the node still at 8 shards), then the coordinator's lock held
    for ``intervals / 2`` intervals as an admin transition would
    (reshard_busy vetoes), then dry run off: one real transition 8 -> 4
    through ``V1Instance.reshard``, the keys answering as before it; the
    three counter families read from ``/metrics`` before and after."""
    import asyncio

    return asyncio.run(_autoscaler_node(torch, dev, cache, keys, intervals))


async def _autoscaler_node(torch, dev, cache, keys, intervals):
    import asyncio

    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.transport.daemon import spawn_daemon

    interval = 0.2
    knobs = dict(
        GUBER_GRPC_ADDRESS="127.0.0.1:0", GUBER_HTTP_ADDRESS="127.0.0.1:0",
        GUBER_TPU_PLATFORM="cpu" if dev.type == "cpu" else "",
        GUBER_TPU_MESH_SHARDS="8", GUBER_CACHE_SIZE=str(cache),
        GUBER_TPU_MAX_BATCH="4096", GUBER_DEBUG_ENDPOINTS="1",
        GUBER_AUTOSCALE_ENABLED="1", GUBER_AUTOSCALE_INTERVAL="200ms",
        GUBER_AUTOSCALE_DRY_RUN="1", GUBER_AUTOSCALE_MIN_SHARDS="4",
        GUBER_AUTOSCALE_MAX_SHARDS="8", GUBER_AUTOSCALE_TARGET_P99_MS="200")
    with env_knobs(**knobs):
        d = await spawn_daemon(setup_daemon_config())
    info = {"cache": cache, "keys": keys, "interval_s": interval}
    try:
        inst = d.instance
        scaler = inst.autoscaler
        url = f"http://{d.conf.http_listen_address}"
        assert inst.engine.n_shards == 8 and scaler.dry_run
        ids = np.arange(keys)
        for s in range(0, keys, SERVE_BATCH):
            await ask(d, raw_batch(b"auto", ids[s:s + SERVE_BATCH]))
        probe = ids[::16]
        before = [r.remaining for r in await ask(d, raw_batch(
            b"auto", probe, hits=0))]
        _, text0 = await asyncio.to_thread(http_get, url + "/metrics")
        await asyncio.sleep(interval * (intervals + 0.5))
        st, body = await asyncio.to_thread(http_get,
                                           url + "/debug/autoscaler")
        body = json.loads(body)
        assert st == 200 and body["dry_run"] is True, (st, body)
        acts = [x for x in body["decisions"] if x["action"] == "act"]
        info["dry_run"] = {
            "decisions": len(body["decisions"]), "acts": len(acts),
            "act_targets": sorted({(x["from_shards"], x["to_shards"])
                                   for x in acts}),
            "shards_after": inst.engine.n_shards,
            "last_signals": body["decisions"][-1]["signals"]}
        assert acts and all(x["dry_run"] for x in acts), body["decisions"]
        assert inst.engine.n_shards == 8
        _, state = await asyncio.to_thread(http_get, url + "/debug/state")
        state = json.loads(state)
        assert "autoscaler" in state and "decisions" not in \
            state["autoscaler"], state.keys()
        info["state_autoscaler"] = sorted(state["autoscaler"])
        # An admin transition holding the coordinator's lock: the
        # controller vetoes (reshard_busy) instead of waiting.
        coord = inst.reshard_coord
        assert coord._lock.acquire(blocking=False)
        try:
            await asyncio.sleep(interval * (intervals // 2 + 0.5))
        finally:
            coord._lock.release()
        scaler.dry_run = False
        t0 = time.perf_counter()
        while not (scaler.ring[-1].action == "act"
                   and not scaler.ring[-1].dry_run):
            assert time.perf_counter() - t0 < 120, "no armed transition"
            await asyncio.sleep(0.05)
        info["armed_transition_s"] = time.perf_counter() - t0
        after = [r.remaining for r in await ask(d, raw_batch(
            b"auto", probe, hits=0))]
        _, text1 = await asyncio.to_thread(http_get, url + "/metrics")
        c0, c1 = autoscale_counters(text0), autoscale_counters(text1)
        moved = {k: v - c0.get(k, 0.0) for k, v in c1.items()
                 if v != c0.get(k, 0.0)}
        last = scaler.ring[-1].as_dict()
        info["armed"] = {
            "decision": {k: last[k] for k in (
                "action", "direction", "from_shards", "to_shards",
                "outcome", "dry_run")},
            "reshard": {k: inst.reshard_status()["last"].get(k) for k in (
                "outcome", "from_shards", "to_shards", "live_items",
                "state_loss", "double_served", "parity_errors",
                "duration_s")},
            "shards_after": inst.engine.n_shards,
            "probe_keys": len(probe),
            "probe_changed": int(sum(a != b for a, b in zip(before, after)))}
        info["counters_moved"] = moved
        assert last["outcome"] == "committed" and last["to_shards"] == 4 \
            and inst.engine.n_shards == 4, info["armed"]
        assert info["armed"]["probe_changed"] == 0, info["armed"]
        assert info["armed"]["reshard"]["state_loss"] == 0, info["armed"]
        for fam in ("decisions", "vetoes", "transitions"):
            assert any(k.startswith(f"gubernator_tpu_autoscale_{fam}_total")
                       for k in moved), (fam, moved)
    finally:
        await d.close()
    return info


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
    serve, serve_launches, leases, lease_launches = serve_phase(torch, dev)
    print("phase6 " + json.dumps(serve), flush=True)
    cluster, cluster_launches = cluster_phase(torch, dev)
    print("phase7 " + json.dumps(cluster), flush=True)
    print("phase8 " + json.dumps(leases), flush=True)
    gmesh, gmesh_launches = global_phase(
        torch, dev, grpc_converge_ms=cluster["global_converge_ms"])
    print("phase9 " + json.dumps(gmesh), flush=True)
    resh, resh_launches, day = reshard_phase(torch, dev)
    print("phase10 " + json.dumps(resh), flush=True)
    fed, fed_launches = federation_phase(torch, dev)
    print("phase11 " + json.dumps(fed), flush=True)
    auto_launches, auto_widths = {}, {}
    with counted(torch, auto_launches, "node", auto_widths):
        node = autoscaler_node(torch, dev)
    node["launches_by_path"] = auto_launches
    node["launches_by_width"] = auto_widths
    print("phase12 " + json.dumps({"day": day, "node": node}), flush=True)
    assert day["autoscale_transitions"] >= 2, day
    assert day["autoscale_state_loss"] == day["autoscale_flaps"] == 0, day
    assert day["parity_errors"] == day["double_served"] == 0, day
    assert day["b2_launches"]["gather_rows"] > 0, day
    day_launches = day["launches_by_path"]["autoscale"]
    for name in launches:
        launches[name] += (mesh_launches[name] + tier_launches[name]
                           + serve_launches[name] + cluster_launches[name]
                           + lease_launches[name] + gmesh_launches[name]
                           + resh_launches[name] + fed_launches[name]
                           + day_launches[name] + auto_launches["node"][name])
        assert launches[name] > 0, f"{name} was not launched on the main path"
    # The ticks', the lease window's and the GLOBAL mesh kernels' launches
    # by lane width over the ten phases' paths.
    widths = {}
    for phase in (info, mesh, tiers, serve, cluster, leases, gmesh, resh,
                  fed, day, node):
        for per_path in phase["launches_by_width"].values():
            for name, counts in per_path.items():
                for w, c in counts.items():
                    widths.setdefault(name, {})
                    widths[name][w] = widths[name].get(w, 0) + c
    print("launch_widths " + json.dumps(
        {k: dict(sorted(v.items())) for k, v in widths.items()}), flush=True)

    table = []
    for name in ("fused_tick", "fused_merged_tick", "fused_ragged_tick",
                 "fused_sorted_tick", "mesh_tile_tick", "gather_rows",
                 "scatter_rows",
                 "lease_apply", "global_accumulate", "global_dense_reconcile",
                 "global_sparse_probe", "global_sparse_apply"):
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
