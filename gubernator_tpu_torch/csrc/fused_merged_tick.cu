// Fused merged tick for Hopper (sm_90a): unique heads of duplicate groups.
//
// Replaces the TPU kernel gubernator_tpu/ops/fusedtick.py
// make_fused_merged_tick_fn (kernel body _kernel with merged=True): the
// fused tick of fused_tick.cu over a window of slot-sorted unique head
// lanes, each carrying the size `count` of its duplicate group, with the
// closed-form duplicate fold (transition.cuh merged_fold) applied to the
// head's row before it is stored, and a row-major (U, 24) int32 MERGED24
// journal row per head (the compact response, the fold's base, q,
// rate_i, s0 and expire, and the echoed request parameters) from which
// the member expansion (ops/tick.py expand_rowmajor) derives every
// member's response.
//
// Bound: memory.  Per live head 128 B read + 128 B written of row, 76 B of
// request and 4 B of count, 96 B of journal: 432 B.  An 8192-head window
// (the grouped plan of a 32768-wide Zipf(1.2) herd window) moves 3.5 MB,
// about 1.06 us at 3.35 TB/s; a 512-head layer of the layered plan 0.07 us.
// Rows are random 128-B lines, so each costs a full DRAM burst each way.
//
// What held the one-thread-a-head design at 8-100x that bound was not the
// bytes: a copy of the same memory work took 0.0032-0.0035 ms against its
// 0.008-0.0088, and phase stamps put ~2.7 us of a head's chain in the
// transition (token, leaky and zoo heads share a warp, so it runs each
// path in turn) and ~0.7 us in the fold's two 64-bit divisions; a
// 512-head layer ran on 4 SMs (PERF.md §6, step 0 of the merged tick).
//
// Design: the fused tick's tile body (tile.cuh) with the MergedOut policy.
// A block of 256 threads owns 64 heads: it loads their request words and
// group sizes in one round, stages the live rows in shared memory by
// cp.async, sorts the heads into algorithm classes so that each warp runs
// one path (zoo warps never enter the fold), transitions and folds each
// staged row in place, stages each head's 24 journal words in shared
// memory, then writes the rows back in place and the tile's journal rows
// as one contiguous run of 16-B stores.  The fold's divisions take 32-bit
// operands when they fit (transition.cuh merged_fold).  A launch of at
// most 8 heads runs one thread a head in registers.  Heads with
// valid == 0 or a slot outside [0, capacity) (padding aims at capacity)
// touch no row and get a zero journal row.  The plans make heads unique
// slots, so the in-place update is race free; the TPU kernel's 20th
// request row, chunk ring, DMA semaphores and one-hot MXU transposes have
// no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

__global__ void __launch_bounds__(gt::TILE_THREADS)
    fused_merged_tick_kernel(int64_t* __restrict__ table, int64_t capacity,
                             const int32_t* __restrict__ m32, int64_t ld_m,
                             const int32_t* __restrict__ count,
                             int32_t* __restrict__ journal, int64_t lanes,
                             int64_t now) {
  gt::tile_tick(table, m32, ld_m, lanes, now, gt::SlotPlace{capacity},
                gt::MergedOut{count, journal});
}

}  // namespace

extern "C" int gt_fused_merged_tick(int64_t* table, int64_t capacity,
                                    const int32_t* m32, int64_t ld_m,
                                    const int32_t* count, int32_t* journal,
                                    int64_t lanes, int64_t now,
                                    void* stream) {
  return gt::launch_tiles(fused_merged_tick_kernel, lanes, stream, table,
                          capacity, m32, ld_m, count, journal, lanes, now);
}
