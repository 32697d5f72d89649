// Fused unique-slot tick for Hopper (sm_90a).
//
// Replaces the TPU kernel gubernator_tpu/ops/fusedtick.py
// make_fused_tick_fn (kernel body _kernel): for each lane of a slot-sorted
// window with at most one live lane per slot, gather the lane's table row,
// apply the full five-algorithm transition, scatter the row back in place,
// and emit the compact (6, B) int32 response.
//
// Bound: memory.  Per live lane 128 B read + 128 B written of table row,
// 76 B of request and 24 B of response: a 32768-lane window moves ~12 MB,
// ~3.5 us at 3.35 TB/s.  Rows are random 128-B lines, one DRAM burst each.
//
// What held the one-thread-a-lane design at 3.4x that bound was not the
// bytes: a copy of the same memory work took a third of its time, and
// each warp ran the token and leaky formulas for all 32 of its lanes
// (three float64 divisions) and then each zoo algorithm's path in turn,
// since the algorithms are mixed within a warp (PERF.md §6, step 0).
//
// Design (tile.cuh): a block of 256 threads owns a tile of 64 lanes.  It
// loads the requests in one round, stages the live rows in shared memory
// (no guard-row read for padding and error lanes), sorts the lanes into
// classes so that every warp runs one algorithm's path (transition.cuh
// transition_class computes only that path's quantities, and floor
// division takes 32-bit operands when they fit), then writes the rows
// back in place and the responses in lane order, coalesced.  A launch of
// at most 8 lanes runs one thread a lane in registers.  Lanes with
// valid == 0 or a slot outside [0, capacity) touch no row and answer
// zeros.  The tile's phases still run one after another within a block,
// so at full width the card moves bytes, then computes, then moves bytes
// again; PERF.md has the split.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

__global__ void __launch_bounds__(gt::TILE_THREADS)
    fused_tick_kernel(int64_t* __restrict__ table, int64_t capacity,
                      const int32_t* __restrict__ m32, int64_t ld_m,
                      int32_t* __restrict__ resp, int64_t ld_r, int64_t lanes,
                      int64_t now) {
  gt::tile_tick(table, m32, ld_m, lanes, now, gt::SlotPlace{capacity},
                gt::RespOut{resp, ld_r});
}

}  // namespace

extern "C" int gt_fused_tick(int64_t* table, int64_t capacity,
                             const int32_t* m32, int64_t ld_m, int32_t* resp,
                             int64_t ld_r, int64_t lanes, int64_t now,
                             void* stream) {
  return gt::launch_tiles(fused_tick_kernel, lanes, stream, table, capacity,
                          m32, ld_m, resp, ld_r, lanes, now);
}
