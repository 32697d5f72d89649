// Ragged fused tick for Hopper (sm_90a): every shard's extent in one launch.
//
// Replaces the TPU kernel gubernator_tpu/ops/raggedtick.py
// make_fused_ragged_tick_fn (kernel body _ragged_kernel), which the JAX
// mesh engine runs once per shard under shard_map and gathers with a psum.
// On one card the shards are slot ranges of one table: shard s owns rows
// [s * (L + 1), (s + 1) * (L + 1)), L = local_capacity, the last of them its
// guard row.  The window is one slot-sorted (19, B) REQ32 matrix of GLOBAL
// slots, and the (n_shards + 1,) int32 cumulative `offsets` vector on the
// device gives shard s the lanes [offsets[s], offsets[s + 1]).  Extents are
// disjoint, so the psum's sum is the union of the shards' lanes: one launch
// walks them all.
//
// Bound: memory, as the fused tick.  Per live lane 128 B read + 128 B
// written of row, 76 B of request and 24 B of response: a 32768-lane
// window moves ~12 MB, ~3.5 us at 3.35 TB/s, whatever the extents' skew.
//
// Design: the fused tick's tile body (tile.cuh; fused_tick.cu says what it
// does about the bound).  Only the placement differs: lane j finds its
// shard by binary search of the device `offsets` (transition.cuh
// ragged_row, a few cached loads; the host never reads `offsets` back) and
// rebases its slot into the shard's block.  Lanes off every extent
// (per-item errors and padding past offsets[n_shards]), lanes with
// valid == 0 and slots outside their shard touch no row and answer zeros.
// Extents hold unique slots, so the in-place update is race free; the TPU
// kernel's chunk ring, phantom chunk, DMA semaphores and one-hot MXU
// transposes have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

struct RaggedPlace {
  const int32_t* offsets;
  int64_t n_shards, local_capacity;
  __device__ int64_t operator()(int64_t j, int64_t slot,
                                int64_t valid) const {
    return gt::ragged_row(offsets, n_shards, local_capacity, j, slot, valid);
  }
};

__global__ void __launch_bounds__(gt::TILE_THREADS)
    fused_ragged_tick_kernel(int64_t* __restrict__ table, RaggedPlace place,
                             const int32_t* __restrict__ m32, int64_t ld_m,
                             int32_t* __restrict__ resp, int64_t ld_r,
                             int64_t lanes, int64_t now) {
  gt::tile_tick(table, m32, ld_m, lanes, now, place, gt::RespOut{resp, ld_r});
}

}  // namespace

extern "C" int gt_fused_ragged_tick(int64_t* table, int64_t n_shards,
                                    int64_t local_capacity,
                                    const int32_t* offsets, const int32_t* m32,
                                    int64_t ld_m, int32_t* resp, int64_t ld_r,
                                    int64_t lanes, int64_t now, void* stream) {
  return gt::launch_tiles(fused_ragged_tick_kernel, lanes, stream, table,
                          RaggedPlace{offsets, n_shards, local_capacity}, m32,
                          ld_m, resp, ld_r, lanes, now);
}
