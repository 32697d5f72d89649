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
// Design: one thread per lane, the fused tick's (fused_tick.cu).  The
// thread finds its shard by binary search of `offsets` (transition.cuh
// ragged_row; a few cached loads), rebases its slot into the shard's block,
// loads its 128-B row as eight 16-B loads, runs gt::transition in
// int64_t/double registers, stores the row as eight 16-B stores and writes
// its six response words.  Lanes off every extent (per-item errors and
// padding past offsets[n_shards]), lanes with valid == 0 and slots outside
// their shard touch no row and answer zeros.  Extents hold unique slots,
// so the in-place update is race free.  The TPU kernel's chunk ring, its
// even chunk rounding and phantom chunk, its DMA semaphores and its
// one-hot MXU transposes have no counterpart here; the host never reads
// `offsets` back for the launch.
//
// Bound: memory, as the fused tick.  Per live lane 128 B read + 128 B
// written of row, 76 B of request and 24 B of response: a 32768-lane
// window moves ~12 MB, ~3.5 us at 3.35 TB/s, whatever the extents' skew.

#include <cuda_runtime.h>
#include <stdint.h>

#include "transition.cuh"

namespace {

__global__ void fused_ragged_tick_kernel(
    int64_t* __restrict__ table, int64_t n_shards, int64_t local_capacity,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ m32,
    int64_t ld_m, int32_t* __restrict__ resp, int64_t ld_r, int64_t lanes,
    int64_t now) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= lanes) return;
  int64_t row = gt::ragged_row(offsets, n_shards, local_capacity, j,
                               m32[gt::R_SLOT * ld_m + j],
                               m32[gt::R_VALID * ld_m + j]);
  gt::Resp p{};
  if (row >= 0) {
    gt::Req r = gt::load_req(m32, ld_m, j);
    int64_t s[gt::ROW_W];
    const longlong2* src =
        reinterpret_cast<const longlong2*>(table + row * gt::ROW_W);
#pragma unroll
    for (int v = 0; v < gt::ROW_W / 2; ++v) {
      longlong2 x = src[v];
      s[2 * v] = x.x;
      s[2 * v + 1] = x.y;
    }
    int64_t o[gt::ROW_W];
    p = gt::transition(now, s, r, o);
    longlong2* dst = reinterpret_cast<longlong2*>(table + row * gt::ROW_W);
#pragma unroll
    for (int v = 0; v < gt::ROW_W / 2; ++v) {
      dst[v] = make_longlong2(o[2 * v], o[2 * v + 1]);
    }
  }
  gt::store_resp(resp, ld_r, j, p, row >= 0);
}

}  // namespace

extern "C" int gt_fused_ragged_tick(int64_t* table, int64_t n_shards,
                                    int64_t local_capacity,
                                    const int32_t* offsets, const int32_t* m32,
                                    int64_t ld_m, int32_t* resp, int64_t ld_r,
                                    int64_t lanes, int64_t now, void* stream) {
  if (lanes > 0) {
    const int threads = 128;
    int64_t blocks = (lanes + threads - 1) / threads;
    fused_ragged_tick_kernel<<<(unsigned)blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        table, n_shards, local_capacity, offsets, m32, ld_m, resp, ld_r,
        lanes, now);
  }
  return (int)cudaGetLastError();
}
