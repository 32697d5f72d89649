// Fused unique-slot tick for Hopper (sm_90a).
//
// Replaces the TPU kernel gubernator_tpu/ops/fusedtick.py
// make_fused_tick_fn (kernel body _kernel): for each lane of a slot-sorted
// window with at most one live lane per slot, gather the lane's table row,
// apply the full five-algorithm transition, scatter the row back in place,
// and emit the compact (6, B) int32 response.
//
// Design: one thread per lane.  The thread reads its 19 request words
// (column j of the (19, B) REQ32 matrix, so a warp reads 128 contiguous
// bytes per request row), loads its 128-B table row as eight 16-B vector
// loads, runs transition.cuh in int64_t/double registers, stores the row
// as eight 16-B vector stores, and writes its six response words.  Lanes
// with valid == 0 or slot == capacity (padding, per-item errors) read the
// guard row, write nothing to the table and answer zeros.  Unique slots
// make the in-place update race free; the TPU kernel's VMEM chunk ring,
// DMA semaphores and one-hot MXU transposes have no counterpart here.
//
// Bound: memory.  Per live lane 128 B read + 128 B written of table row,
// 76 B of request and 24 B of response, against ~0.5 KFLOP of integer and
// float64 work: a 32768-lane window moves ~12 MB, ~3.7 us at 3.35 TB/s.
// Rows are random 128-B lines, so each costs a full DRAM burst; the
// kernel cannot go faster than those two line transfers per lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "transition.cuh"

namespace {

__global__ void fused_tick_kernel(int64_t* __restrict__ table,
                                  int64_t capacity,
                                  const int32_t* __restrict__ m32,
                                  int64_t ld_m, int32_t* __restrict__ resp,
                                  int64_t ld_r, int64_t lanes, int64_t now) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= lanes) return;
  gt::Req r = gt::load_req(m32, ld_m, j);
  bool live = r.valid != 0 && r.slot >= 0 && r.slot < capacity;
  int64_t slot = live ? r.slot : capacity;  // padding reads the guard row

  int64_t s[gt::ROW_W];
  const longlong2* src =
      reinterpret_cast<const longlong2*>(table + slot * gt::ROW_W);
#pragma unroll
  for (int v = 0; v < gt::ROW_W / 2; ++v) {
    longlong2 x = src[v];
    s[2 * v] = x.x;
    s[2 * v + 1] = x.y;
  }

  int64_t o[gt::ROW_W];
  gt::Resp p = gt::transition(now, s, r, o);
  if (live) {
    longlong2* dst = reinterpret_cast<longlong2*>(table + slot * gt::ROW_W);
#pragma unroll
    for (int v = 0; v < gt::ROW_W / 2; ++v) {
      dst[v] = make_longlong2(o[2 * v], o[2 * v + 1]);
    }
  }
  gt::store_resp(resp, ld_r, j, p, live);
}

}  // namespace

extern "C" int gt_fused_tick(int64_t* table, int64_t capacity,
                             const int32_t* m32, int64_t ld_m, int32_t* resp,
                             int64_t ld_r, int64_t lanes, int64_t now,
                             void* stream) {
  if (lanes > 0) {
    const int threads = 128;
    int64_t blocks = (lanes + threads - 1) / threads;
    fused_tick_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        table, capacity, m32, ld_m, resp, ld_r, lanes, now);
  }
  return (int)cudaGetLastError();
}
