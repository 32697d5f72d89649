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
// Design: one thread per head lane.  The thread reads its 19 request words
// and its count, loads its 128-B row as eight 16-B loads, runs
// gt::transition and gt::merged_fold in int64_t/double registers, stores
// the row (live lanes only: padding heads at slot == capacity read the
// guard row and never write it) and writes its 96-B journal row as six
// 16-B stores.  The plans make heads unique slots, so the in-place update
// is race free.  `count` arrives as its own int32 vector; the TPU kernel's
// 20th request row, chunk ring, DMA semaphores and one-hot MXU transposes
// have no counterpart here.
//
// Bound: memory.  Per live head 128 B read + 128 B written of row, 76 B of
// request and 4 B of count, 96 B of journal: 432 B.  An 8192-head window
// (the grouped plan of a 32768-wide Zipf(1.2) herd window) moves 3.5 MB,
// about 1.06 us at 3.35 TB/s.  Rows are random 128-B lines, so each costs
// a full DRAM burst each way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "transition.cuh"

namespace {

__global__ void fused_merged_tick_kernel(int64_t* __restrict__ table,
                                         int64_t capacity,
                                         const int32_t* __restrict__ m32,
                                         int64_t ld_m,
                                         const int32_t* __restrict__ count,
                                         int32_t* __restrict__ journal,
                                         int64_t lanes, int64_t now) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= lanes) return;
  gt::Req r = gt::load_req(m32, ld_m, j);
  int32_t c = count[j];
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
  gt::MergedHead mh = gt::merged_fold(now, o, r, c);
  if (live) {
    longlong2* dst = reinterpret_cast<longlong2*>(table + slot * gt::ROW_W);
#pragma unroll
    for (int v = 0; v < gt::ROW_W / 2; ++v) {
      dst[v] = make_longlong2(o[2 * v], o[2 * v + 1]);
    }
  }

  int32_t w[gt::MERGED24_W];
  gt::merged24_words(w, p, mh, r, live);
  int4* jd = reinterpret_cast<int4*>(journal + j * gt::MERGED24_W);
#pragma unroll
  for (int v = 0; v < gt::MERGED24_W / 4; ++v) {
    jd[v] = make_int4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
  }
}

}  // namespace

extern "C" int gt_fused_merged_tick(int64_t* table, int64_t capacity,
                                    const int32_t* m32, int64_t ld_m,
                                    const int32_t* count, int32_t* journal,
                                    int64_t lanes, int64_t now,
                                    void* stream) {
  if (lanes > 0) {
    const int threads = 128;
    int64_t blocks = (lanes + threads - 1) / threads;
    fused_merged_tick_kernel<<<(unsigned)blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        table, capacity, m32, ld_m, count, journal, lanes, now);
  }
  return (int)cudaGetLastError();
}
