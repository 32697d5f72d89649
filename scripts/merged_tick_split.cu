// Diagnostic kernels for scripts/merged_tick_split.py: an empty kernel of
// a 128-thread grid, a copy kernel of the merged tick's memory work, and
// the merged tick's one-thread-a-head design (before the tile body) with
// %globaltimer stamps, on the transition.cuh of the checkout it is built
// against.
#include <cuda_runtime.h>
#include <stdint.h>

#include "transition.cuh"

namespace {

__device__ __forceinline__ uint64_t gtime_dep(int64_t x) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : "l"(x) : "memory");
  return t;
}

__global__ void empty_kernel() {}

__global__ void copy_kernel(int64_t* __restrict__ table, int64_t capacity,
                            const int32_t* __restrict__ m32, int64_t ld_m,
                            const int32_t* __restrict__ count,
                            int32_t* __restrict__ journal, int64_t lanes) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= lanes) return;
  int32_t acc = count[j];
  int32_t v[gt::REQ32_ROWS];
#pragma unroll
  for (int k = 0; k < gt::REQ32_ROWS; ++k) v[k] = m32[k * ld_m + j];
#pragma unroll
  for (int k = 0; k < gt::REQ32_ROWS; ++k) acc ^= v[k];
  bool live = v[gt::R_VALID] != 0 && v[gt::R_SLOT] >= 0 &&
              v[gt::R_SLOT] < capacity;
  int64_t slot = live ? v[gt::R_SLOT] : capacity;
  const longlong2* src =
      reinterpret_cast<const longlong2*>(table + slot * gt::ROW_W);
  longlong2 x[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) x[q] = src[q];
  if (live) {
    longlong2* dst = reinterpret_cast<longlong2*>(table + slot * gt::ROW_W);
#pragma unroll
    for (int q = 0; q < 8; ++q) dst[q] = x[q];
  }
  int4* jd = reinterpret_cast<int4*>(journal + j * gt::MERGED24_W);
  int4 z = make_int4(0, 0, 0, acc == 0x5a5a5a5a ? 1 : 0);
#pragma unroll
  for (int q = 0; q < 6; ++q) jd[q] = z;
}

// The one-thread-a-head merged tick with stamps of thread 0 of every
// block: entry, request words in, row in, transition, fold, stores issued.
// Each stamp waits on a value of the step before it.
__global__ void stamped_kernel(int64_t* __restrict__ table, int64_t capacity,
                               const int32_t* __restrict__ m32, int64_t ld_m,
                               const int32_t* __restrict__ count,
                               int32_t* __restrict__ journal, int64_t lanes,
                               int64_t now, uint64_t* stamps) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= lanes) return;
  uint64_t t0 = gtime_dep(0);
  gt::Req r = gt::load_req(m32, ld_m, j);
  int32_t c = count[j];
  uint64_t t1 = gtime_dep(r.slot ^ r.hits ^ r.limit ^ r.duration ^
                          r.created_at ^ r.burst ^ r.greg_exp ^ r.greg_dur ^
                          r.known ^ r.algorithm ^ r.behavior ^ r.valid ^ c);
  bool live = r.valid != 0 && r.slot >= 0 && r.slot < capacity;
  int64_t slot = live ? r.slot : capacity;
  int64_t s[gt::ROW_W];
  const longlong2* src =
      reinterpret_cast<const longlong2*>(table + slot * gt::ROW_W);
#pragma unroll
  for (int v = 0; v < gt::ROW_W / 2; ++v) {
    longlong2 x = src[v];
    s[2 * v] = x.x;
    s[2 * v + 1] = x.y;
  }
  int64_t sx = 0;
#pragma unroll
  for (int w = 0; w < gt::ROW_W; ++w) sx ^= s[w];
  uint64_t t2 = gtime_dep(sx);
  int64_t o[gt::ROW_W];
  gt::Resp p =
      gt::transition_class(gt::algo_class(r.algorithm), now, s, r, o);
  int64_t ox = p.status ^ p.remaining ^ p.reset_time ^ p.over_limit;
#pragma unroll
  for (int w = 0; w < gt::ROW_W; ++w) ox ^= o[w];
  uint64_t t3 = gtime_dep(ox);
  gt::MergedHead mh = gt::merged_fold(now, o, r, c);
  uint64_t t4 = gtime_dep(mh.base ^ mh.q ^ mh.rate_i ^ mh.s0 ^ mh.expire ^
                          o[gt::W_REMAINING] ^ o[gt::W_REMAINING_F] ^
                          o[gt::W_STATUS]);
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
  uint64_t t5 = gtime_dep(0);
  if (threadIdx.x == 0) {
    uint64_t* st = stamps + blockIdx.x * 6;
    st[0] = t0; st[1] = t1; st[2] = t2; st[3] = t3; st[4] = t4; st[5] = t5;
  }
}

}  // namespace

extern "C" int diag_empty(int64_t lanes, void* stream) {
  int64_t blocks = (lanes + 127) / 128;
  empty_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int diag_copy(int64_t* table, int64_t capacity, const int32_t* m32,
                         int64_t ld_m, const int32_t* count, int32_t* journal,
                         int64_t lanes, void* stream) {
  int64_t blocks = (lanes + 127) / 128;
  copy_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
      table, capacity, m32, ld_m, count, journal, lanes);
  return (int)cudaGetLastError();
}

extern "C" int diag_stamped(int64_t* table, int64_t capacity,
                            const int32_t* m32, int64_t ld_m,
                            const int32_t* count, int32_t* journal,
                            int64_t lanes, int64_t now, uint64_t* stamps,
                            void* stream) {
  int64_t blocks = (lanes + 127) / 128;
  stamped_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
      table, capacity, m32, ld_m, count, journal, lanes, now, stamps);
  return (int)cudaGetLastError();
}
