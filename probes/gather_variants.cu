// Variants of the row gather (gubernator_tpu_torch/csrc/rows.cu), built
// and timed side by side by probes/gather_variants.py on one card.  Each
// entry point has gt_gather_rows's C interface: (table, capacity, row
// words, slots, n, out, stream) on 16-word rows.
//
//   v_flat         the first design: one thread a 16-B vector, each thread
//                  loading its row's slot and dividing by the row width
//   v_w<U>_<LD>    a warp per 4*U rows: one coalesced slot load shuffled
//                  to the rows' lanes, U 16-B row loads a thread before
//                  its stores, a grid sized to the work; LD the load:
//                  ldg (read-only path), na (L1::no_allocate), nc
//                  (.nc.L1::no_allocate), l2 (nc + L2::256B prefetch)
//   v_w<U>_<LD>_cs the same with streaming (st.global.cs) stores
//   v_p<U>_x<K>    a persistent grid (K blocks an SM) walking warp tasks
//                  grid-stride, the next task's slots loaded before this
//                  task's rows

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { LDG, NA, NC, L2 };

template <int LD>
__device__ __forceinline__ int4 ld(const int4* p) {
  int4 v;
  if (LD == NA) {
    asm volatile("ld.global.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else if (LD == NC) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else if (LD == L2) {
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else {
    v = __ldg(p);
  }
  return v;
}

template <bool CS>
__device__ __forceinline__ void st(int4* p, int4 v) {
  if (CS) {
    asm volatile("st.global.cs.v4.s32 [%0], {%1, %2, %3, %4};" :: "l"(p),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
  } else {
    *p = v;
  }
}

__device__ __forceinline__ int64_t clamp(int64_t s, int64_t cap) {
  return s < 0 ? 0 : (s > cap ? cap : s);
}

__global__ void flat_k(const longlong2* __restrict__ table, int64_t capacity,
                       const int64_t* __restrict__ slots,
                       longlong2* __restrict__ out, int64_t n, int nvec) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * nvec) return;
  int64_t j = t / nvec;
  int v = (int)(t - j * nvec);
  out[t] = table[clamp(slots[j], capacity) * nvec + v];
}

template <int U, int LD, bool CS>
__global__ void w_k(const int4* __restrict__ table, int64_t capacity,
                    const int64_t* __restrict__ slots, int4* __restrict__ out,
                    int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (4 * U);
  if (base >= n) return;
  const int rows = n - base < 4 * U ? (int)(n - base) : 4 * U;
  const int64_t s = clamp(lane < rows ? __ldg(slots + base + lane) : 0,
                          capacity);
  int4 val[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int r = k * 4 + (lane >> 3);
    const int64_t sr = __shfl_sync(0xffffffffu, s, r);
    if (r < rows) val[k] = ld<LD>(table + sr * 8 + (lane & 7));
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if (k * 4 + (lane >> 3) < rows) st<CS>(out + base * 8 + k * 32 + lane, val[k]);
  }
}

template <int U>
__global__ void p_k(const int4* __restrict__ table, int64_t capacity,
                    const int64_t* __restrict__ slots, int4* __restrict__ out,
                    int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)gridDim.x * (blockDim.x >> 5) * (4 * U);
  int64_t base =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * (4 * U);
  int64_t s = base + lane < n && lane < 4 * U ? __ldg(slots + base + lane) : 0;
  while (base < n) {
    const int rows = n - base < 4 * U ? (int)(n - base) : 4 * U;
    const int64_t sc = clamp(s, capacity);
    int4 val[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int r = k * 4 + (lane >> 3);
      const int64_t sr = __shfl_sync(0xffffffffu, sc, r);
      if (r < rows) val[k] = __ldg(table + sr * 8 + (lane & 7));
    }
    const int64_t next = base + step;
    s = next + lane < n && lane < 4 * U ? __ldg(slots + next + lane) : 0;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (k * 4 + (lane >> 3) < rows) out[base * 8 + k * 32 + lane] = val[k];
    }
    base = next;
  }
}

template <typename K>
int go(K kernel, int64_t threads, const int64_t* table, int64_t cap,
       const int64_t* slots, int64_t n, int64_t* out, void* stream) {
  if (n == 0) return 0;
  kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(table), cap, slots,
      reinterpret_cast<int4*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

#define ARGS const int64_t *t, int64_t c, int64_t w, const int64_t *s, \
             int64_t n, int64_t *o, void *st
#define W(NAME, U, LD, CS)                                              \
  extern "C" int NAME(ARGS) {                                          \
    return go(w_k<U, LD, CS>, (n + 4 * U - 1) / (4 * U) * 32, t, c, s, n, \
              o, st);                                                  \
  }
#define P(NAME, U, K)                                                   \
  extern "C" int NAME(ARGS) {                                          \
    int64_t th = (n + 4 * U - 1) / (4 * U) * 32;                       \
    if (th > (int64_t)132 * K * 256) th = (int64_t)132 * K * 256;       \
    return go(p_k<U>, th, t, c, s, n, o, st);                          \
  }

extern "C" int v_flat(ARGS) {
  if (n == 0) return 0;
  flat_k<<<(unsigned)((n * 8 + 255) / 256), 256, 0,
           static_cast<cudaStream_t>(st)>>>(
      reinterpret_cast<const longlong2*>(t), c, s,
      reinterpret_cast<longlong2*>(o), n, 8);
  return (int)cudaGetLastError();
}
W(v_w1_ldg, 1, LDG, false)
W(v_w2_ldg, 2, LDG, false)
W(v_w4_ldg, 4, LDG, false)
W(v_w8_ldg, 8, LDG, false)
W(v_w1_na, 1, NA, false)
W(v_w2_na, 2, NA, false)
W(v_w4_na, 4, NA, false)
W(v_w8_na, 8, NA, false)
W(v_w2_nc, 2, NC, false)
W(v_w8_nc_cs, 8, NC, true)
W(v_w2_l2, 2, L2, false)
W(v_w2_ldg_cs, 2, LDG, true)
P(v_p2_x4, 2, 4)
P(v_p2_x8, 2, 8)
