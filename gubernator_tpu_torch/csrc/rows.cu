// Row gather and scatter for Hopper (sm_90a).
//
// Replace the TPU kernels gubernator_tpu/ops/rowtable.py gather_rows
// (_gather_kernel) and scatter_rows (_scatter_kernel), which move one
// table row per DMA descriptor through a ring of semaphores.
//
//   gather:  out[j] = table[clamp(slots[j], 0, capacity)]
//   scatter: table[slots[j]] = rows[j] for slots[j] in [0, capacity);
//            lanes aimed at the guard row (or outside the table) write
//            nothing.  Two lanes with one real slot are a caller bug.
//
// Bound: memory.  Per row W*8 B read + W*8 B written plus the 8-B slot:
// 32768 rows of 128 B move ~8.6 MB, ~2.6 us at 3.35 TB/s; zero rows are
// only written (65536 evicted rows, ~8.9 MB).
//
// Gather design.  Each slot costs two dependent DRAM round trips (the
// slot, then its row).  A warp takes 8 rows: lanes 0-7 load their slots
// in one coalesced load (clamped), and __shfl_sync hands each slot to its
// row's lanes.  A row of W int64 words is W/2 16-B vectors; consecutive
// lanes take consecutive vectors (eight lanes a 128-B row), and each
// thread issues its two row loads before either store.  Small gathers
// (at most kNoAllocateRows rows, a window's) read the table without L1
// allocation; larger ones (the tiers' readbacks, the reclaim scan) read
// it through the read-only path.  The port's 16-word row is a
// compile-time width (eight vectors: no division is left); any other
// even width takes the same body with the width at run time.  One warp a
// task and a grid sized to the work: the block scheduler keeps every SM
// fed.  Timed on the H100 beside the alternatives
// (probes/gather_variants.py, PERF.md): four or eight loads a thread, 32
// rows a warp, a persistent grid-stride walk, streaming stores and an L2
// prefetch hint were each as fast or slower.
//
// Scatter design, the gather's mirror.  A warp takes 16 rows: lanes 0-15
// load their slots in one coalesced load, __shfl_sync hands each slot to
// its row's lanes, and each thread issues its four source-vector loads
// with the slot load, before any store, so a warp waits one DRAM round
// trip, not two (a slot, then a source vector behind its range test),
// and no thread divides in 64 bits.  8 rows a warp, as the gather, was
// 1.5-10% slower.  Stores are streaming (st.global.cs, evict first): the
// kernel never reads what it writes, and the source rows and slots keep
// their place in the L2 (0.003584 ms against 0.004392 with plain stores
// at 32768 rows; PERF.md §6, from probes/scatter_accumulate_breakdown.py,
// which times the other shapes and the earlier design).
// The 16-word row is a compile-time width; any other even width takes
// the same body with the width at run time.  Lanes at the guard row or
// outside [0, capacity) store nothing.  With no source (rows == nullptr,
// row_evict) the kernel stores zero rows: an eviction is one launch that
// only writes, with no zero tensor to fill and read back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;     // rows a warp gathers
constexpr int kUnroll = 2;   // 16-B row loads a thread has in flight
constexpr int kScatterRows = 16;   // rows a warp scatters
constexpr int kScatterUnroll = 4;  // 16-B source loads a thread has in flight
constexpr int64_t kNoAllocateRows = 1 << 17;
constexpr unsigned kFull = 0xffffffffu;

template <bool NO_ALLOCATE>
__device__ __forceinline__ int4 load_row_vec(const int4* p) {
  if (NO_ALLOCATE) {
    int4 v;
    asm volatile("ld.global.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  }
  return __ldg(p);
}

// NVEC > 0: the row's vector count fixed at compile time; NVEC == 0: the
// general body, nvec_rt vectors a row.
template <int NVEC, bool NO_ALLOCATE>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int4* __restrict__ table, int64_t capacity,
                   const int64_t* __restrict__ slots, int4* __restrict__ out,
                   int64_t n, int nvec_rt) {
  const int nvec = NVEC > 0 ? NVEC : nvec_rt;
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * kRows;
  if (base >= n) return;  // warp-uniform
  const int rows = n - base < kRows ? (int)(n - base) : kRows;
  int64_t s = lane < rows ? __ldg(slots + base + lane) : 0;
  s = s < 0 ? 0 : (s > capacity ? capacity : s);
  const int total = rows * nvec;  // vectors of this warp's rows
  const int passes = (kRows * nvec + 32 * kUnroll - 1) / (32 * kUnroll);
  int4* dst = out + base * nvec;
  for (int p = 0; p < passes; ++p) {
    int4 val[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = (p * kUnroll + k) * 32 + lane;
      const int r = v / nvec;
      const int64_t sr = __shfl_sync(kFull, s, r & 31);
      if (v < total) {
        val[k] = load_row_vec<NO_ALLOCATE>(table + sr * nvec + (v - r * nvec));
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = (p * kUnroll + k) * 32 + lane;
      if (v < total) dst[v] = val[k];
    }
  }
}

// NVEC as for the gather; ZERO: no source, zero rows stored.
template <int NVEC, bool ZERO>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(int4* __restrict__ table, int64_t capacity,
                    const int64_t* __restrict__ slots,
                    const int4* __restrict__ rows, int64_t n, int nvec_rt) {
  const int nvec = NVEC > 0 ? NVEC : nvec_rt;
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * kScatterRows;
  if (base >= n) return;  // warp-uniform
  const int nrows =
      n - base < kScatterRows ? (int)(n - base) : kScatterRows;
  const int64_t s = lane < nrows ? __ldg(slots + base + lane) : capacity;
  const int total = nrows * nvec;  // vectors of this warp's rows
  const int passes = (kScatterRows * nvec + 32 * kScatterUnroll - 1) /
                     (32 * kScatterUnroll);
  const int4* src = ZERO ? nullptr : rows + base * nvec;
  for (int p = 0; p < passes; ++p) {
    int4 val[kScatterUnroll];
#pragma unroll
    for (int k = 0; k < kScatterUnroll; ++k) {
      const int v = (p * kScatterUnroll + k) * 32 + lane;
      val[k] = make_int4(0, 0, 0, 0);
      if (!ZERO && v < total) val[k] = __ldg(src + v);
    }
#pragma unroll
    for (int k = 0; k < kScatterUnroll; ++k) {
      const int v = (p * kScatterUnroll + k) * 32 + lane;
      const int r = v / nvec;
      const int64_t sr = __shfl_sync(kFull, s, r & 31);
      if (v < total && sr >= 0 && sr < capacity) {
        __stcs(table + sr * nvec + (v - r * nvec), val[k]);
      }
    }
  }
}

// Blocks for n rows at `rows` rows a warp.
unsigned warp_blocks(int64_t n, int rows) {
  const int64_t per_block = (int64_t)rows * (kThreads / 32);
  return (unsigned)((n + per_block - 1) / per_block);
}

template <int NVEC>
void launch_gather(const int64_t* table, int64_t capacity, const int64_t* slots,
                   int64_t n, int64_t* out, int nvec, cudaStream_t stream) {
  const unsigned blocks = warp_blocks(n, kRows);
  const int4* t = reinterpret_cast<const int4*>(table);
  int4* o = reinterpret_cast<int4*>(out);
  if (n <= kNoAllocateRows) {
    gather_rows_kernel<NVEC, true><<<blocks, kThreads, 0, stream>>>(
        t, capacity, slots, o, n, nvec);
  } else {
    gather_rows_kernel<NVEC, false><<<blocks, kThreads, 0, stream>>>(
        t, capacity, slots, o, n, nvec);
  }
}

template <int NVEC>
void launch_scatter(int64_t* table, int64_t capacity, const int64_t* slots,
                    int64_t n, const int64_t* rows, int nvec,
                    cudaStream_t stream) {
  int4* t = reinterpret_cast<int4*>(table);
  const unsigned blocks = warp_blocks(n, kScatterRows);
  if (rows == nullptr) {
    scatter_rows_kernel<NVEC, true><<<blocks, kThreads, 0, stream>>>(
        t, capacity, slots, nullptr, n, nvec);
  } else {
    scatter_rows_kernel<NVEC, false><<<blocks, kThreads, 0, stream>>>(
        t, capacity, slots, reinterpret_cast<const int4*>(rows), n, nvec);
  }
}

}  // namespace

extern "C" int gt_gather_rows(const int64_t* table, int64_t capacity,
                              int64_t row_words, const int64_t* slots,
                              int64_t n, int64_t* out, void* stream) {
  int nvec = (int)(row_words / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && nvec > 0) {
    if (nvec == 8) {
      launch_gather<8>(table, capacity, slots, n, out, nvec, st);
    } else {
      launch_gather<0>(table, capacity, slots, n, out, nvec, st);
    }
  }
  return (int)cudaGetLastError();
}

// rows == nullptr: zero rows (row_evict).
extern "C" int gt_scatter_rows(int64_t* table, int64_t capacity,
                               int64_t row_words, const int64_t* slots,
                               int64_t n, const int64_t* rows, void* stream) {
  int nvec = (int)(row_words / 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && nvec > 0) {
    if (nvec == 8) {
      launch_scatter<8>(table, capacity, slots, n, rows, nvec, st);
    } else {
      launch_scatter<0>(table, capacity, slots, n, rows, nvec, st);
    }
  }
  return (int)cudaGetLastError();
}
