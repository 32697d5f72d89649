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
// Design: a row of W int64 words is W/2 16-B vectors; consecutive threads
// move consecutive vectors, so the W/2 threads of one row read and write
// one contiguous line (a 128-B row is eight lanes, four rows a warp) with
// 16-B vector loads and stores.  Each thread reads its row's slot itself.
//
// Bound: memory.  Per row W*8 B read + W*8 B written plus the 8-B slot:
// 32768 rows of 128 B move ~8.6 MB, ~2.6 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const longlong2* __restrict__ table,
                                   int64_t capacity,
                                   const int64_t* __restrict__ slots,
                                   longlong2* __restrict__ out, int64_t n,
                                   int nvec) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * nvec) return;
  int64_t j = t / nvec;
  int v = (int)(t - j * nvec);
  int64_t s = slots[j];
  s = s < 0 ? 0 : (s > capacity ? capacity : s);
  out[t] = table[s * nvec + v];
}

__global__ void scatter_rows_kernel(longlong2* __restrict__ table,
                                    int64_t capacity,
                                    const int64_t* __restrict__ slots,
                                    const longlong2* __restrict__ rows,
                                    int64_t n, int nvec) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * nvec) return;
  int64_t j = t / nvec;
  int v = (int)(t - j * nvec);
  int64_t s = slots[j];
  if (s < 0 || s >= capacity) return;  // guard row: dropped
  table[s * nvec + v] = rows[t];
}

unsigned grid_of(int64_t threads_total, int threads) {
  return (unsigned)((threads_total + threads - 1) / threads);
}

}  // namespace

extern "C" int gt_gather_rows(const int64_t* table, int64_t capacity,
                              int64_t row_words, const int64_t* slots,
                              int64_t n, int64_t* out, void* stream) {
  int nvec = (int)(row_words / 2);
  if (n > 0) {
    gather_rows_kernel<<<grid_of(n * nvec, 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const longlong2*>(table), capacity, slots,
        reinterpret_cast<longlong2*>(out), n, nvec);
  }
  return (int)cudaGetLastError();
}

extern "C" int gt_scatter_rows(int64_t* table, int64_t capacity,
                               int64_t row_words, const int64_t* slots,
                               int64_t n, const int64_t* rows, void* stream) {
  int nvec = (int)(row_words / 2);
  if (n > 0) {
    scatter_rows_kernel<<<grid_of(n * nvec, 256), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<longlong2*>(table), capacity, slots,
        reinterpret_cast<const longlong2*>(rows), n, nvec);
  }
  return (int)cudaGetLastError();
}
