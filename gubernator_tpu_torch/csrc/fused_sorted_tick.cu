// Chained duplicate tick for Hopper (sm_90a): a slot-sorted window whose
// slots repeat, in one launch.
//
// Replaces the TPU package's XLA program gubernator_tpu/ops/tick32.py
// make_sorted_tick32_rows_fn (jitted at :558; the JAX engine runs it for
// duplicate windows that neither the grouped nor the layered plan takes),
// with the semantics of the x64 oracle engine._jitted_tick(...,
// sorted_input=True): the requests of one slot apply one after another in
// window order, each through the fused tick's x64 transition.  It is not a
// port of that program's triple-float32 parts arithmetic or of its
// closed-form unit fold (ROADMAP C.1-C.3).  Before it, the port ran such a
// window as rank rounds, one fused-tick launch per round (5877 launches for
// a random Zipf(1.2) window of 32768); rank rounds remain its plain
// version, for CPU tensors only (ops/sortedtick.py).
//
// Design (sorted_tick.cuh): one thread a lane, 256 a block.  A segment's
// head thread keeps the slot's row in registers across the segment's
// transitions, so a row is read once and written once whatever the number
// of requests on its key; the other lanes' threads return at once (an
// inert lane writes its zero response first).
//
// Bound: the bytes bound is a distinct live slot's 128 B read and 128 B
// written plus 76 B of request and 24 B of response a lane, ~0.002 ms for
// a 32768-lane window; the longest segment is a chain of dependent
// transitions in one thread, which sets the time for a skewed window
// (chip_smoke.py phase 2 measures both: the window and a one-segment
// window of the same length).  Splitting a long segment over threads
// (the closed-form fold of identical runs, ROADMAP A.1) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_tick.cuh"

namespace {

constexpr int SORTED_THREADS = 256;

__global__ void __launch_bounds__(SORTED_THREADS)
    fused_sorted_tick_kernel(int64_t* __restrict__ table, int64_t capacity,
                             const int32_t* __restrict__ m32, int64_t ld_m,
                             int32_t* __restrict__ resp, int64_t ld_r,
                             int64_t lanes, int64_t now) {
  const int64_t j = (int64_t)blockIdx.x * SORTED_THREADS + threadIdx.x;
  if (j < lanes) {
    gt::sorted_lane(table, capacity, m32, ld_m, resp, ld_r, lanes, now, j);
  }
}

}  // namespace

extern "C" int gt_fused_sorted_tick(int64_t* table, int64_t capacity,
                                    const int32_t* m32, int64_t ld_m,
                                    int32_t* resp, int64_t ld_r,
                                    int64_t lanes, int64_t now,
                                    void* stream) {
  if (lanes > 0) {
    const int64_t blocks = (lanes + SORTED_THREADS - 1) / SORTED_THREADS;
    fused_sorted_tick_kernel<<<(unsigned)blocks, SORTED_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        table, capacity, m32, ld_m, resp, ld_r, lanes, now);
  }
  return (int)cudaGetLastError();
}
