// One quota-lease column window for Hopper (sm_90a): kernel B.9.
//
// Replaces the XLA program gubernator_tpu/ops/engine.py
// _jitted_lease_apply, which scatters one window of lanes into the three
// lease columns beside the table (docs/leases.md):
//
//   lanes: (4, n) int64, row-major: slot, budget, expiry, generation
//   set:   budget[s] = b;  expire[s] = e;  gen[s] = (int32)g
//   delta: budget[s] = max(budget[s] + b, 0);
//          expire[s] = max(expire[s], e);  gen[s] = max(gen[s], (int32)g)
//
// A lane whose slot lies outside [0, capacity) writes nothing (the
// reference's mode="drop"; the columns' entry at capacity is a guard).
//
// Contract (ops/leasecols.py pack_lanes): one lane a slot.  The host keeps
// the last lane of a slot that repeats in a set window, and merges a delta
// window's lanes per slot (budgets summed, expiry and generation their
// max), which equals the reference's scatter-add, then clamp, then
// scatter-max.  A delta window's lanes also cover every slot whose budget
// is negative (zero lanes, normally none), so the reference's clamp of
// the whole budget column is a clamp of the lanes' slots.  So each thread
// owns its slot: no atomics, no second pass.
//
// Bound: bytes.  28 B a lane in (slot, budget and expiry 8 B each, the
// generation 4 B), 20 B of columns read (delta) and 20 B written: a
// 4096-lane window moves ~0.28 MB, ~0.08 us at 3.35 TB/s, so the launch
// itself bounds it.  Design: one thread a lane, lanes read coalesced from
// the four rows, 256 threads a block, a grid sized to the lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool SET>
__global__ void lease_apply_kernel(int64_t* __restrict__ budget,
                                   int64_t* __restrict__ expire,
                                   int32_t* __restrict__ gen,
                                   int64_t capacity,
                                   const int64_t* __restrict__ lanes,
                                   int64_t n) {
  int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  int64_t s = __ldg(lanes + j);
  if (s < 0 || s >= capacity) return;
  int64_t b = __ldg(lanes + n + j);
  int64_t e = __ldg(lanes + 2 * n + j);
  int32_t g = (int32_t)__ldg(lanes + 3 * n + j);
  if (SET) {
    budget[s] = b;
    expire[s] = e;
    gen[s] = g;
  } else {
    int64_t nb = budget[s] + b;
    budget[s] = nb > 0 ? nb : 0;
    int64_t oe = expire[s];
    expire[s] = e > oe ? e : oe;
    int32_t og = gen[s];
    gen[s] = g > og ? g : og;
  }
}

}  // namespace

extern "C" int gt_lease_apply(int64_t* budget, int64_t* expire, int32_t* gen,
                              int64_t capacity, const int64_t* lanes,
                              int64_t n, int is_set, void* stream) {
  if (n > 0) {
    unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_set) {
      lease_apply_kernel<true><<<blocks, kThreads, 0, st>>>(
          budget, expire, gen, capacity, lanes, n);
    } else {
      lease_apply_kernel<false><<<blocks, kThreads, 0, st>>>(
          budget, expire, gen, capacity, lanes, n);
    }
  }
  return (int)cudaGetLastError();
}
