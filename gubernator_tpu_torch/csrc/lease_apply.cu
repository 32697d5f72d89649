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
// owns its slots: no atomics, no second pass.
//
// Layout (ops/leasecols.py lease_records): the three columns interleaved,
// one 32-B record a slot, one DRAM sector: budget (int64), expiry
// (int64), generation (int32), then 12 B of padding that stay 0.
//
// Bound: bytes.  28 B a lane in (slot, budget and expiry 8 B each, the
// generation 4 B), 20 B of columns read (delta) and 20 B written: a
// 4096-lane window moves ~0.28 MB, ~0.08 us at 3.35 TB/s, so the launch
// itself bounds it (an empty launch ~2.1 us on the H100).  Past the
// launch, a window waits on its round trips and on the random sectors it
// touches (PERF.md §6, the B.9 and B.8d redesign: with three columns a
// lane touched three sectors, and at 65536 lanes the card drained those
// writes for ~10 us after the last store was issued).  So:
// * a lane's record is one sector, read (delta) as two 16-B loads and
//   written whole as two 16-B stores, padding included, so no sector is
//   written in part;
// * a thread issues its lane's four words together, before the range
//   test, and a delta window's two record loads together once the slot
//   arrives: a set window is one round trip to the lanes, then stores;
//   a delta window two (two lanes a thread were no faster: PERF.md §6,
//   the same entry);
// * blocks are as small as spreads the window over the SMs (32 to 256
//   threads, the least power of two with at most `sms` blocks' worth of
//   lanes each), so a grant call's ~3840 lanes issue their stores from
//   ~120 SMs and not 16.
// Lanes are read coalesced from the four rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

template <bool SET>
__global__ void __launch_bounds__(256)
    lease_apply_kernel(longlong2* __restrict__ rec, int64_t capacity,
                       const int64_t* __restrict__ lanes, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // 1. The lane's four words, issued together before the range test (with
  // a return between the slot and the rest, nvcc sinks the other three
  // loads past it, and a wide set window slows: PERF.md §6).
  const bool in = j < n;
  int64_t s = 0, b = 0, e = 0, g = 0;
  if (in) {
    s = __ldg(lanes + j);
    b = __ldg(lanes + n + j);
    e = __ldg(lanes + 2 * n + j);
    g = __ldg(lanes + 3 * n + j);
  }
  if (!in || s < 0 || s >= capacity) return;
  int64_t nb = b, ne = e;
  int32_t ng = (int32_t)g;
  if (!SET) {
    // 2. A delta window's record, both halves issued together: budget and
    // expiry, then the generation (the low half of the third word).
    const longlong2 lo = rec[2 * s];
    const longlong2 hi = rec[2 * s + 1];
    nb = lo.x + b;
    nb = nb > 0 ? nb : 0;
    ne = e > lo.y ? e : lo.y;
    const int32_t og = (int32_t)hi.x;
    ng = ng > og ? ng : og;
  }
  // 3. The record written whole.
  rec[2 * s] = make_longlong2(nb, ne);
  rec[2 * s + 1] = make_longlong2((int64_t)(uint32_t)ng, 0);
}

// Threads a block for a window of n lanes on `sms` SMs.
int block_threads(int64_t n, int sms) {
  int threads = 32;
  while (threads < 256 && (int64_t)threads * sms < n) threads *= 2;
  return threads;
}

void launch(longlong2* rec, int64_t capacity, const int64_t* lanes,
            int64_t n, int is_set, int threads, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (is_set) {
    lease_apply_kernel<true><<<blocks, threads, 0, st>>>(rec, capacity,
                                                         lanes, n);
  } else {
    lease_apply_kernel<false><<<blocks, threads, 0, st>>>(rec, capacity,
                                                          lanes, n);
  }
}

}  // namespace

// `records`: the interleaved columns' base, (capacity + 1) 32-B records.
extern "C" int gt_lease_apply(int64_t* records, int64_t capacity,
                              const int64_t* lanes, int64_t n, int is_set,
                              void* stream) {
  if (n > 0) {
    launch(reinterpret_cast<longlong2*>(records), capacity, lanes, n, is_set,
           block_threads(n, sm_count()), static_cast<cudaStream_t>(stream));
  }
  return (int)cudaGetLastError();
}
