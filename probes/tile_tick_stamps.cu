// A stamped build of the mesh's duplicate tile tick (kernel B.6): the
// package's steps (gubernator_tpu_torch/csrc/mesh_tile_tick.cuh) run by the
// kernel of mesh_tile_tick.cu under policies that also write the card's
// globaltimer at each of their barriers, for probes/tick_breakdown.py.
//
// Per warp of a lane block (WREC words): its start, its words published,
// then each __syncwarp of its steps (warp_groups' fifth one closes its
// groups; the ones after belong to its runs), and their count last.
// Built with STAMP_LANES_ONLY or STAMP_RUNS_ONLY, the kernel keeps one of
// its two paths, for ptxas's count of each one's registers.  Per
// run block (BREC words): its start, then each barrier of its runs and
// each run it popped (the stamp after the pop, then its head lane), and
// the count last; per lane block the runs it helped with, as a run
// block's (HREC words, its start left 0).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_tile_tick.cuh"

namespace {

using namespace gt;

constexpr unsigned kFull = 0xffffffffu;
constexpr int WREC = 64;
constexpr int BREC = 128;

__device__ __forceinline__ uint64_t gtimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#if defined(__CUDA_ARCH__)
#define GT_CARD(...) __VA_ARGS__
#else
#define GT_CARD(...) __builtin_unreachable()
#endif

// A stamp into `rec` (n words; the count kept in shared memory at *cnt
// and written to rec[n - 1] at the block's end).
__device__ __forceinline__ void stamp(uint64_t* rec, int n, int* cnt,
                                      uint64_t v) {
  const int i = (*cnt)++;
  if (i < n - 1) rec[i] = v;
}

struct StampWarp {
  static constexpr int N = 1;
  uint64_t* rec;
  int* cnt;
  GT_HD int lane(int) const { GT_CARD(return threadIdx.x & 31); }
  template <class F>
  GT_HD uint32_t ballot(F pred) const {
    GT_CARD(return __ballot_sync(kFull, pred(0)));
  }
  template <class F>
  GT_HD int64_t from(F get, int src) const {
    GT_CARD(return __shfl_sync(kFull, (long long)get(0), src));
  }
  GT_HD void sync() const {
    GT_CARD(__syncwarp(); if ((threadIdx.x & 31) == 0) stamp(rec, WREC, cnt,
                                                             gtimer());
            __syncwarp());
  }
  GT_HD void publish(const Scratch& sc, int q, int64_t x, int64_t row) const {
    GT_CARD(if (q >= 0) {
      const uint32_t i = atomicAdd(sc.ctrl + CTRL_PUSHED + 2 * q, 1u);
      uint64_t* e = queue_at(sc, q, i);
      const uint64_t tag = (uint64_t)sc.epoch << 32;
      e[0] = tag | (uint32_t)x;
      e[1] = tag | (uint32_t)row;
      __threadfence();
    } atomicAdd(sc.ctrl + CTRL_CLASSIFIED, 1u);
            stamp(rec, WREC, cnt, gtimer()));
  }
};

struct StampBlock {
  long long* red;
  uint64_t* rec;
  int* cnt;
  template <class F>
  GT_HD void each(F f) const {
    GT_CARD(f((int)threadIdx.x));
  }
  template <class F>
  GT_HD void once(F f) const {
    GT_CARD(if (threadIdx.x == 0) {
      f();
      stamp(rec, BREC, cnt, gtimer());
    });
  }
  GT_HD void sync() const {
    GT_CARD(__syncthreads(); if (threadIdx.x == 0) stamp(rec, BREC, cnt,
                                                         gtimer());
            __syncthreads());
  }
  template <class F>
  GT_HD int64_t min(F get) const {
    GT_CARD(if (threadIdx.x == 0) *red = INT64_MAX; __syncthreads();
            atomicMin(red, (long long)get((int)threadIdx.x));
            __syncthreads(); const int64_t v = *red; __syncthreads();
            if (threadIdx.x == 0) stamp(rec, BREC, cnt, gtimer());
            return v);
  }
  GT_HD uint32_t word(const uint64_t* p, uint32_t epoch) const {
    GT_CARD(uint64_t v; while (((v = *(volatile const uint64_t*)p) >> 32) !=
                               epoch) {} return (uint32_t)v);
  }
  GT_HD void or_at(uint32_t* p, uint32_t v) const {
    GT_CARD(atomicOr(p, v));
  }
  GT_HD void stage16(void* dst, const void* src) const {
    GT_CARD(asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                             (unsigned)__cvta_generic_to_shared(dst)),
                         "l"(src)
                         : "memory"));
  }
  GT_HD void stage4(void* dst, const void* src) const {
    GT_CARD(asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                             (unsigned)__cvta_generic_to_shared(dst)),
                         "l"(src)
                         : "memory"));
  }
  GT_HD void staged() const {
    GT_CARD(asm volatile("cp.async.wait_all;\n" ::: "memory"));
  }
};

__device__ bool all_classified(const Scratch& sc, int64_t n_lane_blocks) {
  return *(volatile const uint32_t*)(sc.ctrl + CTRL_CLASSIFIED) ==
         (uint32_t)(n_lane_blocks * TT_WARPS);
}

__device__ void pop_whole(const Scratch& sc, int64_t* out) {
  __threadfence();
  volatile const uint32_t* ctrl = sc.ctrl;
  out[0] = out[1] = -1;
  for (int q = 0; q < 2; ++q) {
    if (ctrl[CTRL_POPPED + 2 * q] >= ctrl[CTRL_PUSHED + 2 * q]) continue;
    const uint32_t i = atomicAdd(sc.ctrl + CTRL_POPPED + 2 * q, 1u);
    if (i >= ctrl[CTRL_PUSHED + 2 * q]) continue;
    const uint64_t* e = queue_at(sc, q, i);
    out[0] = (int64_t)(uint32_t)__ldcg(e);
    out[1] = (int64_t)(uint32_t)__ldcg(e + 1);
    return;
  }
}

__device__ void pop_run(const Scratch& sc, int64_t n_lane_blocks,
                        int64_t* out) {
  while (!all_classified(sc, n_lane_blocks)) {
  }
  pop_whole(sc, out);
}

__device__ void help_pop(const Scratch& sc, int64_t n_lane_blocks,
                         int64_t* out) {
  out[0] = out[1] = -1;
  if (all_classified(sc, n_lane_blocks)) pop_whole(sc, out);
}

struct TaskList {
  int64_t head[TT_THREADS];
  int n, next;
};

union TickSmem {
  WarpSmem warp[TT_WARPS];
  RunSmem run;
};

__global__ void __launch_bounds__(TT_THREADS, 1)
    stamped_kernel(TileTick c, uint64_t* wrec, uint64_t* brec,
                   uint64_t* hrec) {
  extern __shared__ __align__(16) unsigned char smem[];
  TickSmem& S = *reinterpret_cast<TickSmem*>(smem);
  __shared__ long long red;
  __shared__ int64_t head[2];
  __shared__ TaskList tasks;
  __shared__ int wcnt[TT_WARPS];
  __shared__ int bcnt;
  const int t = threadIdx.x;
  const uint64_t t0 = gtimer();
  if (t < TT_WARPS) wcnt[t] = 0;
  if (t == 0) bcnt = 0;
#if !defined(STAMP_RUNS_ONLY)
  if ((int64_t)blockIdx.x < c.n_lane_blocks) {
    if (t == 0) tasks.n = tasks.next = 0;
    __syncthreads();
    const int wi = t / 32;
    uint64_t* rec = wrec + ((int64_t)blockIdx.x * TT_WARPS + wi) * WREC;
    const StampWarp w{rec, wcnt + wi};
    if (t % 32 == 0) stamp(rec, WREC, wcnt + wi, t0);
    TLane L[1];
    WarpMasks M;
    warp_classify(w, c, blockIdx.x, wi, L, M, S.warp[wi]);
    const uint32_t runs = warp_groups(w, c, L, M, S.warp[wi]);
    if (t % 32 == 0) {
      const int64_t w0 = (int64_t)blockIdx.x * TT_THREADS + wi * 32;
      for (uint32_t m = runs; m; m &= m - 1) {
        tasks.head[atomicAdd(&tasks.n, 1)] = w0 + low_bit(m);
      }
    }
    __syncthreads();
    for (;;) {
      int i = 0;
      if (t % 32 == 0) i = atomicAdd(&tasks.next, 1);
      i = __shfl_sync(kFull, i, 0);
      if (i >= tasks.n) break;
      warp_run(w, c, tasks.head[i], S.warp[wi]);
    }
    if (t % 32 == 0) rec[WREC - 1] = wcnt[wi];
    __syncthreads();
    uint64_t* hr = hrec + (int64_t)blockIdx.x * BREC;
    const StampBlock b{&red, hr, &bcnt};
    for (;;) {
      if (t == 0) {
        help_pop(c.sc, c.n_lane_blocks, head);
        if (head[0] >= 0) {
          stamp(hr, BREC, &bcnt, gtimer());
          stamp(hr, BREC, &bcnt, (uint64_t)(head[0] + 1));
        }
      }
      __syncthreads();
      const int64_t h = head[0], row = head[1];
      __syncthreads();
      if (h < 0) break;
#if !defined(STAMP_LANES_ONLY)
      run_block(b, c, h, row, S.run);
#endif
    }
    if (t == 0) hr[BREC - 1] = bcnt;
  } else
#endif
  {
    __syncthreads();
    uint64_t* rec = brec + ((int64_t)blockIdx.x - c.n_lane_blocks) * BREC;
    const StampBlock b{&red, rec, &bcnt};
    if (t == 0) stamp(rec, BREC, &bcnt, t0);
    for (;;) {
      if (t == 0) {
        pop_run(c.sc, c.n_lane_blocks, head);
        stamp(rec, BREC, &bcnt, gtimer());
        stamp(rec, BREC, &bcnt, (uint64_t)(head[0] + 1));
      }
      __syncthreads();
      const int64_t h = head[0], row = head[1];
      __syncthreads();
      if (h < 0) break;
#if !defined(STAMP_LANES_ONLY)
      run_block(b, c, h, row, S.run);
#endif
    }
    if (t == 0) rec[BREC - 1] = bcnt;
  }
  __syncthreads();
  if (t == 0) {
    __threadfence();
    if (atomicAdd(c.sc.ctrl + CTRL_FINISHED, 1u) == gridDim.x - 1) {
      for (int i = 0; i < CTRL_WORDS; ++i) c.sc.ctrl[i] = 0;
      __threadfence();
    }
  }
}

}  // namespace

extern "C" int64_t stamped_records(int64_t lanes, int64_t* warps,
                                   int64_t* blocks, int64_t* helpers) {
  *warps = lane_blocks(lanes) * TT_WARPS * WREC;
  *blocks = run_blocks(lanes) * BREC;
  *helpers = lane_blocks(lanes) * BREC;
  return 0;
}

extern "C" int stamped_tick(int64_t* table, int64_t n_shards,
                            int64_t local_capacity, const int32_t* offsets,
                            const int32_t* m32, int64_t ld_m, int32_t* resp,
                            int64_t ld_r, int64_t lanes, int64_t tile,
                            int64_t now, uint64_t* scratch, int64_t epoch,
                            int64_t* rounds, uint64_t* wrec, uint64_t* brec,
                            uint64_t* hrec, void* stream) {
  const size_t smem = sizeof(TickSmem);
  cudaError_t e = cudaFuncSetAttribute(
      stamped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  TileTick c;
  c.table = table;
  c.g = TileGeom{offsets, n_shards, local_capacity,
                 tile < lanes ? tile : lanes, max_tiles_of(lanes, tile)};
  c.m32 = m32;
  c.ld_m = ld_m;
  c.resp = resp;
  c.ld_r = ld_r;
  c.lanes = lanes;
  c.now = now;
  c.n_lane_blocks = lane_blocks(lanes);
  c.sc = scratch_at(scratch, lanes, tile, n_shards, rounds, (uint32_t)epoch);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int64_t runs = run_blocks(lanes);
  const int64_t room = (int64_t)sms - c.n_lane_blocks;
  if (runs > room) runs = room > 1 ? room : (runs > 0 ? 1 : 0);
  const int64_t blocks = c.n_lane_blocks + runs;
  stamped_kernel<<<(unsigned)blocks, TT_THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(c, wrec, brec, hrec);
  return (int)cudaGetLastError();
}

// Calibration, one thread of one block on an otherwise idle card: cycles
// of the first transition (tt_transition on a row in shared memory, its
// code not yet fetched), of the next 15, of 64 dependent volatile loads
// from memory the L2 holds, of 16 dependent shared-memory loads, of 16
// folds (fold_terms and fold_row) and of 16 64-bit floor divisions;
// out[0..5] those cycles, out[6] a checksum.
namespace {

__global__ void calibrate_kernel(const int64_t* chain, int64_t* out,
                                 const int32_t* m32, int64_t ld_m,
                                 int64_t now, int64_t seed) {
  __shared__ int64_t row[ROW_W];
  __shared__ int64_t ring[64];
  if (threadIdx.x != 0) return;
  for (int i = 0; i < 64; ++i) ring[i] = (i * 7 + 3) % 64;
  for (int i = 0; i < ROW_W; ++i) row[i] = 0;
  int64_t sum = 0;
  Req q = load_req(m32, ld_m, 0);
  Resp a{};
  sum += q.hits;
  long long c0 = clock64();
  a = tt_transition(now, q, row);
  long long c1 = clock64();
  for (int i = 0; i < 15; ++i) {
    q.hits = 1 + (a.remaining & 1);
    a = tt_transition(now, q, row);
  }
  long long c2 = clock64();
  sum += a.remaining;
  volatile const int64_t* vc = chain;
  int64_t p = 0;
  for (int i = 0; i < 64; ++i) p = vc[p];  // into the L2
  sum += p;
  p = 0;
  long long c3 = clock64();
  for (int i = 0; i < 64; ++i) p = vc[p];
  long long c4 = clock64();
  sum += p;
  volatile int64_t* vr = ring;
  int64_t r = 0;
  for (int i = 0; i < 16; ++i) r = vr[r];
  long long c5 = clock64();
  sum += r;
  FoldHead f = fold_head(row);
  for (int i = 0; i < 16; ++i) {
    f.R0 += sum & 1;
    const FoldTerms ft = fold_terms(q, f);
    fold_row(q, f, 5 + (ft.q & 3), row);
    sum += ft.q + row[W_REMAINING];
  }
  long long c6 = clock64();
  int64_t d = seed;
  for (int i = 0; i < 16; ++i) {
    d = floor_div((d * 977 + 1) << 20, 3 + (d & 7));
  }
  long long c7 = clock64();
  sum += d;
  out[0] = c1 - c0;
  out[1] = c2 - c1;
  out[2] = c4 - c3;
  out[3] = c5 - c4;
  out[4] = c6 - c5;
  out[5] = c7 - c6;
  out[6] = sum;
}

}  // namespace

extern "C" int stamped_calibrate(const int64_t* chain, int64_t* out,
                                 const int32_t* m32, int64_t ld_m,
                                 int64_t now, void* stream) {
  calibrate_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      chain, out, m32, ld_m, now, 123456789);
  return (int)cudaGetLastError();
}
