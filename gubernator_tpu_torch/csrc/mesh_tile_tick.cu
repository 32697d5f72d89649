// The mesh's duplicate tile tick for Hopper (sm_90a): a mesh window whose
// slots repeat, every shard's extent, in one launch (kernel B.6).
//
// Replaces the TPU package's XLA program gubernator_tpu/ops/engine.py
// make_tick_fn(..., compact_req=True, compact_resp=True) (:1139; its
// non-sorted tick :1298-1395 with _apply_merged_followers :857 and
// _merged_formulas :961), which the JAX mesh engine runs per tile of each
// shard's extent for every window with a repeated key
// (gubernator_tpu/parallel/mesh_engine.py:191-194, :222-236).  Its plain
// version is that tile walk on the card's tensors' CPU copies
// (ops/tiletick.py mesh_tile_tick_plain: raggedtick.ragged_walk over
// tick.merge_tick), for CPU tensors only; mesh_tile_tick.cuh says what a
// chunk, a piece, the fold and the rank rounds are, and which steps each
// kind of block runs.
//
// Bound: bytes.  76 B of request and 24 B of response a lane, and a
// distinct slot's 128-B row read and written: phase 4's herd window of
// 32768 lanes over 7650 slots moves ~5.2 MB, ~1.6 us at 3.35 TB/s.  What
// held the one-thread design back on this card was latency, not bytes
// (PERF.md §6, PR 16's breakdown): a thread walked each run of up to 32
// lanes with a global round trip a lane (19.8 us), the block of the herd's
// 5850-lane run found its end with a barrier a 256 lanes and tested
// eligibility with each load waiting on the last verdict (36 us), and
// 992 blocks searched 33 lanes each for such a head, most of them in vain,
// ahead of the lane blocks.
//
// Design:
//
// * Lane blocks, one a 256 lanes, a warp a 32-lane window: every lane
//   reads its request once; ballots find the runs; all runs that end in
//   the window run at once, a head lane each (its request and post-state
//   shuffled to its followers, which answer the fold in parallel); a run
//   that leaves the window, or crosses a chunk boundary, with at most 256
//   lanes goes to the warp striding over it.  No lane waits on another's
//   answer in memory.
// * Run blocks (one a 2048 lanes, at most 64, and no more than fit beside
//   the lane blocks in one wave; after them) take the runs past 256 lanes
//   from two queues the lane blocks fill (runs past 2048 lanes first),
//   once every warp has classified.  They never read those runs'
//   requests: each warp publishes, for its 32 lanes, which lanes start a
//   run, which do not fold with the lane before them and which are
//   invalid, so a run block finds a run's end and each piece's
//   eligibility in one round of word reads, then ticks the heads in one
//   thread and writes the fold's answers with all of them.  A run block
//   waits only on warps, which wait on nothing, and run blocks are fewer
//   than the SMs, so every lane block gets a place.
// * Lane blocks that finish take queued runs too, once every warp has
//   classified (so that none waits on another).
// * One launch a window and no memset: the queues' counters are reset by
//   the last block to finish; the queue entries, the warps' words and the
//   rank-round cells carry the launch's epoch (the caller counts launches
//   on its scratch), so a launch never reads a stale one.
//
// Registers: __launch_bounds__(256, 1).  The grid holds lanes / 256 lane
// blocks and a few run blocks, about one block an SM at the mesh's
// 32768-lane windows, so one block an SM is the occupancy it uses, and the
// whole register file spares every spill.  The warps hide latency with
// independent loads, not with more warps; a build for two blocks an SM
// timed slower on the herd (PERF.md §6, PR 16).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_tile_tick.cuh"

namespace {

using namespace gt;

constexpr unsigned kFull = 0xffffffffu;

// The card's side of the templates' policies (mesh_tile_tick.cuh).  Their
// members are host and device functions only because the templates are;
// they run on the card alone.
#if defined(__CUDA_ARCH__)
#define GT_CARD(...) __VA_ARGS__
#else
#define GT_CARD(...) __builtin_unreachable()
#endif

// One lane of a warp.
struct CardWarp {
  static constexpr int N = 1;
  GT_HD int lane(int) const { GT_CARD(return threadIdx.x & 31); }
  template <class F>
  GT_HD uint32_t ballot(F pred) const {
    GT_CARD(return __ballot_sync(kFull, pred(0)));
  }
  template <class F>
  GT_HD int64_t from(F get, int src) const {
    GT_CARD(return __shfl_sync(kFull, (long long)get(0), src));
  }
  GT_HD void sync() const { GT_CARD(__syncwarp()); }
  GT_HD void fence() const { GT_CARD(__threadfence()); }
  // Lane 0's last step of classification: the run past TT_HUGE lanes
  // headed in the window onto queue q (none for q < 0), then the warp
  // counted classified, behind a fence only when it pushed (the queues
  // are whole once every warp counts).
  GT_HD void publish(const Scratch& sc, int q, int64_t x, int64_t row) const {
    GT_CARD(if (q >= 0) {
      const uint32_t i = atomicAdd(sc.ctrl + CTRL_PUSHED + 2 * q, 1u);
      uint64_t* e = queue_at(sc, q, i);
      const uint64_t tag = (uint64_t)sc.epoch << 32;
      e[0] = tag | (uint32_t)x;
      e[1] = tag | (uint32_t)row;
      __threadfence();
    } atomicAdd(sc.ctrl + CTRL_CLASSIFIED, 1u));
  }
};

// One thread of a run block.
struct CardBlock {
  long long* red;  // a shared word for reductions
  template <class F>
  GT_HD void each(F f) const {
    GT_CARD(f((int)threadIdx.x));
  }
  template <class F>
  GT_HD void once(F f) const {
    GT_CARD(if (threadIdx.x == 0) f());
  }
  GT_HD void sync() const { GT_CARD(__syncthreads()); }
  template <class F>
  GT_HD int64_t min(F get) const {
    GT_CARD(if (threadIdx.x == 0) *red = INT64_MAX; __syncthreads();
            atomicMin(red, (long long)get((int)threadIdx.x));
            __syncthreads(); const int64_t v = *red; __syncthreads();
            return v);
  }
  // Another warp's word (this launch's, once every warp has classified;
  // awaited all the same).
  GT_HD uint32_t word(const uint64_t* p, uint32_t epoch) const {
    GT_CARD(uint64_t v; while (((v = *(volatile const uint64_t*)p) >> 32) !=
                               epoch) {} return (uint32_t)v);
  }
  GT_HD void or_at(uint32_t* p, uint32_t v) const {
    GT_CARD(atomicOr(p, v));
  }
  // Asynchronous copies into shared memory (cp.async), and the wait for
  // this thread's own.
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

// Every warp has classified: the queues are whole.
__device__ bool all_classified(const Scratch& sc, int64_t n_lane_blocks) {
  return *(volatile const uint32_t*)(sc.ctrl + CTRL_CLASSIFIED) ==
         (uint32_t)(n_lane_blocks * TT_WARPS);
}

// The next queued run, giant ones first: its head lane and table row, or
// {-1, -1}; called once the queues are whole.
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

// A run block's next run, once every warp has classified (the warps wait
// on nothing, and run blocks are fewer than the card's SMs).
__device__ void pop_run(const Scratch& sc, int64_t n_lane_blocks,
                        int64_t* out) {
  while (!all_classified(sc, n_lane_blocks)) {
  }
  pop_whole(sc, out);
}

// A lane block that has finished its lanes takes a queued run too, but
// never waits: none unless every warp has classified.
__device__ void help_pop(const Scratch& sc, int64_t n_lane_blocks,
                         int64_t* out) {
  out[0] = out[1] = -1;
  if (all_classified(sc, n_lane_blocks)) pop_whole(sc, out);
}

union TickSmem {
  WarpSmem warp[TT_WARPS];
  RunSmem run;
};

// A lane block's RUN tasks, shared by its warps.
struct TaskList {
  int64_t head[TT_THREADS];
  int n, next;
};

__global__ void __launch_bounds__(TT_THREADS, 1)
    mesh_tile_tick_kernel(TileTick c) {
  extern __shared__ __align__(16) unsigned char smem[];
  TickSmem& S = *reinterpret_cast<TickSmem*>(smem);
  __shared__ long long red;
  __shared__ int64_t head[2];
  __shared__ TaskList tasks;
  const int t = threadIdx.x;
  const CardBlock b{&red};
  if ((int64_t)blockIdx.x < c.n_lane_blocks) {
    if (t == 0) tasks.n = tasks.next = 0;
    __syncthreads();
    const CardWarp w;
    const int wi = t / 32;
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
    __syncthreads();
    for (;;) {
      if (t == 0) help_pop(c.sc, c.n_lane_blocks, head);
      __syncthreads();
      const int64_t h = head[0], row = head[1];
      __syncthreads();
      if (h < 0) break;
      run_block(b, c, h, row, S.run);
    }
  } else {
    for (;;) {
      if (t == 0) pop_run(c.sc, c.n_lane_blocks, head);
      __syncthreads();
      const int64_t h = head[0], row = head[1];
      __syncthreads();
      if (h < 0) break;
      run_block(b, c, h, row, S.run);
    }
  }
  // The last block to finish resets the queue's counters.
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

// Scratch words (8 bytes each) a launch of `lanes` lanes needs.
extern "C" int64_t gt_mesh_tile_tick_scratch_words(int64_t lanes, int64_t tile,
                                                   int64_t n_shards) {
  return scratch_words(lanes, tile, n_shards);
}

// `scratch` holds gt_mesh_tile_tick_scratch_words 8-byte words, zeroed
// once by its owner and used by one stream; `epoch` counts the launches on
// it from 1 (never 0: the owner zeroes the scratch again before it wraps);
// `rounds` one int64 the launch adds the window's rank rounds to.
extern "C" int gt_mesh_tile_tick(int64_t* table, int64_t n_shards,
                                 int64_t local_capacity,
                                 const int32_t* offsets, const int32_t* m32,
                                 int64_t ld_m, int32_t* resp, int64_t ld_r,
                                 int64_t lanes, int64_t tile, int64_t now,
                                 uint64_t* scratch, int64_t epoch,
                                 int64_t* rounds, void* stream) {
  if (lanes <= 0) return 0;
  const size_t smem = sizeof(TickSmem);
  cudaError_t e = cudaFuncSetAttribute(
      mesh_tile_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
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
  // Run blocks: as many as fit beside the lane blocks in one wave (the
  // SMs' places), at least one, at most run_blocks().
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int64_t runs = run_blocks(lanes);
  const int64_t room = (int64_t)sms - c.n_lane_blocks;
  if (runs > room) runs = room > 1 ? room : (runs > 0 ? 1 : 0);
  const int64_t blocks = c.n_lane_blocks + runs;
  mesh_tile_tick_kernel<<<(unsigned)blocks, TT_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(c);
  return (int)cudaGetLastError();
}
