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
// closed-form unit fold (ROADMAP C.1-C.3).  Rank rounds of the fused tick
// are its plain version, for CPU tensors only (ops/sortedtick.py).
//
// Bound: the bytes bound is a distinct live slot's 128 B read and 128 B
// written plus 76 B of request and 24 B of response a lane, ~0.0014 ms
// for a Zipf(1.2) window of 32768 lanes.  No design reaches it: a
// segment's transitions depend on one another, and the window's longest
// segment (~5000 lanes) is a chain that one thread runs link by link.
// The design (sorted_tick.cuh) shortens the link: one launch of two kinds
// of block, long blocks first, so the longest chains start first.
//
// * A long block (blockIdx < long_blocks) owns at most one segment of
//   more than CHUNK lanes and walks it CHUNK lanes at a time through
//   shared memory: the next chunk's request slices in flight (16-B
//   cp.async, double-buffered) while this one runs, prepare() of the
//   chunk's lanes by all threads, apply() lane after lane by one thread
//   with the row in registers, the answers written coalesced.
// * A lane block owns SORTED_THREADS lanes: it prepares those that its
//   short segments reach (its lanes, and those after them on its last
//   lane's slot) into shared memory, answers the inert ones, and its
//   first threads each apply one short segment headed there.
//
// Each block finds its own work from the slot row, so the launch needs
// no scratch and no second kernel.  Shared memory: the larger of the two
// kinds' (SortedSmem), dynamic (over 48 KB), the same for every block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_tick.cuh"

namespace {

using namespace gt;

// Chunk of `cnt` lanes from window lane `base` into staging rows `dst`:
// each row's slice as whole 16-B vectors from the vector that holds its
// first word (a vector that holds a word of the matrix lies inside its
// allocation), in flight until the caller waits for the group.
__device__ __forceinline__ void stage_chunk(int32_t* dst,
                                            const int32_t* m32, int64_t ld_m,
                                            int64_t base, int cnt, int t) {
  constexpr int V = STAGE_W / 4;  // vectors a staging row holds
  for (int x = t; x < REQ32_ROWS * V; x += SORTED_THREADS) {
    const int k = x / V, v = x - k * V;
    const int sh = stage_shift(m32, ld_m, k, base);
    if (4 * v < sh + cnt) {
      const int32_t* src = m32 + k * ld_m + base - sh + 4 * v;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst + k * STAGE_W + 4 * v)),
                   "l"(src)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void long_block(int64_t* table, int64_t capacity,
                                           const int32_t* m32, int64_t ld_m,
                                           int32_t* resp, int64_t ld_r,
                                           int64_t lanes, int64_t now,
                                           int64_t k, WalkSmem& S) {
  const int t = threadIdx.x;
  if (t == 0) S.head = -1;
  __syncthreads();
  const int64_t mine = long_head(m32, ld_m, capacity, lanes, k, t,
                                 SORTED_THREADS);
  if (mine >= 0) S.head = mine;
  __syncthreads();
  const int64_t h = S.head;
  if (h < 0) return;
  const int32_t slot = slot_at(m32, ld_m, h);
  int64_t* row = table + (int64_t)slot * ROW_W;
  const int slot_sh = stage_shift(m32, ld_m, R_SLOT, h);
  int64_t s[ROW_W];
  bool loaded = false;

  stage_chunk(&S.stage[0][0][0], m32, ld_m, h, chunk_lanes(lanes, h), t);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int c = 0;; ++c) {
    const int64_t base = h + (int64_t)c * CHUNK;
    const int cnt = chunk_lanes(lanes, base);
    // 1. The next chunk in flight; this one's group landed; its run.
    if (base + CHUNK < lanes) {
      stage_chunk(&S.stage[(c + 1) & 1][0][0], m32, ld_m, base + CHUNK,
                  chunk_lanes(lanes, base + CHUNK), t);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (t == 0) S.run = cnt;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int32_t* st = &S.stage[c & 1][0][0];
    const int off = chunk_run(st, slot_sh, slot, cnt, t, SORTED_THREADS);
    if (off < cnt) atomicMin(&S.run, off);
    __syncthreads();
    const int n = S.run;
    // 2. Prepare.
    for (int i = t; i < n; i += SORTED_THREADS) {
      walk_prepare(S, st, m32, ld_m, base, i, now);
    }
    __syncthreads();
    // 3. Apply.
    if (t == 0) walk_apply(S, n, now, row, s, loaded);
    __syncthreads();
    // 4. Respond.
    walk_respond(S, t, SORTED_THREADS, n, resp, ld_r, base);
    if (!walk_goes_on(n, base, lanes)) break;
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (t == 0 && loaded) store_ticked_row(row, s);
}

__device__ __forceinline__ void lane_block(int64_t* table, int64_t capacity,
                                           const int32_t* m32, int64_t ld_m,
                                           int32_t* resp, int64_t ld_r,
                                           int64_t lanes, int64_t now,
                                           int64_t b, LaneSmem& S) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const LaneBlock L = lane_block_at(m32, ld_m, lanes, b);
  // 1. Prepare; answer the inert lanes; the block's short heads.
  for (int x = t; x < L.span; x += SORTED_THREADS) {
    lane_prepare(S, L, m32, ld_m, x, now);
  }
  const bool mine =
      t < L.own && lane_head(capacity, m32, ld_m, resp, ld_r, lanes, L.j0 + t);
  // 2. Pack the heads.
  const unsigned ballot = __ballot_sync(0xffffffffu, mine);
  if (lane == 0) S.counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, heads = 0;
  for (int w = 0; w < SORTED_THREADS / 32; ++w) {
    if (w < warp) before += S.counts[w];
    heads += S.counts[w];
  }
  if (mine) S.heads[before + __popc(ballot & ((1u << lane) - 1u))] = t;
  __syncthreads();
  // 3. One thread a short segment.
  if (t < heads) {
    short_chain(S, S.heads[t], L.span, table, resp, ld_r, L.j0, now);
  }
}

__global__ void __launch_bounds__(SORTED_THREADS)
    fused_sorted_tick_kernel(int64_t* __restrict__ table, int64_t capacity,
                             const int32_t* __restrict__ m32, int64_t ld_m,
                             int32_t* __restrict__ resp, int64_t ld_r,
                             int64_t lanes, int64_t now, int64_t n_long) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortedSmem& S = *reinterpret_cast<SortedSmem*>(smem);
  if ((int64_t)blockIdx.x < n_long) {
    long_block(table, capacity, m32, ld_m, resp, ld_r, lanes, now,
               blockIdx.x, S.walk);
  } else {
    lane_block(table, capacity, m32, ld_m, resp, ld_r, lanes, now,
               blockIdx.x - n_long, S.lane);
  }
}

}  // namespace

extern "C" int gt_fused_sorted_tick(int64_t* table, int64_t capacity,
                                    const int32_t* m32, int64_t ld_m,
                                    int32_t* resp, int64_t ld_r,
                                    int64_t lanes, int64_t now,
                                    void* stream) {
  if (lanes > 0) {
    const int smem = (int)sizeof(SortedSmem);
    cudaError_t e = cudaFuncSetAttribute(
        fused_sorted_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const int64_t n_long = long_blocks(lanes);
    const int64_t blocks =
        n_long + (lanes + SORTED_THREADS - 1) / SORTED_THREADS;
    fused_sorted_tick_kernel<<<(unsigned)blocks, SORTED_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        table, capacity, m32, ld_m, resp, ld_r, lanes, now, n_long);
  }
  return (int)cudaGetLastError();
}

// The build's chunk (the longest short segment), threads a block and
// dynamic shared memory bytes a block.
extern "C" int gt_fused_sorted_tick_config(int64_t* out) {
  out[0] = CHUNK;
  out[1] = SORTED_THREADS;
  out[2] = (int64_t)sizeof(SortedSmem);
  return 0;
}
