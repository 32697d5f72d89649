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
// chunk, a piece, the fold and the rank rounds are.
//
// Bound: bytes.  76 B of request and 24 B of response a lane, and a
// distinct slot's 128-B row read and written: a herd window of 32768
// lanes over ~2000 keys moves ~3.8 MB, ~1.1 us at 3.35 TB/s.  What the
// fold leaves is one transition a piece plus a chain for each group that
// does not fold (its followers apply one after another).
//
// Design: one launch, two kinds of block, as the chained tick's
// (sorted_tick.cuh), long blocks first.
//
// * A lane block owns TT_THREADS lanes, one thread each: a lane off every
//   extent or off its shard answers zeros; the head of a run of at most
//   TT_LONG lanes runs it alone (run_serial: its pieces in order, the row
//   in registers, the requests read from the window).
// * A long block owns the run of more than TT_LONG lanes headed in its
//   range, if any.  It finds the run's end, then takes its pieces in
//   order: thread 0 ticks the head on the row in its registers; all
//   threads test the followers' eligibility (__syncthreads_and); a folding
//   group's followers answer in parallel from the head's post-state in
//   shared memory, and thread 0 folds the row; a group that does not fold
//   is a chain: TT_CHAIN lanes at a time all threads prepare() into
//   shared memory, thread 0 apply()s them in order, the answers go out
//   coalesced.  A piece with an invalid lane goes to piece_serial in
//   thread 0.
//
// Each block finds its own work from the slot row and the offsets, so the
// launch needs no plan from the host.  The rank-round counter takes one
// atomic max a piece on a per-chunk scratch that the entry zeroes first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_tile_tick.cuh"

namespace {

using namespace gt;

__device__ __forceinline__ void long_block(int64_t* table, const TileGeom& g,
                                           const int32_t* m32, int64_t ld_m,
                                           int32_t* resp, int64_t ld_r,
                                           int64_t lanes, int64_t now,
                                           int64_t k, int32_t* tile_max,
                                           int64_t* rounds, LongSmem& S) {
  const int t = threadIdx.x;
  if (t == 0) S.head = -1;
  __syncthreads();
  const int64_t mine = long_head_tt(g, m32, ld_m, lanes, k, t, TT_THREADS);
  if (mine >= 0) S.head = mine;
  __syncthreads();
  const int64_t h = S.head;
  if (h < 0) return;
  const Extent e = extent_at(g, h);
  const int32_t slot = slot_at(m32, ld_m, h);
  int64_t* rp = table + shard_row(g, e.shard, slot) * ROW_W;
  // The run's end: the first lane past h off its slot, or the extent's.
  if (t == 0) S.end = e.z;
  __syncthreads();
  for (int64_t x = h + 1 + t;; x += TT_THREADS) {
    const bool stop = x >= e.z || slot_at(m32, ld_m, x) != slot;
    if (stop && x < e.z) atomicMin((unsigned long long*)&S.end,
                                   (unsigned long long)x);
    if (__syncthreads_or(stop)) break;
  }
  const int64_t end = S.end;
  int64_t s[ROW_W];
  bool loaded = false;
  for (int64_t p = h; p < end;) {
    const int64_t ce = chunk_end(g, e, p);
    const int64_t q = ce < end ? ce : end;
    const int64_t id = chunk_id(g, e, p);
    if (t == 0) S.bad = 0;
    __syncthreads();
    for (int64_t x = p + t; x < q; x += TT_THREADS) {
      if (m32[R_VALID * ld_m + x] == 0) S.bad = 1;
    }
    __syncthreads();
    if (S.bad) {  // rare: invalid lanes inside an extent
      if (t == 0) {
        note_rounds(tile_max, rounds, id,
                    piece_serial(m32, ld_m, p, q, now, rp, s, loaded, resp,
                                 ld_r));
      }
      __syncthreads();
      p = q;
      continue;
    }
    // 1. The head (lane p) on the row, by thread 0.
    const Req hr = load_req(m32, ld_m, p);
    if (t == 0) {
      if (!loaded) {
        load_row(rp, s);
        loaded = true;
      }
      store_resp(resp, ld_r, p,
                 transition_class(algo_class(hr.algorithm), now, hr, s),
                 true);
      S.fold = fold_head(s);
    }
    // 2. Eligibility of the whole group.
    bool ok = lane_mergeable(hr, hr, true);
    for (int64_t x = p + 1 + t; x < q; x += TT_THREADS) {
      ok = ok && lane_mergeable(load_req(m32, ld_m, x), hr, false);
    }
    const bool elig = __syncthreads_and(ok) != 0;
    const int64_t n = q - p;
    if (n > 1) {
      const bool proven = proven_alive(hr, now);
      const FoldHead f = S.fold;
      const bool alive = now <= f.E;
      if (elig && (alive || proven)) {
        // 3a. The fold: every follower from the head's post-state.
        for (int64_t x = p + 1 + t; x < q; x += TT_THREADS) {
          store_resp(resp, ld_r, x,
                     alive ? fold_answer(hr, f, x - p) : Resp{}, alive);
        }
        if (t == 0) {
          if (alive) fold_row(hr, f, n - 1, s);
          note_rounds(tile_max, rounds, id, proven ? 0 : n - 1);
        }
      } else {
        // 3b. The chain, TT_CHAIN lanes at a time.
        for (int64_t base = p + 1; base < q; base += TT_CHAIN) {
          const int cnt = (int)(q - base < TT_CHAIN ? q - base : TT_CHAIN);
          for (int i = t; i < cnt; i += TT_THREADS) {
            chain_prepare(S, m32, ld_m, base, i, now);
          }
          __syncthreads();
          if (t == 0) chain_apply(S, cnt, now, s);
          __syncthreads();
          chain_respond(S, t, TT_THREADS, cnt, resp, ld_r, base);
          __syncthreads();
        }
        if (t == 0) note_rounds(tile_max, rounds, id, n - 1);
      }
    }
    __syncthreads();
    p = q;
  }
  if (t == 0 && loaded) store_ticked_row(rp, s);
}

__global__ void __launch_bounds__(TT_THREADS)
    mesh_tile_tick_kernel(int64_t* __restrict__ table, TileGeom g,
                          const int32_t* __restrict__ m32, int64_t ld_m,
                          int32_t* __restrict__ resp, int64_t ld_r,
                          int64_t lanes, int64_t now, int64_t n_long,
                          int32_t* __restrict__ tile_max,
                          int64_t* __restrict__ rounds) {
  __shared__ LongSmem S;
  if ((int64_t)blockIdx.x < n_long) {
    long_block(table, g, m32, ld_m, resp, ld_r, lanes, now, blockIdx.x,
               tile_max, rounds, S);
    return;
  }
  const int64_t j =
      ((int64_t)blockIdx.x - n_long) * TT_THREADS + threadIdx.x;
  if (j < lanes) {
    lane_step(table, g, m32, ld_m, resp, ld_r, now, j, tile_max, rounds);
  }
}

}  // namespace

// `tile_max` is scratch of n_shards * ceil(lanes / tile) int32 cells (the
// entry zeroes it); `rounds` one int64 the launch adds the window's rank
// rounds to.
extern "C" int gt_mesh_tile_tick(int64_t* table, int64_t n_shards,
                                 int64_t local_capacity,
                                 const int32_t* offsets, const int32_t* m32,
                                 int64_t ld_m, int32_t* resp, int64_t ld_r,
                                 int64_t lanes, int64_t tile, int64_t now,
                                 int32_t* tile_max, int64_t* rounds,
                                 void* stream) {
  if (lanes > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t max_tiles = (lanes + tile - 1) / tile;
    cudaError_t e = cudaMemsetAsync(
        tile_max, 0, (size_t)(n_shards * max_tiles) * sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
    const TileGeom g{offsets, n_shards, local_capacity, tile, max_tiles};
    const int64_t n_long = long_blocks_tt(lanes);
    const int64_t blocks = n_long + (lanes + TT_THREADS - 1) / TT_THREADS;
    mesh_tile_tick_kernel<<<(unsigned)blocks, TT_THREADS, 0, st>>>(
        table, g, m32, ld_m, resp, ld_r, lanes, now, n_long, tile_max,
        rounds);
  }
  return (int)cudaGetLastError();
}
