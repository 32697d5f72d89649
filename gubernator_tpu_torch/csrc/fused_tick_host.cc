// Host build of the tick kernels' lane code, for tests only.
//
// Compiles transition.cuh and tile.cuh as plain C++ and runs the kernels'
// tile steps one tile after another (tile.cuh): staging of the live rows,
// of the requests and of the output policy's inputs, the class partition
// with its warp-aligned positions, the policy's per-class tick of each
// position, and the write-back of the rows and of the outputs in lane
// order; narrow tiles lane by lane, as the kernels' one-thread-a-lane
// path.  The unique ticks (fused_tick.cu, fused_ragged_tick.cu) take the
// RespOut policy, the merged tick (fused_merged_tick.cu) MergedOut.  The
// CPU tests hold them against the plain PyTorch versions
// (ops/fusedtick.py, ops/raggedtick.py), which checks the kernels'
// arithmetic and tile layout on a machine without a GPU; the kernels
// themselves are held against the plain versions on the card by
// chip_smoke.py.  The chained duplicate tick (fused_sorted_tick.cu) runs
// its blocks (sorted_tick.cuh) one after another: each long block's walk
// chunk by chunk (stage, run, prepare, apply, respond), then each lane
// block's inert lanes and short segments.  The mesh's duplicate tile tick
// (mesh_tile_tick.cu) runs the kernel's own steps (mesh_tile_tick.cuh)
// under a policy that holds a warp's lanes or a block's threads in
// arrays: each lane block's warps, then the run blocks.

#include <stdint.h>

#include <cstring>
#include <memory>
#include <vector>

#include "mesh_tile_tick.cuh"

namespace {

// The kernels' tile_tick, one tile at a time; `place(j, slot, valid)`
// gives lane j's table row or -1, `out` is the output policy.
template <class Place, class Out>
int tile_tick_host(int64_t* table, const int32_t* m32, int64_t ld_m,
                   int64_t lanes, int64_t now, Place place, Out out) {
  using namespace gt;
  auto S = std::make_unique<TileSmem<typename Out::Smem>>();
  int cls[TILE];
  for (int64_t base = 0; base < lanes; base += TILE) {
    const int n = (int)(lanes - base < TILE ? lanes - base : TILE);
    if (n <= DIRECT_LANES) {  // the kernels' narrow path, lane by lane
      for (int t = 0; t < n; ++t) {
        Req r = load_req(m32, ld_m, base + t);
        out.direct(table, base + t, place(base + t, r.slot, r.valid), r,
                   now);
      }
      continue;
    }
    // 1. Stage.
    int totals[N_CLASSES] = {0};
    for (int t = 0; t < TILE; ++t) {
      S->row_of[t] = -1;
      cls[t] = C_INERT;
      if (t < n) {
        const int32_t* col = m32 + base + t;
        for (int k = 0; k < REQ32_ROWS; ++k) {
          S->req[k * TILE + t] = col[k * ld_m];
        }
        out.stage(S->out, t, base + t);
        S->row_of[t] = place(base + t, col[R_SLOT * ld_m],
                             col[R_VALID * ld_m]);
      } else {
        out.stage(S->out, t, -1);
      }
      if (S->row_of[t] >= 0) {
        load_row(table + S->row_of[t] * ROW_W, S->rows + t * SROW_W);
        cls[t] = algo_class(S->req[R_ALGORITHM * TILE + t]);
        ++totals[cls[t]];
      }
    }
    // 2. Partition: the positions the warps' ballots give.
    int starts[N_CLASSES], seen[N_CLASSES] = {0};
    tile_class_starts(totals, starts);
    for (int q = 0; q < TILE_THREADS; ++q) S->perm[q] = -1;
    for (int t = 0; t < TILE; ++t) {
      if (cls[t] != C_INERT) {
        S->perm[starts[cls[t]] + seen[cls[t]]++] = (int16_t)t;
      }
    }
    // 3. Transition, position by position.
    for (int q = 0; q < TILE_THREADS; ++q) {
      const int p = S->perm[q];
      if (p >= 0) {
        out.tick(S->out, now, S->rows + p * SROW_W,
                 load_req(S->req, TILE, p), p);
      }
    }
    // 4. Write back.
    for (int t = 0; t < TILE; ++t) {
      if (S->row_of[t] >= 0) {
        store_row(table + S->row_of[t] * ROW_W, S->rows + t * SROW_W);
      }
    }
    out.write(S->out, 0, 1, base, n);
  }
  return 0;
}

}  // namespace

extern "C" int gt_fused_tick_host(int64_t* table, int64_t capacity,
                                  const int32_t* m32, int64_t ld_m,
                                  int32_t* resp, int64_t ld_r, int64_t lanes,
                                  int64_t now) {
  return tile_tick_host(table, m32, ld_m, lanes, now,
                        gt::SlotPlace{capacity}, gt::RespOut{resp, ld_r});
}

extern "C" int gt_fused_ragged_tick_host(int64_t* table, int64_t n_shards,
                                         int64_t local_capacity,
                                         const int32_t* offsets,
                                         const int32_t* m32, int64_t ld_m,
                                         int32_t* resp, int64_t ld_r,
                                         int64_t lanes, int64_t now) {
  return tile_tick_host(table, m32, ld_m, lanes, now,
                        [=](int64_t j, int64_t slot, int64_t valid) {
                          return gt::ragged_row(offsets, n_shards,
                                                local_capacity, j, slot,
                                                valid);
                        },
                        gt::RespOut{resp, ld_r});
}

// The merged tick's tile steps: transition and duplicate fold of each
// head, row store for live heads, one MERGED24 journal row per head.
extern "C" int gt_fused_merged_tick_host(int64_t* table, int64_t capacity,
                                         const int32_t* m32, int64_t ld_m,
                                         const int32_t* count,
                                         int32_t* journal, int64_t lanes,
                                         int64_t now) {
  return tile_tick_host(table, m32, ld_m, lanes, now,
                        gt::SlotPlace{capacity},
                        gt::MergedOut{count, journal});
}

namespace {

// A long segment headed at lane h, the kernel's long block step after
// step: staging (the chunk's words at the kernel's staging offsets), the
// run of the head's slot in the chunk, prepare, apply, respond.
void walk_host(gt::WalkSmem& S, int64_t* table, const int32_t* m32,
               int64_t ld_m, int32_t* resp, int64_t ld_r, int64_t lanes,
               int64_t now, int64_t h) {
  using namespace gt;
  const int32_t slot = slot_at(m32, ld_m, h);
  int64_t* row = table + (int64_t)slot * ROW_W;
  const int slot_sh = stage_shift(m32, ld_m, R_SLOT, h);
  int64_t s[ROW_W];
  bool loaded = false;
  for (int c = 0;; ++c) {
    const int64_t base = h + (int64_t)c * CHUNK;
    const int cnt = chunk_lanes(lanes, base);
    int32_t* st = &S.stage[c & 1][0][0];
    for (int k = 0; k < REQ32_ROWS; ++k) {
      const int sh = stage_shift(m32, ld_m, k, base);
      for (int i = 0; i < cnt; ++i) {
        st[k * STAGE_W + sh + i] = m32[k * ld_m + base + i];
      }
    }
    const int n = chunk_run(st, slot_sh, slot, cnt, 0, 1);
    for (int i = 0; i < n; ++i) walk_prepare(S, st, m32, ld_m, base, i, now);
    walk_apply(S, n, now, row, s, loaded);
    walk_respond(S, 0, 1, n, resp, ld_r, base);
    if (!walk_goes_on(n, base, lanes)) break;
  }
  if (loaded) store_ticked_row(row, s);
}

}  // namespace

// The chained duplicate tick's blocks one after another: the long blocks
// (each walks the long segment headed in its range of lanes), then the
// lane blocks (prepare, inert lanes answer zeros, each short head applies
// its segment).
extern "C" int gt_fused_sorted_tick_host(int64_t* table, int64_t capacity,
                                         const int32_t* m32, int64_t ld_m,
                                         int32_t* resp, int64_t ld_r,
                                         int64_t lanes, int64_t now) {
  using namespace gt;
  auto S = std::make_unique<SortedSmem>();
  for (int64_t k = 0; k < long_blocks(lanes); ++k) {
    const int64_t h = long_head(m32, ld_m, capacity, lanes, k, 0, 1);
    if (h >= 0) {
      walk_host(S->walk, table, m32, ld_m, resp, ld_r, lanes, now, h);
    }
  }
  for (int64_t b = 0; b * SORTED_THREADS < lanes; ++b) {
    const LaneBlock L = lane_block_at(m32, ld_m, lanes, b);
    for (int x = 0; x < L.span; ++x) {
      lane_prepare(S->lane, L, m32, ld_m, x, now);
    }
    for (int x = 0; x < L.own; ++x) {
      if (lane_head(capacity, m32, ld_m, resp, ld_r, lanes, L.j0 + x)) {
        short_chain(S->lane, x, L.span, table, resp, ld_r, L.j0, now);
      }
    }
  }
  return 0;
}

namespace {

// The host's side of mesh_tile_tick.cuh's policies: a warp's 32 lanes, or
// a run block's 256 threads, as arrays stepped by loops.
struct HostWarp {
  static constexpr int N = 32;
  int lane(int k) const { return k; }
  template <class F>
  uint32_t ballot(F pred) const {
    uint32_t m = 0;
    for (int k = 0; k < N; ++k) m |= (uint32_t)(pred(k) ? 1 : 0) << k;
    return m;
  }
  template <class F>
  int64_t from(F get, int src) const {
    return (int64_t)get(src);
  }
  void sync() const {}
  void fence() const {}
  void publish(const gt::Scratch& sc, int q, int64_t x, int64_t row) const {
    if (q >= 0) {
      uint64_t* e = gt::queue_at(sc, q, sc.ctrl[gt::CTRL_PUSHED + 2 * q]++);
      const uint64_t tag = (uint64_t)sc.epoch << 32;
      e[0] = tag | (uint32_t)x;
      e[1] = tag | (uint32_t)row;
    }
    sc.ctrl[gt::CTRL_CLASSIFIED] += 1;
  }
};

struct HostBlock {
  template <class F>
  void each(F f) const {
    for (int t = 0; t < gt::TT_THREADS; ++t) f(t);
  }
  template <class F>
  void once(F f) const {
    f();
  }
  void sync() const {}
  template <class F>
  int64_t min(F get) const {
    int64_t v = INT64_MAX;
    for (int t = 0; t < gt::TT_THREADS; ++t) {
      const int64_t x = get(t);
      v = x < v ? x : v;
    }
    return v;
  }
  // Every warp classified before the run blocks: each word is this
  // launch's.
  uint32_t word(const uint64_t* p, uint32_t) const { return (uint32_t)*p; }
  void or_at(uint32_t* p, uint32_t v) const { *p |= v; }
  void stage16(void* dst, const void* src) const { std::memcpy(dst, src, 16); }
  void stage4(void* dst, const void* src) const { std::memcpy(dst, src, 4); }
  void staged() const {}
};

}  // namespace

// Scratch words the host build needs (gt_mesh_tile_tick_scratch_words's).
extern "C" int64_t gt_mesh_tile_tick_scratch_words_host(int64_t lanes,
                                                        int64_t tile,
                                                        int64_t n_shards) {
  return gt::scratch_words(lanes, tile, n_shards);
}

// The mesh's duplicate tile tick's blocks one after another, as the kernel
// runs them: each lane block's warps classify (each publishing its
// words), then run their groups, then the block's runs; then the queued
// runs, giant ones first; then the counters go back to 0.  `scratch`
// holds gt_mesh_tile_tick_scratch_words_host words and `epoch` is the
// launch's, as for the kernel.
extern "C" int gt_mesh_tile_tick_host(int64_t* table, int64_t n_shards,
                                      int64_t local_capacity,
                                      const int32_t* offsets,
                                      const int32_t* m32, int64_t ld_m,
                                      int32_t* resp, int64_t ld_r,
                                      int64_t lanes, int64_t tile,
                                      int64_t now, uint64_t* scratch,
                                      int64_t epoch, int64_t* rounds) {
  using namespace gt;
  if (lanes <= 0) return 0;
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
  const HostWarp w;
  auto L = std::make_unique<TLane[]>(TT_THREADS);
  auto S = std::make_unique<WarpSmem[]>(TT_WARPS);
  WarpMasks M[TT_WARPS];
  for (int64_t b = 0; b < c.n_lane_blocks; ++b) {
    for (int wi = 0; wi < TT_WARPS; ++wi) {
      warp_classify(w, c, b, wi, L.get() + wi * 32, M[wi], S[wi]);
    }
    std::vector<int64_t> tasks;
    for (int wi = 0; wi < TT_WARPS; ++wi) {
      const uint32_t runs = warp_groups(w, c, L.get() + wi * 32, M[wi], S[wi]);
      for (uint32_t m = runs; m; m &= m - 1) {
        tasks.push_back(b * TT_THREADS + wi * 32 + low_bit(m));
      }
    }
    for (int64_t h : tasks) warp_run(w, c, h, S[0]);
  }
  const HostBlock blk;
  auto R = std::make_unique<RunSmem>();
  for (int q = 0; q < 2; ++q) {
    while (c.sc.ctrl[CTRL_POPPED + 2 * q] < c.sc.ctrl[CTRL_PUSHED + 2 * q]) {
      const uint64_t* e =
          queue_at(c.sc, q, c.sc.ctrl[CTRL_POPPED + 2 * q]++);
      run_block(blk, c, (int64_t)(uint32_t)e[0], (int64_t)(uint32_t)e[1],
                *R);
    }
  }
  for (int i = 0; i < CTRL_WORDS; ++i) c.sc.ctrl[i] = 0;
  return 0;
}

// The host build's chunk, block size and shared memory bytes
// (gt_fused_sorted_tick_config's).
extern "C" int gt_fused_sorted_tick_config_host(int64_t* out) {
  out[0] = gt::CHUNK;
  out[1] = gt::SORTED_THREADS;
  out[2] = (int64_t)sizeof(gt::SortedSmem);
  return 0;
}

// floor_div and floor_mod (transition.cuh) of n pairs with b > 0, for the
// tests of their 32-bit fast path.
extern "C" int gt_floor_divmod_host(const int64_t* a, const int64_t* b,
                                    int64_t n, int64_t* q, int64_t* m) {
  for (int64_t i = 0; i < n; ++i) {
    q[i] = gt::floor_div(a[i], b[i]);
    m[i] = gt::floor_mod(a[i], b[i]);
  }
  return 0;
}
