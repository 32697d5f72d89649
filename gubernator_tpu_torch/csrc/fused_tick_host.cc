// Host build of the tick kernels' lane code, for tests only.
//
// Compiles transition.cuh and tile.cuh as plain C++.  The unique-slot
// ticks (fused_tick.cu, fused_ragged_tick.cu) run the kernels' tile steps
// one tile after another: staging of the live rows and of the requests,
// the class partition with its warp-aligned positions, the per-class
// transition of each position, and the write-back of the rows and of the
// responses in lane order (tile.cuh).  The merged tick (fused_merged_tick.cu)
// runs its per-lane loop.  The CPU tests hold them against the plain
// PyTorch versions (ops/fusedtick.py, ops/raggedtick.py), which checks the
// kernels' arithmetic and tile layout on a machine without a GPU; the
// kernels themselves are held against the plain versions on the card by
// chip_smoke.py.

#include <stdint.h>

#include <vector>

#include "tile.cuh"

namespace {

// The kernels' tile_tick, one tile at a time (narrow tiles lane by lane,
// as direct_lane); `place(j, slot, valid)`
// gives lane j's table row or -1.
template <class Place>
int tile_tick_host(int64_t* table, const int32_t* m32, int64_t ld_m,
                   int32_t* resp, int64_t ld_r, int64_t lanes, int64_t now,
                   Place place) {
  using namespace gt;
  std::vector<int64_t> rows(TILE * SROW_W), row_of(TILE);
  std::vector<int32_t> req(REQ32_ROWS * TILE), out(RESP_ROWS * TILE);
  std::vector<int> cls(TILE), perm(TILE_THREADS);
  for (int64_t base = 0; base < lanes; base += TILE) {
    const int n = (int)(lanes - base < TILE ? lanes - base : TILE);
    if (n <= DIRECT_LANES) {  // the kernels' direct_lane, lane by lane
      for (int t = 0; t < n; ++t) {
        Req r = load_req(m32, ld_m, base + t);
        int64_t row = place(base + t, r.slot, r.valid);
        Resp q{};
        if (row >= 0) {
          int64_t s[ROW_W], o[ROW_W];
          for (int w = 0; w < ROW_W; ++w) s[w] = table[row * ROW_W + w];
          q = transition_class(algo_class(r.algorithm), now, s, r, o);
          for (int w = 0; w < ROW_W; ++w) table[row * ROW_W + w] = o[w];
        }
        store_resp(resp, ld_r, base + t, q, row >= 0);
      }
      continue;
    }
    // 1. Stage.
    int totals[N_CLASSES] = {0};
    for (int t = 0; t < TILE; ++t) {
      row_of[t] = -1;
      cls[t] = C_INERT;
      if (t < n) {
        const int32_t* col = m32 + base + t;
        row_of[t] = place(base + t, col[R_SLOT * ld_m], col[R_VALID * ld_m]);
        for (int k = 0; k < REQ32_ROWS; ++k) req[k * TILE + t] = col[k * ld_m];
      }
      if (row_of[t] >= 0) {
        for (int w = 0; w < ROW_W; ++w) {
          rows[t * SROW_W + w] = table[row_of[t] * ROW_W + w];
        }
        cls[t] = algo_class(req[R_ALGORITHM * TILE + t]);
        ++totals[cls[t]];
      }
      for (int k = 0; k < RESP_ROWS; ++k) out[k * TILE + t] = 0;
    }
    // 2. Partition: the positions the warps' ballots give.
    int starts[N_CLASSES], seen[N_CLASSES] = {0};
    tile_class_starts(totals, starts);
    for (int q = 0; q < TILE_THREADS; ++q) perm[q] = -1;
    for (int t = 0; t < TILE; ++t) {
      if (cls[t] != C_INERT) perm[starts[cls[t]] + seen[cls[t]]++] = t;
    }
    // 3. Transition, position by position.
    for (int q = 0; q < TILE_THREADS; ++q) {
      if (perm[q] >= 0) tile_lane(now, rows.data(), req.data(), out.data(),
                                  perm[q]);
    }
    // 4. Write back.
    for (int t = 0; t < TILE; ++t) {
      if (row_of[t] < 0) continue;
      for (int w = 0; w < ROW_W; ++w) {
        table[row_of[t] * ROW_W + w] = rows[t * SROW_W + w];
      }
    }
    for (int k = 0; k < RESP_ROWS; ++k) {
      for (int t = 0; t < n; ++t) resp[k * ld_r + base + t] = out[k * TILE + t];
    }
  }
  return 0;
}

}  // namespace

extern "C" int gt_fused_tick_host(int64_t* table, int64_t capacity,
                                  const int32_t* m32, int64_t ld_m,
                                  int32_t* resp, int64_t ld_r, int64_t lanes,
                                  int64_t now) {
  return tile_tick_host(table, m32, ld_m, resp, ld_r, lanes, now,
                        [=](int64_t, int64_t slot, int64_t valid) {
                          return gt::slot_row(capacity, slot, valid);
                        });
}

extern "C" int gt_fused_ragged_tick_host(int64_t* table, int64_t n_shards,
                                         int64_t local_capacity,
                                         const int32_t* offsets,
                                         const int32_t* m32, int64_t ld_m,
                                         int32_t* resp, int64_t ld_r,
                                         int64_t lanes, int64_t now) {
  return tile_tick_host(table, m32, ld_m, resp, ld_r, lanes, now,
                        [=](int64_t j, int64_t slot, int64_t valid) {
                          return gt::ragged_row(offsets, n_shards,
                                                local_capacity, j, slot,
                                                valid);
                        });
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

// fused_merged_tick.cu's per-lane loop: transition, duplicate
// fold, row store for live heads, one MERGED24 journal row per head.
extern "C" int gt_fused_merged_tick_host(int64_t* table, int64_t capacity,
                                         const int32_t* m32, int64_t ld_m,
                                         const int32_t* count,
                                         int32_t* journal, int64_t lanes,
                                         int64_t now) {
  for (int64_t j = 0; j < lanes; ++j) {
    gt::Req r = gt::load_req(m32, ld_m, j);
    bool live = r.valid != 0 && r.slot >= 0 && r.slot < capacity;
    int64_t slot = live ? r.slot : capacity;
    int64_t s[gt::ROW_W];
    int64_t o[gt::ROW_W];
    for (int w = 0; w < gt::ROW_W; ++w) s[w] = table[slot * gt::ROW_W + w];
    gt::Resp p = gt::transition(now, s, r, o);
    gt::MergedHead mh = gt::merged_fold(now, o, r, count[j]);
    if (live) {
      for (int w = 0; w < gt::ROW_W; ++w) table[slot * gt::ROW_W + w] = o[w];
    }
    gt::merged24_words(journal + j * gt::MERGED24_W, p, mh, r, live);
  }
  return 0;
}
