// Host build of the fused ticks' lane loops, for tests only.
//
// Compiles transition.cuh as plain C++ and runs the same per-lane steps as
// the kernels of fused_tick.cu, fused_merged_tick.cu and
// fused_ragged_tick.cu (guard-row read for padding lanes, no table write
// for them, zero response), one lane after another.  The CPU tests hold them against the plain PyTorch versions
// (ops/fusedtick.py), which checks the kernels' arithmetic on a machine
// without a GPU; the kernels themselves are held against the plain
// versions on the card by chip_smoke.py.

#include <stdint.h>

#include "transition.cuh"

extern "C" int gt_fused_tick_host(int64_t* table, int64_t capacity,
                                  const int32_t* m32, int64_t ld_m,
                                  int32_t* resp, int64_t ld_r, int64_t lanes,
                                  int64_t now) {
  for (int64_t j = 0; j < lanes; ++j) {
    gt::Req r = gt::load_req(m32, ld_m, j);
    bool live = r.valid != 0 && r.slot >= 0 && r.slot < capacity;
    int64_t slot = live ? r.slot : capacity;
    int64_t s[gt::ROW_W];
    int64_t o[gt::ROW_W];
    for (int w = 0; w < gt::ROW_W; ++w) s[w] = table[slot * gt::ROW_W + w];
    gt::Resp p = gt::transition(now, s, r, o);
    if (live) {
      for (int w = 0; w < gt::ROW_W; ++w) table[slot * gt::ROW_W + w] = o[w];
    }
    gt::store_resp(resp, ld_r, j, p, live);
  }
  return 0;
}

// The same for fused_merged_tick.cu's lane loop: transition, duplicate
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

// The same for fused_ragged_tick.cu's lane loop: shard by lane position,
// slot rebased into the shard's block, zeros for lanes off every extent.
extern "C" int gt_fused_ragged_tick_host(int64_t* table, int64_t n_shards,
                                         int64_t local_capacity,
                                         const int32_t* offsets,
                                         const int32_t* m32, int64_t ld_m,
                                         int32_t* resp, int64_t ld_r,
                                         int64_t lanes, int64_t now) {
  for (int64_t j = 0; j < lanes; ++j) {
    int64_t row = gt::ragged_row(offsets, n_shards, local_capacity, j,
                                 m32[gt::R_SLOT * ld_m + j],
                                 m32[gt::R_VALID * ld_m + j]);
    gt::Resp p{};
    if (row >= 0) {
      gt::Req r = gt::load_req(m32, ld_m, j);
      int64_t s[gt::ROW_W];
      int64_t o[gt::ROW_W];
      for (int w = 0; w < gt::ROW_W; ++w) s[w] = table[row * gt::ROW_W + w];
      p = gt::transition(now, s, r, o);
      for (int w = 0; w < gt::ROW_W; ++w) table[row * gt::ROW_W + w] = o[w];
    }
    gt::store_resp(resp, ld_r, j, p, row >= 0);
  }
  return 0;
}
