// The lane code of the chained duplicate tick (kernel B.5,
// fused_sorted_tick.cu), host and device code alike: the kernel runs it one
// thread a lane, the host build (fused_tick_host.cc) lane after lane, and
// the CPU tests hold the host build against the plain version
// (ops/sortedtick.py fused_sorted_tick_plain, rank rounds of the fused
// tick's plain version).
//
// The window is slot-sorted and may repeat slots.  A lane whose slot
// differs from its left neighbour's heads a segment, the lanes of one slot.
// The head's thread runs the whole segment: it loads the slot's row into
// registers at the first live lane, applies each live lane's transition in
// window order (transition.cuh transition_class, the x64 transition of the
// fused tick), writes each lane's response, and stores the row once.  The
// next lane's request is loaded before the current lane's transition runs,
// so its loads overlap the arithmetic.  An inert lane (valid == 0, or a
// slot outside [0, capacity): padding and per-item errors aim at
// `capacity`) touches no row and answers zeros from its own thread, as the
// fused tick answers it.
#pragma once

#include "tile.cuh"

namespace gt {

GT_HD void sorted_lane(int64_t* table, int64_t capacity, const int32_t* m32,
                       int64_t ld_m, int32_t* resp, int64_t ld_r,
                       int64_t lanes, int64_t now, int64_t j) {
  const int32_t slot = m32[R_SLOT * ld_m + j];
  if (slot_row(capacity, slot, m32[R_VALID * ld_m + j]) < 0) {
    store_resp(resp, ld_r, j, Resp{}, false);
  }
  if ((j > 0 && m32[R_SLOT * ld_m + j - 1] == slot) || slot < 0 ||
      slot >= capacity) {
    return;  // not a head, or a segment of inert lanes
  }
  int64_t* row = table + (int64_t)slot * ROW_W;
  int64_t s[ROW_W], o[ROW_W];
  bool loaded = false;
  Req r = load_req(m32, ld_m, j);
  for (int64_t k = j;; ++k) {
    const bool more = k + 1 < lanes && m32[R_SLOT * ld_m + k + 1] == slot;
    Req next;
    if (more) next = load_req(m32, ld_m, k + 1);
    if (r.valid != 0) {
      if (!loaded) {
        load_row(row, s);
        loaded = true;
      }
      Resp q = transition_class(algo_class(r.algorithm), now, s, r, o);
      for (int w = 0; w < ROW_W; ++w) s[w] = o[w];
      store_resp(resp, ld_r, k, q, true);
    }
    if (!more) break;
    r = next;
  }
  if (loaded) store_row(row, s);
}

}  // namespace gt
