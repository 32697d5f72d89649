// The lane code of the chained duplicate tick (kernel B.5,
// fused_sorted_tick.cu), host and device code alike: the kernel runs it
// with its threads and barriers, the host build (fused_tick_host.cc) step
// after step in one thread, and the CPU tests hold the host build against
// the plain version (ops/sortedtick.py fused_sorted_tick_plain, rank rounds
// of the fused tick's plain version).
//
// The window is slot-sorted and may repeat slots.  A segment is the run of
// lanes on one slot; its head is its first lane.  Each segment's requests
// apply in window order to the slot's row, which one thread keeps in
// registers: loaded at the first live lane, stored once at the end.  What
// bounds the kernel is that chain of dependent transitions, not bytes: a
// Zipf(1.2) window of 32768 lanes has a segment of ~5000 lanes.  So:
//
// * Segments of at most CHUNK lanes run one thread each.  A lane block
//   owns SORTED_THREADS lanes.  1. Its threads load the requests of the
//   lanes a short segment headed in the block can reach (its own lanes,
//   and those after them that continue its last lane's slot, but none of
//   a segment headed before the block or of a long one) and prepare()
//   them into shared memory, answer the inert lanes, and find the
//   block's short heads.  2. Warp ballots pack the heads into the block's
//   first threads (no thread on a non-head lane).  3. Each of those
//   threads applies its segment's lanes from shared memory (short_chain),
//   the row in its registers, answers written as they come.
// * A longer segment gets a block of its own (long block k owns the long
//   head in lanes [k (CHUNK + 1), k (CHUNK + 1) + CHUNK]: two long heads
//   are more than CHUNK lanes apart, so there is at most one).  The block
//   walks the segment CHUNK lanes at a time.  1. Stage: its threads copy
//   the next chunk's slices of the 19 request rows into shared memory
//   (16-B cp.async, double-buffered) while this chunk runs.  2. Prepare:
//   every thread runs prepare() for its lanes of the chunk into shared
//   memory.  3. Apply: one thread applies the chunk's lanes in order from
//   there (walk_apply), the row in its registers, answers into shared
//   memory.  4. Respond: the block writes the chunk's (6, n) answers
//   coalesced.  Only apply() stays on the chain: compares, adds, and a
//   division for a leaky (the leak, none when no time elapsed),
//   sliding-window (k, wprev) or GCRA (remaining) lane; the request-only
//   divisions (leaky rate, GCRA T, the window start) and the 16-word row
//   copy are off it.  On the H100 a link costs ~0.3 us this way, against
//   ~0.59 us for one thread running whole transitions (PERF.md §6).
//
// The host build runs the same steps through the helpers below with one
// thread (t = 0, step = 1); only the copies, ballots and barriers are the
// card's.
//
// An inert lane (valid == 0, or a slot outside [0, capacity): padding and
// per-item errors aim at `capacity`) touches no row and answers zeros; a
// run of out-of-range slots is no segment.  The window must be sorted by
// slot (the contract): a head's segment is long when lane head + CHUNK
// has its slot.
#pragma once

#include "tile.cuh"

namespace gt {

constexpr int SORTED_THREADS = 256;
// A segment of more than CHUNK lanes is long, and its block stages it
// CHUNK lanes at a time (chosen on the H100, PERF.md §6).
constexpr int CHUNK = 256;
static_assert(CHUNK % 4 == 0 && CHUNK >= 4, "chunks of whole 16-B vectors");
// A staged request row: the chunk's words after a shift of up to 3 words
// (its slice starts mid 16-B vector), 16-B aligned rows.
constexpr int STAGE_W = CHUNK + 4;

GT_HD int32_t slot_at(const int32_t* m32, int64_t ld_m, int64_t j) {
  return m32[R_SLOT * ld_m + j];
}

// Lane j heads a segment: its slot is a row of the table, its left
// neighbour's is another.
GT_HD bool segment_head(const int32_t* m32, int64_t ld_m, int64_t capacity,
                        int64_t j) {
  const int32_t slot = slot_at(m32, ld_m, j);
  return slot >= 0 && slot < capacity &&
         (j == 0 || slot_at(m32, ld_m, j - 1) != slot);
}

// The segment headed at lane j has more than CHUNK lanes.
GT_HD bool long_segment(const int32_t* m32, int64_t ld_m, int64_t lanes,
                        int64_t j) {
  return j + CHUNK < lanes &&
         slot_at(m32, ld_m, j + CHUNK) == slot_at(m32, ld_m, j);
}

// Long blocks a window of `lanes` lanes needs: one for each range of
// CHUNK + 1 lanes that may hold a long head (head + CHUNK < lanes).
GT_HD int64_t long_blocks(int64_t lanes) { return lanes / (CHUNK + 1); }

// Long block k's head search for thread t of `step`: the long head among
// the thread's lanes of the block's range, or -1.
GT_HD int64_t long_head(const int32_t* m32, int64_t ld_m, int64_t capacity,
                        int64_t lanes, int64_t k, int t, int step) {
  const int64_t a = k * (CHUNK + 1);
  for (int64_t j = a + t; j <= a + CHUNK && j < lanes; j += step) {
    if (segment_head(m32, ld_m, capacity, j) &&
        long_segment(m32, ld_m, lanes, j)) {
      return j;
    }
  }
  return -1;
}

// Lanes of the chunk that starts at window lane `base`.
GT_HD int chunk_lanes(int64_t lanes, int64_t base) {
  return (int)(lanes - base < CHUNK ? lanes - base : CHUNK);
}

// A walk goes on past the chunk from `base` when all its CHUNK lanes were
// the segment's and the window goes on.
GT_HD bool walk_goes_on(int n, int64_t base, int64_t lanes) {
  return n == CHUNK && base + CHUNK < lanes;
}

// Words 13-15 of a row that a live lane ticked are 0; the row goes back.
GT_HD void store_ticked_row(int64_t* row, int64_t* s) {
  for (int w = W_PREV_COUNT + 1; w < ROW_W; ++w) s[w] = 0;
  store_row(row, s);
}

// A long block's shared memory.
struct WalkSmem {
  alignas(16) int32_t stage[2][REQ32_ROWS][STAGE_W];
  int64_t prep[PREP_W * CHUNK];
  bool live[CHUNK];
  int32_t resp[RESP_ROWS * CHUNK];
  int64_t head;  // the block's long head, or -1
  int32_t run;   // lanes of the segment in the chunk
};

// A lane block's: its lanes and the CHUNK after them (a short segment
// headed in the block ends among them), its short heads packed.
constexpr int LANE_SPAN = SORTED_THREADS + CHUNK;
struct LaneSmem {
  int64_t prep[PREP_W * LANE_SPAN];
  int32_t slot[LANE_SPAN];
  bool live[LANE_SPAN];
  int32_t counts[SORTED_THREADS / 32];
  int32_t heads[SORTED_THREADS];
};

union SortedSmem {
  WalkSmem walk;
  LaneSmem lane;
};

// Lane block b's lanes: it owns `own` lanes from j0 and prepares `span`
// (its own and up to CHUNK after them), `edge` the slot of its last own
// lane.  Its short segments reach no lane on `prev`'s slot (lane j0 - 1's:
// headed before the block) and none on the edge's slot when that segment
// is long (`edge_long`: the span's last lane has it too, CHUNK + 1 lanes).
struct LaneBlock {
  int64_t j0;
  int span, own;
  int32_t edge, prev;
  bool has_prev, edge_long;
};

GT_HD LaneBlock lane_block_at(const int32_t* m32, int64_t ld_m,
                              int64_t lanes, int64_t b) {
  LaneBlock L;
  L.j0 = b * SORTED_THREADS;
  L.span = (int)(lanes - L.j0 < LANE_SPAN ? lanes - L.j0 : LANE_SPAN);
  L.own = L.span < SORTED_THREADS ? L.span : SORTED_THREADS;
  L.edge = slot_at(m32, ld_m, L.j0 + L.own - 1);
  L.has_prev = L.j0 > 0;
  L.prev = L.has_prev ? slot_at(m32, ld_m, L.j0 - 1) : 0;
  L.edge_long = L.span == LANE_SPAN &&
                slot_at(m32, ld_m, L.j0 + L.span - 1) == L.edge;
  return L;
}

// Lane block step 1 for lane j0 + x: its slot and, where a short segment
// headed in the block may reach it (an own lane, or one after them on the
// edge's slot), whether it is live and its prepared terms.
GT_HD void lane_prepare(LaneSmem& S, const LaneBlock& L, const int32_t* m32,
                        int64_t ld_m, int x, int64_t now) {
  const int32_t slot = slot_at(m32, ld_m, L.j0 + x);
  S.slot[x] = slot;
  if ((L.has_prev && slot == L.prev) || (L.edge_long && slot == L.edge) ||
      (x >= SORTED_THREADS && slot != L.edge)) {
    return;
  }
  const Req r = load_req(m32, ld_m, L.j0 + x);
  S.live[x] = r.valid != 0;
  put_prep(S.prep, LANE_SPAN, x, prepare(algo_class(r.algorithm), now, r));
}

// Lane block step 1 for its own lane j, after the prepare: an inert lane
// answers zeros; true when j heads a short segment.
GT_HD bool lane_head(int64_t capacity, const int32_t* m32, int64_t ld_m,
                     int32_t* resp, int64_t ld_r, int64_t lanes, int64_t j) {
  if (slot_row(capacity, slot_at(m32, ld_m, j), m32[R_VALID * ld_m + j]) <
      0) {
    store_resp(resp, ld_r, j, Resp{}, false);
  }
  return segment_head(m32, ld_m, capacity, j) &&
         !long_segment(m32, ld_m, lanes, j);
}

// Lane block step 3, in one thread: the short segment headed at lane
// j0 + x (prepared lanes x.. up to `span`) on its row in registers
// (loaded at the first live lane, before the loop), the answers straight
// to the window's response.
GT_HD void short_chain(const LaneSmem& S, int x, int span, int64_t* table,
                       int32_t* resp, int64_t ld_r, int64_t j0,
                       int64_t now) {
  const int32_t slot = S.slot[x];
  auto more = [&](int i) { return i + 1 < span && S.slot[i + 1] == slot; };
  int i = x;
  while (!S.live[i]) {  // inert lanes before the first live one
    if (!more(i)) return;
    ++i;
  }
  int64_t* row = table + (int64_t)slot * ROW_W;
  int64_t s[ROW_W];
  load_row(row, s);
  for (;; ++i) {
    if (S.live[i]) {
      store_resp(resp, ld_r, j0 + i,
                 apply(now, get_prep(S.prep, LANE_SPAN, i), s), true);
    }
    if (!more(i)) break;
  }
  store_ticked_row(row, s);
}

// Where request row k's slice of a chunk starts in its staging row: the
// slice's offset into its 16-B vector.  Chunks are whole vectors apart,
// so a segment's chunks share it.
GT_HD int stage_shift(const int32_t* m32, int64_t ld_m, int k,
                      int64_t base) {
  return (int)(((uintptr_t)(m32 + k * ld_m + base) >> 2) & 3);
}

// Lane i of the chunk staged in `st` from window lanes `base`..
GT_HD Req staged_req(const int32_t* st, const int32_t* m32, int64_t ld_m,
                     int64_t base, int i) {
  return req_from([=](int k) {
    return st[k * STAGE_W + stage_shift(m32, ld_m, k, base) + i];
  });
}

// Long block step 1 for thread t of `step`, the chunk of `cnt` lanes
// staged in `st` (slot row shifted by `slot_sh`): the first of the
// thread's lanes off the segment's `slot`, or cnt.
GT_HD int chunk_run(const int32_t* st, int slot_sh, int32_t slot, int cnt,
                    int t, int step) {
  for (int i = t; i < cnt; i += step) {
    if (st[R_SLOT * STAGE_W + slot_sh + i] != slot) return i;
  }
  return cnt;
}

// Long block step 2 for lane i of the chunk staged in `st`.
GT_HD void walk_prepare(WalkSmem& S, const int32_t* st, const int32_t* m32,
                        int64_t ld_m, int64_t base, int i, int64_t now) {
  const Req r = staged_req(st, m32, ld_m, base, i);
  S.live[i] = r.valid != 0;
  put_prep(S.prep, CHUNK, i, prepare(algo_class(r.algorithm), now, r));
}

// Long block step 3, in one thread: the chunk's first n lanes in order on
// the row `s` (loaded from `row` at the segment's first live lane, before
// the loop, so the loop carries the row without a test), answers into
// S.resp.
GT_HD void walk_apply(WalkSmem& S, int n, int64_t now, const int64_t* row,
                      int64_t* s, bool& loaded) {
  int i = 0;
  if (!loaded) {
    for (; i < n && !S.live[i]; ++i) {
      store_resp(S.resp, CHUNK, i, Resp{}, true);
    }
    if (i == n) return;
    load_row(row, s);
    loaded = true;
  }
  for (; i < n; ++i) {
    Resp q{};
    if (S.live[i]) q = apply(now, get_prep(S.prep, CHUNK, i), s);
    store_resp(S.resp, CHUNK, i, q, true);
  }
}

// Long block step 4 for thread t of `step`: the chunk's n answers to
// window lanes base.., row by row.
GT_HD void walk_respond(const WalkSmem& S, int t, int step, int n,
                        int32_t* resp, int64_t ld_r, int64_t base) {
  for (int w = 0; w < RESP_ROWS; ++w) {
    for (int i = t; i < n; i += step) {
      resp[w * ld_r + base + i] = S.resp[w * CHUNK + i];
    }
  }
}

}  // namespace gt
