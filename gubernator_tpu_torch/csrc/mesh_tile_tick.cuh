// The steps of the mesh's duplicate tile tick (kernel B.6,
// mesh_tile_tick.cu), host and device code alike: the kernel runs them
// with its warps and blocks, the host build (fused_tick_host.cc) runs the
// same templates with a policy that holds all 32 lanes of a warp (or all
// 256 threads of a block) in arrays and does their collectives with
// loops, and the CPU tests hold the host build against the plain version
// (ops/tiletick.py mesh_tile_tick_plain: the tile walk of each shard's
// extent through tick.merge_tick).  Only the policies' ballots, shuffles,
// barriers, shared-memory reductions, asynchronous copies, atomics and
// the wait for another warp's word are the card's (mesh_tile_tick.cu).
//
// The window is one slot-sorted (19, B) REQ32 matrix of GLOBAL slots over
// n_shards row blocks of one table (shard s owns rows [s (L + 1),
// (s + 1) (L + 1)), L = local_capacity); shard s owns the lanes
// [offsets[s], offsets[s + 1]) of the window.  The tile walk the TPU
// package's mesh runs cuts each extent [a, z) into chunks
// [a + k tile, min(z, a + (k + 1) tile)) and ticks them one after another
// with the x64 tile tick (engine.make_tick_fn(..., compact_req=True,
// compact_resp=True)); the chunks are part of the semantics.  Within a
// chunk the lanes of one slot (a *piece*) form a group: its first valid
// lane, the head, takes the whole transition from the row as the chunk
// found it; when every valid lane of the group is fold-eligible
// (lane_mergeable) and the head's post-state is alive, every follower
// answers in closed form (fold_answer, the x64 engine._merged_formulas)
// and the head's row takes the group-final values (fold_row); otherwise
// the followers apply one after another in window order.  A run of one
// slot that crosses a chunk boundary is two pieces, the second ticking
// from the first one's final row, so a run's pieces go in order.
//
// Rank rounds: the plain version ticks a chunk's non-folded followers in
// rounds of one lane a slot; a chunk's rounds are the most followers of
// one of its pieces that did not fold in closed form (a group that is not
// eligible, or an eligible one whose head the request does not prove
// alive).  Each piece notes its rounds in its chunk's cell (note_rounds),
// so metric_rank_rounds keeps the meaning it has on the CPU.
//
// Who runs what (the design, mesh_tile_tick.cu says why):
//
// * Lane block b owns lanes [256 b, 256 b + 256), warp w of it the 32
//   lanes from 256 b + 32 w (its *window*).  1. Classify
//   (warp_classify): every lane reads its request's fold fields and its
//   slot's neighbours; lanes off every extent or off their shard answer
//   zeros; ballots give the window's run heads and boundaries, and for
//   each lane whether it may fold with the lane before it (notlink) and
//   whether it is invalid; the warp publishes those three words for the
//   run blocks, and pushes the head of every run past TT_HUGE lanes onto
//   a run queue (runs past TT_GIANT lanes on the one popped first).
//   2. Groups (warp_groups): every run headed in the window that
//   ends in it as one piece with only valid lanes is a group of lanes of
//   the warp, all groups at once: the head lane ticks the row in shared
//   memory, its request and post-state go to the group by shuffles, the
//   followers test their eligibility and answer the fold in parallel, or
//   prepare their links into shared memory for the head lane to apply in
//   order.  A group with an invalid lane runs piece_serial in its first
//   lane.  3. Runs (warp_run): a run headed in the window that crosses its
//   end or a chunk boundary and has at most TT_HUGE lanes goes to a warp
//   of the block as a whole (the block's warps share these tasks), piece
//   by piece, 32 lanes at a time.
// * Run blocks (after the lane blocks) pop the runs past TT_HUGE lanes,
//   once every warp has classified, giant ones first, and take each as a
//   block (run_block): its end and each piece's eligibility come from the
//   words the warps published, the heads tick in one thread, the fold's
//   answers are written by all threads, a chain is prepared by all
//   threads TT_CHAIN links at a time and applied in order by one.
//
// Scratch (the caller's; mesh_tile_tick.cu): the run queues' counters,
// reset by the last block to finish; the queues, the warps' words and the
// rank-round cells, each tagged with the launch's epoch, so that no launch
// has to clear them first.
#pragma once

#include "sorted_tick.cuh"

namespace gt {

constexpr int TT_THREADS = 256;  // threads a block; lanes a lane block owns
constexpr int TT_WARPS = TT_THREADS / 32;
// A run that leaves its warp's window with at most TT_HUGE lanes is the
// warp's, walked 32 lanes at a time; a longer one is a run block's.
constexpr int TT_HUGE = 256;
// Lanes of a non-folding group a run block prepares at a time.
constexpr int TT_CHAIN = 256;
// Run blocks: one for each TT_RUN_LANES lanes of the window, at most
// TT_MAX_RUN_BLOCKS (fewer than the card's SMs, so that spinning run
// blocks never keep a lane block from a place on the card).
constexpr int TT_RUN_LANES = 2048;
constexpr int TT_MAX_RUN_BLOCKS = 64;
// Pieces of one run a run block flags at a time.
constexpr int TT_PIECES = 64;
// A row in shared memory: 17 words, so that 16 lanes reading word k of
// their own rows hit 16 different pairs of banks.
constexpr int ROWP = ROW_W + 1;
constexpr int32_t NO_MERGE = RESET_REMAINING | DURATION_IS_GREGORIAN;

struct TileGeom {
  const int32_t* offsets;
  int64_t n_shards, local_capacity, tile, max_tiles;
};

// Lane j's extent: shard s with offsets[s] <= j < offsets[s + 1] (the
// caller checks offsets[0] <= j < offsets[n_shards]).
struct Extent {
  int64_t shard, a, z;
};

GT_HD bool in_extents(const TileGeom& g, int64_t j) {
  return j >= g.offsets[0] && j < g.offsets[g.n_shards];
}

GT_HD Extent extent_at(const TileGeom& g, int64_t j) {
  if (g.n_shards <= 16) {
    // Few shards: every offset read at once, none waiting on another.
    int64_t s = 0, a = g.offsets[0], z = g.offsets[g.n_shards];
    GT_UNROLL
    for (int i = 1; i < 16; ++i) {
      if (i >= g.n_shards) continue;
      const int64_t v = g.offsets[i];
      if (v <= j) {
        s = i;
        a = v;
      } else if (v < z) {
        z = v;
      }
    }
    return Extent{s, a, z};
  }
  int64_t lo = 0, hi = g.n_shards;  // offsets[lo] <= j < offsets[hi]
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    if (g.offsets[mid] <= j) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return Extent{lo, g.offsets[lo], g.offsets[lo + 1]};
}

// The table row of global slot `slot` on `shard`, or -1 when the slot is
// not the shard's (a host bug; such a lane answers zeros).
GT_HD int64_t shard_row(const TileGeom& g, int64_t shard, int64_t slot) {
  const int64_t local = slot - shard * g.local_capacity;
  if (local < 0 || local >= g.local_capacity) return -1;
  return shard * (g.local_capacity + 1) + local;
}

// Lane j (in an extent, on its shard) heads a run: its extent starts
// there or its left neighbour holds another slot.
GT_HD bool run_head(const int32_t* m32, int64_t ld_m, const Extent& e,
                    int64_t j) {
  return j == e.a || slot_at(m32, ld_m, j - 1) != slot_at(m32, ld_m, j);
}

// The chunk of extent e that holds lane p (lane offsets and the tile
// fit 32 bits: the entries clamp the tile to the window, which no chunk
// index notices; a 64-bit division costs ~460 cycles on the card, PERF.md
// §6).
GT_HD int64_t chunk_of(const TileGeom& g, const Extent& e, int64_t p) {
  return (int64_t)((uint32_t)(p - e.a) / (uint32_t)g.tile);
}

// The end of the chunk that holds lane p of extent e.
GT_HD int64_t chunk_end(const TileGeom& g, const Extent& e, int64_t p) {
  const int64_t end = e.a + (chunk_of(g, e, p) + 1) * g.tile;
  return end < e.z ? end : e.z;
}

// The counter cell of the chunk that holds lane p of extent e.
GT_HD int64_t chunk_id(const TileGeom& g, const Extent& e, int64_t p) {
  return e.shard * g.max_tiles + chunk_of(g, e, p);
}

// ---- scratch ----

// Queue counters (uint32 words), reset by the last block of a launch:
// runs pushed and popped of queue 0 (runs past TT_GIANT lanes) and of
// queue 1 (the other runs past TT_HUGE lanes), warps classified, blocks
// finished.
constexpr int CTRL_PUSHED = 0, CTRL_POPPED = 1, CTRL_CLASSIFIED = 4,
              CTRL_FINISHED = 5, CTRL_WORDS = 6;
constexpr int TT_GIANT = 2048;
// A warp's published words (uint64, each (epoch << 32) | bits, so that a
// reader needs no flag): its window's boundary, notlink and invalid bits.
constexpr int WORD_W = 4;
constexpr int U_BRK = 0, U_NOTLINK = 1, U_BAD = 2;
constexpr int UNIT_WORDS = TT_WARPS * WORD_W;  // a lane block's

GT_HD int64_t lane_blocks(int64_t lanes) {
  return (lanes + TT_THREADS - 1) / TT_THREADS;
}

GT_HD int64_t run_blocks(int64_t lanes) {
  if (lanes <= TT_HUGE) return 0;
  const int64_t n = lanes / TT_RUN_LANES;
  return n < 1 ? 1 : (n > TT_MAX_RUN_BLOCKS ? TT_MAX_RUN_BLOCKS : n);
}

// Runs past TT_HUGE lanes a window may hold.
GT_HD int64_t max_huge_runs(int64_t lanes) {
  return lanes / (TT_HUGE + 1) + 1;
}

GT_HD int64_t max_tiles_of(int64_t lanes, int64_t tile) {
  return (lanes + tile - 1) / tile;
}

// The scratch a launch needs, in 8-byte words: the counters, the queue,
// the lane blocks' words and the rank-round cells.
GT_HD int64_t scratch_words(int64_t lanes, int64_t tile, int64_t n_shards) {
  return CTRL_WORDS / 2 + 4 * max_huge_runs(lanes) +
         lane_blocks(lanes) * UNIT_WORDS +
         n_shards * max_tiles_of(lanes, tile);
}

struct Scratch {
  uint32_t* ctrl;
  uint64_t* queue;  // two queues of (epoch << 32) | head lane, then row
  uint64_t* units;
  uint64_t* cells;  // (epoch << 32) | rank rounds
  int64_t* rounds;
  int64_t queue_len;
  uint32_t epoch;
};

GT_HD Scratch scratch_at(uint64_t* base, int64_t lanes, int64_t tile,
                         int64_t n_shards, int64_t* rounds, uint32_t epoch) {
  (void)n_shards;
  (void)tile;
  Scratch s;
  s.ctrl = reinterpret_cast<uint32_t*>(base);
  s.queue = base + CTRL_WORDS / 2;
  s.queue_len = max_huge_runs(lanes);
  s.units = s.queue + 4 * s.queue_len;
  s.cells = s.units + lane_blocks(lanes) * UNIT_WORDS;
  s.rounds = rounds;
  s.epoch = epoch;
  return s;
}

// Entry i of queue q: two words, the run's head lane and its table row,
// each as (epoch << 32) | value.
GT_HD uint64_t* queue_at(const Scratch& sc, int q, int64_t i) {
  return sc.queue + 2 * (q * sc.queue_len + i);
}

// A piece's rank rounds into its chunk's cell; the counter grows by what
// the cell's maximum for this launch grows by, so it ends at the sum of
// the chunks' maxima whatever the order of the pieces.
GT_HD void note_rounds(const Scratch& sc, int64_t id, int64_t c) {
  if (c <= 0) return;
  const uint64_t v = ((uint64_t)sc.epoch << 32) | (uint64_t)(uint32_t)c;
#if defined(__CUDA_ARCH__)
  const uint64_t old = atomicMax(
      reinterpret_cast<unsigned long long*>(sc.cells + id),
      (unsigned long long)v);
#else
  const uint64_t old = sc.cells[id];
  if (v > old) sc.cells[id] = v;
#endif
  if (v <= old) return;
  const int64_t before =
      (old >> 32) == sc.epoch ? (int64_t)(old & 0xffffffffu) : 0;
#if defined(__CUDA_ARCH__)
  atomicAdd(reinterpret_cast<unsigned long long*>(sc.rounds),
            (unsigned long long)(c - before));
#else
  *sc.rounds += c - before;
#endif
}

// ---- the x64 closed-form fold (ops/transition.py merged_formulas) ----

// The head's post-transition values the fold reads.
struct FoldHead {
  int64_t R0, S0, E;
  double F0;
};

GT_HD FoldHead fold_head(const int64_t* s) {
  return FoldHead{s[W_REMAINING], s[W_STATUS], s[W_EXPIRE_AT],
                  bits_to_f64(s[W_REMAINING_F])};
}

// The fields the fold reads are the same in r and h.
GT_HD bool same_fold_fields(const Req& r, const Req& h) {
  return r.hits == h.hits && r.limit == h.limit &&
         r.duration == h.duration && r.behavior == h.behavior &&
         r.created_at == h.created_at && r.burst == h.burst &&
         r.algorithm == h.algorithm;
}

// Lane r may fold against head h (transition.py merge_eligible): valid,
// identical to the head in every field the fold reads, hits > 0, no
// RESET_REMAINING or Gregorian flag, known (the head is exempt), and a
// token or leaky lane.
GT_HD bool lane_mergeable(const Req& r, const Req& h, bool head) {
  return r.valid != 0 && same_fold_fields(r, h) && r.hits > 0 &&
         (r.behavior & NO_MERGE) == 0 && (r.known != 0 || head) &&
         r.algorithm <= LEAKY;
}

// The request proves its head comes out alive (tick.merge_tick `proven`):
// such a group's followers never ride a rank round.
GT_HD bool proven_alive(const Req& r, int64_t now) {
  return r.duration > 0 && r.created_at >= now &&
         r.created_at <= I64_MAX - r.duration;
}

// What a merged group's answers take from its head, computed once.
struct FoldTerms {
  int64_t base, q, residue, h, rate_i, E, S0, created_at, limit;
  bool is_tok, drain;
};

GT_HD FoldTerms fold_terms(const Req& r, const FoldHead& f) {
  FoldTerms k;
  k.is_tok = r.algorithm == TOKEN;
  k.h = r.hits > 0 ? r.hits : 1;
  k.base = k.is_tok ? f.R0 : trunc_i64(f.F0);
  k.q = floor_div(k.base, k.h);
  k.drain = (r.behavior & DRAIN_OVER_LIMIT) != 0;
  k.residue = wsub(k.base, wmul(k.q, k.h));
  const int64_t safe_limit = r.limit == 0 ? 1 : r.limit;
  k.rate_i = trunc_i64((double)r.duration / (double)safe_limit);
  k.E = f.E;
  k.S0 = f.S0;
  k.created_at = r.created_at;
  k.limit = r.limit;
  return k;
}

// The follower at rank i of a merged group (head alive).
GT_HD Resp fold_answer_at(const FoldTerms& k, int64_t i) {
  const bool under = i <= k.q;
  const int64_t rem_over = k.drain ? 0 : k.residue;
  const int64_t rem_resp = under ? wsub(k.base, wmul(i, k.h)) : rem_over;
  const int64_t reset_rem =
      under ? rem_resp : ((k.drain && i > wadd(k.q, 1)) ? 0 : k.residue);
  Resp p;
  p.status = under ? (k.is_tok ? k.S0 : UNDER) : OVER;
  p.remaining = rem_resp;
  p.reset_time = k.is_tok ? k.E
                          : wadd(k.created_at,
                                 wmul(wsub(k.limit, reset_rem), k.rate_i));
  p.over_limit = under ? 0 : 1;
  return p;
}

GT_HD Resp fold_answer(const Req& r, const FoldHead& f, int64_t i) {
  return fold_answer_at(fold_terms(r, f), i);
}

// The head's row after a merged group of li followers (head alive): token
// remaining and status, leaky remaining_f.
GT_HD void fold_row(const Req& r, const FoldHead& f, int64_t li, int64_t* s) {
  const bool is_tok = r.algorithm == TOKEN;
  const int64_t h = r.hits > 0 ? r.hits : 1;
  const int64_t base = is_tok ? f.R0 : trunc_i64(f.F0);
  const int64_t q = floor_div(base, h);
  const bool drain = (r.behavior & DRAIN_OVER_LIMIT) != 0;
  const int64_t residue = wsub(base, wmul(q, h));
  const bool divisible = residue == 0;
  if (is_tok) {
    s[W_REMAINING] = li <= q ? wsub(base, wmul(li, h)) : (drain ? 0 : residue);
    const bool at_zero = divisible ? li > q : (drain && li > wadd(q, 1));
    s[W_STATUS] = at_zero ? OVER : f.S0;
  } else {
    const bool zero_f = (q >= 1 && divisible && li >= q) ||
                        (base > 0 && drain && li > q);
    s[W_REMAINING_F] = f64_to_bits(
        zero_f ? 0.0 : f.F0 - (double)wmul(imin(li, q), h));
  }
}

// ---- the transition's steps as the warp and block steps call them ----

// One live lane's transition of row `s` (transition_class).
GT_HD Resp tt_transition(int64_t now, const Req& r, int64_t* s) {
  return transition_class(algo_class(r.algorithm), now, r, s);
}

// Lane x's request-only terms into the columns `cols` of n lanes.
GT_HD void tt_prepare(int64_t* cols, int n, int x, int64_t now,
                      const Req& r) {
  put_prep(cols, n, x, prepare(algo_class(r.algorithm), now, r));
}

// Lane x's prepared link applied to row `s`; its answer replaces its
// first four terms (get_answer reads it).
GT_HD void tt_apply(int64_t* cols, int n, int x, int64_t now,
                    int64_t* s) {
  const Resp a = apply(now, get_prep(cols, n, x), s);
  cols[0 * n + x] = a.status;
  cols[1 * n + x] = a.remaining;
  cols[2 * n + x] = a.reset_time;
  cols[3 * n + x] = a.over_limit;
}

// Lanes [p, q) of a piece, in one thread, on the row `s` (loaded from
// `row` at the first valid lane when `loaded` is false): the head, then
// the fold or the followers in order, answers straight to `resp`.
// Invalid lanes answer zeros and hold no rank.  Returns the piece's rank
// rounds.  The path of pieces with an invalid lane, which the engine's
// windows never hold (their extents hold only packed lanes).
GT_HD int64_t piece_serial(const int32_t* m32, int64_t ld_m, int64_t p,
                           int64_t q, int64_t now, const int64_t* row,
                           int64_t* s, bool& loaded, int32_t* resp,
                           int64_t ld_r) {
  int64_t h = p;
  for (; h < q && m32[R_VALID * ld_m + h] == 0; ++h) {
    store_resp(resp, ld_r, h, Resp{}, false);
  }
  if (h == q) return 0;
  if (!loaded) {
    load_row(row, s);
    loaded = true;
  }
  const Req hr = load_req(m32, ld_m, h);
  store_resp(resp, ld_r, h, tt_transition(now, hr, s), true);
  int64_t n = 1;
  bool elig = lane_mergeable(hr, hr, true);
  for (int64_t j = h + 1; j < q; ++j) {
    if (m32[R_VALID * ld_m + j] == 0) continue;
    ++n;
    elig = elig && lane_mergeable(load_req(m32, ld_m, j), hr, false);
  }
  if (n == 1) {  // the lanes after the head are invalid
    for (int64_t j = h + 1; j < q; ++j) {
      store_resp(resp, ld_r, j, Resp{}, false);
    }
    return 0;
  }
  const bool proven = proven_alive(hr, now);
  if (elig) {
    const FoldHead f = fold_head(s);
    const bool alive = now <= f.E;
    if (alive || proven) {
      int64_t i = 0;
      for (int64_t j = h + 1; j < q; ++j) {
        const bool live = alive && m32[R_VALID * ld_m + j] != 0;
        i += m32[R_VALID * ld_m + j] != 0;
        store_resp(resp, ld_r, j, live ? fold_answer(hr, f, i) : Resp{},
                   live);
      }
      if (alive) fold_row(hr, f, n - 1, s);
      return proven ? 0 : n - 1;
    }
  }
  for (int64_t j = h + 1; j < q; ++j) {
    const Req r = load_req(m32, ld_m, j);
    if (r.valid == 0) {
      store_resp(resp, ld_r, j, Resp{}, false);
      continue;
    }
    store_resp(resp, ld_r, j, tt_transition(now, r, s), true);
  }
  return n - 1;
}

// ---- what every step reads ----

struct TileTick {
  int64_t* table;
  TileGeom g;
  const int32_t* m32;
  int64_t ld_m;
  int32_t* resp;
  int64_t ld_r;
  int64_t lanes, now, n_lane_blocks;
  Scratch sc;
};

GT_HD int64_t* row_ptr(const TileTick& c, int64_t row) {
  return c.table + row * ROW_W;
}

// Bit masks of a window: lanes [lo, hi) of 32.
GT_HD uint32_t span_bits(int lo, int hi) {
  const uint32_t below_hi = hi >= 32 ? 0xffffffffu : ((1u << hi) - 1u);
  const uint32_t below_lo = lo >= 32 ? 0xffffffffu : ((1u << lo) - 1u);
  return below_hi & ~below_lo;
}

GT_HD int low_bit(uint32_t m) {  // m != 0
#if defined(__CUDA_ARCH__)
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

GT_HD int high_bit(uint32_t m) {  // m != 0
#if defined(__CUDA_ARCH__)
  return 31 - __clz(m);
#else
  return 31 - __builtin_clz(m);
#endif
}

// A lane's answer from its prepared columns, once tt_apply wrote it over
// its first four terms.
GT_HD Resp get_answer(const int64_t* cols, int n, int x) {
  Resp a;
  a.status = cols[0 * n + x];
  a.remaining = cols[1 * n + x];
  a.reset_time = cols[2 * n + x];
  a.over_limit = cols[3 * n + x];
  return a;
}

// ---- lane blocks: a warp's window ----

// A lane as its warp's steps see it after classification.
struct TLane {
  Req r;  // the fold fields, valid and known words of its request
  Extent e;
  int64_t x, row;  // window lane; table row (-1: the lane answers zeros)
  bool good, head, notlink, bad, huge, giant, cont;
};

// The fields of lane x's request that the fold compares, and its valid
// and known words.
GT_HD Req load_fold_fields(const int32_t* m, int64_t ld, int64_t x) {
  auto pair = [&](int row) {
    return ((int64_t)m[(row + 1) * ld + x] << 32) |
           (int64_t)(uint32_t)m[row * ld + x];
  };
  Req r = Req{};
  r.known = m[R_KNOWN * ld + x];
  r.algorithm = m[R_ALGORITHM * ld + x];
  r.behavior = m[R_BEHAVIOR * ld + x];
  r.valid = m[R_VALID * ld + x];
  r.hits = pair(R_HITS);
  r.limit = pair(R_LIMIT);
  r.duration = pair(R_DURATION);
  r.created_at = pair(R_CREATED_AT);
  r.burst = pair(R_BURST);
  return r;
}

// Lane x of the window, as its classification reads it.  Every read is
// issued first, none waiting on another: the slot and the slots around
// it, the request's fold fields and those of the lane before.
GT_HD TLane classify(const TileTick& c, int64_t x) {
  TLane L;
  L.e = Extent{0, 0, 0};
  L.r = Req{};
  L.x = x;
  L.row = -1;
  L.good = L.head = L.notlink = L.bad = L.huge = L.giant = L.cont = false;
  if (x >= c.lanes) return L;
  const int32_t slot = slot_at(c.m32, c.ld_m, x);
  const int32_t prev = slot_at(c.m32, c.ld_m, x > 0 ? x - 1 : x);
  const int32_t next = slot_at(c.m32, c.ld_m, x + 1 < c.lanes ? x + 1 : x);
  const int32_t far =
      slot_at(c.m32, c.ld_m, x + TT_HUGE < c.lanes ? x + TT_HUGE : x);
  const int32_t farther =
      slot_at(c.m32, c.ld_m, x + TT_GIANT < c.lanes ? x + TT_GIANT : x);
  const Req r = load_fold_fields(c.m32, c.ld_m, x);
  const Req pr = load_fold_fields(c.m32, c.ld_m, x > 0 ? x - 1 : x);
  if (!in_extents(c.g, x)) return L;
  L.e = extent_at(c.g, x);
  L.row = shard_row(c.g, L.e.shard, slot);
  if (L.row < 0) return L;
  L.good = true;
  L.r = r;
  L.bad = r.valid == 0;
  L.head = x == L.e.a || prev != slot;
  if (L.head) {
    L.huge = x + TT_HUGE < L.e.z && far == slot;
    L.giant = L.huge && x + TT_GIANT < L.e.z && farther == slot;
  } else {
    // The lane folds with the one before it: both valid, the same fold
    // fields, the lane a mergeable follower.  A piece whose followers all
    // do folds (its fields equal along it).
    L.notlink = !(pr.valid != 0 && lane_mergeable(r, pr, false));
  }
  L.cont = x + 1 < L.e.z && next == slot;
  return L;
}

// A window's ballots.
struct WarpMasks {
  uint32_t head, brk, notlink, bad;
  bool cont31;  // lane 31's run goes on past the window
};

// A warp's shared memory: its head lanes' rows and a chain slice.
struct WarpSmem {
  int64_t rows[32 * ROWP];
  int64_t prep[PREP_W * 32];
};

// Step 1 for warp `wi` of lane block `b`: classify and answer the lanes
// off every extent or shard; lane 0 writes the window's words (tagged: no
// flag, no fence) and, through the policy, pushes the head of a run past
// TT_HUGE lanes onto a run queue (queue 0 past TT_GIANT lanes) and counts
// the warp classified; the heads stage their rows.
template <class W>
GT_HD void warp_classify(const W& w, const TileTick& c, int64_t b, int wi,
                         TLane* L, WarpMasks& M, WarpSmem& S) {
  const int64_t w0 = b * TT_THREADS + wi * 32;
  for (int k = 0; k < W::N; ++k) {
    const int64_t x = w0 + w.lane(k);
    L[k] = classify(c, x);
    if (!L[k].good && x < c.lanes) {
      store_resp(c.resp, c.ld_r, x, Resp{}, false);
    }
  }
  const uint32_t good = w.ballot([&](int k) { return L[k].good; });
  M.head = w.ballot([&](int k) { return L[k].head; });
  M.brk = ~good | M.head;
  M.notlink = w.ballot([&](int k) { return L[k].notlink; });
  M.bad = w.ballot([&](int k) { return L[k].bad; });
  M.cont31 = w.from([&](int k) { return (int64_t)L[k].cont; }, 31) != 0;
  // At most one run past TT_HUGE lanes starts in a window.
  const uint32_t huge = w.ballot([&](int k) { return L[k].huge; });
  const uint32_t giant = w.ballot([&](int k) { return L[k].giant; });
  const int ht = huge ? low_bit(huge) : 0;
  const int64_t hrow = w.from([&](int j) { return L[j].row; }, ht);
  for (int k = 0; k < W::N; ++k) {
    if (w.lane(k) != 0) continue;
    const uint64_t tag = (uint64_t)c.sc.epoch << 32;
    uint64_t* u = c.sc.units + (w0 / 32) * WORD_W;
    u[U_BRK] = tag | M.brk;
    u[U_NOTLINK] = tag | M.notlink;
    u[U_BAD] = tag | M.bad;
    w.publish(c.sc, huge ? (giant ? 0 : 1) : -1, w0 + ht, hrow);
  }
  // The heads stage their rows for step 2.
  for (int k = 0; k < W::N; ++k) {
    if (L[k].head && !L[k].huge) {
      load_row(row_ptr(c, L[k].row), S.rows + w.lane(k) * ROWP);
    }
  }
}

// The kinds of group a head lane finds in its window.
constexpr int G_INLINE = 0, G_SERIAL = 1, G_RUN = 2, G_HUGE = 3;

// The group headed at window lane t, ending before lane `ge` (32: at the
// window's end).
GT_HD int group_kind(const TileTick& c, const TLane& L, int t, int ge,
                     const WarpMasks& M) {
  if (ge == 32 && M.cont31) return L.huge ? G_HUGE : G_RUN;
  if (chunk_end(c.g, L.e, L.x) < L.x + (ge - t)) return G_RUN;
  if (M.bad & span_bits(t, ge)) return G_SERIAL;
  return G_INLINE;
}

// The fold fields of the request of window lane `src`, for every lane
// (shuffles on the card).
template <class W>
GT_HD Req req_from_lane(const W& w, const TLane* L, int src) {
  Req r = Req{};
  r.hits = w.from([&](int j) { return L[j].r.hits; }, src);
  r.limit = w.from([&](int j) { return L[j].r.limit; }, src);
  r.duration = w.from([&](int j) { return L[j].r.duration; }, src);
  r.created_at = w.from([&](int j) { return L[j].r.created_at; }, src);
  r.burst = w.from([&](int j) { return L[j].r.burst; }, src);
  r.behavior =
      (int32_t)w.from([&](int j) { return (int64_t)L[j].r.behavior; }, src);
  r.algorithm =
      (int32_t)w.from([&](int j) { return (int64_t)L[j].r.algorithm; }, src);
  r.known = 1;
  r.valid = 1;
  return r;
}

// Step 2 for a warp: the window's INLINE groups all at once, its SERIAL
// ones in their first lanes.  Returns the lanes that head its RUN groups
// (step 3: the lane block hands them to its warps, warp_run each).
template <class W>
GT_HD uint32_t warp_groups(const W& w, const TileTick& c, const TLane* L,
                           const WarpMasks& M, WarpSmem& S) {
  int gh[W::N], ge[W::N], kind[W::N];
  bool member[W::N];
  for (int k = 0; k < W::N; ++k) {
    const int t = w.lane(k);
    const uint32_t before = M.head & span_bits(0, t + 1);
    gh[k] = before ? high_bit(before) : -1;
    const uint32_t after = gh[k] >= 0 ? M.brk & ~span_bits(0, gh[k] + 1) : 0;
    ge[k] = after ? low_bit(after) : 32;
    kind[k] = L[k].head ? group_kind(c, L[k], t, ge[k], M) : -1;
  }
  const uint32_t inl =
      w.ballot([&](int k) { return kind[k] == G_INLINE; });
  const uint32_t runs = w.ballot([&](int k) { return kind[k] == G_RUN; });
  // SERIAL groups (an invalid lane): the first lane alone.  INLINE heads
  // stage their rows and tick them.
  for (int k = 0; k < W::N; ++k) {
    const int t = w.lane(k);
    member[k] = gh[k] >= 0 && t < ge[k] && ((inl >> gh[k]) & 1u);
    int64_t* s = S.rows + t * ROWP;
    const int64_t x = L[k].x;
    if (kind[k] == G_INLINE) load_row(row_ptr(c, L[k].row), s);
    if (kind[k] == G_SERIAL) {
      int64_t* rp = row_ptr(c, L[k].row);
      bool loaded = false;
      note_rounds(c.sc, chunk_id(c.g, L[k].e, x),
                  piece_serial(c.m32, c.ld_m, x, x + (ge[k] - t), c.now, rp,
                               s, loaded, c.resp, c.ld_r));
      if (loaded) store_ticked_row(rp, s);
    }
    if (kind[k] == G_INLINE) {
      const Req r = load_req(c.m32, c.ld_m, x);
      store_resp(c.resp, c.ld_r, x, tt_transition(c.now, r, s), true);
    }
  }
  w.sync();
  // Every member takes its head's fold fields (shuffles) and post-state;
  // followers test their own.
  Req hr[W::N];
  for (int k = 0; k < W::N; ++k) {
    hr[k] = req_from_lane(w, L, gh[k] >= 0 ? gh[k] : 0);
  }
  FoldHead f[W::N];
  bool ok[W::N];
  for (int k = 0; k < W::N; ++k) {
    f[k] = FoldHead{0, 0, 0, 0.0};
    ok[k] = true;
    if (!member[k]) continue;
    if (!L[k].head) ok[k] = lane_mergeable(L[k].r, hr[k], false);
    f[k] = fold_head(S.rows + gh[k] * ROWP);
  }
  const uint32_t nm = w.ballot([&](int k) { return !ok[k]; });
  w.sync();
  // Fold or chain, per group.
  bool fold[W::N], chain[W::N];
  for (int k = 0; k < W::N; ++k) {
    fold[k] = chain[k] = false;
    if (!member[k]) continue;
    const int t = w.lane(k);
    const int n = ge[k] - gh[k];
    if (n == 1) continue;
    const bool elig = lane_mergeable(hr[k], hr[k], true) &&
                      !(nm & span_bits(gh[k] + 1, ge[k]));
    const bool alive = c.now <= f[k].E;
    fold[k] = elig && (alive || proven_alive(hr[k], c.now));
    chain[k] = !fold[k];
    if (fold[k] && !L[k].head) {
      store_resp(c.resp, c.ld_r, L[k].x,
                 alive ? fold_answer(hr[k], f[k], t - gh[k]) : Resp{},
                 alive);
    }
    if (fold[k] && L[k].head && alive) {
      fold_row(hr[k], f[k], n - 1, S.rows + t * ROWP);
    }
    if (chain[k] && !L[k].head) {
      tt_prepare(S.prep, 32, t, c.now, load_req(c.m32, c.ld_m, L[k].x));
    }
  }
  w.sync();
  for (int k = 0; k < W::N; ++k) {
    if (!(chain[k] && L[k].head)) continue;
    int64_t* s = S.rows + w.lane(k) * ROWP;
    for (int j = gh[k] + 1; j < ge[k]; ++j) tt_apply(S.prep, 32, j, c.now, s);
  }
  w.sync();
  for (int k = 0; k < W::N; ++k) {
    if (!member[k]) continue;
    const int t = w.lane(k);
    if (chain[k] && !L[k].head) {
      store_resp(c.resp, c.ld_r, L[k].x, get_answer(S.prep, 32, t), true);
    }
    if (!L[k].head) continue;
    const int n = ge[k] - gh[k];
    note_rounds(c.sc, chunk_id(c.g, L[k].e, L[k].x),
                n == 1 || (fold[k] && proven_alive(hr[k], c.now)) ? 0
                                                                  : n - 1);
    store_ticked_row(row_ptr(c, L[k].row), S.rows + t * ROWP);
  }
  w.sync();
  return runs;
}

// The run headed at window lane h (at most TT_HUGE lanes), by the whole
// warp: its end, then its pieces in order.  A piece with an invalid lane
// runs piece_serial in lane 0; else lane 0 ticks the head on the row in
// shared memory while every lane tests its lanes' eligibility against the
// head's request (32 lanes a round), then the warp answers the fold, or
// prepares the chain 32 links at a time for lane 0 to apply.
template <class W>
GT_HD void warp_run(const W& w, const TileTick& c, int64_t h, WarpSmem& S) {
  const Extent e = extent_at(c.g, h);
  const int32_t slot = slot_at(c.m32, c.ld_m, h);
  int64_t* rp = row_ptr(c, shard_row(c.g, e.shard, slot));
  int64_t* s = S.rows;
  // Lane 0 reads the row while the warp finds the run's end (a read only:
  // the row goes back only if a valid lane ticked it).
  for (int k = 0; k < W::N; ++k) {
    if (w.lane(k) == 0) load_row(rp, s);
  }
  int64_t end = -1;
  for (int64_t base = h + 1; end < 0; base += 128) {
    uint32_t off[4];
    for (int u = 0; u < 4; ++u) {
      off[u] = w.ballot([&](int k) {
        const int64_t x = base + 32 * u + w.lane(k);
        return x >= e.z || slot_at(c.m32, c.ld_m, x) != slot;
      });
    }
    for (int u = 0; u < 4 && end < 0; ++u) {
      if (off[u]) end = base + 32 * u + low_bit(off[u]);
    }
  }
  bool loaded = false;
  for (int64_t p = h; p < end;) {
    const int64_t ce = chunk_end(c.g, e, p);
    const int64_t q = ce < end ? ce : end;
    const int64_t id = chunk_id(c.g, e, p);
    const int64_t n = q - p;
    // Every lane reads the head's request and its own lanes': an invalid
    // lane, a follower that does not fold with the head.
    const Req hr = load_req(c.m32, c.ld_m, p);
    uint32_t bad = w.ballot([&](int k) {
      return w.lane(k) == 0 && hr.valid == 0;
    });
    uint32_t nm = 0;
    for (int64_t base = p + 1; base < q; base += 32) {
      Req r[W::N];
      bool live[W::N];
      for (int k = 0; k < W::N; ++k) {
        const int64_t x = base + w.lane(k);
        live[k] = x < q;
        r[k] = live[k] ? load_fold_fields(c.m32, c.ld_m, x) : hr;
      }
      bad |= w.ballot([&](int k) { return live[k] && r[k].valid == 0; });
      nm |= w.ballot([&](int k) {
        return live[k] && !lane_mergeable(r[k], hr, false);
      });
    }
    int64_t rc[W::N];
    for (int k = 0; k < W::N; ++k) {
      rc[k] = 0;
      if (w.lane(k) != 0) continue;
      if (bad) {
        rc[k] = piece_serial(c.m32, c.ld_m, p, q, c.now, rp, s, loaded,
                             c.resp, c.ld_r);
        continue;
      }
      store_resp(c.resp, c.ld_r, p, tt_transition(c.now, hr, s), true);
      loaded = true;
    }
    loaded = w.from([&](int j) {
      return (int64_t)(w.lane(j) == 0 && loaded);
    }, 0) != 0;
    w.sync();
    if (!bad && n > 1) {
      const FoldHead f = fold_head(s);
      w.sync();
      const bool elig = lane_mergeable(hr, hr, true) && nm == 0;
      const bool alive = c.now <= f.E;
      const bool proven = proven_alive(hr, c.now);
      if (elig && (alive || proven)) {
        const FoldTerms ft = fold_terms(hr, f);
        for (int64_t base = p + 1; base < q; base += 32) {
          for (int k = 0; k < W::N; ++k) {
            const int64_t x = base + w.lane(k);
            if (x < q) {
              store_resp(c.resp, c.ld_r, x,
                         alive ? fold_answer_at(ft, x - p) : Resp{}, alive);
            }
          }
        }
        for (int k = 0; k < W::N; ++k) {
          if (w.lane(k) != 0) continue;
          if (alive) fold_row(hr, f, n - 1, s);
          rc[k] = proven ? 0 : n - 1;
        }
      } else {
        for (int64_t base = p + 1; base < q; base += 32) {
          const int cnt = (int)(q - base < 32 ? q - base : 32);
          for (int k = 0; k < W::N; ++k) {
            const int t = w.lane(k);
            if (t >= cnt) continue;
            tt_prepare(S.prep, 32, t, c.now, load_req(c.m32, c.ld_m, base + t));
          }
          w.sync();
          for (int k = 0; k < W::N; ++k) {
            if (w.lane(k) != 0) continue;
            for (int j = 0; j < cnt; ++j) tt_apply(S.prep, 32, j, c.now, s);
          }
          w.sync();
          for (int k = 0; k < W::N; ++k) {
            const int t = w.lane(k);
            if (t < cnt) {
              store_resp(c.resp, c.ld_r, base + t,
                         get_answer(S.prep, 32, t), true);
            }
          }
          w.sync();
        }
        for (int k = 0; k < W::N; ++k) {
          if (w.lane(k) == 0) rc[k] = n - 1;
        }
      }
    }
    for (int k = 0; k < W::N; ++k) {
      if (w.lane(k) == 0) note_rounds(c.sc, id, rc[k]);
    }
    w.sync();
    p = q;
  }
  for (int k = 0; k < W::N; ++k) {
    if (w.lane(k) == 0 && loaded) store_ticked_row(rp, s);
  }
  w.sync();
}

// ---- run blocks: runs past TT_HUGE lanes ----

constexpr int RUN_NONE = 0, RUN_FOLD = 1, RUN_CHAIN = 2;

// A piece as its head left it: what its followers do, and for a fold
// what their answers take.
struct PieceHead {
  FoldTerms ft;
  int64_t p, q;
  int32_t mode;
  bool alive;
};

struct RunSmem {
  int64_t prep[PREP_W * TT_CHAIN];
  int32_t resp[RESP_ROWS * TT_CHAIN];
  alignas(16) int64_t row[ROW_W];
  // The first pieces' head requests' words, read ahead (word k of piece
  // j's head at hwords[k][j]).
  int32_t hwords[REQ32_ROWS][TT_PIECES];
  PieceHead piece[TT_PIECES];  // a batch of pieces
  uint32_t wnl[TT_THREADS], wbd[TT_THREADS];  // a thread's words, kept
  uint32_t notlink[TT_PIECES], bad[TT_PIECES];
  int32_t upto;
  bool loaded;
};

// Piece k of the run [h, end) of extent e: its first lane.
GT_HD int64_t piece_start(const TileGeom& g, const Extent& e, int64_t h,
                          int64_t k) {
  return k == 0 ? h : e.a + (chunk_of(g, e, h) + k) * g.tile;
}

// Piece k's index for lane x of the run headed at h.
GT_HD int64_t piece_of(const TileGeom& g, const Extent& e, int64_t h,
                       int64_t x) {
  return chunk_of(g, e, x) - chunk_of(g, e, h);
}

// The published words of the 32 lanes from lane 32 wd.
GT_HD const uint64_t* unit_words(const TileTick& c, int64_t wd) {
  return c.sc.units + wd * WORD_W;
}

// Word wd's notlink and invalid bits into the flags of pieces [pb, pb +
// TT_PIECES) of the run [h, end): a follower that does not fold with the
// lane before it (a piece's head excepted), an invalid lane.
template <class B>
GT_HD void flag_word(const B& b, const TileTick& c, const Extent& e,
                     int64_t h, int64_t end, int64_t pb, int64_t lo,
                     int64_t hi, int64_t wd, uint32_t nl, uint32_t bd,
                     RunSmem& S) {
  const int64_t x0 = wd * 32 > lo ? wd * 32 : lo;
  const int64_t x1 = wd * 32 + 32 < hi ? wd * 32 + 32 : hi;
  if (x0 >= x1) return;
  for (int64_t k = piece_of(c.g, e, h, x0); k <= piece_of(c.g, e, h, x1 - 1);
       ++k) {
    const int64_t ps = piece_start(c.g, e, h, k);
    const int64_t ce = chunk_end(c.g, e, ps);
    const int64_t qe = ce < end ? ce : end;
    const int64_t a0 = ps > x0 ? ps : x0;
    const int64_t a1 = qe < x1 ? qe : x1;
    if (a0 >= a1) continue;
    const uint32_t m = span_bits((int)(a0 - wd * 32), (int)(a1 - wd * 32));
    const uint32_t head_bit =
        ps >= wd * 32 && ps < wd * 32 + 32 ? 1u << (ps - wd * 32) : 0u;
    if (nl & m & ~head_bit) b.or_at(S.notlink + (k - pb), 1u);
    if (bd & m) b.or_at(S.bad + (k - pb), 1u);
  }
}

// The pieces [pb, pe) of the run [h, end) in order, their flags set.
// Thread 0 ticks the heads one after another up to the first piece whose
// followers chain (the row stays in shared memory; the first pieces' head
// requests were read ahead); then every thread writes the fold pieces'
// answers, and the block runs the chain, if one ended the stretch.
template <class B>
GT_HD void run_pieces(const B& b, const TileTick& c, const Extent& e,
                      int64_t h, int64_t end, int64_t* rp, int64_t pb,
                      int64_t pe, RunSmem& S) {
  for (int64_t k = pb; k < pe;) {
    b.once([&] {
      int64_t* s = S.row;
      int64_t j = k;
      while (j < pe) {
        const int64_t p = piece_start(c.g, e, h, j);
        const int64_t ce = chunk_end(c.g, e, p);
        const int64_t q = ce < end ? ce : end;
        const int64_t id = chunk_id(c.g, e, p);
        const int64_t n = q - p;
        PieceHead& P = S.piece[j - pb];
        P.p = p;
        P.q = q;
        P.mode = RUN_NONE;
        ++j;
        if (S.bad[j - 1 - pb]) {
          note_rounds(c.sc, id,
                      piece_serial(c.m32, c.ld_m, p, q, c.now, rp, s,
                                   S.loaded, c.resp, c.ld_r));
          continue;
        }
        const Req hr =
            j - 1 < TT_PIECES
                ? req_from([&](int w) { return S.hwords[w][j - 1]; })
                : load_req(c.m32, c.ld_m, p);
        S.loaded = true;
        store_resp(c.resp, c.ld_r, p, tt_transition(c.now, hr, s), true);
        const FoldHead f = fold_head(s);
        const bool alive = c.now <= f.E;
        const bool proven = proven_alive(hr, c.now);
        const bool elig =
            lane_mergeable(hr, hr, true) && S.notlink[j - 1 - pb] == 0;
        P.mode = n <= 1 ? RUN_NONE
                        : (elig && (alive || proven) ? RUN_FOLD : RUN_CHAIN);
        if (P.mode == RUN_FOLD) {
          P.ft = fold_terms(hr, f);
          P.alive = alive;
          if (alive) fold_row(hr, f, n - 1, s);
        }
        note_rounds(c.sc, id,
                    P.mode == RUN_NONE || (P.mode == RUN_FOLD && proven)
                        ? 0
                        : n - 1);
        if (P.mode == RUN_CHAIN) break;
      }
      S.upto = (int32_t)(j - pb);
    });
    b.sync();
    const int64_t upto = pb + S.upto;
    b.each([&](int t) {
      for (int64_t j = k; j < upto; ++j) {
        const PieceHead& P = S.piece[j - pb];
        if (P.mode != RUN_FOLD) continue;
        const FoldTerms ft = P.ft;
        for (int64_t x = P.p + 1 + t; x < P.q; x += TT_THREADS) {
          store_resp(c.resp, c.ld_r, x,
                     P.alive ? fold_answer_at(ft, x - P.p) : Resp{},
                     P.alive);
        }
      }
    });
    const PieceHead last = S.piece[upto - 1 - pb];
    if (last.mode == RUN_CHAIN) {
      for (int64_t base = last.p + 1; base < last.q; base += TT_CHAIN) {
        const int cnt =
            (int)(last.q - base < TT_CHAIN ? last.q - base : TT_CHAIN);
        b.each([&](int t) {
          for (int i = t; i < cnt; i += TT_THREADS) {
            tt_prepare(S.prep, TT_CHAIN, i, c.now,
                       load_req(c.m32, c.ld_m, base + i));
          }
        });
        b.sync();
        b.once([&] {
          int64_t s[ROW_W];
          for (int i = 0; i < ROW_W; ++i) s[i] = S.row[i];
          for (int i = 0; i < cnt; ++i) {
            store_resp(S.resp, TT_CHAIN, i,
                       apply(c.now, get_prep(S.prep, TT_CHAIN, i), s), true);
          }
          for (int i = 0; i < ROW_W; ++i) S.row[i] = s[i];
        });
        b.sync();
        b.each([&](int t) {
          for (int r = 0; r < RESP_ROWS; ++r) {
            for (int i = t; i < cnt; i += TT_THREADS) {
              c.resp[r * c.ld_r + base + i] = S.resp[r * TT_CHAIN + i];
            }
          }
        });
      }
    }
    b.sync();
    k = upto;
  }
}

// The run headed at lane h on table row `row`, by a block (policy B: the
// threads of the block, their barriers, reductions and staged copies).
// 1. The row and the first pieces' head requests are staged (copies in
// flight), while every thread reads one 32-lane word of the warps'
// boundary, notlink and invalid bits (8192 lanes a round; a word not yet
// this launch's is awaited): the run's end is their first boundary past
// h.  2. The pieces' flags come from the same words (read again only for
// a run past a round or past TT_PIECES pieces).  3. run_pieces.
template <class B>
GT_HD void run_block(const B& b, const TileTick& c, int64_t h, int64_t row,
                     RunSmem& S) {
  const Extent e = extent_at(c.g, h);
  int64_t* rp = row_ptr(c, row);
  const int64_t w0 = h / 32;
  // The row and the first pieces' head requests are staged (copies in
  // flight, no thread waiting on them) while the end is found.
  b.each([&](int t) {
    if (t < ROW_W / 2) b.stage16(S.row + 2 * t, rp + 2 * t);
    if (t == 0) S.loaded = false;
    if (t < TT_PIECES) {
      S.notlink[t] = S.bad[t] = 0;
      const int64_t ps = piece_start(c.g, e, h, t);
      if (ps < e.z) {
        for (int k = 0; k < REQ32_ROWS; ++k) {
          b.stage4(&S.hwords[k][t], c.m32 + k * c.ld_m + ps);
        }
      }
    }
  });
  int64_t end = b.min([&](int t) {
    const int64_t wd = w0 + t;
    S.wnl[t] = S.wbd[t] = 0;
    if (wd * 32 >= c.lanes) return c.lanes;
    const uint64_t* u = unit_words(c, wd);
    uint32_t bits = b.word(u + U_BRK, c.sc.epoch);
    S.wnl[t] = b.word(u + U_NOTLINK, c.sc.epoch);
    S.wbd[t] = b.word(u + U_BAD, c.sc.epoch);
    if (wd == w0) bits &= ~span_bits(0, (int)(h % 32) + 1);
    return bits ? wd * 32 + low_bit(bits) : INT64_MAX;
  });
  const bool one_round = end != INT64_MAX;
  for (int64_t r0 = w0 + TT_THREADS; end == INT64_MAX; r0 += TT_THREADS) {
    end = b.min([&](int t) {
      const int64_t wd = r0 + t;
      if (wd * 32 >= c.lanes) return c.lanes;
      const uint32_t bits = b.word(unit_words(c, wd) + U_BRK, c.sc.epoch);
      return bits ? wd * 32 + low_bit(bits) : INT64_MAX;
    });
  }
  const int64_t pieces = piece_of(c.g, e, h, end - 1) + 1;
  if (one_round && pieces <= TT_PIECES) {
    b.each([&](int t) {
      flag_word(b, c, e, h, end, 0, h, end, w0 + t, S.wnl[t], S.wbd[t], S);
      b.staged();
    });
    b.sync();
    run_pieces(b, c, e, h, end, rp, 0, pieces, S);
  } else {
    for (int64_t pb = 0; pb < pieces; pb += TT_PIECES) {
      const int64_t pe = pieces - pb < TT_PIECES ? pieces : pb + TT_PIECES;
      b.each([&](int t) {
        if (t < TT_PIECES) S.notlink[t] = S.bad[t] = 0;
        b.staged();
      });
      b.sync();
      const int64_t lo = piece_start(c.g, e, h, pb);
      const int64_t hi = pe < pieces ? piece_start(c.g, e, h, pe) : end;
      b.each([&](int t) {
        for (int64_t wd = lo / 32 + t; wd * 32 < hi; wd += TT_THREADS) {
          const uint64_t* u = unit_words(c, wd);
          flag_word(b, c, e, h, end, pb, lo, hi, wd,
                    b.word(u + U_NOTLINK, c.sc.epoch),
                    b.word(u + U_BAD, c.sc.epoch), S);
        }
      });
      b.sync();
      run_pieces(b, c, e, h, end, rp, pb, pe, S);
    }
  }
  b.once([&] {
    if (S.loaded) store_ticked_row(rp, S.row);
  });
  b.sync();
}

}  // namespace gt
