// The lane code of the mesh's duplicate tile tick (kernel B.6,
// mesh_tile_tick.cu), host and device code alike: the kernel runs it with
// its threads and barriers, the host build (fused_tick_host.cc) step after
// step in one thread, and the CPU tests hold the host build against the
// plain version (ops/tiletick.py mesh_tile_tick_plain: the tile walk of
// each shard's extent through tick.merge_tick).
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
// from the first one's final row, so a run's pieces go in order through
// one thread (piece_serial) or one block (mesh_tile_tick.cu).
//
// Rank rounds: the plain version ticks a chunk's non-folded followers in
// rounds of one lane a slot; a chunk's rounds are the most followers of
// one of its pieces that did not fold in closed form (a group that is not
// eligible, or an eligible one whose head the request does not prove
// alive).  The kernel adds each chunk's rounds to a counter with an
// atomic max a chunk (note_rounds), so metric_rank_rounds keeps the
// meaning it has on the CPU.
#pragma once

#include "sorted_tick.cuh"

namespace gt {

// A run of more than TT_LONG lanes of one slot gets a block of its own
// (long block k owns the long run headed in lanes [k (TT_LONG + 1),
// k (TT_LONG + 1) + TT_LONG]); a shorter run is one thread's.  A thread
// reads its lanes' requests one after another, so a short run costs
// ~26 dependent memory operations a lane: TT_LONG keeps that chain to a
// warp's width (at 256, phase 4's herd waited on the Zipf tail's runs of
// 33-256 lanes, PERF.md §6).
constexpr int TT_THREADS = 256;
constexpr int TT_LONG = 32;
// Lanes of a non-folding group a long block prepares at a time.
constexpr int TT_CHAIN = 256;
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

// The run headed at lane j has more than TT_LONG lanes.
GT_HD bool long_run(const int32_t* m32, int64_t ld_m, const Extent& e,
                    int64_t j) {
  return j + TT_LONG < e.z &&
         slot_at(m32, ld_m, j + TT_LONG) == slot_at(m32, ld_m, j);
}

GT_HD int64_t long_blocks_tt(int64_t lanes) { return lanes / (TT_LONG + 1); }

// The end of the chunk that holds lane p of extent e.
GT_HD int64_t chunk_end(const TileGeom& g, const Extent& e, int64_t p) {
  const int64_t end = e.a + ((p - e.a) / g.tile + 1) * g.tile;
  return end < e.z ? end : e.z;
}

// The counter cell of the chunk that holds lane p of extent e.
GT_HD int64_t chunk_id(const TileGeom& g, const Extent& e, int64_t p) {
  return e.shard * g.max_tiles + (p - e.a) / g.tile;
}

// A piece's rank rounds into its chunk's cell; the counter grows by what
// the chunk's maximum grows by, so it ends at the sum of the chunks'
// maxima whatever the order of the pieces.
GT_HD void note_rounds(int32_t* tile_max, int64_t* rounds, int64_t id,
                       int64_t c) {
  if (c <= 0) return;
#if defined(__CUDA_ARCH__)
  const int old = atomicMax(tile_max + id, (int)c);
  if (c > old) {
    atomicAdd(reinterpret_cast<unsigned long long*>(rounds),
              (unsigned long long)(c - old));
  }
#else
  if (c > tile_max[id]) {
    *rounds += c - tile_max[id];
    tile_max[id] = (int32_t)c;
  }
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

// Lane r may fold against head h (transition.py merge_eligible): valid,
// identical to the head in every field the fold reads, hits > 0, no
// RESET_REMAINING or Gregorian flag, known (the head is exempt), and a
// token or leaky lane.
GT_HD bool lane_mergeable(const Req& r, const Req& h, bool head) {
  return r.valid != 0 && r.hits == h.hits && r.limit == h.limit &&
         r.duration == h.duration && r.behavior == h.behavior &&
         r.created_at == h.created_at && r.burst == h.burst &&
         r.algorithm == h.algorithm && r.hits > 0 &&
         (r.behavior & NO_MERGE) == 0 && (r.known != 0 || head) &&
         r.algorithm <= LEAKY;
}

// The request proves its head comes out alive (tick.merge_tick `proven`):
// such a group's followers never ride a rank round.
GT_HD bool proven_alive(const Req& r, int64_t now) {
  return r.duration > 0 && r.created_at >= now &&
         r.created_at <= I64_MAX - r.duration;
}

// The follower at rank i of a merged group (head alive).
GT_HD Resp fold_answer(const Req& r, const FoldHead& f, int64_t i) {
  const bool is_tok = r.algorithm == TOKEN;
  const int64_t h = r.hits > 0 ? r.hits : 1;
  const int64_t base = is_tok ? f.R0 : trunc_i64(f.F0);
  const int64_t q = floor_div(base, h);
  const bool drain = (r.behavior & DRAIN_OVER_LIMIT) != 0;
  const bool under = i <= q;
  const int64_t residue = wsub(base, wmul(q, h));
  const int64_t rem_over = drain ? 0 : residue;
  const int64_t rem_resp = under ? wsub(base, wmul(i, h)) : rem_over;
  const int64_t safe_limit = r.limit == 0 ? 1 : r.limit;
  const int64_t rate_i = trunc_i64((double)r.duration / (double)safe_limit);
  const int64_t reset_rem =
      under ? rem_resp : ((drain && i > wadd(q, 1)) ? 0 : residue);
  Resp p;
  p.status = under ? (is_tok ? f.S0 : UNDER) : OVER;
  p.remaining = rem_resp;
  p.reset_time = is_tok ? f.E
                        : wadd(r.created_at,
                               wmul(wsub(r.limit, reset_rem), rate_i));
  p.over_limit = under ? 0 : 1;
  return p;
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

// Lanes [p, q) of a piece, in one thread, on the row `s` (loaded from
// `row` at the first valid lane when `loaded` is false): the head, then
// the fold or the followers in order, answers straight to `resp`.
// Invalid lanes answer zeros and hold no rank.  Returns the piece's rank
// rounds.
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
  store_resp(resp, ld_r, h,
             transition_class(algo_class(hr.algorithm), now, hr, s), true);
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
    store_resp(resp, ld_r, j, transition_class(algo_class(r.algorithm), now,
                                               r, s),
               true);
  }
  return n - 1;
}

// The run [j, end) of one slot (end past its last lane) on table row
// `row`, in one thread: its pieces in order, the row in registers.
GT_HD void run_serial(int64_t* table, const TileGeom& g, const Extent& e,
                      const int32_t* m32, int64_t ld_m, int32_t* resp,
                      int64_t ld_r, int64_t now, int64_t row, int64_t j,
                      int64_t end, int32_t* tile_max, int64_t* rounds) {
  int64_t* rp = table + row * ROW_W;
  int64_t s[ROW_W];
  bool loaded = false;
  for (int64_t p = j; p < end;) {
    const int64_t ce = chunk_end(g, e, p);
    const int64_t q = ce < end ? ce : end;
    note_rounds(tile_max, rounds, chunk_id(g, e, p),
                piece_serial(m32, ld_m, p, q, now, rp, s, loaded, resp,
                             ld_r));
    p = q;
  }
  if (loaded) store_ticked_row(rp, s);
}

// A lane thread's step for lane j: lanes off every extent and lanes whose
// slot is not their shard's answer zeros; the head of a short run runs
// it.  True when lane j heads a long run (a long block's).
GT_HD bool lane_step(int64_t* table, const TileGeom& g, const int32_t* m32,
                     int64_t ld_m, int32_t* resp, int64_t ld_r, int64_t now,
                     int64_t j, int32_t* tile_max, int64_t* rounds) {
  if (!in_extents(g, j)) {
    store_resp(resp, ld_r, j, Resp{}, false);
    return false;
  }
  const Extent e = extent_at(g, j);
  const int32_t slot = slot_at(m32, ld_m, j);
  const int64_t row = shard_row(g, e.shard, slot);
  if (row < 0) {
    store_resp(resp, ld_r, j, Resp{}, false);
    return false;
  }
  if (!run_head(m32, ld_m, e, j)) return false;
  if (long_run(m32, ld_m, e, j)) return true;
  int64_t end = j + 1;
  while (end < e.z && slot_at(m32, ld_m, end) == slot) ++end;
  run_serial(table, g, e, m32, ld_m, resp, ld_r, now, row, j, end, tile_max,
             rounds);
  return false;
}

// Long block k's head search for thread t of `step`: the long run head
// among the thread's lanes of the block's range, or -1.
GT_HD int64_t long_head_tt(const TileGeom& g, const int32_t* m32,
                           int64_t ld_m, int64_t lanes, int64_t k, int t,
                           int step) {
  const int64_t a = k * (TT_LONG + 1);
  for (int64_t j = a + t; j <= a + TT_LONG && j < lanes; j += step) {
    if (!in_extents(g, j)) continue;
    const Extent e = extent_at(g, j);
    if (shard_row(g, e.shard, slot_at(m32, ld_m, j)) >= 0 &&
        run_head(m32, ld_m, e, j) && long_run(m32, ld_m, e, j)) {
      return j;
    }
  }
  return -1;
}

// A long block's shared memory: the prepared terms and answers of
// TT_CHAIN lanes of a non-folding group, and the block's broadcasts.
struct LongSmem {
  int64_t prep[PREP_W * TT_CHAIN];
  int32_t resp[RESP_ROWS * TT_CHAIN];
  FoldHead fold;
  int64_t head, end;
  int32_t bad;
};

// Long block step: lane i of the chain slice from lane `base` prepared.
GT_HD void chain_prepare(LongSmem& S, const int32_t* m32, int64_t ld_m,
                         int64_t base, int i, int64_t now) {
  const Req r = load_req(m32, ld_m, base + i);
  put_prep(S.prep, TT_CHAIN, i, prepare(algo_class(r.algorithm), now, r));
}

// Long block step, in one thread: the slice's n prepared lanes applied in
// order on the row `s`, answers into S.resp.
GT_HD void chain_apply(LongSmem& S, int n, int64_t now, int64_t* s) {
  for (int i = 0; i < n; ++i) {
    store_resp(S.resp, TT_CHAIN, i, apply(now, get_prep(S.prep, TT_CHAIN, i),
                                          s),
               true);
  }
}

// Long block step for thread t of `step`: the slice's n answers to window
// lanes base.., row by row.
GT_HD void chain_respond(const LongSmem& S, int t, int step, int n,
                         int32_t* resp, int64_t ld_r, int64_t base) {
  for (int w = 0; w < RESP_ROWS; ++w) {
    for (int i = t; i < n; i += step) {
      resp[w * ld_r + base + i] = S.resp[w * TT_CHAIN + i];
    }
  }
}

}  // namespace gt
