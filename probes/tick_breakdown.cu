// Breakdown probes of two kernels on one card: where the time of the mesh's
// duplicate tile tick (B.6) and of the GLOBAL mesh's dense reconcile
// (B.8b) goes in their one-thread designs (those before the Hopper
// redesigns in gubernator_tpu_torch/csrc/mesh_tile_tick.cu and
// global_mesh.cu).  Built and driven by probes/tick_breakdown.py.
//
// B.6 (namespace prev): the earlier design, copied as it was: a lane block
// of 256 lanes runs every run of at most 32 lanes in the thread of its
// head (run_serial), and lanes / 33 long blocks each search 33 lanes for
// the head of a longer run and take its pieces in order.  prev_tick runs
// it as the package ran it (a memset of the rank-round scratch, then the
// kernel); prev_tick_probe runs the same kernel with clock64 and
// globaltimer stamps: per block its start and end, its kind, its work,
// and for a long block the cycles of each step (end search, invalid-lane
// check, head, eligibility, fold, chain), for a lane block the slowest
// thread's cycles and run.
//
// B.8b: the earlier dense kernel (one thread a slot: the owner's row in
// registers by 16-B loads, dense_slot, the row to all n replicas by 16-B
// stores, the accumulators zeroed), and two parts of it alone: dense_move
// (the owner's row to the n replicas and the zeroing, no fold) and
// dense_fold (the fold, written back to the owner's row only).
#include <cuda_runtime.h>
#include <stdint.h>

#include "global_mesh.cuh"
#include "sorted_tick.cuh"

namespace prev {

using namespace gt;

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


}  // namespace prev

namespace {

using namespace gt;
using namespace prev;

__device__ __forceinline__ uint64_t gtimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Per-block record of the probe (REC words a block).
constexpr int REC = 16;
enum {
  K_START = 0, K_END = 1, K_CSTART = 2, K_CEND = 3, K_KIND = 4, K_WORK = 5,
  K_HEADS = 6, K_THREAD_MAX = 7, K_SEARCH = 8, K_BAD = 9, K_HEAD = 10,
  K_ELIG = 11, K_FOLD = 12, K_CHAIN = 13, K_PIECES = 14, K_SMID = 15
};

template <bool PROBE>
__device__ __forceinline__ void long_block_p(
    int64_t* table, const TileGeom& g, const int32_t* m32, int64_t ld_m,
    int32_t* resp, int64_t ld_r, int64_t lanes, int64_t now, int64_t k,
    int32_t* tile_max, int64_t* rounds, LongSmem& S, uint64_t* rec) {
  const int t = threadIdx.x;
  long long c0 = clock64(), c1;
  if (t == 0) S.head = -1;
  __syncthreads();
  const int64_t mine = long_head_tt(g, m32, ld_m, lanes, k, t, TT_THREADS);
  if (mine >= 0) S.head = mine;
  __syncthreads();
  const int64_t h = S.head;
  if (h < 0) {
    if (PROBE && t == 0) rec[K_KIND] = 2;
    return;
  }
  const Extent e = extent_at(g, h);
  const int32_t slot = slot_at(m32, ld_m, h);
  int64_t* rp = table + shard_row(g, e.shard, slot) * ROW_W;
  if (t == 0) S.end = e.z;
  __syncthreads();
  for (int64_t x = h + 1 + t;; x += TT_THREADS) {
    const bool stop = x >= e.z || slot_at(m32, ld_m, x) != slot;
    if (stop && x < e.z) atomicMin((unsigned long long*)&S.end,
                                   (unsigned long long)x);
    if (__syncthreads_or(stop)) break;
  }
  const int64_t end = S.end;
  if (PROBE && t == 0) {
    c1 = clock64();
    rec[K_KIND] = 1;
    rec[K_WORK] = (uint64_t)(end - h);
    rec[K_SEARCH] += (uint64_t)(c1 - c0);
    c0 = c1;
  }
  int64_t s[ROW_W];
  bool loaded = false;
  for (int64_t p = h; p < end;) {
    const int64_t ce = chunk_end(g, e, p);
    const int64_t q = ce < end ? ce : end;
    const int64_t id = chunk_id(g, e, p);
    if (PROBE && t == 0) rec[K_PIECES] += 1;
    if (t == 0) S.bad = 0;
    __syncthreads();
    for (int64_t x = p + t; x < q; x += TT_THREADS) {
      if (m32[R_VALID * ld_m + x] == 0) S.bad = 1;
    }
    __syncthreads();
    if (PROBE && t == 0) {
      c1 = clock64();
      rec[K_BAD] += (uint64_t)(c1 - c0);
      c0 = c1;
    }
    if (S.bad) {
      if (t == 0) {
        note_rounds(tile_max, rounds, id,
                    piece_serial(m32, ld_m, p, q, now, rp, s, loaded, resp,
                                 ld_r));
      }
      __syncthreads();
      p = q;
      continue;
    }
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
    if (PROBE && t == 0) {
      c1 = clock64();
      rec[K_HEAD] += (uint64_t)(c1 - c0);
      c0 = c1;
    }
    bool ok = lane_mergeable(hr, hr, true);
    for (int64_t x = p + 1 + t; x < q; x += TT_THREADS) {
      ok = ok && lane_mergeable(load_req(m32, ld_m, x), hr, false);
    }
    const bool elig = __syncthreads_and(ok) != 0;
    if (PROBE && t == 0) {
      c1 = clock64();
      rec[K_ELIG] += (uint64_t)(c1 - c0);
      c0 = c1;
    }
    const int64_t n = q - p;
    if (n > 1) {
      const bool proven = proven_alive(hr, now);
      const FoldHead f = S.fold;
      const bool alive = now <= f.E;
      if (elig && (alive || proven)) {
        for (int64_t x = p + 1 + t; x < q; x += TT_THREADS) {
          store_resp(resp, ld_r, x,
                     alive ? fold_answer(hr, f, x - p) : Resp{}, alive);
        }
        if (t == 0) {
          if (alive) fold_row(hr, f, n - 1, s);
          note_rounds(tile_max, rounds, id, proven ? 0 : n - 1);
        }
        if (PROBE) {
          __syncthreads();
          if (t == 0) {
            c1 = clock64();
            rec[K_FOLD] += (uint64_t)(c1 - c0);
            c0 = c1;
          }
        }
      } else {
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
        if (PROBE && t == 0) {
          c1 = clock64();
          rec[K_CHAIN] += (uint64_t)(c1 - c0);
          c0 = c1;
        }
      }
    }
    __syncthreads();
    p = q;
  }
  if (t == 0 && loaded) store_ticked_row(rp, s);
}

template <bool PROBE>
__global__ void __launch_bounds__(TT_THREADS)
    prev_kernel(int64_t* __restrict__ table, TileGeom g,
                const int32_t* __restrict__ m32, int64_t ld_m,
                int32_t* __restrict__ resp, int64_t ld_r, int64_t lanes,
                int64_t now, int64_t n_long, int32_t* __restrict__ tile_max,
                int64_t* __restrict__ rounds, uint64_t* __restrict__ recs) {
  __shared__ LongSmem S;
  __shared__ unsigned long long tmax, theads, trun;
  uint64_t* rec = PROBE ? recs + (int64_t)blockIdx.x * REC : nullptr;
  if (PROBE && threadIdx.x == 0) {
    rec[K_START] = gtimer();
    rec[K_CSTART] = (uint64_t)clock64();
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    rec[K_SMID] = smid;
    tmax = 0;
    theads = 0;
    trun = 0;
  }
  if (PROBE) __syncthreads();
  if ((int64_t)blockIdx.x < n_long) {
    long_block_p<PROBE>(table, g, m32, ld_m, resp, ld_r, lanes, now,
                        blockIdx.x, tile_max, rounds, S, rec);
  } else {
    const int64_t j =
        ((int64_t)blockIdx.x - n_long) * TT_THREADS + threadIdx.x;
    const long long c0 = clock64();
    if (j < lanes) {
      lane_step(table, g, m32, ld_m, resp, ld_r, now, j, tile_max, rounds);
    }
    if (PROBE) {
      const unsigned long long c = (unsigned long long)(clock64() - c0);
      atomicMax(&tmax, c);
      if (j < lanes && in_extents(g, j)) {
        const Extent e = extent_at(g, j);
        if (shard_row(g, e.shard, slot_at(m32, ld_m, j)) >= 0 &&
            run_head(m32, ld_m, e, j) && !long_run(m32, ld_m, e, j)) {
          int64_t end = j + 1;
          while (end < e.z && slot_at(m32, ld_m, end) == slot_at(m32, ld_m, j))
            ++end;
          atomicAdd(&theads, 1ull);
          atomicMax(&trun, (unsigned long long)(end - j));
        }
      }
      if (threadIdx.x == 0) rec[K_KIND] = 0;
    }
  }
  if (PROBE) {
    __syncthreads();
    if (threadIdx.x == 0) {
      rec[K_CEND] = (uint64_t)clock64();
      rec[K_END] = gtimer();
      if ((int64_t)blockIdx.x >= n_long) {
        rec[K_THREAD_MAX] = tmax;
        rec[K_HEADS] = theads;
        rec[K_WORK] = trun;
      }
    }
  }
}

// ---- B.8b's earlier kernel and its two parts ----

constexpr int kThreads = 256;

__device__ __forceinline__ void row_in(const int64_t* table, int64_t r,
                                       int64_t* row) {
  const longlong2* src =
      reinterpret_cast<const longlong2*>(table + r * ROW_W);
#pragma unroll
  for (int v = 0; v < ROW_W / 2; ++v) {
    longlong2 x = src[v];
    row[2 * v] = x.x;
    row[2 * v + 1] = x.y;
  }
}

__device__ __forceinline__ void row_out(int64_t* table, int64_t r,
                                        const int64_t* row) {
  longlong2* dst = reinterpret_cast<longlong2*>(table + r * ROW_W);
#pragma unroll
  for (int v = 0; v < ROW_W / 2; ++v) {
    dst[v] = make_longlong2(row[2 * v], row[2 * v + 1]);
  }
}

// mode 0: the whole step; 1: the move alone; 2: the fold alone.
template <int MODE>
__global__ void dense_prev(int64_t* __restrict__ table,
                           const int64_t* __restrict__ aux,
                           int64_t* __restrict__ acc, gm::Mesh m, int64_t now,
                           int strict) {
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= m.capacity) return;
  int64_t row[ROW_W];
  const int64_t own = gm::owner_of(m, s) * m.capacity + s;
  row_in(table, own, row);
  if (MODE != 1) gm::dense_slot(m, aux, acc, s, now, strict != 0, row);
  if (MODE == 2) {
    row_out(table, own, row);
    return;
  }
  for (int64_t d = 0; d < m.n_nodes; ++d) {
    row_out(table, d * m.capacity + s, row);
#pragma unroll
    for (int k = 0; k < gm::ACC_ROWS; ++k) acc[gm::acc_ix(m, d, k, s)] = 0;
  }
}

}  // namespace

extern "C" int prev_tick(int64_t* table, int64_t n_shards,
                         int64_t local_capacity, const int32_t* offsets,
                         const int32_t* m32, int64_t ld_m, int32_t* resp,
                         int64_t ld_r, int64_t lanes, int64_t tile,
                         int64_t now, int32_t* tile_max, int64_t* rounds,
                         uint64_t* recs, void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t max_tiles = (lanes + tile - 1) / tile;
  cudaError_t e = cudaMemsetAsync(
      tile_max, 0, (size_t)(n_shards * max_tiles) * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  const TileGeom g{offsets, n_shards, local_capacity, tile, max_tiles};
  const int64_t n_long = long_blocks_tt(lanes);
  const int64_t blocks = n_long + (lanes + TT_THREADS - 1) / TT_THREADS;
  if (recs) {
    e = cudaMemsetAsync(recs, 0, (size_t)blocks * REC * 8, st);
    if (e != cudaSuccess) return (int)e;
    prev_kernel<true><<<(unsigned)blocks, TT_THREADS, 0, st>>>(
        table, g, m32, ld_m, resp, ld_r, lanes, now, n_long, tile_max, rounds,
        recs);
  } else {
    prev_kernel<false><<<(unsigned)blocks, TT_THREADS, 0, st>>>(
        table, g, m32, ld_m, resp, ld_r, lanes, now, n_long, tile_max, rounds,
        nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int64_t prev_tick_blocks(int64_t lanes) {
  return prev::long_blocks_tt(lanes) +
         (lanes + prev::TT_THREADS - 1) / prev::TT_THREADS;
}

extern "C" int prev_dense(int64_t* table, const int64_t* aux, int64_t* acc,
                          int64_t n_nodes, int64_t capacity, int64_t now,
                          int strict, int mode, void* stream) {
  const gm::Mesh m{n_nodes, capacity, capacity / n_nodes};
  const unsigned blocks = (unsigned)((capacity + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    dense_prev<0><<<blocks, kThreads, 0, st>>>(table, aux, acc, m, now, strict);
  } else if (mode == 1) {
    dense_prev<1><<<blocks, kThreads, 0, st>>>(table, aux, acc, m, now, strict);
  } else {
    dense_prev<2><<<blocks, kThreads, 0, st>>>(table, aux, acc, m, now, strict);
  }
  return (int)cudaGetLastError();
}
