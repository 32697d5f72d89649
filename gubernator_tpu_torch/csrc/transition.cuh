// Per-lane bucket transition for the fused tick kernel.
//
// A scalar C++ port of gubernator_tpu/ops/buckets.py bucket_transition
// (token and leaky bucket, the reference's exact precedence and quirks)
// plus the algorithm zoo (gubernator_tpu/algos: sliding window, GCRA,
// concurrency), run in int64_t/double registers.  It is NOT a port of the
// TPU kernel's transition32: the int32 (lo, hi) pairs, the triple-float32
// remaining and the one-hot MXU transposes exist only because Mosaic has
// no 64-bit types, and Hopper has them.  The plain PyTorch version of the
// same function is gubernator_tpu_torch/ops/transition.py; the two must
// agree bit for bit, so:
//
// * int64 add/sub/mul go through uint64_t (two's-complement wrap, as XLA
//   and torch give; signed overflow is undefined in C++);
// * float64 -> int64 is trunc_i64: toward zero, saturating, NaN -> 0 (what
//   XLA gives the reference);
// * `//` and `%` are floor operations (jnp and torch semantics), used only
//   on the clamped a >= 0, b > 0 domain by the zoo formulas;
// * float64 operations are the same sequence of correctly rounded IEEE
//   operations, built with --fmad=false (no fused multiply-add).
//
// The transition is split in two (prepare, apply; see below): the terms
// that depend on the request alone, and the rest, which reads the stored
// row.  transition_class composes them for the tile ticks; the chained
// tick prepares a segment's lanes in parallel ahead of its chain.
//
// The header compiles as CUDA (the kernels) and as host C++ (the test-only
// host build in fused_tick_host.cc, which the CPU tests hold against the
// plain version).  merged_fold below is the duplicate fold of the merged
// tick kernel (fused_merged_tick.cu); its plain version is
// ops/transition.py merged_fold.  ragged_row is the ragged tick's lane
// placement (fused_ragged_tick.cu); its plain version is
// ops/raggedtick.py fused_ragged_tick_plain.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define GT_HD __host__ __device__ __forceinline__
#else
#define GT_HD inline
#endif

namespace gt {

// Row layout (ops/buckets.py): 16 int64 words a slot.
constexpr int ROW_W = 16;
constexpr int W_ALGORITHM = 0, W_LIMIT = 1, W_REMAINING = 2,
              W_REMAINING_F = 3, W_DURATION = 4, W_CREATED_AT = 5,
              W_UPDATED_AT = 6, W_BURST = 7, W_STATUS = 8, W_EXPIRE_AT = 9,
              W_IN_USE = 10, W_TAT = 11, W_PREV_COUNT = 12;

// REQ32 request matrix rows (ops/engine.py REQ32_INDEX): narrow fields one
// int32 row each, wide fields a (lo, hi) pair of rows.
constexpr int R_SLOT = 0, R_KNOWN = 1, R_ALGORITHM = 2, R_BEHAVIOR = 3,
              R_VALID = 4, R_HITS = 5, R_LIMIT = 7, R_DURATION = 9,
              R_CREATED_AT = 11, R_BURST = 13, R_GREG_EXP = 15,
              R_GREG_DUR = 17;
constexpr int REQ32_ROWS = 19;
constexpr int RESP_ROWS = 6;

constexpr int32_t RESET_REMAINING = 8, DRAIN_OVER_LIMIT = 32,
                  DURATION_IS_GREGORIAN = 4;
constexpr int64_t UNDER = 0, OVER = 1;
constexpr int64_t TOKEN = 0, LEAKY = 1, SLIDING = 2, GCRA = 3, CONC = 4;
constexpr int64_t I64_MAX = 0x7fffffffffffffffLL;
constexpr int64_t I64_MIN = -I64_MAX - 1;

GT_HD int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
GT_HD int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
GT_HD int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
GT_HD int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
GT_HD int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Floor division and modulo for b > 0 (every caller guarantees it).  When
// both operands lie in [0, 2^32) floor and truncation agree and unsigned
// 32-bit division gives the same quotient and remainder, in a few
// instructions on the card instead of the long 64-bit routine.
GT_HD bool fits_u32(int64_t a, int64_t b) {
  return (((uint64_t)a | (uint64_t)b) >> 32) == 0;
}
GT_HD int64_t floor_div(int64_t a, int64_t b) {
  if (fits_u32(a, b)) return (int64_t)((uint32_t)a / (uint32_t)b);
  int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
GT_HD int64_t floor_mod(int64_t a, int64_t b) {
  if (fits_u32(a, b)) return (int64_t)((uint32_t)a % (uint32_t)b);
  int64_t m = a % b;
  return (m != 0 && m < 0) ? m + b : m;
}

GT_HD int64_t trunc_i64(double x) {
#if defined(__CUDA_ARCH__)
  // The guards as selects beside the conversion, not branches: a leaky
  // lane's chain runs five of these.  The conversion alone differs from
  // the reference at an edge (tests/test_torch_cuda.py
  // test_float_to_int_edges_match_plain).
  const int64_t v = __double2ll_rz(x);
  return x != x                        ? 0
       : x >= 9223372036854775808.0    ? I64_MAX
       : x < -9223372036854775808.0    ? I64_MIN
                                       : v;
#else
  if (x != x) return 0;
  if (x >= 9223372036854775808.0) return I64_MAX;
  if (x < -9223372036854775808.0) return I64_MIN;
  return (int64_t)x;
#endif
}

GT_HD double bits_to_f64(int64_t w) {
#if defined(__CUDA_ARCH__)
  return __longlong_as_double(w);
#else
  double d;
  __builtin_memcpy(&d, &w, 8);
  return d;
#endif
}
GT_HD int64_t f64_to_bits(double d) {
#if defined(__CUDA_ARCH__)
  return __double_as_longlong(d);
#else
  int64_t w;
  __builtin_memcpy(&w, &d, 8);
  return w;
#endif
}

struct Req {
  int64_t slot, hits, limit, duration, created_at, burst, greg_exp, greg_dur;
  int32_t known, algorithm, behavior, valid;
};

struct Resp {
  int64_t status, remaining, reset_time, over_limit;
};

// Lane classes: one per transition path, picked by the request's
// algorithm the way the reference dispatches it (unknown values resolve to
// the sliding window, negative ones to the leaky bucket).  The tile
// kernels (tile.cuh) sort a tile's lanes by class so that a warp runs one
// path; INERT lanes (padding, invalid or out-of-range slots) touch no row.
constexpr int C_TOKEN = 0, C_LEAKY = 1, C_SLIDING = 2, C_GCRA = 3,
              C_CONC = 4, C_INERT = 5, N_CLASSES = 6;

GT_HD int algo_class(int32_t algorithm) {
  return algorithm == TOKEN ? C_TOKEN
       : algorithm < SLIDING ? C_LEAKY
       : algorithm == GCRA ? C_GCRA
       : algorithm == CONC ? C_CONC
       : C_SLIDING;
}

// ---- the transition, split in two ----
//
// prepare() computes what a lane's transition takes from its request
// alone; apply() the rest, which reads the stored row, and rewrites the
// row in place (only the words its path changes; words 13-15 are the
// caller's).  transition_class() below is the two run back to back, so
// every kernel runs the same expressions: those of the reference's
// bucket_transition and the zoo, in their order, the request-only ones
// hoisted.  The chained tick (sorted_tick.cuh) prepares a run of lanes in
// parallel and leaves only apply() on a segment's chain.

// Request-only terms of each path (comments name the reference's values).
struct TokenTerms {
  int64_t greg_exp;
  int64_t created_dur;  // created_at + duration: a renewed expiry
  int64_t new_expire;   // tn_expire: a new item's expiry
  int64_t new_rem;      // tn_rem
};
struct LeakyTerms {
  double burst_f, rate_div, h_f;  // burst, rate (1.0 for 0.0), hits
  double new_remf;                // ln_remf
  int64_t rate_i;                 // trunc(rate)
  int64_t duration_eff;           // the stored duration (Gregorian aware)
  int64_t expire;                 // created_at + duration_eff
  int64_t new_rem, new_reset;     // ln_resp_rem and its reset time
};
struct SlidingTerms {
  int64_t t, dur, aligned;  // max(created, 0), max(duration, 1), window
  int64_t expire;           // t + 2 * dur
};
struct GcraTerms {
  int64_t T, burst_eff, tau, hm1T, hT, horizon;  // (h - 1) T, h T, t + tau
  int64_t T_div;   // max(T, 1)
  int64_t expire;  // t + duration
};
struct ConcTerms {
  int64_t expire;  // t + duration
};

struct Prep {
  // The request's own fields that apply() reads; a leaky lane's burst is
  // its effective burst (the limit for 0).
  int64_t hits, limit, duration, created_at, burst;
  int32_t algorithm;
  int8_t cls;
  bool reset_b, drain_b, greg_b, known, new_over;
  union {
    TokenTerms tok;
    LeakyTerms leaky;
    SlidingTerms sw;
    GcraTerms gcra;
    ConcTerms conc;
  } u;
};

// The request-only half, per class: the fields every path reads, then
// each path's terms.
GT_HD Prep prepare_fields(int cls, const Req& r) {
  Prep p;
  p.cls = (int8_t)cls;
  p.algorithm = r.algorithm;
  p.hits = r.hits;
  p.limit = r.limit;
  p.duration = r.duration;
  p.created_at = r.created_at;
  p.burst = r.burst;
  p.reset_b = (r.behavior & RESET_REMAINING) != 0;
  p.drain_b = (r.behavior & DRAIN_OVER_LIMIT) != 0;
  p.greg_b = (r.behavior & DURATION_IS_GREGORIAN) != 0;
  p.known = r.known != 0;
  p.new_over = false;
  return p;
}

GT_HD void token_prepare(const Req& r, Prep& p) {
  TokenTerms& k = p.u.tok;
  const int64_t h = r.hits, limit = r.limit;
  k.greg_exp = r.greg_exp;
  k.created_dur = wadd(r.created_at, r.duration);
  k.new_expire = p.greg_b ? r.greg_exp : wadd(r.created_at, r.duration);
  p.new_over = h > limit;
  k.new_rem = p.new_over ? limit : wsub(limit, h);
}

GT_HD void leaky_prepare(int64_t now, const Req& r, Prep& p) {
  LeakyTerms& k = p.u.leaky;
  const int64_t h = r.hits, limit = r.limit, r_dur = r.duration;
  double safe_limit_f = (double)(limit == 0 ? 1 : limit);
  int64_t burst = r.burst == 0 ? limit : r.burst;
  p.burst = burst;
  k.burst_f = (double)burst;
  double rate = (double)(p.greg_b ? r.greg_dur : r_dur) / safe_limit_f;
  k.rate_div = rate == 0.0 ? 1.0 : rate;
  k.duration_eff = p.greg_b ? wsub(r.greg_exp, now) : r_dur;
  k.expire = wadd(r.created_at, k.duration_eff);
  k.rate_i = trunc_i64(rate);
  k.h_f = (double)h;
  int64_t ln_rate_i = trunc_i64((double)r_dur / safe_limit_f);
  p.new_over = h > burst;
  k.new_remf = p.new_over ? 0.0 : (double)wsub(burst, h);
  k.new_rem = p.new_over ? 0 : wsub(burst, h);
  k.new_reset =
      wadd(r.created_at, wmul(wsub(limit, k.new_rem), ln_rate_i));
}

GT_HD void gcra_prepare(const Req& r, Prep& p) {
  GcraTerms& k = p.u.gcra;
  const int64_t limit = r.limit;
  int64_t safe_limit = limit <= 0 ? 1 : limit;
  k.T = floor_div(imax(r.duration, 0), safe_limit);
  k.burst_eff = r.burst > 0 ? r.burst : limit;
  k.tau = wmul(wsub(k.burst_eff, 1), k.T);
  k.hm1T = wmul(wsub(r.hits, 1), k.T);
  k.hT = wmul(r.hits, k.T);
  k.horizon = wadd(r.created_at, k.tau);
  k.T_div = imax(k.T, 1);
  k.expire = wadd(r.created_at, r.duration);
}

GT_HD void conc_prepare(const Req& r, Prep& p) {
  p.u.conc.expire = wadd(r.created_at, r.duration);
}

GT_HD void sliding_prepare(const Req& r, Prep& p) {
  SlidingTerms& k = p.u.sw;
  k.t = imax(r.created_at, 0);
  k.dur = imax(r.duration, 1);
  k.aligned = wsub(k.t, floor_mod(k.t, k.dur));
  k.expire = wadd(k.t, wadd(k.dur, k.dur));
}

// The request-only half of the transition of a lane of class `cls`
// (== algo_class(r.algorithm)).
GT_HD Prep prepare(int cls, int64_t now, const Req& r) {
  Prep p = prepare_fields(cls, r);
  if (cls == C_TOKEN) {
    token_prepare(r, p);
  } else if (cls == C_LEAKY) {
    leaky_prepare(now, r, p);
  } else if (cls == C_GCRA) {
    gcra_prepare(r, p);
  } else if (cls == C_CONC) {
    conc_prepare(r, p);
  } else {
    sliding_prepare(r, p);
  }
  return p;
}

// Prepared terms in memory (a kernel's shared memory): PREP_W words a
// lane, word k of lane x at k * n + x, so that the threads of a warp
// touch neighbouring words.
constexpr int PREP_W = (int)(sizeof(Prep) / 8);
static_assert(sizeof(Prep) % 8 == 0, "a Prep is whole words");

GT_HD void put_prep(int64_t* cols, int n, int x, const Prep& p) {
  int64_t w[PREP_W];
  memcpy(w, &p, sizeof(Prep));
  for (int k = 0; k < PREP_W; ++k) cols[k * n + x] = w[k];
}

GT_HD Prep get_prep(const int64_t* cols, int n, int x) {
  int64_t w[PREP_W];
  for (int k = 0; k < PREP_W; ++k) w[k] = cols[k * n + x];
  Prep p;
  memcpy(&p, w, sizeof(Prep));
  return p;
}

// Zoo result: the state words a zoo transition decides, and its response.
struct Zoo {
  int64_t remaining, created_at, status, expire_at, tat, prev_count;
  Resp resp;
};

GT_HD Zoo sliding_window(const int64_t* s, const Prep& p, bool exists) {
  const SlidingTerms& k = p.u.sw;
  bool ex = exists && !p.reset_b && s[W_ALGORITHM] == SLIDING;
  int64_t t = k.t, dur = k.dur;
  int64_t ws0 = ex ? s[W_CREATED_AT] : k.aligned;
  int64_t cur0 = ex ? imax(s[W_REMAINING], 0) : 0;
  int64_t prev0 = ex ? imax(s[W_PREV_COUNT], 0) : 0;
  int64_t delta = imax(wsub(t, ws0), 0);
  int64_t kw = floor_div(delta, dur);
  int64_t prev1 = kw == 0 ? prev0 : (kw == 1 ? cur0 : 0);
  int64_t cur1 = kw == 0 ? cur0 : 0;
  int64_t ws1 = kw == 0 ? ws0 : k.aligned;
  int64_t frac = imin(imax(wsub(dur, wsub(t, ws1)), 0), dur);
  int64_t wprev = floor_div(wmul(prev1, frac), dur);
  int64_t used = wadd(wprev, cur1);
  int64_t avail = imax(wsub(p.limit, used), 0);
  int64_t h = p.hits;
  bool h_pos = h > 0, h_neg = h < 0, h_query = h == 0;
  bool fits = h <= avail;
  bool admit = h_pos && fits, over = h_pos && !fits;
  int64_t cur2 = admit ? wadd(cur1, h)
               : (over && p.drain_b) ? wadd(cur1, avail)
               : h_neg ? imax(wadd(cur1, h), 0)
               : cur1;
  Zoo z;
  z.remaining = cur2;
  z.created_at = ws1;
  z.status = (over || (h_query && avail == 0)) ? OVER : UNDER;
  z.expire_at = (!h_query || !ex) ? k.expire : s[W_EXPIRE_AT];
  z.tat = 0;
  z.prev_count = prev1;
  z.resp.status = z.status;
  z.resp.remaining = imax(wsub(p.limit, wadd(wprev, cur2)), 0);
  z.resp.reset_time = wadd(ws1, dur);
  z.resp.over_limit = over;
  return z;
}

GT_HD Zoo gcra(const int64_t* s, const Prep& p, bool exists) {
  const GcraTerms& k = p.u.gcra;
  bool ex = exists && !p.reset_b && s[W_ALGORITHM] == GCRA;
  int64_t t = p.created_at;
  int64_t T = k.T, burst_eff = k.burst_eff;
  int64_t tat0 = ex ? s[W_TAT] : t;
  int64_t tat1 = imax(tat0, t);
  int64_t h = p.hits;
  bool h_pos = h > 0, h_neg = h < 0, h_query = h == 0;
  int64_t need = wadd(tat1, k.hm1T);
  bool conform = need <= k.horizon;
  bool admit = h_pos && conform, over = h_pos && !conform;
  int64_t stepped = wadd(tat1, k.hT);
  int64_t tat2 = admit ? stepped : (h_neg ? imax(stepped, t) : tat1);
  int64_t slack = wsub(k.horizon, tat2);
  int64_t rem_div = wadd(floor_div(imax(slack, 0), k.T_div), 1);
  int64_t rem = slack < 0 ? 0 : (T == 0 ? burst_eff : imin(rem_div, burst_eff));
  rem = imax(rem, 0);
  Zoo z;
  z.remaining = rem;
  z.created_at = ex ? s[W_CREATED_AT] : t;
  z.status = (over || (h_query && rem == 0)) ? OVER : UNDER;
  z.expire_at = (!h_query || !ex) ? imax(k.expire, tat2) : s[W_EXPIRE_AT];
  z.tat = tat2;
  z.prev_count = 0;
  z.resp.status = z.status;
  z.resp.remaining = rem;
  z.resp.reset_time = imax(wsub(tat2, k.tau), t);
  z.resp.over_limit = over;
  return z;
}

GT_HD Zoo concurrency(const int64_t* s, const Prep& p, bool exists) {
  bool ex = exists && !p.reset_b && s[W_ALGORITHM] == CONC;
  int64_t t = p.created_at;
  int64_t rebased = wadd(s[W_REMAINING], wsub(p.limit, s[W_LIMIT]));
  int64_t rem0 = imax(ex ? rebased : p.limit, 0);
  int64_t h = p.hits;
  bool h_pos = h > 0, h_neg = h < 0, h_query = h == 0;
  bool fits = h <= rem0;
  bool admit = h_pos && fits, over = h_pos && !fits;
  int64_t rem1 = admit ? wsub(rem0, h)
               : h_neg ? imax(imin(wsub(rem0, h), p.limit), 0)
               : rem0;
  Zoo z;
  z.remaining = rem1;
  z.created_at = ex ? s[W_CREATED_AT] : t;
  z.status = (over || (h_query && rem1 == 0)) ? OVER : UNDER;
  z.expire_at = (!h_query || !ex) ? p.u.conc.expire : s[W_EXPIRE_AT];
  z.tat = 0;
  z.prev_count = 0;
  z.resp.status = z.status;
  z.resp.remaining = rem1;
  z.resp.reset_time = z.expire_at;
  z.resp.over_limit = over;
  return z;
}

// ---- token bucket (algorithms.go:37-257) ----
// Every apply step reads the row before it writes any word of it.
GT_HD Resp token_apply(const Prep& p, bool exists, int64_t* s) {
  const TokenTerms& k = p.u.tok;
  bool algo_match = s[W_ALGORITHM] == (int64_t)p.algorithm;
  int64_t h = p.hits, limit = p.limit, r_dur = p.duration,
          r_created = p.created_at;
  bool tok_reset = exists && p.reset_b;
  bool tok_exist = exists && !p.reset_b && algo_match;
  Resp resp;
  if (tok_reset) {
    // RESET_REMAINING on an existing item removes it (:78-90).
    double s_remf = bits_to_f64(s[W_REMAINING_F]);
    s[W_REMAINING] = 0;
    s[W_REMAINING_F] = f64_to_bits(s_remf * 0.0);
    s[W_DURATION] = 0;
    s[W_CREATED_AT] = 0;
    s[W_UPDATED_AT] = 0;
    s[W_BURST] = 0;
    s[W_STATUS] = 0;
    s[W_EXPIRE_AT] = 0;
    s[W_IN_USE] = 0;
    resp.status = UNDER;
    resp.remaining = limit;
    resp.reset_time = 0;
    resp.over_limit = 0;
  } else if (tok_exist) {
    int64_t t_rem0 = s[W_LIMIT] != limit
        ? imax(wadd(s[W_REMAINING], wsub(limit, s[W_LIMIT])), 0)
        : s[W_REMAINING];
    int64_t rl_status = s[W_STATUS];
    int64_t rl_rem_base = t_rem0;
    bool dur_changed = s[W_DURATION] != r_dur;
    int64_t expire_cand =
        p.greg_b ? k.greg_exp : wadd(s[W_CREATED_AT], r_dur);
    bool renew = expire_cand <= r_created;
    int64_t expire_new = renew ? k.created_dur : expire_cand;
    int64_t t_created = (dur_changed && renew) ? r_created : s[W_CREATED_AT];
    int64_t t_rem1 = (dur_changed && renew) ? limit : t_rem0;
    int64_t t_expire = dur_changed ? expire_new : s[W_EXPIRE_AT];
    bool t_query = h == 0;
    bool t_at_zero = !t_query && rl_rem_base == 0 && h > 0;
    bool t_exact = !t_query && !t_at_zero && t_rem1 == h;
    bool t_over = !t_query && !t_at_zero && !t_exact && h > t_rem1;
    bool t_dec = !t_query && !t_at_zero && !t_exact && !t_over;
    s[W_REMAINING] = t_exact ? 0
                   : t_over ? (p.drain_b ? 0 : t_rem1)
                   : t_dec ? wsub(t_rem1, h) : t_rem1;
    s[W_DURATION] = r_dur;
    s[W_CREATED_AT] = t_created;
    s[W_STATUS] = t_at_zero ? OVER : rl_status;
    s[W_EXPIRE_AT] = t_expire;
    s[W_IN_USE] = 1;
    resp.status = (t_at_zero || t_over) ? OVER : rl_status;
    resp.remaining = t_exact ? 0
                   : t_over ? (p.drain_b ? 0 : rl_rem_base)
                   : t_dec ? wsub(t_rem1, h) : rl_rem_base;
    resp.reset_time = t_expire;
    resp.over_limit = t_at_zero || t_over;
  } else {
    s[W_REMAINING] = k.new_rem;
    s[W_DURATION] = r_dur;
    s[W_CREATED_AT] = r_created;
    s[W_STATUS] = UNDER;
    s[W_EXPIRE_AT] = k.new_expire;
    s[W_IN_USE] = 1;
    resp.status = p.new_over ? OVER : UNDER;
    resp.remaining = k.new_rem;
    resp.reset_time = k.new_expire;
    resp.over_limit = p.new_over;
  }
  s[W_ALGORITHM] = TOKEN;
  s[W_LIMIT] = limit;
  s[W_TAT] = 0;
  s[W_PREV_COUNT] = 0;
  return resp;
}

// ---- leaky bucket (algorithms.go:260-493) ----
GT_HD Resp leaky_apply(const Prep& p, bool exists, int64_t* s) {
  const LeakyTerms& k = p.u.leaky;
  bool algo_match = s[W_ALGORITHM] == (int64_t)p.algorithm;
  int64_t h = p.hits, limit = p.limit, burst = p.burst,
          r_created = p.created_at;
  bool leak_exist = exists && algo_match;
  Resp resp;
  if (leak_exist) {
    double s_remf = bits_to_f64(s[W_REMAINING_F]);
    double burst_f = k.burst_f;
    double b_rem0 = p.reset_b ? burst_f : s_remf;
    bool burst_changed = s[W_BURST] != burst;
    double b_rem1 =
        (burst_changed && burst > trunc_i64(b_rem0)) ? burst_f : b_rem0;
    int64_t elapsed = wsub(r_created, s[W_UPDATED_AT]);
    // No elapsed time leaks nothing: 0 / rate is a zero of either sign
    // (rate_div is finite and never 0), which truncates to 0.
    double leak = 0.0;
    bool leaked = false;
    if (elapsed != 0) {
      leak = (double)elapsed / k.rate_div;
      leaked = trunc_i64(leak) > 0;
    }
    double b_rem2 = leaked ? b_rem1 + leak : b_rem1;
    int64_t b_upd = leaked ? r_created : s[W_UPDATED_AT];
    double b_rem3 = trunc_i64(b_rem2) > burst ? burst_f : b_rem2;
    int64_t rem_i = trunc_i64(b_rem3);
    double h_f = k.h_f;
    bool l_at_zero = rem_i == 0 && h > 0;
    bool l_exact = !l_at_zero && rem_i == h;
    bool l_over = !l_at_zero && !l_exact && h > rem_i;
    bool l_query = !l_at_zero && !l_exact && !l_over && h == 0;
    bool l_dec = !l_at_zero && !l_exact && !l_over && !l_query;
    double le_remf = l_exact ? 0.0
                   : l_over ? (p.drain_b ? 0.0 : b_rem3)
                   : l_dec ? b_rem3 - h_f : b_rem3;
    int64_t le_resp_rem = l_exact ? 0
                        : l_over ? (p.drain_b ? 0 : rem_i)
                        : l_dec ? trunc_i64(b_rem3 - h_f) : rem_i;
    int64_t le_reset_rem = l_over ? rem_i : le_resp_rem;
    int64_t expire = h != 0 ? k.expire : s[W_EXPIRE_AT];
    s[W_REMAINING_F] = f64_to_bits(le_remf);
    s[W_DURATION] = p.duration;
    s[W_UPDATED_AT] = b_upd;
    s[W_EXPIRE_AT] = expire;
    resp.status = (l_at_zero || l_over) ? OVER : UNDER;
    resp.remaining = le_resp_rem;
    resp.reset_time =
        wadd(r_created, wmul(wsub(limit, le_reset_rem), k.rate_i));
    resp.over_limit = l_at_zero || l_over;
  } else {
    s[W_REMAINING_F] = f64_to_bits(k.new_remf);
    s[W_DURATION] = k.duration_eff;
    s[W_UPDATED_AT] = r_created;
    s[W_STATUS] = UNDER;
    s[W_EXPIRE_AT] = k.expire;
    resp.status = p.new_over ? OVER : UNDER;
    resp.remaining = k.new_rem;
    resp.reset_time = k.new_reset;
    resp.over_limit = p.new_over;
  }
  s[W_ALGORITHM] = LEAKY;
  s[W_LIMIT] = limit;
  s[W_BURST] = burst;
  s[W_IN_USE] = 1;
  s[W_TAT] = 0;
  s[W_PREV_COUNT] = 0;
  return resp;
}

// ---- algorithm zoo: the row a zoo transition stores ----
GT_HD Resp zoo_store(const Zoo& z, const Prep& p, int64_t* s) {
  s[W_ALGORITHM] = p.algorithm;
  s[W_LIMIT] = p.limit;
  s[W_REMAINING] = z.remaining;
  s[W_REMAINING_F] = 0;  // +0.0
  s[W_DURATION] = p.duration;
  s[W_CREATED_AT] = z.created_at;
  s[W_UPDATED_AT] = p.created_at;
  s[W_BURST] = p.burst;
  s[W_STATUS] = z.status;
  s[W_EXPIRE_AT] = z.expire_at;
  s[W_IN_USE] = 1;
  s[W_TAT] = z.tat;
  s[W_PREV_COUNT] = z.prev_count;
  return z.resp;
}

GT_HD Resp gcra_apply(const Prep& p, bool exists, int64_t* s) {
  return zoo_store(gcra(s, p, exists), p, s);
}
GT_HD Resp conc_apply(const Prep& p, bool exists, int64_t* s) {
  return zoo_store(concurrency(s, p, exists), p, s);
}
GT_HD Resp sliding_apply(const Prep& p, bool exists, int64_t* s) {
  return zoo_store(sliding_window(s, p, exists), p, s);
}

// Whether row `s` holds a live item the lane may use.
GT_HD bool row_exists(int64_t now, const Prep& p, const int64_t* s) {
  return p.known && s[W_IN_USE] != 0 && now <= s[W_EXPIRE_AT];
}

// The state-dependent half: one live lane's transition of row `s` (words
// 0-12, rewritten in place) with its prepared terms `p`.  (Tests of the
// class, not a switch: the card would index a jump table in constant
// memory on the chain.)
GT_HD Resp apply(int64_t now, const Prep& p, int64_t* s) {
  const bool exists = row_exists(now, p, s);
  if (p.cls == C_TOKEN) return token_apply(p, exists, s);
  if (p.cls == C_LEAKY) return leaky_apply(p, exists, s);
  if (p.cls == C_GCRA) return gcra_apply(p, exists, s);
  if (p.cls == C_CONC) return conc_apply(p, exists, s);
  return sliding_apply(p, exists, s);
}

// One live lane of class `cls` (== algo_class(r.algorithm)) on the row
// `s` (16 words), in place: words 0-12 as the transition leaves them,
// words 13-15 zero.  Each class's prepare and apply, dispatched once, so
// a path keeps only its own terms in registers.
GT_HD Resp transition_class(int cls, int64_t now, const Req& r, int64_t* s) {
  for (int w = W_PREV_COUNT + 1; w < ROW_W; ++w) s[w] = 0;
  Prep p = prepare_fields(cls, r);
  const bool exists = row_exists(now, p, s);
  if (cls == C_TOKEN) {
    token_prepare(r, p);
    return token_apply(p, exists, s);
  }
  if (cls == C_LEAKY) {
    leaky_prepare(now, r, p);
    return leaky_apply(p, exists, s);
  }
  if (cls == C_GCRA) {
    gcra_prepare(r, p);
    return gcra_apply(p, exists, s);
  }
  if (cls == C_CONC) {
    conc_prepare(r, p);
    return conc_apply(p, exists, s);
  }
  sliding_prepare(r, p);
  return sliding_apply(p, exists, s);
}

// ---- closed-form duplicate fold (kernel B.3) ----
//
// Port of gubernator_tpu/ops/transition32.py merged_fold32 (its result in
// native int64/float64, not its i32-pair and triple-float32 arithmetic):
// fold count - 1 followers identical to the head into the head's
// post-transition row.  The i <= q followers decrement, the rest are over
// the limit; token status flips to OVER on an at-zero step; leaky
// remaining_f zeroes exactly on an exact-remainder or drain step and keeps
// its fraction otherwise.  count == 1 is the identity.  Where merged_fold32
// and the x64 engine._merged_formulas differ, this follows merged_fold32
// (what the JAX engine runs for grouped and layered windows):
//   * leaky base is floor(remaining_f), not its truncation;
//   * q = max(base, 0) // h;
//   * rate_i is the exact integer floor of max(duration, 0) // safe_limit.
constexpr int MERGED24_W = 24;

struct MergedHead {
  int64_t base, q, rate_i, s0, expire;
};

// Floor division for any b != 0 (rate_i's divisor is the request limit).
GT_HD int64_t floor_div_any(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

GT_HD int64_t floor_i64(double x) {
#if defined(__CUDA_ARCH__)
  return trunc_i64(::floor(x));
#else
  return trunc_i64(__builtin_floor(x));
#endif
}

// `o` is the head's post-transition row; the fold rewrites its remaining,
// status and remaining_f words in place.  The extras (base, q, rate_i, s0,
// expire) are every head's; the fold itself only a live token or leaky
// head's with followers, so a warp of zoo heads (tile.cuh) skips it.  Both
// divisions take floor_div's 32-bit path when their operands fit: q's
// dividend is >= 0 and h >= 1, and rate_i's dividend is >= 0, so for a
// positive divisor floor and truncation agree; a negative limit keeps
// floor_div_any.
GT_HD MergedHead merged_fold(int64_t now, int64_t* o, const Req& r,
                             int32_t count) {
  bool is_tok = r.algorithm == TOKEN;
  int64_t h = r.hits > 0 ? r.hits : 1;
  double remf = bits_to_f64(o[W_REMAINING_F]);
  int64_t base = is_tok ? o[W_REMAINING] : floor_i64(remf);
  int64_t q = floor_div(imax(base, 0), h);
  int64_t dur = imax(r.duration, 0);
  int64_t safe_limit = r.limit == 0 ? 1 : r.limit;

  MergedHead m;
  m.base = base;
  m.q = q;
  m.rate_i = safe_limit > 0 ? floor_div(dur, safe_limit)
                            : floor_div_any(dur, safe_limit);
  m.s0 = o[W_STATUS];
  m.expire = o[W_EXPIRE_AT];
  bool alive = now <= o[W_EXPIRE_AT];
  bool fold = count > 1 && alive && r.valid != 0 && r.algorithm <= LEAKY;
  if (!fold) return m;

  int64_t li = (int64_t)count - 1;
  int64_t residue = wsub(base, wmul(q, h));
  bool divisible = residue == 0;
  bool drain = (r.behavior & DRAIN_OVER_LIMIT) != 0;
  if (is_tok) {
    bool at_zero_last = divisible ? li > q : (drain && li > wadd(q, 1));
    o[W_REMAINING] =
        li <= q ? wsub(base, wmul(li, h)) : (drain ? 0 : residue);
    if (at_zero_last) o[W_STATUS] = OVER;
  } else {
    bool zero_f = (q >= 1 && divisible && li >= q) ||
                  (base > 0 && drain && li > q);
    o[W_REMAINING_F] = f64_to_bits(
        zero_f ? 0.0 : remf - (double)wmul(imin(li, q), h));
  }
  return m;
}

GT_HD void put_pair(int32_t* w, int k, int64_t v) {
  w[k] = (int32_t)(uint32_t)(uint64_t)v;
  w[k + 1] = (int32_t)(v >> 32);
}

// One head's MERGED24 journal row (transition32.merged24_rows order): the
// six compact response words, base, q, rate_i, s0, expire, then the echoed
// hits, limit, created_at, algorithm and behavior; word 23 is 0.  Padding
// heads get a zero row.
GT_HD void merged24_words(int32_t* w, const Resp& p, const MergedHead& m,
                          const Req& r, bool live) {
  for (int k = 0; k < MERGED24_W; ++k) w[k] = 0;
  if (!live) return;
  w[0] = (int32_t)p.status;
  w[1] = (int32_t)p.over_limit;
  put_pair(w, 2, p.remaining);
  put_pair(w, 4, p.reset_time);
  put_pair(w, 6, m.base);
  put_pair(w, 8, m.q);
  put_pair(w, 10, m.rate_i);
  w[12] = (int32_t)m.s0;
  put_pair(w, 13, m.expire);
  put_pair(w, 15, r.hits);
  put_pair(w, 17, r.limit);
  put_pair(w, 19, r.created_at);
  w[21] = r.algorithm;
  w[22] = r.behavior;
}

// A request from its 19 REQ32 words, `word(k)` giving row k's: narrow
// fields one word each, wide fields a (lo, hi) pair of words.
template <class Word>
GT_HD Req req_from(Word word) {
  auto pair = [&](int row) {
    return ((int64_t)word(row + 1) << 32) | (int64_t)(uint32_t)word(row);
  };
  Req r;
  r.slot = word(R_SLOT);
  r.known = word(R_KNOWN);
  r.algorithm = word(R_ALGORITHM);
  r.behavior = word(R_BEHAVIOR);
  r.valid = word(R_VALID);
  r.hits = pair(R_HITS);
  r.limit = pair(R_LIMIT);
  r.duration = pair(R_DURATION);
  r.created_at = pair(R_CREATED_AT);
  r.burst = pair(R_BURST);
  r.greg_exp = pair(R_GREG_EXP);
  r.greg_dur = pair(R_GREG_DUR);
  return r;
}

// Lane j of a (19, *) REQ32 matrix of leading dimension ld.
GT_HD Req load_req(const int32_t* m, int64_t ld, int64_t j) {
  return req_from([=](int k) { return m[k * ld + j]; });
}

// Compact response columns: status, over_limit, remaining lo/hi,
// reset_time lo/hi (int32).  Padding and error lanes answer zeros.
GT_HD void store_resp(int32_t* out, int64_t ld, int64_t j, const Resp& p,
                      bool live) {
  out[0 * ld + j] = live ? (int32_t)p.status : 0;
  out[1 * ld + j] = live ? (int32_t)p.over_limit : 0;
  out[2 * ld + j] = live ? (int32_t)(uint32_t)(uint64_t)p.remaining : 0;
  out[3 * ld + j] = live ? (int32_t)(p.remaining >> 32) : 0;
  out[4 * ld + j] = live ? (int32_t)(uint32_t)(uint64_t)p.reset_time : 0;
  out[5 * ld + j] = live ? (int32_t)(p.reset_time >> 32) : 0;
}

// Lane placement of the fused tick (fused_tick.cu): the lane's table row,
// or -1 for a lane that touches no row (valid == 0, or a slot outside
// [0, capacity): padding aims at the guard row, per-item errors too).
GT_HD int64_t slot_row(int64_t capacity, int64_t slot, int64_t valid) {
  return valid != 0 && slot >= 0 && slot < capacity ? slot : -1;
}

// Lane placement of the ragged tick (fused_ragged_tick.cu) over a table of
// n_shards blocks of local_capacity + 1 rows, the last row of each block
// its shard's guard.  Lane j belongs to shard s when
// offsets[s] <= j < offsets[s + 1] (found by lane position, not from the
// slot), and its global slot rebases into the shard's block.  Returns the
// lane's table row, or -1 for a lane that touches no row: off every
// extent, valid == 0, or a slot outside its shard's range (a host bug;
// the TPU kernel clips such a slot into the shard instead).
GT_HD int64_t ragged_row(const int32_t* offsets, int64_t n_shards,
                         int64_t local_capacity, int64_t j, int64_t slot,
                         int64_t valid) {
  if (valid == 0 || j < offsets[0] || j >= offsets[n_shards]) return -1;
  int64_t lo = 0, hi = n_shards;  // offsets[lo] <= j < offsets[hi]
  while (hi - lo > 1) {
    int64_t mid = (lo + hi) / 2;
    if (offsets[mid] <= j) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  int64_t local = slot - lo * local_capacity;
  if (local < 0 || local >= local_capacity) return -1;
  return lo * (local_capacity + 1) + local;
}

}  // namespace gt
