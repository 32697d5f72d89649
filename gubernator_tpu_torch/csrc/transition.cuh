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
//   XLA gives the reference), with __double2ll_rz only on in-range values;
// * `//` and `%` are floor operations (jnp and torch semantics), used only
//   on the clamped a >= 0, b > 0 domain by the zoo formulas;
// * float64 operations are the same sequence of correctly rounded IEEE
//   operations, built with --fmad=false (no fused multiply-add).
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
  if (x != x) return 0;
  if (x >= 9223372036854775808.0) return I64_MAX;
  if (x < -9223372036854775808.0) return I64_MIN;
#if defined(__CUDA_ARCH__)
  return __double2ll_rz(x);
#else
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

// Zoo result: the state words a zoo transition decides, and its response.
struct Zoo {
  int64_t remaining, created_at, status, expire_at, tat, prev_count;
  Resp resp;
};

GT_HD Zoo sliding_window(const int64_t* s, const Req& r, bool exists,
                         bool reset_b, bool drain_b) {
  bool ex = exists && !reset_b && s[W_ALGORITHM] == SLIDING;
  int64_t t = imax(r.created_at, 0);
  int64_t dur = imax(r.duration, 1);
  int64_t aligned = wsub(t, floor_mod(t, dur));
  int64_t ws0 = ex ? s[W_CREATED_AT] : aligned;
  int64_t cur0 = ex ? imax(s[W_REMAINING], 0) : 0;
  int64_t prev0 = ex ? imax(s[W_PREV_COUNT], 0) : 0;
  int64_t delta = imax(wsub(t, ws0), 0);
  int64_t k = floor_div(delta, dur);
  int64_t prev1 = k == 0 ? prev0 : (k == 1 ? cur0 : 0);
  int64_t cur1 = k == 0 ? cur0 : 0;
  int64_t ws1 = k == 0 ? ws0 : aligned;
  int64_t frac = imin(imax(wsub(dur, wsub(t, ws1)), 0), dur);
  int64_t wprev = floor_div(wmul(prev1, frac), dur);
  int64_t used = wadd(wprev, cur1);
  int64_t avail = imax(wsub(r.limit, used), 0);
  int64_t h = r.hits;
  bool h_pos = h > 0, h_neg = h < 0, h_query = h == 0;
  bool fits = h <= avail;
  bool admit = h_pos && fits, over = h_pos && !fits;
  int64_t cur2 = admit ? wadd(cur1, h)
               : (over && drain_b) ? wadd(cur1, avail)
               : h_neg ? imax(wadd(cur1, h), 0)
               : cur1;
  Zoo z;
  z.remaining = cur2;
  z.created_at = ws1;
  z.status = (over || (h_query && avail == 0)) ? OVER : UNDER;
  z.expire_at = (!h_query || !ex) ? wadd(t, wadd(dur, dur)) : s[W_EXPIRE_AT];
  z.tat = 0;
  z.prev_count = prev1;
  z.resp.status = z.status;
  z.resp.remaining = imax(wsub(r.limit, wadd(wprev, cur2)), 0);
  z.resp.reset_time = wadd(ws1, dur);
  z.resp.over_limit = over;
  return z;
}

GT_HD Zoo gcra(const int64_t* s, const Req& r, bool exists, bool reset_b) {
  bool ex = exists && !reset_b && s[W_ALGORITHM] == GCRA;
  int64_t t = r.created_at;
  int64_t safe_limit = r.limit <= 0 ? 1 : r.limit;
  int64_t T = floor_div(imax(r.duration, 0), safe_limit);
  int64_t burst_eff = r.burst > 0 ? r.burst : r.limit;
  int64_t tau = wmul(wsub(burst_eff, 1), T);
  int64_t tat0 = ex ? s[W_TAT] : t;
  int64_t tat1 = imax(tat0, t);
  int64_t h = r.hits;
  bool h_pos = h > 0, h_neg = h < 0, h_query = h == 0;
  int64_t need = wadd(tat1, wmul(wsub(h, 1), T));
  int64_t horizon = wadd(t, tau);
  bool conform = need <= horizon;
  bool admit = h_pos && conform, over = h_pos && !conform;
  int64_t stepped = wadd(tat1, wmul(h, T));
  int64_t tat2 = admit ? stepped : (h_neg ? imax(stepped, t) : tat1);
  int64_t slack = wsub(horizon, tat2);
  int64_t rem_div = wadd(floor_div(imax(slack, 0), imax(T, 1)), 1);
  int64_t rem = slack < 0 ? 0 : (T == 0 ? burst_eff : imin(rem_div, burst_eff));
  rem = imax(rem, 0);
  Zoo z;
  z.remaining = rem;
  z.created_at = ex ? s[W_CREATED_AT] : t;
  z.status = (over || (h_query && rem == 0)) ? OVER : UNDER;
  z.expire_at = (!h_query || !ex) ? imax(wadd(t, r.duration), tat2)
                                  : s[W_EXPIRE_AT];
  z.tat = tat2;
  z.prev_count = 0;
  z.resp.status = z.status;
  z.resp.remaining = rem;
  z.resp.reset_time = imax(wsub(tat2, tau), t);
  z.resp.over_limit = over;
  return z;
}

GT_HD Zoo concurrency(const int64_t* s, const Req& r, bool exists,
                      bool reset_b) {
  bool ex = exists && !reset_b && s[W_ALGORITHM] == CONC;
  int64_t t = r.created_at;
  int64_t rebased = wadd(s[W_REMAINING], wsub(r.limit, s[W_LIMIT]));
  int64_t rem0 = imax(ex ? rebased : r.limit, 0);
  int64_t h = r.hits;
  bool h_pos = h > 0, h_neg = h < 0, h_query = h == 0;
  bool fits = h <= rem0;
  bool admit = h_pos && fits, over = h_pos && !fits;
  int64_t rem1 = admit ? wsub(rem0, h)
               : h_neg ? imax(imin(wsub(rem0, h), r.limit), 0)
               : rem0;
  Zoo z;
  z.remaining = rem1;
  z.created_at = ex ? s[W_CREATED_AT] : t;
  z.status = (over || (h_query && rem1 == 0)) ? OVER : UNDER;
  z.expire_at = (!h_query || !ex) ? wadd(t, r.duration) : s[W_EXPIRE_AT];
  z.tat = 0;
  z.prev_count = 0;
  z.resp.status = z.status;
  z.resp.remaining = rem1;
  z.resp.reset_time = z.expire_at;
  z.resp.over_limit = over;
  return z;
}

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

// What every class reads first: the behavior flags and whether the slot
// holds a live item.
struct Lane {
  bool reset_b, drain_b, greg_b, exists;
};

GT_HD Lane lane_flags(int64_t now, const int64_t* s, const Req& r) {
  Lane f;
  f.reset_b = (r.behavior & RESET_REMAINING) != 0;
  f.drain_b = (r.behavior & DRAIN_OVER_LIMIT) != 0;
  f.greg_b = (r.behavior & DURATION_IS_GREGORIAN) != 0;
  f.exists = r.known != 0 && s[W_IN_USE] != 0 && now <= s[W_EXPIRE_AT];
  return f;
}

// ---- token bucket (algorithms.go:37-257) ----
GT_HD Resp token_transition(const int64_t* s, const Req& r, const Lane& f,
                            int64_t* o) {
  bool algo_match = s[W_ALGORITHM] == (int64_t)r.algorithm;
  int64_t h = r.hits, limit = r.limit, r_dur = r.duration,
          r_created = r.created_at;
  double s_remf = bits_to_f64(s[W_REMAINING_F]);
  bool tok_reset = f.exists && f.reset_b;
  bool tok_exist = f.exists && !f.reset_b && algo_match;
  o[W_ALGORITHM] = TOKEN;
  o[W_LIMIT] = limit;
  o[W_TAT] = 0;
  o[W_PREV_COUNT] = 0;
  Resp resp;
  if (tok_reset) {
    // RESET_REMAINING on an existing item removes it (:78-90).
    o[W_REMAINING] = 0;
    o[W_REMAINING_F] = f64_to_bits(s_remf * 0.0);
    o[W_DURATION] = 0;
    o[W_CREATED_AT] = 0;
    o[W_UPDATED_AT] = 0;
    o[W_BURST] = 0;
    o[W_STATUS] = 0;
    o[W_EXPIRE_AT] = 0;
    o[W_IN_USE] = 0;
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
        f.greg_b ? r.greg_exp : wadd(s[W_CREATED_AT], r_dur);
    bool renew = expire_cand <= r_created;
    int64_t expire_new = renew ? wadd(r_created, r_dur) : expire_cand;
    int64_t t_created = (dur_changed && renew) ? r_created : s[W_CREATED_AT];
    int64_t t_rem1 = (dur_changed && renew) ? limit : t_rem0;
    int64_t t_expire = dur_changed ? expire_new : s[W_EXPIRE_AT];
    bool t_query = h == 0;
    bool t_at_zero = !t_query && rl_rem_base == 0 && h > 0;
    bool t_exact = !t_query && !t_at_zero && t_rem1 == h;
    bool t_over = !t_query && !t_at_zero && !t_exact && h > t_rem1;
    bool t_dec = !t_query && !t_at_zero && !t_exact && !t_over;
    o[W_REMAINING] = t_exact ? 0
                   : t_over ? (f.drain_b ? 0 : t_rem1)
                   : t_dec ? wsub(t_rem1, h) : t_rem1;
    o[W_REMAINING_F] = f64_to_bits(s_remf);
    o[W_DURATION] = r_dur;
    o[W_CREATED_AT] = t_created;
    o[W_UPDATED_AT] = s[W_UPDATED_AT];
    o[W_BURST] = s[W_BURST];
    o[W_STATUS] = t_at_zero ? OVER : s[W_STATUS];
    o[W_EXPIRE_AT] = t_expire;
    o[W_IN_USE] = 1;
    resp.status = (t_at_zero || t_over) ? OVER : rl_status;
    resp.remaining = t_exact ? 0
                   : t_over ? (f.drain_b ? 0 : rl_rem_base)
                   : t_dec ? wsub(t_rem1, h) : rl_rem_base;
    resp.reset_time = t_expire;
    resp.over_limit = t_at_zero || t_over;
  } else {
    int64_t tn_expire = f.greg_b ? r.greg_exp : wadd(r_created, r_dur);
    bool tn_over = h > limit;
    int64_t tn_rem = tn_over ? limit : wsub(limit, h);
    o[W_REMAINING] = tn_rem;
    o[W_REMAINING_F] = f64_to_bits(s_remf);
    o[W_DURATION] = r_dur;
    o[W_CREATED_AT] = r_created;
    o[W_UPDATED_AT] = s[W_UPDATED_AT];
    o[W_BURST] = s[W_BURST];
    o[W_STATUS] = UNDER;
    o[W_EXPIRE_AT] = tn_expire;
    o[W_IN_USE] = 1;
    resp.status = tn_over ? OVER : UNDER;
    resp.remaining = tn_rem;
    resp.reset_time = tn_expire;
    resp.over_limit = tn_over;
  }
  return resp;
}

// ---- leaky bucket (algorithms.go:260-493) ----
GT_HD Resp leaky_transition(int64_t now, const int64_t* s, const Req& r,
                            const Lane& f, int64_t* o) {
  bool algo_match = s[W_ALGORITHM] == (int64_t)r.algorithm;
  int64_t h = r.hits, limit = r.limit, r_dur = r.duration,
          r_created = r.created_at;
  double safe_limit_f = (double)(limit == 0 ? 1 : limit);
  int64_t burst = r.burst == 0 ? limit : r.burst;
  bool leak_exist = f.exists && algo_match;
  o[W_ALGORITHM] = LEAKY;
  o[W_LIMIT] = limit;
  o[W_REMAINING] = s[W_REMAINING];
  o[W_BURST] = burst;
  o[W_IN_USE] = 1;
  o[W_TAT] = 0;
  o[W_PREV_COUNT] = 0;
  Resp resp;
  if (leak_exist) {
    double s_remf = bits_to_f64(s[W_REMAINING_F]);
    double burst_f = (double)burst;
    double b_rem0 = f.reset_b ? burst_f : s_remf;
    bool burst_changed = s[W_BURST] != burst;
    double b_rem1 =
        (burst_changed && burst > trunc_i64(b_rem0)) ? burst_f : b_rem0;
    double rate = (double)(f.greg_b ? r.greg_dur : r_dur) / safe_limit_f;
    int64_t duration_eff = f.greg_b ? wsub(r.greg_exp, now) : r_dur;
    int64_t elapsed = wsub(r_created, s[W_UPDATED_AT]);
    double leak = (double)elapsed / (rate == 0.0 ? 1.0 : rate);
    bool leaked = trunc_i64(leak) > 0;
    double b_rem2 = leaked ? b_rem1 + leak : b_rem1;
    int64_t b_upd = leaked ? r_created : s[W_UPDATED_AT];
    double b_rem3 = trunc_i64(b_rem2) > burst ? burst_f : b_rem2;
    int64_t rem_i = trunc_i64(b_rem3);
    int64_t rate_i = trunc_i64(rate);
    double h_f = (double)h;
    bool l_at_zero = rem_i == 0 && h > 0;
    bool l_exact = !l_at_zero && rem_i == h;
    bool l_over = !l_at_zero && !l_exact && h > rem_i;
    bool l_query = !l_at_zero && !l_exact && !l_over && h == 0;
    bool l_dec = !l_at_zero && !l_exact && !l_over && !l_query;
    double le_remf = l_exact ? 0.0
                   : l_over ? (f.drain_b ? 0.0 : b_rem3)
                   : l_dec ? b_rem3 - h_f : b_rem3;
    int64_t le_resp_rem = l_exact ? 0
                        : l_over ? (f.drain_b ? 0 : rem_i)
                        : l_dec ? trunc_i64(b_rem3 - h_f) : rem_i;
    int64_t le_reset_rem = l_over ? rem_i : le_resp_rem;
    o[W_REMAINING_F] = f64_to_bits(le_remf);
    o[W_DURATION] = r_dur;
    o[W_CREATED_AT] = s[W_CREATED_AT];
    o[W_UPDATED_AT] = b_upd;
    o[W_STATUS] = s[W_STATUS];
    o[W_EXPIRE_AT] = h != 0 ? wadd(r_created, duration_eff) : s[W_EXPIRE_AT];
    resp.status = (l_at_zero || l_over) ? OVER : UNDER;
    resp.remaining = le_resp_rem;
    resp.reset_time =
        wadd(r_created, wmul(wsub(limit, le_reset_rem), rate_i));
    resp.over_limit = l_at_zero || l_over;
  } else {
    int64_t ln_rate_i = trunc_i64((double)r_dur / safe_limit_f);
    int64_t ln_duration = f.greg_b ? wsub(r.greg_exp, now) : r_dur;
    bool ln_over = h > burst;
    double ln_remf = ln_over ? 0.0 : (double)wsub(burst, h);
    int64_t ln_resp_rem = ln_over ? 0 : wsub(burst, h);
    o[W_REMAINING_F] = f64_to_bits(ln_remf);
    o[W_DURATION] = ln_duration;
    o[W_CREATED_AT] = s[W_CREATED_AT];
    o[W_UPDATED_AT] = r_created;
    o[W_STATUS] = UNDER;
    o[W_EXPIRE_AT] = wadd(r_created, ln_duration);
    resp.status = ln_over ? OVER : UNDER;
    resp.remaining = ln_resp_rem;
    resp.reset_time =
        wadd(r_created, wmul(wsub(limit, ln_resp_rem), ln_rate_i));
    resp.over_limit = ln_over;
  }
  return resp;
}

// ---- algorithm zoo: the row a zoo transition stores ----
GT_HD Resp zoo_store(const Zoo& z, const Req& r, int64_t* o) {
  o[W_ALGORITHM] = r.algorithm;
  o[W_LIMIT] = r.limit;
  o[W_REMAINING] = z.remaining;
  o[W_REMAINING_F] = 0;  // +0.0
  o[W_DURATION] = r.duration;
  o[W_CREATED_AT] = z.created_at;
  o[W_UPDATED_AT] = r.created_at;
  o[W_BURST] = r.burst;
  o[W_STATUS] = z.status;
  o[W_EXPIRE_AT] = z.expire_at;
  o[W_IN_USE] = 1;
  o[W_TAT] = z.tat;
  o[W_PREV_COUNT] = z.prev_count;
  return z.resp;
}

// One live lane of class `cls` (== algo_class(r.algorithm)): `s` is the
// gathered row (read), `o` the row to store.  Each class computes only its
// own quantities.
GT_HD Resp transition_class(int cls, int64_t now, const int64_t* s,
                            const Req& r, int64_t* o) {
  Lane f = lane_flags(now, s, r);
  Resp resp;
  switch (cls) {
    case C_TOKEN:
      resp = token_transition(s, r, f, o);
      break;
    case C_LEAKY:
      resp = leaky_transition(now, s, r, f, o);
      break;
    case C_GCRA:
      resp = zoo_store(gcra(s, r, f.exists, f.reset_b), r, o);
      break;
    case C_CONC:
      resp = zoo_store(concurrency(s, r, f.exists, f.reset_b), r, o);
      break;
    default:
      resp = zoo_store(sliding_window(s, r, f.exists, f.reset_b, f.drain_b),
                       r, o);
      break;
  }
  for (int w = W_PREV_COUNT + 1; w < ROW_W; ++w) o[w] = 0;
  return resp;
}

// One lane: `s` is the gathered row (read), `o` the row to store.
GT_HD Resp transition(int64_t now, const int64_t* s, const Req& r,
                      int64_t* o) {
  return transition_class(algo_class(r.algorithm), now, s, r, o);
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
// status and remaining_f words in place.
GT_HD MergedHead merged_fold(int64_t now, int64_t* o, const Req& r,
                             int32_t count) {
  bool is_tok = r.algorithm == TOKEN;
  int64_t h = r.hits > 0 ? r.hits : 1;
  double remf = bits_to_f64(o[W_REMAINING_F]);
  int64_t base = is_tok ? o[W_REMAINING] : floor_i64(remf);
  int64_t q = imax(base, 0) / h;
  int64_t li = (int64_t)count - 1;
  bool alive = now <= o[W_EXPIRE_AT];
  bool fold = count > 1 && alive && r.valid != 0 && r.algorithm <= LEAKY;

  int64_t residue = wsub(base, wmul(q, h));
  bool divisible = residue == 0;
  bool drain = (r.behavior & DRAIN_OVER_LIMIT) != 0;
  int64_t rem_last =
      li <= q ? wsub(base, wmul(li, h)) : (drain ? 0 : residue);
  bool at_zero_last = divisible ? li > q : (drain && li > wadd(q, 1));
  bool zero_f = (q >= 1 && divisible && li >= q) ||
                (base > 0 && drain && li > q);
  double remf_last =
      zero_f ? 0.0 : remf - (double)wmul(imin(li, q), h);

  MergedHead m;
  m.base = base;
  m.q = q;
  m.rate_i = floor_div_any(imax(r.duration, 0), r.limit == 0 ? 1 : r.limit);
  m.s0 = o[W_STATUS];
  m.expire = o[W_EXPIRE_AT];
  if (fold && is_tok) {
    o[W_REMAINING] = rem_last;
    if (at_zero_last) o[W_STATUS] = OVER;
  }
  if (fold && !is_tok) o[W_REMAINING_F] = f64_to_bits(remf_last);
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

GT_HD int64_t join_pair(const int32_t* m, int64_t ld, int row, int64_t j) {
  return ((int64_t)m[(row + 1) * ld + j] << 32) |
         (int64_t)(uint32_t)m[row * ld + j];
}

GT_HD Req load_req(const int32_t* m, int64_t ld, int64_t j) {
  Req r;
  r.slot = m[R_SLOT * ld + j];
  r.known = m[R_KNOWN * ld + j];
  r.algorithm = m[R_ALGORITHM * ld + j];
  r.behavior = m[R_BEHAVIOR * ld + j];
  r.valid = m[R_VALID * ld + j];
  r.hits = join_pair(m, ld, R_HITS, j);
  r.limit = join_pair(m, ld, R_LIMIT, j);
  r.duration = join_pair(m, ld, R_DURATION, j);
  r.created_at = join_pair(m, ld, R_CREATED_AT, j);
  r.burst = join_pair(m, ld, R_BURST, j);
  r.greg_exp = join_pair(m, ld, R_GREG_EXP, j);
  r.greg_dur = join_pair(m, ld, R_GREG_DUR, j);
  return r;
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
