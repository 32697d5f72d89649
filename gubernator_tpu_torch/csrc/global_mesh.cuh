// The GLOBAL mesh's per-lane and per-slot steps (kernels B.8a-B.8d).
//
// Port of the device programs of gubernator_tpu/parallel/global_mesh.py
// to one card: the n logical nodes of the mesh are n replicas in one row
// table, so each collective of the reference (psum, all-gather by one-hot
// psum, pmax by write stamp) becomes a read of the other replicas' words
// by the thread that owns a slot.
//
// Buffers (ops/globalmesh.py):
//   table  (n * capacity + 1, 16) int64: node d's replica of slot s is
//          row d * capacity + s (the row layout of ops/buckets.py); the
//          last row is the drop row, which nothing writes;
//   aux    (n, 9, capacity) int64: each node's last request parameters a
//          slot (AUX_ROWS of the reference, the write stamp last);
//   accum  (n, 4, capacity) int64: each node's queued hits, RESET count,
//          queued-request count and touch count a slot.
// Slot s is owned by node s / (capacity / n): the authority's row.
//
// Every transition goes through gt::transition_class, so the x64
// semantics are those of the ticks B.1 and B.5 bit for bit.  The header
// compiles as CUDA (global_mesh.cu) and as host C++ (the test-only host
// build global_mesh_host.cc, which the CPU tests hold against the plain
// versions).
#pragma once

#include "transition.cuh"

namespace gm {

constexpr int AUX_ROWS = 9;
constexpr int A_LIMIT = 0, A_DURATION = 1, A_ALGORITHM = 2, A_BEHAVIOR = 3,
              A_BURST = 4, A_GREG_EXP = 5, A_GREG_DUR = 6,
              A_CREATED_AT = 7, A_STAMP = 8;
constexpr int ACC_ROWS = 4;
constexpr int ACC_HITS = 0, ACC_RESET = 1, ACC_COUNT = 2, ACC_TOUCH = 3;

struct Mesh {
  int64_t n_nodes, capacity, slice;  // slice = capacity / n_nodes
};

GT_HD int64_t aux_ix(const Mesh& m, int64_t d, int k, int64_t s) {
  return (d * AUX_ROWS + k) * m.capacity + s;
}
GT_HD int64_t acc_ix(const Mesh& m, int64_t d, int k, int64_t s) {
  return (d * ACC_ROWS + k) * m.capacity + s;
}
GT_HD int64_t owner_of(const Mesh& m, int64_t s) { return s / m.slice; }

// ---- B.8a: one sorted lane of a process window ----
//
// Lanes are the window's REQ32 columns sorted by the flattened slot
// d * capacity + s (a stable sort: arrival order within a slot kept), the
// live lanes of one slot contiguous.  A lane is live when valid and its
// flattened slot lies in the table (padding aims at the drop row).  The
// flattened slot is an int32 word and the drop row n * capacity fits
// one (the wrapper checks), so node, slot and owner are 32-bit divisions
// (a 64-bit one costs ~460 cycles on the H100, PERF.md §6).
struct Lane {
  int64_t flat;  // the flattened slot when live, else -1
  int64_t d, s;
  bool live;
  bool tail;   // the last live lane of its slot: writes the aux words
  bool queue;  // a hit on a slot its node does not own (global.go:99-112)
  bool reset;  // a queued lane with RESET_REMAINING
  gt::Req r;
};

GT_HD Lane lane_at(const int32_t* m32, int64_t ld, int64_t lanes, int64_t j,
                   const Mesh& m) {
  Lane l;
  // The lane's 19 words and its successor's slot and valid words, all
  // issued before any is used.
  l.r = gt::load_req(m32, ld, j);
  const bool has_next = j + 1 < lanes;
  const int32_t next_slot = has_next ? m32[gt::R_SLOT * ld + j + 1] : 0;
  const int32_t next_valid = has_next ? m32[gt::R_VALID * ld + j + 1] : 0;
  const int32_t flat = (int32_t)l.r.slot;
  l.live = l.r.valid != 0 && flat >= 0 && flat < m.n_nodes * m.capacity;
  const uint32_t f = (uint32_t)flat, cap = (uint32_t)m.capacity;
  const uint32_t d = l.live ? f / cap : 0u;
  const uint32_t s = l.live ? f - d * cap : 0u;
  l.flat = l.live ? flat : -1;
  l.d = d;
  l.s = s;
  l.tail = l.live && !(has_next && next_slot == flat && next_valid != 0);
  const bool owned = l.live && s / (uint32_t)m.slice == d;
  l.queue = l.live && !owned && l.r.hits != 0;
  l.reset = l.queue && (l.r.behavior & gt::RESET_REMAINING) != 0;
  return l;
}

// A lane's accumulator terms: its hits where queued, and its queued,
// RESET and touch counts packed in one word, 8 bits each (a run merged
// within a warp sums at most 32 of each, so no field carries into the
// next).  Sums wrap modulo 2^64 in any order, so a run's merged terms
// added once leave the words as the lanes' own adds would.
constexpr int CNT_QUEUE = 0, CNT_RESET = 8, CNT_TOUCH = 16;

struct LaneAcc {
  uint64_t hits;
  uint32_t counts;
};

GT_HD LaneAcc lane_acc(const Lane& l, bool track_touch) {
  LaneAcc a;
  a.hits = l.queue ? (uint64_t)l.r.hits : 0u;
  a.counts = ((l.queue ? 1u : 0u) << CNT_QUEUE) |
             ((l.reset ? 1u : 0u) << CNT_RESET) |
             ((track_touch && l.live ? 1u : 0u) << CNT_TOUCH);
  return a;
}

// A run's merged terms as its node's four accumulator addends, in ACC
// order; a word whose addend is 0 is left alone.
GT_HD void run_addends(const LaneAcc& a, uint64_t* v) {
  v[ACC_HITS] = a.hits;
  v[ACC_RESET] = (a.counts >> CNT_RESET) & 0xffu;
  v[ACC_COUNT] = (a.counts >> CNT_QUEUE) & 0xffu;
  v[ACC_TOUCH] = (a.counts >> CNT_TOUCH) & 0xffu;
}

// The aux words a tail lane writes, in AUX_ROWS order.
GT_HD int64_t aux_word(const Lane& l, int k, int64_t stamp) {
  const gt::Req& r = l.r;
  return k == A_LIMIT        ? r.limit
       : k == A_DURATION     ? r.duration
       : k == A_ALGORITHM    ? (int64_t)r.algorithm
       : k == A_BEHAVIOR     ? (int64_t)r.behavior
       : k == A_BURST        ? r.burst
       : k == A_GREG_EXP     ? r.greg_exp
       : k == A_GREG_DUR     ? r.greg_dur
       : k == A_CREATED_AT   ? r.created_at
                             : stamp;
}

// ---- the authority's fold of one node's window into one row ----
//
// The request a reconcile applies (make_global_reconcile_fn make_req /
// the sparse fold): the hits and the RESET count of the window, the
// parameters `p` (AUX_ROWS words; `havep` false when there are none), and
// `fb` the row whose limit, duration, algorithm and burst stand in when
// `havep` is false.  DRAIN_OVER_LIMIT is forced on forwarded GLOBAL hits
// (gubernator.go:510-512) and RESET_REMAINING applies only when queued in
// this window.
GT_HD gt::Req fold_req(int64_t hits, int64_t resets, const int64_t* p,
                       bool havep, const int64_t* fb, int64_t greg_exp,
                       int64_t greg_dur, int64_t now) {
  gt::Req r;
  int32_t beh = (int32_t)(havep ? p[A_BEHAVIOR] : 0);
  beh = (beh & ~gt::RESET_REMAINING) | gt::DRAIN_OVER_LIMIT;
  r.slot = 0;
  r.known = 1;
  r.valid = 1;
  r.hits = hits;
  r.limit = havep ? p[A_LIMIT] : fb[gt::W_LIMIT];
  r.duration = havep ? p[A_DURATION] : fb[gt::W_DURATION];
  r.algorithm = (int32_t)(havep ? p[A_ALGORITHM] : fb[gt::W_ALGORITHM]);
  r.behavior = resets > 0 ? (beh | gt::RESET_REMAINING) : beh;
  r.created_at = havep ? p[A_CREATED_AT] : now;
  r.burst = havep ? p[A_BURST] : fb[gt::W_BURST];
  r.greg_exp = greg_exp;
  r.greg_dur = greg_dur;
  return r;
}

GT_HD void apply_req(int64_t now, const gt::Req& r, int64_t* row) {
  gt::transition_class(gt::algo_class(r.algorithm), now, r, row);
}

// ---- B.8b: the dense reconcile of one slot ----
//
// `row` holds the owner's row on entry and the merged row on return (in
// registers, or the kernel's shared memory).  The parameters are the
// stamp winner's: the node with the largest stamp * n + d among stamps
// above 0 (the reference's pmax over write stamps, ties summed as its
// masked psum does); without one the base row (the owner's row on entry)
// stands in and the Gregorian words are 0.  Strict: each node's window
// folds in node order where its count is above 0, the base row copied
// aside at the first.  Otherwise the three rows are summed over the nodes
// and applied once, the request read from the row before it changes.
GT_HD void dense_slot(const Mesh& m, const int64_t* aux, const int64_t* acc,
                      int64_t s, int64_t now, bool strict, int64_t* row) {
  const int64_t n = m.n_nodes;
  int64_t win = -1;
  for (int64_t d = 0; d < n; ++d) {
    const int64_t st = aux[aux_ix(m, d, A_STAMP, s)];
    const int64_t key = st > 0 ? gt::wadd(gt::wmul(st, n), d) : -1;
    win = key > win ? key : win;
  }
  const bool havep = win >= 0;
  int64_t p[AUX_ROWS];
  for (int k = 0; k < AUX_ROWS; ++k) p[k] = 0;
  if (havep) {
    for (int64_t d = 0; d < n; ++d) {
      const int64_t st = aux[aux_ix(m, d, A_STAMP, s)];
      const int64_t key = st > 0 ? gt::wadd(gt::wmul(st, n), d) : -1;
      if (key != win) continue;
      for (int k = 0; k < AUX_ROWS; ++k) {
        p[k] = gt::wadd(p[k], aux[aux_ix(m, d, k, s)]);
      }
    }
  }
  if (strict) {
    int64_t base[gt::ROW_W];
    bool copied = false;
    for (int64_t d = 0; d < n; ++d) {
      if (acc[acc_ix(m, d, ACC_COUNT, s)] <= 0) continue;
      if (!copied) {
        for (int w = 0; w < gt::ROW_W; ++w) base[w] = row[w];
        copied = true;
      }
      apply_req(now, fold_req(acc[acc_ix(m, d, ACC_HITS, s)],
                              acc[acc_ix(m, d, ACC_RESET, s)], p, havep,
                              base, p[A_GREG_EXP], p[A_GREG_DUR], now),
                row);
    }
    return;
  }
  int64_t hits = 0, resets = 0, count = 0;
  for (int64_t d = 0; d < n; ++d) {
    hits = gt::wadd(hits, acc[acc_ix(m, d, ACC_HITS, s)]);
    resets = gt::wadd(resets, acc[acc_ix(m, d, ACC_RESET, s)]);
    count = gt::wadd(count, acc[acc_ix(m, d, ACC_COUNT, s)]);
  }
  if (count > 0) {
    apply_req(now, fold_req(hits, resets, p, havep, row, p[A_GREG_EXP],
                            p[A_GREG_DUR], now),
              row);
  }
}

// ---- B.8c: the sparse probe's view of one slot ----
//
// Bit 2d of the result: node d's window holds the slot (count above 0);
// bit 2d + 1: node d touched it (touch above 0).  The slot is in the
// union when any bit is set.
GT_HD bool window_at(const Mesh& m, const int64_t* acc, int64_t d,
                     int64_t s) {
  return acc[acc_ix(m, d, ACC_COUNT, s)] > 0;
}
GT_HD bool touch_at(const Mesh& m, const int64_t* acc, int64_t d,
                    int64_t s) {
  return acc[acc_ix(m, d, ACC_TOUCH, s)] > 0;
}

// The probe's verdict from its counts: any node's window or touch set
// wider than k, or any owner's share of the union wider than 2k
// (global_mesh.py:434-437).
GT_HD bool overflow_of(const int32_t* wcount, const int32_t* tcount,
                       const int32_t* bcount, int64_t n, int64_t k) {
  bool over = false;
  for (int64_t d = 0; d < n; ++d) {
    over = over || wcount[d] > k || tcount[d] > k || bcount[d] > 2 * k;
  }
  return over;
}

// ---- B.8d: the sparse apply of one union slot, in two halves ----
//
// The slot's row is the owner's row with each node's window folded in
// node order where its count is above 0, each with that node's own
// parameters (havep its own stamp above 0, the Gregorian words masked by
// it) and the running row standing in without them
// (global_mesh.py:442-477).  DRAIN_OVER_LIMIT is forced and
// RESET_REMAINING applies only when queued (fold_req).
//
// The halves are those of the chained tick (sorted_tick.cuh): each node's
// window is read (node_acc, node_aux) and, where it has its own
// parameters, built and prepared apart from the others (node_window, a
// lane a node in the kernel); only the applies run on the slot's chain,
// in node order (chain_link).  A window without its own parameters takes
// its limit, duration, algorithm and burst from the running row, so its
// request is built and prepared on the chain.
constexpr int8_t WIN_NONE = 0, WIN_OWN = 1, WIN_RUNNING = 2,
                 WIN_RUNNING_RESET = 3;

// Node d's four accumulator words of slot s, in ACC order.
struct NodeAcc {
  int64_t w[ACC_ROWS];
};

GT_HD NodeAcc node_acc(const Mesh& m, const int64_t* acc, int64_t d,
                       int64_t s) {
  NodeAcc a;
  for (int k = 0; k < ACC_ROWS; ++k) a.w[k] = acc[acc_ix(m, d, k, s)];
  return a;
}

// Node d's nine aux words of slot s into p.
GT_HD void node_aux(const Mesh& m, const int64_t* aux, int64_t d, int64_t s,
                    int64_t* p) {
  for (int k = 0; k < AUX_ROWS; ++k) p[k] = aux[aux_ix(m, d, k, s)];
}

// Node d's accumulator words of slot s to 0: those that are not 0
// already (`a`, as read), which leaves what zeroing all four would with
// fewer partly written sectors.
GT_HD void node_zero(const Mesh& m, int64_t* acc, int64_t d, int64_t s,
                     const NodeAcc& a) {
  for (int k = 0; k < ACC_ROWS; ++k) {
    if (a.w[k] != 0) acc[acc_ix(m, d, k, s)] = 0;
  }
}

struct NodeWin {
  int8_t kind;     // WIN_*: no window, its own parameters (prepared), or
                   // the running row's (without or with a queued RESET)
  int64_t hits;    // the window's hits (for the running row's kinds)
  gt::Prep prep;   // the prepared request (WIN_OWN)
};

// A node's window from its accumulator words `a` and aux words `p` (read
// only when its count is above 0): its request built and prepared when
// it has its own parameters.
GT_HD NodeWin node_window(const NodeAcc& a, const int64_t* p, int64_t now) {
  NodeWin w;
  w.hits = a.w[ACC_HITS];
  if (a.w[ACC_COUNT] <= 0) {
    w.kind = WIN_NONE;
  } else if (p[A_STAMP] > 0) {
    const gt::Req r = fold_req(a.w[ACC_HITS], a.w[ACC_RESET], p, true, p,
                               p[A_GREG_EXP], p[A_GREG_DUR], now);
    w.prep = gt::prepare(gt::algo_class(r.algorithm), now, r);
    w.kind = WIN_OWN;
  } else {
    w.kind = a.w[ACC_RESET] > 0 ? WIN_RUNNING_RESET : WIN_RUNNING;
  }
  return w;
}

// One link of the slot's chain: a window of kind `kind` (not WIN_NONE)
// on the running row, in place (words 13-15 are chain_end's).
GT_HD void chain_link(int8_t kind, const gt::Prep& own, int64_t hits,
                      int64_t now, int64_t* row) {
  if (kind == WIN_OWN) {
    gt::apply(now, own, row);
    return;
  }
  // Without parameters of its own fold_req reads only the running row.
  const gt::Req r = fold_req(hits, kind == WIN_RUNNING_RESET ? 1 : 0, row,
                             false, row, 0, 0, now);
  gt::apply(now, gt::prepare(gt::algo_class(r.algorithm), now, r), row);
}

// After the chain: words 13-15 of a row that a window was folded into
// are 0, as every transition leaves them.
GT_HD void chain_end(bool folded, int64_t* row) {
  if (!folded) return;
  for (int w = gt::W_PREV_COUNT + 1; w < gt::ROW_W; ++w) row[w] = 0;
}

}  // namespace gm
