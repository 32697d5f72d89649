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
// flattened slot lies in the table (padding aims at the drop row).
struct Lane {
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
  l.r = gt::load_req(m32, ld, j);
  const int64_t flat = l.r.slot;
  l.live = l.r.valid != 0 && flat >= 0 && flat < m.n_nodes * m.capacity;
  l.d = l.live ? flat / m.capacity : 0;
  l.s = l.live ? flat - l.d * m.capacity : 0;
  bool next_same = false;
  if (j + 1 < lanes) {
    next_same = m32[gt::R_SLOT * ld + j + 1] == flat &&
                m32[gt::R_VALID * ld + j + 1] != 0;
  }
  l.tail = l.live && !next_same;
  const bool owned = owner_of(m, l.s) == l.d;
  l.queue = l.live && !owned && l.r.hits != 0;
  l.reset = l.queue && (l.r.behavior & gt::RESET_REMAINING) != 0;
  return l;
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

// ---- B.8d: the sparse apply of one union slot ----
//
// `row` holds the owner's row on entry and the folded row on return: each
// node's window in node order where its count is above 0, each with that
// node's own parameters (havep its own stamp above 0, the Gregorian words
// masked by it) and the running row standing in without them
// (global_mesh.py:442-477).
GT_HD void sparse_slot(const Mesh& m, const int64_t* aux, const int64_t* acc,
                       int64_t s, int64_t now, int64_t* row) {
  for (int64_t d = 0; d < m.n_nodes; ++d) {
    if (acc[acc_ix(m, d, ACC_COUNT, s)] <= 0) continue;
    int64_t p[AUX_ROWS];
    for (int k = 0; k < AUX_ROWS; ++k) p[k] = aux[aux_ix(m, d, k, s)];
    const bool havep = p[A_STAMP] > 0;
    apply_req(now, fold_req(acc[acc_ix(m, d, ACC_HITS, s)],
                            acc[acc_ix(m, d, ACC_RESET, s)], p, havep, row,
                            havep ? p[A_GREG_EXP] : 0,
                            havep ? p[A_GREG_DUR] : 0, now),
              row);
  }
}

}  // namespace gm
