// Host build of the GLOBAL mesh kernels' lane and slot code, for tests only.
//
// Compiles global_mesh.cuh as plain C++ and runs each kernel's steps one
// lane or one slot after another: B.8a's lane decisions, aux words and
// runs merged a warp (its atomic adds as plain adds), B.8b's dense slot,
// B.8c's window and touch bits, counts and verdict (the union listed in
// slot order), and B.8d's two halves on each listed slot (each node's
// window, then the chain).  The CPU tests hold it against the plain
// PyTorch versions (ops/globalmesh.py); the kernels themselves are held
// against the plain versions on the card by chip_smoke.py.

#include <stdint.h>

#include <vector>

#include "global_mesh.cuh"

namespace {

gm::Mesh mesh_of(int64_t n_nodes, int64_t capacity) {
  return gm::Mesh{n_nodes, capacity, capacity / n_nodes};
}

void replicate(int64_t* table, int64_t* acc, const gm::Mesh& m, int64_t s,
               const int64_t* row) {
  for (int64_t d = 0; d < m.n_nodes; ++d) {
    int64_t* dst = table + (d * m.capacity + s) * gt::ROW_W;
    for (int w = 0; w < gt::ROW_W; ++w) dst[w] = row[w];
    for (int k = 0; k < gm::ACC_ROWS; ++k) acc[gm::acc_ix(m, d, k, s)] = 0;
  }
}

void owner_row(const int64_t* table, const gm::Mesh& m, int64_t s,
               int64_t* row) {
  const int64_t* src = table + (gm::owner_of(m, s) * m.capacity + s) * gt::ROW_W;
  for (int w = 0; w < gt::ROW_W; ++w) row[w] = src[w];
}

}  // namespace

// B.8a as the kernel runs it: warps of 32 lanes, each run of one
// flattened slot within a warp merged (lane_acc) and added once.
extern "C" void gt_global_accumulate_host(const int32_t* m32, int64_t ld,
                                          int64_t lanes, int64_t* aux,
                                          int64_t* acc, int64_t n_nodes,
                                          int64_t capacity, int64_t stamp,
                                          int track_touch) {
  const gm::Mesh m = mesh_of(n_nodes, capacity);
  auto add_run = [&](const gm::Lane& l, const gm::LaneAcc& a) {
    if (l.flat < 0) return;
    uint64_t v[gm::ACC_ROWS];
    gm::run_addends(a, v);
    for (int k = 0; k < gm::ACC_ROWS; ++k) {
      int64_t& w = acc[gm::acc_ix(m, l.d, k, l.s)];
      w = (int64_t)((uint64_t)w + v[k]);
    }
  };
  for (int64_t w0 = 0; w0 < lanes; w0 += 32) {
    const int64_t w1 = w0 + 32 < lanes ? w0 + 32 : lanes;
    gm::Lane run{};
    gm::LaneAcc sum{};
    for (int64_t j = w0; j < w1; ++j) {
      const gm::Lane l = gm::lane_at(m32, ld, lanes, j, m);
      if (l.tail) {
        for (int k = 0; k < gm::AUX_ROWS; ++k) {
          aux[gm::aux_ix(m, l.d, k, l.s)] = gm::aux_word(l, k, stamp);
        }
      }
      const gm::LaneAcc a = gm::lane_acc(l, track_touch != 0);
      if (j > w0 && l.flat == run.flat) {
        sum.hits += a.hits;
        sum.counts += a.counts;
        continue;
      }
      if (j > w0) add_run(run, sum);
      run = l;
      sum = a;
    }
    add_run(run, sum);
  }
}

extern "C" void gt_global_dense_host(int64_t* table, const int64_t* aux,
                                     int64_t* acc, int64_t n_nodes,
                                     int64_t capacity, int64_t now,
                                     int strict) {
  const gm::Mesh m = mesh_of(n_nodes, capacity);
  int64_t row[gt::ROW_W];
  for (int64_t s = 0; s < capacity; ++s) {
    owner_row(table, m, s, row);
    gm::dense_slot(m, aux, acc, s, now, strict != 0, row);
    replicate(table, acc, m, s, row);
  }
}

// list: the union in slot order; out: [overflow, union size].
extern "C" void gt_global_probe_host(const int64_t* acc, int64_t n_nodes,
                                     int64_t capacity, int64_t k,
                                     int32_t* list, int64_t* out) {
  const gm::Mesh m = mesh_of(n_nodes, capacity);
  std::vector<int32_t> w(n_nodes, 0), t(n_nodes, 0), b(n_nodes, 0);
  int64_t size = 0;
  for (int64_t s = 0; s < capacity; ++s) {
    bool any = false;
    for (int64_t d = 0; d < n_nodes; ++d) {
      const bool wd = gm::window_at(m, acc, d, s);
      const bool td = gm::touch_at(m, acc, d, s);
      w[d] += wd;
      t[d] += td;
      any = any || wd || td;
    }
    if (any) {
      list[size++] = (int32_t)s;
      b[gm::owner_of(m, s)] += 1;
    }
  }
  out[0] = gm::overflow_of(w.data(), t.data(), b.data(), n_nodes, k) ? 1 : 0;
  out[1] = size;
}

// B.8d's two halves as the kernel runs them: every node's window first
// (the kernel's lanes), then the chain in node order (its lane 0), then
// the row to every replica and the accumulators zeroed.
extern "C" void gt_global_apply_host(int64_t* table, const int64_t* aux,
                                     int64_t* acc, int64_t n_nodes,
                                     int64_t capacity, const int32_t* list,
                                     int64_t count, int64_t now) {
  const gm::Mesh m = mesh_of(n_nodes, capacity);
  std::vector<gm::NodeAcc> accs(n_nodes);
  std::vector<gm::NodeWin> wins(n_nodes);
  int64_t row[gt::ROW_W], p[gm::AUX_ROWS];
  for (int64_t j = 0; j < count; ++j) {
    const int64_t s = list[j];
    owner_row(table, m, s, row);
    for (int64_t d = 0; d < n_nodes; ++d) {
      accs[d] = gm::node_acc(m, acc, d, s);
      if (accs[d].w[gm::ACC_COUNT] > 0) gm::node_aux(m, aux, d, s, p);
      wins[d] = gm::node_window(accs[d], p, now);
    }
    bool folded = false;
    for (const gm::NodeWin& w : wins) {
      if (w.kind == gm::WIN_NONE) continue;
      gm::chain_link(w.kind, w.prep, w.hits, now, row);
      folded = true;
    }
    gm::chain_end(folded, row);
    for (int64_t d = 0; d < n_nodes; ++d) {
      int64_t* dst = table + (d * m.capacity + s) * gt::ROW_W;
      for (int w = 0; w < gt::ROW_W; ++w) dst[w] = row[w];
      gm::node_zero(m, acc, d, s, accs[d]);
    }
  }
}
