// Breakdown probes of two kernels on one card: the quota-lease column
// window (B.9) and the GLOBAL mesh's sparse fold and install (B.8d), in
// the designs they had before their Hopper redesigns (one thread a lane
// and one thread a union slot, copied as they were), with stamped builds
// of both.  Built and driven by probes/lease_sparse_breakdown.py.
//
// B.9 (lease_prev): one thread a lane; the slot word first, the
// range test, then the budget, expiry and generation words, then (delta)
// the three column words, then the stores.  prev_lease runs it as the
// package ran it; with `rec` it runs the stamped copy, where lane 0 of
// every warp writes its clock64 after each step (slot word, lane words,
// column words, stores issued), its SM, and globaltimer at its start and
// end.  lease_variant runs the port's kernel (csrc/lease_apply.cu,
// included below) at a chosen block size, and apply_variant the port's
// B.8d (csrc/global_mesh.cu) at a chosen number of lanes a slot.
//
// B.8d (apply_prev): one thread a union slot, a grid sized to the
// engine's 2 n sparse_k slots whose threads past the union read the count
// word and exit; a thread loads the owner's row, reads node d's count
// for d = 0..n-1 and for each window its hits, RESET count and nine aux
// words, runs one whole transition, and last writes the row to the n
// replicas (16-B stores 128 B apart) and zeroes the accumulators.  The
// stamped copy writes, per union slot, its clock64 after the list word,
// the row, each count read, each window's loads and each transition, and
// after the stores are issued; per block, thread 0's globaltimer at its
// start and end and whether the block had a slot.  apply_stamped is a
// stamped copy of the port's B.8d (its group-a-slot design, below).
#include <cuda_runtime.h>
#include <stdint.h>

#include "global_mesh.cuh"

// The port's kernels, for their launch choices (each source's unnamed
// namespace inside a namespace of its own; their shared header first).
#include "sm_count.cuh"
namespace b9 {
#include "lease_apply.cu"
}
namespace b8 {
#include "global_mesh.cu"
}

namespace probe {

__device__ __forceinline__ uint64_t gtimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smid() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

// The cycle counter once `v` has arrived: the branch on it waits for the
// load that produced it, and the clock is read after the branch.
__device__ __forceinline__ uint64_t clk_after(int64_t v) {
  if (v == (int64_t)0x7eadbeefcafef00dLL) asm volatile("trap;");
  return (uint64_t)clock64();
}

constexpr int kThreads = 256;

// ---- B.9, the earlier design: one thread a lane ----
// A warp's record: globaltimer and clock at its start, clock after the
// slot word, after the lane words, after the column words (delta), after
// the stores are issued, its SM, and globaltimer at its end.
constexpr int REC9 = 8;

template <bool SET, bool PROBE>
__global__ void lease_prev(int64_t* __restrict__ budget,
                           int64_t* __restrict__ expire,
                           int32_t* __restrict__ gen, int64_t capacity,
                           const int64_t* __restrict__ lanes, int64_t n,
                           uint64_t* __restrict__ rec) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool stamp = PROBE && (threadIdx.x & 31) == 0;
  uint64_t* r = stamp ? rec + (j >> 5) * REC9 : nullptr;
  if (stamp) {
    r[0] = gtimer();
    r[1] = (uint64_t)clock64();
    r[6] = smid();
  }
  if (j >= n) return;
  int64_t s = __ldg(lanes + j);
  if (stamp) r[2] = clk_after(s);
  if (s < 0 || s >= capacity) return;
  int64_t b = __ldg(lanes + n + j);
  int64_t e = __ldg(lanes + 2 * n + j);
  int32_t g = (int32_t)__ldg(lanes + 3 * n + j);
  if (stamp) r[3] = clk_after(b ^ e ^ g);
  if (SET) {
    budget[s] = b;
    expire[s] = e;
    gen[s] = g;
    if (stamp) r[4] = r[3];
  } else {
    int64_t ob = budget[s];
    int64_t oe = expire[s];
    int32_t og = gen[s];
    if (stamp) r[4] = clk_after(ob ^ oe ^ og);
    int64_t nb = ob + b;
    budget[s] = nb > 0 ? nb : 0;
    expire[s] = e > oe ? e : oe;
    gen[s] = g > og ? g : og;
  }
  if (stamp) {
    r[5] = (uint64_t)clock64();
    r[7] = gtimer();
  }
}

// ---- B.8d, the earlier design: one thread a union slot ----
constexpr int RECD = 64;       // a union slot's record
constexpr int RECD_NODES = 16; // count stamps kept for nodes 0..15
constexpr int RECD_WINS = 16;  // window stamp pairs kept
enum {
  D_GSTART = 0, D_GEND = 1, D_C0 = 2, D_LIST = 3, D_ROW = 4, D_STORES = 5,
  D_WINS = 6, D_SMID = 7, D_COUNT = 8, D_WIN = 8 + RECD_NODES
};
constexpr int RECB = 4;        // a block's record: gstart, gend, work, smid

__device__ __forceinline__ void load_row(const int64_t* table, int64_t r,
                                         int64_t* row) {
  const longlong2* src =
      reinterpret_cast<const longlong2*>(table + r * gt::ROW_W);
#pragma unroll
  for (int v = 0; v < gt::ROW_W / 2; ++v) {
    longlong2 x = src[v];
    row[2 * v] = x.x;
    row[2 * v + 1] = x.y;
  }
}

__device__ __forceinline__ void store_row(int64_t* table, int64_t r,
                                          const int64_t* row) {
  longlong2* dst = reinterpret_cast<longlong2*>(table + r * gt::ROW_W);
#pragma unroll
  for (int v = 0; v < gt::ROW_W / 2; ++v) {
    dst[v] = make_longlong2(row[2 * v], row[2 * v + 1]);
  }
}

template <bool PROBE>
__global__ void apply_prev(int64_t* __restrict__ table,
                           const int64_t* __restrict__ aux,
                           int64_t* __restrict__ acc, gm::Mesh m,
                           const int32_t* __restrict__ list,
                           const int64_t* __restrict__ count, int64_t now,
                           uint64_t* __restrict__ srec,
                           uint64_t* __restrict__ brec) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  uint64_t* b = PROBE && threadIdx.x == 0 ? brec + blockIdx.x * RECB
                                          : nullptr;
  if (b) {
    b[0] = gtimer();
    b[3] = smid();
  }
  const uint64_t c0 = (uint64_t)clock64();
  const int64_t cnt = *count;
  if (j >= cnt) {
    if (b) b[1] = gtimer();
    return;
  }
  if (b) b[2] = 1;
  uint64_t* r = PROBE ? srec + j * RECD : nullptr;
  const int64_t s = list[j];
  if (PROBE) {
    r[D_GSTART] = b ? b[0] : gtimer();
    r[D_C0] = c0;
    r[D_LIST] = clk_after(s);
    r[D_SMID] = smid();
  }
  int64_t row[gt::ROW_W];
  load_row(table, gm::owner_of(m, s) * m.capacity + s, row);
  if (PROBE) {
    int64_t x = 0;
#pragma unroll
    for (int w = 0; w < gt::ROW_W; ++w) x ^= row[w];
    r[D_ROW] = clk_after(x);
  }
  int wins = 0;
  for (int64_t d = 0; d < m.n_nodes; ++d) {
    const int64_t c = acc[gm::acc_ix(m, d, gm::ACC_COUNT, s)];
    if (PROBE && d < RECD_NODES) r[D_COUNT + d] = clk_after(c);
    if (c <= 0) continue;
    int64_t p[gm::AUX_ROWS];
    for (int k = 0; k < gm::AUX_ROWS; ++k) p[k] = aux[gm::aux_ix(m, d, k, s)];
    const int64_t hits = acc[gm::acc_ix(m, d, gm::ACC_HITS, s)];
    const int64_t resets = acc[gm::acc_ix(m, d, gm::ACC_RESET, s)];
    if (PROBE && wins < RECD_WINS) {
      int64_t x = hits ^ resets;
      for (int k = 0; k < gm::AUX_ROWS; ++k) x ^= p[k];
      r[D_WIN + 2 * wins] = clk_after(x);
    }
    const bool havep = p[gm::A_STAMP] > 0;
    gm::apply_req(now,
                  gm::fold_req(hits, resets, p, havep, row,
                               havep ? p[gm::A_GREG_EXP] : 0,
                               havep ? p[gm::A_GREG_DUR] : 0, now),
                  row);
    if (PROBE && wins < RECD_WINS) {
      r[D_WIN + 2 * wins + 1] =
          clk_after(row[gt::W_REMAINING] ^ row[gt::W_REMAINING_F] ^
                    row[gt::W_EXPIRE_AT] ^ row[gt::W_STATUS]);
    }
    ++wins;
  }
  for (int64_t d = 0; d < m.n_nodes; ++d) {
    store_row(table, d * m.capacity + s, row);
#pragma unroll
    for (int k = 0; k < gm::ACC_ROWS; ++k) acc[gm::acc_ix(m, d, k, s)] = 0;
  }
  if (PROBE) {
    r[D_STORES] = (uint64_t)clock64();
    r[D_WINS] = (uint64_t)wins;
    r[D_GEND] = gtimer();
    if (b) b[1] = r[D_GEND];
  }
}

}  // namespace probe

extern "C" int prev_lease(int64_t* budget, int64_t* expire, int32_t* gen,
                          int64_t capacity, const int64_t* lanes, int64_t n,
                          int is_set, uint64_t* rec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      (unsigned)((n + probe::kThreads - 1) / probe::kThreads);
#define PREV_LEASE(S, P)                                               \
  probe::lease_prev<S, P><<<blocks, probe::kThreads, 0, st>>>(         \
      budget, expire, gen, capacity, lanes, n, rec)
  if (rec) {
    if (is_set) PREV_LEASE(true, true); else PREV_LEASE(false, true);
  } else {
    if (is_set) PREV_LEASE(true, false); else PREV_LEASE(false, false);
  }
#undef PREV_LEASE
  return (int)cudaGetLastError();
}

// Warps of a B.9 launch of n lanes (the stamped copy's records).
extern "C" int64_t prev_lease_warps(int64_t n) { return (n + 31) / 32; }

// ---- B.8d, the port's design, stamped ----
// A copy of csrc/global_mesh.cu apply_kernel<G> whose group lane 0
// writes, per union slot, the clock after each step: the list word, the
// group's accumulator words and the owner's row (one round trip), the aux
// words of the nodes with a window, the prepares (their terms in shared
// memory), the chain, the stores issued; globaltimer at its start and
// end, the windows folded and its SM.  A step's stamp waits for the whole
// warp's loads (a warp consumes a load in one instruction).
constexpr int RECS = 16;
enum {
  S_GSTART = 0, S_GEND = 1, S_C0 = 2, S_LIST = 3, S_ACC = 4, S_AUX = 5,
  S_PREP = 6, S_CHAIN = 7, S_STORES = 8, S_WINS = 9, S_SMID = 10
};

template <int G>
__global__ void __launch_bounds__(b8::kSparseThreads)
    apply_stamped(int64_t* __restrict__ table,
                  const int64_t* __restrict__ aux, int64_t* __restrict__ acc,
                  gm::Mesh m, const int32_t* __restrict__ list, int64_t count,
                  int64_t now, uint64_t* __restrict__ rec) {
  constexpr int kSlots = b8::kSparseThreads / G;
  __shared__ b8::SparseGroup<G> groups[kSlots];
  const int t = threadIdx.x, x = t % G;
  b8::SparseGroup<G>& S = groups[t / G];
  const int64_t j = (int64_t)blockIdx.x * kSlots + t / G;
  if (j >= count) return;
  uint64_t* r = rec + j * RECS;
  const uint64_t g0 = probe::gtimer(), c0 = (uint64_t)clock64();
  const unsigned mask = b8::group_mask<G>(t);
  const int64_t s = list[j];
  const uint64_t c_list = probe::clk_after(s);
  const int64_t n = m.n_nodes;
  longlong2* row_v = reinterpret_cast<longlong2*>(S.row);
  longlong2 v;
  if (x < gt::ROW_W / 2) {
    v = reinterpret_cast<const longlong2*>(
        table + (gm::owner_of(m, s) * m.capacity + s) * gt::ROW_W)[x];
  }
  gm::NodeAcc a;
  gm::NodeWin w;
  w.kind = gm::WIN_NONE;
  int64_t p[gm::AUX_ROWS];
  uint64_t c_acc = 0, c_aux = 0;
  if (x < n) a = gm::node_acc(m, acc, x, s);
  if (x < gt::ROW_W / 2) row_v[x] = v;
  c_acc = probe::clk_after(x < n ? a.w[0] ^ a.w[2] : 0);
  if (x < n && a.w[gm::ACC_COUNT] > 0) gm::node_aux(m, aux, x, s, p);
  c_aux = probe::clk_after(x < n && a.w[gm::ACC_COUNT] > 0 ? p[0] ^ p[8]
                                                           : 0);
  if (x < n) {
    w = gm::node_window(a, p, now);
    gm::node_zero(m, acc, x, s, a);
  }
  S.kind[x] = w.kind;
  S.hits[x] = w.hits;
  if (w.kind == gm::WIN_OWN) gt::put_prep(S.prep, G, x, w.prep);
  __syncwarp(mask);
  const uint64_t c_prep = (uint64_t)clock64();
  int64_t row[gt::ROW_W];
  int wins = 0;
  if (x == 0) {
#pragma unroll
    for (int k = 0; k < gt::ROW_W; ++k) row[k] = S.row[k];
    const int64_t span = n < G ? n : G;
    for (int i = 0; i < span; ++i) {
      const int8_t kind = S.kind[i];
      if (kind == gm::WIN_NONE) continue;
      gt::Prep own;
      if (kind == gm::WIN_OWN) own = gt::get_prep(S.prep, G, i);
      gm::chain_link(kind, own, S.hits[i], now, row);
      ++wins;
    }
    gm::chain_end(wins > 0, row);
#pragma unroll
    for (int k = 0; k < gt::ROW_W; ++k) S.row[k] = row[k];
  }
  __syncwarp(mask);
  const uint64_t c_chain = (uint64_t)clock64();
  for (int64_t i = x; i < n * (gt::ROW_W / 2); i += G) {
    const int64_t d = i / (gt::ROW_W / 2);
    reinterpret_cast<longlong2*>(table + (d * m.capacity + s) * gt::ROW_W)
        [i % (gt::ROW_W / 2)] = row_v[i % (gt::ROW_W / 2)];
  }
  __syncwarp(mask);
  if (x == 0) {
    r[S_GSTART] = g0;
    r[S_C0] = c0;
    r[S_LIST] = c_list;
    r[S_ACC] = c_acc;
    r[S_AUX] = c_aux;
    r[S_PREP] = c_prep;
    r[S_CHAIN] = c_chain;
    r[S_STORES] = (uint64_t)clock64();
    r[S_GEND] = probe::gtimer();
    r[S_WINS] = (uint64_t)wins;
    r[S_SMID] = probe::smid();
  }
}

// The stamped copy of the port's B.8d (up to 32 nodes) at `g` lanes a
// slot; `rec` holds RECS words a union slot.
extern "C" int apply_port_stamped(int64_t* table, const int64_t* aux,
                                  int64_t* acc, int64_t n_nodes,
                                  int64_t capacity, const int32_t* list,
                                  int64_t count, int64_t now, int g,
                                  uint64_t* rec, void* stream) {
  if (count <= 0 || n_nodes > 32) return count <= 0 ? 0 : -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const gm::Mesh m{n_nodes, capacity, capacity / n_nodes};
#define STAMPED(G)                                                        \
  apply_stamped<G><<<(unsigned)((count + b8::kSparseThreads / G - 1) /    \
                                (b8::kSparseThreads / G)),                \
                     b8::kSparseThreads, 0, st>>>(table, aux, acc, m, list, \
                                                  count, now, rec)
  if (g == 8) {
    STAMPED(8);
  } else if (g == 16) {
    STAMPED(16);
  } else {
    STAMPED(32);
  }
#undef STAMPED
  return (int)cudaGetLastError();
}

// The port's B.9 kernel at `threads` a block, on lease_records' records.
extern "C" int lease_variant(int64_t* records, int64_t capacity,
                             const int64_t* lanes, int64_t n, int is_set,
                             int threads, void* stream) {
  if (n <= 0) return 0;
  b9::launch(reinterpret_cast<longlong2*>(records), capacity, lanes, n,
             is_set, threads, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The port's B.8d at `g` lanes a union slot (8, 16 or 32).
extern "C" int apply_variant(int64_t* table, const int64_t* aux, int64_t* acc,
                             int64_t n_nodes, int64_t capacity,
                             const int32_t* list, int64_t count, int64_t now,
                             int g, void* stream) {
  if (count <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const gm::Mesh m{n_nodes, capacity, capacity / n_nodes};
  if (g == 8) {
    b8::launch_apply<8>(table, aux, acc, m, list, count, now, st);
  } else if (g == 16) {
    b8::launch_apply<16>(table, aux, acc, m, list, count, now, st);
  } else if (g == 32) {
    b8::launch_apply<32>(table, aux, acc, m, list, count, now, st);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// The earlier B.8d: a grid of max_slots threads, the union count read on the
// card; with `srec` / `brec` the stamped copy.
extern "C" int prev_apply(int64_t* table, const int64_t* aux, int64_t* acc,
                          int64_t n_nodes, int64_t capacity,
                          const int32_t* list, const int64_t* count,
                          int64_t max_slots, int64_t now, uint64_t* srec,
                          uint64_t* brec, void* stream) {
  if (max_slots <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const gm::Mesh m{n_nodes, capacity, capacity / n_nodes};
  const unsigned blocks =
      (unsigned)((max_slots + probe::kThreads - 1) / probe::kThreads);
  if (srec) {
    probe::apply_prev<true><<<blocks, probe::kThreads, 0, st>>>(
        table, aux, acc, m, list, count, now, srec, brec);
  } else {
    probe::apply_prev<false><<<blocks, probe::kThreads, 0, st>>>(
        table, aux, acc, m, list, count, now, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int64_t prev_apply_blocks(int64_t max_slots) {
  return (max_slots + probe::kThreads - 1) / probe::kThreads;
}
