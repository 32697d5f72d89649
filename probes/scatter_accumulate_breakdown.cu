// Breakdown probes of two kernels on one card: the row scatter (B.2
// scatter) and the GLOBAL mesh's accumulate (B.8a), in the designs they
// had before their Hopper redesigns (copied as they were), with stamped
// copies of both, and the port's kernels at other launch shapes.  Built
// and driven by probes/scatter_accumulate_breakdown.py.
//
// B.2 scatter (scatter_prev): one thread a 16-B vector; thread t divides
// t by the row's vector count in 64 bits, loads its row's slot itself,
// and after the range test loads its vector of the source row and stores
// it.  prev_scatter runs it as the package ran it; with `rec` it runs the
// stamped copy, where lane 0 of every warp writes its clock64 after each
// step (the slot word, the source vector, the store issued), its SM, and
// globaltimer at its start and end.
//
// B.8a (accumulate_prev): one thread a lane in 256-thread blocks; the
// lane's 19 words and its successor's slot and valid words, node and slot
// by 64-bit divisions (and the owner by a third), the tail lane's nine aux
// words, then the queued lane's hits, RESET and count atomics and with
// track_touch its touch atomic, each lane its own.  The stamped copy
// writes, per warp (lane 0), the clock after the column loads, after the
// divisions, after the aux stores and after the atomics are issued, its
// SM, and globaltimer at its start and end.
//
// Variants of the port's kernels (scatter_variant, accumulate_variant):
// the scatter at 8 rows a warp (the gather's), with plain stores
// (write-back, as the earlier design stored), and as a persistent grid-stride
// walk; the accumulate at 256-thread blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "global_mesh.cuh"
#include "sm_count.cuh"

// The port's kernels (each source's unnamed namespace inside a namespace
// of its own; their shared headers first).
namespace b2 {
#include "rows.cu"
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
constexpr unsigned kFull = 0xffffffffu;

// A warp's record (both kernels): globaltimer and clock at its start, the
// clocks after its steps (REC_STEP0.. in the kernel's order), its SM, and
// globaltimer at its end.
constexpr int REC = 8;
enum { R_GSTART = 0, R_C0 = 1, R_STEP0 = 2, R_SMID = 6, R_GEND = 7 };

// ---- B.2 scatter, the earlier design: one thread a 16-B vector ----
// Steps: the slot word, the source vector, the store issued.
template <bool PROBE>
__global__ void scatter_prev(longlong2* __restrict__ table, int64_t capacity,
                             const int64_t* __restrict__ slots,
                             const longlong2* __restrict__ rows, int64_t n,
                             int nvec, uint64_t* __restrict__ rec) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool stamp = PROBE && (threadIdx.x & 31) == 0;
  uint64_t* r = stamp ? rec + (t >> 5) * REC : nullptr;
  if (stamp) {
    r[R_GSTART] = gtimer();
    r[R_C0] = (uint64_t)clock64();
    r[R_SMID] = smid();
  }
  if (t >= n * nvec) return;
  int64_t j = t / nvec;
  int v = (int)(t - j * nvec);
  int64_t s = slots[j];
  if (stamp) r[R_STEP0] = clk_after(s);
  if (s < 0 || s >= capacity) {
    if (stamp) r[R_GEND] = gtimer();
    return;  // guard row: dropped
  }
  const longlong2 x = rows[t];
  if (stamp) r[R_STEP0 + 1] = clk_after(x.x ^ x.y);
  table[s * nvec + v] = x;
  if (stamp) {
    r[R_STEP0 + 2] = (uint64_t)clock64();
    r[R_GEND] = gtimer();
  }
}

// ---- B.8a, the earlier design: one thread a lane ----
struct PrevLane {
  int64_t d, s;
  bool live, tail, queue, reset;
  gt::Req r;
};

// global_mesh.cuh's lane_at as it was: node, slot and owner by 64-bit
// divisions.
__device__ __forceinline__ PrevLane prev_lane_at(const int32_t* m32,
                                                 int64_t ld, int64_t lanes,
                                                 int64_t j, const gm::Mesh& m) {
  PrevLane l;
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
  const bool owned = gm::owner_of(m, l.s) == l.d;
  l.queue = l.live && !owned && l.r.hits != 0;
  l.reset = l.queue && (l.r.behavior & gt::RESET_REMAINING) != 0;
  return l;
}

// The same lane from words already loaded (the stamped copy's split of
// the loads from the arithmetic).
__device__ __forceinline__ PrevLane prev_lane_from(const gt::Req& q,
                                                   bool next_same_raw,
                                                   const gm::Mesh& m) {
  PrevLane l;
  l.r = q;
  const int64_t flat = q.slot;
  l.live = q.valid != 0 && flat >= 0 && flat < m.n_nodes * m.capacity;
  l.d = l.live ? flat / m.capacity : 0;
  l.s = l.live ? flat - l.d * m.capacity : 0;
  l.tail = l.live && !next_same_raw;
  const bool owned = gm::owner_of(m, l.s) == l.d;
  l.queue = l.live && !owned && q.hits != 0;
  l.reset = l.queue && (q.behavior & gt::RESET_REMAINING) != 0;
  return l;
}

__device__ __forceinline__ void atomic_add64(int64_t* p, int64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v);
}

// Steps: the column loads, the divisions, the aux stores issued, the
// atomics issued.
template <bool PROBE>
__global__ void accumulate_prev(const int32_t* __restrict__ m32, int64_t ld,
                                int64_t lanes, int64_t* __restrict__ aux,
                                int64_t* __restrict__ acc, gm::Mesh m,
                                int64_t stamp, int track_touch,
                                uint64_t* __restrict__ rec) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool st = PROBE && (threadIdx.x & 31) == 0;
  uint64_t* r = st ? rec + (j >> 5) * REC : nullptr;
  if (st) {
    r[R_GSTART] = gtimer();
    r[R_C0] = (uint64_t)clock64();
    r[R_SMID] = smid();
  }
  if (j >= lanes) return;
  PrevLane l;
  if (PROBE) {
    // The loads of lane_at, waited for, then its arithmetic.
    l.r = gt::load_req(m32, ld, j);
    int32_t ns = 0, nv = 0;
    if (j + 1 < lanes) {
      ns = m32[gt::R_SLOT * ld + j + 1];
      nv = m32[gt::R_VALID * ld + j + 1];
    }
    if (st) {
      r[R_STEP0] = clk_after(l.r.slot ^ l.r.hits ^ l.r.limit ^ l.r.duration ^
                             l.r.created_at ^ l.r.burst ^ l.r.greg_exp ^
                             l.r.greg_dur ^ l.r.known ^ l.r.algorithm ^
                             l.r.behavior ^ l.r.valid ^ ns ^ nv);
    }
    l = prev_lane_from(l.r, ns == l.r.slot && nv != 0, m);
    if (st) r[R_STEP0 + 1] = clk_after(l.d ^ l.s ^ (int64_t)l.queue);
  } else {
    l = prev_lane_at(m32, ld, lanes, j, m);
  }
  if (!l.live) {
    if (st) r[R_GEND] = gtimer();
    return;
  }
  if (l.tail) {
#pragma unroll
    for (int k = 0; k < gm::AUX_ROWS; ++k) {
      const gt::Req& q = l.r;
      const int64_t w = k == gm::A_LIMIT        ? q.limit
                      : k == gm::A_DURATION     ? q.duration
                      : k == gm::A_ALGORITHM    ? (int64_t)q.algorithm
                      : k == gm::A_BEHAVIOR     ? (int64_t)q.behavior
                      : k == gm::A_BURST        ? q.burst
                      : k == gm::A_GREG_EXP     ? q.greg_exp
                      : k == gm::A_GREG_DUR     ? q.greg_dur
                      : k == gm::A_CREATED_AT   ? q.created_at
                                                : stamp;
      aux[gm::aux_ix(m, l.d, k, l.s)] = w;
    }
  }
  if (st) r[R_STEP0 + 2] = (uint64_t)clock64();
  if (l.queue) {
    atomic_add64(acc + gm::acc_ix(m, l.d, gm::ACC_HITS, l.s), l.r.hits);
    if (l.reset) atomic_add64(acc + gm::acc_ix(m, l.d, gm::ACC_RESET, l.s), 1);
    atomic_add64(acc + gm::acc_ix(m, l.d, gm::ACC_COUNT, l.s), 1);
  }
  if (track_touch) {
    atomic_add64(acc + gm::acc_ix(m, l.d, gm::ACC_TOUCH, l.s), 1);
  }
  if (st) {
    r[R_STEP0 + 3] = (uint64_t)clock64();
    r[R_GEND] = gtimer();
  }
}

// ---- Variants of the port's scatter (csrc/rows.cu), 16-word rows ----
// ROWS rows a warp (lanes below ROWS load the slots), STREAM streaming
// stores (st.global.cs), and a grid-stride walk when the grid is smaller
// than the work; ZERO stores zero rows (no source).
template <int ROWS, bool STREAM, bool ZERO>
__global__ void __launch_bounds__(kThreads)
    scatter_var(int4* __restrict__ table, int64_t capacity,
                const int64_t* __restrict__ slots,
                const int4* __restrict__ rows, int64_t n) {
  constexpr int NVEC = 8, UNROLL = ROWS * NVEC / 32;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t step = (int64_t)gridDim.x * (kThreads / 32) * ROWS;
  for (int64_t base = warp * ROWS; base < n; base += step) {
    const int nrows = n - base < ROWS ? (int)(n - base) : ROWS;
    const int64_t s = lane < nrows ? __ldg(slots + base + lane) : capacity;
    const int total = nrows * NVEC;
    int4 val[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int v = k * 32 + lane;
      val[k] = make_int4(0, 0, 0, 0);
      if (!ZERO && v < total) val[k] = __ldg(rows + base * NVEC + v);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int v = k * 32 + lane;
      const int64_t sr = __shfl_sync(kFull, s, (v / NVEC) & 31);
      if (v < total && sr >= 0 && sr < capacity) {
        int4* dst = table + sr * NVEC + (v % NVEC);
        if (STREAM) {
          __stcs(dst, val[k]);
        } else {
          *dst = val[k];
        }
      }
    }
  }
}

template <int ROWS, bool STREAM>
void launch_var(int4* table, int64_t capacity, const int64_t* slots,
                const int4* rows, int64_t n, unsigned blocks,
                cudaStream_t st) {
  if (rows == nullptr) {
    scatter_var<ROWS, STREAM, true><<<blocks, kThreads, 0, st>>>(
        table, capacity, slots, nullptr, n);
  } else {
    scatter_var<ROWS, STREAM, false><<<blocks, kThreads, 0, st>>>(
        table, capacity, slots, rows, n);
  }
}

}  // namespace probe

// The port's scatter design at another launch shape, 16-word rows (rows
// null: zero rows): kind 0, 8 rows a warp; 1, plain stores; 2, a
// persistent grid-stride walk (8 blocks an SM).
extern "C" int scatter_variant(int64_t* table, int64_t capacity,
                               const int64_t* slots, int64_t n,
                               const int64_t* rows, int kind, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4* t = reinterpret_cast<int4*>(table);
  const int4* r = reinterpret_cast<const int4*>(rows);
  auto blocks = [n](int rows_a_warp) {
    const int64_t per_block = (int64_t)rows_a_warp * (probe::kThreads / 32);
    return (unsigned)((n + per_block - 1) / per_block);
  };
  if (kind == 0) {
    probe::launch_var<8, true>(t, capacity, slots, r, n, blocks(8), st);
  } else if (kind == 1) {
    probe::launch_var<16, false>(t, capacity, slots, r, n, blocks(16), st);
  } else if (kind == 2) {
    const unsigned grid = (unsigned)(8 * sm_count());
    probe::launch_var<16, true>(t, capacity, slots, r, n,
                                grid < blocks(16) ? grid : blocks(16), st);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// The port's B.8a at `threads` a block.
extern "C" int accumulate_variant(const int32_t* m32, int64_t ld,
                                  int64_t lanes, int64_t* aux, int64_t* acc,
                                  int64_t n_nodes, int64_t capacity,
                                  int64_t stamp, int track_touch, int threads,
                                  void* stream) {
  if (lanes <= 0) return 0;
  const gm::Mesh m{n_nodes, capacity, capacity / n_nodes};
  b8::launch_accumulate(m32, ld, lanes, aux, acc, m, stamp, track_touch,
                        threads, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The earlier scatter (rows non-null); with `rec` its stamped copy.
extern "C" int prev_scatter(int64_t* table, int64_t capacity,
                            int64_t row_words, const int64_t* slots,
                            int64_t n, const int64_t* rows, uint64_t* rec,
                            void* stream) {
  const int nvec = (int)(row_words / 2);
  if (n <= 0) return 0;
  const unsigned blocks =
      (unsigned)((n * nvec + probe::kThreads - 1) / probe::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  longlong2* t = reinterpret_cast<longlong2*>(table);
  const longlong2* r = reinterpret_cast<const longlong2*>(rows);
  if (rec) {
    probe::scatter_prev<true><<<blocks, probe::kThreads, 0, st>>>(
        t, capacity, slots, r, n, nvec, rec);
  } else {
    probe::scatter_prev<false><<<blocks, probe::kThreads, 0, st>>>(
        t, capacity, slots, r, n, nvec, nullptr);
  }
  return (int)cudaGetLastError();
}

// Warps of the earlier scatter's launch (its stamped copy's records).
extern "C" int64_t prev_scatter_warps(int64_t n, int64_t row_words) {
  return (n * (row_words / 2) + 31) / 32;
}

// The earlier accumulate; with `rec` its stamped copy.
extern "C" int prev_accumulate(const int32_t* m32, int64_t ld, int64_t lanes,
                               int64_t* aux, int64_t* acc, int64_t n_nodes,
                               int64_t capacity, int64_t stamp,
                               int track_touch, uint64_t* rec, void* stream) {
  if (lanes <= 0) return 0;
  const gm::Mesh m{n_nodes, capacity, capacity / n_nodes};
  const unsigned blocks =
      (unsigned)((lanes + probe::kThreads - 1) / probe::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rec) {
    probe::accumulate_prev<true><<<blocks, probe::kThreads, 0, st>>>(
        m32, ld, lanes, aux, acc, m, stamp, track_touch, rec);
  } else {
    probe::accumulate_prev<false><<<blocks, probe::kThreads, 0, st>>>(
        m32, ld, lanes, aux, acc, m, stamp, track_touch, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int64_t prev_accumulate_warps(int64_t lanes) {
  return ((lanes + probe::kThreads - 1) / probe::kThreads) * probe::kThreads /
         32;
}
