// The tile body shared by the unique-slot tick kernels (fused_tick.cu and
// fused_ragged_tick.cu), and the layout the host build of their lane loop
// (fused_tick_host.cc) follows step by step.
//
// A block owns TILE consecutive lanes of the slot-sorted window and runs
// TILE_THREADS threads:
//
// 1. Stage.  Thread t < TILE loads lane t's 19 request words in one round
//    of loads, places the lane (`place`: its table row, or -1 for a lane
//    that touches no row) and stores the words into shared memory.  Then
//    the block copies the live rows into shared memory, 16 B a thread and
//    eight threads a 128-B row (cp.async), while it partitions.  Inert
//    lanes copy no row and answer zeros.
// 2. Partition.  Each warp ballots its live lanes by class
//    (transition.cuh algo_class) and the block lays the classes out one
//    after another, each starting on a warp boundary, lanes ascending
//    within a class (tile_class_starts).  TILE_THREADS leaves room for the
//    padding of every class, so each warp of step 3 runs one class's path.
// 3. Transition.  Thread t takes the lane at position t, runs
//    transition_class on its staged row and request, and writes the new
//    row over the staged one and its response into shared memory.
// 4. Write back.  The block stores the live rows in place, eight threads
//    a 128-B row (16-B stores), and the (6, n) response columns in lane
//    order, both coalesced.
//
// A tile of at most DIRECT_LANES lanes (a launch of a few lanes: the rank
// rounds) skips the four steps: each lane's thread loads its request and
// row into registers, ticks it and stores it, the shorter chain when
// there is nothing to share.
//
// The sizes are measured ones (PERF.md §6): 64-lane tiles beat 128 and
// 256 at every width from 17 lanes up (more SMs at mid widths, several
// blocks an SM to overlap at full width; 32 loses at full width to the
// warps the class padding adds), and the 16-B copies beat one 128-B bulk
// copy (cp.async.bulk on an mbarrier) a row below full width.
//
#pragma once

#include "transition.cuh"

namespace gt {

constexpr int TILE = 64;           // lanes a block owns
constexpr int TILE_WARPS = TILE / 32;
// Every class may leave up to 31 threads of padding at its warp's end.
constexpr int TILE_THREADS = 256;
static_assert(TILE + (N_CLASSES - 1) * 31 <= TILE_THREADS,
              "room for every live class to start on a warp boundary");
// A staged row takes 144 B: 16-B aligned (vector copies and stores) and
// spread over the banks.
constexpr int SROW_W = 18;
// Tiles this narrow run one thread a lane in registers (direct_lane).
constexpr int DIRECT_LANES = 8;

struct TileSmem {
  int64_t rows[TILE * SROW_W];
  int32_t req[REQ32_ROWS * TILE];
  int32_t resp[RESP_ROWS * TILE];
  int64_t row_of[TILE];
  int16_t perm[TILE_THREADS];  // lane at each position, -1 for padding
  int32_t counts[TILE_WARPS][N_CLASSES];
};

// First position of each live class: classes in order, each rounded up to
// a whole warp.  `totals` are the tile's live lanes of each class.
GT_HD void tile_class_starts(const int* totals, int* starts) {
  int at = 0;
  for (int c = 0; c < C_INERT; ++c) {
    starts[c] = at;
    at += (totals[c] + 31) & ~31;
  }
}

// Step 3 for the lane at position p of the tile: transition of its staged
// row and request; the new row replaces the staged one.
GT_HD void tile_lane(int64_t now, int64_t* rows, const int32_t* req,
                     int32_t* resp, int p) {
  Req r = load_req(req, TILE, p);
  int64_t* s = rows + p * SROW_W;
  int64_t o[ROW_W];
  Resp q = transition_class(algo_class(r.algorithm), now, s, r, o);
  for (int w = 0; w < ROW_W; ++w) s[w] = o[w];
  store_resp(resp, TILE, p, q, true);
}

#if defined(__CUDACC__)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One lane of a narrow tile, in registers: load the row, tick, store.
__device__ __forceinline__ void direct_lane(int64_t* __restrict__ table,
                                            int32_t* __restrict__ resp,
                                            int64_t ld_r, int64_t j,
                                            int64_t now, int64_t row,
                                            const Req& r) {
  Resp q{};
  if (row >= 0) {
    int64_t s[ROW_W], o[ROW_W];
    const longlong2* src =
        reinterpret_cast<const longlong2*>(table + row * ROW_W);
#pragma unroll
    for (int v = 0; v < ROW_W / 2; ++v) {
      longlong2 x = src[v];
      s[2 * v] = x.x;
      s[2 * v + 1] = x.y;
    }
    q = transition_class(algo_class(r.algorithm), now, s, r, o);
    longlong2* dst = reinterpret_cast<longlong2*>(table + row * ROW_W);
#pragma unroll
    for (int v = 0; v < ROW_W / 2; ++v) {
      dst[v] = make_longlong2(o[2 * v], o[2 * v + 1]);
    }
  }
  store_resp(resp, ld_r, j, q, row >= 0);
}

// The tile body; `place(j, slot, valid)` gives lane j's table row or -1.
template <class Place>
__device__ __forceinline__ void tile_tick(int64_t* __restrict__ table,
                                          const int32_t* __restrict__ m32,
                                          int64_t ld_m,
                                          int32_t* __restrict__ resp,
                                          int64_t ld_r, int64_t lanes,
                                          int64_t now, Place place) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int n = (int)(lanes - base < TILE ? lanes - base : TILE);
  if (n <= DIRECT_LANES) {
    if (t < n) {
      Req r = load_req(m32, ld_m, base + t);
      direct_lane(table, resp, ld_r, base + t, now,
                  place(base + t, r.slot, r.valid), r);
    }
    return;
  }
  __shared__ __align__(16) TileSmem S;
  S.perm[t] = -1;

  // 1. Stage: the lane's request words in one round of loads, into shared
  // memory, and its placement.
  int cls = C_INERT, rank = 0;
  if (t < TILE) {
    int64_t row = -1;
    if (t < n) {
      const int32_t* col = m32 + base + t;
      int32_t v[REQ32_ROWS];
#pragma unroll
      for (int k = 0; k < REQ32_ROWS; ++k) v[k] = col[k * ld_m];
      row = place(base + t, v[R_SLOT], v[R_VALID]);
      if (row >= 0) cls = algo_class(v[R_ALGORITHM]);
#pragma unroll
      for (int k = 0; k < REQ32_ROWS; ++k) S.req[k * TILE + t] = v[k];
    }
    S.row_of[t] = row;
#pragma unroll
    for (int k = 0; k < RESP_ROWS; ++k) S.resp[k * TILE + t] = 0;

    // 2. Partition: per-warp class counts and each lane's rank.
#pragma unroll
    for (int c = 0; c < C_INERT; ++c) {
      unsigned b = __ballot_sync(0xffffffffu, cls == c);
      if (lane == 0) S.counts[warp][c] = __popc(b);
      if (cls == c) rank = __popc(b & ((1u << lane) - 1u));
    }
  }
  __syncthreads();

  // The live rows' copies into shared memory: 16 B a thread, eight
  // threads a 128-B row, in flight while the block partitions.
  for (int k = t; k < TILE * (ROW_W / 2); k += TILE_THREADS) {
    const int q = k >> 3, vec = k & 7;
    const int64_t row = S.row_of[q];
    if (row >= 0) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(S.rows + q * SROW_W + 2 * vec)),
                   "l"(table + row * ROW_W + 2 * vec)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (cls != C_INERT) {
    // tile_class_starts for the lane's own class, plus the lanes of its
    // class in the warps before it.
    int at = 0, before = 0;
    for (int c = 0; c < cls; ++c) {
      int total = 0;
      for (int w = 0; w < TILE_WARPS; ++w) total += S.counts[w][c];
      at += (total + 31) & ~31;
    }
    for (int w = 0; w < warp; ++w) before += S.counts[w][cls];
    S.perm[at + before + rank] = (int16_t)t;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 3. Transition.
  const int p = S.perm[t];
  if (p >= 0) tile_lane(now, S.rows, S.req, S.resp, p);
  __syncthreads();

  // 4. Write back: live rows in place, then the response columns.
  for (int k = t; k < TILE * (ROW_W / 2); k += TILE_THREADS) {
    const int q = k >> 3, vec = k & 7;
    const int64_t row = S.row_of[q];
    if (row >= 0) {
      reinterpret_cast<longlong2*>(table + row * ROW_W)[vec] =
          reinterpret_cast<const longlong2*>(S.rows + q * SROW_W)[vec];
    }
  }
  for (int k = t; k < RESP_ROWS * TILE; k += TILE_THREADS) {
    const int w = k / TILE, i = k - w * TILE;
    if (i < n) resp[w * ld_r + base + i] = S.resp[k];
  }
}

// Launch one block per TILE lanes on `stream`; returns the cudaError_t.
template <class Kernel, class... Args>
int launch_tiles(Kernel kernel, int64_t lanes, void* stream, Args... args) {
  if (lanes > 0) {
    int64_t blocks = (lanes + TILE - 1) / TILE;
    kernel<<<(unsigned)blocks, TILE_THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(args...);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace gt
