// The tile body shared by the tick kernels (fused_tick.cu,
// fused_ragged_tick.cu and fused_merged_tick.cu), and the layout the host
// build of their lane loop (fused_tick_host.cc) follows step by step.
//
// A block owns TILE consecutive lanes of the slot-sorted window and runs
// TILE_THREADS threads:
//
// 1. Stage.  Thread t < TILE loads lane t's 19 request words in one round
//    of loads, with what its output policy stages beside them (`Out::stage`:
//    the merged tick's group size), places the lane (`place`: its table
//    row, or -1 for a lane that touches no row) and stores the words into
//    shared memory.  Then the block copies the live rows into shared
//    memory, 16 B a thread and eight threads a 128-B row (cp.async), while
//    it partitions.  Inert lanes copy no row and answer zeros.
// 2. Partition.  Each warp ballots its live lanes by class
//    (transition.cuh algo_class) and the block lays the classes out one
//    after another, each starting on a warp boundary, lanes ascending
//    within a class (tile_class_starts).  TILE_THREADS leaves room for the
//    padding of every class, so each warp of step 3 runs one class's path.
// 3. Transition.  Thread t takes the lane at position t and runs its
//    policy's `tick` on the staged row and request: transition_class (and
//    for the merged tick the duplicate fold) in place on the staged row,
//    the lane's output into shared memory.
// 4. Write back.  The block stores the live rows in place, eight threads
//    a 128-B row (16-B stores), and its policy writes the outputs in lane
//    order (`Out::write`), both coalesced.
//
// A tile of at most DIRECT_LANES lanes (a launch of a few lanes: the rank
// rounds) skips the four steps: each lane's thread loads its request and
// row into registers, ticks it and stores it (`Out::direct`), the shorter
// chain when there is nothing to share.
//
// Output policies: RespOut, the unique ticks' (6, B) response columns;
// MergedOut, the merged tick's group sizes in and its (U, 24) MERGED24
// journal rows out.  Their step-3, step-4 and narrow-path code is host
// and device code alike, so the host build runs the kernels' own lane
// code; only the staging copies, ballots and barriers are the card's.
//
// The sizes are measured ones (PERF.md §6): 64-lane tiles beat 128 and
// 256 at every width from 17 lanes up (more SMs at mid widths, several
// blocks an SM to overlap at full width; 32 loses at full width to the
// warps the class padding adds, and wins only 1-3% for the merged tick
// at 512-8192 heads, so all three ticks keep one size), and the 16-B
// copies beat one 128-B bulk copy (cp.async.bulk on an mbarrier) a row
// below full width.
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
// Tiles this narrow run one thread a lane in registers (Out::direct).
constexpr int DIRECT_LANES = 8;

template <class OutSmem>
struct TileSmem {
  int64_t rows[TILE * SROW_W];
  int32_t req[REQ32_ROWS * TILE];
  OutSmem out;
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

#if defined(__CUDA_ARCH__)
#define GT_UNROLL _Pragma("unroll")
#else
#define GT_UNROLL
#endif

// 16 bytes from memory at `src` to memory at `dst`, both 16-B aligned:
// one vector load and store on the card.
GT_HD void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
#else
  __builtin_memcpy(dst, src, 16);
#endif
}

// Four words of a register array to 16-B aligned `dst`, one vector store.
GT_HD void store4(int32_t* dst, const int32_t* w) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<int4*>(dst) = make_int4(w[0], w[1], w[2], w[3]);
#else
  __builtin_memcpy(dst, w, 16);
#endif
}

// A 128-B table row into registers and back, eight 16-B loads or stores.
GT_HD void load_row(const int64_t* src, int64_t* s) {
  GT_UNROLL
  for (int v = 0; v < ROW_W / 2; ++v) {
#if defined(__CUDA_ARCH__)
    longlong2 x = reinterpret_cast<const longlong2*>(src)[v];
    s[2 * v] = x.x;
    s[2 * v + 1] = x.y;
#else
    s[2 * v] = src[2 * v];
    s[2 * v + 1] = src[2 * v + 1];
#endif
  }
}
GT_HD void store_row(int64_t* dst, const int64_t* o) {
  GT_UNROLL
  for (int v = 0; v < ROW_W / 2; ++v) {
#if defined(__CUDA_ARCH__)
    reinterpret_cast<longlong2*>(dst)[v] =
        make_longlong2(o[2 * v], o[2 * v + 1]);
#else
    dst[2 * v] = o[2 * v];
    dst[2 * v + 1] = o[2 * v + 1];
#endif
  }
}

// The unique ticks' placement: slot_row.
struct SlotPlace {
  int64_t capacity;
  GT_HD int64_t operator()(int64_t, int64_t slot, int64_t valid) const {
    return slot_row(capacity, slot, valid);
  }
};

// ---- output policies ----
//
// stage(S, t, j): step 1 for tile lane t, j its window lane (-1 past the
//   window's end); runs for every t < TILE before the lane is placed.
// tick(S, now, s, r, p): step 3 for the lane at tile position p, its
//   staged row `s` (replaced by the new row) and request `r`.
// write(S, t, step, base, n): step 4 for thread t of `step` threads, the
//   tile's first lane `base` and its `n` lanes.
// direct(table, j, row, r, now): window lane j alone in registers, `row`
//   its table row or -1.

// The unique ticks' (6, B) compact response columns, leading dimension
// ld_r.
struct RespOut {
  int32_t* __restrict__ resp;
  int64_t ld_r;
  struct Smem {
    int32_t resp[RESP_ROWS * TILE];
  };
  GT_HD void stage(Smem& S, int t, int64_t) const {
    for (int k = 0; k < RESP_ROWS; ++k) S.resp[k * TILE + t] = 0;
  }
  GT_HD void tick(Smem& S, int64_t now, int64_t* s, const Req& r,
                  int p) const {
    Resp q = transition_class(algo_class(r.algorithm), now, r, s);
    store_resp(S.resp, TILE, p, q, true);
  }
  GT_HD void write(const Smem& S, int t, int step, int64_t base,
                   int n) const {
    for (int k = t; k < RESP_ROWS * TILE; k += step) {
      const int w = k / TILE, i = k - w * TILE;
      if (i < n) resp[w * ld_r + base + i] = S.resp[k];
    }
  }
  GT_HD void direct(int64_t* table, int64_t j, int64_t row, const Req& r,
                    int64_t now) const {
    Resp q{};
    if (row >= 0) {
      int64_t s[ROW_W];
      load_row(table + row * ROW_W, s);
      q = transition_class(algo_class(r.algorithm), now, r, s);
      store_row(table + row * ROW_W, s);
    }
    store_resp(resp, ld_r, j, q, row >= 0);
  }
};

// A staged journal row takes 112 B: 16-B aligned, and eight threads'
// 16-B stores at one offset of eight consecutive rows hit eight different
// 16-B bank groups (a 96-B stride would put two on each).
constexpr int SJOURNAL_W = 28;

// The merged tick's group sizes `count` (U,) and its (U, 24) MERGED24
// journal, 16-B aligned rows: the fold after the transition, and one
// journal row a head (zeros for an inert head).
struct MergedOut {
  const int32_t* __restrict__ count;
  int32_t* __restrict__ journal;
  struct Smem {
    alignas(16) int32_t journal[TILE * SJOURNAL_W];
    int32_t count[TILE];
  };
  GT_HD void stage(Smem& S, int t, int64_t j) const {
    S.count[t] = j >= 0 ? count[j] : 0;
    const int32_t zero[4] = {0, 0, 0, 0};
    GT_UNROLL
    for (int v = 0; v < MERGED24_W / 4; ++v) {
      store4(S.journal + t * SJOURNAL_W + 4 * v, zero);
    }
  }
  GT_HD void tick(Smem& S, int64_t now, int64_t* s, const Req& r,
                  int p) const {
    Resp q = transition_class(algo_class(r.algorithm), now, r, s);
    MergedHead mh = merged_fold(now, s, r, S.count[p]);
    int32_t jw[MERGED24_W];
    merged24_words(jw, q, mh, r, true);
    GT_UNROLL
    for (int v = 0; v < MERGED24_W / 4; ++v) {
      store4(S.journal + p * SJOURNAL_W + 4 * v, jw + 4 * v);
    }
  }
  // The tile's n journal rows are one contiguous run of n * 96 B.
  GT_HD void write(const Smem& S, int t, int step, int64_t base,
                   int n) const {
    constexpr int V = MERGED24_W / 4;
    for (int k = t; k < n * V; k += step) {
      const int i = k / V, v = k - i * V;
      copy16(journal + (base + i) * MERGED24_W + 4 * v,
             S.journal + i * SJOURNAL_W + 4 * v);
    }
  }
  GT_HD void direct(int64_t* table, int64_t j, int64_t row, const Req& r,
                    int64_t now) const {
    Resp q{};
    MergedHead mh{};
    if (row >= 0) {
      int64_t s[ROW_W];
      load_row(table + row * ROW_W, s);
      q = transition_class(algo_class(r.algorithm), now, r, s);
      mh = merged_fold(now, s, r, count[j]);
      store_row(table + row * ROW_W, s);
    }
    int32_t jw[MERGED24_W];
    merged24_words(jw, q, mh, r, row >= 0);
    GT_UNROLL
    for (int v = 0; v < MERGED24_W / 4; ++v) {
      store4(journal + j * MERGED24_W + 4 * v, jw + 4 * v);
    }
  }
};

#if defined(__CUDACC__)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The tile body; `place(j, slot, valid)` gives lane j's table row or -1,
// `out` is the output policy.
template <class Place, class Out>
__device__ __forceinline__ void tile_tick(int64_t* __restrict__ table,
                                          const int32_t* __restrict__ m32,
                                          int64_t ld_m, int64_t lanes,
                                          int64_t now, Place place,
                                          Out out) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int n = (int)(lanes - base < TILE ? lanes - base : TILE);
  if (n <= DIRECT_LANES) {
    if (t < n) {
      Req r = load_req(m32, ld_m, base + t);
      out.direct(table, base + t, place(base + t, r.slot, r.valid), r, now);
    }
    return;
  }
  __shared__ __align__(16) TileSmem<typename Out::Smem> S;
  S.perm[t] = -1;

  // 1. Stage: the lane's request words in one round of loads, with its
  // policy's inputs, into shared memory, and its placement.
  int cls = C_INERT, rank = 0;
  if (t < TILE) {
    int64_t row = -1;
    if (t < n) {
      const int32_t* col = m32 + base + t;
      int32_t v[REQ32_ROWS];
#pragma unroll
      for (int k = 0; k < REQ32_ROWS; ++k) v[k] = col[k * ld_m];
      out.stage(S.out, t, base + t);
      row = place(base + t, v[R_SLOT], v[R_VALID]);
      if (row >= 0) cls = algo_class(v[R_ALGORITHM]);
#pragma unroll
      for (int k = 0; k < REQ32_ROWS; ++k) S.req[k * TILE + t] = v[k];
    } else {
      out.stage(S.out, t, -1);
    }
    S.row_of[t] = row;

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
  if (p >= 0) {
    out.tick(S.out, now, S.rows + p * SROW_W, load_req(S.req, TILE, p), p);
  }
  __syncthreads();

  // 4. Write back: live rows in place, then the policy's outputs.
  for (int k = t; k < TILE * (ROW_W / 2); k += TILE_THREADS) {
    const int q = k >> 3, vec = k & 7;
    const int64_t row = S.row_of[q];
    if (row >= 0) {
      copy16(table + row * ROW_W + 2 * vec, S.rows + q * SROW_W + 2 * vec);
    }
  }
  out.write(S.out, t, TILE_THREADS, base, n);
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
