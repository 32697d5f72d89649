// The GLOBAL mesh's device programs for Hopper (sm_90a): kernels B.8a-B.8d.
//
// Replace the XLA programs of gubernator_tpu/parallel/global_mesh.py on
// one card, where the mesh's n nodes are n replicas in one row table
// (global_mesh.cuh has the buffers and the per-slot steps):
//
//   B.8a accumulate (the tail of make_global_process_fn, :213-246): per
//        sorted lane of a process window, the last lane of a slot writes
//        its node's 9 aux words, a queued lane (a hit on a slot its node
//        does not own) adds its hits, its RESET bit and 1 into its node's
//        accumulators, and with track_touch every live lane adds 1 to its
//        touch count.  64-bit atomics: negative hits wrap as XLA's add.
//        Bound: bytes, 76 B a lane in and a tail's 72 B of aux words out,
//        far below a launch (~0.1 us for global_mesh_8's 2048 lanes).  In
//        256-thread blocks that window ran on 8 SMs, a warp's chain its
//        column loads, two 64-bit divisions (~0.31 us), nine aux stores
//        eight warps an SM and an atomic a word a lane (PERF.md §6).  So a
//        thread issues its lane's 19 words and its successor's slot and
//        valid words together, takes node, slot and owner by 32-bit
//        division (lane_at), and blocks are as small as spreads the
//        window over the SMs (32 to 256 threads, as B.9's); a warp merges
//        each run of one flattened slot in registers (a segmented scan by
//        shuffles of its hits and of its queued, RESET and touch counts
//        packed in one word) and only the run's last lane in the warp
//        issues the atomics.
//   B.8b dense reconcile (make_global_reconcile_fn, :577-687): per slot,
//        the owner's row, the stamp winner's parameters, every node's
//        window folded in node order (or summed), the row written to all
//        n replicas and every node's accumulators zeroed.  Bound: bytes,
//        capacity x (128 + 8n + 128n + 32n) B and the folded windows'
//        words (PERF.md §6).  A thread a slot moving its rows as 16-B
//        vectors 128 B apart (32 rows an instruction, n + 1 times) ran at
//        a third of that on this card; so a block takes a tile of 256
//        consecutive slots: the owners' rows (contiguous within a slice)
//        come into shared memory by coalesced 16-B loads, each slot's
//        thread runs dense_slot on its staged row, and the tile goes out to
//        each replica as one contiguous run of coalesced 16-B stores.
//   B.8c sparse probe (:400-437 with :295-317): per slot, every node's
//        window and touch bits; counts per node, each owner's share of the
//        union of all of them, the union compacted into a slot list (any
//        order) and the overflow verdict, written by the last block.
//   B.8d sparse apply (:442-500): per union slot, the owner's row with
//        every node's window folded in node order on that node's own
//        parameters, written to all n replicas, the accumulators zeroed.
//        Bound: bytes, ~union x (128 + 160n) B, far below a launch; what
//        a slot waits on is its chain of round trips and transitions, and
//        at thousands of union slots the random sectors it touches.  A
//        thread a slot (the first port) read the n count words one after
//        another, each window's words after its count, ran whole
//        transitions in one chain (its warp's 32 slots diverging over the
//        algorithms) and stored 16-B vectors 128 B apart from 2 SMs
//        (PERF.md §6, the B.9 and B.8d redesign).  So a group of G lanes
//        takes a slot (global_mesh.cuh's node_acc / node_window /
//        chain_link): lane d reads node d's four
//        accumulator words while lanes 0-7 read the owner's row as eight
//        16-B vectors, in one round trip, then the nine aux words of a
//        node with a window (a second round trip, ~2.3x fewer sectors than
//        reading every node's); each lane prepares its node's window when
//        it has its own parameters and zeroes its node's words that are
//        not 0; lane 0 runs only the applies (and the prepares of windows
//        on the running row's parameters) in node order, the row in its
//        registers; the row goes to each replica as one 128-B run of
//        eight lanes.  G is a warp while the union fits the SMs at a warp
//        a slot, 16 or 8 past 8 or 16 slots an SM (sparse_group).  The
//        host reads the union's size with the overflow word and sizes the
//        grid by it: no block without a slot, no launch for an empty
//        union.
//
// Design: one thread a lane (B.8a, runs merged a warp) or a slot (B.8c;
// B.8b a tile, B.8d a group, as above), grids sized to the work; rows move
// as 16-B vectors.
// B.8c scans the count and touch rows of every node (2 x 8 B x n x
// capacity); its counts are warp ballots summed in shared memory, then
// once a block into global counters, and its list appends one atomic a
// warp.  The probe's scratch counters are zeroed by a memset in the same
// stream before its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "global_mesh.cuh"
#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void atomic_add64(int64_t* p, uint64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            (unsigned long long)v);
}

__global__ void __launch_bounds__(kThreads)
    accumulate_kernel(const int32_t* __restrict__ m32, int64_t ld,
                      int64_t lanes, int64_t* __restrict__ aux,
                      int64_t* __restrict__ acc, gm::Mesh m, int64_t stamp,
                      int track_touch) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // Whole warps go on: lanes past the window are dead lanes of no run.
  gm::Lane l{};
  l.flat = -1;
  if (j < lanes) l = gm::lane_at(m32, ld, lanes, j, m);
  if (l.tail) {
#pragma unroll
    for (int k = 0; k < gm::AUX_ROWS; ++k) {
      aux[gm::aux_ix(m, l.d, k, l.s)] = gm::aux_word(l, k, stamp);
    }
  }
  // The warp's runs: neighbouring lanes of one flattened slot.  Each lane
  // sums its run's terms up to itself, so the run's last lane holds the
  // run's; warps without a run of two lanes skip the scan.
  gm::LaneAcc a = gm::lane_acc(l, track_touch != 0);
  const int64_t up = __shfl_up_sync(kFull, l.flat, 1);
  const int64_t down = __shfl_down_sync(kFull, l.flat, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || up != l.flat);
  if (heads != kFull) {
    const int first = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint64_t h = __shfl_up_sync(kFull, a.hits, off);
      const uint32_t c = __shfl_up_sync(kFull, a.counts, off);
      if (lane - off >= first) {
        a.hits += h;
        a.counts += c;
      }
    }
  }
  if (l.flat >= 0 && (lane == 31 || down != l.flat)) {
    uint64_t v[gm::ACC_ROWS];
    gm::run_addends(a, v);
#pragma unroll
    for (int k = 0; k < gm::ACC_ROWS; ++k) {
      if (v[k]) atomic_add64(acc + gm::acc_ix(m, l.d, k, l.s), v[k]);
    }
  }
}

// B.8b's tile: kThreads consecutive slots a block, their rows staged in
// shared memory at a 144-B stride (16-B aligned for the vector copies;
// a thread's own row's words spread over the banks).
constexpr int kDenseRowW = 18;
constexpr int kDenseVecs = gt::ROW_W / 2;  // 16-B vectors a row

__global__ void __launch_bounds__(kThreads)
    dense_kernel(int64_t* __restrict__ table,
                 const int64_t* __restrict__ aux, int64_t* __restrict__ acc,
                 gm::Mesh m, int64_t now, int strict) {
  __shared__ __align__(16) int64_t rows[kThreads * kDenseRowW];
  const int t = threadIdx.x;
  const int64_t s0 = (int64_t)blockIdx.x * kThreads;
  const int ns = (int)(m.capacity - s0 < kThreads ? m.capacity - s0
                                                   : kThreads);
  // 1. The owners' rows in: vector v of the tile is row v / 8's part
  // v % 8; a tile inside one owner's slice reads one contiguous run.
  for (int v = t; v < ns * kDenseVecs; v += kThreads) {
    const int i = v / kDenseVecs, part = v % kDenseVecs;
    const int64_t s = s0 + i;
    const longlong2* src = reinterpret_cast<const longlong2*>(
        table + (gm::owner_of(m, s) * m.capacity + s) * gt::ROW_W);
    reinterpret_cast<longlong2*>(rows + i * kDenseRowW)[part] = src[part];
  }
  __syncthreads();
  // 2. Each slot's thread reconciles its staged row.
  if (t < ns) {
    gm::dense_slot(m, aux, acc, s0 + t, now, strict != 0,
                   rows + t * kDenseRowW);
  }
  __syncthreads();
  // 3. The tile to every replica, one contiguous run of 16-B stores each,
  // and every node's accumulators of the tile to 0 (coalesced).
  for (int64_t d = 0; d < m.n_nodes; ++d) {
    longlong2* dst = reinterpret_cast<longlong2*>(
        table + (d * m.capacity + s0) * gt::ROW_W);
    for (int v = t; v < ns * kDenseVecs; v += kThreads) {
      dst[v] = reinterpret_cast<const longlong2*>(
          rows + (v / kDenseVecs) * kDenseRowW)[v % kDenseVecs];
    }
    if (t < ns) {
#pragma unroll
      for (int k = 0; k < gm::ACC_ROWS; ++k) {
        acc[gm::acc_ix(m, d, k, s0 + t)] = 0;
      }
    }
  }
}

// scratch (int32): [0] finished blocks, [1] union size, then the window
// counts, the touch counts and the owners' union shares, n each.
// out (int64): [0] overflow, [1] union size.
__global__ void probe_kernel(const int64_t* __restrict__ acc, gm::Mesh m,
                             int64_t k, int32_t* __restrict__ scratch,
                             int32_t* __restrict__ list,
                             int64_t* __restrict__ out) {
  extern __shared__ int32_t sh[];  // 3n counters
  const int64_t n = m.n_nodes;
  for (int64_t i = threadIdx.x; i < 3 * n; i += kThreads) sh[i] = 0;
  __syncthreads();
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool in = s < m.capacity;
  const int lane = threadIdx.x & 31;
  bool any = false;
  for (int64_t d = 0; d < n; ++d) {
    const bool w = in && gm::window_at(m, acc, d, s);
    const bool t = in && gm::touch_at(m, acc, d, s);
    any = any || w || t;
    const unsigned bw = __ballot_sync(kFull, w);
    const unsigned bt = __ballot_sync(kFull, t);
    if (lane == 0) {
      if (bw) atomicAdd(&sh[d], __popc(bw));
      if (bt) atomicAdd(&sh[n + d], __popc(bt));
    }
  }
  const unsigned bu = __ballot_sync(kFull, any);
  int base = 0;
  if (lane == 0 && bu) base = atomicAdd(&scratch[1], __popc(bu));
  base = __shfl_sync(kFull, base, 0);
  const int owner = any ? (int)gm::owner_of(m, s) : -1;
  const unsigned peers = __match_any_sync(kFull, owner);
  if (any) {
    list[base + __popc(bu & ((1u << lane) - 1u))] = (int32_t)s;
    if (lane == __ffs(peers) - 1) atomicAdd(&sh[2 * n + owner], __popc(peers));
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < 3 * n; i += kThreads) {
    if (sh[i]) atomicAdd(&scratch[2 + i], sh[i]);
  }
  // Every thread fences its own adds, and the barrier holds thread 0's
  // finished-block bump until all of them have: only then may the last block
  // read the sums.
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) {
    last = atomicAdd(&scratch[0], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const volatile int32_t* v = scratch;
    bool over = false;
    for (int64_t d = 0; d < n; ++d) {
      over = over || v[2 + d] > k || v[2 + n + d] > k ||
             v[2 + 2 * n + d] > 2 * k;
    }
    out[0] = over ? 1 : 0;
    out[1] = v[1];
  }
}

// B.8d: a group of G lanes a union slot (G = 8, 16 or 32), kSparseThreads
// / G slots a block.  A node's aux words are read only once its count
// says it has a window: a second round trip but far fewer sectors (never
// slower than reading them with the counts, 22% faster at 4096 union
// slots: PERF.md §6, the B.9 and B.8d redesign).
constexpr int kSparseThreads = 128;

template <int G>
struct SparseGroup {
  alignas(16) int64_t row[gt::ROW_W];  // the owner's row, then the folded
  int64_t prep[gt::PREP_W * G];        // each lane's prepared request
  int64_t hits[G];
  int8_t kind[G];
};

// The lanes of thread t's group, as a __syncwarp mask.
template <int G>
__device__ __forceinline__ unsigned group_mask(int t) {
  return G == 32 ? kFull : ((1u << G) - 1u) << ((t & 31) & ~(G - 1));
}

// Node d's window words (its aux words after them, only for a window)
// and its window.
__device__ __forceinline__ gm::NodeWin node_at(const gm::Mesh& m,
                                               const int64_t* aux,
                                               const int64_t* acc, int64_t d,
                                               int64_t s, int64_t now,
                                               gm::NodeAcc& a) {
  int64_t p[gm::AUX_ROWS];
  a = gm::node_acc(m, acc, d, s);
  if (a.w[gm::ACC_COUNT] > 0) gm::node_aux(m, aux, d, s, p);
  return gm::node_window(a, p, now);
}

template <int G>
__global__ void __launch_bounds__(kSparseThreads)
    apply_kernel(int64_t* __restrict__ table, const int64_t* __restrict__ aux,
                 int64_t* __restrict__ acc, gm::Mesh m,
                 const int32_t* __restrict__ list, int64_t count,
                 int64_t now) {
  constexpr int kSlots = kSparseThreads / G;
  __shared__ SparseGroup<G> groups[kSlots];
  const int t = threadIdx.x, x = t % G;
  SparseGroup<G>& S = groups[t / G];
  const int64_t j = (int64_t)blockIdx.x * kSlots + t / G;
  if (j >= count) return;  // whole groups: only in the last block
  const unsigned mask = group_mask<G>(t);
  const int64_t s = list[j];
  const int64_t n = m.n_nodes;
  longlong2* row_v = reinterpret_cast<longlong2*>(S.row);
  // 1. The owner's row as eight 16-B vectors (lanes 0-7) and each lane's
  // node's window words, in one round trip (a second for a window's aux
  // words); a window with its own parameters is prepared by its lane.
  longlong2 v;
  if (x < gt::ROW_W / 2) {
    v = reinterpret_cast<const longlong2*>(
        table + (gm::owner_of(m, s) * m.capacity + s) * gt::ROW_W)[x];
  }
  gm::NodeAcc a;
  gm::NodeWin w;
  w.kind = gm::WIN_NONE;
  if (x < n) w = node_at(m, aux, acc, x, s, now, a);
  if (x < gt::ROW_W / 2) row_v[x] = v;
  // 2. The chain, on lane 0, the row in its registers: G nodes a round
  // (one round unless n > 32), each round's windows handed over in
  // shared memory; a lane zeroes its node's accumulator words once they
  // are read.
  int64_t row[gt::ROW_W];
  bool folded = false;
  for (int64_t d0 = 0; d0 < n; d0 += G) {
    if (d0 > 0) {
      w.kind = gm::WIN_NONE;
      if (d0 + x < n) w = node_at(m, aux, acc, d0 + x, s, now, a);
    }
    if (d0 + x < n) gm::node_zero(m, acc, d0 + x, s, a);
    S.kind[x] = w.kind;
    S.hits[x] = w.hits;
    if (w.kind == gm::WIN_OWN) gt::put_prep(S.prep, G, x, w.prep);
    __syncwarp(mask);
    if (x == 0) {
      if (d0 == 0) {
#pragma unroll
        for (int k = 0; k < gt::ROW_W; ++k) row[k] = S.row[k];
      }
      const int64_t span = n - d0 < G ? n - d0 : G;
      for (int i = 0; i < span; ++i) {
        const int8_t kind = S.kind[i];
        if (kind == gm::WIN_NONE) continue;
        gt::Prep own;
        if (kind == gm::WIN_OWN) own = gt::get_prep(S.prep, G, i);
        gm::chain_link(kind, own, S.hits[i], now, row);
        folded = true;
      }
    }
    __syncwarp(mask);
  }
  if (x == 0) {
    gm::chain_end(folded, row);
#pragma unroll
    for (int k = 0; k < gt::ROW_W; ++k) S.row[k] = row[k];
  }
  __syncwarp(mask);
  // 3. The row to every replica as one 128-B run of eight 16-B stores.
  for (int64_t i = x; i < n * (gt::ROW_W / 2); i += G) {
    const int64_t d = i / (gt::ROW_W / 2);
    reinterpret_cast<longlong2*>(table + (d * m.capacity + s) * gt::ROW_W)
        [i % (gt::ROW_W / 2)] = row_v[i % (gt::ROW_W / 2)];
  }
}

template <int G>
void launch_apply(int64_t* table, const int64_t* aux, int64_t* acc,
                  const gm::Mesh& m, const int32_t* list, int64_t count,
                  int64_t now, cudaStream_t st) {
  constexpr int kSlots = kSparseThreads / G;
  apply_kernel<G><<<(unsigned)((count + kSlots - 1) / kSlots),
                    kSparseThreads, 0, st>>>(table, aux, acc, m, list, count,
                                             now);
}

// Lanes a union slot: a warp while the union fits the SMs at a warp a
// slot (the chains then run one to a warp, none diverging), half or a
// quarter of one as it grows past 8 or 16 slots an SM (the loads and
// stores of more slots in flight an SM); never fewer than the nodes
// rounded up to a power of two, nor than the row's eight 16-B vectors.
int sparse_group(int64_t n_nodes, int64_t count, int sms) {
  const int least = n_nodes <= 8 ? 8 : n_nodes <= 16 ? 16 : 32;
  const int g = count > 16 * (int64_t)sms ? 8
              : count > 8 * (int64_t)sms  ? 16
                                          : 32;
  return g > least ? g : least;
}

void launch_accumulate(const int32_t* m32, int64_t ld, int64_t lanes,
                       int64_t* aux, int64_t* acc, const gm::Mesh& m,
                       int64_t stamp, int track_touch, int threads,
                       cudaStream_t st) {
  accumulate_kernel<<<(unsigned)((lanes + threads - 1) / threads), threads,
                      0, st>>>(m32, ld, lanes, aux, acc, m, stamp,
                               track_touch);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

gm::Mesh mesh_of(int64_t n_nodes, int64_t capacity) {
  return gm::Mesh{n_nodes, capacity, capacity / n_nodes};
}

}  // namespace

extern "C" int gt_global_accumulate(const int32_t* m32, int64_t ld,
                                    int64_t lanes, int64_t* aux, int64_t* acc,
                                    int64_t n_nodes, int64_t capacity,
                                    int64_t stamp, int track_touch,
                                    void* stream) {
  if (lanes > 0) {
    launch_accumulate(m32, ld, lanes, aux, acc, mesh_of(n_nodes, capacity),
                      stamp, track_touch,
                      spread_threads(lanes, sm_count()),
                      (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int gt_global_dense(int64_t* table, const int64_t* aux,
                               int64_t* acc, int64_t n_nodes,
                               int64_t capacity, int64_t now, int strict,
                               void* stream) {
  dense_kernel<<<blocks_for(capacity), kThreads, 0, (cudaStream_t)stream>>>(
      table, aux, acc, mesh_of(n_nodes, capacity), now, strict);
  return (int)cudaGetLastError();
}

extern "C" int gt_global_probe(const int64_t* acc, int64_t n_nodes,
                               int64_t capacity, int64_t k, int32_t* scratch,
                               int32_t* list, int64_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(
      scratch, 0, (size_t)(2 + 3 * n_nodes) * sizeof(int32_t), st);
  if (rc != cudaSuccess) return (int)rc;
  probe_kernel<<<blocks_for(capacity), kThreads,
                 (size_t)(3 * n_nodes) * sizeof(int32_t), st>>>(
      acc, mesh_of(n_nodes, capacity), k, scratch, list, out);
  return (int)cudaGetLastError();
}

extern "C" int gt_global_apply(int64_t* table, const int64_t* aux,
                               int64_t* acc, int64_t n_nodes,
                               int64_t capacity, const int32_t* list,
                               int64_t count, int64_t now, void* stream) {
  if (count > 0) {
    const gm::Mesh m = mesh_of(n_nodes, capacity);
    cudaStream_t st = (cudaStream_t)stream;
    const int g = sparse_group(n_nodes, count, sm_count());
    if (g == 8) {
      launch_apply<8>(table, aux, acc, m, list, count, now, st);
    } else if (g == 16) {
      launch_apply<16>(table, aux, acc, m, list, count, now, st);
    } else {
      launch_apply<32>(table, aux, acc, m, list, count, now, st);
    }
  }
  return (int)cudaGetLastError();
}
