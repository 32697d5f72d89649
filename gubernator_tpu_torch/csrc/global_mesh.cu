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
//
// Design: one thread a lane (B.8a) or a slot (B.8c-B.8d; B.8b a tile, as
// above), 256 threads a block, grids sized to the work; rows move as 16-B
// vectors.  B.8c scans
// the count and touch rows of every node (2 x 8 B x n x capacity); its
// counts are warp ballots summed in shared memory, then once a block into
// global counters, and its list appends one atomic a warp.  The probe's
// scratch counters are zeroed by a memset in the same stream before its
// launch.  B.8d reads the union count from the probe's output on the card,
// so the host reads back only the overflow word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "global_mesh.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// The merged row of slot s to every replica, and every node's four
// accumulator words of the slot to 0.
__device__ __forceinline__ void replicate(int64_t* table, int64_t* acc,
                                          const gm::Mesh& m, int64_t s,
                                          const int64_t* row) {
  for (int64_t d = 0; d < m.n_nodes; ++d) {
    store_row(table, d * m.capacity + s, row);
#pragma unroll
    for (int k = 0; k < gm::ACC_ROWS; ++k) acc[gm::acc_ix(m, d, k, s)] = 0;
  }
}

__device__ __forceinline__ void atomic_add64(int64_t* p, int64_t v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            (unsigned long long)v);
}

__global__ void accumulate_kernel(const int32_t* __restrict__ m32, int64_t ld,
                                  int64_t lanes, int64_t* __restrict__ aux,
                                  int64_t* __restrict__ acc, gm::Mesh m,
                                  int64_t stamp, int track_touch) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= lanes) return;
  const gm::Lane l = gm::lane_at(m32, ld, lanes, j, m);
  if (!l.live) return;
  if (l.tail) {
#pragma unroll
    for (int k = 0; k < gm::AUX_ROWS; ++k) {
      aux[gm::aux_ix(m, l.d, k, l.s)] = gm::aux_word(l, k, stamp);
    }
  }
  if (l.queue) {
    atomic_add64(acc + gm::acc_ix(m, l.d, gm::ACC_HITS, l.s), l.r.hits);
    if (l.reset) atomic_add64(acc + gm::acc_ix(m, l.d, gm::ACC_RESET, l.s), 1);
    atomic_add64(acc + gm::acc_ix(m, l.d, gm::ACC_COUNT, l.s), 1);
  }
  if (track_touch) {
    atomic_add64(acc + gm::acc_ix(m, l.d, gm::ACC_TOUCH, l.s), 1);
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

__global__ void apply_kernel(int64_t* __restrict__ table,
                             const int64_t* __restrict__ aux,
                             int64_t* __restrict__ acc, gm::Mesh m,
                             const int32_t* __restrict__ list,
                             const int64_t* __restrict__ count,
                             int64_t now) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= *count) return;
  const int64_t s = list[j];
  int64_t row[gt::ROW_W];
  load_row(table, gm::owner_of(m, s) * m.capacity + s, row);
  gm::sparse_slot(m, aux, acc, s, now, row);
  replicate(table, acc, m, s, row);
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
    accumulate_kernel<<<blocks_for(lanes), kThreads, 0,
                        (cudaStream_t)stream>>>(
        m32, ld, lanes, aux, acc, mesh_of(n_nodes, capacity), stamp,
        track_touch);
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
                               const int64_t* count, int64_t max_slots,
                               int64_t now, void* stream) {
  if (max_slots > 0) {
    apply_kernel<<<blocks_for(max_slots), kThreads, 0,
                   (cudaStream_t)stream>>>(
        table, aux, acc, mesh_of(n_nodes, capacity), list, count, now);
  }
  return (int)cudaGetLastError();
}
