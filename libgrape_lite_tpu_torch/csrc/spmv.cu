// Gather-reduce SpMV kernels for Hopper (sm_90a), bound through ctypes.
//
// Both kernels compute rows of  y[r] = (+)_{e in in(r)} x[nbr_e] (*) w_e
// over a fragment stack: fnum fragments of vp rows each, CSR arrays
// stacked [fnum, vp + 1] (indptr) and [fnum, ep] (edge arrays), x indexed
// by the padded global id pid = fid * vp + lid.
//
// gather_reduce replaces the pack-gather Pallas pipeline of the JAX
// package (libgrape_lite_tpu/ops/spmv_pack.py::_run_level_dev: the
// gather/mid-fold kernel _kernel_body, the final fold-scan, and the
// extraction kernel _extract_kernel_body).  The TPU version exists to
// turn an irregular gather plus segmented reduction into dense vector
// work: lane-mixed x tables, a hub tier, Clos routes and multi-level
// folds.  On this card threads gather from L1/L2 directly, so the kernel
// reads the CSR as it is, with no plan and no host preprocessing.
//   Bound: each edge costs 4 B of nbr (+4 B of w) read once; x (4 MB at
//   2^20 vertices) stays in the 50 MB L2.  What bounds it in practice is
//   the random x reads (the card serves uniform 4-byte gathers from a
//   4 MB table at ~121 G/s) and, before this design, degree skew: with a
//   warp per row, RMAT-20's hub row (139,379 edges) is 4,356 dependent
//   warp iterations, ~0.43 ms, the whole kernel's time.
//   Design (Merrill and Garland's merge-based CSR SpMV): each fragment's
//   rows + edges form one merge path of row ends against edge indices,
//   cut into blocks of kItemsPerBlock items, so a hub row spreads over as
//   many blocks as its edges fill and an empty row costs one item.
//     pass 1 (merge_partition_kernel): a binary search on indptr gives
//       the row coordinate of every block boundary;
//     pass 2 (merge_gather_kernel): a block stages its indptr slice and
//       its nbr (and w) span in shared memory with cp.async.bulk on an
//       mbarrier (16-B aligned interiors; the ragged ints at each end by
//       plain loads), gathers every edge's x at once (kItemsPerThread
//       independent loads a thread, w off the dependent chain), then each
//       thread walks kItemsPerThread merge items.  Rows that start and end
//       in one thread are written directly; the rest meet in a fixed-order
//       segmented scan of the thread tails.  The row that runs past the
//       block leaves a carry (row, partial);
//     pass 3 (carry_fold_kernel): the first slot of each run of carries
//       for one row folds the run into y[row]: its own thread for a run
//       of one or two, else its warp, in block order.
//   No atomics: sums are bit-identical from rerun to rerun, min and max
//   equal any-order results.  Pads after a fragment's indptr[vp] edges
//   lie past its merge path; offsets f * ep are 64-bit.  The carve-out
//   gives shared memory only what the resident blocks need, leaving L1
//   for RMAT's hot x columns.
//   Value types: float (sum, min, max; optional weights) and int32 (sum,
//   min, max; no weights) -- BFS depths and WCC labels, whose INT32_MAX
//   sentinels and pid range a float32 cannot carry exactly past 2^24, and
//   the peeling apps' neighbour counts (kcore, core_decomposition,
//   common_neighbors).  An int32 sum is exact in any order (integer
//   addition is associative), so it is bit-equal to the plain version;
//   a row's sum must stay below 2^31 (the apps' counts are bounded by the
//   in-degree).
//
// gather_reduce_lanes is the same function for k lanes of x at once,
// y[b, f, r] for b < k: the counterpart of the JAX package's batched
// serve queries, whose pull runs under jax.vmap over a leading lane
// axis (libgrape_lite_tpu/worker/worker.py::_make_batched_runner, over
// the same pack-gather pipeline).  k single calls would read indptr,
// nbr and w k times (272 MB a call at RMAT-20 with weights).
//   Bound: indptr, nbr and w read once, plus k x's and k y's.  What
//   bounds it in practice is the gathers' load instructions: by scalar
//   loads each lane cost ~0.14 ms at RMAT-20 (33.5 M edges), 50x the
//   0.0025 ms its x and y take at 3.35 TB/s; by the vector loads below
//   ~0.06 ms.
//   Design: the merge path as it is.  merge_partition_kernel runs once
//   (it reads indptr alone).  merge_gather_lanes_kernel stages a block's
//   row ends, nbr and w once with the same bulk copies, and takes the
//   lanes in groups of G (the smallest power of two that holds them, 2
//   to 8).  x comes lane-minor, each vertex's lanes in a row of `pitch`
//   (the lanes rounded up to the vector width; the wrapper transposes
//   and pads), so a thread fetches an edge's G lanes with G / 4 16-byte
//   loads (one 8-byte load for G 2): a quarter of the load instructions
//   of scalar gathers.  Each thread classifies its kItemsPerThread merge
//   items once (edge or row end: merge_gather_kernel's walk without
//   values), loads its own edges' lanes straight into registers, then
//   walks them: no shared-memory round trip of the gathered values and
//   no sync before the walk.  The walk, the block's segmented scan
//   (its syncs and key shuffles shared by the G lanes) and the carry
//   are merge_gather_kernel's, so each lane reduces in exactly that
//   kernel's order: its output is bit-equal to gather_reduce on that
//   lane's x, float sums included.  Carries go to slot b * nblocks +
//   blk with row b * fnum * vp + pid, so carry_fold_kernel folds every
//   lane's runs in one launch over the flat [k * fnum * vp] y (keys of
//   two lanes never meet).  One lane is gather_reduce itself: the entry
//   points take 2 or more, and the wrapper calls the single kernel for
//   one.
//
// overlay_fold is K1's use on the delta overlay (dyn/ingest.py): the
// JAX package folds the overlay's slots with an XLA segment min by their
// row (libgrape_lite_tpu/app/base.py::dyn_min_fold), not a Pallas kernel;
// a merge path over the overlay's CSR walks every row end of the graph
// (three passes over 1.05 M rows at RMAT-20) for a few thousand edges.
//   Bound: the slots' bytes and their rows' read and write (~100 KB at
//   4,096 slots): in practice one launch.
//   Design: one pass over the slots, in place into the caller's pull
//   result, every lane in the same launch: one thread a slot and lane,
//   a warp min over each run of equal rows among its 32 slots (src is
//   sorted within a fragment), one integer atomic a run.  Min is exact
//   in any order, so the result equals the merge path's followed by a
//   minimum.  Floats go through atomicMin / atomicMax on their bits
//   (ordered_min: -0.0 below +0.0, +inf the identity; no NaN), never a
//   float atomic; an overlay with every slot in one row costs cap / 32
//   atomics, not a serial walk.

// strict_tile replaces the strict-tile Pallas kernel
// (libgrape_lite_tpu/ops/spmv.py::_spmv_partials, body _spmv_tile_kernel)
// together with the XLA scatter-add that folds its tile partials
// (spmv_strict): the segment sum of f32 values by their sorted int32
// row (src), over equal tiles of `tile` edges (exact edge balance).  The
// TPU builds a one-hot [tile, rmax] product per tile and folds
// [num_tiles, rmax] partials; rmax is the widest tile's row window
// (11,264 at RMAT-20, where degree-0/1 rows cluster), so that work and
// those partials follow tiles x rmax, not the edges.
//   Bound: device-memory bytes, read once: 4 B value + 4 B src per edge,
//   plus y (4 B a row) written once.
//   Design: work and traffic in proportion to the edges, no partials.
//     pass 1 (cudaMemsetAsync): y = 0, so rows without an edge hold 0.
//       4 B a row (4 MiB at RMAT-20, 1.5% of the edge bytes); zeroing
//       the gaps inside the tiles instead would leave a long run of
//       empty rows (an edgeless fragment: all vp of them) to one thread;
//     pass 2 (strict_segments_kernel): one block per tile stages its
//       src and value spans in shared memory with cp.async.bulk on an
//       mbarrier (16-B aligned interiors, ragged ends by plain loads, as
//       K1 does).  Thread j walks a run of ipt consecutive edges (ipt
//       odd, so a warp's 32 reads hit 32 banks), summing in edge order:
//       rows that start and end in its run are final; its first row and
//       its tail meet the other threads' in K1's fixed-order segmented
//       scan.  The thread holding a row's last edge in the tile writes
//       y[row], unless the row crosses a tile boundary: src[e0 - 1] or
//       src[e0 + tile] (one load each) says so.  Then the row leaves a
//       carry (row, partial) in the tile's left or right slot; a tile
//       inside one row puts its sum left and 0 right, so a hub's slots
//       form one unbroken run in tile order;
//     pass 3 (K1's carry_fold_kernel): folds each run of carries into
//       y[row], a longer run by a warp 256 a step (a star of 2^22
//       edges: 4,096 slots).
//   No atomics: reruns are bit-identical.  Pads (src == vp, or past ep)
//   credit no row.  row_lo and rmax are the plan's, checked by the
//   wrapper; the kernel reads each row from src.  Offsets f * ep are
//   64-bit.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

enum Kind { kSum = 0, kMin = 1, kMax = 2 };

// identity and combine, overloaded on the value type (the argument only
// selects the overload)
template <int KIND>
__device__ __forceinline__ float identity(float) {
  return KIND == kSum ? 0.0f : (KIND == kMin ? CUDART_INF_F : -CUDART_INF_F);
}

template <int KIND>
__device__ __forceinline__ int identity(int) {
  return KIND == kSum ? 0 : (KIND == kMin ? INT_MAX : INT_MIN);
}

template <int KIND>
__device__ __forceinline__ float combine(float a, float b) {
  return KIND == kSum ? a + b : (KIND == kMin ? fminf(a, b) : fmaxf(a, b));
}

template <int KIND>
__device__ __forceinline__ int combine(int a, int b) {
  return KIND == kSum ? a + b : (KIND == kMin ? min(a, b) : max(a, b));
}

template <int KIND>
__device__ __forceinline__ float apply_weight(float v, float w) {
  return KIND == kSum ? v * w : v + w;
}

// ---- merge-path gather-reduce (K1) ---------------------------------------

constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kItemsPerThread = 4;
constexpr int kItemsPerBlock = kGatherThreads * kItemsPerThread;
// row ends, then edges, each placed at its global address mod 16 B
constexpr int kStageInts = kItemsPerBlock + 12;
constexpr int kPartitionThreads = 256;
constexpr int kFoldThreads = 256;
constexpr int kFoldUnroll = 8;
// gather_reduce_lanes: at most this many lanes gathered, walked and
// scanned at once (their x adjacent in xt)
constexpr int kMaxLaneGroup = 8;
// resident lane-kernel blocks an SM is asked to fit (caps registers):
// a group of 8 lanes holds 32 gathered values a thread and runs best at
// 3 (80 registers), smaller groups at 4 (64)
template <int G>
constexpr int kLaneBlocksPerSm = G >= 8 ? 3 : 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// misalignment of a 4-byte-aligned global address, in ints (0..3)
__device__ __forceinline__ int quad_offset(const void* p) {
  return static_cast<int>((reinterpret_cast<size_t>(p) >> 2) & 3);
}

// Stage n ints of g at s, where s and g agree mod 16 B: the 16-B aligned
// interior goes by one bulk copy (thread 0, completing on bar), the at
// most 3 + 3 ragged ints at either end by threads 0..5.  Returns the bulk
// bytes (thread 0 needs them for expect_tx before issuing).
__device__ __forceinline__ unsigned bulk_span(const int* g, int n, int& a0,
                                              int& a1) {
  a0 = min(n, (4 - quad_offset(g)) & 3);
  a1 = a0 + ((n - a0) & ~3);
  return static_cast<unsigned>(a1 - a0) * 4u;
}

__device__ __forceinline__ void stage_ragged(int* s, const int* g, int n,
                                             int a0, int a1, int tid) {
  if (tid < 3 && tid < a0) s[tid] = g[tid];
  const int i = a1 + tid - 3;
  if (tid >= 3 && tid < 6 && i < n) s[i] = g[i];
}

__device__ __forceinline__ void bulk_copy(int* s, const int* g,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(s)), "l"(g), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0: make bar expect `bytes` of bulk copies (issued next).
__device__ __forceinline__ void bulk_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Every thread, after a __syncthreads that follows bulk_expect: wait for
// the copies on bar to land.
__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  } while (!done);
}

// Inclusive segmented scan of (key, val) over the kGatherThreads threads
// of a block, whose keys do not fall with tid, in a fixed order: reruns
// are bit-identical.  Returns the thread's scanned value; prev_key and
// prev receive thread tid - 1's scanned pair (-1 and the identity for
// thread 0).
template <typename T, int KIND>
__device__ __forceinline__ T block_segmented_scan(int key, T val,
                                                  int& prev_key, T& prev,
                                                  int* s_wkey, T* s_wval) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T ident = identity<KIND>(T());
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int k2 = __shfl_up_sync(0xffffffffu, key, off);
    const T v2 = __shfl_up_sync(0xffffffffu, val, off);
    if (lane >= off && k2 == key) val = combine<KIND>(v2, val);
  }
  if (lane == 31) { s_wkey[warp] = key; s_wval[warp] = val; }
  __syncthreads();
  if (warp == 0) {
    int wk = lane < kGatherWarps ? s_wkey[lane] : -1;
    T wv = lane < kGatherWarps ? s_wval[lane] : ident;
#pragma unroll
    for (int off = 1; off < kGatherWarps; off <<= 1) {
      const int k2 = __shfl_up_sync(0xffffffffu, wk, off);
      const T v2 = __shfl_up_sync(0xffffffffu, wv, off);
      if (lane >= off && k2 == wk) wv = combine<KIND>(v2, wv);
    }
    if (lane < kGatherWarps) s_wval[lane] = wv;  // keys unchanged
  }
  __syncthreads();
  const int lane0_key = __shfl_sync(0xffffffffu, key, 0);
  if (warp > 0 && key == lane0_key && s_wkey[warp - 1] == key)
    val = combine<KIND>(s_wval[warp - 1], val);
  prev = __shfl_up_sync(0xffffffffu, val, 1);
  prev_key = __shfl_up_sync(0xffffffffu, key, 1);
  if (lane == 0) {
    prev = warp > 0 ? s_wval[warp - 1] : ident;
    prev_key = warp > 0 ? s_wkey[warp - 1] : -1;
  }
  return val;
}

// block_segmented_scan for G lanes at once: one key (the row) per
// thread and G values, each lane's combined in exactly the order of
// block_segmented_scan, so lane j's results equal that function's on
// lane j's values; the syncs and the key logic are shared.
template <typename T, int KIND, int G>
__device__ __forceinline__ void block_segmented_scan_lanes(
    int key, T (&val)[G], int& prev_key, T (&prev)[G], int* s_wkey,
    T (*s_wval)[kGatherWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T ident = identity<KIND>(T());
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int k2 = __shfl_up_sync(0xffffffffu, key, off);
    const bool take = lane >= off && k2 == key;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const T v2 = __shfl_up_sync(0xffffffffu, val[j], off);
      if (take) val[j] = combine<KIND>(v2, val[j]);
    }
  }
  if (lane == 31) {
    s_wkey[warp] = key;
#pragma unroll
    for (int j = 0; j < G; ++j) s_wval[j][warp] = val[j];
  }
  __syncthreads();
  if (warp == 0) {
    const int wk = lane < kGatherWarps ? s_wkey[lane] : -1;
    T wv[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      wv[j] = lane < kGatherWarps ? s_wval[j][lane] : ident;
#pragma unroll
    for (int off = 1; off < kGatherWarps; off <<= 1) {
      const int k2 = __shfl_up_sync(0xffffffffu, wk, off);
      const bool take = lane >= off && k2 == wk;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const T v2 = __shfl_up_sync(0xffffffffu, wv[j], off);
        if (take) wv[j] = combine<KIND>(v2, wv[j]);
      }
    }
    if (lane < kGatherWarps) {
#pragma unroll
      for (int j = 0; j < G; ++j) s_wval[j][lane] = wv[j];
    }
  }
  __syncthreads();
  const int lane0_key = __shfl_sync(0xffffffffu, key, 0);
  const bool from_warp =
      warp > 0 && key == lane0_key && s_wkey[warp - 1] == key;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (from_warp) val[j] = combine<KIND>(s_wval[j][warp - 1], val[j]);
    prev[j] = __shfl_up_sync(0xffffffffu, val[j], 1);
  }
  prev_key = __shfl_up_sync(0xffffffffu, key, 1);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) prev[j] = warp > 0 ? s_wval[j][warp - 1] : ident;
    prev_key = warp > 0 ? s_wkey[warp - 1] : -1;
  }
}

// Diagonal d of the merge of a fragment's row ends (ends[0..rows)) with
// its edge indices (0..nnz): the number of row ends consumed.  A row end
// goes before edge e when it is <= e.
__device__ __forceinline__ long long merge_search(const int* ends,
                                                  long long rows,
                                                  long long nnz, long long d,
                                                  int e_base) {
  long long lo = d > nnz ? d - nnz : 0;
  long long hi = d < rows ? d : rows;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (ends[mid] <= e_base + d - mid - 1) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Pass 1: the row coordinate of every block boundary of every fragment.
__global__ void merge_partition_kernel(const int* __restrict__ indptr,
                                       int* __restrict__ part, int vp,
                                       int bpf, long long count) {
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= count) return;
  const long long f = g / (bpf + 1);
  const long long lb = g - f * (bpf + 1);
  const int* ip = indptr + f * (static_cast<long long>(vp) + 1);
  const long long nnz = ip[vp];
  const long long d = min(lb * kItemsPerBlock, vp + nnz);
  part[g] = static_cast<int>(merge_search(ip + 1, vp, nnz, d, 0));
}

// Pass 2: one block per kItemsPerBlock merge items of one fragment.
template <typename T, int KIND, bool HAS_W>
__global__ void __launch_bounds__(kGatherThreads)
merge_gather_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ nbr, const float* __restrict__ w,
                    const T* __restrict__ x, T* __restrict__ y,
                    const int* __restrict__ part, int* __restrict__ carry_row,
                    T* __restrict__ carry_val, int vp, long long ep,
                    int bpf) {
  __shared__ alignas(16) int s_stage[kStageInts];
  __shared__ alignas(16) float s_w[HAS_W ? kStageInts : 4];
  __shared__ alignas(8) unsigned long long s_bar;
  __shared__ int s_wkey[kGatherWarps];
  __shared__ T s_wval[kGatherWarps];

  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const long long f = blk / bpf;
  const int lb = static_cast<int>(blk - f * bpf);
  const int* ip = indptr + f * (static_cast<long long>(vp) + 1);
  const int nnz = ip[vp];
  const long long d0 = static_cast<long long>(lb) * kItemsPerBlock;
  if (d0 >= vp + static_cast<long long>(nnz)) {  // past the fragment's path
    if (tid == 0) carry_row[blk] = -1;
    return;
  }
  const int* pf = part + f * (static_cast<long long>(bpf) + 1);
  const int r0 = pf[lb], r1 = pf[lb + 1];
  const long long d1 =
      min(d0 + kItemsPerBlock, vp + static_cast<long long>(nnz));
  const int e0 = static_cast<int>(d0 - r0);
  const int e1 = static_cast<int>(d1 - r1);
  const int nrows = r1 - r0, nedges = e1 - e0;

  // stage the row ends of rows r0..r1-1 and the block's edge span
  const int* g_end = ip + r0 + 1;
  const int* g_nbr = nbr + f * ep + e0;
  const int s_r = quad_offset(g_end);
  const int s_e = ((s_r + nrows + 3) & ~3) + quad_offset(g_nbr);
  int ra0, ra1, ea0, ea1, wa0 = 0, wa1 = 0;
  const unsigned rb = bulk_span(g_end, nrows, ra0, ra1);
  const unsigned eb = bulk_span(g_nbr, nedges, ea0, ea1);
  const float* g_w = HAS_W ? w + f * ep + e0 : nullptr;
  const int s_wo = HAS_W ? quad_offset(g_w) : 0;
  unsigned wb = 0;
  if constexpr (HAS_W)
    wb = bulk_span(reinterpret_cast<const int*>(g_w), nedges, wa0, wa1);
  if (tid == 0) {
    bulk_expect(&s_bar, rb + eb + wb);
    bulk_copy(s_stage + s_r + ra0, g_end + ra0, rb, &s_bar);
    bulk_copy(s_stage + s_e + ea0, g_nbr + ea0, eb, &s_bar);
    if constexpr (HAS_W)
      bulk_copy(reinterpret_cast<int*>(s_w) + s_wo + wa0,
                reinterpret_cast<const int*>(g_w) + wa0, wb, &s_bar);
  }
  stage_ragged(s_stage + s_r, g_end, nrows, ra0, ra1, tid);
  stage_ragged(s_stage + s_e, g_nbr, nedges, ea0, ea1, tid);
  if constexpr (HAS_W)
    stage_ragged(reinterpret_cast<int*>(s_w) + s_wo,
                 reinterpret_cast<const int*>(g_w), nedges, wa0, wa1, tid);
  __syncthreads();  // the barrier's init before anyone waits on it
  bulk_wait(&s_bar);

  // gather: every edge's x (and w) at once, in place over its nbr
  const int* s_end = s_stage + s_r;
  T* s_val = reinterpret_cast<T*>(s_stage + s_e);
  {
    int idx[kItemsPerThread];
    T val[kItemsPerThread];
#pragma unroll
    for (int k = 0; k < kItemsPerThread; ++k) {
      const int i = tid + k * kGatherThreads;
      idx[k] = i < nedges ? s_stage[s_e + i] : -1;
    }
#pragma unroll
    for (int k = 0; k < kItemsPerThread; ++k)
      if (idx[k] >= 0) val[k] = __ldg(x + idx[k]);
#pragma unroll
    for (int k = 0; k < kItemsPerThread; ++k) {
      const int i = tid + k * kGatherThreads;
      if (i < nedges) {
        T v = val[k];
        if constexpr (HAS_W) v = apply_weight<KIND>(v, s_w[s_wo + i]);
        s_val[i] = v;
      }
    }
  }
  __syncthreads();

  // each thread walks kItemsPerThread merge items: rows that end inside
  // it and started inside it are written at once; its first row end (a
  // row begun by earlier threads) and its tail wait for the scan
  const int items = nrows + nedges;
  const int t0 = min(tid * kItemsPerThread, items);
  const int t1 = min(t0 + kItemsPerThread, items);
  const int x0 = static_cast<int>(merge_search(s_end, nrows, nedges, t0, e0));
  int xr = x0, ye = t0 - x0;
  const T ident = identity<KIND>(T());
  T acc = ident, head = ident;
  bool has_head = false;
  T* yf = y + f * vp + r0;
  for (int k = 0; k < kItemsPerThread && xr + ye < t1; ++k) {
    if (ye < nedges && (xr == nrows || e0 + ye < s_end[xr])) {
      acc = combine<KIND>(acc, s_val[ye]);
      ++ye;
    } else {
      if (has_head) yf[xr] = acc; else head = acc;
      has_head = true;
      acc = ident;
      ++xr;
    }
  }

  // segmented inclusive scan of the thread tails keyed by their row
  // (keys rise with tid); prev is the scanned tail of the thread before
  // (its key is x0): the part of this thread's head row that earlier
  // threads of the block hold
  int prev_key;
  T prev;
  const T val = block_segmented_scan<T, KIND>(xr, acc, prev_key, prev,
                                              s_wkey, s_wval);
  if (has_head) yf[x0] = tid > 0 ? combine<KIND>(prev, head) : head;
  if (tid == kGatherThreads - 1) {
    // key == nrows: row r1 continues past the block; carry it when the
    // block holds any of its edges
    const int tail_edges = nrows > 0 ? e1 - s_end[nrows - 1] : nedges;
    const bool carry = r1 < vp && tail_edges > 0;
    carry_row[blk] = carry ? static_cast<int>(f * vp + r1) : -1;
    carry_val[blk] = val;
  }
}

// Pass 3: a thread per carry slot; the first slot of each run of
// carries for one row folds the run into y[row], which the block holding
// the row's end wrote.  The warp fold below reads 32 kFoldUnroll carries
// at a time (a hub row of 2^22 edges leaves 4,096); each lane folds the
// carries at its offset mod 32 in block order and a fixed butterfly
// joins the lanes.  A run of one or two (most runs: a row crossing one
// block or tile boundary) is written by its own thread with what that
// fold gives when the other lanes hold identities: (id + c0) + (id + c1)
// (an identity-combined carry absorbs further identities).  The warp
// takes its longer runs one at a time.
template <typename T, int KIND>
__global__ void carry_fold_kernel(const int* __restrict__ carry_row,
                                  const T* __restrict__ carry_val,
                                  T* __restrict__ y, long long nblocks) {
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const T ident = identity<KIND>(T());
  int key = -1, len = 0;  // len: the run's length, 3 for any longer
  if (b < nblocks) {
    key = carry_row[b];
    if (key >= 0 && (b == 0 || carry_row[b - 1] != key)) {
      len = 1;
      while (len < 3 && b + len < nblocks && carry_row[b + len] == key) ++len;
    }
  }
  if (len == 1 || len == 2) {
    T acc = combine<KIND>(ident, carry_val[b]);
    if (len == 2)
      acc = combine<KIND>(acc, combine<KIND>(ident, carry_val[b + 1]));
    y[key] = combine<KIND>(acc, y[key]);
  }
  for (unsigned runs = __ballot_sync(0xffffffffu, len == 3); runs;
       runs &= runs - 1) {
    const int src = __ffs(runs) - 1;
    const int rkey = __shfl_sync(0xffffffffu, key, src);
    T acc = ident;
    for (long long base = b - lane + src;; base += 32 * kFoldUnroll) {
      bool mine[kFoldUnroll], all = true;
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        const long long j = base + u * 32 + lane;
        mine[u] = j < nblocks && carry_row[j] == rkey;
        all = all && mine[u];
      }
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u)
        if (mine[u]) acc = combine<KIND>(acc, carry_val[base + u * 32 + lane]);
      if (!__all_sync(0xffffffffu, all)) break;  // the run ends in this span
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = combine<KIND>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) y[rkey] = combine<KIND>(acc, y[rkey]);
  }
}

// A vertex's values of lanes g .. g + G - 1 in xt (lane-minor, rows of
// `pitch` lanes): 16-byte vector loads (8 bytes for G 2), so one load
// instruction brings up to 4 lanes.  The rows of the last group hold
// fewer than G lanes when pitch - g < G: only `avail` lanes are read.
template <typename T, int V> struct LaneVec;
template <> struct LaneVec<float, 2> { using type = float2; };
template <> struct LaneVec<float, 4> { using type = float4; };
template <> struct LaneVec<int, 2> { using type = int2; };
template <> struct LaneVec<int, 4> { using type = int4; };

template <typename T, int G>
__device__ __forceinline__ void load_lanes(const T* p, int avail,
                                           T (&v)[G]) {
  constexpr int V = G < 4 ? G : 4;
  using Vec = typename LaneVec<T, V>::type;
#pragma unroll
  for (int q = 0; q < G / V; ++q) {
    if (q * V < avail) {
      const Vec u = __ldg(reinterpret_cast<const Vec*>(p) + q);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < V; ++i) v[q * V + i] = e[i];
    }
  }
}

// Pass 2 for `lanes` lanes of x, lane-minor (xt[pid * pitch + b], pitch
// the lanes rounded up to the vector width), into y[lanes, lane_rows]:
// merge_gather_kernel's staging once, then for each group of G lanes
// merge_gather_kernel's walk, scan and carry for all of them at once,
// each thread gathering its own edges' lanes by vector loads straight
// into registers.
template <typename T, int KIND, bool HAS_W, int G>
__global__ void __launch_bounds__(kGatherThreads, kLaneBlocksPerSm<G>)
merge_gather_lanes_kernel(const int* __restrict__ indptr,
                          const int* __restrict__ nbr,
                          const float* __restrict__ w,
                          const T* __restrict__ xt, T* __restrict__ y,
                          const int* __restrict__ part,
                          int* __restrict__ carry_row,
                          T* __restrict__ carry_val, int vp, long long ep,
                          int bpf, int lanes, int pitch, long long lane_rows,
                          long long nblocks) {
  __shared__ alignas(16) int s_stage[kStageInts];
  __shared__ alignas(16) float s_w[HAS_W ? kStageInts : 4];
  __shared__ alignas(8) unsigned long long s_bar;
  __shared__ int s_wkey[kGatherWarps];
  __shared__ T s_wval[G][kGatherWarps];

  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const long long f = blk / bpf;
  const int lb = static_cast<int>(blk - f * bpf);
  const int* ip = indptr + f * (static_cast<long long>(vp) + 1);
  const int nnz = ip[vp];
  const long long d0 = static_cast<long long>(lb) * kItemsPerBlock;
  if (d0 >= vp + static_cast<long long>(nnz)) {  // past the fragment's path
    for (int b = tid; b < lanes; b += kGatherThreads)
      carry_row[b * nblocks + blk] = -1;
    return;
  }
  const int* pf = part + f * (static_cast<long long>(bpf) + 1);
  const int r0 = pf[lb], r1 = pf[lb + 1];
  const long long d1 =
      min(d0 + kItemsPerBlock, vp + static_cast<long long>(nnz));
  const int e0 = static_cast<int>(d0 - r0);
  const int e1 = static_cast<int>(d1 - r1);
  const int nrows = r1 - r0, nedges = e1 - e0;

  // stage the row ends and the edge span once, as merge_gather_kernel
  const int* g_end = ip + r0 + 1;
  const int* g_nbr = nbr + f * ep + e0;
  const int s_r = quad_offset(g_end);
  const int s_e = ((s_r + nrows + 3) & ~3) + quad_offset(g_nbr);
  int ra0, ra1, ea0, ea1, wa0 = 0, wa1 = 0;
  const unsigned rb = bulk_span(g_end, nrows, ra0, ra1);
  const unsigned eb = bulk_span(g_nbr, nedges, ea0, ea1);
  const float* g_w = HAS_W ? w + f * ep + e0 : nullptr;
  const int s_wo = HAS_W ? quad_offset(g_w) : 0;
  unsigned wb = 0;
  if constexpr (HAS_W)
    wb = bulk_span(reinterpret_cast<const int*>(g_w), nedges, wa0, wa1);
  if (tid == 0) {
    bulk_expect(&s_bar, rb + eb + wb);
    bulk_copy(s_stage + s_r + ra0, g_end + ra0, rb, &s_bar);
    bulk_copy(s_stage + s_e + ea0, g_nbr + ea0, eb, &s_bar);
    if constexpr (HAS_W)
      bulk_copy(reinterpret_cast<int*>(s_w) + s_wo + wa0,
                reinterpret_cast<const int*>(g_w) + wa0, wb, &s_bar);
  }
  stage_ragged(s_stage + s_r, g_end, nrows, ra0, ra1, tid);
  stage_ragged(s_stage + s_e, g_nbr, nedges, ea0, ea1, tid);
  if constexpr (HAS_W)
    stage_ragged(reinterpret_cast<int*>(s_w) + s_wo,
                 reinterpret_cast<const int*>(g_w), nedges, wa0, wa1, tid);
  __syncthreads();  // the barrier's init before anyone waits on it
  bulk_wait(&s_bar);

  // what no lane changes: merge_gather_kernel's walk over this thread's
  // kItemsPerThread merge items, taken once without values -- bit k of
  // emask says item k is an edge -- and each edge item's nbr and w
  const int* s_end = s_stage + s_r;
  const int items = nrows + nedges;
  const int t0 = min(tid * kItemsPerThread, items);
  const int t1 = min(t0 + kItemsPerThread, items);
  const int n_items = t1 - t0;
  const int x0 = static_cast<int>(merge_search(s_end, nrows, nedges, t0, e0));
  unsigned emask = 0;
  {
    int xr = x0, ye = t0 - x0;
    for (int k = 0; k < n_items; ++k) {
      if (ye < nedges && (xr == nrows || e0 + ye < s_end[xr])) {
        emask |= 1u << k;
        ++ye;
      } else {
        ++xr;
      }
    }
  }
  int idx[kItemsPerThread];
  float wv[kItemsPerThread];
#pragma unroll
  for (int k = 0; k < kItemsPerThread; ++k) {
    const int i = t0 - x0 + __popc(emask & ((1u << k) - 1));
    const bool edge = (emask >> k) & 1u;
    idx[k] = edge ? s_stage[s_e + i] : -1;
    wv[k] = HAS_W && edge ? s_w[s_wo + i] : 0.0f;
  }
  const T ident = identity<KIND>(T());
  const int tail_edges = nrows > 0 ? e1 - s_end[nrows - 1] : nedges;
  const bool carries = r1 < vp && tail_edges > 0;

  for (int g = 0; g < lanes; g += G) {
    const int gl = min(G, lanes - g);
    // gather: each edge item's G lanes, all loads in flight before the
    // walk; a vertex's lanes are adjacent in xt, one sector for 8
    T val[kItemsPerThread][G];
#pragma unroll
    for (int k = 0; k < kItemsPerThread; ++k)
      if (idx[k] >= 0)
        load_lanes<T, G>(xt + static_cast<long long>(idx[k]) * pitch + g,
                         pitch - g, val[k]);

    // merge_gather_kernel's walk for the group's lanes at once: the
    // merge items and row keys are the lanes' own, only the values
    // differ, so each lane combines in that kernel's order
    int xr = x0;
    T acc[G], head[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = head[j] = ident;
    bool has_head = false;
#pragma unroll
    for (int k = 0; k < kItemsPerThread; ++k) {
      if (k >= n_items) break;
      if ((emask >> k) & 1u) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          T v = val[k][j];
          if constexpr (HAS_W) v = apply_weight<KIND>(v, wv[k]);
          acc[j] = combine<KIND>(acc[j], v);
        }
      } else {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j < gl) {
            if (has_head) y[(g + j) * lane_rows + f * vp + r0 + xr] = acc[j];
            else head[j] = acc[j];
          }
          acc[j] = ident;
        }
        has_head = true;
        ++xr;
      }
    }
    int prev_key;
    T prev[G];
    block_segmented_scan_lanes<T, KIND, G>(xr, acc, prev_key, prev,
                                           s_wkey, s_wval);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= gl) continue;
      const long long yb = (g + j) * lane_rows + f * vp + r0;
      if (has_head) y[yb + x0] = tid > 0 ? combine<KIND>(prev[j], head[j])
                                         : head[j];
      if (tid == kGatherThreads - 1) {
        const long long slot = (g + j) * nblocks + blk;
        carry_row[slot] = carries
            ? static_cast<int>((g + j) * lane_rows + f * vp + r1) : -1;
        carry_val[slot] = acc[j];
      }
    }
    if (g + G < lanes) __syncthreads();  // the scan's slots serve the next group
  }
}

// ---- the overlay fold (K1 on the delta overlay) ------------------------

constexpr int kOverlayThreads = 256;

// The order the overlay fold reduces floats in: their bits as int32 with
// the negative floats' magnitude bits flipped, a total order on non-NaN
// values with -0.0 below +0.0.
__device__ __forceinline__ int ordered_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float ordered_min(float a, float b) {
  return ordered_key(b) < ordered_key(a) ? b : a;
}

__device__ __forceinline__ int ordered_min(int a, int b) { return min(a, b); }

// *a = ordered_min(*a, v) by integer atomics on the float's bits: where
// v's sign bit is clear, non-negative floats order as their int32 bits
// and every negative float's bits are a negative int32 (atomicMin);
// where it is set, negative floats order inversely to their bits read
// unsigned, all above every non-negative float's (atomicMax).
__device__ __forceinline__ void atomic_ordered_min(float* a, float v) {
  const int b = __float_as_int(v);
  if (b >= 0) atomicMin(reinterpret_cast<int*>(a), b);
  else atomicMax(reinterpret_cast<unsigned*>(a), static_cast<unsigned>(b));
}

__device__ __forceinline__ void atomic_ordered_min(int* a, int v) {
  atomicMin(a, v);
}

// One thread a slot of one lane (blockIdx.y): slot s = f * cap + i of
// the overlay planes [fnum, cap] relaxes row f * vp + src[s] of lane b
// of y [lanes, rows] from x[b * n + nbr[s]] (+ w[s]; BFS: + 1, the
// sentinel INT_MAX kept).  A row's slots are adjacent (src is sorted
// within a fragment), so a warp first takes the min of each run of
// equal rows among its 32 slots, and the run's first slot applies it
// with one atomic: an overlay whose slots all fall in one row costs
// cap / 32 atomics, not a serial walk.
template <typename T, bool HAS_W, bool PLUS_ONE>
__global__ void __launch_bounds__(kOverlayThreads)
overlay_fold_kernel(const int* __restrict__ src, const int* __restrict__ nbr,
                    const float* __restrict__ w,
                    const unsigned char* __restrict__ mask,
                    const T* __restrict__ x, T* __restrict__ y, int cap,
                    long long slots, int vp, long long n, long long rows) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  int key = -1;  // no row: a pad slot, or past the planes
  T v = identity<kMin>(T());
  if (s < slots && mask[s]) {
    key = static_cast<int>(s / cap * vp + src[s]);
    const T xv = __ldg(x + b * n + nbr[s]);
    if constexpr (HAS_W) v = apply_weight<kMin>(xv, w[s]);
    else if constexpr (PLUS_ONE) v = xv == INT_MAX ? xv : xv + 1;
    else v = xv;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int k2 = __shfl_down_sync(0xffffffffu, key, off);
    const T v2 = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32 && k2 == key) v = ordered_min(v, v2);
  }
  const int before = __shfl_up_sync(0xffffffffu, key, 1);
  if (key >= 0 && (lane == 0 || before != key))
    atomic_ordered_min(y + b * rows + key, v);
}

template <typename T, bool HAS_W, bool PLUS_ONE>
cudaError_t run_overlay_fold(const int* src, const int* nbr, const float* w,
                             const unsigned char* mask, const T* x, T* y,
                             int fnum, int cap, int vp, long long n,
                             int lanes, cudaStream_t s) {
  const long long slots = static_cast<long long>(fnum) * cap;
  const dim3 grid(static_cast<unsigned>(
      (slots + kOverlayThreads - 1) / kOverlayThreads), lanes);
  overlay_fold_kernel<T, HAS_W, PLUS_ONE><<<grid, kOverlayThreads, 0, s>>>(
      src, nbr, w, mask, x, y, cap, slots, vp, n,
      static_cast<long long>(fnum) * vp);
  return cudaGetLastError();
}

// ---- strict-tile segment sum (K2) ---------------------------------------

// Ints of each of the two staged spans of a strict tile (src, then
// values), each placed at its global address mod 16 B.
__host__ __device__ constexpr int strict_region_ints(int tile) {
  return (tile + 6) & ~3;
}

__device__ __forceinline__ bool in_rows(int row, int vp) {
  return static_cast<unsigned>(row) < static_cast<unsigned>(vp);
}

// Pass 2: one block per tile t of fragment f; slots 2 (f num_tiles + t)
// and + 1 receive the tile's left and right carries (row -1: none).
__global__ void __launch_bounds__(kGatherThreads)
strict_segments_kernel(const float* __restrict__ values,
                       const int* __restrict__ src, float* __restrict__ y,
                       int* __restrict__ carry_row,
                       float* __restrict__ carry_val, long long ep,
                       int num_tiles, int tile, int vp) {
  extern __shared__ __align__(16) int s_dyn[];
  __shared__ alignas(8) unsigned long long s_bar;
  __shared__ int s_wkey[kGatherWarps];
  __shared__ float s_wval[kGatherWarps];
  __shared__ int s_nb[2];  // src of the edges just before and after

  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const long long f = blockIdx.y;
  const long long slot = 2 * (f * num_tiles + t);
  const long long e0 = static_cast<long long>(t) * tile;
  const int n = static_cast<int>(
      max(0LL, min(static_cast<long long>(tile), ep - e0)));
  if (tid == 0) carry_row[slot] = carry_row[slot + 1] = -1;
  if (n == 0) return;  // a tile past ep

  const int* g_src = src + f * ep + e0;
  const int* g_val = reinterpret_cast<const int*>(values + f * ep + e0);
  int* s_src = s_dyn + quad_offset(g_src);
  int* s_vbits = s_dyn + strict_region_ints(tile) + quad_offset(g_val);
  int sa0, sa1, va0, va1;
  const unsigned sb = bulk_span(g_src, n, sa0, sa1);
  const unsigned vb = bulk_span(g_val, n, va0, va1);
  if (tid == 0) {
    bulk_expect(&s_bar, sb + vb);
    bulk_copy(s_src + sa0, g_src + sa0, sb, &s_bar);
    bulk_copy(s_vbits + va0, g_val + va0, vb, &s_bar);
    s_nb[0] = e0 > 0 ? g_src[-1] : -1;
    s_nb[1] = e0 + n < ep ? g_src[n] : -1;
  }
  stage_ragged(s_src, g_src, n, sa0, sa1, tid);
  stage_ragged(s_vbits, g_val, n, va0, va1, tid);
  __syncthreads();  // the barrier's init before anyone waits on it
  bulk_wait(&s_bar);
  const float* s_val = reinterpret_cast<const float*>(s_vbits);

  // rows crossing the tile's edges: its first row, continued from the
  // tile before, and its last row, continued by the tile after
  const int key0 = s_src[0], keyl = s_src[n - 1];
  const bool left = s_nb[0] == key0 && in_rows(key0, vp);
  const bool right = s_nb[1] == keyl && in_rows(keyl, vp);
  float* yf = y + f * vp;
  // the tile's sum of a row, from the thread holding its last edge here
  auto emit = [&](int row, float v) {
    if (!in_rows(row, vp)) return;  // a pad row
    const bool l = left && row == key0, r = right && row == keyl;
    if (!l && !r) {
      yf[row] = v;
      return;
    }
    const int pid = static_cast<int>(f * vp + row);
    if (l) { carry_row[slot] = pid; carry_val[slot] = v; }
    if (r) { carry_row[slot + 1] = pid; carry_val[slot + 1] = l ? 0.0f : v; }
  };

  // thread tid walks edges [a, b) in order; ipt is odd, so a warp's
  // reads at a + k fall in 32 different banks
  const int ipt = (tile + kGatherThreads - 1) / kGatherThreads | 1;
  const int a = min(tid * ipt, n), b = min(a + ipt, n);
  int key = a < b ? s_src[a] : INT_MAX;  // an empty run sorts last
  int head_key = -1;
  float acc = 0.0f, head = 0.0f;
  bool has_head = false;
  for (int e = a; e < b; ++e) {
    const int k = s_src[e];
    if (k != key) {  // row `key` ends at e - 1
      if (has_head) {
        emit(key, acc);
      } else {  // the run's first row: earlier threads may hold more
        head = acc;
        head_key = key;
        has_head = true;
      }
      key = k;
      acc = 0.0f;
    }
    acc += s_val[e];
  }
  int prev_key;
  float prev;
  const float tail = block_segmented_scan<float, kSum>(key, acc, prev_key,
                                                       prev, s_wkey, s_wval);
  if (has_head) emit(head_key, prev_key == head_key ? prev + head : head);
  if (a < b && (b == n || s_src[b] != key)) emit(key, tail);
}

long long blocks_per_fragment(int vp, long long ep) {
  return (vp + ep + kItemsPerBlock - 1) / kItemsPerBlock;
}

// Gather-kernel facts for reports: {threads, items per thread, static
// shared bytes, registers, resident blocks per SM, carve-out percent}.
// The first call sets the carve-out: shared memory for as many blocks
// as the SM holds by threads and registers, the rest of the SM's 256 KB
// left to L1, where the hot x columns are reused.
template <typename Kernel>
cudaError_t kernel_config(Kernel kernel, int* cfg) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int dev = 0, smem_sm = 0, blocks = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kGatherThreads, 0);
  if (err != cudaSuccess) return err;
  // 1 KB a block is reserved by the system
  const long long need =
      static_cast<long long>(blocks) * (attr.sharedSizeBytes + 1024);
  const int pct = static_cast<int>(
      std::min(100LL, (100 * need + smem_sm - 1) / smem_sm));
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
  if (err != cudaSuccess) return err;
  const int c[6] = {kGatherThreads, kItemsPerThread,
                    static_cast<int>(attr.sharedSizeBytes), attr.numRegs,
                    blocks, pct};
  for (int i = 0; i < 6; ++i) cfg[i] = c[i];
  return cudaSuccess;
}

// The facts of merge_gather_kernel (G = 0), or of
// merge_gather_lanes_kernel with lane groups of G.
template <typename T, int KIND, bool HAS_W, int G = 0>
cudaError_t gather_config(int* out) {
  static int cfg[6] = {0, 0, 0, 0, 0, -1};
  if (cfg[5] < 0) {
    cudaError_t err;
    if constexpr (G > 0)
      err = kernel_config(merge_gather_lanes_kernel<T, KIND, HAS_W, G>, cfg);
    else
      err = kernel_config(merge_gather_kernel<T, KIND, HAS_W>, cfg);
    if (err != cudaSuccess) return err;
  }
  for (int i = 0; i < 6; ++i) out[i] = cfg[i];
  return cudaSuccess;
}

// The three passes on one stream; scratch holds part[fnum * (bpf + 1)],
// then carry_row[fnum * bpf], then carry_val[fnum * bpf].
template <typename T, int KIND, bool HAS_W>
cudaError_t run_gather(const int* indptr, const int* nbr, const float* w,
                       const T* x, T* y, int* scratch, int fnum, int vp,
                       long long ep, cudaStream_t s) {
  int cfg[6];
  cudaError_t err = gather_config<T, KIND, HAS_W>(cfg);
  if (err != cudaSuccess) return err;
  const int bpf = static_cast<int>(blocks_per_fragment(vp, ep));
  const long long bounds = static_cast<long long>(fnum) * (bpf + 1);
  const long long nblocks = static_cast<long long>(fnum) * bpf;
  int* part = scratch;
  int* carry_row = part + bounds;
  T* carry_val = reinterpret_cast<T*>(carry_row + nblocks);
  merge_partition_kernel<<<static_cast<unsigned>(
      (bounds + kPartitionThreads - 1) / kPartitionThreads),
      kPartitionThreads, 0, s>>>(indptr, part, vp, bpf, bounds);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_gather_kernel<T, KIND, HAS_W>
      <<<static_cast<unsigned>(nblocks), kGatherThreads, 0, s>>>(
          indptr, nbr, w, x, y, part, carry_row, carry_val, vp, ep, bpf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  carry_fold_kernel<T, KIND><<<static_cast<unsigned>(
      (nblocks + kFoldThreads - 1) / kFoldThreads),
      kFoldThreads, 0, s>>>(carry_row, carry_val, y, nblocks);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t run_gather_f32(const int* indptr, const int* nbr, const float* w,
                           const float* x, float* y, int* scratch, int fnum,
                           int vp, long long ep, cudaStream_t s) {
  return w ? run_gather<float, KIND, true>(indptr, nbr, w, x, y, scratch,
                                            fnum, vp, ep, s)
           : run_gather<float, KIND, false>(indptr, nbr, w, x, y, scratch,
                                             fnum, vp, ep, s);
}

// The lane group for `lanes` (>= 2) lanes: the smallest power of two
// that holds them, at most kMaxLaneGroup.  One lane is not a group:
// the wrapper gives it to merge_gather_kernel.
int lane_group(int lanes) {
  int g = 2;
  while (g < lanes && g < kMaxLaneGroup) g <<= 1;
  return g;
}

// The lanes of an xt row: `lanes` rounded up to the group's vector
// width (load_lanes), so every vector load is aligned and in the row
// (ops/spmv.py::lane_pitch, checked at every launch).
int lanes_pitch(int lanes) {
  const int v = std::min(lane_group(lanes), 4);
  return (lanes + v - 1) / v * v;
}

// The three passes for `lanes` lanes of x on one stream; scratch holds
// part[fnum * (bpf + 1)], then carry_row[lanes * fnum * bpf], then
// carry_val[lanes * fnum * bpf].
template <typename T, int KIND, bool HAS_W, int G>
cudaError_t run_gather_lanes_g(const int* indptr, const int* nbr,
                               const float* w, const T* xt, T* y,
                               int* scratch, int fnum, int vp, long long ep,
                               int lanes, cudaStream_t s) {
  int cfg[6];
  cudaError_t err = gather_config<T, KIND, HAS_W, G>(cfg);
  if (err != cudaSuccess) return err;
  const int bpf = static_cast<int>(blocks_per_fragment(vp, ep));
  const long long bounds = static_cast<long long>(fnum) * (bpf + 1);
  const long long nblocks = static_cast<long long>(fnum) * bpf;
  const long long slots = lanes * nblocks;
  int* part = scratch;
  int* carry_row = part + bounds;
  T* carry_val = reinterpret_cast<T*>(carry_row + slots);
  merge_partition_kernel<<<static_cast<unsigned>(
      (bounds + kPartitionThreads - 1) / kPartitionThreads),
      kPartitionThreads, 0, s>>>(indptr, part, vp, bpf, bounds);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_gather_lanes_kernel<T, KIND, HAS_W, G>
      <<<static_cast<unsigned>(nblocks), kGatherThreads, 0, s>>>(
          indptr, nbr, w, xt, y, part, carry_row, carry_val, vp, ep, bpf,
          lanes, lanes_pitch(lanes), static_cast<long long>(fnum) * vp,
          nblocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  carry_fold_kernel<T, KIND><<<static_cast<unsigned>(
      (slots + kFoldThreads - 1) / kFoldThreads),
      kFoldThreads, 0, s>>>(carry_row, carry_val, y, slots);
  return cudaGetLastError();
}

template <typename T, int KIND, bool HAS_W>
cudaError_t run_gather_lanes(const int* indptr, const int* nbr,
                             const float* w, const T* xt, T* y, int* scratch,
                             int fnum, int vp, long long ep, int lanes,
                             cudaStream_t s) {
  switch (lane_group(lanes)) {
    case 2: return run_gather_lanes_g<T, KIND, HAS_W, 2>(indptr, nbr, w, xt, y, scratch, fnum, vp, ep, lanes, s);
    case 4: return run_gather_lanes_g<T, KIND, HAS_W, 4>(indptr, nbr, w, xt, y, scratch, fnum, vp, ep, lanes, s);
    default: return run_gather_lanes_g<T, KIND, HAS_W, kMaxLaneGroup>(indptr, nbr, w, xt, y, scratch, fnum, vp, ep, lanes, s);
  }
}

template <int KIND>
cudaError_t run_gather_lanes_f32(const int* indptr, const int* nbr,
                                 const float* w, const float* xt, float* y,
                                 int* scratch, int fnum, int vp, long long ep,
                                 int lanes, cudaStream_t s) {
  return w ? run_gather_lanes<float, KIND, true>(
                 indptr, nbr, w, xt, y, scratch, fnum, vp, ep, lanes, s)
           : run_gather_lanes<float, KIND, false>(
                 indptr, nbr, w, xt, y, scratch, fnum, vp, ep, lanes, s);
}

}  // namespace

extern "C" {

const char* grape_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// int32 words of scratch that grape_gather_reduce(_i32) needs.
long long grape_gather_scratch_ints(int fnum, int vp, long long ep) {
  const long long bpf = blocks_per_fragment(vp, ep);
  return fnum * (bpf + 1) + 2 * fnum * bpf;
}

// The gather kernel's launch facts for one kind (see gather_config).
int grape_gather_config(int kind, int has_w, int is_int, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (is_int && !has_w && kind == kSum) err = gather_config<int, kSum, false>(out);
  else if (is_int && !has_w && kind == kMin) err = gather_config<int, kMin, false>(out);
  else if (is_int && !has_w && kind == kMax) err = gather_config<int, kMax, false>(out);
  else if (!is_int && kind == kSum) err = has_w ? gather_config<float, kSum, true>(out) : gather_config<float, kSum, false>(out);
  else if (!is_int && kind == kMin) err = has_w ? gather_config<float, kMin, true>(out) : gather_config<float, kMin, false>(out);
  else if (!is_int && kind == kMax) err = has_w ? gather_config<float, kMax, true>(out) : gather_config<float, kMax, false>(out);
  return static_cast<int>(err);
}

// y[fnum * vp] = gather-reduce of x over the stacked CSR; w may be null;
// scratch holds grape_gather_scratch_ints(fnum, vp, ep) int32 words.
// Returns the first launch error, cudaSuccess when all three launched.
int grape_gather_reduce(const int* indptr, const int* nbr, const float* w,
                        const float* x, float* y, int* scratch, int fnum,
                        int vp, long long ep, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(fnum) * vp == 0) return cudaSuccess;
  switch (kind) {
    case kSum: return run_gather_f32<kSum>(indptr, nbr, w, x, y, scratch, fnum, vp, ep, s);
    case kMin: return run_gather_f32<kMin>(indptr, nbr, w, x, y, scratch, fnum, vp, ep, s);
    case kMax: return run_gather_f32<kMax>(indptr, nbr, w, x, y, scratch, fnum, vp, ep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// int32 sum / min / max of x over the stacked CSR, no weights (rows
// without edges hold 0 / INT32_MAX / INT32_MIN).  A sum wraps past 2^31:
// the caller keeps each row's sum below it.
int grape_gather_reduce_i32(const int* indptr, const int* nbr, const int* x,
                            int* y, int* scratch, int fnum, int vp,
                            long long ep, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(fnum) * vp == 0) return cudaSuccess;
  switch (kind) {
    case kSum: return run_gather<int, kSum, false>(indptr, nbr, nullptr, x, y, scratch, fnum, vp, ep, s);
    case kMin: return run_gather<int, kMin, false>(indptr, nbr, nullptr, x, y, scratch, fnum, vp, ep, s);
    case kMax: return run_gather<int, kMax, false>(indptr, nbr, nullptr, x, y, scratch, fnum, vp, ep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// int32 words of scratch that grape_gather_reduce_lanes(_i32) needs.
long long grape_gather_lanes_scratch_ints(int fnum, int vp, long long ep,
                                          int lanes) {
  const long long bpf = blocks_per_fragment(vp, ep);
  return fnum * (bpf + 1) + 2LL * lanes * fnum * bpf;
}

// The launch facts of the lane kernel that takes kMaxLaneGroup lanes at
// once, for one kind (see gather_config).
int grape_gather_lanes_config(int kind, int has_w, int is_int, int* out) {
  constexpr int G = kMaxLaneGroup;
  cudaError_t err = cudaErrorInvalidValue;
  if (is_int && !has_w && kind == kSum) err = gather_config<int, kSum, false, G>(out);
  else if (is_int && !has_w && kind == kMin) err = gather_config<int, kMin, false, G>(out);
  else if (is_int && !has_w && kind == kMax) err = gather_config<int, kMax, false, G>(out);
  else if (!is_int && kind == kSum) err = has_w ? gather_config<float, kSum, true, G>(out) : gather_config<float, kSum, false, G>(out);
  else if (!is_int && kind == kMin) err = has_w ? gather_config<float, kMin, true, G>(out) : gather_config<float, kMin, false, G>(out);
  else if (!is_int && kind == kMax) err = has_w ? gather_config<float, kMax, true, G>(out) : gather_config<float, kMax, false, G>(out);
  return static_cast<int>(err);
}

// y[lanes, fnum * vp] = gather-reduce of each lane of x (lanes >= 2; one
// lane is grape_gather_reduce) over the stacked CSR, x lane-minor:
// xt[pid * pitch + lane], 16-B aligned, pitch = lanes rounded up to 2
// (for 2 lanes) or 4 (pad lanes are read, never written; another pitch
// is refused); w may be null; scratch holds
// grape_gather_lanes_scratch_ints(fnum, vp, ep, lanes) int32 words.
// Returns the first launch error, cudaSuccess when all three launched.
int grape_gather_reduce_lanes(const int* indptr, const int* nbr,
                              const float* w, const float* xt, float* y,
                              int* scratch, int fnum, int vp, long long ep,
                              int kind, int lanes, int pitch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(fnum) * vp * lanes == 0) return cudaSuccess;
  if (lanes < 2 || pitch != lanes_pitch(lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case kSum: return run_gather_lanes_f32<kSum>(indptr, nbr, w, xt, y, scratch, fnum, vp, ep, lanes, s);
    case kMin: return run_gather_lanes_f32<kMin>(indptr, nbr, w, xt, y, scratch, fnum, vp, ep, lanes, s);
    case kMax: return run_gather_lanes_f32<kMax>(indptr, nbr, w, xt, y, scratch, fnum, vp, ep, lanes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// int32 sum / min / max of each lane of x over the stacked CSR, no
// weights (the identities of grape_gather_reduce_i32 on empty rows).
int grape_gather_reduce_lanes_i32(const int* indptr, const int* nbr,
                                  const int* xt, int* y, int* scratch,
                                  int fnum, int vp, long long ep, int kind,
                                  int lanes, int pitch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(fnum) * vp * lanes == 0) return cudaSuccess;
  if (lanes < 2 || pitch != lanes_pitch(lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case kSum: return run_gather_lanes<int, kSum, false>(indptr, nbr, nullptr, xt, y, scratch, fnum, vp, ep, lanes, s);
    case kMin: return run_gather_lanes<int, kMin, false>(indptr, nbr, nullptr, xt, y, scratch, fnum, vp, ep, lanes, s);
    case kMax: return run_gather_lanes<int, kMax, false>(indptr, nbr, nullptr, xt, y, scratch, fnum, vp, ep, lanes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Fold the delta overlay's real slots into y in place, every lane:
// y[b, f * vp + src[f, s]] = min(that, x[b, nbr[f, s]] + w[f, s]) for
// each slot with mask[f, s] (planes [fnum, cap], src sorted within a
// fragment), x [lanes, n] lane-major, y [lanes, fnum * vp]; w may be
// null.  Floats reduce in ordered_min's order (-0.0 below +0.0; no
// NaN).  One launch; returns its error.
int grape_overlay_fold(const int* src, const int* nbr, const float* w,
                       const unsigned char* mask, const float* x, float* y,
                       int fnum, int cap, int vp, long long n, int lanes,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(fnum) * cap * lanes == 0) return cudaSuccess;
  return static_cast<int>(
      w ? run_overlay_fold<float, true, false>(src, nbr, w, mask, x, y, fnum,
                                               cap, vp, n, lanes, s)
        : run_overlay_fold<float, false, false>(src, nbr, w, mask, x, y,
                                                fnum, cap, vp, n, lanes, s));
}

// The int32 overlay fold, no weights; plus_one adds BFS's hop to each
// slot's x first, the sentinel INT32_MAX kept.
int grape_overlay_fold_i32(const int* src, const int* nbr,
                           const unsigned char* mask, const int* x, int* y,
                           int fnum, int cap, int vp, long long n, int lanes,
                           int plus_one, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(fnum) * cap * lanes == 0) return cudaSuccess;
  return static_cast<int>(
      plus_one ? run_overlay_fold<int, false, true>(src, nbr, nullptr, mask,
                                                    x, y, fnum, cap, vp, n,
                                                    lanes, s)
               : run_overlay_fold<int, false, false>(src, nbr, nullptr, mask,
                                                     x, y, fnum, cap, vp, n,
                                                     lanes, s));
}

// int32 words of scratch that grape_strict_tile needs: two carry slots
// (row, then value) a tile.
long long grape_strict_scratch_ints(int fnum, int num_tiles) {
  return 4LL * fnum * num_tiles;
}

// y[fnum * vp] = strict-tile segment sum of values [fnum, ep] by their
// sorted src (pads: src == vp), tiles of `tile` edges.  Three passes on
// one stream: memset y, the tile kernel, the carry fold.  Returns the
// first launch error, cudaSuccess when all three launched.
int grape_strict_tile(const float* values, const int* src, float* y,
                      int* scratch, int fnum, long long ep, int num_tiles,
                      int tile, int vp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(fnum) * vp;
  if (rows == 0) return cudaSuccess;
  cudaError_t err = cudaMemsetAsync(y, 0, rows * sizeof(float), s);
  const long long slots = 2LL * fnum * num_tiles;
  if (err != cudaSuccess || slots == 0) return static_cast<int>(err);
  static const cudaError_t carve = cudaFuncSetAttribute(
      strict_segments_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);  // the tiles stream; no reuse in L1
  if (carve != cudaSuccess) return static_cast<int>(carve);
  int* carry_row = scratch;
  float* carry_val = reinterpret_cast<float*>(scratch + slots);
  const size_t smem = 2 * sizeof(int) * strict_region_ints(tile);
  strict_segments_kernel<<<dim3(num_tiles, fnum), kGatherThreads, smem, s>>>(
      values, src, y, carry_row, carry_val, ep, num_tiles, tile, vp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  carry_fold_kernel<float, kSum><<<static_cast<unsigned>(
      (slots + kFoldThreads - 1) / kFoldThreads), kFoldThreads, 0, s>>>(
      carry_row, carry_val, y, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
