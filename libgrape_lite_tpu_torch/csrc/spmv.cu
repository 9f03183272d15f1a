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
//     pass 3 (carry_fold_kernel): the first block of each run of carries
//       for one row folds the run, a warp in block order, into y[row].
//   No atomics: sums are bit-identical from rerun to rerun, min and max
//   equal any-order results.  Pads after a fragment's indptr[vp] edges
//   lie past its merge path; offsets f * ep are 64-bit.  The carve-out
//   gives shared memory only what the resident blocks need, leaving L1
//   for RMAT's hot x columns.
//   Value types: float (sum, min, max; optional weights) and int32 (min,
//   max; no weights) -- BFS depths and WCC labels, whose INT32_MAX
//   sentinels and pid range a float32 cannot carry exactly past 2^24.
//
// strict_tile replaces the strict-tile Pallas kernel
// (libgrape_lite_tpu/ops/spmv.py::_spmv_partials, body _spmv_tile_kernel)
// together with the XLA scatter-add that folds its tile partials
// (spmv_strict).  Edges are cut into equal tiles of `tile` edges (exact
// edge balance); tile t owns the row window [row_lo[t], row_lo[t]+rmax).
//   Bound: device-memory bytes: per edge 4 B value + 4 B src, plus the
//   num_tiles * rmax partials written and read back once.
//   Design: pass 1 is one block per tile.  It stages the tile's values and
//   local row ids in shared memory; thread j binary-searches the run of
//   edges of window row j (edges are row-sorted) and sums it in edge
//   order.  That replaces the TPU's one-hot MXU product, which costs
//   tile * rmax multiply-adds, with tile adds.  Pass 2 is one thread per
//   output row: it finds the tiles whose window covers the row (row_lo is
//   non-decreasing) and adds their partials in tile order, the order of
//   the XLA scatter-add.  Pad edges (src == vp, or past ep) fall outside
//   every real row and are never read back.

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
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&s_bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(&s_bar)), "r"(rb + eb + wb) : "memory");
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
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(&s_bar)) : "memory");
  } while (!done);

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
  // (keys rise with tid), in a fixed order: reruns are bit-identical
  int key = xr;
  T val = acc;
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
  // the scanned tail of the thread before (its key is x0): the part of
  // this thread's head row that earlier threads of the block hold
  T prev = __shfl_up_sync(0xffffffffu, val, 1);
  if (lane == 0) prev = warp > 0 ? s_wval[warp - 1] : ident;
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

// Pass 3: one warp per block carry; the first block of each run of
// carries for one row folds the run into y[row], which the block holding
// the row's end wrote.  The warp reads 32 kFoldUnroll carries at a time
// (a hub row of 2^22 edges leaves 4,096); each lane folds its share in
// block order and a fixed butterfly joins the lanes.
template <typename T, int KIND>
__global__ void carry_fold_kernel(const int* __restrict__ carry_row,
                                  const T* __restrict__ carry_val,
                                  T* __restrict__ y, long long nblocks) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= nblocks) return;  // the whole warp leaves together
  const int key = carry_row[b];
  if (key < 0 || (b > 0 && carry_row[b - 1] == key)) return;
  T acc = identity<KIND>(T());
  for (long long base = b;; base += 32 * kFoldUnroll) {
    bool mine[kFoldUnroll], all = true;
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) {
      const long long j = base + u * 32 + lane;
      mine[u] = j < nblocks && carry_row[j] == key;
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
  if (lane == 0) y[key] = combine<KIND>(acc, y[key]);
}

// first index i in [0, n) with a[i] >= key (n when none)
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void strict_partials_kernel(const float* __restrict__ values,
                                       const int* __restrict__ src,
                                       const int* __restrict__ row_lo,
                                       float* __restrict__ partials,
                                       long long ep, int num_tiles, int tile,
                                       int rmax, int vp) {
  extern __shared__ int s_local[];  // [tile] local rows, then [tile] values
  float* s_val = reinterpret_cast<float*>(s_local + tile);
  const int t = blockIdx.x;
  const long long f = blockIdx.y;
  const long long tile_id = f * num_tiles + t;
  const int lo = row_lo[tile_id];
  const long long e0 = static_cast<long long>(t) * tile;
  const float* vf = values + f * ep;
  const int* sf = src + f * ep;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long e = e0 + i;
    const bool in = e < ep;
    s_local[i] = (in ? sf[e] : vp) - lo;  // past ep: a pad row
    s_val[i] = in ? vf[e] : 0.0f;
  }
  __syncthreads();
  float* out = partials + tile_id * rmax;
  for (int j = threadIdx.x; j < rmax; j += blockDim.x) {
    const int a = lower_bound(s_local, tile, j);
    const int b = lower_bound(s_local, tile, j + 1);
    float acc = 0.0f;
    for (int i = a; i < b; ++i) acc += s_val[i];
    out[j] = acc;
  }
}

__global__ void strict_fold_kernel(const float* __restrict__ partials,
                                   const int* __restrict__ row_lo,
                                   float* __restrict__ y, int num_tiles,
                                   int rmax, int vp, long long rows) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (g >= rows) return;
  const long long f = g / vp;
  const int r = static_cast<int>(g - f * vp);
  const int* lo_f = row_lo + f * num_tiles;
  // tiles whose window [lo, lo + rmax) holds r: lo in (r - rmax, r]
  const int t_begin = lower_bound(lo_f, num_tiles, r - rmax + 1);
  const int t_end = lower_bound(lo_f, num_tiles, r + 1);
  const float* pf = partials + f * num_tiles * static_cast<long long>(rmax);
  float acc = 0.0f;
  for (int t = t_begin; t < t_end; ++t)
    acc += pf[static_cast<long long>(t) * rmax + (r - lo_f[t])];
  y[g] = acc;
}

long long blocks_per_fragment(int vp, long long ep) {
  return (vp + ep + kItemsPerBlock - 1) / kItemsPerBlock;
}

// Gather-kernel facts for reports: {threads, items per thread, static
// shared bytes, registers, resident blocks per SM, carve-out percent}.
// The first call sets the carve-out: shared memory for as many blocks
// as the SM holds by threads and registers, the rest of the SM's 256 KB
// left to L1, where the hot x columns are reused.
template <typename T, int KIND, bool HAS_W>
cudaError_t gather_config(int* out) {
  static int cfg[6] = {0, 0, 0, 0, 0, -1};
  if (cfg[5] < 0) {
    const auto kernel = merge_gather_kernel<T, KIND, HAS_W>;
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
      (nblocks * 32 + kFoldThreads - 1) / kFoldThreads),
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
  if (is_int && !has_w && kind == kMin) err = gather_config<int, kMin, false>(out);
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

// int32 min / max of x over the stacked CSR, no weights (rows without
// edges hold INT32_MAX / INT32_MIN).  Sum is refused.
int grape_gather_reduce_i32(const int* indptr, const int* nbr, const int* x,
                            int* y, int* scratch, int fnum, int vp,
                            long long ep, int kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(fnum) * vp == 0) return cudaSuccess;
  switch (kind) {
    case kMin: return run_gather<int, kMin, false>(indptr, nbr, nullptr, x, y, scratch, fnum, vp, ep, s);
    case kMax: return run_gather<int, kMax, false>(indptr, nbr, nullptr, x, y, scratch, fnum, vp, ep, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// y[fnum * vp] = strict-tile segment sum of values by sorted src; the
// caller allocates partials[fnum * num_tiles * rmax].
int grape_strict_tile(const float* values, const int* src,
                      const int* row_lo, float* partials, float* y, int fnum,
                      long long ep, int num_tiles, int tile, int rmax, int vp,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(tile) * (sizeof(int) + sizeof(float));
  dim3 grid(num_tiles, fnum);
  strict_partials_kernel<<<grid, 256, smem, s>>>(values, src, row_lo,
                                                 partials, ep, num_tiles,
                                                 tile, rmax, vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(fnum) * vp;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((rows + threads - 1) / threads);
  if (rows > 0)
    strict_fold_kernel<<<blocks, threads, 0, s>>>(partials, row_lo, y,
                                                  num_tiles, rmax, vp, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
