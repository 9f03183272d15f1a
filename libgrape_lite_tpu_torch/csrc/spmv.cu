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
// folds.  On this card a warp can gather from L2 directly, so the kernel
// reads the CSR as it is, with no plan and no host preprocessing.
//   Bound: device-memory bytes.  Each edge costs 4 B of nbr (+4 B of w)
//   read once; x (4 MB at 2^20 vertices) stays in the 50 MB L2, so its
//   random reads cost L2 bandwidth rather than HBM bandwidth.
//   Design: one warp per row; lanes stride the row's edges (coalesced
//   nbr/w reads), each lane folds its edges in order, then a fixed
//   xor-butterfly shuffle combines the 32 lane values.  No atomics, so
//   reruns are bit-identical, and min/max equal any-order results.
//   Known weakness: degree skew.  A hub row of 10^5 edges keeps one warp
//   busy for ~3000 iterations while neighbours finish.
//   Value types: float (sum, min, max; optional weights) and int32 (min,
//   max; no weights) -- BFS depths and WCC labels, whose INT32_MAX
//   sentinels and pid range a float32 cannot carry exactly past 2^24.
//   Integer min/max is exact in any order, like the float min/max.
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

template <typename T, int KIND, bool HAS_W>
__global__ void gather_reduce_kernel(const int* __restrict__ indptr,
                                     const int* __restrict__ nbr,
                                     const float* __restrict__ w,
                                     const T* __restrict__ x,
                                     T* __restrict__ y, int vp,
                                     long long ep, long long rows) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const long long f = row / vp;
  const int r = static_cast<int>(row - f * vp);
  const int* ip = indptr + f * (static_cast<long long>(vp) + 1);
  const int begin = ip[r];
  const int end = ip[r + 1];
  const int* nb = nbr + f * ep;
  const float* wf = HAS_W ? w + f * ep : nullptr;
  T acc = identity<KIND>(T());
  for (int i = begin + lane; i < end; i += 32) {
    T v = __ldg(x + nb[i]);
    if constexpr (HAS_W) v = apply_weight<KIND>(v, wf[i]);
    acc = combine<KIND>(acc, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = combine<KIND>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) y[row] = acc;
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

template <int KIND>
void launch_gather(const int* indptr, const int* nbr, const float* w,
                   const float* x, float* y, int vp, long long ep,
                   long long rows, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((rows * 32 + threads - 1) / threads);
  if (w)
    gather_reduce_kernel<float, KIND, true><<<blocks, threads, 0, stream>>>(
        indptr, nbr, w, x, y, vp, ep, rows);
  else
    gather_reduce_kernel<float, KIND, false><<<blocks, threads, 0, stream>>>(
        indptr, nbr, w, x, y, vp, ep, rows);
}

template <int KIND>
void launch_gather_i32(const int* indptr, const int* nbr, const int* x,
                       int* y, int vp, long long ep, long long rows,
                       cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks =
      static_cast<unsigned>((rows * 32 + threads - 1) / threads);
  gather_reduce_kernel<int, KIND, false><<<blocks, threads, 0, stream>>>(
      indptr, nbr, nullptr, x, y, vp, ep, rows);
}

}  // namespace

extern "C" {

const char* grape_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y[fnum * vp] = gather-reduce of x over the stacked CSR; w may be null.
// Returns cudaGetLastError() after the launch.
int grape_gather_reduce(const int* indptr, const int* nbr, const float* w,
                        const float* x, float* y, int fnum, int vp,
                        long long ep, int kind, void* stream) {
  const long long rows = static_cast<long long>(fnum) * vp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    switch (kind) {
      case kSum: launch_gather<kSum>(indptr, nbr, w, x, y, vp, ep, rows, s); break;
      case kMin: launch_gather<kMin>(indptr, nbr, w, x, y, vp, ep, rows, s); break;
      case kMax: launch_gather<kMax>(indptr, nbr, w, x, y, vp, ep, rows, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// int32 min / max of x over the stacked CSR, no weights (rows without
// edges hold INT32_MAX / INT32_MIN).  Sum is refused.
int grape_gather_reduce_i32(const int* indptr, const int* nbr, const int* x,
                            int* y, int fnum, int vp, long long ep, int kind,
                            void* stream) {
  const long long rows = static_cast<long long>(fnum) * vp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    switch (kind) {
      case kMin: launch_gather_i32<kMin>(indptr, nbr, x, y, vp, ep, rows, s); break;
      case kMax: launch_gather_i32<kMax>(indptr, nbr, x, y, vp, ep, rows, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
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
