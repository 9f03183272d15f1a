// Rate-probe kernels for Hopper (sm_90a), bound through ctypes: the
// primitives a gather SpMV is built from, measured alone.
//
// They replace the Pallas kernels of the JAX package's probe script
// (scripts/pallas_probe.py::main), one each:
//   stream            out = a * 2 + 1                     (vpu_stream, :65/:70)
//   lane_gather_t128  out[i,j] = tab[idx[i,j]], 128 entries (:85/:93)
//   sublane_gather    out[i,j] = tab[idx[i,j], j], S rows   (:117/:126)
//   cumsum_lanes      inclusive prefix sum of each 128-wide row (:147/:152)
// over E = rows * 128 f32 elements held as [rows, 128], int32 indices.
//
// Bound: device-memory bytes for all four: each element reads 4 B (a or
// idx) and writes 4 B, with one or two operations.  At E = 2^22 a plane
// is 16 MiB, so input and output (32 MiB) stay in the 50 MB L2 from one
// call to the next; at E = 2^26 (256 MiB a plane) they stream from HBM.
// The gathers' table reads are the part under test: a random 4-byte read
// costs a 32-byte sector wherever the table is not staged on chip.
//
// Design, shared by all four: a persistent grid (the SM count times the
// blocks of 1024 threads that fit on one SM, capped by the work) walks
// the elements with a grid-stride loop, so every launch fills the card
// whatever E is.
//   stream: 16-byte loads and stores (float4).  a * 2 is exact, so the
//     result is bit-equal to the plain version with or without an FMA.
//   lane_gather_t128: the 128-entry table lives in registers, 4 entries a
//     lane (lane l holds tab[l + 32k], k = 0..3); entry t comes from lane
//     t % 32 by __shfl_sync, four shuffles and a select by t / 32.  No
//     shared memory, so no bank conflicts on random entries.  Thread e
//     owns element e, so a warp reads 32 neighbouring indices (128 B).
//   sublane_gather: the caller (ops/probe.py::sublane_plan) picks where
//     the table is read from, by the card's per-block shared-memory
//     opt-in (232,448 bytes on an H100):
//     - shared: tables of S * 512 bytes that fit (S <= 453, so 8 and 64
//       of the probe's 8, 64, 512, 8192) are staged whole in each
//       block's shared memory.  Thread e reads row idx[e] at column
//       e % 128: a warp's 32 reads hit 32 different banks.
//     - sliced: larger tables are cut into column slices of c columns,
//       the widest c (128 % c == 0, c >= 4) whose S * c * 4 bytes fit
//       (S = 512: c = 64; S = 8192: c = 4; 128 KiB each).  A block owns
//       one slice, stages tab[:, j0:j0+c] once, column-major ([c][S]:
//       random rows of one column spread over the banks), and walks its
//       row group's quads (one int4 of idx, one float4 of out: 4
//       columns of a row), kSliceUnroll loads in flight a thread.  Each
//       table element then comes from shared memory, not from a 32-byte
//       L2 sector.  At c = 4 a row's slice is 16 B, half a sector of idx
//       and of out.  The slice varies fastest over the grid, and a
//       thread block cluster (kSliceCluster blocks) holds neighbouring
//       slices of one row group and walks its rows in lockstep, a
//       cluster barrier a step: L2 serves each sector's other half
//       within the step, and more of a row's bytes leave device memory
//       together (without the barrier the blocks drift apart, and S8192
//       took longer than a plain read of the table through L2: PERF.md).
//     Tables too large for a 4-column slice (S > 14,528) are refused.
//   cumsum_lanes: one warp per row, 4 values a lane (one float4): a
//     sequential scan of the 4, a Hillis-Steele __shfl_up_sync scan of the
//     32 lane totals, and the exclusive lane total added to each.  The
//     order differs from torch.cumsum's; the plain version repeats it.
//     Held to |kernel - torch.cumsum| <= 1e-5 x the prefix sum of |a|.
// Indices are clamped into the table (the plain versions raise on an
// index out of range): the wrappers do not scan them, since a scan would
// add a reduction and a host sync to every timed call.

#include <algorithm>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

template <typename Kernel>
int persistent_blocks(Kernel kernel, size_t smem, long long work_blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (work_blocks < blocks) blocks = work_blocks;
  return static_cast<int>(blocks > 0 ? blocks : 1);
}

__global__ void __launch_bounds__(kThreads)
    stream_kernel(const float4* __restrict__ a, float4* __restrict__ out,
                  long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 v = __ldg(a + i);
    v.x = v.x * 2.0f + 1.0f;
    v.y = v.y * 2.0f + 1.0f;
    v.z = v.z * 2.0f + 1.0f;
    v.w = v.w * 2.0f + 1.0f;
    out[i] = v;
  }
}

// n is a multiple of 32 and so is the grid's thread count: every warp
// runs the loop the same number of times, as the full-mask shuffles need.
__global__ void __launch_bounds__(kThreads)
    lane_gather_t128_kernel(const float* __restrict__ tab,
                            const int* __restrict__ idx,
                            float* __restrict__ out, long long n) {
  const int lane = threadIdx.x & 31;
  const float t0 = tab[lane], t1 = tab[lane + 32], t2 = tab[lane + 64],
              t3 = tab[lane + 96];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const int t = min(max(__ldg(idx + e), 0), 127);
    const int src = t & 31;
    const float g0 = __shfl_sync(0xffffffffu, t0, src);
    const float g1 = __shfl_sync(0xffffffffu, t1, src);
    const float g2 = __shfl_sync(0xffffffffu, t2, src);
    const float g3 = __shfl_sync(0xffffffffu, t3, src);
    const int k = t >> 5;
    out[e] = k == 0 ? g0 : (k == 1 ? g1 : (k == 2 ? g2 : g3));
  }
}

__global__ void __launch_bounds__(kThreads)
    sublane_gather_kernel(const float* __restrict__ tab,
                          const int* __restrict__ idx,
                          float* __restrict__ out, long long n, int s) {
  extern __shared__ float staged[];
  for (int i = threadIdx.x; i < s * 128; i += blockDim.x)
    staged[i] = __ldg(tab + i);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const int row = min(max(__ldg(idx + e), 0), s - 1);
    out[e] = staged[row * 128 + static_cast<int>(e & 127)];
  }
}

// Sliced sublane gather: block b owns column slice b % slices (c = 4 cq
// columns from j0) and row group b / slices; quad g of the slice plane is
// row g / cq, columns j0 + 4 (g % cq) .. + 3.  The blocks of a cluster
// hold neighbouring slices of one row group and walk its rows in
// lockstep (a cluster barrier a step), so the parts of a row that they
// read and write meet in L2 within one step.
constexpr int kSliceUnroll = 4;
// blocks a cluster: 64 columns at c = 4 (a non-portable size: 16 blocks
// of one SM each fit a GPC of the H100; 8, the portable limit, was
// slower: PERF.md)
constexpr int kSliceCluster = 16;

__device__ __forceinline__ int clamp_row(int i, int s) {
  return min(max(i, 0), s - 1);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    sublane_sliced_kernel(const float* __restrict__ tab,
                          const int* __restrict__ idx,
                          float* __restrict__ out, long long rows, int s,
                          int cq_log) {
  extern __shared__ float staged[];  // [c][s]
  const int cq = 1 << cq_log;
  const int slices = 32 >> cq_log;  // 128 / c
  const int slice = blockIdx.x % slices;
  const int group = blockIdx.x / slices;
  const int groups = gridDim.x / slices;
  const int q0 = slice * cq;  // the slice's first quad of a row
  // stage: table rows fastest, so a warp's 32 stores hit 32 banks
  for (int g = threadIdx.x; g < s * cq; g += blockDim.x) {
    const int q = g / s, r = g - q * s;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
                               tab + static_cast<long long>(r) * 128) +
                           q0 + q);
    float* col = staged + 4 * q * s + r;
    col[0] = v.x;
    col[s] = v.y;
    col[2 * s] = v.z;
    col[3 * s] = v.w;
  }
  __syncthreads();
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  const long long quads = rows << cq_log;
  const long long step = static_cast<long long>(groups) * blockDim.x;
  cluster_arrive();
  // the same trip count for every thread of the cluster (one row group)
  for (long long base = static_cast<long long>(group) * blockDim.x;
       base < quads; base += step * kSliceUnroll) {
    const long long g0 = base + threadIdx.x;
    int4 ix[kSliceUnroll];
    cluster_wait();  // no block starts a step before all issued the last
#pragma unroll
    for (int u = 0; u < kSliceUnroll; ++u) {
      const long long g = g0 + u * step;
      if (g < quads)
        ix[u] = __ldg(idx4 + (g >> cq_log) * 32 + q0 + (g & (cq - 1)));
    }
    cluster_arrive();
#pragma unroll
    for (int u = 0; u < kSliceUnroll; ++u) {
      const long long g = g0 + u * step;
      if (g < quads) {
        const int q = static_cast<int>(g & (cq - 1));
        const float* col = staged + 4 * q * s;
        float4 v;
        v.x = col[clamp_row(ix[u].x, s)];
        v.y = col[s + clamp_row(ix[u].y, s)];
        v.z = col[2 * s + clamp_row(ix[u].z, s)];
        v.w = col[3 * s + clamp_row(ix[u].w, s)];
        out4[(g >> cq_log) * 32 + q0 + q] = v;
      }
    }
  }
  cluster_wait();
}

__global__ void __launch_bounds__(kThreads)
    cumsum_lanes_kernel(const float4* __restrict__ a,
                        float4* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x) >> 5;
       row < rows; row += warps) {  // row is the same across the warp
    float4 v = __ldg(a + row * 32 + lane);
    v.y = v.x + v.y;
    v.z = v.y + v.z;
    v.w = v.z + v.w;
    float s = v.w;  // inclusive scan of the lane totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s = u + s;
    }
    float excl = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) excl = 0.0f;
    v.x = excl + v.x;
    v.y = excl + v.y;
    v.z = excl + v.z;
    v.w = excl + v.w;
    out[row * 32 + lane] = v;
  }
}

}  // namespace

extern "C" {

const char* grape_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns cudaGetLastError() after its launch.  n counts
// f32 elements (rows * 128).

int grape_probe_stream(const float* a, float* out, long long n,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n4 = n / 4;
  if (n4 > 0) {
    const int blocks = persistent_blocks(stream_kernel, 0,
                                         (n4 + kThreads - 1) / kThreads);
    stream_kernel<<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(out),
        n4);
  }
  return static_cast<int>(cudaGetLastError());
}

int grape_probe_lane_gather_t128(const float* tab, const int* idx,
                                 float* out, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int blocks = persistent_blocks(lane_gather_t128_kernel, 0,
                                         (n + kThreads - 1) / kThreads);
    lane_gather_t128_kernel<<<blocks, kThreads, 0, st>>>(tab, idx, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// cols (ops/probe.py::sublane_plan): 128 stages the whole table in
// shared memory, 4..64 (a power of two) column slices of it.
int grape_probe_sublane_gather(const float* tab, const int* idx, float* out,
                               long long n, int s, int cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(s) * cols * sizeof(float);
  const bool sliced = cols >= 4 && cols < 128 && (cols & (cols - 1)) == 0;
  if (cols != 128 && !sliced)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long work = (n + kThreads - 1) / kThreads;
  if (sliced) {
    const auto kernel = sublane_sliced_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    int cq_log = 0;
    while ((4 << cq_log) < cols) ++cq_log;
    const int slices = 128 / cols;
    const int csize = std::min(kSliceCluster, slices);  // divides slices
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = csize;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(csize);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err == cudaSuccess && clusters == 0)
      err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return static_cast<int>(err);
    // every slice gets the same number of row groups (the resident
    // clusters' blocks), each at least a block's worth of quads
    const long long rows = n / 128;
    const long long quads = rows << cq_log;
    long long groups = static_cast<long long>(clusters) * csize / slices;
    groups = std::min(groups, (quads + kThreads - 1) / kThreads);
    groups = std::max(groups, 1LL);
    cfg.gridDim = dim3(static_cast<unsigned>(groups * slices));
    err = cudaLaunchKernelEx(&cfg, kernel, tab, idx, out, rows, s, cq_log);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sublane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int blocks = persistent_blocks(sublane_gather_kernel, bytes, work);
    sublane_gather_kernel<<<blocks, kThreads, bytes, st>>>(tab, idx, out, n,
                                                           s);
  }
  return static_cast<int>(cudaGetLastError());
}

int grape_probe_cumsum_lanes(const float* a, float* out, long long rows,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    const int blocks = persistent_blocks(
        cumsum_lanes_kernel, 0, (rows * 32 + kThreads - 1) / kThreads);
    cumsum_lanes_kernel<<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(out),
        rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
