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
//   sublane_gather: tables of S * 512 bytes that fit a block's shared
//     memory after the opt-in (232,448 bytes on an H100: S <= 453, so 8
//     and 64 of the probe's 8, 64, 512, 8192) are staged there once per
//     block; the rest are read through L2 with __ldg.  The launcher
//     reports which placement it took.  Thread e reads row
//     idx[e] at column e % 128: a warp's 32 reads hit 32 different banks.
//   cumsum_lanes: one warp per row, 4 values a lane (one float4): a
//     sequential scan of the 4, a Hillis-Steele __shfl_up_sync scan of the
//     32 lane totals, and the exclusive lane total added to each.  The
//     order differs from torch.cumsum's; the plain version repeats it.
//     Held to |kernel - torch.cumsum| <= 1e-5 x the prefix sum of |a|.
// Indices are clamped into the table (the plain versions raise on an
// index out of range): the wrappers do not scan them, since a scan would
// add a reduction and a host sync to every timed call.

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

template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
    sublane_gather_kernel(const float* __restrict__ tab,
                          const int* __restrict__ idx,
                          float* __restrict__ out, long long n, int s) {
  extern __shared__ float staged[];
  const float* src = tab;
  if (SHARED) {
    for (int i = threadIdx.x; i < s * 128; i += blockDim.x)
      staged[i] = __ldg(tab + i);
    __syncthreads();
    src = staged;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const int row = min(max(__ldg(idx + e), 0), s - 1);
    const int at = row * 128 + static_cast<int>(e & 127);
    out[e] = SHARED ? src[at] : __ldg(src + at);
  }
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

// *placement is set to 1 when the table was staged in shared memory, to
// 0 when it was read through L2.
int grape_probe_sublane_gather(const float* tab, const int* idx, float* out,
                               long long n, int s, int* placement,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(s) * 128 * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const bool shared = bytes <= static_cast<size_t>(optin);
  *placement = shared ? 1 : 0;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long work = (n + kThreads - 1) / kThreads;
  if (shared) {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sublane_gather_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int blocks =
        persistent_blocks(sublane_gather_kernel<true>, bytes, work);
    sublane_gather_kernel<true><<<blocks, kThreads, bytes, st>>>(
        tab, idx, out, n, s);
  } else {
    const int blocks = persistent_blocks(sublane_gather_kernel<false>, 0,
                                         work);
    sublane_gather_kernel<false><<<blocks, kThreads, 0, st>>>(tab, idx, out,
                                                              n, s);
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
