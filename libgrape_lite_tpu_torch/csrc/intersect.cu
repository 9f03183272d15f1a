// Row AND-popcount for Hopper (sm_90a), bound through ctypes.
//
//   out[i] = sum_w popc(A[ia[i], w] & B[ib[i], w])
//
// A [ra, words] and B [rb, words] are packed row bitmaps (int32 words
// holding uint32 bit patterns), ia / ib [n] int32 row indices, out [n]
// int32.  A null index array reads row i itself, which is the dense form
// out[i] = sum_w popc(A[i, w] & B[i, w]).
//
// Replaces the Pallas kernel of the JAX package's set-intersection step
// (libgrape_lite_tpu/ops/pallas_kernels.py::intersect_count, body
// _intersect_kernel), which ANDs [block, words] row tiles resident in
// VMEM and reduces their popcounts on the VPU.  The JAX callers (LCC's
// bitmap kernels) gather the rows into [chunk, words] operands in XLA
// before the call; here the kernel gathers them itself, so the gathered
// copies are never written to device memory and read back.
//   Bound: device-memory bytes.  Each pair reads two rows of `words` words
//   and does words ANDs, popcounts and adds; the words are mostly zero on
//   sparse graphs, so the kernel streams rows at the memory rate.  Rows
//   that many pairs share (hub vertices) may hit in the 50 MB L2.
//   Design: one warp per pair.  Lanes stride the two rows with 16-byte
//   loads when words % 4 == 0 and the bases are 16-byte aligned (scalar
//   loads otherwise), each lane sums __popc of its words, and a fixed
//   xor-butterfly shuffle adds the 32 lane sums.  Integer sums are exact
//   in any order.  Row offsets are 64-bit: a bitmap of 2^18 rows of 8192
//   words holds 2^31 words.
//   Left for a speed PR: staging hub rows in shared memory and skipping
//   all-zero words.

#include <cuda_runtime.h>

namespace {

template <bool VEC>
__global__ void row_and_popcount_kernel(const int* __restrict__ a,
                                        const int* __restrict__ ia,
                                        const int* __restrict__ b,
                                        const int* __restrict__ ib,
                                        int* __restrict__ out, long long n,
                                        int words) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // the whole warp leaves together
  const long long row_a = ia ? static_cast<long long>(ia[i]) : i;
  const long long row_b = ib ? static_cast<long long>(ib[i]) : i;
  const int* pa = a + row_a * words;
  const int* pb = b + row_b * words;
  int acc = 0;
  if (VEC) {
    const int4* va = reinterpret_cast<const int4*>(pa);
    const int4* vb = reinterpret_cast<const int4*>(pb);
    const int nv = words >> 2;
#pragma unroll 4
    for (int j = lane; j < nv; j += 32) {
      const int4 x = __ldg(va + j);
      const int4 y = __ldg(vb + j);
      acc += __popc(static_cast<unsigned>(x.x & y.x)) +
             __popc(static_cast<unsigned>(x.y & y.y)) +
             __popc(static_cast<unsigned>(x.z & y.z)) +
             __popc(static_cast<unsigned>(x.w & y.w));
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < words; j += 32)
      acc += __popc(static_cast<unsigned>(__ldg(pa + j) & __ldg(pb + j)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[i] = acc;
}

}  // namespace

extern "C" {

const char* grape_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[n] = row AND-popcount of (a[ia[i]], b[ib[i]]); ia / ib may be null.
// vec != 0 selects 16-byte loads (words % 4 == 0, bases 16-byte aligned).
// Returns cudaGetLastError() after the launch.
int grape_row_and_popcount(const int* a, const int* ia, const int* b,
                           const int* ib, int* out, long long n, int words,
                           int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks =
        static_cast<unsigned>((n * 32 + threads - 1) / threads);
    if (vec)
      row_and_popcount_kernel<true><<<blocks, threads, 0, s>>>(
          a, ia, b, ib, out, n, words);
    else
      row_and_popcount_kernel<false><<<blocks, threads, 0, s>>>(
          a, ia, b, ib, out, n, words);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
