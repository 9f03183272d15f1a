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
//   Bound: device-memory bytes, counting each distinct row a call names
//   once.  Sparse graphs leave the rows almost empty: an N+ row of the
//   RMAT-18 bitmap LCC holds ~14.5 set bits in 8,192 words, so >= 99.8%
//   of the words are zero.  Streaming both rows of every pair (the first
//   design, a warp per pair) read 249 GB per call, 24x the bound even
//   with L2 hits.
//   Design, indexed form, in one call:
//     mark_rows_kernel: flags the rows ia / ib name (all rows when an
//       index is null; one flag array when a is b);
//     row_occupancy_kernel: a warp per flagged row reads the row once and
//       writes its occupancy summary, one bit per 16-byte group of four
//       words (the last group ragged when words % 4 != 0): 64 words, 256
//       B, for an 8,192-word row; 32 lanes' group bits are one ballot.
//       Each distinct row is read once: this pass runs near the byte bound;
//     pair_popcount_kernel: 8 lanes per pair AND the two summary rows and,
//       for each group set in both, load that int4 of both rows and add
//       the popcount of their AND: ~0.5 KiB of summaries and 32 B per
//       common group a pair, instead of 64 KiB of rows.
//   What bounds the pair pass is the count of random 16-byte loads, two
//   per group set in both summaries (hub columns fill the low groups of
//   many rows, and many such groups hold no common bit).  Reading them
//   from a compact L2-sized copy of the rows' groups, from a per-warp
//   shared-memory stage of the repeated row, or with a lane per summary
//   bit was slower on the card (PERF.md).  Pairs in any order are
//   correct; in the callers' order the row repeated over a run of pairs
//   stays in L1.
//   The dense form (both indices null) streams both rows, as before: it
//   reads each row once anyway.  16-byte loads when words % 4 == 0 and
//   the bases are 16-byte aligned (scalar loads otherwise); integer sums
//   are exact in any order.  Row offsets are 64-bit: a bitmap of 2^18
//   rows of 8192 words holds 2^31 words.

#include <cuda_runtime.h>

namespace {

template <bool VEC>
__global__ void row_and_popcount_kernel(const int* __restrict__ a,
                                        const int* __restrict__ b,
                                        int* __restrict__ out, long long n,
                                        int words) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // the whole warp leaves together
  const int* pa = a + i * words;
  const int* pb = b + i * words;
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

constexpr int kThreads = 256;
constexpr int kGroupWords = 4;  // one occupancy bit per 16-byte group
constexpr int kBatch = 8;       // summary words a lane holds per batch
constexpr int kPairLanes = 8;   // lanes per pair in the pair pass

__global__ void mark_rows_kernel(const int* __restrict__ idx, long long n,
                                 unsigned char* __restrict__ flags) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) flags[idx[i]] = 1;  // racing writers store the same byte
}

// group g of a row as int4, a ragged last group padded with zero words
template <bool VEC>
__device__ __forceinline__ int4 load_group(const int* __restrict__ row,
                                           int g, int words) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(row) + g);
  const int w = g * kGroupWords;
  int4 v;
  v.x = __ldg(row + w);
  v.y = w + 1 < words ? __ldg(row + w + 1) : 0;
  v.z = w + 2 < words ? __ldg(row + w + 2) : 0;
  v.w = w + 3 < words ? __ldg(row + w + 3) : 0;
  return v;
}

__device__ __forceinline__ int and_popc(int4 x, int4 y) {
  return __popc(static_cast<unsigned>(x.x & y.x)) +
         __popc(static_cast<unsigned>(x.y & y.y)) +
         __popc(static_cast<unsigned>(x.z & y.z)) +
         __popc(static_cast<unsigned>(x.w & y.w));
}

// Summary pass.  occ[r, j] bit l = group 32 j + l of row r is not all
// zero, for every flagged row (every row when flags is null); other rows
// stay unwritten.  A warp per row, kBatch 16-byte loads a lane in flight.
template <bool VEC>
__global__ void row_occupancy_kernel(const int* __restrict__ bm,
                                     long long rows, int words, int sw,
                                     const unsigned char* __restrict__ flags,
                                     unsigned* __restrict__ occ) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows || (flags && !flags[r])) return;  // warp-uniform
  const int* row = bm + r * words;
  unsigned* out = occ + r * sw;
  const int groups = (words + kGroupWords - 1) / kGroupWords;
  for (int j0 = 0; j0 < sw; j0 += kBatch) {
    bool nz[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int g = (j0 + k) * 32 + lane;
      if (g < groups) {
        const int4 v = load_group<VEC>(row, g, words);
        nz[k] = (v.x | v.y | v.z | v.w) != 0;
      } else {
        nz[k] = false;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (j0 + k >= sw) break;  // warp-uniform
      const unsigned bits = __ballot_sync(0xffffffffu, nz[k]);
      if (lane == 0) out[j0 + k] = bits;
    }
  }
}

// Pair pass: kPairLanes lanes per pair, lane s on summary words j0 +
// k kPairLanes + s.  Each lane ANDs its kBatch words of both summaries
// (all loads issued together), then loads the groups set in both, two at
// a time (four 16-byte loads in flight), and adds the popcounts of their
// AND.  In the callers' order the second row (ib) repeats over a run of
// pairs, so its summary and groups come from L1.
template <bool VEC>
__global__ void pair_popcount_kernel(const int* __restrict__ a,
                                     const int* __restrict__ ia,
                                     const unsigned* __restrict__ occ_a,
                                     const int* __restrict__ b,
                                     const int* __restrict__ ib,
                                     const unsigned* __restrict__ occ_b,
                                     int* __restrict__ out, long long n,
                                     int words, int sw) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = t / kPairLanes;
  const int sub = static_cast<int>(t % kPairLanes);
  int acc = 0;
  if (i < n) {
    const long long row_a = ia ? static_cast<long long>(ia[i]) : i;
    const long long row_b = ib ? static_cast<long long>(ib[i]) : i;
    const unsigned* oa = occ_a + row_a * sw;
    const unsigned* ob = occ_b + row_b * sw;
    const int* pa = a + row_a * words;
    const int* pb = b + row_b * words;
    for (int j0 = 0; j0 < sw; j0 += kPairLanes * kBatch) {
      unsigned m[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = j0 + k * kPairLanes + sub;
        m[k] = j < sw ? __ldg(oa + j) & __ldg(ob + j) : 0u;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int base = (j0 + k * kPairLanes + sub) * 32;
        unsigned mm = m[k];
        while (mm) {
          const int g1 = base + __ffs(mm) - 1;
          mm &= mm - 1;
          const bool two = mm != 0;
          const int g2 = two ? base + __ffs(mm) - 1 : g1;
          mm &= two ? mm - 1 : mm;
          const int c1 = and_popc(load_group<VEC>(pa, g1, words),
                                  load_group<VEC>(pb, g1, words));
          const int c2 = and_popc(load_group<VEC>(pa, g2, words),
                                  load_group<VEC>(pb, g2, words));
          acc += c1 + (two ? c2 : 0);
        }
      }
    }
  }
#pragma unroll
  for (int off = kPairLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (i < n && sub == 0) out[i] = acc;
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <bool VEC>
cudaError_t run_indexed(const int* a, const int* ia, unsigned char* flags_a,
                        unsigned* occ_a, long long rows_a, const int* b,
                        const int* ib, unsigned char* flags_b,
                        unsigned* occ_b, long long rows_b, int* out,
                        long long n, int words, int sw, bool same,
                        cudaStream_t s) {
  cudaError_t err;
  if (same) flags_b = flags_a;  // a is b: one flag array, one summary
  if (ia && flags_a) {
    mark_rows_kernel<<<blocks_for(n), kThreads, 0, s>>>(ia, n, flags_a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (ib && flags_b) {
    mark_rows_kernel<<<blocks_for(n), kThreads, 0, s>>>(ib, n, flags_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  row_occupancy_kernel<VEC><<<blocks_for(rows_a * 32), kThreads, 0, s>>>(
      a, rows_a, words, sw, flags_a, occ_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (!same) {
    row_occupancy_kernel<VEC><<<blocks_for(rows_b * 32), kThreads, 0, s>>>(
        b, rows_b, words, sw, flags_b, occ_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  pair_popcount_kernel<VEC><<<blocks_for(n * kPairLanes), kThreads, 0, s>>>(
      a, ia, occ_a, b, ib, same ? occ_a : occ_b, out, n, words, sw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* grape_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dense form: out[n] = row AND-popcount of (a[i], b[i]), streaming both
// rows.  vec != 0 selects 16-byte loads (words % 4 == 0, bases 16-byte
// aligned).  Returns cudaGetLastError() after the launch.
int grape_row_and_popcount(const int* a, const int* b, int* out,
                           long long n, int words, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks =
        static_cast<unsigned>((n * 32 + threads - 1) / threads);
    if (vec)
      row_and_popcount_kernel<true><<<blocks, threads, 0, s>>>(
          a, b, out, n, words);
    else
      row_and_popcount_kernel<false><<<blocks, threads, 0, s>>>(
          a, b, out, n, words);
  }
  return static_cast<int>(cudaGetLastError());
}

// Indexed form: out[n] = row AND-popcount of (a[ia[i]], b[ib[i]]) through
// occupancy summaries; ia / ib may be null (row i).  The caller gives
// zeroed flags[rows] for each side whose index is not null (else null:
// every row is summarised) and occ[rows * sw] summaries, sw =
// ceil(ceil(words / 4) / 32); same != 0 when a is b, and then the a-side
// buffers serve both (flags_a null when either index is).  Returns the
// first launch error.
int grape_row_and_popcount_indexed(const int* a, const int* ia,
                                   unsigned char* flags_a, unsigned* occ_a,
                                   long long rows_a, const int* b,
                                   const int* ib, unsigned char* flags_b,
                                   unsigned* occ_b, long long rows_b,
                                   int* out, long long n, int words, int sw,
                                   int vec, int same, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(
      vec ? run_indexed<true>(a, ia, flags_a, occ_a, rows_a, b, ib, flags_b,
                              occ_b, rows_b, out, n, words, sw, same != 0, s)
          : run_indexed<false>(a, ia, flags_a, occ_a, rows_a, b, ib,
                               flags_b, occ_b, rows_b, out, n, words, sw,
                               same != 0, s));
}

}  // extern "C"
