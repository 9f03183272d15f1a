// Build-capability probe `mxu_dot` (compiled, never launched).
//
// Counterpart of k_mxu_dot in the JAX package's lowering probe
// (libgrape_lite_tpu/ops/pallas_kernels.py::_CAP_PROBE): one
// [128, 128] @ [128, 128] f32 product on the matrix unit.  On Hopper that
// unit is reached through wgmma.mma_async, which exists only for sm_90a.
// tf32 is its only f32-input type, so the operands are rounded to tf32
// (cvt.rna) when staged and the sum is kept in f32.
//
// Layout: both operands sit in shared memory K-major, without swizzle, as
// 8-row x 16-byte core matrices (128 contiguous bytes):
//   offset(r, k) = (r / 8) * SBO + (k / 4) * LBO + (r % 8) * 16 + (k % 4) * 4
// with LBO = 128 B (the next core matrix along K) and SBO = 4096 B (the
// next 8-row group, after all 32 core matrices of K = 128).  A is x as
// given ([M][K]); B must be K-major for tf32 (no transpose bit), so y is
// stored transposed ([N][K]).  256 threads are two warpgroups; warpgroup
// g computes rows 64g .. 64g+63 with 16 m64n128k8 steps along K.  The
// sequence per warpgroup: stage, fence.proxy.async (make the generic
// stores visible to wgmma's async proxy), __syncthreads, wgmma.fence,
// 16 x mma_async, commit_group, wait_group 0, then the accumulators.
// A launch needs 128 KiB of dynamic shared memory (above the 48 KiB
// default, so after cudaFuncSetAttribute's opt-in).

#include <cstdint>

namespace {

constexpr int kDim = 128;
constexpr uint32_t kLbo = 128;                 // bytes
constexpr uint32_t kSbo = (kDim / 4) * 128;    // 4096 bytes
constexpr uint32_t kOperandBytes = kDim / 8 * kSbo;  // 64 KiB

__device__ __forceinline__ uint32_t smem_offset(int r, int k) {
  return (r >> 3) * kSbo + (k >> 2) * kLbo + (r & 7) * 16 + (k & 3) * 4;
}

// Matrix descriptor, no swizzle: start address, LBO and SBO in 16-byte
// units (bits 0-13, 16-29, 32-45); base offset and layout type 0.
__device__ __forceinline__ uint64_t descriptor(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] += A(64 x 8) * B(8 x 128), scale-d = 1
__device__ __forceinline__ void mma_m64n128k8(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace

__global__ void __launch_bounds__(256)
    caps_mxu_dot(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  for (int i = threadIdx.x; i < kDim * kDim; i += blockDim.x) {
    const int r = i / kDim, c = i % kDim;
    // A[r][k = c] = x[r][c];  B^T[n = c][k = r] = y[r][c]
    *reinterpret_cast<float*>(smem + smem_offset(r, c)) = to_tf32(x[i]);
    *reinterpret_cast<float*>(smem + kOperandBytes + smem_offset(c, r)) =
        to_tf32(y[i]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kDim / 8; ++s) {
    const uint32_t a = base + smem_offset(64 * wg, 8 * s);
    const uint32_t b = base + kOperandBytes + smem_offset(0, 8 * s);
    mma_m64n128k8(d, descriptor(a), descriptor(b));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);

  // accumulator i of thread (warp w, lane l) of the warpgroup holds
  // row 16w + l/4 + 8 * ((i/2) % 2), column 8 * (i/4) + 2 * (l % 4) + i % 2
  const int w = (threadIdx.x >> 5) & 3, l = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = 64 * wg + 16 * w + l / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (l & 3) + (i & 1);
    out[row * kDim + col] = d[i];
  }
}
