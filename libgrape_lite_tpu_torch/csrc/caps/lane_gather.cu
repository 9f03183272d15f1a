// Build-capability probe `lane_gather` (compiled, never launched).
//
// Counterpart of k_lane_gather in the JAX package's lowering probe
// (libgrape_lite_tpu/ops/pallas_kernels.py::_CAP_PROBE):
//   out[i, j] = x[i, idx[i, j]],  x [8, 128] f32, idx [8, 128] int8,
// the gather within a row that a TPU does across lanes.  One warp holds a
// row in registers, 4 values a lane (lane l holds columns 4l .. 4l+3), and
// fetches column k from lane k / 4 with __shfl_sync: four shuffles, one
// per register, then a select by k % 4.

#include <cstdint>

__global__ void caps_lane_gather(const float* __restrict__ x,
                                 const int8_t* __restrict__ idx,
                                 float* __restrict__ out) {
  const int row = threadIdx.x >> 5;  // blockDim.x == 256: 8 warps, 8 rows
  const int lane = threadIdx.x & 31;
  const float4 v = reinterpret_cast<const float4*>(x + row * 128)[lane];
  float r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int k = static_cast<int>(idx[row * 128 + 4 * lane + c]) & 127;
    const float g0 = __shfl_sync(0xffffffffu, v.x, k >> 2);
    const float g1 = __shfl_sync(0xffffffffu, v.y, k >> 2);
    const float g2 = __shfl_sync(0xffffffffu, v.z, k >> 2);
    const float g3 = __shfl_sync(0xffffffffu, v.w, k >> 2);
    const int s = k & 3;
    r[c] = s == 0 ? g0 : (s == 1 ? g1 : (s == 2 ? g2 : g3));
  }
  reinterpret_cast<float4*>(out + row * 128)[lane] =
      make_float4(r[0], r[1], r[2], r[3]);
}
