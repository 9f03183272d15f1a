// Build-capability probe `int_reduce` (compiled, never launched).
//
// Counterpart of k_int_reduce in the JAX package's lowering probe
// (libgrape_lite_tpu/ops/pallas_kernels.py::_CAP_PROBE):
//   out[i, j] = x[i, j] + (float) sum_j' idx[i, j'],
// x [8, 128] f32, idx [8, 128] int32: an integer row sum added to floats.
// One warp per row, 4 values a lane; the lane sums meet in
// __reduce_add_sync, the warp-wide integer add of sm_80 and later (it
// takes 32-bit integers only).

__global__ void caps_int_reduce(const float* __restrict__ x,
                                const int* __restrict__ idx,
                                float* __restrict__ out) {
  const int row = threadIdx.x >> 5;  // blockDim.x == 256: 8 warps, 8 rows
  const int lane = threadIdx.x & 31;
  const int4 k = reinterpret_cast<const int4*>(idx + row * 128)[lane];
  const int total = __reduce_add_sync(0xffffffffu, k.x + k.y + k.z + k.w);
  const float add = static_cast<float>(total);
  const float4 v = reinterpret_cast<const float4*>(x + row * 128)[lane];
  reinterpret_cast<float4*>(out + row * 128)[lane] =
      make_float4(v.x + add, v.y + add, v.z + add, v.w + add);
}
