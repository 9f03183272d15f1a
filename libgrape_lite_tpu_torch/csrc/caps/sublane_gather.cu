// Build-capability probe `sublane_gather` (compiled, never launched).
//
// Counterpart of k_sublane_gather in the JAX package's lowering probe
// (libgrape_lite_tpu/ops/pallas_kernels.py::_CAP_PROBE):
//   out[i, j] = x[idx[i, j], j],  x [8, 128] f32, idx [8, 128] int16,
// the gather along the row axis that a TPU does across sublanes.  Here x
// is staged in shared memory and each thread reads its row of it; thread
// t owns element t = i * 128 + j, so the 32 lanes of a warp read 32
// neighbouring columns, one per bank.

#include <cstdint>

__global__ void caps_sublane_gather(const float* __restrict__ x,
                                    const int16_t* __restrict__ idx,
                                    float* __restrict__ out) {
  __shared__ float xs[8 * 128];
  const int t = threadIdx.x;  // blockDim.x == 1024
  xs[t] = x[t];
  __syncthreads();
  out[t] = xs[static_cast<int>(idx[t]) * 128 + (t & 127)];
}
