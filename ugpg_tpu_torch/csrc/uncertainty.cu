// Uncertainty map from logits: A = 1 - 2 |sigmoid(x) - 0.5|, pointwise.
//
// Replaces: ugpg_tpu/ops/pallas/uncertainty_fused.py, uncertainty_from_logits
//           (kernel body _unc_kernel).
// Bound on the H100: memory.  One read and one write of the tensor (8 bytes
//   per element in float32) and ~20 operations per element, far below the
//   ~295 operations per byte at which the card stops being memory-bound.
// Design: one grid-stride pass over the flat tensor, coalesced loads and
//   stores, float32 math.  No padding to (256, 128) tiles as on the TPU: the
//   ragged tail is simply the loop bound.  The flat index is int64 (the JAX
//   side once mis-masked past 2^24 elements with a float index compare).

#include "common.cuh"

namespace {

template <typename T>
__global__ void uncertainty_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float p = 1.0f / (1.0f + expf(-ugpg::to_float(x[i])));
    out[i] = ugpg::from_float<T>(1.0f - 2.0f * fabsf(p - 0.5f));
  }
}

}  // namespace

// x, out: n elements of the same dtype and the same dense layout.
extern "C" int ugpg_uncertainty_from_logits(const void* x, void* out, int64_t n, int dtype,
                                            void* stream) {
  constexpr int kThreads = 256;
  const int blocks = ugpg::grid_stride_blocks(n, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ugpg::kFloat32) {
    uncertainty_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n);
  } else if (dtype == ugpg::kBFloat16) {
    uncertainty_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
