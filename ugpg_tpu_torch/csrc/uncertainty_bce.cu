// Uncertainty-weighted BCE-with-logits: the loss of the train step and its
// gradient, as two kernels.
//
//   pixel = (1 - z) x + (1 + (pw - 1) z) softplus(-x)
//   w     = 1 + alpha (1 - 2 |p - 0.5|)
//   forward:  final = mean(pixel * w), base = mean(pixel)
//   backward: dx = g / N * w * ((1 - z) - (1 + (pw - 1) z) sigmoid(-x))
//
// Replaces: ugpg_tpu/ops/pallas/uncertainty_fused.py, _run_fwd (kernel body
//           _loss_fwd_kernel) and _run_bwd (_loss_bwd_kernel), the forward
//           and backward of the custom VJP uncertainty_weighted_bce.
// Bound on the H100: memory.  The forward reads x, z and p once (12 bytes
//   per element) and writes two floats; the backward reads 12 bytes and
//   writes 4 per element.  About 20 operations per element, far below the
//   card's ~20 float32 operations per byte of bandwidth.
// Design:
//   * The TPU kernel carries two sums in SMEM across a sequential grid.
//     Blocks on Hopper run in parallel and in no order, so the forward is
//     two passes: a fixed grid-stride grid where each block reduces its
//     share (thread sums, warp shuffles, one shared-memory step) and writes
//     its two partial sums, then one block that adds the partials in a fixed
//     order and divides by N.  No atomics: the loss is bit-identical from
//     run to run for the same N on the same card.  Sums are carried in
//     float64 (cheap next to the memory traffic), so their error does not
//     grow with N.
//   * The backward is one elementwise grid-stride pass.  g arrives as a
//     device pointer and is read by the kernel, so the host never waits for
//     the forward's result.
//   * Flat indices are int64 and the ragged tail is the loop bound: no
//     padding to (256, 128) tiles and no tail mask (the JAX kernel once
//     mis-masked past 2^24 elements with a float32 index compare).
//   * float32 only: the heads and the logits are always float32.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float softplus_neg(float x) {
  // softplus(-x) = log(1 + exp(-x)) = max(-x, 0) + log1p(exp(-|x|))
  return fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float weight(float p, float alpha) {
  return 1.0f + alpha * (1.0f - 2.0f * fabsf(p - 0.5f));
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // smem is reused by the next call
  return v;
}

__global__ void bce_forward_partials(const float* __restrict__ x, const float* __restrict__ z,
                                     const float* __restrict__ p, int64_t n, float pw,
                                     float alpha, double* __restrict__ partials) {
  __shared__ double smem[32];
  double wsum = 0.0, bsum = 0.0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float xi = x[i], zi = z[i];
    const float pixel = (1.0f - zi) * xi + (1.0f + (pw - 1.0f) * zi) * softplus_neg(xi);
    wsum += (double)(pixel * weight(p[i], alpha));
    bsum += (double)pixel;
  }
  wsum = block_sum(wsum, smem);
  bsum = block_sum(bsum, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = wsum;
    partials[gridDim.x + blockIdx.x] = bsum;
  }
}

__global__ void bce_forward_finish(const double* __restrict__ partials, int blocks, int64_t n,
                                   float* __restrict__ out) {
  __shared__ double smem[32];
  double wsum = 0.0, bsum = 0.0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
    wsum += partials[b];
    bsum += partials[blocks + b];
  }
  wsum = block_sum(wsum, smem);
  bsum = block_sum(bsum, smem);
  if (threadIdx.x == 0) {
    out[0] = (float)(wsum / (double)n);
    out[1] = (float)(bsum / (double)n);
  }
}

__global__ void bce_backward(const float* __restrict__ x, const float* __restrict__ z,
                             const float* __restrict__ p, const float* __restrict__ g, int64_t n,
                             float pw, float alpha, float inv_n, float* __restrict__ dx) {
  const float scale = g[0] * inv_n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float xi = x[i], zi = z[i];
    const float dpl = (1.0f - zi) - (1.0f + (pw - 1.0f) * zi) / (1.0f + expf(xi));
    dx[i] = scale * weight(p[i], alpha) * dpl;
  }
}

}  // namespace

// Number of blocks of the forward's first pass for n elements: the wrapper
// allocates 2 * blocks float64 partial sums.
extern "C" int ugpg_uncertainty_bce_blocks(int64_t n) {
  return ugpg::grid_stride_blocks(n, kThreads);
}

// x, z, p: n contiguous float32; partials: 2 * ugpg_uncertainty_bce_blocks(n)
// float64; out: 2 float32, (final, base).
extern "C" int ugpg_uncertainty_bce_forward(const void* x, const void* z, const void* p,
                                            int64_t n, float pw, float alpha, void* partials,
                                            int blocks, void* out, void* stream) {
  if (blocks != ugpg::grid_stride_blocks(n, kThreads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bce_forward_partials<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(z), static_cast<const float*>(p),
      n, pw, alpha, static_cast<double*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bce_forward_finish<<<1, kThreads, 0, s>>>(static_cast<const double*>(partials), blocks, n,
                                            static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// x, z, p, dx: n contiguous float32; g: one float32 on the device.
extern "C" int ugpg_uncertainty_bce_backward(const void* x, const void* z, const void* p,
                                             const void* g, int64_t n, float pw, float alpha,
                                             float inv_n, void* dx, void* stream) {
  const int blocks = ugpg::grid_stride_blocks(n, kThreads);
  bce_backward<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(z), static_cast<const float*>(p),
      static_cast<const float*>(g), n, pw, alpha, inv_n, static_cast<float*>(dx));
  return (int)cudaGetLastError();
}
