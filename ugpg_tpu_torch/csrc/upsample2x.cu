// Exact 2x bilinear upsample, align_corners=True, NHWC.
//
// Replaces: ugpg_tpu/ops/pallas/resize2x.py, upsample2x_pallas
//           (kernel body _kernel).
// Bound on the H100: memory.  Each input element is read once and four
//   output elements are written (5 x element size per input element), at
//   ~7 operations per output element.
// Design: one thread per output element in a grid-stride loop, the channel
//   index fastest, so neighbouring threads read and write neighbouring
//   addresses.  Output row 2k lerps input rows k-1 and k, row 2k+1 rows k and
//   k+1, with the weights of _lerp2x_weights (passed in as float32); columns
//   the same way.  The out-of-range tap is clamped to the edge: its weight
//   is exactly 0, and H or W = 1 falls out of the same rule.  Rows are
//   lerped first, then columns, in float32, as in the TPU kernel.  The four
//   reads per output hit L1/L2: each input element feeds 16 outputs.

#include "common.cuh"

namespace {

template <typename T>
__global__ void upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  const float* __restrict__ weights, int N, int H, int W,
                                  int C) {
  // weights: [even_lo(H) | odd_hi(H) | even_lo(W) | odd_hi(W)]
  const int OH = 2 * H, OW = 2 * W;
  const int64_t total = (int64_t)N * OH * OW * C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int c = (int)(i % C);
    int64_t r = i / C;
    const int ox = (int)(r % OW);
    r /= OW;
    const int oy = (int)(r % OH);
    const int64_t n = r / OH;

    const int ky = oy >> 1, kx = ox >> 1;
    int y0, y1, x0, x1;
    float a0, a1, b0, b1;
    if ((oy & 1) == 0) {
      y0 = max(ky - 1, 0); y1 = ky; a0 = weights[ky]; a1 = 1.0f - a0;
    } else {
      y0 = ky; y1 = min(ky + 1, H - 1); a1 = weights[H + ky]; a0 = 1.0f - a1;
    }
    if ((ox & 1) == 0) {
      x0 = max(kx - 1, 0); x1 = kx; b0 = weights[2 * H + kx]; b1 = 1.0f - b0;
    } else {
      x0 = kx; x1 = min(kx + 1, W - 1); b1 = weights[2 * H + W + kx]; b0 = 1.0f - b1;
    }
    const T* img = x + n * H * W * C + c;
    const int64_t r0 = (int64_t)y0 * W * C, r1 = (int64_t)y1 * W * C;
    const float z0 = a0 * ugpg::to_float(img[r0 + (int64_t)x0 * C]) +
                     a1 * ugpg::to_float(img[r1 + (int64_t)x0 * C]);
    const float z1 = a0 * ugpg::to_float(img[r0 + (int64_t)x1 * C]) +
                     a1 * ugpg::to_float(img[r1 + (int64_t)x1 * C]);
    out[i] = ugpg::from_float<T>(b0 * z0 + b1 * z1);
  }
}

}  // namespace

// x: (N, H, W, C), out: (N, 2H, 2W, C), both dense NHWC of one dtype.
extern "C" int ugpg_upsample2x(const void* x, void* out, const float* weights, int N, int H,
                               int W, int C, int dtype, void* stream) {
  constexpr int kThreads = 256;
  const int blocks = ugpg::grid_stride_blocks((int64_t)N * 4 * H * W * C, kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ugpg::kFloat32) {
    upsample2x_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), weights, N, H, W, C);
  } else if (dtype == ugpg::kBFloat16) {
    upsample2x_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), weights, N, H,
        W, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
