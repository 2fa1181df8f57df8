// Exact 2x bilinear upsample, align_corners=True, NHWC.
//
// Replaces: ugpg_tpu/ops/pallas/resize2x.py, upsample2x_pallas
//           (kernel body _kernel).
// Bound on the H100: memory.  Each input element is read once and four
//   output elements are written (5 x element size per input element), at
//   ~7 operations per output element.
// Design: one thread owns one input pixel (y, x) and one 16-byte vector of
//   channels (8 bf16 or 4 float32), and writes the 2x2 output quad it
//   feeds: rows 2y and 2y+1, columns 2x and 2x+1, as four 16-byte stores.
//   Output row 2y lerps input rows y-1 and y, row 2y+1 rows y and y+1,
//   with the weights of _lerp2x_weights (passed in as float32); columns
//   the same way.  The out-of-range tap is clamped to the edge: its weight
//   is exactly 0, and H or W = 1 falls out of the same rule.  Rows are
//   lerped first, then columns, in float32, as in the TPU kernel.  The
//   clamped 3x3 neighbourhood is read as 16-byte vectors; its reads of the
//   neighbours' pixels hit L1.  The grid is (x and channel group, y, n):
//   index math is 32-bit within an image, whose base offset is 64-bit.
//   C not a multiple of the vector width (or a misaligned tensor) takes
//   the same kernel with one channel per thread and scalar accesses.

#include <limits.h>

#include "common.cuh"

namespace {

template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = ugpg::to_float(*p);
  } else if constexpr (sizeof(T) == 2) {  // 8 bf16
    ugpg::load8(p, v);
  } else {  // 4 float32
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = ugpg::from_float<T>(v[0]);
  } else if constexpr (sizeof(T) == 2) {
    ugpg::store8(p, v);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Grid: (ceil(W * C / V / threads), H, N).
template <typename T, int V>
__global__ void upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  const float* __restrict__ weights, int H, int W, int C) {
  // weights: [even_lo(H) | odd_hi(H) | even_lo(W) | odd_hi(W)]
  const int groups = C / V;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W * groups) return;
  const int xi = i / groups, c = (i - xi * groups) * V;
  const int yi = blockIdx.y;
  const T* img = x + (int64_t)blockIdx.z * H * W * C;
  T* oimg = out + (int64_t)blockIdx.z * 4 * H * W * C;

  // even output row: a0 = even_lo on row y-1, 1 - a0 on row y;
  // odd output row: a1 = odd_hi on row y+1, 1 - a1 on row y
  const float ae = weights[yi], ao = weights[H + yi];
  const float be = weights[2 * H + xi], bo = weights[2 * H + W + xi];
  const int rows[3] = {max(yi - 1, 0), yi, min(yi + 1, H - 1)};
  const int cols[3] = {max(xi - 1, 0), xi, min(xi + 1, W - 1)};

  float ze[3][V], zo[3][V];  // each column lerped over rows, for output rows 2y and 2y+1
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float top[V], midv[V], bot[V];
    load_vec<V>(img + (rows[0] * W + cols[k]) * C + c, top);
    load_vec<V>(img + (rows[1] * W + cols[k]) * C + c, midv);
    load_vec<V>(img + (rows[2] * W + cols[k]) * C + c, bot);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ze[k][j] = ae * top[j] + (1.0f - ae) * midv[j];
      zo[k][j] = (1.0f - ao) * midv[j] + ao * bot[j];
    }
  }
  // output columns 2x (b0 = even_lo on column x-1) and 2x+1 (b1 = odd_hi on x+1)
  auto emit = [&](const float(&z)[3][V], int oy) {
    float left[V], right[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      left[j] = be * z[0][j] + (1.0f - be) * z[1][j];
      right[j] = (1.0f - bo) * z[1][j] + bo * z[2][j];
    }
    T* row = oimg + (oy * 2 * W + 2 * xi) * C + c;
    store_vec<V>(row, left);
    store_vec<V>(row + C, right);
  };
  emit(ze, 2 * yi);
  emit(zo, 2 * yi + 1);
}

template <typename T>
cudaError_t launch(const void* x, void* out, const float* weights, int N, int H, int W, int C,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(T), kThreads = 256;
  const bool vec = C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_row = vec ? W * (C / V) : W * C;
  const dim3 grid((per_row + kThreads - 1) / kThreads, H, N);
  if (vec)
    upsample2x_kernel<T, V><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                       static_cast<T*>(out), weights, H, W, C);
  else
    upsample2x_kernel<T, 1><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                       static_cast<T*>(out), weights, H, W, C);
  return cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C), out: (N, 2H, 2W, C), both dense NHWC of one dtype.
extern "C" int ugpg_upsample2x(const void* x, void* out, const float* weights, int N, int H,
                               int W, int C, int dtype, void* stream) {
  // one output image must be 32-bit indexable; grid y and z are at most 65535
  if (N < 1 || H < 1 || W < 1 || C < 1 || N > 65535 || H > 65535 ||
      (int64_t)4 * H * W * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ugpg::kFloat32) return (int)launch<float>(x, out, weights, N, H, W, C, s);
  if (dtype == ugpg::kBFloat16) return (int)launch<__nv_bfloat16>(x, out, weights, N, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
