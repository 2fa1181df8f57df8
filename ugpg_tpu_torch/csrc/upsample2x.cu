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
//
// Second instance, bf16 only (kTaps, ugpg_upsample2x_bf16_taps): the
//   rounding of the JAX package's bf16 resize (ugpg_tpu/ops/resize.py, the
//   bf16 einsums), which its int8 forward runs on each Up block's
//   dequantized half.  Each output tap pair carries its own two weights,
//   the bf16 roundings of _bilinear_ac_matrix's float32 entries, taken as
//   rounded (they need not sum to 1).  Down H first:
//   r = bf16(w0 * x0 + w1 * x1), then along W: out = bf16(v0 * r0 + v1 * r1).
//   Both products of a pair are exact in float32 (8-bit by 8-bit
//   significands), so the sum rounds once, with or without a fused
//   multiply-add, and the result equals the einsums' bit for bit.

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Grid: (ceil(W * C / V / threads), H, N).
template <typename T, int V, bool kTaps>
__global__ void upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  const float* __restrict__ weights, int H, int W, int C) {
  // weights: [even_lo(H) | odd_hi(H) | even_lo(W) | odd_hi(W)]; kTaps:
  // [even0(H) | even1(H) | odd0(H) | odd1(H) | the same four of W]
  const int groups = C / V;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W * groups) return;
  const int xi = i / groups, c = (i - xi * groups) * V;
  const int yi = blockIdx.y;
  const T* img = x + (int64_t)blockIdx.z * H * W * C;
  T* oimg = out + (int64_t)blockIdx.z * 4 * H * W * C;

  // even output row: a0 = even_lo on row y-1, 1 - a0 on row y;
  // odd output row: a1 = odd_hi on row y+1, 1 - a1 on row y.
  // kTaps: even row e0 on row y-1, e1 on row y; odd row o0 on y, o1 on y+1
  float e0, e1, o0, o1, f0, f1, p0, p1;  // rows (e, o), then columns (f, p)
  if constexpr (kTaps) {
    e0 = weights[yi], e1 = weights[H + yi], o0 = weights[2 * H + yi], o1 = weights[3 * H + yi];
    const float* wc = weights + 4 * H;
    f0 = wc[xi], f1 = wc[W + xi], p0 = wc[2 * W + xi], p1 = wc[3 * W + xi];
  } else {
    const float ae = weights[yi], ao = weights[H + yi];
    const float be = weights[2 * H + xi], bo = weights[2 * H + W + xi];
    e0 = ae, e1 = 1.0f - ae, o0 = 1.0f - ao, o1 = ao;
    f0 = be, f1 = 1.0f - be, p0 = 1.0f - bo, p1 = bo;
  }
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
      ze[k][j] = e0 * top[j] + e1 * midv[j];
      zo[k][j] = o0 * midv[j] + o1 * bot[j];
      if constexpr (kTaps) {  // the H pass rounds to bf16 before the W pass
        ze[k][j] = round_bf16(ze[k][j]);
        zo[k][j] = round_bf16(zo[k][j]);
      }
    }
  }
  // output columns 2x (b0 = even_lo on column x-1) and 2x+1 (b1 = odd_hi on x+1)
  auto emit = [&](const float(&z)[3][V], int oy) {
    float left[V], right[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      left[j] = f0 * z[0][j] + f1 * z[1][j];
      right[j] = p0 * z[1][j] + p1 * z[2][j];
    }
    T* row = oimg + (oy * 2 * W + 2 * xi) * C + c;
    store_vec<V>(row, left);
    store_vec<V>(row + C, right);
  };
  emit(ze, 2 * yi);
  emit(zo, 2 * yi + 1);
}

template <typename T, bool kTaps = false>
cudaError_t launch(const void* x, void* out, const float* weights, int N, int H, int W, int C,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(T), kThreads = 256;
  const bool vec = C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int per_row = vec ? W * (C / V) : W * C;
  const dim3 grid((per_row + kThreads - 1) / kThreads, H, N);
  if (vec)
    upsample2x_kernel<T, V, kTaps><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), weights, H, W, C);
  else
    upsample2x_kernel<T, 1, kTaps><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), weights, H, W, C);
  return cudaGetLastError();
}

}  // namespace

// one output image must be 32-bit indexable; grid y and z are at most 65535
static bool valid_shape(int N, int H, int W, int C) {
  return N >= 1 && H >= 1 && W >= 1 && C >= 1 && N <= 65535 && H <= 65535 &&
         (int64_t)4 * H * W * C <= INT_MAX;
}

// x: (N, H, W, C), out: (N, 2H, 2W, C), both dense NHWC of one dtype.
extern "C" int ugpg_upsample2x(const void* x, void* out, const float* weights, int N, int H,
                               int W, int C, int dtype, void* stream) {
  if (!valid_shape(N, H, W, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ugpg::kFloat32) return (int)launch<float>(x, out, weights, N, H, W, C, s);
  if (dtype == ugpg::kBFloat16) return (int)launch<__nv_bfloat16>(x, out, weights, N, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16-taps instance: x and out bf16 NHWC, weights the 4 (H + W) tap
// weights (ugpg_tpu_torch/ops/cuda/resize2x.py::_tap_weights).
extern "C" int ugpg_upsample2x_bf16_taps(const void* x, void* out, const float* weights, int N,
                                         int H, int W, int C, void* stream) {
  if (!valid_shape(N, H, W, C)) return (int)cudaErrorInvalidValue;
  return (int)launch<__nv_bfloat16, true>(x, out, weights, N, H, W, C,
                                          static_cast<cudaStream_t>(stream));
}
