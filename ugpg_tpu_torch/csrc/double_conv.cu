// Fused DoubleConv: (3x3 conv, zero pad, + bias, ReLU) x 2 on BN-folded
// weights, with the middle activation kept in shared memory.
//
// Replaces: ugpg_tpu/ops/pallas/double_conv.py, fused_double_conv
//           (kernel body _dc_kernel, taps in _conv3x3).
// Bound on the H100: operations.  At the stage-4 shapes the pair does
//   2 * 9 * (Cin*Cm + Cm*Cout) operations per pixel against a few hundred
//   bytes per pixel of input and output (61.8 GFLOP per 256 px image), far
//   above the card's ~295 operations per byte in bf16.
// Design: a block owns one image's TH x TW output tile (8 x 16, or 8 x 8
//   when the middle tile would not fit).  It stages the input tile with a
//   2-px halo, zero outside the image, in chunks of CC channels (so Cin =
//   1024 fits), and computes the (TH+2) x (TW+2) x Cm middle tile into
//   shared memory: float32 sums, bias, ReLU, rounded to the input dtype as
//   the JAX kernel does, and set to zero where it lies outside the image
//   (conv2 pads with zero, not with conv1 applied to padding).  conv2 then
//   reads only shared memory.  Device memory sees the input (plus its halo),
//   the weights and the output, never the middle activation.
//   Each of the 8 warps owns 8 channels of a 64-channel pass and each lane
//   a few positions; weights are read as 16-byte vectors that are the same
//   for the whole warp (one broadcast per load).  The products run on the
//   CUDA cores in float32 FMA, not on the tensor cores: this is the first,
//   simple kernel, and the gap to the bf16 tensor-core bound is recorded in
//   PERF.md.  The 1-px halo of the middle tile recomputes conv1 on
//   (TH+2)(TW+2)/(TH*TW) of the tile's positions (1.41x at 8 x 16).

#include "common.cuh"

namespace {

constexpr int TH = 8;          // output tile rows
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int CG = WARPS * 8;  // channels per pass: 8 per warp
constexpr int CC = 16;         // input channels staged per chunk
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB: the most a block may use on sm_90

template <typename T, int TW>
struct Tile {
  static constexpr int MH = TH + 2, MW = TW + 2, MP = MH * MW;  // middle tile
  static constexpr int XH = TH + 4, XW = TW + 4, XP = XH * XW;  // input tile, 2-px halo
  static constexpr int P1 = (MP + 31) / 32;                     // middle positions per lane
  static constexpr int P2 = TH * TW / 32;                       // output positions per lane
  __host__ __device__ static size_t mid_bytes(int cm) { return ((size_t)cm * MP * sizeof(T) + 15) / 16 * 16; }
  __host__ __device__ static size_t smem_bytes(int cm) { return mid_bytes(cm) + (size_t)CC * XP * sizeof(float); }
};

// x: (N, H, W, Cin); w1: (3, 3, Cin, Cm); w2: (3, 3, Cm, Cout); out: (N, H, W, Cout).
// Cm and Cout are multiples of 8.  Grid: (tiles, N).
template <typename T, int TW>
__global__ void __launch_bounds__(THREADS)
    double_conv_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const float* __restrict__ b2, T* __restrict__ out, int H, int W,
                       int Cin, int Cm, int Cout, int tiles_w) {
  using G = Tile<T, TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* mid = reinterpret_cast<T*>(smem);                              // [Cm][MP]
  float* xs = reinterpret_cast<float*>(smem + G::mid_bytes(Cm));    // [CC][XP]

  const int64_t n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xn = x + n * H * W * Cin;

  // ---- conv1 over the middle tile ------------------------------------
  int xoff[G::P1];  // input-tile offset of this lane's middle positions
#pragma unroll
  for (int i = 0; i < G::P1; ++i) {
    const int p = min(lane + 32 * i, G::MP - 1);  // lanes past MP compute a copy, never stored
    xoff[i] = (p / G::MW) * G::XW + p % G::MW;
  }
  for (int cm0 = 0; cm0 < Cm; cm0 += CG) {
    const int cmw = cm0 + warp * 8;  // this warp's 8 middle channels
    const bool active = cmw < Cm;
    float acc[G::P1][8];
#pragma unroll
    for (int i = 0; i < G::P1; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int ci0 = 0; ci0 < Cin; ci0 += CC) {
      const int cc = min(CC, Cin - ci0);
      __syncthreads();  // the previous chunk is consumed
      for (int idx = threadIdx.x; idx < G::XP * cc; idx += THREADS) {
        const int q = idx / cc, c = idx - q * cc;
        const int iy = ty0 - 2 + q / G::XW, ix = tx0 - 2 + q % G::XW;
        float v = 0.0f;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          v = ugpg::to_float(xn[((int64_t)iy * W + ix) * Cin + ci0 + c]);
        xs[c * G::XP + q] = v;
      }
      __syncthreads();
      if (active) {
        for (int c = 0; c < cc; ++c) {
          const float* xc = xs + c * G::XP;
          const T* wc = w1 + (int64_t)(ci0 + c) * Cm + cmw;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            float wv[8];
            ugpg::load8(wc + (int64_t)tap * Cin * Cm, wv);
            const int d = (tap / 3) * G::XW + tap % 3;
#pragma unroll
            for (int i = 0; i < G::P1; ++i) {
              const float v = xc[xoff[i] + d];
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
            }
          }
        }
      }
    }
    if (active) {
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = b1[cmw + j];
#pragma unroll
      for (int i = 0; i < G::P1; ++i) {
        const int p = lane + 32 * i;
        if (p < G::MP) {
          const int gy = ty0 - 1 + p / G::MW, gx = tx0 - 1 + p % G::MW;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mid[(cmw + j) * G::MP + p] =
                ugpg::from_float<T>(inside ? fmaxf(acc[i][j] + bv[j], 0.0f) : 0.0f);
        }
      }
    }
  }
  __syncthreads();

  // ---- conv2 from the middle tile --------------------------------------
  int moff[G::P2];  // middle-tile offset of this lane's output positions
#pragma unroll
  for (int i = 0; i < G::P2; ++i) {
    const int p = lane + 32 * i;
    moff[i] = (p / TW) * G::MW + p % TW;
  }
  for (int co0 = 0; co0 < Cout; co0 += CG) {
    const int cow = co0 + warp * 8;  // this warp's 8 output channels
    if (cow >= Cout) break;          // warp-uniform; no barrier follows
    float acc[G::P2][8];
#pragma unroll
    for (int i = 0; i < G::P2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int c = 0; c < Cm; ++c) {
      const T* mc = mid + c * G::MP;
      const T* wc = w2 + (int64_t)c * Cout + cow;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float wv[8];
        ugpg::load8(wc + (int64_t)tap * Cm * Cout, wv);
        const int d = (tap / 3) * G::MW + tap % 3;
#pragma unroll
        for (int i = 0; i < G::P2; ++i) {
          const float v = ugpg::to_float(mc[moff[i] + d]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(v, wv[j], acc[i][j]);
        }
      }
    }
    float bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = b2[cow + j];
#pragma unroll
    for (int i = 0; i < G::P2; ++i) {
      const int p = lane + 32 * i;
      const int oy = ty0 + p / TW, ox = tx0 + p % TW;
      if (oy < H && ox < W) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[i][j] + bv[j], 0.0f);
        ugpg::store8(out + ((n * H + oy) * W + ox) * Cout + cow, v);
      }
    }
  }
}

template <typename T, int TW>
cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, void* out, int N, int H, int W, int Cin, int Cm, int Cout,
                   cudaStream_t s) {
  const size_t smem = Tile<T, TW>::smem_bytes(Cm);
  auto kernel = double_conv_kernel<T, TW>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  kernel<<<dim3(tiles_w * tiles_h, N), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), H, W, Cin, Cm, Cout, tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w1, const float* b1, const void* w2,
                     const float* b2, void* out, int N, int H, int W, int Cin, int Cm, int Cout,
                     cudaStream_t s) {
  // the wider tile when the image is wider than 8 and its middle tile fits
  if (W > 8 && Tile<T, 16>::smem_bytes(Cm) <= SMEM_LIMIT)
    return launch<T, 16>(x, w1, b1, w2, b2, out, N, H, W, Cin, Cm, Cout, s);
  if (Tile<T, 8>::smem_bytes(Cm) <= SMEM_LIMIT)
    return launch<T, 8>(x, w1, b1, w2, b2, out, N, H, W, Cin, Cm, Cout, s);
  return cudaErrorInvalidValue;  // the middle tile does not fit in shared memory
}

}  // namespace

// x: (N, H, W, Cin) dense NHWC; w1: (3, 3, Cin, Cm) and w2: (3, 3, Cm, Cout)
// dense HWIO in x's dtype; b1, b2 float32; out: (N, H, W, Cout) dense NHWC.
extern "C" int ugpg_fused_double_conv(const void* x, const void* w1, const float* b1,
                                      const void* w2, const float* b2, void* out, int N, int H,
                                      int W, int Cin, int Cm, int Cout, int dtype,
                                      void* stream) {
  if (Cm % 8 || Cout % 8 || N < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ugpg::kFloat32)
    return (int)dispatch<float>(x, w1, b1, w2, b2, out, N, H, W, Cin, Cm, Cout, s);
  if (dtype == ugpg::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, out, N, H, W, Cin, Cm, Cout, s);
  return (int)cudaErrorInvalidValue;
}
