// DoubleConv on BN-folded weights: (3x3 conv, zero pad, + bias, ReLU) x 2.
//
// Replaces: ugpg_tpu/ops/pallas/double_conv.py, fused_double_conv
//           (kernel body _dc_kernel, taps in _conv3x3).
// Bound on the H100: operations.  At the stage-4 shapes the pair does
//   2 * 9 * (Cin*Cm + Cm*Cout) operations per pixel against a few hundred
//   bytes per pixel of input and output (61.8 GFLOP per 256 px image), far
//   above the card's ~295 operations per byte in bf16.
//
// Two kernels, one per dtype; neither dtype takes the other's path.
//
// bfloat16: conv3x3_mma_kernel, an implicit GEMM on the tensor cores,
//   launched twice per DoubleConv (conv1 -> bf16 middle activation in a
//   scratch tensor -> conv2).  M = output pixels, N = output channels,
//   K = 9 taps x Cin.  Why two launches and not the TPU kernel's fused
//   pair: on this card the work is bound by operations, and fusing the
//   pair would recompute conv1 on the middle tile's 1-px halo (1.14-1.41x
//   of conv1's operations at 16x16 or 8x16 tiles) and tie the tile size to
//   a Cm-wide middle tile in shared memory (184 KB at Cm = 512 for 8x16).
//   The middle activation's round trip costs 2 bytes x Cm per pixel each
//   way, about 3.6 GB per batch-64 stage-4 forward (about 1.07 ms at
//   3.35 TB/s), and that traffic overlaps the tensor-core work of the
//   blocks in flight.  With two passes conv2's own zero padding also makes
//   the middle positions outside the image zero (the fused form had to
//   zero them by hand, not leave relu(bias) there).
//   A block owns a 16x16 output tile of one image and a 64-channel slice
//   of the outputs; 8 warps split it 4 (rows) x 2 (channels), each warp a
//   4-row x 32-channel tile: 4 x 4 mma tiles of m16n8k16, 64 float32
//   accumulators per thread.  For each chunk of KC input channels (32, or
//   16 when Cin <= 16) the block stages the haloed 18x18 x KC input tile
//   and the chunk's 9 x 64 x KC weights into shared memory with 16-byte
//   cp.async (zero-fill makes the padding outside the image and past Cin),
//   double-buffered so the next chunk's copies overlap this chunk's
//   products.  Cin % 8 != 0 (the 3-channel input, 6-byte pixels) stages
//   with scalar loads, zero-filled to the chunk width; K is padded with
//   zeros in shared memory and in the packed weights, never in x.
//   Products: mma.sync m16n8k16 bf16 -> float32, A fragments by ldmatrix
//   from the haloed tile.  Each m16 tile is one 16-pixel output row, so
//   tap (dy, dx) reads the same staged tile at a shifted row address: one
//   staged tile feeds 9 x KC/16 k-steps and no im2col exists anywhere.
//   Each pixel's 16-byte columns are XOR-swizzled by the pixel's index
//   within its 128-byte line, so the 8 rows of every ldmatrix phase (8
//   consecutive pixels at any tap shift, or 8 consecutive weight rows)
//   fall on 8 distinct bank groups.  Epilogue: float32 bias, ReLU, round
//   to bf16, staged through shared memory and written as 16-byte vectors;
//   the ragged pixel edge and channel edge (Cout % 8 == 0) are masked.
//   Weights arrive packed (ops/cuda/double_conv.py::pack_conv3x3):
//   (9, Cout, Cpad) bf16, tap-major, Cin zero-padded to a multiple of KC.
//   Next step (ROADMAP.md queue B): wgmma with B loaded by TMA.
//
// float32: conv3x3_f32_kernel, an implicit GEMM on the CUDA cores in
//   float32 FMA (no TF32, which would not match the CPU to 1e-4), launched
//   twice per DoubleConv like the bf16 path: conv1 into a float32 middle
//   tensor, then conv2, whose own zero padding makes the middle positions
//   outside the image zero.  Bound: operations, 2 * 9 * (Cin*Cm + Cm*Cout)
//   per pixel against the FP32 CUDA cores' 67 TFLOP/s (958.8 GFLOP, 14.31 ms
//   per stage-4 forward at 1008 px); the middle round trip adds 8 bytes x Cm
//   per pixel (about 1.7 GB, 0.52 ms at 3.35 TB/s, per such forward).
//   What the design does about the fused kernel it replaces:
//   - No Cm-wide middle tile in shared memory, so nothing ties a block to
//     one per SM: a stage of the K ring is 24.5 KB (BN = 64), and at 166
//     registers (BN = 64; 123 at 32) with no spills three 128-thread blocks
//     share an SM.
//   - The grid is (pixel tiles, Cout / BN, N): it splits over output
//     channels, so at batch 1 the 63 px, Cm = 512 shape still has 256
//     blocks.  BN is 64, or 32 where 64 would leave fewer than 256 blocks
//     (ops/cuda/double_conv.py::f32_plan); no split-K, so no atomics and
//     a repeat gives the same bits.
//   - No recomputed halo and no idle lanes: every lane owns 8 output pixels
//     (8 consecutive columns of one row of the 8 x 16 tile) x 4 * NV
//     channels (NV = BN / 32 float4 vectors, v*32 + cg*4 ... + 3), all
//     inside the tile.
//   - Weights come from shared memory, and reuse is high: per channel and
//     tap row dy a lane reads 10 input values once and uses them for the 3
//     dx taps (a register shift, no im2col), and per tap one float4 of
//     weights per vector feeds 8 pixels: 192 FMAs per 10 scalar and 6
//     float4 shared loads at BN = 64.
//   - Staging overlaps compute: each chunk of KC = 8 input channels (the
//     haloed 10 x 18 x KC input tile and its 9 x KC x BN weights) is copied
//     with 16-byte cp.async into a ring of 3 stages; zero-fill (source size
//     0) makes the padding outside the image and past Cin.  Cin % 4 != 0
//     (the 3-channel input) or an x off 16 bytes stages with 4-byte
//     cp.async.
//   - Bank conflicts: the input tile is pixel-major (KC floats per pixel)
//     with a row pitch of 19 pixels, so the four rows a warp reads at once
//     start 152 floats apart, on banks 0, 24, 16 and 8 (the 8 lanes of one
//     row broadcast); the 8 channel groups of a warp read 8 consecutive
//     float4 of a weight row (128 bytes).  That is the bank arithmetic; no
//     profiler counts conflicts on the H100 machine, but a pitch of 18,
//     whose four rows share two banks, timed the same within 0.3% over the
//     native shapes: the input reads are 10 of about 208 instructions per
//     (channel, dy), and the issue slots, not the banks, bound the loop.
//   Epilogue: float32 bias and ReLU from registers, written as 16-byte
//   vectors along channels (NHWC); the ragged pixel edge and the channel
//   edge (Cout % 4 == 0) are masked.  Weights arrive as HWIO (3, 3, Cin,
//   Cout): tap-major, output channels innermost, as the B tile is read.

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kMaxDevices = 64;

// Sets a kernel's dynamic shared memory limit once per device.  Racing
// callers may both set it; setting it twice is harmless.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= kMaxDevices) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// ======================================================= cp.async, both dtypes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ======================================================= float32, CUDA cores
namespace f32 {

constexpr int TH = 8, TW = 16;               // output tile
constexpr int HH = TH + 2, HW = TW + 2;      // input tile with its 1-px halo
constexpr int PITCH = HW + 1;                // staged pixels per tile row: odd, for the banks
constexpr int KC = 8;                        // input channels per K chunk
constexpr int STAGES = 3;
constexpr int THREADS = 128;                 // 4 warps: 2 (rows 0-3, 4-7) x 2 (columns 0-7, 8-15)
constexpr int PX = 8;                        // pixels per lane: consecutive columns of one row
constexpr int A_FLOATS = HH * PITCH * KC;    // [HH][PITCH][KC]

template <int NV>  // float4 channel vectors per lane; BN = 32 * NV output channels per block
struct Cfg {
  static constexpr int BN = 32 * NV;
  static constexpr int B_FLOATS = 9 * KC * BN;  // [tap][KC][BN]
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * 4;
};

std::atomic<unsigned> launches{0};  // conv3x3_f32_kernel launches, for the tests

// x: (N, H, W, Cin); w: (3, 3, Cin, Cout); bias: (Cout); y: (N, H, W, Cout).
// Cout % 4 == 0; w and y 16-byte aligned; VEC: Cin % 4 == 0 and x 16-byte
// aligned.  Grid: (tiles, Cout slices of BN, N).
template <int NV, bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y, int H, int W,
                       int Cin, int Cout, int tiles_w) {
  using C = Cfg<NV>;
  constexpr int BV = C::BN / 4;  // float4 per weight row
  extern __shared__ __align__(16) float fsmem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7;                           // channels v*32 + cg*4 ... + 3
  const int row = (warp & 1) * 4 + (lane >> 3);      // output row within the tile
  const int col0 = (warp >> 1) * PX;                 // first of the lane's 8 columns
  const int ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * C::BN;
  const int64_t img = blockIdx.z;
  const float* xn = x + img * H * W * Cin;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(fsmem);
  const int chunks = (Cin + KC - 1) / KC;

  // Stage chunk `chunk` (input channels chunk*KC ...) into buffer `stage`.
  auto load_chunk = [&](int chunk, int stage) {
    const int c0 = chunk * KC;
    const uint32_t sa = sbase + stage * C::STAGE_FLOATS * 4, sb = sa + A_FLOATS * 4;
    constexpr int PER_PIXEL = VEC ? KC / 4 : KC;  // copies per staged pixel
    for (int i = tid; i < HH * HW * PER_PIXEL; i += THREADS) {
      const int p = i / PER_PIXEL, q = i % PER_PIXEL;
      const int r = p / HW, c = p % HW;
      const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
      const int ch = c0 + (VEC ? q * 4 : q);
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < Cin;
      const float* src = ok ? xn + ((int64_t)gy * W + gx) * Cin + ch : x;
      const uint32_t dst = sa + ((r * PITCH + c) * KC + (VEC ? q * 4 : q)) * 4;
      if constexpr (VEC)
        cp_async16(dst, src, ok ? 16 : 0);
      else
        cp_async4(dst, src, ok ? 4 : 0);
    }
    for (int i = tid; i < 9 * KC * BV; i += THREADS) {
      const int r = i / BV, v = i % BV;  // r = tap * KC + channel within the chunk
      const int ch = c0 + r % KC, n = n0 + v * 4;
      const bool ok = ch < Cin && n < Cout;
      const float* src = ok ? w + ((int64_t)(r / KC) * Cin + ch) * Cout + n : w;
      cp_async16(sb + (r * C::BN + v * 4) * 4, src, ok ? 16 : 0);
    }
  };

  float acc[PX][4 * NV];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < 4 * NV; ++k) acc[j][k] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load_chunk(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<STAGES - 2>();  // chunk k has landed (this thread's copies)
    __syncthreads();              // ... everyone's, and chunk k-1 is consumed
    if (k + STAGES - 1 < chunks) load_chunk(k + STAGES - 1, (k + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* as = fsmem + (k % STAGES) * C::STAGE_FLOATS + (row * PITCH + col0) * KC;
    const float4* bs = reinterpret_cast<const float4*>(fsmem + (k % STAGES) * C::STAGE_FLOATS +
                                                       A_FLOATS) + cg;
    // c stays a loop: unrolled, the compiler hoists the chunk's shared loads,
    // reaches 168 registers and spills 208 bytes: 25 TFLOP/s on the H100
    // against 40 as a loop
#pragma unroll 1
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float a[PX + 2];  // columns col0-1 ... col0+8 of input row row+dy-1, channel c
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) a[j] = as[(dy * PITCH + j) * KC + c];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float4 b[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) b[v] = bs[((dy * 3 + dx) * KC + c) * BV + v * 8];
#pragma unroll
          for (int j = 0; j < PX; ++j)
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              acc[j][4 * v + 0] = fmaf(a[j + dx], b[v].x, acc[j][4 * v + 0]);
              acc[j][4 * v + 1] = fmaf(a[j + dx], b[v].y, acc[j][4 * v + 1]);
              acc[j][4 * v + 2] = fmaf(a[j + dx], b[v].z, acc[j][4 * v + 2]);
              acc[j][4 * v + 3] = fmaf(a[j + dx], b[v].w, acc[j][4 * v + 3]);
            }
        }
      }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind

  const int oy = ty0 + row;
  if (oy >= H) return;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int n = n0 + v * 32 + cg * 4;
    if (n >= Cout) continue;  // Cout % 4 == 0: the whole vector or none of it
    const float b0 = bias[n], b1 = bias[n + 1], b2 = bias[n + 2], b3 = bias[n + 3];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int ox = tx0 + col0 + j;
      if (ox < W)
        *reinterpret_cast<float4*>(y + ((img * H + oy) * W + ox) * Cout + n) = make_float4(
            fmaxf(acc[j][4 * v + 0] + b0, 0.0f), fmaxf(acc[j][4 * v + 1] + b1, 0.0f),
            fmaxf(acc[j][4 * v + 2] + b2, 0.0f), fmaxf(acc[j][4 * v + 3] + b3, 0.0f));
    }
  }
}

template <int NV, bool VEC>
cudaError_t launch(const float* x, const float* w, const float* b, float* y, int N, int H, int W,
                   int Cin, int Cout, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  cudaError_t e = allow_smem(conv3x3_f32_kernel<NV, VEC>, Cfg<NV>::SMEM, done);
  if (e != cudaSuccess) return e;
  const int tiles_w = cdiv(W, TW);
  const int64_t tiles = (int64_t)tiles_w * cdiv(H, TH);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  conv3x3_f32_kernel<NV, VEC><<<dim3((unsigned)tiles, cdiv(Cout, Cfg<NV>::BN), N), THREADS,
                                Cfg<NV>::SMEM, s>>>(x, w, b, y, H, W, Cin, Cout, tiles_w);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++launches;
  return e;
}

// One conv3x3 + bias + ReLU; bn is the plan's output channels per block.
cudaError_t conv3x3(const void* x, const void* w, const float* b, void* y, int N, int H, int W,
                    int Cin, int Cout, int bn, cudaStream_t s) {
  if (Cout % 4 || N < 1 || N > 65535 || Cin < 1 || (bn != 32 && bn != 64))
    return cudaErrorInvalidValue;
  if (misaligned(w) || misaligned(y)) return cudaErrorMisalignedAddress;
  const bool vec = Cin % 4 == 0 && !misaligned(x);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  if (bn == 32)
    return vec ? launch<1, true>(xf, wf, b, yf, N, H, W, Cin, Cout, s)
               : launch<1, false>(xf, wf, b, yf, N, H, W, Cin, Cout, s);
  return vec ? launch<2, true>(xf, wf, b, yf, N, H, W, Cin, Cout, s)
             : launch<2, false>(xf, wf, b, yf, N, H, W, Cin, Cout, s);
}

}  // namespace f32

// ======================================================= bfloat16, tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TH = 16, TW = 16;                         // output tile: one m16 tile per row
constexpr int HH = TH + 2, HW = TW + 2, HP = HH * HW;   // input tile with its 1-px halo
constexpr int BN = 64;                                  // output channels per block
constexpr int THREADS = 256;                            // 8 warps: 4 (rows) x 2 (channels)
constexpr int WARP_ROWS = TH / 4;                       // m16 tiles per warp
constexpr int WARP_N8 = BN / 2 / 8;                     // n8 tiles per warp
constexpr int STAGES = 2;
constexpr int OUT_STRIDE = BN + 8;  // bf16 per staged output pixel: 16 bytes of padding

template <int KC>
struct Cfg {
  static constexpr int COLS = KC / 8;                // 16-byte columns per pixel or weight row
  static constexpr int A_BYTES = HP * KC * 2;        // haloed input tile
  static constexpr int B_BYTES = 9 * BN * KC * 2;    // 9 taps x BN rows of KC channels
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = TH * TW * OUT_STRIDE * 2;
  static constexpr int SMEM =
      STAGES * STAGE_BYTES > OUT_BYTES ? STAGES * STAGE_BYTES : OUT_BYTES;
};

// Byte offset of 16-byte column `col` of `row` in a tile of KC-channel
// rows.  The column is XOR-ed with the row's index within its 128-byte
// line, so any 8 consecutive rows hit 8 distinct bank groups.
template <int KC>
__device__ __forceinline__ uint32_t swz(int row, int col) {
  constexpr int COLS = KC / 8, ROWS_PER_LINE = 8 / COLS;
  return (uint32_t)(row * (KC * 2) + ((col ^ ((row / ROWS_PER_LINE) % COLS)) << 4));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16x16, row) * b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x: (N, H, W, Cin) bf16; w: (9, Cout, Cpad) bf16, packed; bias: (Cout)
// float32; y: (N, H, W, Cout) bf16.  Cout % 8 == 0; VEC: Cin % 8 == 0 and
// x 16-byte aligned.  Grid: (Cout slices of BN, tiles, N).
template <int KC, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, bf16* __restrict__ y, int H, int W,
                       int Cin, int Cpad, int Cout, int tiles_w) {
  using C = Cfg<KC>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int n0 = blockIdx.x * BN;
  const int ty0 = (blockIdx.y / tiles_w) * TH, tx0 = (blockIdx.y % tiles_w) * TW;
  const int64_t img = blockIdx.z;
  const bf16* xn = x + img * H * W * Cin;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int chunks = Cpad / KC;

  // Stage chunk `chunk` (input channels chunk*KC ...) into buffer `stage`.
  auto load_chunk = [&](int chunk, int stage) {
    const int c0 = chunk * KC;
    const int a_off = stage * C::STAGE_BYTES, b_off = a_off + C::A_BYTES;
    for (int i = tid; i < HP * C::COLS; i += THREADS) {
      const int p = i / C::COLS, col = i % C::COLS;
      const int gy = ty0 - 1 + p / HW, gx = tx0 - 1 + p % HW;
      const int c = c0 + col * 8;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int64_t pix = inside ? ((int64_t)gy * W + gx) * Cin : 0;
      if constexpr (VEC) {
        const bool ok = inside && c < Cin;
        cp_async16(sbase + a_off + swz<KC>(p, col), ok ? xn + pix + c : x, ok ? 16 : 0);
      } else {  // scalar loads, zero past Cin and outside the image
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(xn) + pix;
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ca = c + 2 * j;
          const uint32_t lo = inside && ca < Cin ? xs[ca] : 0u;
          const uint32_t hi = inside && ca + 1 < Cin ? xs[ca + 1] : 0u;
          v[j] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(smem + a_off + swz<KC>(p, col)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int i = tid; i < 9 * BN * C::COLS; i += THREADS) {
      const int row = i / C::COLS, col = i % C::COLS;  // row = tap * BN + channel
      const int tap = row / BN, n = n0 + row % BN;
      const bool ok = n < Cout;
      const bf16* src = ok ? w + ((int64_t)tap * Cout + n) * Cpad + c0 + col * 8 : w;
      cp_async16(sbase + b_off + swz<KC>(row, col), src, ok ? 16 : 0);
    }
  };

  float acc[WARP_ROWS][WARP_N8][4];
#pragma unroll
  for (int i = 0; i < WARP_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < WARP_N8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks) load_chunk(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<STAGES - 2>();  // chunk k has landed (this thread's copies)
    __syncthreads();              // ... everyone's, and chunk k-1 is consumed
    if (k + STAGES - 1 < chunks) load_chunk(k + STAGES - 1, (k + STAGES - 1) % STAGES);
    cp_async_commit();

    const uint32_t sa = sbase + (k % STAGES) * C::STAGE_BYTES, sb = sa + C::A_BYTES;
    // dy stays a loop: unrolled, the 9 taps' swizzled addresses are
    // hoisted out of the chunk loop and spill
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = dy * 3 + dx;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[WARP_ROWS][4], b[WARP_N8][2];
#pragma unroll
        for (int mt = 0; mt < WARP_ROWS; ++mt) {
          // lanes 0-15: pixels 0-15 of the row, k 0-7; lanes 16-31: k 8-15
          const int p = (warp_m * WARP_ROWS + mt + dy) * HW + dx + (lane & 15);
          ldmatrix_x4(a[mt], sa + swz<KC>(p, ks * 2 + (lane >> 4)));
        }
#pragma unroll
        for (int np = 0; np < WARP_N8 / 2; ++np) {
          // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
          const int row = tap * BN + warp_n * (BN / 2) + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          uint32_t r[4];
          ldmatrix_x4(r, sb + swz<KC>(row, ks * 2 + ((lane >> 3) & 1)));
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < WARP_ROWS; ++mt)
#pragma unroll
          for (int nt = 0; nt < WARP_N8; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stage buffers are free: stage the output tile there

  // accumulator (mt, nt): rows g and g+8 of output row warp_m*4+mt, channels 2t, 2t+1
  bf16* out_s = reinterpret_cast<bf16*>(smem);  // [TH * TW][OUT_STRIDE]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < WARP_N8; ++nt) {
    const int nl = warp_n * (BN / 2) + nt * 8 + 2 * t;  // channel within the slice
    const bool ok = n0 + nl < Cout;                      // Cout % 8 == 0: both or neither
    const float bb0 = ok ? bias[n0 + nl] : 0.0f, bb1 = ok ? bias[n0 + nl + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < WARP_ROWS; ++mt) {
      const int p = (warp_m * WARP_ROWS + mt) * TW + g;
      *reinterpret_cast<__nv_bfloat162*>(out_s + p * OUT_STRIDE + nl) = __floats2bfloat162_rn(
          fmaxf(acc[mt][nt][0] + bb0, 0.0f), fmaxf(acc[mt][nt][1] + bb1, 0.0f));
      *reinterpret_cast<__nv_bfloat162*>(out_s + (p + 8) * OUT_STRIDE + nl) = __floats2bfloat162_rn(
          fmaxf(acc[mt][nt][2] + bb0, 0.0f), fmaxf(acc[mt][nt][3] + bb1, 0.0f));
    }
  }
  __syncthreads();
  constexpr int VPP = BN / 8;  // 16-byte vectors per pixel
  for (int i = tid; i < TH * TW * VPP; i += THREADS) {
    const int p = i / VPP, v = i % VPP;
    const int oy = ty0 + p / TW, ox = tx0 + p % TW, n = n0 + v * 8;
    if (oy < H && ox < W && n < Cout)
      *reinterpret_cast<uint4*>(y + ((img * H + oy) * W + ox) * Cout + n) =
          *reinterpret_cast<const uint4*>(out_s + p * OUT_STRIDE + v * 8);
  }
}

template <int KC, bool VEC>
cudaError_t launch(const bf16* x, const bf16* w, const float* b, bf16* y, int N, int H, int W,
                   int Cin, int Cpad, int Cout, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  cudaError_t e = allow_smem(conv3x3_mma_kernel<KC, VEC>, Cfg<KC>::SMEM, done);
  if (e != cudaSuccess) return e;
  const int tiles_w = cdiv(W, TW), tiles = tiles_w * cdiv(H, TH);
  if (tiles > 65535) return cudaErrorInvalidValue;
  conv3x3_mma_kernel<KC, VEC><<<dim3(cdiv(Cout, BN), tiles, N), THREADS, Cfg<KC>::SMEM, s>>>(
      x, w, b, y, H, W, Cin, Cpad, Cout, tiles_w);
  return cudaGetLastError();
}

// One conv3x3 + bias + ReLU; kc is the packing's chunk width (16 or 32).
cudaError_t conv3x3(const void* x, const void* w, const float* b, void* y, int N, int H, int W,
                    int Cin, int Cout, int kc, cudaStream_t s) {
  if (Cout % 8 || N < 1 || N > 65535 || Cin < 1 || (kc != 16 && kc != 32))
    return cudaErrorInvalidValue;
  if (misaligned(w) || misaligned(y)) return cudaErrorMisalignedAddress;
  const int cpad = cdiv(Cin, kc) * kc;
  const bool vec = Cin % 8 == 0 && !misaligned(x);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* yb = static_cast<bf16*>(y);
  if (kc == 16)
    return vec ? launch<16, true>(xb, wb, b, yb, N, H, W, Cin, cpad, Cout, s)
               : launch<16, false>(xb, wb, b, yb, N, H, W, Cin, cpad, Cout, s);
  return vec ? launch<32, true>(xb, wb, b, yb, N, H, W, Cin, cpad, Cout, s)
             : launch<32, false>(xb, wb, b, yb, N, H, W, Cin, cpad, Cout, s);
}

}  // namespace tc

}  // namespace

// float32: two launches of the CUDA-core conv.  x: (N, H, W, Cin) dense
// NHWC; w1: (3, 3, Cin, Cm) and w2: (3, 3, Cm, Cout) dense HWIO; b1, b2
// float32; mid: (N, H, W, Cm) scratch; out: (N, H, W, Cout); bn1, bn2: the
// output channels per block of each launch (32 or 64).
extern "C" int ugpg_double_conv_f32(const void* x, const void* w1, const float* b1, void* mid,
                                    const void* w2, const float* b2, void* out, int N, int H,
                                    int W, int Cin, int Cm, int Cout, int bn1, int bn2,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = f32::conv3x3(x, w1, b1, mid, N, H, W, Cin, Cm, bn1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)f32::conv3x3(mid, w2, b2, out, N, H, W, Cm, Cout, bn2, s);
}

// Launches of conv3x3_f32_kernel in this process so far, modulo 2^31.
extern "C" int ugpg_conv3x3_f32_launches() { return (int)(f32::launches.load() & 0x7fffffffu); }

// bfloat16: two launches of the tensor-core conv.  x: (N, H, W, Cin) dense
// NHWC; w1: (9, Cm, Cpad1) and w2: (9, Cout, Cpad2) packed (Cpad = Cin or
// Cm rounded up to kc1 or kc2); b1, b2 float32; mid: (N, H, W, Cm) scratch;
// out: (N, H, W, Cout).
extern "C" int ugpg_double_conv_bf16(const void* x, const void* w1, const float* b1, void* mid,
                                     const void* w2, const float* b2, void* out, int N, int H,
                                     int W, int Cin, int Cm, int Cout, int kc1, int kc2,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = tc::conv3x3(x, w1, b1, mid, N, H, W, Cin, Cm, kc1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)tc::conv3x3(mid, w2, b2, out, N, H, W, Cm, Cout, kc2, s);
}
