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
// float32: double_conv_f32_kernel, on the CUDA cores in float32 FMA, exact
//   enough to match the CPU to 1e-4, which TF32 would not.  A block owns
//   one image's TH x TW output tile (8 x 16, or 8 x 8 when the middle tile
//   would not fit), stages the input tile with a 2-px
//   halo in chunks of CC channels, computes the (TH+2) x (TW+2) x Cm middle
//   tile into shared memory, zero where it lies outside the image, and
//   runs conv2 from shared memory.  Weights arrive as (3, 3, Cin, Cout).

#include "common.cuh"

namespace {

constexpr size_t SMEM_LIMIT = 232448;  // 227 KB: the most a block may use on sm_90
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

// ======================================================= float32, CUDA cores
namespace f32 {

constexpr int TH = 8;          // output tile rows
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int CG = WARPS * 8;  // channels per pass: 8 per warp
constexpr int CC = 16;         // input channels staged per chunk

template <int TW>
struct Tile {
  static constexpr int MH = TH + 2, MW = TW + 2, MP = MH * MW;  // middle tile
  static constexpr int XH = TH + 4, XW = TW + 4, XP = XH * XW;  // input tile, 2-px halo
  static constexpr int P1 = (MP + 31) / 32;                     // middle positions per lane
  static constexpr int P2 = TH * TW / 32;                       // output positions per lane
  static size_t mid_bytes(int cm) { return ((size_t)cm * MP * sizeof(float) + 15) / 16 * 16; }
  static size_t smem_bytes(int cm) { return mid_bytes(cm) + (size_t)CC * XP * sizeof(float); }
};

// x: (N, H, W, Cin); w1: (3, 3, Cin, Cm); w2: (3, 3, Cm, Cout); out: (N, H, W, Cout).
// Cm and Cout are multiples of 8.  Grid: (tiles, N).
template <int TW>
__global__ void __launch_bounds__(THREADS)
    double_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                           const float* __restrict__ b1, const float* __restrict__ w2,
                           const float* __restrict__ b2, float* __restrict__ out, int H, int W,
                           int Cin, int Cm, int Cout, int tiles_w, size_t mid_bytes) {
  using G = Tile<TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* mid = reinterpret_cast<float*>(smem);                // [Cm][MP]
  float* xs = reinterpret_cast<float*>(smem + mid_bytes);     // [CC][XP]

  const int64_t n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* xn = x + n * H * W * Cin;

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
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) v = xn[((int64_t)iy * W + ix) * Cin + ci0 + c];
        xs[c * G::XP + q] = v;
      }
      __syncthreads();
      if (active) {
        for (int c = 0; c < cc; ++c) {
          const float* xc = xs + c * G::XP;
          const float* wc = w1 + (int64_t)(ci0 + c) * Cm + cmw;
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
            mid[(cmw + j) * G::MP + p] = inside ? fmaxf(acc[i][j] + bv[j], 0.0f) : 0.0f;
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
      const float* mc = mid + c * G::MP;
      const float* wc = w2 + (int64_t)c * Cout + cow;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float wv[8];
        ugpg::load8(wc + (int64_t)tap * Cm * Cout, wv);
        const int d = (tap / 3) * G::MW + tap % 3;
#pragma unroll
        for (int i = 0; i < G::P2; ++i) {
          const float v = mc[moff[i] + d];
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

template <int TW>
cudaError_t launch(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, float* out, int N, int H, int W, int Cin, int Cm, int Cout,
                   cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  cudaError_t e = allow_smem(double_conv_f32_kernel<TW>, SMEM_LIMIT, done);
  if (e != cudaSuccess) return e;
  const int tiles_w = cdiv(W, TW), tiles_h = cdiv(H, TH);
  double_conv_f32_kernel<TW><<<dim3(tiles_w * tiles_h, N), THREADS, Tile<TW>::smem_bytes(Cm), s>>>(
      x, w1, b1, w2, b2, out, H, W, Cin, Cm, Cout, tiles_w, Tile<TW>::mid_bytes(Cm));
  return cudaGetLastError();
}

cudaError_t double_conv(const float* x, const float* w1, const float* b1, const float* w2,
                        const float* b2, float* out, int N, int H, int W, int Cin, int Cm,
                        int Cout, cudaStream_t s) {
  // the wider tile when the image is wider than 8 and its middle tile fits
  if (W > 8 && Tile<16>::smem_bytes(Cm) <= SMEM_LIMIT)
    return launch<16>(x, w1, b1, w2, b2, out, N, H, W, Cin, Cm, Cout, s);
  if (Tile<8>::smem_bytes(Cm) <= SMEM_LIMIT)
    return launch<8>(x, w1, b1, w2, b2, out, N, H, W, Cin, Cm, Cout, s);
  return cudaErrorInvalidValue;  // the middle tile does not fit in shared memory
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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// float32.  x: (N, H, W, Cin) dense NHWC; w1: (3, 3, Cin, Cm) and w2:
// (3, 3, Cm, Cout) dense HWIO; b1, b2 float32; out: (N, H, W, Cout).
extern "C" int ugpg_double_conv_f32(const void* x, const void* w1, const float* b1,
                                    const void* w2, const float* b2, void* out, int N, int H,
                                    int W, int Cin, int Cm, int Cout, void* stream) {
  if (Cm % 8 || Cout % 8 || N < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  return (int)f32::double_conv(static_cast<const float*>(x), static_cast<const float*>(w1), b1,
                               static_cast<const float*>(w2), b2, static_cast<float*>(out), N,
                               H, W, Cin, Cm, Cout, static_cast<cudaStream_t>(stream));
}

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
