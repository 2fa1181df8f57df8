// Uncertainty-weighted BCE-with-logits: the loss of the train step and its
// gradient, one kernel launch each.
//
//   pixel = (1 - z) x + (1 + (pw - 1) z) softplus(-x)
//   w     = 1 + alpha (1 - 2 |p - 0.5|)
//   forward:  final = mean(pixel * w), base = mean(pixel)
//   backward: dx = g / N * w * ((1 - z) - (1 + (pw - 1) z) sigmoid(-x))
//
// Replaces: ugpg_tpu/ops/pallas/uncertainty_fused.py, _run_fwd (kernel body
//           _loss_fwd_kernel) and _run_bwd (_loss_bwd_kernel), the forward
//           and backward of the custom VJP uncertainty_weighted_bce.
// Bound on the H100: memory.  The forward reads x, z and p once and writes
//   two floats, 12n + 8 bytes; the backward reads x, z, p and g and writes
//   dx, 16n + 4 bytes.  With alpha = 0 the weight is exactly 1 and p is not
//   read: 8n + 8 and 12n + 4.  About 20 operations per element, far below
//   the card's ~20 float32 operations per byte of bandwidth.  At the
//   training path's sizes (0.5 M elements at 256 px, batch 8: a 1.9 us
//   byte bound) one launch costs more than the bytes, so one launch per call
//   is what the forward can gain there; at batch 64 (50 MB) it is the bytes.
// Design:
//   * A persistent grid: one wave of resident blocks (the occupancy API's
//     count times the SMs, at most kMaxBlocks), fewer when the work is
//     smaller; it never grows with n.  Each thread walks 16-byte float4s of
//     every stream and loads its next float4 of each before computing on
//     the current one, so two per stream are in flight while it computes.
//     A scalar prologue takes the elements before x's first 16-byte
//     boundary (a slice such as x[1:]) and an epilogue the n % 4 after the
//     last float4; pointers at different offsets from a 16-byte boundary take
//     the scalar walk for every element.
//   * The forward is one launch.  Each thread sums in float64 (cheap next to
//     the memory traffic; the error does not grow with n, past 2^31
//     elements), each block reduces by warp shuffles and one shared-memory
//     step into its slot of a workspace, and the last block to take a ticket
//     (atomicAdd after __threadfence) loads every slot at once, adds them in
//     index order, writes the two means and puts the ticket back to 0 for
//     the next call.  Every sum's order is fixed by n, the alignment and the
//     grid, so the loss is bit-identical from run to run.  The wrapper keeps
//     one workspace per device and stream, zeroed once: launches on two
//     streams never share a ticket.  That last block's chain (fence, ticket,
//     slot loads, block sum) comes after the streaming and is what keeps
//     the forward further from its bound than the backward.
//   * The backward is the same walk, storing float4s of dx.  g arrives as a
//     device pointer and is read by the kernel, so the host never waits for
//     the forward's result.
//   * alpha = 0 (stage 1) selects instantiations that never read p.
//   * Flat indices are int64: no tail mask (the JAX kernel once mis-masked
//     past 2^24 elements with a float32 index compare).
//   * expf and log1pf, not the fast-math intrinsics.  float32 only: the heads
//     and the logits are always float32.

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // workspace slots: the grid's ceiling
constexpr int kSlotsPerThread = kMaxBlocks / kThreads;
static_assert(kMaxBlocks % kThreads == 0, "the finishing block loads every slot at once");
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float softplus_neg(float x) {
  // softplus(-x) = log(1 + exp(-x)) = max(-x, 0) + log1p(exp(-|x|))
  return fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float pixel_loss(float x, float z, float pw) {
  return (1.0f - z) * x + (1.0f + (pw - 1.0f) * z) * softplus_neg(x);
}

__device__ __forceinline__ float pixel_grad(float x, float z, float pw) {
  return (1.0f - z) - (1.0f + (pw - 1.0f) * z) / (1.0f + expf(x));
}

__device__ __forceinline__ float weight(float p, float alpha) {
  return 1.0f + alpha * (1.0f - 2.0f * fabsf(p - 0.5f));
}

// Calls f.one(i, x, z, p) for the scalar elements and f.four(j, x4, z4, p4)
// for the float4 whose first element is head + 4 j, in an order fixed by n,
// head and the grid: the prologue [0, head), the float4s, the epilogue.
// The float4 walk loads a thread's next float4 of each stream before it
// computes on the current one, so two of each are in flight per thread.
// p is read only when kWeighted.
template <bool kWeighted, typename F>
__device__ __forceinline__ void walk(const float* __restrict__ x, const float* __restrict__ z,
                                     const float* __restrict__ p, int64_t n, int64_t head,
                                     F& f) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t nv = (n - head) >> 2;
  for (int64_t i = t; i < head; i += stride) f.one(i, x[i], z[i], kWeighted ? p[i] : 0.0f);
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const float4* z4 = reinterpret_cast<const float4*>(z + head);
  const float4* p4 = reinterpret_cast<const float4*>(p + head);
  float4 a, b, c;
  if (t < nv) {
    a = __ldg(x4 + t);
    b = __ldg(z4 + t);
    if constexpr (kWeighted) c = __ldg(p4 + t);
  }
  for (int64_t j = t; j < nv; j += stride) {
    float4 na, nb, nc;
    if (j + stride < nv) {
      na = __ldg(x4 + j + stride);
      nb = __ldg(z4 + j + stride);
      if constexpr (kWeighted) nc = __ldg(p4 + j + stride);
    }
    if constexpr (kWeighted) {
      f.four(j, a, b, c);
      c = nc;
    } else {
      f.four(j, a, b, a);
    }
    a = na;
    b = nb;
  }
  for (int64_t i = head + 4 * nv + t; i < n; i += stride)
    f.one(i, x[i], z[i], kWeighted ? p[i] : 0.0f);
}

template <bool kWeighted>
struct SumLoss {
  float pw, alpha;
  double wsum, bsum;
  __device__ __forceinline__ void one(int64_t, float x, float z, float p) {
    const float pixel = pixel_loss(x, z, pw);
    if constexpr (kWeighted) wsum += (double)(pixel * weight(p, alpha));
    bsum += (double)pixel;
  }
  __device__ __forceinline__ void four(int64_t, float4 x, float4 z, float4 p) {
    one(0, x.x, z.x, p.x);
    one(0, x.y, z.y, p.y);
    one(0, x.z, z.z, p.z);
    one(0, x.w, z.w, p.w);
  }
};

template <bool kWeighted>
struct Grad {
  float pw, alpha, scale;
  float* dx;     // element i
  float4* dx4;   // the float4 walk's j
  __device__ __forceinline__ float at(float x, float z, float p) const {
    const float dpl = pixel_grad(x, z, pw);
    if constexpr (kWeighted) return scale * weight(p, alpha) * dpl;
    return scale * dpl;  // the weight is exactly 1
  }
  __device__ __forceinline__ void one(int64_t i, float x, float z, float p) {
    dx[i] = at(x, z, p);
  }
  __device__ __forceinline__ void four(int64_t j, float4 x, float4 z, float4 p) {
    dx4[j] = make_float4(at(x.x, z.x, p.x), at(x.y, z.y, p.y), at(x.z, z.z, p.z),
                         at(x.w, z.w, p.w));
  }
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// b (and w when kWeighted) summed over the block in a fixed order, valid in
// thread 0.  The caller syncs before smem is written again.
template <bool kWeighted>
__device__ __forceinline__ void block_sum(double& w, double& b, double (&smem)[2][kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  b = warp_sum(b);
  if constexpr (kWeighted) w = warp_sum(w);
  if (lane == 0) {
    smem[0][warp] = b;
    if constexpr (kWeighted) smem[1][warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
    b = warp_sum(lane < kWarps ? smem[0][lane] : 0.0);
    if constexpr (kWeighted) w = warp_sum(lane < kWarps ? smem[1][lane] : 0.0);
  }
}

// slots: kMaxBlocks float64 base sums, then kMaxBlocks weighted sums; ticket:
// 0 on entry and on exit; out: (final, base).
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
bce_forward(const float* __restrict__ x, const float* __restrict__ z,
            const float* __restrict__ p, int64_t n, int64_t head, float pw, float alpha,
            double* __restrict__ slots, unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ double smem[2][kWarps];
  __shared__ bool last;
  SumLoss<kWeighted> f{pw, alpha, 0.0, 0.0};
  walk<kWeighted>(x, z, p, n, head, f);
  double w = f.wsum, b = f.bsum;
  block_sum<kWeighted>(w, b, smem);
  if (threadIdx.x == 0) {
    slots[blockIdx.x] = b;
    if constexpr (kWeighted) slots[kMaxBlocks + blockIdx.x] = w;
    __threadfence();  // the slot is visible to every block before the ticket is
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double bs[kSlotsPerThread], ws[kSlotsPerThread];
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {  // every load issued before the adds
    const int i = threadIdx.x + k * kThreads;
    bs[k] = i < (int)gridDim.x ? __ldcg(slots + i) : 0.0;  // L2: written by other SMs
    if constexpr (kWeighted) ws[k] = i < (int)gridDim.x ? __ldcg(slots + kMaxBlocks + i) : 0.0;
  }
  w = b = 0.0;
#pragma unroll
  for (int k = 0; k < kSlotsPerThread; ++k) {
    b += bs[k];
    if constexpr (kWeighted) w += ws[k];
  }
  block_sum<kWeighted>(w, b, smem);
  if (threadIdx.x == 0) {
    const double base = b / (double)n;
    out[0] = (float)(kWeighted ? w / (double)n : base);
    out[1] = (float)base;
    *ticket = 0u;
  }
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
bce_backward(const float* __restrict__ x, const float* __restrict__ z,
             const float* __restrict__ p, const float* __restrict__ g, int64_t n, int64_t head,
             float pw, float alpha, float inv_n, float* __restrict__ dx) {
  Grad<kWeighted> f{pw, alpha, __ldg(g) * inv_n, dx, reinterpret_cast<float4*>(dx + head)};
  walk<kWeighted>(x, z, p, n, head, f);
}

// Where the float4 walk starts: after the elements before x's first 16-byte
// boundary, or at n (every element scalar) when another stream sits at
// another offset from one.  Null pointers are streams not read.
int64_t vector_head(int64_t n, const void* x, std::initializer_list<const void*> others) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(x) & 15;
  if (off & 3) return n;
  for (const void* q : others)
    if (q != nullptr && (reinterpret_cast<uintptr_t>(q) & 15) != off) return n;
  const int64_t head = (int64_t)(((16 - off) & 15) >> 2);
  return head < n ? head : n;
}

// One wave of resident blocks, fewer when the walk needs fewer.
template <typename Kernel>
cudaError_t grid(Kernel kernel, int (&cache)[kMaxDevices], int64_t n, int64_t head,
                 int* blocks) {
  int resident = 0;
  const cudaError_t e = ugpg::resident_blocks(kernel, kThreads, cache, &resident);
  if (e != cudaSuccess) return e;
  const int64_t units = head < n ? (n - head) >> 2 : n;  // float4s, or scalars
  int64_t need = (units + kThreads - 1) / kThreads;
  if (need < 1) need = 1;
  if (need > resident) need = resident;
  *blocks = (int)(need < kMaxBlocks ? need : kMaxBlocks);
  return cudaSuccess;
}

template <bool kWeighted>
int launch_forward(const float* x, const float* z, const float* p, int64_t n, float pw,
                   float alpha, double* slots, float* out, cudaStream_t s) {
  static int cache[kMaxDevices] = {};
  const int64_t head = vector_head(n, x, {z, kWeighted ? p : nullptr});
  int blocks = 0;
  const cudaError_t e = grid(bce_forward<kWeighted>, cache, n, head, &blocks);
  if (e != cudaSuccess) return (int)e;
  unsigned* ticket = reinterpret_cast<unsigned*>(slots + 2 * kMaxBlocks);
  bce_forward<kWeighted><<<blocks, kThreads, 0, s>>>(x, z, p, n, head, pw, alpha, slots, ticket,
                                                     out);
  return (int)cudaGetLastError();
}

template <bool kWeighted>
int launch_backward(const float* x, const float* z, const float* p, const float* g, int64_t n,
                    float pw, float alpha, float inv_n, float* dx, cudaStream_t s) {
  static int cache[kMaxDevices] = {};
  const int64_t head = vector_head(n, x, {z, kWeighted ? p : nullptr, dx});
  int blocks = 0;
  const cudaError_t e = grid(bce_backward<kWeighted>, cache, n, head, &blocks);
  if (e != cudaSuccess) return (int)e;
  bce_backward<kWeighted><<<blocks, kThreads, 0, s>>>(x, z, p, g, n, head, pw, alpha, inv_n, dx);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the forward's workspace: 2 * kMaxBlocks float64 slots, then the
// ticket, zeroed once by the caller.  One workspace per device and stream.
extern "C" int ugpg_uncertainty_bce_workspace_bytes() {
  return (int)((2 * kMaxBlocks + 1) * sizeof(double));
}

// x, z: n float32; p: n float32, not read when alpha == 0; out: 2 float32,
// (final, base).  One launch.
extern "C" int ugpg_uncertainty_bce_forward(const void* x, const void* z, const void* p,
                                            int64_t n, float pw, float alpha, void* workspace,
                                            void* out, void* stream) {
  const auto xf = static_cast<const float*>(x), zf = static_cast<const float*>(z),
             pf = static_cast<const float*>(p);
  const auto ws = static_cast<double*>(workspace);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return alpha != 0.0f ? launch_forward<true>(xf, zf, pf, n, pw, alpha, ws, o, s)
                       : launch_forward<false>(xf, zf, pf, n, pw, alpha, ws, o, s);
}

// x, z, dx: n float32; p: n float32, not read when alpha == 0; g: one
// float32 on the device.
extern "C" int ugpg_uncertainty_bce_backward(const void* x, const void* z, const void* p,
                                             const void* g, int64_t n, float pw, float alpha,
                                             float inv_n, void* dx, void* stream) {
  const auto xf = static_cast<const float*>(x), zf = static_cast<const float*>(z),
             pf = static_cast<const float*>(p), gf = static_cast<const float*>(g);
  const auto d = static_cast<float*>(dx);
  const auto s = static_cast<cudaStream_t>(stream);
  return alpha != 0.0f ? launch_backward<true>(xf, zf, pf, gf, n, pw, alpha, inv_n, d, s)
                       : launch_backward<false>(xf, zf, pf, gf, n, pw, alpha, inv_n, d, s);
}
