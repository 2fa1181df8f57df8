// Uncertainty map from logits: A = 1 - 2 |sigmoid(x) - 0.5|, pointwise, in
// the logits' dtype (float32 or bfloat16) and memory order.
//
// Replaces: ugpg_tpu/ops/pallas/uncertainty_fused.py, uncertainty_from_logits
//           (kernel body _unc_kernel, one (256, 128) tile per grid step of a
//           zero-padded copy of the logits; here no padding and no copy).
// Bound on the H100: memory.  One read and one write of the tensor, 8n bytes
//   in float32 and 4n in bfloat16: 10.0 us for the 4,194,304 float32 logits
//   of a bucket-64 serving call at 3.35 TB/s, 1.25 us at bucket 8, 0.16 us at
//   bucket 1, where a call is its launch.  About 20 operations per element,
//   far below the card's ~20 float32 operations per byte of bandwidth.
// Design:
//   * A persistent grid: one wave of resident blocks (ugpg::resident_blocks,
//     the occupancy API's count times the SMs, cached per device), fewer
//     when the work is smaller (bucket 1: 64 blocks of 256).  Each thread
//     walks 16-byte vectors (4 float32 or 8 bfloat16) and loads its next
//     vector before computing on the current one, so two are in flight per
//     thread while it computes.
//   * A scalar prologue takes the elements before x's first 16-byte boundary
//     (a slice such as x[1:]) and an epilogue the n % vec after the last
//     vector; an out at another offset from a 16-byte boundary than x sends
//     every element through the scalar walk.
//   * Flat indices are int64: the walk is right past 2^31 elements.
//   * float32 math with expf and IEEE division (no fast-math), in the JAX
//     kernel's expression 1 - 2|p - 0.5|, not the equal 2 sigmoid(-|x|),
//     which rounds differently near |x| ~ 17: the float32 map agrees with
//     torch.sigmoid's to a few ulp.
//   * One launch per call; no allocation, no synchronisation.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float uncertainty(float x) {
  const float p = 1.0f / (1.0f + expf(-x));
  return 1.0f - 2.0f * fabsf(p - 0.5f);
}

template <typename T>
__device__ __forceinline__ T map1(T x) {
  return ugpg::from_float<T>(uncertainty(ugpg::to_float(x)));
}

// The map over the 16 / sizeof(T) elements of one 16-byte vector.
template <typename T>
__device__ __forceinline__ uint4 map16(uint4 v) {
  const T* e = reinterpret_cast<const T*>(&v);
  uint4 r;
  T* o = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int k = 0; k < (int)(16 / sizeof(T)); ++k) o[k] = map1<T>(e[k]);
  return r;
}

// [0, head) scalar, then the 16-byte vectors, then the n % vec tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
uncertainty_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, int64_t head) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = t; i < head; i += stride) out[i] = map1<T>(x[i]);
  const int64_t nv = (n - head) / kVec;
  const uint4* x4 = reinterpret_cast<const uint4*>(x + head);
  uint4* o4 = reinterpret_cast<uint4*>(out + head);
  uint4 a;
  if (t < nv) a = __ldg(x4 + t);
  for (int64_t j = t; j < nv; j += stride) {
    uint4 next;
    if (j + stride < nv) next = __ldg(x4 + j + stride);
    o4[j] = map16<T>(a);
    a = next;
  }
  for (int64_t i = head + nv * kVec + t; i < n; i += stride) out[i] = map1<T>(x[i]);
}

// Where the vector walk starts: after the elements before x's first 16-byte
// boundary, or at n (every element scalar) when out sits at another offset
// from one.
template <typename T>
int64_t vector_head(const void* x, const void* out, int64_t n) {
  const uintptr_t off = reinterpret_cast<uintptr_t>(x) & 15;
  if (off % sizeof(T) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != off) return n;
  const int64_t head = (int64_t)(((16 - off) & 15) / sizeof(T));
  return head < n ? head : n;
}

template <typename T>
int launch(const void* x, void* out, int64_t n, cudaStream_t s) {
  static int cache[kMaxDevices] = {};
  int resident = 0;
  const cudaError_t e = ugpg::resident_blocks(uncertainty_kernel<T>, kThreads, cache, &resident);
  if (e != cudaSuccess) return (int)e;
  constexpr int64_t kVec = 16 / sizeof(T);
  const int64_t head = vector_head<T>(x, out, n);
  const int64_t units = head < n ? (n - head) / kVec : n;  // vectors, or scalars
  int64_t need = (units + kThreads - 1) / kThreads;
  if (need < 1) need = 1;
  const int blocks = (int)(need < resident ? need : resident);
  uncertainty_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                    static_cast<T*>(out), n, head);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: n elements of one dtype in the same dense memory order.  One launch.
extern "C" int ugpg_uncertainty_from_logits(const void* x, void* out, int64_t n, int dtype,
                                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ugpg::kFloat32) return launch<float>(x, out, n, s);
  if (dtype == ugpg::kBFloat16) return launch<__nv_bfloat16>(x, out, n, s);
  return (int)cudaErrorInvalidValue;
}
