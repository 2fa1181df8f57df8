// Shared helpers of the port's kernels.  Each source under csrc/ is built
// into its own shared library with a plain C interface and bound with
// ctypes (ugpg_tpu_torch/ops/cuda/_lib.py).  Kernels accept float32 and
// bfloat16 (dtype code 0 and 1) and accumulate in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ugpg {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements <-> 8 floats; p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Grid size of a grid-stride elementwise pass: enough blocks to fill the
// card several times over, never more than the work needs.
inline int grid_stride_blocks(int64_t n, int threads) {
  const int64_t need = (n + threads - 1) / threads;
  const int64_t cap = 132 * 16;  // 132 SMs on an H100 SXM
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

// Blocks of `kernel`, launched with `threads` threads and no dynamic shared
// memory, that the current device keeps resident at once: one wave of a
// persistent grid.  Looked up once per device into `cache` (zero-initialised,
// indexed by device); racing callers store the same value.
template <typename Kernel, int kDevices>
cudaError_t resident_blocks(Kernel kernel, int threads, int (&cache)[kDevices], int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return e;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

}  // namespace ugpg

// Every library exports its own copy (each source is a separate .so).
extern "C" const char* ugpg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
