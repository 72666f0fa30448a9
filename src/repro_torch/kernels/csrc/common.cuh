// Helpers shared by the kernel sources: float32 / bfloat16 conversion and
// tile staging.  Included by attention.cu and scan.cu; each translation
// unit keeps its own copy (anonymous namespace).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// Four consecutive elements as float32 (16-byte load for float32, 8-byte
// load for bfloat16; the wrappers check the alignment).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage rows [r0, r0 + ROWS) of a (S, HD) matrix with row stride ld_src
// (elements) into shared memory as float32 with row stride LD, times scale;
// rows at or past S become 0.  Each thread issues all its vector loads
// before its first store, so ROWS * HD / (4 * NT) loads are in flight at
// once instead of one at a time.
template <int ROWS, int HD, int LD, int NT, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ld_src,
                                           int r0, int S, float scale) {
  constexpr int VPR = HD / 4;  // vectors per row
  constexpr int ITERS = ROWS * VPR / NT;
  static_assert(ROWS * VPR % NT == 0, "tile must split evenly over the threads");
  float4 buf[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / VPR, c = (idx % VPR) * 4;
    buf[it] = r0 + r < S ? load4(src + (r0 + r) * ld_src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = threadIdx.x + it * NT, r = idx / VPR, c = (idx % VPR) * 4;
    float* d = dst + r * LD + c;
    d[0] = buf[it].x * scale;
    d[1] = buf[it].y * scale;
    d[2] = buf[it].z * scale;
    d[3] = buf[it].w * scale;
  }
}

}  // namespace
