// The element types and precision tiers shared by every kernel: the dtype
// and tier codes of the C interfaces, the conversions between the state,
// operand and bf16 types, and the row-tile kernels' (K4, K6) 16-byte
// shared-memory load and one multiply-add at a tier.
//
// Tiers (the `tier` argument of every entry):
//   0 highest: plain multiply-adds (no TF32);
//   1 high:    bf16 hi/lo split of both factors, lo*lo dropped, three sums;
//   2 bf16:    bf16-rounded factors, products exact in fp32 ("default",
//              "bf16"; a bf16-stored bank always takes this tier).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum { DT_F32 = 0, DT_F64 = 1, DT_BF16 = 2 };
enum { TIER_HIGHEST = 0, TIER_HIGH = 1, TIER_BF16 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(double x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T cvt(float x) { return static_cast<T>(x); }
template <typename T> __device__ __forceinline__ T cvt(double x) { return static_cast<T>(x); }
template <typename T> __device__ __forceinline__ T cvt(__nv_bfloat16 x) {
  return static_cast<T>(__bfloat162float(x));
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of a shared-memory row: 4 floats or 2 doubles.
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x, v[1] = q.y;
}

// One multiply-add of y (state type T) and w (operand type WT) into the
// accumulators a0..a2 of type AT at the tier; "high" keeps its three sums
// apart (a0 + a1, then + a2, at the end).
template <int TIER, typename AT, typename T, typename WT>
__device__ __forceinline__ void mac(AT& a0, AT& a1, AT& a2, T y, WT w) {
  if (TIER == TIER_HIGHEST) {
    a0 += static_cast<AT>(y) * static_cast<AT>(cvt<T>(w));
  } else if (TIER == TIER_HIGH) {
    const float yv = to_f(y), wv = to_f(w);
    const float yh = bf16r(yv), yl = bf16r(yv - yh);
    const float wh = bf16r(wv), wl = bf16r(wv - wh);
    // products of two bf16 values are exact in fp32
    a0 += static_cast<AT>(yh * wl);
    a1 += static_cast<AT>(yl * wh);
    a2 += static_cast<AT>(yh * wh);
  } else {
    a0 += static_cast<AT>(bf16r(to_f(y)) * bf16r(to_f(w)));
  }
}

}  // namespace
