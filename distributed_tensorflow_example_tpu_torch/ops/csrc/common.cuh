// Shared helpers for the port's hand-written Hopper kernels: dtype
// codes of the C interface, f32 conversions and a block-wide sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dtx {

// dtype codes passed across the ctypes boundary (ops/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as XLA casts
}

// Sum of ``v`` over the whole block, returned to every thread.
// ``red`` is 32 floats of shared memory; blockDim.x is a multiple of
// 32.  Every warp folds the per-warp partials itself, so no second
// broadcast is needed; the trailing barrier frees ``red`` for reuse.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  return v;
}

}  // namespace dtx
