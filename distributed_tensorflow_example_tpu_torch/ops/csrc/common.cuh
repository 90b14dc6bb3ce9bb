// Shared helpers for the port's hand-written Hopper kernels: dtype
// codes of the C interface, f32 conversions, a block-wide sum, the
// shared-memory opt-in of a launch, and the tiled GEMM with a fused
// bias + activation epilogue.
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

// A kernel whose dynamic shared memory is above the 48 KB a launch gets
// without an opt-in: the opt-in, set once per instantiation (``done``).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

// ---------------------------------------------------------------------------
// The tiled GEMM with a fused bias + activation epilogue of the grouped
// FFN's f32 form (grouped_ffn.cu, two launches; the f32 MLP forward has
// its own split-K GEMM in mlp_forward.cu):
//   z[e] = A[e] @ B[e] + bias[e]                 (f32; stored when kWithZ)
//   out[e] = round_to_OutT(act(z[e]))
// kWithZ (the grouped FFN's training form only) also writes the f32
// pre-activation z to z_out, the residual its backward differentiates
// the activation at; every other instantiation takes z_out = nullptr and
// compiles to the same epilogue as before.
// Each block computes a 64 x 64 output tile over 32-deep K slices staged
// through shared memory as f32 (exact for bf16 inputs), each thread a
// 4 x 4 register tile with f32 FMA accumulation.  Every load and store is
// guarded, so M, N and K need not be multiples of the tile.  CUDA-core
// arithmetic: no tensor cores, no TMA, no pipelining of the K loop.
// Internal linkage (anonymous namespace): each source that includes this
// header gets its own copy of the kernel.
// ---------------------------------------------------------------------------
namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kAPad = 4;  // keeps the transposed A stores to 2-way conflicts

// activation codes of the C interface (ops/fused.py _ACT_CODES)
constexpr int kGelu = 0;
constexpr int kRelu = 1;
constexpr int kTanh = 2;
constexpr int kSigmoid = 3;
constexpr int kIdentity = 4;

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kGelu: {
      // jax.nn.gelu's default tanh approximation:
      // x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))), written as
      // PyTorch's CUDA gelu writes it (the card's plain version), so that
      // at equal z the two round a bf16 hidden alike
      const float k = 0.7978845608028654f;
      const float cube = v * v * v;
      const float cdf = 0.5f * (1.0f + tanhf(k * (v + 0.044715f * cube)));
      return v * cdf;
    }
    case kRelu:
      return fmaxf(v, 0.f);
    case kTanh:
      return tanhf(v);
    case kSigmoid:
      return 1.f / (1.f + expf(-v));
    default:
      return v;
  }
}

// out[e] = act(A[e] @ B[e] + bias[e]) for A [E, M, K], B [E, K, N],
// bias [E, N], out [E, M, N] (and z_out [E, M, N] f32 when kWithZ);
// grid (ceil(N/64), ceil(M/64), E).
template <typename T, typename OutT, bool kWithZ = false>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_bias_act_kernel(const T* __restrict__ A, const T* __restrict__ B,
                         const float* __restrict__ bias,
                         OutT* __restrict__ out, float* __restrict__ z_out,
                         int M, int N, int K, int act) {
  __shared__ __align__(16) float As[kBK][kBM + kAPad];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const size_t e = blockIdx.z;
  A += e * (size_t)M * (size_t)K;
  B += e * (size_t)K * (size_t)N;
  bias += e * (size_t)N;
  out += e * (size_t)M * (size_t)N;
  if (kWithZ) z_out += e * (size_t)M * (size_t)N;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile [kBM, kBK]: K is contiguous in memory, stored transposed
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kGemmThreads; ++i) {
      const int idx = tid + i * kGemmThreads;
      const int m = idx / kBK;
      const int k = idx % kBK;
      const int gm = m0 + m;
      const int gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f32(A[(size_t)gm * K + gk]) : 0.f;
    }
    // B tile [kBK, kBN]: N is contiguous in memory
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kGemmThreads; ++i) {
      const int idx = tid + i * kGemmThreads;
      const int k = idx / kBN;
      const int n = idx % kBN;
      const int gk = k0 + k;
      const int gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f32(B[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn >= N) continue;
      const float z = acc[i][j] + bias[gn];
      if (kWithZ) z_out[(size_t)gm * N + gn] = z;
      out[(size_t)gm * N + gn] = from_f32<OutT>(activate(z, act));
    }
  }
}

}  // namespace

}  // namespace dtx
