// Grouped FFN forward: per expert e,
//   h1[e] = round_to_T(act(x[e] @ W1[e] + b1[e]))      (f32 accumulation)
//   out[e] = h1[e] @ W2[e] + b2[e]                      (f32 out)
// over x [E, C, d], W1 [E, d, ff], W2 [E, ff, d] of one dtype T (f32 or
// bf16), f32 biases.  The dense FFN is the E = 1 case.
//
// Replaces the TPU kernel _moe_kernel in distributed_tensorflow_example_
// tpu/ops/pallas_fused.py (launched by _moe_grouped_forward; public
// names moe_grouped_matmul, fp8_grouped_matmul, fp8_dense_ffn), forward
// without the z1 residual output.
//
// What bounds it on an H100: at decode (C = live batch <= 8 rows) the
// weights are the traffic, 2 * d * ff * sizeof(T) bytes per call (16 MB
// in bf16 at d=1024, ff=4096, ~5 us at 3.35 TB/s), so it is bound by
// bytes; at prefill (C = the bucketed prompt width, up to 512 rows) it
// is 4 * C * d * ff operations and bound by the tensor cores' rate.
//
// The design: the TPU body keeps both weight matrices resident in VMEM
// and the [tile, ff] hidden never leaves it.  At d=1024, ff=4096 the
// weights are 16 MB in bf16, far beyond the 227 KB of shared memory a
// block has, so this port does not carry it over block by block.  It is
// two launches of one tiled GEMM with a fused epilogue:
//   launch 1: x @ W1 + b1, activation, round to T -> h1 [E, C, ff] in
//             device memory (the one intermediate the TPU kernel avoids);
//   launch 2: h1 @ W2 + b2 -> out [E, C, d] in f32.
// Each block computes a 64 x 64 output tile over 32-deep K slices staged
// through shared memory as f32 (exact for bf16 inputs), each thread a
// 4 x 4 register tile with f32 FMA accumulation.  This is CUDA-core
// arithmetic: no tensor cores, no TMA, no pipelining of the K loop.
// Keeping h1 on chip (an ff-chunked second GEMM), wgmma, TMA and fp8
// tensor cores are the work of a later change; this kernel is the
// simple, correct reference point their times are measured against.
#include "common.cuh"

namespace dtx {
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
      // x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
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
// bias [E, N], out [E, M, N]; grid (ceil(N/64), ceil(M/64), E).
template <typename T, typename OutT>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_bias_act_kernel(const T* __restrict__ A, const T* __restrict__ B,
                         const float* __restrict__ bias,
                         OutT* __restrict__ out, int M, int N, int K,
                         int act) {
  __shared__ __align__(16) float As[kBK][kBM + kAPad];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const size_t e = blockIdx.z;
  A += e * (size_t)M * (size_t)K;
  B += e * (size_t)K * (size_t)N;
  bias += e * (size_t)N;
  out += e * (size_t)M * (size_t)N;
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
      out[(size_t)gm * N + gn] =
          from_f32<OutT>(activate(acc[i][j] + bias[gn], act));
    }
  }
}

template <typename T>
cudaError_t grouped_ffn(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* h1, float* out,
                        int E, int C, int d, int ff, int act,
                        cudaStream_t stream) {
  if (E == 0 || C == 0) return cudaSuccess;
  const dim3 block(kGemmThreads);
  const dim3 grid1((ff + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gemm_bias_act_kernel<T, T><<<grid1, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<T*>(h1), C, ff, d, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((d + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gemm_bias_act_kernel<T, float><<<grid2, block, 0, stream>>>(
      static_cast<const T*>(h1), static_cast<const T*>(w2), b2, out, C, d, ff,
      kIdentity);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dtx

// C interface (ctypes).  x [E, C, d], w1 [E, d, ff], w2 [E, ff, d] and
// the scratch h1 [E, C, ff] are of ``dtype`` (0 f32, 1 bf16); b1 [E, ff],
// b2 [E, d] and out [E, C, d] are f32.  ``act``: 0 gelu (tanh form),
// 1 relu, 2 tanh, 3 sigmoid.  Two launches on ``stream``; returns the
// first nonzero cudaError_t (0 = success).
extern "C" int dtx_grouped_ffn_fwd(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* h1, void* out,
                                   int E, int C, int d, int ff, int act,
                                   int dtype, void* stream) {
  if (E < 0 || C < 0 || d < 1 || ff < 1 || E > 65535 || act < 0 ||
      act > dtx::kSigmoid || (C + dtx::kBM - 1) / dtx::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  float* outf = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dtx::kFloat32:
      return (int)dtx::grouped_ffn<float>(x, w1, b1f, w2, b2f, h1, outf, E,
                                          C, d, ff, act, st);
    case dtx::kBFloat16:
      return (int)dtx::grouped_ffn<__nv_bfloat16>(x, w1, b1f, w2, b2f, h1,
                                                  outf, E, C, d, ff, act, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
