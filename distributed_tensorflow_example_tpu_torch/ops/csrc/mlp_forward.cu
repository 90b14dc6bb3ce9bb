// MLP forward, one layer per launch: for layer i of L,
//   hidden layer (i < L):  h_i = round_to_T(act(h_{i-1} @ W_i + b_i))
//   last layer   (i = L):  logits = h_{L-1} @ W_L + b_L          (f32 out)
// with h_0 = x, all of A = h_{i-1} [N, s_{i-1}] and W_i [s_{i-1}, s_i] of
// one dtype T (f32 or bf16), f32 bias, f32 accumulation.  The wrapper
// (ops/fused.py mlp_forward) launches it L times; the hiddens it writes
// are the residuals of the backward.
//
// Replaces the TPU kernel _make_kernel in distributed_tensorflow_example_
// tpu/ops/pallas_fused.py (launched by _forward_pallas; public name
// mlp_forward, the --pallas MLP forward of the training step and eval).
//
// What bounds it on an H100: at the wide training shape (N = 8192,
// 784-4096-4096-10, bf16) it is 2 * N * sum(s_{i-1} * s_i) = 328 GFLOP
// against ~0.2 GB of traffic, so it is bound by operations (0.33 ms at
// the 989 TFLOP/s bf16 tensor-core rate); at the reference shape
// (N = 100, 784-100-10, f32) it moves ~0.6 MB and does 16 MFLOP, so the
// launches themselves bound it.
//
// The design: the TPU body holds every weight of the chain in VMEM and
// walks a 128-row tile through all layers without leaving the chip.  At
// 4096 x 4096 one bf16 weight is 32 MB, far beyond the 227 KB of shared
// memory a block has, so the chain is cut at each layer: one GEMM launch
// per layer, with the bias, the activation and the rounding to T fused
// into its epilogue, and the hidden written to device memory (the
// backward needs it there anyway).  bf16 layers run the tensor-core GEMM
// of gemm_tc.cuh (wgmma over bf16 tiles fed by TMA; a batch of one
// matrix, 128 x 256 tiles, no split of K); f32 layers the CUDA-core GEMM
// of common.cuh (gemm_bias_act_kernel, f32 FMA: the tensor cores take
// f32 only as TF32, against the 1e-4 the f32 forward is held to).  The
// edge guards of both replace the TPU kernel's row padding to 128, so
// any N >= 1 and any width (784, 100, 10) run as they are.
#include "common.cuh"
#include "gemm_tc.cuh"

namespace dtx {
namespace {

// an f32 layer on the CUDA cores
cudaError_t fma_layer(const void* A, const void* W, const float* bias,
                      void* out, int M, int N, int K, int act, bool last,
                      cudaStream_t stream) {
  const dim3 block(kGemmThreads);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1);
  gemm_bias_act_kernel<float, float><<<grid, block, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(W), bias,
      static_cast<float*>(out), nullptr, M, N, K, last ? kIdentity : act);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dtx

// C interface (ctypes).  A [M, K] and W [K, N] are of ``dtype`` (0 f32,
// 1 bf16), bias [N] is f32.  ``last`` = 0: a hidden layer, out [M, N] of
// ``dtype`` = act(A @ W + bias) with ``act`` 1 relu, 2 tanh, 3 sigmoid;
// ``last`` = 1: the logits, out [M, N] f32 = A @ W + bias.  One launch on
// ``stream``; returns its cudaError_t (0 = success).
extern "C" int dtx_mlp_layer_fwd(const void* A, const void* W,
                                 const void* bias, void* out, int M, int N,
                                 int K, int act, int dtype, int last,
                                 void* stream) {
  if (M < 0 || N < 1 || K < 1 || act < dtx::kRelu || act > dtx::kSigmoid ||
      (M + dtx::kBM - 1) / dtx::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0) return (int)cudaSuccess;
  switch (dtype) {
    case dtx::kFloat32:
      return (int)dtx::fma_layer(A, W, b, out, M, N, K, act, last != 0, st);
    case dtx::kBFloat16:
      return (int)(last ? dtx::tc_gemm<float, 2, false>(
                              A, W, b, out, nullptr, 1, M, N, K,
                              dtx::kIdentity, 1, st)
                        : dtx::tc_gemm<__nv_bfloat16, 2, false>(
                              A, W, b, out, nullptr, 1, M, N, K, act, 1,
                              st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
