// Grouped FFN forward: per expert e,
//   z1[e] = x[e] @ W1[e] + b1[e]                        (f32 accumulation)
//   h1[e] = round_to_T(act(z1[e]))
//   out[e] = h1[e] @ W2[e] + b2[e]                      (f32 out)
// over x [E, C, d], W1 [E, d, ff], W2 [E, ff, d] of one dtype T (f32 or
// bf16), f32 biases.  The dense FFN is the E = 1 case.  Two forms, as
// the TPU kernel has: the primal form (eval, decode) keeps z1 to itself;
// the training form (want_z1) also writes the f32 z1 [E, C, ff], the
// residual the backward differentiates the activation at.
//
// Replaces the TPU kernel _moe_kernel in distributed_tensorflow_example_
// tpu/ops/pallas_fused.py (launched by _moe_grouped_forward, want_z1
// False or True; public names moe_grouped_matmul, fp8_grouped_matmul,
// fp8_dense_ffn; the training form is the forward rule of their VJPs).
// The backward is no kernel in either package: plain batched products
// (XLA einsums there, ops/fused.py here).
//
// What bounds it on an H100: at decode (C = live batch <= 8 rows) the
// weights are the traffic, 2 * d * ff * sizeof(T) bytes per call (16 MB
// in bf16 at d=1024, ff=4096, ~5 us at 3.35 TB/s), so it is bound by
// bytes; at prefill (C = the bucketed prompt width, up to 512 rows) and
// in MoE training (E = 64, C = 640, d = 1024, ff = 2048: 344 GFLOP and
// ~1.1 GB with z1) it is 4 * E * C * d * ff operations and bound by the
// tensor cores' rate.
//
// The design: the TPU body keeps both weight matrices resident in VMEM
// and the [tile, ff] hidden never leaves it.  At d=1024, ff=4096 the
// weights are 16 MB in bf16, far beyond the 227 KB of shared memory a
// block has, so this port does not carry it over block by block.  It is
// two launches of one tiled GEMM with a fused epilogue
// (gemm_bias_act_kernel in common.cuh, shared with mlp_forward.cu):
//   launch 1: x @ W1 + b1 (-> z1 in f32 in the training form),
//             activation, round to T -> h1 [E, C, ff] in device memory
//             (the one intermediate the TPU kernel avoids);
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

template <typename T>
cudaError_t grouped_ffn(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* h1, float* out,
                        float* z1, int E, int C, int d, int ff, int act,
                        cudaStream_t stream) {
  if (E == 0 || C == 0) return cudaSuccess;
  const dim3 block(kGemmThreads);
  const dim3 grid1((ff + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  if (z1 != nullptr) {
    gemm_bias_act_kernel<T, T, true><<<grid1, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), b1,
        static_cast<T*>(h1), z1, C, ff, d, act);
  } else {
    gemm_bias_act_kernel<T, T><<<grid1, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), b1,
        static_cast<T*>(h1), nullptr, C, ff, d, act);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((d + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gemm_bias_act_kernel<T, float><<<grid2, block, 0, stream>>>(
      static_cast<const T*>(h1), static_cast<const T*>(w2), b2, out, nullptr,
      C, d, ff, kIdentity);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dtx

// C interface (ctypes).  x [E, C, d], w1 [E, d, ff], w2 [E, ff, d] and
// the scratch h1 [E, C, ff] are of ``dtype`` (0 f32, 1 bf16); b1 [E, ff],
// b2 [E, d] and out [E, C, d] are f32; z1 is NULL (the primal form) or an
// f32 [E, C, ff] output (the training form).  ``act``: 0 gelu (tanh
// form), 1 relu, 2 tanh, 3 sigmoid.  Two launches on ``stream``; returns
// the first nonzero cudaError_t (0 = success).
extern "C" int dtx_grouped_ffn_fwd(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* h1, void* out,
                                   void* z1, int E, int C, int d, int ff,
                                   int act, int dtype, void* stream) {
  if (E < 0 || C < 0 || d < 1 || ff < 1 || E > 65535 || act < 0 ||
      act > dtx::kSigmoid || (C + dtx::kBM - 1) / dtx::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  float* outf = static_cast<float*>(out);
  float* z1f = static_cast<float*>(z1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dtx::kFloat32:
      return (int)dtx::grouped_ffn<float>(x, w1, b1f, w2, b2f, h1, outf, z1f,
                                          E, C, d, ff, act, st);
    case dtx::kBFloat16:
      return (int)dtx::grouped_ffn<__nv_bfloat16>(x, w1, b1f, w2, b2f, h1,
                                                  outf, z1f, E, C, d, ff, act,
                                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
