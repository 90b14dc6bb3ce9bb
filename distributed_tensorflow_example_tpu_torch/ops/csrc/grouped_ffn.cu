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
// weights are 16 MB in bf16, and a 128-row hidden at ff 2048 is 512 KB,
// far beyond the 227 KB of shared memory a block has, so this port does
// not carry it over block by block.  It is two products, each one batched
// launch over the experts with a fused epilogue:
//   launch 1: x @ W1 + b1 (-> z1 in f32 in the training form),
//             activation, round to T -> h1 [E, C, ff] in device memory
//             (the one intermediate the TPU kernel avoids);
//   launch 2: h1 @ W2 + b2 -> out [E, C, d] in f32.
// bf16 (every main path): gemm_bias_act_tc_kernel of gemm_tc.cuh, the
// tensor-core GEMM the MLP forward's bf16 layers run, with the expert as
// its batch index (blockIdx.z and the third coordinate of its TMA boxes)
// and the z1 store in its epilogue (kWithZ).  f32: the CUDA-core GEMM of
// common.cuh (gemm_bias_act_kernel, f32 FMA over 64 x 64 tiles): the
// tensor cores take f32 only as TF32, against the 1e-3 the f32 form is
// held to, and no main path runs it.
//
// The plan (ops/fused.py grouped_ffn_plan, chosen in Python and tested
// on the CPU): per product, 128 x 256 tiles where they give at least one
// CTA an SM (132 on an H100), else 128 x 128 tiles, and where those are
// still too few, K split in s equal shares so that tiles x s fills one
// wave; the f32 shares then go through split_k_sum_kernel, which adds
// them in a fixed order and applies the product's epilogue (bias,
// activation, rounding, z1), so a split launch 1 reduces before its
// activation and the result is the same bits from run to run.  At the
// shapes the paths run, H100 (132 SMs):
//   decode  E 1, C 8, d 1024, ff 4096:  launch 1 128 x 128 tiles, K in
//           4 shares: 128 CTAs + the sum; launch 2 128 x 128, K in 16
//           shares: 128 CTAs + the sum;
//   prefill E 1, C 512:                 launch 1 128 x 128, no split: 128
//           CTAs; launch 2 128 x 128, K in 4 shares: 128 CTAs + the sum;
//   moe_wide E 64, C 640, d 1024, ff 2048 (training): launch 1 128 x 256:
//           2560 CTAs; launch 2 128 x 256: 1280 CTAs;
//   moe_wide eval, C 160:               1024 and 512 CTAs, 128 x 256.
#include "common.cuh"
#include "gemm_tc.cuh"

namespace dtx {
namespace {

// the f32 form: two launches of the CUDA-core GEMM
cudaError_t grouped_ffn_fma(const float* x, const float* w1, const float* b1,
                            const float* w2, const float* b2, float* h1,
                            float* out, float* z1, int E, int C, int d,
                            int ff, int act, cudaStream_t stream) {
  const dim3 block(kGemmThreads);
  const dim3 grid1((ff + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  if (z1 != nullptr) {
    gemm_bias_act_kernel<float, float, true><<<grid1, block, 0, stream>>>(
        x, w1, b1, h1, z1, C, ff, d, act);
  } else {
    gemm_bias_act_kernel<float, float><<<grid1, block, 0, stream>>>(
        x, w1, b1, h1, nullptr, C, ff, d, act);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((d + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  gemm_bias_act_kernel<float, float><<<grid2, block, 0, stream>>>(
      h1, w2, b2, out, nullptr, C, d, ff, kIdentity);
  return cudaGetLastError();
}

// One bf16 product out = act(A @ W + bias) over E experts on the tensor
// cores, with 128 x (128 halves) tiles, K split in ``splits`` shares
// (through ``part`` and split_k_sum) where splits > 1.
template <typename OutT, bool kWithZ>
cudaError_t tc_product(const void* A, const void* W, const float* bias,
                       void* out, float* z, float* part, int E, int M, int N,
                       int K, int act, int halves, int splits,
                       cudaStream_t stream) {
  if (splits == 1)
    return halves == 2
               ? tc_gemm<OutT, 2, kWithZ>(A, W, bias, out, z, E, M, N, K,
                                          act, 1, stream)
               : tc_gemm<OutT, 1, kWithZ>(A, W, bias, out, z, E, M, N, K,
                                          act, 1, stream);
  const cudaError_t err =
      halves == 2 ? tc_gemm<float, 2, false>(A, W, nullptr, part, nullptr, E,
                                             M, N, K, kIdentity, splits,
                                             stream)
                  : tc_gemm<float, 1, false>(A, W, nullptr, part, nullptr, E,
                                             M, N, K, kIdentity, splits,
                                             stream);
  if (err != cudaSuccess) return err;
  return split_k_sum<OutT, kWithZ>(part, splits, bias, out, z, E, M, N, act,
                                   stream);
}

// the bf16 form: launch 1 (+ its split sum), then launch 2 (+ its sum)
template <bool kWithZ>
cudaError_t grouped_ffn_tc(const void* x, const void* w1, const float* b1,
                           const void* w2, const float* b2, void* h1,
                           float* out, float* z1, float* part, int E, int C,
                           int d, int ff, int act, const int plan[4],
                           cudaStream_t stream) {
  const cudaError_t err = tc_product<__nv_bfloat16, kWithZ>(
      x, w1, b1, h1, z1, part, E, C, ff, d, act, plan[0], plan[1], stream);
  if (err != cudaSuccess) return err;
  return tc_product<float, false>(h1, w2, b2, out, nullptr, part, E, C, d,
                                  ff, kIdentity, plan[2], plan[3], stream);
}

}  // namespace
}  // namespace dtx

// C interface (ctypes).  x [E, C, d], w1 [E, d, ff], w2 [E, ff, d] and
// the scratch h1 [E, C, ff] are of ``dtype`` (0 f32, 1 bf16); b1 [E, ff],
// b2 [E, d] and out [E, C, d] are f32; z1 is NULL (the primal form) or an
// f32 [E, C, ff] output (the training form).  ``act``: 0 gelu (tanh
// form), 1 relu, 2 tanh, 3 sigmoid.  bf16 only: (halves1, splits1) and
// (halves2, splits2) are the plan of launch 1 and launch 2 (tile width
// 128 x halves, halves 1 or 2; K in ``splits`` shares, 1 <= splits <=
// ceil(K / 64)), and ``part`` an f32 scratch of splits * E * C * N floats
// for each split launch (NULL where neither splits); the f32 form takes
// halves 2, splits 1 and no ``part``.  Two to four launches on
// ``stream``; returns the first nonzero cudaError_t (0 = success).
extern "C" int dtx_grouped_ffn_fwd(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* h1, void* out,
                                   void* z1, void* part, int E, int C, int d,
                                   int ff, int act, int dtype, int halves1,
                                   int splits1, int halves2, int splits2,
                                   void* stream) {
  using namespace dtx;
  const int plan[4] = {halves1, splits1, halves2, splits2};
  const int depth[2] = {d, ff};   // K of launch 1, launch 2
  if (E < 0 || C < 0 || d < 1 || ff < 1 || act < 0 || act > kSigmoid ||
      (C + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 2; ++i) {
    const int halves = plan[2 * i], splits = plan[2 * i + 1];
    if ((halves != 1 && halves != 2) || splits < 1 ||
        splits > (depth[i] + kTcBK - 1) / kTcBK ||
        (long long)E * splits > 65535 || (splits > 1 && part == nullptr) ||
        (dtype == kFloat32 && (halves != 2 || splits != 1)))
      return (int)cudaErrorInvalidValue;
  }
  if (E == 0 || C == 0) return (int)cudaSuccess;
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  float* outf = static_cast<float*>(out);
  float* z1f = static_cast<float*>(z1);
  float* partf = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)grouped_ffn_fma(
          static_cast<const float*>(x), static_cast<const float*>(w1), b1f,
          static_cast<const float*>(w2), b2f, static_cast<float*>(h1), outf,
          z1f, E, C, d, ff, act, st);
    case kBFloat16:
      return (int)(z1f != nullptr
                       ? grouped_ffn_tc<true>(x, w1, b1f, w2, b2f, h1, outf,
                                              z1f, partf, E, C, d, ff, act,
                                              plan, st)
                       : grouped_ffn_tc<false>(x, w1, b1f, w2, b2f, h1, outf,
                                               nullptr, partf, E, C, d, ff,
                                               act, plan, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
