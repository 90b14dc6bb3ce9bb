// Fused LayerNorm forward, and LayerNorm fused with the residual add
// that feeds it.
//
// Replaces the TPU kernels in distributed_tensorflow_example_tpu/ops/
// pallas_fused.py: _ln_fwd_kernel (launched by _ln_run_fwd, public
// name fused_layer_norm) and _ln_res_fwd_kernel (public name
// fused_layer_norm_residual).
//
// What it computes, per row of [rows, d]:
//   y = (x - mean) * rsqrt(var + 1e-6) * g + b    (f32 statistics, f32 y)
// and, in the residual form, s = x + r first, rounded to s's dtype and
// written out, with the statistics taken from the ROUNDED s (the JAX
// kernel's convention, so the fused and unfused paths agree).
//
// What bounds it on an H100: bytes.  Per element it reads x (and r)
// and writes y (and s) once for ~10 flops; at d=1024 a row is 4 KB of
// f32, and the card's 3.35 TB/s is the limit, or, at the decode shape
// (8 rows), the launch itself.
//
// The design: the TPU kernel tiles 128 rows into VMEM.  Here one CTA
// of 256 threads owns one row: the row is read from device memory
// once (coalesced, neighbouring threads on neighbouring elements),
// kept in shared memory as f32 (4 KB at d=1024), and the two-pass
// mean/variance runs over that copy with warp-shuffle reductions, so
// the variance is the exact two-pass form of the reference rather
// than E[x^2]-E[x]^2.  y is written once.  Rows are independent, so
// nothing carries between CTAs.
#include "common.cuh"

namespace dtx {
namespace {

constexpr int kLnThreads = 256;
constexpr float kLnEps = 1e-6f;
// the row copy is dynamic shared memory under the 48 KB a launch gets
// without an opt-in, beside the kernel's static 32-float reduction
// buffer: d <= (48 KB - 128 B) / 4
constexpr int kLnMaxD = (48 * 1024 - 32 * (int)sizeof(float)) /
                        (int)sizeof(float);

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kLnThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ g, const float* __restrict__ b,
                  float* __restrict__ y, T* __restrict__ s, int d) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * (size_t)d;
  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float v = to_f32(x[base + i]);
    if (kResidual) {
      const T sv = from_f32<T>(v + to_f32(r[base + i]));
      s[base + i] = sv;
      v = to_f32(sv);
    }
    row[i] = v;
    acc += v;
  }
  const float mu = block_sum(acc, red) / (float)d;
  acc = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = row[i] - mu;
    acc += c * c;
  }
  const float var = block_sum(acc, red) / (float)d;
  const float rstd = rsqrtf(var + kLnEps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    y[base + i] = (row[i] - mu) * rstd * g[i] + b[i];
  }
}

template <typename T, bool kResidual>
cudaError_t launch(const void* x, const void* r, const float* g,
                   const float* b, float* y, void* s, int rows, int d,
                   cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  ln_fwd_kernel<T, kResidual>
      <<<rows, kLnThreads, (size_t)d * sizeof(float), stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(r), g, b, y,
          static_cast<T*>(s), d);
  return cudaGetLastError();
}

template <bool kResidual>
int dispatch(const void* x, const void* r, const void* g, const void* b,
             void* y, void* s, int rows, int d, int dtype, void* stream) {
  if (rows < 0 || d < 1 || d > kLnMaxD) return (int)cudaErrorInvalidValue;
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch<float, kResidual>(x, r, gf, bf, yf, s, rows, d, st);
    case kBFloat16:
      return (int)launch<__nv_bfloat16, kResidual>(x, r, gf, bf, yf, s, rows,
                                                   d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dtx

// C interface (ctypes).  x/r/s: [rows, d] of ``dtype`` (0 f32, 1 bf16);
// g/b: [d] f32; y: [rows, d] f32.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int dtx_layer_norm_fwd(const void* x, const void* g,
                                  const void* b, void* y, int rows, int d,
                                  int dtype, void* stream) {
  return dtx::dispatch<false>(x, nullptr, g, b, y, nullptr, rows, d, dtype,
                              stream);
}

extern "C" int dtx_layer_norm_residual_fwd(const void* x, const void* r,
                                           const void* g, const void* b,
                                           void* y, void* s, int rows, int d,
                                           int dtype, void* stream) {
  return dtx::dispatch<true>(x, r, g, b, y, s, rows, d, dtype, stream);
}

extern "C" int dtx_layer_norm_max_d() { return dtx::kLnMaxD; }
