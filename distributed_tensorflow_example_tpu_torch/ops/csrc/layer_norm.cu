// Fused LayerNorm forward, LayerNorm fused with the residual add that
// feeds it, and the LayerNorm backward.
//
// Replaces the TPU kernels in distributed_tensorflow_example_tpu/ops/
// pallas_fused.py: _ln_fwd_kernel (launched by _ln_run_fwd, public
// name fused_layer_norm), _ln_res_fwd_kernel (public name
// fused_layer_norm_residual) and _ln_bwd_kernel (launched by
// _ln_run_bwd, the backward of both).
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
// The design: the TPU kernel tiles 128 rows into VMEM.  Here rows up to
// kLnRegMaxD = 1024 wide (every path's d_model) take the register path,
// ln_fwd_warp_kernel: one warp owns a row, each lane 32 of its values at
// d = 1024, read as 16-byte vectors of 4 f32 (8-byte vectors of 4 bf16),
// neighbouring lanes on neighbouring vectors; the row stays in registers
// and the mean and then the exact two-pass variance (not E[x^2]-E[x]^2)
// reduce by warp shuffles alone, so no shared memory and no block
// barrier lies on the path.  g and b are read once per warp and kept in
// registers across the rows it walks (row = warp, warp + W, ...), with a
// grid sized to the card's resident warps.  y is written once, as
// vectors.  Rows wider than that, or whose width is not a multiple of 4
// or whose tensors are not aligned to the vectors, take ln_fwd_kernel:
// one CTA of 256 threads a row, the row read once (coalesced) into
// shared memory as f32 (up to kLnMaxD = 12256 wide), the same two-pass
// statistics over that copy with block-wide reductions.  Rows are
// independent, so nothing carries between warps or CTAs.
//
// The backward, per row of the saved normalization input x (or the
// residual sum s) and the f32 cotangent dy:
//   mu, var recomputed in f32; rstd = rsqrt(var + 1e-6);
//   xh = (x - mu) * rstd; w = dy * g;
//   dx = rstd * (w - mean(w) - xh * mean(w * xh))     (f32 dx)
// plus dg = sum_rows dy * xh and db = sum_rows dy (the JAX _ln_bwd_rows
// math).  It is bound by bytes too: dy and x read once, dx written once
// (805 MB at 65,536 x 1024 f32, 0.24 ms at 3.35 TB/s).  The TPU kernel
// carries dg/db in one [1, d] block across its sequential grid; CTAs run
// in no order here, so each CTA walks a strip of rows (row = cta,
// cta + G, ...), keeps its own dg/db partial sums in shared memory
// (each column owned by one thread, so no atomics), and writes them to
// a [2, G, d] buffer; a second launch sums the G partials of each
// column in a fixed order, so dg/db are deterministic.
#include "common.cuh"

#include <cstdint>

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

// the register path: rows up to kLnRegMaxD wide, kLnVec values a lane
// per vector, kLnRegIters vectors a lane, kLnRegWarps rows in flight a CTA
constexpr int kLnVec = 4;
constexpr int kLnRegMaxD = 1024;
constexpr int kLnRegIters = kLnRegMaxD / (32 * kLnVec);
constexpr int kLnRegWarps = 8;

__device__ __forceinline__ void load_vec(const float* p, float v[kLnVec]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float v[kLnVec]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void store_vec(float* p, const float v[kLnVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float v[kLnVec]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one warp a row (d <= kLnRegMaxD, d % kLnVec == 0, every tensor aligned
// to its vector); lane l holds columns 4 (32 i + l) .. + 3 for i <
// kLnRegIters, those past d empty
template <typename T, bool kResidual>
__global__ void __launch_bounds__(kLnRegWarps * 32)
    ln_fwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const float* __restrict__ g,
                       const float* __restrict__ b, float* __restrict__ y,
                       T* __restrict__ s, int rows, int d) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kLnRegWarps;
  float gv[kLnRegIters][kLnVec], bv[kLnRegIters][kLnVec];
#pragma unroll
  for (int i = 0; i < kLnRegIters; ++i) {
    const int c = (32 * i + lane) * kLnVec;
    if (c < d) {
      load_vec(g + c, gv[i]);
      load_vec(b + c, bv[i]);
    }
  }
  for (int row = blockIdx.x * kLnRegWarps + (threadIdx.x >> 5); row < rows;
       row += warps) {
    const size_t base = (size_t)row * (size_t)d;
    float v[kLnRegIters][kLnVec];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kLnRegIters; ++i) {
      const int c = (32 * i + lane) * kLnVec;
      if (c >= d) continue;
      load_vec(x + base + c, v[i]);
      if (kResidual) {
        float rv[kLnVec];
        load_vec(r + base + c, rv);
        // s rounded to T; the statistics are taken from the rounded s
#pragma unroll
        for (int j = 0; j < kLnVec; ++j)
          v[i][j] = to_f32(from_f32<T>(v[i][j] + rv[j]));
        store_vec(s + base + c, v[i]);
      }
#pragma unroll
      for (int j = 0; j < kLnVec; ++j) acc += v[i][j];
    }
    const float mu = warp_sum(acc) / (float)d;
    acc = 0.f;
#pragma unroll
    for (int i = 0; i < kLnRegIters; ++i) {
      if ((32 * i + lane) * kLnVec >= d) continue;
#pragma unroll
      for (int j = 0; j < kLnVec; ++j) {
        const float c = v[i][j] - mu;
        acc += c * c;
      }
    }
    const float rstd = rsqrtf(warp_sum(acc) / (float)d + kLnEps);
#pragma unroll
    for (int i = 0; i < kLnRegIters; ++i) {
      const int c = (32 * i + lane) * kLnVec;
      if (c >= d) continue;
      float o[kLnVec];
#pragma unroll
      for (int j = 0; j < kLnVec; ++j)
        o[j] = (v[i][j] - mu) * rstd * gv[i][j] + bv[i][j];
      store_vec(y + base + c, o);
    }
  }
}

// whether every tensor of a launch lies on its vector's boundary
template <typename T>
bool vec_aligned(const void* x, const void* r, const float* g,
                 const float* b, const float* y, const void* s) {
  const uintptr_t t = sizeof(T) * kLnVec, f = sizeof(float) * kLnVec;
  auto at = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  return at(x) % t == 0 && at(r) % t == 0 && at(s) % t == 0 &&
         at(g) % f == 0 && at(b) % f == 0 && at(y) % f == 0;
}

template <typename T, bool kResidual>
cudaError_t launch(const void* x, const void* r, const float* g,
                   const float* b, float* y, void* s, int rows, int d,
                   cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  if (d <= kLnRegMaxD && d % kLnVec == 0 &&
      vec_aligned<T>(x, r, g, b, y, s)) {
    // the grid: every warp resident at once (blocks a CTA can keep on an
    // SM x the SMs), no more than the rows need
    static int resident = 0;
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ln_fwd_warp_kernel<T, kResidual>, kLnRegWarps * 32, 0);
      if (err != cudaSuccess) return err;
      resident = sms * per_sm;
    }
    const int need = (rows + kLnRegWarps - 1) / kLnRegWarps;
    const int grid = need < resident ? need : resident;
    ln_fwd_warp_kernel<T, kResidual><<<grid, kLnRegWarps * 32, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(r), g, b, y,
            static_cast<T*>(s), rows, d);
    return cudaGetLastError();
  }
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

// CTAs of the backward: about eight per SM of an H100, each walking
// rows/G rows; G = min(rows, kLnBwdCtas) is the wrapper's choice
constexpr int kLnBwdCtas = 132 * 8;
// x row, dy row and the two partial-sum rows: 4d floats, an opt-in above
// 48 KB of dynamic shared memory (d <= kLnMaxD keeps it under 227 KB)
constexpr size_t kLnBwdMaxSmem = 4 * (size_t)kLnMaxD * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    ln_bwd_kernel(const float* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ g, float* __restrict__ dx,
                  float* __restrict__ part, int rows, int d) {
  extern __shared__ float buf[];
  __shared__ float red[32];
  float* xs = buf;           // the row of x, f32
  float* dys = buf + d;      // the row of dy
  float* ag = buf + 2 * d;   // this CTA's sum of dy * xh per column
  float* ab = buf + 3 * d;   // this CTA's sum of dy per column
  // every column is read and written by one thread only (i = tid +
  // k * blockDim), so the row buffers need no barrier of their own
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    ag[i] = 0.f;
    ab[i] = 0.f;
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = (size_t)row * (size_t)d;
    float acc = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float v = to_f32(x[base + i]);
      xs[i] = v;
      acc += v;
    }
    const float mu = block_sum(acc, red) / (float)d;
    acc = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float c = xs[i] - mu;
      acc += c * c;
    }
    const float rstd = rsqrtf(block_sum(acc, red) / (float)d + kLnEps);
    float sw = 0.f, swx = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float dyv = dy[base + i];
      dys[i] = dyv;
      const float w = dyv * g[i];
      sw += w;
      swx += w * ((xs[i] - mu) * rstd);
    }
    const float mw = block_sum(sw, red) / (float)d;
    const float mwx = block_sum(swx, red) / (float)d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float xh = (xs[i] - mu) * rstd;
      const float dyv = dys[i];
      const float w = dyv * g[i];
      dx[base + i] = rstd * ((w - mw) - xh * mwx);
      ag[i] += dyv * xh;
      ab[i] += dyv;
    }
  }
  const size_t G = gridDim.x;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    part[(size_t)blockIdx.x * d + i] = ag[i];
    part[(G + blockIdx.x) * (size_t)d + i] = ab[i];
  }
}

// dg[c] = sum over the G partials of column c, in CTA order (then db)
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ dg,
                                     float* __restrict__ db, int G, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * d) return;
  const int which = i / d;
  const int col = i % d;
  const float* p = part + (size_t)which * G * d + col;
  float s = 0.f;
  for (int r = 0; r < G; ++r) s += p[(size_t)r * d];
  (which == 0 ? dg : db)[col] = s;
}

template <typename T>
cudaError_t launch_bwd(const float* dy, const void* x, const float* g,
                       float* dx, float* part, float* dg, float* db,
                       int rows, int d, int ctas, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kLnBwdMaxSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  ln_bwd_kernel<T><<<ctas, kLnThreads, 4 * (size_t)d * sizeof(float),
                     stream>>>(dy, static_cast<const T*>(x), g, dx, part,
                               rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_reduce_kernel<<<(2 * d + kLnThreads - 1) / kLnThreads, kLnThreads,
                         0, stream>>>(part, dg, db, ctas, d);
  return cudaGetLastError();
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

// the widest row the forwards' register path (ln_fwd_warp_kernel) takes
extern "C" int dtx_layer_norm_reg_max_d() { return dtx::kLnRegMaxD; }

// dy: [rows, d] f32; x: [rows, d] of ``dtype`` (the forward's input, or
// its residual sum s); g: [d] f32; dx: [rows, d] f32; part: [2, ctas, d]
// f32 scratch; dg, db: [d] f32.  1 <= ctas <= min(rows,
// dtx_layer_norm_bwd_max_ctas()).  Two launches; returns the cudaError_t
// of the first that fails (0 = success).
extern "C" int dtx_layer_norm_bwd(const void* dy, const void* x,
                                  const void* g, void* dx, void* part,
                                  void* dg, void* db, int rows, int d,
                                  int ctas, int dtype, void* stream) {
  using namespace dtx;
  if (rows < 1 || d < 1 || d > kLnMaxD || ctas < 1 || ctas > rows ||
      ctas > kLnBwdCtas)
    return (int)cudaErrorInvalidValue;
  const float* dyf = static_cast<const float*>(dy);
  const float* gf = static_cast<const float*>(g);
  float* dxf = static_cast<float*>(dx);
  float* pf = static_cast<float*>(part);
  float* dgf = static_cast<float*>(dg);
  float* dbf = static_cast<float*>(db);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_bwd<float>(dyf, x, gf, dxf, pf, dgf, dbf, rows, d,
                                    ctas, st);
    case kBFloat16:
      return (int)launch_bwd<__nv_bfloat16>(dyf, x, gf, dxf, pf, dgf, dbf,
                                            rows, d, ctas, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dtx_layer_norm_bwd_max_ctas() { return dtx::kLnBwdCtas; }
