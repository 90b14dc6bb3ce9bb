// Flash attention: the forward (normalized output, or the raw softmax
// statistics the backward keeps), the dq backward and the dk/dv backward.
//
// Replaces the TPU kernels in distributed_tensorflow_example_tpu/ops/
// flash_attention.py:
//   flash_fwd_kernel  <- _make_kernel      (call in _flash_call)
//   flash_dq_kernel   <- _make_dq_kernel   (first call in _flash_backward_flat)
//   flash_dkv_kernel  <- _make_dkv_kernel  (second call there)
//
// What they compute, per (batch, head) over q, k, v [B, S, H, D] of one
// dtype T (f32 or bf16; T is also the compute dtype, as in the JAX
// package; this file's kernels take f32, flash_attention_tc.cu's bf16):
//   q2 = round_T(q * log2(e)/sqrt(D))              (prescaled once)
//   s  = q2 . k^T   in f32, log2 domain; causal: s = -1e30 where key > query
//   forward, online over key tiles: m = running max, p = exp2(s - m),
//     l = l*alpha + sum(p), acc = acc*alpha + round_T(p) . v,
//     alpha = exp2(m_old - m);
//     normalized: o = round_T(acc / max(l, 1e-30));
//     stats:      acc (f32), m * ln(2) (natural log), l;
//   dq:  p = exp2(s - m*log2(e)) / max(l, 1e-30), dp = do . v^T,
//        ds = p * (dp - dlt), dq = sum round_T(ds) . k  * (1/sqrt(D));
//   dkv: dv = sum round_T(p)^T . do,  dk = sum round_T(ds)^T . q2 * (1/log2(e)).
// m, l and dlt (= rowsum(do * o), computed by the caller) are [B, S, H]
// f32.  These are the JAX kernels' rounding points.
//
// What bounds them on an H100: operations.  At the path's shape (B*H =
// 64, S = 8192, D = 128, causal) the forward is 1.1e12 flops, dq 1.65e12
// and dk/dv 2.2e12 per call, against 3 x 134 MB of bf16 inputs: far
// above the card's ~295 operations per byte.
//
// Which kernel runs: the C entry points below route every bf16 call
// (the forward in both forms, dq and dk/dv) to flash_attention_tc.cu,
// which runs every product on the tensor cores.  This file keeps the
// f32 kernels of all three.  f32 stays on the
// CUDA cores on purpose: the tensor cores take f32 only as TF32, which
// keeps about three digits, against the 1e-4 of scale that f32
// attention is held to (tests/test_torch_cuda.py, chip_smoke.py) and
// the JAX package's f32 products.
//
// The design of the kernels here: the TPU kernels walk a sequential grid
// whose innermost dimension carries the running statistics in VMEM
// scratch over 1024-wide tiles.  Here the loop over the streamed tiles
// runs inside one CTA of 256 threads, over 64-row tiles staged in shared
// memory (116-167 KB, so one CTA per SM).
// Each thread owns a 4 x 4 block of the 64 x 64 score tile (rows ty +
// 16i, columns tx + 16j: 16-byte shared loads along the head dim,
// conflict-free), so a row's max and sum are 16-lane shuffles, and a 4 x
// 8 block of the 64 x 128 output (columns 4tx.. and 64 + 4tx..).  The
// score tile goes through shared memory once for the p . v (or ds . k)
// product.  Causal: key tiles above the diagonal are never
// visited (forward and dq stop at the diagonal tile, dk/dv start at it);
// only the diagonal tile and the ragged last tile mask.  Key tile 0
// comes first, so every row's running max is finite before a fully
// masked row could appear (the JAX module docstring's ordering
// argument).  Rows and keys past S are guarded (zero in shared memory,
// masked out of the softmax, never stored), so any S runs without
// padding.  Arithmetic is f32 FMA on the CUDA cores, tile loads are
// synchronous.
#include "common.cuh"

namespace dtx {
namespace {

constexpr int kFlashThreads = 256;
constexpr int kTile = 64;            // rows of a q tile and of a key tile
constexpr int kMaxD = 128;           // head dims up to this
constexpr int kLd = kMaxD + 4;       // shared row stride of a [64, D] tile
constexpr int kPLd = kTile + 4;      // shared row stride of a [64, 64] tile
constexpr float kNegInf = -1e30f;    // ops/ring_attention.NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kTiny = 1e-30f;

constexpr size_t kFwdSmem = (3 * kTile * kLd + kTile * kPLd) * sizeof(float);
constexpr size_t kDqSmem = (4 * kTile * kLd + kTile * kPLd) * sizeof(float);
constexpr size_t kDkvSmem =
    (4 * kTile * kLd + 2 * kTile * kPLd + 3 * kTile) * sizeof(float);

// rows [row0, row0 + 64) of head (b, h) of a [B, S, H, D] f32 tensor
// into dst [64][kLd]; with kPrescale each value is multiplied by ``mul``
// (the JAX _prescale, whose rounding to f32 is the product's own).  Rows
// >= S and columns >= D are zero.  All loads are issued before the
// stores.
template <bool kPrescale>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int b, int h, int row0, int S,
                                          int H, int D, float mul) {
  constexpr int kPer = kTile * kMaxD / kFlashThreads;  // 32
  float reg[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int idx = threadIdx.x + t * kFlashThreads;
    const int r = idx / kMaxD;
    const int c = idx % kMaxD;
    const int row = row0 + r;
    float v = 0.f;
    if (row < S && c < D) {
      v = src[(((size_t)b * S + row) * H + h) * (size_t)D + c];
      if (kPrescale) v *= mul;
    }
    reg[t] = v;
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int idx = threadIdx.x + t * kFlashThreads;
    dst[(idx / kMaxD) * kLd + idx % kMaxD] = reg[t];
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// s[i][j] = sum_d A[ra + 16i][d] * B[rb + 16j][d] over d < dpad
// (A rows broadcast within a 16-lane group, B rows conflict-free)
__device__ __forceinline__ void tile_scores(const float* __restrict__ A,
                                            const float* __restrict__ Bm,
                                            int ra, int rb, int dpad,
                                            float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < dpad; d += 4) {
    float4 a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(&A[(ra + 16 * i) * kLd + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(&Bm[(rb + 16 * j) * kLd + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum_k W[ra + 16i][k] * M[k][col(c)] over the 64 k of a
// [64][kPLd] tile W and a [64][kLd] tile M; col(c) = 4tx + c for c < 4,
// 64 + 4tx + c - 4 otherwise.
__device__ __forceinline__ void tile_accumulate(const float* __restrict__ W,
                                                const float* __restrict__ M,
                                                int ra, int tx,
                                                float acc[4][8]) {
  for (int k = 0; k < kTile; k += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = ld4(&W[(ra + 16 * i) * kPLd + k]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 lo = ld4(&M[(k + u) * kLd + 4 * tx]);
      const float4 hi = ld4(&M[(k + u) * kLd + 64 + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = comp(w[i], u);
        acc[i][0] = fmaf(p, lo.x, acc[i][0]);
        acc[i][1] = fmaf(p, lo.y, acc[i][1]);
        acc[i][2] = fmaf(p, lo.z, acc[i][2]);
        acc[i][3] = fmaf(p, lo.w, acc[i][3]);
        acc[i][4] = fmaf(p, hi.x, acc[i][4]);
        acc[i][5] = fmaf(p, hi.y, acc[i][5]);
        acc[i][6] = fmaf(p, hi.z, acc[i][6]);
        acc[i][7] = fmaf(p, hi.w, acc[i][7]);
      }
    }
  }
}

__device__ __forceinline__ int out_col(int tx, int c) {
  return c < 4 ? 4 * tx + c : 64 + 4 * tx + (c - 4);
}

// max / sum over the 16 lanes that share a row (lanes differing in the
// low four bits of the lane id)
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// forward (f32): grid (q tiles, B*H); heavier causal tiles are scheduled
// first
// ---------------------------------------------------------------------------
template <bool kCausal, bool kStats>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int S, int H, int D,
                     float qscale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* Ps = Vs + kTile * kLd;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  const int dpad = (D + 3) & ~3;
  const int n_kt = (S + kTile - 1) / kTile;
  const int last = kCausal ? qt : n_kt - 1;

  load_tile<true>(Qs, q, b, h, q0, S, H, D, qscale);
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last iteration is done with Ks, Vs and Ps
    load_tile<false>(Ks, k, b, h, k0, S, H, D, 1.f);
    load_tile<false>(Vs, v, b, h, k0, S, H, D, 1.f);
    __syncthreads();
    float s[4][4];
    tile_scores(Qs, Ks, ty, tx, dpad, s);
    if ((kCausal && kt == qt) || k0 + kTile > S) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = k0 + tx + 16 * j;
          const int qp = q0 + ty + 16 * i;
          if (kp >= S || (kCausal && kp > qp)) s[i][j] = kNegInf;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = exp2f(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        ps += p;
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_accumulate(Ps, Vs, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const size_t base = ((size_t)b * S + row) * H + h;
    if (kStats) {
      if (tx == 0) {
        m_out[base] = m[i] * kLn2;
        l_out[base] = l[i];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = out_col(tx, c);
        if (col < D) acc_out[base * D + col] = acc[i][c];
      }
    } else {
      const float den = fmaxf(l[i], kTiny);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = out_col(tx, c);
        if (col < D) o[base * D + col] = acc[i][c] / den;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq (f32): grid (q tiles, B*H); streams key tiles 0..(causal frontier)
// ---------------------------------------------------------------------------
template <bool kCausal>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ dlt_in, float* __restrict__ dq,
                    int S, int H, int D, float qscale, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * kLd;
  float* Ks = dOs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* Ds = Vs + kTile * kLd;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  const int dpad = (D + 3) & ~3;
  const int n_kt = (S + kTile - 1) / kTile;
  const int last = kCausal ? qt : n_kt - 1;

  load_tile<true>(Qs, q, b, h, q0, S, H, D, qscale);
  load_tile<false>(dOs, dout, b, h, q0, S, H, D, 1.f);
  float mlog2[4], lden[4], dl[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t base = ((size_t)b * S + row) * H + h;
    mlog2[i] = row < S ? m_in[base] * kLog2e : 0.f;
    lden[i] = row < S ? fmaxf(l_in[base], kTiny) : 1.f;
    dl[i] = row < S ? dlt_in[base] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<false>(Ks, k, b, h, k0, S, H, D, 1.f);
    load_tile<false>(Vs, v, b, h, k0, S, H, D, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_scores(Qs, Ks, ty, tx, dpad, s);
    tile_scores(dOs, Vs, ty, tx, dpad, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const int qp = q0 + ty + 16 * i;
        const bool masked = qp >= S || kp >= S || (kCausal && kp > qp);
        const float p = masked ? 0.f : exp2f(s[i][j] - mlog2[i]) / lden[i];
        const float ds = p * (dp[i][j] - dl[i]);
        Ds[(ty + 16 * i) * kPLd + tx + 16 * j] = ds;
      }
    __syncthreads();
    tile_accumulate(Ds, Ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const size_t base = ((size_t)b * S + row) * H + h;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = out_col(tx, c);
      if (col < D) dq[base * D + col] = acc[i][c] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dk/dv: grid (key tiles, B*H); streams q tiles from the first that sees
// this key tile (the diagonal one under causal) to the end
// ---------------------------------------------------------------------------
template <bool kCausal>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ dlt_in,
                     float* __restrict__ dk, float* __restrict__ dv, int S,
                     int H, int D, float qscale, float inv_log2e) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * kLd;
  float* Qs = Vs + kTile * kLd;
  float* dOs = Qs + kTile * kLd;
  float* Ps = dOs + kTile * kLd;
  float* Ds = Ps + kTile * kPLd;
  float* mls = Ds + kTile * kPLd;   // m * log2(e) of the q tile's rows
  float* lds = mls + kTile;         // max(l, 1e-30)
  float* dls = lds + kTile;         // dlt
  const int kt = blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int k0 = kt * kTile;
  const int dpad = (D + 3) & ~3;
  const int n_qt = (S + kTile - 1) / kTile;

  load_tile<false>(Ks, k, b, h, k0, S, H, D, 1.f);
  load_tile<false>(Vs, v, b, h, k0, S, H, D, 1.f);
  float dka[4][8], dva[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int qt = kCausal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<true>(Qs, q, b, h, q0, S, H, D, qscale);
    load_tile<false>(dOs, dout, b, h, q0, S, H, D, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const size_t base = ((size_t)b * S + row) * H + h;
      mls[threadIdx.x] = row < S ? m_in[base] * kLog2e : 0.f;
      lds[threadIdx.x] = row < S ? fmaxf(l_in[base], kTiny) : 1.f;
      dls[threadIdx.x] = row < S ? dlt_in[base] : 0.f;
    }
    __syncthreads();
    // transposed tiles: rows are this CTA's keys, columns the q rows
    float s[4][4], dp[4][4];
    tile_scores(Ks, Qs, ty, tx, dpad, s);
    tile_scores(Vs, dOs, ty, tx, dpad, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + ty + 16 * i;
        const int qc = tx + 16 * j;
        const int qp = q0 + qc;
        const bool masked = qp >= S || kp >= S || (kCausal && kp > qp);
        const float p = masked ? 0.f : exp2f(s[i][j] - mls[qc]) / lds[qc];
        const float ds = p * (dp[i][j] - dls[qc]);
        Ps[(ty + 16 * i) * kPLd + qc] = p;
        Ds[(ty + 16 * i) * kPLd + qc] = ds;
      }
    __syncthreads();
    tile_accumulate(Ps, dOs, ty, tx, dva);
    tile_accumulate(Ds, Qs, ty, tx, dka);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
    const size_t base = ((size_t)b * S + row) * H + h;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = out_col(tx, c);
      if (col < D) {
        dk[base * D + col] = dka[i][c] * inv_log2e;
        dv[base * D + col] = dva[i][c];
      }
    }
  }
}

bool check_geom(int B, int S, int H, int D) {
  return B >= 1 && S >= 1 && H >= 1 && D >= 1 && D <= kMaxD &&
         (long long)B * H <= 65535;
}

template <bool kCausal, bool kStats>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* acc, void* m, void* l, int B, int S, int H, int D,
                float qscale, cudaStream_t st) {
  static bool ready = false;
  auto kernel = flash_fwd_kernel<kCausal, kStats>;
  cudaError_t err = allow_smem(kernel, kFwdSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kFlashThreads, kFwdSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), S, H, D, qscale);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* m, const void* l,
                   const void* dlt, void* dq, int B, int S, int H, int D,
                   float qscale, float scale, cudaStream_t st) {
  static bool ready = false;
  auto kernel = flash_dq_kernel<kCausal>;
  cudaError_t err = allow_smem(kernel, kDqSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kFlashThreads, kDqSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dlt), static_cast<float*>(dq), S, H, D,
      qscale, scale);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* m, const void* l,
                    const void* dlt, void* dk, void* dv, int B, int S, int H,
                    int D, float qscale, float inv_log2e, cudaStream_t st) {
  static bool ready = false;
  auto kernel = flash_dkv_kernel<kCausal>;
  cudaError_t err = allow_smem(kernel, kDkvSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kFlashThreads, kDkvSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dlt), static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, D, qscale, inv_log2e);
  return cudaGetLastError();
}

}  // namespace

// bf16 forward, dq and dk/dv on the tensor cores (flash_attention_tc.cu)
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           void* o, void* acc, void* m, void* l, int B,
                           int S, int H, int D, bool causal, bool stats,
                           float qscale, cudaStream_t st);
cudaError_t flash_dq_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const void* m, const void* l,
                          const void* dlt, void* dq, int B, int S, int H,
                          int D, bool causal, float qscale, float scale,
                          cudaStream_t st);
cudaError_t flash_dkv_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* m, const void* l,
                           const void* dlt, void* dk, void* dv, int B, int S,
                           int H, int D, bool causal, float qscale,
                           float inv_log2e, cudaStream_t st);
}  // namespace dtx

// C interface (ctypes).  q, k, v, o, do: [B, S, H, D] contiguous of
// ``dtype`` (0 f32, 1 bf16); acc, dq, dk, dv: [B, S, H, D] f32; m, l,
// dlt: [B, S, H] f32.  ``qscale`` = f32(log2(e) / sqrt(D)), ``scale`` =
// f32(1 / sqrt(D)), ``inv_log2e`` = f32(1 / log2(e)), as the JAX package
// rounds them.  Each returns the cudaError_t of its launch (0 = success).
extern "C" int dtx_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* acc, void* m, void* l, int B,
                             int S, int H, int D, int causal, int stats,
                             int dtype, float qscale, void* stream) {
  using namespace dtx;
  if (!check_geom(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)flash_fwd_bf16(q, k, v, o, acc, m, l, B, S, H, D, causal,
                               stats, qscale, st);
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  switch ((causal ? 1 : 0) | (stats ? 2 : 0)) {
    case 0: return (int)fwd<false, false>(q, k, v, o, acc, m, l, B, S, H, D,
                                          qscale, st);
    case 1: return (int)fwd<true, false>(q, k, v, o, acc, m, l, B, S, H, D,
                                         qscale, st);
    case 2: return (int)fwd<false, true>(q, k, v, o, acc, m, l, B, S, H, D,
                                         qscale, st);
    default: return (int)fwd<true, true>(q, k, v, o, acc, m, l, B, S, H, D,
                                         qscale, st);
  }
}

extern "C" int dtx_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* m,
                                const void* l, const void* dlt, void* dq,
                                int B, int S, int H, int D, int causal,
                                int dtype, float qscale, float scale,
                                void* stream) {
  using namespace dtx;
  if (!check_geom(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return causal ? (int)bwd_dq<true>(q, k, v, dout, m, l, dlt, dq, B, S,
                                        H, D, qscale, scale, st)
                    : (int)bwd_dq<false>(q, k, v, dout, m, l, dlt, dq, B, S,
                                         H, D, qscale, scale, st);
    case kBFloat16:
      return (int)flash_dq_bf16(q, k, v, dout, m, l, dlt, dq, B, S, H, D,
                                causal, qscale, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dtx_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* m, const void* l,
                                 const void* dlt, void* dk, void* dv, int B,
                                 int S, int H, int D, int causal, int dtype,
                                 float qscale, float inv_log2e,
                                 void* stream) {
  using namespace dtx;
  if (!check_geom(B, S, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return causal ? (int)bwd_dkv<true>(q, k, v, dout, m, l, dlt, dk, dv,
                                         B, S, H, D, qscale, inv_log2e, st)
                    : (int)bwd_dkv<false>(q, k, v, dout, m, l, dlt, dk, dv,
                                          B, S, H, D, qscale, inv_log2e,
                                          st);
    case kBFloat16:
      return (int)flash_dkv_bf16(q, k, v, dout, m, l, dlt, dk, dv, B, S, H,
                                 D, causal, qscale, inv_log2e, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dtx_flash_max_d() { return dtx::kMaxD; }
