// Flash attention in bf16 on Hopper's tensor cores: the forward
// (normalized output, or the raw softmax statistics the backward keeps),
// the dq backward and the dk/dv backward.  ``dtx_flash_fwd``,
// ``dtx_flash_bwd_dq`` and ``dtx_flash_bwd_dkv`` (flash_attention.cu)
// route bf16 here; f32 stays on that file's CUDA-core kernels.
//
// Replaces the TPU kernels in distributed_tensorflow_example_tpu/ops/
// flash_attention.py:
//   flash_fwd_tc_kernel  <- _make_kernel      (call in _flash_call)
//   flash_dq_tc_kernel   <- _make_dq_kernel   (first call in
//                                              _flash_backward_flat)
//   flash_dkv_tc_kernel  <- _make_dkv_kernel  (second call there)
// with the rounding points and constants of those kernels (see the note
// at the head of flash_attention.cu): q2 = round_bf16(q * f32(log2(e) /
// sqrt(D))) once, when the q tile lands; s = q2 . k^T in f32, log2
// domain; masked scores -1e30; m the running max, alpha = exp2(m_old -
// m_new), p = exp2(s - m_new), l = l * alpha + sum of the unrounded p,
// acc = acc * alpha + round_bf16(p) . v; normalized o = round_bf16(acc /
// max(l, 1e-30)), stats acc (f32), m * ln(2), l; dq recomputes p =
// exp2(s - m * log2(e)) / max(l, 1e-30), ds = p * (dp - dlt) with dp =
// do . v^T, and dq = sum round_bf16(ds) . k, times f32(1/sqrt(D));
// dk/dv recompute p and ds the same way on the transposed tile (keys x
// q rows) and store, f32, dv = sum round_bf16(p)^T . do and dk = sum
// round_bf16(ds)^T . q2 times f32(1/log2(e)).
//
// What bounds them on an H100: operations.  At the training path's
// [8, 8192, 8, 128] causal the forward is 1.1e12 flops, dq 1.65e12 and
// dk/dv 2.2e12 against at most 0.6 GB of inputs and outputs, far above
// the card's ~295 bf16 operations per byte; only the tensor cores come
// near that rate.  The CUDA-core kernels they replace ran at 9, 12 and
// 17 TFLOP/s on an H100: scalar f32 FMA at two FMAs per float read from
// shared memory, tiles widened to f32 (one CTA per SM), synchronous tile
// loads, and the score tile sent through shared memory for the second
// product.
//
// The design of the forward and dq (FlashAttention-3's products and
// overlap, without its TMA producer warps):
//   * a CTA of two warpgroups (8 warps) owns a 128-row q tile, each
//     warpgroup 64 rows, and streams 64-key tiles: grid (q tiles, B*H),
//     the heaviest causal q tiles first (qt = gridDim.x - 1 -
//     blockIdx.x);
//   * every product is a warpgroup MMA, wgmma m64nNk16 bf16 -> f32:
//     s = q2 . k^T and dp = do . v^T (n 64) read K and V from shared
//     memory as they lie (k-major); p . v and ds . k (n 128) reduce over
//     keys and read V and K through the descriptor's transpose (MN-
//     major).  The forward keeps q2 in registers as the A operand (the
//     warp's fragments, 32 registers); dq reads Q and dO from shared
//     memory;
//   * p (and ds) never leave registers: the f32 accumulator of s is
//     rounded to bf16 and is the A operand of the next product, the JAX
//     kernels' round_T(p) / round_T(ds) point;
//   * tiles stay bf16 in shared memory in the no-swizzle core-matrix
//     layout (tc.cuh) that the descriptors read and the 16-byte cp.async
//     copies fill without bank conflicts.  K and V stream through a ring
//     of four stages, two tiles ahead (KvRing): 128 KB for the forward
//     (q2 passes through the last stage into registers first), 192 KB
//     with dq's resident Q and dO; one CTA per SM;
//   * the products are asynchronous: the next key tile's s (and dp) run
//     on the tensor cores under this tile's exp2 (and ds), and this
//     tile's p . v (ds . k) under the next tile's row max.  No product is
//     in flight while acc is rescaled, so ptxas keeps the wgmma pipeline
//     (its -Xptxas -v report names any it must serialize);
//   * a row's max and sum are two shuffles within the quad of lanes
//     that holds it in the accumulator layout;
//   * exp2 is one ex2.approx each, and dq's division by max(l, 1e-30)
//     is correctly rounded from the row's reciprocal with two FMAs:
//     exp2f's and the division's longer full-precision sequences were
//     the largest cost of dq's elementwise work;
//   * causal: key tiles above the diagonal are never visited, and a
//     warpgroup stops at the key tile holding its last row; only tiles
//     that cross the diagonal or S mask (and, for dq, a ragged last q
//     tile); key tile 0 comes first, so every row's running max is
//     finite before a fully masked row could appear;
//   * rows and keys past S are zero-filled in shared memory, masked
//     and never stored, so any S runs without padding; any D <= 128 is
//     zero-padded to 128 in shared memory and every product runs its 8
//     steps of 16 over it (a loop bound known to the compiler; a bound
//     tested at each step made ptxas serialize the products): D a
//     multiple of 8 (and 16-byte aligned tensors) takes the asynchronous
//     copies, any other D guarded scalar loads, on the same tensor
//     cores.
// dk/dv (FlashAttention-2/3's backward, without TMA):
//   * a CTA of two warpgroups owns a 128-key tile, each warpgroup 64
//     keys; K and V stay resident in shared memory (64 KB) and the
//     64-row q tiles, from the first that sees the key tile (causal) to
//     the end, stream through a ring of four (Q, dO, m, l, dlt) stages
//     two tiles ahead (196 KB in all, one CTA per SM): grid (key tiles,
//     B*H), key tile 0, the heaviest under causal, first;
//   * the products: s^T = k . q2^T and dp^T = v . do^T (n 64) read K, V,
//     Q and dO k-major; dv += round(p)^T . do and dk += round(ds)^T . q2
//     (n 128) take p^T and ds^T from registers (their accumulator rows
//     are already keys) and read dO and Q MN-major.  dk and dv (64 + 64
//     f32 a thread) stay in registers over the whole stream;
//   * m, l and dlt belong to the tile's columns (q rows): each stage
//     holds them in shared memory (4-byte cp.async), and each thread
//     reads the columns 8j + 2t, +1 it holds;
//   * q2 = round_bf16(q * qscale) is made in place when a q tile has
//     landed, one pass over the stage a tile ahead of its use, with m *
//     log2(e), max(l, 1e-30) and its reciprocal;
//   * dk and dv of one tile run on the tensor cores under the next
//     tile's ring barrier and are retired with its s^T and dp^T;
//   * masking as above, on the transposed tile: keys past their q row
//     (causal), and q rows or keys past S, give p = 0 and ds = 0; only
//     tiles that cross the diagonal or S test anything.
// Registers and spills of each instantiation (-Xptxas -v) are printed
// by chip_smoke.py and kept in PERF.md.  TMA loads from producer warps,
// in place of every thread's cp.async and a CTA barrier per key tile,
// are the next step (ROADMAP.md).
#include "common.cuh"
#include "tc.cuh"

#include <initializer_list>

namespace dtx {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroups = 2;          // of a CTA, 64 q rows each
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBq = 64 * kWarpgroups;   // rows of a q tile
constexpr int kTile = 64;               // rows of a key tile
constexpr int kTileElems = kTile * tc::kTileCols;   // 16 KB
constexpr int kStages = 4;              // of the (K, V) ring
constexpr float kNegInf = -1e30f;       // ops/ring_attention.NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kTiny = 1e-30f;

constexpr size_t kRingSmem = kStages * 2 * kTileElems * sizeof(bf16);
static_assert(kBq <= 2 * kTile, "the forward's q tile passes a stage");
constexpr size_t kFwdSmem = kRingSmem;
constexpr size_t kDqSmem = kRingSmem + 2 * kBq * tc::kTileCols * sizeof(bf16);

// 2^x on the special-function unit (ex2.approx, the instruction behind
// exp2f); results below 2^-126 flush to 0 where exp2f would keep a
// subnormal, a difference of under 1e-38 against the p = 1 of a row's max
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x / l correctly rounded, as the division is, given rl = 1/l correctly
// rounded (Markstein: one product and two FMAs in place of the division's
// longer sequence)
__device__ __forceinline__ float div_rn(float x, float l, float rl) {
  const float q = x * rl;
  return fmaf(fmaf(-q, l, x), rl, q);
}

// descriptors of the core-matrix tiles (tc.cuh): step ks of the head dim
// of a [rows][d] tile read k-major (rows are the product's M or N), and
// keys 16kk.. of a [keys][d] tile read MN-major (keys reduced)
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int ks) {
  return tc::gmma_desc(tile + tc::il_off(0, 2 * ks), 128, tc::kIlGroup);
}

__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return tc::gmma_desc(tile + tc::il_off(16 * kk, 0), tc::kIlGroup, 128);
}

// the geometry one CTA works on: q tile qt of head (b, h)
template <bool kCausal>
struct Geom {
  int qt, q0, row0, wg0, lane, last, last_wg, b, h;
  size_t ld, head;

  __device__ __forceinline__ Geom(int S, int H, int D) {
    qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal q tiles first
    b = blockIdx.y / H;
    h = blockIdx.y % H;
    q0 = qt * kBq;
    row0 = (threadIdx.x >> 5) * 16;    // the warp's rows
    wg0 = (threadIdx.x >> 7) * 64;     // the warpgroup's rows
    lane = threadIdx.x & 31;
    // causal: up to the key tile holding the q tile's (the warpgroup's)
    // last row
    last = (kCausal ? min(q0 + kBq, S) - 1 : S - 1) / kTile;
    last_wg = kCausal ? min(last, (q0 + wg0 + 63) / kTile) : last;
    ld = (size_t)H * D;                // between rows of one head
    head = (size_t)b * S * ld + (size_t)h * D;
  }
};

// The ring of (K, V) stages a CTA streams key tiles through: tile kt in
// stage kt % kStages.  advance(kt) opens key tile kt: tile kt + 1 has
// landed and is visible to every thread and to wgmma, and tile kt + 2's
// copies go into the stage of tile kt - 2, whose products the barrier
// has seen finish.  Every thread calls it once for each key tile up to
// the CTA's last, whether its warpgroup still works or not.
template <bool kCausal>
struct KvRing {
  bf16* base;
  const bf16* k;
  const bf16* v;
  const Geom<kCausal>& g;
  int S, D;
  bool vec;

  __device__ __forceinline__ bf16* stage(int kt) const {
    return base + (kt % kStages) * 2 * kTileElems;
  }
  __device__ __forceinline__ void load(int kt) const {
    const int k0 = kt * kTile;
    tc::load_tile<kTile, kThreads>(stage(kt), k + g.head + k0 * g.ld, g.ld,
                                   S - k0, D, vec);
    tc::load_tile<kTile, kThreads>(stage(kt) + kTileElems,
                                   v + g.head + k0 * g.ld, g.ld, S - k0, D,
                                   vec);
  }
  // tiles 0 and 1 in flight, in two copy groups
  __device__ __forceinline__ void start() const {
    load(0);
    tc::cp_async_commit();
    if (g.last >= 1) load(1);
    tc::cp_async_commit();
  }
  __device__ __forceinline__ void advance(int kt) const {
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    __syncthreads();
    if (kt + 2 <= g.last) load(kt + 2);
    tc::cp_async_commit();
  }
};

// causal masking of one warp's 16 x 64 scores (accumulator layout) at
// key tile kt: keys past S, or past the row under causal, to -1e30; for
// dq (kRows) also rows past S.  Only tiles that cross the diagonal or S
// (or a ragged last q tile) test anything.
template <bool kCausal, bool kRows>
__device__ __forceinline__ void mask(float s[32], const Geom<kCausal>& g,
                                     int kt, int S, int qrow) {
  const int k0 = kt * kTile;
  if (!((kCausal && k0 + kTile - 1 > g.q0 + g.row0) || k0 + kTile > S ||
        (kRows && g.q0 + g.row0 + 16 > S)))
    return;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int kp = k0 + (i >> 2) * 8 + 2 * (g.lane & 3) + (i & 1);
    const int qp = qrow + 8 * ((i >> 1) & 1);
    if (kp >= S || (kCausal && kp > qp) || (kRows && qp >= S))
      s[i] = kNegInf;
  }
}

// ---------------------------------------------------------------------------
// forward: grid (q tiles, B*H)
// ---------------------------------------------------------------------------
template <bool kCausal, bool kStats>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ acc_out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int S, int H, int D, float qscale, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geom<kCausal> g(S, H, D);
  const KvRing<kCausal> ring{reinterpret_cast<bf16*>(smem_raw), k, v, g, S,
                             D, vec != 0};
  const int lane = g.lane;

  ring.start();
  // q2 passes through the last stage, first refilled by key tile 3
  bf16* Qs = ring.stage(kStages - 1);
  tc::load_tile<kBq, kThreads, true>(Qs, q + g.head + g.q0 * g.ld, g.ld,
                                     S - g.q0, D, vec, qscale);
  tc::cp_async_wait<1>();   // key tile 0
  tc::fence_proxy_async();
  __syncthreads();
  // the warp's A fragments of q2 (tc.cuh: the layout wgmma takes)
  uint32_t qf[tc::kTileCols / 16][4];
#pragma unroll
  for (int ks = 0; ks < tc::kTileCols / 16; ++ks)
    tc::ldmatrix_x4(qf[ks], Qs + tc::il_off(g.row0 + (lane & 15),
                                            2 * ks + (lane >> 4)));

  // the thread's rows: g and g + 8 of the warp's 16 (r = 0, 1)
  const int qrow = g.q0 + g.row0 + (lane >> 2);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float m_new[2], alpha[2];
  float acc[64], s[32], sn[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // s = q2 . k^T of key tile kt, issued (committed, not waited for)
  auto issue_s = [&](float (&sc)[32], int kt) {
    tc::fence_regs(sc);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < tc::kTileCols / 16; ++ks)
      tc::wgmma_m64n64k16_rs<0>(sc, qf[ks], desc_k(ring.stage(kt), ks), ks);
    tc::wgmma_commit();
  };
  // the new row max from key tile kt's scores in s, and acc rescaled to
  // it once the previous tile's p . v has landed
  auto rescale = [&](int kt) {
    mask<kCausal, false>(s, g, kt, S, qrow);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
      m_new[r] = fmaxf(m[r], tc::quad_max(mx));
      alpha[r] = fexp2(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * n + 2 * r] *= alpha[r];
        acc[4 * n + 2 * r + 1] *= alpha[r];
      }
    tc::fence_regs(acc);
  };
  // p = exp2(s - m), l, and acc += round(p) . v of key tile kt, issued
  auto accumulate_pv = [&](int kt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * n + e] = fexp2(s[4 * n + e] - m_new[r]);
          ps += s[4 * n + e];
        }
      l[r] = l[r] * alpha[r] + tc::quad_sum(ps);
    }
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      tc::c_to_a(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      tc::wgmma_m64n128k16_rs<1>(
          acc, pa[kk], desc_mn(ring.stage(kt) + kTileElems, kk), 1);
    tc::wgmma_commit();
  };

  issue_s(s, 0);
  tc::wgmma_wait<0>();
  tc::fence_regs(s);
  for (int kt = 0; kt < g.last_wg; ++kt) {
    ring.advance(kt);
    rescale(kt);
    issue_s(sn, kt + 1);      // under this tile's exp2
    accumulate_pv(kt);        // under the next tile's row max
    tc::wgmma_wait<1>();      // the next tile's scores
    tc::fence_regs(sn);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = sn[i];
  }
  ring.advance(g.last_wg);
  rescale(g.last_wg);
  accumulate_pv(g.last_wg);
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);
  for (int kt = g.last_wg + 1; kt <= g.last; ++kt) ring.advance(kt);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= S) continue;
    const size_t base = ((size_t)g.b * S + row) * H + g.h;
    const float den = fmaxf(l[r], kTiny);
    if (kStats && (lane & 3) == 0) {
      m_out[base] = m[r] * kLn2;
      l_out[base] = l[r];
    }
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + e;
        if (col >= D) continue;
        if (kStats)
          acc_out[base * D + col] = acc[4 * n + 2 * r + e];
        else
          o[base * D + col] =
              __float2bfloat16_rn(acc[4 * n + 2 * r + e] / den);
      }
  }
}

// ---------------------------------------------------------------------------
// dq: grid (q tiles, B*H); streams key tiles 0..(causal frontier)
// ---------------------------------------------------------------------------
template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ dlt_in,
                       float* __restrict__ dq, int S, int H, int D,
                       float qscale, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Geom<kCausal> g(S, H, D);
  const KvRing<kCausal> ring{reinterpret_cast<bf16*>(smem_raw), k, v, g, S,
                             D, vec != 0};
  bf16* Qs = ring.base + kStages * 2 * kTileElems;   // resident
  bf16* dOs = Qs + kBq * tc::kTileCols;
  const int lane = g.lane;

  // dO rides in the first copy group with key tile 0
  tc::load_tile<kBq, kThreads>(dOs, dout + g.head + g.q0 * g.ld, g.ld,
                               S - g.q0, D, vec);
  ring.start();
  tc::load_tile<kBq, kThreads, true>(Qs, q + g.head + g.q0 * g.ld, g.ld,
                                     S - g.q0, D, vec, qscale);
  tc::cp_async_wait<1>();   // dO and key tile 0
  tc::fence_proxy_async();
  __syncthreads();

  const int qrow = g.q0 + g.row0 + (lane >> 2);
  float mlog2[2], lden[2], rl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    const size_t base = ((size_t)g.b * S + row) * H + g.h;
    mlog2[r] = row < S ? m_in[base] * kLog2e : 0.f;
    lden[r] = row < S ? fmaxf(l_in[base], kTiny) : 1.f;
    rl[r] = 1.f / lden[r];
    dl[r] = row < S ? dlt_in[base] : 0.f;
  }
  const bf16* Qw = Qs + tc::il_off(g.wg0, 0);    // the warpgroup's rows
  const bf16* dOw = dOs + tc::il_off(g.wg0, 0);
  float acc[64], s[32], dp[32], sn[32], dpn[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // s = q2 . k^T and dp = do . v^T of key tile kt, issued
  auto issue_sdp = [&](float (&sc)[32], float (&dpc)[32], int kt) {
    tc::fence_regs(sc);
    tc::fence_regs(dpc);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < tc::kTileCols / 16; ++ks)
      tc::wgmma_m64n64k16_ss<0>(sc, desc_k(Qw, ks),
                                desc_k(ring.stage(kt), ks), ks);
#pragma unroll
    for (int ks = 0; ks < tc::kTileCols / 16; ++ks)
      tc::wgmma_m64n64k16_ss<0>(dpc, desc_k(dOw, ks),
                                desc_k(ring.stage(kt) + kTileElems, ks), ks);
    tc::wgmma_commit();
  };
  // ds = p * (dp - dlt) of key tile kt, rounded, and acc += ds . k issued
  auto accumulate_dsk = [&](int kt) {
    mask<kCausal, true>(s, g, kt, S, qrow);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = div_rn(fexp2(s[i] - mlog2[r]), lden[r], rl[r]);
      s[i] = p * (dp[i] - dl[r]);   // ds
    }
    uint32_t da[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      tc::c_to_a(da[kk], &s[8 * kk], &s[8 * kk + 4]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      tc::wgmma_m64n128k16_rs<1>(acc, da[kk], desc_mn(ring.stage(kt), kk),
                                 1);
    tc::wgmma_commit();
  };

  tc::fence_regs(acc);
  issue_sdp(s, dp, 0);
  tc::wgmma_wait<0>();
  tc::fence_regs(s);
  tc::fence_regs(dp);
  for (int kt = 0; kt < g.last_wg; ++kt) {
    ring.advance(kt);
    issue_sdp(sn, dpn, kt + 1);   // under this tile's ds
    accumulate_dsk(kt);           // under the next tile's ds
    tc::wgmma_wait<1>();          // the next tile's s and dp
    tc::fence_regs(sn);
    tc::fence_regs(dpn);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = sn[i];
      dp[i] = dpn[i];
    }
  }
  ring.advance(g.last_wg);
  accumulate_dsk(g.last_wg);
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);
  for (int kt = g.last_wg + 1; kt <= g.last; ++kt) ring.advance(kt);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= S) continue;
    const size_t base = ((size_t)g.b * S + row) * H + g.h;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + e;
        if (col < D) dq[base * D + col] = acc[4 * n + 2 * r + e] * scale;
      }
  }
}

// ---------------------------------------------------------------------------
// dk/dv: grid (key tiles of kBq, B*H); the key tile's K and V stay
// resident, each warpgroup owning 64 keys, and the 64-row q tiles from
// the first that sees the key tile (causal) to the end stream through a
// ring of (Q, dO, statistics) stages
// ---------------------------------------------------------------------------
constexpr int kStatRows = 4 * kTile;   // m, l, dlt and 1/l of a q tile
constexpr size_t kDkvStage = 2 * kTileElems * sizeof(bf16)
                             + kStatRows * sizeof(float);
constexpr size_t kDkvSmem = 2 * kBq * tc::kTileCols * sizeof(bf16)
                            + kStages * kDkvStage;
static_assert(kDkvStage % 128 == 0, "stages keep the tiles' alignment");

// One stage: the q tile's Q (q2 after prepare), dO and its rows' f32
// statistics: m (m * log2(e) after prepare), l (max(l, 1e-30)), dlt and
// 1 / max(l, 1e-30), each kTile floats.  Tile i of the CTA (q tile
// first + i) sits in stage i % kStages.  advance(i) opens tile i: tile i
// (prepared) is visible to every thread and to wgmma, tile i + 1 has
// landed and is prepared, and tile i + 2's copies go into the stage of
// tile i - 2, whose products every warpgroup has retired.
struct QRing {
  unsigned char* base;
  const bf16* q;
  const bf16* dout;
  const float* m;
  const float* l;
  const float* dlt;
  int first, n, S, H, D, b, h;
  size_t ld, head;
  float qscale;
  bool vec;

  __device__ __forceinline__ bf16* qs(int i) const {
    return reinterpret_cast<bf16*>(base + (i % kStages) * kDkvStage);
  }
  __device__ __forceinline__ bf16* dos(int i) const {
    return qs(i) + kTileElems;
  }
  __device__ __forceinline__ float* stats(int i) const {
    return reinterpret_cast<float*>(qs(i) + 2 * kTileElems);
  }
  __device__ __forceinline__ void load(int i) const {
    const int q0 = (first + i) * kTile;
    tc::load_tile<kTile, kThreads>(qs(i), q + head + q0 * ld, ld, S - q0, D,
                                   vec);
    tc::load_tile<kTile, kThreads>(dos(i), dout + head + q0 * ld, ld,
                                   S - q0, D, vec);
    if (threadIdx.x < 3 * kTile) {
      const int which = threadIdx.x / kTile;
      const int r = threadIdx.x % kTile;
      const bool valid = q0 + r < S;
      const size_t at = valid ? ((size_t)b * S + q0 + r) * H + h : 0;
      const float* src = which == 0 ? m : which == 1 ? l : dlt;
      tc::cp_async4(stats(i) + which * kTile + r, src + at, valid);
    }
  }
  // the landed tile i made what the products and the elementwise pass
  // read: q2 = round_bf16(q * qscale) in place (the JAX rounding point),
  // m * log2(e), max(l, 1e-30) and its reciprocal
  __device__ __forceinline__ void prepare(int i) const {
    uint4* t = reinterpret_cast<uint4*>(qs(i));
#pragma unroll
    for (int j = 0; j < kTileElems / 8 / kThreads; ++j) {
      uint4 raw = t[threadIdx.x + j * kThreads];
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        w[e] = tc::pack_bf16(f.x * qscale, f.y * qscale);
      }
      t[threadIdx.x + j * kThreads] = raw;
    }
    if (threadIdx.x < kTile) {
      float* st = stats(i);
      const int r = threadIdx.x;
      st[r] *= kLog2e;
      const float den = fmaxf(st[kTile + r], kTiny);
      st[kTile + r] = den;
      st[3 * kTile + r] = 1.f / den;
    }
  }
  // tiles 0 and 1 in flight (tile 0 with the caller's K and V), then
  // tile 0 landed and prepared
  __device__ __forceinline__ void start() const {
    load(0);
    tc::cp_async_commit();
    if (n > 1) load(1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    prepare(0);
  }
  __device__ __forceinline__ void advance(int i) const {
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    __syncthreads();
    if (i + 1 < n) prepare(i + 1);
    if (i + 2 < n) load(i + 2);
    tc::cp_async_commit();
  }
};

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const float* __restrict__ dlt_in,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int S, int H, int D, float qscale, float inv_log2e,
                        int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // resident
  bf16* Vs = Ks + kBq * tc::kTileCols;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int k0 = blockIdx.x * kBq;   // key tile 0 (the most q tiles) first
  const int wg0 = (threadIdx.x >> 7) * 64;   // the warpgroup's keys
  const int row0 = (threadIdx.x >> 5) * 16;  // the warp's keys
  const int lane = threadIdx.x & 31;
  const size_t ld = (size_t)H * D;
  const size_t head = (size_t)b * S * ld + (size_t)h * D;
  // causal: from the q tile holding the key tile's first key
  const int first = kCausal ? k0 / kTile : 0;
  const QRing ring{smem_raw + 2 * kBq * tc::kTileCols * sizeof(bf16),
                   q, dout, m_in, l_in, dlt_in, first,
                   (S + kTile - 1) / kTile - first, S, H, D, b, h, ld, head,
                   qscale, vec != 0};

  // K and V ride in the first copy group with q tile 0
  tc::load_tile<kBq, kThreads>(Ks, k + head + k0 * ld, ld, S - k0, D,
                               vec != 0);
  tc::load_tile<kBq, kThreads>(Vs, v + head + k0 * ld, ld, S - k0, D,
                               vec != 0);
  ring.start();

  const bf16* Kw = Ks + tc::il_off(wg0, 0);
  const bf16* Vw = Vs + tc::il_off(wg0, 0);
  // the thread's keys: rows g and g + 8 of the warp's 16 (r = 0, 1)
  const int krow = k0 + row0 + (lane >> 2);
  float dka[64], dva[64], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
  tc::fence_regs(dka);
  tc::fence_regs(dva);

  for (int i = 0; i < ring.n; ++i) {
    ring.advance(i);
    const bf16* Qt = ring.qs(i);
    const bf16* dOt = ring.dos(i);
    const float* st = ring.stats(i);
    const int q0 = (first + i) * kTile;
    // s^T = k . q2^T and dp^T = v . do^T: 64 keys x 64 q rows
    tc::fence_regs(s);
    tc::fence_regs(dp);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < tc::kTileCols / 16; ++ks)
      tc::wgmma_m64n64k16_ss<0>(s, desc_k(Kw, ks), desc_k(Qt, ks), ks);
#pragma unroll
    for (int ks = 0; ks < tc::kTileCols / 16; ++ks)
      tc::wgmma_m64n64k16_ss<0>(dp, desc_k(Vw, ks), desc_k(dOt, ks), ks);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();   // also retires the last tile's dk and dv
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // masked (key past the q row under causal, or either past S): s =
    // -1e30, so p = 0 and ds = 0.  Only tiles that cross the diagonal or
    // S test anything.
    if ((kCausal && krow - (lane >> 2) + 15 > q0) || q0 + kTile > S ||
        krow - (lane >> 2) + 16 > S) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = krow + 8 * ((e >> 1) & 1);
        const int qp = q0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
        if (qp >= S || kp >= S || (kCausal && kp > qp)) s[e] = kNegInf;
      }
    }
    // p = exp2(s - m log2(e)) / max(l, 1e-30), unrounded; ds = p (dp -
    // dlt); both per q column, rounded to bf16 as the A operands of the
    // next products (the JAX round_T(p), round_T(ds) points)
    uint32_t pa[kTile / 16][4], da[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      const float2 ml = *reinterpret_cast<const float2*>(st + c);
      const float2 den = *reinterpret_cast<const float2*>(st + kTile + c);
      const float2 dl = *reinterpret_cast<const float2*>(st + 2 * kTile + c);
      const float2 rl = *reinterpret_cast<const float2*>(st + 3 * kTile + c);
#pragma unroll
      for (int e = 4 * j; e < 4 * j + 4; ++e) {
        const bool odd = e & 1;
        const float p = div_rn(fexp2(s[e] - (odd ? ml.y : ml.x)),
                               odd ? den.y : den.x, odd ? rl.y : rl.x);
        dp[e] = p * (dp[e] - (odd ? dl.y : dl.x));
        s[e] = p;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      tc::c_to_a(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
      tc::c_to_a(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
    }
    // dv += round(p)^T . do, dk += round(ds)^T . q2 (q rows reduced: do
    // and q2 read MN-major), issued; retired under the next tile's s^T
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      tc::wgmma_m64n128k16_rs<1>(dva, pa[kk], desc_mn(dOt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      tc::wgmma_m64n128k16_rs<1>(dka, da[kk], desc_mn(Qt, kk), 1);
    tc::wgmma_commit();
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(dka);
  tc::fence_regs(dva);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + 8 * r;
    if (row >= S) continue;
    const size_t base = ((size_t)b * S + row) * H + h;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + e;
        if (col >= D) continue;
        dk[base * D + col] = dka[4 * n + 2 * r + e] * inv_log2e;
        dv[base * D + col] = dva[4 * n + 2 * r + e];
      }
  }
}

// 16-byte copies need D a multiple of 8 and every tensor 16-byte aligned
bool vec_ok(int D, std::initializer_list<const void*> ptrs) {
  if (D % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <bool kCausal, bool kStats>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* acc, void* m, void* l, int B, int S, int H, int D,
                float qscale, cudaStream_t st) {
  static bool ready = false;
  auto kernel = flash_fwd_tc_kernel<kCausal, kStats>;
  cudaError_t err = allow_smem(kernel, kFwdSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBq - 1) / kBq, B * H);
  kernel<<<grid, kThreads, kFwdSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), S, H, D, qscale, vec_ok(D, {q, k, v}));
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* m, const void* l,
                   const void* dlt, void* dq, int B, int S, int H, int D,
                   float qscale, float scale, cudaStream_t st) {
  static bool ready = false;
  auto kernel = flash_dq_tc_kernel<kCausal>;
  cudaError_t err = allow_smem(kernel, kDqSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBq - 1) / kBq, B * H);
  kernel<<<grid, kThreads, kDqSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dlt), static_cast<float*>(dq), S, H, D,
      qscale, scale, vec_ok(D, {q, k, v, dout}));
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* m, const void* l,
                    const void* dlt, void* dk, void* dv, int B, int S, int H,
                    int D, float qscale, float inv_log2e, cudaStream_t st) {
  static bool ready = false;
  auto kernel = flash_dkv_tc_kernel<kCausal>;
  cudaError_t err = allow_smem(kernel, kDkvSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBq - 1) / kBq, B * H);
  kernel<<<grid, kThreads, kDkvSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dlt), static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, D, qscale, inv_log2e,
      vec_ok(D, {q, k, v, dout}));
  return cudaGetLastError();
}

}  // namespace

// the bf16 routes of dtx_flash_fwd, dtx_flash_bwd_dq and dtx_flash_bwd_dkv
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           void* o, void* acc, void* m, void* l, int B,
                           int S, int H, int D, bool causal, bool stats,
                           float qscale, cudaStream_t st) {
  if (causal)
    return stats ? fwd<true, true>(q, k, v, o, acc, m, l, B, S, H, D,
                                   qscale, st)
                 : fwd<true, false>(q, k, v, o, acc, m, l, B, S, H, D,
                                    qscale, st);
  return stats ? fwd<false, true>(q, k, v, o, acc, m, l, B, S, H, D, qscale,
                                  st)
               : fwd<false, false>(q, k, v, o, acc, m, l, B, S, H, D, qscale,
                                   st);
}

cudaError_t flash_dq_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const void* m, const void* l,
                          const void* dlt, void* dq, int B, int S, int H,
                          int D, bool causal, float qscale, float scale,
                          cudaStream_t st) {
  return causal ? bwd_dq<true>(q, k, v, dout, m, l, dlt, dq, B, S, H, D,
                               qscale, scale, st)
                : bwd_dq<false>(q, k, v, dout, m, l, dlt, dq, B, S, H, D,
                                qscale, scale, st);
}

cudaError_t flash_dkv_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* m, const void* l,
                           const void* dlt, void* dk, void* dv, int B, int S,
                           int H, int D, bool causal, float qscale,
                           float inv_log2e, cudaStream_t st) {
  return causal ? bwd_dkv<true>(q, k, v, dout, m, l, dlt, dk, dv, B, S, H,
                                D, qscale, inv_log2e, st)
                : bwd_dkv<false>(q, k, v, dout, m, l, dlt, dk, dv, B, S, H,
                                 D, qscale, inv_log2e, st);
}

}  // namespace dtx
