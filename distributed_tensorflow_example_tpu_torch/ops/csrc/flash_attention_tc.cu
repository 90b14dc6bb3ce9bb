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
//     zero-padded to 128 in shared memory (D up to 256: the wide kernels
//     below) and every product runs its 8
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
// Head dims 129-256 (the *_wide_tc kernels; JAX _pick_tiles takes D >
// 128 with square tiles): tiles are zero-padded to 256 columns, where the
// narrow design does not fit (its four stages of 64-key tiles would take
// 256 KB of the 227 KB a CTA can have, and q2 in registers beside a 64 x
// 256 f32 output, 128 registers a thread, passes the 255 a thread may
// use).  All three are warp specialized (FlashAttention-3's producer and
// consumers): a producer warpgroup keeps 56 registers (setmaxnreg) and
// streams tiles of one head by TMA (rank-4 maps of [B, S, H, D],
// 128-byte swizzled boxes of [rows][64]) through a ring of stages handed
// over on full / empty mbarriers; two consumer warpgroups of 224
// registers run the products, with no CTA-wide barrier after the start.
// What bounds them: with every thread's cp.async feeding the streamed
// tiles (2.35 TB/s from L2 on the H100) each ran at the copies' pace, far
// behind its products; TMA (15.89 TB/s) leaves each bound by its products
// and what feeds them from shared memory.
//   * forward: a CTA owns a 128-row q tile, Q resident (64 KB, four
//     [128][64] boxes by TMA; each consumer makes q2 in place over its 64
//     rows), and streams 80-key K and V tiles (40 KB each) through two
//     stages, K and V on mbarriers of their own, so a tile's s starts as
//     soon as its K lands and V's stage goes back once its p . v has
//     retired.  Consumer c owns 64 rows: s = q2 . k^T as m64n80k16 over
//     the 16 steps of the head dim (Q and K read from shared memory), acc
//     += round(p) . v as m64n256k16 (p from registers, V read MN-major).
//     The consumers take turns on two named barriers (FlashAttention-3's
//     ping-pong): a turn issues the last tile's p . v and this tile's s
//     together and hands the turn on, so one consumer's row max, rescale
//     of acc (no product of its own in flight) and exp2 pass run while
//     the other's products keep the tensor cores busy.  What is left: a
//     key tile's products take 32 tensor-core clocks a key, and its
//     shared-memory traffic (s reads Q and K and p . v reads V, once per
//     consumer; TMA writes K and V) 3.8 KB a key, 30 clocks at 128 B a
//     clock: the two co-limit.  Hence 80 keys (FlashAttention-3's width
//     at this head dim), the widest tile two stages of K and V leave room
//     for beside Q: Q's reads per key fall with the width (64 keys: 4 KB
//     a key, 32 clocks).  Issuing tile j + 1's s ahead of tile j's
//     softmax as well (acc rescaled between the two products, p packed
//     after the wait) measured no faster, and packing p while its product
//     was in flight made ptxas serialize the products; not kept.  Shared
//     memory 65,536 + 163,840 + 72 = 229,448 B.  At [8, 8192, 4, 256]
//     causal 1.6966-1.7031 ms (645.7-648.2 TFLOP/s, 1.05x SDPA's forward;
//     bound 1.112 ms by operations) on an NVIDIA H100 80GB HBM3 at 700.00
//     W, where the design before it (every thread's cp.async into a
//     two-stage ring, no product under another tile's softmax) took
//     4.2206-4.2520 ms in the same call.
//   * dq: a CTA owns a 128-row q tile, Q2 and dO resident (128 KB,
//     loaded by cp.async, q2 made in place); consumer c owns 64 rows and
//     streams 32-key (K, V) tiles (32 KB) through three stages up to its
//     causal frontier: s and dp as m64n32k16 over the 16 steps of the
//     head dim, ds in registers, dq += round(ds) . k as m64n256k16 over
//     the tile's two 16-key steps.  Each K and V tile is read once for
//     128 q rows.  The two consumers share nothing but the ring, so one's
//     exp2 / ds pass runs under the other's products.  Shared memory
//     98,304 + 131,072 + 56 = 229,432 B.
//   * dk/dv: a CTA owns 64 keys, K and V resident (64 KB, cp.async), and
//     streams 32-row (Q, dO) tiles through four stages (32 KB each; their
//     statistics 512 B each beside).  dk and dv of 64 keys x 256 columns
//     would be 256 f32 registers a thread, so the consumers split the
//     work by product: warpgroup 1 runs s^T = k . q2^T (m64n32k16), p in
//     its registers and dv += round(p)^T . do (m64n256k16, all 256
//     columns); warpgroup 2 runs dp^T = v . do^T, ds = p (dp - dlt) and
//     dk += round(ds)^T . q2.  Each (q, key) pair's s^T and dp^T are
//     computed once in the CTA (8 D flops a pair); warpgroup 1 hands p
//     (f32, unrounded, so ds keeps the JAX rounding point) to warpgroup 2
//     through a double buffer on named barriers, so 1 may run two tiles
//     ahead and the two are never in lock-step; while 1 runs its exp2
//     pass, 2's products (and the other way for its ds pass) keep the
//     tensor cores busy.  Issuing the next tile's scores before this
//     tile's elementwise pass (retiring dk / dv with wgmma_wait<1>) was
//     measured slower on the H100 (6.07 ms against 5.48 at [8, 8192, 4,
//     256]; 48 B spilled), so each tile's scores are issued behind the
//     last tile's dv (dk) products and retired together.  Shared memory
//     65,536 + 131,072 + 2,048 + 16,384 (p) + 104 = 215,144 B.
//   * registers (-Xptxas -v): all three 168 at launch (384 threads),
//     setmaxnreg 56 / 224, 0 bytes spilled (the forward's producer spilled
//     at 24, 32 and 40).  Masking, rounding points, the guards
//     for ragged S and the zero padding are the narrow kernels'; where D
//     is not a multiple of 8 (or a tensor not 16-byte aligned) the
//     producer fills the same swizzled layout with guarded scalar loads.
//     No atomics: every output element is summed by one thread in a fixed
//     order, the same bits from call to call.
// Registers and spills of each instantiation (-Xptxas -v) are printed
// by chip_smoke.py and kept in PERF.md.  Times above: an NVIDIA H100 80GB
// HBM3 at 700.00 W (scripts/torch_flash_bench.py and the copy rates of
// scripts/torch_copy_bench.py).
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

// descriptors of the core-matrix tiles (tc.cuh): step ks of the head
// dim of a [rows][d] tile of kCols columns read k-major (rows are the
// product's M or N), and keys 16kk.. of a [keys][d] tile read MN-major
// (keys reduced)
template <int kCols = tc::kTileCols>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int ks) {
  return tc::gmma_desc(tile + tc::il_off<kCols>(0, 2 * ks), 128,
                       tc::il_group(kCols));
}

__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk) {
  return tc::gmma_desc(tile + tc::il_off(16 * kk, 0),
                       tc::il_group(tc::kTileCols), 128);
}

// the geometry one CTA works on: q tile qt (of kRowsQ rows) of head (b, h)
template <bool kCausal, int kRowsQ = kBq>
struct Geom {
  int qt, q0, row0, wg0, lane, last, last_wg, b, h;
  size_t ld, head;

  __device__ __forceinline__ Geom(int S, int H, int D) {
    qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal q tiles first
    b = blockIdx.y / H;
    h = blockIdx.y % H;
    q0 = qt * kRowsQ;
    row0 = (threadIdx.x >> 5) * 16;    // the warp's rows
    wg0 = (threadIdx.x >> 7) * 64;     // the warpgroup's rows
    lane = threadIdx.x & 31;
    // causal: up to the key tile holding the q tile's (the warpgroup's)
    // last row
    last = (kCausal ? min(q0 + kRowsQ, S) - 1 : S - 1) / kTile;
    last_wg = kCausal ? min(last, (q0 + wg0 + 63) / kTile) : last;
    ld = (size_t)H * D;                // between rows of one head
    head = (size_t)b * S * ld + (size_t)h * D;
  }
};

// The ring of (K, V) stages a CTA streams key tiles through: tile kt in
// stage kt % kStages, filled by the CTA's threads, two tiles ahead:
// advance(kt) opens key tile kt: tile kt + 1 has landed and is visible
// to every thread and to wgmma, and tile kt + 2's copies go into the
// stage of tile kt - 2, whose products the barrier has seen finish.
// Every thread calls it once for each key tile up to the CTA's last,
// whether its warpgroup still works or not.
template <class G>
struct KvRing {
  static constexpr int kElems = kTileElems;   // one K or V tile
  bf16* base;
  const bf16* k;
  const bf16* v;
  const G& g;
  int S, D;
  bool vec;

  __device__ __forceinline__ bf16* stage(int kt) const {
    return base + (kt % kStages) * 2 * kElems;
  }
  __device__ __forceinline__ void load(int kt) const {
    const int k0 = kt * kTile;
    tc::load_tile<kTile, kThreads>(stage(kt), k + g.head + k0 * g.ld, g.ld,
                                   S - k0, D, vec);
    tc::load_tile<kTile, kThreads>(stage(kt) + kElems,
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
template <bool kCausal, bool kRows, class G>
__device__ __forceinline__ void mask(float s[32], const G& g, int kt, int S,
                                     int qrow) {
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
  const KvRing<Geom<kCausal>> ring{reinterpret_cast<bf16*>(smem_raw), k, v,
                                   g, S, D, vec != 0};
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
  const KvRing<Geom<kCausal>> ring{reinterpret_cast<bf16*>(smem_raw), k, v,
                                   g, S, D, vec != 0};
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

// One stage: the q tile's Q (q2 after prepare), dO (128 columns each)
// and its rows' f32 statistics: m (m * log2(e) after prepare), l (max(l,
// 1e-30)), dlt and 1 / max(l, 1e-30), each kTile floats.  Tile i of the
// CTA (q tile first + i) sits in stage i % kStages: advance(i) opens
// tile i: tile i (prepared) is visible to every thread and to wgmma,
// tile i + 1 has landed and is prepared, and tile i + 2's copies go into
// the stage of tile i - 2, whose products every warpgroup has retired.
struct QRing {
  static constexpr int kElems = kTile * tc::kTileCols;   // one Q or dO tile
  static constexpr size_t kStageBytes =
      2 * kElems * sizeof(bf16) + kStatRows * sizeof(float);
  static_assert(kStageBytes % 128 == 0, "stages keep the tiles' alignment");
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
    return reinterpret_cast<bf16*>(base + (i % kStages) * kStageBytes);
  }
  __device__ __forceinline__ bf16* dos(int i) const {
    return qs(i) + kElems;
  }
  __device__ __forceinline__ float* stats(int i) const {
    return reinterpret_cast<float*>(qs(i) + 2 * kElems);
  }
  __device__ __forceinline__ void load(int i) const {
    const int q0 = (first + i) * kTile;
    tc::load_tile<kTile, kThreads, false, tc::kTileCols>(qs(i), q + head + q0 * ld,
                                                 ld, S - q0, D, vec);
    tc::load_tile<kTile, kThreads, false, tc::kTileCols>(
        dos(i), dout + head + q0 * ld, ld, S - q0, D, vec);
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
    for (int j = 0; j < kElems / 8 / kThreads; ++j) {
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
constexpr size_t kDkvSmem = 2 * kBq * tc::kTileCols * sizeof(bf16)
                            + kStages * QRing::kStageBytes;

// The elementwise pass of dk/dv on one transposed tile (the thread's
// keys krow, krow + 8 x the tile's q rows from q0) in the accumulator
// layout: masked entries (key past the q row under causal, or either
// past S) get s = -1e30, so p = 0 and ds = 0, and only tiles that cross
// the diagonal or S test anything; p = exp2(s - m log2(e)) / max(l,
// 1e-30), unrounded, and ds = p (dp - dlt), both per q column from the
// stage's prepared statistics ``st``, rounded to bf16 as the A operands
// pa and da of the next products (the JAX round_T(p), round_T(ds)
// points).
template <bool kCausal>
__device__ __forceinline__ void dkv_p_ds(float s[32], float dp[32],
                                         const float* st, int krow, int q0,
                                         int S, int lane,
                                         uint32_t pa[kTile / 16][4],
                                         uint32_t da[kTile / 16][4]) {
  if ((kCausal && krow - (lane >> 2) + 15 > q0) || q0 + kTile > S ||
      krow - (lane >> 2) + 16 > S) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int kp = krow + 8 * ((e >> 1) & 1);
      const int qp = q0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
      if (qp >= S || kp >= S || (kCausal && kp > qp)) s[e] = kNegInf;
    }
  }
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
}

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

    uint32_t pa[kTile / 16][4], da[kTile / 16][4];
    dkv_p_ds<kCausal>(s, dp, st, krow, q0, S, lane, pa, da);
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

// ---------------------------------------------------------------------------
// head dims 129-256: tiles zero-padded to 256 columns (kWide) in shared
// memory, as narrower heads are padded to 128 above.  The header note
// says what bounds each wide kernel and what its design does about it.
// ---------------------------------------------------------------------------
constexpr int kWide = 256;                       // columns of a wide tile
constexpr int kWideTileElems = kTile * kWide;    // 32 KB

// ---------------------------------------------------------------------------
// The wide kernels (forward, dq and dk/dv at 128 < D <= 256) are warp
// specialized.  Warpgroup 0 is the producer: it loads the CTA's resident
// tiles (the backward's by cp.async into the no-swizzle layout, the
// forward's Q by TMA) and streams tiles of one head through a ring of
// stages by TMA (128-byte swizzled boxes of [rows][64], four a tile, on a
// rank-4 map of [B, S, H, D]; where D is not a multiple of 8, or a tensor
// not 16-byte aligned, guarded scalar loads into the same layout).
// Warpgroups 1 and 2 consume the stages on the tensor cores.  Stages are
// handed over on mbarriers: full (TMA's bytes, or the producer's arrival
// once its own stores are fenced; dk/dv: the arrivals of the three
// producer warps that made the landed tile's q2 and statistics) and empty
// (lane 0 of each of the 8 consumer warps, once the products that read
// the stage have retired); a stage's j-th fill is phase j of each, so a
// wait names the parity j & 1.  The producer keeps 56 registers a thread
// and gives the rest to the consumers (setmaxnreg: 128 x 56 + 256 x 224
// = 384 x 168, what the CTA is given at launch; the forward's producer
// spilled at 24, 32 and 40).
// ---------------------------------------------------------------------------
constexpr int kWideThreads = 384;     // producer + two consumer warpgroups
constexpr int kLaunchRegs = 65536 / kWideThreads / 8 * 8;   // 168 a thread
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
                  kWideThreads * kLaunchRegs,
              "the registers the warpgroups keep fit the CTA's");
constexpr int kBarProducer = 1;       // named barrier of the producer's 128
constexpr int kStream = 32;           // rows of a streamed tile
constexpr int kStreamElems = kStream * kWide;   // 16 KB

// a consumer warp done with a stage (after the wgmma_wait that retired
// the products reading it)
__device__ __forceinline__ void stage_release(uint64_t* empty, int lane) {
  if (lane == 0) tc::mbar_arrive(empty);
}

// descriptors of a streamed (swizzled) tile of four [kRows][64] boxes:
// step ks of the head dim read k-major (the tile's rows are the product's
// M or N: box ks / 4, 32 bytes a step within it), and rows 16kk.. read
// MN-major (the rows reduced; the next 64 columns a box away)
template <int kRows = kStream>
__device__ __forceinline__ uint64_t desc_sw_k(const bf16* tile, int ks) {
  return tc::gmma_desc_sw128(tile + (ks >> 2) * kRows * 64 + (ks & 3) * 16,
                             16);
}

template <int kRows = kStream>
__device__ __forceinline__ uint64_t desc_sw_mn(const bf16* tile, int kk) {
  return tc::gmma_desc_sw128(tile + 16 * kk * 64,
                             kRows * 64 * sizeof(bf16));
}

// Rows [0, kRows) of a resident [kRows][kWide] tile (tc.cuh's no-swizzle
// layout) from ``src`` (row r at src + r * ld), rows >= ``rows`` and
// columns >= D zero, by the producer's 128 threads: with ``vec`` one
// 16-byte cp.async a step, which the caller commits and waits for, else
// load_tile's guarded scalar loads (complete on return).  The loop is not
// unrolled: the producer keeps few registers.
template <int kRows>
__device__ __forceinline__ void produce_tile(bf16* __restrict__ dst,
                                             const bf16* __restrict__ src,
                                             size_t ld, int rows, int D,
                                             bool vec) {
  if (!vec) {
    tc::load_tile<kRows, 128, false, kWide>(dst, src, ld, rows, D, false);
    return;
  }
  constexpr int kChunks = kWide / 8;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += 128) {
    const int r = (idx / (8 * kChunks)) * 8 + (idx & 7);
    const int chunk = (idx >> 3) % kChunks;
    const bool valid = r < rows && chunk * 8 < D;
    tc::cp_async16(dst + tc::il_off<kWide>(r, chunk),
                   valid ? src + r * ld + chunk * 8 : src, valid);
  }
}

// A streamed tile: rows [r0, r0 + kRows) of head (b, h) into ``dst``'s
// four swizzled boxes.  With TMA (a map of kRows-row boxes), thread
// ``tid`` 0 issues the boxes on ``bar`` (whose bytes its caller expects);
// otherwise threads ``tid`` 0..nthr-1 each store their share, guarded
// (rows past S and columns past D zero), complete on return.
template <int kRows = kStream>
__device__ __forceinline__ void stream_tile(bf16* __restrict__ dst,
                                            const CUtensorMap* map,
                                            const bf16* __restrict__ src,
                                            size_t ld, int r0, int S, int D,
                                            int b, int h, uint64_t* bar,
                                            bool tma, int tid, int nthr) {
  if (tma) {
    if (tid == 0)
      for (int c = 0; c < kWide / 64; ++c)
        tc::tma_load_4d(dst + c * kRows * 64, map, 64 * c, h, r0, b, bar);
    return;
  }
  for (int idx = tid; idx < kRows * kWide; idx += nthr) {
    const int r = idx / kWide;
    const int c = idx % kWide;
    dst[(c >> 6) * kRows * 64 + tc::sw128_off(r, c & 63)] =
        r0 + r < S && c < D ? src[(size_t)(r0 + r) * ld + c]
                            : __float2bfloat16_rn(0.f);
  }
}

// q2 = round_bf16(q * qscale) in place over a landed tile of ``elems``
// values (the JAX rounding point; any layout), by threads ``tid`` 0..nthr-1
__device__ __forceinline__ void scale_in_place(bf16* tile, int elems,
                                               float qscale, int tid,
                                               int nthr) {
  uint4* t = reinterpret_cast<uint4*>(tile);
#pragma unroll 4
  for (int j = tid; j < elems / 8; j += nthr) {
    uint4 raw = t[j];
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      w[e] = tc::pack_bf16(f.x * qscale, f.y * qscale);
    }
    t[j] = raw;
  }
}

// masking of one warp's 16 x kKeys scores (accumulator layout) at the
// key tile from k0: keys past S or past the row (causal), and with kRows
// rows past S, to -1e30; ``wrow0`` is the warp's first row.  Only tiles
// that cross the diagonal or S test anything.
template <bool kCausal, int kKeys, bool kRows>
__device__ __forceinline__ void mask_wide(float (&s)[kKeys / 2], int k0,
                                          int wrow0, int qrow, int S,
                                          int lane) {
  if (!((kCausal && k0 + kKeys - 1 > wrow0) || k0 + kKeys > S ||
        (kRows && wrow0 + 16 > S)))
    return;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) {
    const int kp = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
    const int qp = qrow + 8 * ((i >> 1) & 1);
    if (kp >= S || (kCausal && kp > qp) || (kRows && qp >= S))
      s[i] = kNegInf;
  }
}

// ---------------------------------------------------------------------------
// wide forward: grid (q tiles of kBq, B*H), the heaviest causal q tiles
// first; the header note gives the design and what bounds it.  Q is four
// [128][64] swizzled boxes, a K or V tile four [80][64]; K (x = 0) and V
// (x = 1) of a stage are handed over on barriers of their own.
// ---------------------------------------------------------------------------
constexpr int kFwdWideStages = 2;        // of the (K, V) ring
constexpr int kFwdKeys = 80;             // keys of a streamed tile
constexpr int kFwdTileElems = kFwdKeys * kWide;   // 40 KB
constexpr int kBarTurn = 2;              // + consumer: its turn (2, 3)
constexpr int kBarQ2 = 4;                // + consumer: its q2 pass (4, 5)
constexpr size_t kFwdWideSmem =
    kBq * kWide * sizeof(bf16)                                // Q: 64 KB
    + kFwdWideStages * 2 * kFwdTileElems * sizeof(bf16)       // 160 KB
    + (4 * kFwdWideStages + 1) * sizeof(uint64_t);            // 229,448 B

template <bool kCausal, bool kStats>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_wide_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             bf16* __restrict__ o,
                             float* __restrict__ acc_out,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out, int S, int H, int D,
                             float qscale, int vec) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // swizzled, q2 in place
  bf16* ring = Qs + kBq * kWide;                  // swizzled (K, V)
  // full[0, kFwdWideStages) K's stages, then V's; empty the same
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kFwdWideStages * 2 * kFwdTileElems);
  uint64_t* empty = full + 2 * kFwdWideStages;
  uint64_t* landed_q = empty + 2 * kFwdWideStages;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t ld = (size_t)H * D;
  const size_t head = (size_t)b * S * ld + (size_t)h * D;
  // causal: up to the key tile holding the q tile's last row
  const int last = (kCausal ? min(q0 + kBq, S) - 1 : S - 1) / kFwdKeys;
  // the thread's warpgroup, uniform over each warp as the compiler can
  // see: setmaxnreg needs the role branch warp-uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  // key tile j's K (x = 0) or V (x = 1), and its stage's barriers
  auto tile = [&](int x, int j) {
    return ring + ((j % kFwdWideStages) * 2 + x) * kFwdTileElems;
  };
  auto slot = [&](int x, int j) {
    return x * kFwdWideStages + j % kFwdWideStages;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kFwdWideStages; ++i) {
      tc::mbar_init(&full[i], 1);
      tc::mbar_init(&empty[i], 8);
    }
    tc::mbar_init(landed_q, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: Q, then each key tile's K and V into their stages
    // once both consumers are done with the tile two before (with TMA
    // thread 0 alone, otherwise all 128 threads' guarded stores)
    tc::setmaxnreg_dec<kProducerRegs>();
    const bool tma = vec != 0;
    const int t = threadIdx.x;
    if (tma && t != 0) return;
    auto done = [&](uint64_t* bar) {   // the scalar route's stores landed
      if (tma) return;
      tc::fence_proxy_async();
      tc::bar_sync(kBarProducer, 128);
      if (t == 0) tc::mbar_arrive(bar);
    };
    if (tma) tc::mbar_expect_tx(landed_q, kBq * kWide * sizeof(bf16));
    stream_tile<kBq>(Qs, &map_q, q + head, ld, q0, S, D, b, h, landed_q, tma,
                     t, 128);
    done(landed_q);
#pragma unroll 1
    for (int j = 0; j <= last; ++j) {
#pragma unroll 1
      for (int x = 0; x < 2; ++x) {
        uint64_t* bar = &full[slot(x, j)];
        if (j >= kFwdWideStages)
          tc::mbar_wait(&empty[slot(x, j)], (j / kFwdWideStages - 1) & 1);
        if (tma) tc::mbar_expect_tx(bar, kFwdTileElems * sizeof(bf16));
        stream_tile<kFwdKeys>(tile(x, j), x ? &map_v : &map_k,
                              (x ? v : k) + head, ld, j * kFwdKeys, S, D, b,
                              h, bar, tma, t, 128);
        done(bar);
      }
    }
    return;
  }

  // the consumers
  tc::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int ct = threadIdx.x & 127;
  const int lane = ct & 31;
  const int wrow0 = q0 + 64 * c + (ct >> 5) * 16;   // the warp's first row
  const int qrow = wrow0 + (lane >> 2);
  const int last_c = kCausal ? min(last, (q0 + 64 * c + 63) / kFwdKeys) : last;
  bf16* Qc = Qs + 64 * c * 64;   // its rows of each [128][64] box

  // q2 = round_bf16(q * qscale) in place over its own rows (the JAX
  // rounding point), visible to its warpgroup's products
  tc::mbar_wait(landed_q, 0);
#pragma unroll
  for (int box = 0; box < kWide / 64; ++box)
    scale_in_place(Qc + box * kBq * 64, 64 * 64, qscale, ct, 128);
  tc::fence_proxy_async();
  tc::bar_sync(kBarQ2 + c, 128);

  // the thread's rows: g and g + 8 of the warp's 16 (r = 0, 1)
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[2 * kWide / 4], s[2 * kFwdKeys / 4];
  uint32_t pa[kFwdKeys / 16][4];   // round(p) of the last tile, the A operand
#pragma unroll
  for (int i = 0; i < 2 * kWide / 4; ++i) acc[i] = 0.f;
  tc::fence_regs(acc);

  auto wait_full = [&](int x, int j) {
    tc::mbar_wait(&full[slot(x, j)], (j / kFwdWideStages) & 1);
  };
  // s = q2 . k^T of key tile j, and acc += round(p) . v of key tile j
  auto issue_s = [&](int j) {
#pragma unroll
    for (int ks = 0; ks < kWide / 16; ++ks)
      tc::wgmma_m64n80k16_ss<0>(s, desc_sw_k<kBq>(Qc, ks),
                                desc_sw_k<kFwdKeys>(tile(0, j), ks), ks);
  };
  auto issue_pv = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk)
      tc::wgmma_m64n256k16_rs<1>(acc, pa[kk],
                                 desc_sw_mn<kFwdKeys>(tile(1, j), kk), 1);
  };
  // a turn: consumer 0 goes first; the other's turn is handed on when
  // this one's products are issued (consumer 1's last turn hands on
  // nothing: each consumer takes last + 2 turns)
  if (c == 1) tc::bar_arrive(kBarTurn, 256);
  auto turn = [&] { tc::bar_sync(kBarTurn + c, 256); };
  auto hand_on = [&](bool final) {
    if (c == 0 || !final) tc::bar_arrive(kBarTurn + 1 - c, 256);
  };
  // key tile j's scores retired: the new row max, acc rescaled (no
  // product in flight), p = exp2(s - m), l, and round(p) into pa
  auto softmax = [&](int j) {
    mask_wide<kCausal, kFwdKeys, false>(s, j * kFwdKeys, wrow0, qrow, S, lane);
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kFwdKeys / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
      m_new[r] = fmaxf(m[r], tc::quad_max(mx));
      alpha[r] = fexp2(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < kWide / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * n + 2 * r] *= alpha[r];
        acc[4 * n + 2 * r + 1] *= alpha[r];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < kFwdKeys / 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * n + e] = fexp2(s[4 * n + e] - m_new[r]);
          ps += s[4 * n + e];
        }
      l[r] = l[r] * alpha[r] + tc::quad_sum(ps);
    }
#pragma unroll
    for (int kk = 0; kk < kFwdKeys / 16; ++kk)
      tc::c_to_a(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
  };

  // turn 0: key tile 0's scores
  wait_full(0, 0);
  turn();
  tc::fence_regs(s);
  tc::wgmma_fence();
  issue_s(0);
  tc::wgmma_commit();
  hand_on(false);
  tc::wgmma_wait<0>();
  tc::fence_regs(s);
  stage_release(&empty[slot(0, 0)], lane);
  softmax(0);
  // turns 1..last_c: key tile j - 1's p . v and key tile j's scores
#pragma unroll 1
  for (int j = 1; j <= last_c; ++j) {
    wait_full(0, j);
    wait_full(1, j - 1);
    turn();
    tc::fence_regs(s);
    tc::fence_regs(acc);
    tc::wgmma_fence();
    issue_pv(j - 1);
    issue_s(j);
    tc::wgmma_commit();
    hand_on(false);
    tc::wgmma_wait<0>();
    tc::fence_regs(s);
    tc::fence_regs(acc);
    stage_release(&empty[slot(1, j - 1)], lane);
    stage_release(&empty[slot(0, j)], lane);
    softmax(j);
  }
  // the last tile's p . v
  wait_full(1, last_c);
  turn();
  tc::fence_regs(acc);
  tc::wgmma_fence();
  issue_pv(last_c);
  tc::wgmma_commit();
  hand_on(last_c == last);
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);
  // consumer 0 past its causal frontier (key tile last, consumer 1's
  // alone) keeps taking its turns; no stage it skips is loaded again
  for (int j = last_c + 1; j <= last; ++j) {
    turn();
    hand_on(j == last);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= S) continue;
    const size_t base = ((size_t)b * S + row) * H + h;
    const float den = fmaxf(l[r], kTiny);
    const float rl = 1.f / den;
    if (kStats && (lane & 3) == 0) {
      m_out[base] = m[r] * kLn2;
      l_out[base] = l[r];
    }
#pragma unroll
    for (int n = 0; n < kWide / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + e;
        if (col >= D) continue;
        if (kStats)
          acc_out[base * D + col] = acc[4 * n + 2 * r + e];
        else
          o[base * D + col] =
              __float2bfloat16_rn(div_rn(acc[4 * n + 2 * r + e], den, rl));
      }
  }
}

// ---------------------------------------------------------------------------
// wide dq: grid (q tiles of kBq, B*H), the heaviest causal q tiles first.
// Q2 and dO of the CTA's 128 rows stay resident; consumer c owns rows
// [64c, 64c + 64) and streams 32-key (K, V) tiles through a three-stage
// ring up to its causal frontier: s = q2 . k^T and dp = do . v^T as
// m64n32k16 over the 16 steps of the head dim, ds in registers, and dq +=
// round(ds) . k as m64n256k16 over the tile's 2 steps of 16 keys.
// ---------------------------------------------------------------------------
constexpr int kDqWideStages = 3;
constexpr size_t kDqWideSmem =
    kDqWideStages * 2 * kStreamElems * sizeof(bf16)           // 96 KB
    + 2 * kBq * kWide * sizeof(bf16)                          // 128 KB
    + (2 * kDqWideStages + 1) * sizeof(uint64_t);             // 229,432 B

template <bool kCausal>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_dq_wide_tc_kernel(const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ m_in,
                            const float* __restrict__ l_in,
                            const float* __restrict__ dlt_in,
                            float* __restrict__ dq, int S, int H, int D,
                            float qscale, float scale, int vec) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // swizzled (K, V)
  bf16* Qs = ring + kDqWideStages * 2 * kStreamElems;   // q2, resident
  bf16* dOs = Qs + kBq * kWide;                          // resident
  uint64_t* full = reinterpret_cast<uint64_t*>(dOs + kBq * kWide);
  uint64_t* empty = full + kDqWideStages;
  uint64_t* resident = empty + kDqWideStages;   // Q2 and dO
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t ld = (size_t)H * D;
  const size_t head = (size_t)b * S * ld + (size_t)h * D;
  // causal: up to the key tile holding the q tile's last row
  const int last = (kCausal ? min(q0 + kBq, S) - 1 : S - 1) / kStream;
  // the thread's warpgroup, uniform over each warp as the compiler can
  // see: setmaxnreg needs the role branch warp-uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  auto stage = [&](int j) {
    return ring + (j % kDqWideStages) * 2 * kStreamElems;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDqWideStages; ++i) {
      tc::mbar_init(&full[i], 1);
      tc::mbar_init(&empty[i], 8);
    }
    tc::mbar_init(resident, 128);
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: dO and Q by cp.async, q2 made in place once Q has
    // landed; key tiles 0-2 in flight, then tile j + 3 into tile j's stage
    // once the consumers are done with it
    tc::setmaxnreg_dec<kProducerRegs>();
    const bool tma = vec != 0;
    auto load = [&](int j) {
      uint64_t* bar = &full[j % kDqWideStages];
      const int k0 = j * kStream;
      if (tma && threadIdx.x == 0)
        tc::mbar_expect_tx(bar, 2 * kStreamElems * sizeof(bf16));
      stream_tile(stage(j), &map_k, k + head, ld, k0, S, D, b, h, bar, tma,
                  threadIdx.x, 128);
      stream_tile(stage(j) + kStreamElems, &map_v, v + head, ld, k0, S, D,
                  b, h, bar, tma, threadIdx.x, 128);
      if (!tma) {
        tc::fence_proxy_async();
        tc::bar_sync(kBarProducer, 128);
        if (threadIdx.x == 0) tc::mbar_arrive(bar);
      }
    };
    produce_tile<kBq>(dOs, dout + head + q0 * ld, ld, S - q0, D, tma);
    produce_tile<kBq>(Qs, q + head + q0 * ld, ld, S - q0, D, tma);
    tc::cp_async_commit();
    for (int j = 0; j < kDqWideStages && j <= last; ++j) load(j);
    tc::cp_async_wait<0>();
    tc::bar_sync(kBarProducer, 128);   // every producer thread's copies
    scale_in_place(Qs, kBq * kWide, qscale, threadIdx.x, 128);
    tc::fence_proxy_async();
    tc::mbar_arrive(resident);
    if (tma && threadIdx.x != 0) return;   // thread 0 issues the rest
#pragma unroll 1
    for (int j = 0; j + kDqWideStages <= last; ++j) {
      tc::mbar_wait(&empty[j % kDqWideStages], (j / kDqWideStages) & 1);
      load(j + kDqWideStages);
    }
    return;
  }

  // the consumers
  tc::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int ct = threadIdx.x & 127;
  const int lane = ct & 31;
  const int wrow0 = q0 + 64 * c + (ct >> 5) * 16;   // the warp's first row
  const int qrow = wrow0 + (lane >> 2);
  const int last_c = kCausal ? min(last, (q0 + 64 * c + 63) / kStream) : last;
  float mlog2[2], lden[2], rl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    const size_t base = ((size_t)b * S + row) * H + h;
    mlog2[r] = row < S ? m_in[base] * kLog2e : 0.f;
    lden[r] = row < S ? fmaxf(l_in[base], kTiny) : 1.f;
    rl[r] = 1.f / lden[r];
    dl[r] = row < S ? dlt_in[base] : 0.f;
  }
  const bf16* Qw = Qs + tc::il_off<kWide>(64 * c, 0);   // the rows it owns
  const bf16* dOw = dOs + tc::il_off<kWide>(64 * c, 0);
  float acc[2 * kWide / 4], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 2 * kWide / 4; ++i) acc[i] = 0.f;
  tc::fence_regs(acc);
  tc::mbar_wait(resident, 0);

  for (int j = 0; j <= last; ++j) {
    tc::mbar_wait(&full[j % kDqWideStages], (j / kDqWideStages) & 1);
    const bf16* Kt = stage(j);
    if (j <= last_c) {
      // s and dp, issued behind the last tile's dq products, all retired
      tc::fence_regs(s);
      tc::fence_regs(dp);
      tc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWide / 16; ++ks)
        tc::wgmma_m64n32k16_ss<0>(s, desc_k<kWide>(Qw, ks),
                                  desc_sw_k(Kt, ks), ks);
#pragma unroll
      for (int ks = 0; ks < kWide / 16; ++ks)
        tc::wgmma_m64n32k16_ss<0>(dp, desc_k<kWide>(dOw, ks),
                                  desc_sw_k(Kt + kStreamElems, ks), ks);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(s);
      tc::fence_regs(dp);
      tc::fence_regs(acc);
      if (j >= 1) stage_release(&empty[(j - 1) % kDqWideStages], lane);
      // ds = p * (dp - dlt), rounded, and acc += ds . k (K read MN-major)
      mask_wide<kCausal, kStream, true>(s, j * kStream, wrow0, qrow, S,
                                        lane);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        const float p = div_rn(fexp2(s[i] - mlog2[r]), lden[r], rl[r]);
        s[i] = p * (dp[i] - dl[r]);   // ds
      }
      uint32_t da[kStream / 16][4];
#pragma unroll
      for (int kk = 0; kk < kStream / 16; ++kk)
        tc::c_to_a(da[kk], &s[8 * kk], &s[8 * kk + 4]);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStream / 16; ++kk)
        tc::wgmma_m64n256k16_rs<1>(acc, da[kk], desc_sw_mn(Kt, kk), 1);
      tc::wgmma_commit();
    } else {
      // past this warpgroup's causal frontier: it only hands stages back
      tc::wgmma_wait<0>();
      tc::fence_regs(acc);
      stage_release(&empty[(j - 1) % kDqWideStages], lane);
    }
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= S) continue;
    const size_t base = ((size_t)b * S + row) * H + h;
#pragma unroll
    for (int n = 0; n < kWide / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + e;
        if (col < D) dq[base * D + col] = acc[4 * n + 2 * r + e] * scale;
      }
  }
}

// ---------------------------------------------------------------------------
// wide dk/dv: grid (key tiles of 64, B*H), key tile 0 (the most q tiles
// under causal) first.  K and V of the CTA's 64 keys stay resident, and
// the 32-row q tiles from the first that sees the key tile stream through
// a four-stage ring: the producer's warp 0 issues their Q and dO boxes
// (TMA) up to four tiles ahead, and its warps 1-3 make q2 in place and
// load the tile's statistics as each lands.  The two consumers split the work by product, so
// each (q, key) pair's s^T and dp^T are computed once in the CTA (8 D
// flops a pair):
//   * warpgroup 1: s^T = k . q2^T (m64n32k16), p = exp2(s - m) / l in
//     its registers, p (f32) to shared memory for warpgroup 2, and dv +=
//     round(p)^T . do over all 256 columns (m64n256k16, A from registers);
//   * warpgroup 2: dp^T = v . do^T, ds = p (dp - dlt) with warpgroup 1's
//     p, and dk += round(ds)^T . q2 over all 256 columns.
// p passes through a double buffer on named barriers (full: warpgroup 1
// arrives, 2 syncs; empty: the other way), so warpgroup 1 may run up to
// two q tiles ahead and neither holds the other in lock-step.
// ---------------------------------------------------------------------------
constexpr int kDkvWideStages = 4;
constexpr int kStatFloats = 4 * kStream;   // m, l, dlt and 1/l of a tile
constexpr int kPElems = kTile * kStream;   // f32 p of a tile
constexpr int kBarPFull = 2;               // + buffer (2, 3)
constexpr int kBarPEmpty = 4;              // + buffer (4, 5)
constexpr size_t kDkvWideSmem =
    2 * kWideTileElems * sizeof(bf16)                      // K, V: 64 KB
    + kDkvWideStages * 2 * kStreamElems * sizeof(bf16)     // Q, dO: 128 KB
    + kDkvWideStages * kStatFloats * sizeof(float)         // 2 KB
    + 2 * kPElems * sizeof(float)                          // p: 16 KB
    + (3 * kDkvWideStages + 1) * sizeof(uint64_t);         // 215,144 B

// The wide dk/dv's masked p of one transposed tile (the thread's keys
// krow, krow + 8 x the tile's 32 q rows from q0), in place of s: masked
// entries (key past the q row under causal, or either past S) get s =
// -1e30, so p = 0, and only tiles that cross the diagonal or S test
// anything; p = exp2(s - m log2(e)) / max(l, 1e-30), unrounded, per q
// column from the stage's prepared statistics ``st``.
template <bool kCausal>
__device__ __forceinline__ void dkv_wide_p(float s[16], const float* st,
                                           int krow, int q0, int S,
                                           int lane) {
  if ((kCausal && krow - (lane >> 2) + 15 > q0) || q0 + kStream > S ||
      krow - (lane >> 2) + 16 > S) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int kp = krow + 8 * ((e >> 1) & 1);
      const int qp = q0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
      if (qp >= S || kp >= S || (kCausal && kp > qp)) s[e] = kNegInf;
    }
  }
#pragma unroll
  for (int j = 0; j < kStream / 8; ++j) {
    const int c = j * 8 + 2 * (lane & 3);
    const float2 ml = *reinterpret_cast<const float2*>(st + c);
    const float2 den = *reinterpret_cast<const float2*>(st + kStream + c);
    const float2 rl = *reinterpret_cast<const float2*>(st + 3 * kStream + c);
#pragma unroll
    for (int e = 4 * j; e < 4 * j + 4; ++e) {
      const bool odd = e & 1;
      s[e] = div_rn(fexp2(s[e] - (odd ? ml.y : ml.x)), odd ? den.y : den.x,
                    odd ? rl.y : rl.x);
    }
  }
}

// the wide stores of one consumer's 64 x 256 accumulator (times ``mul``)
// into rows krow, krow + 8 of out
__device__ __forceinline__ void store_wide_rows(float* __restrict__ out,
                                                const float (&a)[128],
                                                float mul, int krow, int S,
                                                int H, int D, int b, int h,
                                                int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + 8 * r;
    if (row >= S) continue;
    const size_t base = ((size_t)b * S + row) * H + h;
#pragma unroll
    for (int n = 0; n < kWide / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * (lane & 3) + e;
        if (col < D) out[base * D + col] = a[4 * n + 2 * r + e] * mul;
      }
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_dkv_wide_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ m_in,
                             const float* __restrict__ l_in,
                             const float* __restrict__ dlt_in,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int S, int H, int D, float qscale,
                             float inv_log2e, int vec) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // swizzled (Q, dO)
  bf16* Ks = ring + kDkvWideStages * 2 * kStreamElems;   // resident
  bf16* Vs = Ks + kWideTileElems;
  float* statbuf = reinterpret_cast<float*>(Vs + kWideTileElems);
  float* pbuf = statbuf + kDkvWideStages * kStatFloats;
  uint64_t* landed = reinterpret_cast<uint64_t*>(pbuf + 2 * kPElems);
  uint64_t* full = landed + kDkvWideStages;
  uint64_t* empty = full + kDkvWideStages;
  uint64_t* resident = empty + kDkvWideStages;   // K and V
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int k0 = blockIdx.x * kTile;
  const size_t ld = (size_t)H * D;
  const size_t head = (size_t)b * S * ld + (size_t)h * D;
  // causal: from the q tile holding the key tile's first key
  const int first = kCausal ? k0 / kStream : 0;
  const int n = (S + kStream - 1) / kStream - first;
  // the thread's warpgroup, uniform over each warp as the compiler can
  // see: setmaxnreg needs the role branch warp-uniform
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  // stage i's q tile (q2 once prepared) and dO, and its statistics: m
  // (m * log2(e) once prepared), max(l, 1e-30), dlt, 1 / max(l, 1e-30)
  auto qs = [&](int i) {
    return ring + (i % kDkvWideStages) * 2 * kStreamElems;
  };
  auto stats = [&](int i) {
    return statbuf + (i % kDkvWideStages) * kStatFloats;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDkvWideStages; ++i) {
      // TMA's bytes and thread 0's arrival, or warp 0's 32 arrivals
      tc::mbar_init(&landed[i], vec ? 1 : 32);
      tc::mbar_init(&full[i], 96);
      tc::mbar_init(&empty[i], 8);
    }
    tc::mbar_init(resident, 128);
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer.  All 128 threads load K and V (cp.async); then warp 0
    // streams the q tiles' Q and dO into the ring, up to four tiles ahead,
    // and warps 1-3 make each landed tile's q2 and statistics in place, so
    // neither job waits on the other
    tc::setmaxnreg_dec<kProducerRegs>();
    const bool tma = vec != 0;
    const int t = threadIdx.x;
    produce_tile<kTile>(Ks, k + head + k0 * ld, ld, S - k0, D, tma);
    produce_tile<kTile>(Vs, v + head + k0 * ld, ld, S - k0, D, tma);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    tc::fence_proxy_async();
    tc::mbar_arrive(resident);
    if (t < 32) {
      if (tma && t != 0) return;   // thread 0 issues every TMA box
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const int sidx = i % kDkvWideStages;
        if (i >= kDkvWideStages)   // tile i - 4 has left the stage
          tc::mbar_wait(&empty[sidx], (i / kDkvWideStages - 1) & 1);
        const int r0 = (first + i) * kStream;
        if (tma)
          tc::mbar_expect_tx(&landed[sidx], 2 * kStreamElems * sizeof(bf16));
        stream_tile(qs(i), &map_q, q + head, ld, r0, S, D, b, h,
                    &landed[sidx], tma, t, 32);
        stream_tile(qs(i) + kStreamElems, &map_do, dout + head, ld, r0, S,
                    D, b, h, &landed[sidx], tma, t, 32);
        if (!tma) {
          tc::fence_proxy_async();
          tc::mbar_arrive(&landed[sidx]);
        }
      }
      return;
    }
    // warps 1-3 (p = 0..95): q2 = round_bf16(q * qscale) in place, and
    // the statistics, one a thread: m * log2(e), max(l, 1e-30) and its
    // reciprocal, dlt
    const int pt = t - 32;
    const int which = pt / kStream;
    const int r = pt % kStream;
    const float* src = which == 0 ? m_in : which == 1 ? l_in : dlt_in;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int sidx = i % kDkvWideStages;
      const int row = (first + i) * kStream + r;
      // the statistic's load runs under the wait and the q2 pass
      const float x = row < S ? src[((size_t)b * S + row) * H + h] : 0.f;
      tc::mbar_wait(&landed[sidx], (i / kDkvWideStages) & 1);
      if (i >= kDkvWideStages)   // the consumers have read tile i - 4's
        tc::mbar_wait(&empty[sidx], (i / kDkvWideStages - 1) & 1);
      scale_in_place(qs(i), kStreamElems, qscale, pt, 96);
      float* st = stats(i);
      if (which == 0) {
        st[r] = x * kLog2e;
      } else if (which == 1) {
        const float den = fmaxf(x, kTiny);
        st[kStream + r] = den;
        st[3 * kStream + r] = 1.f / den;
      } else {
        st[2 * kStream + r] = x;
      }
      tc::fence_proxy_async();
      tc::mbar_arrive(&full[sidx]);
    }
    return;
  }

  tc::setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x & 127;
  const int lane = ct & 31;
  // the thread's keys: rows g and g + 8 of its warp's 16 (r = 0, 1)
  const int krow = k0 + (ct >> 5) * 16 + (lane >> 2);
  float acc[2 * kWide / 4], sc[16];   // dv and s^T, or dk and dp^T
#pragma unroll
  for (int i = 0; i < 2 * kWide / 4; ++i) acc[i] = 0.f;
  tc::fence_regs(acc);
  tc::mbar_wait(resident, 0);

  for (int i = 0; i < n; ++i) {
    const int buf = i % 2;
    float* pb = pbuf + buf * kPElems;
    tc::mbar_wait(&full[i % kDkvWideStages], (i / kDkvWideStages) & 1);
    const bf16* Qt = qs(i);
    const bf16* dOt = Qt + kStreamElems;
    const float* st = stats(i);
    // warpgroup 1: s^T = k . q2^T; 2: dp^T = v . do^T (64 keys x 32 q
    // rows), issued behind the last tile's dv (dk) products, all retired
    const bf16* A = wg == 1 ? Ks : Vs;
    const bf16* B = wg == 1 ? Qt : dOt;
    tc::fence_regs(sc);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWide / 16; ++ks)
      tc::wgmma_m64n32k16_ss<0>(sc, desc_k<kWide>(A, ks), desc_sw_k(B, ks),
                                ks);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(sc);
    tc::fence_regs(acc);
    if (i >= 1) stage_release(&empty[(i - 1) % kDkvWideStages], lane);
    if (wg == 1) {
      dkv_wide_p<kCausal>(sc, st, krow, (first + i) * kStream, S, lane);
      if (i >= 2) tc::bar_sync(kBarPEmpty + buf, 256);
#pragma unroll
      for (int e = 0; e < 16; ++e) pb[e * 128 + ct] = sc[e];
      tc::bar_arrive(kBarPFull + buf, 256);
    } else {
      tc::bar_sync(kBarPFull + buf, 256);
#pragma unroll
      for (int j = 0; j < kStream / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(
            st + 2 * kStream + j * 8 + 2 * (lane & 3));
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e)
          sc[e] = pb[e * 128 + ct] * (sc[e] - (e & 1 ? dl.y : dl.x));  // ds
      }
      if (i + 2 < n) tc::bar_arrive(kBarPEmpty + buf, 256);
    }
    // dv += round(p)^T . do, or dk += round(ds)^T . q2 (q rows reduced: do
    // and q2 read MN-major), issued; retired with the next tile's scores
    uint32_t a[kStream / 16][4];
#pragma unroll
    for (int kk = 0; kk < kStream / 16; ++kk)
      tc::c_to_a(a[kk], &sc[8 * kk], &sc[8 * kk + 4]);
    const bf16* Bt = wg == 1 ? dOt : Qt;
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStream / 16; ++kk)
      tc::wgmma_m64n256k16_rs<1>(acc, a[kk], desc_sw_mn(Bt, kk), 1);
    tc::wgmma_commit();
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);
  if (wg == 1)
    store_wide_rows(dv, acc, 1.f, krow, S, H, D, b, h, lane);
  else
    store_wide_rows(dk, acc, inv_log2e, krow, S, H, D, b, h, lane);
}

// 16-byte copies need D a multiple of 8 and every tensor 16-byte aligned
bool vec_ok(int D, std::initializer_list<const void*> ptrs) {
  if (D % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// the wide kernels' streamed tensors as TMA maps of ``box_rows``-row
// boxes, where the 16-byte copies (and so TMA) can take them
cudaError_t stream_maps(CUtensorMap* a, CUtensorMap* b, const void* x,
                        const void* y, int B, int S, int H, int D,
                        bool vec, uint32_t box_rows = kStream) {
  if (!vec) return cudaSuccess;
  const cudaError_t err = tc::encode_heads_map(a, x, B, S, H, D, box_rows);
  return err != cudaSuccess ? err
                            : tc::encode_heads_map(b, y, B, S, H, D,
                                                   box_rows);
}

// the launchers: the narrow kernels for D <= 128, the wide ones (kWideD)
// for 128 < D <= 256
template <bool kCausal, bool kStats, bool kWideD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* acc, void* m, void* l, int B, int S, int H, int D,
                float qscale, cudaStream_t st) {
  static bool ready = false;
  const bool vec = vec_ok(D, {q, k, v});
  const dim3 grid((S + kBq - 1) / kBq, B * H);
  if constexpr (kWideD) {
    auto kernel = flash_fwd_wide_tc_kernel<kCausal, kStats>;
    cudaError_t err = allow_smem(kernel, kFwdWideSmem, &ready);
    CUtensorMap map_q = {}, map_k = {}, map_v = {};
    if (err == cudaSuccess && vec)
      err = tc::encode_heads_map(&map_q, q, B, S, H, D, kBq);
    if (err == cudaSuccess)
      err = stream_maps(&map_k, &map_v, k, v, B, S, H, D, vec, kFwdKeys);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWideThreads, kFwdWideSmem, st>>>(
        map_q, map_k, map_v, static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(acc),
        static_cast<float*>(m), static_cast<float*>(l), S, H, D, qscale,
        vec);
    return cudaGetLastError();
  }
  auto kernel = flash_fwd_tc_kernel<kCausal, kStats>;
  cudaError_t err = allow_smem(kernel, kFwdSmem, &ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kFwdSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), S, H, D, qscale, vec);
  return cudaGetLastError();
}

template <bool kCausal, bool kWideD>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* m, const void* l,
                   const void* dlt, void* dq, int B, int S, int H, int D,
                   float qscale, float scale, cudaStream_t st) {
  static bool ready = false;
  const bool vec = vec_ok(D, {q, k, v, dout});
  const dim3 grid((S + kBq - 1) / kBq, B * H);
  if constexpr (kWideD) {
    auto kernel = flash_dq_wide_tc_kernel<kCausal>;
    cudaError_t err = allow_smem(kernel, kDqWideSmem, &ready);
    CUtensorMap map_k = {}, map_v = {};
    if (err == cudaSuccess)
      err = stream_maps(&map_k, &map_v, k, v, B, S, H, D, vec);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kWideThreads, kDqWideSmem, st>>>(
        map_k, map_v, static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(dlt),
        static_cast<float*>(dq), S, H, D, qscale, scale, vec);
    return cudaGetLastError();
  }
  auto kernel = flash_dq_tc_kernel<kCausal>;
  cudaError_t err = allow_smem(kernel, kDqSmem, &ready);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kDqSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dlt), static_cast<float*>(dq), S, H, D,
      qscale, scale, vec);
  return cudaGetLastError();
}

template <bool kCausal, bool kWideD>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* m, const void* l,
                    const void* dlt, void* dk, void* dv, int B, int S, int H,
                    int D, float qscale, float inv_log2e, cudaStream_t st) {
  static bool ready = false;
  const bool vec = vec_ok(D, {q, k, v, dout});
  if constexpr (kWideD) {
    auto kernel = flash_dkv_wide_tc_kernel<kCausal>;
    cudaError_t err = allow_smem(kernel, kDkvWideSmem, &ready);
    CUtensorMap map_q = {}, map_do = {};
    if (err == cudaSuccess)
      err = stream_maps(&map_q, &map_do, q, dout, B, S, H, D, vec);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kTile - 1) / kTile, B * H);
    kernel<<<grid, kWideThreads, kDkvWideSmem, st>>>(
        map_q, map_do, static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(dlt),
        static_cast<float*>(dk), static_cast<float*>(dv), S, H, D, qscale,
        inv_log2e, vec);
    return cudaGetLastError();
  }
  auto kernel = flash_dkv_tc_kernel<kCausal>;
  cudaError_t err = allow_smem(kernel, kDkvSmem, &ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBq - 1) / kBq, B * H);
  kernel<<<grid, kThreads, kDkvSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(dlt), static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, D, qscale, inv_log2e, vec);
  return cudaGetLastError();
}

template <bool kWideD>
cudaError_t fwd_route(const void* q, const void* k, const void* v, void* o,
                      void* acc, void* m, void* l, int B, int S, int H,
                      int D, bool causal, bool stats, float qscale,
                      cudaStream_t st) {
  if (causal)
    return stats ? fwd<true, true, kWideD>(q, k, v, o, acc, m, l, B, S, H,
                                           D, qscale, st)
                 : fwd<true, false, kWideD>(q, k, v, o, acc, m, l, B, S, H,
                                            D, qscale, st);
  return stats ? fwd<false, true, kWideD>(q, k, v, o, acc, m, l, B, S, H, D,
                                          qscale, st)
               : fwd<false, false, kWideD>(q, k, v, o, acc, m, l, B, S, H,
                                           D, qscale, st);
}

}  // namespace

// the bf16 routes of dtx_flash_fwd, dtx_flash_bwd_dq and dtx_flash_bwd_dkv
cudaError_t flash_fwd_bf16(const void* q, const void* k, const void* v,
                           void* o, void* acc, void* m, void* l, int B,
                           int S, int H, int D, bool causal, bool stats,
                           float qscale, cudaStream_t st) {
  return D > tc::kTileCols
             ? fwd_route<true>(q, k, v, o, acc, m, l, B, S, H, D, causal,
                               stats, qscale, st)
             : fwd_route<false>(q, k, v, o, acc, m, l, B, S, H, D, causal,
                                stats, qscale, st);
}

cudaError_t flash_dq_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const void* m, const void* l,
                          const void* dlt, void* dq, int B, int S, int H,
                          int D, bool causal, float qscale, float scale,
                          cudaStream_t st) {
  if (D > tc::kTileCols)
    return causal ? bwd_dq<true, true>(q, k, v, dout, m, l, dlt, dq, B, S, H,
                                       D, qscale, scale, st)
                  : bwd_dq<false, true>(q, k, v, dout, m, l, dlt, dq, B, S,
                                        H, D, qscale, scale, st);
  return causal ? bwd_dq<true, false>(q, k, v, dout, m, l, dlt, dq, B, S, H,
                                      D, qscale, scale, st)
                : bwd_dq<false, false>(q, k, v, dout, m, l, dlt, dq, B, S, H,
                                       D, qscale, scale, st);
}

cudaError_t flash_dkv_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* m, const void* l,
                           const void* dlt, void* dk, void* dv, int B, int S,
                           int H, int D, bool causal, float qscale,
                           float inv_log2e, cudaStream_t st) {
  if (D > tc::kTileCols)
    return causal ? bwd_dkv<true, true>(q, k, v, dout, m, l, dlt, dk, dv, B,
                                        S, H, D, qscale, inv_log2e, st)
                  : bwd_dkv<false, true>(q, k, v, dout, m, l, dlt, dk, dv, B,
                                         S, H, D, qscale, inv_log2e, st);
  return causal ? bwd_dkv<true, false>(q, k, v, dout, m, l, dlt, dk, dv, B,
                                       S, H, D, qscale, inv_log2e, st)
                : bwd_dkv<false, false>(q, k, v, dout, m, l, dlt, dk, dv, B,
                                        S, H, D, qscale, inv_log2e, st);
}

}  // namespace dtx
