// The bf16 GEMM with a fused bias + activation epilogue on Hopper's
// tensor cores (sm_90a), which the MLP forward (mlp_forward.cu) launches
// once per bf16 layer:
//   z   = A @ W + bias                  (bf16 operands, f32 sum, f32 bias)
//   out = round_to_OutT(act(z))         (OutT bf16 for a hidden layer;
//                                        f32 and act = identity for the
//                                        logits)
// for A [M, K] (K contiguous), W [K, N] (N contiguous), bias [N] f32 and
// out [M, N]: the JAX _layer (ops/pallas_fused.py), with the activation
// and rounding of common.cuh's gemm_bias_act_kernel, which keeps the f32
// layers and the grouped FFN.
//
// What bounds it on an H100: operations at the wide MLP's shapes (8192
// rows, 784-4096-4096-10: 328 GFLOP against ~0.2 GB, far above the
// card's ~295 bf16 operations per byte).  The CUDA-core GEMM it replaces
// for bf16 ran at ~25 TFLOP/s: scalar f32 FMA over tiles widened to f32,
// synchronous loads, no overlap.
//
// The design:
//   * a CTA of two warpgroups owns a 128 x 256 output tile, each
//     warpgroup 64 rows; every product is a warpgroup MMA, wgmma
//     m64n128k16 bf16 -> f32, two a 16-deep step (the tile's two
//     128-column halves), with the 64 x 256 f32 sum in registers;
//   * K runs in 64-deep slices through a ring of four stages, two
//     slices ahead (48 KB a stage, 192 KB in all, one CTA per SM), and
//     one slice's products stay in flight under the next slice's
//     barrier; A is read k-major, W MN-major through the descriptor's
//     transpose bit, both as they lie in memory;
//   * the tiles arrive 128-byte swizzled: by TMA where a row's width is
//     a multiple of 8 and the tensor 16-byte aligned (A [128][64] in one
//     box, W in four [64][64] boxes, completing on the stage's
//     mbarrier), otherwise by 4-byte cp.async copies of column pairs
//     (even widths: the logits' 10, 100, 300) or guarded scalar loads
//     (odd: 129), written to the same swizzled places, on the same
//     tensor cores; rows, columns and a ragged last K slice (K = 784)
//     are zero-filled;
//   * the epilogue works on the accumulator layout: bias, activation
//     and rounding per element, stores guarded at M and N (pairs of
//     neighbouring columns where N is even).
// Why TMA: 256 threads each copying 16 bytes with cp.async into the
// no-swizzle core-matrix tiles of tc.cuh (the flash kernels' feed) move
// a few TB/s on an H100, several times less than TMA boxes from L2
// (scripts/torch_copy_bench.py); fed that way, this GEMM's copies and
// not its products set its pace (PERF.md).
// Registers and spills (-Xptxas -v) are printed by chip_smoke.py and
// kept in PERF.md.  Internal linkage: each source that includes this
// header gets its own copy of the kernel.
#pragma once

#include "common.cuh"
#include "tc.cuh"

namespace dtx {
namespace {

constexpr int kTcBM = 128;   // rows of a CTA's tile (two warpgroups)
constexpr int kTcBN = 256;   // columns of a CTA's tile (two halves)
constexpr int kTcBK = 64;    // depth of a K slice: one 128-byte row
constexpr int kTcThreads = 256;
constexpr int kTcStages = 4;
constexpr int kTcAhead = kTcStages - 2;    // slices in flight
constexpr int kTcAElems = kTcBM * kTcBK;   // [128][64], 16 KB
constexpr int kTcBox = kTcBK * 64;         // one [64 K][64 N] box of W
constexpr int kTcStageElems = kTcAElems + kTcBN / 64 * kTcBox;   // 48 KB
// the ring, its full barriers, and room to align the ring to the
// 1024-byte swizzle atom
constexpr size_t kTcGemmSmem =
    kTcStages * kTcStageElems * sizeof(__nv_bfloat16) +
    kTcStages * sizeof(uint64_t) + 1024;

// how an operand's rows reach shared memory
constexpr int kCopyScalar = 0;   // guarded loads, complete on return
constexpr int kCopyPairs = 1;    // 4-byte cp.async (ld even)
constexpr int kCopyTma = 2;      // TMA boxes (ld a multiple of 8)

// Rows [0, kRows) x columns [0, kCols) of a matrix (row r at src + r *
// ld; rows >= ``rows`` and columns >= ``cols`` zero) into the 128-byte
// swizzled layout TMA writes: kCols / 64 boxes of [kRows][64], one after
// the other.  The copies of the operands TMA cannot take.
template <int kRows, int kCols>
__device__ __forceinline__ void copy_sw128(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           size_t ld, int rows, int cols,
                                           bool pairs) {
  if (pairs) {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kRows * kCols / 2;
         idx += kTcThreads) {
      const int r = idx / (kCols / 2);
      const int c = 2 * (idx % (kCols / 2));
      const bool valid = r < rows && c < cols;
      tc::cp_async4(dst + (c >> 6) * kRows * 64 + tc::sw128_off(r, c & 63),
                    valid ? src + r * ld + c : src, valid);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kRows * kCols; idx += kTcThreads) {
    const int r = idx / kCols;
    const int c = idx % kCols;
    dst[(c >> 6) * kRows * 64 + tc::sw128_off(r, c & 63)] =
        r < rows && c < cols ? src[r * ld + c] : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// bias + activation + rounding of one 128-column accumulator half
template <typename OutT>
__device__ __forceinline__ void epilogue(const float (&acc)[64],
                                         const float* __restrict__ bias,
                                         OutT* __restrict__ out, int M,
                                         int N, int row, int n0, int lane,
                                         int act) {
  const bool pairs = N % 2 == 0;   // 4- / 8-byte aligned column pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= M) continue;
    OutT* o = out + (size_t)(row + 8 * r) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + j * 8 + 2 * (lane & 3);
      if (col >= N) continue;
      const float z0 = activate(acc[4 * j + 2 * r] + bias[col], act);
      if (col + 1 < N) {
        const float z1 = activate(acc[4 * j + 2 * r + 1] + bias[col + 1],
                                  act);
        if (pairs) {
          store_pair(o + col, z0, z1);
          continue;
        }
        o[col + 1] = from_f32<OutT>(z1);
      }
      o[col] = from_f32<OutT>(z0);
    }
  }
}

// grid (ceil(N / 256), ceil(M / 128)); copy_a / copy_w: how A's and W's
// rows arrive (kCopy*); map_a / map_w: their tensor maps where TMA
// copies them (A [M][K] in boxes of [128][64], W [K][N] in boxes of
// [64][64])
template <typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
    gemm_bias_act_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                            const __grid_constant__ CUtensorMap map_w,
                            const __nv_bfloat16* __restrict__ A,
                            const __nv_bfloat16* __restrict__ W,
                            const float* __restrict__ bias,
                            OutT* __restrict__ out, int M, int N, int K,
                            int act, int copy_a, int copy_w) {
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTcStages *
                                               kTcStageElems);
  const int m0 = blockIdx.y * kTcBM;
  const int n0 = blockIdx.x * kTcBN;
  const int wg0 = (threadIdx.x >> 7) * 64;   // the warpgroup's rows
  const int row0 = (threadIdx.x >> 5) * 16;  // the warp's rows
  const int lane = threadIdx.x & 31;
  const int nk = (K + kTcBK - 1) / kTcBK;
  const bool tma_a = copy_a == kCopyTma;
  const bool tma_w = copy_w == kCopyTma;
  const uint32_t tx_bytes = (tma_a ? kTcAElems * sizeof(bf16) : 0) +
                            (tma_w ? kTcBN / 64 * kTcBox * sizeof(bf16) : 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kTcStages; ++i) tc::mbar_init(&full[i], 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  // slice t in stage t % kTcStages: A [128][64], then W's four [64][64]
  // boxes (columns n0, n0 + 64, ...)
  auto a_tile = [&](int t) { return ring + (t % kTcStages) * kTcStageElems; };
  auto load = [&](int t) {
    const int k0 = t * kTcBK;
    bf16* a = a_tile(t);
    bf16* w = a + kTcAElems;
    if (threadIdx.x == 0 && tx_bytes) {
      uint64_t* bar = &full[t % kTcStages];
      tc::mbar_expect_tx(bar, tx_bytes);
      if (tma_a) tc::tma_load_2d(a, &map_a, k0, m0, bar);
      if (tma_w)
        for (int b = 0; b < kTcBN / 64; ++b)
          tc::tma_load_2d(w + b * kTcBox, &map_w, n0 + 64 * b, k0, bar);
    }
    if (!tma_a)
      copy_sw128<kTcBM, kTcBK>(a, A + (size_t)m0 * K + k0, K, M - m0,
                               K - k0, copy_a == kCopyPairs);
    if (!tma_w)
      copy_sw128<kTcBK, kTcBN>(w, W + (size_t)k0 * N + n0, N,
                               K - k0, N - n0, copy_w == kCopyPairs);
  };

#pragma unroll
  for (int t = 0; t < kTcAhead; ++t) {
    if (t < nk) load(t);
    tc::cp_async_commit();
  }
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  tc::fence_regs(acc0);
  tc::fence_regs(acc1);

  for (int t = 0; t < nk; ++t) {
    tc::cp_async_wait<kTcAhead - 1>();   // this thread's copies of slice t
    if (tx_bytes) tc::mbar_wait(&full[t % kTcStages], (t / kTcStages) & 1);
    tc::fence_proxy_async();
    // slice t visible to all; every warpgroup has retired slice t - 2,
    // whose stage slice t + kTcAhead refills
    __syncthreads();
    if (t + kTcAhead < nk) load(t + kTcAhead);
    tc::cp_async_commit();
    const bf16* At = a_tile(t) + wg0 * kTcBK;
    const bf16* Wt = a_tile(t) + kTcAElems;
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      // A k-major: 16 columns = 32 bytes along the swizzled rows; W
      // MN-major: 16 rows of K, the next 64 columns a box (8 KB) away
      const uint64_t da = tc::gmma_desc_sw128(At + 16 * ks, 16);
      tc::wgmma_m64n128k16_ss<1>(
          acc0, da,
          tc::gmma_desc_sw128(Wt + 16 * 64 * ks, kTcBox * sizeof(bf16)), 1);
      tc::wgmma_m64n128k16_ss<1>(
          acc1, da,
          tc::gmma_desc_sw128(Wt + 2 * kTcBox + 16 * 64 * ks,
                              kTcBox * sizeof(bf16)),
          1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();   // slice t - 1's products
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc0);
  tc::fence_regs(acc1);

  const int row = m0 + row0 + (lane >> 2);
  epilogue(acc0, bias, out, M, N, row, n0, lane, act);
  epilogue(acc1, bias, out, M, N, row, n0 + 128, lane, act);
}

}  // namespace
}  // namespace dtx
