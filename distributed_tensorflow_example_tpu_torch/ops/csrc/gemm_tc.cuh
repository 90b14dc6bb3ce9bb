// The bf16 GEMM with a fused bias + activation epilogue on Hopper's
// tensor cores (sm_90a), batched over a leading index: for e in [0, E),
//   z[e]   = A[e] @ W[e] + bias[e]      (bf16 operands, f32 sum, f32 bias)
//   out[e] = round_to_OutT(act(z[e]))   (OutT bf16 for a hidden layer;
//                                        f32 and act = identity for the
//                                        logits or an FFN's output)
// for A [E, M, K] (K contiguous), W [E, K, N] (N contiguous), bias
// [E, N] f32 and out [E, M, N]; kWithZ also writes the f32 z to z_out
// [E, M, N] (the grouped FFN's training form).  The MLP forward
// (mlp_forward.cu) launches it with E = 1 once per bf16 layer, the
// grouped FFN (grouped_ffn.cu) twice per call with E experts.  The
// activation and rounding are those of common.cuh's gemm_bias_act_kernel,
// which keeps the f32 layers and the f32 grouped FFN.
//
// What bounds it on an H100: operations at the wide MLP's and the MoE
// trainer's shapes (328 and 344 GFLOP against ~0.2 and ~1.1 GB, far
// above the card's ~295 bf16 operations per byte); bytes where M is a
// handful of rows (decode: the weights are the traffic).  The CUDA-core
// GEMM it replaces for bf16 ran at ~25 TFLOP/s: scalar f32 FMA over
// tiles widened to f32, synchronous loads, no overlap.
//
// The design:
//   * a CTA of two warpgroups owns a 128 x (128 kHalves) output tile of
//     one matrix of the batch (blockIdx.z), each warpgroup 64 rows; every
//     product is a warpgroup MMA, wgmma m64n128k16 bf16 -> f32, kHalves a
//     16-deep step (the tile's 128-column halves), with the 64 x 128
//     kHalves f32 sum in registers;
//   * K runs in 64-deep slices through a ring of four stages, two
//     slices ahead (48 KB a stage at kHalves 2, 32 KB at 1), and one
//     slice's products stay in flight under the next slice's barrier;
//     A is read k-major, W MN-major through the descriptor's transpose
//     bit, both as they lie in memory;
//   * the tiles arrive 128-byte swizzled: by TMA where a row's width is
//     a multiple of 8 and the tensor 16-byte aligned, through a 3-D
//     tensor map (inner, rows, batch index), so a box is zero-filled at
//     its own matrix's row and K edges and never reads the next one's
//     rows (A [128][64] in one box, W in 2 kHalves [64][64] boxes,
//     completing on the stage's mbarrier); otherwise by 4-byte cp.async
//     copies of column pairs (even widths) or guarded scalar loads (odd),
//     written to the same swizzled places, on the same tensor cores;
//   * split-K: with ``splits`` > 1, blockIdx.z = e * splits + s and the
//     CTA sums only its s-th share of the K slices, writing the f32 sum
//     (no bias, identity) to out + (s * E + e) * M * N; split_k_sum_kernel
//     then adds the shares in the order s = 0, 1, ... (so a result is the
//     same bits from run to run; no atomics) and applies the epilogue.
//     It fills the card where M x N has too few tiles (decode rows);
//   * the epilogue goes through shared memory: the accumulators are
//     staged as an f32 tile over the drained ring, then a loop that is
//     not unrolled applies bias, activation and rounding four columns at
//     a time (z stored first under kWithZ), stores guarded at M and N
//     and whole rows of a warp's 128 columns.
// The pipeline is static: no wgmma under a runtime branch (kHalves and
// kWithZ are template arguments), or ptxas serializes the products.
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

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace dtx {
namespace {

constexpr int kTcBM = 128;   // rows of a CTA's tile (two warpgroups)
constexpr int kTcBK = 64;    // depth of a K slice: one 128-byte row
constexpr int kTcThreads = 256;
constexpr int kTcStages = 4;
constexpr int kTcAhead = kTcStages - 2;    // slices in flight
constexpr int kTcAElems = kTcBM * kTcBK;   // [128][64], 16 KB
constexpr int kTcBox = kTcBK * 64;         // one [64 K][64 N] box of W

// columns of a CTA's tile, elements of a ring stage, and the dynamic
// shared memory of a launch: the ring, its full barriers, and room to
// align the ring to the 1024-byte swizzle atom
__host__ __device__ constexpr int tc_bn(int halves) { return 128 * halves; }
__host__ __device__ constexpr int tc_stage_elems(int halves) {
  return kTcAElems + tc_bn(halves) / 64 * kTcBox;
}
__host__ __device__ constexpr size_t tc_smem(int halves) {
  return kTcStages * tc_stage_elems(halves) * sizeof(__nv_bfloat16) +
         kTcStages * sizeof(uint64_t) + 1024;
}

// how an operand's rows reach shared memory
constexpr int kCopyScalar = 0;   // guarded loads, complete on return
constexpr int kCopyPairs = 1;    // 4-byte cp.async (ld even)
constexpr int kCopyTma = 2;      // TMA boxes (ld a multiple of 8)

// how the tensor-core GEMM copies the rows of a [.., rows, ld] bf16
// tensor: TMA needs 16-byte rows (and so 16-byte matrix strides) and a
// 16-byte aligned base
inline int copy_mode(const void* p, int ld) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  if (ld % 8 == 0 && at % 16 == 0) return kCopyTma;
  if (ld % 2 == 0 && at % 4 == 0) return kCopyPairs;
  return kCopyScalar;
}

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

// f32 the staged tile's rows are padded by: a warp's pair stores of the
// accumulator layout (4 rows x 4 column pairs a half-warp) then fall on
// 32 different banks
constexpr int kTcPad = 8;

// The accumulators of a CTA's tile, the f32 sums, into ``zs`` [128][128
// kHalves + kTcPad] (the drained ring): thread ``lane`` of the warp
// owning rows [row0, row0 + 16) holds, for each 8-column group j of a
// 128-column half, rows lane / 4 and lane / 4 + 8 at columns 8 j + 2
// (lane % 4) and the next
template <int kHalves>
__device__ __forceinline__ void stage_tile(const float (&acc)[kHalves][64],
                                           float* __restrict__ zs,
                                           int row0, int lane) {
  constexpr int kLd = tc_bn(kHalves) + kTcPad;
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            zs + (row0 + (lane >> 2) + 8 * r) * kLd + 128 * h + 8 * j +
            2 * (lane & 3)) =
            make_float2(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
}

__device__ __forceinline__ void store_quad(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* p,
                                           const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// The epilogue of the staged tile ``zs`` (stage_tile), output tile at
// (m0, n0): bias (kBias), activation kAct and rounding, z = sum + bias
// stored to z_out first under kWithZ, four neighbouring columns at a
// time, stores guarded at M and N and whole (16 bytes f32, 8 bf16)
// where N and the outputs allow.  A loop that is not unrolled: unrolled
// over a thread's 128 values the epilogue is code fetched once a CTA,
// which at K 1024 cost more than the products once the activation was
// more than a few instructions (tanhf's gelu: PERF.md); rolled it is a
// few hundred bytes, and a warp's stores are 128 columns of one row.
template <typename OutT, bool kWithZ, int kAct, bool kBias, int kHalves>
__device__ __forceinline__ void store_staged(const float* __restrict__ zs,
                                             const float* __restrict__ bias,
                                             OutT* __restrict__ out,
                                             float* __restrict__ z_out,
                                             int M, int N, int m0, int n0) {
  constexpr int kBN = tc_bn(kHalves);
  constexpr int kLd = kBN + kTcPad;
  auto at = [](const void* p, size_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const bool quads = N % 4 == 0 && at(out, 4 * sizeof(OutT)) &&
                     (!kWithZ || at(z_out, 16));
  auto step = [&](int r, int c) {
    const int col = n0 + c;
    const float4 s = *reinterpret_cast<const float4*>(zs + r * kLd + c);
    float z[4] = {s.x, s.y, s.z, s.w}, y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kBias && col + k < N) z[k] += bias[col + k];
      y[k] = activate(z[k], kAct);
    }
    const size_t o = (size_t)(m0 + r) * N + col;
    if (quads) {   // N % 4 == 0: the four columns lie inside the row
      if (kWithZ) store_quad(z_out + o, z);
      store_quad(out + o, y);
      return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (col + k >= N) break;
      if (kWithZ) z_out[o + k] = z[k];
      out[o + k] = from_f32<OutT>(y[k]);
    }
  };
  // only the tile's rows below M and columns below N: a decode tile has
  // 8 rows of 128, a logits tile 10 columns of 256
  const int rows = min(kTcBM, M - m0);
  const int cols = min(kBN, N - n0);
  if (cols == kBN) {
#pragma unroll 1
    for (int idx = threadIdx.x; idx < rows * (kBN / 4); idx += kTcThreads)
      step(idx / (kBN / 4), 4 * (idx % (kBN / 4)));
  } else {
    const int q = (cols + 3) / 4;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < rows * q; idx += kTcThreads)
      step(idx / q, 4 * (idx % q));
  }
}

// grid (ceil(N / (128 kHalves)), ceil(M / 128), E * splits); copy_a /
// copy_w: how A's and W's rows arrive (kCopy*); map_a / map_w: their
// 3-D tensor maps where TMA copies them (A [E][M][K] in boxes of
// [1][128][64], W [E][K][N] in boxes of [1][64][64]).  OutT float takes
// act = identity (and bias = nullptr for split-K shares, splits > 1);
// OutT bf16 takes a bias.
template <typename OutT, int kHalves, bool kWithZ>
__global__ void __launch_bounds__(kTcThreads, 1)
    gemm_bias_act_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                            const __grid_constant__ CUtensorMap map_w,
                            const __nv_bfloat16* __restrict__ A,
                            const __nv_bfloat16* __restrict__ W,
                            const float* __restrict__ bias,
                            OutT* __restrict__ out,
                            float* __restrict__ z_out, int M, int N, int K,
                            int act, int copy_a, int copy_w, int splits) {
  using bf16 = __nv_bfloat16;
  constexpr int kBN = tc_bn(kHalves);
  constexpr int kStageElems = tc_stage_elems(kHalves);
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTcStages *
                                               kStageElems);
  const int e = blockIdx.z / splits;       // the matrix of the batch
  const int split = blockIdx.z % splits;   // its share of K
  const size_t experts = gridDim.z / splits;
  const int m0 = blockIdx.y * kTcBM;
  const int n0 = blockIdx.x * kBN;
  const int wg0 = (threadIdx.x >> 7) * 64;   // the warpgroup's rows
  const int row0 = (threadIdx.x >> 5) * 16;  // the warp's rows
  const int lane = threadIdx.x & 31;
  const int nk_all = (K + kTcBK - 1) / kTcBK;
  const int per = (nk_all + splits - 1) / splits;
  const int t0 = split * per;              // this CTA's first slice
  const int nk = max(0, min(per, nk_all - t0));
  A += (size_t)e * M * K;
  W += (size_t)e * K * N;
  if (bias != nullptr) bias += (size_t)e * N;
  out += ((size_t)split * experts + e) * M * N;
  if (kWithZ) z_out += (size_t)e * M * N;
  const bool tma_a = copy_a == kCopyTma;
  const bool tma_w = copy_w == kCopyTma;
  const uint32_t tx_bytes = (tma_a ? kTcAElems * sizeof(bf16) : 0) +
                            (tma_w ? kBN / 64 * kTcBox * sizeof(bf16) : 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kTcStages; ++i) tc::mbar_init(&full[i], 1);
    tc::mbar_init_fence();
  }
  __syncthreads();

  // local slice i (global t0 + i) in stage i % kTcStages: A [128][64],
  // then W's 2 kHalves [64][64] boxes (columns n0, n0 + 64, ...)
  auto a_tile = [&](int i) { return ring + (i % kTcStages) * kStageElems; };
  auto load = [&](int i) {
    const int k0 = (t0 + i) * kTcBK;
    bf16* a = a_tile(i);
    bf16* w = a + kTcAElems;
    if (threadIdx.x == 0 && tx_bytes) {
      uint64_t* bar = &full[i % kTcStages];
      tc::mbar_expect_tx(bar, tx_bytes);
      if (tma_a) tc::tma_load_3d(a, &map_a, k0, m0, e, bar);
      if (tma_w)
        for (int b = 0; b < kBN / 64; ++b)
          tc::tma_load_3d(w + b * kTcBox, &map_w, n0 + 64 * b, k0, e, bar);
    }
    if (!tma_a)
      copy_sw128<kTcBM, kTcBK>(a, A + (size_t)m0 * K + k0, K, M - m0,
                               K - k0, copy_a == kCopyPairs);
    if (!tma_w)
      copy_sw128<kTcBK, kBN>(w, W + (size_t)k0 * N + n0, N, K - k0,
                             N - n0, copy_w == kCopyPairs);
  };

#pragma unroll
  for (int i = 0; i < kTcAhead; ++i) {
    if (i < nk) load(i);
    tc::cp_async_commit();
  }
  float acc[kHalves][64];
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    tc::fence_regs(acc[h]);
  }

  for (int i = 0; i < nk; ++i) {
    tc::cp_async_wait<kTcAhead - 1>();   // this thread's copies of slice i
    if (tx_bytes) tc::mbar_wait(&full[i % kTcStages], (i / kTcStages) & 1);
    tc::fence_proxy_async();
    // slice i visible to all; every warpgroup has retired slice i - 2,
    // whose stage slice i + kTcAhead refills
    __syncthreads();
    if (i + kTcAhead < nk) load(i + kTcAhead);
    tc::cp_async_commit();
    const bf16* At = a_tile(i) + wg0 * kTcBK;
    const bf16* Wt = a_tile(i) + kTcAElems;
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      // A k-major: 16 columns = 32 bytes along the swizzled rows; W
      // MN-major: 16 rows of K, the next 64 columns a box (8 KB) away;
      // half h reads boxes 2h and 2h + 1
      const uint64_t da = tc::gmma_desc_sw128(At + 16 * ks, 16);
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
        tc::wgmma_m64n128k16_ss<1>(
            acc[h], da,
            tc::gmma_desc_sw128(Wt + 2 * h * kTcBox + 16 * 64 * ks,
                                kTcBox * sizeof(bf16)),
            1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();   // slice i - 1's products
  }
  tc::wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < kHalves; ++h) tc::fence_regs(acc[h]);
  tc::cp_async_wait<0>();

  // every warpgroup's products retired and every copy landed: the ring
  // takes the staged f32 tile
  static_assert(kTcBM * (kBN + kTcPad) * sizeof(float) <=
                    kTcStages * kStageElems * sizeof(bf16),
                "the staged tile fits in the ring");
  float* zs = reinterpret_cast<float*>(ring);
  __syncthreads();
  stage_tile<kHalves>(acc, zs, row0, lane);
  __syncthreads();

  // one branch to an epilogue specialized for the activation: a switch
  // per element would put every activation's code in the loop
  if constexpr (std::is_same_v<OutT, float>) {
    // an f32 output is a product's last (logits, the FFN's out), or a
    // split-K share (no bias: the f32 sum as it is): no activation, so
    // no other epilogue is compiled for it
    if (bias == nullptr)
      store_staged<OutT, kWithZ, kIdentity, false, kHalves>(
          zs, bias, out, z_out, M, N, m0, n0);
    else
      store_staged<OutT, kWithZ, kIdentity, true, kHalves>(
          zs, bias, out, z_out, M, N, m0, n0);
  } else {
    switch (act) {
      case kGelu:
        store_staged<OutT, kWithZ, kGelu, true, kHalves>(
            zs, bias, out, z_out, M, N, m0, n0);
        break;
      case kRelu:
        store_staged<OutT, kWithZ, kRelu, true, kHalves>(
            zs, bias, out, z_out, M, N, m0, n0);
        break;
      case kTanh:
        store_staged<OutT, kWithZ, kTanh, true, kHalves>(
            zs, bias, out, z_out, M, N, m0, n0);
        break;
      case kSigmoid:
        store_staged<OutT, kWithZ, kSigmoid, true, kHalves>(
            zs, bias, out, z_out, M, N, m0, n0);
        break;
      default:
        store_staged<OutT, kWithZ, kIdentity, true, kHalves>(
            zs, bias, out, z_out, M, N, m0, n0);
    }
  }
}

// The epilogue of a split-K product: for i in [0, E * M * N), z = the
// ``splits`` f32 shares part[s * E * M * N + i] summed in the order s =
// 0, 1, ... plus bias[e, col]; z_out[i] = z (kWithZ); out[i] =
// round_to_OutT(act(z)).
template <typename OutT, bool kWithZ>
__global__ void split_k_sum_kernel(const float* __restrict__ part,
                                   int splits, size_t total, size_t mn,
                                   int N, const float* __restrict__ bias,
                                   OutT* __restrict__ out,
                                   float* __restrict__ z_out, int act) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float z = part[i];
    for (int s = 1; s < splits; ++s) z += part[s * total + i];
    z += bias[(i / mn) * N + i % N];
    if (kWithZ) z_out[i] = z;
    out[i] = from_f32<OutT>(activate(z, act));
  }
}

// One product of the batch: out = act(A @ W + bias) (and z_out under
// kWithZ) for E matrices [M, K] x [K, N], on ``stream``.  splits > 1
// (OutT float, bias null, act identity, no z) writes the split-K shares
// to ``out``, [splits, E, M, N] f32.
template <typename OutT, int kHalves, bool kWithZ>
cudaError_t tc_gemm(const void* A, const void* W, const float* bias,
                    void* out, float* z_out, int E, int M, int N, int K,
                    int act, int splits, cudaStream_t stream) {
  static bool ready = false;
  auto kernel = gemm_bias_act_tc_kernel<OutT, kHalves, kWithZ>;
  cudaError_t err = allow_smem(kernel, tc_smem(kHalves), &ready);
  if (err != cudaSuccess) return err;
  const int copy_a = copy_mode(A, K);
  const int copy_w = copy_mode(W, N);
  CUtensorMap map_a = {}, map_w = {};
  if (copy_a == kCopyTma) {
    err = tc::encode_sw128_map(&map_a, A, K, M, (uint64_t)K * 2, kTcBK,
                               kTcBM, E, (uint64_t)M * K * 2);
    if (err != cudaSuccess) return err;
  }
  if (copy_w == kCopyTma) {
    err = tc::encode_sw128_map(&map_w, W, N, K, (uint64_t)N * 2, 64, kTcBK,
                               E, (uint64_t)K * N * 2);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + tc_bn(kHalves) - 1) / tc_bn(kHalves),
                  (M + kTcBM - 1) / kTcBM, E * splits);
  kernel<<<grid, kTcThreads, tc_smem(kHalves), stream>>>(
      map_a, map_w, static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(W), bias, static_cast<OutT*>(out),
      z_out, M, N, K, act, copy_a, copy_w, splits);
  return cudaGetLastError();
}

// split_k_sum_kernel over [E, M, N] on ``stream``
template <typename OutT, bool kWithZ>
cudaError_t split_k_sum(const float* part, int splits, const float* bias,
                        void* out, float* z_out, int E, int M, int N,
                        int act, cudaStream_t stream) {
  const size_t mn = (size_t)M * N;
  const size_t total = (size_t)E * mn;
  // a grid-stride loop: 16 blocks an SM of the current device, fewer for
  // a small sum
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t blocks = std::min<size_t>((total + 255) / 256,
                                         (size_t)sms * 16);
  split_k_sum_kernel<OutT, kWithZ>
      <<<(unsigned)blocks, 256, 0, stream>>>(part, splits, total, mn, N, bias,
                   static_cast<OutT*>(out), z_out, act);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dtx
