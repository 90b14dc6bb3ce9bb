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
// matrix, 128 x 256 tiles, no split of K).  f32 layers stay on the CUDA
// cores (the tensor cores take f32 only as TF32, against the 1e-4 the
// f32 forward is held to) and run fma_gemm_kernel below, built for the
// few rows of the reference MLP: at 100 rows its first layer is 16
// output tiles of 32 x 32, and 64 x 64 tiles gave it 4 CTAs on 132 SMs,
// each walking K = 784 alone.  Here K is split over a thread block
// cluster as well (ops/fused.mlp_f32_plan picks the split, up to the
// portable cluster size of 8, to put about four CTAs on every SM: 112
// CTAs at 100 rows), each CTA of 64 threads computes its share of the
// tile (4 x 4 outputs a thread, f32 FMA, 32-deep K slices staged in
// shared memory, the next slice loaded into registers while this one is
// multiplied, 16-byte loads where a width is a multiple of 4), leaves
// its partial tile in its shared memory, and after a cluster barrier
// each CTA adds a slice of the tile over the cluster's shares in rank
// order through distributed shared memory, then applies the bias, the
// activation and the store: no workspace, no second launch, no atomics,
// the same bits on every run.  The edge guards of both GEMMs replace
// the TPU kernel's row padding to 128, so any N >= 1 and any width
// (784, 100, 10) run as they are.
#include "common.cuh"
#include "gemm_tc.cuh"

#include <cooperative_groups.h>
#include <cstdint>

namespace dtx {
namespace {

namespace cg = cooperative_groups;

// the f32 layer's tile: kFT x kFT outputs a CTA, kFK-deep K slices,
// kFThreads threads of kFR x kFR outputs each, K split over at most
// kFMaxSplits CTAs of one cluster (ops/fused.py mirrors these)
constexpr int kFT = 32;
constexpr int kFK = 32;
constexpr int kFR = 4;
constexpr int kFThreads = (kFT / kFR) * (kFT / kFR);  // 64
constexpr int kFMaxSplits = 8;
constexpr int kFPad = 4;  // keeps the float4 reads of the A columns aligned
// the vectors each thread loads of a slice: 4 of A [kFT, kFK], 4 of B
// [kFK, kFT], 4 values each
constexpr int kFLoads = kFT * kFK / (kFThreads * 4);  // 4

// four consecutive values of a row (guarded by ``limit`` on the row's
// length), as one 16-byte load when kVec (the row's length a multiple
// of 4 and the base 16-byte aligned), else as four guarded loads
template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ row, int at,
                                      int limit, bool in, float v[4]) {
  if (kVec) {
    if (in && at < limit) {
      const float4 q = *reinterpret_cast<const float4*>(row + at);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (in && at + j < limit) ? row[at + j] : 0.f;
  }
}

// out = act(A @ W + bias) for A [M, K], W [K, N] f32, f32 out; grid
// (splits, ceil(N / kFT), ceil(M / kFT)) in clusters of (splits, 1, 1):
// the CTA of cluster rank s multiplies K slices [s * per, (s + 1) *
// per) of the tile's rows and columns
template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kFThreads)
    fma_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int N, int K, int per, int act) {
  // As [kFK][kFT + kFPad] (A's slice transposed) then Bs [kFK][kFT]; after
  // the K loop the first kFT * kFT floats hold this CTA's partial tile
  __shared__ __align__(16) float smem[kFK * (kFT + kFPad) + kFK * kFT];
  float(*As)[kFT + kFPad] = reinterpret_cast<float(*)[kFT + kFPad]>(smem);
  float(*Bs)[kFT] =
      reinterpret_cast<float(*)[kFT]>(smem + kFK * (kFT + kFPad));
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m0 = blockIdx.z * kFT;
  const int n0 = blockIdx.y * kFT;
  const int tid = threadIdx.x;
  const int tx = tid % (kFT / kFR);
  const int ty = tid / (kFT / kFR);
  const int slices = (K + kFK - 1) / kFK;
  const int s_begin = rank * per;
  const int s_end = min(slices, s_begin + per);

  float acc[kFR][kFR];
#pragma unroll
  for (int i = 0; i < kFR; ++i)
#pragma unroll
    for (int j = 0; j < kFR; ++j) acc[i][j] = 0.f;

  // slice loads: vector q = tid + i * kFThreads of A is row q / 8, K
  // offset 4 (q % 8); of W, K row q / 8, column 4 (q % 8)
  float ra[kFLoads][4], rb[kFLoads][4];
  auto load = [&](int s) {
    const int k0 = s * kFK;
#pragma unroll
    for (int i = 0; i < kFLoads; ++i) {
      const int q = tid + i * kFThreads;
      const int r = q / (kFK / 4), c4 = 4 * (q % (kFK / 4));
      const int gm = m0 + r;
      load4<kVecA>(A + (size_t)min(gm, M - 1) * K, k0 + c4, K, gm < M,
                   ra[i]);
      const int gk = k0 + r;
      load4<kVecB>(W + (size_t)min(gk, K - 1) * N, n0 + c4, N, gk < K,
                   rb[i]);
    }
  };
  if (s_begin < s_end) load(s_begin);
  for (int s = s_begin; s < s_end; ++s) {
    __syncthreads();  // the previous slice's products are done
#pragma unroll
    for (int i = 0; i < kFLoads; ++i) {
      const int q = tid + i * kFThreads;
      const int r = q / (kFK / 4), c4 = 4 * (q % (kFK / 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) As[c4 + j][r] = ra[i][j];
      *reinterpret_cast<float4*>(&Bs[r][c4]) =
          make_float4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
    }
    __syncthreads();
    if (s + 1 < s_end) load(s + 1);  // in flight under the products
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * kFR]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * kFR]);
      const float av[kFR] = {a.x, a.y, a.z, a.w};
      const float bv[kFR] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kFR; ++i)
#pragma unroll
        for (int j = 0; j < kFR; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __syncthreads();  // every thread is done with As and Bs
  float* tile = smem;  // [kFT][kFT], this CTA's share of the sum
#pragma unroll
  for (int i = 0; i < kFR; ++i)
    *reinterpret_cast<float4*>(&tile[(ty * kFR + i) * kFT + tx * kFR]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();  // every share of the tile is in its CTA's memory
  for (int e = rank * kFThreads + tid; e < kFT * kFT;
       e += splits * kFThreads) {
    float z = 0.f;
    for (int r = 0; r < splits; ++r) z += cluster.map_shared_rank(tile, r)[e];
    const int gm = m0 + e / kFT, gn = n0 + e % kFT;
    if (gm < M && gn < N)
      out[(size_t)gm * N + gn] = activate(z + bias[gn], act);
  }
  cluster.sync();  // no CTA leaves while another reads its share
}

// an f32 layer on the CUDA cores, K in ``splits`` shares of whole slices
template <bool kVecA, bool kVecB>
cudaError_t fma_launch(const float* A, const float* W, const float* bias,
                       float* out, int M, int N, int K, int splits, int act,
                       cudaStream_t stream) {
  const int slices = (K + kFK - 1) / kFK;
  const int per = (slices + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kFT - 1) / kFT, (M + kFT - 1) / kFT);
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fma_gemm_kernel<kVecA, kVecB>, A, W, bias,
                            out, M, N, K, per, act);
}

cudaError_t fma_layer(const void* A, const void* W, const float* bias,
                      void* out, int M, int N, int K, int splits, int act,
                      bool last, cudaStream_t stream) {
  const float* a = static_cast<const float*>(A);
  const float* w = static_cast<const float*>(W);
  float* o = static_cast<float*>(out);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool va = K % 4 == 0 && aligned(A);
  const bool vb = N % 4 == 0 && aligned(W);
  const int f = last ? kIdentity : act;
  cudaError_t err =
      va ? (vb ? fma_launch<true, true>(a, w, bias, o, M, N, K, splits, f,
                                         stream)
               : fma_launch<true, false>(a, w, bias, o, M, N, K, splits, f,
                                          stream))
         : (vb ? fma_launch<false, true>(a, w, bias, o, M, N, K, splits, f,
                                          stream)
               : fma_launch<false, false>(a, w, bias, o, M, N, K, splits,
                                           f, stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace dtx

// C interface (ctypes).  A [M, K] and W [K, N] are of ``dtype`` (0 f32,
// 1 bf16), bias [N] is f32.  ``last`` = 0: a hidden layer, out [M, N] of
// ``dtype`` = act(A @ W + bias) with ``act`` 1 relu, 2 tanh, 3 sigmoid;
// ``last`` = 1: the logits, out [M, N] f32 = A @ W + bias.  ``splits``:
// the f32 layer's split of K (ops/fused.mlp_f32_plan: 1 to 8 shares of
// 32-deep slices, none empty); 1 for bf16.  One launch on ``stream``;
// returns its cudaError_t (0 = success).
extern "C" int dtx_mlp_layer_fwd(const void* A, const void* W,
                                 const void* bias, void* out, int M, int N,
                                 int K, int act, int dtype, int last,
                                 int splits, void* stream) {
  using namespace dtx;
  if (M < 0 || N < 1 || K < 1 || act < kRelu || act > kSigmoid ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: {
      const int slices = (K + kFK - 1) / kFK;
      const int per = (slices + splits - 1) / splits;
      if (splits > kFMaxSplits || splits > slices ||
          (splits - 1) * per >= slices || (N + kFT - 1) / kFT > 65535 ||
          (M + kFT - 1) / kFT > 65535)
        return (int)cudaErrorInvalidValue;
      if (M == 0) return (int)cudaSuccess;
      return (int)fma_layer(A, W, b, out, M, N, K, splits, act, last != 0,
                            st);
    }
    case kBFloat16:
      if (splits != 1 || (M + kBM - 1) / kBM > 65535)
        return (int)cudaErrorInvalidValue;
      if (M == 0) return (int)cudaSuccess;
      return (int)(last ? tc_gemm<float, 2, false>(A, W, b, out, nullptr, 1,
                                                   M, N, K, kIdentity, 1, st)
                        : tc_gemm<__nv_bfloat16, 2, false>(
                              A, W, b, out, nullptr, 1, M, N, K, act, 1,
                              st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
