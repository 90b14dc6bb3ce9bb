// Copy microbenchmark behind the feed of the tensor-core GEMM
// (ops/csrc/gemm_tc.cuh): how fast 256 threads of a CTA, one CTA per
// SM, stream 48 KB tiles of bf16 rows into shared memory through a ring
// of four stages two tiles ahead, three ways:
//   mode 0: 16-byte cp.async per thread into three [64][128] no-swizzle
//           core-matrix tiles of tc.cuh (load_tile, the flash kernels'
//           feed);
//   mode 1: 16-byte loads into registers, then shared stores, same
//           tiles;
//   mode 2: TMA, one thread asking for three [128][64] boxes a tile,
//           128-byte swizzled, completing on an mbarrier (the rank-3
//           tensor map of gemm_tc.cuh, here of one matrix).
// Each CTA reads its own 384 rows (``private``: from device memory) or
// every CTA the same 384 rows (``shared``: from L2).  Built and run by
// scripts/torch_copy_bench.py.
#include "../distributed_tensorflow_example_tpu_torch/ops/csrc/tc.cuh"

using bf16 = __nv_bfloat16;
using namespace dtx;

constexpr int kStage = 3 * 128 * 64;   // elements of one 48 KB tile

template <int kMode>
__global__ void __launch_bounds__(256, 1)
    copy_kernel(const __grid_constant__ CUtensorMap map, const bf16* src,
                size_t ld, int iters, int shared_rows, float* sink) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 4 * kStage);
  const int row0 = shared_rows ? 0 : blockIdx.x * 384;
  if (kMode == 2 && threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) tc::mbar_init(&full[i], 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](int t) {
    bf16* st = ring + (t % 4) * kStage;
    if constexpr (kMode == 2) {
      if (threadIdx.x == 0) {
        tc::mbar_expect_tx(&full[t % 4], kStage * sizeof(bf16));
        for (int j = 0; j < 3; ++j)
          tc::tma_load_3d(st + j * 128 * 64, &map, (t % 64) * 64,
                          row0 + j * 128, 0, &full[t % 4]);
      }
    } else {
      // three [64][128] tiles (16 KB each) in load_tile's layout
      for (int j = 0; j < 3; ++j) {
        const bf16* s = src + (size_t)(row0 + j * 64) * ld + (t % 32) * 128;
        bf16* d = st + j * 64 * 128;
        if (kMode == 0) {
          tc::load_tile<64, 256>(d, s, ld, 64, 128, true);
          continue;
        }
        uint4 r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = threadIdx.x + i * 256;
          const int row = (idx / 128) * 8 + (idx & 7);
          r[i] = *reinterpret_cast<const uint4*>(s + row * ld +
                                                 ((idx >> 3) % 16) * 8);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = threadIdx.x + i * 256;
          const int row = (idx / 128) * 8 + (idx & 7);
          *reinterpret_cast<uint4*>(d + tc::il_off(row, (idx >> 3) % 16)) =
              r[i];
        }
      }
    }
  };
  load(0);
  tc::cp_async_commit();
  load(1);
  tc::cp_async_commit();
  float acc = 0.f;
  for (int t = 0; t < iters; ++t) {
    tc::cp_async_wait<1>();
    if (kMode == 2) tc::mbar_wait(&full[t % 4], (t / 4) & 1);
    __syncthreads();
    acc += __bfloat162float(ring[(t % 4) * kStage + threadIdx.x]);
    __syncthreads();
    if (t + 2 < iters) load(t + 2);
    tc::cp_async_commit();
  }
  if (acc == 12345.f) sink[0] = acc;   // keeps the reads
}

// smem bytes: the ring, its barriers, alignment room
constexpr size_t kSmem = 4 * kStage * sizeof(bf16) + 64 + 1024;

extern "C" int copy_bench(int mode, const void* src, unsigned long long ld,
                          unsigned long long rows, int ctas, int iters,
                          int shared_rows, void* sink) {
  CUtensorMap map = {};
  if (mode == 2) {
    cudaError_t e = tc::encode_sw128_map(&map, src, ld, rows, ld * 2, 64,
                                         128, 1, rows * ld * 2);
    if (e != cudaSuccess) return (int)e;
  }
  auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)kSmem);
    kernel<<<ctas, 256, kSmem>>>(map, static_cast<const bf16*>(src), ld,
                                 iters, shared_rows,
                                 static_cast<float*>(sink));
  };
  if (mode == 0) run(copy_kernel<0>);
  else if (mode == 1) run(copy_kernel<1>);
  else run(copy_kernel<2>);
  return (int)cudaGetLastError();
}
