// Tensor-core building blocks for the port's Hopper kernels (sm_90a):
// Hopper's warpgroup MMA (wgmma) with its shared-memory matrix
// descriptors, the tile layouts those descriptors read (no-swizzle core
// matrices, and the 128-byte swizzle), asynchronous global -> shared
// copies that fill them (cp.async of 16 or 4 bytes, and TMA boxes that
// complete on an mbarrier), the ldmatrix load of an A operand into
// registers, and the bf16 packing of an f32 accumulator into the A
// operand of the next product.
//
// Register layouts (g = lane / 4, t = lane % 4).  A wgmma m64nNk16 is
// issued by a warpgroup of 4 warps; warp w of the group holds rows
// 16w..16w+15 of the 64.  Its accumulator, per 8 columns j: d[4j],
// d[4j+1] at (row g, cols 8j+2t, +1), d[4j+2], d[4j+3] at (row g+8, the
// same cols).  An A operand from registers is, per warp, mma.sync
// m16n8k16's A fragment: a0 (row g, cols 2t, 2t+1), a1 (row g+8, cols
// 2t..), a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..).  So the
// accumulators of two neighbouring 8-column blocks, packed to bf16
// pairs, are the A operand of one 16-deep step: a product's result
// feeds the next product without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dtx {
namespace tc {

// the widest row of a tile (the widest head dim)
constexpr int kTileCols = 128;

// The tile layout: wgmma's no-swizzle ("interleave") core matrices of 8
// rows x 16 bytes, stored as 128 contiguous bytes.  il_off gives the
// element offset of (row, 8-element chunk) in a [rows][kTileCols] tile:
// rows in groups of 8, kIlGroup bytes apart, and within a group the 16
// chunks' core matrices 128 bytes apart.  A descriptor reads it with
//   k-major (the tile's rows are the product's M or N, its columns the
//   reduction): LBO = 128 (the next 8 columns), SBO = kIlGroup (the
//   next 8 rows);
//   MN-major (the rows are the reduction, read transposed): LBO =
//   kIlGroup (the next 8 rows), SBO = 128 (the next 8 columns).
// 8 lanes copying one chunk of 8 consecutive rows fill one core matrix,
// and ldmatrix's 8 row addresses of a chunk hit distinct banks.
constexpr uint32_t kIlGroup = kTileCols / 8 * 128;  // bytes per 8 rows

__device__ __forceinline__ int il_off(int row, int chunk) {
  return (row >> 3) * (kIlGroup / 2) + chunk * 64 + (row & 7) * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the matrix descriptor of a no-swizzle operand at ``p``
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

// 16 bytes global -> shared without passing through registers; where
// ``valid`` is false the 16 bytes are zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (a strided f32 row statistic, a pair of bf16
// in a row of even width); zero-filled where ``valid`` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most ``N`` committed groups of this thread are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy shared-memory writes (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i] (thread holds row lane/4, cols
// 2(lane%4), +1): with rows 0-7 / 8-15 and column chunks c / c+1 an A
// operand
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two f32 rounded to bf16 (nearest even, as XLA casts); ``lo`` in the
// low half, the element of the lower column
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of 16-deep step j from the f32 accumulators of 8-column
// blocks 2j and 2j+1, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4],
                                       const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// max / sum over the 4 lanes of a quad: the lanes holding one row of an
// accumulator
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [0, kRows) of a [kRows][kTileCols] tile in the layout above from
// ``src`` (row r at src + r * ld, D <= kTileCols columns).  Rows >=
// ``rows`` and columns >= D are zero.  With ``vec`` (D a multiple of 8, ``src``
// 16-byte aligned) 16-byte cp.async copies that the caller commits and
// waits for, 8 neighbouring threads filling one core matrix; otherwise
// guarded scalar loads and shared stores, complete on return.  With
// kScale each value is multiplied by ``mul`` in f32 and rounded back to
// bf16 (then always through registers, complete on return).
template <int kRows, int kThreads, bool kScale = false>
__device__ __forceinline__ void load_tile(__nv_bfloat16* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          size_t ld, int rows, int D,
                                          bool vec,
                                          float mul = 1.f) {
  constexpr int kChunks = kTileCols / 8;  // 16-byte chunks of a row
  if (vec) {
#pragma unroll
    for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = (idx / (8 * kChunks)) * 8 + (idx & 7);
      const int chunk = (idx >> 3) % kChunks;
      const int c = chunk * 8;
      const bool valid = r < rows && c < D;
      const __nv_bfloat16* from = valid ? src + r * ld + c : src;
      __nv_bfloat16* to = dst + il_off(r, chunk);
      if (!kScale) {
        cp_async16(to, from, valid);
        continue;
      }
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (valid) raw = *reinterpret_cast<const uint4*>(from);
      uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        w[j] = pack_bf16(f.x * mul, f.y * mul);
      }
      *reinterpret_cast<uint4*>(to) = raw;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kRows * kTileCols; idx += kThreads) {
    const int r = idx / kTileCols;
    const int c = idx % kTileCols;
    float x = 0.f;
    if (r < rows && c < D) {
      x = __bfloat162float(src[r * ld + c]);
      if (kScale) x *= mul;
    }
    dst[il_off(r, c >> 3) + (c & 7)] = __float2bfloat16_rn(x);
  }
}

// ---------------------------------------------------------------------------
// TMA (the tensor memory accelerator): one thread asks for a whole 2-D
// box of a tensor; the copy lands in shared memory, 128-byte swizzled,
// and completes on an mbarrier that counts the bytes.  Boxes past the
// tensor's edge are zero-filled.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barrier inits visible to the other threads and to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also expects ``bytes`` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the box at element coordinates (c0 innermost, c1, c2) of a rank-3
// tensor map, e.g. (K, rows, expert) of a batch of matrices, into
// ``dst`` (1024-byte aligned for the 128-byte swizzle), completing on
// ``bar``; a box never crosses into the next c2 plane, and what lies past
// an edge of its own plane is zero
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// The 128-byte swizzled tile (what TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B, and wgmma reads with layout type 1):
// rows of 128 bytes (64 bf16), the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8); 8 rows make a 1024-byte atom.  Element offset of
// (row, col) in a tile of 64-wide rows:
__device__ __forceinline__ int sw128_off(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// descriptor of a 128-byte swizzled operand at ``p`` (within a 1024-byte
// aligned atom): k-major, SBO = 1024 (the next 8 rows), steps of 16
// along K advance ``p`` by 32 bytes; MN-major, LBO = the stride of the
// next 64 columns, SBO = 1024 (the next 8 rows of K), steps of 16 along
// K advance ``p`` by 16 rows
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* p,
                                                    uint32_t lbo) {
  return gmma_desc(p, lbo, 1024) | (uint64_t)1 << 62;
}

// The rank-3 tensor map of a batch of ``depth`` >= 1 row-major bf16
// matrices [depth][outer][inner] (rows ``row_bytes`` apart and matrices
// ``plane_bytes`` apart, both multiples of 16; ``base`` 16-byte aligned)
// read in boxes of [1][box_outer][box_inner] elements (tma_load_3d),
// box_inner * 2 <= 128, written 128-byte swizzled; one matrix is depth 1.
// cuTensorMapEncodeTiled is looked up at run time through the CUDA
// runtime, so nothing links against libcuda.
inline cudaError_t encode_sw128_map(CUtensorMap* map, const void* base,
                                    uint64_t inner, uint64_t outer,
                                    uint64_t row_bytes, uint32_t box_inner,
                                    uint32_t box_outer, uint64_t depth,
                                    uint64_t plane_bytes) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (fn == nullptr || found != cudaDriverEntryPointSuccess)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {inner, outer, depth};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t box[3] = {box_inner, box_outer, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma: issue a group's products after wgmma_fence (which orders them
// after this thread's register writes), commit the group, and read the
// accumulators only after wgmma_wait has retired it.  fence_regs keeps
// the compiler from moving an accumulator's reads or writes across the
// asynchronous products that own it.  Registers the products own must not
// be written by other instructions between a group's fence and its wait,
// or ptxas serializes the products (its -v report says so).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most ``N`` committed groups of the warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . b, m64 x n x k16, bf16 in, f32 accumulate; scale_d = 0
// overwrites d.  _rs: A from registers; _ss: A k-major from a
// descriptor.  kTransB = 1 reads an MN-major B.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float d[32],
                                                  const uint32_t a[4],
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float d[64],
                                                  const uint32_t a[4],
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float d[32],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float d[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

}  // namespace tc
}  // namespace dtx
