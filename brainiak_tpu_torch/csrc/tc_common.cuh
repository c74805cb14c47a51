// Device helpers of the tensor-core FCMA kernels (fcma_gram_tc.cu, K1's
// one-epoch-tile route, and fcma_corr_tc.cu, K3's): TMA tensor copies
// completing on shared-memory mbarriers, the 3xTF32 split, the
// m16n8k8 TF32 product, and the fragment-to-voxel maps that keep the
// loads of a warp off shared-memory bank conflicts under the TMA's
// swizzle, for NVIDIA Hopper (sm_90a).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// Where element (t, c) of a stage's [rows][N] box lies: 16-byte chunk
// c / 4 of row t XOR-swizzled as the TMA writes it, 128-byte rows
// (N = 32) with t % 8, 64-byte rows (N = 16) with t / 2 % 4.  The box
// starts on a 1024-byte boundary and its rows per epoch are a multiple
// of 8, so t may be the row within the box's epoch.
template <int N>
__device__ __forceinline__ int swizzled(int t, int c) {
  static_assert(N == 16 || N == 32, "64- or 128-byte rows");
  const int x = N == 32 ? (t & 7) : ((t >> 1) & 3);
  return t * N + (((c >> 2) ^ x) << 2) + (c & 3);
}

// B fragment column n (of every n-tile) reads chunk col_chunk(n) of
// its row: the 8 lanes of a quarter warp, 2 columns x 4 rows, hit the
// 8 chunks of a 128-byte row.  Column n of n-tile j is voxel
// 4 col_chunk(n) + j.
__device__ __forceinline__ int col_chunk(int n) {
  return ((n & 1) << 2) | (n >> 1);
}

// A fragment row m (0..15) of m-tile mt is block voxel row_voxel: the
// rows g (and g + 8) that a load reads over 4 rows of T fall on
// distinct banks under the 64-byte (TB=16) and 128-byte (TB=32)
// swizzles.
template <int TB>
__device__ __forceinline__ int row_voxel(int mt, int m) {
  return 4 * ((m >> 3) + 2 * mt + (TB / 8) * ((m >> 2) & 1)) + (m & 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
}

// box (c0, t0, e0) of a 3-d tensor map into dst, completing on bar
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int t0,
                                         int e0 = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(t0), "r"(e0),
      "r"(smem_addr(bar))
      : "memory");
}

// fp32 -> TF32 to nearest, ties away from zero: the rounding of
// cvt.rna.tf32.f32, bit for bit on finite values, in two integer
// operations (half an ulp of TF32 added to the magnitude, the 13 low
// bits cleared); measured faster than cvt.rna on the H100.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// hi = tf32(x) to nearest, ties away; lo = x - hi unrounded: the
// tensor core reads a .tf32 operand's 19 high bits
__device__ __forceinline__ void split(float x, unsigned& hi,
                                      unsigned& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b, one m16n8k8 TF32 product with an fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Whether encode_map takes p with these strides (floats): 16-byte
// aligned, positive strides that are multiples of 4
bool tma_operand(const float* p, int ld_t, int ld_e) {
  return (reinterpret_cast<size_t>(p) & 15) == 0 && ld_t > 0 &&
         ld_e > 0 && ld_t % 4 == 0 && ld_e % 4 == 0;
}

// A tensor map of src [E, T, ncols] (float32; a row of T every ld_t
// floats and an epoch every ld_e, both multiples of 4, src 16-byte
// aligned) whose box is [ept, rows, n] with the swizzle `swizzled`
// reads; out-of-range elements load as 0.  False if the encoding is
// refused.
bool encode_map(CUtensorMap* map, const float* src, int E, int T,
                int ncols, int n, int ept, int rows, size_t ld_t,
                size_t ld_e) {
  static const PFN_cuTensorMapEncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)ncols, (cuuint64_t)T,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)ld_t * sizeof(float),
                                 (cuuint64_t)ld_e * sizeof(float)};
  const cuuint32_t box[3] = {(cuuint32_t)n, (cuuint32_t)rows,
                             (cuuint32_t)ept};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(src), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                n == 32   ? CU_TENSOR_MAP_SWIZZLE_128B
                : n == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
