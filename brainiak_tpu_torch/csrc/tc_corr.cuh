// The tensor-core body that K3's two tensor-core kernels share, for
// NVIDIA Hopper (sm_90a): fcma_corr_tc.cu (subjects of at most
// kMaxEps = 4 epochs, all of them in a thread's registers) and
// fcma_corr_tcl.cu (longer subjects, in chunks of kMaxEps epochs).
// The tile and ring constants, the 3xTF32 products of one stage
// (mma_stage), the 16-byte store of a thread's 4 consecutive voxels
// (store4) and the persistent grid (persistent_grid).  The design they
// serve is set out in fcma_corr_tc.cu.

#pragma once

#include <climits>

#include "fcma_tile.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kMaxEps = 4;    // epochs of a subject a thread holds
constexpr int kBoxCols = 32;  // columns of a TMA box: 128-byte rows
// the tile and the ring (PERF.md: 64-voxel tiles, two stages of 32 rows
// measured fastest at the host-CV shape)
constexpr int kWB = 8;      // warps along the block voxels, 16 each
constexpr int kWC = 2;      // warps along the voxels, 32 each
constexpr int kStages = 2;  // stages in the ring
constexpr int kKT = 32;     // rows of T a stage holds

struct CorrTc {
  static_assert(kWB % 2 == 0, "block voxels in boxes of 32");
  static_assert(kKT % 8 == 0, "whole k-steps and swizzle periods");
  static constexpr int kWarps = kWB * kWC;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTB = 16 * kWB;         // block voxels of an item
  static constexpr int kTV = kBoxCols * kWC;   // voxels of an item
  static constexpr int kBox = kMaxEps * kKT * kBoxCols;  // floats a box
  static constexpr int kStage = (kWC + kWB / 2) * kBox;
  // stages, then a full and an empty mbarrier a stage
  static constexpr int kSmem =
      kStages * kStage * (int)sizeof(float) + kStages * 16;
  static_assert(kSmem <= 232448, "shared memory of an SM");
};

// One stage: acc[e][j] += the 3xTF32 products of the warp's m16 tile of
// each of the EPS epochs over the stage's first n_rows rows (the k-steps
// wholly past T, zero-filled, are skipped).  ds, bs: the warp's data
// and block boxes;
// fragments (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, q = lane % 4:
// A rows g and g + 8 (block voxels b_lo, b_hi), columns (k) q and
// q + 4; B rows (k) q and q + 4, column g (voxels cg + j of n-tile j).
template <int EPS>
__device__ __forceinline__ void mma_stage(const float* ds, const float* bs,
                                          int n_rows, int q, int cg,
                                          int b_lo, int b_hi,
                                          float (&acc)[EPS][4][4]) {
#pragma unroll
  for (int ks = 0; ks < kKT; ks += 8) {
    if (ks >= n_rows) break;  // block-uniform
    const int r0 = ks + q;
    const int r1 = r0 + 4;
#pragma unroll
    for (int e = 0; e < EPS; ++e) {
      const float* de = ds + e * kKT * kBoxCols;
      const float* be = bs + e * kKT * kBoxCols;
      const float4 x0 = *reinterpret_cast<const float4*>(
          de + swizzled<kBoxCols>(r0, cg));
      const float4 x1 = *reinterpret_cast<const float4*>(
          de + swizzled<kBoxCols>(r1, cg));
      const float bv0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float bv1[4] = {x1.x, x1.y, x1.z, x1.w};
      unsigned bh0[4], bl0[4], bh1[4], bl1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(bv0[j], bh0[j], bl0[j]);
        split(bv1[j], bh1[j], bl1[j]);
      }
      const float av[4] = {be[swizzled<kBoxCols>(r0, b_lo)],
                           be[swizzled<kBoxCols>(r0, b_hi)],
                           be[swizzled<kBoxCols>(r1, b_lo)],
                           be[swizzled<kBoxCols>(r1, b_hi)]};
      unsigned ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
      float(&c)[4][4] = acc[e];
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(c[j], al, bh0[j], bh1[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(c[j], ah, bl0[j], bl1[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(c[j], ah, bh0[j], bh1[j]);
    }
  }
}

// out[row, v..v + 3] = x, the voxels past V left out; a 16-byte
// streaming store where vec (V % 4 == 0, out aligned)
__device__ __forceinline__ void store4(float* __restrict__ out, size_t row,
                                       int v, int V, bool vec,
                                       const float (&x)[4]) {
  float* dst = out + row * V + v;
  if (vec && v < V) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (v + j < V) __stcs(dst + j, x[j]);
  }
}

// The grid of a persistent kernel of CorrTc's block and shared memory:
// as many blocks as fit the SMs at once, at most n_items (refused
// beyond an int).  Sets the kernel's dynamic shared memory.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, long long n_items, int& grid) {
  using Tl = CorrTc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  int n_sm = 0;
  int per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, Tl::kThreads, Tl::kSmem)) != cudaSuccess)
    return err;
  if (n_items > INT_MAX) return cudaErrorInvalidValue;
  const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * n_sm;
  grid = (int)(n_items < fit ? n_items : fit);
  return cudaSuccess;
}

}  // namespace
