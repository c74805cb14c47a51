// The one-tile tensor-core body that K1 (fcma_gram_tc.cu) and K4
// (fcma_sample_gram_tc.cu) share, for NVIDIA Hopper (sm_90a): the
// stage ring's constants and shared-memory layout, the 3xTF32 products
// of one stage (mma_stage), the clamped Fisher-z of the accumulators
// into the z tile (fisher_store) and the Gram of one voxel tile on
// GramLane's fp32 FMA micro-tile (gram_tile), and K1's sum of its
// partial Grams over V splits (gram_sum_kernel, which K1's multi-tile
// route, fcma_gram_tcm.cu, launches too).  The design they serve is set
// out in fcma_gram_tc.cu.  Last, the near-one rule on the one-tile
// layout, which K4's route (fcma_sample_gram_tc.cu) applies: a
// correlation with |r| >= kNearOne formed again in fp32 FMA (near_one
// and refine_near_one, on fcma_tile.cuh's fisher_fma).

#pragma once

#include "fcma_tile.cuh"
#include "tc_common.cuh"

namespace {

// rows of T a stage holds and stages in the ring (measured: 8 rows
// and 3 stages at least as fast as 16 rows or 2 and 4 stages where
// those fit)
constexpr int kKT = 8;
constexpr int kStages = 3;

template <int EPT, int TB>
struct TcTile {
  static constexpr int kMT = TB / 16;           // m16 tiles per epoch
  static constexpr int kEW = 2 / kMT;           // epochs a warp owns
  static_assert(EPT * kMT == 2 * (kThreads / 32), "two units a warp");
  static constexpr int kDs = EPT * kKT * kTV;   // data floats a stage
  static constexpr int kBs = EPT * kKT * TB;    // block floats a stage
  static constexpr int kStage = kDs + kBs;
  static_assert(kDs * sizeof(float) % 1024 == 0 &&
                    kStage * sizeof(float) % 1024 == 0,
                "stages and their boxes on 1024-byte swizzle periods");
  // stages, the z tile, one mbarrier a stage
  static constexpr int kSmem =
      (kStages * kStage + TB * EPT * kZS) * (int)sizeof(float) +
      kStages * 8;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// One stage of kKT rows: acc[u][j] += the 3xTF32 products of the
// warp's units.  Fragments (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4,
// q = lane % 4: A rows g and g + 8, columns (k) q and q + 4; B rows
// (k) q and q + 4, column g.  Rows and columns map to voxels by
// row_voxel and col_chunk.
template <int EPT, int TB>
__device__ __forceinline__ void mma_stage(const float* st, int warp,
                                          int g, int q, int E,
                                          float (&acc)[2][4][4]) {
  using Tl = TcTile<EPT, TB>;
#pragma unroll
  for (int ks = 0; ks < kKT; ks += 8) {
    const int r0 = ks + q;
    const int r1 = r0 + 4;
#pragma unroll
    for (int ew = 0; ew < Tl::kEW; ++ew) {
      const int e = warp * Tl::kEW + ew;
      if (e >= E) continue;  // warp-uniform
      const float* ds = st + e * kKT * kTV;
      const int cg = 4 * col_chunk(g);
      const float4 x0 =
          *reinterpret_cast<const float4*>(ds + swizzled<kTV>(r0, cg));
      const float4 x1 =
          *reinterpret_cast<const float4*>(ds + swizzled<kTV>(r1, cg));
      const float bv0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float bv1[4] = {x1.x, x1.y, x1.z, x1.w};
      unsigned bh0[4], bl0[4], bh1[4], bl1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(bv0[j], bh0[j], bl0[j]);
        split_tf32(bv1[j], bh1[j], bl1[j]);
      }
      const float* bs = st + Tl::kDs + e * kKT * TB;
#pragma unroll
      for (int mt = 0; mt < Tl::kMT; ++mt) {
        const int b = row_voxel<TB>(mt, g);
        const int b8 = row_voxel<TB>(mt, g + 8);
        const float av[4] = {bs[swizzled<TB>(r0, b)],
                             bs[swizzled<TB>(r0, b8)],
                             bs[swizzled<TB>(r1, b)],
                             bs[swizzled<TB>(r1, b8)]};
        unsigned ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], al[i]);
        float(&c)[4][4] = acc[ew * Tl::kMT + mt];
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(c[j], al, bh0[j], bh1[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(c[j], ah, bl0[j], bl1[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(c[j], ah, bh0[j], bh1[j]);
      }
    }
  }
}

// The clamped Fisher-z of the accumulators into zs[b][e][v] (z = 0 for
// epochs e >= E and voxels past V), and the accumulators zeroed.
// Accumulator i of n-tile j: row g + 8 (i / 2), column 2q + i % 2.
template <int EPT, int TB>
__device__ __forceinline__ void fisher_store(float (&acc)[2][4][4],
                                             float* zs, int warp, int g,
                                             int q, int E, int V,
                                             int v0) {
  using Tl = TcTile<EPT, TB>;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = warp * Tl::kEW + u / Tl::kMT;
    const int mt = u % Tl::kMT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = row_voxel<TB>(mt, g + 8 * (i >> 1));
        const int v = 4 * col_chunk(2 * q + (i & 1)) + j;
        float z = 0.f;
        if (e < E && v0 + v < V) {
          float num = 1.f + acc[u][j][i];
          float den = 1.f - acc[u][j][i];
          if (num <= 0.f) num = kClamp;
          if (den <= 0.f) den = kClamp;
          z = 0.5f * logf(num / den);
        }
        zs[(b * EPT + e) * kZS + v] = z;
        acc[u][j][i] = 0.f;
      }
    }
  }
}

// g += zn zn^T over the tile's 32 voxels: the micro-tile of
// accumulate_gram (fcma_tile.cuh) on the one-tile z layout.
template <int EPT>
__device__ __forceinline__ void gram_tile(
    const float* zs, const GramLane<EPT>& lane,
    float (&gr)[4][GramLane<EPT>::GF]) {
  constexpr int GF = GramLane<EPT>::GF;
  const float* za = &zs[(lane.gb * EPT + lane.eq * 4) * kZS];
  const float* zc = &zs[(lane.gb * EPT + lane.fo * GF) * kZS];
#pragma unroll 4
  for (int v = 0; v < kTV; ++v) {
    float a[4];
    float c[GF];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = za[i * kZS + v];
#pragma unroll
    for (int j = 0; j < GF; ++j) c[j] = zc[j * kZS + v];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < GF; ++j) gr[i][j] = fmaf(a[i], c[j], gr[i][j]);
  }
}

// out[b, e, f] = the sum over splits, in split order, of the partials
// [nsplit, B, ept, ept]
__global__ void gram_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int E, int B,
                                int ept, int nsplit) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * E * E) return;
  const int f = (int)(idx % E);
  const int e = (int)(idx / E % E);
  const size_t b = idx / ((size_t)E * E);
  const size_t per_split = (size_t)B * ept * ept;
  const float* p = partial + (b * ept + e) * ept + f;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += p[k * per_split];
  out[idx] = s;
}

// Bit (u * 4 + j) * 4 + i set where |acc[u][j][i]| >= kNearOne
__device__ __forceinline__ unsigned near_one(const float (&acc)[2][4][4]) {
  unsigned near = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    near |= (unsigned)(fabsf(acc[k / 16][k / 4 % 4][k % 4]) >= kNearOne)
            << k;
  return near;
}

// For each bit of `near` (rare: a voxel with itself or a near copy),
// the z tile's entry that fisher_store wrote from that accumulator
// replaced by fisher_fma of blk[e, :, b] and data[e, :, v].
// Samples past N, block voxels past B and voxels past V load as 0, so
// their accumulators are never flagged and every read is in range.
template <int EPT, int TB>
__device__ void refine_near_one(unsigned near, float* zs,
                                const float* __restrict__ blk,
                                const float* __restrict__ data, int warp,
                                int g, int q, int T, int b0, int v0,
                                int blk_ld_t, int blk_ld_e, int data_ld_t,
                                int data_ld_e) {
  using Tl = TcTile<EPT, TB>;
  for (; near != 0; near &= near - 1) {
    const int k = __ffs(near) - 1;
    const int u = k / 16;
    const int j = k / 4 % 4;
    const int i = k % 4;
    const int e = warp * Tl::kEW + u / Tl::kMT;
    const int b = row_voxel<TB>(u % Tl::kMT, g + 8 * (i >> 1));
    const int v = 4 * col_chunk(2 * q + (i & 1)) + j;
    zs[(b * EPT + e) * kZS + v] =
        fisher_fma(blk + (size_t)e * blk_ld_e + b0 + b,
                   data + (size_t)e * data_ld_e + v0 + v, T, blk_ld_t,
                   data_ld_t);
  }
}

}  // namespace
