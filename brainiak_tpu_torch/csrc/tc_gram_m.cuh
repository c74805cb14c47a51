// The multi-tile tensor-core body that K1 (fcma_gram_tcm.cu) and K4
// (fcma_sample_gram_tcm.cu) share, for NVIDIA Hopper (sm_90a): the
// stage ring's constants and the z tile's layout (Tcm), the block's
// warps (Warps), the 3xTF32 products of one stage (mma_stage_m), the
// accumulators into the z tile (store_r), the Fisher-z and z-score of
// each subject in it (fisher_normalize), the Gram's 8 x 8 micro-tile
// of one voxel pair (gram_pair), and the run of a block over its voxel
// tiles through the TMA ring with per-warp empty mbarriers (tcm_tiles),
// which hands each whole tile's z to the kernel's own Gram.  The
// design they serve is set out in fcma_gram_tcm.cu; the TMA and 3xTF32
// helpers are tc_common.cuh's, the near-one rule (fisher_fma,
// kNearOne) fcma_tile.cuh's.

#pragma once

#include "tc_gram.cuh"

namespace {

struct Tcm {
  static constexpr int kMaxE = 104;
  static constexpr int kMB = 8;      // block voxels: the n8 of m16n8k8
  static constexpr int kMEG = 16;    // epochs a stage
  static constexpr int kMRows = 16;  // rows of T a stage
  static constexpr int kMStages = 3;
  static constexpr int kDs = kMEG * kMRows * kTV;  // data floats a stage
  static constexpr int kStage = kDs + kMEG * kMRows * kMB;
  static_assert(kMRows % 8 == 0, "whole k-steps and swizzle periods");
  static_assert(kDs * sizeof(float) % 1024 == 0 &&
                    kStage * sizeof(float) % 1024 == 0,
                "stages and their boxes on 1024-byte swizzle periods");

  // The z tile is zs[b][e][v]: epoch e of a block voxel starts z_row(e)
  // floats into its rows, 32 voxels a row and 2 pad floats after every
  // 8 epochs, so that the 8-epoch rows a warp's Gram loads read fall
  // on other banks; a block voxel takes z_stride(E) floats, E rounded
  // up to whole 8 x 8 micro-tiles (the padding epochs hold 0), even, so
  // its rows start 8-byte aligned.
  __host__ __device__ static constexpr int z_row(int e) {
    return e * kTV + (e >> 3) * 2;
  }
  __host__ __device__ static constexpr int z_stride(int E) {
    return z_row((E + 7) / 8 * 8);
  }
  // stages, the z tile, a full and an empty mbarrier a stage
  __host__ __device__ static constexpr int smem(int E) {
    return (kMStages * kStage + kMB * z_stride(E)) * (int)sizeof(float) +
           kMStages * 16;
  }
};
static_assert(Tcm::smem(Tcm::kMaxE) <= 232448 &&
                  Tcm::smem(Tcm::kMaxE + 1) > 232448,
              "kMaxE: the most epochs shared memory holds");

// A block of W warps: kEW epochs of a stage a warp, kGW warps (kGL
// lanes) a block voxel's Gram
template <int W>
struct Warps {
  static constexpr int kThreads = 32 * W;
  static constexpr int kEW = Tcm::kMEG / W;
  static constexpr int kGW = W / Tcm::kMB;
  static constexpr int kGL = 32 * kGW;
  static_assert(kEW * W == Tcm::kMEG && kGW * Tcm::kMB == W,
                "whole epochs a warp, whole warps a block voxel");
};

// One stage: acc[u][mt] += the 3xTF32 products of the stage's epoch
// kEW warp + u (if below n_ep) and m-tile mt over the stage's first
// n_rows rows (the k-steps wholly past T, zero-filled, are skipped).
// Fragments (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, q = lane % 4:
// A rows (voxels) g and g + 8, columns (k) q and q + 4; B rows (k) q
// and q + 4, column (block voxel) g.
template <int W>
__device__ __forceinline__ void mma_stage_m(
    const float* st, int warp, int g, int q, int n_rows, int n_ep,
    float (&acc)[Warps<W>::kEW][2][4]) {
  constexpr int kEW = Warps<W>::kEW;
  const int cg = 4 * col_chunk(g);
#pragma unroll
  for (int ks = 0; ks < Tcm::kMRows; ks += 8) {
    if (ks >= n_rows) break;  // block-uniform
    const int r0 = ks + q;
    const int r1 = r0 + 4;
#pragma unroll
    for (int u = 0; u < kEW; ++u) {
      const int el = kEW * warp + u;
      if (el >= n_ep) continue;  // warp-uniform
      const float* ds = st + el * Tcm::kMRows * kTV;
      const float* bs = st + Tcm::kDs + el * Tcm::kMRows * Tcm::kMB;
      const float4 x0 =
          *reinterpret_cast<const float4*>(ds + swizzled<kTV>(r0, cg));
      const float4 x1 =
          *reinterpret_cast<const float4*>(ds + swizzled<kTV>(r1, cg));
      const float av[2][4] = {{x0.x, x0.y, x1.x, x1.y},
                              {x0.z, x0.w, x1.z, x1.w}};
      unsigned bh0, bl0, bh1, bl1;
      split(bs[r0 * Tcm::kMB + g], bh0, bl0);
      split(bs[r1 * Tcm::kMB + g], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        unsigned ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(av[mt][i], ah[i], al[i]);
        mma_tf32(acc[u][mt], al, bh0, bh1);
        mma_tf32(acc[u][mt], ah, bl0, bl1);
        mma_tf32(acc[u][mt], ah, bh0, bh1);
      }
    }
  }
}

// The accumulators, r itself, into zs[b][e][v] (epochs past E are
// not stored), and zeroed.  Accumulator i of m-tile mt: voxel row
// g + 8 (i / 2), block-voxel column 2q + i % 2.
template <int W>
__device__ __forceinline__ void store_r(float (&acc)[Warps<W>::kEW][2][4],
                                        float* zs, int zst, int warp,
                                        int g, int q, int e0, int E) {
#pragma unroll
  for (int u = 0; u < Warps<W>::kEW; ++u) {
    const int e = e0 + Warps<W>::kEW * warp + u;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e < E)  // warp-uniform
          zs[(2 * q + (i & 1)) * zst + Tcm::z_row(e) + 4 * col_chunk(g) +
             2 * mt + (i >> 1)] = acc[u][mt][i];
        acc[u][mt][i] = 0.f;
      }
    }
  }
}

// Each (block voxel b, voxel v, subject) run of eps epochs of the z
// tile, r in, zn out: the clamped Fisher-z, then the z-score over the
// run (fcma_tile.cuh's expressions, epochs in order).  The voxels of a
// warp's items are consecutive, so their accesses are one row.  An
// |r| >= kNearOne is formed again from blk and data first
// (fisher_fma); block voxels past B and voxels past V load as 0, so
// theirs are never flagged, and their z = 0.5 logf(1) and zn are
// exactly 0.
template <int W>
__device__ __forceinline__ void fisher_normalize(
    float* zs, int zst, int E, int T, int eps, int b0, int v0,
    const float* __restrict__ blk, const float* __restrict__ data,
    int blk_ld_t, int blk_ld_e, int data_ld_t, int data_ld_e) {
  constexpr int kRowsZ = Tcm::kMB * kTV;
  const int n_items = kRowsZ * (E / eps);
  const float inv_n = 1.f / (float)eps;
  for (int item = threadIdx.x; item < n_items;
       item += Warps<W>::kThreads) {
    const int v = item % kTV;
    const int b = item / kTV % Tcm::kMB;
    const int e0 = item / kRowsZ * eps;
    float* zb = zs + b * zst + v;
    bool near = false;
#pragma unroll 4
    for (int k = 0; k < eps; ++k)
      near |= fabsf(zb[Tcm::z_row(e0 + k)]) >= kNearOne;
    float sum = 0.f;
    float sq = 0.f;
    if (!near) {
#pragma unroll 4
      for (int k = 0; k < eps; ++k) {
        float* zp = zb + Tcm::z_row(e0 + k);
        const float z = fisher_z(*zp);
        *zp = z;
        sum += z;
        sq = fmaf(z, z, sq);
      }
    } else {  // rare: a voxel with itself, or a near copy
      for (int k = 0; k < eps; ++k) {
        const int e = e0 + k;
        float* zp = zb + Tcm::z_row(e);
        const float z =
            fabsf(*zp) >= kNearOne
                ? fisher_fma(blk + (size_t)e * blk_ld_e + b0 + b,
                             data + (size_t)e * data_ld_e + v0 + v, T,
                             blk_ld_t, data_ld_t)
                : fisher_z(*zp);
        *zp = z;
        sum += z;
        sq = fmaf(z, z, sq);
      }
    }
    const float mean = sum * inv_n;
    const float var = sq * inv_n - mean * mean;
    const float inv = var <= 0.f ? 0.f : 1.0f / sqrtf(var);
#pragma unroll 4
    for (int k = 0; k < eps; ++k) {
      float* zp = zb + Tcm::z_row(e0 + k);
      *zp = (*zp - mean) * inv;
    }
  }
}

// g += the 8 x 8 micro-tile of one voxel pair of the z tile: the 8
// rows from za (epochs) x the 8 rows from zc, each an 8-byte load of
// two voxels, the first voxel's product before the second's.  The
// lanes of a warp read 8-epoch blocks whose rows z_row puts on other
// banks.
__device__ __forceinline__ void gram_pair(const float* za, const float* zc,
                                          float (&g)[8][8]) {
  float2 a[8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
    a[x] = *reinterpret_cast<const float2*>(za + x * kTV);
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const float2 c = *reinterpret_cast<const float2*>(zc + y * kTV);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      g[x][y] = fmaf(a[x].x, c.x, g[x][y]);
      g[x][y] = fmaf(a[x].y, c.y, g[x][y]);
    }
  }
}

// A block's run: block voxels blockIdx.y * kMB.. and the V split
// blockIdx.x of tiles_per_split voxel tiles, E epochs in groups of kMEG
// a stage and T in chunks of kMRows rows through the ring; smem holds
// the stages, the z tile and the mbarriers (Tcm::smem).  Per voxel
// tile, every correlation goes into the z tile once; with NORM kTile
// each subject of eps epochs is then Fisher-z'd and z-scored there
// (fisher_normalize; kRaw keeps r).  The z of a whole tile is handed to
// the kernel's Gram, gram(zs, zst, j, n) taking slice j of n: one slice
// a chunk of the next tile's first epoch group (whose r reaches the z
// tile only at the group's end), so that the ring keeps loading while
// it runs, and after the last tile slice 0 of 1.
template <int W, int NORM, class Gram>
__device__ __forceinline__ void tcm_tiles(
    const CUtensorMap& tmap_data, const CUtensorMap& tmap_blk,
    const float* __restrict__ blk, const float* __restrict__ data,
    float* smem, int E, int T, int V, int eps, int tiles_per_split,
    int blk_ld_t, int blk_ld_e, int data_ld_t, int data_ld_e,
    Gram&& gram) {
  using Tl = Tcm;
  using Tw = Warps<W>;
  const int zst = Tl::z_stride(E);
  float* zs = smem + Tl::kMStages * Tl::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(zs + Tl::kMB * zst);
  uint64_t* empty = full + Tl::kMStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int b0 = blockIdx.y * Tl::kMB;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int n_tiles =
      max(0, min(n_vtiles, t_begin + tiles_per_split) - t_begin);
  const int n_groups = (E + Tl::kMEG - 1) / Tl::kMEG;
  const int n_chunks = (T + Tl::kMRows - 1) / Tl::kMRows;
  const int per_tile = n_groups * n_chunks;
  const int total = n_tiles * per_tile;
  constexpr unsigned kStageBytes = Tl::kStage * sizeof(float);

  // chunk c of the block's run: rows (c % n_chunks) * kMRows.. of
  // epoch group c / n_chunks % n_groups of voxel tile
  // t_begin + c / per_tile, into stage c % kMStages
  auto fetch = [&](int c) {
    if (c < total) {
      const int t0 = c % n_chunks * Tl::kMRows;
      const int e0 = c / n_chunks % n_groups * Tl::kMEG;
      const int v0 = (t_begin + c / per_tile) * kTV;
      float* st = smem + c % Tl::kMStages * Tl::kStage;
      uint64_t* bar = full + c % Tl::kMStages;
      mbar_expect_tx(bar, kStageBytes);
      tma_load(st, &tmap_data, bar, v0, t0, e0);
      tma_load(st + Tl::kDs, &tmap_blk, bar, b0, t0, e0);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < Tl::kMStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, W);
    }
    // the barriers are visible to the async proxy (the TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the padding epochs of the z tile read as 0 by the Gram
  for (int i = threadIdx.x; i < Tl::kMB * zst; i += Tw::kThreads)
    zs[i] = 0.f;
  __syncthreads();

  float acc[Tw::kEW][2][4];
#pragma unroll
  for (int u = 0; u < Tw::kEW; ++u)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][mt][i] = 0.f;

  if (threadIdx.x == 0)
    for (int c = 0; c < Tl::kMStages; ++c) fetch(c);
  bool gram_due = false;  // the z tile holds a tile whose Gram is owed
  for (int c = 0; c < total; ++c) {
    const int chunk = c % n_chunks;
    const int grp = c / n_chunks % n_groups;
    mbar_wait(full + c % Tl::kMStages, (c / Tl::kMStages) & 1);
    mma_stage_m<W>(smem + c % Tl::kMStages * Tl::kStage, warp, g, q,
                   T - chunk * Tl::kMRows, E - grp * Tl::kMEG, acc);
    // the warp is done with the stage; the last warp's arrival frees it
    // for its refill
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % Tl::kMStages);
    if (threadIdx.x == 0 && c + Tl::kMStages < total) {
      mbar_wait(empty + c % Tl::kMStages, (c / Tl::kMStages) & 1);
      fetch(c + Tl::kMStages);
    }
    // the last tile's Gram, a slice of voxels a chunk of the first
    // group, so that the ring keeps loading while it runs
    if (gram_due) gram(zs, zst, chunk, n_chunks);
    if (chunk != n_chunks - 1) continue;
    // the group's correlations are whole
    if (grp == 0) {
      gram_due = false;
      __syncthreads();  // every warp is done with the last tile's Gram
    }
    store_r<W>(acc, zs, zst, warp, g, q, grp * Tl::kMEG, E);
    if (grp != n_groups - 1) continue;
    // the tile's r is whole: every subject's epochs are in it
    __syncthreads();
    if constexpr (NORM != kRaw) {
      fisher_normalize<W>(zs, zst, E, T, eps, b0,
                          (t_begin + c / per_tile) * kTV, blk, data,
                          blk_ld_t, blk_ld_e, data_ld_t, data_ld_e);
      __syncthreads();
    }
    gram_due = true;
  }
  if (gram_due) gram(zs, zst, 0, 1);
}

}  // namespace
