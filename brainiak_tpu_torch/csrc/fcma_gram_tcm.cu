// K1 on its multi-tile route: fused FCMA correlation + Fisher-z +
// within-subject normalization + per-voxel Gram for NVIDIA Hopper
// (sm_90a), every correlation formed once, on the tensor cores in
// 3xTF32, with the operands brought in by the TMA.
//
// Replaces, for designs of more than one epoch tile (more than 32
// epochs, or subjects longer than a tile) of at most kMaxE = 104 epochs
// (ops/fcma_kernels.py gram_route "tcm"), the Pallas kernel
// brainiak_tpu/ops/pallas_kernels.py:223 fcma_gram (_gram_kernel +
// _normalized_corr_tile) at E > 32.  One epoch tile takes
// fcma_gram_tc.cu, more than kMaxE epochs fcma_corr.cu.  The Pallas
// kernel holds all E epochs of a block in VMEM and forms each
// correlation once; so does this kernel, in shared memory.
//
// Inputs: blk [E, T, B] and data [E, T, V], float32, epoch-normalized,
// 16-byte aligned, a row of T every ld_t floats and an epoch every ld_e
// floats (both multiples of 4, as the TMA needs; the wrapper copies an
// operand only where it breaks that).  Output: the unshrunk per-voxel
// Gram out[b] = sum_v zn[b, :, v] zn[b, :, v]^T, [B, E, E], with zn the
// clamped Fisher-z of r[b, e, v] = sum_t blk[e, t, b] data[e, t, v],
// z-scored across all the epochs of e's subject (eps of them, any eps
// that divides E).  zn never reaches device memory; partial Grams are
// summed over V splits in split order, no atomics.  Ragged edges: rows
// t >= T and voxels past B or V load as 0 (the TMA's out-of-range
// fill), voxels past V get z = 0, rows past B are not written.
//
// Precision.  3xTF32 as fcma_corr_tc.cu: each operand split into
// hi = tf32(x) (to nearest, ties away) and lo = x - hi, passed
// unrounded (the tensor core reads its 19 high bits), the products
// lo*hi + hi*lo + hi*hi accumulated in that order in fp32.  A
// correlation with |r| >= kNearOne = 1 - 2^-10 is formed again in fp32
// FMA, t ascending, before its Fisher-z (fisher_fma, fcma_tile.cuh, K4's
// rule): at a voxel paired with itself (r = 1) the clamped Fisher-z
// turns the last ulp of r into 4.95 against 8.66, and the z-score
// carries that into the subject.  The Fisher-z and z-score are
// fcma_tile.cuh's expressions, the Gram fp32 FMA.  Built without
// --use_fast_math.
//
// Bound at the E=80 row (80 epochs, 40 a subject, T=150, B=512,
// V=4096): operations.  The correlation's 3 x 50.33 GFLOP on the TF32
// tensor cores at 494.7 TFLOP/s is 0.305 ms, plus the Gram's
// E (E + 1) / 2 distinct entries, 13.59 GFLOP in fp32 at 67 TFLOP/s,
// 0.203 ms: 0.508 ms.  The bytes (inputs once, output once) are 234
// MB, 0.070 ms.  From L2, though, each block re-reads its voxel tiles'
// data rows (reused by its kMB = 8 block voxels) and its block voxels'
// rows (reused by 32 voxels): E T 4 (B V / 8 + B V / 32) bytes, 15.7
// GB at that shape.
//
// kMaxE = 104 is what shared memory allows: the ring of three 40 KB
// stages and the z tile, kMB x z_stride(E) floats (E rounded up to 8
// rows of 32 voxels, 2 pad floats every 8 rows), fit a block's 227 KB
// up to E = 104 and not at 105.  The registers agree: the Gram's 8 x 8
// micro-tiles take one a lane at 16 warps up to E = 80, three at 8
// warps up to E = 104 (192 accumulators of the 255 a thread), four
// beyond.
//
// Design.
//   * A block owns kMB = 8 block voxels (the n8 of mma.m16n8k8) and a V
//     split of 32-voxel tiles, as fcma_gram_tc.cu, but the splits are
//     the grid's x: the blocks in flight are every split of a few
//     block-voxel groups, whose rows (re-read for every voxel tile)
//     and current voxel tiles both stay in L2.  Per voxel tile it forms
//     the correlations of all E epochs into a z tile zs[b][e][v] in
//     shared memory: [8 x T] . [T x 32] per epoch, the 32 data voxels
//     as two m16 tiles (M) and the block voxels as N.  Fewer block
//     voxels a block than the one-tile kernel's 16 or 32: that is what
//     lets all E epochs' z tile and the E (E + 1) / 2 Gram entries of
//     each block voxel fit shared memory and registers.
//   * W = 16 warps up to E = 80, 8 beyond (the Gram's registers).  The
//     epochs go through the ring in groups of kMEG = 16, each warp
//     owning 16 / W epochs of a group and both m-tiles.  T streams
//     through kMStages stages of kMRows rows; one thread fills a stage
//     with two TMA tensor copies, boxes [16, 16, 32] of data (128-byte
//     rows, swizzled) and [16, 16, 8] of blk (32-byte rows,
//     unswizzled), on the stage's full mbarrier.  Each warp, done with
//     a stage, arrives on its empty mbarrier, and the filling thread
//     waits there before the refill (fcma_corr_tc.cu's ring): no block
//     barrier a stage.  The ring runs on across groups and voxel tiles.
//   * A fragment row m of m-tile mt is voxel 4 col_chunk(m % 8) + 2 mt
//     + m / 8, so a thread's A fragments of one row for both m-tiles
//     are one 16-byte load, and a warp's loads hit 32 distinct banks
//     under the 128-byte swizzle; the B fragments (rows q, q + 4 of 8
//     block voxels, 32 bytes a row) hit 32 distinct banks unswizzled.
//   * At the end of a group the accumulators, r itself, go into the z
//     tile.  At the end of a voxel tile every subject is whole in it,
//     and one pass takes each (block voxel, voxel, subject) run through
//     the Fisher-z and the z-score: no statistics pass.  One Fisher-z
//     pass a tile, not one a group, so the ring drains once a tile.
//   * The Gram: W / 8 warps take one block voxel's upper triangle in 8
//     x 8 micro-tiles of fp32 FMA, from 8-byte loads of
//     zs[b][8i..8i+7][v, v+1], accumulated in registers over the
//     block's voxel tiles and written once, mirrored, as one [E, E]
//     partial a (split, block voxel).  A tile's Gram runs in slices of
//     voxels, one a chunk of the next tile's first epoch group (whose
//     r reaches the z tile only at the group's end), so that the ring
//     keeps loading while it runs.

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

// gr[s] += the 8 x 8 micro-tile of slot s over voxel pairs p_lo..p_hi
// - 1 (voxels 2 p, 2 p + 1, in order) of the z tile: epochs ea[s].. x
// eb[s].. of the warp's block voxel, slots below n_mine.  8-byte loads
// of two voxels; the lanes of a warp read 8-epoch blocks whose rows
// z_row puts on other banks.
template <int W, int S>
__device__ __forceinline__ void gram_m(const float* zs, int zst, int warp,
                                       int p_lo, int p_hi,
                                       const int (&ea)[S],
                                       const int (&eb)[S], int n_mine,
                                       float (&gr)[S][8][8]) {
  const float* zb = zs + warp / Warps<W>::kGW * zst;
  for (int v = 2 * p_lo; v < 2 * p_hi; v += 2) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s >= n_mine) break;
      const float* za = zb + Tcm::z_row(ea[s]) + v;
      const float* zc = zb + Tcm::z_row(eb[s]) + v;
      float2 a[8];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        a[x] = *reinterpret_cast<const float2*>(za + x * kTV);
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        const float2 c = *reinterpret_cast<const float2*>(zc + y * kTV);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          gr[s][x][y] = fmaf(a[x].x, c.x, gr[s][x][y]);
          gr[s][x][y] = fmaf(a[x].y, c.y, gr[s][x][y]);
        }
      }
    }
  }
}

// tmap_data, tmap_blk: tensor maps of data ([16, 16, 32] boxes) and
// blk ([16, 16, 8] boxes); blk and data themselves for fisher_fma.  W
// warps; S: 8 x 8 Gram micro-tiles a lane, at most.
template <int W, int S>
__global__ void __launch_bounds__(32 * W, 1)
fcma_gram_tcm_kernel(const __grid_constant__ CUtensorMap tmap_data,
                     const __grid_constant__ CUtensorMap tmap_blk,
                     const float* __restrict__ blk,
                     const float* __restrict__ data,
                     float* __restrict__ partial, int E, int T, int B,
                     int V, int eps, int tiles_per_split, int blk_ld_t,
                     int blk_ld_e, int data_ld_t, int data_ld_e) {
  using Tl = Tcm;
  using Tw = Warps<W>;
  // 1024-byte aligned: the TMA's 128-byte swizzle repeats every 1024
  extern __shared__ __align__(1024) float smem[];
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

  // the lane's Gram slots: micro-tiles gl, gl + kGL, .. of the upper
  // triangle of 8 x 8 blocks, row by row (decode_pair), gl the lane's
  // place among its block voxel's kGL
  const int gl = warp % Tw::kGW * 32 + lane;
  const int nb8 = (E + 7) / 8;
  const int n_micro = nb8 * (nb8 + 1) / 2;
  const int n_mine = gl < n_micro ? (n_micro - 1 - gl) / Tw::kGL + 1 : 0;
  int ea[S], eb[S];
  float gr[S][8][8];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    int i = 0, j = 0;
    if (s < n_mine) decode_pair(gl + Tw::kGL * s, nb8, &i, &j);
    ea[s] = 8 * i;
    eb[s] = 8 * j;
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y) gr[s][x][y] = 0.f;
  }
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
    if (gram_due)
      gram_m<W, S>(zs, zst, warp, chunk * (kTV / 2) / n_chunks,
                   (chunk + 1) * (kTV / 2) / n_chunks, ea, eb, n_mine,
                   gr);
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
    fisher_normalize<W>(zs, zst, E, T, eps, b0,
                        (t_begin + c / per_tile) * kTV, blk, data,
                        blk_ld_t, blk_ld_e, data_ld_t, data_ld_e);
    __syncthreads();
    gram_due = true;
  }
  if (gram_due)
    gram_m<W, S>(zs, zst, warp, 0, kTV / 2, ea, eb, n_mine, gr);

  // one [E, E] partial per (split, block voxel), the lower triangle
  // mirrored from the upper
  const int bg = b0 + warp / Tw::kGW;
  if (bg < B) {
    float* dst = partial + ((size_t)blockIdx.x * B + bg) * E * E;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s >= n_mine) break;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          const int e = ea[s] + x;
          const int f = eb[s] + y;
          if (e < E && f < E) {
            dst[e * E + f] = gr[s][x][y];
            if (ea[s] != eb[s]) dst[f * E + e] = gr[s][x][y];
          }
        }
      }
    }
  }
}

template <int W, int S>
int launch(const CUtensorMap& map_data, const CUtensorMap& map_blk,
           const float* blk, const float* data, float* partial,
           float* out, int E, int T, int B, int V, int eps, int nsplit,
           int blk_ld_t, int blk_ld_e, int data_ld_t, int data_ld_e,
           cudaStream_t s) {
  const int smem = Tcm::smem(E);
  cudaError_t err = cudaFuncSetAttribute(
      fcma_gram_tcm_kernel<W, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid(nsplit, (B + Tcm::kMB - 1) / Tcm::kMB);
  fcma_gram_tcm_kernel<W, S><<<grid, 32 * W, smem, s>>>(
      map_data, map_blk, blk, data, partial, E, T, B, V, eps, per_split,
      blk_ld_t, blk_ld_e, data_ld_t, data_ld_e);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == out) return (int)err;
  const size_t n = (size_t)B * E * E;
  const int threads = 256;
  gram_sum_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    s>>>(partial, out, E, B, E, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// E <= 104 epochs of subjects of eps epochs (E a multiple of eps); blk
// and data 16-byte aligned with row strides ld_t and epoch strides
// ld_e (floats, multiples of 4); partial is [nsplit, B, E, E] scratch,
// or out itself when nsplit is 1; out [B, E, E].
extern "C" int fcma_gram_tcm_f32(const float* blk, const float* data,
                                 float* partial, float* out, int E, int T,
                                 int B, int V, int eps, int nsplit,
                                 int blk_ld_t, int blk_ld_e, int data_ld_t,
                                 int data_ld_e, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E < 1 || E > Tcm::kMaxE || T < 0 || B < 0 || V < 0 || eps < 1 ||
      E % eps != 0 || nsplit < 1 || (partial == out) != (nsplit == 1) ||
      (B + Tcm::kMB - 1) / Tcm::kMB > 65535 ||  // gridDim.y
      !tma_operand(blk, blk_ld_t, blk_ld_e) ||
      !tma_operand(data, data_ld_t, data_ld_e))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (T == 0 || V == 0)  // every r is 0, and so is every z
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * B * E * E, s);
  CUtensorMap map_data, map_blk;
  if (!encode_map(&map_data, data, E, T, V, kTV, Tcm::kMEG, Tcm::kMRows,
                  data_ld_t, data_ld_e) ||
      !encode_map(&map_blk, blk, E, T, B, Tcm::kMB, Tcm::kMEG,
                  Tcm::kMRows, blk_ld_t, blk_ld_e))
    return (int)cudaErrorInvalidValue;
  // 16 warps, one 8 x 8 Gram micro-tile a lane, up to 64 micro-tiles
  // (E <= 80); else 8 warps, three a lane, up to 96 (E <= 104)
  const int nb8 = (E + 7) / 8;
  if (nb8 * (nb8 + 1) / 2 <= 64)
    return launch<16, 1>(map_data, map_blk, blk, data, partial, out, E, T,
                         B, V, eps, nsplit, blk_ld_t, blk_ld_e, data_ld_t,
                         data_ld_e, s);
  return launch<8, 3>(map_data, map_blk, blk, data, partial, out, E, T, B,
                      V, eps, nsplit, blk_ld_t, blk_ld_e, data_ld_t,
                      data_ld_e, s);
}
