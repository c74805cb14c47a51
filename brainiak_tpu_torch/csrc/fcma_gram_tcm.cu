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
// Design.  The body up to the Gram (ring, products, z tile, Fisher-z
// and z-score) is tc_gram_m.cuh's, which K4's multi-tile route
// (fcma_sample_gram_tcm.cu) shares; the per-voxel Gram is this file's.
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

#include "tc_gram_m.cuh"

namespace {

// gr[s] += the 8 x 8 micro-tile of slot s over voxel pairs p_lo..p_hi
// - 1 (voxels 2 p, 2 p + 1, in order) of the z tile: epochs ea[s].. x
// eb[s].. of the warp's block voxel, slots below n_mine (gram_pair).
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
      gram_pair(zb + Tcm::z_row(ea[s]) + v, zb + Tcm::z_row(eb[s]) + v,
                gr[s]);
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
  using Tw = Warps<W>;
  // 1024-byte aligned: the TMA's 128-byte swizzle repeats every 1024
  extern __shared__ __align__(1024) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

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

  // slice j of n of a whole tile's voxel pairs into the warp's block
  // voxel's micro-tiles
  tcm_tiles<W, kTile>(tmap_data, tmap_blk, blk, data, smem, E, T, V, eps,
                      tiles_per_split, blk_ld_t, blk_ld_e, data_ld_t,
                      data_ld_e,
                      [&](const float* zs, int zst, int j, int n) {
                        gram_m<W, S>(zs, zst, warp, j * (kTV / 2) / n,
                                     (j + 1) * (kTV / 2) / n, ea, eb,
                                     n_mine, gr);
                      });

  // one [E, E] partial per (split, block voxel), the lower triangle
  // mirrored from the upper
  const int bg = blockIdx.y * Tcm::kMB + warp / Tw::kGW;
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
