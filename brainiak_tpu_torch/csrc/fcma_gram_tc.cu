// K1 on its one-epoch-tile route: fused FCMA correlation + Fisher-z +
// within-subject normalization + per-voxel Gram for NVIDIA Hopper
// (sm_90a), with the correlation on the tensor cores in 3xTF32 and the
// operands brought in by the TMA.
//
// Replaces, for E <= 32 epochs of whole subjects (one epoch tile, the
// route of both FCMA main-path shapes), the Pallas kernel
// brainiak_tpu/ops/pallas_kernels.py fcma_gram (_gram_kernel +
// _normalized_corr_tile).  Longer designs take fcma_corr.cu.
//
// Inputs: blk [E, T, B] and data [E, T, V], float32, epoch-normalized,
// 16-byte aligned, a row of T every ld_t floats and an epoch every ld_e
// floats (both multiples of 4, as the TMA needs; the wrapper copies an
// operand only where it breaks that).  Output: the
// unshrunk per-voxel Gram out[b] = sum_v zn[b, :, v] zn[b, :, v]^T,
// [B, E, E], with zn the clamped Fisher-z of
// r[b, e, v] = sum_t blk[e, t, b] data[e, t, v], z-scored across the
// epochs of e's subject.  zn is never written to device memory;
// partial Grams are summed over V splits in split order, no atomics.
// Ragged edges as in fcma_tile.cuh: rows t >= T and voxels past B or V
// load as 0 (the TMA's out-of-range fill), voxels past V get z = 0; no
// value is tested for NaN.
//
// Precision.  Each operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (to nearest, ties away, as cvt.rna) and the
// product is lo*hi + hi*lo + hi*hi, accumulated in that order in fp32
// (3xTF32): the dropped lo*lo term is about 2^-22 of each
// product, so r keeps fp32 accuracy.  The Fisher-z is the same
// expression as fcma_tile.cuh's (logf, IEEE division, 1e-4 floors), the
// inverse std 1.0f / sqrtf(var).  Built without --use_fast_math.
//
// Bound at the whole-brain shape (E=32, T=150, B=1024, V=65536): the
// correlation's 3 x 644.2 GFLOP on the TF32 tensor cores at 494.7
// TFLOP/s (3.91 ms) plus the Gram's 70.9 GFLOP (its E (E + 1) / 2
// distinct entries) in fp32 FMA at 67 TFLOP/s (1.06 ms): 4.97 ms.  The
// operands stream from L2: a block re-reads its TB block voxels' rows
// for every voxel tile and every block re-reads the data tile, about
// 122 GB at that shape.
//
// Design.
//   * A block of 512 threads owns TB block voxels (16 at EPT=32, 32 at
//     EPT=16) and a range of 32-voxel tiles (the V split over
//     blockIdx.z, as in fcma_corr.cu).  Per tile and epoch the
//     correlation is [TB x T] . [T x 32]; a 16-row slab of one epoch
//     is one m16 tile.  Each warp owns two (epoch, 16 block voxels)
//     units and, per unit, four m16n8k8 n-tiles: 32 fp32 accumulators
//     a thread.  mma.sync, not wgmma: a wgmma tile is 64 rows, which
//     would need 64 block voxels per epoch, and the z tile of 64 x 32
//     epochs x 32 voxels would not fit in shared memory.
//   * T streams through a ring of kStages shared-memory stages of kKT
//     rows.  One thread fills a stage with two TMA tensor copies,
//     boxes [EPT, kKT, 32] of data and [EPT, kKT, TB] of blk, that
//     complete on the stage's mbarrier; one __syncthreads per stage
//     frees the stage for its refill.  The ring runs on across voxel
//     tiles, so the next tile's first stages load during this tile's
//     Fisher-z, normalization and Gram.  Per-thread cp.async copies of
//     the same stages were measured to bind: half the bytes in as many
//     copies took as long, and the warps that made the copies stalled
//     instead of overlapping the loads with the products.
//   * Stage rows are unpadded, their 16-byte chunks XOR-swizzled by the
//     TMA's 128-byte (data, and blk at TB=32) or 64-byte (blk at
//     TB=16) mode; the fragment rows and columns are permuted
//     (row_voxel, col_chunk) so that the loads of a warp hit 32
//     distinct banks, and a thread's B fragments of one row, one per
//     n-tile, are one 16-byte load.
//   * The Fisher-z is applied to the accumulator fragments in
//     registers and stored into the z tile zs[b][e][v] of
//     fcma_tile.cuh, where normalize_subjects and the Gram of
//     accumulate_gram (GramLane's fp32 FMA micro-tile) run unchanged.
//   * The ring's constants, mma_stage, fisher_store and gram_tile are
//     in tc_gram.cuh, shared with K4's tensor-core route
//     (fcma_sample_gram_tc.cu); gram_sum_kernel, with K1's multi-tile
//     route (fcma_gram_tcm.cu).

#include "tc_gram.cuh"

namespace {

// tmap_data, tmap_blk: tensor maps of data and blk (encode_map)
template <int EPT, int TB>
__global__ void __launch_bounds__(kThreads, 1)
fcma_gram_tc_kernel(const __grid_constant__ CUtensorMap tmap_data,
                    const __grid_constant__ CUtensorMap tmap_blk,
                    float* __restrict__ partial, int E, int T, int B,
                    int V, int eps, int tiles_per_split) {
  using Tl = TcTile<EPT, TB>;
  constexpr int GF = GramLane<EPT>::GF;
  // 1024-byte aligned: the TMA's 128-byte swizzle repeats every 1024
  extern __shared__ __align__(1024) float smem[];
  float* stages = smem;
  float* zs = stages + kStages * Tl::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(zs + TB * EPT * kZS);
  const int warp = threadIdx.x / 32;
  const int g = threadIdx.x % 32 / 4;
  const int q = threadIdx.x % 4;
  const int b0 = blockIdx.x * TB;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int n_tiles = max(0, min(n_vtiles, t_begin + tiles_per_split) -
                                 t_begin);
  const int n_chunks = (T + kKT - 1) / kKT;
  const int total = n_tiles * n_chunks;

  // chunk c of the block's run: rows (c % n_chunks) * kKT.. of voxel
  // tile t_begin + c / n_chunks, into stage c % kStages
  auto fetch = [&](int c) {
    if (threadIdx.x == 0 && c < total) {
      const int t0 = (c % n_chunks) * kKT;
      const int v0 = (t_begin + c / n_chunks) * kTV;
      float* st = stages + (c % kStages) * Tl::kStage;
      uint64_t* bar = full + c % kStages;
      mbar_expect_tx(bar, Tl::kStage * sizeof(float));
      tma_load(st, &tmap_data, bar, v0, t0);
      tma_load(st + Tl::kDs, &tmap_blk, bar, b0, t0);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    // the barriers are visible to the async proxy (the TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const GramLane<EPT> lane;
  float gr[4][GF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < GF; ++j) gr[i][j] = 0.f;
  float acc[2][4][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][j][i] = 0.f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) fetch(c);
  for (int c = 0; c < total; ++c) {
    // every thread is done with chunk c - 1, whose stage the next copy
    // refills, and with the previous tile's Gram (the z tile is free)
    __syncthreads();
    fetch(c + kStages - 1);
    mbar_wait(full + c % kStages, (c / kStages) & 1);
    mma_stage<EPT, TB>(stages + (c % kStages) * Tl::kStage, warp, g, q,
                       E, acc);
    if (c % n_chunks == n_chunks - 1) {
      const int v0 = (t_begin + c / n_chunks) * kTV;
      fisher_store<EPT, TB>(acc, zs, warp, g, q, E, V, v0);
      __syncthreads();
      normalize_subjects<EPT, TB>(zs, EPT, eps, E / eps, 0);
      __syncthreads();
      gram_tile<EPT>(zs, lane, gr);
    }
  }

  // one partial Gram per (split, block voxel)
  const int bg = b0 + lane.gb;
  if (bg < B) {
    float* dst = partial + ((size_t)blockIdx.z * B + bg) * (EPT * EPT);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < GF; ++j)
        dst[(lane.eq * 4 + i) * EPT + lane.fo * GF + j] = gr[i][j];
  }
}

template <int EPT, int TB>
int launch(const float* blk, const float* data, float* partial,
           float* out, int E, int T, int B, int V, int eps, int nsplit,
           int blk_ld_t, int blk_ld_e, int data_ld_t, int data_ld_e,
           cudaStream_t s) {
  constexpr int smem = TcTile<EPT, TB>::kSmem;
  CUtensorMap map_data, map_blk;
  if (!encode_map(&map_data, data, E, T, V, kTV, EPT, kKT, data_ld_t,
                  data_ld_e) ||
      !encode_map(&map_blk, blk, E, T, B, TB, EPT, kKT, blk_ld_t,
                  blk_ld_e))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fcma_gram_tc_kernel<EPT, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid((B + TB - 1) / TB, 1, nsplit);
  fcma_gram_tc_kernel<EPT, TB><<<grid, kThreads, smem, s>>>(
      map_data, map_blk, partial, E, T, B, V, eps, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * E * E;
  const int threads = 256;
  gram_sum_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    s>>>(partial, out, E, B, EPT, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// One epoch tile: E <= ept (32 or 16) epochs of whole subjects (E a
// multiple of eps); blk and data 16-byte aligned with row strides ld_t
// and epoch strides ld_e (floats, multiples of 4); partial is
// [nsplit, B, ept, ept] scratch, out [B, E, E].
extern "C" int fcma_gram_tc_f32(const float* blk, const float* data,
                                float* partial, float* out, int E, int T,
                                int B, int V, int eps, int ept,
                                int nsplit, int blk_ld_t, int blk_ld_e,
                                int data_ld_t, int data_ld_e,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E < 1 || E > ept || eps < 1 || E % eps != 0 || nsplit < 1 ||
      !tma_operand(blk, blk_ld_t, blk_ld_e) ||
      !tma_operand(data, data_ld_t, data_ld_e))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (T == 0 || V == 0)  // every r is 0, and so is every z
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * B * E * E, s);
  if (ept == 32)
    return launch<32, 16>(blk, data, partial, out, E, T, B, V, eps,
                          nsplit, blk_ld_t, blk_ld_e, data_ld_t,
                          data_ld_e, s);
  if (ept == 16)
    return launch<16, 32>(blk, data, partial, out, E, T, B, V, eps,
                          nsplit, blk_ld_t, blk_ld_e, data_ld_t,
                          data_ld_e, s);
  return (int)cudaErrorInvalidValue;
}
