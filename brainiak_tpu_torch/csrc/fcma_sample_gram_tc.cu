// K4 on its one-sample-tile route: the FCMA classifier's fused sample
// Gram for NVIDIA Hopper (sm_90a), with the correlation on the tensor
// cores in 3xTF32 and the operands brought in by the TMA.
//
// Replaces, for N <= 32 samples that form one sample tile of whole
// groups (the route of the classifier's whole-brain shape), the Pallas
// kernel brainiak_tpu/ops/pallas_kernels.py fcma_sample_gram
// (_sample_gram_kernel).  More samples, or a group longer than a tile,
// take fcma_sample_gram.cu.
//
// Inputs: blk [N, T, B] and data [N, T, V], float32, epoch-normalized
// (the classifier's two regions, samples in place of epochs; the
// narrower region is blk), 16-byte aligned, a row of T every ld_t
// floats and a sample every ld_e floats (both multiples of 4, as the
// TMA needs; the wrapper copies an operand only where it breaks that).
// Output: the unshrunk sample Gram
//   out[n, m] = sum_{b, v} f[n, b, v] f[m, b, v],   [N, N],
// of the features r[n, b, v] = sum_t blk[n, t, b] data[n, t, v]: with
// norm_unit > 1 their clamped Fisher-z, z-scored across each group of
// norm_unit consecutive samples; with norm_unit <= 1 r itself
// (Norm::kRaw of fcma_tile.cuh).  The [N, B * V] features never reach
// device memory.
//
// K4 is K1 summed over the block voxels, so this is K1's tensor-core
// kernel (fcma_gram_tc.cu, whose design notes hold here; its body is
// shared in tc_gram.cuh) with samples for epochs and groups for
// subjects:
//   * A block of 512 threads owns TB block voxels (16 at EPT=32, 32 at
//     EPT=16) and one V split of 32-voxel tiles; T streams through
//     kStages TMA stages on mbarriers, and the ring runs on across
//     voxel tiles.  The correlation is 3xTF32 mma.sync m16n8k8; the
//     Fisher-z goes into the z tile in registers (fisher_store), where
//     normalize_subjects z-scores each group; the raw mode (a template
//     parameter) stores r and skips both.  Each voxel tile's Gram goes
//     into GramLane's fp32 FMA micro-tile (gram_tile): one block voxel
//     a thread, accumulated over the block's voxel tiles.
//   * The block-voxel sum, once, at the end of the block: the TB
//     micro-tiles are summed in shared memory (the free stages), in
//     block-voxel order, into one [EPT, EPT] partial per (V split,
//     block-voxel tile); a second kernel sums the partials in a fixed
//     order into [N, N].  Deterministic, no atomics.
//   * Padded block voxels.  K1 drops the rows of block voxels past B;
//     K4 sums them, so they must add exactly 0.  They do: the TMA
//     loads their columns as 0, so every product and r of theirs is
//     exactly 0 (the 3xTF32 split of 0 is 0, 0 times a finite value is
//     0), their Fisher-z is 0.5 logf(1 / 1) = 0 exactly, their groups'
//     mean and variance are 0, so normalize_subjects' inverse std is 0
//     and zn = 0; in raw mode r = 0 is stored.  Samples n >= N and
//     voxels past V are stored as 0 as in K1, and rows t >= T load as 0.
//
// Precision as K1's tensor-core route: r in 3xTF32 (lo*hi + hi*lo +
// hi*hi, both parts rounded to nearest), the Fisher-z and z-score in
// IEEE fp32 (no --use_fast_math), the Gram in fp32 FMA.  One
// exception, with norm_unit > 1: a correlation with |r| >= 1 - 2^-10
// is formed again in fp32 FMA, t = 0, 1, ..., T - 1 in turn, and its
// Fisher-z taken from that (refine_near_one).  Near |r| = 1 the
// clamped Fisher-z turns the last ulp of r into an O(1) change of z
// (r = 1 - 2^-24 gives 8.7, r >= 1 the clamp's 4.95), and the z-score
// carries it into the whole group.  A voxel paired with itself (region
// 1 inside region 2, as in the classifier's two-mask fits) sits
// exactly there.  The FMA kernels (corr_tile of fcma_tile.cuh) form r
// in that order, so those features come out as theirs.  Away from
// |r| = 1 the Fisher-z is well conditioned and 3xTF32 keeps fp32
// accuracy.

// Bound at the classifier's whole-brain shape (N=32, T=150, B=1024,
// V=65536), as K1's tensor-core route: the correlation's 3 x 644.2
// GFLOP on the TF32 tensor cores at 494.7 TFLOP/s (3.91 ms) plus the
// Gram's 70.9 GFLOP (its N (N + 1) / 2 distinct entries) in fp32 FMA
// at 67 TFLOP/s (1.06 ms): 4.97 ms.

#include "tc_gram.cuh"

namespace {

// Raw mode: the accumulators themselves into zs[b][e][v] (0 for
// samples e >= E and voxels past V), and zeroed; the layout of
// fisher_store (tc_gram.cuh) without the Fisher-z.
template <int EPT, int TB>
__device__ __forceinline__ void raw_store(float (&acc)[2][4][4],
                                          float* zs, int warp, int g,
                                          int q, int E, int V, int v0) {
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
        zs[(b * EPT + e) * kZS + v] =
            e < E && v0 + v < V ? acc[u][j][i] : 0.f;
        acc[u][j][i] = 0.f;
      }
    }
  }
}

// tmap_data, tmap_blk: tensor maps of data and blk (encode_map); blk
// and data themselves for refine_near_one; NORM is kTile (groups of
// eps samples) or kRaw
template <int EPT, int TB, int NORM>
__global__ void __launch_bounds__(kThreads, 1)
fcma_sample_gram_tc_kernel(const __grid_constant__ CUtensorMap tmap_data,
                           const __grid_constant__ CUtensorMap tmap_blk,
                           const float* __restrict__ blk,
                           const float* __restrict__ data,
                           float* __restrict__ partial, int N, int T,
                           int V, int eps, int tiles_per_split,
                           int blk_ld_t, int blk_ld_e, int data_ld_t,
                           int data_ld_e) {
  using Tl = TcTile<EPT, TB>;
  constexpr int GF = GramLane<EPT>::GF;
  static_assert(TB * EPT * EPT <= kStages * Tl::kStage,
                "the block-voxel sum fits in the stages");
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
                       N, acc);
    if (c % n_chunks == n_chunks - 1) {
      const int v0 = (t_begin + c / n_chunks) * kTV;
      if constexpr (NORM == kRaw) {
        raw_store<EPT, TB>(acc, zs, warp, g, q, N, V, v0);
      } else {
        const unsigned near = near_one(acc);
        fisher_store<EPT, TB>(acc, zs, warp, g, q, N, V, v0);
        if (near)
          refine_near_one<EPT, TB>(near, zs, blk, data, warp, g, q, T,
                                   b0, v0, blk_ld_t, blk_ld_e, data_ld_t,
                                   data_ld_e);
        __syncthreads();
        normalize_subjects<EPT, TB>(zs, EPT, eps, N / eps, 0);
      }
      __syncthreads();
      gram_tile<EPT>(zs, lane, gr);
    }
  }

  // Sum the TB block voxels' micro-tiles in block-voxel order into one
  // partial per (split, block-voxel tile).  The stages are free: every
  // copy was waited for and every thread is past its last mma_stage.
  float* red = stages;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < GF; ++j)
      red[(lane.gb * EPT + lane.eq * 4 + i) * EPT + lane.fo * GF + j] =
          gr[i][j];
  __syncthreads();
  float* dst =
      partial + (size_t)(blockIdx.z * gridDim.x + blockIdx.x) * (EPT * EPT);
  for (int idx = threadIdx.x; idx < EPT * EPT; idx += kThreads) {
    float s = 0.f;
    for (int b = 0; b < TB; ++b) s += red[b * EPT * EPT + idx];
    dst[idx] = s;
  }
}

// out[n, m] = the sum of the partials [nparts, ept, ept] at (n, m), one
// warp an entry: lane k sums parts k, k + 32, ... in order, then a
// fixed shuffle tree
__global__ void sample_gram_tc_sum_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int N,
                                          int ept, int nparts) {
  const int entry = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (entry >= N * N) return;  // warp-uniform
  const size_t per_part = (size_t)ept * ept;
  const float* p = partial + (entry / N) * ept + entry % N;
  float s = 0.f;
  for (int k = lane; k < nparts; k += 32) s += p[k * per_part];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) out[entry] = s;
}

template <int EPT, int TB, int NORM>
int launch(const float* blk, const float* data, float* partial,
           float* out, int N, int T, int B, int V, int eps, int nsplit,
           int blk_ld_t, int blk_ld_e, int data_ld_t, int data_ld_e,
           cudaStream_t s) {
  constexpr int smem = TcTile<EPT, TB>::kSmem;
  CUtensorMap map_data, map_blk;
  if (!encode_map(&map_data, data, N, T, V, kTV, EPT, kKT, data_ld_t,
                  data_ld_e) ||
      !encode_map(&map_blk, blk, N, T, B, TB, EPT, kKT, blk_ld_t,
                  blk_ld_e))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fcma_sample_gram_tc_kernel<EPT, TB, NORM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid((B + TB - 1) / TB, 1, nsplit);
  fcma_sample_gram_tc_kernel<EPT, TB, NORM><<<grid, kThreads, smem, s>>>(
      map_data, map_blk, blk, data, partial, N, T, V, eps, per_split,
      blk_ld_t, blk_ld_e, data_ld_t, data_ld_e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int blocks = (N * N * 32 + threads - 1) / threads;
  sample_gram_tc_sum_kernel<<<blocks, threads, 0, s>>>(
      partial, out, N, EPT, (int)grid.x * nsplit);
  return (int)cudaGetLastError();
}

template <int EPT, int TB>
int run(const float* blk, const float* data, float* partial, float* out,
        int N, int T, int B, int V, int norm_unit, int nsplit,
        int blk_ld_t, int blk_ld_e, int data_ld_t, int data_ld_e,
        cudaStream_t s) {
  if (norm_unit <= 1)
    return launch<EPT, TB, kRaw>(blk, data, partial, out, N, T, B, V, 1,
                                 nsplit, blk_ld_t, blk_ld_e, data_ld_t,
                                 data_ld_e, s);
  return launch<EPT, TB, kTile>(blk, data, partial, out, N, T, B, V,
                                norm_unit, nsplit, blk_ld_t, blk_ld_e,
                                data_ld_t, data_ld_e, s);
}

}  // namespace

// One sample tile of whole groups: N <= ept (32 or 16) samples, a
// multiple of norm_unit when norm_unit > 1 (raw r when <= 1); blk and
// data 16-byte aligned with row strides ld_t and sample strides ld_e
// (floats, multiples of 4); partial is [nsplit * ceil(B / (512 / ept)),
// ept, ept] scratch, out [N, N].  Anything else is refused with
// cudaErrorInvalidValue.
extern "C" int fcma_sample_gram_tc_f32(const float* blk, const float* data,
                                       float* partial, float* out, int N,
                                       int T, int B, int V, int norm_unit,
                                       int ept, int nsplit, int blk_ld_t,
                                       int blk_ld_e, int data_ld_t,
                                       int data_ld_e, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || N > ept || (norm_unit > 1 && N % norm_unit != 0) ||
      nsplit < 1 || !tma_operand(blk, blk_ld_t, blk_ld_e) ||
      !tma_operand(data, data_ld_t, data_ld_e))
    return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || V == 0)  // every feature is 0
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * N * N, s);
  if (ept == 32)
    return run<32, 16>(blk, data, partial, out, N, T, B, V, norm_unit,
                       nsplit, blk_ld_t, blk_ld_e, data_ld_t, data_ld_e, s);
  if (ept == 16)
    return run<16, 32>(blk, data, partial, out, N, T, B, V, norm_unit,
                       nsplit, blk_ld_t, blk_ld_e, data_ld_t, data_ld_e, s);
  return (int)cudaErrorInvalidValue;
}
