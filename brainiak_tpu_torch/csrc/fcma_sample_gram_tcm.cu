// K4 on its multi-tile route: the FCMA classifier's fused sample Gram
// for NVIDIA Hopper (sm_90a), every correlation formed once, on the
// tensor cores in 3xTF32, with the operands brought in by the TMA.
//
// Replaces, for N samples of more than one sample tile up to kMaxE =
// 104 (ops/fcma_kernels.py sample_gram_route "tcm"), the Pallas kernel
// brainiak_tpu/ops/pallas_kernels.py:311 fcma_sample_gram
// (_sample_gram_kernel).  One sample tile of whole groups takes
// fcma_sample_gram_tc.cu, more than kMaxE samples fcma_sample_gram.cu.
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
// norm_unit consecutive samples (any group length that divides N: a
// group may span what the FMA kernel's sample tiles would be); with
// norm_unit <= 1 r itself.  The [N, B * V] features never reach device
// memory.
//
// K4 is K1 summed over the block voxels, so this is K1's multi-tile
// kernel (fcma_gram_tcm.cu, whose design notes hold here; its body up
// to the Gram is tc_gram_m.cuh's) with samples for epochs and groups
// for subjects: a block owns 8 block voxels and a V split of 32-voxel
// tiles, forms the correlations of all N samples of a voxel tile into
// the z tile zs[8 block voxels][N][32 voxels] in shared memory, once
// each (3xTF32 mma.sync from TMA stages), and z-scores every group
// there, with no statistics pass.  Raw features (norm_unit <= 1) are a
// template parameter that skips the Fisher-z and the z-score.
//
// The Gram, and the block-voxel sum in it.  A tile's contribution is
// one [N, 256] . [256, N] product over its 8 x 32 (block voxel, voxel)
// columns.  K1 keeps one [E, E] Gram a block voxel (one 8 x 8 micro-
// tile a lane at 16 warps up to 80 epochs, three at 8 warps beyond,
// which spills); summing its 8 Grams at the end of the block (PR 8's
// way on the one-tile route) would keep that.  Here every lane of the
// 16 warps shares the N (N + 1) / 2 entries: lane l owns micro-tile
// l % n_micro of the upper triangle of 8 x 8 blocks (n_micro = 15 at
// N=40, 55 at 80, 78 at 96, 91 at 104) over slice l / n_micro of the
// 128 voxel pairs (block voxel-major), 512 / n_micro slices (5 to 34).
// So a lane holds one 8 x 8 accumulator at every N up to 104: 16
// warps throughout, no spill, and the block-voxel sum is the lane's
// own FMA chain.  The lanes of a warp mostly share a slice and read
// the 8-epoch rows that z_row puts on distinct banks, as K1's do.  At
// the end of the block the slices of each micro-tile are summed in
// slice order in shared memory (the free stages) into one [N, N]
// partial per (split, block group), mirrored; gram_sum_kernel sums the
// partials in that order.  Deterministic, no atomics.
//
// Padded block voxels (b >= B) add exactly 0: the TMA loads their
// columns as 0, so every product and r of theirs is 0 (the 3xTF32
// split of 0 is 0), never near one, their Fisher-z is 0.5 logf(1) = 0,
// each group's variance 0, fisher_normalize's inverse std 0 and zn 0;
// raw r is 0.  Voxels past V alike, rows t >= T load as 0, and samples
// past N are never stored (the z tile's padding rows hold 0).
//
// Grid: x the V splits (ops/fcma_kernels.py _tcm_split: one wave of
// 132 SMs), y the block groups of 8 block voxels.  At N=96 (8192 x
// 1024: B=1024, V=8192) 1 split x 128 groups, 256 voxel tiles a block;
// at N=80 (4096 x 512) 2 splits x 64 groups, 64 tiles a block.
//
// Precision as K1's multi-tile route: r in 3xTF32 (lo*hi + hi*lo +
// hi*hi, lo passed unrounded), |r| >= kNearOne = 1 - 2^-10 formed
// again in fp32 FMA, t ascending (fisher_fma, at a voxel paired with
// itself), the Fisher-z and z-score in IEEE fp32 (no --use_fast_math),
// the Gram in fp32 FMA.
//
// Bound at N=96, T=150, 8192 x 1024, norm_unit 12: operations.  The
// correlation's 3 x 241.6 GFLOP on the TF32 tensor cores at 494.7
// TFLOP/s is 1.465 ms, plus the Gram's N (N + 1) / 2 distinct entries,
// 78.1 GFLOP in fp32 at 67 TFLOP/s, 1.166 ms: 2.63 ms.  At N=80, 4096 x
// 512 (K1's E=80 work): 0.508 ms.  From L2 each block re-reads its
// voxel tiles' data rows (reused by 8 block voxels) and its block
// voxels' rows (reused by 32 voxels): N T 4 (B V / 8 + B V / 32) bytes,
// 75.5 GB at N=96, 15.7 GB at N=80.

#include "tc_gram_m.cuh"

namespace {

// voxel pairs of a z tile: 16 of each of its 8 block voxels
constexpr int kPairs = Tcm::kMB * kTV / 2;
constexpr int kW = 16;  // warps a block
constexpr int kLanes = Warps<kW>::kThreads;
static_assert(Tcm::kMStages * Tcm::kStage + Tcm::kMB * Tcm::z_stride(1) >=
                  64 * kLanes,
              "the slice sum fits in the stages and the z tile");

// gr += the 8 x 8 micro-tile, samples ea.. x eb.., of the z tile over
// voxel pairs p_lo..p_hi - 1 (pair p: block voxel p / 16, voxels
// 2 (p % 16) and 2 (p % 16) + 1), in order (gram_pair).
__device__ __forceinline__ void gram_pairs(const float* zs, int zst,
                                           int p_lo, int p_hi, int ea,
                                           int eb, float (&gr)[8][8]) {
  for (int p = p_lo; p < p_hi; ++p) {
    const float* zb = zs + p / (kTV / 2) * zst + 2 * (p % (kTV / 2));
    gram_pair(zb + Tcm::z_row(ea), zb + Tcm::z_row(eb), gr);
  }
}

// tmap_data, tmap_blk: tensor maps of data ([16, 16, 32] boxes) and
// blk ([16, 16, 8] boxes); blk and data themselves for fisher_fma;
// NORM is kTile (groups of eps samples) or kRaw
template <int NORM>
__global__ void __launch_bounds__(kLanes, 1)
fcma_sample_gram_tcm_kernel(const __grid_constant__ CUtensorMap tmap_data,
                            const __grid_constant__ CUtensorMap tmap_blk,
                            const float* __restrict__ blk,
                            const float* __restrict__ data,
                            float* __restrict__ partial, int N, int T,
                            int V, int eps, int tiles_per_split,
                            int blk_ld_t, int blk_ld_e, int data_ld_t,
                            int data_ld_e) {
  // 1024-byte aligned: the TMA's 128-byte swizzle repeats every 1024
  extern __shared__ __align__(1024) float smem[];
  // the lane's share: micro-tile mi (row by row, decode_pair) over
  // slice sl of the voxel pairs; lanes past n_lanes idle
  const int nb8 = (N + 7) / 8;
  const int n_micro = nb8 * (nb8 + 1) / 2;
  const int n_slices = kLanes / n_micro;
  const int n_lanes = n_slices * n_micro;
  const int mi = threadIdx.x % n_micro;
  const int sl = threadIdx.x / n_micro;
  const int p_lo = sl < n_slices ? sl * kPairs / n_slices : 0;
  const int p_hi = sl < n_slices ? (sl + 1) * kPairs / n_slices : 0;
  int bi, bj;
  decode_pair(mi, nb8, &bi, &bj);
  const int ea = 8 * bi;
  const int eb = 8 * bj;
  float gr[8][8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) gr[x][y] = 0.f;

  // slice j of n of the lane's voxel pairs of a whole tile
  tcm_tiles<kW, NORM>(tmap_data, tmap_blk, blk, data, smem, N, T, V, eps,
                      tiles_per_split, blk_ld_t, blk_ld_e, data_ld_t,
                      data_ld_e,
                      [&](const float* zs, int zst, int j, int n) {
                        gram_pairs(zs, zst, p_lo + (p_hi - p_lo) * j / n,
                                   p_lo + (p_hi - p_lo) * (j + 1) / n, ea,
                                   eb, gr);
                      });

  // every warp is done with the z tile, every copy was waited for: the
  // stages and the z tile are free for the slices' sum
  __syncthreads();
  float* red = smem;
  if (threadIdx.x < n_lanes)
#pragma unroll
    for (int x = 0; x < 8; ++x)
#pragma unroll
      for (int y = 0; y < 8; ++y)
        red[(x * 8 + y) * n_lanes + threadIdx.x] = gr[x][y];
  __syncthreads();
  // one [N, N] partial per (split, block group), the lower triangle
  // mirrored from the upper
  float* dst =
      partial + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * N * N;
  for (int idx = threadIdx.x; idx < 64 * n_micro; idx += kLanes) {
    const int xy = idx / n_micro;
    const int m = idx % n_micro;
    float s = 0.f;
    for (int k = 0; k < n_slices; ++k)
      s += red[xy * n_lanes + k * n_micro + m];
    int i, j;
    decode_pair(m, nb8, &i, &j);
    const int e = 8 * i + xy / 8;
    const int f = 8 * j + xy % 8;
    if (e < N && f < N) {
      dst[e * N + f] = s;
      if (i != j) dst[f * N + e] = s;
    }
  }
}

template <int NORM>
int launch(const CUtensorMap& map_data, const CUtensorMap& map_blk,
           const float* blk, const float* data, float* partial,
           float* out, int N, int T, int B, int V, int eps, int nsplit,
           int blk_ld_t, int blk_ld_e, int data_ld_t, int data_ld_e,
           cudaStream_t s) {
  const int smem = Tcm::smem(N);
  cudaError_t err = cudaFuncSetAttribute(
      fcma_sample_gram_tcm_kernel<NORM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid(nsplit, (B + Tcm::kMB - 1) / Tcm::kMB);
  fcma_sample_gram_tcm_kernel<NORM><<<grid, kLanes, smem, s>>>(
      map_data, map_blk, blk, data, partial, N, T, V, eps, per_split,
      blk_ld_t, blk_ld_e, data_ld_t, data_ld_e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  gram_sum_kernel<<<(N * N + threads - 1) / threads, threads, 0, s>>>(
      partial, out, N, 1, N, (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

}  // namespace

// N <= 104 samples, a multiple of norm_unit when norm_unit > 1 (raw r
// when <= 1); blk and data 16-byte aligned with row strides ld_t and
// sample strides ld_e (floats, multiples of 4); partial is
// [nsplit * ceil(B / 8), N, N] scratch, out [N, N].  Anything else is
// refused with cudaErrorInvalidValue.
extern "C" int fcma_sample_gram_tcm_f32(const float* blk, const float* data,
                                        float* partial, float* out, int N,
                                        int T, int B, int V, int norm_unit,
                                        int nsplit, int blk_ld_t,
                                        int blk_ld_e, int data_ld_t,
                                        int data_ld_e, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || N > Tcm::kMaxE || T < 0 || B < 0 || V < 0 ||
      (norm_unit > 1 && N % norm_unit != 0) || nsplit < 1 ||
      (B + Tcm::kMB - 1) / Tcm::kMB > 65535 ||  // gridDim.y
      !tma_operand(blk, blk_ld_t, blk_ld_e) ||
      !tma_operand(data, data_ld_t, data_ld_e))
    return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || V == 0)  // every feature is 0
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * N * N, s);
  CUtensorMap map_data, map_blk;
  if (!encode_map(&map_data, data, N, T, V, kTV, Tcm::kMEG, Tcm::kMRows,
                  data_ld_t, data_ld_e) ||
      !encode_map(&map_blk, blk, N, T, B, Tcm::kMB, Tcm::kMEG,
                  Tcm::kMRows, blk_ld_t, blk_ld_e))
    return (int)cudaErrorInvalidValue;
  if (norm_unit <= 1)
    return launch<kRaw>(map_data, map_blk, blk, data, partial, out, N, T,
                        B, V, 1, nsplit, blk_ld_t, blk_ld_e, data_ld_t,
                        data_ld_e, s);
  return launch<kTile>(map_data, map_blk, blk, data, partial, out, N, T, B,
                       V, norm_unit, nsplit, blk_ld_t, blk_ld_e, data_ld_t,
                       data_ld_e, s);
}
