// K4: the FCMA classifier's fused sample Gram for NVIDIA Hopper
// (sm_90a).
//
// Replaces brainiak_tpu/ops/pallas_kernels.py fcma_sample_gram
// (_sample_gram_kernel).
//
// Inputs: blk [N, T, B] and data [N, T, V], float32, row-major, both
// epoch-normalized: the two regions of the classifier's correlation
// features, samples in place of epochs.  A sample's features are the
// correlations of every (b, v) pair; with norm_unit > 1 they are
// Fisher-z'd and z-scored across each group of norm_unit consecutive
// samples (the tile of fcma_tile.cuh, groups in place of subjects),
// with norm_unit <= 1 they are the raw r (Norm::kRaw).  The output is
// the unshrunk sample Gram
//   out[n, m] = sum_{b, v} f[n, b, v] f[m, b, v],   [N, N],
// and the [N, B * V] feature matrix never reaches device memory.  The
// feature set is the same with the two regions swapped, so the caller
// passes the narrower region as blk.
//
// K4(x1, x2, u) = sum_b K1(x1, x2, u)[b]: this is K1 (fcma_corr.cu)
// reduced over the block voxels as well, on K1's grid and tile loop
// (accumulate_gram of fcma_tile.cuh).  Each thread's Gram micro-tile (one block voxel, 4 x EPT/4 samples)
// accumulates over the block's whole range of voxel tiles; then the
// block sums its TB block voxels' micro-tiles in shared memory in a
// fixed order and writes one [EPT, EPT] partial per (V split,
// block-voxel tile, sample-tile pair).  A second kernel sums the
// partials in a fixed order into [N, N] and mirrors the off-diagonal
// tile pairs.  Deterministic, no atomics.
//
// Bound at the classifier path's shape (N=32, T=150, B=1024,
// V=65536): operations, as for K1.  Correlation 2*N*T*B*V = 644.2
// GFLOP plus the Gram's N*(N+1)/2 distinct entries, N*(N+1)*B*V =
// 70.9 GFLOP: 715.1 GFLOP, about 10.7 ms at 67 TFLOP/s fp32; the
// 1.28 GB of input take about 0.38 ms.  fp32 FMA throughout, IEEE
// logf and division, no --use_fast_math.

#include <algorithm>

#include "fcma_tile.cuh"

namespace {

template <int EPT, int TB, int NORM>
__global__ void __launch_bounds__(kThreads, 1)
fcma_sample_gram_kernel(const float* __restrict__ blk,
                        const float* __restrict__ data,
                        const float* __restrict__ stats,
                        float* __restrict__ partial, int N, int T, int B,
                        int V, int eps, int tile_len, int ntiles,
                        int tiles_per_split, int vec_blk, int vec_data) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  const GramLane<EPT> lane;
  constexpr int GF = GramLane<EPT>::GF;
  float g[4][GF];
  accumulate_gram<EPT, TB, NORM>(blk, data, stats, N, T, B, V, eps,
                                 tile_len, ntiles, tiles_per_split, vec_blk,
                                 vec_data, stages, lane, g);

  // sum the TB block voxels' micro-tiles in block-voxel order into one
  // partial per (split, block-voxel tile, pair), in the free stages
  float* red = stages;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < GF; ++j)
      red[(lane.gb * EPT + lane.eq * 4 + i) * EPT + lane.fo * GF + j] =
          g[i][j];
  __syncthreads();
  float* dst = partial +
      ((size_t)(blockIdx.z * gridDim.x + blockIdx.x) * gridDim.y +
       blockIdx.y) *
          (EPT * EPT);
  for (int idx = threadIdx.x; idx < EPT * EPT; idx += kThreads) {
    float s = 0.f;
    for (int b = 0; b < TB; ++b) s += red[b * EPT * EPT + idx];
    dst[idx] = s;
  }
}

// Sum the nparts partials of each sample-tile pair in part order and
// scatter the pair's block (and its mirror) into out [N, N].
__global__ void sample_gram_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int N,
                                          int ept, int tile_len, int ntiles,
                                          int npairs, int nparts) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int per_pair = ept * ept;
  if (idx >= per_pair * npairs) return;
  const int f = idx % ept;
  const int e = (idx / ept) % ept;
  int ta, tc;
  decode_pair(idx / per_pair, ntiles, &ta, &tc);
  const int a0 = ta * tile_len;
  const int c0 = tc * tile_len;
  if (e >= min(tile_len, N - a0) || f >= min(tile_len, N - c0)) return;
  const size_t stride = (size_t)npairs * per_pair;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < nparts; ++k) s += partial[k * stride + idx];
  out[(size_t)(a0 + e) * N + c0 + f] = s;
  if (ta != tc) out[(size_t)(c0 + f) * N + a0 + e] = s;
}

template <int EPT, int TB, int NORM>
int launch_sample_gram(const float* blk, const float* data,
                       const float* stats, float* partial, float* out,
                       int N, int T, int B, int V, int eps, int tile_len,
                       int ntiles, int nsplit, int vec_blk, int vec_data,
                       cudaStream_t s) {
  const int n_slots = ntiles == 1 ? EPT : 2 * EPT;
  const int smem =
      std::max(Tile<EPT, TB>::smem_bytes(n_slots),
               TB * EPT * EPT * (int)sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fcma_sample_gram_kernel<EPT, TB, NORM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int npairs = ntiles * (ntiles + 1) / 2;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid((B + TB - 1) / TB, npairs, nsplit);
  fcma_sample_gram_kernel<EPT, TB, NORM><<<grid, kThreads, smem, s>>>(
      blk, data, stats, partial, N, T, B, V, eps, tile_len, ntiles,
      per_split, vec_blk, vec_data);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = npairs * EPT * EPT;
  const int threads = 256;
  sample_gram_reduce_kernel<<<(n + threads - 1) / threads, threads, 0,
                              s>>>(partial, out, N, EPT, tile_len, ntiles,
                                   npairs, (int)grid.x * nsplit);
  return (int)cudaGetLastError();
}

template <int EPT, int TB>
int run_sample_gram(const float* blk, const float* data, float* partial,
                    float* stats, float* out, int N, int T, int B, int V,
                    int norm_unit, int tile_len, int ntiles, int nsplit,
                    cudaStream_t s) {
  const int vb = rows_aligned(blk, B);
  const int vd = rows_aligned(data, V);
  if (norm_unit <= 1)
    return launch_sample_gram<EPT, TB, kRaw>(
        blk, data, nullptr, partial, out, N, T, B, V, 1, tile_len, ntiles,
        nsplit, vb, vd, s);
  return dispatch<EPT, TB>(
      blk, data, stats, N, T, B, V, norm_unit, tile_len, nsplit, vb, vd, s,
      [&](auto norm) {
        return launch_sample_gram<EPT, TB, decltype(norm)::value>(
            blk, data, stats, partial, out, N, T, B, V, norm_unit,
            tile_len, ntiles, nsplit, vb, vd, s);
      });
}

}  // namespace

// ept (sample tile capacity) is 32 or 16; tile_len <= ept samples:
// whole groups of norm_unit, or ept when norm_unit <= 1 or a group is
// longer than one tile (stats is then [2, B, N / norm_unit, V] scratch
// for the statistics pass, else unused); partial is
// [nsplit * ceil(B / (512 / ept)), npairs, ept, ept] scratch.
extern "C" int fcma_sample_gram_f32(const float* blk, const float* data,
                                    float* partial, float* stats,
                                    float* out, int N, int T, int B, int V,
                                    int norm_unit, int ept, int tile_len,
                                    int ntiles, int nsplit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ept == 32)
    return run_sample_gram<32, 16>(blk, data, partial, stats, out, N, T, B,
                                   V, norm_unit, tile_len, ntiles, nsplit,
                                   s);
  if (ept == 16)
    return run_sample_gram<16, 32>(blk, data, partial, stats, out, N, T, B,
                                   V, norm_unit, tile_len, ntiles, nsplit,
                                   s);
  return (int)cudaErrorInvalidValue;
}
