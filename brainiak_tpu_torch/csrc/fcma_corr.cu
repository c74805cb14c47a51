// K1 and K3: fused FCMA correlation + Fisher-z + within-subject
// normalization for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of brainiak_tpu/ops/pallas_kernels.py:
//   K1 fcma_gram            (_gram_kernel + _normalized_corr_tile)
//   K3 fcma_corr_normalize  (_kernel + _normalized_corr_tile)
//
// Inputs: blk [E, T, B] and data [E, T, V], float32, row-major, both
// epoch-normalized (a dot product over T is a Pearson r).  The tile of
// fcma_tile.cuh gives, for every block voxel b, epoch e and voxel v,
// the Fisher-z of r z-scored across the epochs of e's subject, zn.
// K3 writes zn to out [B, E, V].  K1 writes the unshrunk per-voxel
// Gram out[b] = sum_v zn[b, :, v] zn[b, :, v]^T, [B, E, E], and never
// stores zn: the [B, E, V] tensor never reaches device memory.
//
// Precision: fp32 FMA throughout, whatever `precision` the caller
// names (the Pallas kernels likewise clamp 'high' up to 'highest').
// logf and IEEE division; the inverse std is 1.0f / sqrtf(var) (not
// rsqrtf).  Built without --use_fast_math.
//
// Bound at the whole-brain path shape (E=32, T=150, B=1024, V=65536):
// operations.  Correlation 2*E*T*B*V = 644.2 GFLOP plus the Gram's
// E*(E+1)/2 distinct entries (it is symmetric), E*(E+1)*B*V = 70.9
// GFLOP: 715.1 GFLOP, about 10.7 ms at 67 TFLOP/s fp32.  The bytes
// (about 1.26 GB of data) take about 0.38 ms.  At the one-mask shape
// (E=16, B=V=8192): 340.4 GFLOP, about 5.1 ms.
//
// Design.  On the TPU the voxel grid axis is a sequential reduction
// carried in VMEM; CUDA blocks run in no order, so here the loop over
// voxel tiles runs INSIDE each block:
//   * A block owns TB block voxels and a contiguous range of 32-voxel
//     tiles of V (the V axis is split over blockIdx.z so that B=1024
//     still fills 132 SMs).  For each voxel tile it forms the
//     normalized tile of fcma_tile.cuh for its epoch tile(s).
//   * K1 accumulates z z^T in registers that persist across voxel
//     tiles (accumulate_gram of fcma_tile.cuh, which K4 shares), and
//     writes one partial Gram per (V split, block voxel).
//     A second kernel sums the partials over splits in a fixed order:
//     deterministic, no atomics.  K3 stores zn straight to [B, E, V].
//   * Epochs are handled in tiles of at most EPT epochs.  When E fits
//     one tile (E <= 32, as in the bench configurations) each block
//     computes every correlation once.  K1 callers (ops/fcma_kernels.py
//     gram_route) take the tensor-core kernels: fcma_gram_tc.cu on one
//     tile, fcma_gram_tcm.cu on more tiles up to 104 epochs;
//     fcma_gram_f32 here runs for E > 104, or when forced
//     (route="ffma").  For more than one tile, K1 blocks take a
//     PAIR of epoch tiles (A, C), A <= C, and produce the Gram's A x C
//     block, mirrored into C x A; each epoch tile's correlations are
//     then recomputed once per pair it belongs to.
//   * A subject of more than EPT epochs spans several tiles: the
//     statistics pass of fcma_tile.cuh runs first (one more pass over
//     the correlations), and the tiles are normalized with its output.

#include "fcma_tile.cuh"

namespace {

template <int EPT, int TB, int NORM>
__global__ void __launch_bounds__(kThreads, 1)
fcma_gram_kernel(const float* __restrict__ blk,
                 const float* __restrict__ data,
                 const float* __restrict__ stats,
                 float* __restrict__ partial, int E, int T, int B, int V,
                 int eps, int tile_len, int ntiles, int tiles_per_split,
                 int vec_blk, int vec_data) {
  extern __shared__ float4 smem4[];
  const GramLane<EPT> lane;
  constexpr int GF = GramLane<EPT>::GF;
  float g[4][GF];
  accumulate_gram<EPT, TB, NORM>(blk, data, stats, E, T, B, V, eps,
                                 tile_len, ntiles, tiles_per_split, vec_blk,
                                 vec_data, reinterpret_cast<float*>(smem4),
                                 lane, g);

  // one partial Gram per (split, pair, block voxel)
  const int bg = blockIdx.x * TB + lane.gb;
  if (bg < B) {
    float* dst = partial +
        (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * B + bg) *
            (EPT * EPT);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < GF; ++j)
        dst[(lane.eq * 4 + i) * EPT + lane.fo * GF + j] = g[i][j];
  }
}

// Sum the per-split partial Grams in split order and scatter each
// epoch-tile pair's block (and its mirror) into out [B, E, E].
__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int E, int B,
                                   int ept, int tile_len, int ntiles,
                                   int npairs, int nsplit) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per_pair = (size_t)B * ept * ept;
  if (idx >= per_pair * npairs) return;
  const int f = (int)(idx % ept);
  const int e = (int)((idx / ept) % ept);
  const int b = (int)((idx / ((size_t)ept * ept)) % B);
  const int pair = (int)(idx / per_pair);
  int ta, tc;
  decode_pair(pair, ntiles, &ta, &tc);
  const int a0 = ta * tile_len;
  const int c0 = tc * tile_len;
  if (e >= min(tile_len, E - a0) || f >= min(tile_len, E - c0)) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k)
    s += partial[((size_t)k * npairs + pair) * per_pair +
                 ((size_t)b * ept + e) * ept + f];
  out[((size_t)b * E + a0 + e) * E + c0 + f] = s;
  if (ta != tc) out[((size_t)b * E + c0 + f) * E + a0 + e] = s;
}

template <int EPT, int TB, int NORM>
__global__ void __launch_bounds__(kThreads, 1)
fcma_corr_normalize_kernel(const float* __restrict__ blk,
                           const float* __restrict__ data,
                           const float* __restrict__ stats,
                           float* __restrict__ out, int E, int T, int B,
                           int V, int eps, int tile_len,
                           int tiles_per_split, int vec_blk,
                           int vec_data) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* zs = stages + Tile<EPT, TB>::kStageFloats;

  const int b0 = blockIdx.x * TB;
  const int a0 = blockIdx.y * tile_len;
  const int na = min(tile_len, E - a0);
  const int split = blockIdx.z;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_vtiles, t_begin + tiles_per_split);
  for (int vt = t_begin; vt < t_end; ++vt) {
    const int v0 = vt * kTV;
    corr_tile<EPT, TB, true>(blk, data, T, B, V, a0, na, b0, v0, 0, EPT,
                             vec_blk, vec_data, stages, zs);
    __syncthreads();
    if constexpr (NORM == kTile)
      normalize_subjects<EPT, TB>(zs, EPT, eps, na / eps, 0);
    else
      normalize_from_stats<EPT, TB>(zs, EPT, stats, E / eps, B, V, eps,
                                    b0, v0, a0, na, 0, 0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < TB * na * kTV; idx += kThreads) {
      const int v = idx % kTV;
      const int e = (idx / kTV) % na;
      const int b = idx / (kTV * na);
      if (b0 + b < B && v0 + v < V)
        out[((size_t)(b0 + b) * E + a0 + e) * V + v0 + v] =
            zs[(b * EPT + e) * kZS + v];
    }
    __syncthreads();
  }
}

template <int EPT, int TB, int NORM>
int launch_gram(const float* blk, const float* data, const float* stats,
                float* partial, float* out, int E, int T, int B, int V,
                int eps, int tile_len, int ntiles, int nsplit, int vec_blk,
                int vec_data, cudaStream_t s) {
  const int n_slots = ntiles == 1 ? EPT : 2 * EPT;
  const int smem = Tile<EPT, TB>::smem_bytes(n_slots);
  cudaError_t err = cudaFuncSetAttribute(
      fcma_gram_kernel<EPT, TB, NORM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int npairs = ntiles * (ntiles + 1) / 2;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid((B + TB - 1) / TB, npairs, nsplit);
  fcma_gram_kernel<EPT, TB, NORM><<<grid, kThreads, smem, s>>>(
      blk, data, stats, partial, E, T, B, V, eps, tile_len, ntiles,
      per_split, vec_blk, vec_data);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)npairs * B * EPT * EPT;
  const int threads = 256;
  gram_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                       0, s>>>(partial, out, E, B, EPT, tile_len, ntiles,
                               npairs, nsplit);
  return (int)cudaGetLastError();
}

template <int EPT, int TB, int NORM>
int launch_corr(const float* blk, const float* data, const float* stats,
                float* out, int E, int T, int B, int V, int eps,
                int tile_len, int ntiles, int nsplit, int vec_blk,
                int vec_data, cudaStream_t s) {
  const int smem = Tile<EPT, TB>::smem_bytes(EPT);
  cudaError_t err = cudaFuncSetAttribute(
      fcma_corr_normalize_kernel<EPT, TB, NORM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid((B + TB - 1) / TB, ntiles, nsplit);
  fcma_corr_normalize_kernel<EPT, TB, NORM><<<grid, kThreads, smem, s>>>(
      blk, data, stats, out, E, T, B, V, eps, tile_len, per_split, vec_blk,
      vec_data);
  return (int)cudaGetLastError();
}

}  // namespace

// ept (epoch tile capacity) is 32 or 16; tile_len <= ept epochs: whole
// subjects, or ept when a subject is longer than one tile (stats is
// then [2, B, E / eps, V] scratch for the statistics pass, else
// unused); partial is [nsplit, npairs, B, ept, ept] scratch.
extern "C" int fcma_gram_f32(const float* blk, const float* data,
                             float* partial, float* stats, float* out,
                             int E, int T, int B, int V, int eps, int ept,
                             int tile_len, int ntiles, int nsplit,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vb = rows_aligned(blk, B);
  const int vd = rows_aligned(data, V);
  if (ept == 32)
    return dispatch<32, 16>(
        blk, data, stats, E, T, B, V, eps, tile_len, nsplit, vb, vd, s,
        [&](auto norm) {
          return launch_gram<32, 16, decltype(norm)::value>(
              blk, data, stats, partial, out, E, T, B, V, eps, tile_len,
              ntiles, nsplit, vb, vd, s);
        });
  if (ept == 16)
    return dispatch<16, 32>(
        blk, data, stats, E, T, B, V, eps, tile_len, nsplit, vb, vd, s,
        [&](auto norm) {
          return launch_gram<16, 32, decltype(norm)::value>(
              blk, data, stats, partial, out, E, T, B, V, eps, tile_len,
              ntiles, nsplit, vb, vd, s);
        });
  return (int)cudaErrorInvalidValue;
}

extern "C" int fcma_corr_normalize_f32(const float* blk,
                                       const float* data, float* stats,
                                       float* out, int E, int T, int B,
                                       int V, int eps, int ept,
                                       int tile_len, int ntiles,
                                       int nsplit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vb = rows_aligned(blk, B);
  const int vd = rows_aligned(data, V);
  if (ept == 32)
    return dispatch<32, 16>(
        blk, data, stats, E, T, B, V, eps, tile_len, nsplit, vb, vd, s,
        [&](auto norm) {
          return launch_corr<32, 16, decltype(norm)::value>(
              blk, data, stats, out, E, T, B, V, eps, tile_len, ntiles,
              nsplit, vb, vd, s);
        });
  if (ept == 16)
    return dispatch<16, 32>(
        blk, data, stats, E, T, B, V, eps, tile_len, nsplit, vb, vd, s,
        [&](auto norm) {
          return launch_corr<16, 32, decltype(norm)::value>(
              blk, data, stats, out, E, T, B, V, eps, tile_len, ntiles,
              nsplit, vb, vd, s);
        });
  return (int)cudaErrorInvalidValue;
}
