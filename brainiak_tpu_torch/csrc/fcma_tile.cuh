// The FCMA correlation tile shared by K1, K3 (fcma_corr.cu) and K4
// (fcma_sample_gram.cu), for NVIDIA Hopper (sm_90a).
//
// A block of kThreads threads owns TB block voxels and, in turn, tiles
// of kTV voxels.  For one epoch tile (at most EPT epochs) it streams T
// through shared memory, forms every per-epoch correlation
//   r[b, e, v] = sum_t blk[e, t, b] * data[e, t, v]
// with register-blocked fp32 FMA, applies the clamped Fisher-z
//   z = 0.5 * logf(num / den),  num = 1 + r, den = 1 - r, each floored
//   at 1e-4 when <= 0
// in registers and leaves z in a shared-memory tile zs[TB][slot][kTV],
// where the z-score across each subject's epochs runs:
//   zn = (z - mean) / sqrt(var),  var = E[z^2] - mean^2, 0 where var <= 0.
//
// Subjects and epoch tiles.  When a subject fits one tile (epochs per
// subject <= EPT) a tile holds whole subjects and the z-score runs on
// the tile alone (Norm::kTile).  A longer subject spans several tiles
// (a tile may then hold the end of one subject and the start of the
// next): a first pass, subject_stats_kernel, writes each (block voxel,
// subject, voxel) mean and inverse std, and the tile is normalized
// with them (Norm::kStats).  Both passes form z with the same code, so
// the statistics are those of the very z values they normalize; every
// sum has one owner thread and a fixed order: no atomics.
//
// Ragged edges: rows t >= T, voxels v >= V and block voxels b >= B load
// as 0, out-of-range voxels are forced to z = 0 and nothing normalizes
// them, so they add exactly 0 to any Gram.
//
// The tensor-core kernels form r in 3xTF32, and a correlation with
// |r| >= kNearOne again as corr_tile forms it (fisher_fma): at a voxel
// paired with itself (r = 1) the clamped Fisher-z turns the last ulp of
// r into 4.95 against 8.66, and the z-score carries that into the
// subject.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kTV = 32;        // voxels per tile
constexpr int kTT = 4;         // TR rows per shared-memory stage
constexpr int kZS = kTV + 1;   // padded row of the z tile (banks)
constexpr float kClamp = 1e-4f;

// how a tile of correlations becomes features
enum Norm : int {
  kRaw = 0,    // raw r: no Fisher-z, no z-score
  kTile = 1,   // Fisher-z, z-score over the subjects inside the tile
  kStats = 2,  // Fisher-z, z-score with the first pass's statistics
};

template <int EPT, int TB>
struct Tile {
  static_assert(EPT * TB == kThreads, "one thread per (epoch, 4b x 8v)");
  // per-epoch strides of the two staging buffers, padded so that the
  // epochs one warp reads fall on different shared-memory banks
  static constexpr int kDsE = kTT * kTV + 4;
  static constexpr int kBsE = kTT * TB + 16;
  static constexpr int kDs = EPT * kDsE;            // one data stage
  static constexpr int kBs = EPT * kBsE;            // one block stage
  static constexpr int kStageFloats = 2 * (kDs + kBs);
  static int smem_bytes(int n_slots) {
    return (kStageFloats + TB * n_slots * kZS) * (int)sizeof(float);
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// epoch-tile pair p -> tiles (ta, tc), ta <= tc, in row-major order of
// the upper triangle
__host__ __device__ __forceinline__ void decode_pair(int p, int ntiles,
                                                     int* ta, int* tc) {
  int i = 0;
  while (p >= ntiles - i) {
    p -= ntiles - i;
    ++i;
  }
  *ta = i;
  *tc = i + p;
}

// Copy rows [t0, t0 + kTT) of `n` consecutive columns starting at c0 of
// the epochs e0 .. e0+ne-1 of src [E, T, ncols] into dst
// [EPT][kTT][n] (epoch stride `estride`), asynchronously.  Anything out
// of range (e >= ne, t >= T, column >= ncols) is zero-filled.  `vec`:
// rows start 16-byte aligned (ncols % 4 == 0), so 16-byte copies.
template <int N>
__device__ __forceinline__ void stage(float* dst, int estride,
                                      const float* __restrict__ src, int T,
                                      int ncols, int e0, int ne, int t0,
                                      int c0, int n_epochs_tile, bool vec) {
  if (vec) {
    constexpr int N4 = N / 4;
    for (int i = threadIdx.x; i < n_epochs_tile * kTT * N4;
         i += kThreads) {
      const int c4 = i % N4;
      const int tt = (i / N4) % kTT;
      const int e = i / (N4 * kTT);
      const int t = t0 + tt;
      const int c = c0 + c4 * 4;
      int bytes = 0;
      const float* p = src;
      if (e < ne && t < T && c < ncols) {
        bytes = min(4, ncols - c) * 4;
        p = src + ((size_t)(e0 + e) * T + t) * ncols + c;
      }
      cp_async16(dst + e * estride + tt * N + c4 * 4, p, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < n_epochs_tile * kTT * N; i += kThreads) {
      const int cc = i % N;
      const int tt = (i / N) % kTT;
      const int e = i / (N * kTT);
      const int t = t0 + tt;
      const int c = c0 + cc;
      int bytes = 0;
      const float* p = src;
      if (e < ne && t < T && c < ncols) {
        bytes = 4;
        p = src + ((size_t)(e0 + e) * T + t) * ncols + c;
      }
      cp_async4(dst + e * estride + tt * N + cc, p, bytes);
    }
  }
}

// Correlate one epoch tile (epochs e0 .. e0+ne-1) of block voxels
// b0 .. b0+TB-1 against voxels v0 .. v0+31 and write to
// zs[b][slot0 + e][v] the clamped Fisher-z of r (FISHER) or r itself,
// 0 where out of range.  T streams through two shared-memory stages:
// the copy of chunk k+1 is in flight while chunk k is multiplied.
template <int EPT, int TB, bool FISHER>
__device__ void corr_tile(const float* __restrict__ blk,
                          const float* __restrict__ data, int T, int B,
                          int V, int e0, int ne, int b0, int v0, int slot0,
                          int n_slots, bool vec_blk, bool vec_data,
                          float* stages, float* zs) {
  using Tl = Tile<EPT, TB>;
  const int tid = threadIdx.x;
  const int el = tid / TB;
  const int rem = tid % TB;
  const int bq = rem >> 2;
  const int vo = rem & 3;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_chunks = (T + kTT - 1) / kTT;
  auto ds = [&](int k) { return stages + (k & 1) * (Tl::kDs + Tl::kBs); };
  if (n_chunks > 0) {
    stage<kTV>(ds(0), Tl::kDsE, data, T, V, e0, ne, 0, v0, ne, vec_data);
    stage<TB>(ds(0) + Tl::kDs, Tl::kBsE, blk, T, B, e0, ne, 0, b0, ne,
              vec_blk);
    cp_async_commit();
  }
  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait_all();
    // chunk k is visible to every thread, and every thread is done
    // with chunk k-1, whose stage the next copy reuses
    __syncthreads();
    if (k + 1 < n_chunks) {
      const int t1 = (k + 1) * kTT;
      stage<kTV>(ds(k + 1), Tl::kDsE, data, T, V, e0, ne, t1, v0, ne,
                 vec_data);
      stage<TB>(ds(k + 1) + Tl::kDs, Tl::kBsE, blk, T, B, e0, ne, t1, b0,
                ne, vec_blk);
      cp_async_commit();
    }
    if (el < ne) {
      const float* dsk = ds(k) + el * Tl::kDsE + vo * 8;
      const float* bsk = ds(k) + Tl::kDs + el * Tl::kBsE + bq * 4;
#pragma unroll
      for (int tt = 0; tt < kTT; ++tt) {
        const float4 bv = *reinterpret_cast<const float4*>(bsk + tt * TB);
        const float4 d0 = *reinterpret_cast<const float4*>(dsk + tt * kTV);
        const float4 d1 =
            *reinterpret_cast<const float4*>(dsk + tt * kTV + 4);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float dd[8] = {d0.x, d0.y, d0.z, d0.w,
                             d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(bb[i], dd[j], acc[i][j]);
      }
    }
  }
  // every thread is done with both stages before anyone refills them
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = bq * 4 + i;
      const int v = vo * 8 + j;
      float z = 0.f;
      if (el < ne && v0 + v < V) {
        if (FISHER) {
          float num = 1.f + acc[i][j];
          float den = 1.f - acc[i][j];
          if (num <= 0.f) num = kClamp;
          if (den <= 0.f) den = kClamp;
          z = 0.5f * logf(num / den);
        } else {
          z = acc[i][j];
        }
      }
      zs[(b * n_slots + slot0 + el) * kZS + v] = z;
    }
  }
}

// Norm::kTile: z-score each (block voxel, subject, voxel) group of
// `eps` epochs in place.  Subjects 0 .. ns0-1 sit at slot 0, ns1 more
// at slot EPT.
template <int EPT, int TB>
__device__ void normalize_subjects(float* zs, int n_slots, int eps,
                                   int ns0, int ns1) {
  const int n_items = TB * kTV * (ns0 + ns1);
  const float inv_n = 1.f / (float)eps;
  for (int item = threadIdx.x; item < n_items; item += kThreads) {
    const int v = item % kTV;
    const int b = (item / kTV) % TB;
    const int s = item / (kTV * TB);
    const int slot = s < ns0 ? s * eps : EPT + (s - ns0) * eps;
    float* zp = &zs[(b * n_slots + slot) * kZS + v];
    float sum = 0.f;
    float sq = 0.f;
    for (int k = 0; k < eps; ++k) {
      const float x = zp[k * kZS];
      sum += x;
      sq = fmaf(x, x, sq);
    }
    const float mean = sum * inv_n;
    const float var = sq * inv_n - mean * mean;
    const float inv = var <= 0.f ? 0.f : 1.0f / sqrtf(var);
    for (int k = 0; k < eps; ++k) zp[k * kZS] = (zp[k * kZS] - mean) * inv;
  }
}

// Norm::kStats: z-score the na epochs a0.. at slot 0 and the nc epochs
// c0.. at slot EPT in place with the first pass's statistics, stats
// [2][B][n_subj][V] (means, then inverse stds).
template <int EPT, int TB>
__device__ void normalize_from_stats(float* zs, int n_slots,
                                     const float* __restrict__ stats,
                                     int n_subj, int B, int V, int eps,
                                     int b0, int v0, int a0, int na,
                                     int c0, int nc) {
  const size_t plane = (size_t)B * n_subj * V;
  const int n_rows = na + nc;
  for (int item = threadIdx.x; item < TB * n_rows * kTV;
       item += kThreads) {
    const int v = item % kTV;
    const int row = (item / kTV) % n_rows;
    const int b = item / (kTV * n_rows);
    if (b0 + b >= B || v0 + v >= V) continue;
    const bool in_a = row < na;
    const int slot = in_a ? row : EPT + row - na;
    const int e = in_a ? a0 + row : c0 + row - na;
    const size_t k = ((size_t)(b0 + b) * n_subj + e / eps) * V + v0 + v;
    float* zp = &zs[(b * n_slots + slot) * kZS + v];
    *zp = (*zp - stats[k]) * stats[plane + k];
  }
}

// |r| from which a correlation is formed again in fp32 FMA
constexpr float kNearOne = 1.f - 0x1p-10f;

// The clamped Fisher-z of r, corr_tile's expression
__device__ __forceinline__ float fisher_z(float r) {
  float num = 1.f + r;
  float den = 1.f - r;
  if (num <= 0.f) num = kClamp;
  if (den <= 0.f) den = kClamp;
  return 0.5f * logf(num / den);
}

// r = sum_t x[t ld_x] y[t ld_y] formed as corr_tile forms it: fp32 FMA
// from 0, t ascending.
__device__ __forceinline__ float corr_fma(const float* __restrict__ x,
                                          const float* __restrict__ y, int T,
                                          int ld_x, int ld_y) {
  float r = 0.f;
  for (int t = 0; t < T; ++t)
    r = fmaf(x[(size_t)t * ld_x], y[(size_t)t * ld_y], r);
  return r;
}

// fisher_z of that r
__device__ __forceinline__ float fisher_fma(const float* __restrict__ x,
                                            const float* __restrict__ y,
                                            int T, int ld_x, int ld_y) {
  return fisher_z(corr_fma(x, y, T, ld_x, ld_y));
}

// A thread's Gram micro-tile in K1 and K4: block voxel gb, epochs
// eq*4 .. eq*4+3 of tile A x fo*GF .. fo*GF+GF-1 of tile C.
template <int EPT>
struct GramLane {
  static constexpr int GF = EPT / 4;
  int gb, eq, fo;
  __device__ GramLane()
      : gb(threadIdx.x / EPT),
        eq(threadIdx.x % EPT / 4),
        fo(threadIdx.x % EPT % 4) {}
};

// The body K1 and K4 share, up to their epilogues.  Block (x, pair,
// split) of their grid owns block voxels x*TB .. x*TB+TB-1, the
// epoch-tile pair `pair` (tiles A <= C of tile_len epochs) and the
// split's range of voxel tiles.  Over that range it forms the
// normalized tile of A and, off the diagonal, of C, and accumulates
// each thread's micro-tile g += zA zC^T over the voxels.  It ends on a
// barrier: the stages and the z tile are free afterwards.
template <int EPT, int TB, int NORM>
__device__ __forceinline__ void accumulate_gram(
    const float* __restrict__ blk, const float* __restrict__ data,
    const float* __restrict__ stats, int E, int T, int B, int V, int eps,
    int tile_len, int ntiles, int tiles_per_split, bool vec_blk,
    bool vec_data, float* stages, const GramLane<EPT>& lane,
    float (&g)[4][GramLane<EPT>::GF]) {
  constexpr int GF = GramLane<EPT>::GF;
  float* zs = stages + Tile<EPT, TB>::kStageFloats;
  const int b0 = blockIdx.x * TB;
  int ta, tc;
  decode_pair(blockIdx.y, ntiles, &ta, &tc);
  const int a0 = ta * tile_len;
  const int na = min(tile_len, E - a0);
  const int c0 = tc * tile_len;
  const int nc = min(tile_len, E - c0);
  const bool same = ta == tc;
  const int n_slots = ntiles == 1 ? EPT : 2 * EPT;
  const int slot_c = same ? 0 : EPT;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < GF; ++j) g[i][j] = 0.f;

  const int n_vtiles = (V + kTV - 1) / kTV;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(n_vtiles, t_begin + tiles_per_split);
  for (int vt = t_begin; vt < t_end; ++vt) {
    const int v0 = vt * kTV;
    corr_tile<EPT, TB, NORM != kRaw>(blk, data, T, B, V, a0, na, b0, v0, 0,
                                     n_slots, vec_blk, vec_data, stages,
                                     zs);
    if (!same)
      corr_tile<EPT, TB, NORM != kRaw>(blk, data, T, B, V, c0, nc, b0, v0,
                                       EPT, n_slots, vec_blk, vec_data,
                                       stages, zs);
    __syncthreads();
    if constexpr (NORM == kTile)
      normalize_subjects<EPT, TB>(zs, n_slots, eps, na / eps,
                                  same ? 0 : nc / eps);
    else if constexpr (NORM == kStats)
      normalize_from_stats<EPT, TB>(zs, n_slots, stats, E / eps, B, V, eps,
                                    b0, v0, a0, na, c0, same ? 0 : nc);
    __syncthreads();
    const float* za = &zs[(lane.gb * n_slots + lane.eq * 4) * kZS];
    const float* zc = &zs[(lane.gb * n_slots + slot_c + lane.fo * GF) * kZS];
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
        for (int j = 0; j < GF; ++j) g[i][j] = fmaf(a[i], c[j], g[i][j]);
    }
    __syncthreads();
  }
}

// First pass of Norm::kStats.  Block (bt, s, split) forms, for its TB
// block voxels, subject s and its range of voxel tiles, the Fisher-z
// of every epoch of the subject, EPT epochs at a time, and writes the
// mean and inverse std over the subject's `eps` epochs to stats
// [2][B][n_subj][V].
template <int EPT, int TB>
__global__ void __launch_bounds__(kThreads, 1)
subject_stats_kernel(const float* __restrict__ blk,
                     const float* __restrict__ data,
                     float* __restrict__ stats, int T, int B, int V,
                     int eps, int tiles_per_split, int vec_blk,
                     int vec_data) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* zs = stages + Tile<EPT, TB>::kStageFloats;
  constexpr int kItems = TB * kTV / kThreads;  // (b, v) pairs a thread
  static_assert(kItems * kThreads == TB * kTV, "whole (b, v) items");

  const int b0 = blockIdx.x * TB;
  const int s = blockIdx.y;
  const int n_subj = gridDim.y;
  const size_t plane = (size_t)B * n_subj * V;
  const float inv_n = 1.f / (float)eps;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(n_vtiles, t_begin + tiles_per_split);
  for (int vt = t_begin; vt < t_end; ++vt) {
    const int v0 = vt * kTV;
    float sum[kItems];
    float sq[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) sum[k] = sq[k] = 0.f;
    for (int e0 = 0; e0 < eps; e0 += EPT) {
      const int ne = min(EPT, eps - e0);
      corr_tile<EPT, TB, true>(blk, data, T, B, V, s * eps + e0, ne, b0,
                               v0, 0, EPT, vec_blk, vec_data, stages, zs);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int item = threadIdx.x + k * kThreads;
        const float* zp = &zs[(item / kTV) * EPT * kZS + item % kTV];
        for (int e = 0; e < ne; ++e) {
          const float x = zp[e * kZS];
          sum[k] += x;
          sq[k] = fmaf(x, x, sq[k]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int item = threadIdx.x + k * kThreads;
      const int b = b0 + item / kTV;
      const int v = v0 + item % kTV;
      if (b < B && v < V) {
        const float mean = sum[k] * inv_n;
        const float var = sq[k] * inv_n - mean * mean;
        const size_t idx = ((size_t)b * n_subj + s) * V + v;
        stats[idx] = mean;
        stats[plane + idx] = var <= 0.f ? 0.f : 1.0f / sqrtf(var);
      }
    }
  }
}

template <int EPT, int TB>
cudaError_t launch_stats(const float* blk, const float* data,
                         float* stats, int E, int T, int B, int V, int eps,
                         int nsplit, int vec_blk, int vec_data,
                         cudaStream_t s) {
  const int smem = Tile<EPT, TB>::smem_bytes(EPT);
  cudaError_t err = cudaFuncSetAttribute(
      subject_stats_kernel<EPT, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid((B + TB - 1) / TB, E / eps, nsplit);
  subject_stats_kernel<EPT, TB><<<grid, kThreads, smem, s>>>(
      blk, data, stats, T, B, V, eps, per_split, vec_blk, vec_data);
  return cudaGetLastError();
}

// One instantiation of (EPT, TB): the statistics pass first when a
// subject spans several tiles, then `run` with the matching Norm.
template <int EPT, int TB, typename Run>
int dispatch(const float* blk, const float* data, float* stats, int E,
             int T, int B, int V, int eps, int tile_len, int nsplit,
             int vb, int vd, cudaStream_t s, Run run) {
  if (eps <= tile_len) return run(std::integral_constant<int, kTile>());
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_stats<EPT, TB>(blk, data, stats, E, T, B,
                                                V, eps, nsplit, vb, vd, s);
  if (err != cudaSuccess) return (int)err;
  return run(std::integral_constant<int, kStats>());
}

// 16-byte copies need 16-byte aligned rows: aligned base, width % 4 == 0
bool rows_aligned(const float* p, int width) {
  return width % 4 == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace
