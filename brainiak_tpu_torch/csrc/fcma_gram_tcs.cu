// K1 beyond 104 epochs, its second stage: the per-voxel Gram of a slab
// of the normalized correlation, out[b] = Z_b Z_b^T with Z_b the
// [E, V] row of block voxel b, on the tensor cores in 3xTF32, for
// NVIDIA Hopper (sm_90a).
//
// Replaces, for designs of more than 104 epochs (ops/fcma_kernels.py
// gram_route "tcs"), the Gram of the Pallas kernel
// brainiak_tpu/ops/pallas_kernels.py:223 fcma_gram (_gram_kernel).  The
// route runs in slabs of Bc block voxels: K3's tensor-core bodies write
// the slab [Bc, E, V] once (fcma_corr_tc.cu z-scored, for subjects of
// at most 4 epochs; fcma_corr_tcl.cu's raw mode, the clamped Fisher-z
// with the near-one rule, for longer subjects), and this kernel reads
// it once, z-scoring a raw slab as it loads it.  So each correlation
// is formed once and each normalized value written once and read once.
//
// Inputs: z [Bc, E, V] float32, contiguous: raw Fisher-z (eps > 0) or
// already z-scored (eps = 0).  Output: out [Bc, E, E], contiguous, both
// triangles; with V split over n_split blocks a block voxel, each split
// writes its whole [E, E] into partial [n_split, Bc, E, E], summed in
// split order, no atomics (gram_sum_kernel, tc_gram.cuh).  The split
// count is the caller's, from V alone, so a block voxel's Gram does not
// depend on Bc.  Voxels past V load as 0 and add exactly 0.
//
// Precision.  The z-score is fcma_tile.cuh's: sums of z and z^2 (fmaf)
// over each subject's epochs in epoch order, var = E[z^2] - mean^2,
// the inverse std 1.0f / sqrtf(var), 0 where var <= 0.  The products
// are 3xTF32 as fcma_corr_tc.cu's: hi = tf32(x) to nearest, ties
// away, lo = x - hi passed unrounded (the tensor core reads its 19
// high bits), lo*hi + hi*lo + hi*hi in that order.  Each stage's 12
// products of a tile (4 k-steps of 8 voxels) are summed from 0 on the
// tensor core, then added in IEEE fp32 to the running sum, stages in
// voxel order, as ring_mma_tc.cu drains its accumulator each stage:
// the tensor core's accumulator drops low bits at each product, which
// summed over the 1024 k-steps of a split put the E=216 row 9e-5 of
// K[0, 0] from the plain version.  Never single-pass TF32.  Built without
// --use_fast_math.
//
// Bound at the E=216 row (12 epochs a subject, T=12, B=1024, V=65536):
// the Gram's E (E + 1) / 2 distinct entries, 3 x 3145.5 GFLOP on the
// TF32 tensor cores at 494.7 TFLOP/s, 19.1 ms; reading the slab once,
// 58.0 GB at 3.35 TB/s, 17.3 ms.  The two are of one order; the
// stages' loads stay in flight under the products of the stages
// before them.  Measured, the instruction issue of the mma.sync loop
// binds (a block's k-step loads and splits 8 values for its 6
// products), far from both (PERF.md).
//
// Design.
//   * A block of kWarps = 16 warps owns one block voxel and one V split
//     (and, beyond 224 epochs, one group of the output's blocks: see
//     below).  All E epochs of kGVT = 32 voxels stream through a ring
//     of S stages of [rows16(E)][kGLd] floats in shared memory, by
//     cp.async (16-byte copies where V % 4 == 0), S = 3 up to 528
//     epochs, 2 up to kMaxE = 800.  The row pad of 4 floats puts the
//     8 rows x 4 columns of a fragment load on 32 distinct banks.
//   * A raw stage is z-scored in place: every (subject, voxel) of it
//     is whole in shared memory, one thread an item, the 32 voxels of
//     a warp's items on 32 banks.  With three stages this runs one
//     stage ahead of the products, behind the one barrier a stage, so
//     a warp's z-score overlaps other warps' products.  A z-scored
//     slab skips it.
//   * The upper triangle, in 16 x 16 blocks (I <= J) of two m16n8k8
//     tiles each, is dealt out in row order, a run of NB <= kMaxBlk = 7
//     slots a warp (at most 56 accumulators a thread); 224 epochs give
//     105 blocks, more take several groups of 112 blocks, one a thread
//     block.  Every warp runs all NB slots, a slot past its run on a
//     stand-in block whose sums are never stored, so that a stage's NB
//     blocks are one stretch of code without branches, which the
//     compiler interleaves (105 blocks on 112 slots at E=216).  A
//     block's A fragment (rows 16 I..) and its two B fragments (rows
//     16 J..) are split into hi and lo once a k-step; its two tiles
//     are independent chains of 12 products a stage.  Blocks on the
//     diagonal compute their lower half too; only e <= f is kept,
//     mirrored.
//   * One thread block a block voxel and split: 128 block voxels x 8
//     splits at the E=216 row, eight waves of 132 SMs.

#include <climits>

#include "tc_gram.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kGThreads = 32 * kWarps;
constexpr int kGVT = 32;         // voxels a stage
constexpr int kGLd = kGVT + 4;   // floats a row of a stage
constexpr int kMaxBlk = 7;       // 16 x 16 blocks a warp
constexpr int kMaxE = 800;       // most epochs: two stages fit
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr int rows16(int E) { return (E + 15) / 16 * 16; }

// a stage, then the warps' block table
__host__ __device__ constexpr int gram_tcs_smem(int E, int S) {
  return S * rows16(E) * kGLd * (int)sizeof(float) +
         kWarps * kMaxBlk * (int)sizeof(int2);
}
static_assert(gram_tcs_smem(kMaxE, 2) <= kSmemMax &&
                  gram_tcs_smem(kMaxE + 16, 2) > kSmemMax,
              "kMaxE: the most epochs two stages hold");

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// All E rows of voxels v0.. (the stage's kGVT) of block voxel b's row
// of z into st; voxels past V zero-filled.
__device__ __forceinline__ void load_stage(float* st,
                                           const float* __restrict__ zb,
                                           int E, int V, int v0, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < E * (kGVT / 4); i += kGThreads) {
      const int c = i % (kGVT / 4) * 4;
      const int e = i / (kGVT / 4);
      const int v = v0 + c;
      const int n = min(4, max(0, V - v));
      cp_async16(st + e * kGLd + c, n ? zb + (size_t)e * V + v : zb, 4 * n);
    }
  } else {
    for (int i = threadIdx.x; i < E * kGVT; i += kGThreads) {
      const int c = i % kGVT;
      const int e = i / kGVT;
      const int v = v0 + c;
      cp_async4(st + e * kGLd + c, v < V ? zb + (size_t)e * V + v : zb,
                v < V ? 4 : 0);
    }
  }
}

// Each (subject, voxel) run of eps epochs of the stage z-scored in place
__device__ __forceinline__ void zscore_stage(float* st, int E, int eps) {
  const float inv_n = 1.f / (float)eps;
  for (int item = threadIdx.x; item < E / eps * kGVT; item += kGThreads) {
    float* zp = st + item / kGVT * eps * kGLd + item % kGVT;
    float sum = 0.f;
    float sq = 0.f;
#pragma unroll 4
    for (int k = 0; k < eps; ++k) {
      const float x = zp[k * kGLd];
      sum += x;
      sq = fmaf(x, x, sq);
    }
    const float mean = sum * inv_n;
    const float var = sq * inv_n - mean * mean;
    const float inv = var <= 0.f ? 0.f : 1.0f / sqrtf(var);
#pragma unroll 4
    for (int k = 0; k < eps; ++k) zp[k * kGLd] = (zp[k * kGLd] - mean) * inv;
  }
}

// One stage's products: acc[k][n] += the 3xTF32 products of the warp's
// block slot k, its two n8 tiles, over the stage's kGVT voxels.  Every
// slot runs, those past the warp's blocks on a stand-in whose sums are
// never stored, so the NB blocks are one stretch of code without
// branches that the compiler interleaves.  A block's 12 products of
// each tile (3 a k-step) go into a partial from 0, added to the sum in
// IEEE fp32 at the stage's end: the tensor core's accumulator drops
// low bits at each product (the file's notes on precision).  Fragments
// (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, q = lane % 4: A rows
// (epochs) g and g + 8, columns (voxels) q and q + 4; B rows (voxels) q
// and q + 4, column (epoch) g.
template <int NB>
__device__ __forceinline__ void mma_blocks(const float* st, const int2* tab,
                                           int g, int q,
                                           float (&acc)[NB][2][4]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int2 off = tab[k];
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kGVT; ks += 8) {
      const float* a = st + off.x + g * kGLd + ks + q;
      const float av[4] = {a[0], a[8 * kGLd], a[4], a[8 * kGLd + 4]};
      unsigned ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* b = st + off.y + (8 * n + g) * kGLd + ks + q;
        unsigned bh0, bl0, bh1, bl1;
        split(b[0], bh0, bl0);
        split(b[4], bh1, bl1);
        mma_tf32(d[n], al, bh0, bh1);
        mma_tf32(d[n], ah, bl0, bl1);
        mma_tf32(d[n], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][n][i] += d[n][i];
  }
}

// z [B, E, V]: raw Fisher-z z-scored over runs of eps epochs as it
// loads (eps > 0), or z-scored already (eps = 0); dst: [B, E, E] out or
// [n_split, B, E, E] partials.  Block x: group fastest, then split, then
// block voxel.  S stages; NB block slots a warp; groups of per_group
// blocks.
template <int S, int NB>
__global__ void __launch_bounds__(kGThreads, 1)
fcma_gram_tcs_kernel(const float* __restrict__ z, float* __restrict__ dst,
                     int E, int B, int V, int eps, int n_split,
                     int tiles_per_split, int n_groups, int per_group,
                     int vec) {
  extern __shared__ __align__(16) float smem[];
  const int st_floats = rows16(E) * kGLd;
  int2* tab = reinterpret_cast<int2*>(smem + S * st_floats);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int grp = blockIdx.x % n_groups;
  const int split_id = blockIdx.x / n_groups % n_split;
  const int b = blockIdx.x / n_groups / n_split;

  // the group's blocks of the upper triangle, row by row, and the
  // warp's run of them
  const int nbt = rows16(E) / 16;
  const int n_blk = nbt * (nbt + 1) / 2;
  const int lo = grp * per_group;
  const int n_grp = max(0, min(n_blk, lo + per_group) - lo);
  const int w_lo = lo + warp * n_grp / kWarps;
  const int n_mine = lo + (warp + 1) * n_grp / kWarps - w_lo;
  if (lane < NB) {
    // slots past the warp's blocks run block (0, 0), never stored
    int idx = lane < n_mine ? w_lo + lane : 0;
    int row = 0;
    while (idx >= nbt - row) {
      idx -= nbt - row;
      ++row;
    }
    tab[warp * kMaxBlk + lane] =
        make_int2(16 * row * kGLd, 16 * (row + idx) * kGLd);
  }
  // the rows past E of every stage read as 0
  for (int i = threadIdx.x; i < S * (rows16(E) - E) * kGLd; i += kGThreads) {
    const int per = (rows16(E) - E) * kGLd;
    smem[i / per * st_floats + E * kGLd + i % per] = 0.f;
  }
  __syncthreads();

  float acc[NB][2][4];
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][n][i] = 0.f;

  const float* zb = z + (size_t)b * E * V;
  const int n_vt = (V + kGVT - 1) / kGVT;
  const int t_begin = split_id * tiles_per_split;
  const int n_st = max(0, min(n_vt, t_begin + tiles_per_split) - t_begin);
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < n_st)
      load_stage(smem + c * st_floats, zb, E, V, (t_begin + c) * kGVT, vec);
    cp_async_commit();
  }
  if constexpr (S >= 3) {
    // a raw stage is z-scored one stage ahead of its products, so that
    // one barrier a stage serves both and a warp's z-score runs beside
    // other warps' products
    if (n_st > 0) {
      cp_async_wait<S - 2>();
      __syncthreads();
      if (eps > 0) zscore_stage(smem, E, eps);
    }
    for (int c = 0; c < n_st; ++c) {
      cp_async_wait<S - 3>();
      // stage c + 1 has landed and stage c is z-scored, in every
      // thread's view, and every warp is done with stage c - 1, whose
      // buffer the next load refills
      __syncthreads();
      if (c + S - 1 < n_st)
        load_stage(smem + (c + S - 1) % S * st_floats, zb, E, V,
                   (t_begin + c + S - 1) * kGVT, vec);
      cp_async_commit();
      if (eps > 0 && c + 1 < n_st)
        zscore_stage(smem + (c + 1) % S * st_floats, E, eps);
      mma_blocks<NB>(smem + c % S * st_floats, tab + warp * kMaxBlk, g, q,
                     acc);
    }
  } else {
    for (int c = 0; c < n_st; ++c) {
      cp_async_wait<S - 2>();
      // stage c is in every thread's view, and every warp is done with
      // stage c - 1, whose buffer the next load refills
      __syncthreads();
      if (c + S - 1 < n_st)
        load_stage(smem + (c + S - 1) % S * st_floats, zb, E, V,
                   (t_begin + c + S - 1) * kGVT, vec);
      cp_async_commit();
      float* st = smem + c % S * st_floats;
      if (eps > 0) {
        zscore_stage(st, E, eps);
        __syncthreads();
      }
      mma_blocks<NB>(st, tab + warp * kMaxBlk, g, q, acc);
    }
  }

  // accumulator i of tile n of block k: epoch row 16 I + g + 8 (i / 2),
  // column 16 J + 8 n + 2 q + i % 2; e <= f kept, and mirrored
  float* out = dst + ((size_t)split_id * B + b) * E * E;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k >= n_mine) break;
    const int2 off = tab[warp * kMaxBlk + k];
    const int e0 = off.x / kGLd;
    const int f0 = off.y / kGLd;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = e0 + g + 8 * (i >> 1);
        const int f = f0 + 8 * n + 2 * q + (i & 1);
        if (e <= f && f < E) {
          out[(size_t)e * E + f] = acc[k][n][i];
          out[(size_t)f * E + e] = acc[k][n][i];
        }
      }
    }
  }
}

template <int S, int NB>
int launch(const float* z, float* partial, float* out, int E, int B, int V,
           int eps, int n_split, int n_groups, int per_group,
           cudaStream_t s) {
  const int smem = gram_tcs_smem(E, S);
  cudaError_t err = cudaFuncSetAttribute(
      fcma_gram_tcs_kernel<S, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vt = (V + kGVT - 1) / kGVT;
  const int per_split = (n_vt + n_split - 1) / n_split;
  const long long grid = (long long)B * n_split * n_groups;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  const int vec = V % 4 == 0 && (reinterpret_cast<size_t>(z) & 15) == 0;
  float* dst = n_split == 1 ? out : partial;
  fcma_gram_tcs_kernel<S, NB><<<(unsigned)grid, kGThreads, smem, s>>>(
      z, dst, E, B, V, eps, n_split, per_split, n_groups, per_group, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const size_t n = (size_t)B * E * E;
  const int threads = 256;
  gram_sum_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    s>>>(partial, out, E, B, E, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// z [B, E, V] contiguous: the raw Fisher-z of subjects of eps epochs
// (E a multiple of eps), or z-scored already (eps = 0); E <= 800.
// partial [n_split, B, E, E] scratch (unused when n_split is 1); out
// [B, E, E].
extern "C" int fcma_gram_tcs_f32(const float* z, float* partial, float* out,
                                 int E, int B, int V, int eps, int n_split,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E < 1 || E > kMaxE || B < 0 || V < 0 || eps < 0 ||
      (eps > 0 && E % eps != 0) || n_split < 1 ||
      (n_split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (V == 0)  // no voxels: every Gram is 0
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * B * E * E, s);
  // up to 112 blocks (224 epochs): one group, NB = the most a warp
  // takes; beyond, groups of 112 blocks, 7 a warp
  const int nbt = rows16(E) / 16;
  const int n_blk = nbt * (nbt + 1) / 2;
  const int per_group =
      n_blk < kWarps * kMaxBlk ? n_blk : kWarps * kMaxBlk;
  const int n_groups = (n_blk + per_group - 1) / per_group;
  const int nb = (per_group + kWarps - 1) / kWarps;
  const auto run = [&](auto stages, auto slots) {
    return launch<decltype(stages)::value, decltype(slots)::value>(
        z, partial, out, E, B, V, eps, n_split, n_groups, per_group, s);
  };
  using std::integral_constant;
  if (gram_tcs_smem(E, 3) > kSmemMax)
    return run(integral_constant<int, 2>(), integral_constant<int, 7>());
  switch (nb) {
    case 1:
    case 2:
      return run(integral_constant<int, 3>(), integral_constant<int, 2>());
    case 3:
      return run(integral_constant<int, 3>(), integral_constant<int, 3>());
    case 4:
      return run(integral_constant<int, 3>(), integral_constant<int, 4>());
    case 5:
      return run(integral_constant<int, 3>(), integral_constant<int, 5>());
    case 6:
      return run(integral_constant<int, 3>(), integral_constant<int, 6>());
    default:
      return run(integral_constant<int, 3>(), integral_constant<int, 7>());
  }
}
