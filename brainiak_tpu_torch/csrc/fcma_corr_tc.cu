// K3 on the tensor cores: fused FCMA correlation + Fisher-z +
// within-subject normalization for NVIDIA Hopper (sm_90a), written to
// [B, E, V], with the correlation in 3xTF32 and the operands brought in
// by the TMA.
//
// Replaces, for subjects of at most kMaxEps = 4 epochs (the route of
// the host-CV branch, VoxelSelector.run(clf), at the FCMA path shapes),
// the Pallas kernel brainiak_tpu/ops/pallas_kernels.py
// fcma_corr_normalize (_kernel + _normalized_corr_tile).  Longer
// subjects take fcma_corr_tcl.cu.  The ring constants, the products of
// a stage and the store are in tc_corr.cuh, which that kernel shares.
//
// Inputs: blk [E, T, B] and data [E, T, V], float32, epoch-normalized,
// 16-byte aligned, a row of T every ld_t floats and an epoch every ld_e
// floats (both multiples of 4, as the TMA needs; the wrapper copies an
// operand only where it breaks that, and VoxelSelector lays its data
// out so once).  Output out [B, E, V], contiguous, the caller's V:
//   out[b, e, v] = (z - mean) / std over the epochs of e's subject,
//   z the clamped Fisher-z of r = sum_t blk[e, t, b] data[e, t, v].
// Ragged edges: rows t >= T and voxels past B or V load as 0 (the TMA's
// out-of-range fill, so r = 0), and nothing past B or V is stored.
//
// Precision.  3xTF32: each operand split into hi = tf32(x) (to nearest,
// ties away, as fcma_gram_tc.cu) and lo = x - hi, passed unrounded (the
// tensor core reads a .tf32 operand's 19 high bits, which CUTLASS's
// 3xTF32 also relies on for its small part); the products lo*hi, hi*lo,
// hi*hi accumulate in that order in fp32, so r keeps fp32 accuracy
// (the dropped parts are about 2^-22 of each product).  The Fisher-z
// and the z-score are fcma_tile.cuh's expressions (logf, IEEE division,
// 1e-4 floors; var = E[z^2] - mean^2 in epoch order, the inverse std
// 1.0f / sqrtf(var), 0 where var <= 0).  Built without --use_fast_math.
//
// Bound at the host-CV shape (E=32, T=150, B=128, V=65536): bytes.  The
// data read once and the output written once are 2.33 GB, 0.70 ms at
// 3.35 TB/s; the three TF32 products, 3 x 80.5 GFLOP, take 0.49 ms at
// 494.7 TFLOP/s.  Measured, the mma.sync loop binds: the products alone
// run at about 200 TFLOP/s of TF32 (PERF.md).
//
// Design.
//   * Nothing couples the epochs but the z-score over one subject's
//     eps <= 4 epochs.  So a warp owns the same 16 block voxels x 32
//     voxels in every epoch of one subject: eps m16 tiles of four
//     m16n8k8 n-tiles, 64 fp32 accumulators a thread, and all epochs of
//     a (b, v) land in one thread.  The Fisher-z, the z-score and the
//     store run on the accumulators in registers: no shared-memory z
//     tile, so the stages have the shared memory to themselves.  The
//     epoch count is a template parameter: no branch in the products.
//   * A block of kWB x kWC = 8 x 2 warps owns, per item, one subject,
//     128 block voxels and a tile of 64 voxels.  The grid is persistent
//     (one block an SM); block k takes items k, k + grid, ..., ordered
//     block column fastest, then subject, then voxel tile, so that the
//     blocks reading one data tile run together and the block operand
//     stays in L2.  L2 reads: E B V T 4 (1 / (32 kWC) + 1 / (16 kWB))
//     bytes, 3.8 GB at the host-CV shape.
//   * T streams through a ring of kStages = 2 stages of kKT = 32 rows
//     (96 KB each).  One thread fills a stage with kWC + kWB / 2 TMA
//     tensor copies, [eps, kKT, 32] boxes of 128-byte rows, swizzled, that
//     complete on the stage's full mbarrier; each warp, done with a
//     stage, arrives on its empty mbarrier, and the filling thread waits
//     there before the refill: no block-wide barrier.  The ring runs on
//     across items, so the next item's first stage loads during this
//     item's epilogue.  The k-steps of a stage wholly past T are
//     skipped.  Fragments map to voxels as in fcma_gram_tc.cu
//     (row_voxel, col_chunk), so a warp's loads hit 32 distinct banks.
//   * A thread's accumulators of one row and column hold 4 consecutive
//     voxels (col_chunk), so it stores 16-byte vectors where V % 4 == 0:
//     one store of a warp covers 8 rows x 64 bytes.  The output is read
//     by nothing here: streaming stores, which keep L2 for the operands.

#include "tc_corr.cuh"

namespace {

// The clamped Fisher-z of one (b, v)'s correlations over the EPS epochs
// of its subject, z-scored, in place.
template <int EPS>
__device__ __forceinline__ void fisher_zscore(float (&x)[EPS]) {
  constexpr float inv_n = 1.f / (float)EPS;
  float sum = 0.f;
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < EPS; ++e) {
    float num = 1.f + x[e];
    float den = 1.f - x[e];
    if (num <= 0.f) num = kClamp;
    if (den <= 0.f) den = kClamp;
    x[e] = 0.5f * logf(num / den);
    sum += x[e];
    sq = fmaf(x[e], x[e], sq);
  }
  const float mean = sum * inv_n;
  const float var = sq * inv_n - mean * mean;
  const float inv = var <= 0.f ? 0.f : 1.0f / sqrtf(var);
#pragma unroll
  for (int e = 0; e < EPS; ++e) x[e] = (x[e] - mean) * inv;
}

// The end of an item: the Fisher-z, the z-score and the store from the
// accumulators, which are zeroed.  Accumulator i of n-tile j: row g + 8 (i / 2), column 2q + i % 2, so j
// runs over 4 consecutive voxels (col_chunk).
template <int EPS>
__device__ __forceinline__ void store_item(float (&acc)[EPS][4][4],
                                           float* __restrict__ out, int E,
                                           int B, int V, int b0, int v0,
                                           int e0, int mt, int g, int q,
                                           bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x[EPS];
#pragma unroll
      for (int e = 0; e < EPS; ++e) x[e] = acc[e][j][i];
      fisher_zscore<EPS>(x);
#pragma unroll
      for (int e = 0; e < EPS; ++e) acc[e][j][i] = x[e];
    }
    const int b = b0 + row_voxel<kBoxCols>(mt, g + 8 * (i >> 1));
    const int v = v0 + 4 * col_chunk(2 * q + (i & 1));
#pragma unroll
    for (int e = 0; e < EPS; ++e) {
      const float x[4] = {acc[e][0][i], acc[e][1][i], acc[e][2][i],
                          acc[e][3][i]};
      if (b < B) store4(out, (size_t)b * E + e0 + e, v, V, vec, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[e][j][i] = 0.f;
    }
  }
}

// tmap_data, tmap_blk: tensor maps of data and blk (encode_map) with
// [EPS, kKT, 32] boxes; n_items = block columns x subjects x voxel tiles
template <int EPS>
__global__ void __launch_bounds__(CorrTc::kThreads, 1)
fcma_corr_tc_kernel(const __grid_constant__ CUtensorMap tmap_data,
                    const __grid_constant__ CUtensorMap tmap_blk,
                    float* __restrict__ out, int E, int T, int B, int V,
                    int n_items, int vec) {
  using Tl = CorrTc;
  // 1024-byte aligned: the TMA's 128-byte swizzle repeats every 1024
  extern __shared__ __align__(1024) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * Tl::kStage);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_bx = (B + Tl::kTB - 1) / Tl::kTB;
  const int n_subj = E / EPS;
  const int n_chunks = (T + kKT - 1) / kKT;
  const int n_mine =
      (int)blockIdx.x < n_items
          ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int total = n_mine * n_chunks;
  constexpr unsigned kStageBytes =
      (kWC + kWB / 2) * EPS * kKT * kBoxCols * sizeof(float);

  // the block's item k: block column bx, subject s, voxel tile vt
  auto decode = [&](int k, int& bx, int& s, int& vt) {
    const int it = blockIdx.x + k * gridDim.x;
    bx = it % n_bx;
    s = it / n_bx % n_subj;
    vt = it / n_bx / n_subj;
  };

  // chunk c of the block's run: rows (c % n_chunks) * kKT.. of item
  // c / n_chunks, into stage c % kStages
  auto fetch = [&](int c) {
    if (c < total) {
      int bx, s, vt;
      decode(c / n_chunks, bx, s, vt);
      const int t0 = c % n_chunks * kKT;
      float* st = smem + c % kStages * Tl::kStage;
      uint64_t* bar = full + c % kStages;
      mbar_expect_tx(bar, kStageBytes);
#pragma unroll
      for (int k = 0; k < kWC; ++k)
        tma_load(st + k * Tl::kBox, &tmap_data, bar,
                 vt * Tl::kTV + kBoxCols * k, t0, s * EPS);
#pragma unroll
      for (int k = 0; k < kWB / 2; ++k)
        tma_load(st + (kWC + k) * Tl::kBox, &tmap_blk, bar,
                 bx * Tl::kTB + kBoxCols * k, t0, s * EPS);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, Tl::kWarps);
    }
    // the barriers are visible to the async proxy (the TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g = lane / 4;
  const int q = lane % 4;
  const int wc = warp % kWC;
  const int wb = warp / kWC;
  const int mt = wb & 1;
  float acc[EPS][4][4];
#pragma unroll
  for (int e = 0; e < EPS; ++e)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[e][j][i] = 0.f;
  const int b_lo = row_voxel<kBoxCols>(mt, g);
  const int b_hi = row_voxel<kBoxCols>(mt, g + 8);
  const int cg = 4 * col_chunk(g);

  if (threadIdx.x == 0)
    for (int c = 0; c < kStages; ++c) fetch(c);
  for (int c = 0; c < total; ++c) {
    mbar_wait(full + c % kStages, (c / kStages) & 1);
    const float* st = smem + c % kStages * Tl::kStage;
    const int chunk = c % n_chunks;
    mma_stage<EPS>(st + wc * Tl::kBox, st + (kWC + wb / 2) * Tl::kBox,
                   T - chunk * kKT, q, cg, b_lo, b_hi, acc);
    // the warp is done with the stage; the last warp's arrival frees it
    // for its refill
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % kStages);
    if (threadIdx.x == 0 && c + kStages < total) {
      mbar_wait(empty + c % kStages, (c / kStages) & 1);
      fetch(c + kStages);
    }
    if (chunk == n_chunks - 1) {
      int bx, s, vt;
      decode(c / n_chunks, bx, s, vt);
      store_item<EPS>(acc, out, E, B, V, bx * Tl::kTB + kBoxCols * (wb / 2),
                      vt * Tl::kTV + kBoxCols * wc, s * EPS, mt, g, q, vec);
    }
  }
}

template <int EPS>
int launch(const float* blk, const float* data, float* out, int E, int T,
           int B, int V, int blk_ld_t, int blk_ld_e, int data_ld_t,
           int data_ld_e, cudaStream_t s) {
  using Tl = CorrTc;
  const auto kernel = fcma_corr_tc_kernel<EPS>;
  CUtensorMap map_data, map_blk;
  if (!encode_map(&map_data, data, E, T, V, kBoxCols, EPS, kKT, data_ld_t,
                  data_ld_e) ||
      !encode_map(&map_blk, blk, E, T, B, kBoxCols, EPS, kKT, blk_ld_t,
                  blk_ld_e))
    return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)((B + Tl::kTB - 1) / Tl::kTB) *
                            (E / EPS) * ((V + Tl::kTV - 1) / Tl::kTV);
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, n_items, grid);
  if (err != cudaSuccess) return (int)err;
  const int vec = V % 4 == 0 && (reinterpret_cast<size_t>(out) & 15) == 0;
  kernel<<<grid, Tl::kThreads, Tl::kSmem, s>>>(map_data, map_blk, out, E,
                                               T, B, V, (int)n_items, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Subjects of eps <= 4 epochs (E a multiple of eps); blk and data
// 16-byte aligned with row strides ld_t and epoch strides ld_e (floats,
// multiples of 4); out [B, E, V] contiguous.
extern "C" int fcma_corr_normalize_tc_f32(const float* blk,
                                          const float* data, float* out,
                                          int E, int T, int B, int V,
                                          int eps, int blk_ld_t,
                                          int blk_ld_e, int data_ld_t,
                                          int data_ld_e, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E < 1 || T < 0 || B < 0 || V < 0 || eps < 1 || eps > kMaxEps ||
      E % eps != 0 || !tma_operand(blk, blk_ld_t, blk_ld_e) ||
      !tma_operand(data, data_ld_t, data_ld_e))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  if (T == 0)  // every r is 0, and so is every z-scored z
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * B * E * V, s);
  switch (eps) {
    case 1:
      return launch<1>(blk, data, out, E, T, B, V, blk_ld_t, blk_ld_e,
                       data_ld_t, data_ld_e, s);
    case 2:
      return launch<2>(blk, data, out, E, T, B, V, blk_ld_t, blk_ld_e,
                       data_ld_t, data_ld_e, s);
    case 3:
      return launch<3>(blk, data, out, E, T, B, V, blk_ld_t, blk_ld_e,
                       data_ld_t, data_ld_e, s);
    default:
      return launch<4>(blk, data, out, E, T, B, V, blk_ld_t, blk_ld_e,
                       data_ld_t, data_ld_e, s);
  }
}
