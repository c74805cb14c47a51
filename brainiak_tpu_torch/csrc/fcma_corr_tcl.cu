// K3 on the tensor cores for subjects of more than 4 epochs: fused FCMA
// correlation + Fisher-z + within-subject normalization for NVIDIA
// Hopper (sm_90a), written to [B, E, V], with the correlation in 3xTF32
// and the operands brought in by the TMA.
//
// Replaces, for subjects of more than kMaxEps = 4 epochs (ops/
// fcma_kernels.py corr_route "tcl": the host-CV branch,
// VoxelSelector.run(clf), of a design with 5 or more epochs a subject),
// the Pallas kernel brainiak_tpu/ops/pallas_kernels.py:168
// fcma_corr_normalize (_kernel + _normalized_corr_tile).  Subjects of
// at most 4 epochs take fcma_corr_tc.cu, whose tile, ring, products and
// fragment maps (tc_corr.cuh) this kernel runs unchanged.
//
// Inputs: blk [E, T, B] and data [E, T, V], float32, epoch-normalized,
// 16-byte aligned, a row of T every ld_t floats and an epoch every ld_e
// floats (both multiples of 4, as the TMA needs; the wrapper copies an
// operand only where it breaks that, and VoxelSelector lays its data
// out so once).  Output out [B, E, V], contiguous, the caller's V:
//   out[b, e, v] = (z - mean) / std over the eps epochs of e's subject,
//   z the clamped Fisher-z of r = sum_t blk[e, t, b] data[e, t, v].
// Ragged edges: rows t >= T, epochs past E and voxels past B or V load
// as 0 (the TMA's out-of-range fill), and nothing past B or V is stored.
//
// Precision.  The products are fcma_corr_tc.cu's 3xTF32 (lo*hi + hi*lo
// + hi*hi in fp32, the small parts unrounded), so r keeps fp32
// accuracy.  A correlation with |r| >= kNearOne = 1 - 2^-10 is formed
// again in fp32 FMA, t ascending, before its Fisher-z (fisher_fma,
// fcma_tile.cuh; K1's multi-tile and K4's rule): at a voxel paired with
// itself (r = 1, the host-CV branch without raw_data2) the clamped
// Fisher-z turns the last ulp of r into 4.95 against 8.66, and the
// z-score carries that into the whole subject.  Those r, their z and
// the z-score of a subject whose every r is near one are then those of
// the FMA kernel (fcma_corr.cu) bit for bit.  The z-score is
// fcma_tile.cuh's: sums of z and z^2 (fmaf) in epoch order, var =
// E[z^2] - mean^2, the inverse std 1.0f / sqrtf(var), 0 where
// var <= 0.  Built without --use_fast_math.
//
// Bound at the E=80 row (80 epochs, 40 a subject, T=150, B=128,
// V=4096): bytes.  The inputs read once and the output written once
// are 370 MB, 0.111 ms at 3.35 TB/s; the three TF32 products, 3 x 12.6
// GFLOP, take 0.076 ms at 494.7 TFLOP/s.  This kernel moves the output
// four times (the raw z written, read twice, the z-score written),
// after the products of its last chunk, when nothing else runs
// (PERF.md: that read-back, not the products, holds it back).
//
// Design.
//   * fcma_corr_tc.cu holds all of a subject's epochs of a (b, v) in
//     one thread's registers, 64 accumulators at 4 epochs; 40 would
//     not fit.  Here a warp keeps the same 16 block voxels x 32 voxels
//     of one subject and runs the subject's epochs through the ring in
//     chunks of kMaxEps = 4 (the last one partial; its epochs past the
//     subject are loaded, multiplied and dropped), each chunk the T
//     stages of fcma_corr_tc.cu's mma_stage<4>.
//   * After each chunk a thread stores the clamped Fisher-z of its 64
//     accumulators raw to out, then forms its near-one r again and
//     stores their z over the first.  After the subject's last chunk
//     it reads back the z values it stored itself, twice: once for the
//     sums of z and z^2 in epoch order, once to write (z - mean) * inv
//     over them.  No exchange between threads, no barrier, any eps > 4,
//     and nothing but the accumulators lives across the products, which
//     run at fcma_corr_tc.cu's registers.  (Running sums in registers
//     read back once instead spill in the products' loop, and were
//     slower on the self-pair path and at eps 12; PERF.md.)  The
//     statistics pass of the FMA kernel, which forms every correlation
//     twice, is gone.
//   * The items, the persistent grid and the TMA ring are
//     fcma_corr_tc.cu's: an item is one subject, 128 block voxels and
//     64 voxels; the ring of kStages stages of kKT rows, [4, kKT, 32]
//     boxes, a full and an empty mbarrier a stage, runs on across
//     chunks and items, so the next chunk's first stage loads during a
//     chunk's epilogue.
//   * Raw mode (fcma_corr_fisher_tcl_f32, the template's MODE
//     kFisher), the first stage of K1's route "tcs" (fcma_gram_tcs.cu)
//     for subjects of more than 4 epochs and of K4's route "tcs"
//     (fcma_sample_gram_tcs.cu) for groups of more than one sample:
//     chunk_end alone, so each clamped Fisher-z, the near-one rule
//     included, is stored once and never read back; that route's Gram
//     z-scores it as it loads it.  The subjects do not matter to raw z,
//     so the chunks of 4 run across the whole design (one "subject" of
//     E epochs) and none is cut short at a subject's end.
//   * r mode (fcma_corr_r_tcl_f32, MODE kCorr), the first stage of K4's
//     route "tcs" on raw features (norm_unit <= 1): the raw mode with r
//     itself stored in place of its Fisher-z, each near-one r again
//     formed in fp32 FMA (corr_fma, fcma_tile.cuh), so that a voxel
//     paired with itself has the FMA kernel's r.

#include "tc_corr.cuh"

namespace {

// what the kernel stores (its template's MODE): the z-score over each
// subject (route "tcl"), the raw clamped Fisher-z (the raw mode) or r
constexpr int kNormalize = 0;
constexpr int kFisher = 1;
constexpr int kCorr = 2;

// r as stored: its clamped Fisher-z (Z), or r itself
template <bool Z>
__device__ __forceinline__ float stored(float r) {
  return Z ? fisher_z(r) : r;
}

// The end of a chunk of ne <= 4 epochs e0.. of the item's subject: each
// accumulator's clamped Fisher-z (Z; else r itself) stored raw to out,
// and the accumulators zeroed; then each |r| >= kNearOne (rare: a voxel
// with itself, or a near copy) formed again from blk and data, its
// value stored over the first.  Accumulator i of n-tile j: row
// g + 8 (i / 2), column 2q + i % 2, so j runs over 4 consecutive voxels
// (col_chunk).  Block voxels past B and voxels past V load as 0, so
// theirs are never formed again and every read is in range.
template <bool Z>
__device__ __forceinline__ void chunk_end(
    float (&acc)[kMaxEps][4][4], float* __restrict__ out,
    const float* __restrict__ blk, const float* __restrict__ data, int E,
    int T, int B, int V, int b0, int v0, int e0, int ne, int mt, int g,
    int q, bool vec, int blk_ld_t, int blk_ld_e, int data_ld_t,
    int data_ld_e) {
  // bit (e * 4 + j) * 4 + i set where |acc[e][j][i]| >= kNearOne
  unsigned long long near = 0;
#pragma unroll
  for (int k = 0; k < 64; ++k)
    near |= (unsigned long long)(k / 16 < ne &&
                                 fabsf(acc[k / 16][k / 4 % 4][k % 4]) >=
                                     kNearOne)
            << k;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + row_voxel<kBoxCols>(mt, g + 8 * (i >> 1));
    const int v = v0 + 4 * col_chunk(2 * q + (i & 1));
#pragma unroll
    for (int e = 0; e < kMaxEps; ++e) {
      const float x[4] = {stored<Z>(acc[e][0][i]), stored<Z>(acc[e][1][i]),
                          stored<Z>(acc[e][2][i]), stored<Z>(acc[e][3][i])};
      if (e < ne && b < B)
        store4(out, (size_t)b * E + e0 + e, v, V, vec, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[e][j][i] = 0.f;
    }
  }
  for (; near != 0; near &= near - 1) {
    const int k = __ffsll((long long)near) - 1;
    const int e = k / 16;
    const int j = k / 4 % 4;
    const int i = k % 4;
    const int b = b0 + row_voxel<kBoxCols>(mt, g + 8 * (i >> 1));
    const int v = v0 + 4 * col_chunk(2 * q + (i & 1)) + j;
    out[((size_t)b * E + e0 + e) * V + v] =
        stored<Z>(corr_fma(blk + (size_t)(e0 + e) * blk_ld_e + b,
                           data + (size_t)(e0 + e) * data_ld_e + v, T,
                           blk_ld_t, data_ld_t));
  }
}

// x = out[row, v..v + 3], the voxels past V read as 0; a 16-byte load
// where vec, as store4 stores
__device__ __forceinline__ void load4(const float* out, size_t row, int v,
                                      int V, bool vec, float (&x)[4]) {
  const float* src = out + row * V + v;
  if (vec && v < V) {
    const float4 y = *reinterpret_cast<const float4*>(src);
    x[0] = y.x;
    x[1] = y.y;
    x[2] = y.z;
    x[3] = y.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = v + j < V ? src[j] : 0.f;
  }
}

// epochs a thread reads back at once (its loads in flight)
constexpr int kReadBack = 8;

// The end of an item: each of the thread's (b, v) z-scored over the
// subject's eps epochs s0.., from the z it stored to out, read back
// twice: once for the sums of z and z^2 in epoch order, once to write
// (z - mean) * inv over them (fisher_zscore's expressions in
// fcma_corr_tc.cu).  One (b, 4 voxels) row at a time, so that the
// second read finds the first's lines in L2.
__device__ __forceinline__ void item_end(float* __restrict__ out, int E,
                                         int B, int V, int b0, int v0,
                                         int s0, int eps, int mt, int g,
                                         int q, bool vec) {
  const float inv_n = 1.f / (float)eps;
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + row_voxel<kBoxCols>(mt, g + 8 * (i >> 1));
    const int v = v0 + 4 * col_chunk(2 * q + (i & 1));
    if (b >= B) continue;
    const size_t row0 = (size_t)b * E + s0;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    float sq[4] = {0.f, 0.f, 0.f, 0.f};
    float x[kReadBack][4];
    for (int e = 0; e < eps; e += kReadBack) {
#pragma unroll
      for (int u = 0; u < kReadBack; ++u)
        if (e + u < eps) load4(out, row0 + e + u, v, V, vec, x[u]);
#pragma unroll
      for (int u = 0; u < kReadBack; ++u) {
        if (e + u < eps) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sum[j] += x[u][j];
            sq[j] = fmaf(x[u][j], x[u][j], sq[j]);
          }
        }
      }
    }
    float mean[4];
    float inv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mean[j] = sum[j] * inv_n;
      const float var = sq[j] * inv_n - mean[j] * mean[j];
      inv[j] = var <= 0.f ? 0.f : 1.0f / sqrtf(var);
    }
    for (int e = 0; e < eps; e += kReadBack) {
#pragma unroll
      for (int u = 0; u < kReadBack; ++u)
        if (e + u < eps) load4(out, row0 + e + u, v, V, vec, x[u]);
#pragma unroll
      for (int u = 0; u < kReadBack; ++u) {
        if (e + u < eps) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            x[u][j] = (x[u][j] - mean[j]) * inv[j];
          store4(out, row0 + e + u, v, V, vec, x[u]);
        }
      }
    }
  }
}

// tmap_data, tmap_blk: tensor maps of data and blk (encode_map) with
// [kMaxEps, kKT, 32] boxes; blk and data themselves for the near-one
// step; n_items = block columns x subjects x voxel tiles.  MODE
// kFisher: each chunk's clamped Fisher-z stored once (chunk_end), not
// read back or z-scored (the routes "tcs", whose Gram z-scores as it
// loads); kCorr: the same with r itself
template <int MODE>
__global__ void __launch_bounds__(CorrTc::kThreads, 1)
fcma_corr_tcl_kernel(const __grid_constant__ CUtensorMap tmap_data,
                     const __grid_constant__ CUtensorMap tmap_blk,
                     const float* __restrict__ blk,
                     const float* __restrict__ data,
                     float* __restrict__ out, int E, int T, int B, int V,
                     int eps, int n_items, int vec, int blk_ld_t,
                     int blk_ld_e, int data_ld_t, int data_ld_e) {
  using Tl = CorrTc;
  // 1024-byte aligned: the TMA's 128-byte swizzle repeats every 1024
  extern __shared__ __align__(1024) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * Tl::kStage);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_bx = (B + Tl::kTB - 1) / Tl::kTB;
  const int n_subj = E / eps;
  const int n_ec = (eps + kMaxEps - 1) / kMaxEps;  // chunks a subject
  const int n_tc = (T + kKT - 1) / kKT;            // stages a chunk
  const int per_item = n_ec * n_tc;
  const int n_mine =
      (int)blockIdx.x < n_items
          ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int total = n_mine * per_item;
  constexpr unsigned kStageBytes = Tl::kStage * sizeof(float);

  // the block's item k: block column bx, subject s, voxel tile vt
  auto decode = [&](int k, int& bx, int& s, int& vt) {
    const int it = blockIdx.x + k * gridDim.x;
    bx = it % n_bx;
    s = it / n_bx % n_subj;
    vt = it / n_bx / n_subj;
  };

  // stage c of the block's run: rows (c % n_tc) * kKT.. of epoch chunk
  // c % per_item / n_tc of item c / per_item, into stage c % kStages
  auto fetch = [&](int c) {
    if (c < total) {
      int bx, s, vt;
      decode(c / per_item, bx, s, vt);
      const int e0 = s * eps + c % per_item / n_tc * kMaxEps;
      const int t0 = c % n_tc * kKT;
      float* st = smem + c % kStages * Tl::kStage;
      uint64_t* bar = full + c % kStages;
      mbar_expect_tx(bar, kStageBytes);
#pragma unroll
      for (int k = 0; k < kWC; ++k)
        tma_load(st + k * Tl::kBox, &tmap_data, bar,
                 vt * Tl::kTV + kBoxCols * k, t0, e0);
#pragma unroll
      for (int k = 0; k < kWB / 2; ++k)
        tma_load(st + (kWC + k) * Tl::kBox, &tmap_blk, bar,
                 bx * Tl::kTB + kBoxCols * k, t0, e0);
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
  float acc[kMaxEps][4][4];
#pragma unroll
  for (int e = 0; e < kMaxEps; ++e)
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
    const int chunk = c % n_tc;
    mma_stage<kMaxEps>(st + wc * Tl::kBox, st + (kWC + wb / 2) * Tl::kBox,
                       T - chunk * kKT, q, cg, b_lo, b_hi, acc);
    // the warp is done with the stage; the last warp's arrival frees it
    // for its refill
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + c % kStages);
    if (threadIdx.x == 0 && c + kStages < total) {
      mbar_wait(empty + c % kStages, (c / kStages) & 1);
      fetch(c + kStages);
    }
    if (chunk == n_tc - 1) {
      int bx, s, vt;
      decode(c / per_item, bx, s, vt);
      const int ec = c % per_item / n_tc;
      const int b0 = bx * Tl::kTB + kBoxCols * (wb / 2);
      const int v0 = vt * Tl::kTV + kBoxCols * wc;
      chunk_end<MODE != kCorr>(
          acc, out, blk, data, E, T, B, V, b0, v0, s * eps + ec * kMaxEps,
          min(kMaxEps, eps - ec * kMaxEps), mt, g, q, vec, blk_ld_t,
          blk_ld_e, data_ld_t, data_ld_e);
      if (MODE == kNormalize && ec == n_ec - 1)
        item_end(out, E, B, V, b0, v0, s * eps, eps, mt, g, q, vec);
    }
  }
}

template <int MODE>
int launch(const float* blk, const float* data, float* out, int E, int T,
           int B, int V, int eps, int blk_ld_t, int blk_ld_e, int data_ld_t,
           int data_ld_e, cudaStream_t s) {
  using Tl = CorrTc;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  if (T == 0)  // every r is 0, and so is every z and z-scored z
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * B * E * V, s);
  CUtensorMap map_data, map_blk;
  if (!encode_map(&map_data, data, E, T, V, kBoxCols, kMaxEps, kKT,
                  data_ld_t, data_ld_e) ||
      !encode_map(&map_blk, blk, E, T, B, kBoxCols, kMaxEps, kKT, blk_ld_t,
                  blk_ld_e))
    return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)((B + Tl::kTB - 1) / Tl::kTB) *
                            (E / eps) * ((V + Tl::kTV - 1) / Tl::kTV);
  int grid = 0;
  const cudaError_t err =
      persistent_grid(fcma_corr_tcl_kernel<MODE>, n_items, grid);
  if (err != cudaSuccess) return (int)err;
  const int vec = V % 4 == 0 && (reinterpret_cast<size_t>(out) & 15) == 0;
  fcma_corr_tcl_kernel<MODE><<<grid, Tl::kThreads, Tl::kSmem, s>>>(
      map_data, map_blk, blk, data, out, E, T, B, V, eps, (int)n_items, vec,
      blk_ld_t, blk_ld_e, data_ld_t, data_ld_e);
  return (int)cudaGetLastError();
}

}  // namespace

// Subjects of eps > 4 epochs (E a multiple of eps); blk and data
// 16-byte aligned with row strides ld_t and epoch strides ld_e (floats,
// multiples of 4); out [B, E, V] contiguous.
extern "C" int fcma_corr_normalize_tcl_f32(const float* blk,
                                           const float* data, float* out,
                                           int E, int T, int B, int V,
                                           int eps, int blk_ld_t,
                                           int blk_ld_e, int data_ld_t,
                                           int data_ld_e, void* stream) {
  if (E < 1 || T < 0 || B < 0 || V < 0 || eps <= kMaxEps ||
      E % eps != 0 || !tma_operand(blk, blk_ld_t, blk_ld_e) ||
      !tma_operand(data, data_ld_t, data_ld_e))
    return (int)cudaErrorInvalidValue;
  return launch<kNormalize>(blk, data, out, E, T, B, V, eps, blk_ld_t,
                            blk_ld_e, data_ld_t, data_ld_e,
                            (cudaStream_t)stream);
}

namespace {

// The raw and r modes: every r of the design through the ring in
// chunks of 4 epochs (one "subject" of E epochs)
template <int MODE>
int launch_raw(const float* blk, const float* data, float* out, int E,
               int T, int B, int V, int blk_ld_t, int blk_ld_e,
               int data_ld_t, int data_ld_e, void* stream) {
  if (E < 1 || T < 0 || B < 0 || V < 0 ||
      !tma_operand(blk, blk_ld_t, blk_ld_e) ||
      !tma_operand(data, data_ld_t, data_ld_e))
    return (int)cudaErrorInvalidValue;
  return launch<MODE>(blk, data, out, E, T, B, V, E, blk_ld_t, blk_ld_e,
                      data_ld_t, data_ld_e, (cudaStream_t)stream);
}

}  // namespace

// The raw mode, for the routes "tcs" of K1 and K4: out[b, e, v] = the
// clamped Fisher-z of r[b, e, v], the near-one rule included, stored
// once and not z-scored, whatever the subjects (the epochs run through
// the ring in chunks of 4 across the whole design).  blk and data as
// above.
extern "C" int fcma_corr_fisher_tcl_f32(const float* blk, const float* data,
                                        float* out, int E, int T, int B,
                                        int V, int blk_ld_t, int blk_ld_e,
                                        int data_ld_t, int data_ld_e,
                                        void* stream) {
  return launch_raw<kFisher>(blk, data, out, E, T, B, V, blk_ld_t, blk_ld_e,
                             data_ld_t, data_ld_e, stream);
}

// The r mode, for K4's route "tcs" on raw features: out[b, e, v] =
// r[b, e, v] itself, each |r| >= kNearOne formed again in fp32 FMA, as
// the raw mode stores its Fisher-z.  blk and data as above.
extern "C" int fcma_corr_r_tcl_f32(const float* blk, const float* data,
                                   float* out, int E, int T, int B, int V,
                                   int blk_ld_t, int blk_ld_e, int data_ld_t,
                                   int data_ld_e, void* stream) {
  return launch_raw<kCorr>(blk, data, out, E, T, B, V, blk_ld_t, blk_ld_e,
                           data_ld_t, data_ld_e, stream);
}
