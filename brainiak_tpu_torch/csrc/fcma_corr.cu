// K1 and K3: fused FCMA correlation + Fisher-z + within-subject
// normalization for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels of brainiak_tpu/ops/pallas_kernels.py:
//   K1 fcma_gram            (_gram_kernel + _normalized_corr_tile)
//   K3 fcma_corr_normalize  (_kernel + _normalized_corr_tile)
//
// Inputs: blk [E, T, B] and data [E, T, V], float32, row-major, both
// epoch-normalized (a dot product over T is a Pearson r).  For every
// block voxel b, epoch e and voxel v:
//   r[b, e, v] = sum_t blk[e, t, b] * data[e, t, v]
//   z          = 0.5 * logf(num / den),  num = 1 + r, den = 1 - r, each
//                floored at 1e-4 when <= 0 (clamped Fisher-z)
//   zn         = (z - mean) / sqrt(var) over each subject's epochs,
//                var = E[z^2] - mean^2, and 0 where var <= 0
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
//     still fills 132 SMs).  For each voxel tile it streams T through
//     shared memory in chunks of TT rows and forms r for every epoch
//     of its epoch tile with register-blocked fp32 FMA (each thread a
//     4 block-voxel x 8 voxel micro-tile of one epoch).
//   * Fisher-z is applied in registers, the result goes to shared
//     memory, and the per-subject z-score runs there.
//   * K1 accumulates z z^T in registers that persist across voxel
//     tiles, and writes one partial Gram per (V split, block voxel).
//     A second kernel sums the partials over splits in a fixed order:
//     deterministic, no atomics.  K3 stores zn straight to [B, E, V].
//   * Epochs are handled in tiles of at most EPT epochs made of whole
//     subjects (the z-score never crosses a subject).  When E fits one
//     tile (E <= 32, as in the bench configurations) each block computes
//     every correlation once.  For larger E, K1 blocks take a PAIR of
//     epoch tiles (A, C), A <= C, and produce the Gram's A x C block,
//     mirrored into C x A; each epoch tile's correlations are then
//     recomputed once per pair it belongs to.
//   * Ragged edges are masked in the kernel: rows t >= T, voxels
//     v >= V and block voxels b >= B load as 0, out-of-range voxels
//     are forced to z = 0 and contribute exactly 0 to the Gram, and
//     nothing out of range is stored.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTV = 32;        // voxels per tile
constexpr int kTT = 4;         // TR rows per shared-memory stage
constexpr int kZS = kTV + 1;   // padded row of the z tile (banks)
constexpr float kClamp = 1e-4f;

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

__device__ __forceinline__ void decode_pair(int p, int ntiles, int* ta,
                                            int* tc) {
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
// b0 .. b0+TB-1 against voxels v0 .. v0+31, apply the clamped
// Fisher-z and write z to zs[b][slot0 + e][v] (0 where out of range).
// T streams through two shared-memory stages: the copy of chunk k+1
// is in flight while chunk k is multiplied.
template <int EPT, int TB>
__device__ void corr_fisher(const float* __restrict__ blk,
                            const float* __restrict__ data, int T, int B,
                            int V, int e0, int ne, int b0, int v0,
                            int slot0, int n_slots, bool vec_blk,
                            bool vec_data, float* stages, float* zs) {
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
        float num = 1.f + acc[i][j];
        float den = 1.f - acc[i][j];
        if (num <= 0.f) num = kClamp;
        if (den <= 0.f) den = kClamp;
        z = 0.5f * logf(num / den);
      }
      zs[(b * n_slots + slot0 + el) * kZS + v] = z;
    }
  }
}

// z-score each (block voxel, subject, voxel) group of `eps` epochs in
// place.  Subjects 0 .. ns0-1 sit at slot 0, ns1 more at slot EPT.
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

template <int EPT, int TB>
__global__ void __launch_bounds__(kThreads, 1)
fcma_gram_kernel(const float* __restrict__ blk,
                 const float* __restrict__ data,
                 float* __restrict__ partial, int E, int T, int B, int V,
                 int eps, int tile_len, int ntiles, int tiles_per_split,
                 int vec_blk, int vec_data) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* zs = stages + Tile<EPT, TB>::kStageFloats;

  const int b0 = blockIdx.x * TB;
  const int pair = blockIdx.y;
  const int split = blockIdx.z;
  const int npairs = gridDim.y;
  int ta, tc;
  decode_pair(pair, ntiles, &ta, &tc);
  const int a0 = ta * tile_len;
  const int na = min(tile_len, E - a0);
  const int c0 = tc * tile_len;
  const int nc = min(tile_len, E - c0);
  const bool same = ta == tc;
  const int n_slots = ntiles == 1 ? EPT : 2 * EPT;
  const int slot_c = same ? 0 : EPT;

  // Gram micro-tile: 4 epochs of tile A x GF epochs of tile C
  constexpr int GF = EPT / 4;
  const int gb = threadIdx.x / EPT;
  const int gr = threadIdx.x % EPT;
  const int eq = gr / 4;
  const int fo = gr % 4;
  float g[4][GF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < GF; ++j) g[i][j] = 0.f;

  const int n_vtiles = (V + kTV - 1) / kTV;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_vtiles, t_begin + tiles_per_split);
  for (int vt = t_begin; vt < t_end; ++vt) {
    const int v0 = vt * kTV;
    corr_fisher<EPT, TB>(blk, data, T, B, V, a0, na, b0, v0, 0, n_slots,
                         vec_blk, vec_data, stages, zs);
    if (!same)
      corr_fisher<EPT, TB>(blk, data, T, B, V, c0, nc, b0, v0, EPT,
                           n_slots, vec_blk, vec_data, stages, zs);
    __syncthreads();
    normalize_subjects<EPT, TB>(zs, n_slots, eps, na / eps,
                                same ? 0 : nc / eps);
    __syncthreads();
    const float* za = &zs[(gb * n_slots + eq * 4) * kZS];
    const float* zc = &zs[(gb * n_slots + slot_c + fo * GF) * kZS];
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

  const int bg = b0 + gb;
  if (bg < B) {
    float* dst = partial +
        (((size_t)split * npairs + pair) * B + bg) * (EPT * EPT);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < GF; ++j)
        dst[(eq * 4 + i) * EPT + fo * GF + j] = g[i][j];
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

template <int EPT, int TB>
__global__ void __launch_bounds__(kThreads, 1)
fcma_corr_normalize_kernel(const float* __restrict__ blk,
                           const float* __restrict__ data,
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
    corr_fisher<EPT, TB>(blk, data, T, B, V, a0, na, b0, v0, 0, EPT,
                         vec_blk, vec_data, stages, zs);
    __syncthreads();
    normalize_subjects<EPT, TB>(zs, EPT, eps, na / eps, 0);
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

template <int EPT, int TB>
int launch_gram(const float* blk, const float* data, float* partial,
                float* out, int E, int T, int B, int V, int eps,
                int tile_len, int ntiles, int nsplit, int vec_blk,
                int vec_data, cudaStream_t s) {
  const int n_slots = ntiles == 1 ? EPT : 2 * EPT;
  const int smem = Tile<EPT, TB>::smem_bytes(n_slots);
  cudaError_t err = cudaFuncSetAttribute(
      fcma_gram_kernel<EPT, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int npairs = ntiles * (ntiles + 1) / 2;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid((B + TB - 1) / TB, npairs, nsplit);
  fcma_gram_kernel<EPT, TB><<<grid, kThreads, smem, s>>>(
      blk, data, partial, E, T, B, V, eps, tile_len, ntiles, per_split,
      vec_blk, vec_data);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)npairs * B * EPT * EPT;
  const int threads = 256;
  gram_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                       0, s>>>(partial, out, E, B, EPT, tile_len, ntiles,
                               npairs, nsplit);
  return (int)cudaGetLastError();
}

template <int EPT, int TB>
int launch_corr(const float* blk, const float* data, float* out, int E,
                int T, int B, int V, int eps, int tile_len, int ntiles,
                int nsplit, int vec_blk, int vec_data, cudaStream_t s) {
  const int smem = Tile<EPT, TB>::smem_bytes(EPT);
  cudaError_t err = cudaFuncSetAttribute(
      fcma_corr_normalize_kernel<EPT, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vtiles = (V + kTV - 1) / kTV;
  const int per_split = (n_vtiles + nsplit - 1) / nsplit;
  dim3 grid((B + TB - 1) / TB, ntiles, nsplit);
  fcma_corr_normalize_kernel<EPT, TB><<<grid, kThreads, smem, s>>>(
      blk, data, out, E, T, B, V, eps, tile_len, per_split, vec_blk,
      vec_data);
  return (int)cudaGetLastError();
}

// 16-byte copies need 16-byte aligned rows: aligned base, width % 4 == 0
bool rows_aligned(const float* p, int width) {
  return width % 4 == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

// ept (epoch tile capacity) is 32 or 16; tile_len <= ept whole
// subjects; partial is [nsplit, npairs, B, ept, ept] scratch.
extern "C" int fcma_gram_f32(const float* blk, const float* data,
                             float* partial, float* out, int E, int T,
                             int B, int V, int eps, int ept, int tile_len,
                             int ntiles, int nsplit, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vb = rows_aligned(blk, B);
  const int vd = rows_aligned(data, V);
  if (ept == 32)
    return launch_gram<32, 16>(blk, data, partial, out, E, T, B, V, eps,
                               tile_len, ntiles, nsplit, vb, vd, s);
  if (ept == 16)
    return launch_gram<16, 32>(blk, data, partial, out, E, T, B, V, eps,
                               tile_len, ntiles, nsplit, vb, vd, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int fcma_corr_normalize_f32(const float* blk,
                                       const float* data, float* out,
                                       int E, int T, int B, int V,
                                       int eps, int ept, int tile_len,
                                       int ntiles, int nsplit,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vb = rows_aligned(blk, B);
  const int vd = rows_aligned(data, V);
  if (ept == 32)
    return launch_corr<32, 16>(blk, data, out, E, T, B, V, eps, tile_len,
                               ntiles, nsplit, vb, vd, s);
  if (ept == 16)
    return launch_corr<16, 32>(blk, data, out, E, T, B, V, eps,
                               tile_len, ntiles, nsplit, vb, vd, s);
  return (int)cudaErrorInvalidValue;
}
