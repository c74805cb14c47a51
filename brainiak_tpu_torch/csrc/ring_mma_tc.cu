// K5 on the tensor cores: one step of the SUMMA ring in 3xTF32 wgmma,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel brainiak_tpu/ops/kernels/ring.py::ring_mma
// (body _mma_kernel, one MXU dot_general) on every CUDA call; the fp32
// FMA kernel csrc/ring_mma.cu stays as the route forced for
// comparisons.  Computes exactly what that kernel computes:
//
//   out[i, col_start + j] = sum_t z[t, i] * rot[t, j]
//
// for i < n_local, j < B, and writes nothing else (the ring's other
// column blocks are left as they were).
//
// Bound: operations.  In 3xTF32 the product is three TF32 products of
// 2 T n_local B operations each on the tensor cores (494.7 TFLOP/s):
// 31.3 ms at T = 600, n_local = B = 65536, against the 17.2 GB store's
// 5.1 ms at 3.35 TB/s, which overlaps them.  When the panel is the
// resident block (the one-shard Gram) the block is symmetric and half
// the products would do, 15.6 ms; this kernel computes all of them.
// On an H100 at a 700 W limit the card runs at that limit while this
// kernel runs, its SM clock well below cuBLAS's (chip_smoke.py samples
// both).
//
// Design.
//   * Pre-pass (split_kmajor_kernel).  wgmma reads TF32 operands from
//     shared memory only K-major (the transpose flags exist for 16-bit
//     types alone), and z [T, n_local] and rot [T, B] are T-major.  The
//     pre-pass reads each operand once, in any strides, through a
//     32 x 32 shared-memory transpose, and writes hi = tf32(x) (to
//     nearest, ties away, as cvt.rna) and lo = x - hi (exact, left
//     unrounded: the tensor core reads its 19 high bits) as K-major
//     [n, t_pad] buffers, t_pad a multiple of 32 and the pad zero.
//   * Product (ring_mma_tc_kernel).  A block owns a 128 x 128 tile at a
//     time: two consumer warpgroups of 64 rows and a producer
//     warpgroup, which gives its registers to them (setmaxnreg: 40 and
//     232 a thread; the block's 384 threads would otherwise leave 168).
//     T streams through a ring of three shared-memory stages of 32 rows
//     (one 128-byte row of every operand row, under the 128-byte
//     swizzle that the TMA writes and the wgmma descriptors read):
//     A_hi, A_lo, B_hi, B_lo [128 x 32], 64 KB a stage.  The producer
//     fills a stage with four TMA tensor copies onto its full mbarrier
//     once both warpgroups have released it on its empty mbarrier.
//     Each k8 step runs m64n128k8 TF32 wgmmas in the order lo.hi,
//     hi.lo, hi.hi (3xTF32: the dropped lo.lo term is about 2^-22 of
//     each product).
//   * Accuracy.  The tensor core's fp32 accumulator loses low bits at
//     each wgmma (the measured error fits rounding toward zero): summed
//     over all of T in it, raw products of scale 1e3 came out 20 times
//     further from float64 than cuBLAS's fp32 product.  So a stage's
//     12 wgmmas go into a partial accumulator (the first overwrites
//     it), which is then added to the tile's sum in fp32 registers:
//     64 + 64 accumulators a thread, hence N = 128.  That was measured
//     to cost no time: the other warpgroup keeps the tensor cores busy
//     while one adds.
//   * The sum over T runs in one order (t ascending, in stages of 32)
//     that depends on neither the tile's place nor n_local or B: no
//     split over T.  So a shard of the ring computes the same entries
//     as the whole, bit for bit.
//   * Persistent: one block per SM walks the tiles in groups of 16 row
//     tiles, so that the blocks in flight share their operand panels
//     in the 50 MB L2 (the split operands at T = 600, n = 65536 are
//     0.32 GB), and the stage ring runs on across tiles, so the next
//     tile's loads overlap this tile's store.  The sums are stored
//     straight from registers, two floats a thread and row, with
//     64-bit offsets, masked at ragged edges, as streaming stores.
//
// Ragged edges: rows past n_local or B load as 0 (the TMA's
// out-of-range fill) and are not stored; t >= T is zero in the split
// buffers.  No value is tested: a NaN column gives NaN in its row or
// column of the block, a zero column exact zeros.

#include "tc_common.cuh"

namespace {

constexpr int kBM = 128;                 // tile rows (z columns)
constexpr int kBN = 128;                 // tile columns (rot columns)
constexpr int kBK = 32;                  // T rows a stage: 128 bytes
constexpr int kStages = 3;
constexpr int kGroupM = 16;              // row tiles of a raster group
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer one
constexpr int kRowBytes = kBK * 4;
constexpr int kABytes = kBM * kRowBytes;  // 16 KB
constexpr int kBBytes = kBN * kRowBytes;  // 16 KB
constexpr int kAHi = 0;
constexpr int kALo = kAHi + kABytes;
constexpr int kBHi = kALo + kABytes;
constexpr int kBLo = kBHi + kBBytes;
constexpr int kStageBytes = kBLo + kBBytes;  // 64 KB
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;

// Shared-memory matrix descriptor of a K-major tile under the 128-byte
// swizzle: 8-row groups 1024 bytes apart (the stride byte offset), the
// leading byte offset unused.  p lies on a 1024-byte boundary, or
// 32 k bytes past one for the k-th k8 step of a 128-byte row.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmmas that own them
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RING_R4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RING_R16(i) RING_R4(i), RING_R4(i + 4), RING_R4(i + 8), RING_R4(i + 12)

// d = A . B (add = 0) or d += A . B (add = 1) over one k8 step: A
// [64 x 8] and B [128 x 8] TF32, both K-major in shared memory
// (descriptors da, db), d the warpgroup's 64 x 128 fp32 accumulator
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : RING_R16(0), RING_R16(16), RING_R16(32), RING_R16(48)
      : "l"(da), "l"(db), "r"(add));
}

#undef RING_R16
#undef RING_R4

// x [t, n] (element (i, j) at x[i ld_t + j ld_n]) -> hi, lo [n, t_pad]
// K-major, zero for t <= i < t_pad.  Block 32 x 8 threads, one 32 x 32
// tile of x.
__global__ void __launch_bounds__(256)
split_kmajor_kernel(const float* __restrict__ x, float* __restrict__ hi,
                    float* __restrict__ lo, int t, long long n,
                    long long ld_t, long long ld_n, int t_pad) {
  __shared__ float tile[32][33];
  const long long n0 = (long long)blockIdx.x * 32;
  const int t0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = t0 + ty + 8 * r;
    const long long j = n0 + tx;
    tile[ty + 8 * r][tx] =
        i < t && j < n ? x[(long long)i * ld_t + j * ld_n] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long j = n0 + ty + 8 * r;
    if (j >= n) continue;
    const float v = tile[tx][ty + 8 * r];
    const float h = __uint_as_float(tf32_rna(v));
    const long long o = j * t_pad + t0 + tx;
    hi[o] = h;
    lo[o] = v - h;
  }
}

// Tile `id` of the grouped raster: kGroupM row tiles, then every column
// tile, row fastest.
__device__ __forceinline__ void raster(int id, int tiles_m, int tiles_n,
                                       int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = id / per_group * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  tm = first_m + id % per_group % group_m;
  tn = id % per_group / group_m;
}

// maps: tensor maps of the split operands (rows of t_pad floats), boxes
// of 32 floats x kBM rows (A) and x kBN rows (B), 128-byte swizzle.
// Persistent: block b takes tiles b, b + gridDim.x, ...
__global__ void __launch_bounds__(kThreads, 1)
ring_mma_tc_kernel(const __grid_constant__ CUtensorMap map_a_hi,
                   const __grid_constant__ CUtensorMap map_a_lo,
                   const __grid_constant__ CUtensorMap map_b_hi,
                   const __grid_constant__ CUtensorMap map_b_lo,
                   float* __restrict__ out, int t_pad, long long n_local,
                   long long nb, long long ld_out, long long col_start,
                   int tiles_m, int tiles_n, int vec) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start there
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n_tiles = tiles_m * tiles_n;
  const int n_chunks = t_pad / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    // the barriers are visible to the async proxy (the TMA)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: it hands its registers to the consumers, and
    // one thread starts every copy; the ring of stages runs on across
    // tiles, so the next tile's first stages load during this tile's
    // last products and its store
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != kConsumers) return;
    int c = 0;
    for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
      int tm, tn;
      raster(id, tiles_m, tiles_n, tm, tn);
      for (int kc = 0; kc < n_chunks; ++kc, ++c) {
        const int s = c % kStages;
        // round c / kStages of the stage; its first round passes at once
        mbar_wait(empty + s, ((c / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        mbar_expect_tx(full + s, kStageBytes);
        const int k0 = kc * kBK;
        tma_load(reinterpret_cast<float*>(st + kAHi), &map_a_hi, full + s,
                 k0, tm * kBM);
        tma_load(reinterpret_cast<float*>(st + kALo), &map_a_lo, full + s,
                 k0, tm * kBM);
        tma_load(reinterpret_cast<float*>(st + kBHi), &map_b_hi, full + s,
                 k0, tn * kBN);
        tma_load(reinterpret_cast<float*>(st + kBLo), &map_b_lo, full + s,
                 k0, tn * kBN);
      }
    }
    return;
  }

  // consumer warpgroups: a stage's products go into `part` (its first
  // wgmma overwrites it), which is then added to `sum` in fp32, so the
  // tensor core's accumulator rounding (see Accuracy above) acts on a
  // stage's sum, not on all of T.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int c = 0;
  for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
    int tm, tn;
    raster(id, tiles_m, tiles_n, tm, tn);
    float sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int kc = 0; kc < n_chunks; ++kc, ++c) {
      const int s = c % kStages;
      mbar_wait(full + s, (c / kStages) & 1);
      const unsigned char* st = smem + s * kStageBytes;
      const uint64_t a_hi = sw128_desc(st + kAHi + wg * 64 * kRowBytes);
      const uint64_t a_lo = sw128_desc(st + kALo + wg * 64 * kRowBytes);
      const uint64_t b_hi = sw128_desc(st + kBHi);
      const uint64_t b_lo = sw128_desc(st + kBLo);
      fence_acc(part);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 8; ++k) {
        // a k8 step is 32 bytes along the row: 2 in descriptor units
        wgmma_tf32(part, a_lo + 2 * k, b_hi + 2 * k, k > 0);
        wgmma_tf32(part, a_hi + 2 * k, b_lo + 2 * k, 1);
        wgmma_tf32(part, a_hi + 2 * k, b_hi + 2 * k, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(part);
      // the stage's products are done: release it for refill
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + s);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += part[i];
    }

    // sum[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h, column
    // 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 tile
    const long long row0 = (long long)tm * kBM + wg * 64 +
                           (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const long long col0 = (long long)tn * kBN + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long i = row0 + 8 * h;
      if (i >= n_local) continue;
      float* row = out + i * ld_out + col_start;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const long long col = col0 + 8 * j;
        const float v0 = sum[4 * j + 2 * h];
        const float v1 = sum[4 * j + 2 * h + 1];
        if (vec && col + 1 < nb) {
          __stcs(reinterpret_cast<float2*>(row + col), make_float2(v0, v1));
        } else {
          if (col < nb) row[col] = v0;
          if (col + 1 < nb) row[col + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

// hi, lo [n, t_pad] (t_pad a positive multiple of 32, >= t) from x [t, n]
// read with element strides ld_t, ld_n.  Returns the CUDA error of the
// launch.
extern "C" int ring_split_f32(const float* x, float* hi, float* lo, int t,
                              long long n, long long ld_t, long long ld_n,
                              int t_pad, void* stream) {
  if (t < 0 || t_pad < 32 || t_pad % 32 != 0 || t > t_pad || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const long long gx = (n + 31) / 32;
  if (gx > 2147483647LL || t_pad / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  split_kmajor_kernel<<<dim3((unsigned)gx, t_pad / 32), 256, 0,
                        (cudaStream_t)stream>>>(x, hi, lo, t, n, ld_t, ld_n,
                                                t_pad);
  return (int)cudaGetLastError();
}

// out[i, col_start + j] = sum_t z[t, i] rot[t, j] from the split
// operands a_hi, a_lo [n_local, t_pad] (of z) and b_hi, b_lo [nb, t_pad]
// (of rot), all 16-byte aligned.  vec != 0: out 8-byte aligned and
// ld_out, col_start even (float2 stores).  One block per SM walks the
// tiles.  Returns the CUDA error of the launch (cudaErrorInvalidValue
// for shapes the grid or the tensor maps do not take).
extern "C" int ring_mma_tc_f32(const float* a_hi, const float* a_lo,
                               const float* b_hi, const float* b_lo,
                               float* out, int t_pad, long long n_local,
                               long long nb, long long ld_out,
                               long long col_start, int vec, void* stream) {
  if (t_pad < 32 || t_pad % 32 != 0 || n_local < 0 || nb < 0)
    return (int)cudaErrorInvalidValue;
  if (n_local == 0 || nb == 0) return (int)cudaGetLastError();
  const long long tiles_m = (n_local + kBM - 1) / kBM;
  const long long tiles_n = (nb + kBN - 1) / kBN;
  if (n_local > 2147483647LL || nb > 2147483647LL ||
      tiles_m * tiles_n > 2147483647LL - 65536 ||
      (long long)kGroupM * tiles_n > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const float* src[4] = {a_hi, a_lo, b_hi, b_lo};
  for (int k = 0; k < 4; ++k) {
    const long long rows = k < 2 ? n_local : nb;
    if (!encode_map(&maps[k], src[k], 1, (int)rows, t_pad, kBK, 1,
                    k < 2 ? kBM : kBN, (size_t)t_pad,
                    (size_t)t_pad * (size_t)rows))
      return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ring_mma_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = tiles_m * tiles_n;
  ring_mma_tc_kernel<<<(unsigned)(n_tiles < sms ? n_tiles : sms), kThreads,
                       kSmem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], out, t_pad, n_local, nb, ld_out,
      col_start, (int)tiles_m, (int)tiles_n, vec);
  return (int)cudaGetLastError();
}
