// K5: one step of the SUMMA ring, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel
// brainiak_tpu/ops/kernels/ring.py::ring_mma (body _mma_kernel).
//
//   z   : [T, n_local] row-major, the resident columns of this shard
//   rot : [T, B]       row-major, the panel the shard holds this step
//   out : rows of ld_out floats; the kernel writes
//         out[i, col_start + j] = sum_t z[t, i] * rot[t, j]
//         for i < n_local, j < B, and nothing else (the ring's other
//         column blocks are left as they were).
//
// Bound: operations.  2 T n_local B fp32 FMA operations against
// 4 (T n_local + T B + n_local B) bytes: at T = 600 and
// n_local = B = 65536 that is 5.2e12 operations (76.9 ms at 67 TFLOP/s)
// and 17.4 GB (5.2 ms at 3.35 TB/s).  The output is not symmetric in
// general (rot is another shard's panel), so every entry is computed.
//
// Design: a tiled SGEMM.  A block of 256 threads owns a 128 x 128 tile
// of the output; it walks T in chunks of 8 rows, each chunk of both
// operands staged in shared memory by cp.async into one of two buffers
// while the other is consumed.  Both operands are T-major, so a chunk
// is 8 coalesced row reads of each, with no transpose.  Each thread
// keeps an 8 x 8 register tile (rows ty*4..+3 and 64+ty*4..+3, columns
// likewise with tx) and accumulates with fp32 fmaf, t ascending, so an
// entry's sum does not depend on where its tile lies.  No TF32: the
// reference pins HIGHEST.
//
// Ragged edges: rows t >= T and columns past n_local or B load as 0
// (adding exactly 0); stores are masked.  Operand values are never
// tested, so a NaN column gives NaN rows of the block.  Every offset
// into out is 64-bit: the whole-brain block holds 4.3e9 entries.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output rows (resident columns) per block
constexpr int kBN = 128;  // output columns (panel columns) per block
constexpr int kBK = 8;    // T rows per shared-memory stage

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive floats of row `row` (width `width`, which is also
// the row stride) from column `col` into dst, zero past the edges.
// VEC: width and col are multiples of 4 and the base is 16-byte
// aligned, so one 16-byte copy (partly zero-filled at the edge).
template <bool VEC>
__device__ __forceinline__ void load4(float* dst, const float* base,
                                      int row, bool row_ok,
                                      long long width, long long col) {
  const float* src = base + (long long)row * width + col;
  if (VEC) {
    long long n = row_ok ? width - col : 0;
    n = n < 0 ? 0 : (n > 4 ? 4 : n);
    cp_async16(dst, n > 0 ? src : base, (int)(4 * n));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = row_ok && col + q < width;
      cp_async4(dst + q, ok ? src + q : base, ok ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
ring_mma_kernel(const float* __restrict__ z, const float* __restrict__ rot,
                float* __restrict__ out, int t, long long n_local,
                long long nb, long long ld_out, long long col_start) {
  __shared__ __align__(16) float as[2][kBK][kBM];
  __shared__ __align__(16) float bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const long long i0 = (long long)blockIdx.y * kBM;
  const long long j0 = (long long)blockIdx.x * kBN;
  // loader: one T row and four columns of each operand per thread
  const int lr = tid / 32;
  const int lc = (tid % 32) * 4;
  // compute: an 8 x 8 register tile
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;

  const int n_chunks = (t + kBK - 1) / kBK;
  {
    const bool ok = lr < t;
    load4<VEC>(&as[0][lr][lc], z, lr, ok, n_local, i0 + lc);
    load4<VEC>(&bs[0][lr][lc], rot, lr, ok, nb, j0 + lc);
  }
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    if (c + 1 < n_chunks) {
      const int row = (c + 1) * kBK + lr;
      const bool ok = row < t;
      load4<VEC>(&as[stage ^ 1][lr][lc], z, row, ok, n_local, i0 + lc);
      load4<VEC>(&bs[stage ^ 1][lr][lc], rot, row, ok, nb, j0 + lc);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          &as[stage][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(
          &as[stage][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(
          &bs[stage][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(
          &bs[stage][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const long long i = i0 + (m < 4 ? ty * 4 + m : 64 + ty * 4 + m - 4);
    if (i >= n_local) continue;
    float* row = out + i * ld_out + col_start;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long j = j0 + h * 64 + tx * 4;
      if (VEC && j + 3 < nb) {
        *reinterpret_cast<float4*>(row + j) =
            make_float4(acc[m][h * 4], acc[m][h * 4 + 1], acc[m][h * 4 + 2],
                        acc[m][h * 4 + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < nb) row[j + q] = acc[m][h * 4 + q];
      }
    }
  }
}

}  // namespace

// vec != 0: n_local, B, ld_out and col_start are multiples of 4 and the
// three pointers 16-byte aligned (the wrapper checks).  Returns the
// CUDA error of the launch (cudaErrorInvalidValue for a grid that does
// not fit).
extern "C" int ring_mma_f32(const float* z, const float* rot, float* out,
                            int t, long long n_local, long long nb,
                            long long ld_out, long long col_start, int vec,
                            void* stream) {
  if (n_local <= 0 || nb <= 0) return (int)cudaGetLastError();
  const long long gx = (nb + kBN - 1) / kBN;
  const long long gy = (n_local + kBM - 1) / kBM;
  if (gx > 2147483647LL || gy > 65535LL || t < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (vec) {
    ring_mma_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        z, rot, out, t, n_local, nb, ld_out, col_start);
  } else {
    ring_mma_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        z, rot, out, t, n_local, nb, ld_out, col_start);
  }
  return (int)cudaGetLastError();
}
