// K2, tile route: FCMA ingest epoch z-score for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel
// brainiak_tpu/ops/kernels/epoch_norm.py::_pallas_batch_zscore
// (body _zscore_kernel / _zscore_block), which stages one (1, T,
// tile_v) block in VMEM and reads it once.  epoch_norm.cu is the
// "simple" route beside it (ops/kernels/epoch_norm.py::zscore_route).
//
// x : [N, T, V] (epochs, TRs, voxels), row-major, float or double.
// For every (epoch, voxel) column, over the T rows:
//     out = (x - mean) / (std_pop * sqrt(T))
// and the column is 0 where it is exactly constant (max == min) or
// where the result is not finite (NaN and inf inputs normalize to 0).
//
// Bound: memory.  Each element is read and written once:
// 2 * N * T * V * sizeof(F) bytes, 2.5 GB at [32, 150, 65536] f32,
// 0.751 ms at 3.35 TB/s.  The simple route reads every column three
// times from device memory (at T=150 its blocks' columns overflow L1
// and L2), about 5 GB.  On an H100 80GB HBM3 at 700 W (chip_smoke.py)
// this kernel takes 0.856 ms there (simple 1.777), 0.967 of the rate
// of a copy of the same bytes (torch's, 0.828 ms); at the study's
// [216, 12, 65536] 0.455 ms (simple 0.465, copy 0.449, bound 0.406).
//
// Design: a block takes one tile of one epoch, all T rows of W
// voxels (W a power of two from 32 to 1024, chosen by the wrapper from
// T and the dtype so that a tile holds tens of KB and several blocks
// share an SM: one block's loads overlap another's arithmetic and
// stores).
//   1. Load: every thread issues cp.async copies of the tile into
//      shared memory, [T][W], all in flight at once (16-byte copies
//      where V is a multiple of the vector and both pointers are
//      16-byte aligned, else element copies of the same kernel; voxels
//      past V are not read).  cp.async rather than TMA: no tensor map
//      to encode a call, and no alignment rule on the scalar path.
//   2. Statistics: one thread a column, rows 0..T-1 in order, with the
//      simple route's expressions, so the output is its output bit for
//      bit.  A warp reads consecutive words of a row: no bank
//      conflicts.  The column's mean and denominator go to shared
//      memory; a constant column's denominator is NaN, which the
//      output's finiteness test turns into 0, as the simple route's
//      constant flag does.
//   3. Output: every thread keeps one vector of columns (its means and
//      denominators in registers) and walks the rows, IEEE division,
//      written once with the streaming store (st.global.cs), so the
//      output does not evict inputs still to be read.
// No fast-math: sqrt and division are IEEE-rounded.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;  // shared memory a block may use

template <typename F, int N>
struct alignas(sizeof(F) * N) Pack {
  F a[N];
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void store_cs(float* p, const Pack<float, 4>& o) {
  __stcs(reinterpret_cast<float4*>(p),
         make_float4(o.a[0], o.a[1], o.a[2], o.a[3]));
}
__device__ __forceinline__ void store_cs(double* p,
                                         const Pack<double, 2>& o) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(o.a[0], o.a[1]));
}
__device__ __forceinline__ void store_cs(float* p, const Pack<float, 1>& o) {
  __stcs(p, o.a[0]);
}
__device__ __forceinline__ void store_cs(double* p,
                                         const Pack<double, 1>& o) {
  __stcs(p, o.a[0]);
}

// Shared memory of a block: the [T][W] tile, then W means and W
// denominators.
__host__ __device__ constexpr long long tile_smem(int t, int w, int size) {
  return ((long long)t + 2) * w * size;
}

template <typename F, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
epoch_zscore_tile_kernel(const F* __restrict__ x, F* __restrict__ out, int t,
                         long long v, int w, int n_vt, F scale) {
  constexpr int kVec = VEC ? 16 / (int)sizeof(F) : 1;
  using P = Pack<F, kVec>;
  extern __shared__ __align__(16) unsigned char smem[];
  F* tile = reinterpret_cast<F*>(smem);
  F* mean_s = tile + (size_t)t * w;
  F* denom_s = mean_s + w;

  const long long epoch = blockIdx.x / n_vt;
  const long long v0 = (long long)(blockIdx.x % n_vt) * w;
  const int wv = (int)min((long long)w, v - v0);  // voxels in range
  const F* xe = x + epoch * t * v + v0;
  F* oe = out + epoch * t * v + v0;

  // a thread's place in the load and output passes: vectors q0, q0 +
  // tq, ... of rows r0, r0 + tr, ... (W, and so wq, a power of two)
  const int wq = w / kVec;
  const int wqv = (wv + kVec - 1) / kVec;
  const int tq = min(wq, (int)blockDim.x);
  const int tr = blockDim.x / tq;
  const int q0 = threadIdx.x % tq;
  const int r0 = threadIdx.x / tq;

  for (int q = q0; q < wqv; q += tq) {
    for (int r = r0; r < t; r += tr) {
      cp_async<kVec * (int)sizeof(F)>(tile + (size_t)r * w + q * kVec,
                                      xe + r * v + q * kVec);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int c = threadIdx.x; c < wv; c += blockDim.x) {
    const F* xc = tile + c;
    F sum = F(0);
    F mx = xc[0];
    F mn = xc[0];
    for (int r = 0; r < t; ++r) {
      F a = xc[(size_t)r * w];
      sum += a;
      mx = fmax(mx, a);
      mn = fmin(mn, a);
    }
    F mean = sum / F(t);
    F ss = F(0);
    for (int r = 0; r < t; ++r) {
      F d = xc[(size_t)r * w] - mean;
      ss += d * d;
    }
    F denom = sqrt(ss / F(t)) * scale;
    mean_s[c] = mean;
    denom_s[c] = mx == mn ? F(NAN) : denom;
  }
  __syncthreads();

  for (int q = q0; q < wqv; q += tq) {
    const P m = *reinterpret_cast<const P*>(mean_s + q * kVec);
    const P d = *reinterpret_cast<const P*>(denom_s + q * kVec);
    for (int r = r0; r < t; r += tr) {
      const P a = *reinterpret_cast<const P*>(tile + (size_t)r * w +
                                              q * kVec);
      P o;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        F y = (a.a[k] - m.a[k]) / d.a[k];
        o.a[k] = isfinite(y) ? y : F(0);
      }
      store_cs(oe + r * v + q * kVec, o);
    }
  }
}

template <typename F, bool VEC>
int launch_vec(const F* x, F* out, long long n, int t, long long v, int w,
               F scale, cudaStream_t stream) {
  const long long smem = tile_smem(t, w, (int)sizeof(F));
  cudaError_t err = cudaFuncSetAttribute(
      epoch_zscore_tile_kernel<F, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_vt = (v + w - 1) / w;
  const int threads = w < kMaxThreads ? w : kMaxThreads;
  epoch_zscore_tile_kernel<F, VEC>
      <<<(unsigned)(n * n_vt), threads, (size_t)smem, stream>>>(
          x, out, t, v, w, (int)n_vt, scale);
  return (int)cudaGetLastError();
}

template <typename F>
int launch(const F* x, F* out, long long n, int t, long long v, int w,
           F scale, void* stream) {
  if (n * v == 0 || t == 0) return (int)cudaGetLastError();
  // W: a power of two from 32 to 1024; the tile must fit
  if (w < 32 || w > 1024 || (w & (w - 1)) ||
      tile_smem(t, w, (int)sizeof(F)) > kSmemMax ||
      n * ((v + w - 1) / w) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / (int)sizeof(F);
  const bool vec = v % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return vec ? launch_vec<F, true>(x, out, n, t, v, w, scale,
                                   (cudaStream_t)stream)
             : launch_vec<F, false>(x, out, n, t, v, w, scale,
                                    (cudaStream_t)stream);
}

}  // namespace

extern "C" int epoch_zscore_tile_f32(const float* x, float* out, long long n,
                                     int t, long long v, int w, float scale,
                                     void* stream) {
  return launch<float>(x, out, n, t, v, w, scale, stream);
}

extern "C" int epoch_zscore_tile_f64(const double* x, double* out,
                                     long long n, int t, long long v, int w,
                                     double scale, void* stream) {
  return launch<double>(x, out, n, t, v, w, scale, stream);
}
