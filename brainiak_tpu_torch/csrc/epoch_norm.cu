// K2: FCMA ingest epoch z-score for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel
// brainiak_tpu/ops/kernels/epoch_norm.py::_pallas_batch_zscore
// (body _zscore_kernel / _zscore_block).
//
// x : [N, T, V] (epochs, TRs, voxels), row-major, float or double.
// For every (epoch, voxel) column, over the T rows:
//     out = (x - mean) / (std_pop * sqrt(T))
// and the column is 0 where it is exactly constant (max == min) or
// where the result is not finite (NaN and inf inputs normalize to 0).
//
// This is K2's "simple" route: ops/kernels/epoch_norm.py::zscore_route
// takes it beyond the rows that epoch_norm_tile.cu's shared-memory
// tile holds (T > 1814 in f32, 906 in f64), or when forced.
//
// Bound: memory.  Each element is read and written once by the
// algorithm: 2 * N * T * V * sizeof(T) bytes, 2.5 GB at
// [32, 150, 65536] f32, about 0.75 ms at 3.35 TB/s.  The arithmetic is
// a handful of operations per element.
//
// Design: one thread per column, consecutive threads on consecutive
// voxels, so every row step of a warp reads one contiguous 128-byte
// (f32) segment.  The column is read three times (sum/max/min, then
// the centred sum of squares, then the output pass).  At T=150 the
// rereads miss L1 and L2 (a block's 256 columns are 154 KB, some 160
// MB over the card's resident blocks, against 256 KB of L1 an SM and
// 50 MB of L2), so it moves three reads and a write, about 5.0 GB:
// 1.777 ms on an H100 80GB HBM3 at 700 W (chip_smoke.py), 2.83 TB/s
// of mostly rereads, where epoch_norm_tile.cu takes 0.856 ms.  At
// T=12 a block's columns (12 KB) stay in L1: 0.465 ms against 0.455.
// The variance is two-pass (mean of squared deviations), as the JAX
// kernel computes it.  No fast-math: sqrt and division are
// IEEE-rounded.

#include <cuda_runtime.h>

namespace {

template <typename F>
__global__ void __launch_bounds__(256)
epoch_zscore_kernel(const F* __restrict__ x, F* __restrict__ out,
                    long long n_cols, int t, long long v, F scale) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_cols) return;
  long long epoch = col / v;
  long long vox = col - epoch * v;
  const F* xc = x + epoch * (long long)t * v + vox;
  F* oc = out + epoch * (long long)t * v + vox;

  F sum = F(0);
  F mx = xc[0];
  F mn = xc[0];
  for (int r = 0; r < t; ++r) {
    F a = xc[(long long)r * v];
    sum += a;
    mx = fmax(mx, a);
    mn = fmin(mn, a);
  }
  F mean = sum / F(t);
  F ss = F(0);
  for (int r = 0; r < t; ++r) {
    F d = xc[(long long)r * v] - mean;
    ss += d * d;
  }
  F denom = sqrt(ss / F(t)) * scale;
  bool constant = (mx == mn);
  for (int r = 0; r < t; ++r) {
    F o = (xc[(long long)r * v] - mean) / denom;
    oc[(long long)r * v] = (constant || !isfinite(o)) ? F(0) : o;
  }
}

template <typename F>
int launch(const F* x, F* out, long long n, int t, long long v,
           F scale, void* stream) {
  long long n_cols = n * v;
  if (n_cols == 0 || t == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n_cols + threads - 1) / threads;
  epoch_zscore_kernel<F><<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(x, out, n_cols, t, v,
                                                   scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int epoch_zscore_f32(const float* x, float* out, long long n,
                                int t, long long v, float scale,
                                void* stream) {
  return launch<float>(x, out, n, t, v, scale, stream);
}

extern "C" int epoch_zscore_f64(const double* x, double* out,
                                long long n, int t, long long v,
                                double scale, void* stream) {
  return launch<double>(x, out, n, t, v, scale, stream);
}
