// K4 beyond 104 samples, its last stage: the sum over block voxels of
// their per-voxel sample Grams into the [N, N] output, for NVIDIA
// Hopper (sm_90a).
//
// Replaces, for N of 105 to 800 samples (ops/fcma_kernels.py
// sample_gram_route "tcs"), the Pallas kernel
// brainiak_tpu/ops/pallas_kernels.py:311 fcma_sample_gram
// (_sample_gram_kernel), with two kernels of K1's route "tcs" before
// it.  K4's Gram is K1's per-block-voxel Gram summed over the block
// voxels: out[n, m] = sum_b sum_v f[b, n, v] f[b, m, v].  So the route
// runs K1's slabs with samples for epochs and groups of norm_unit for
// subjects: for each slab of Bc block voxels (ops/fcma_kernels.py
// tcs_slabs, at most 8 GiB of [Bc, N, V]) fcma_corr_tcl.cu writes the
// slab's correlation once (its raw mode, the clamped Fisher-z, for
// norm_unit > 1; its r mode, r itself, for raw features; in both the
// near-one r formed again in fp32 FMA), fcma_gram_tcs.cu reads it once
// into the per-block-voxel Grams g [Bc, N, N] (z-scoring each group of
// norm_unit samples as it loads), and this kernel adds those into out.
//
// Order.  out[i] = ((out[i] + g[0, i]) + g[1, i]) + ... in IEEE fp32,
// block voxels ascending, slab after slab onto the running output (the
// first slab starts from 0).  Each block voxel's Gram depends on B, V
// and N alone (fcma_gram_tcs.cu's V split comes from V alone), so the
// result does not depend on the slab budget.  No atomics.
//
// Design.  One thread an output entry i, a grid over the N * N
// entries; a thread reads g[b, i] for b = 0.. in turn, so a warp's
// reads are 32 consecutive floats.  The loop is unrolled by 8, which
// puts 8 of a thread's loads in flight before their adds.  The Grams
// are both triangles, mirrored bit for bit, so the sum is symmetric
// bit for bit too.
//
// Cost at the study's shape (N = 216, 128 block voxels a slab): 23.9
// MB of Grams read a slab, 7 us at 3.35 TB/s, against the slab's 7.25
// GB written and read once by the two kernels before it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 800;  // fcma_gram_tcs.cu's most epochs

// out[i] = (first ? 0 : out[i]) + g[0, i] + ... + g[B - 1, i], in that
// order, for i < nn = N * N
__global__ void __launch_bounds__(kThreads)
    block_voxel_sum_kernel(const float* __restrict__ grams,
                           float* __restrict__ out, int nn, int B,
                           int first) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nn) return;
  float s = first ? 0.f : out[i];
#pragma unroll 8
  for (int b = 0; b < B; ++b) s += grams[(size_t)b * nn + i];
  out[i] = s;
}

}  // namespace

// grams [B, N, N] contiguous, the per-block-voxel Grams of a slab; out
// [N, N]: out += their sum in block-voxel order (out = their sum where
// first is non-zero).  N <= 800; anything else is refused with
// cudaErrorInvalidValue.
extern "C" int fcma_sample_gram_tcs_sum_f32(const float* grams, float* out,
                                            int N, int B, int first,
                                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 0 || N > kMaxN || B < 0 || (B > 0 && grams == nullptr) ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nn = N * N;
  if (nn == 0) return (int)cudaSuccess;
  block_voxel_sum_kernel<<<(nn + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      grams, out, nn, B, first);
  return (int)cudaGetLastError();
}
