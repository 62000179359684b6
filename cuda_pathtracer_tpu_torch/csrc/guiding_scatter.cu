// Segmented sum of the path-guiding (energy, weight) updates.
//
// Replaces the Pallas TPU kernel cuda_pathtracer_tpu/ops/guiding_scatter.py
// `_kernel` (called from `segment_sum_pairs`). The TPU had no fast scatter,
// so it sorted the updates and accumulated them window by window through
// one-hot matmuls. Hopper has L2 atomics: one thread per update adds its
// energy and weight into two f32 tables with atomicAdd, which is the
// reference renderer's own form (kernel_update_buckets, kernels.h:878-879).
// No sort, no scratch. Updates keyed to the discard bin (seg == n_bins,
// samples that are not guiding records) are skipped.
//
// Bound on the H100: L2 atomic throughput (two 4-byte atomics per update;
// ~6.2M updates per 1080p sample, most of them discarded). The atomic order
// varies from run to run, so sums match the plain version (index_add_) to f32
// rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void guiding_scatter_kernel(const float* __restrict__ e,
                                       const float* __restrict__ w,
                                       const int* __restrict__ seg, int n,
                                       int n_bins, float* __restrict__ sum_e,
                                       float* __restrict__ sum_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = seg[i];
  if (s < 0 || s >= n_bins) return;
  atomicAdd(sum_e + s, e[i]);
  atomicAdd(sum_w + s, w[i]);
}

}  // namespace

extern "C" int cpt_guiding_scatter(const float* e, const float* w,
                                   const int* seg, int n, int n_bins,
                                   float* sum_e, float* sum_w, void* stream) {
  const int block = 256;
  const int grid = (n + block - 1) / block;
  guiding_scatter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      e, w, seg, n, n_bins, sum_e, sum_w);
  return static_cast<int>(cudaGetLastError());
}
