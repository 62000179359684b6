// Segmented sum of the path-guiding (energy, weight) updates.
//
// Replaces the Pallas TPU kernel cuda_pathtracer_tpu/ops/guiding_scatter.py
// `_kernel` (called from `segment_sum_pairs`). The TPU had no fast scatter,
// so it sorted the updates and accumulated them window by window through
// one-hot matmuls. Hopper has L2 atomics, which is the reference renderer's
// own form (kernel_update_buckets, kernels.h:878-879): no sort, no scratch.
// Updates keyed outside [0, n_bins) (the discard bin n_bins, samples that are
// not guiding records) are skipped.
//
// What bounds it on the H100: bytes. At sibenik 1080p a band brings
// 1,244,160 ids (5.0 MB) into 1,316,960 bins whose (energy, weight) table
// (10.5 MB) must be zeroed and written whatever the updates, and few
// updates are kept (1,632 in the first converge band). So the table is ONE
// interleaved f32 [n_bins, 2] table, zeroed by one cudaMemsetAsync on the
// caller's stream (no separate fill per column), and the kernel is one
// launch, a thread per 16-byte line of ids:
// - a thread reads its four ids as one int4 (a line that the ids only
//   partly cover, at either end, is read id by id); energy and weight are
//   read only for kept updates, and a warp with no kept update on an id
//   slot skips it on one ballot;
// - each kept update is one 8-byte float2 atomicAdd (Hopper's vector atomic
//   on global memory) into its (energy, weight) pair;
// - lanes of a warp that hit the same bin are grouped with
//   __match_any_sync and summed by shuffles, and one lane per group does
//   the atomic, so a contended distribution (many updates on few bins) is
//   not bound by atomics on one address.
// The memset runs near the memory rate, and the kernel's time is its launch
// and one pass over the ids. A cooperative variant that zeroes the table,
// waits on grid.sync() and scatters in one launch measured slower (PERF.md,
// the scatter's findings).
// The atomic order varies from run to run, so sums match the plain version
// (index_add_) to f32 rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;

// Sum of v over the lanes in `peers` (the lanes holding the same id), left
// in the group's lowest lane: a tree over the group, log2(size) rounds, each
// lane adding in the partial of the next surviving lane above it. Every lane
// of the warp takes part in each round's shuffles and votes.
__device__ __forceinline__ float2 reduce_peers(unsigned peers, float2 v) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));  // position in group
  unsigned above = peers & ~((2u << lane) - 1u);          // higher peers
  while (__any_sync(FULL, above != 0)) {
    const int next = __ffs(above);  // 1 + the next surviving higher peer
    const float ex = __shfl_sync(FULL, v.x, next ? next - 1 : lane);
    const float ey = __shfl_sync(FULL, v.y, next ? next - 1 : lane);
    if (next) {
      v.x = v.x + ex;
      v.y = v.y + ey;
    }
    // lanes at odd positions have given their partial away: drop them
    above &= ~__ballot_sync(FULL, rank & 1u);
    rank >>= 1;
  }
  return v;
}

// One update per lane (seg id s at index i); the whole warp calls it.
__device__ __forceinline__ void scatter_one(int s, int i,
                                            const float* __restrict__ e,
                                            const float* __restrict__ w,
                                            int n_bins,
                                            float2* __restrict__ table) {
  const bool kept = static_cast<unsigned>(s) < static_cast<unsigned>(n_bins);
  if (__ballot_sync(FULL, kept) == 0) return;  // warp-uniform
  float2 v = kept ? make_float2(e[i], w[i]) : make_float2(0.0f, 0.0f);
  const unsigned same = __match_any_sync(FULL, kept ? s : -1);
  const unsigned peers = kept ? same : 0u;
  v = reduce_peers(peers, v);
  const int lane = threadIdx.x & 31;
  if (kept && (__ffs(peers) - 1) == lane) atomicAdd(table + s, v);
}

__global__ void __launch_bounds__(BLOCK)
guiding_scatter_kernel(const float* __restrict__ e,
                       const float* __restrict__ w,
                       const int* __restrict__ seg, int n, int lead,
                       int n_bins, float2* __restrict__ table) {
  // this thread's 16-byte line holds ids [i, i + 4); `lead` ids of the
  // first line lie before seg
  const int i = 4 * (blockIdx.x * BLOCK + threadIdx.x) - lead;
  int s[4] = {-1, -1, -1, -1};
  if (i >= 0 && i + 3 < n) {
    const int4 v = *reinterpret_cast<const int4*>(seg + i);
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k >= 0 && i + k < n) s[k] = seg[i + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) scatter_one(s[k], i + k, e, w, n_bins, table);
}

}  // namespace

// Zeroes the interleaved (energy, weight) table [n_bins, 2] and, when there
// are updates, adds them into it: one memset and one launch on `stream`.
extern "C" int cpt_guiding_scatter(const float* e, const float* w,
                                   const int* seg, int n, int n_bins,
                                   float* table, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(table, 0, sizeof(float2) * (size_t)n_bins, s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(seg) & 15u) >> 2);
  const long long lines = (static_cast<long long>(n) + lead + 3) / 4;
  const int grid = static_cast<int>((lines + BLOCK - 1) / BLOCK);
  guiding_scatter_kernel<<<grid, BLOCK, 0, s>>>(
      e, w, seg, n, lead, n_bins, reinterpret_cast<float2*>(table));
  return static_cast<int>(cudaGetLastError());
}
