// Row and element gathers: the Hopper counterpart of six Pallas probes of
// tools/ that asked which gather formulations lower in Mosaic and what a row
// read inside a kernel costs:
//   tools/pallas_gather_probe1.py:16  out[b, :] = tab[idx[b], :]       (ROWS)
//   tools/pallas_gather_probe2.py:12  take_along_axis(tab, idx, axis=0) (TAA0)
//   tools/pallas_gather_probe2.py:27  the same with idx as tall as tab  (TAA0)
//   tools/pallas_gather_probe3.py:12  take_along_axis(..., axis=1)      (TAA1)
//   tools/pallas_probe_r2a.py:10      try_one: row gather, take_along_axis
//                                     axis 1, jnp.take (ROWS, TAA1) and the
//                                     fori_loop sum of scalar-indexed rows
//                                     (:63-67, ROWSUM)
//   tools/pallas_probe_r2f.py:18      t[0:8] + t[N-8:N] over 8-100 MB tables
//                                     (ROWPAIR); on a TPU the question was
//                                     whether the table fits in VMEM, here it
//                                     is where it lives (L1, the 50 MB L2 or
//                                     HBM): CHASE times dependent row reads,
//                                     each row's column 0 naming the next.
// On the TPU each formulation was one program over VMEM-resident blocks; the
// card has no such memory, so every mode reads device memory directly, one
// thread per output element, and a row is read as 16-byte vectors (one float4
// per thread) when its width is a multiple of 4. ROWSUM adds its rows in the
// fori_loop's order and CHASE its rows in step order, so every mode is
// bit-equal to its plain version (no arithmetic but those adds).
//
// Bound on the H100: bytes. A gather moves the rows (or elements) its indices
// name, the indices and the output; at the probes' sizes most calls are
// launch-sized (a few hundred KB). CHASE is latency-bound: one dependent load
// per step per chain, which is what it measures.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { ROWS = 0, TAA0 = 1, TAA1 = 2, ROWSUM = 3, ROWPAIR = 4, CHASE = 5 };

// out[b, :] = tab[idx[b], :] (+ tab[idx2[b], :] for ROWPAIR), as float4.
template <bool PAIR>
__global__ void rows4_kernel(const float4* __restrict__ tab,
                             const int* __restrict__ idx, float4* __restrict__ out,
                             int n_out, int q_per_row) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)n_out * q_per_row) return;
  const int b = (int)(i / q_per_row);
  const int q = (int)(i % q_per_row);
  float4 v = __ldg(tab + (long long)idx[b] * q_per_row + q);
  if (PAIR) {
    const float4 w = __ldg(tab + (long long)idx[n_out + b] * q_per_row + q);
    v.x = v.x + w.x;
    v.y = v.y + w.y;
    v.z = v.z + w.z;
    v.w = v.w + w.w;
  }
  out[i] = v;
}

// The same one float at a time, for widths that are not a multiple of 4.
template <bool PAIR>
__global__ void rows1_kernel(const float* __restrict__ tab,
                             const int* __restrict__ idx, float* __restrict__ out,
                             int n_out, int width) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)n_out * width) return;
  const int b = (int)(i / width);
  const int c = (int)(i % width);
  float v = __ldg(tab + (long long)idx[b] * width + c);
  if (PAIR) v = v + __ldg(tab + (long long)idx[n_out + b] * width + c);
  out[i] = v;
}

// take_along_axis, axis 0: out[b, c] = tab[idx[b, c], c]; tab [N, C].
__global__ void taa0_kernel(const float* __restrict__ tab,
                            const int* __restrict__ idx, float* __restrict__ out,
                            int out_rows, int cols) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)out_rows * cols) return;
  const int c = (int)(i % cols);
  out[i] = __ldg(tab + (long long)idx[i] * cols + c);
}

// take_along_axis, axis 1: out[a, b] = tab[a, idx[a, b]]; tab [A, N].
__global__ void taa1_kernel(const float* __restrict__ tab,
                            const int* __restrict__ idx, float* __restrict__ out,
                            int tab_cols, int out_rows, int out_cols) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)out_rows * out_cols) return;
  const int a = (int)(i / out_cols);
  out[i] = __ldg(tab + (long long)a * tab_cols + idx[i]);
}

// out[0, :] = sum of tab[idx[i], :] for i = 0..steps-1, in that order (the
// fori_loop of r2a:63-67): one thread per float4 of the row.
__global__ void rowsum_kernel(const float4* __restrict__ tab,
                              const int* __restrict__ idx,
                              float4* __restrict__ out, int q_per_row,
                              int steps) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= q_per_row) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < steps; ++i) {
    const float4 v = __ldg(tab + (long long)idx[i] * q_per_row + q);
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
    acc.z = acc.z + v.z;
    acc.w = acc.w + v.w;
  }
  out[q] = acc;
}

__global__ void rowsum1_kernel(const float* __restrict__ tab,
                               const int* __restrict__ idx,
                               float* __restrict__ out, int width, int steps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float acc = 0.f;
  for (int i = 0; i < steps; ++i) acc = acc + __ldg(tab + (long long)idx[i] * width + c);
  out[c] = acc;
}

// Dependent row reads: chain s starts at row idx[s]; each step reads the row
// (q_per_row threads, one float4 each), adds it to the chain's sum, and goes
// to the row that the row's column 0 names. The group's first lane holds
// column 0 and broadcasts it. Every lane runs every step (inactive chains
// read row 0 and store nothing), so the shuffles see full warps.
__global__ void chase_kernel(const float4* __restrict__ tab,
                             const int* __restrict__ idx,
                             float4* __restrict__ out, int n_chains,
                             int q_per_row, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = i / q_per_row;
  const int q = i % q_per_row;
  const bool active = s < n_chains;
  int cur = active ? idx[s] : 0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < steps; ++k) {
    const float4 v = __ldg(tab + (long long)cur * q_per_row + q);
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
    acc.z = acc.z + v.z;
    acc.w = acc.w + v.w;
    cur = (int)__shfl_sync(0xffffffffu, v.x, 0, q_per_row);
    if (!active) cur = 0;
  }
  if (active) out[(long long)s * q_per_row + q] = acc;
}

inline int blocks_for(long long n, int block) {
  return (int)((n + block - 1) / block);
}

}  // namespace

// mode: see Mode. Shapes (row-major, int32 indices, all in range):
//   ROWS     tab [tab_rows, tab_cols], idx [out_rows], out [out_rows, tab_cols]
//   TAA0     tab [tab_rows, tab_cols], idx = out [out_rows, tab_cols]
//   TAA1     tab [tab_rows, tab_cols], idx = out [tab_rows, out_cols]
//   ROWSUM   tab [tab_rows, tab_cols], idx [steps], out [1, tab_cols]
//   ROWPAIR  tab [tab_rows, tab_cols], idx [2, out_rows], out [out_rows, tab_cols]
//   CHASE    tab [tab_rows, tab_cols] (column 0 holds the next row), idx
//            [out_rows] starts, out [out_rows, tab_cols]; tab_cols / 4 a power
//            of two up to 32
extern "C" int cpt_probe_gather(int mode, const float* tab, const int* idx,
                                float* out, int tab_rows, int tab_cols,
                                int out_rows, int out_cols, int steps,
                                void* stream) {
  (void)tab_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int block = 256;
  const bool vec = tab_cols % 4 == 0;
  const int q = tab_cols / 4;
  switch (mode) {
    case ROWS:
    case ROWPAIR:
      if (vec) {
        const long long n = (long long)out_rows * q;
        if (mode == ROWS)
          rows4_kernel<false><<<blocks_for(n, block), block, 0, st>>>(
              reinterpret_cast<const float4*>(tab), idx,
              reinterpret_cast<float4*>(out), out_rows, q);
        else
          rows4_kernel<true><<<blocks_for(n, block), block, 0, st>>>(
              reinterpret_cast<const float4*>(tab), idx,
              reinterpret_cast<float4*>(out), out_rows, q);
      } else {
        const long long n = (long long)out_rows * tab_cols;
        if (mode == ROWS)
          rows1_kernel<false><<<blocks_for(n, block), block, 0, st>>>(
              tab, idx, out, out_rows, tab_cols);
        else
          rows1_kernel<true><<<blocks_for(n, block), block, 0, st>>>(
              tab, idx, out, out_rows, tab_cols);
      }
      break;
    case TAA0:
      taa0_kernel<<<blocks_for((long long)out_rows * tab_cols, block), block, 0,
                    st>>>(tab, idx, out, out_rows, tab_cols);
      break;
    case TAA1:
      taa1_kernel<<<blocks_for((long long)tab_rows * out_cols, block), block, 0,
                    st>>>(tab, idx, out, tab_cols, tab_rows, out_cols);
      break;
    case ROWSUM:
      if (vec)
        rowsum_kernel<<<blocks_for(q, 128), 128, 0, st>>>(
            reinterpret_cast<const float4*>(tab), idx,
            reinterpret_cast<float4*>(out), q, steps);
      else
        rowsum1_kernel<<<blocks_for(tab_cols, 128), 128, 0, st>>>(
            tab, idx, out, tab_cols, steps);
      break;
    case CHASE:
      if (!vec || q > 32 || (q & (q - 1)) != 0) return (int)cudaErrorInvalidValue;
      chase_kernel<<<blocks_for((long long)out_rows * q, 128), 128, 0, st>>>(
          reinterpret_cast<const float4*>(tab), idx,
          reinterpret_cast<float4*>(out), out_rows, q, steps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
