// K chained slab-test steps on a (16 R, 128) block, in f32, in bf16
// arithmetic and in bf16 storage widened to f32: the Hopper counterpart of
// tools/bf16_vpu_probe.py:56 (`make`'s kernel, :31-52), which asked whether a
// bf16 slab chain is ~2x cheaper per element than f32 on the TPU's vector
// unit. Here the question is whether packed bf16x2 arithmetic halves the slab
// instruction count on Hopper's CUDA cores.
//
// Every element is an independent chain, so one thread takes two adjacent
// elements in all three variants: two f32 chains, or one bf16x2 chain. Each
// op rounds as the JAX op does: a separate multiply and subtract (the `_rn`
// intrinsics, which are never contracted into an fma, and -fmad=false for
// f32), NaN-propagating min/max (min.NaN / __hmin2_nan), and the final
// lo + hi rounded once to the output type. bf16 products and differences of
// bf16 values are correctly rounded here and in torch (which computes in f32
// and rounds: f32 carries more than 2 x 8 + 2 bits, so that double rounding
// is innocuous), so the variants are bit-equal to their plain versions. K is
// a kernel argument, so the compiler cannot fold the loop.
//
// Bound on the H100: operations. Per element and step: 4 mul, 4 sub, 6
// min/max, 1 compare and 2 selects; f32 at 67 TFLOP/s, bf16x2 at the
// 134 TFLOP/s of Hopper's non-tensor bf16 rate (NVIDIA H100 white paper).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "probe_common.cuh"

namespace {

__device__ __forceinline__ void slab_steps_f32(float x, int k, float& out) {
  const float iv = x * 1.0009765625f;
  const float oiv = x * 0.999f;
  float lo = x, hi = x + 1.0f;
  for (int s = 0; s < k; ++s) {
    const float t0 = lo * iv - oiv;
    const float t1 = hi * iv - oiv;
    const float t0b = lo * oiv - iv;
    const float t1b = hi * oiv - iv;
    const float tmin = probe_max(probe_min(t0, t1), probe_min(t0b, t1b));
    const float tmax = probe_min(probe_max(t0, t1), probe_max(t0b, t1b));
    const bool hit = tmax >= tmin;
    lo = hit ? -hi : lo;
    hi = hit ? tmin : hi;
  }
  out = lo + hi;
}

__global__ void slab_f32_kernel(const float2* __restrict__ x,
                                float2* __restrict__ out, int n2, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const float2 v = x[i];
  float2 r;
  slab_steps_f32(v.x, k, r.x);
  slab_steps_f32(v.y, k, r.y);
  out[i] = r;
}

__global__ void slab_widen_kernel(const __nv_bfloat162* __restrict__ x,
                                  __nv_bfloat162* __restrict__ out, int n2,
                                  int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const float2 v = __bfloat1622float2(x[i]);
  float2 r;
  slab_steps_f32(v.x, k, r.x);
  slab_steps_f32(v.y, k, r.y);
  out[i] = __floats2bfloat162_rn(r.x, r.y);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

__device__ __forceinline__ __nv_bfloat162 from_bits(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, 4);
  return v;
}

__global__ void slab_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                                 __nv_bfloat162* __restrict__ out, int n2,
                                 int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 v = x[i];
  const __nv_bfloat162 iv = __hmul2_rn(v, __float2bfloat162_rn(1.0009765625f));
  const __nv_bfloat162 oiv = __hmul2_rn(v, __float2bfloat162_rn(0.999f));
  __nv_bfloat162 lo = v;
  __nv_bfloat162 hi = __hadd2_rn(v, __float2bfloat162_rn(1.0f));
  for (int s = 0; s < k; ++s) {
    const __nv_bfloat162 t0 = __hsub2_rn(__hmul2_rn(lo, iv), oiv);
    const __nv_bfloat162 t1 = __hsub2_rn(__hmul2_rn(hi, iv), oiv);
    const __nv_bfloat162 t0b = __hsub2_rn(__hmul2_rn(lo, oiv), iv);
    const __nv_bfloat162 t1b = __hsub2_rn(__hmul2_rn(hi, oiv), iv);
    const __nv_bfloat162 tmin =
        __hmax2_nan(__hmin2_nan(t0, t1), __hmin2_nan(t0b, t1b));
    const __nv_bfloat162 tmax =
        __hmin2_nan(__hmax2_nan(t0, t1), __hmax2_nan(t0b, t1b));
    // 0xFFFF in each half where tmax >= tmin
    const uint32_t hit = __hge2_mask(tmax, tmin);
    lo = from_bits((bits(__hneg2(hi)) & hit) | (bits(lo) & ~hit));
    hi = from_bits((bits(tmin) & hit) | (bits(hi) & ~hit));
  }
  out[i] = __hadd2_rn(lo, hi);
}

}  // namespace

// variant 0: f32 in and out; 1: bf16 arithmetic, bf16 in and out; 2: bf16 in
// and out, f32 arithmetic. n_elems is even; the buffers hold n_elems values.
extern "C" int cpt_probe_slab(int variant, const void* x, void* out,
                              int n_elems, int k, void* stream) {
  if (n_elems % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n2 = n_elems / 2;
  const int block = 256;
  const int grid = (n2 + block - 1) / block;
  if (n2 == 0) return 0;
  switch (variant) {
    case 0:
      slab_f32_kernel<<<grid, block, 0, st>>>(
          static_cast<const float2*>(x), static_cast<float2*>(out), n2, k);
      break;
    case 1:
      slab_bf16_kernel<<<grid, block, 0, st>>>(
          static_cast<const __nv_bfloat162*>(x),
          static_cast<__nv_bfloat162*>(out), n2, k);
      break;
    case 2:
      slab_widen_kernel<<<grid, block, 0, st>>>(
          static_cast<const __nv_bfloat162*>(x),
          static_cast<__nv_bfloat162*>(out), n2, k);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
