// Device helpers shared by the packet-step probe kernels (probe_packet_step.cu,
// probe_decision.cu, probe_visit.cu, probe_packet_walk.cu): the Hopper
// counterparts of the TPU probes that take apart the TPU's packet traversal
// step (tools/pallas_probe_r2f..i.py, kernel_lab*.py, mosaic_bisect.py,
// subpacket_probe.py).
//
// A packet is 128 rays, one thread per ray (lane): a block of 128 threads,
// four warps, holds one program of the TPU probe, its packets looped over by
// every thread. Node rows are f32[128] rows of a table; every thread reads
// the same row, so its loads broadcast. A decision over the packet (per
// slot: the least t of the lanes that hit, and whether any lane hit) is a
// warp reduction (__reduce_min_sync on an order-preserving key of the
// float, __reduce_or_sync on the 16-bit hit masks) and a combine of the four
// warps' partials in shared memory after one __syncthreads; the partials
// are double-buffered by step parity, so the next step's writes never meet
// this step's reads. What the TPU kept in SMEM (stacks, decision words)
// lives in shared memory: thread 0 writes, and the readers see it after the
// next barrier. The scalar state (row, mask, stack pointer) is the same in
// every thread, so branches on it are uniform.
//
// Arithmetic is the plain PyTorch versions' (tools/packet_ops.py): the
// library is built with -fmad=false, sums associate left to right, min/max
// propagate NaN (traverse_common.cuh's min.NaN / max.NaN), the first index
// wins an argmin, and int32 words wrap as jnp's do (floor_mod, abs32).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// the renderer's kernel helpers, part of the probe library's build key
#include "../../csrc/traverse_common.cuh"

namespace pk {

constexpr int LANES = 128;
constexpr int WARPS = LANES / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 3.0e38f;

using cpt::nan_max;
using cpt::nan_min;

// an unsigned key whose order is the float order (-0 < +0; no NaN operands)
__device__ __forceinline__ unsigned f2key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key2f(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// jnp's int32 semantics
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}
__device__ __forceinline__ int abs32(int a) {   // abs(INT_MIN) == INT_MIN
  return a < 0 ? (int)(0u - (unsigned)a) : a;
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// the row a one-row dynamic slice reads in interpret mode: past either end,
// the last row
__device__ __forceinline__ int clamp_row(int i, int n) {
  return (unsigned)i >= (unsigned)n ? n - 1 : i;
}
__device__ __forceinline__ int as_int(const float* p) {
  return __float_as_int(*p);
}

// slab of one slot: (lo - o) * iv (classic) or lo * iv - oiv (product form)
__device__ __forceinline__ void tmin_tmax(float t0x, float t1x, float t0y,
                                          float t1y, float t0z, float t1z,
                                          float& tmin, float& tmax) {
  tmin = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                 nan_min(t0z, t1z));
  tmax = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                 nan_max(t0z, t1z));
}

// box fields f (lo x y z, hi x y z) of slot c at b[f * 16 + c]
__device__ __forceinline__ void slab_sub(const float* b, int c, const float o[3],
                                         const float iv[3], float& tmin,
                                         float& tmax) {
  tmin_tmax((b[c] - o[0]) * iv[0], (b[48 + c] - o[0]) * iv[0],
            (b[16 + c] - o[1]) * iv[1], (b[64 + c] - o[1]) * iv[1],
            (b[32 + c] - o[2]) * iv[2], (b[80 + c] - o[2]) * iv[2], tmin, tmax);
}

__device__ __forceinline__ void slab_fma(const float* b, int c, const float iv[3],
                                         const float oiv[3], float& tmin,
                                         float& tmax) {
  tmin_tmax(b[c] * iv[0] - oiv[0], b[48 + c] * iv[0] - oiv[0],
            b[16 + c] * iv[1] - oiv[1], b[64 + c] * iv[1] - oiv[1],
            b[32 + c] * iv[2] - oiv[2], b[80 + c] * iv[2] - oiv[2], tmin, tmax);
}

__device__ __forceinline__ bool slab_hit(float tmin, float tmax, float t) {
  return tmax >= nan_max(tmin, 0.0f) && tmin < t;
}

// Moller-Trumbore of a triangle given as (v0, e1, e2); the caller adds the
// t tests. tt is f * (e2 . q).
__device__ __forceinline__ bool moller(float v0x, float v0y, float v0z,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       const float o[3], const float d[3],
                                       float eps, float& tt) {
  const float hx = d[1] * e2z - d[2] * e2y;
  const float hy = d[2] * e2x - d[0] * e2z;
  const float hz = d[0] * e2y - d[1] * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const bool small = fabsf(a) < eps;
  const float f = 1.0f / (small ? 1.0f : a);
  const float sx = o[0] - v0x;
  const float sy = o[1] - v0y;
  const float sz = o[2] - v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (d[0] * qx + d[1] * qy + d[2] * qz);
  tt = f * (e2x * qx + e2y * qy + e2z * qz);
  return !small && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
}

// triangle k of a field-major 9 x 12 block at b: fields j at b[j * stride + k]
__device__ __forceinline__ bool moller_row(const float* b, int stride, int k,
                                           const float o[3], const float d[3],
                                           float eps, float& tt) {
  return moller(b[k], b[stride + k], b[2 * stride + k], b[3 * stride + k],
                b[4 * stride + k], b[5 * stride + k], b[6 * stride + k],
                b[7 * stride + k], b[8 * stride + k], o, d, eps, tt);
}

// Per-slot partials of NP packets, double-buffered by step parity.
template <int NP>
struct SlotRed {
  unsigned key[2][NP][WARPS][16];
  unsigned mask[2][NP][WARPS];
};

// each warp's per-slot least key and OR of the hit masks into the partials
template <int NP>
__device__ __forceinline__ void red_put(SlotRed<NP>& r, int buf, int p,
                                        const unsigned (&key)[16],
                                        unsigned mask) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const unsigned k = __reduce_min_sync(FULL, key[c]);
    if (lane == 0) r.key[buf][p][warp][c] = k;
  }
  const unsigned m = __reduce_or_sync(FULL, mask);
  if (lane == 0) r.mask[buf][p][warp] = m;
}

// after the barrier: per slot the least t over the packet, and the any mask
template <int NP>
__device__ __forceinline__ unsigned red_get(const SlotRed<NP>& r, int buf,
                                            int p, float (&pc)[16]) {
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    unsigned k = r.key[buf][p][0][c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) k = min(k, r.key[buf][p][w][c]);
    pc[c] = key2f(k);
  }
  unsigned m = r.mask[buf][p][0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m |= r.mask[buf][p][w];
  return m;
}

// the nearest-first pick: key = pc where any else BIG; the first slot that
// reaches the least key among the hit slots (16 when none hit)
__device__ __forceinline__ int nearest_slot(const float (&pc)[16],
                                            unsigned anyc) {
  float kmin = BIG;
#pragma unroll
  for (int c = 0; c < 16; ++c)
    kmin = nan_min(kmin, ((anyc >> c) & 1u) ? pc[c] : BIG);
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (((anyc >> c) & 1u) && pc[c] == kmin) return c;
  return 16;
}

// the hit slots that reach the least key (a mask)
__device__ __forceinline__ unsigned nearest_slots(const float (&pc)[16],
                                                  unsigned anyc) {
  float kmin = BIG;
#pragma unroll
  for (int c = 0; c < 16; ++c)
    kmin = nan_min(kmin, ((anyc >> c) & 1u) ? pc[c] : BIG);
  unsigned hot = 0;
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (((anyc >> c) & 1u) && pc[c] == kmin) hot |= 1u << c;
  return hot;
}

// a launch on blocks x 128 threads; the cudaError_t of the launch
template <typename Kn, typename... A>
int launch(Kn kernel, int blocks, cudaStream_t st, A... args) {
  kernel<<<blocks, LANES, 0, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pk
