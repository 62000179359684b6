// Device helpers shared by the two traversal kernels (traverse.cu, the
// merged 16-ary table; traverse_packet.cu, the split inner/leaf tables).
//
// Both tables store child boxes as six 16-wide field blocks (NaN in empty
// slots) and leaf triangles as (v0, e1 = v1 - v0, e2 = v2 - v0) in
// field-major 9 x 12 order, so the slab test and Moller-Trumbore below are
// the same arithmetic for both, written to round like the plain PyTorch
// versions: the library is built with -fmad=false, the slab test is a
// separate multiply and subtract (lo * iv - oiv with oiv = o * iv), and sums
// associate left to right.
#pragma once
#include <cuda_runtime.h>

namespace cpt {

constexpr int ROW = 128;
constexpr int ARITY = 16;
constexpr int LEAF_MAX = 12;
constexpr float BIG = 3.0e38f;
constexpr float MT_DET_EPS = 1e-4f;
constexpr float TINY = 1e-20f;

// min/max that propagate a NaN operand like jnp.minimum / torch.minimum.
// fminf/fmaxf DROP a NaN and would "hit" an empty slot.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// ops/intersect.py::safe_inv_dir
__device__ __forceinline__ float safe_inv(float d) {
  float sign = d >= 0.0f ? 1.0f : -1.0f;
  float denom = fabsf(d) < TINY ? sign * TINY : d;
  return 1.0f / denom;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ivx, ivy, ivz, oivx, oivy, oivz;
};

__device__ __forceinline__ Ray make_ray(const float* ro, const float* rd,
                                        int i) {
  Ray r;
  r.ox = ro[3 * i];
  r.oy = ro[3 * i + 1];
  r.oz = ro[3 * i + 2];
  r.dx = rd[3 * i];
  r.dy = rd[3 * i + 1];
  r.dz = rd[3 * i + 2];
  r.ivx = safe_inv(r.dx);
  r.ivy = safe_inv(r.dy);
  r.ivz = safe_inv(r.dz);
  r.oivx = r.ox * r.ivx;
  r.oivy = r.oy * r.ivy;
  r.oivz = r.oz * r.ivz;
  return r;
}

// Slab test of child slot k of an inner row (box blocks at row[0:96]).
// Returns whether the ray enters the box before t; tmin is the entry t.
__device__ __forceinline__ bool slab(const float* row, int k, const Ray& r,
                                     float t, float& tmin) {
  const float lox = __ldg(row + 0 * ARITY + k);
  const float loy = __ldg(row + 1 * ARITY + k);
  const float loz = __ldg(row + 2 * ARITY + k);
  const float hix = __ldg(row + 3 * ARITY + k);
  const float hiy = __ldg(row + 4 * ARITY + k);
  const float hiz = __ldg(row + 5 * ARITY + k);
  const float t0x = lox * r.ivx - r.oivx, t1x = hix * r.ivx - r.oivx;
  const float t0y = loy * r.ivy - r.oivy, t1y = hiy * r.ivy - r.oivy;
  const float t0z = loz * r.ivz - r.oivz, t1z = hiz * r.ivz - r.oivz;
  tmin = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                 nan_min(t0z, t1z));
  const float tmax = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                             nan_max(t0z, t1z));
  return tmax >= nan_max(tmin, 0.0f) && tmin < t;
}

// Moller-Trumbore against triangle k of a leaf row (payload at row[0:108]).
// Returns whether it is hit before t, with its tt, u and v.
__device__ __forceinline__ bool moller(const float* row, int k, const Ray& r,
                                       float t, float& tt, float& u,
                                       float& v) {
  const float v0x = __ldg(row + 0 * LEAF_MAX + k);
  const float v0y = __ldg(row + 1 * LEAF_MAX + k);
  const float v0z = __ldg(row + 2 * LEAF_MAX + k);
  const float e1x = __ldg(row + 3 * LEAF_MAX + k);
  const float e1y = __ldg(row + 4 * LEAF_MAX + k);
  const float e1z = __ldg(row + 5 * LEAF_MAX + k);
  const float e2x = __ldg(row + 6 * LEAF_MAX + k);
  const float e2y = __ldg(row + 7 * LEAF_MAX + k);
  const float e2z = __ldg(row + 8 * LEAF_MAX + k);
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = (e1x * hx + e1y * hy) + e1z * hz;
  const float f = 1.0f / (fabsf(a) < MT_DET_EPS ? 1.0f : a);
  const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  u = f * ((sx * hx + sy * hy) + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = f * ((r.dx * qx + r.dy * qy) + r.dz * qz);
  tt = f * ((e2x * qx + e2y * qy) + e2z * qz);
  return fabsf(a) >= MT_DET_EPS && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
         u + v <= 1.0f && tt > 0.0f && tt < t;
}

}  // namespace cpt
