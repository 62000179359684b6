// Device helpers shared by the two traversal kernels (traverse.cu, the
// merged 16-ary table; traverse_packet.cu, the split inner/leaf tables).
//
// Both kernels walk one ray per GROUP of 16 lanes, half a warp. At an inner
// visit lane k slab-tests child slot k; at a leaf visit lanes 0-11 each test
// one triangle. Both tables store child boxes as six 16-wide field blocks
// (NaN in empty slots) and leaf triangles as (v0, e1 = v1 - v0, e2 = v2 - v0)
// in field-major 9 x 12 order, so field f of slot k sits at row[f * 16 + k]
// (boxes) or row[f * 12 + k] (triangles): each load instruction of a group
// reads one contiguous 64-byte (48-byte) run of its row.
//
// The two halves of a warp hold different rays and diverge, so every
// ballot and shuffle names its own half (group_mask), never the full warp.
// Every walk-state variable (t, the stack, the current row) is the same in
// all 16 lanes of a group, so branches on it are uniform within the group.
// (Keeping the warp in step instead, both halves through an inner and a leaf
// phase each pass with full-warp masks, measured slower on an H100.)
//
// The arithmetic is the plain PyTorch versions': the library is built with
// -fmad=false, the slab test is a separate multiply and subtract
// (lo * iv - oiv with oiv = o * iv), and sums associate left to right.
#pragma once
#include <cuda_runtime.h>

namespace cpt {

constexpr int ROW = 128;
constexpr int ARITY = 16;
constexpr int GROUP = 16;  // lanes per ray, = ARITY
constexpr int LEAF_MAX = 12;
constexpr int PGIDS = 108;  // leaf row: world-triangle ids (int32 bits)
constexpr float BIG = 3.0e38f;
constexpr float MT_DET_EPS = 1e-4f;
constexpr float TINY = 1e-20f;
constexpr int NO_GID = 1 << 30;

static_assert(GROUP == ARITY, "one lane per child slot");

// min/max that propagate a NaN operand like jnp.minimum / torch.minimum:
// one PTX min.NaN / max.NaN each. fminf/fmaxf DROP a NaN and would "hit" an
// empty slot. The sign of a zero result may differ from torch's; the walks
// only compare these values, and -0 == +0.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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
  r.ox = __ldg(ro + 3 * i);
  r.oy = __ldg(ro + 3 * i + 1);
  r.oz = __ldg(ro + 3 * i + 2);
  r.dx = __ldg(rd + 3 * i);
  r.dy = __ldg(rd + 3 * i + 1);
  r.dz = __ldg(rd + 3 * i + 2);
  r.ivx = safe_inv(r.dx);
  r.ivy = safe_inv(r.dy);
  r.ivz = safe_inv(r.dz);
  r.oivx = r.ox * r.ivx;
  r.oivy = r.oy * r.ivy;
  r.oivz = r.oz * r.ivz;
  return r;
}

// This lane's position in its group, and the lanes of its half-warp.
__device__ __forceinline__ int group_lane() {
  return threadIdx.x & (GROUP - 1);
}
__device__ __forceinline__ unsigned group_mask() {
  return 0xFFFFu << (threadIdx.x & GROUP);
}

// The 16 predicate bits of this lane's group, bit k from lane k.
__device__ __forceinline__ unsigned group_ballot(unsigned mask, bool p) {
  return (__ballot_sync(mask, p) >> (threadIdx.x & GROUP)) & 0xFFFFu;
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

// The group's slab test of all 16 child slots: lane k tests slot k (its
// entry t in tmin); returns the 16-bit hit mask, the same bits as a loop
// over the slots.
__device__ __forceinline__ unsigned group_slab(unsigned mask, const float* row,
                                               const Ray& r, float t,
                                               float& tmin) {
  return group_ballot(mask, slab(row, group_lane(), r, t, tmin));
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

struct LeafHit {
  float t, u, v;
  int gid;
  bool take;
};

// The smallest value over the group (no NaN among them).
__device__ __forceinline__ float group_min(unsigned mask, float x) {
#pragma unroll
  for (int off = GROUP / 2; off; off >>= 1)
    x = fminf(x, __shfl_xor_sync(mask, x, off));
  return x;
}

// The group's Moller-Trumbore over a leaf row: lanes 0-11 each test one
// triangle against the entry t. The winner is the lexicographic minimum of
// (tt, gid) over the accepted lanes: a 4-step butterfly takes the smallest
// tt, a ballot finds the lanes that hold it, and only on an exact-t tie a
// second butterfly takes the smallest id among them. Every lane ends with
// the closest triangle, ties in t to the lowest id (the plain version's
// choice), and its u, v by shuffle from the winning lane. With UV false the
// barycentrics are not shuffled.
template <bool UV>
__device__ __forceinline__ LeafHit group_moller(unsigned mask,
                                                const float* row,
                                                const int* row_i,
                                                const Ray& r, float t) {
  const int k = group_lane();
  LeafHit h{BIG, 0.0f, 0.0f, NO_GID, false};
  bool ok = false;
  if (k < LEAF_MAX) {
    const int g = __ldg(row_i + PGIDS + k);
    float tt, u, v;
    ok = moller(row, k, r, t, tt, u, v);
    if (ok) {
      h.t = tt;
      h.gid = g;
      h.u = u;
      h.v = v;
    }
  }
  h.take = group_ballot(mask, ok) != 0;
  if (h.take) {
    const float best = group_min(mask, h.t);  // misses hold BIG
    const bool at_best = ok && h.t == best;
    unsigned win = group_ballot(mask, at_best);
    if (win & (win - 1)) {
      int g = at_best ? h.gid : NO_GID;
#pragma unroll
      for (int off = GROUP / 2; off; off >>= 1)
        g = min(g, __shfl_xor_sync(mask, g, off));
      win = group_ballot(mask, at_best && h.gid == g);
    }
    const int src = __ffs(win) - 1;
    h.t = best;
    h.gid = __shfl_sync(mask, h.gid, src, GROUP);
    if (UV) {
      h.u = __shfl_sync(mask, h.u, src, GROUP);
      h.v = __shfl_sync(mask, h.v, src, GROUP);
    }
  }
  return h;
}

// The slot with the smallest key over the group (lane k holds slot k's key,
// none NaN), the lowest slot among equal minima, as torch.argmin.
__device__ __forceinline__ int group_argmin(unsigned mask, float key) {
  return __ffs(group_ballot(mask, key == group_min(mask, key))) - 1;
}

// Launch geometry shared by both kernels: 8 groups (rays) per 128-thread
// block. Thread indices are ints: the wrappers keep 16 * n_rays within
// INT_MAX (ops/kernels.py::check_group_count).
constexpr int BLOCK = 128;

inline unsigned grid_for(int n_rays) {
  return (unsigned)(((long long)n_rays * GROUP + BLOCK - 1) / BLOCK);
}

// The ray of this thread's group (unsigned until divided: the last block's
// spare threads may pass INT_MAX).
__device__ __forceinline__ int group_ray() {
  return (int)((blockIdx.x * BLOCK + threadIdx.x) / GROUP);
}

}  // namespace cpt
