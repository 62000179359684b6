// Closest-hit / any-hit traversal of the merged 16-ary world BVH (v2).
//
// Replaces the Pallas TPU kernel cuda_pathtracer_tpu/ops/traverse_packet2.py:289
// `_kernel` (called from `_run_packets2`, entry `traverse_packet2`). The TPU
// walked 128-ray packets over the union of their hitmasks because its vector
// unit runs lanes in lockstep. Here one group of 16 lanes (half a warp) walks
// one ray: at an inner visit lane k slab-tests child slot k, at a leaf lanes
// 0-11 test one triangle each (traverse_common.cuh).
//
// The walk is the plain PyTorch version's (ops/traverse_packet2.py::
// traverse_merged_ref), visit for visit: descend lowest slot first with a
// stack of (hitmask, meta) entries, test a leaf's triangles against
// the t the ray had on entering the leaf, break an exact-t tie inside a leaf
// to the lowest id, end a stop-on-hit ray at its first hit. So t, gid, found
// and u, v equal the plain version's bit for bit.
//
// What bounds it on the H100: the latency of dependent 512-byte row reads
// (the next row depends on this row's slab test), and the divergence between
// the two groups of a warp, which walk different rays (one at an inner row
// while the other is at a leaf, one done while the other walks on). One
// thread per ray paid each visit as 96 (inner) or 108 (leaf) scalar loads and
// 16 or 12 tests in sequence, its warp's 32 loads scattered over 32 rows. A
// group reads its row field by field: one load instruction per field moves
// 64 contiguous bytes, so a visit is 7 (inner) or 10 (leaf) independent loads
// and one test per lane, then a ballot (inner) or a 4-step min reduction
// (leaf). A long walk is then a chain of short visits instead of a chain of
// 16 tests per visit, and a warp's two walks wait for each other only where
// they diverge. The price is 16 threads per ray: more instructions per ray on
// a coherent wave, where a thread per ray kept all 32 lanes busy.
//
// The stack belongs to the group, but every lane keeps its own copy in its
// local stack frame (48 x 8 bytes, cached in L1): all 16 lanes push and pop
// the same entries, so no lane waits on another. The top entry lives in
// registers; popping a sibling only clears a bit of it. Measured on an H100
// with utils/kernel_ab.py: one copy per group in shared memory, written by
// lane 0 between two __syncwarp, ran 1-8% slower per wave; staging rows 0-16
// (the root and its children) in shared memory per block by one bulk async
// copy ran 3-33% slower. ptxas: 51 registers, a 384-byte stack frame, no
// spills.
//
// Hazards, each handled here or in traverse_common.cuh:
//  * NaN boxes: empty child slots hold NaN boxes. fminf/fmaxf DROP a NaN
//    operand and would "hit" a slot that does not exist; nan_min/nan_max
//    propagate it like jnp.minimum/torch.minimum, so every compare fails.
//  * Rounding: t must be bit-identical to the plain version, so the file is
//    built with -fmad=false (no multiply-add contraction), IEEE division and
//    square root, and no --use_fast_math.
//  * Bitcast words: the meta word and the triangle ids are int32 bit
//    patterns stored in f32 rows, most of them denormal as floats. They are
//    loaded as int32 through an int pointer, never through float arithmetic
//    (which could flush them to zero).
//  * Divergent half-warps: every ballot and shuffle names the group's 16
//    lanes (group_mask), never the whole warp.
//
// The renderer's trace (ops/dispatch.py::trace) is two launches of this
// file: prepass_kernel, then traverse_kernel with its merge epilogue.
//
// prepass_kernel replaces no TPU kernel: the JAX package's sphere and plane
// prepass (cuda_pathtracer_tpu/ops/traverse.py::_primitives_prepass) is XLA
// code in its jitted trace. It is the plain version's ~70 PyTorch launches
// a trace (ops/traverse.py::prepass_ref: the default t_max, active and
// stop_on_hit fills, ray_sphere and ray_plane over [B, K] with a fold per
// family, the live mask) in one launch, one thread per ray, every sphere
// and plane in a loop (a scene with none costs nothing). Its work is a few
// dozen flops a primitive; a ray reads 24 bytes (ro, rd), plus up to 6 for
// t_max, active and stop_on_hit, and writes 15 (t, prim_type and prim_id,
// found, live and stop: chip_smoke.py's PREPASS_*_BYTES), so it is bound by
// its launch and the bytes; the primitives are a few hundred bytes, read
// through the read-only cache. Its values equal the plain version's bit
// for bit: every product, sum, quotient and root is one IEEE operation in
// the plain version's order (__fmul_rn and its kin, which no compiler
// contracts), clamp_min keeps a NaN as torch.clamp_min does, and a
// family's fold keeps _fold's rule: a primitive must beat the t the ray
// had before the family strictly, and the lowest index wins an exact-t tie.
//
// traverse_kernel's merge epilogue, when the wrapper passes the prepass's
// prim_type, prim_id and found, writes the trace's Hit directly: the
// triangle where the walk found one, else the prepass's primitive, and
// intersected = active & (found | found0), in place of five PyTorch
// where()s. Without them the kernel writes the walk's own (t, gid, found):
// the renderer never takes that mode; it is the walk alone, kept so the
// walk can be timed and checked on its own (the benchmark's traverse
// roofline, chip_smoke.py's wave holds, utils/kernel_ab.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

namespace {

using namespace cpt;

constexpr int PMETA = 96;
constexpr int META_BASE_BITS = 20;
// stack entries per group; the wrapper checks depth + 2 <= MAX_STACK
constexpr int MAX_STACK = 48;

// ops/traverse.py's primitive tags, constants.T_MAX and constants.EPS
constexpr int PRIM_TRIANGLE = 0;
constexpr int PRIM_SPHERE = 1;
constexpr int PRIM_PLANE = 2;
constexpr float T_MAX = 9999999.0f;
constexpr float PLANE_EPS = 1e-3f;
constexpr float SMALL_A = 0.001f;
constexpr int PREPASS_BLOCK = 256;

// vecmath.dot: (a0*b0 + a1*b1) + a2*b2, each operation rounded alone
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// torch.clamp_min(x, 0.0): a NaN stays NaN (fmaxf alone would drop it)
__device__ __forceinline__ float clamp_min0(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

// one family's fold (ops/traverse.py::_fold), fed a primitive at a time:
// ts_m = t_k where the primitive beats the ray's t before the family, else
// T_MAX; the least ts_m and the lowest index holding it
struct Fold {
  float t_before, best;
  int j;
  bool got;
  __device__ __forceinline__ explicit Fold(float t)
      : t_before(t), best(T_MAX), j(0), got(false) {}
  __device__ __forceinline__ void add(int k, bool hit, float ts) {
    const bool better = hit && ts < t_before;
    const float m = better ? ts : T_MAX;
    if (k == 0 || m < best) {
      best = m;
      j = k;
    }
    got = got || better;
  }
};

__global__ void __launch_bounds__(PREPASS_BLOCK)
    prepass_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ t_max,
                   const uint8_t* __restrict__ active,
                   const uint8_t* __restrict__ stop_on_hit, int any_hit,
                   const float* __restrict__ sphere_pos,
                   const float* __restrict__ sphere_radius, int n_spheres,
                   const float* __restrict__ plane_normal,
                   const float* __restrict__ plane_d, int n_planes, int n,
                   float* __restrict__ t_out, int* __restrict__ ptype_out,
                   int* __restrict__ pid_out, uint8_t* __restrict__ found_out,
                   uint8_t* __restrict__ live_out,
                   uint8_t* __restrict__ stop_out) {
  const int i = blockIdx.x * PREPASS_BLOCK + threadIdx.x;
  if (i >= n) return;
  const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
  const float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
  float t = t_max ? t_max[i] : T_MAX;
  int ptype = PRIM_TRIANGLE, pid = -1;
  bool found = false;
  if (n_spheres > 0) {
    // intersect.ray_sphere
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const bool small_a = fabsf(a) < SMALL_A;
    const float denom = __fmul_rn(2.0f, small_a ? 1.0f : a);
    const float a4 = __fmul_rn(4.0f, a);
    Fold f(t);
    for (int k = 0; k < n_spheres; ++k) {
      const float ocx = __fsub_rn(ox, __ldg(sphere_pos + 3 * k));
      const float ocy = __fsub_rn(oy, __ldg(sphere_pos + 3 * k + 1));
      const float ocz = __fsub_rn(oz, __ldg(sphere_pos + 3 * k + 2));
      const float r = __ldg(sphere_radius + k);
      const float b = __fmul_rn(2.0f, dot3(dx, dy, dz, ocx, ocy, ocz));
      const float c =
          __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), __fmul_rn(r, r));
      const float det = __fsub_rn(__fmul_rn(b, b), __fmul_rn(a4, c));
      const float sdet = __fsqrt_rn(clamp_min0(det));
      const float tmin = __fdiv_rn(__fsub_rn(-b, sdet), denom);
      const float tmax = __fdiv_rn(__fadd_rn(-b, sdet), denom);
      f.add(k, !small_a && det >= 0.0f && tmax > 0.0f,
            tmin < 0.0f ? tmax : tmin);
    }
    if (f.got) {
      t = f.best;
      ptype = PRIM_SPHERE;
      pid = f.j;
      found = true;
    }
  }
  if (n_planes > 0) {
    // intersect.ray_plane, with vecmath.normalize(rd) once a ray
    const float len = __fsqrt_rn(clamp_min0(dot3(dx, dy, dz, dx, dy, dz)));
    const float nx = __fdiv_rn(dx, len), ny = __fdiv_rn(dy, len),
                nz = __fdiv_rn(dz, len);
    Fold f(t);
    for (int k = 0; k < n_planes; ++k) {
      const float px = __ldg(plane_normal + 3 * k);
      const float py = __ldg(plane_normal + 3 * k + 1);
      const float pz = __ldg(plane_normal + 3 * k + 2);
      const float q = dot3(nx, ny, nz, px, py, pz);
      const bool flat = fabsf(q) < PLANE_EPS;
      const float ts = __fdiv_rn(
          -__fadd_rn(dot3(ox, oy, oz, px, py, pz), __ldg(plane_d + k)),
          flat ? 1.0f : q);
      f.add(k, !flat && ts > 0.0f, ts);
    }
    if (f.got) {
      t = f.best;
      ptype = PRIM_PLANE;
      pid = f.j;
      found = true;
    }
  }
  const bool stop = stop_on_hit ? stop_on_hit[i] != 0 : any_hit != 0;
  t_out[i] = t;
  ptype_out[i] = ptype;
  pid_out[i] = pid;
  found_out[i] = found;
  live_out[i] = (active == nullptr || active[i]) && !(stop && found);
  stop_out[i] = stop;
}

__global__ void __launch_bounds__(BLOCK)
    traverse_kernel(const float* __restrict__ table,
                    const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ t0,
                    const uint8_t* __restrict__ live,
                    const uint8_t* __restrict__ stop, int n, int want_uv,
                    float* __restrict__ t_out, int* __restrict__ gid_out,
                    uint8_t* __restrict__ found_out, float* __restrict__ u_out,
                    float* __restrict__ v_out,
                    const int* __restrict__ ptype0,
                    const int* __restrict__ pid0,
                    const uint8_t* __restrict__ found0,
                    const uint8_t* __restrict__ active,
                    int* __restrict__ ptype_out) {
  const int i = group_ray();
  if (i >= n) return;  // whole groups: n is a count of rays
  const int k = group_lane();
  const unsigned mask = group_mask();
  const int* table_i = reinterpret_cast<const int*>(table);

  float t = t0[i];
  int gid = -1;
  bool found = false;
  float bu = 0.0f, bv = 0.0f;
  if (live[i]) {
    const bool stop_on_hit = stop[i] != 0;
    const Ray r = make_ray(ro, rd, i);

    // entries (hitmask, meta): this lane's copy of the group's stack, the
    // top entry (sp - 1) in registers
    uint2 stack[MAX_STACK];
    unsigned top_bits = 0, top_meta = 0;
    int sp = 0;
    int cur = 0;  // the root is inner row 0
    bool cur_leaf = false;
    while (true) {
      const float* row = table + (size_t)cur * ROW;
      const int* row_i = table_i + (size_t)cur * ROW;
      if (!cur_leaf) {
        const unsigned meta = (unsigned)__ldg(row_i + PMETA);
        float tmin;
        const unsigned hit = group_slab(mask, row, r, t, tmin);
        if (hit) {
          if (sp > 0) stack[sp - 1] = make_uint2(top_bits, top_meta);
          top_bits = hit;
          top_meta = meta;
          ++sp;
        }
      } else {
        const LeafHit h = group_moller<true>(mask, row, row_i, r, t);
        if (h.take) {
          t = h.t;
          gid = h.gid;
          bu = h.u;
          bv = h.v;
          found = true;
          if (stop_on_hit) break;
        }
      }
      // next child: lowest set bit of the top entry
      if (sp == 0) break;
      const unsigned meta = top_meta;
      const int j = __ffs(top_bits) - 1;
      top_bits &= top_bits - 1;
      if (!top_bits && --sp > 0) {
        const uint2 e = stack[sp - 1];
        top_bits = e.x;
        top_meta = e.y;
      }
      const int n_inner = (int)(meta >> META_BASE_BITS);
      cur = (int)(meta & ((1u << META_BASE_BITS) - 1)) + j;
      cur_leaf = j >= n_inner;
    }
  }
  if (k == 0) {
    t_out[i] = t;
    if (ptype_out) {
      // the merge epilogue: gid_out and found_out take prim_id and
      // intersected; u and v are 0 on a lane with no triangle already
      const bool act = active == nullptr || active[i];
      gid_out[i] = found ? gid : pid0[i];
      ptype_out[i] = found ? PRIM_TRIANGLE : ptype0[i];
      found_out[i] = act && (found || found0[i]);
    } else {
      gid_out[i] = gid;
      found_out[i] = found;
    }
    if (want_uv) {
      u_out[i] = bu;
      v_out[i] = bv;
    }
  }
}

}  // namespace

extern "C" int cpt_traverse_max_stack() { return MAX_STACK; }

extern "C" const char* cpt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ptype0, pid0, found0 and ptype_out null: the walk alone; given: the merge
// epilogue (active null means every lane)
extern "C" int cpt_traverse(const float* table, const float* ro,
                            const float* rd, const float* t0,
                            const uint8_t* live, const uint8_t* stop, int n,
                            int want_uv, float* t_out, int* gid_out,
                            uint8_t* found_out, float* u_out, float* v_out,
                            const int* ptype0, const int* pid0,
                            const uint8_t* found0, const uint8_t* active,
                            int* ptype_out, void* stream) {
  traverse_kernel<<<grid_for(n), BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      table, ro, rd, t0, live, stop, n, want_uv, t_out, gid_out, found_out,
      u_out, v_out, ptype0, pid0, found0, active, ptype_out);
  return static_cast<int>(cudaGetLastError());
}

// t_max, active and stop_on_hit may be null: T_MAX, every lane, any_hit
extern "C" int cpt_prepass(const float* ro, const float* rd,
                           const float* t_max, const uint8_t* active,
                           const uint8_t* stop_on_hit, int any_hit,
                           const float* sphere_pos, const float* sphere_radius,
                           int n_spheres, const float* plane_normal,
                           const float* plane_d, int n_planes, int n,
                           float* t_out, int* ptype_out, int* pid_out,
                           uint8_t* found_out, uint8_t* live_out,
                           uint8_t* stop_out, void* stream) {
  prepass_kernel<<<(unsigned)((n + PREPASS_BLOCK - 1) / PREPASS_BLOCK),
                   PREPASS_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ro, rd, t_max, active, stop_on_hit, any_hit, sphere_pos, sphere_radius,
      n_spheres, plane_normal, plane_d, n_planes, n, t_out, ptype_out,
      pid_out, found_out, live_out, stop_out);
  return static_cast<int>(cudaGetLastError());
}
