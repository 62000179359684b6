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
#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

namespace {

using namespace cpt;

constexpr int PMETA = 96;
constexpr int META_BASE_BITS = 20;
// stack entries per group; the wrapper checks depth + 2 <= MAX_STACK
constexpr int MAX_STACK = 48;

__global__ void __launch_bounds__(BLOCK)
    traverse_kernel(const float* __restrict__ table,
                    const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ t0,
                    const uint8_t* __restrict__ live,
                    const uint8_t* __restrict__ stop, int n, int want_uv,
                    float* __restrict__ t_out, int* __restrict__ gid_out,
                    uint8_t* __restrict__ found_out, float* __restrict__ u_out,
                    float* __restrict__ v_out) {
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
    gid_out[i] = gid;
    found_out[i] = found;
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

extern "C" int cpt_traverse(const float* table, const float* ro,
                            const float* rd, const float* t0,
                            const uint8_t* live, const uint8_t* stop, int n,
                            int want_uv, float* t_out, int* gid_out,
                            uint8_t* found_out, float* u_out, float* v_out,
                            void* stream) {
  traverse_kernel<<<grid_for(n), BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      table, ro, rd, t0, live, stop, n, want_uv, t_out, gid_out, found_out,
      u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
