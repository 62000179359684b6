// Closest-hit / any-hit traversal of the merged 16-ary world BVH.
//
// Replaces the Pallas TPU kernel cuda_pathtracer_tpu/ops/traverse_packet2.py
// `_kernel` (called from `_run_packets2`, entry `traverse_packet2`). The TPU
// walked 128-ray packets over the union of their hitmasks because its vector
// unit runs lanes in lockstep; here one thread walks one ray, with its own
// stack, over the table in global memory. Same table, same arithmetic, same
// descent order (lowest slot first, leaves tested against the t the ray had
// on entering the leaf, exact-t ties inside a leaf to the lowest id), so the
// closest t equals the plain PyTorch version bit for bit
// (ops/traverse_packet2.py::traverse_merged_ref).
//
// Bound on the H100: latency of dependent 512-byte row reads (each visit's
// next row depends on the slab test of this one). The sibenik-class table
// (a few tens of MB) stays resident in the 50 MB L2; rows are read through
// the read-only path (__ldg). No shared memory, no packets: making it fast
// (ray sorting, wavefronts, TMA row prefetch) is later work.
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

namespace {

using namespace cpt;

constexpr int PMETA = 96;
constexpr int PGIDS = 108;
constexpr int META_BASE_BITS = 20;
// stack entries per thread; the wrapper checks depth + 2 <= MAX_STACK
constexpr int MAX_STACK = 48;

__global__ void traverse_kernel(const float* __restrict__ table,
                                const float* __restrict__ ro,
                                const float* __restrict__ rd,
                                const float* __restrict__ t0,
                                const uint8_t* __restrict__ live,
                                const uint8_t* __restrict__ stop, int n,
                                int want_uv, float* __restrict__ t_out,
                                int* __restrict__ gid_out,
                                uint8_t* __restrict__ found_out,
                                float* __restrict__ u_out,
                                float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* table_i = reinterpret_cast<const int*>(table);
  float t = t0[i];
  int gid = -1;
  bool found = false;
  float bu = 0.0f, bv = 0.0f;
  if (live[i]) {
    const bool stop_on_hit = stop[i] != 0;
    const Ray r = make_ray(ro, rd, i);

    // entry: hitmask (16 bits) | meta << 16
    unsigned long long stack[MAX_STACK];
    int sp = 0;
    int cur = 0;  // the root is inner row 0
    bool cur_leaf = false;
    while (true) {
      const float* row = table + (size_t)cur * ROW;
      const int* row_i = table_i + (size_t)cur * ROW;
      if (!cur_leaf) {
        unsigned hit = 0;
#pragma unroll
        for (int k = 0; k < ARITY; ++k) {
          float tmin;
          if (slab(row, k, r, t, tmin)) hit |= 1u << k;
        }
        if (hit) {
          const unsigned long long meta = (unsigned)__ldg(row_i + PMETA);
          stack[sp++] = hit | (meta << 16);
        }
      } else {
        // Moller-Trumbore on the leaf's triangles against the entry t
        float leaf_t = BIG, lu = 0.0f, lv = 0.0f;
        int leaf_g = 1 << 30;
        bool take = false;
#pragma unroll 2
        for (int k = 0; k < LEAF_MAX; ++k) {
          float tt, u, v;
          if (moller(row, k, r, t, tt, u, v)) {
            const int g = __ldg(row_i + PGIDS + k);
            if (!take || tt < leaf_t || (tt == leaf_t && g < leaf_g)) {
              leaf_t = tt;
              leaf_g = g;
              lu = u;
              lv = v;
            }
            take = true;
          }
        }
        if (take) {
          t = leaf_t;
          gid = leaf_g;
          bu = lu;
          bv = lv;
          found = true;
          if (stop_on_hit) break;
        }
      }
      // next child: lowest set bit of the top entry
      if (sp == 0) break;
      const unsigned long long e = stack[sp - 1];
      const unsigned bits = (unsigned)(e & 0xFFFFu);
      const unsigned meta = (unsigned)(e >> 16);
      const int j = __ffs(bits) - 1;
      const unsigned rest = bits & (bits - 1);
      if (rest)
        stack[sp - 1] = rest | ((unsigned long long)meta << 16);
      else
        --sp;
      const int n_inner = (int)(meta >> META_BASE_BITS);
      cur = (int)(meta & ((1u << META_BASE_BITS) - 1)) + j;
      cur_leaf = j >= n_inner;
    }
  }
  t_out[i] = t;
  gid_out[i] = gid;
  found_out[i] = found;
  if (want_uv) {
    u_out[i] = bu;
    v_out[i] = bv;
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
  const int block = 128;
  const int grid = (n + block - 1) / block;
  traverse_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ro, rd, t0, live, stop, n, want_uv, t_out, gid_out, found_out,
      u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
