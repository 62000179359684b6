// Closest-hit / any-hit traversal of the split inner/leaf 16-ary tables (v1).
//
// Replaces the Pallas TPU kernel cuda_pathtracer_tpu/ops/traverse_packet.py:180
// `_kernel` (called from `_run_packets`, entry `traverse_packet`). The TPU
// walked 128-ray packets: a packet visited the union of the nodes its rays
// wanted, picked the next child by a cross-lane reduction, and kept one
// (node, visited-mask) stack per packet in SMEM. Here one thread walks one
// ray with its own (row, visited-mask) stack of depth + 8 entries in local
// memory, as `_run_packets` sizes it (_stack_cap(1, depth + 2)).
//
// Semantics are `_kernel`'s, per ray:
//  * an inner visit slab-tests the 16 child slots of the row, drops the slots
//    already in the visited mask, and descends into the hit child with the
//    smallest entry t (lowest slot on ties), or into the lowest hit slot when
//    `cheap` (any-hit calls). When more than one child was hit it first pushes
//    (row, mask | selected bit); a pop re-fetches that parent row and re-prunes
//    its children against the improved t;
//  * child refs are signed: >= 0 an inner row, < 0 the leaf row ~ref;
//  * a leaf visit runs Moller-Trumbore (determinant cutoff MT_DET_EPS) over
//    the 12 (v0, e1, e2) slots against the t the ray had on entering the
//    leaf; an exact-t tie inside a leaf goes to the lowest triangle id;
//  * a stop-on-hit ray ends at its first hit.
// The closest t equals the plain PyTorch version's bit for bit
// (ops/traverse_packet.py::traverse_packet_ref); against the packet kernel
// only the visit order differs, so prim_id can differ on exact-t ties between
// leaves, and for any-hit calls only `found` is contractual.
//
// Bound on the H100: the latency of dependent 512-byte row reads (the next
// row depends on this row's slab test), plus divergence between the 32 rays
// of a warp, which walk different paths. The tables stay resident in the
// 50 MB L2 for scenes of the sibenik class. No shared memory and no packets:
// making it fast is later work.
//
// The hazards of traverse.cu hold here too: empty slots are NaN boxes (NaN-
// propagating min/max in traverse_common.cuh); t is compared bit for bit
// (-fmad=false, no fast math); child refs (inner row [96:112]) and triangle
// ids (leaf row [108:120]) are int32 bits stored in f32 lanes, most of them
// denormal, and are read through an int pointer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

namespace {

using namespace cpt;

constexpr int PREFS = 96;
constexpr int PGIDS = 108;
// stack entries per thread; the wrapper checks depth + 8 <= MAX_STACK
constexpr int MAX_STACK = 64;

__global__ void traverse_packet_kernel(
    const float* __restrict__ inner, const float* __restrict__ leaf,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t0, const uint8_t* __restrict__ live,
    const uint8_t* __restrict__ stop, int n, int cheap, int stack_cap,
    float* __restrict__ t_out, int* __restrict__ gid_out,
    uint8_t* __restrict__ found_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* inner_i = reinterpret_cast<const int*>(inner);
  const int* leaf_i = reinterpret_cast<const int*>(leaf);
  float t = t0[i];
  int gid = -1;
  bool found = false;
  if (live[i]) {
    const bool stop_on_hit = stop[i] != 0;
    const Ray r = make_ray(ro, rd, i);

    int stack_row[MAX_STACK];
    unsigned stack_mask[MAX_STACK];
    int sp = 0;
    int cur = 0;  // the root is inner row 0
    unsigned mask = 0;
    while (true) {
      bool pop = true;
      if (cur < 0) {
        const size_t base = (size_t)(~cur) * ROW;
        const float* row = leaf + base;
        float leaf_t = BIG;
        int leaf_g = 1 << 30;
        bool take = false;
#pragma unroll 2
        for (int k = 0; k < LEAF_MAX; ++k) {
          float tt, u, v;
          if (moller(row, k, r, t, tt, u, v)) {
            const int g = __ldg(leaf_i + base + PGIDS + k);
            if (!take || tt < leaf_t || (tt == leaf_t && g < leaf_g)) {
              leaf_t = tt;
              leaf_g = g;
            }
            take = true;
          }
        }
        if (take) {
          t = leaf_t;
          gid = leaf_g;
          found = true;
          if (stop_on_hit) break;
        }
      } else {
        const size_t base = (size_t)cur * ROW;
        const float* row = inner + base;
        int n_hit = 0, sel = -1;
        float best = BIG;
#pragma unroll
        for (int k = 0; k < ARITY; ++k) {
          float tmin;
          if (slab(row, k, r, t, tmin) && !((mask >> k) & 1u)) {
            ++n_hit;
            if (cheap ? sel < 0 : tmin < best) {
              best = tmin;
              sel = k;
            }
          }
        }
        if (n_hit) {
          if (n_hit > 1 && sp < stack_cap) {
            stack_row[sp] = cur;
            stack_mask[sp] = mask | (1u << sel);
            ++sp;
          }
          cur = __ldg(inner_i + base + PREFS + sel);
          mask = 0;
          pop = false;
        }
      }
      if (pop) {
        if (sp == 0) break;
        --sp;
        cur = stack_row[sp];
        mask = stack_mask[sp];
      }
    }
  }
  t_out[i] = t;
  gid_out[i] = gid;
  found_out[i] = found;
}

}  // namespace

extern "C" int cpt_traverse_packet_max_stack() { return MAX_STACK; }

extern "C" int cpt_traverse_packet(const float* inner, const float* leaf,
                                   const float* ro, const float* rd,
                                   const float* t0, const uint8_t* live,
                                   const uint8_t* stop, int n, int cheap,
                                   int stack_cap, float* t_out, int* gid_out,
                                   uint8_t* found_out, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  traverse_packet_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      inner, leaf, ro, rd, t0, live, stop, n, cheap, stack_cap, t_out, gid_out,
      found_out);
  return static_cast<int>(cudaGetLastError());
}
