// Closest-hit / any-hit traversal of the split inner/leaf 16-ary tables (v1).
//
// Replaces the Pallas TPU kernel cuda_pathtracer_tpu/ops/traverse_packet.py:180
// `_kernel` (called from `_run_packets`, entry `traverse_packet`). The TPU
// walked 128-ray packets: a packet visited the union of the nodes its rays
// wanted, picked the next child by a cross-lane reduction, and kept one
// (node, visited-mask) stack per packet in SMEM. Here one group of 16 lanes
// (half a warp) walks one ray: at an inner visit lane k slab-tests child
// slot k, at a leaf lanes 0-11 test one triangle each (traverse_common.cuh).
//
// The walk is the plain PyTorch version's (ops/traverse_packet.py::
// traverse_packet_ref), visit for visit:
//  * an inner visit slab-tests the 16 child slots of the row and drops the
//    slots already in the visited mask (a ballot gives the hit bits,
//    n_hit = popc); it descends into the hit child with the smallest entry t,
//    lowest slot on ties (group_argmin), or into the lowest hit slot when
//    `cheap` (any-hit calls). When more than one child was hit it first
//    pushes (row, mask | selected bit), unless the stack holds `stack_cap`
//    entries already (the push is then dropped, as the TPU kernel's
//    `_stack_cap` bound does); a pop re-fetches that parent row and re-prunes
//    its children against the improved t;
//  * child refs are signed: >= 0 an inner row, < 0 the leaf row ~ref. Lane k
//    loads slot k's ref with the boxes; the selected one comes by shuffle;
//  * a leaf visit runs Moller-Trumbore (determinant cutoff MT_DET_EPS) over
//    the 12 (v0, e1, e2) slots against the t the ray had on entering the
//    leaf; an exact-t tie inside a leaf goes to the lowest triangle id;
//  * a stop-on-hit ray ends at its first hit.
// So t, gid and found equal the plain version's bit for bit. Against the
// packet kernel only the visit order differs: prim_id can differ on exact-t
// ties between leaves, and for any-hit calls only `found` is contractual.
//
// What bounds it on the H100: the latency of dependent 512-byte row reads
// (the next row depends on this row's slab test), the parent row read again
// on every pop, and the divergence between the two groups of a warp, which
// walk different rays. One thread per ray paid each visit as 96 scalar
// loads and 16 slab tests in sequence; a group reads the row field by field
// (one load instruction moves 64 contiguous bytes) and tests the 16 slots at
// once, so a visit is 7 independent loads, one test per lane, a ballot and a
// 4-step min reduction for the nearest child.
//
// The stack belongs to the group, but every lane keeps its own copy of the
// (row, visited-mask) pairs in its local stack frame (64 x 8 bytes, cached
// in L1): all 16 lanes push and pop the same entries, so no lane waits on
// another (one shared copy written by lane 0 between two __syncwarp measured
// slower on an H100, utils/kernel_ab.py). ptxas: 43 registers, a 512-byte
// stack frame, no spills.
//
// The hazards of traverse.cu hold here too: empty slots are NaN boxes (NaN-
// propagating min/max in traverse_common.cuh); t is compared bit for bit
// (-fmad=false, no fast math); child refs (inner row [96:112]) and triangle
// ids (leaf row [108:120]) are int32 bits stored in f32 lanes, most of them
// denormal, and are read through an int pointer; ballots and shuffles name
// the group's 16 lanes, never the whole warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

namespace {

using namespace cpt;

constexpr int PREFS = 96;
// stack entries per group; the wrapper checks depth + 8 <= MAX_STACK
constexpr int MAX_STACK = 64;

__global__ void __launch_bounds__(BLOCK) traverse_packet_kernel(
    const float* __restrict__ inner, const float* __restrict__ leaf,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t0, const uint8_t* __restrict__ live,
    const uint8_t* __restrict__ stop, int n, int cheap, int stack_cap,
    float* __restrict__ t_out, int* __restrict__ gid_out,
    uint8_t* __restrict__ found_out) {
  const int i = group_ray();
  if (i >= n) return;  // whole groups: n is a count of rays
  const int k = group_lane();
  const unsigned mask = group_mask();
  const int* inner_i = reinterpret_cast<const int*>(inner);
  const int* leaf_i = reinterpret_cast<const int*>(leaf);

  float t = t0[i];
  int gid = -1;
  bool found = false;
  if (live[i]) {
    const bool stop_on_hit = stop[i] != 0;
    const Ray r = make_ray(ro, rd, i);

    int2 stack[MAX_STACK];  // this lane's copy: (row, visited mask)
    int sp = 0;
    int cur = 0;  // the root is inner row 0
    unsigned visited = 0;
    while (true) {
      bool pop = true;
      if (cur < 0) {
        const size_t base = (size_t)(~cur) * ROW;
        const LeafHit h = group_moller<false>(mask, leaf + base,
                                              leaf_i + base, r, t);
        if (h.take) {
          t = h.t;
          gid = h.gid;
          found = true;
          if (stop_on_hit) break;
        }
      } else {
        const size_t base = (size_t)cur * ROW;
        const int ref = __ldg(inner_i + base + PREFS + k);
        float tmin;
        const unsigned hit =
            group_slab(mask, inner + base, r, t, tmin) & ~visited;
        if (hit) {
          const int sel =
              cheap ? __ffs(hit) - 1
                    : group_argmin(mask, (hit >> k) & 1u ? tmin : BIG);
          if (__popc(hit) > 1 && sp < stack_cap) {
            stack[sp] = make_int2(cur, (int)(visited | (1u << sel)));
            ++sp;
          }
          cur = __shfl_sync(mask, ref, sel, GROUP);
          visited = 0;
          pop = false;
        }
      }
      if (pop) {
        if (sp == 0) break;
        --sp;
        const int2 e = stack[sp];
        cur = e.x;
        visited = (unsigned)e.y;
      }
    }
  }
  if (k == 0) {
    t_out[i] = t;
    gid_out[i] = gid;
    found_out[i] = found;
  }
}

}  // namespace

extern "C" int cpt_traverse_packet_max_stack() { return MAX_STACK; }

extern "C" int cpt_traverse_packet(const float* inner, const float* leaf,
                                   const float* ro, const float* rd,
                                   const float* t0, const uint8_t* live,
                                   const uint8_t* stop, int n, int cheap,
                                   int stack_cap, float* t_out, int* gid_out,
                                   uint8_t* found_out, void* stream) {
  traverse_packet_kernel<<<grid_for(n), BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      inner, leaf, ro, rd, t0, live, stop, n, cheap, stack_cap, t_out, gid_out,
      found_out);
  return static_cast<int>(cudaGetLastError());
}
