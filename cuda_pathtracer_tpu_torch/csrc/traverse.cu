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
// Hazards, each handled below:
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

namespace {

constexpr int ROW = 128;
constexpr int ARITY = 16;
constexpr int LEAF_MAX = 12;
constexpr int PBOX0 = 0;
constexpr int PMETA = 96;
constexpr int PTRIS = 0;
constexpr int PGIDS = 108;
constexpr int META_BASE_BITS = 20;
// stack entries per thread; the wrapper checks depth + 2 <= MAX_STACK
constexpr int MAX_STACK = 48;
constexpr float BIG = 3.0e38f;
constexpr float MT_DET_EPS = 1e-4f;
constexpr float TINY = 1e-20f;

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
    const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
    const float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
    const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
    const float oivx = ox * ivx, oivy = oy * ivy, oivz = oz * ivz;

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
          const float lox = __ldg(row + PBOX0 + 0 * ARITY + k);
          const float loy = __ldg(row + PBOX0 + 1 * ARITY + k);
          const float loz = __ldg(row + PBOX0 + 2 * ARITY + k);
          const float hix = __ldg(row + PBOX0 + 3 * ARITY + k);
          const float hiy = __ldg(row + PBOX0 + 4 * ARITY + k);
          const float hiz = __ldg(row + PBOX0 + 5 * ARITY + k);
          const float t0x = lox * ivx - oivx, t1x = hix * ivx - oivx;
          const float t0y = loy * ivy - oivy, t1y = hiy * ivy - oivy;
          const float t0z = loz * ivz - oivz, t1z = hiz * ivz - oivz;
          const float tmin = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                                     nan_min(t0z, t1z));
          const float tmax = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                                     nan_max(t0z, t1z));
          if (tmax >= nan_max(tmin, 0.0f) && tmin < t) hit |= 1u << k;
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
          const float v0x = __ldg(row + PTRIS + 0 * LEAF_MAX + k);
          const float v0y = __ldg(row + PTRIS + 1 * LEAF_MAX + k);
          const float v0z = __ldg(row + PTRIS + 2 * LEAF_MAX + k);
          const float e1x = __ldg(row + PTRIS + 3 * LEAF_MAX + k);
          const float e1y = __ldg(row + PTRIS + 4 * LEAF_MAX + k);
          const float e1z = __ldg(row + PTRIS + 5 * LEAF_MAX + k);
          const float e2x = __ldg(row + PTRIS + 6 * LEAF_MAX + k);
          const float e2y = __ldg(row + PTRIS + 7 * LEAF_MAX + k);
          const float e2z = __ldg(row + PTRIS + 8 * LEAF_MAX + k);
          const float hx = dy * e2z - dz * e2y;
          const float hy = dz * e2x - dx * e2z;
          const float hz = dx * e2y - dy * e2x;
          const float a = (e1x * hx + e1y * hy) + e1z * hz;
          const float f = 1.0f / (fabsf(a) < MT_DET_EPS ? 1.0f : a);
          const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
          const float u = f * ((sx * hx + sy * hy) + sz * hz);
          const float qx = sy * e1z - sz * e1y;
          const float qy = sz * e1x - sx * e1z;
          const float qz = sx * e1y - sy * e1x;
          const float v = f * ((dx * qx + dy * qy) + dz * qz);
          const float tt = f * ((e2x * qx + e2y * qy) + e2z * qz);
          const bool ok = fabsf(a) >= MT_DET_EPS && u >= 0.0f && u <= 1.0f &&
                          v >= 0.0f && u + v <= 1.0f && tt > 0.0f && tt < t;
          if (ok) {
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
