// The v1 PACKET walk and its ablations: the Hopper counterpart of the Pallas
// lab tools/kernel_lab.py:256 (run_variant :247 -> variant_kernel :40, a copy
// of the v1 traversal kernel with hooks), run on the port's sibenik waves.
//
// The lab walks 2 packets of 128 rays per program; each packet descends as
// one: an inner visit slab-tests the 16 slots for every live ray and takes
// the nearest slot any ray hit (kmin over slots of the least t over rays),
// pushing (row, visited mask) when more than one slot was hit; a leaf visit
// tests 12 triangles per ray and keeps the least t (lowest gid on a tie).
// This is another function than csrc/traverse_packet.cu (one ray per 16-lane
// group, its own visit order), so it is ported as a walk of its own.
//
// One block of 128 threads per program, a thread per ray (probe_packet.cuh):
// a leaf visit is lane-local, with no barrier; an inner visit reduces the
// slots over the block (warp reductions, partials in shared memory, barrier
// A), thread 0 combines them into the decision words in shared memory and,
// when the walk pushes, writes the stack entry, and every thread reads the
// words after barrier B. The hooks:
//   v0      three decision words (selref, selbit, nhits), as the lab ships
//   script  the words written but not waited for: next row = cur + 1 up to
//           row 2000 (past the inner table's end a read takes its last row)
//   nodec   no reductions: inner rows only, cur + 1 up to 2000
//   packed  one word: (selref + 2^24) << 6 | sel << 2 | (nhits > 1) << 1 |
//           (nhits > 0)
//   phase   both packets' vector work, then one barrier pair for the two
// Outputs: the lab's (t, gid bits, found, 0) rows per packet, the stacks and
// words each program leaves, a per-packet digest (the words written and the
// next row of every live step) and a per-lane digest (each inner visit's
// hit mask), so script and nodec, whose t is t0, still show their work.
//
// Bound on the H100: a dependent chain per packet (row read, slab, block
// reduce, two barriers, the next row) over ~100-1,000 steps; 1,440 blocks
// of 4 warps keep every SM busy, so latency per step over the SMs' warps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_packet.cuh"

namespace {

using namespace pk;

constexpr int NPK = 2;
constexpr int RAY_ROWS = 16;
constexpr int DONE = 1 << 30;
constexpr int SCRIPT_END = 2000;
constexpr int MAX_STACK = 64;

enum Variant { V0, SCRIPT, NODEC, PACKED, PHASE };

struct Lane {
  float o[3], d[3], iv[3];
  bool live, soh;
  float t;
  int gid;
  bool fnd;
  unsigned dig;
};

template <int V>
struct Walk {
  SlotRed<NPK>* red;
  int (*stk_n)[MAX_STACK];
  int (*stk_m)[MAX_STACK];
  int (*dec_s)[4];
  const float* itab;
  const float* ltab;
  int ni, nl, dcap;

  // the leaf visit of packet p: lane-local
  __device__ void leaf(Lane& r, int cur) {
    const float* row = ltab + (long long)clamp_row(~cur, nl) * LANES;
    const float t_scan = (r.live && !(r.soh && r.fnd)) ? r.t : -BIG;
    float ttk[12], leaf_t = BIG;
    bool take = false;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      float tt;
      const bool ok = moller_row(row, 12, k, r.o, r.d, 1e-4f, tt) &&
                      tt > 0.0f && tt < t_scan;
      ttk[k] = ok ? tt : BIG;
      leaf_t = nan_min(leaf_t, ttk[k]);
      take |= ok;
    }
    int leaf_gid = 1 << 30;
#pragma unroll
    for (int k = 0; k < 12; ++k)
      if (ttk[k] == leaf_t) leaf_gid = min(leaf_gid, as_int(row + 108 + k));
    if (take) {
      if (leaf_t < r.t) r.gid = leaf_gid;
      r.t = nan_min(r.t, leaf_t);
      r.fnd = true;
    }
  }

  // the inner visit's lane part: the hit mask into the partials (or, nodec,
  // into the lane digest only)
  __device__ void inner(Lane& r, int p, int cur, int mask, int buf) {
    const float* box = itab + (long long)clamp_row(cur, ni) * LANES;
    const float t_scan = (r.live && !(r.soh && r.fnd)) ? r.t : -BIG;
    unsigned key[16], m = 0u;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float tmin, tmax;
      slab_sub(box, c, r.o, r.iv, tmin, tmax);
      const bool hit = slab_hit(tmin, tmax, t_scan) && ((mask >> c) & 1) == 0;
      key[c] = f2key(hit ? tmin : BIG);
      m |= (unsigned)hit << c;
    }
    r.dig += m;
    if (V != NODEC) red_put(*red, buf, p, key, m);
  }

  // thread 0, after barrier A: the words of packet p, and its push
  __device__ void decide(int p, int cur, int mask, int sp, int buf,
                         unsigned& dig) {
    float pc[16];
    const unsigned anyc = red_get(*red, buf, p, pc);
    const int sel = nearest_slot(pc, anyc);
    const int selref = anyc ? as_int(itab + (long long)clamp_row(cur, ni) *
                                     LANES + 96 + sel) : 0;
    const int selbit = anyc ? (1 << sel) : 0;
    const int nh = __popc(anyc);
    if (V == PACKED) {
      const int word = (int)((((unsigned)selref + (1u << 24)) << 6) |
                             ((unsigned)sel << 2) | (nh > 1 ? 2u : 0u) |
                             (nh > 0 ? 1u : 0u));
      dec_s[p][0] = word;
      dig += (unsigned)word;
    } else {
      dec_s[p][0] = selref;
      dec_s[p][1] = selbit;
      dec_s[p][2] = nh;
      dig += (unsigned)selref + (unsigned)selbit + (unsigned)nh;
    }
    if (V != SCRIPT && nh > 0 && nh > 1 && sp < dcap) {
      stk_n[p][sp] = cur;
      stk_m[p][sp] = mask | selbit;
    }
  }

  // every thread: the next (row, mask, sp) of packet p from the words
  __device__ void step(int p, int& cur, int& mask, int& sp) {
    const bool alive = cur != DONE;
    const bool is_leaf = cur < 0;
    if (V == SCRIPT || V == NODEC) {
      const bool go = alive && cur < SCRIPT_END && (V == SCRIPT || !is_leaf);
      cur = go ? cur + 1 : DONE;
      return;
    }
    // thread 0 pushed in decide(); here every thread moves sp and pops
    int selref;
    bool descend, push;
    if (V == PACKED) {
      const int word = dec_s[p][0];
      selref = (word >> 6) - (1 << 24);
      descend = alive && !is_leaf && (word & 1) > 0;
      push = descend && ((word >> 1) & 1) > 0 && sp < dcap;
    } else {
      selref = dec_s[p][0];
      const int nh = dec_s[p][2];
      descend = alive && !is_leaf && nh > 0;
      push = descend && nh > 1 && sp < dcap;
    }
    const int sp2 = sp + (push ? 1 : 0);
    const bool pop = alive && !descend && sp2 > 0;
    const int spr = pop ? sp2 - 1 : sp2;
    const int pn = stk_n[p][spr];
    const int pm = stk_m[p][spr];
    cur = descend ? selref : (pop ? pn : DONE);
    mask = descend ? 0 : (pop ? pm : 0);
    sp = pop ? spr : sp2;
  }
};

template <int V>
__global__ void __launch_bounds__(LANES)
walk_kernel(const float* __restrict__ itab, const float* __restrict__ ltab,
            const float* __restrict__ rays, float* __restrict__ out,
            int* __restrict__ stk_n_out, int* __restrict__ stk_m_out,
            int* __restrict__ dec_out, unsigned* __restrict__ digest,
            unsigned* __restrict__ lane_digest, int ni, int nl, int dcap) {
  __shared__ SlotRed<NPK> red;
  __shared__ int stk_n[NPK][MAX_STACK], stk_m[NPK][MAX_STACK], dec_s[NPK][4];
  const int l = threadIdx.x;
  const int g = blockIdx.x;
  for (int e = l; e < NPK * MAX_STACK; e += LANES) {
    (&stk_n[0][0])[e] = 0;
    (&stk_m[0][0])[e] = 0;
  }
  if (l < NPK * 4) (&dec_s[0][0])[l] = 0;
  Walk<V> w{&red, stk_n, stk_m, dec_s, itab, ltab, ni, nl, dcap};
  Lane r[NPK];
  int cur[NPK], mask[NPK], sp[NPK];
  unsigned dig[NPK];
#pragma unroll
  for (int p = 0; p < NPK; ++p) {
    const float* ry = rays + (long long)(g * NPK + p) * RAY_ROWS * LANES + l;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      r[p].o[a] = ry[a * LANES];
      r[p].d[a] = ry[(3 + a) * LANES];
      r[p].iv[a] = ry[(6 + a) * LANES];
    }
    r[p].t = ry[9 * LANES];
    r[p].live = ry[10 * LANES] != 0.0f;
    r[p].soh = ry[11 * LANES] != 0.0f;
    r[p].gid = -1;
    r[p].fnd = false;
    r[p].dig = 0u;
    cur[p] = __syncthreads_or(r[p].live) ? 0 : DONE;
    mask[p] = 0;
    sp[p] = 0;
    dig[p] = 0u;
  }
  int ph = 0;
  while (cur[0] != DONE || cur[1] != DONE) {
    if (V == PHASE) {
      bool any_inner = false;
#pragma unroll
      for (int p = 0; p < NPK; ++p) {
        if (cur[p] == DONE) continue;
        if (cur[p] < 0) {
          w.leaf(r[p], cur[p]);
        } else {
          w.inner(r[p], p, cur[p], mask[p], ph);
          any_inner = true;
        }
      }
      if (any_inner) {
        __syncthreads();
        if (l == 0) {
#pragma unroll
          for (int p = 0; p < NPK; ++p)
            if (cur[p] != DONE && cur[p] >= 0)
              w.decide(p, cur[p], mask[p], sp[p], ph, dig[p]);
        }
        __syncthreads();
        ph ^= 1;
      }
#pragma unroll
      for (int p = 0; p < NPK; ++p) {
        const bool alive = cur[p] != DONE;
        w.step(p, cur[p], mask[p], sp[p]);
        if (alive && l == 0) dig[p] += (unsigned)cur[p];
      }
      continue;
    }
#pragma unroll
    for (int p = 0; p < NPK; ++p) {
      const bool alive = cur[p] != DONE;
      if (alive) {
        if (cur[p] < 0) {
          w.leaf(r[p], cur[p]);
        } else {
          w.inner(r[p], p, cur[p], mask[p], ph);
          if (V != NODEC) {
            __syncthreads();
            if (l == 0) w.decide(p, cur[p], mask[p], sp[p], ph, dig[p]);
            if (V != SCRIPT) __syncthreads();
            ph ^= 1;
          }
        }
      }
      w.step(p, cur[p], mask[p], sp[p]);
      if (alive && l == 0) dig[p] += (unsigned)cur[p];
    }
  }
#pragma unroll
  for (int p = 0; p < NPK; ++p) {
    const long long q = (long long)g * NPK + p;
    float* o = out + q * 4 * LANES + l;
    o[0] = r[p].t;
    o[LANES] = __int_as_float(r[p].gid);
    o[2 * LANES] = r[p].fnd ? 1.0f : 0.0f;
    o[3 * LANES] = 0.0f;
    lane_digest[q * LANES + l] = r[p].dig;
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < NPK; ++p) {
    const long long q = (long long)g * NPK + p;
    for (int e = l; e <= dcap; e += LANES) {
      stk_n_out[q * (dcap + 1) + e] = stk_n[p][e];
      stk_m_out[q * (dcap + 1) + e] = stk_m[p][e];
    }
    if (l < 4) dec_out[q * 4 + l] = dec_s[p][l];
    if (l == 0) digest[q] = dig[p];
  }
}

}  // namespace

// variant 0-4 = v0 script nodec packed phase; ins itab [ni, 128], ltab [nl,
// 128], rays [programs * 2 * 16, 128]; outs out [programs * 8, 128] f32,
// stk_n and stk_m [programs * 2, dcap + 1], dec_s [programs * 2, 4],
// digest [programs * 2], lane_digest [programs * 2, 128]; dcap = depth + 2.
extern "C" int cpt_probe_packet_walk(int variant, const void* const* ins,
                                     void* const* outs, int ni, int nl,
                                     int programs, int dcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ni < 1 || nl < 1 || programs < 1 || dcap < 0 || dcap + 1 > MAX_STACK)
    return (int)cudaErrorInvalidValue;
  const float* const* in = reinterpret_cast<const float* const*>(ins);
  float* const* fo = reinterpret_cast<float* const*>(outs);
  int* const* io = reinterpret_cast<int* const*>(outs);
  unsigned* const* uo = reinterpret_cast<unsigned* const*>(outs);
#define WALK_CASE(V) \
  case V: return launch(walk_kernel<V>, programs, st, in[0], in[1], in[2], fo[0], io[1], io[2], io[3], uo[4], uo[5], ni, nl, dcap);
  switch (variant) {
    WALK_CASE(0) WALK_CASE(1) WALK_CASE(2) WALK_CASE(3) WALK_CASE(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WALK_CASE
}
