// The TPU packet-traversal step on one block: the Hopper counterpart of four
// module-level Pallas probes of tools/ that priced a realistic packet step
// on the TPU (the next row is scripted in all four):
//   tools/pallas_probe_r2f.py:96  make(T, NI) :35: a [1, 128] row, boxes by
//                                 reshape, a [16, 128] slab, the argmin
//                                 child and hit mask, a 64-entry SMEM stack;
//                                 NI interleaved packets
//   tools/pallas_probe_r2g.py:158 make(T, NPK) :16: the real step body, both
//                                 paths every step (12 Moller-Trumbore tests
//                                 with the lowest gid; 16 slabs with the
//                                 visited mask and the nearest child; a
//                                 32-entry (row, mask) stack)
//   tools/pallas_probe_r2h.py:172 make(T, variant) :75: split tables, 8
//                                 packets; A state in registers, B the t in
//                                 shared memory, C a branch per path and the
//                                 decision words handed over in shared memory
//   tools/pallas_probe_r2i.py:68  make(T, variant) :14: V1 every field read
//                                 by each thread from the row, V2 the row
//                                 staged once in shared memory
// One block of 128 threads, a thread per ray (probe_packet.cuh). All the
// packets' vector work of a step goes before one barrier (the TPU's "one
// drain"), then every thread takes the same decisions; r2h C adds a second
// barrier for its decision words. The TPU kernel is one program, so this is
// one block and the rest of the card idles: a latency probe.
//
// Bound on the H100: the chain's latency (a dependent row read, ~30 FP32
// operations per slot and lane, a block barrier per step), not bytes or the
// FP32 rate (a step is ~100 K operations, ~1.5 ns at 67 TFLOP/s).
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_packet.cuh"

namespace {

using namespace pk;

// ---- r2f ----
template <int NI>
__global__ void __launch_bounds__(LANES)
r2f_kernel(const float* __restrict__ tab, const float* __restrict__ ro,
           const float* __restrict__ ird, float* __restrict__ out,
           int* __restrict__ stack_out, unsigned* __restrict__ digest, int n,
           int steps) {
  __shared__ SlotRed<NI> red;
  __shared__ int stack[NI][64];
  const int l = threadIdx.x;
  for (int e = l; e < NI * 64; e += LANES) (&stack[0][0])[e] = 0;
  __syncthreads();
  float o[NI][3], ip[NI][3], ts[NI];
  int idx[NI], sp[NI];
  unsigned dig[NI];
#pragma unroll
  for (int p = 0; p < NI; ++p) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[p][a] = ro[(3 * p + a) * LANES + l];
      ip[p][a] = ird[(3 * p + a) * LANES + l];
    }
    ts[p] = 3e38f;
    idx[p] = p;
    sp[p] = 0;
    dig[p] = 0u;
  }
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
#pragma unroll
    for (int p = 0; p < NI; ++p) {
      const float* box = tab + (long long)idx[p] * LANES + 1;
      unsigned key[16], m = 0u;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float tmin, tmax;
        slab_sub(box, c, o[p], ip[p], tmin, tmax);
        const bool hit = slab_hit(tmin, tmax, ts[p]);
        key[c] = f2key(hit ? tmin : 3e38f);
        m |= (unsigned)hit << c;
      }
      red_put(red, buf, p, key, m);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NI; ++p) {
      float pc[16];
      const unsigned anyc = red_get(red, buf, p, pc);
      int sel = 0;
      float best = (anyc & 1u) ? pc[0] : 3e38f;
#pragma unroll
      for (int c = 1; c < 16; ++c) {
        const float e = ((anyc >> c) & 1u) ? pc[c] : 3e38f;
        if (e < best) {
          best = e;
          sel = c;
        }
      }
      ts[p] = ts[p] * 0.9999f;
      const int nxt = (idx[p] * 7 + sel + 1) % n;
      const bool push = anyc != 0u && sp[p] < 62;
      if (push && l == 0) stack[p][sp[p]] = nxt;
      const int sp2 = sp[p] + (push ? 1 : 0);
      const int sp3 = max(sp2 - 1, 0);
      // a push is popped at once: the popped entry is the one just pushed
      const int popped = push ? nxt : stack[p][sp3];
      idx[p] = sp2 > 0 ? popped : nxt;
      sp[p] = sp3;
      dig[p] += (unsigned)sel + anyc + (unsigned)idx[p];
    }
  }
#pragma unroll
  for (int p = 0; p < NI; ++p)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      out[(3 * p + a) * LANES + l] = o[p][a] + ts[0];
  __syncthreads();
  for (int e = l; e < NI * 64; e += LANES) stack_out[e] = (&stack[0][0])[e];
  if (l < NI) {
#pragma unroll
    for (int p = 0; p < NI; ++p)
      if (p == l) digest[p] = dig[p];
  }
}

// ---- r2g ----
template <int NP>
__global__ void __launch_bounds__(LANES)
r2g_kernel(const float* __restrict__ tab, const float* __restrict__ ov,
           const float* __restrict__ invv, const float* __restrict__ dv,
           float* __restrict__ t_out, int* __restrict__ gid_out,
           int* __restrict__ stk_n_out, int* __restrict__ stk_m_out,
           unsigned* __restrict__ digest, int n, int steps) {
  __shared__ SlotRed<NP> red;
  __shared__ int stk_n[NP][32], stk_m[NP][32];
  const int l = threadIdx.x;
  for (int e = l; e < NP * 32; e += LANES) {
    (&stk_n[0][0])[e] = 0;
    (&stk_m[0][0])[e] = 0;
  }
  __syncthreads();
  float o[NP][3], iv[NP][3], d[NP][3], t[NP];
  int best[NP], cur[NP], mask[NP], sp[NP];
  unsigned dig[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[p][a] = ov[(3 * p + a) * LANES + l];
      iv[p][a] = invv[(3 * p + a) * LANES + l];
      d[p][a] = dv[(3 * p + a) * LANES + l];
    }
    t[p] = BIG;
    best[p] = -1;
    cur[p] = p;
    mask[p] = 0;
    sp[p] = 0;
    dig[p] = 0u;
  }
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float* row = tab + (long long)cur[p] * LANES;
      const float tag = row[0];
      // leaf path: fields v0, v1, v2 (x y z each) at 1 + j * 12
      const float* f = row + 1;
      float leaf_t = BIG;
      bool found = false;
      float ttk[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) {
        const float v0x = f[k], v0y = f[12 + k], v0z = f[24 + k];
        float tt;
        const bool ok = moller(v0x, v0y, v0z, f[36 + k] - v0x, f[48 + k] - v0y,
                               f[60 + k] - v0z, f[72 + k] - v0x,
                               f[84 + k] - v0y, f[96 + k] - v0z, o[p], d[p],
                               1e-9f, tt) &&
                        tt > 1e-4f && tt < t[p] && tag < 0.0f;
        ttk[k] = ok ? tt : BIG;
        leaf_t = nan_min(leaf_t, ttk[k]);
        found |= ok;
      }
      int leaf_gid = 1 << 30;
#pragma unroll
      for (int k = 0; k < 12; ++k)
        if (ttk[k] == leaf_t) leaf_gid = min(leaf_gid, as_int(row + 109 + k));
      const float t2 = found ? nan_min(t[p], leaf_t) : t[p];
      if (found && leaf_t < t[p]) best[p] = leaf_gid;
      t[p] = t2;
      // inner path: boxes at 1 + f * 16
      unsigned key[16], m = 0u;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float tmin, tmax;
        slab_sub(f, c, o[p], iv[p], tmin, tmax);
        const bool hit = slab_hit(tmin, tmax, t2) && tag > 0.0f &&
                         (float)c < tag && ((mask[p] >> c) & 1) == 0;
        key[c] = f2key(hit ? tmin : BIG);
        m |= (unsigned)hit << c;
      }
      red_put(red, buf, p, key, m);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float* row = tab + (long long)cur[p] * LANES;
      float pc[16];
      const unsigned anyc = red_get(red, buf, p, pc);
      const unsigned hot = nearest_slots(pc, anyc);
      int selref = 0, selbit = 0;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        selref = max(selref, ((hot >> c) & 1u) ? as_int(row + 97 + c) : 0);
        selbit = max(selbit, ((hot >> c) & 1u) ? (1 << c) : 0);
      }
      const int nhits = __popc(anyc);
      const bool descend = !((int)row[0] < 0) && nhits > 0;
      const bool push = descend && nhits > 1 && sp[p] < 30;
      if (push && l == 0) {
        stk_n[p][sp[p]] = cur[p];
        stk_m[p][sp[p]] = mask[p] | selbit;
      }
      const int sp2 = sp[p] + (push ? 1 : 0);
      const int sp3 = (!descend && sp2 > 0) ? sp2 - 1 : sp2;
      // not descending, no push happened this step: the entry is an older one
      const int pn = stk_n[p][sp3];
      const int pm = stk_m[p][sp3];
      const int nxt = floor_mod(wadd(abs32(descend ? selref : pn), i), n);
      mask[p] = descend ? 0 : pm;
      cur[p] = nxt;
      sp[p] = sp3;
      dig[p] += (unsigned)selref + (unsigned)selbit + (unsigned)nhits +
                (unsigned)nxt;
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    t_out[p * LANES + l] = t[p];
    gid_out[p * LANES + l] = best[p];
  }
  __syncthreads();
  for (int e = l; e < NP * 32; e += LANES) {
    stk_n_out[e] = (&stk_n[0][0])[e];
    stk_m_out[e] = (&stk_m[0][0])[e];
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
    if (l == p) digest[p] = dig[p];
}

// ---- r2h ----
constexpr int R2H_NPK = 8;

template <int V>   // 0 A, 1 B, 2 C
__global__ void __launch_bounds__(LANES)
r2h_kernel(const float* __restrict__ itab, const float* __restrict__ ltab,
           const float* __restrict__ ov, const float* __restrict__ dvv,
           const float* __restrict__ ivv, const float* __restrict__ t0v,
           float* __restrict__ out, int* __restrict__ stk_n_out,
           int* __restrict__ stk_m_out, float* __restrict__ t_s_out,
           int* __restrict__ dec_out, unsigned* __restrict__ digest, int ni,
           int nl, int steps) {
  constexpr int NP = R2H_NPK;
  __shared__ SlotRed<NP> red;
  __shared__ int stk_n[NP][32], stk_m[NP][32], dec_s[NP][4];
  __shared__ float t_s[NP][LANES];
  const int l = threadIdx.x;
  for (int e = l; e < NP * 32; e += LANES) {
    (&stk_n[0][0])[e] = 0;
    (&stk_m[0][0])[e] = 0;
  }
  if (l < NP * 4) (&dec_s[0][0])[l] = 0;
  float o[NP][3], d[NP][3], iv[NP][3], t0[NP], ta[NP];
  int cur[NP], mask[NP], sp[NP];
  unsigned dig[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[p][a] = ov[(3 * p + a) * LANES + l];
      d[p][a] = dvv[(3 * p + a) * LANES + l];
      iv[p][a] = ivv[(3 * p + a) * LANES + l];
    }
    t0[p] = t0v[p * LANES + l];
    ta[p] = t0[p];
    t_s[p][l] = t0[p];
    cur[p] = p % 5;
    mask[p] = 0;
    sp[p] = 0;
    dig[p] = 0u;
  }
  __syncthreads();
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const bool leaf = cur[p] < 0;
      if (V == 2 && leaf) {
        // C: the leaf branch only
        const float* rowL = ltab + (long long)(~cur[p]) * LANES;
        const float t = t_s[p][l];
        float leaf_t = BIG;
        bool take = false;
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          float tt;
          const bool ok = moller_row(rowL, 12, k, o[p], d[p], 1e-4f, tt) &&
                          tt > 0.0f && tt < t;
          leaf_t = nan_min(leaf_t, ok ? tt : BIG);
          take |= ok;
        }
        t_s[p][l] = take ? nan_min(t, leaf_t) : t;
        continue;
      }
      float t;
      if (V != 2) {
        // A / B: both paths every step
        const float* rowL = ltab + (long long)(leaf ? ~cur[p] : 0) * LANES;
        t = V == 0 ? ta[p] : t_s[p][l];
        float leaf_t = BIG;
        bool take = false;
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          float tt;
          const bool ok = moller_row(rowL, 12, k, o[p], d[p], 1e-4f, tt) &&
                          tt > 0.0f && tt < t;
          leaf_t = nan_min(leaf_t, ok ? tt : BIG);
          take |= ok;
        }
        if (take && leaf) t = nan_min(t, leaf_t);
        if (V == 0) ta[p] = t;
        else t_s[p][l] = t;
      } else {
        t = t_s[p][l];
      }
      const float* box = itab + (long long)max(cur[p], 0) * LANES;
      unsigned key[16], m = 0u;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float tmin, tmax;
        slab_sub(box, c, o[p], iv[p], tmin, tmax);
        const bool hit = slab_hit(tmin, tmax, t) && ((mask[p] >> c) & 1) == 0;
        key[c] = f2key(hit ? tmin : BIG);
        m |= (unsigned)hit << c;
      }
      red_put(red, buf, p, key, m);
    }
    __syncthreads();
    if (V == 2) {
      // C: thread 0 combines the inner packets' partials into the words
      if (l == 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (cur[p] < 0) continue;
          float pc[16];
          const unsigned anyc = red_get(red, buf, p, pc);
          const int sel = nearest_slot(pc, anyc);
          const float* box = itab + (long long)cur[p] * LANES;
          dec_s[p][0] = anyc ? as_int(box + 96 + sel) : 0;
          dec_s[p][1] = anyc ? (1 << sel) : 0;
          dec_s[p][2] = __popc(anyc);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      int selref, selbit, nhits;
      if (V == 2) {
        selref = dec_s[p][0];
        selbit = dec_s[p][1];
        nhits = dec_s[p][2];
      } else {
        float pc[16];
        const unsigned anyc = red_get(red, buf, p, pc);
        const int sel = nearest_slot(pc, anyc);
        const float* box = itab + (long long)max(cur[p], 0) * LANES;
        selref = anyc ? as_int(box + 96 + sel) : 0;
        selbit = anyc ? (1 << sel) : 0;
        nhits = __popc(anyc);
      }
      const bool descend = cur[p] >= 0 && nhits > 0;
      const bool push = descend && nhits > 1 && sp[p] < 30;
      if (push && l == 0) {
        stk_n[p][sp[p]] = cur[p];
        stk_m[p][sp[p]] = mask[p] | selbit;
      }
      const int sp2 = sp[p] + (push ? 1 : 0);
      const int spr = (!descend && sp2 > 0) ? sp2 - 1 : sp2;
      const int pn = stk_n[p][spr];
      const int pm = stk_m[p][spr];
      const int a = abs32(descend ? selref : pn);
      const int nxt = (i + p) % 3 == 0 ? ~floor_mod(a, nl) : floor_mod(a, ni);
      mask[p] = descend ? 0 : pm;
      cur[p] = nxt;
      sp[p] = spr;
      dig[p] += (unsigned)selref + (unsigned)selbit + (unsigned)nhits +
                (unsigned)nxt;
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (V == 0) {
      out[p * LANES + l] = ta[p] + t0[p];
      t_s_out[p * LANES + l] = t0[p];
    } else {
      out[p * LANES + l] = t0[p] + t_s[p][l];
      t_s_out[p * LANES + l] = t_s[p][l];
    }
  }
  for (int e = l; e < NP * 32; e += LANES) {
    stk_n_out[e] = (&stk_n[0][0])[e];
    stk_m_out[e] = (&stk_m[0][0])[e];
  }
  if (l < NP * 4) dec_out[l] = (&dec_s[0][0])[l];
#pragma unroll
  for (int p = 0; p < NP; ++p)
    if (l == p) digest[p] = dig[p];
}

// ---- r2i ----
template <int V>   // 1: fields from the row in memory; 2: the row staged
__global__ void __launch_bounds__(LANES)
r2i_kernel(const float* __restrict__ tab, const float* __restrict__ ov,
           float* __restrict__ out, unsigned* __restrict__ digest, int n,
           int steps) {
  __shared__ SlotRed<1> red;
  __shared__ float row_s[LANES];
  const int l = threadIdx.x;
  // the origin is also the direction, and (y, z, x) the slab's inverse
  const float o[3] = {ov[l], ov[LANES + l], ov[2 * LANES + l]};
  const float ivs[3] = {o[1], o[2], o[0]};
  float t = BIG;
  int idx = 0;
  unsigned dig = 0u;
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    const float* row = tab + (long long)idx * LANES;
    if (V == 2) {
      row_s[l] = row[l];
      __syncthreads();
      row = row_s;
    }
    float leaf_t = BIG;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      float tt;
      bool ok;
      if (V == 1) {
        ok = moller_row(row, 12, k, o, o, 1e-4f, tt);
      } else {
        // fields j at 16 j (j < 8) and the ninth at 112
        ok = moller(row[k], row[16 + k], row[32 + k], row[48 + k],
                    row[64 + k], row[80 + k], row[96 + k], row[112 + k],
                    row[112 + k], o, o, 1e-4f, tt);
      }
      ok = ok && tt > 0.0f && tt < t;
      leaf_t = nan_min(leaf_t, ok ? tt : BIG);
    }
    unsigned key[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float tmin, tmax;
      slab_sub(row, c, o, ivs, tmin, tmax);
      key[c] = f2key(slab_hit(tmin, tmax, t) ? tmin : BIG);
    }
    red_put(red, buf, 0, key, 0u);
    __syncthreads();
    float pc[16];
    red_get(red, buf, 0, pc);
    float kmin = pc[0];
#pragma unroll
    for (int c = 1; c < 16; ++c) kmin = nan_min(kmin, pc[c]);
    int sel = 16;
#pragma unroll
    for (int c = 15; c >= 0; --c)
      if (pc[c] == kmin) sel = c;
    t = nan_min(t, leaf_t);
    idx = (idx * 5 + sel + 1) % n;
    dig += (unsigned)sel + (unsigned)idx;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) out[r * LANES + l] = t;
  if (l == 0) digest[0] = dig;
}

}  // namespace

// site 0 r2f (variant = NI 1/2/4; ins tab, ro, ird; outs out, stack,
// digest), 1 r2g (variant = NPK 1/2/4; ins tab, o, inv, d; outs t, gid,
// stk_n, stk_m, digest), 2 r2h (variant 0/1/2 = A/B/C; ins itab, ltab, o,
// dv, iv, t0; outs out, stk_n, stk_m, t_s, dec_s, digest), 3 r2i (variant
// 1/2; ins tab, o; outs out, digest). n0, n1: the tables' rows.
extern "C" int cpt_probe_packet_step(int site, int variant, int steps,
                                     const void* const* ins, void* const* outs,
                                     int n0, int n1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps < 0 || n0 < 1) return (int)cudaErrorInvalidValue;
  const float* const* in = reinterpret_cast<const float* const*>(ins);
  float* const* fo = reinterpret_cast<float* const*>(outs);
  int* const* io = reinterpret_cast<int* const*>(outs);
  unsigned* const* uo = reinterpret_cast<unsigned* const*>(outs);
  if (site == 0) {
    switch (variant) {
      case 1: return launch(r2f_kernel<1>, 1, st, in[0], in[1], in[2], fo[0], io[1], uo[2], n0, steps);
      case 2: return launch(r2f_kernel<2>, 1, st, in[0], in[1], in[2], fo[0], io[1], uo[2], n0, steps);
      case 4: return launch(r2f_kernel<4>, 1, st, in[0], in[1], in[2], fo[0], io[1], uo[2], n0, steps);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (site == 1) {
    switch (variant) {
      case 1: return launch(r2g_kernel<1>, 1, st, in[0], in[1], in[2], in[3], fo[0], io[1], io[2], io[3], uo[4], n0, steps);
      case 2: return launch(r2g_kernel<2>, 1, st, in[0], in[1], in[2], in[3], fo[0], io[1], io[2], io[3], uo[4], n0, steps);
      case 4: return launch(r2g_kernel<4>, 1, st, in[0], in[1], in[2], in[3], fo[0], io[1], io[2], io[3], uo[4], n0, steps);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (site == 2) {
    if (n1 < 1) return (int)cudaErrorInvalidValue;
    switch (variant) {
      case 0: return launch(r2h_kernel<0>, 1, st, in[0], in[1], in[2], in[3], in[4], in[5], fo[0], io[1], io[2], fo[3], io[4], uo[5], n0, n1, steps);
      case 1: return launch(r2h_kernel<1>, 1, st, in[0], in[1], in[2], in[3], in[4], in[5], fo[0], io[1], io[2], fo[3], io[4], uo[5], n0, n1, steps);
      case 2: return launch(r2h_kernel<2>, 1, st, in[0], in[1], in[2], in[3], in[4], in[5], fo[0], io[1], io[2], fo[3], io[4], uo[5], n0, n1, steps);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (site == 3) {
    switch (variant) {
      case 1: return launch(r2i_kernel<1>, 1, st, in[0], in[1], fo[0], uo[1], n0, steps);
      case 2: return launch(r2i_kernel<2>, 1, st, in[0], in[1], fo[0], uo[1], n0, steps);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
