// The vector->scalar decision round trip on Hopper: the counterpart of two
// Pallas probes of tools/:
//   tools/kernel_lab2.py:136    make_kernel(variant) :34: 256 programs x 2
//                               packets, T steps over an inner table, the
//                               same slab + reductions every step; the next
//                               row scripted (sA), from this step's decision
//                               word (sB), plus stack-word traffic (sC), or
//                               from the previous step's word (sD)
//   tools/mosaic_bisect.py:166  mk(variant) :43, mk_rays(variant) :113: one
//                               construct per rung over a dependent loop,
//                               m0 (a static row, a block sum) to m9 (rays,
//                               a bit-cast meta word, the t compare)
// One block of 128 threads per program, a thread per lane (probe_packet.cuh).
// The round trip is what the TPU paid between its vector unit and its
// scalar core: the block reduce (warp reductions, the four warps' partials
// in shared memory, a barrier), thread 0 combining them into the decision
// word in shared memory, a second barrier, and every thread reading the
// word for the next row's address. sA and sD skip the second barrier (sD
// reads the word one step late, double-buffered); m0-m2 keep the scalar in
// registers (every thread takes it from the reduction itself).
//
// Bound on the H100: latency (a dependent row read and one or two block
// barriers per step); the bytes (a 512-byte row per packet-step) and FP32
// operations (~400 per lane and step) are nanoseconds at the card's rates.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_packet.cuh"

namespace {

using namespace pk;

constexpr int NPK = 2;
constexpr float BIG2 = 1.5e38f;   // BIG / 2

// ---- kernel_lab2 ----
template <int V>   // 0 sA, 1 sB, 2 sC, 3 sD
__global__ void __launch_bounds__(LANES)
lab2_kernel(const float* __restrict__ itab, const float* __restrict__ rays,
            float* __restrict__ out, int* __restrict__ dec_out,
            unsigned* __restrict__ digest, int n, int steps) {
  __shared__ SlotRed<NPK> red;
  __shared__ int dec_s[NPK][4];
  __shared__ int word[2][NPK];
  const int l = threadIdx.x;
  const int g = blockIdx.x;
  if (l < NPK * 4) (&dec_s[0][0])[l] = 0;
  if (l < 2 * NPK) (&word[0][0])[l] = 0;
  float o[NPK][3], iv[NPK][3], t[NPK];
  int cur[NPK];
  unsigned dig[NPK];
#pragma unroll
  for (int p = 0; p < NPK; ++p) {
    const float* r = rays + (long long)(g * NPK + p) * 12 * LANES + l;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[p][a] = r[a * LANES];
      iv[p][a] = r[(6 + a) * LANES];
    }
    t[p] = BIG2;
    cur[p] = p;
    dig[p] = 0u;
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
#pragma unroll
    for (int p = 0; p < NPK; ++p) {
      const float* box = itab + (long long)cur[p] * LANES;
      unsigned key[16], m = 0u;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float tmin, tmax;
        slab_sub(box, c, o[p], iv[p], tmin, tmax);
        const bool hit = slab_hit(tmin, tmax, t[p]);
        key[c] = f2key(hit ? tmin : BIG);
        m |= (unsigned)hit << c;
      }
      red_put(red, buf, p, key, m);
    }
    __syncthreads();
    int prev[NPK];
#pragma unroll
    for (int p = 0; p < NPK; ++p) {
      // t scales where some slot was hit (kmin < BIG: a hit slot's least t
      // is below t, itself below BIG)
      unsigned anyc = 0u;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) anyc |= red.mask[buf][p][w];
      if (anyc) t[p] = t[p] * 1.0000001f;
      prev[p] = word[buf ^ 1][p];       // sD: the previous step's word
      if (l == 0) {
        float pc[16];
        red_get(red, buf, p, pc);
        const int selc = nearest_slot(pc, anyc);
        dec_s[p][0] = selc;
        word[buf][p] = selc;
      }
    }
    if (V == 1 || V == 2) __syncthreads();   // the word, for every thread
#pragma unroll
    for (int p = 0; p < NPK; ++p) {
      int nxt;
      if (V == 0) nxt = (cur[p] * 5 + 1) % (n - 1);
      else if (V == 3) nxt = (cur[p] + prev[p] + 1) % (n - 1);
      else nxt = (cur[p] + word[buf][p] + 1) % (n - 1);
      if (l == 0) {
        if (V == 2) {
          if (s % 2 == 0) dec_s[p][1] = nxt;
          else dec_s[p][2] = dec_s[p][1];
        }
        dig[p] += (unsigned)word[buf][p] + (unsigned)nxt;
      }
      cur[p] = nxt;
    }
  }
#pragma unroll
  for (int p = 0; p < NPK; ++p) out[(g * 8 + p) * LANES + l] = t[p];
  for (int r = NPK; r < 8; ++r) out[(g * 8 + r) * LANES + l] = 0.0f;
  __syncthreads();
  if (l < NPK * 4) dec_out[g * NPK * 4 + l] = (&dec_s[0][0])[l];
  if (l == 0) {
#pragma unroll
    for (int p = 0; p < NPK; ++p) digest[g * NPK + p] = dig[p];
  }
}

// ---- mosaic_bisect ----
// a block sum of one float per lane in the plain versions' order
// (decision_probe._block_sum): a halving tree per warp, then warps 0..3 in order
__device__ __forceinline__ float block_sum(float x, float* scratch4) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_down_sync(FULL, x, o);
  if ((threadIdx.x & 31) == 0) scratch4[threadIdx.x >> 5] = x;
  __syncthreads();
  const float s = ((scratch4[0] + scratch4[1]) + scratch4[2]) + scratch4[3];
  __syncthreads();
  return s;
}

// mosaic_bisect.py:35-40 on the row's first four 16-wide fields, slot c
__device__ __forceinline__ float body_math(const float* row, int c) {
  const float a = nan_min(row[c] * 1.5f - 0.25f, row[16 + c]);
  const float b = nan_max(row[32 + c] * 0.5f + 0.125f, row[48 + c]);
  return nan_max(a, b);
}

template <int K>   // the rung m0..m9
__global__ void __launch_bounds__(LANES)
mosaic_kernel(const float* __restrict__ tab, const float* __restrict__ rays,
              float* __restrict__ out, int* __restrict__ sc_out,
              float* __restrict__ t_s_out, unsigned* __restrict__ digest,
              int n, int steps) {
  __shared__ int sc[3][8];
  __shared__ float t_s[LANES];
  __shared__ unsigned part[2][WARPS];
  __shared__ float sum4[WARPS];
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  if (l < 24) (&sc[0][0])[l] = 0;
  t_s[l] = 0.0f;
  unsigned dig = 0u;
  float ivx = 0.f, ivy = 0.f, oivx = 0.f, oivy = 0.f;
  if (K >= 7) {
    ivx = rays[6 * LANES + l];
    ivy = rays[7 * LANES + l];
    oivx = rays[12 * LANES + l];
    oivy = rays[13 * LANES + l];
  }
  __syncthreads();
  const int sets = K == 5 ? 8 : 1;
  for (int c = 0; c < sets; ++c) {
    int cur = c;
    if (K >= 6) {
      if (l == 0) sc[2][0] = c % n;
      if (K >= 7) t_s[l] = rays[9 * LANES + l];
      __syncthreads();
    }
    for (int s = 0; s < steps; ++s) {
      const int buf = s & 1;
      int wrd, nxt;
      if (K == 0) {
        // a static row, its block sum (cancelled in the next id)
        const int v = (int)block_sum(tab[l], sum4);
        nxt = (int)((unsigned)wadd(wadd(wmul(cur, 5), s), v) - (unsigned)v) &
              (n - 1);
        wrd = v;
      } else if (K <= 2) {
        // the block max of the row (m1) or of the slab-like math (m2)
        const float* row = tab + (long long)cur * LANES;
        float v;
        if (K == 1) {
          v = row[l];
        } else {
          v = body_math(row, 0);
#pragma unroll
          for (int k = 1; k < 16; ++k) v = nan_max(v, body_math(row, k));
        }
        const unsigned mk = __reduce_max_sync(FULL, f2key(v));
        if (lane == 0) part[buf][warp] = mk;
        __syncthreads();
        unsigned m = part[buf][0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) m = max(m, part[buf][w]);
        wrd = key2f(m) > 2.0f ? 1 : 0;
        nxt = (cur * 5 + s + wrd) & (n - 1);
      } else {
        // the decision word through shared memory, read back as the next id
        const int id = K >= 6 ? sc[2][0] : cur;
        const float* row = tab + (long long)id * LANES;
        unsigned hits = 0u;
        if (K <= 6) {
#pragma unroll
          for (int k = 0; k < 16; ++k)
            hits |= (unsigned)(body_math(row, k) > 0.7f) << k;
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const float t0x = row[k] * ivx - oivx;
            const float t1x = row[16 + k] * ivx - oivx;
            const float t0y = row[32 + k] * ivy - oivy;
            const float t1y = row[48 + k] * ivy - oivy;
            const float tmin = nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y));
            const float tmax = nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y));
            const bool hit = K == 9 ? slab_hit(tmin, tmax, t_s[l])
                                    : tmax >= nan_max(tmin, 0.0f);
            hits |= (unsigned)hit << k;
          }
        }
        const unsigned m = __reduce_or_sync(FULL, hits);
        if (lane == 0) part[buf][warp] = m;
        __syncthreads();
        if (l == 0) {
          unsigned a = part[buf][0];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) a |= part[buf][w];
          sc[0][0] = (int)a;
          if (K >= 7) sc[1][0] = K >= 8 ? as_int(row + 96) : 0;
          const int w0 = K >= 7 ? wadd(sc[0][0], sc[1][0]) : sc[0][0];
          const int base = K >= 6 ? sc[2][0] : cur;
          const int nx = wadd(wadd(w0, wmul(base, 5)), s) & (n - 1);
          if (K >= 6) sc[2][0] = nx;
          dig += (unsigned)w0 + (unsigned)nx;
        }
        __syncthreads();
        nxt = K >= 6 ? sc[2][0] : (wadd(wadd(sc[0][0], wmul(cur, 5)), s) & (n - 1));
        wrd = 0;
      }
      if (K <= 2 && l == 0) dig += (unsigned)wrd + (unsigned)nxt;
      cur = nxt;
    }
    out[l] = K == 9 ? (0.0f + (float)cur) + t_s[l] : 0.0f + (float)cur;
  }
  __syncthreads();
  if (l < 24) sc_out[l] = (&sc[0][0])[l];
  t_s_out[l] = t_s[l];
  if (l == 0) digest[0] = dig;
}

}  // namespace

// site 0 kernel_lab2 (variant 0-3 = sA sB sC sD; ins itab, rays; outs out,
// dec_s, digest; programs blocks), 1 mosaic_bisect (variant 0-9 = m0-m9;
// ins tab, rays; outs out, sc, t_s, digest; one block; n a power of two).
extern "C" int cpt_probe_decision(int site, int variant, int steps,
                                  const void* const* ins, void* const* outs,
                                  int n, int programs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps < 0 || n < 2 || programs < 1) return (int)cudaErrorInvalidValue;
  const float* const* in = reinterpret_cast<const float* const*>(ins);
  float* const* fo = reinterpret_cast<float* const*>(outs);
  int* const* io = reinterpret_cast<int* const*>(outs);
  unsigned* const* uo = reinterpret_cast<unsigned* const*>(outs);
  if (site == 0) {
    switch (variant) {
      case 0: return launch(lab2_kernel<0>, programs, st, in[0], in[1], fo[0], io[1], uo[2], n, steps);
      case 1: return launch(lab2_kernel<1>, programs, st, in[0], in[1], fo[0], io[1], uo[2], n, steps);
      case 2: return launch(lab2_kernel<2>, programs, st, in[0], in[1], fo[0], io[1], uo[2], n, steps);
      case 3: return launch(lab2_kernel<3>, programs, st, in[0], in[1], fo[0], io[1], uo[2], n, steps);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (site != 1 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
#define MOSAIC_CASE(K) \
  case K: return launch(mosaic_kernel<K>, 1, st, in[0], in[1], fo[0], io[1], fo[2], uo[3], n, steps);
  switch (variant) {
    MOSAIC_CASE(0) MOSAIC_CASE(1) MOSAIC_CASE(2) MOSAIC_CASE(3) MOSAIC_CASE(4)
    MOSAIC_CASE(5) MOSAIC_CASE(6) MOSAIC_CASE(7) MOSAIC_CASE(8) MOSAIC_CASE(9)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MOSAIC_CASE
}
