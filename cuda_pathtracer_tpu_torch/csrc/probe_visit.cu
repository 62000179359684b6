// The v2 packet visit taken apart on Hopper: the counterpart of two Pallas
// probes of tools/:
//   tools/kernel_lab3.py:487     make_kernel(variant) :65, pack_bf16 :459:
//                                256 programs x 2 packets, T scripted steps,
//                                17 rungs from the empty loop to the full
//                                inner visit (fetch, first word to every
//                                lane, field blocks, slab, any-reduce and
//                                decision words), bf16 box planes, two
//                                visits a step, the any-reduce as tensor-core
//                                counts, 8 / 16 visits under one reduce (rows
//                                read each, or staged together), 1 / 8 / 16
//                                leaves a step
//   tools/subpacket_probe.py:295 _mk(variant) :68, _mk_v2ref :227: one
//                                program, 8 subpackets of 16 lanes a step:
//                                v2ref, fetch8, exp_mxu, dec_mxu, dec_sum,
//                                full
// One block of 128 threads per program, a thread per lane (probe_packet.cuh).
//
// The tensor-core rungs use mma.sync m16n8k16 bf16 -> f32 and stay exact:
// - kernel_lab3 mxu: per warp, the hit masks of its 32 lanes (A, 16 slots x
//   32 lanes, 0/1, built by four shuffles per k-tile) times ones: per-slot
//   hit counts, summed over the four warps in shared memory (integers < 129);
// - subpacket exp_mxu / dec_mxu / full: each lane's field of its subpacket's
//   row, out[i, l] = rt[l / 16][off + i], is A (the fields, 16 x 8 groups)
//   times B (0/1, group -> lane), with the f32 row in three bf16 pieces
//   (hi + mid + lo = the value exactly) in three accumulators summed (hi +
//   mid) + lo; the slab and Moller-Trumbore then run in the accumulator
//   layout (rows = slots, columns = lanes). dec_mxu's counts per (group,
//   slot) are gmap^T (0/1) times the hit bits, fed straight from the
//   accumulators (two n-tiles make one k-tile), and the group's hit mask is
//   one more product with the powers of two (exact in bf16; sums < 2^16).
// dec_mxu's DMA hand-off (subpacket_probe.py:146-155) becomes a store of the
// (8, DECW) decision block to shared memory, a __syncthreads, and per-group
// reads; dec_sum writes the same words from per-warp reductions.
//
// Bound on the H100: latency per step (dependent row reads, one or two
// block barriers); the FP32 work (~400-2,000 operations per lane and visit)
// and the bytes (512-byte rows) are far below the card's rates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_packet.cuh"

namespace {

using namespace pk;

constexpr int NPK = 2;
constexpr int DECW = 128;
constexpr float BIG2 = 1.5e38f;
constexpr float BIG_SUB = 1e30f;    // subpacket_probe.py's BIG

enum Rung {
  EMPTY, FETCH, TRANS, BCAST, SLAB, FULL, BF16, DUAL, MXU, SHARE8, SHARE8T,
  SHARE16, SHARE16T, LEAF, LEAF8, LEAF8T, LEAF16T
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 1.0 in the low / high half of a .b32 register
__device__ __forceinline__ uint32_t ones_pair(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// the three bf16 pieces of an f32: hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid); (hi + mid) + lo == x
__device__ __forceinline__ void pieces(float x, uint32_t (&p)[3]) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(h);
  const __nv_bfloat16 m = __float2bfloat16_rn(r1);
  const float r2 = r1 - __bfloat162float(m);
  p[0] = (uint32_t)__bfloat16_as_ushort(h);
  p[1] = (uint32_t)__bfloat16_as_ushort(m);
  p[2] = bf16_bits(r2);
}

// ---- kernel_lab3 ----
template <int V>
struct Lab3 {
  static constexpr int K = (V == SHARE8 || V == SHARE8T || V == LEAF8 ||
                            V == LEAF8T) ? 8
                           : (V == SHARE16 || V == SHARE16T || V == LEAF16T)
                               ? 16 : 1;
  static constexpr bool STAGE = V == SHARE8T || V == SHARE16T ||
                                V == LEAF8T || V == LEAF16T;
  static constexpr bool SHARE = V >= SHARE8 && V <= SHARE16T;
};

// the 16-bit hit mask of one lane against row b (boxes at 0, product form)
__device__ __forceinline__ unsigned lane_hits(const float* b, const float iv[3],
                                              const float oiv[3], float t) {
  unsigned m = 0u;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    float tmin, tmax;
    slab_fma(b, c, iv, oiv, tmin, tmax);
    m |= (unsigned)slab_hit(tmin, tmax, t) << c;
  }
  return m;
}

// kernel_lab3.py:100-132: even planes by shift; field f, child c at packed
// lane 8 f + c / 2
__device__ __forceinline__ unsigned lane_hits_bf16(const float* brow,
                                                   const float iv[3],
                                                   const float oiv[3], float t) {
  float box[96];
#pragma unroll
  for (int f = 0; f < 6; ++f)
#pragma unroll
    for (int c = 0; c < 16; ++c)
      box[f * 16 + c] = __uint_as_float(__float_as_uint(brow[f * 8 + c / 2]) << 16);
  return lane_hits(box, iv, oiv, t);
}

// kernel_lab3's mxu: per-slot hit counts of this warp's 32 lanes on the
// tensor cores (A = the hit bits, 16 slots x 16 lanes per k-tile; B = ones)
__device__ __forceinline__ void mxu_counts(unsigned m, float (&d)[4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int base = 16 * kk + 2 * tig;
    const unsigned m0 = __shfl_sync(FULL, m, base);
    const unsigned m1 = __shfl_sync(FULL, m, base + 1);
    const unsigned m8 = __shfl_sync(FULL, m, base + 8);
    const unsigned m9 = __shfl_sync(FULL, m, base + 9);
    const uint32_t a0 = ones_pair((m0 >> g) & 1u, (m1 >> g) & 1u);
    const uint32_t a1 = ones_pair((m0 >> (g + 8)) & 1u, (m1 >> (g + 8)) & 1u);
    const uint32_t a2 = ones_pair((m8 >> g) & 1u, (m9 >> g) & 1u);
    const uint32_t a3 = ones_pair((m8 >> (g + 8)) & 1u, (m9 >> (g + 8)) & 1u);
    mma_bf16(d, a0, a1, a2, a3, 0x3F803F80u, 0x3F803F80u);
  }
}

template <int V>
__global__ void __launch_bounds__(LANES)
lab3_kernel(const float* __restrict__ tab, const float* __restrict__ btab,
            const float* __restrict__ rays, float* __restrict__ out,
            int* __restrict__ dec_out, unsigned* __restrict__ digest, int n,
            int steps) {
  using L = Lab3<V>;
  constexpr int K = L::K;
  __shared__ int dec_s[NPK][4];
  __shared__ unsigned part[2][WARPS][16];
  __shared__ float cnt[2][WARPS][16];
  __shared__ float rows_s[L::STAGE ? K : 1][LANES];
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const int g = blockIdx.x;
  if (l < NPK * 4) (&dec_s[0][0])[l] = 0;
  float o[NPK][3], d[NPK][3], iv[NPK][3], oiv[NPK][3], t[NPK];
  int cur[NPK];
  unsigned dig[NPK];
#pragma unroll
  for (int p = 0; p < NPK; ++p) {
    const float* r = rays + (long long)(g * NPK + p) * 16 * LANES + l;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[p][a] = r[a * LANES];
      d[p][a] = r[(3 + a) * LANES];
      iv[p][a] = r[(6 + a) * LANES];
      oiv[p][a] = r[(12 + a) * LANES];
    }
    t[p] = BIG2;
    cur[p] = p;
    dig[p] = 0u;
  }
  __syncthreads();
  int ph = 0;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int p = 0; p < NPK; ++p) {
      const float* row = tab + (long long)cur[p] * LANES;
      if (V == EMPTY || V == FETCH || V == TRANS || V == BCAST || V == SLAB) {
        if (V == FETCH) {
          t[p] = t[p] + row[l] * 1e-30f;
        } else if (V == TRANS) {
          t[p] = t[p] + row[0] * 1e-30f;
        } else if (V == BCAST) {
          float mn = 0.f;
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            float acc = row[c];
#pragma unroll
            for (int k = 1; k < 6; ++k) acc = acc + row[16 * k + c];
            mn = c == 0 ? acc : nan_min(mn, acc);
          }
          t[p] = t[p] + mn * 1e-30f;
        } else if (V == SLAB) {
          const unsigned m = lane_hits(row, iv[p], oiv[p], t[p]);
          float csum = 0.f;
#pragma unroll
          for (int c = 0; c < 16; ++c) csum = csum + (float)((m >> c) & 1u);
          t[p] = t[p] + csum * 1e-30f;
        }
        if (l == 0) {
          dec_s[p][0] = cur[p];
          dig[p] += (unsigned)cur[p];
        }
      } else if (V == FULL || V == BF16 || V == DUAL || V == MXU) {
#pragma unroll
        for (int v = 0; v < (V == DUAL ? 2 : 1); ++v) {
          const int id = v == 0 ? cur[p] : (cur[p] + 1) % (n - 1);
          const float* r = (V == BF16 ? btab : tab) + (long long)id * LANES;
          const unsigned m = V == BF16 ? lane_hits_bf16(r, iv[p], oiv[p], t[p])
                                       : lane_hits(r, iv[p], oiv[p], t[p]);
          if (V == MXU) {
            float dd[4];
            mxu_counts(m, dd);
            if ((lane & 3) == 0) {
              cnt[ph][warp][lane >> 2] = dd[0];
              cnt[ph][warp][(lane >> 2) + 8] = dd[2];
            }
          } else {
            const unsigned wm = __reduce_or_sync(FULL, m);
            if (lane == 0) part[ph][warp][0] = wm;
          }
          __syncthreads();
          if (l == 0) {
            unsigned anyc = 0u;
            if (V == MXU) {
#pragma unroll
              for (int c = 0; c < 16; ++c)
                anyc |= (unsigned)((cnt[ph][0][c] + cnt[ph][1][c]) +
                                   (cnt[ph][2][c] + cnt[ph][3][c]) > 0.f) << c;
            } else {
#pragma unroll
              for (int w = 0; w < WARPS; ++w) anyc |= part[ph][w][0];
            }
            const int meta = as_int(r + 96);
            dec_s[p][0] = (int)anyc;
            dec_s[p][1] = meta;
            dig[p] += anyc + (unsigned)meta;
          }
          ph ^= 1;
          t[p] = t[p] * 1.0000001f;
        }
      } else if (L::SHARE) {
        int ids[K];
#pragma unroll
        for (int q = 0; q < K; ++q) ids[q] = (cur[p] + q * 37) % (n - 1);
        if (L::STAGE) {
#pragma unroll
          for (int q = 0; q < K; ++q)
            rows_s[q][l] = tab[(long long)ids[q] * LANES + l];
          __syncthreads();
        }
        int meta[K];
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const float* r = L::STAGE ? rows_s[q] : tab + (long long)ids[q] * LANES;
          const unsigned wm = __reduce_or_sync(FULL, lane_hits(r, iv[p], oiv[p], t[p]));
          if (lane == 0) part[ph][warp][q] = wm;
          meta[q] = as_int(r + 96);
        }
        __syncthreads();
        if (l == 0) {
#pragma unroll
          for (int q = 0; q < K; ++q) {
            unsigned a = 0u;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) a |= part[ph][w][q];
            dec_s[p][0] = (int)a;
            dec_s[p][1] = meta[q];
            dig[p] += a + (unsigned)meta[q];
          }
        }
        ph ^= 1;
        t[p] = t[p] * 1.0000001f;
      } else {
        // leaves: 12 Moller-Trumbore tests per row, lane-local
        int ids[K];
#pragma unroll
        for (int q = 0; q < K; ++q) ids[q] = (cur[p] + q * 37) % (n - 1);
        if (L::STAGE) {
#pragma unroll
          for (int q = 0; q < K; ++q)
            rows_s[q][l] = tab[(long long)ids[q] * LANES + l];
          __syncthreads();
        }
        float leaf_t = BIG;
        bool take = false;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const float* r = L::STAGE ? rows_s[q] : tab + (long long)ids[q] * LANES;
#pragma unroll
          for (int k = 0; k < 12; ++k) {
            float tt;
            const bool ok = moller_row(r, 12, k, o[p], d[p], 1e-4f, tt) &&
                            tt > 0.0f && tt < t[p];
            leaf_t = nan_min(leaf_t, ok ? tt : BIG);
            take |= ok;
          }
        }
        if (L::STAGE) __syncthreads();   // the rows are read before the next
        if (take) t[p] = leaf_t;
        if (l == 0) {
          dec_s[p][0] = cur[p];
          dig[p] += (unsigned)cur[p];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < NPK; ++p) cur[p] = (cur[p] * 5 + 1) % (n - 1);
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

// ---- subpacket_probe ----
enum Sub { V2REF, FETCH8, EXP_MXU, DEC_MXU, DEC_SUM, SUB_FULL };

// rt fields f (rows of `rows` from off) expanded to this thread's elements:
// n-tile j of warp w is lanes 32 w + 8 j .. + 7, all of group 2 w + j / 2;
// element e of n-tile j: row g + 8 (e >> 1), lane 32 w + 8 j + 2 tig + (e & 1)
__device__ __forceinline__ void expand(const float (*rt)[LANES], int off,
                                       int rows, float (&f)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // A = the fields, rows x groups: a0 (row g, groups 2 tig, 2 tig + 1), a1
  // (row g + 8); groups 8..15 are zero
  uint32_t plo[3], phi[3], qlo[3], qhi[3];
  pieces(rt[2 * tig][off + g], plo);
  pieces(rt[2 * tig + 1][off + g], phi);
  const bool has8 = g + 8 < rows;
  pieces(has8 ? rt[2 * tig][off + g + 8] : 0.f, qlo);
  pieces(has8 ? rt[2 * tig + 1][off + g + 8] : 0.f, qhi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int grp = 2 * warp + (j >> 1);
    const uint32_t b0 = ones_pair(2 * tig == grp, 2 * tig + 1 == grp);
    float acc[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
      mma_bf16(acc[k], plo[k] | (phi[k] << 16), qlo[k] | (qhi[k] << 16), 0u, 0u,
               b0, 0u);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) f[j][e] = (acc[0][e] + acc[1][e]) + acc[2][e];
  }
}

template <int V>
__global__ void __launch_bounds__(LANES)
subpacket_kernel(const float* __restrict__ tab, const float* __restrict__ rays,
                 float* __restrict__ out, float* __restrict__ rt_out,
                 int* __restrict__ dec_v_out, int* __restrict__ dmem_out,
                 int* __restrict__ sc_out, float* __restrict__ t_s_out,
                 unsigned* __restrict__ digest, int n, int steps, int sets) {
  __shared__ int sc[3][8];
  __shared__ float rt[8][LANES];
  __shared__ int dec_v[8][DECW];
  __shared__ float t_s[LANES];
  __shared__ unsigned part[2][WARPS][2];
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const int g = lane >> 2, tig = lane & 3;
  if (l < 24) (&sc[0][0])[l] = 0;
  for (int e = l; e < 8 * LANES; e += LANES) (&rt[0][0])[e] = 0.f;
  for (int e = l; e < 8 * DECW; e += LANES) (&dec_v[0][0])[e] = 0;
  // this thread's lanes: its own (v2ref, fetch8) or its elements' (e & 1)
  float iv[4][2][3], oiv[4][2][3], ro[4][2][3], rd[4][2][3];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int L = V <= FETCH8 ? l : 32 * warp + 8 * j + 2 * tig + h;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        ro[j][h][a] = rays[a * LANES + L];
        rd[j][h][a] = rays[(3 + a) * LANES + L];
        iv[j][h][a] = rays[(6 + a) * LANES + L];
        oiv[j][h][a] = rays[(12 + a) * LANES + L];
      }
    }
  unsigned dig = 0u;
  int ph = 0;
  for (int c = 0; c < sets; ++c) {
    t_s[l] = rays[9 * LANES + l];
    int ids[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) ids[q] = V == V2REF ? (q == 0 ? c % n : 0)
                                                    : (c * 7 + q * 13) % n;
    if (l == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (V != V2REF || q == 0) sc[2][q] = ids[q];
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      if (V == V2REF) {
        const float* row = tab + (long long)ids[0] * LANES;
        const unsigned wm = __reduce_or_sync(FULL, lane_hits(row, iv[0][0], oiv[0][0], t_s[l]));
        if (lane == 0) part[ph][warp][0] = wm;
        __syncthreads();
        unsigned m = 0u;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) m |= part[ph][w][0];
        ph ^= 1;
        const int meta = as_int(row + 96);
        const int nx = wadd(wadd(wadd((int)m, meta), wmul(ids[0], 5)), s) & (n - 1);
        if (l == 0) {
          sc[0][0] = (int)m;
          sc[1][0] = meta;
          sc[2][0] = nx;
          dig += m + (unsigned)meta + (unsigned)nx;
        }
        ids[0] = nx;
        continue;
      }
      // 8 dependent row fetches into rt
#pragma unroll
      for (int q = 0; q < 8; ++q) rt[q][l] = tab[(long long)ids[q] * LANES + l];
      __syncthreads();
      if (V == FETCH8) {
        const int w0 = (int)rt[0][0];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          ids[q] = wadd(wadd(wadd(w0, wmul(ids[q], 5)), q * 37), s) & (n - 1);
        if (l == 0) {
          sc[0][0] = w0;
          dig += (unsigned)w0;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            sc[2][q] = ids[q];
            dig += (unsigned)ids[q];
          }
        }
        __syncthreads();   // rt is read before the next fetch
        continue;
      }
      // each lane's box fields from its subpacket's row, on the tensor cores
      float box[6][4][4];
#pragma unroll
      for (int f = 0; f < 6; ++f) expand(rt, f * 16, 16, box[f]);
      float tpre[4][2];
      bool hit[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tpre[j][h] = t_s[32 * warp + 8 * j + 2 * tig + h];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e & 1;
          float tmin, tmax;
          tmin_tmax(box[0][j][e] * iv[j][h][0] - oiv[j][h][0],
                    box[3][j][e] * iv[j][h][0] - oiv[j][h][0],
                    box[1][j][e] * iv[j][h][1] - oiv[j][h][1],
                    box[4][j][e] * iv[j][h][1] - oiv[j][h][1],
                    box[2][j][e] * iv[j][h][2] - oiv[j][h][2],
                    box[5][j][e] * iv[j][h][2] - oiv[j][h][2], tmin, tmax);
          hit[j][e] = slab_hit(tmin, tmax, tpre[j][h]);
        }
      }
      if (V == EXP_MXU) {
        unsigned m = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) m |= (unsigned)hit[j][e] << (g + 8 * (e >> 1));
        const unsigned wm = __reduce_or_sync(FULL, m);
        if (lane == 0) part[ph][warp][0] = wm;
        __syncthreads();
        unsigned a = 0u;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) a |= part[ph][w][0];
        ph ^= 1;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          ids[q] = wadd(wadd(wadd((int)a, wmul(ids[q], 5)), q * 37), s) & (n - 1);
        if (l == 0) {
          sc[0][0] = (int)a;
          dig += a;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            sc[2][q] = ids[q];
            dig += (unsigned)ids[q];
          }
        }
        continue;
      }
      if (V == DEC_SUM) {
        // per-group any: each warp holds its two groups whole
        unsigned m0 = 0u, m1 = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned b = (unsigned)hit[j][e] << (g + 8 * (e >> 1));
            if (j < 2) m0 |= b;
            else m1 |= b;
          }
        m0 = __reduce_or_sync(FULL, m0);
        m1 = __reduce_or_sync(FULL, m1);
        if (lane == 0) {
          sc[0][2 * warp] = (int)m0;
          sc[0][2 * warp + 1] = (int)m1;
          sc[1][2 * warp] = as_int(&rt[2 * warp][96]);
          sc[1][2 * warp + 1] = as_int(&rt[2 * warp + 1][96]);
        }
      } else {
        // dec_mxu / full: counts^T = gmap^T (groups x lanes) @ hits^T
        // (lanes x slots), per warp over its 32 lanes (its two groups)
        float cntT[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) cntT[nt][0] = cntT[nt][1] = cntT[nt][2] = cntT[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t a0 = (g == 2 * warp + kk) ? 0x3F803F80u : 0u;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const uint32_t b0 = ones_pair(hit[2 * kk][2 * nt], hit[2 * kk][2 * nt + 1]);
            const uint32_t b1 = ones_pair(hit[2 * kk + 1][2 * nt], hit[2 * kk + 1][2 * nt + 1]);
            mma_bf16(cntT[nt], a0, 0u, a0, 0u, b0, b1);
          }
        }
        // the group's hit mask: (counts^T > 0) @ 2^slot
        const uint32_t a0 = ones_pair(cntT[0][0] > 0.f, cntT[0][1] > 0.f);
        const uint32_t a1 = ones_pair(cntT[0][2] > 0.f, cntT[0][3] > 0.f);
        const uint32_t a2 = ones_pair(cntT[1][0] > 0.f, cntT[1][1] > 0.f);
        const uint32_t a3 = ones_pair(cntT[1][2] > 0.f, cntT[1][3] > 0.f);
        const uint32_t b0 = bf16_bits((float)(1 << (2 * tig))) |
                            (bf16_bits((float)(1 << (2 * tig + 1))) << 16);
        const uint32_t b1 = bf16_bits((float)(1 << (2 * tig + 8))) |
                            (bf16_bits((float)(1 << (2 * tig + 9))) << 16);
        float bits[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(bits, a0, a1, a2, a3, b0, b1);
        if (tig == 0 && (g >> 1) == warp) {
          dec_v[g][0] = (int)bits[0];
          dec_v[g][1] = as_int(&rt[g][96]);
        }
      }
      if (V == SUB_FULL) {
        // the leaf path: each lane's triangle fields from its subpacket's row
        float tri[9][4][4];
#pragma unroll
        for (int f = 0; f < 9; ++f) expand(rt, f * 12, 12, tri[f]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float lt = BIG_SUB;
            bool tk = false;
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int e = 2 * hi + h;
              if (hi == 1 && g + 8 >= 12) continue;
              float tt;
              const bool ok =
                  moller(tri[0][j][e], tri[1][j][e], tri[2][j][e], tri[3][j][e],
                         tri[4][j][e], tri[5][j][e], tri[6][j][e], tri[7][j][e],
                         tri[8][j][e], ro[j][h], rd[j][h], 1e-4f, tt) &&
                  tt > 0.0f && tt < tpre[j][h];
              lt = nan_min(lt, ok ? tt : BIG_SUB);
              tk |= ok;
            }
            // over the 8 row groups of the warp (lane bits 2-4)
#pragma unroll
            for (int x = 4; x < 32; x <<= 1) {
              lt = nan_min(lt, __shfl_xor_sync(FULL, lt, x));
              tk |= __shfl_xor_sync(FULL, (int)tk, x) != 0;
            }
            tpre[j][h] = tk ? lt : tpre[j][h];
          }
      }
      __syncthreads();   // the decision words, for every thread
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int w0 = V == DEC_SUM ? wadd(sc[0][q], sc[1][q])
                                    : wadd(dec_v[q][0], dec_v[q][1]);
        dig += l == 0 ? (unsigned)w0 : 0u;
        ids[q] = wadd(wadd(wadd(w0, wmul(ids[q], 5)), q * 37), s) & (n - 1);
      }
      if (V == SUB_FULL && g == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            t_s[32 * warp + 8 * j + 2 * tig + h] = tpre[j][h];
      }
      if (l == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          sc[2][q] = ids[q];
          dig += (unsigned)ids[q];
        }
      }
    }
    __syncthreads();
    int acc = ids[0];
    if (V != V2REF) {
#pragma unroll
      for (int q = 1; q < 8; ++q) acc = wadd(acc, ids[q]);
    }
    out[l] = (0.0f + (float)acc) + t_s[l];
    __syncthreads();
  }
  for (int e = l; e < 8 * LANES; e += LANES) rt_out[e] = (&rt[0][0])[e];
  for (int e = l; e < 8 * DECW; e += LANES) {
    dec_v_out[e] = (&dec_v[0][0])[e];
    dmem_out[e] = (&dec_v[0][0])[e];
  }
  if (l < 24) sc_out[l] = (&sc[0][0])[l];
  t_s_out[l] = t_s[l];
  if (l == 0) digest[0] = dig;
}

}  // namespace

// site 0 kernel_lab3 (variant 0-16 in the Rung order; ins tab, btab, rays;
// outs out, dec_s, digest; programs blocks), 1 subpacket_probe (variant 0-5
// in the Sub order; ins tab, rays; outs out, rt, dec_v, dmem, sc, t_s,
// digest; one block, `programs` sets; n a power of two).
extern "C" int cpt_probe_visit(int site, int variant, int steps,
                               const void* const* ins, void* const* outs, int n,
                               int programs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps < 0 || n < 2 || programs < 1) return (int)cudaErrorInvalidValue;
  const float* const* in = reinterpret_cast<const float* const*>(ins);
  float* const* fo = reinterpret_cast<float* const*>(outs);
  int* const* io = reinterpret_cast<int* const*>(outs);
  unsigned* const* uo = reinterpret_cast<unsigned* const*>(outs);
  if (site == 0) {
#define LAB3_CASE(V) \
  case V: return launch(lab3_kernel<V>, programs, st, in[0], in[1], in[2], fo[0], io[1], uo[2], n, steps);
    switch (variant) {
      LAB3_CASE(0) LAB3_CASE(1) LAB3_CASE(2) LAB3_CASE(3) LAB3_CASE(4)
      LAB3_CASE(5) LAB3_CASE(6) LAB3_CASE(7) LAB3_CASE(8) LAB3_CASE(9)
      LAB3_CASE(10) LAB3_CASE(11) LAB3_CASE(12) LAB3_CASE(13) LAB3_CASE(14)
      LAB3_CASE(15) LAB3_CASE(16)
      default: return (int)cudaErrorInvalidValue;
    }
#undef LAB3_CASE
  }
  if (site != 1 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
#define SUB_CASE(V) \
  case V: return launch(subpacket_kernel<V>, 1, st, in[0], in[1], fo[0], fo[1], io[2], io[3], io[4], fo[5], uo[6], n, steps, programs);
  switch (variant) {
    SUB_CASE(0) SUB_CASE(1) SUB_CASE(2) SUB_CASE(3) SUB_CASE(4) SUB_CASE(5)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SUB_CASE
}
