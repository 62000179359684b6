// A scripted packet-traversal step, chained T times: the Hopper counterpart
// of four Pallas probes of tools/ that priced one dependent step of a packet
// loop on the TPU:
//   tools/pallas_probe_r2b.py:49  the base chain (:17-44): read tile tab[idx]
//                                 (8 x 128 f32 = 4 KB), vector ops, a max
//                                 reduce to a scalar, a push and pop of a
//                                 64-entry stack, the scalar accumulated
//   tools/pallas_probe_r2c.py:63  the same with each of read / vec / sreduce
//                                 / stack toggled
//   tools/pallas_probe_r2d.py:52  the T sweep (ns per step is the slope)
//   tools/pallas_probe_r2e.py:62  NI interleaved chains, their reduces
//                                 batched into one drain or not
// The toggles and NI are template parameters. One block of 256 threads holds
// the 8 x 128 tile as one float4 per thread; the max reduce is a warp
// shuffle then a shared-memory pass over the 8 warps; the stack lives in
// shared memory (thread 0 pushes), the index and stack pointer in registers,
// identical in every thread. One __syncthreads per step (per chain and step
// when NI > 1 is not batched). The TPU kernel is one program, so this runs
// ONE block and the rest of the card idles: right for a latency probe, which
// prices the dependent chain (load -> vector ops -> block reduce -> next
// index), not throughput.
//
// Rounding: separate multiplies and adds (-fmad=false), NaN-propagating
// min/max, the scalar sum in step order, so the output is bit-equal to the
// plain version. With the reduce off, the output adds the per-element sum of
// the chain's tiles (r2c's vacc); with it on, it adds none (r2c adds a zero
// block there, which changes no bit of a non-negative sum).
//
// Bound on the H100: neither bytes nor operations (4 KB and ~10 K operations
// per step, nanoseconds at the card's rates) but the chain's latency: a
// dependent global load and a block barrier per step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 x 128 floats = 256 float4
constexpr int kStack = 64;
constexpr int kStackLimit = 60;

__device__ __forceinline__ float4 vmax(float4 a, float4 b) {
  return make_float4(probe_max(a.x, b.x), probe_max(a.y, b.y),
                     probe_max(a.z, b.z), probe_max(a.w, b.w));
}

__device__ __forceinline__ float4 vmin(float4 a, float4 b) {
  return make_float4(probe_min(a.x, b.x), probe_min(a.y, b.y),
                     probe_min(a.z, b.z), probe_min(a.w, b.w));
}

// c = min(b * b + a, a * 1.5 - tile), a = (tile - rays) * rays,
// b = max(a, tile * 0.5 + rays)
__device__ __forceinline__ float vec1(float t, float r, bool on) {
  if (!on) return t;
  const float a = (t - r) * r;
  const float b = probe_max(a, t * 0.5f + r);
  return probe_min(b * b + a, a * 1.5f - t);
}

template <bool READ, bool VEC, bool SRED, bool STACK, int NI, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
step_kernel(const float4* __restrict__ tab, const float4* __restrict__ rays,
            float4* __restrict__ out, int n_nodes, int steps) {
  __shared__ int stack[NI][kStack];
  __shared__ float red_s[2][NI][kThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int e = t; e < NI * kStack; e += kThreads) (&stack[0][0])[e] = 0;
  __syncthreads();

  const float4 r = rays[t];
  int idx[NI], sp[NI];
#pragma unroll
  for (int p = 0; p < NI; ++p) {
    idx[p] = p;
    sp[p] = 0;
  }
  float acc = 0.f;
  float4 vacc = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = 0; i < steps; ++i) {
    float4 c[NI];
#pragma unroll
    for (int p = 0; p < NI; ++p) {
      float4 tile;
      if (READ) {
        tile = tab[(long long)idx[p] * kThreads + t];
      } else {
        const float f = 1.0f + (float)idx[p];
        tile = make_float4(r.x * f, r.y * f, r.z * f, r.w * f);
      }
      c[p] = make_float4(vec1(tile.x, r.x, VEC), vec1(tile.y, r.y, VEC),
                         vec1(tile.z, r.z, VEC), vec1(tile.w, r.w, VEC));
    }
    bool hit[NI];
    if (SRED) {
      const int buf = i & 1;
      float red[NI];
#pragma unroll
      for (int p = 0; p < NI; ++p) {
        float m = probe_max(probe_max(c[p].x, c[p].y), probe_max(c[p].z, c[p].w));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = probe_max(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) red_s[buf][p][warp] = m;
        if (!BATCHED) {
          __syncthreads();
          float v = red_s[buf][p][0];
#pragma unroll
          for (int w = 1; w < kThreads / 32; ++w) v = probe_max(v, red_s[buf][p][w]);
          red[p] = v;
        }
      }
      if (BATCHED) {
        __syncthreads();
#pragma unroll
        for (int p = 0; p < NI; ++p) {
          float v = red_s[buf][p][0];
#pragma unroll
          for (int w = 1; w < kThreads / 32; ++w) v = probe_max(v, red_s[buf][p][w]);
          red[p] = v;
        }
      }
#pragma unroll
      for (int p = 0; p < NI; ++p) {
        acc = acc + red[p];
        hit[p] = red[p] > 0.f;
      }
    } else {
      vacc = make_float4(vacc.x + c[0].x, vacc.y + c[0].y, vacc.z + c[0].z,
                         vacc.w + c[0].w);
#pragma unroll
      for (int p = 0; p < NI; ++p) hit[p] = (i % 3) > 0;
    }
#pragma unroll
    for (int p = 0; p < NI; ++p) {
      const int nxt = (idx[p] * 5 + 1) % n_nodes;
      if (STACK) {
        const bool push = hit[p] && sp[p] < kStackLimit;
        if (push && t == 0) stack[p][sp[p]] = nxt;
        const int sp2 = push ? sp[p] + 1 : sp[p];
        const int sp3 = max(sp2 - 1, 0);
        // a push is popped at once: the popped entry is the one just pushed
        const int popped = push ? nxt : stack[p][sp3];
        idx[p] = sp2 > 0 ? popped : nxt;
        sp[p] = sp3;
      } else {
        idx[p] = nxt;
      }
    }
    // the stack entries a later step may pop are visible after this barrier
    if (STACK && !SRED) __syncthreads();
  }
  float4 o = make_float4(r.x + acc, r.y + acc, r.z + acc, r.w + acc);
  if (!SRED) o = make_float4(o.x + vacc.x, o.y + vacc.y, o.z + vacc.z, o.w + vacc.w);
  out[t] = o;
}

template <bool R, bool V, bool S, bool K, int NI, bool B>
int launch(const float* tab, const float* rays, float* out, int n, int steps,
           cudaStream_t st) {
  step_kernel<R, V, S, K, NI, B><<<1, kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(tab),
      reinterpret_cast<const float4*>(rays), reinterpret_cast<float4*>(out), n,
      steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define STEP_CASE(F)                                                         \
  case F:                                                                    \
    return launch<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0, (F & 8) != 0, 1, \
                  false>(tab, rays, out, n_nodes, steps, st);

// tab [n_nodes, 8, 128] f32, rays and out [8, 128] f32. flags: bit 0 read,
// bit 1 vec, bit 2 sreduce, bit 3 stack. ni 1 takes any flags; ni 2, 4 and 8
// take all four (r2e), with batched 0 (a barrier per chain) or 1 (one
// barrier for all chains).
extern "C" int cpt_probe_step(const float* tab, const float* rays, float* out,
                              int n_nodes, int steps, int flags, int ni,
                              int batched, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_nodes < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  if (ni == 1) {
    switch (flags) {
      STEP_CASE(0) STEP_CASE(1) STEP_CASE(2) STEP_CASE(3)
      STEP_CASE(4) STEP_CASE(5) STEP_CASE(6) STEP_CASE(7)
      STEP_CASE(8) STEP_CASE(9) STEP_CASE(10) STEP_CASE(11)
      STEP_CASE(12) STEP_CASE(13) STEP_CASE(14) STEP_CASE(15)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (flags != 15 || ni > n_nodes) return (int)cudaErrorInvalidValue;
  switch (ni * 2 + (batched ? 1 : 0)) {
    case 4: return launch<true, true, true, true, 2, false>(tab, rays, out, n_nodes, steps, st);
    case 5: return launch<true, true, true, true, 2, true>(tab, rays, out, n_nodes, steps, st);
    case 8: return launch<true, true, true, true, 4, false>(tab, rays, out, n_nodes, steps, st);
    case 9: return launch<true, true, true, true, 4, true>(tab, rays, out, n_nodes, steps, st);
    case 16: return launch<true, true, true, true, 8, false>(tab, rays, out, n_nodes, steps, st);
    case 17: return launch<true, true, true, true, 8, true>(tab, rays, out, n_nodes, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
