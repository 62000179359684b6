// Separable luminance Gaussian of the film's blurred display.
//
// Replaces the Pallas TPU kernel cuda_pathtracer_tpu/ops/blur_pallas.py
// `_blur_kernel` (called from `blur_luminance_pallas`), which held whole
// color planes in VMEM (so at most 640x640 frames) and fused the albedo
// divide and both passes. Per pixel and channel c = lum / max(alb, 0.001) *
// n, then a 7-tap horizontal (-3..3) and an 8-tap vertical (-4..3) Gaussian,
// each tap skipped outside the frame and each pass renormalised over the
// taps taken, as the reference's gauss_horz / gauss_vert shaders do
// (main.cpp:111-171).
//
// What bounds it on the H100: bytes, 44 per pixel (the two f32x4
// accumulators read once, the f32x3 image written once, 0.0272 ms at
// 1080p), and nearly as much the arithmetic: ~100 FP32 operations and 12
// IEEE divides per pixel, which -fmad=false and bit-equality keep from
// being contracted or approximated. The design keeps everything between the
// read and the write in shared memory, in one launch at any frame size:
// - each block of 256 threads owns a 64 x 16 output tile, loads the tile and
//   its halo (3 | 3 columns, 4 | 3 rows) of both accumulators as float4s and
//   computes c once per pixel into shared memory (3 divides per pixel, not
//   one per tap);
// - the horizontal pass runs over the tile's 23 rows into shared memory, each
//   thread on a run of 4 outputs from three 16-byte shared loads per channel;
// - the vertical pass runs each thread down 4 rows of one column and writes
//   the f32x3 output. No scratch image goes through device memory.
// On the card the loads alone take about as long as the arithmetic and the
// stores alone (~0.031 and ~0.030 ms), and a block's phases overlap little
// with its neighbours' (PERF.md, the blur's findings): other tile shapes,
// more blocks per SM, loads hoisted ahead of the divides, and a persistent
// block that copies its next tile with cp.async while it computes (2 blocks
// per SM) all measured the same or slower.
// Out-of-frame halo entries hold 0, and 0 * w added to a sum that starts at
// +0 leaves it bit-identical, so the taps run unconditionally; the weight
// sums count only the taps inside the frame. The 15 weights are computed on
// the host in f32 exactly as the plain version computes them; taps are
// summed in the plain version's order, with IEEE divides and no
// multiply-add contraction (-fmad=false), so the output is bit-equal to the
// plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;           // output tile width
constexpr int TH = 16;           // output tile height
constexpr int BLOCK = 256;
constexpr int HALO_L = 3, HALO_R = 3;   // horizontal taps -3..3
constexpr int HALO_T = 4, HALO_B = 3;   // vertical taps -4..3
constexpr int CH = TH + HALO_T + HALO_B;  // 23 rows of c and of h
// c row j holds column x0 - 4 + j: the run of outputs x0 + 4q .. + 3 reads
// c columns 4q + 1 .. 4q + 10, inside the float4s at 4q, 4q + 4, 4q + 8
constexpr int CW = TW + 8;       // 72 columns, rows 16-byte aligned
constexpr int RUNS = TW / 4;     // runs of 4 outputs per row
constexpr int ROWS = TH * TW / BLOCK;  // rows per thread, vertical pass
static_assert(BLOCK % TW == 0 && ROWS * BLOCK == TH * TW, "vertical mapping");

struct BlurWeights {
  float h[7];  // taps -3..3
  float v[8];  // taps -4..3
};

// max(a, 0.001) that keeps a NaN, as torch.clamp_min and jnp.maximum do
__device__ __forceinline__ float albedo_floor(float a) {
  return a != a ? a : fmaxf(a, 0.001f);
}

__global__ void __launch_bounds__(BLOCK)
blur_kernel(const float4* __restrict__ lum, const float4* __restrict__ alb,
            float n_samples, BlurWeights w, int width, int height,
            float* __restrict__ out) {
  __shared__ __align__(16) float c_s[3][CH][CW];
  __shared__ __align__(16) float h_s[3][CH][TW];
  __shared__ float hsum_s[TW];   // horizontal weight sum per column
  __shared__ float vsum_s[TH];   // vertical weight sum per row
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;

  // 1. c over the tile and its halo (7 pixels a thread); 0 outside the
  // frame
#pragma unroll
  for (int u = 0; u < (CH * CW + BLOCK - 1) / BLOCK; ++u) {
    const int k = tid + u * BLOCK;
    if (k >= CH * CW) break;
    const int r = k / CW, j = k - r * CW;
    const int gy = y0 - HALO_T + r, gx = x0 - 4 + j;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width && j >= 1 &&
        j <= TW + HALO_L + HALO_R) {
      const size_t p = (size_t)gy * width + gx;
      const float4 l = lum[p];
      const float4 a = alb[p];
      c0 = (l.x / albedo_floor(a.x)) * n_samples;
      c1 = (l.y / albedo_floor(a.y)) * n_samples;
      c2 = (l.z / albedo_floor(a.z)) * n_samples;
    }
    c_s[0][r][j] = c0;
    c_s[1][r][j] = c1;
    c_s[2][r][j] = c2;
  }
  if (tid < TW) {
    float s = 0.0f;
    const int gx = x0 + tid;
#pragma unroll
    for (int t = 0; t < 7; ++t) {
      const int xs = gx + t - HALO_L;
      s = s + ((xs >= 0 && xs < width) ? w.h[t] : 0.0f);
    }
    hsum_s[tid] = s;
  } else if (tid < TW + TH) {
    float s = 0.0f;
    const int gy = y0 + tid - TW;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int ys = gy + t - HALO_T;
      s = s + ((ys >= 0 && ys < height) ? w.v[t] : 0.0f);
    }
    vsum_s[tid - TW] = s;
  }
  __syncthreads();

  // 2. horizontal pass over the CH rows: a thread per run of 4 outputs;
  // rows outside the frame give 0 (their c is 0)
  for (int k = tid; k < CH * RUNS; k += BLOCK) {
    const int r = k / RUNS, q = k - r * RUNS;
    const float s0 = hsum_s[4 * q], s1 = hsum_s[4 * q + 1],
                s2 = hsum_s[4 * q + 2], s3 = hsum_s[4 * q + 3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float4* row = reinterpret_cast<const float4*>(&c_s[ch][r][4 * q]);
      const float4 a = row[0], b = row[1], d = row[2];
      // c columns 4q .. 4q + 11 of this row; output m reads 1 + m .. 7 + m
      const float v[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                           b.z, b.w, d.x, d.y, d.z, d.w};
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < 7; ++t) {
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] = acc[m] + v[1 + m + t] * w.h[t];
      }
      *reinterpret_cast<float4*>(&h_s[ch][r][4 * q]) = make_float4(
          acc[0] / s0, acc[1] / s1, acc[2] / s2, acc[3] / s3);
    }
  }
  __syncthreads();

  // 3. vertical pass: a thread per column and ROWS consecutive rows
  const int x = tid % TW;
  const int r0 = (tid / TW) * ROWS;
  const int gx = x0 + x;
  if (gx >= width) return;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float v[ROWS + 7];
#pragma unroll
    for (int t = 0; t < ROWS + 7; ++t) v[t] = h_s[ch][r0 + t][x];
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int gy = y0 + r0 + m;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 8; ++t) acc = acc + v[m + t] * w.v[t];
      if (gy < height)
        out[((size_t)gy * width + gx) * 3 + ch] = acc / vsum_s[r0 + m];
    }
  }
}

}  // namespace

extern "C" int cpt_blur(const float* lum, const float* alb, float n_samples,
                        const float* weights15, int width, int height,
                        float* out, void* stream) {
  BlurWeights w;
  for (int k = 0; k < 7; ++k) w.h[k] = weights15[k];
  for (int k = 0; k < 8; ++k) w.v[k] = weights15[7 + k];
  const dim3 grid((width + TW - 1) / TW, (height + TH - 1) / TH);
  blur_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(lum), reinterpret_cast<const float4*>(alb),
      n_samples, w, width, height, out);
  return static_cast<int>(cudaGetLastError());
}
