// Separable luminance Gaussian of the film's blurred display.
//
// Replaces the Pallas TPU kernel cuda_pathtracer_tpu/ops/blur_pallas.py
// `_blur_kernel` (called from `blur_luminance_pallas`). The TPU kernel held a
// whole color plane in VMEM, which capped it at 640x640 frames; here two
// launches stream the frame at any size: a horizontal pass (7 taps, -3..3)
// from the accumulators into a scratch image the wrapper allocates, then a
// vertical pass (8 taps, -4..3) into the output. Each tap is skipped outside
// the frame and the weights of the taps taken are renormalised, as the
// reference's gauss_horz / gauss_vert shaders do (main.cpp:111-171).
//
// The 15 weights exp(-i*i*0.5*spread)/sqrt(2*pi) are computed on the host in
// f32 exactly as the plain version computes them and passed by value.
// Taps are summed in the same order as the plain version and the file is
// built without multiply-add contraction, so the two agree to rounding.
//
// Bound on the H100: memory bandwidth (two f32x4 accumulators read, one
// f32x3 scratch written and read, one f32x3 output written: ~80 B/pixel).
// Neighbouring threads read neighbouring pixels; the taps' re-reads hit L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct BlurWeights {
  float h[7];  // taps -3..3
  float v[8];  // taps -4..3
};

__global__ void blur_h_kernel(const float* __restrict__ lum,
                              const float* __restrict__ alb, float n_samples,
                              BlurWeights w, int width, int height,
                              float* __restrict__ tmp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width || y >= height) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
  for (int k = 0; k < 7; ++k) {
    const int xs = x + k - 3;
    if (xs < 0 || xs >= width) continue;
    const size_t p = (size_t)y * width + xs;
    for (int c = 0; c < 3; ++c) {
      const float cv = (lum[4 * p + c] / fmaxf(alb[4 * p + c], 0.001f)) * n_samples;
      acc[c] = acc[c] + cv * w.h[k];
    }
    wsum = wsum + w.h[k];
  }
  const size_t q = (size_t)y * width + x;
  for (int c = 0; c < 3; ++c) tmp[3 * q + c] = acc[c] / wsum;
}

__global__ void blur_v_kernel(const float* __restrict__ tmp, BlurWeights w,
                              int width, int height, float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width || y >= height) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
  for (int k = 0; k < 8; ++k) {
    const int ys = y + k - 4;
    if (ys < 0 || ys >= height) continue;
    const size_t p = (size_t)ys * width + x;
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + tmp[3 * p + c] * w.v[k];
    wsum = wsum + w.v[k];
  }
  const size_t q = (size_t)y * width + x;
  for (int c = 0; c < 3; ++c) out[3 * q + c] = acc[c] / wsum;
}

}  // namespace

extern "C" int cpt_blur(const float* lum, const float* alb, float n_samples,
                        const float* weights15, int width, int height,
                        float* tmp, float* out, void* stream) {
  BlurWeights w;
  for (int k = 0; k < 7; ++k) w.h[k] = weights15[k];
  for (int k = 0; k < 8; ++k) w.v[k] = weights15[7 + k];
  const int block = 256;
  const dim3 grid((width + block - 1) / block, height);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blur_h_kernel<<<grid, block, 0, s>>>(lum, alb, n_samples, w, width, height, tmp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blur_v_kernel<<<grid, block, 0, s>>>(tmp, w, width, height, out);
  return static_cast<int>(cudaGetLastError());
}
