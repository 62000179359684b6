// Helpers shared by the probe kernels (probe_*.cu).
#pragma once

// min/max that propagate a NaN operand like jnp.minimum / torch.minimum: one
// PTX min.NaN / max.NaN each (fminf/fmaxf drop a NaN).
__device__ __forceinline__ float probe_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float probe_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
