// The probe library's error string, so that checking a probe launch needs
// no other library (tools/probe_kernels.py::check).
#include <cuda_runtime.h>

extern "C" const char* cpt_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
