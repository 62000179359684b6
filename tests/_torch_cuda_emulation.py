"""A CUDA source of the port's render library, run on the CPU.

``g++`` compiles the ``.cu`` file against a small header that stands in for
the CUDA runtime: a launch runs the grid's blocks in turn, each as one
``std::thread`` per CUDA thread; ``__syncthreads`` is a barrier of the
block; a warp vote, sum or shuffle goes through the block (two barriers), so it
holds only where every thread of the block reaches it together; the IEEE
intrinsics are the plain operators, compiled with ``-ffp-contract=off``.
The ``<<<...>>>`` launches and ``extern __shared__`` arrays are rewritten
before the compile. The library keeps the file's C entry points, so the
wrappers of ``ops/`` call it as they call the card's, which lets the CPU
tests hold a kernel's indexing and arithmetic to its plain version.
"""
import os
import re
import subprocess

from cuda_pathtracer_tpu_torch.ops import kernels

HEADER = r'''
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __restrict__
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaMemcpyDeviceToHost = 2,
       cudaDevAttrMaxSharedMemoryPerBlockOptin = 97,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr int EMU_SHARED_BYTES = 232448;  // an H100 block's opt-in maximum
struct EmuDim { unsigned x; };
static EmuDim blockIdx, gridDim;
static thread_local EmuDim threadIdx;
static std::barrier<>* emu_barrier;
static unsigned emu_words[1024];
static inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
static inline unsigned __ballot_sync(unsigned, bool p) {
  emu_words[threadIdx.x] = p;
  __syncthreads();
  unsigned m = 0, w = threadIdx.x & ~31u;
  for (int k = 0; k < 32; ++k) m |= (emu_words[w + k] ? 1u : 0u) << k;
  __syncthreads();
  return m;
}
static inline int __reduce_add_sync(unsigned, int v) {
  emu_words[threadIdx.x] = static_cast<unsigned>(v);
  __syncthreads();
  int s = 0;
  unsigned w = threadIdx.x & ~31u;
  for (int k = 0; k < 32; ++k) s += static_cast<int>(emu_words[w + k]);
  __syncthreads();
  return s;
}
static long long emu_longs[1024];
static inline long long __shfl_xor_sync(unsigned, long long v, int mask) {
  emu_longs[threadIdx.x] = v;
  __syncthreads();
  long long got = emu_longs[threadIdx.x ^ mask];
  __syncthreads();
  return got;
}
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline float __int_as_float(int i) {
  float f; std::memcpy(&f, &i, 4); return f; }
static inline uint32_t __float_as_uint(float f) {
  uint32_t i; std::memcpy(&i, &f, 4); return i; }
static inline cudaError_t cudaGetLastError() { return cudaSuccess; }
static inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
static inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = EMU_SHARED_BYTES; return cudaSuccess; }
template <class F> static inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess; }
static inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n,
                                          int, cudaStream_t) {
  std::memcpy(d, s, n); return cudaSuccess; }
static inline cudaError_t cudaStreamSynchronize(cudaStream_t) {
  return cudaSuccess; }
static void emu_launch(long grid, long block, const std::function<void()>& k) {
  gridDim.x = static_cast<unsigned>(grid);
  for (long b = 0; b < grid; ++b) {
    blockIdx.x = static_cast<unsigned>(b);
    std::barrier<> bar(block);
    emu_barrier = &bar;
    std::vector<std::thread> threads;
    for (long t = 0; t < block; ++t)
      threads.emplace_back([t, &k] {
        threadIdx.x = static_cast<unsigned>(t);
        k();
      });
    for (auto& th : threads) th.join();
  }
}
'''

_LAUNCH = re.compile(r'(\w+)\s*<<<(.*?)>>>\((.*?)\);', re.S)
_DYNAMIC = re.compile(r'extern __shared__ ([\w ]+?) (\w+)\[\];')


def _config(text: str) -> list:
    """The top-level comma-separated parts of a launch configuration."""
    parts, depth, cur = [], 0, ''
    for ch in text:
        depth += ch in '(<'
        depth -= ch in ')>'
        if ch == ',' and depth == 0:
            parts.append(cur.strip())
            cur = ''
        else:
            cur += ch
    return parts + [cur.strip()]


def translate(source: str) -> str:
    """The ``.cu`` source as C++ for the emulation header."""
    source = source.replace('#include <cuda_runtime.h>',
                            '#include "emulation.h"')
    source = _DYNAMIC.sub(
        lambda m: f'static {m[1]} {m[2]}[EMU_SHARED_BYTES / sizeof({m[1]})];',
        source)

    def launch(m):
        grid, block = _config(m[2])[:2]
        return (f'emu_launch({grid}, {block}, [&] {{ {m[1]}({m[3]}); }});')
    return _LAUNCH.sub(launch, source)


def build(cu_name: str, out_dir: str, signatures: dict):
    """``csrc/<cu_name>`` compiled for the CPU into ``out_dir`` and loaded
    with the given C entry points typed (``kernels.load``)."""
    with open(os.path.join(kernels.CSRC, cu_name)) as f:
        source = translate(f.read())
    with open(os.path.join(out_dir, 'emulation.h'), 'w') as f:
        f.write(HEADER)
    cpp = os.path.join(out_dir, cu_name.replace('.cu', '.cpp'))
    with open(cpp, 'w') as f:
        f.write(source)
    so = cpp[:-4] + '.so'
    res = subprocess.run(['g++', '-std=c++20', '-O1', '-ffp-contract=off',
                          '-fPIC', '-shared', '-o', so, cpp, '-lpthread'],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f'g++ failed on {cu_name}:\n{res.stderr}')
    return kernels.load(so, signatures)
