// Per-lane dependent row fetches from a small table, by a one-hot product on
// the tensor cores or by a direct load: the Hopper counterpart of three
// Pallas probes of tools/ that asked whether a per-lane row gather through
// the TPU's matrix unit (out = onehot(cur) @ tab) could drive a per-lane walk:
//   tools/pallas_probe_onehot.py:63   T = 64 steps per lane (make_kernel,
//                                     :32-57; step :38-48): row = tab[cur],
//                                     acc += row[1], cur = (int(row[0]) * 7 +
//                                     step + 1) % N; f32 or bf16 table
//   tools/pallas_probe_onehot2.py:74  P chains in flight per grid cell
//   tools/pallas_probe_onehot3.py:68  W lane groups per grid cell
// On Hopper P chains and W groups are the same thing, more independent
// chains per warp, and run the same kernel. A block is one grid cell of the
// probe: 128 lanes, times P chains.
//
// Path (a), mma: 8 warps; warp w owns lanes 16w..16w+15 as the 16 rows of an
// m16n8k16 A fragment, built in registers from the lanes' indices (1.0 where
// the column is the lane's row). The table, laid out by the wrapper in
// B-fragment order (piece, 8-column strip, 16-row k-tile, 32 lanes x 4 bf16),
// streams through shared memory in chunks of 32 k-tiles; each k-tile's B
// fragment feeds one mma.sync per chain. The product runs over the full
// 128-wide row (16 strips), because the probe prices a row fetch; columns 0
// and 1 of strip 0 carry the chain. Exactness: a bf16 table is one piece;
// an f32 table is three bf16 pieces (hi + mid + lo = the f32 value exactly),
// each in its own f32 accumulator (one product of 1.0 and zeros: exact),
// summed on the CUDA cores as (hi + mid) + lo, which is exact too. TF32 would
// drop bits: the payload column holds integers up to 2^24.
// Path (b), ldg: one thread per lane and chain loads the lane's whole row
// (16-byte vectors; columns 0 and 1 come from the first).
// Both paths give the plain version's bits.
//
// Bound on the H100: the function moves the table once, the starts and the
// outputs, and does ~4 operations per lane-step, so its bound is bytes
// (microseconds). Path (a) does 2 x N x 128 x pieces multiply-adds per lane
// and step, priced at the 989 TFLOP/s dense bf16 tensor rate; path (b) is
// bound by its dependent load latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;       // lanes per chain and grid cell
constexpr int kStrips = 16;       // 128 columns / 8
constexpr int kChunk = 32;        // k-tiles staged per chunk

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 1.0 in the low / high half of a .b32 register where the offset
// (row index - this thread's first column) is 0 / 1
__device__ __forceinline__ uint32_t one_hot_pair(int off) {
  return (off == 0 ? 0x3F80u : 0u) | (off == 1 ? 0x3F800000u : 0u);
}

template <int P, int NP>
__global__ void __launch_bounds__(256)
onehot_mma_kernel(const uint2* __restrict__ frag, const int* __restrict__ starts,
                  int* __restrict__ out_cur, float* __restrict__ out_acc,
                  int n_rows, int steps) {
  __shared__ uint2 tile[NP][kChunk][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int quad0 = lane & ~3;
  const int k_tiles = n_rows / 16;
  const int cell = blockIdx.x;
  const int r0 = warp * 16 + g;   // this thread's two A rows (lanes)
  const int r1 = r0 + 8;

  int cur[P][2];
  float acc[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int* s = starts + ((long long)cell * P + p) * kLanes;
    cur[p][0] = s[r0];
    cur[p][1] = s[r1];
    acc[p][0] = 0.f;
    acc[p][1] = 0.f;
  }

  for (int step = 0; step < steps; ++step) {
    float col0[P][2], col1[P][2];
    for (int strip = 0; strip < kStrips; ++strip) {
      float d[P][NP][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int pc = 0; pc < NP; ++pc)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[p][pc][e] = 0.f;
      for (int c0 = 0; c0 < k_tiles; c0 += kChunk) {
        const int kch = min(kChunk, k_tiles - c0);
        __syncthreads();   // the previous chunk is no longer read
        for (int e = threadIdx.x; e < NP * kch * 32; e += blockDim.x) {
          const int pc = e / (kch * 32);
          const int rem = e - pc * kch * 32;
          tile[pc][rem >> 5][rem & 31] =
              frag[(((long long)pc * kStrips + strip) * k_tiles + c0) * 32 + rem];
        }
        __syncthreads();
        for (int kk = 0; kk < kch; ++kk) {
          const int kbase = (c0 + kk) * 16 + tig * 2;
          uint2 b[NP];
#pragma unroll
          for (int pc = 0; pc < NP; ++pc) b[pc] = tile[pc][kk][lane];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int o0 = cur[p][0] - kbase;
            const int o1 = cur[p][1] - kbase;
            const uint32_t a0 = one_hot_pair(o0);
            const uint32_t a1 = one_hot_pair(o1);
            const uint32_t a2 = one_hot_pair(o0 - 8);
            const uint32_t a3 = one_hot_pair(o1 - 8);
#pragma unroll
            for (int pc = 0; pc < NP; ++pc)
              mma_bf16(d[p][pc], a0, a1, a2, a3, b[pc].x, b[pc].y);
          }
        }
      }
      if (strip == 0) {
        // thread tig 0 of each quad holds columns 0 and 1 of rows r0 and r1
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = d[p][0][e];
            if (NP == 3) v[e] = (v[e] + d[p][1][e]) + d[p][2][e];
            v[e] = __shfl_sync(0xffffffffu, v[e], quad0);
          }
          col0[p][0] = v[0];
          col1[p][0] = v[1];
          col0[p][1] = v[2];
          col1[p][1] = v[3];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[p][h] = acc[p][h] + col1[p][h];
        cur[p][h] = ((int)col0[p][h] * 7 + step + 1) % n_rows;
      }
  }
  if (tig == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long base = ((long long)cell * P + p) * kLanes;
      out_cur[base + r0] = cur[p][0];
      out_cur[base + r1] = cur[p][1];
      out_acc[base + r0] = acc[p][0];
      out_acc[base + r1] = acc[p][1];
    }
  }
}

// one 16-byte load that the compiler must keep (the rest of the row)
__device__ __forceinline__ void keep_load(const void* ptr) {
  uint32_t x, y, z, w;
  asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(x), "=r"(y), "=r"(z), "=r"(w)
               : "l"(ptr));
}

template <int P, bool BF16>
__global__ void __launch_bounds__(kLanes)
onehot_ldg_kernel(const void* __restrict__ tab, const int* __restrict__ starts,
                  int* __restrict__ out_cur, float* __restrict__ out_acc,
                  int n_rows, int steps) {
  constexpr int kRowBytes = kLanes * (BF16 ? 2 : 4);
  const char* base = static_cast<const char*>(tab);
  const int lane = threadIdx.x;
  const int cell = blockIdx.x;
  int cur[P];
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    cur[p] = starts[((long long)cell * P + p) * kLanes + lane];
    acc[p] = 0.f;
  }
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const char* row = base + (long long)cur[p] * kRowBytes;
      float c0, c1;
      if (BF16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
        c0 = __uint_as_float(v.x << 16);
        c1 = __uint_as_float(v.x & 0xFFFF0000u);
      } else {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row));
        c0 = v.x;
        c1 = v.y;
      }
      for (int o = 16; o < kRowBytes; o += 16) keep_load(row + o);
      acc[p] = acc[p] + c1;
      cur[p] = ((int)c0 * 7 + step + 1) % n_rows;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long i = ((long long)cell * P + p) * kLanes + lane;
    out_cur[i] = cur[p];
    out_acc[i] = acc[p];
  }
}

template <int P>
int launch(int path, int bf16, const void* tab, const int* starts, int* out_cur,
           float* out_acc, int n_rows, int n_cells, int steps, cudaStream_t st) {
  if (path == 0) {
    if (bf16)
      onehot_mma_kernel<P, 1><<<n_cells, 256, 0, st>>>(
          static_cast<const uint2*>(tab), starts, out_cur, out_acc, n_rows, steps);
    else
      onehot_mma_kernel<P, 3><<<n_cells, 256, 0, st>>>(
          static_cast<const uint2*>(tab), starts, out_cur, out_acc, n_rows, steps);
  } else {
    if (bf16)
      onehot_ldg_kernel<P, true><<<n_cells, kLanes, 0, st>>>(
          tab, starts, out_cur, out_acc, n_rows, steps);
    else
      onehot_ldg_kernel<P, false><<<n_cells, kLanes, 0, st>>>(
          tab, starts, out_cur, out_acc, n_rows, steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// path 0 (mma): tab is the B-fragment-ordered bf16 table, [pieces, 16,
// n_rows / 16, 32, 4] with 1 piece for a bf16 table and 3 for an f32 one.
// path 1 (ldg): tab is the [n_rows, 128] table itself, bf16 or f32.
// starts, out_cur (int32) and out_acc (f32) are [n_cells, chains, 128];
// n_rows is a multiple of 16; chains is 1, 2, 4 or 8.
extern "C" int cpt_probe_onehot(int path, int bf16, const void* tab,
                                const int* starts, int* out_cur, float* out_acc,
                                int n_rows, int n_cells, int chains, int steps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_rows < 16 || n_rows % 16 != 0 || n_cells < 1 || steps < 0)
    return (int)cudaErrorInvalidValue;
  switch (chains) {
    case 1: return launch<1>(path, bf16, tab, starts, out_cur, out_acc, n_rows, n_cells, steps, st);
    case 2: return launch<2>(path, bf16, tab, starts, out_cur, out_acc, n_rows, n_cells, steps, st);
    case 4: return launch<4>(path, bf16, tab, starts, out_cur, out_acc, n_rows, n_cells, steps, st);
    case 8: return launch<8>(path, bf16, tab, starts, out_cur, out_acc, n_rows, n_cells, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
