// The lanes of each Whitted recursion level (models/raytracer.py): the
// primary rays of level 0, and the compaction of a level's children into
// the next level's lanes.
//
// Replaces no TPU kernel: the JAX package forms its levels with XLA code
// inside its jitted frame (camera.generate_rays_simple, raytracer._compact).
// The port's plain versions, raytracer._rays_plain and raytracer._compact,
// run eagerly as ~50 PyTorch ops for the rays (three of which wait for the
// card: two 0-d divisors and the camera's up vector copied to it) and ~15
// a compaction (a nonzero that waits for the card, a stable weight sort on
// ordered levels, six gathers), so a 640x480 depth-7 frame spent ~4.5 ms of
// host time issuing them while the card waited (PERF.md, section 5).
//
//  * primary_rays_kernel, one thread a pixel: the camera basis, the pixel's
//    point on the screen, the barrel distortion and the normalised
//    direction, in exactly the plain version's operation order; it writes
//    the level-0 lanes (origin, direction, weight 1, pixel), zeroes the
//    frame and the levels' shadow-ray counters. The camera is read on the
//    card, so nothing is copied to it and nothing waits.
//  * count_kernel, then scatter_kernel: an order-preserving stream
//    compaction of the active lanes in tiles of TILE lanes. The first pass
//    counts each tile's active lanes; the second sums the counts of the
//    tiles before its own, ranks its lanes with warp ballots and writes
//    each active lane to its packed row, and its last block writes the
//    count, which the host reads back through pinned memory (the level's
//    one wait). On a level whose lanes keep their order the pass writes the
//    lanes themselves; on a level that the JAX package cuts by weight it
//    writes one 64-bit key a lane instead: the high word the lane's max
//    component of weight mapped to a falling order, the low word its index.
//    The keys are unique, so their ascending order (as signed integers, as
//    torch.sort orders them) is exactly the plain version's stable
//    argsort(-score) over the active lanes.
//  * sort_gather_kernel: up to cpt_whitted_sort_capacity() keys (8,192:
//    1,024 threads of 8 keys, 64 KB of shared memory) a block sorts them
//    by a bitonic network, in registers, by warp shuffles and, across
//    warps, through shared memory, then gathers the lanes of its slice of
//    the first `kept` positions, all in the one launch. Every block sorts
//    the same keys, so that the gather, whose loads are scattered, runs on
//    as many SMs as there are slices. Above the capacity PyTorch sorts the
//    keys and gather_kernel gathers.
//
// What bounds it on the H100: not bytes or operations but launches, the
// host's wait for the count and, on ordered levels, the sort's latency. A
// compaction moves at most ~45 bytes a kept lane and reads one byte
// (active) and, on ordered levels, 12 bytes of weight a lane; at 640x480
// that is well under a microsecond of HBM time a level. The bitonic sort
// takes ~log2(n)^2 / 2 dependent stages on one SM: 15.5 us for 2,048 keys
// and 52.6 us for 8,192 with the gather, against 38.0 and 86.2 us for
// torch.sort and gather_kernel (chip_smoke.py's sweep_sorts, H100).
//
// Rounding: the rays are bit-equal to camera.generate_rays_simple on the
// card. The file is built with -fmad=false and every operation is written
// with its IEEE intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn) in
// the plain version's order: vecmath.dot's (a0*b0 + a1*b1) + a2*b2, the
// cross products term by term with the up vector (0, 1, 0) multiplied out
// as PyTorch does, and each Python-float scalar rounded to float where
// PyTorch rounds it (width / height and 2 * width / height in double,
// then to float; 0.2; 1e-4). The compaction moves bits and does no
// arithmetic.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;
// the compaction's tiles: SCAN_ITEMS rounds of BLOCK consecutive lanes
constexpr int SCAN_ITEMS = 16;
constexpr int TILE = BLOCK * SCAN_ITEMS;
constexpr int WARPS = BLOCK / 32;
// the sort in a block: keys a thread holds, threads at most, and so the
// fewest keys it sorts (one warp's)
constexpr int SORT_ITEMS = 8;
constexpr int SORT_THREADS = 1024;
constexpr int SORT_MIN = 32 * SORT_ITEMS;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s)};
}
__device__ __forceinline__ V3 divide(V3 a, float s) {
  return {__fdiv_rn(a.x, s), __fdiv_rn(a.y, s), __fdiv_rn(a.z, s)};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                   __fmul_rn(a.z, b.z));
}
// vecmath.cross: (ay bz - az by, az bx - ax bz, ax by - ay bx)
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}
// torch.clamp_min keeps a NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
// vecmath.length: sqrt(clamp_min(dot(a, a), 0))
__device__ __forceinline__ float length(V3 a) {
  return __fsqrt_rn(clamp_min(dot(a, a), 0.0f));
}
__device__ __forceinline__ V3 normalize(V3 a) { return divide(a, length(a)); }
__device__ __forceinline__ V3 load3(const float* p, size_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, size_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// camera.generate_rays_simple for pixel (x, y), with basis and _distort.
__global__ void primary_rays_kernel(const float* __restrict__ eye_p,
                                    const float* __restrict__ view_p,
                                    const float* __restrict__ d_p, int width,
                                    int height, float ar, float two_ar,
                                    int max_depth, float* __restrict__ ro,
                                    float* __restrict__ rd,
                                    float* __restrict__ weight,
                                    int64_t* __restrict__ pixel,
                                    float* __restrict__ out,
                                    long long* __restrict__ shadow) {
  const int64_t n = static_cast<int64_t>(width) * height;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i < max_depth) shadow[i] = 0;
  if (i >= n) return;
  const V3 eye = {__ldg(eye_p), __ldg(eye_p + 1), __ldg(eye_p + 2)};
  const V3 view = {__ldg(view_p), __ldg(view_p + 1), __ldg(view_p + 2)};
  const float d = __ldg(d_p);

  // basis (camera.py): center = eye + d view; u, v from the up vector
  const V3 center = add(eye, scale(view, d));
  const V3 up = {0.0f, 1.0f, 0.0f};
  const V3 u = normalize(cross(up, view));
  const V3 v = normalize(cross(view, u));
  const V3 lt = sub(sub(center, scale(u, ar)), v);
  const V3 su = scale(u, two_ar);
  const V3 sv = scale(v, 2.0f);

  // generate_rays_simple: the pixel fractions divide exactly (vecmath.div)
  const float xf = __fdiv_rn(static_cast<float>(i % width),
                             static_cast<float>(width));
  const float yf = __fdiv_rn(static_cast<float>(i / width),
                             static_cast<float>(height));
  const V3 p = add(add(lt, scale(su, xf)), scale(sv, yf));

  // _distort: r -> r + 0.2 r^3 about the view center
  const V3 from_center = sub(p, center);
  const float r = length(from_center);
  const float r3 = __fmul_rn(__fmul_rn(__fmul_rn(0.2f, r), r), r);
  const float k = __fdiv_rn(__fadd_rn(r, r3), clamp_min(r, 1e-4f));
  const V3 point = add(center, scale(from_center, k));
  const V3 dir = normalize(sub(point, eye));

  store3(ro, i, eye);
  store3(rd, i, dir);
  store3(weight, i, V3{1.0f, 1.0f, 1.0f});
  store3(out, i, V3{0.0f, 0.0f, 0.0f});
  pixel[i] = i;
}

// The sum of v over the block (BLOCK threads); every thread gets it.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// Each tile's active lanes.
__global__ void count_kernel(const uint8_t* __restrict__ active, int m,
                             int* __restrict__ tile_counts) {
  __shared__ int scratch[WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  int c = 0;
#pragma unroll
  for (int r = 0; r < SCAN_ITEMS; ++r) {
    const int64_t i = base + r * BLOCK;
    c += i < m && active[i];
  }
  c = block_sum(c, scratch);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = c;
}

// The lane's score, max_comp(w), as the high word of a key that sorts
// ascending, as a signed 64-bit integer (torch.sort's order), in falling
// score: zeros of either sign tie, NaN comes last. The low word is the
// lane's index, so keys are unique and ties keep lane order.
__device__ __forceinline__ long long falling_key(V3 w, unsigned lane) {
  // vecmath.max_comp: torch.maximum, which keeps a NaN
  float s = fmaxf(fmaxf(w.x, w.y), w.z);
  if (w.x != w.x || w.y != w.y || w.z != w.z) s = __int_as_float(0x7fc00000);
  const uint32_t b = s == 0.0f ? 0u : __float_as_uint(s);
  // rising: unsigned order of the scores; its complement falls
  const uint32_t rising = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const uint32_t falling = s != s ? 0xffffffffu : ~rising;
  // flipping the top bit turns unsigned order into signed order
  return static_cast<long long>(
      (static_cast<unsigned long long>(falling ^ 0x80000000u) << 32) | lane);
}

// The active lanes to their packed rows, in lane order: the lanes
// themselves (keys null) or one key a lane. The last block writes the
// count.
__global__ void scatter_kernel(const uint8_t* __restrict__ active, int m,
                               const int* __restrict__ tile_counts,
                               const float* __restrict__ ro,
                               const float* __restrict__ rd,
                               const float* __restrict__ w,
                               const int64_t* __restrict__ pixel,
                               float* __restrict__ ro2, float* __restrict__ rd2,
                               float* __restrict__ w2,
                               int64_t* __restrict__ pixel2,
                               long long* __restrict__ keys,
                               int* __restrict__ count) {
  __shared__ int scratch[WARPS];
  __shared__ int warp_counts[WARPS];
  int before = 0;
  for (int t = threadIdx.x; t < static_cast<int>(blockIdx.x); t += BLOCK)
    before += tile_counts[t];
  int at = block_sum(before, scratch);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  for (int r = 0; r < SCAN_ITEMS; ++r) {
    const int64_t i = base + r * BLOCK;
    const bool a = i < m && active[i];
    const unsigned votes = __ballot_sync(FULL, a);
    if (lane == 0) warp_counts[warp] = __popc(votes);
    __syncthreads();
    int ahead = 0, total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const int c = warp_counts[k];
      ahead += k < warp ? c : 0;
      total += c;
    }
    if (a) {
      const size_t pos = static_cast<size_t>(at + ahead +
                                             __popc(votes & below));
      if (keys) {
        keys[pos] = falling_key(load3(w, i), static_cast<unsigned>(i));
      } else {
        store3(ro2, pos, load3(ro, i));
        store3(rd2, pos, load3(rd, i));
        store3(w2, pos, load3(w, i));
        pixel2[pos] = pixel[i];
      }
    }
    at += total;
    __syncthreads();
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *count = at;
}

__device__ __forceinline__ void gather_lane(
    size_t j, unsigned lane, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ w,
    const int64_t* __restrict__ pixel, float* __restrict__ ro2,
    float* __restrict__ rd2, float* __restrict__ w2,
    int64_t* __restrict__ pixel2) {
  store3(ro2, j, load3(ro, lane));
  store3(rd2, j, load3(rd, lane));
  store3(w2, j, load3(w, lane));
  pixel2[j] = pixel[lane];
}

// The sort: a bitonic network over p keys (a power of two of at least
// SORT_MIN), SORT_ITEMS of them in each thread's registers (thread t holds
// positions [SORT_ITEMS t, SORT_ITEMS t + SORT_ITEMS)). A stage whose pairs
// lie in one thread runs in its registers, one whose pairs lie in one warp
// by shuffles, and only the stages across warps go through shared memory,
// laid out by register slot (position SORT_ITEMS t + a at a * threads + t,
// so a warp's accesses hit distinct banks).

// The pair (x at position i, its partner y at i ^ j) of the stage (k, j):
// the lower position keeps the smaller key where the run is rising.
__device__ __forceinline__ long long bitonic_keep(long long x, long long y,
                                                  int i, int j, int k) {
  const bool rising = (i & k) == 0;
  const bool lower = (i & j) == 0;
  return (lower == rising) == (x < y) ? x : y;
}

template <int J>
__device__ __forceinline__ void thread_stage(long long (&r)[SORT_ITEMS],
                                             int base, int k) {
#pragma unroll
  for (int a = 0; a < SORT_ITEMS; ++a) {
    if (a & J) continue;
    const long long x = r[a], y = r[a | J];
    r[a] = bitonic_keep(x, y, base + a, J, k);
    r[a | J] = bitonic_keep(y, x, base + (a | J), J, k);
  }
}

// Each block: the n keys sorted (padded to p with keys that sort last),
// then the lanes of its `rows` of the first `kept` positions gathered, a
// thread a row. Every block sorts the same keys: the gather, whose loads
// are scattered, then runs on as many SMs as there are blocks.
__global__ void __launch_bounds__(SORT_THREADS)
    sort_gather_kernel(const long long* __restrict__ keys, int n, int p,
                       int kept, int rows, const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ w,
                       const int64_t* __restrict__ pixel,
                       float* __restrict__ ro2, float* __restrict__ rd2,
                       float* __restrict__ w2, int64_t* __restrict__ pixel2) {
  extern __shared__ long long s[];
  const int threads = p / SORT_ITEMS;
  const int t = threadIdx.x;
  const int base = t * SORT_ITEMS;
  long long r[SORT_ITEMS];
  // the pads sort after every key (whose low word is below 2^31)
#pragma unroll
  for (int a = 0; a < SORT_ITEMS; ++a)
    r[a] = base + a < n ? keys[base + a] : LLONG_MAX;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32 * SORT_ITEMS) {
#pragma unroll
        for (int a = 0; a < SORT_ITEMS; ++a) s[a * threads + t] = r[a];
        __syncthreads();
        const int partner = t ^ (j / SORT_ITEMS);
#pragma unroll
        for (int a = 0; a < SORT_ITEMS; ++a)
          r[a] = bitonic_keep(r[a], s[a * threads + partner], base + a, j, k);
        __syncthreads();
      } else if (j >= SORT_ITEMS) {
        const int lanes = j / SORT_ITEMS;
#pragma unroll
        for (int a = 0; a < SORT_ITEMS; ++a)
          r[a] = bitonic_keep(r[a], __shfl_xor_sync(FULL, r[a], lanes),
                              base + a, j, k);
      } else if (j == 4) {
        thread_stage<4>(r, base, k);
      } else if (j == 2) {
        thread_stage<2>(r, base, k);
      } else {
        thread_stage<1>(r, base, k);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < SORT_ITEMS; ++a) s[a * threads + t] = r[a];
  __syncthreads();
  const int first = blockIdx.x * rows;
  const int last = min(first + rows, kept);
  for (int i = first + t; i < last; i += threads) {
    const long long key = s[(i % SORT_ITEMS) * threads + i / SORT_ITEMS];
    gather_lane(i, static_cast<unsigned>(key), ro, rd, w, pixel, ro2, rd2,
                w2, pixel2);
  }
}

// The lanes of the first `kept` sorted keys, one thread a lane.
__global__ void gather_kernel(const long long* __restrict__ sorted,
                              int kept, const float* __restrict__ ro,
                              const float* __restrict__ rd,
                              const float* __restrict__ w,
                              const int64_t* __restrict__ pixel,
                              float* __restrict__ ro2, float* __restrict__ rd2,
                              float* __restrict__ w2,
                              int64_t* __restrict__ pixel2) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j < kept)
    gather_lane(j, static_cast<unsigned>(sorted[j]), ro, rd, w, pixel, ro2,
                rd2, w2, pixel2);
}

int tiles(int m) { return (m + TILE - 1) / TILE; }

}  // namespace

// The level-0 lanes of a width x height frame: ro, rd, weight f32[B, 3],
// pixel i64[B]; out f32[B, 3] and shadow i64[max_depth] zeroed. eye,
// view f32[3] and d f32[] on the card; ar and two_ar are width / height and
// 2 * width / height rounded to float.
extern "C" int cpt_whitted_primary_rays(const float* eye, const float* view,
                                        const float* d, int width, int height,
                                        float ar, float two_ar, int max_depth,
                                        float* ro, float* rd, float* weight,
                                        int64_t* pixel, float* out,
                                        long long* shadow, void* stream) {
  const int64_t n = static_cast<int64_t>(width) * height;
  const int64_t threads = n > max_depth ? n : max_depth;
  const int grid = static_cast<int>((threads + BLOCK - 1) / BLOCK);
  primary_rays_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      eye, view, d, width, height, ar, two_ar, max_depth, ro, rd, weight,
      pixel, out, shadow);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of m lanes (TILE each), for the size of tile_counts.
extern "C" int cpt_whitted_lanes_tiles(int m) { return tiles(m); }

// tile_counts: i32[tiles(m)], written.
extern "C" int cpt_whitted_lanes_count(const uint8_t* active, int m,
                                       int* tile_counts, void* stream) {
  count_kernel<<<tiles(m), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      active, m, tile_counts);
  return static_cast<int>(cudaGetLastError());
}

// The active lanes packed into ro2, rd2, w2 [m, 3] and pixel2 [m] (keys
// null), or their keys into keys [m] (the four outputs null); the count
// into count i32[1].
extern "C" int cpt_whitted_lanes_scatter(
    const uint8_t* active, int m, const int* tile_counts, const float* ro,
    const float* rd, const float* w, const int64_t* pixel, float* ro2,
    float* rd2, float* w2, int64_t* pixel2, long long* keys,
    int* count, void* stream) {
  scatter_kernel<<<tiles(m), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      active, m, tile_counts, ro, rd, w, pixel, ro2, rd2, w2, pixel2, keys,
      count);
  return static_cast<int>(cudaGetLastError());
}

// Copy the count to host memory (pinned, so the copy is the stream's own)
// and wait for it: the compaction's one wait for the card.
extern "C" int cpt_whitted_lanes_read_count(const int* count, int* host,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemcpyAsync(host, count, sizeof(int), cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(s));
}

// The most keys the one-block sort takes on the current device: the
// largest power of two whose keys fit its shared memory, and its threads.
extern "C" int cpt_whitted_sort_capacity() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  int p = SORT_MIN;
  while (2 * p * static_cast<int>(sizeof(long long)) <= bytes &&
         2 * p <= SORT_ITEMS * SORT_THREADS)
    p *= 2;
  return p;
}

// The n keys sorted in a block (n at most cpt_whitted_sort_capacity()),
// the lanes of the first kept gathered, `rows` of them by each block.
extern "C" int cpt_whitted_sort_gather(const long long* keys, int n,
                                       int kept, int rows, const float* ro,
                                       const float* rd, const float* w,
                                       const int64_t* pixel, float* ro2,
                                       float* rd2, float* w2, int64_t* pixel2,
                                       void* stream) {
  int p = SORT_MIN;
  while (p < n) p *= 2;
  const int smem = p * static_cast<int>(sizeof(long long));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sort_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sort_gather_kernel<<<(kept + rows - 1) / rows, p / SORT_ITEMS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      keys, n, p, kept, rows, ro, rd, w, pixel, ro2, rd2, w2, pixel2);
  return static_cast<int>(cudaGetLastError());
}

// The lanes of the first kept of the sorted keys.
extern "C" int cpt_whitted_gather(const long long* sorted, int kept,
                                  const float* ro, const float* rd,
                                  const float* w, const int64_t* pixel,
                                  float* ro2, float* rd2, float* w2,
                                  int64_t* pixel2, void* stream) {
  gather_kernel<<<(kept + BLOCK - 1) / BLOCK, BLOCK, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      sorted, kept, ro, rd, w, pixel, ro2, rd2, w2, pixel2);
  return static_cast<int>(cudaGetLastError());
}
