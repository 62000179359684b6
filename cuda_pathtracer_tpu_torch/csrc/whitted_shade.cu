// Shading of one Whitted recursion level (models/raytracer.py), in two
// launches around the level's shadow traces.
//
// Replaces no TPU kernel: the JAX package shades a level with XLA-fused
// elementwise code inside its jitted frame. The port's plain version,
// models/raytracer.py::_shade_level, runs eagerly as ~220 PyTorch ops a
// level, each one kernel over at most 2x the pixels' lanes, so a depth-7
// frame spent most of its time launching them from the host while
// the card waited (PERF.md, section 5). A level's width changes every frame
// with the compaction's nonzero, so a CUDA graph cannot hold it.
//
//  * shade_pre (after the closest-hit trace), one thread a lane: the hit
//    point, material, normal, checkerboard and diffuse weight, and for each
//    point light the shadow ray (origin, direction, t_max, active), written
//    as [L, n] blocks so that each light's rays are one contiguous slice
//    for the any-hit trace.
//  * shade_post (after the shadow traces), one thread a lane: the same
//    surface again (recomputed, not stored: it is cheaper than a round trip
//    through device memory), the lights' direct terms in light order, the
//    sky or diffuse term added into out[pixel] with atomicAdd (index_add_
//    on the card is atomic too), the Fresnel reweighting, Beer absorption
//    and the refract and reflect children, written into 2n-row buffers in
//    the order of the plain version's cat (refract block, then reflect
//    block), and the level's shadow rays added into a device counter (one
//    atomic per warp).
//
// What bounds it on the H100: bytes. Per lane shade_pre streams the ray
// and its hit (37 bytes) and writes 29 bytes a light; shade_post streams
// the same 37, the weight and pixel (20 bytes) and a byte a light, reads
// and writes the frame's pixel (24 bytes) and writes 90 bytes of children.
// The data-dependent gathers of the world triangle's ids, the model
// triangle's normal and material and the instance's transform come mostly
// from L2 (sibenik's four triangle arrays are 3.95 MB). chip_smoke.py
// times both on sibenik's and outside's 1080p levels against that bound:
// shade_pre runs near it, shade_post, with its atomics, well below. The
// arithmetic (~300 FP32 operations a lane, a few IEEE divides and square
// roots, one expf) is far below the FP32 rate. The small tables
// (materials, spheres, planes, lights) are read through the read-only
// cache (__ldg): every lane of a block reads the same few rows, which stay
// in L1 after the first touch, and no table has a size the kernel must fit
// into shared memory.
//
// Rounding: every lane's outputs are bit-equal to the plain version's on
// the card. The file is built with -fmad=false (no multiply-add
// contraction), IEEE division and square root; each expression keeps the
// plain version's operation order (left-to-right products, (1 - transmit)
// - reflect, normalize with its 1e-12 clamp, vecmath.dot's (a0*b0 + a1*b1)
// + a2*b2), its float constants are the plain version's Python doubles
// rounded to float, clamp_min keeps a NaN as torch.clamp_min does, and the
// checkerboard truncates to int64 as .long() does. Only the frame's sums
// differ, by the order in which atomics add a pixel's lanes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PRIM_SPHERE = 1;  // ops/traverse.py
constexpr int PRIM_PLANE = 2;

// the plain version's Python constants, rounded to float as PyTorch rounds
// a scalar operand
constexpr float EPS = static_cast<float>(1e-3);           // constants.EPS
constexpr float TWO_EPS = static_cast<float>(2.0 * 1e-3);  // 2.0 * EPS
constexpr float NORMAL_EPS = static_cast<float>(1e-12);
constexpr float D2_MIN = static_cast<float>(1e-20);
constexpr float FRESNEL_MIN = static_cast<float>(1e-9);
constexpr float CHILD_MIN = static_cast<float>(1e-5);
constexpr float CHECKER_ODD = static_cast<float>(0.2);
constexpr float SKY_R = static_cast<float>(0.2);  // raytracer.SKY_COLOR
constexpr float SKY_G = static_cast<float>(0.3);
constexpr float SKY_B = static_cast<float>(0.6);

// The scene's arrays the shading reads (scene/device.py), row-major and
// contiguous, with their lengths.
struct Tables {
  const int* tri_gid;          // [WT] world triangle -> model triangle
  const int* tri_inst;         // [WT] world triangle -> instance
  const float* tri_normal;     // [T, 3]
  const int* tri_mat;          // [T]
  const float* inst_transform; // [I, 3, 4]
  const int* inst_mat;         // [I] (-1: no override)
  const float* mat_diffuse;    // [M, 3]
  const float* mat_transmit;   // [M]
  const float* mat_reflect;    // [M]
  const float* mat_ior;        // [M]
  const float* mat_absorption; // [M, 3]
  const float* sphere_pos;     // [S, 3]
  const int* sphere_mat;       // [S]
  const float* plane_normal;   // [P, 3]
  const int* plane_mat;        // [P]
  const float* light_pos;      // [L, 3]
  const float* light_color;    // [L, 3]
  int n_world, n_mats, n_spheres, n_planes, n_lights;
};

// The level's rays and their closest hits (ops/traverse.py::Hit).
struct Level {
  const float* ro;        // [n, 3]
  const float* rd;        // [n, 3]
  const float* t;         // [n]
  const int* prim_type;   // [n]
  const int* prim_id;     // [n]
  const uint8_t* hit;     // [n] intersected
  int n;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V3 where3(bool c, V3 a, V3 b) { return c ? a : b; }

__device__ __forceinline__ V3 load3(const float* p, size_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ V3 ldg3(const float* p, size_t i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ void store3(float* p, size_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// vecmath.dot
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// torch.clamp_min: a NaN stays NaN (fmaxf alone would drop it)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// vecmath.max_comp, NaN-propagating like torch.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float max_comp(V3 a) {
  return nan_max(nan_max(a.x, a.y), a.z);
}

// vecmath.normalize(a, eps=1e-12)
__device__ __forceinline__ V3 normalize(V3 a) {
  const float n = clamp_min(sqrtf(clamp_min(dot(a, a), 0.0f)), NORMAL_EPS);
  return a / n;
}

__device__ __forceinline__ int clampi(long long v, int lo, int hi) {
  return static_cast<int>(v < lo ? lo : (v > hi ? hi : v));
}

// What both launches know of a lane's hit (_shade_level up to its lights).
struct Surface {
  V3 pos;        // ro + t * rd
  V3 cn;         // collider normal: the normal, flipped to face the ray
  V3 diffuse_color;
  V3 absorption;
  float t, transmit, reflect, ior;
  float diffuse;  // (1 - transmit) - reflect
  bool live, inside;
};

__device__ Surface surface(const Tables& s, const Level& lv, int i) {
  Surface f;
  const V3 ro = load3(lv.ro, i);
  const V3 rd = load3(lv.rd, i);
  f.t = lv.t[i];
  f.live = lv.hit[i] != 0;
  const int ptype = lv.prim_type[i];
  const long long pid = max(lv.prim_id[i], 0);
  const int wt = static_cast<int>(min(pid, static_cast<long long>(s.n_world - 1)));
  const int gid = max(s.tri_gid[wt], 0);
  const int inst = max(s.tri_inst[wt], 0);
  const bool is_sphere = s.n_spheres > 0 && f.live && ptype == PRIM_SPHERE;
  const bool is_plane = s.n_planes > 0 && f.live && ptype == PRIM_PLANE;
  f.pos = ro + rd * f.t;

  const int over = __ldg(s.inst_mat + inst);
  int mid = over >= 0 ? over : s.tri_mat[gid];
  const int sph = is_sphere ? clampi(pid, 0, s.n_spheres - 1) : 0;
  const int pla = is_plane ? clampi(pid, 0, s.n_planes - 1) : 0;
  if (is_sphere) mid = __ldg(s.sphere_mat + sph);
  if (is_plane) mid = __ldg(s.plane_mat + pla);
  mid = clampi(mid, 0, s.n_mats - 1);
  f.diffuse_color = ldg3(s.mat_diffuse, mid);
  f.transmit = __ldg(s.mat_transmit + mid);
  f.reflect = __ldg(s.mat_reflect + mid);
  f.ior = __ldg(s.mat_ior + mid);
  f.absorption = ldg3(s.mat_absorption, mid);

  V3 normal;
  if (is_sphere) {
    normal = normalize(f.pos - ldg3(s.sphere_pos, sph));
  } else if (is_plane) {
    normal = ldg3(s.plane_normal, pla);
  } else {
    // vecmath.transform_dir: the instance's linear part times the normal
    const float* m = s.inst_transform + 12 * static_cast<size_t>(inst);
    const V3 tn = load3(s.tri_normal, gid);
    V3 w;
    w.x = (__ldg(m + 0) * tn.x + __ldg(m + 1) * tn.y) + __ldg(m + 2) * tn.z;
    w.y = (__ldg(m + 4) * tn.x + __ldg(m + 5) * tn.y) + __ldg(m + 6) * tn.z;
    w.z = (__ldg(m + 8) * tn.x + __ldg(m + 9) * tn.y) + __ldg(m + 10) * tn.z;
    normal = normalize(w);
  }
  f.inside = dot(rd, normal) > 0.0f;
  f.cn = where3(f.inside, -normal, normal);

  // checkerboard (raytracer.h:109-114): .long() truncates toward zero, and
  // the int64 sum's parity is its low bit (torch's % 2 == 0)
  if (is_plane) {
    const long long qx = static_cast<long long>(fabsf(f.pos.x * 0.25f));
    const long long qz = static_cast<long long>(fabsf(f.pos.z * 0.25f));
    const bool even = ((static_cast<unsigned long long>(qx) +
                        static_cast<unsigned long long>(qz)) & 1ull) == 0;
    f.diffuse_color = even ? V3{1.0f, 1.0f, 1.0f}
                           : V3{CHECKER_ODD, CHECKER_ODD, CHECKER_ODD};
  }
  f.diffuse = (1.0f - f.transmit) - f.reflect;
  return f;
}

// One point light's shadow ray from the light to the hit.
struct Shadow {
  V3 fl;       // unit direction from the light
  float d2;    // squared distance
  float dist;
  bool active;
};

__device__ __forceinline__ Shadow shadow_ray(const Surface& f, V3 lpos) {
  Shadow r;
  const V3 from_light = f.pos - lpos;
  const bool facing = dot(from_light, f.cn) < 0.0f;
  r.d2 = dot(from_light, from_light);
  r.dist = sqrtf(clamp_min(r.d2, D2_MIN));
  r.fl = from_light / r.dist;
  r.active = f.live && facing && f.diffuse > 0.0f;
  return r;
}

__global__ void __launch_bounds__(BLOCK)
shade_pre_kernel(Tables s, Level lv, float* __restrict__ sro,
                 float* __restrict__ sfl, float* __restrict__ tmax,
                 uint8_t* __restrict__ sact) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lv.n) return;
  const Surface f = surface(s, lv, i);
  for (int li = 0; li < s.n_lights; ++li) {
    const V3 lpos = ldg3(s.light_pos, li);
    const Shadow r = shadow_ray(f, lpos);
    const size_t k = static_cast<size_t>(li) * lv.n + i;
    store3(sro, k, lpos + r.fl * EPS);
    store3(sfl, k, r.fl);
    tmax[k] = r.dist - TWO_EPS;
    sact[k] = r.active;
  }
}

__global__ void __launch_bounds__(BLOCK)
shade_post_kernel(Tables s, Level lv, const float* __restrict__ weight,
                  const int64_t* __restrict__ pixel,
                  const uint8_t* __restrict__ occluded,
                  float* __restrict__ out,
                  unsigned long long* __restrict__ shadow_count,
                  float* __restrict__ ro2, float* __restrict__ rd2,
                  float* __restrict__ w2, int64_t* __restrict__ pixel2,
                  uint8_t* __restrict__ active2) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int n = lv.n;
  unsigned rays = 0;
  if (i < n) {
    const Surface f = surface(s, lv, i);
    const V3 rd = load3(lv.rd, i);
    const V3 w = load3(weight, i);
    const V3 zero = {0.0f, 0.0f, 0.0f};

    // point-light direct lighting with hard shadows (raytracer.h:120-137)
    V3 direct = zero;
    for (int li = 0; li < s.n_lights; ++li) {
      const Shadow r = shadow_ray(f, ldg3(s.light_pos, li));
      const bool lit =
          r.active && !occluded[static_cast<size_t>(li) * n + i];
      const float g = dot(-r.fl, f.cn) / r.d2;
      direct = direct + where3(lit, ldg3(s.light_color, li) * g, zero);
      rays += r.active;
    }
    const V3 wd = w * f.diffuse_color;
    const V3 contrib =
        where3(!f.live, w * V3{SKY_R, SKY_G, SKY_B}, zero) +
        where3(f.live && f.diffuse > 0.0f, wd * f.diffuse * direct, zero);
    float* px = out + 3 * pixel[i];
    atomicAdd(px, contrib.x);
    atomicAdd(px + 1, contrib.y);
    atomicAdd(px + 2, contrib.z);

    // Fresnel reweighting (raytracer.h:140-156; shading._refract)
    const float n1 = f.inside ? f.ior : 1.0f;
    const float n2 = f.inside ? 1.0f : f.ior;
    const float eta = n1 / clamp_min(n2, FRESNEL_MIN);
    const float costi = dot(f.cn, -rd);
    const float k = 1.0f - (eta * eta) * (1.0f - costi * costi);
    const bool tir = k < 0.0f;
    const V3 refr_d = normalize(
        rd * eta + f.cn * (eta * costi - sqrtf(clamp_min(k, 0.0f))));
    const float sinti = sqrtf(clamp_min((1.0f - costi) - costi, 0.0f));
    const float costt =
        sqrtf(clamp_min(1.0f - ((eta * eta) * sinti) * sinti, 0.0f));
    const float spol = (n1 * costi - n2 * costt) /
                       clamp_min(n1 * costi + n2 * costt, FRESNEL_MIN);
    const float ppol = (n1 * costt - n2 * costi) /
                       clamp_min(n1 * costt + n2 * costi, FRESNEL_MIN);
    const float refl_prob = tir ? 1.0f : (spol * spol + ppol * ppol) * 0.5f;

    const bool has_transmit = f.live && f.transmit > 0.0f;
    const float changed = has_transmit ? refl_prob : 0.0f;
    const float transmit_eff = f.transmit - changed;
    const float reflect_eff = f.reflect + changed;
    const V3 beer = f.inside ? V3{expf(-f.absorption.x * f.t),
                                  expf(-f.absorption.y * f.t),
                                  expf(-f.absorption.z * f.t)}
                             : V3{1.0f, 1.0f, 1.0f};
    const bool refract_active = has_transmit && transmit_eff > 0.0f;
    const V3 refract_w =
        where3(refract_active, wd * transmit_eff * beer, zero);

    // shading._reflect_ray: d - (2 dot(d, n)) n
    const V3 refl_d = rd - f.cn * (dot(rd, f.cn) * 2.0f);
    const bool reflect_active = f.live && reflect_eff > 0.0f;
    const V3 reflect_w = where3(reflect_active, wd * reflect_eff, zero);

    const int64_t p = pixel[i];
    store3(ro2, i, f.pos + refr_d * EPS);
    store3(rd2, i, refr_d);
    store3(w2, i, refract_w);
    pixel2[i] = p;
    active2[i] = refract_active && max_comp(refract_w) > CHILD_MIN;
    const size_t j = static_cast<size_t>(n) + i;
    store3(ro2, j, f.pos + refl_d * EPS);
    store3(rd2, j, refl_d);
    store3(w2, j, reflect_w);
    pixel2[j] = p;
    active2[j] = reflect_active && max_comp(reflect_w) > CHILD_MIN;
  }
  // the level's shadow rays: one atomic per warp (every lane of the warp
  // is here: the grid covers whole blocks)
  rays = __reduce_add_sync(FULL, rays);
  if ((threadIdx.x & 31) == 0 && rays)
    atomicAdd(shadow_count, static_cast<unsigned long long>(rays));
}

Tables tables_of(const void* const* p, const int* c) {
  Tables s;
  s.tri_gid = static_cast<const int*>(p[0]);
  s.tri_inst = static_cast<const int*>(p[1]);
  s.tri_normal = static_cast<const float*>(p[2]);
  s.tri_mat = static_cast<const int*>(p[3]);
  s.inst_transform = static_cast<const float*>(p[4]);
  s.inst_mat = static_cast<const int*>(p[5]);
  s.mat_diffuse = static_cast<const float*>(p[6]);
  s.mat_transmit = static_cast<const float*>(p[7]);
  s.mat_reflect = static_cast<const float*>(p[8]);
  s.mat_ior = static_cast<const float*>(p[9]);
  s.mat_absorption = static_cast<const float*>(p[10]);
  s.sphere_pos = static_cast<const float*>(p[11]);
  s.sphere_mat = static_cast<const int*>(p[12]);
  s.plane_normal = static_cast<const float*>(p[13]);
  s.plane_mat = static_cast<const int*>(p[14]);
  s.light_pos = static_cast<const float*>(p[15]);
  s.light_color = static_cast<const float*>(p[16]);
  s.n_world = c[0];
  s.n_mats = c[1];
  s.n_spheres = c[2];
  s.n_planes = c[3];
  s.n_lights = c[4];
  return s;
}

Level level_of(const void* const* p, int n) {
  return {static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
          static_cast<const float*>(p[2]), static_cast<const int*>(p[3]),
          static_cast<const int*>(p[4]), static_cast<const uint8_t*>(p[5]),
          n};
}

int grid_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// tables: the 17 arrays of Tables in its order; counts: WT, M, S, P, L.
// level: ro, rd, t, prim_type, prim_id, intersected. Outputs [L, n(, 3)].
extern "C" int cpt_whitted_shade_pre(const void* const* tables,
                                     const int* counts,
                                     const void* const* level, int n,
                                     float* sro, float* sfl, float* tmax,
                                     uint8_t* sact, void* stream) {
  shade_pre_kernel<<<grid_for(n), BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      tables_of(tables, counts), level_of(level, n), sro, sfl, tmax, sact);
  return static_cast<int>(cudaGetLastError());
}

// occluded: [L, n] intersected of the shadow traces; out: the frame
// [pixels, 3], added into; shadow_count: i64, added into. Children [2n].
extern "C" int cpt_whitted_shade_post(const void* const* tables,
                                      const int* counts,
                                      const void* const* level, int n,
                                      const float* weight,
                                      const int64_t* pixel,
                                      const uint8_t* occluded, float* out,
                                      long long* shadow_count, float* ro2,
                                      float* rd2, float* w2, int64_t* pixel2,
                                      uint8_t* active2, void* stream) {
  shade_post_kernel<<<grid_for(n), BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tables_of(tables, counts), level_of(level, n), weight, pixel, occluded,
      out, reinterpret_cast<unsigned long long*>(shadow_count), ro2, rd2, w2,
      pixel2, active2);
  return static_cast<int>(cudaGetLastError());
}
