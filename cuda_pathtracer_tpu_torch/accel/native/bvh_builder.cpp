// Native binned-SAH BVH builder (OpenMP-parallel).
//
// C++ implementation of the same algorithm as ../bvh.py (Wald 2007 binned
// SAH, K=16 bins, leaf cutoff <=4 with a median-split fallback so leaves are
// statically bounded) — the role of the reference's createBVHBinned
// (reference: src/bvhBuilder.h:35-274), written fresh. The top of the tree is
// split sequentially until enough independent subtrees exist, then subtrees
// build in parallel: node ids come from a shared atomic counter and each
// subtree owns a disjoint slice of the permutation array, so no locking is
// needed anywhere else. The resulting TREE (boxes, leaf contents, perm) is
// identical for any thread count — only node numbering differs — because
// every split depends only on its own slice's geometry.
//
// Memory design (the build is gather-bound, measured 27 ns/triangle-touch
// with split arrays): each triangle's box + centroid + bin id live in ONE
// 64-byte cache-line record, fetched once per touch via the permutation with
// software prefetch. The record stores (-lo, hi) and (-cen, cen) halves so
// a bin grow is a single 8-wide MAX per half (min(lo,x) == -max(-lo,-x),
// bitwise identical for IEEE min/max including signed zeros, so the tree
// matches the numpy builder exactly). Each WorkItem
// carries its exact centroid bounds, computed during the parent's binning as
// the union of per-bin centroid boxes (min/max over the same point set =>
// bit-identical to a rescan), so a node makes two passes over its slice
// (bin + partition), not three.
//
// Exposed via a C ABI for ctypes (see ../native.py), which compiles this file
// at first use with the flags named there.
//
// Output layout matches accel.bvh.BVHNodes: vmin/vmax [N,3] float32,
// left/leaf_start/leaf_count int32 (leaf_count > 0 marks a leaf), plus the
// triangle permutation applied by the build.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <cstdio>
#include <chrono>
#include <vector>
#include <algorithm>
#include <limits>
#ifdef _OPENMP
#include <omp.h>
#endif
#if defined(__SSE2__) || defined(_M_X64)
#include <immintrin.h>
#define BVH_SSE 1
#endif

namespace {

constexpr int K = 16;
constexpr int LEAF_SIZE = 4;
constexpr float FEPS = 1e-3f;
constexpr float INF = std::numeric_limits<float>::infinity();

// One vector of 4 floats; lane 3 is padding kept inert (+INF for mins,
// -INF for maxes, 0 for points) so SSE min/max over all 4 lanes never
// changes lanes 0-2.
struct alignas(16) F4 {
    float v[4];
#ifdef BVH_SSE
    inline __m128 m() const { return _mm_load_ps(v); }
    inline void set(__m128 x) { _mm_store_ps(v, x); }
#endif
    inline void mins(const F4& o) {
#ifdef BVH_SSE
        set(_mm_min_ps(m(), o.m()));
#else
        for (int j = 0; j < 4; j++) v[j] = std::min(v[j], o.v[j]);
#endif
    }
    inline void maxs(const F4& o) {
#ifdef BVH_SSE
        set(_mm_max_ps(m(), o.m()));
#else
        for (int j = 0; j < 4; j++) v[j] = std::max(v[j], o.v[j]);
#endif
    }
};

struct alignas(16) Box {
    F4 lo, hi;
    static Box insideOut() {
        return {{{INF, INF, INF, INF}}, {{-INF, -INF, -INF, -INF}}};
    }
    inline void grow(const Box& b) { lo.mins(b.lo); hi.maxs(b.hi); }
    inline void grow_pt(const F4& p) { lo.mins(p); hi.maxs(p); }
    float area() const {
        float dx = std::max(hi.v[0] - lo.v[0], 0.0f);
        float dy = std::max(hi.v[1] - lo.v[1], 0.0f);
        float dz = std::max(hi.v[2] - lo.v[2], 0.0f);
        return 2.0f * (dx * dy + dx * dz + dy * dz);
    }
};

// Negated-min box: f = [-lox,-loy,-loz,-INF, hix,hiy,hiz,-INF]. Growing by
// another NBox (or a point in the same form) is ONE 8-wide max; the -INF
// pads are max-identities so they never change. insideOut == all -INF.
struct alignas(32) NBox {
    float f[8];
    static NBox insideOut() {
        return {{-INF, -INF, -INF, -INF, -INF, -INF, -INF, -INF}};
    }
#ifdef __AVX__
    inline void grow(const NBox& o) {
        _mm256_store_ps(f, _mm256_max_ps(_mm256_load_ps(f),
                                         _mm256_load_ps(o.f)));
    }
#else
    inline void grow(const NBox& o) {
        for (int j = 0; j < 8; j++) f[j] = std::max(f[j], o.f[j]);
    }
#endif
    Box box() const {
        return {{{-f[0], -f[1], -f[2], INF}}, {{f[4], f[5], f[6], -INF}}};
    }
    float area() const {
        // same subtract as Box::area (hi - lo with lo == -f[j]) so the
        // float result is bitwise identical
        float dx = std::max(f[4] - (-f[0]), 0.0f);
        float dy = std::max(f[5] - (-f[1]), 0.0f);
        float dz = std::max(f[6] - (-f[2]), 0.0f);
        return 2.0f * (dx * dy + dx * dz + dy * dz);
    }
};

// One triangle's entire build payload in a single cache line:
// nbox = (-lo, hi), ncen = (-cen, cen) — both growable by 8-wide max.
struct alignas(64) TriRec {
    NBox nbox;
    NBox ncen;
    inline float cen(int axis) const { return ncen.f[4 + axis]; }
};
static_assert(sizeof(TriRec) == 64, "TriRec must be one cache line");

struct WorkItem {
    int64_t node, start, count;
    Box cen;              // exact centroid bounds of the slice
};

inline void prefetch(const void* p) {
#ifdef BVH_SSE
    _mm_prefetch((const char*)p, _MM_HINT_T0);
#else
    (void)p;
#endif
}

}  // namespace

extern "C" int64_t build_bvh_binned(
    int64_t n,
    const float* v0, const float* v1, const float* v2,
    float* out_vmin, float* out_vmax,
    int32_t* out_left, int32_t* out_leaf_start, int32_t* out_leaf_count,
    int32_t* out_perm) {
    if (n <= 0) return 0;

    const bool prof = std::getenv("BVH_PROF") != nullptr;
    double t_init = 0, t_bin = 0, t_part = 0, t_med = 0;
    int64_t n_bin = 0, n_part = 0, n_med = 0;
    auto now = [] {
        return std::chrono::duration<double>(
            std::chrono::steady_clock::now().time_since_epoch()).count();
    };
    double tstart = now();

    // one cache-line record per triangle, NOT zero-initialized (the init
    // loop writes every byte; a std::vector would memset 64 B/tri first)
    TriRec* rec = static_cast<TriRec*>(
        std::aligned_alloc(64, (size_t)n * sizeof(TriRec)));
    // bin id of the triangle at PERM POSITION i for the current split: the
    // bin pass writes it sequentially and the partition reads it
    // sequentially from both ends (swapped alongside out_perm), so the
    // partition does no gathers at all
    int8_t* bin_pos = static_cast<int8_t*>(std::malloc((size_t)n));
    if (!rec || !bin_pos) {
        std::free(rec);
        std::free(bin_pos);
        return 0;
    }

    NBox nroot = NBox::insideOut();
    NBox nroot_cen = NBox::insideOut();
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        NBox local = NBox::insideOut();
        NBox local_cen = NBox::insideOut();
#ifdef _OPENMP
#pragma omp for nowait
#endif
        for (int64_t i = 0; i < n; i++) {
            TriRec& t = rec[i];
#ifdef BVH_SSE
            if (i + 1 < n) {
                // 16-byte loads read one float past the 12-byte vertex —
                // safe everywhere except the last triangle (scalar below)
                __m128 a = _mm_loadu_ps(v0 + 3 * i);
                __m128 b = _mm_loadu_ps(v1 + 3 * i);
                __m128 c = _mm_loadu_ps(v2 + 3 * i);
                __m128 lo = _mm_min_ps(a, _mm_min_ps(b, c));
                __m128 hi = _mm_max_ps(a, _mm_max_ps(b, c));
                __m128 cen = _mm_mul_ps(_mm_set1_ps(0.333333f),
                                        _mm_add_ps(_mm_add_ps(a, b), c));
                const __m128 sgn = _mm_set1_ps(-0.0f);
                _mm_store_ps(t.nbox.f, _mm_xor_ps(lo, sgn));
                _mm_store_ps(t.nbox.f + 4, hi);
                _mm_store_ps(t.ncen.f, _mm_xor_ps(cen, sgn));
                _mm_store_ps(t.ncen.f + 4, cen);
                t.nbox.f[3] = -INF;
                t.nbox.f[7] = -INF;
                t.ncen.f[3] = -INF;
                t.ncen.f[7] = -INF;
            } else
#endif
            {
                for (int j = 0; j < 3; j++) {
                    float a = v0[3 * i + j], b = v1[3 * i + j],
                          c = v2[3 * i + j];
                    float lo = std::min(a, std::min(b, c));
                    float hi = std::max(a, std::max(b, c));
                    float cen = 0.333333f * ((a + b) + c);
                    t.nbox.f[j] = -lo;
                    t.nbox.f[4 + j] = hi;
                    t.ncen.f[j] = -cen;
                    t.ncen.f[4 + j] = cen;
                }
                t.nbox.f[3] = -INF;
                t.nbox.f[7] = -INF;
                t.ncen.f[3] = -INF;
                t.ncen.f[7] = -INF;
            }
            local.grow(t.nbox);
            local_cen.grow(t.ncen);
            out_perm[i] = (int32_t)i;
        }
#ifdef _OPENMP
#pragma omp critical
#endif
        {
            nroot.grow(local);
            nroot_cen.grow(local_cen);
        }
    }
    const Box root = nroot.box();
    const Box root_cen = nroot_cen.box();
    if (prof) t_init = now() - tstart;

    auto set_box = [&](int64_t idx, const Box& b) {
        out_vmin[3 * idx] = b.lo.v[0];
        out_vmin[3 * idx + 1] = b.lo.v[1];
        out_vmin[3 * idx + 2] = b.lo.v[2];
        out_vmax[3 * idx] = b.hi.v[0];
        out_vmax[3 * idx + 1] = b.hi.v[1];
        out_vmax[3 * idx + 2] = b.hi.v[2];
    };
    auto make_leaf = [&](int64_t idx, int64_t start, int64_t count) {
        out_leaf_start[idx] = (int32_t)start;
        out_leaf_count[idx] = (int32_t)count;
        out_left[idx] = 0;
    };

    set_box(0, root);
    std::atomic<int64_t> node_count{1};

    // median-split fallback when SAH bails with count > LEAF_SIZE; children's
    // centroid bounds need a rescan here (rare path)
    auto median_split = [&](std::vector<WorkItem>& stack, int64_t idx,
                            int64_t start, int64_t count, int axis) {
        double tm0 = prof ? now() : 0;
        int32_t* b = out_perm + start;
        std::nth_element(b, b + count / 2, b + count,
                         [&](int32_t a, int32_t c) {
                             return rec[a].cen(axis) < rec[c].cen(axis);
                         });
        const int64_t lcnt = count / 2;
        const int64_t c1 = node_count.fetch_add(2);
        const int64_t c2 = c1 + 1;
        NBox lb = NBox::insideOut(), rb = NBox::insideOut();
        NBox lcen = NBox::insideOut(), rcen = NBox::insideOut();
        for (int64_t i = start; i < start + lcnt; i++) {
            lb.grow(rec[out_perm[i]].nbox);
            lcen.grow(rec[out_perm[i]].ncen);
        }
        for (int64_t i = start + lcnt; i < start + count; i++) {
            rb.grow(rec[out_perm[i]].nbox);
            rcen.grow(rec[out_perm[i]].ncen);
        }
        set_box(c1, lb.box());
        set_box(c2, rb.box());
        out_left[idx] = (int32_t)c1;
        out_leaf_count[idx] = 0;
        out_leaf_start[idx] = 0;
        if (prof) { t_med += now() - tm0; n_med += count; }
        stack.push_back({c2, start + lcnt, count - lcnt, rcen.box()});
        stack.push_back({c1, start, lcnt, lcen.box()});
    };

    // One SAH split step; pushes children onto `stack` (or makes a leaf).
    // `scratch_perm`/`scratch_bin` are caller-owned slice-sized buffers for
    // the branchless partition (per-thread in the parallel phase).
    auto step = [&](std::vector<WorkItem>& stack, const WorkItem& w,
                    std::vector<int32_t>& scratch_perm,
                    std::vector<int8_t>& scratch_bin) {
        const int64_t idx = w.node, start = w.start, count = w.count;

        if (count <= LEAF_SIZE) { make_leaf(idx, start, count); return; }

        const Box& cen = w.cen;
        float ext[3];
        for (int j = 0; j < 3; j++) ext[j] = cen.hi.v[j] - cen.lo.v[j];
        int axis = 2;
        if (ext[0] > ext[1] && ext[0] > ext[2]) axis = 0;
        else if (ext[1] > ext[0] && ext[1] > ext[2]) axis = 1;
        const float bmin = cen.lo.v[axis], bmax = cen.hi.v[axis];
        if (bmax - bmin < K * FEPS) {
            median_split(stack, idx, start, count, axis);
            return;
        }

        NBox nbins[K];
        NBox ncbins[K];         // per-bin centroid bounds -> child bounds
        int64_t bin_counts[K] = {0};
        for (int k = 0; k < K; k++) {
            nbins[k] = NBox::insideOut();
            ncbins[k] = NBox::insideOut();
        }
        const float bin_fac = K * (1.0f - FEPS) / (bmax - bmin);
        double tb0 = prof ? now() : 0;
        constexpr int64_t PF = 12;
        for (int64_t i = start; i < start + count; i++) {
            if (i + PF < start + count) prefetch(&rec[out_perm[i + PF]]);
            TriRec& t = rec[out_perm[i]];
            int b = (int)((t.cen(axis) - bmin) * bin_fac);
            if (b < 0) b = 0;
            if (b >= K) b = K - 1;
            bin_pos[i] = (int8_t)b;
            bin_counts[b]++;
            nbins[b].grow(t.nbox);
            ncbins[b].grow(t.ncen);
        }
        if (prof) { t_bin += now() - tb0; n_bin += count; }

        Box parent_box;
        {
            const float* mn = out_vmin + 3 * idx;
            const float* mx = out_vmax + 3 * idx;
            parent_box = {{{mn[0], mn[1], mn[2], INF}},
                          {{mx[0], mx[1], mx[2], -INF}}};
        }
        const double inv_parent =
            1.0 / std::max((double)parent_box.area(), 1e-30);

        // cost-only sweep in NBox space (one 8-wide max per grow; the area
        // uses the same float subtracts as Box::area so costs — and hence
        // min_k — are bit-identical to the Box-space scan)
        double left_cost[K], right_cost[K];
        NBox lb = NBox::insideOut(), rb = NBox::insideOut();
        int64_t lc = 0, rc = 0;
        for (int k = 0; k < K; k++) {
            left_cost[k] = lc ? lc * lb.area() * inv_parent : 0.0;
            lb.grow(nbins[k]);
            lc += bin_counts[k];
            rb.grow(nbins[K - k - 1]);
            rc += bin_counts[K - k - 1];
            right_cost[K - k - 1] = rc * rb.area() * inv_parent;
        }

        double min_sah = (double)count;
        int min_k = -1;
        for (int k = 0; k < K; k++) {
            double sah = left_cost[k] + right_cost[k] + FEPS;
            if (sah < min_sah) { min_sah = sah; min_k = k; }
        }
        if (min_k <= 0) {
            median_split(stack, idx, start, count, axis);
            return;
        }
        int64_t bin_lcnt = 0;
        for (int k = 0; k < min_k; k++) bin_lcnt += bin_counts[k];

        // branchless STABLE partition: the classic two-pointer swap loop
        // pays ~one branch misprediction per element (the side predicate is
        // data-random); instead copy the slice out and replay it with a
        // cmov-indexed store — both sides fill forward, so relative order is
        // preserved on each side (stable) and all writes are sequential.
        // NOTE: the resulting perm ORDER differs from a swap partition;
        // leaf/slice SETS and every split are identical, but anything keyed
        // on triangle order (the light-list order feeding NEE's random light
        // pick) draws a statistically-identical, bitwise-different sequence —
        // golden locks were regenerated when this landed.
        double tp0 = prof ? now() : 0;
        {
            int64_t lpos = start, rpos = start + bin_lcnt;
            std::memcpy(scratch_perm.data(), out_perm + start,
                        count * sizeof(int32_t));
            std::memcpy(scratch_bin.data(), bin_pos + start, count);
            for (int64_t i = 0; i < count; i++) {
                const int32_t v = scratch_perm[i];
                const int8_t b = scratch_bin[i];
                const bool goL = b < min_k;
                const int64_t pos = goL ? lpos : rpos;
                out_perm[pos] = v;
                bin_pos[pos] = b;
                lpos += goL;
                rpos += !goL;
            }
        }
        const int64_t lcnt = bin_lcnt;
        if (prof) { t_part += now() - tp0; n_part += count; }
        if (lcnt == 0 || lcnt == count) {
            median_split(stack, idx, start, count, axis);
            return;
        }

        // children's boxes and centroid bounds: union of the per-bin boxes
        // on each side of the cut — the same min/max over the same points as
        // a rescan of the child slice, so bit-identical
        NBox lbox = NBox::insideOut(), rbox = NBox::insideOut();
        NBox lcen = NBox::insideOut(), rcen = NBox::insideOut();
        for (int k = 0; k < min_k; k++) lbox.grow(nbins[k]);
        for (int k = min_k; k < K; k++) rbox.grow(nbins[k]);
        for (int k = 0; k < min_k; k++) lcen.grow(ncbins[k]);
        for (int k = min_k; k < K; k++) rcen.grow(ncbins[k]);

        const int64_t c1 = node_count.fetch_add(2);
        const int64_t c2 = c1 + 1;
        set_box(c1, lbox.box());
        set_box(c2, rbox.box());
        out_left[idx] = (int32_t)c1;
        out_leaf_count[idx] = 0;
        out_leaf_start[idx] = 0;
        stack.push_back({c2, start + lcnt, count - lcnt, rcen.box()});
        stack.push_back({c1, start, lcnt, lcen.box()});
    };

    auto build_subtree = [&](WorkItem item) {
        std::vector<WorkItem> stack;
        stack.reserve(128);
        std::vector<int32_t> scratch_perm(item.count);
        std::vector<int8_t> scratch_bin(item.count);
        stack.push_back(item);
        while (!stack.empty()) {
            WorkItem w = stack.back();
            stack.pop_back();
            step(stack, w, scratch_perm, scratch_bin);
        }
    };

    auto dump_prof = [&] {
        std::fprintf(stderr,
            "BVH_PROF init=%.3fs bin=%.3fs(%lldM) part=%.3fs(%lldM) "
            "med=%.3fs(%lldM)\n",
            t_init, t_bin, (long long)(n_bin / 1000000),
            t_part, (long long)(n_part / 1000000),
            t_med, (long long)(n_med / 1000000));
    };

#ifdef _OPENMP
    const int threads = omp_get_max_threads();
#else
    const int threads = 1;
#endif
    if (threads <= 1 || n < 1 << 16) {
        build_subtree({0, 0, n, root_cen});
        if (prof) dump_prof();
        std::free(rec);
        std::free(bin_pos);
        return node_count.load();
    }

    // sequential top: split until enough independent subtrees exist
    const int64_t want = (int64_t)threads * 8;
    std::vector<WorkItem> frontier{{0, 0, n, root_cen}};
    std::vector<WorkItem> ready;
    while (!frontier.empty() &&
           (int64_t)(frontier.size() + ready.size()) < want) {
        // split the largest frontier item
        size_t big = 0;
        for (size_t i = 1; i < frontier.size(); i++)
            if (frontier[i].count > frontier[big].count) big = i;
        WorkItem w = frontier[big];
        frontier.erase(frontier.begin() + big);
        if (w.count <= LEAF_SIZE * 8) { ready.push_back(w); continue; }
        std::vector<WorkItem> children;
        std::vector<int32_t> top_sp(w.count);
        std::vector<int8_t> top_sb(w.count);
        step(children, w, top_sp, top_sb);
        for (const auto& c : children) frontier.push_back(c);
        if (children.empty()) { /* became a leaf */ }
    }
    for (const auto& w : frontier) ready.push_back(w);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int64_t i = 0; i < (int64_t)ready.size(); i++) {
        build_subtree(ready[i]);
    }

    if (prof) dump_prof();
    std::free(rec);
    std::free(bin_pos);
    return node_count.load();
}
