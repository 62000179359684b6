"""The reference's ray queries: a binary BVH over the world triangles, built
by Morton order on the device, walked per ray with a stack; spheres and
planes tested against every ray.

Semantics (src/kernels.h:120-200, 286-320): spheres, then planes, give a
ray its first ``t`` (the lowest index wins a tie); a triangle takes the hit
only with a ``t`` strictly below it, Moller-Trumbore with the 1e-4
determinant cut-off, ``0 < t``; among triangles an exact tie goes to the
lowest triangle index. A shadow query asks whether anything lies in
``(0, t_max)``.

The tree: triangles sorted by the Morton code of their centroids, leaves
of 4 consecutive triangles, a complete binary tree over the leaves (node
``n``'s children ``2n + 1`` and ``2n + 2``). Boxes are padded by a
millionth of the scene's extent, so rounding in the slab test never loses
a triangle.
"""
from __future__ import annotations

import torch

LEAF = 4
STACK = 64
DET_EPS = 1e-4
T_MAX = 9999999.0
EPS = 1e-3


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _spread_bits(x):
    """10-bit integers -> every third bit of a 30-bit code."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


class Tree:
    """The BVH of triangles ``v0``, ``v1``, ``v2`` (f32[N, 3], one device)."""

    def __init__(self, v0, v1, v2):
        dev = v0.device
        n = v0.shape[0]
        lo = torch.minimum(torch.minimum(v0, v1), v2)
        hi = torch.maximum(torch.maximum(v0, v1), v2)
        c = (lo + hi) * 0.5
        cmin, cmax = c.amin(0), c.amax(0)
        q = ((c - cmin) / torch.clamp_min(cmax - cmin, 1e-30) * 1023.0)
        q = q.clamp(0, 1023).long()
        code = ((_spread_bits(q[:, 0]) << 2) | (_spread_bits(q[:, 1]) << 1)
                | _spread_bits(q[:, 2]))
        order = torch.argsort(code, stable=True)
        n_leaves = -(-n // LEAF)
        p = 1
        while p < n_leaves:
            p *= 2
        self.first_leaf = p - 1
        tri = torch.full((p * LEAF,), -1, dtype=torch.int64, device=dev)
        tri[:n] = order
        self.leaf_tri = tri.view(p, LEAF)
        inf = torch.tensor(float('inf'), device=dev)
        blo = torch.where(tri[:, None] >= 0, lo[tri.clamp_min(0)], inf)
        bhi = torch.where(tri[:, None] >= 0, hi[tri.clamp_min(0)], -inf)
        level = (blo.view(p, LEAF, 3).amin(1), bhi.view(p, LEAF, 3).amax(1))
        levels = [level]
        while level[0].shape[0] > 1:
            a, b = level
            level = (torch.minimum(a[0::2], a[1::2]),
                     torch.maximum(b[0::2], b[1::2]))
            levels.append(level)
        pad = 1e-6 * float((hi.amax(0) - lo.amin(0)).max()) + 1e-6
        self.box_lo = torch.cat([lv[0] for lv in reversed(levels)]) - pad
        self.box_hi = torch.cat([lv[1] for lv in reversed(levels)]) + pad
        # a node over padding alone has no box and is never entered
        self.box_ok = (self.box_lo <= self.box_hi).all(-1)
        self.v0 = v0
        self.e1 = v1 - v0
        self.e2 = v2 - v0

    def _slab(self, nodes, o, inv, t_best):
        """(hit, entry t) of boxes ``nodes`` for rays ``o``/``inv``."""
        a = (self.box_lo[nodes] - o) * inv
        b = (self.box_hi[nodes] - o) * inv
        tmin = torch.minimum(a, b).amax(-1)
        tmax = torch.maximum(a, b).amin(-1)
        tmin = torch.clamp_min(tmin, 0.0)
        return self.box_ok[nodes] & (tmax >= tmin) & (tmin <= t_best), tmin

    def query(self, ro, rd, t_init, active, any_hit: bool):
        """Walk every active ray. Closest hit: (t, triangle index or -1) of
        the nearest triangle with ``t < t_init``; any hit: bool, a triangle
        with ``0 < t < t_init``."""
        dev = ro.device
        r = ro.shape[0]
        best_t = t_init.clone()
        best = torch.full((r,), -1, dtype=torch.int64, device=dev)
        tiny = torch.where(rd >= 0, 1e-20, -1e-20)
        inv = 1.0 / torch.where(rd.abs() < 1e-20, tiny, rd)
        stack_n = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
        stack_t = torch.zeros((r, STACK), dtype=torch.float32, device=dev)
        sp = torch.zeros(r, dtype=torch.int64, device=dev)
        root = torch.zeros(r, dtype=torch.int64, device=dev)
        hit0, t0 = self._slab(root, ro, inv, best_t)
        start = active & hit0
        stack_t[:, 0] = t0
        sp[start] = 1
        while True:
            idx = torch.nonzero(sp > 0).squeeze(1)
            if idx.numel() == 0:
                break
            top = sp[idx] - 1
            node = stack_n[idx, top]
            keep = stack_t[idx, top] <= best_t[idx]
            sp[idx] = top
            idx, node = idx[keep], node[keep]
            leaf = node >= self.first_leaf

            li = idx[leaf]
            if li.numel():
                tri = self.leaf_tri[node[leaf] - self.first_leaf]    # [M, 4]
                ok_tri = tri >= 0
                tc = tri.clamp_min(0)
                o, d = ro[li][:, None], rd[li][:, None]
                e1, e2 = self.e1[tc], self.e2[tc]
                h = _cross(d, e2)
                a = _dot(e1, h)
                small = a.abs() < DET_EPS
                f = 1.0 / torch.where(small, torch.ones_like(a), a)
                s = o - self.v0[tc]
                u = f * _dot(s, h)
                qv = _cross(s, e1)
                v = f * _dot(d, qv)
                t = f * _dot(e2, qv)
                ok = (ok_tri & ~small & (u >= 0) & (u <= 1) & (v >= 0)
                      & (u + v <= 1) & (t > 0) & (t <= best_t[li][:, None]))
                if any_hit:
                    ok &= t < t_init[li][:, None]
                    done = li[ok.any(1)]
                    best[done] = 0
                    sp[done] = 0
                else:
                    tt = torch.where(ok, t, torch.full_like(t, float('inf')))
                    lt = tt.amin(1)
                    big = torch.iinfo(torch.int64).max
                    lid = torch.where(ok & (tt == lt[:, None]), tri,
                                      torch.full_like(tri, big)).amin(1)
                    cur_t, cur = best_t[li], best[li]
                    won = ok.any(1) & ((lt < cur_t) | (
                        (lt == cur_t) & (cur >= 0) & (lid < cur)))
                    # a tie with the first t (a sphere's or a plane's, or
                    # t_init) stays theirs: a triangle needs t < t_init
                    won &= lt < t_init[li]
                    best_t[li[won]] = lt[won]
                    best[li[won]] = lid[won]

            ii = idx[~leaf]
            if ii.numel():
                n = node[~leaf]
                o, iv, bt = ro[ii], inv[ii], best_t[ii]
                h1, t1 = self._slab(2 * n + 1, o, iv, bt)
                h2, t2 = self._slab(2 * n + 2, o, iv, bt)
                # push the far child first, so the near one is walked first
                near_first = t1 <= t2
                far_n = torch.where(near_first, 2 * n + 2, 2 * n + 1)
                far_t = torch.where(near_first, t2, t1)
                near_n = torch.where(near_first, 2 * n + 1, 2 * n + 2)
                near_t = torch.where(near_first, t1, t2)
                far_h = torch.where(near_first, h2, h1)
                near_h = torch.where(near_first, h1, h2)
                for hit, nn, tn in ((far_h, far_n, far_t),
                                    (near_h, near_n, near_t)):
                    rr = ii[hit]
                    stack_n[rr, sp[rr]] = nn[hit]
                    stack_t[rr, sp[rr]] = tn[hit]
                    sp[rr] += 1
        if any_hit:
            return best >= 0
        return best_t, best


def spheres_planes(sc: dict, ro, rd, t_init):
    """Every sphere, then every plane, against every ray (kernels.h:120-143,
    286-320): (t, kind 0 none / 1 sphere / 2 plane, index)."""
    r = ro.shape[0]
    dev = ro.device
    t = t_init.clone()
    kind = torch.zeros(r, dtype=torch.int64, device=dev)
    index = torch.zeros(r, dtype=torch.int64, device=dev)
    for k in range(sc['sphere_pos'].shape[0]):
        oc = ro - sc['sphere_pos'][k]
        a = _dot(rd, rd)
        b = 2.0 * _dot(rd, oc)
        c = _dot(oc, oc) - sc['sphere_radius'][k] * sc['sphere_radius'][k]
        det = b * b - 4.0 * a * c
        sdet = torch.sqrt(torch.clamp_min(det, 0.0))
        small = a.abs() < 0.001
        den = 2.0 * torch.where(small, torch.ones_like(a), a)
        t_lo, t_hi = (-b - sdet) / den, (-b + sdet) / den
        ts = torch.where(t_lo < 0.0, t_hi, t_lo)
        better = ~small & (det >= 0.0) & (t_hi > 0.0) & (ts < t)
        t = torch.where(better, ts, t)
        kind = torch.where(better, 1, kind)
        index = torch.where(better, k, index)
    for k in range(sc['plane_normal'].shape[0]):
        nrm = sc['plane_normal'][k]
        dn = rd / torch.sqrt(torch.clamp_min(_dot(rd, rd), 0.0))[:, None]
        q = _dot(dn, nrm.expand_as(dn))
        small = q.abs() < EPS
        ts = -(_dot(ro, nrm.expand_as(ro)) + sc['plane_d'][k]) / torch.where(
            small, torch.ones_like(q), q)
        better = ~small & (ts > 0.0) & (ts < t)
        t = torch.where(better, ts, t)
        kind = torch.where(better, 2, kind)
        index = torch.where(better, k, index)
    return t, kind, index
