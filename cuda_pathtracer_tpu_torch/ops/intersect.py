"""Primitive intersection (counterpart of ``cuda_pathtracer_tpu/ops/intersect.py``;
the HYBRID intersection functions of src/kernels.h:120-200).

Every function broadcasts over leading batch axes. The BVH walks test
triangles inside the traversals (``ops/traverse_packet*.py``); here are the
spheres and planes, and :func:`ray_triangle` for shading's re-intersect of a
hit that came without barycentrics.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..constants import EPS


def ray_triangle(ro, rd, v0, v1, v2):
    """Moller-Trumbore (src/kernels.h:169-188) with the 1e-4 determinant
    cutoff. Shapes: ro/rd [..., 3]; v0/v1/v2 [..., 3]. Returns
    (hit bool[...], t, u, v)."""
    v0v1 = v1 - v0
    v0v2 = v2 - v0
    pvec = vm.cross(rd, v0v2)
    det = vm.dot(v0v1, pvec)
    small = torch.abs(det) < 1e-4
    inv_det = 1.0 / torch.where(small, torch.ones_like(det), det)
    tvec = ro - v0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, v0v1)
    v = vm.dot(rd, qvec) * inv_det
    t = vm.dot(v0v2, qvec) * inv_det
    hit = ~small & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > 0.0)
    return hit, t, u, v


def ray_sphere(ro, rd, center, radius):
    """src/kernels.h:120-135. Returns (hit, t)."""
    oc = ro - center
    a = vm.dot(rd, rd)
    b = 2.0 * vm.dot(rd, oc)
    c = vm.dot(oc, oc) - radius * radius
    det = b * b - 4.0 * a * c
    sdet = vm.sqrt(torch.clamp_min(det, 0.0))
    small_a = torch.abs(a) < 0.001
    denom = 2.0 * torch.where(small_a, torch.ones_like(a), a)
    tmin = (-b - sdet) / denom
    tmax = (-b + sdet) / denom
    t = torch.where(tmin < 0.0, tmax, tmin)
    hit = ~small_a & (det >= 0.0) & (tmax > 0.0)
    return hit, t


def ray_plane(ro, rd, normal, d):
    """src/kernels.h:137-143. Returns (hit, t)."""
    q = vm.dot(vm.normalize(rd), normal)
    small = torch.abs(q) < EPS
    qq = torch.where(small, torch.ones_like(q), q)
    t = -(vm.dot(ro, normal) + d) / qq
    hit = ~small & (t > 0.0)
    return hit, t


def safe_inv_dir(rd):
    """Reciprocal direction with tiny components clamped to +-1e-20, so the
    slab test never forms 0*inf."""
    tiny = 1e-20
    sign = torch.where(rd >= 0.0, 1.0, -1.0).to(rd.dtype)
    denom = torch.where(torch.abs(rd) < tiny, sign * tiny, rd)
    return 1.0 / denom
