"""Primitive intersection (counterpart of ``cuda_pathtracer_tpu/ops/intersect.py``;
the HYBRID intersection functions of src/kernels.h:120-200).

Every function broadcasts over leading batch axes. Triangles are tested inside
the traversal (``ops/traverse_packet2.py``); spheres and planes here.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from cuda_pathtracer_tpu.constants import EPS


def ray_sphere(ro, rd, center, radius):
    """src/kernels.h:120-135. Returns (hit, t)."""
    oc = ro - center
    a = vm.dot(rd, rd)
    b = 2.0 * vm.dot(rd, oc)
    c = vm.dot(oc, oc) - radius * radius
    det = b * b - 4.0 * a * c
    sdet = torch.sqrt(torch.clamp_min(det, 0.0))
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
