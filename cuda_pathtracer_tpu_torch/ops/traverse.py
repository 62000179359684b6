"""The ``Hit`` contract and the analytic-primitive prepass (counterpart of
``cuda_pathtracer_tpu/ops/traverse.py``).

Spheres and planes are brute-forced before the tree walk, like
traverseTopLevel (src/kernels.h:286-320); the triangle walk itself is
``ops/traverse_packet2.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import intersect as isect
from ..constants import T_MAX

# primitive type tags (reference PRIMITIVE_TYPE, src/types.h:296)
PRIM_TRIANGLE = 0
PRIM_SPHERE = 1
PRIM_PLANE = 2

_NO_INDEX = 2 ** 30


class Hit(NamedTuple):
    t: torch.Tensor            # f32[B]
    prim_type: torch.Tensor    # i32[B] (valid only when hit)
    prim_id: torch.Tensor      # i32[B] world triangle / sphere / plane index
    intersected: torch.Tensor  # bool[B]
    # barycentrics of the winning triangle (closest-hit traces with
    # want_uv); None otherwise
    u: torch.Tensor | None = None
    v: torch.Tensor | None = None


def _fold(hit, ts, t, ptype, pid, found, tag: int):
    """Merge the closest of one primitive family ([B, K] tests) into the
    running best; ties go to the lowest index."""
    better = hit & (ts < t[..., None])
    ts_m = torch.where(better, ts, torch.full_like(ts, T_MAX))
    bt = torch.amin(ts_m, dim=-1)
    k = torch.arange(ts.shape[-1], dtype=torch.int32, device=ts.device)
    j = torch.amin(torch.where(ts_m == bt[..., None], k,
                               torch.full_like(k, _NO_INDEX)), dim=-1)
    got = torch.any(better, dim=-1)
    return (torch.where(got, bt, t),
            torch.where(got, torch.full_like(ptype, tag), ptype),
            torch.where(got, j, pid),
            found | got)


def _primitives_prepass(scene, ro, rd, t_init):
    """Brute-force spheres and planes (src/kernels.h:286-320).
    Returns (t, prim_type, prim_id, found)."""
    B = ro.shape[:-1]
    dev = ro.device
    t = t_init
    ptype = torch.zeros(B, dtype=torch.int32, device=dev)
    pid = torch.full(B, -1, dtype=torch.int32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    if scene.sphere_pos.shape[0] > 0:
        hit, ts = isect.ray_sphere(ro[..., None, :], rd[..., None, :],
                                   scene.sphere_pos, scene.sphere_radius)
        t, ptype, pid, found = _fold(hit, ts, t, ptype, pid, found, PRIM_SPHERE)
    if scene.plane_normal.shape[0] > 0:
        hit, ts = isect.ray_plane(ro[..., None, :], rd[..., None, :],
                                  scene.plane_normal, scene.plane_d)
        t, ptype, pid, found = _fold(hit, ts, t, ptype, pid, found, PRIM_PLANE)
    return t, ptype, pid, found
