"""Rays and primitives that stress the sphere/plane prepass, and the trace
as the port ran it before the prepass and the merge became kernels (the
plain route the card tests hold ``dispatch.trace`` to).

The primitives (numpy, f32) put exact ties and edges where the rays go:

  * spheres 0 and 1 are the same unit sphere at (0, 0, 5) (a sphere/sphere
    tie: the lowest index wins), sphere 2 a unit sphere at (3, 0, 5);
  * plane 0 is z = 4, tangent to sphere 0 at its near pole (a ray down +z
    from the origin meets both at t = 4 exactly: the sphere wins), plane 1
    is the same plane (a plane/plane tie), plane 2 is y = -2.

The rays (``rays``): down +z from the origin (the ties), tangent to sphere
0 (a discriminant of exactly 0), from inside sphere 0, pointing away from
it, parallel to the planes, with a t_max shorter than the sphere, zero,
NaN and infinite directions, and seeded random rays around the spheres;
each lane also gets an ``active`` and a ``stop`` bit from the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
from cuda_pathtracer_tpu_torch.ops.traverse import (Hit, PRIM_TRIANGLE,
                                                    _primitives_prepass)
from cuda_pathtracer_tpu_torch.constants import T_MAX

SPHERE_POS = np.array([[0, 0, 5], [0, 0, 5], [3, 0, 5]], np.float32)
SPHERE_RADIUS = np.array([1, 1, 1], np.float32)
PLANE_NORMAL = np.array([[0, 0, 1], [0, 0, 1], [0, 1, 0]], np.float32)
PLANE_D = np.array([-4, -4, 2], np.float32)

# (spheres, planes) kept of the three each: every family on, or off
PRIMITIVE_SETS = {'spheres and planes': (3, 3), 'spheres only': (3, 0),
                  'planes only': (0, 3), 'none': (0, 0)}


def rays(n_random: int = 4000, seed: int = 0) -> dict:
    """ro, rd f32[B, 3]; t_max f32[B]; active, stop bool[B] (numpy)."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    fixed = [
        # (origin, direction, t_max)
        ((0, 0, 0), (0, 0, 1), T_MAX),          # sphere/sphere/plane tie at 4
        ((0, 0, 0), (0, 0, 2), T_MAX),          # the same, unnormalised
        ((10, 0, 0), (0, 0, 1), T_MAX),         # plane/plane tie, no sphere
        ((1, 0, 4.5), (0, 0, 1), T_MAX),        # tangent to sphere 0
        ((3, 1, 4.5), (0, 0, 1), T_MAX),        # tangent to sphere 2
        ((0, 0, 5), (0, 0, 1), T_MAX),          # inside sphere 0
        ((0, 0, 5), (0.6, 0.8, 0), T_MAX),      # inside, sideways
        ((0, 0, 0), (0, 0, -1), T_MAX),         # away from every sphere
        ((0, 0, 7), (0, 0, 1), T_MAX),          # beyond sphere 0, away
        ((0, 0, 0), (1, 0, 0), T_MAX),          # parallel to planes 0 and 1
        ((0, 3, 0), (1, 0, 1), T_MAX),          # parallel to plane 2
        ((0, 0, 0), (0, 0, 1), 3.0),            # t_max short of the sphere
        ((0, 0, 0), (0, 0, 1), 4.0),            # t_max exactly at the tie
        ((0, 0, 0), (0, 1e-4, 1), 4.0),         # just under
        ((0, 0, 0), (0, 0, 0), T_MAX),          # zero direction
        ((0, 0, 0), (nan, 0, 1), T_MAX),        # NaN direction
        ((0, 0, 0), (0, 0, inf), T_MAX),        # infinite direction
        ((0, 0, 0), (inf, inf, inf), T_MAX),
        ((nan, 0, 0), (0, 0, 1), T_MAX),        # NaN origin
        ((0, 0, 0), (0, 0, 1), nan),            # NaN t_max
        ((0, 0, 0), (0, 0, 1), 0.0),            # t_max 0
        ((0, 0, 0), (0, 1, 1), T_MAX),          # grazing sphere 0's top
    ]
    ro = np.array([f[0] for f in fixed], np.float32)
    rd = np.array([f[1] for f in fixed], np.float32)
    t_max = np.array([f[2] for f in fixed], np.float32)
    rs = np.random.RandomState(seed)
    r_ro = rs.uniform([-3, -3, -2], [6, 3, 9], (n_random, 3)).astype(np.float32)
    # aim most rays at a sphere, some anywhere
    target = SPHERE_POS[rs.randint(0, 3, n_random)] + rs.normal(
        0, 0.8, (n_random, 3)).astype(np.float32)
    r_rd = np.where(rs.rand(n_random, 1) < 0.7, target - r_ro,
                    rs.normal(size=(n_random, 3))).astype(np.float32)
    r_t = np.where(rs.rand(n_random) < 0.2, rs.uniform(0, 8, n_random),
                   T_MAX).astype(np.float32)
    ro = np.concatenate([ro, r_ro])
    rd = np.concatenate([rd, r_rd])
    t_max = np.concatenate([t_max, r_t])
    n = ro.shape[0]
    active = rs.rand(n) < 0.85
    active[:len(fixed)] = True
    active[len(fixed) - 3] = False        # one fixed lane inactive
    stop = rs.rand(n) < 0.4
    return dict(ro=ro, rd=rd, t_max=t_max, active=active, stop=stop)


def with_primitives(arrays, which: str):
    """``arrays`` (SceneArrays) with this file's spheres and planes, as many
    of each as ``PRIMITIVE_SETS[which]`` keeps."""
    n_s, n_p = PRIMITIVE_SETS[which]
    dev = arrays.sphere_pos.device

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return arrays._replace(
        sphere_pos=t(SPHERE_POS[:n_s]), sphere_radius=t(SPHERE_RADIUS[:n_s]),
        sphere_mat=t(np.zeros(n_s, np.int32)),
        plane_normal=t(PLANE_NORMAL[:n_p]), plane_d=t(PLANE_D[:n_p]),
        plane_mat=t(np.zeros(n_p, np.int32)))


def trace_before(scene, dyn, ro, rd, *, t_max=None, active=None,
                 any_hit: bool = False, stop_on_hit=None,
                 want_uv: bool = False, v1: bool = False) -> Hit:
    """``dispatch.trace`` as it was before the prepass and the merge became
    kernels: the default fills, ``_primitives_prepass``, the live mask, the
    walk alone (v2 ``traverse_merged``, v1 ``traverse_split``: on the card
    their kernels) and the ``where``s that merge the walk's hit over the
    prepass's."""
    B = ro.shape[0]
    dev = ro.device
    if t_max is None:
        t_max = torch.full((B,), T_MAX, dtype=torch.float32, device=dev)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=dev)
    if stop_on_hit is None:
        stop_on_hit = torch.full((B,), bool(any_hit), device=dev)
    t0, ptype0, pid0, found0 = _primitives_prepass(scene, ro, rd, t_max)
    live = active & ~(stop_on_hit & found0)
    if v1:
        t, gid, found = tp1.traverse_split(
            tp1.PacketTables(dyn.packet_inner, dyn.packet_leaf, dyn.depth),
            ro.contiguous(), rd.contiguous(), t0.contiguous(), live,
            stop_on_hit.contiguous(), cheap=any_hit)
        u = v = None
    else:
        want_uv = want_uv and not any_hit
        t, gid, found, u, v = tp2.traverse_merged(
            tp2.MergedTable(dyn.packet_merged, dyn.depth), ro.contiguous(),
            rd.contiguous(), t0.contiguous(), live, stop_on_hit.contiguous(),
            want_uv=want_uv)
        if want_uv:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            u = torch.where(found, u, zero)
            v = torch.where(found, v, zero)
    ptype = torch.where(found, torch.full_like(ptype0, PRIM_TRIANGLE), ptype0)
    pid = torch.where(found, gid, pid0)
    return Hit(t=t, prim_type=ptype, prim_id=pid,
               intersected=active & (found | found0), u=u, v=v)


def bits(x):
    """An output as comparable bits: f32 viewed as int32, None kept."""
    if x is None:
        return None
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def differing(got, want) -> list:
    """Names of the fields (of two NamedTuples) that are not bit-equal."""
    bad = []
    for name in got._fields:
        a, b = bits(getattr(got, name)), bits(getattr(want, name))
        if a is None or b is None:
            if a is not b:
                bad.append(name)
        elif a.shape != b.shape or not torch.equal(a, b):
            bad.append(name)
    return bad
