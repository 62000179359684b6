"""The ``Hit`` contract and the analytic-primitive prepass (counterpart of
``cuda_pathtracer_tpu/ops/traverse.py``).

Spheres and planes are brute-forced before the tree walk, like
traverseTopLevel (src/kernels.h:286-320); the triangle walk itself is
``ops/traverse_packet2.py``. :func:`prepass` launches ``csrc/traverse.cu``'s
``prepass_kernel`` on CUDA tensors; :func:`prepass_ref` is its plain
version, the CPU route and the kernel's reference on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import intersect as isect
from . import kernels
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


class Prepass(NamedTuple):
    """A trace's lanes after the spheres and planes, as the walk takes them."""
    t: torch.Tensor          # f32[B] the walk's t0: t_max, or the closer hit
    prim_type: torch.Tensor  # i32[B] PRIM_SPHERE / PRIM_PLANE where found
    prim_id: torch.Tensor    # i32[B] sphere / plane index, -1 where none
    found: torch.Tensor      # bool[B]
    live: torch.Tensor       # bool[B] active & ~(stop & found): lanes to walk
    stop: torch.Tensor       # bool[B] stop_on_hit, filled in where not given


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
    kernels.note_plain('prepass', ro)
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


def prepass_ref(scene, ro, rd, t_max=None, active=None, stop_on_hit=None,
                any_hit: bool = False) -> Prepass:
    """The trace's defaults (t_max ``T_MAX``, every lane active,
    stop_on_hit ``any_hit``), :func:`_primitives_prepass` and the lanes the
    walk takes: a stop-on-hit lane whose prepass found an occluder is done."""
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
    return Prepass(t0, ptype0, pid0, found0, live, stop_on_hit)


def prepass(scene, ro, rd, t_max=None, active=None, stop_on_hit=None,
            any_hit: bool = False) -> Prepass:
    """:func:`prepass_ref`'s contract. CPU tensors take the plain version;
    CUDA tensors, contiguous, launch ``prepass_kernel`` (or raise), whose
    outputs are contiguous. ro, rd f32[B, 3]; t_max f32[B], active and
    stop_on_hit bool[B], each optional."""
    if ro.device.type == 'cpu':
        return prepass_ref(scene, ro, rd, t_max, active, stop_on_hit, any_hit)
    B = ro.shape[0]
    opt = (t_max, active, stop_on_hit)
    given = [(x, dt) for x, dt in zip(opt, (torch.float32, torch.bool,
                                            torch.bool)) if x is not None]
    prims = (scene.sphere_pos, scene.sphere_radius, scene.plane_normal,
             scene.plane_d)
    kernels.require_cuda('prepass', ro, rd, *prims, *(x for x, _ in given),
                         dtypes=(torch.float32,) * 6
                         + tuple(dt for _, dt in given))
    if rd.shape != (B, 3) or ro.shape != (B, 3) \
            or any(x.shape != (B,) for x, _ in given):
        raise ValueError('prepass: ray tensors disagree on shape')
    dev = ro.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    ptype = torch.empty(B, dtype=torch.int32, device=dev)
    pid = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    live = torch.empty(B, dtype=torch.bool, device=dev)
    stop = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        ptr = [x.data_ptr() if x is not None else None for x in opt]
        err = kernels.library().cpt_prepass(
            ro.data_ptr(), rd.data_ptr(), *ptr, int(any_hit),
            prims[0].data_ptr(), prims[1].data_ptr(), prims[0].shape[0],
            prims[2].data_ptr(), prims[3].data_ptr(), prims[2].shape[0], B,
            t.data_ptr(), ptype.data_ptr(), pid.data_ptr(), found.data_ptr(),
            live.data_ptr(), stop.data_ptr(), kernels.stream_of(ro))
        kernels.LAUNCHES['prepass'] += 1
        kernels.check(err, 'prepass')
    return Prepass(t, ptype, pid, found, live, stop)


def merge_hit(t, gid, found, u, v, pre: Prepass, active=None) -> Hit:
    """The trace's :class:`Hit` from the walk's (t, gid, found, u, v) and
    its prepass: the walk's triangle where it found one, else the prepass's
    primitive (plain version of ``traverse.cu``'s merge epilogue)."""
    ptype = torch.where(found, torch.full_like(pre.prim_type, PRIM_TRIANGLE),
                        pre.prim_type)
    pid = torch.where(found, gid, pre.prim_id)
    intersected = found | pre.found
    if active is not None:
        intersected = active & intersected
    if u is not None:
        zero = torch.zeros((), dtype=torch.float32, device=t.device)
        u = torch.where(found, u, zero)
        v = torch.where(found, v, zero)
    return Hit(t=t, prim_type=ptype, prim_id=pid, intersected=intersected,
               u=u, v=v)
