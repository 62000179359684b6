"""The shading of one Whitted recursion level on the card, in two launches
of ``csrc/whitted_shade.cu`` around the level's shadow traces
(``models/raytracer.py::_shade_level_kernels`` calls them).

:func:`shade_pre` runs after the closest-hit trace and gives each point
light's shadow rays; :func:`shade_post` runs after the shadow traces, adds
each lane's contribution into the frame and writes the refract and reflect
children. Together they compute what ``models/raytracer.py::_shade_level``
computes between and after its traces, bit for bit; that plain version, with
its ``cat``s and ``index_add_``, is the CPU route and the kernels' reference
on the card.

Both launches read the same scene arrays and the same rays and hits: the
scene's are checked and gathered once a frame (:func:`tables`), the level's
once a level (:func:`level`), and both are handed to the two wrappers. They
take CUDA tensors only (or raise), and each adds one to
``kernels.LAUNCHES['whitted_shade']``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import kernels

_F32, _I32 = torch.float32, torch.int32


class Tables(NamedTuple):
    """The scene arrays of ``Tables`` in ``csrc/whitted_shade.cu``, as a C
    array of pointers, with their lengths (world triangles, materials,
    spheres, planes, lights); ``arrays`` keeps the tensors alive."""
    arrays: tuple
    ptrs: ctypes.Array
    counts: ctypes.Array
    n_lights: int


class Level(NamedTuple):
    """A level's rays and closest hits as a C array of pointers;
    ``arrays`` keeps the tensors alive."""
    arrays: tuple
    ptrs: ctypes.Array
    n: int


def tables(scene, dyn) -> Tables:
    """The 17 arrays the kernels read from the scene (``scene``, ``dyn``:
    ``scene/device.py``'s arrays), checked once for the frame."""
    arrays = (dyn.tri_gid, dyn.tri_inst, scene.tri_normal, scene.tri_mat,
              dyn.inst_transform, dyn.inst_mat, scene.mat_diffuse,
              scene.mat_transmit, scene.mat_reflect, scene.mat_ior,
              scene.mat_absorption, scene.sphere_pos, scene.sphere_mat,
              scene.plane_normal, scene.plane_mat, scene.point_light_pos,
              scene.point_light_color)
    kernels.require_cuda('whitted_shade', *arrays, dtypes=(
        _I32, _I32, _F32, _I32, _F32, _I32, _F32, _F32, _F32, _F32, _F32,
        _F32, _I32, _F32, _I32, _F32, _F32))
    counts = (dyn.tri_gid.shape[0], scene.mat_diffuse.shape[0],
              scene.sphere_mat.shape[0], scene.plane_mat.shape[0],
              scene.point_light_pos.shape[0])
    if not counts[0] or not counts[1]:
        raise ValueError('whitted_shade: the scene needs a triangle and a '
                         'material')
    return Tables(arrays,
                  (ctypes.c_void_p * len(arrays))(*(a.data_ptr()
                                                    for a in arrays)),
                  (ctypes.c_int * len(counts))(*counts), counts[4])


def level(ro, rd, hit) -> Level:
    """The level's rays f32[n, 3] and their closest hits
    (``ops/traverse.py::Hit``), checked once for both launches."""
    n = ro.shape[0]
    arrays = (ro, rd, hit.t, hit.prim_type, hit.prim_id, hit.intersected)
    kernels.require_cuda('whitted_shade', *arrays,
                         dtypes=(_F32, _F32, _F32, _I32, _I32, torch.bool))
    if ro.shape != (n, 3) or rd.shape != (n, 3) or any(
            a.shape != (n,) for a in arrays[2:]):
        raise ValueError('whitted_shade: rays and hits disagree on shape')
    return Level(arrays, (ctypes.c_void_p * len(arrays))(
        *(a.data_ptr() for a in arrays)), n)


def shade_pre(tab: Tables, lv: Level):
    """Each point light's shadow rays for the level's lanes: (origin
    f32[L, n, 3], direction f32[L, n, 3], t_max f32[L, n], active
    bool[L, n]), as ``_shade_level`` hands them to its any-hit traces."""
    L, n, ro = tab.n_lights, lv.n, lv.arrays[0]
    sro = torch.empty((L, n, 3), dtype=_F32, device=ro.device)
    sfl = torch.empty((L, n, 3), dtype=_F32, device=ro.device)
    tmax = torch.empty((L, n), dtype=_F32, device=ro.device)
    active = torch.empty((L, n), dtype=torch.bool, device=ro.device)
    if n and L:
        err = kernels.library().cpt_whitted_shade_pre(
            tab.ptrs, tab.counts, lv.ptrs, n, sro.data_ptr(), sfl.data_ptr(),
            tmax.data_ptr(), active.data_ptr(), kernels.stream_of(ro))
        kernels.LAUNCHES['whitted_shade'] += 1
        kernels.check(err, 'whitted_shade')
    return sro, sfl, tmax, active


def shade_post(tab: Tables, lv: Level, weight, pixel, occluded, out,
               shadow_count):
    """Adds each lane's contribution into ``out`` f32[pixels, 3] at its
    ``pixel`` i64[n], and the level's shadow rays into ``shadow_count`` (an
    i64 0-d tensor); ``occluded`` bool[L, n] is the shadow traces'
    ``intersected``. Returns the children (origin f32[2n, 3], direction
    f32[2n, 3], weight f32[2n, 3], pixel i64[2n], active bool[2n]): the
    refract children in rows [0, n), the reflect children in [n, 2n)."""
    n, ro = lv.n, lv.arrays[0]
    kernels.require_cuda('whitted_shade', ro, weight, pixel, occluded, out,
                         shadow_count, dtypes=(_F32, _F32, torch.int64,
                                               torch.bool, _F32, torch.int64))
    if weight.shape != (n, 3) or pixel.shape != (n,) or \
            occluded.shape != (tab.n_lights, n) or out.dim() != 2 or \
            out.shape[1] != 3 or shadow_count.shape != ():
        raise ValueError('whitted_shade: weights, pixels, shadow hits, frame '
                         'or counter of the wrong shape')
    ro2 = torch.empty((2 * n, 3), dtype=_F32, device=ro.device)
    rd2 = torch.empty((2 * n, 3), dtype=_F32, device=ro.device)
    w2 = torch.empty((2 * n, 3), dtype=_F32, device=ro.device)
    pixel2 = torch.empty(2 * n, dtype=torch.int64, device=ro.device)
    active2 = torch.empty(2 * n, dtype=torch.bool, device=ro.device)
    if n:
        err = kernels.library().cpt_whitted_shade_post(
            tab.ptrs, tab.counts, lv.ptrs, n, weight.data_ptr(),
            pixel.data_ptr(), occluded.data_ptr(), out.data_ptr(),
            shadow_count.data_ptr(), ro2.data_ptr(), rd2.data_ptr(),
            w2.data_ptr(), pixel2.data_ptr(), active2.data_ptr(),
            kernels.stream_of(ro))
        kernels.LAUNCHES['whitted_shade'] += 1
        kernels.check(err, 'whitted_shade')
    return ro2, rd2, w2, pixel2, active2
