"""Whitted-style raytracer mode (counterpart of
``cuda_pathtracer_tpu/models/raytracer.py``; the reference's OpenMP CPU
raytracer, src/raytracer.h:17-165): point-light direct lighting with hard
shadows, recursive reflect/refract with Fresnel reweighting and Beer
absorption, the checkerboard plane, the sky constant (0.2, 0.3, 0.6), depth 2
on a clearing frame and 7 otherwise.

The recursion tree is evaluated level by level, as in the JAX package: each
depth is one wavefront (trace, shadow traces, shade) over the level's lanes,
the refract and reflect children of every lane form the next level, and each
lane's contribution is added into its pixel. A level keeps at most 2x the
pixel count of lanes, the highest-weight ones (the JAX package's
weight-priority cap).

Unlike the JAX package, a level carries only its active lanes: a child whose
weight fell to 1e-5 or below, or that was never spawned, adds exactly 0 to
the frame, so it is dropped before the level is traced rather than traced as
a masked lane. The lanes kept, and their order, are the JAX package's
(``_compact``).

A level is shaded by :func:`_shade_level`, the plain version, on the CPU,
and on the card by two kernels around its traces
(:func:`_shade_level_kernels`, ``ops/whitted_shade.py``), which give the
plain version's children and shadow rays bit for bit; the frame's sums
differ only by the order of the card's atomic adds. The levels' lanes are
formed by :func:`_rays_plain` and :func:`_compact` on the CPU, and on the
card by ``ops/whitted_lanes.py``'s kernels, which give the same lanes bit
for bit.
"""
from __future__ import annotations

import functools

import torch

from . import film
from .shading import _f3, _reflect_ray, _refract
from ..core import camera as cam_mod
from ..core import vecmath as vm
from ..ops import kernels, whitted_lanes, whitted_shade
from ..ops.dispatch import trace
from ..ops.traverse import PRIM_PLANE, PRIM_SPHERE
from ..constants import EPS
from ..utils.profiling import span

SKY_COLOR = (0.2, 0.3, 0.6)  # src/raytracer.h:89


def _shade_level(scene, dyn, ro, rd, weight):
    """Shade one recursion level of live lanes (Raytracer::radiance,
    src/raytracer.h:85-165). Returns (contribution f32[B, 3], shadow rays
    traced as an i64 0-d tensor, the refract and the reflect children, each
    (origin, direction, weight, active))."""
    kernels.note_plain('whitted_shade', ro)
    dev = ro.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    with span('trace.closest'):
        hit = trace(scene, dyn, ro, rd)
    live = hit.intersected

    # sky for misses (raytracer.h:89); the copy to the card waits for it
    with span('sync.sky'):
        sky = torch.tensor(SKY_COLOR, dtype=torch.float32, device=dev)
    contrib = torch.where(_f3(~live), weight * sky, zero)

    pid = torch.clamp_min(hit.prim_id, 0).long()
    wt = torch.clamp_max(pid, dyn.tri_gid.shape[0] - 1)
    gid = torch.clamp_min(dyn.tri_gid[wt], 0).long()
    inst = torch.clamp_min(dyn.tri_inst[wt], 0).long()
    is_sphere = live & (hit.prim_type == PRIM_SPHERE)
    is_plane = live & (hit.prim_type == PRIM_PLANE)
    pos = ro + _f3(hit.t) * rd

    n_sph = scene.sphere_mat.shape[0]
    n_pla = scene.plane_mat.shape[0]
    override = dyn.inst_mat[inst]
    mid = torch.where(override >= 0, override, scene.tri_mat[gid])
    if n_sph:
        mid = torch.where(is_sphere,
                          scene.sphere_mat[torch.clamp(pid, 0, n_sph - 1)], mid)
    if n_pla:
        mid = torch.where(is_plane,
                          scene.plane_mat[torch.clamp(pid, 0, n_pla - 1)], mid)
    mid = torch.clamp(mid, 0, scene.mat_diffuse.shape[0] - 1).long()

    diffuse_color = scene.mat_diffuse[mid]
    transmit = scene.mat_transmit[mid]
    reflect_f = scene.mat_reflect[mid]
    ior = scene.mat_ior[mid]
    absorption = scene.mat_absorption[mid]

    normal = vm.normalize(
        vm.transform_dir(dyn.inst_transform[inst], scene.tri_normal[gid]),
        eps=1e-12)
    if n_sph:
        sph_c = scene.sphere_pos[torch.clamp(pid, 0, n_sph - 1)]
        normal = torch.where(_f3(is_sphere),
                             vm.normalize(pos - sph_c, eps=1e-12), normal)
    if n_pla:
        normal = torch.where(_f3(is_plane),
                             scene.plane_normal[torch.clamp(pid, 0, n_pla - 1)],
                             normal)
    inside = vm.dot(rd, normal) > 0.0
    collider_normal = torch.where(_f3(inside), -normal, normal)

    # checkerboard (raytracer.h:109-114, no +1000 offset in this mode). Only
    # plane hits feed the parity: elsewhere pos may be out of any integer's
    # range, and there the conversion differs between backends
    if n_pla:
        q = torch.where(_f3(is_plane), torch.abs(pos / 4.0), zero)
        even = (q[:, 0].long() + q[:, 2].long()) % 2 == 0
        checker = torch.where(_f3(even), torch.ones(3, device=dev),
                              torch.full((3,), 0.2, device=dev))
        diffuse_color = torch.where(_f3(is_plane), checker, diffuse_color)

    diffuse = 1.0 - transmit - reflect_f

    # point-light direct lighting with hard shadows (raytracer.h:120-137):
    # each shadow ray starts at its light and runs to just short of the hit
    direct = torch.zeros_like(diffuse_color)
    shadow_rays = torch.zeros((), dtype=torch.int64, device=dev)
    for li in range(int(scene.point_light_pos.shape[0])):
        lpos = scene.point_light_pos[li]
        lcol = scene.point_light_color[li]
        from_light = pos - lpos
        facing = vm.dot(from_light, collider_normal) < 0.0
        d2 = vm.dot(from_light, from_light)
        dist = vm.sqrt(torch.clamp_min(d2, 1e-20))
        fl = from_light / _f3(dist)
        sro = lpos + EPS * fl
        shadow_active = live & facing & (diffuse > 0.0)
        with span('trace.shadow') as sp:
            if sp is not None:
                sp.attrs['light'] = li
            shadow = trace(scene, dyn, sro, fl, t_max=dist - 2.0 * EPS,
                           active=shadow_active, any_hit=True)
        lit = shadow_active & ~shadow.intersected
        direct = direct + torch.where(
            _f3(lit), lcol * _f3(vm.dot(-fl, collider_normal) / d2), zero)
        shadow_rays = shadow_rays + shadow_active.sum()

    contrib = contrib + torch.where(
        _f3(live & (diffuse > 0.0)),
        weight * diffuse_color * _f3(diffuse) * direct, zero)

    # Fresnel reweighting (raytracer.h:140-156)
    refr_o, refr_d, refl_prob, _ = _refract(rd, collider_normal, pos, ior,
                                            absorption, inside, hit.t)
    has_transmit = live & (transmit > 0.0)
    changed = torch.where(has_transmit, refl_prob, zero)
    transmit_eff = transmit - changed
    reflect_eff = reflect_f + changed

    beer = torch.where(_f3(inside), torch.exp(-absorption * _f3(hit.t)),
                       torch.ones((), device=dev))
    refract_active = has_transmit & (transmit_eff > 0.0)
    refract_w = torch.where(_f3(refract_active),
                            weight * diffuse_color * _f3(transmit_eff) * beer,
                            zero)

    refl_o, refl_d = _reflect_ray(rd, collider_normal, pos)
    reflect_active = live & (reflect_eff > 0.0)
    reflect_w = torch.where(_f3(reflect_active),
                            weight * diffuse_color * _f3(reflect_eff), zero)

    children = (
        (refr_o, refr_d, refract_w,
         refract_active & (vm.max_comp(refract_w) > 1e-5)),
        (refl_o, refl_d, reflect_w,
         reflect_active & (vm.max_comp(reflect_w) > 1e-5)),
    )
    return contrib, shadow_rays, children


def _level_plain(scene, dyn, ro, rd, weight, pixel, out, shadow):
    """One level on the plain route: :func:`_shade_level`, its contribution
    added into ``out`` at ``pixel`` and its shadow rays into ``shadow`` (an
    i64 0-d tensor). Returns the children as one block of 2n lanes
    (origin, direction, weight, pixel, active): the refract children, then
    the reflect children."""
    contrib, rays, children = _shade_level(scene, dyn, ro, rd, weight)
    out.index_add_(0, pixel, contrib)
    shadow += rays
    return (*(torch.cat([c[i] for c in children]) for i in range(3)),
            torch.cat([pixel, pixel]), torch.cat([c[3] for c in children]))


def _shade_level_kernels(tables, scene, dyn, ro, rd, weight, pixel, out,
                         shadow):
    """:func:`_level_plain`'s contract on the card, given the frame's
    ``whitted_shade.tables``: the closest-hit trace, ``shade_pre`` for the
    shadow rays, one any-hit trace per point light on its slice of them,
    then ``shade_post``, which adds into ``out`` and ``shadow`` and writes
    the children."""
    with span('trace.closest'):
        hit = trace(scene, dyn, ro, rd)
    lv = whitted_shade.level(ro, rd, hit)
    sro, sfl, tmax, sact = whitted_shade.shade_pre(tables, lv)
    hits = []
    for li in range(sro.shape[0]):
        with span('trace.shadow') as sp:
            if sp is not None:
                sp.attrs['light'] = li
            hits.append(trace(scene, dyn, sro[li], sfl[li], t_max=tmax[li],
                              active=sact[li], any_hit=True).intersected)
    # [L, n]; with no light, sact is the empty [0, n]
    occluded = torch.stack(hits) if hits else sact
    return whitted_shade.shade_post(tables, lv, weight, pixel, occluded, out,
                                    shadow)


def _rays_plain(camera, width: int, height: int, max_depth: int):
    """Level 0 of the frame, plain: one ray per pixel from
    ``camera.generate_rays_simple``. Returns (origin, direction, weight
    f32[B, 3], pixel i64[B], the frame f32[B, 3] and the levels' shadow-ray
    counts i64[max_depth], both zeroed)."""
    kernels.note_plain('whitted_lanes', camera.eye)
    dev = camera.eye.device
    B = width * height
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    ro, rd = cam_mod.generate_rays_simple(camera, lanes % width,
                                          lanes // width, width, height)
    return (ro.contiguous(), rd,
            torch.ones((B, 3), dtype=torch.float32, device=dev), lanes,
            torch.zeros((B, 3), dtype=torch.float32, device=dev),
            torch.zeros(max_depth, dtype=torch.int64, device=dev))


def _compact(ro, rd, w, pixel, active, cap: int, ordered: bool):
    """The active lanes, at most ``cap`` of them. ``ordered`` says that the
    JAX package's level was longer than ``cap`` and so went through its
    weight-priority compaction, ``argsort(-score)[:cap]`` with inactive lanes
    scoring -1: the active lanes then come in a stable sort by falling
    weight, cut to ``cap``, which keeps the lanes of the JAX package in its
    order (sibling lanes often tie). Otherwise they keep their order. Returns
    ((ro, rd, w, pixel), active lanes dropped, the sort: ``library`` when
    ``ordered``, else ``none``)."""
    kernels.note_plain('whitted_lanes', active)
    with span('sync.compact'):
        idx = torch.nonzero(active).squeeze(1)
    n = idx.shape[0]
    if ordered:
        score = vm.max_comp(w.index_select(0, idx))
        idx = idx.index_select(0, torch.argsort(-score, stable=True)[:cap])
    return tuple(a.index_select(0, idx) for a in (ro, rd, w, pixel)), \
        max(n - cap, 0), 'library' if ordered else 'none'


def render_whitted(scene, dyn, camera, *, width: int, height: int,
                   max_depth: int, stats: list | None = None):
    """One full Whitted frame -> f32[H*W, 3] (Raytracer::Render,
    src/raytracer.h:62-83: one jitter-free ray per pixel), on the camera's
    device.

    ``stats``, when a list, gets one dict per level: ``lanes`` (the level's
    width in the JAX package: the pixels, then twice the level before, at
    most the cap), ``active`` (the lanes traced), ``dropped`` (active lanes
    the cap dropped when the level was formed) and ``shadow`` (shadow rays
    traced).

    On the card the lanes come from ``ops/whitted_lanes.py`` (the primary
    rays, then each compaction) and each level runs
    :func:`_shade_level_kernels`, with the scene's tables gathered once for
    the frame; elsewhere :func:`_rays_plain`, :func:`_compact` and
    :func:`_level_plain`. Spans (``utils/profiling.py``): ``whitted.rays``,
    then per depth ``whitted.level`` (attributes ``depth``, ``lanes``: the
    lanes traced, ``dropped``, ``ordered``: whether the level was formed by
    the weight-priority compaction) around ``trace.closest``,
    ``trace.shadow`` per light and ``whitted.compact`` (attribute ``sort``:
    ``none``, ``block`` or ``library``)."""
    B = width * height
    if camera.eye.device.type == 'cuda':
        rays, compact = whitted_lanes.primary_rays, whitted_lanes.compact
        level = functools.partial(_shade_level_kernels,
                                  whitted_shade.tables(scene, dyn))
    else:
        rays, compact, level = _rays_plain, _compact, _level_plain
    with span('whitted.rays'):
        ro, rd, weight, pixel, out, shadow = rays(camera, width, height,
                                                  max_depth)
    cap = 2 * B
    level_lanes, dropped, ordered = B, 0, False

    for depth in range(max_depth):
        n = ro.shape[0]
        children = None
        with span('whitted.level') as lv:
            if lv is not None:
                lv.attrs.update(depth=depth, lanes=n, dropped=dropped,
                                ordered=int(ordered))
            if n:
                children = level(scene, dyn, ro, rd, weight, pixel, out,
                                 shadow[depth])
            if stats is not None:
                stats.append(dict(lanes=level_lanes, active=n,
                                  dropped=dropped, shadow=shadow[depth]))
            if depth == max_depth - 1:
                break
            ordered = 2 * level_lanes > cap
            level_lanes = min(2 * level_lanes, cap)
            if children is None:
                dropped = 0
                continue
            with span('whitted.compact') as cs:
                (ro, rd, weight, pixel), dropped, sort = compact(
                    *children, cap, ordered)
                if cs is not None:
                    cs.attrs['sort'] = sort
    if stats is not None:
        for s in stats:
            s['shadow'] = int(s['shadow'])
    return out


class Raytracer:
    """Interactive Whitted mode (the reference's Raytracer Application,
    src/raytracer.h:17-31), on ``device`` (the card by default).

    A clearing frame re-reads the scene's dynamic arrays, which the scene
    caches until an invalidation and then refits on the device."""

    def __init__(self, scene, width: int = 640, height: int = 480,
                 device='cuda', skydome: str | None = None):
        self.scene = scene
        self.width = width
        self.height = height
        self.device = torch.device(device)
        with span('engine.init', setup=True):
            self.arrays = scene.to_device(self.device, skydome=skydome)
            self.dyn = scene.dynamic_arrays(self.device)
            self.frame = torch.zeros((width * height, 3),
                                     dtype=torch.float32, device=self.device)

    def render(self, camera, current_time: float = 0.0,
               frame_time: float = 0.0, should_clear: bool = False,
               stats: list | None = None):
        """One frame: depth 2 when clearing, else 7 (raytracer.h:65).
        ``stats`` as in :func:`render_whitted`. The span ``whitted.frame``
        starts a frame id."""
        with span('whitted.frame', new_frame=True):
            if should_clear:
                self.dyn = self.scene.dynamic_arrays(self.device)
            max_depth = 2 if should_clear else 7
            self.frame = render_whitted(self.arrays, self.dyn, camera,
                                        width=self.width, height=self.height,
                                        max_depth=max_depth, stats=stats)

    def finish(self):
        """Application::Finish: wait for the device."""
        if self.device.type == 'cuda':
            with span('sync.finish'):
                torch.cuda.synchronize(self.device)

    def image(self, blur: bool = False):
        """The frame without accumulation: w = 1 and no blur, whatever
        ``blur`` says (main.cpp:370-373 uses the plain quad shader in this
        mode). Span: ``film.display``."""
        with span('film.display'):
            ones = torch.ones((self.frame.shape[0], 1), dtype=torch.float32,
                              device=self.device)
            lum = torch.cat([self.frame, ones], dim=1)
            return film.display(lum, torch.ones_like(lum), 1.0, self.width,
                                self.height, blur=False)
