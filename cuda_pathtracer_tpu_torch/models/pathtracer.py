"""The wavefront path tracer (counterpart of
``cuda_pathtracer_tpu/models/pathtracer.py``; the reference Pathtracer,
src/pathtracer.h:46-311).

:func:`render_sample` runs one sample over the whole frame as one wavefront,
lanes in row-major pixel order: generate, then per bounce extend (closest
hit with barycentrics), shade, connect (any-hit NEE shadow rays), until no
lane is alive or the bounce cap; then the guiding update and the film
accumulation. This is the JAX package's full-width bounce loop, the one it
runs below ``TAIL_MIN_LANES``. Its TPU coherence measures (tail narrowing,
the per-bounce ray sort, tile lane order, the peeled bounce 0, spp batching
and bands) are not ported.
"""
from __future__ import annotations

import torch

from . import film
from .guiding import (SampleCache, init_radiance_state, update_radiance_state)
from .shading import TraceState, shade
from ..core import camera as cam_mod
from ..core import rng as _rng
from ..ops.dispatch import trace
from ..constants import MAX_CACHE_DEPTH, MAX_RAY_DEPTH

# the reference trains the radiance cache for the first 100 converge samples
# (HCACHE && converge && sampleIndex < 100, src/pathtracer.h:292)
GUIDE_TRAIN_SAMPLES = 100


def render_sample(scene, dyn, camera, radiance, lum, alb, sample_idx: int,
                  rand_idx: int, guide: bool, bn_lanes, *, nee: bool,
                  cache_on: bool, max_bounces: int, width: int, height: int):
    """One sample per pixel. Returns (lum', alb', radiance', rand_idx',
    rays traced as an int64 0-d tensor).

    ``rand_idx`` advances once for the primary rays and once per bounce, as
    the reference's host randIdx does; ``guide`` gates the guiding update.
    """
    dev = lum.device
    B = width * height
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    xs = lanes % width
    ys = lanes // width

    # primary rays (kernel_generate_primary_rays, kernels.h:493-501)
    seeds = _rng.get_seed(xs, ys, rand_idx, width)
    ro, rd, _ = cam_mod.generate_rays(camera, xs, ys, seeds, width, height)
    rand_idx += 1

    state = TraceState.clear(B, dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    cache = SampleCache.empty(B, dev)
    albedo_add = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    albedo_inc = torch.zeros(B, dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    bounce = 0
    while bounce < max_bounces and bool(alive.any()):
        hit = trace(scene, dyn, ro, rd, active=alive, want_uv=True)
        out = shade(scene, dyn, ro, rd, hit, state, alive, xs, ys, rand_idx,
                    sample_idx, nee, cache_on, radiance, width, bn_lanes)
        rays = rays + alive.sum()
        state = out.state
        if nee:
            # connect: the NEE shadow rays (kernel_connect, kernels.h:799-810)
            sh = trace(scene, dyn, out.shadow_o, out.shadow_d,
                       t_max=out.shadow_tmax, active=out.shadow_active,
                       any_hit=True)
            add = out.shadow_active & ~sh.intersected
            state = state._replace(accucolor=state.accucolor + torch.where(
                add[:, None], state.light, torch.zeros_like(state.light)))
            rays = rays + out.shadow_active.sum()
        # guiding records of the first bounces (kernels.h:536,795)
        if bounce < MAX_CACHE_DEPTH:
            cache.stype[bounce] = out.cache_stype
            cache.tri[bounce] = out.cache_tri
            cache.bucket[bounce] = out.cache_bucket
            cache.cum_mask[bounce] = out.cache_cum_mask
        albedo_add = albedo_add + out.albedo_add
        albedo_inc = albedo_inc + out.albedo_inc
        ro, rd, alive = out.ray_o, out.ray_d, out.alive
        rand_idx += 1
        bounce += 1

    # guiding update (src/pathtracer.h:292-296)
    if guide:
        radiance = update_radiance_state(radiance, cache, state.accucolor, True)
    lum = film.accumulate(lum, state.accucolor)
    alb = film.accumulate_albedo(alb, albedo_add, albedo_inc)
    return lum, alb, radiance, rand_idx, rays


class Pathtracer:
    """Progressive renderer (the Application subclass,
    src/pathtracer.h:46-71): host-side sample loop over render_sample.

    A clearing frame re-reads the scene's dynamic arrays, which the scene
    caches until an invalidation and then refits on the device."""

    def __init__(self, scene, width: int = 640, height: int = 480,
                 device='cuda', skydome: str | None = None,
                 blue_noise: str | None = None):
        self.scene = scene
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.nee = True     # HNEE (src/pathtracer.h:213)
        self.cache = True   # HCACHE
        self.arrays = scene.to_device(self.device, skydome=skydome,
                                      blue_noise=blue_noise)
        self.dyn = scene.dynamic_arrays(self.device)
        self.radiance = init_radiance_state(int(self.arrays.tri_mat.shape[0]),
                                            self.device)
        self.lum, self.alb = film.clear_accumulators(width * height, self.device)
        self.sample_idx = 0
        self.rand_idx = 0
        self.rays_traced = 0
        # the blue-noise texel of each lane's pixel, constant per frame size
        lanes = torch.arange(width * height, device=self.device)
        bn = self.arrays.blue_noise
        self.bn_lanes = bn[(lanes // width) % bn.shape[0],
                           (lanes % width) % bn.shape[1]]

    def render(self, camera, current_time: float = 0.0,
               frame_time: float = 0.0, should_clear: bool = False):
        """One display frame (Pathtracer::Render, src/pathtracer.h:224-302).
        ``current_time`` and ``frame_time`` are the reference's arguments;
        the scene's handlers read the time in ``Scene.update``."""
        if should_clear:
            self.dyn = self.scene.dynamic_arrays(self.device)
            self.lum, self.alb = film.clear_accumulators(
                self.width * self.height, self.device)
            self.sample_idx = 0
            self.rand_idx = 0
        n_samples = self.scene.interactive_depth if should_clear else 1
        if should_clear:
            max_bounces = self.scene.interactive_depth + (0 if self.nee else 1)
        else:
            max_bounces = MAX_RAY_DEPTH
        for _ in range(n_samples):
            guide = ((not should_clear) and self.cache
                     and self.sample_idx < GUIDE_TRAIN_SAMPLES)
            self.lum, self.alb, self.radiance, self.rand_idx, rays = \
                render_sample(self.arrays, self.dyn, camera, self.radiance,
                              self.lum, self.alb, self.sample_idx,
                              self.rand_idx, guide, self.bn_lanes,
                              nee=self.nee, cache_on=self.cache,
                              max_bounces=max_bounces, width=self.width,
                              height=self.height)
            self.sample_idx += 1
            self.rays_traced = self.rays_traced + rays

    def finish(self):
        """Application::Finish: wait for the device."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def accumulators_pixel_order(self):
        """(lum, alb) in row-major pixel order (the lanes already are)."""
        return self.lum, self.alb

    def image(self, blur: bool = False):
        lum, alb = self.accumulators_pixel_order()
        return film.display(lum, alb, float(self.sample_idx), self.width,
                            self.height, blur=blur)

    def energy(self):
        total, has_nan, has_neg = film.energy_audit(self.lum)
        return float(total), bool(has_nan), bool(has_neg)
