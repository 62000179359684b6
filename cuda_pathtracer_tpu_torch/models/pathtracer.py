"""The wavefront path tracer (counterpart of
``cuda_pathtracer_tpu/models/pathtracer.py``; the reference Pathtracer,
src/pathtracer.h:46-311).

:func:`render_sample` runs one sample over one band of the frame: generate,
then per bounce extend (closest hit with barycentrics), shade, connect
(any-hit NEE shadow rays), until no lane is alive or the bounce cap; then
the guiding sums and the film accumulation. It follows the JAX engine's
schedule, because that schedule decides which random numbers each path
draws:

* bands: :class:`Pathtracer` renders a frame of more than
  ``MAX_LANES_PER_DISPATCH`` lanes in horizontal bands (1080p: 5 bands of
  216 rows), each starting from the same ``rand_idx``;
* tile lane order: lanes map to pixels in 8x16 tiles when the band tiles;
  the accumulators stay in lane order (:meth:`Pathtracer.
  accumulators_pixel_order` undoes it);
* tail narrowing: at ``TAIL_MIN_LANES`` lanes and more, the bounces from
  ``TAIL_START`` on run on the still-alive lanes only, compacted into
  buffers of ``L // TAIL_DIV`` and then ``max(L // TAIL2_DIV, 2048)`` lanes,
  in as many rounds as the pending lanes need; each round continues the
  ``rand_idx`` the round before it ended at;
* spp windows: a dispatch of ``spp`` samples is ``spp`` sample-major lane
  blocks, each with its own ``rand_idx`` window of ``RSTRIDE``.

Not ported: the per-bounce coherence sort and the peeled bounce 0 (neither
changes a result: per-ray traversal is exact and the sort only permutes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import film
from .guiding import (SampleCache, accumulate_buckets, init_radiance_state,
                      propagate)
from .shading import TraceState, shade
from ..core import camera as cam_mod
from ..core import rng as _rng
from ..ops.dispatch import trace
from ..constants import MAX_CACHE_DEPTH, MAX_RAY_DEPTH
from ..utils.profiling import span

# tail narrowing (the JAX engine's defaults): after TAIL_START bounces the
# pending lanes are compacted into L // TAIL_DIV lanes, after TAIL2_START
# into max(L // TAIL2_DIV, 2048); off below TAIL_MIN_LANES lanes
TAIL_START = 3
TAIL_DIV = 8
TAIL2_START = 8
TAIL2_DIV = 32
TAIL_MIN_LANES = 131072

# the reference trains the radiance cache for the first 100 converge samples
# (HCACHE && converge && sampleIndex < 100, src/pathtracer.h:292)
GUIDE_TRAIN_SAMPLES = 100


def _tile_coords(lanes, width: int):
    """Lane -> pixel (x, y) in 8x16-tile order: lane = tile-major, each
    128-lane group one 8-row x 16-column tile."""
    tpr = width // 16
    g = lanes // 128
    w = lanes % 128
    xs = (g % tpr) * 16 + w % 16
    ys = (g // tpr) * 8 + w // 16
    return xs, ys


def tile_permutation(width: int, height: int):
    """i64 lane -> row-major pixel index of the tile order, or None when the
    frame does not tile."""
    if width % 16 or height % 8:
        return None
    xs, ys = _tile_coords(torch.arange(width * height), width)
    return ys * width + xs


def tile_unpermute(arr, width: int, band_h: int, bands: int = 1):
    """Tile-order lanes -> row-major pixels, as a reshape and transpose.
    ``arr`` is [bands * band_h * width, ...]; the bands are already in
    row order."""
    tail = arr.shape[1:]
    a = arr.reshape(bands, band_h // 8, width // 16, 8, 16, *tail)
    return a.transpose(2, 3).reshape(bands * band_h * width, *tail)


def band_geometry(width: int, height: int, spp: int, max_lanes: int):
    """(bands, band_h, tile_order) of a frame: the fewest bands that keep
    width * spp * band_h within ``max_lanes`` and divide the height, moved to
    8-row-aligned bands when the frame tiles and the cap allows 30% more
    (1080p: 5 bands of 216 rows)."""
    lanes_per_row = width * spp
    rows_per_band = max(1, max_lanes // lanes_per_row)
    bands = -(-height // rows_per_band)
    while height % bands:
        bands += 1
    if width % 16 == 0 and height % 8 == 0:
        b = bands
        while b >= 1 and not (height % b == 0 and (height // b) % 8 == 0):
            b -= 1
        if b >= 1 and (height // b) * lanes_per_row <= max_lanes * 1.3:
            bands = b
    band_h = height // bands
    return bands, band_h, width % 16 == 0 and band_h % 8 == 0


def rand_stride(L: int, max_bounces: int) -> int:
    """RSTRIDE: the most ``rand_idx`` one sample of an L-lane dispatch can
    advance (generate, each bounce, and each tail round's replay of its
    level's bounces), the width of one sample's window."""
    stride = max_bounces + 2
    if max_bounces > TAIL_START and L >= TAIL_MIN_LANES:
        stride += (TAIL_DIV - 1) * (min(TAIL2_START, max_bounces) - TAIL_START)
        if max_bounces > TAIL2_START:
            c2 = max(L // TAIL2_DIV, 2048)
            stride += (-(-L // c2) - 1) * (max_bounces - TAIL2_START)
    return stride


def tail_levels(L: int, max_bounces: int):
    """The narrowing levels (start bounce, end bounce, buffer lanes) of an
    L-lane dispatch; empty when the tail is off. Bands of fewer than 2048
    lanes with more than 8 bounces get a level-2 buffer wider than the band,
    as in the JAX engine."""
    if not (max_bounces > TAIL_START and L >= TAIL_MIN_LANES):
        return []
    levels = [(TAIL_START, min(TAIL2_START, max_bounces), L // TAIL_DIV)]
    if max_bounces > TAIL2_START:
        levels.append((TAIL2_START, max_bounces, max(L // TAIL2_DIV, 2048)))
    return levels


class _Lanes(NamedTuple):
    """What each lane keeps for the whole sample: its pixel, its rand_idx
    offset and sample index (ints shared by every lane when spp is 1, else
    i64 per lane) and its blue-noise value."""
    xs: torch.Tensor
    ys: torch.Tensor
    soff: int | torch.Tensor
    samp: int | torch.Tensor
    bn: torch.Tensor

    def select(self, sel):
        def take(v):
            return v.index_select(0, sel) if isinstance(v, torch.Tensor) else v
        return _Lanes(*(take(v) for v in self))


class _Carry(NamedTuple):
    bounce: int
    ro: torch.Tensor
    rd: torch.Tensor
    alive: torch.Tensor
    state: TraceState
    cache: SampleCache | None   # None where no bounce can write it
    rand_idx: int
    albedo_add: torch.Tensor
    albedo_inc: torch.Tensor
    rays: torch.Tensor          # i64 0-d: extend + shadow rays traced


def _bounce_body(scene, dyn, radiance, c: _Carry, ln: _Lanes, *, nee: bool,
                 cache_on: bool, width: int) -> _Carry:
    """One bounce on the lanes of ``c``: extend, shade, connect, the guiding
    record of a bounce below MAX_CACHE_DEPTH (written into ``c.cache`` in
    place) and the ray count. ``rand_idx`` advances by one."""
    hit = trace(scene, dyn, c.ro, c.rd, active=c.alive, want_uv=True)
    out = shade(scene, dyn, c.ro, c.rd, hit, c.state, c.alive, ln.xs, ln.ys,
                c.rand_idx + ln.soff, ln.samp, nee, cache_on, radiance, width,
                ln.bn)
    rays = c.rays + c.alive.sum()
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
    if c.bounce < MAX_CACHE_DEPTH:
        c.cache.stype[c.bounce] = out.cache_stype
        c.cache.tri[c.bounce] = out.cache_tri
        c.cache.bucket[c.bounce] = out.cache_bucket
        c.cache.cum_mask[c.bounce] = out.cache_cum_mask
    return _Carry(bounce=c.bounce + 1, ro=out.ray_o, rd=out.ray_d,
                  alive=out.alive, state=state, cache=c.cache,
                  rand_idx=c.rand_idx + 1,
                  albedo_add=c.albedo_add + out.albedo_add,
                  albedo_inc=c.albedo_inc + out.albedo_inc, rays=rays)


# the per-lane fields a tail round gathers and scatters back
_SUMS = ('accucolor', 'albedo_add', 'albedo_inc')
_RAY = ('ro', 'rd', 'mask', 'from_specular', 'albedo_set')


def _tail_round(scene, dyn, radiance, tf: dict, ln: _Lanes, start_b: int,
                end_b: int, C: int, last_level: bool, *, nee: bool,
                cache_on: bool, width: int):
    """One compaction round of a tail level, updating ``tf`` (the full-width
    lane fields, ``rand_idx`` and ``rays``) in place: the first C lanes in
    stable order of (not pending) run bounces start_b .. end_b, then every
    field of those C lanes is written back. Later rounds pad the buffer with
    lanes that are no longer pending; they are dead in the sub-loop, so
    their sums and guiding records stay as they were, but as in the JAX
    engine their ``alive`` is written back as false, even where an earlier
    round of the level left them alive."""
    order = torch.argsort((~tf['pending']).to(torch.int8), stable=True)
    sel = order[:C]
    pend = tf['pending'].index_select(0, sel)
    g = {k: tf[k].index_select(0, sel) for k in _SUMS + _RAY}
    cache = tf['cache']
    sub_cache = None
    if start_b < MAX_CACHE_DEPTH:
        sub_cache = SampleCache(*(f.index_select(1, sel) for f in cache))
    st0 = TraceState(mask=g['mask'], accucolor=g['accucolor'],
                     light=torch.zeros_like(g['mask']),
                     from_specular=g['from_specular'],
                     albedo_set=g['albedo_set'])
    c = _Carry(bounce=start_b, ro=g['ro'], rd=g['rd'], alive=pend,
               state=st0, cache=sub_cache, rand_idx=tf['rand_idx'],
               albedo_add=torch.zeros_like(g['albedo_add']),
               albedo_inc=torch.zeros_like(g['albedo_inc']),
               rays=torch.zeros_like(tf['rays']))
    sub_ln = ln.select(sel)
    while c.bounce < end_b and bool(c.alive.any()):
        c = _bounce_body(scene, dyn, radiance, c, sub_ln, nee=nee,
                         cache_on=cache_on, width=width)
    back = dict(accucolor=c.state.accucolor,
                albedo_add=g['albedo_add'] + c.albedo_add,
                albedo_inc=g['albedo_inc'] + c.albedo_inc,
                alive=c.alive, pending=torch.zeros_like(pend))
    if not last_level:
        # nothing reads the ray state after the last level
        back.update(ro=c.ro, rd=c.rd, mask=c.state.mask,
                    from_specular=c.state.from_specular,
                    albedo_set=c.state.albedo_set)
    for k, v in back.items():
        tf[k].index_copy_(0, sel, v)
    if sub_cache is not None:
        # only pending lanes write their records back: a padded lane's
        # records are its earlier round's
        idx = sel[pend]
        for full, sub in zip(cache, c.cache):
            full.index_copy_(1, idx, sub[:, pend])
    tf['rand_idx'] = c.rand_idx
    tf['rays'] = tf['rays'] + c.rays


def _tail_level(scene, dyn, radiance, tf: dict, ln: _Lanes, start_b: int,
                end_b: int, C: int, last_level: bool, *, nee: bool,
                cache_on: bool, width: int):
    """Run the alive lanes of ``tf`` from start_b to end_b in C-lane rounds
    until none is pending."""
    tf['pending'] = tf['alive'].clone()
    while bool(tf['pending'].any()):
        _tail_round(scene, dyn, radiance, tf, ln, start_b, end_b, C,
                    last_level, nee=nee, cache_on=cache_on, width=width)


def render_sample(scene, dyn, camera, radiance, lum, alb, sample_idx: int,
                  rand_idx: int, guide: bool, bn_lanes, *, nee: bool,
                  cache_on: bool, max_bounces: int, width: int, height: int,
                  full_height: int = 0, row_offset: int = 0,
                  tile_order: bool = False, spp: int = 1):
    """``spp`` samples per pixel of one band of ``height`` rows starting at
    row ``row_offset`` of a ``full_height`` frame. Returns (lum', alb',
    guiding sums, rand_idx', rays traced as an i64 0-d tensor).

    ``lum``/``alb`` and ``bn_lanes`` are in lane order (tile order when
    ``tile_order``). ``rand_idx`` advances once for the primary rays and once
    per bounce, each tail round replaying its level's bounces. The guiding
    sums are the band's raw bucket (sum, count), f32[T, 8] each ([spp, T, 8]
    when ``spp > 1``), or None without ``guide``; the caller adds the bands'
    sums and runs the EMA once per sample."""
    dev = lum.device
    full_height = full_height or height
    B = width * height
    L = B * spp
    lanes = torch.arange(L, dtype=torch.int64, device=dev)
    pix = lanes % B
    if tile_order:
        xs, ys = _tile_coords(pix, width)
    else:
        xs, ys = pix % width, pix // width
    ys = ys + row_offset
    stride = rand_stride(L, max_bounces)
    if spp > 1:
        s_vec = lanes // B
        soff, samp = s_vec * stride, sample_idx + s_vec
    else:
        soff, samp = 0, sample_idx
    ln = _Lanes(xs, ys, soff, samp,
                bn_lanes.repeat(spp) if spp > 1 else bn_lanes)

    # primary rays (kernel_generate_primary_rays, kernels.h:493-501)
    seeds = _rng.get_seed(xs, ys, rand_idx + soff, width)
    ro, rd, _ = cam_mod.generate_rays(camera, xs, ys, seeds, width,
                                      full_height)
    levels = tail_levels(L, max_bounces)
    c = _Carry(bounce=0, ro=ro, rd=rd,
               alive=torch.ones(L, dtype=torch.bool, device=dev),
               state=TraceState.clear(L, dev), cache=SampleCache.empty(L, dev),
               rand_idx=rand_idx + 1,
               albedo_add=torch.zeros((L, 3), dtype=torch.float32, device=dev),
               albedo_inc=torch.zeros(L, dtype=torch.float32, device=dev),
               rays=torch.zeros((), dtype=torch.int64, device=dev))
    main_end = TAIL_START if levels else max_bounces
    while c.bounce < main_end and bool(c.alive.any()):
        c = _bounce_body(scene, dyn, radiance, c, ln, nee=nee,
                         cache_on=cache_on, width=width)
    accucolor, cache = c.state.accucolor, c.cache
    albedo_add, albedo_inc = c.albedo_add, c.albedo_inc
    rand_idx, rays = c.rand_idx, c.rays

    if levels:
        tf = dict(alive=c.alive, ro=c.ro, rd=c.rd, mask=c.state.mask,
                  from_specular=c.state.from_specular,
                  albedo_set=c.state.albedo_set, accucolor=accucolor,
                  albedo_add=albedo_add, albedo_inc=albedo_inc,
                  cache=cache, rand_idx=rand_idx, rays=rays)
        for i, (start_b, end_b, C) in enumerate(levels):
            _tail_level(scene, dyn, radiance, tf, ln, start_b, end_b, C,
                        i == len(levels) - 1, nee=nee, cache_on=cache_on,
                        width=width)
        accucolor, albedo_add, albedo_inc = (tf['accucolor'], tf['albedo_add'],
                                             tf['albedo_inc'])
        rand_idx, rays = tf['rand_idx'], tf['rays']

    # guiding bucket sums (src/pathtracer.h:292-296); with spp > 1 one
    # scatter serves every sample, its segment ids offset by the sample's
    # index times the triangle count
    n_tris = radiance.cache.shape[0]
    if not guide:
        sums = None
    elif spp == 1:
        sums = accumulate_buckets(n_tris, cache, accucolor)
    else:
        s_vec = (lanes // B).to(torch.int32)
        off = cache._replace(tri=cache.tri + s_vec[None, :] * n_tris)
        se, sw = accumulate_buckets(n_tris * spp, off, accucolor)
        sums = (se.reshape(spp, n_tris, -1), sw.reshape(spp, n_tris, -1))

    if spp > 1:
        # the sample-major lane blocks back to per-pixel sums
        accucolor = accucolor.reshape(spp, B, 3).sum(0)
        albedo_add = albedo_add.reshape(spp, B, 3).sum(0)
        albedo_inc = albedo_inc.reshape(spp, B).sum(0)
        rand_idx += (spp - 1) * stride
    lum = film.accumulate(lum, accucolor, n_samples=float(spp))
    alb = film.accumulate_albedo(alb, albedo_add, albedo_inc)
    return lum, alb, sums, rand_idx, rays


class Pathtracer:
    """Progressive renderer (the Application subclass,
    src/pathtracer.h:46-71): host-side sample loop over render_sample, band
    by band.

    A clearing frame re-reads the scene's dynamic arrays, which the scene
    caches until an invalidation and then refits on the device."""

    # lanes (pixels x spp) of one render_sample call; larger frames render
    # in bands. The JAX engine's value: the band geometry decides the random
    # streams, so the port keeps it
    MAX_LANES_PER_DISPATCH = 360000
    # converge samples batched into one dispatch
    SPP_PER_DISPATCH = 1
    # the process's rank: a sharded engine's ranks other than 0 write nothing
    rank = 0

    def __init__(self, scene, width: int = 640, height: int = 480,
                 device='cuda', skydome: str | None = None,
                 blue_noise: str | None = None, spp: int | None = None):
        self.scene = scene
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.spp = spp if spp is not None else self.SPP_PER_DISPATCH
        self.nee = True     # HNEE (src/pathtracer.h:213)
        self.cache = True   # HCACHE
        self.arrays = scene.to_device(self.device, skydome=skydome,
                                      blue_noise=blue_noise)
        self.dyn = scene.dynamic_arrays(self.device)
        self.radiance = init_radiance_state(int(self.arrays.tri_mat.shape[0]),
                                            self.device)
        self.sample_idx = 0
        self.rand_idx = 0
        self.rays_traced = 0
        self._set_bands(band_geometry(width, height, self.spp,
                                      self.MAX_LANES_PER_DISPATCH)[0])
        self._clear_accumulators()

    def _set_bands(self, bands: int):
        """Fix the band geometry (bands must divide the height) and the
        per-band blue-noise values. The accumulators' lane order follows the
        geometry: clear them before rendering into another."""
        if self.height % bands:
            raise ValueError(f'{bands} bands do not divide {self.height} rows')
        self.bands = bands
        self.band_h = self.height // bands
        self.tile_order = self.width % 16 == 0 and self.band_h % 8 == 0
        self.bn_bands = self._bn_bands()

    def _owned_bands(self) -> range:
        """The bands this engine renders and whose accumulators it holds,
        in order: every band here (a rank of the sharded engine holds its
        own)."""
        return range(self.bands)

    def _full_height(self) -> int:
        """The frame height the camera frames: the engine's height here
        (the sharded engine's requested one, below its pad rows)."""
        return self.height

    def _clear_accumulators(self):
        n = len(self._owned_bands()) * self.band_h * self.width
        self.lum, self.alb = film.clear_accumulators(n, self.device)

    def _bn_bands(self):
        """The blue-noise texel of each lane's pixel, per band, in
        render_sample's lane -> pixel mapping."""
        bn = self.arrays.blue_noise
        lanes = torch.arange(self.width * self.band_h, device=self.device)
        if self.tile_order:
            xs, ys = _tile_coords(lanes, self.width)
        else:
            xs, ys = lanes % self.width, lanes // self.width
        return [bn[(ys + b * self.band_h) % bn.shape[0], xs % bn.shape[1]]
                for b in range(self.bands)]

    def render(self, camera, current_time: float = 0.0,
               frame_time: float = 0.0, should_clear: bool = False):
        """One display frame (Pathtracer::Render, src/pathtracer.h:224-302).
        ``current_time`` and ``frame_time`` are the reference's arguments;
        the scene's handlers read the time in ``Scene.update``."""
        if should_clear:
            self.dyn = self.scene.dynamic_arrays(self.device)
            self._clear_accumulators()
            self.sample_idx = 0
            self.rand_idx = 0
        n_samples = self.scene.interactive_depth if should_clear else 1
        if should_clear:
            max_bounces = self.scene.interactive_depth + (0 if self.nee else 1)
        else:
            max_bounces = MAX_RAY_DEPTH
        # clearing frames render one sample per dispatch for latency
        use_spp = 1 if should_clear else self.spp
        for _ in range(n_samples):
            guide = ((not should_clear) and self.cache
                     and self.sample_idx < GUIDE_TRAIN_SAMPLES)
            # a batch never trains past the guiding window
            if guide and self.sample_idx + use_spp > GUIDE_TRAIN_SAMPLES:
                use_spp = max(1, GUIDE_TRAIN_SAMPLES - self.sample_idx)
            self.rand_idx, rays = self._sample_dispatch(camera, guide,
                                                        max_bounces, use_spp)
            self.sample_idx += use_spp
            self.rays_traced = self.rays_traced + rays

    def _sample_dispatch(self, camera, guide: bool, max_bounces: int,
                         spp: int):
        """One dispatch over the whole frame: the band loop, then the EMA
        once per sample on the bands' summed guiding tables. Returns (the
        largest rand_idx a band reached, rays traced)."""
        ridx, rays, sums = self._render_bands(camera, guide, max_bounces, spp)
        if guide:
            self._propagate(*sums, spp)
        return ridx, rays

    def _render_bands(self, camera, guide: bool, max_bounces: int, spp: int):
        """render_sample over the owned bands, each from the same rand_idx,
        into ``lum``/``alb``. Returns (the largest rand_idx a band reached,
        rays traced, the bands' raw guiding (sum, count) added left to right
        or None without ``guide``)."""
        lum_parts, alb_parts = [], []
        gsum = gcnt = None
        ridx, rays = self.rand_idx, 0
        bl = self.band_h * self.width
        for j, b in enumerate(self._owned_bands()):
            sl = slice(j * bl, (j + 1) * bl)
            lum_b, alb_b, sums, ridx_b, rays_b = render_sample(
                self.arrays, self.dyn, camera, self.radiance,
                self.lum[sl], self.alb[sl], self.sample_idx, self.rand_idx,
                guide, self.bn_bands[b], nee=self.nee, cache_on=self.cache,
                max_bounces=max_bounces, width=self.width,
                height=self.band_h, full_height=self._full_height(),
                row_offset=b * self.band_h, tile_order=self.tile_order,
                spp=spp)
            lum_parts.append(lum_b)
            alb_parts.append(alb_b)
            if guide:
                gsum = sums[0] if gsum is None else gsum + sums[0]
                gcnt = sums[1] if gcnt is None else gcnt + sums[1]
            ridx = max(ridx, ridx_b)
            rays = rays + rays_b
        self.lum = torch.cat(lum_parts)
        self.alb = torch.cat(alb_parts)
        return ridx, rays, ((gsum, gcnt) if guide else None)

    def _propagate(self, gsum, gcnt, spp: int):
        """The guiding EMA once per sample of a dispatch, on the raw summed
        tables ([T, 8], or [spp, T, 8] when ``spp > 1``)."""
        if spp == 1:
            gsum, gcnt = gsum[None], gcnt[None]
        for s in range(spp):
            self.radiance = propagate(self.radiance, gsum[s], gcnt[s], True)

    def gather_lanes(self):
        """(lum, alb) of the whole frame in lane order."""
        return self.lum, self.alb

    def keep_lanes(self, lum, alb):
        """Take whole-frame lane-order accumulators (a checkpoint's)."""
        self.lum, self.alb = lum, alb

    def finish(self):
        """Application::Finish: wait for the device."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def accumulators_pixel_order(self):
        """(lum, alb) in row-major pixel order, whatever the lane order."""
        if self.tile_order:
            return (tile_unpermute(self.lum, self.width, self.band_h,
                                   self.bands),
                    tile_unpermute(self.alb, self.width, self.band_h,
                                   self.bands))
        return self.lum, self.alb

    def image(self, blur: bool = False):
        """The display image (span ``film.display``)."""
        with span('film.display'):
            lum, alb = self.accumulators_pixel_order()
            return film.display(lum, alb, float(self.sample_idx), self.width,
                                self.height, blur=blur)

    def energy(self):
        total, has_nan, has_neg = film.energy_audit(self.lum)
        return float(total), bool(has_nan), bool(has_neg)
