"""Wavefront shading: materials, NEE and the next bounce (counterpart of
``cuda_pathtracer_tpu/models/shading.py``; kernel_shade + kernel_connect,
src/kernels.h:513-810).

Every lane computes every branch and the results merge with masks; each
lane's RNG stream advances only at the draw sites the reference would run on
that lane (``sampling.masked_rand``). Lanes are pixel-indexed: the
reference's queue of surviving paths is an ``alive`` mask, and shadow rays
are a second masked lane set, one per pixel.

Kept from the JAX package (PARITY.md): an emissive hit writes a TERMINATE
guiding record; getRefractRay's ``sinti = sqrt(max(0, 1 - costi - costi))``
is reproduced verbatim.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import sampling
from . import sky as sky_mod
from .guiding import SAMPLE_IGNORE, SAMPLE_TERMINATE, SAMPLE_BUCKET, RadianceState
from ..core import rng as _rng
from ..core import vecmath as vm
from ..ops import intersect as isect
from ..ops.lookup import table_lookup
from ..ops.traverse import Hit, PRIM_TRIANGLE, PRIM_SPHERE, PRIM_PLANE
from ..scene.textures import sample_bilinear
from ..constants import EPS, PI


class TraceState(NamedTuple):
    """Per-pixel path state (TraceState, src/types.h:461-468)."""
    mask: torch.Tensor           # f32[B, 3] throughput
    accucolor: torch.Tensor      # f32[B, 3]
    light: torch.Tensor          # f32[B, 3] pending NEE contribution
    from_specular: torch.Tensor  # bool[B]
    albedo_set: torch.Tensor     # bool[B]

    @staticmethod
    def clear(n: int, device) -> 'TraceState':
        """kernel_clear_state (src/kernels.h:485-491)."""
        return TraceState(
            mask=torch.ones((n, 3), dtype=torch.float32, device=device),
            accucolor=torch.zeros((n, 3), dtype=torch.float32, device=device),
            light=torch.zeros((n, 3), dtype=torch.float32, device=device),
            from_specular=torch.ones(n, dtype=torch.bool, device=device),
            albedo_set=torch.zeros(n, dtype=torch.bool, device=device))


class ShadeOutput(NamedTuple):
    state: TraceState
    ray_o: torch.Tensor           # f32[B, 3] next ray
    ray_d: torch.Tensor
    alive: torch.Tensor           # bool[B]
    shadow_o: torch.Tensor        # f32[B, 3]
    shadow_d: torch.Tensor
    shadow_tmax: torch.Tensor     # f32[B]
    shadow_active: torch.Tensor   # bool[B]
    cache_stype: torch.Tensor     # i32[B]
    cache_tri: torch.Tensor       # i32[B]
    cache_bucket: torch.Tensor    # i32[B]
    cache_cum_mask: torch.Tensor  # f32[B, 3]
    albedo_add: torch.Tensor      # f32[B, 3]
    albedo_inc: torch.Tensor      # f32[B] 1.0 where albedo written


def _f3(m):
    return m[..., None]


def _sel(m, a, b):
    """torch.where over a [B] mask and [B, 3] (or broadcastable) values."""
    return torch.where(_f3(m), a, b)


def _bits(x):
    """int32 fields stored as f32 bit patterns -> int32 (no arithmetic)."""
    return x.contiguous().view(torch.int32)


def _reflect_ray(rd, normal, pos):
    """getReflectRay (src/kernels.h:452-456)."""
    nd = vm.reflect(rd, normal)
    return pos + EPS * nd, nd


def _refract(rd, normal, pos, ior, absorption, inside, t):
    """getRefractRay (src/kernels.h:458-483). Returns (refract_o,
    refract_d, reflected_prob, beer)."""
    one = torch.ones_like(ior)
    n1 = torch.where(inside, ior, one)
    n2 = torch.where(inside, one, ior)
    eta = n1 / torch.clamp_min(n2, 1e-9)
    costi = vm.dot(normal, -rd)
    k = 1.0 - (eta * eta) * (1.0 - costi * costi)
    tir = k < 0.0
    refract_d = _f3(eta) * rd + normal * _f3(
        eta * costi - vm.sqrt(torch.clamp_min(k, 0.0)))
    refract_d = vm.normalize(refract_d, eps=1e-12)

    sinti = vm.sqrt(torch.clamp_min(1.0 - costi - costi, 0.0))
    costt = vm.sqrt(torch.clamp_min(1.0 - eta * eta * sinti * sinti, 0.0))
    spol = (n1 * costi - n2 * costt) / torch.clamp_min(n1 * costi + n2 * costt, 1e-9)
    ppol = (n1 * costt - n2 * costi) / torch.clamp_min(n1 * costt + n2 * costi, 1e-9)
    reflected = torch.where(tir, one, 0.5 * (spol * spol + ppol * ppol))
    beer = torch.where(_f3(inside), torch.exp(-absorption * _f3(t)),
                       torch.ones_like(absorption))
    return pos + EPS * refract_d, refract_d, reflected, beer


def shade(scene, dyn, ro, rd, hit: Hit, state: TraceState, ray_active,
          xs, ys, rand_idx, sample_idx, nee: bool, cache_on: bool,
          radiance: RadianceState, width: int, bn_sample) -> ShadeOutput:
    """One wavefront shade pass. ``ray_active`` marks lanes that carried a
    ray this bounce; ``hit`` carries the traversal's barycentrics
    (trace(want_uv=True) on v2) or ``u = v = None`` (v1), and then textured
    hits re-intersect their triangle; ``bn_sample`` is the per-lane
    blue-noise value. ``rand_idx`` and ``sample_idx`` are ints, or i64
    tensors per lane when a dispatch batches several samples."""
    B = ro.shape[0]
    dev = ro.device
    zero3 = torch.zeros((), dtype=torch.float32, device=dev)

    # ---- sky escape (kernels.h:526-537) ----
    missed = ray_active & ~hit.intersected
    sky_add = state.mask * sky_mod.sample_sky(scene.sky_img, rd)
    first_albedo = missed & ~state.albedo_set
    albedo_add = _sel(first_albedo, sky_add, zero3)
    albedo_inc = first_albedo.to(torch.float32)
    accucolor = state.accucolor + _sel(missed, sky_add, zero3)
    albedo_set = state.albedo_set | missed

    live = hit.intersected

    # ---- per-bounce RNG (kernels.h:540-542) ----
    rand_state = _rng.RandState(
        seed=_rng.get_seed(xs, ys, rand_idx, width),
        bn_sample=bn_sample,
        bn_idx=_rng._u32(rand_idx, dev).expand(B),
        sample_idx=sample_idx)

    # ---- hit decode: world triangle -> model triangle and instance ----
    pid = torch.clamp_min(hit.prim_id, 0).long()
    wt = torch.clamp_max(pid, dyn.tri_gid.shape[0] - 1)
    gid = dyn.tri_gid[wt].long()
    inst = dyn.tri_inst[wt].long()
    is_tri = live & (hit.prim_type == PRIM_TRIANGLE)
    is_sphere = live & (hit.prim_type == PRIM_SPHERE)
    is_plane = live & (hit.prim_type == PRIM_PLANE)

    pos = ro + _f3(hit.t) * rd

    trip = scene.tri_packed[gid]                     # [B, 16]
    nrm_model = trip[:, 0:3]
    tang = trip[:, 3:6]
    bitang = trip[:, 6:9]
    uvs = trip[:, 9:15]
    instp = table_lookup(dyn.inst_packed, inst)      # [B, 16]
    inst_tf = instp[:, 0:12].reshape(B, 3, 4)
    override = _bits(instp[:, 12])

    # material id with instance override (getColliderMaterialID,
    # kernels.h:88-99)
    n_sph = scene.sphere_packed.shape[0]
    n_pla = scene.plane_packed.shape[0]
    mid = torch.where(override >= 0, override, _bits(trip[:, 15]))
    sphp = plap = None
    if n_sph:
        sphp = table_lookup(scene.sphere_packed, pid)
        mid = torch.where(is_sphere, _bits(sphp[:, 4]), mid)
    if n_pla:
        plap = table_lookup(scene.plane_packed, pid)
        mid = torch.where(is_plane, _bits(plap[:, 4]), mid)

    matp = table_lookup(scene.mat_packed, mid)       # [B, 24]
    diffuse = matp[:, 0:3]
    emission = matp[:, 6:9]
    reflect_p = matp[:, 9]
    glossy = matp[:, 10]
    transmit_p = matp[:, 11]
    ior = matp[:, 12]
    absorption = matp[:, 13:16]
    tex_id = _bits(matp[:, 16])
    ntex_id = _bits(matp[:, 17])

    # normal (getColliderNormal, kernels.h:101-118 + world transform :553-556)
    normal = vm.normalize(vm.transform_dir(inst_tf, nrm_model), eps=1e-12)
    if n_sph:
        normal = _sel(is_sphere, vm.normalize(pos - sphp[:, 0:3], eps=1e-12),
                      normal)
    if n_pla:
        normal = _sel(is_plane, plap[:, 0:3], normal)
    original_normal = normal

    inside = vm.dot(rd, original_normal) > 0.0
    surface_normal = _sel(inside, -original_normal, original_normal)
    collider_normal = surface_normal

    # ---- emissive hit (kernels.h:563-576) ----
    is_emissive = live & (vm.max_comp(emission) > EPS)
    emis_visible = is_emissive & ((not nee) | state.from_specular)
    emis_add = state.mask * emission
    accucolor = accucolor + _sel(emis_visible, emis_add, zero3)
    first_albedo = emis_visible & ~albedo_set
    albedo_add = albedo_add + _sel(first_albedo, emis_add, zero3)
    albedo_inc = albedo_inc + first_albedo.to(torch.float32)
    albedo_set = albedo_set | emis_visible
    live = live & ~is_emissive   # emissive hits terminate the path

    # ---- plane checkerboard (kernels.h:578-582) ----
    if n_pla:
        px = torch.abs(pos[:, 0] / 4.0 + 1000.0).to(torch.int64)
        py = torch.abs(pos[:, 2] / 4.0 + 1000.0).to(torch.int64)
        even = (px + py) % 2 == 0
        checker = torch.where(_f3(even), torch.ones_like(diffuse),
                              torch.full_like(diffuse, 0.2))
        diffuse = _sel(is_plane, checker, diffuse)

    # ---- texturing barycentrics (kernels.h:585-619) ----
    has_tex = is_tri & (tex_id >= 0)
    has_nmap = is_tri & (ntex_id >= 0)
    if scene.textures.texels.shape[0] > 1:
        if hit.u is None:
            # the v1 traversal gives no barycentrics: re-intersect the
            # winning triangle from its world-space vertices
            tri9 = dyn.world_tris[wt]
            _, _, tu, tv = isect.ray_triangle(ro, rd, tri9[:, 0:3],
                                              tri9[:, 3:6], tri9[:, 6:9])
        else:
            tu, tv = hit.u, hit.v
        w0 = 1.0 - tu - tv
        uv_u = (uvs[:, 0] * w0 + uvs[:, 2] * tu) + uvs[:, 4] * tv
        uv_v = (uvs[:, 1] * w0 + uvs[:, 3] * tu) + uvs[:, 5] * tv
        texel = sample_bilinear(scene.textures, torch.clamp_min(tex_id, 0),
                                uv_u, uv_v)
        diffuse = _sel(has_tex, diffuse * texel, diffuse)
        if bool((scene.mat_normal_tex >= 0).any()):
            ntexel = sample_bilinear(scene.textures,
                                     torch.clamp_min(ntex_id, 0), uv_u, uv_v)
            tn = ntexel * 2.0 - 1.0
            tex_normal = (tn[:, 0:1] * tang + tn[:, 1:2] * bitang) \
                + tn[:, 2:3] * nrm_model
            tex_normal = vm.normalize(vm.transform_dir(inst_tf, tex_normal),
                                      eps=1e-12)
            flip = vm.dot(tex_normal, collider_normal) < 0.0
            tex_normal = _sel(flip, -tex_normal, tex_normal)
            collider_normal = _sel(has_nmap, tex_normal, collider_normal)

    # ---- branch select (kernels.h:624-661) ----
    brdf = vm.div(diffuse, PI)
    r_branch, rand_state = sampling.masked_rand(rand_state, live)
    take_transmit = live & (r_branch < transmit_p)
    take_reflect = live & ~take_transmit & (r_branch - transmit_p < reflect_p)
    take_diffuse = live & ~take_transmit & ~take_reflect

    mask = state.mask

    # transmit branch
    refr_o, refr_d, refl_prob, beer = _refract(rd, collider_normal, pos, ior,
                                               absorption, inside, hit.t)
    mask = _sel(take_transmit, mask * beer, mask)
    r_fres, rand_state = sampling.masked_rand(rand_state, take_transmit)
    fres_reflect = take_transmit & (r_fres < refl_prob)
    refl_o, refl_d = _reflect_ray(rd, collider_normal, pos)
    mask = _sel(fres_reflect, mask * diffuse, mask)
    spec_o = _sel(fres_reflect, refl_o, refr_o)
    spec_d = _sel(fres_reflect, refl_d, refr_d)

    # reflect branch
    mask = _sel(take_reflect, mask * diffuse, mask)
    spec_o = _sel(take_reflect, refl_o, spec_o)
    spec_d = _sel(take_reflect, refl_d, spec_d)

    # glossy perturbation of both specular branches (kernels.h:651-660; the
    # reference does not renormalize the lerped direction)
    take_spec = take_transmit | take_reflect
    g0, rand_state = sampling.masked_rand(rand_state, take_spec)
    g1, rand_state = sampling.masked_rand(rand_state, take_spec)
    noise_d = sampling.hemisphere_cosine(spec_d, g0, g1)
    spec_d = spec_d * _f3(1.0 - glossy) + _f3(glossy) * noise_d

    from_specular = torch.where(live, take_spec, state.from_specular)

    # ---- diffuse branch ----
    first_albedo = take_diffuse & ~albedo_set
    albedo_add = albedo_add + _sel(first_albedo, mask * diffuse, zero3)
    albedo_inc = albedo_inc + first_albedo.to(torch.float32)
    albedo_set = albedo_set | take_diffuse

    # NEE: 4-candidate area-light sampling (kernels.h:672-752)
    shadow_o = torch.zeros_like(ro)
    shadow_d = torch.zeros_like(rd)
    shadow_tmax = torch.zeros(B, dtype=torch.float32, device=dev)
    shadow_active = torch.zeros(B, dtype=torch.bool, device=dev)
    light_out = state.light
    n_lights = dyn.light_packed.shape[0]
    if nee and n_lights > 0:
        valid = torch.zeros(B, dtype=torch.float32, device=dev)
        success = torch.zeros(B, dtype=torch.int64, device=dev)
        for _ in range(4):
            rl, rand_state = sampling.masked_rand(rand_state, take_diffuse)
            pick = (rl * n_lights).to(torch.int64) % n_lights
            lp = table_lookup(dyn.light_packed, pick)
            centroid = vm.div((lp[:, 0:3] + lp[:, 3:6]) + lp[:, 6:9], 3.0)
            from_light = vm.normalize(pos - centroid, eps=1e-12)
            ok = take_diffuse & (vm.dot(lp[:, 9:12], from_light) > 0.0)
            valid = valid + ok.to(torch.float32)
            success = torch.where(ok, pick, success)

        has_light = take_diffuse & (valid > 0.0)
        lu, rand_state = sampling.masked_rand(rand_state, has_light)
        lv, rand_state = sampling.masked_rand(rand_state, has_light)
        fold = lu + lv > 1.0
        lu = torch.where(fold, 1.0 - lu, lu)
        lv = torch.where(fold, 1.0 - lv, lv)

        lps = table_lookup(dyn.light_packed, success)
        lv0 = lps[:, 0:3]
        v0v1 = lps[:, 3:6] - lv0
        v0v2 = lps[:, 6:9] - lv0
        cr = vm.cross(v0v1, v0v2)
        cr_len = torch.clamp_min(vm.length(cr), 1e-20)
        sample_point = (lv0 + _f3(lu) * v0v1) + _f3(lv) * v0v2

        sdir = pos - sample_point
        slen = torch.clamp_min(vm.length(sdir), 1e-20)
        inv_slen = 1.0 / slen
        sdir = sdir * _f3(inv_slen)
        lnormal = cr * _f3(1.0 / cr_len)
        nl = vm.dot(collider_normal, -sdir)
        lnl = vm.dot(lnormal, sdir)
        unoccludable = has_light & (nl > 0.0) \
            & (vm.dot(-sdir, surface_normal) > 0.0) & (lnl > 0.0)

        area = 0.5 * cr_len
        sa = lnl * area * inv_slen * inv_slen
        contrib = mask * _f3(nl * sa * n_lights * (valid / 4.0)) * brdf \
            * lps[:, 12:15]
        light_out = _sel(unoccludable, contrib, light_out)

        # inverted shadow ray for coherent origins (kernels.h:746-750)
        fw = lnl * lnl * lnl
        shadow_o = (sample_point + _f3(fw * EPS) * sdir) \
            + _f3((1.0 - fw) * EPS) * lnormal
        shadow_d = sdir
        shadow_tmax = slen - 2.0 * EPS
        shadow_active = unoccludable

    # hemisphere sample: guided or cosine (kernels.h:755-770)
    guided = take_diffuse & cache_on & is_tri \
        & (vm.dot(collider_normal, original_normal) > 0.0)
    rc = radiance.cache[gid]
    rc_cols = [rc[:, j] for j in range(rc.shape[-1])]
    # radianceTotal is identically the bucket sum under this update rule
    rt = rc_cols[0]
    for c in rc_cols[1:]:
        rt = rt + c
    gs, rand_state = sampling.masked_rand(rand_state, guided)
    gr0, rand_state = sampling.masked_rand(rand_state, guided)
    gr1, rand_state = sampling.masked_rand(rand_state, guided)
    gdir, gbucket, ginvprob = sampling.hemisphere_cached_cols(
        collider_normal, rc_cols, rt, gs, gr0, gr1)

    plain = take_diffuse & ~guided
    c0, rand_state = sampling.masked_rand(rand_state, plain)
    c1, rand_state = sampling.masked_rand(rand_state, plain)
    cdir = sampling.hemisphere_cosine(collider_normal, c0, c1)

    r_dir = _sel(guided, gdir, cdir)
    mask = _sel(guided, mask * _f3(ginvprob), mask)

    i32 = torch.int32
    cache_stype = torch.where(
        guided, torch.full((B,), SAMPLE_BUCKET, dtype=i32, device=dev),
        torch.where(live, torch.full((B,), SAMPLE_IGNORE, dtype=i32, device=dev),
                    torch.full((B,), SAMPLE_TERMINATE, dtype=i32, device=dev)))
    cache_tri = torch.where(guided, gid, torch.zeros_like(gid)).to(i32)
    cache_bucket = torch.where(guided, gbucket, torch.zeros_like(gbucket))
    cache_cum_mask = _sel(guided, mask, torch.ones_like(mask))

    # kill reversed samples, offset trick, BRDF (kernels.h:772-781)
    reversed_ = take_diffuse & (vm.dot(r_dir, surface_normal) < 0.0)
    mask = _sel(reversed_, torch.zeros_like(mask), mask)
    fdot = torch.clamp_min(vm.dot(collider_normal, r_dir), 0.0)
    fcube = fdot * fdot * fdot
    diff_o = (pos + _f3(EPS * fcube) * r_dir) \
        + _f3(EPS * (1.0 - fcube)) * collider_normal
    mask = _sel(take_diffuse, mask * PI * brdf, mask)

    russian_p = torch.where(take_diffuse,
                            torch.clamp(vm.max_comp(diffuse), 0.1, 0.9),
                            torch.ones_like(transmit_p))

    new_o = _sel(take_diffuse, diff_o, spec_o)
    new_d = _sel(take_diffuse, r_dir, spec_d)

    # ---- Russian roulette (kernels.h:784-793) ----
    rr, rand_state = sampling.masked_rand(rand_state, live)
    survive = live & (vm.max_comp(mask) > 0.0001) & (rr < russian_p)
    mask = _sel(survive, mask / _f3(russian_p), mask)
    cache_stype = torch.where(live & ~survive,
                              torch.full_like(cache_stype, SAMPLE_TERMINATE),
                              cache_stype)

    # lanes not shading this bounce keep their previous values
    out_state = TraceState(
        mask=_sel(live, mask, state.mask),
        accucolor=accucolor,
        light=light_out,
        from_specular=from_specular,
        albedo_set=albedo_set)
    return ShadeOutput(
        state=out_state, ray_o=new_o, ray_d=new_d, alive=survive,
        shadow_o=shadow_o, shadow_d=shadow_d, shadow_tmax=shadow_tmax,
        shadow_active=shadow_active, cache_stype=cache_stype,
        cache_tri=cache_tri, cache_bucket=cache_bucket,
        cache_cum_mask=cache_cum_mask, albedo_add=albedo_add,
        albedo_inc=albedo_inc)
