"""The reference's Whitted frame (src/raytracer.h:17-165, with the JAX
package's level cap), written plainly: one jitter-free ray per pixel,
point-light direct lighting with hard shadows, and reflect and refract
children with Fresnel reweighting and Beer absorption, down to depth 7; the
display transform (w = 1, gamma 2, vignette) and the frame as uint8.

Each depth is walked as one batch of rays. The children of a level (every
refract child, then every reflect child) form the next; a child adds to its
pixel only once its weight passes 1e-5. A level keeps at most twice the
pixel count of rays, those of the largest weight.

``round_rays`` rounds every traced ray's origin and direction to bfloat16
before the walk: the control, a renderer that reads bf16 ray rows.
"""
from __future__ import annotations

import torch

from .bvh import EPS, T_MAX, Tree, _dot, spheres_planes
from .scenes import get as get_scene

SKY = (0.2, 0.3, 0.6)
MIN_WEIGHT = 1e-5


def _norm(a):
    return a / torch.sqrt(torch.clamp_min(_dot(a, a), 0.0))[..., None]


class Whitted:
    """The scene ``name`` on ``device``, ready to render frames."""

    def __init__(self, name: str, device, round_rays: bool = False):
        self.sc = get_scene(name).to_device(device)
        self.tree = Tree(self.sc['v0'], self.sc['v1'], self.sc['v2'])
        self.round_rays = round_rays
        self.device = device

    def _rays(self, ro, rd):
        if not self.round_rays:
            return ro, rd
        return (ro.to(torch.bfloat16).to(torch.float32),
                rd.to(torch.bfloat16).to(torch.float32))

    def closest(self, ro, rd):
        """(t, kind 0 miss / 1 sphere / 2 plane / 3 triangle, index)."""
        ro, rd = self._rays(ro, rd)
        t0 = torch.full((ro.shape[0],), T_MAX, device=ro.device)
        t, kind, index = spheres_planes(self.sc, ro, rd, t0)
        tt, tri = self.tree.query(ro, rd, t, torch.ones_like(t0, dtype=torch.bool),
                                  any_hit=False)
        won = tri >= 0
        return (torch.where(won, tt, t), torch.where(won, 3, kind),
                torch.where(won, tri, index))

    def blocked(self, ro, rd, t_max, active):
        """Whether anything lies on each active ray within ``(0, t_max)``."""
        ro, rd = self._rays(ro, rd)
        _, kind, _ = spheres_planes(self.sc, ro, rd, t_max)
        return active & ((kind > 0) | self.tree.query(ro, rd, t_max, active,
                                                       any_hit=True))

    def level(self, ro, rd, w):
        """Shade one level: (contribution [R, 3], children (origin,
        direction, weight) of the rays that spawn them, their row index)."""
        sc = self.sc
        t, kind, index = self.closest(ro, rd)
        live = kind > 0
        sph, pla, tri = kind == 1, kind == 2, kind == 3
        pos = ro + t[:, None] * rd
        mat = torch.zeros_like(index)
        normal = torch.zeros_like(ro)
        if sc['sphere_pos'].shape[0]:
            k = index.clamp(0, sc['sphere_pos'].shape[0] - 1)
            mat = torch.where(sph, sc['sphere_mat'][k], mat)
            normal = torch.where(sph[:, None], _norm(pos - sc['sphere_pos'][k]),
                                 normal)
        if sc['plane_normal'].shape[0]:
            k = index.clamp(0, sc['plane_normal'].shape[0] - 1)
            mat = torch.where(pla, sc['plane_mat'][k], mat)
            normal = torch.where(pla[:, None], sc['plane_normal'][k], normal)
        k = index.clamp(0, sc['tri_mat'].shape[0] - 1)
        mat = torch.where(tri, sc['tri_mat'][k], mat)
        normal = torch.where(tri[:, None], sc['normal'][k], normal)

        color = sc['diffuse'][mat]
        if sc['plane_normal'].shape[0]:
            # the checkerboard of 4-unit squares (raytracer.h:109-114)
            q = torch.where(pla[:, None], (pos / 4.0).abs(), 0.0)
            even = (q[:, 0].long() + q[:, 2].long()) % 2 == 0
            check = torch.where(even, 1.0, 0.2)[:, None].expand(-1, 3)
            color = torch.where(pla[:, None], check, color)
        transmit, reflect = sc['transmit'][mat], sc['reflect'][mat]
        ior, absorb = sc['ior'][mat], sc['absorption'][mat]
        diffuse = 1.0 - transmit - reflect
        inside = _dot(rd, normal) > 0.0
        n = torch.where(inside[:, None], -normal, normal)

        # direct light: a shadow ray from each light to just short of the hit
        direct = torch.zeros_like(ro)
        for lp, lc in zip(sc['light_pos'], sc['light_color']):
            to = pos - lp
            d2 = _dot(to, to)
            dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
            dl = to / dist[:, None]
            active = live & (diffuse > 0.0) & (_dot(to, n) < 0.0)
            lit = active & ~self.blocked(lp + EPS * dl, dl, dist - 2.0 * EPS,
                                         active)
            direct += torch.where(lit[:, None],
                                  lc * (_dot(-dl, n) / d2)[:, None], 0.0)
        out = torch.where(live[:, None], w * color * diffuse[:, None] * direct,
                          w * torch.tensor(SKY, device=ro.device))
        out = torch.where((live & (diffuse > 0.0))[:, None] | ~live[:, None],
                          out, 0.0)

        # Fresnel (kernels.h:458-483) with the reference's sin term
        n1 = torch.where(inside, ior, 1.0)
        n2 = torch.where(inside, 1.0, ior)
        eta = n1 / torch.clamp_min(n2, 1e-9)
        cos_i = _dot(n, -rd)
        k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
        refr_d = eta[:, None] * rd + n * (
            eta * cos_i - torch.sqrt(torch.clamp_min(k, 0.0)))[:, None]
        refr_d = refr_d / torch.clamp_min(
            torch.sqrt(torch.clamp_min(_dot(refr_d, refr_d), 0.0)), 1e-12)[:, None]
        sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i - cos_i, 0.0))
        cos_t = torch.sqrt(torch.clamp_min(1.0 - eta * eta * sin_i * sin_i, 0.0))
        s_pol = (n1 * cos_i - n2 * cos_t) / torch.clamp_min(n1 * cos_i + n2 * cos_t, 1e-9)
        p_pol = (n1 * cos_t - n2 * cos_i) / torch.clamp_min(n1 * cos_t + n2 * cos_i, 1e-9)
        fresnel = torch.where(k < 0.0, 1.0, 0.5 * (s_pol * s_pol + p_pol * p_pol))
        glass = live & (transmit > 0.0)
        moved = torch.where(glass, fresnel, 0.0)
        transmit, reflect = transmit - moved, reflect + moved
        beer = torch.where(inside[:, None], torch.exp(-absorb * t[:, None]), 1.0)
        refl_d = rd - 2.0 * _dot(rd, n)[:, None] * n

        kids = []
        for on, origin, direction, weight in (
                (glass & (transmit > 0.0), pos + EPS * refr_d, refr_d,
                 w * color * transmit[:, None] * beer),
                (live & (reflect > 0.0), pos + EPS * refl_d, refl_d,
                 w * color * reflect[:, None])):
            on = on & (weight.amax(1) > MIN_WEIGHT)
            rows = torch.nonzero(on).squeeze(1)
            kids.append((origin[rows], direction[rows], weight[rows], rows))
        return out, kids

    def frame(self, camera: dict, width: int, height: int, depth: int = 7):
        """The display image of one frame as uint8 [H, W, 3], bottom row
        first, on the host."""
        dev = self.device
        ro, rd = primary_rays(camera, width, height, dev)
        pixels = width * height
        pixel = torch.arange(pixels, device=dev)
        w = torch.ones((pixels, 3), device=dev)
        img = torch.zeros((pixels, 3), device=dev)
        for level in range(depth):
            if ro.shape[0] == 0:
                break
            out, kids = self.level(ro, rd, w)
            img.index_add_(0, pixel, out)
            if level == depth - 1:
                break
            ro = torch.cat([k[0] for k in kids])
            rd = torch.cat([k[1] for k in kids])
            w = torch.cat([k[2] for k in kids])
            pixel = torch.cat([pixel[k[3]] for k in kids])
            if ro.shape[0] > 2 * pixels:
                keep = torch.argsort(-w.amax(1), stable=True)[:2 * pixels]
                ro, rd, w, pixel = ro[keep], rd[keep], w[keep], pixel[keep]
        return to_uint8(display(img, width, height))


def primary_rays(camera: dict, width: int, height: int, device):
    """Camera::getRay(x, y) (src/types.h:590-600, 660-676): the screen plane
    at ``d`` along the view, aspect-wide, barrel-distorted by
    r -> r + 0.2 r^3 about its centre."""
    def f(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    eye, view, d = f(camera['eye']), f(camera['view_dir']), f(camera['d'])
    centre = eye + d * view
    u = _norm(torch.linalg.cross(f([0.0, 1.0, 0.0]), view))
    v = _norm(torch.linalg.cross(view, u))
    ar = width / height
    corner = centre - u * ar - v
    i = torch.arange(width * height, device=device)
    xf = (i % width).float() / f(float(width))
    yf = (i // width).float() / f(float(height))
    p = corner + xf[:, None] * (2.0 * ar * u) + yf[:, None] * (2.0 * v)
    off = p - centre
    r = torch.sqrt(torch.clamp_min(_dot(off, off), 0.0))
    p = centre + off * ((r + 0.2 * r * r * r) / torch.clamp_min(r, 1e-4))[:, None]
    return eye.expand(p.shape), _norm(p - eye)


def display(rgb, width: int, height: int):
    """quad_fs (src/main.cpp:46-108) at one sample: gamma 2.0 and the
    vignette 1 - (x^2 + y^2) about the centre, [H, W, 3]."""
    dev = rgb.device
    img = torch.sqrt(torch.clamp_min(rgb, 0.0)).reshape(height, width, 3)
    ys = (torch.arange(height, device=dev) + 0.5) / float(height) - 0.5
    xs = (torch.arange(width, device=dev) + 0.5) / float(width) - 0.5
    return img * (1.0 - (xs[None, :] ** 2 + ys[:, None] ** 2))[..., None]


def to_uint8(img):
    return torch.clamp(img * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
