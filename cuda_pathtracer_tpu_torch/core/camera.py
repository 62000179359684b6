"""Pinhole + thin-lens camera with barrel distortion (counterpart of
``cuda_pathtracer_tpu/core/camera.py``; reference Camera, src/types.h:586-677).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng as _rng
from . import vecmath as vm
from ..constants import PI


class Camera(NamedTuple):
    eye: torch.Tensor           # f32[3]
    view_dir: torch.Tensor      # f32[3]
    d: torch.Tensor             # f32[] screen plane distance
    focal_length: torch.Tensor  # f32[]
    aperture: torch.Tensor      # f32[]

    @staticmethod
    def create(eye, view_dir, d=1.5, focal_length=5.0, aperture=0.01,
               device='cuda') -> 'Camera':
        def f(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)
        return Camera(f(eye), f(view_dir), f(d), f(focal_length), f(aperture))


def basis(cam: Camera, width: int, height: int):
    """(lt, u, v) as Camera::recalculate (src/types.h:590-600)."""
    center = cam.eye + cam.d * cam.view_dir
    up = torch.zeros_like(cam.view_dir)
    up[1] = 1.0
    u = vm.normalize(vm.cross(up, cam.view_dir))
    v = vm.normalize(vm.cross(cam.view_dir, u))
    ar = width / height
    lt = center - u * ar - v
    return lt, 2.0 * ar * u, 2.0 * v


def _distort(cam: Camera, p):
    """Barrel distortion r -> r + 0.2 r^3 about the view center
    (src/types.h:669-676)."""
    center = cam.eye + cam.d * cam.view_dir
    from_center = p - center
    r = vm.length(from_center)
    rd = r + 0.2 * r * r * r
    return center + from_center * (rd / torch.clamp_min(r, 1e-4))[..., None]


def generate_rays(cam: Camera, xs, ys, seeds, width: int, height: int):
    """Primary rays with AA jitter, distortion and lens sampling — the
    vectorized Camera::getRay(x, y, seed) (src/types.h:641-658). Draws come
    from the raw xorshift stream of ``seeds``. Returns (origin[..., 3],
    direction[..., 3], rand_state_after)."""
    rand_state = _rng.make_state(seeds)
    r1, rand_state = _rng.rand(rand_state)
    r2, rand_state = _rng.rand(rand_state)
    xf = (xs.to(torch.float32) + r1) / width
    yf = (ys.to(torch.float32) + r2) / height

    lt, u, v = basis(cam, width, height)
    origin = _distort(cam, lt + xf[..., None] * u + yf[..., None] * v)
    direction = origin - cam.eye
    correction = vm.length(direction)
    direction = direction / correction[..., None]
    focal_point = origin + (cam.focal_length - cam.d) * direction

    r3, rand_state = _rng.rand(rand_state)
    r4, rand_state = _rng.rand(rand_state)
    offset_r = torch.sqrt(r3)
    offset_a = r4 * (2.0 * PI)
    fx = offset_r * torch.sin(offset_a)
    fy = offset_r * torch.cos(offset_a)
    origin = origin + cam.aperture * (fx[..., None] * u + fy[..., None] * v)
    direction = vm.normalize(focal_point - origin)
    # reject directions pointing backwards through the lens (types.h:654)
    flip = vm.dot(direction, cam.view_dir) < 0
    direction = torch.where(flip[..., None], -direction, direction)
    origin = origin - correction[..., None] * direction
    return origin, direction, rand_state


def generate_rays_simple(cam: Camera, xs, ys, width: int, height: int):
    """Jitter-free pinhole rays, Camera::getRay(x, y) (src/types.h:660-667):
    the rays of the Whitted mode and of click-to-focus. Returns (origin[...,
    3], direction[..., 3])."""
    xf = xs.to(torch.float32) / width
    yf = ys.to(torch.float32) / height
    lt, u, v = basis(cam, width, height)
    point = _distort(cam, lt + xf[..., None] * u + yf[..., None] * v)
    direction = vm.normalize(point - cam.eye)
    return cam.eye.expand(direction.shape), direction
