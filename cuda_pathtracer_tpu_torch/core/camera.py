"""Pinhole + thin-lens camera with barrel distortion (counterpart of
``cuda_pathtracer_tpu/core/camera.py``; reference Camera, src/types.h:586-677).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng as _rng
from . import vecmath as vm
from ..constants import PI
from ..utils.profiling import span


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


def default_camera(device='cuda') -> Camera:
    """The fallback camera of stateLoader.h:30-33."""
    return Camera.create([0.0, 2.0, -3.0], [0.0, 0.0, 1.0], 1.5, 5.0, 0.01,
                         device=device)


def basis(cam: Camera, width: int, height: int):
    """(lt, u, v) as Camera::recalculate (src/types.h:590-600)."""
    center = cam.eye + cam.d * cam.view_dir
    up = torch.zeros_like(cam.view_dir)
    with span('sync.basis'):   # the 1.0's copy to a card waits for it
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
    xf = vm.div(xs.to(torch.float32) + r1, width)
    yf = vm.div(ys.to(torch.float32) + r2, height)

    lt, u, v = basis(cam, width, height)
    origin = _distort(cam, lt + xf[..., None] * u + yf[..., None] * v)
    direction = origin - cam.eye
    correction = vm.length(direction)
    direction = direction / correction[..., None]
    focal_point = origin + (cam.focal_length - cam.d) * direction

    r3, rand_state = _rng.rand(rand_state)
    r4, rand_state = _rng.rand(rand_state)
    offset_r = vm.sqrt(r3)
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
    3], direction[..., 3]). The pixel fractions divide exactly (``vm.div``):
    at a far checkerboard an ulp of ray direction moves the hit by more
    than a square."""
    xf = vm.div(xs.to(torch.float32), width)
    yf = vm.div(ys.to(torch.float32), height)
    lt, u, v = basis(cam, width, height)
    point = _distort(cam, lt + xf[..., None] * u + yf[..., None] * v)
    direction = vm.normalize(point - cam.eye)
    return cam.eye.expand(direction.shape), direction


# ---------------------------------------------------------------------------
# Host-side interactive updates (the WASD/arrow/PgUp-PgDn handling of
# src/types.h:612-637), in float64 numpy as the JAX package does them.
# ---------------------------------------------------------------------------

MOVE_SPEED = 0.08
LOOK_SPEED = 0.02
APERTURE_SPEED = 0.001


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def update_camera(cam: Camera, actions: set) -> tuple[Camera, bool]:
    """Apply the held camera actions; returns (new camera on ``cam``'s
    device, has_moved)."""
    eye = _host(cam.eye)
    view = _host(cam.view_dir)
    aperture = float(cam.aperture)

    def _norm(v):
        return v / max(np.linalg.norm(v), 1e-12)

    side = _norm(np.cross([0.0, 1.0, 0.0], view))
    if 'move_forward' in actions:
        eye += MOVE_SPEED * view
    if 'move_backward' in actions:
        eye -= MOVE_SPEED * view
    if 'move_left' in actions:
        eye -= MOVE_SPEED * side
    if 'move_right' in actions:
        eye += MOVE_SPEED * side
    if 'look_up' in actions:
        view[1] += LOOK_SPEED
    if 'look_down' in actions:
        view[1] -= LOOK_SPEED
    if 'look_left' in actions:
        view -= LOOK_SPEED * side
    if 'look_right' in actions:
        view += LOOK_SPEED * side
    if 'aperture_up' in actions:
        aperture += APERTURE_SPEED
    if 'aperture_down' in actions:
        aperture -= APERTURE_SPEED
    view = _norm(view)

    moved = (not np.allclose(eye, _host(cam.eye))
             or not np.allclose(view, _host(cam.view_dir))
             or aperture != float(cam.aperture))
    new = Camera.create(eye, view, float(cam.d), float(cam.focal_length),
                        aperture, device=cam.eye.device)
    return new, moved
