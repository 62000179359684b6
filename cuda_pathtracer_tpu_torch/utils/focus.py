"""Click-to-focus: trace one ray through the scene and set the focal length
(counterpart of ``cuda_pathtracer_tpu/utils/focus.py``; src/main.cpp:381-393).

The JAX package traces the ray with its XLA threaded walk, which the port
does not have; the port traces it through ``ops/dispatch.py::trace``, as
every other ray. Both walks give the exact ``t``, so the focal length is the
same.
"""
from __future__ import annotations

import torch

from ..core import camera as cam_mod
from ..ops.dispatch import trace


def click_to_focus(camera, scene_arrays, dyn, x: int, y: int,
                   width: int, height: int):
    """Returns (new_camera, hit: bool). ``y`` is measured from the bottom, as
    in the reference's WINDOW_HEIGHT - mousey flip (main.cpp:385)."""
    dev = camera.eye.device
    xs = torch.tensor([x], dtype=torch.int32, device=dev)
    ys = torch.tensor([y], dtype=torch.int32, device=dev)
    ro, rd = cam_mod.generate_rays_simple(camera, xs, ys, width, height)
    hit = trace(scene_arrays, dyn, ro.contiguous(), rd)
    if not bool(hit.intersected[0]):
        return camera, False
    focal = torch.tensor(float(hit.t[0]), dtype=torch.float32, device=dev)
    return camera._replace(focal_length=focal), True
