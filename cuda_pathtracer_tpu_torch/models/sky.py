"""Equirect skydome lookup for escaped rays (counterpart of
``cuda_pathtracer_tpu/models/sky.py::sample_sky``; normalToUv,
src/kernels.h:31-36, and kernel_shade's miss branch, src/kernels.h:526-537).
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..scene.textures import bilinear_wrap
from ..constants import PI


def normal_to_uv(n):
    """src/kernels.h:31-36; uv may be negative — wrap handles it."""
    theta = vm.div(torch.atan2(n[..., 0], n[..., 2]), 2.0 * PI)
    phi = vm.div(-torch.acos(torch.clamp(n[..., 1], -1.0, 1.0)), PI)
    return theta, phi


def sample_sky(sky_img, direction):
    """Bilinear wrap-addressed fetch of the equirect skydome
    (sky_img f32[Hs, Ws, 3], bottom-row-first)."""
    u, v = normal_to_uv(direction)
    return bilinear_wrap(sky_img.reshape(-1, sky_img.shape[-1]), 0,
                         sky_img.shape[1], sky_img.shape[0], u, v)
