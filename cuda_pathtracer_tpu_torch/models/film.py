"""Film: accumulators, the luminance blur, the display transform and the
energy audit (counterpart of ``cuda_pathtracer_tpu/models/film.py``; the GL
surfaces and GLSL post chain of src/main.cpp:30-171).

Accumulators are f32[H*W, 4] in pixel (row-major) order, rgb plus a weight.
"""
from __future__ import annotations

import torch

from ..ops.blur import blur_luminance


def clear_accumulators(n_pixels: int, device):
    """kernel_clear_screen for both surfaces (src/kernels.h:826-832)."""
    return (torch.zeros((n_pixels, 4), dtype=torch.float32, device=device),
            torch.zeros((n_pixels, 4), dtype=torch.float32, device=device))


def accumulate(lum, add_rgb, n_samples: float = 1.0):
    """kernel_add_to_screen (src/kernels.h:812-824): rgb += sample color,
    w += n; negative old values clamp to 0 like the surf2Dread guard."""
    old = torch.clamp_min(lum[:, :3], 0.0)
    return torch.cat([old + add_rgb, lum[:, 3:4] + n_samples], dim=1)


def accumulate_albedo(alb, add_rgb, inc):
    """updateAlbedo (src/kernels.h:56-62); w counts writes, not samples."""
    old = torch.clamp_min(alb[:, :3], 0.0)
    return torch.cat([old + add_rgb, alb[:, 3:4] + inc[:, None]], dim=1)


def display(lum, alb, n_samples: float, width: int, height: int,
            blur: bool = False):
    """Final display transform (quad_fs / quad_fs_blurred,
    src/main.cpp:46-108): divide by the sample count, optionally multiply the
    blurred luminance by the per-pixel albedo, gamma 2.0, vignette.
    Returns f32[H, W, 3], bottom-row-first."""
    if blur:
        blurred = blur_luminance(lum, alb, n_samples, width, height)
        lum_c = blurred / max(n_samples, 1.0)
        alb_c = alb[:, :3] / torch.clamp_min(alb[:, 3:4], 1e-9)
        color = lum_c * alb_c
    else:
        color = lum[:, :3] / torch.clamp_min(lum[:, 3:4], 1e-9)
    color = torch.sqrt(torch.clamp_min(color, 0.0))   # gamma 2.0
    img = color.reshape(height, width, 3)
    dev = lum.device
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height - 0.5
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width - 0.5
    vign = 1.0 - (xs[None, :] ** 2 + ys[:, None] ** 2)
    return img * vign[..., None]


def energy_audit(lum):
    """The DEBUG_ENERGY check (src/main.cpp:342-366): per-sample mean energy
    and NaN / negativity flags. Returns 0-d tensors (energy, has_nan,
    has_negative)."""
    rgb = lum[:, :3]
    w = torch.clamp_min(lum[:, 3:4], 1.0)
    sample = torch.mean(rgb, dim=1)
    has_nan = torch.any(torch.isnan(rgb))
    has_neg = torch.any(rgb < 0.0)
    total = torch.sum(torch.where(torch.isnan(sample),
                                  torch.zeros_like(sample), sample)) / torch.mean(w)
    return total, has_nan, has_neg
