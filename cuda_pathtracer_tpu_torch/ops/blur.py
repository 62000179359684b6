"""The film's separable luminance Gaussian (counterpart of
``cuda_pathtracer_tpu/ops/blur_pallas.py`` and ``models/film.py::_blur_xla``;
gauss_horz / gauss_vert, src/main.cpp:111-171).

Per pixel and channel c = lum / max(alb, 0.001) * n, then a 7-tap horizontal
(-3..3) and an 8-tap vertical (-4..3) Gaussian with weights
exp(-i^2 * 0.5 * spread) / sqrt(2 pi), spread = max(0.7, n / 200), each pass
renormalised over the taps that fall inside the frame.

:func:`blur_luminance` launches ``csrc/blur.cu`` on CUDA tensors, at any
frame size: one launch of shared-memory tiles, no scratch image;
:func:`blur_luminance_ref` is the plain version, used on the CPU and as the
kernel's reference on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from ..constants import PI

H_TAPS = tuple(range(-3, 4))
V_TAPS = tuple(range(-4, 4))


def blur_weights(n_samples: float) -> torch.Tensor:
    """f32[15] on the CPU: the 7 horizontal then the 8 vertical tap weights,
    rounded in f32 as ``blur_pallas._weights`` rounds them."""
    n = torch.tensor(n_samples, dtype=torch.float32)
    spread = torch.clamp_min(n / 200.0, 0.7)
    k = torch.tensor([-(i * i) * 0.5 for i in H_TAPS + V_TAPS],
                     dtype=torch.float32)
    return torch.exp(k * spread) / torch.sqrt(
        torch.tensor(2.0 * PI, dtype=torch.float32))


def _blur_axis(img, axis: int, taps, weights):
    n = img.shape[axis]
    idx = torch.arange(n, device=img.device)
    shape = [1, 1, 1]
    shape[axis] = n
    acc = torch.zeros_like(img)
    wsum = torch.zeros(shape, dtype=img.dtype, device=img.device)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    for off, w in zip(taps, weights):
        valid = ((idx + off >= 0) & (idx + off < n)).reshape(shape)
        shifted = torch.roll(img, -off, dims=axis)
        acc = acc + torch.where(valid, shifted * w, zero)
        wsum = wsum + torch.where(valid, w, zero)
    return acc / wsum


def blur_luminance_ref(lum, alb, n_samples: float, width: int, height: int):
    """Plain version: [H*W, >=3] accumulators in, blurred luminance f32[H*W, 3]
    out (its implicit weight is ``n_samples``)."""
    kernels.note_plain('blur', lum)
    w = blur_weights(n_samples).to(lum.device)
    n = torch.tensor(n_samples, dtype=torch.float32, device=lum.device)
    c = (lum[:, :3] / torch.clamp_min(alb[:, :3], 0.001)) * n
    img = c.reshape(height, width, 3)
    h = _blur_axis(img, 1, H_TAPS, w[:7])
    v = _blur_axis(h, 0, V_TAPS, w[7:])
    return v.reshape(-1, 3)


def blur_luminance(lum, alb, n_samples: float, width: int, height: int):
    """:func:`blur_luminance_ref`'s contract. CPU tensors take the plain
    version; CUDA tensors launch the stencil kernel (or raise). The kernel
    reads each pixel's accumulators as one 16-byte load, so both must start
    on a 16-byte boundary."""
    if lum.device.type == 'cpu':
        return blur_luminance_ref(lum, alb, n_samples, width, height)
    kernels.require_cuda('blur', lum, alb,
                         dtypes=(torch.float32, torch.float32))
    npx = width * height
    if lum.shape != (npx, 4) or alb.shape != (npx, 4):
        raise ValueError(f'blur: accumulators must be [{npx}, 4]')
    if lum.data_ptr() % 16 or alb.data_ptr() % 16:
        raise ValueError('blur: accumulators must be 16-byte aligned')
    w = (ctypes.c_float * 15)(*blur_weights(n_samples).tolist())
    out = torch.empty((npx, 3), dtype=torch.float32, device=lum.device)
    if npx:
        lib = kernels.library()
        err = lib.cpt_blur(lum.data_ptr(), alb.data_ptr(), float(n_samples),
                           ctypes.cast(w, ctypes.c_void_p), width, height,
                           out.data_ptr(),
                           kernels.stream_of(lum))
        kernels.LAUNCHES['blur'] += 1
        kernels.check(err, 'blur')
    return out
