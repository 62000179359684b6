"""Vector math over tensors with a trailing xyz axis (counterpart of
``cuda_pathtracer_tpu/core/vecmath.py``).

Sums are written out component by component, ``(a0*b0 + a1*b1) + a2*b2``, so
the rounding is the same on every backend and matches the left-to-right order
of the JAX package's three-term reductions.
"""
from __future__ import annotations

import torch

from ..utils.profiling import span


def dot(a, b):
    """Batched 3-vector dot product -> [...]."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def sqrt(x):
    """The correctly rounded f32 square root on every device. The card's
    ``torch.sqrt`` gives it; PyTorch's vectorized CPU one is an ulp off it
    for some inputs, so on the CPU the f64 root is rounded to f32, which is
    the IEEE f32 root (53 bits are more than 2 * 24 + 2)."""
    if x.device.type != 'cpu':
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def length(a):
    return sqrt(torch.clamp_min(dot(a, a), 0.0))


def normalize(a, eps: float = 0.0):
    n = length(a)
    if eps:
        n = torch.clamp_min(n, eps)
    return a / n[..., None]


def div(x, d: float):
    """x / d for a Python number d, rounded as one IEEE division on every
    device. PyTorch's CUDA kernels divide by a Python scalar as a multiply
    by its reciprocal, an ulp off the CPU's (and the JAX package's)
    quotient for many x when d is not a power of two; a 0-d f32 tensor on
    x's device divides exactly. On the CPU the result is ``x / d``'s. The
    0-d tensor's copy to a card waits for the card (span ``sync.div``)."""
    with span('sync.div'):
        d = torch.tensor(float(d), dtype=torch.float32, device=x.device)
    return x / d


def reflect(d, n):
    """Mirror direction ``d`` about normal ``n`` (CUDA reflect())."""
    return d - 2.0 * dot(d, n)[..., None] * n


def max_comp(a):
    """Component max of a float3 (reference fmaxcompf, cutil_math.h:288-293)."""
    return torch.maximum(torch.maximum(a[..., 0], a[..., 1]), a[..., 2])


def luminance(c):
    """Rec.601 luma (src/kernels.h:51-54)."""
    return (0.299 * c[..., 0] + 0.587 * c[..., 1]) + 0.114 * c[..., 2]


def transform_dir(m, d):
    """Linear part of affine [..., 3, 4] transform(s) applied to direction(s)
    (mat4x3::mul(target, 0.0f), src/types.h:401-406)."""
    return ((m[..., :, 0] * d[..., None, 0] + m[..., :, 1] * d[..., None, 1])
            + m[..., :, 2] * d[..., None, 2])


def orthonormal_basis(w):
    """(u, v) perpendicular to w with the reference's helper choice
    (src/kernels.h:398-400): +Y when |w.x| > 0.1 else +X."""
    pick_y = (torch.abs(w[..., 0]) > 0.1).to(w.dtype)
    helper = torch.stack([1.0 - pick_y, pick_y, torch.zeros_like(pick_y)], dim=-1)
    u = normalize(cross(helper, w))
    v = normalize(cross(w, u))
    return u, v
