"""Hemisphere sampling (counterpart of ``cuda_pathtracer_tpu/models/sampling.py``;
src/kernels.h:390-450).

Every draw goes through :func:`masked_rand`, which advances a lane's stream
only where that lane takes the branch, so each lane's draw sequence is the
one the reference's CUDA thread would make.
"""
from __future__ import annotations

import torch

from ..core import rng as _rng
from ..core import vecmath as vm
from ..constants import PI, EPS, GUIDE_BUCKETS


def masked_rand(state: _rng.RandState, mask):
    """Draw for every lane but advance the stream only where ``mask``."""
    val, new = _rng.rand(state)
    merged = _rng.RandState(
        seed=torch.where(mask, new.seed, state.seed),
        bn_sample=state.bn_sample,
        bn_idx=torch.where(mask, new.bn_idx, state.bn_idx),
        sample_idx=state.sample_idx)
    return val, merged


def _to_world(sample, w):
    """Rotate a tangent-space sample so +z aligns with ``w``
    (src/kernels.h:398-405)."""
    u, v = vm.orthonormal_basis(w)
    return vm.normalize((sample[..., 0:1] * u + sample[..., 1:2] * v)
                        + sample[..., 2:3] * w)


def hemisphere_cosine(normal, r0, r1):
    """Cosine-weighted hemisphere sample (src/kernels.h:390-406)."""
    r = torch.sqrt(r0)
    theta = 2.0 * PI * r1
    sample = torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                          torch.sqrt(torch.clamp_min(1.0 - r0, 0.0))], dim=-1)
    return _to_world(sample, normal)


def hemisphere_cached_cols(normal, cols, radiance_total, s_pick, r0_raw,
                           r1_raw):
    """Guided sample over the 8-bucket radiance cache
    (SampleHemisphereCached, src/kernels.h:408-431); ``cols`` are the 8
    bucket values as separate [B] vectors. Returns (direction, bucket i32,
    invprob)."""
    sample = s_pick * radiance_total
    # do-while: bucket = first index where EPS + cumsum >= sample
    run = torch.zeros_like(cols[0])
    bucket = torch.zeros(cols[0].shape, dtype=torch.int32, device=cols[0].device)
    for j in range(GUIDE_BUCKETS):
        run = run + cols[j]
        bucket = bucket + ((run + EPS) < sample).to(torch.int32)
    bucket = torch.clamp_max(bucket, GUIDE_BUCKETS - 1)

    bf = bucket.to(torch.float32)
    low = bucket < 4
    r0_min = torch.where(low, 0.0, 0.5).to(torch.float32)
    r0_max = torch.where(low, 0.5, 1.0).to(torch.float32)
    r1i = torch.remainder(bf, 4.0)
    r1_min = r1i * 0.25
    r1_max = (r1i + 1.0) * 0.25
    # the reference's inverted lerp: min*t + max*(1-t)
    r0 = r0_min * r0_raw + r0_max * (1.0 - r0_raw)
    r1 = r1_min * r1_raw + r1_max * (1.0 - r1_raw)

    picked = torch.zeros_like(cols[0])
    for j in range(GUIDE_BUCKETS):
        picked = torch.where(bucket == j, cols[j], picked)
    invprob = radiance_total / (picked * GUIDE_BUCKETS)
    return hemisphere_cosine(normal, r0, r1), bucket, invprob
