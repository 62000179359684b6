"""Counter-based RNG, bit-exact with ``cuda_pathtracer_tpu/core/rng.py``.

Same chain as the reference (src/use_cuda.h:61-101, src/kernels.h:20-29): a
per-(x, y, frame) seed ``wang_hash(wang_hash(x + W*y) + randIdx)``, an
xorshift32 stream scaled by 2^-32, and the blue-noise quasirandom override on
the first sample of a frame.

torch has no unsigned 32-bit arithmetic (``<<``, ``>>`` and ``+`` are missing
for ``uint32`` on the CPU), so every u32 value is held in an ``int64`` tensor
in [0, 2^32) and masked with ``& 0xFFFFFFFF`` after each operation that can
leave that range. Products stay below 2^63: the largest multiplier is
0x27d4eb2d < 2^30.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import PI

M32 = 0xFFFFFFFF
_SCALE = 2.3283064365387e-10  # 2^-32, src/use_cuda.h:80-85


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def wang_hash(seed):
    """src/use_cuda.h:61-69."""
    seed = _u32(seed)
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & M32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27d4eb2d) & M32
    return seed ^ (seed >> 15)


def xorshift(seed):
    """George Marsaglia xorshift32 (src/use_cuda.h:71-78)."""
    seed = _u32(seed)
    seed = seed ^ ((seed << 13) & M32)
    seed = seed ^ (seed >> 17)
    return seed ^ ((seed << 5) & M32)


def rand_uniform(seed):
    """Advance the xorshift stream; returns (value in [0,1), new_seed)."""
    seed = xorshift(seed)
    return seed.to(torch.float32) * _SCALE, seed


def get_seed(x, y, rand_idx, width: int):
    """Per-pixel per-frame seed (src/use_cuda.h:98-101)."""
    x = _u32(x)
    y = _u32(y, x.device)
    return wang_hash((wang_hash((x + width * y) & M32)
                      + _u32(rand_idx, x.device)) & M32)


class RandState(NamedTuple):
    """Per-lane RNG state (src/types.h:679-687). ``seed`` and ``bn_idx`` are
    u32 values in int64 tensors; ``sample_idx`` is the sample index, a Python
    int when the whole wavefront shares it, or an i64 tensor per lane when a
    dispatch batches several samples."""
    seed: torch.Tensor       # i64[...] in [0, 2^32)
    bn_sample: torch.Tensor  # f32[...] blue-noise texture sample
    bn_idx: torch.Tensor     # i64[...] quasirandom draw counter
    sample_idx: int | torch.Tensor


def rand(state: RandState):
    """One draw per lane with the blue-noise gate (src/kernels.h:20-29):
    sampleIdx < 1 -> quasirandom, else xorshift."""
    ur, new_seed = rand_uniform(state.seed)
    per_lane = isinstance(state.sample_idx, torch.Tensor)
    if per_lane or state.sample_idx < 1:
        # jnp.mod equals fmod here: both operands are non-negative
        val = torch.fmod(state.bn_sample + PI * state.bn_idx.to(torch.float32),
                         1.0)
        if per_lane:
            val = torch.where(state.sample_idx < 1, val, ur)
    else:
        val = ur
    return val, RandState(new_seed, state.bn_sample,
                          (state.bn_idx + 1) & M32, state.sample_idx)


def make_state(seed, bn_sample=None, sample_idx: int = 0) -> RandState:
    seed = _u32(seed)
    if bn_sample is None:
        bn_sample = torch.zeros(seed.shape, dtype=torch.float32,
                                device=seed.device)
        # force the xorshift path when no blue noise is wired up
        sample_idx = 1 if sample_idx == 0 else sample_idx
    return RandState(seed, bn_sample.to(torch.float32),
                     torch.zeros_like(seed), int(sample_idx))
