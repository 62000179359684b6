"""Path guiding: the 8-bucket per-triangle radiance cache (counterpart of
``cuda_pathtracer_tpu/models/guiding.py``; kernel_update_buckets /
kernel_propagate_buckets, src/kernels.h:848-905).

The per-(triangle, bucket) sums go through ``ops/guiding_scatter.py`` (the
atomicAdd kernel on the card); the EMA propagate is elementwise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..ops.guiding_scatter import segment_sum_pairs
from ..constants import EPS, GUIDE_BUCKETS, MAX_CACHE_DEPTH

# sample-cache entry types (SAMPLE_TYPE, src/types.h:337)
SAMPLE_IGNORE = 0
SAMPLE_TERMINATE = 1
SAMPLE_BUCKET = 2

ALPHA = 0.95
ENERGY_CLAMP = 100.0
VALUE_MIN = 0.1
VALUE_MAX = 2.0


class RadianceState(NamedTuple):
    cache: torch.Tensor  # f32[T, 8]
    total: torch.Tensor  # f32[T]


def init_radiance_state(num_triangles: int, device) -> RadianceState:
    """kernel_init_radiance_cache (kernels.h:848-861): 0.1 per bucket."""
    cache = torch.full((num_triangles, GUIDE_BUCKETS), VALUE_MIN,
                       dtype=torch.float32, device=device)
    total = torch.full((num_triangles,), GUIDE_BUCKETS * VALUE_MIN,
                       dtype=torch.float32, device=device)
    return RadianceState(cache, total)


class SampleCache(NamedTuple):
    """Guiding records of the first MAX_CACHE_DEPTH bounces (SampleCache,
    src/types.h:339-345), [depth, lanes]."""
    stype: torch.Tensor     # i32[D, B]
    tri: torch.Tensor       # i32[D, B] global triangle id
    bucket: torch.Tensor    # i32[D, B]
    cum_mask: torch.Tensor  # f32[D, B, 3]

    @staticmethod
    def empty(n_lanes: int, device) -> 'SampleCache':
        d = MAX_CACHE_DEPTH
        return SampleCache(
            torch.full((d, n_lanes), SAMPLE_TERMINATE, dtype=torch.int32,
                       device=device),
            torch.zeros((d, n_lanes), dtype=torch.int32, device=device),
            torch.zeros((d, n_lanes), dtype=torch.int32, device=device),
            torch.ones((d, n_lanes, 3), dtype=torch.float32, device=device))


def accumulate_buckets(n_tris: int, cache: SampleCache, total_energy):
    """Per-(triangle, bucket) energy sums and counts (kernel_update_buckets,
    kernels.h:863-882): a BUCKET record counts while no TERMINATE precedes it
    in its lane's chain. Returns (sum, count), each f32[n_tris, 8]."""
    term = (cache.stype == SAMPLE_TERMINATE).to(torch.int32)
    alive_chain = torch.cumsum(term, dim=0) - term
    valid = (cache.stype == SAMPLE_BUCKET) & (alive_chain == 0)
    # fmin, not minimum: cum_mask can have exact-zero channels, and CUDA's
    # fminf(100, 0/0 = NaN) returns 100 (kernels.h:872)
    lum = vm.luminance(total_energy[None, :, :] / cache.cum_mask)
    energy = torch.fmin(torch.full_like(lum, ENERGY_CLAMP), lum)
    energy = torch.where(valid, energy, torch.zeros_like(energy))
    weight = valid.to(torch.float32)
    n_bins = n_tris * GUIDE_BUCKETS
    seg = cache.tri * GUIDE_BUCKETS + cache.bucket
    seg = torch.where(valid, seg, torch.full_like(seg, n_bins))
    sum_e, sum_w = segment_sum_pairs(energy.reshape(-1), weight.reshape(-1),
                                     seg.reshape(-1).to(torch.int32), n_bins)
    return (sum_e.reshape(n_tris, GUIDE_BUCKETS),
            sum_w.reshape(n_tris, GUIDE_BUCKETS))


def propagate(state: RadianceState, add_sum, add_count,
              enabled: bool) -> RadianceState:
    """The EMA (kernel_propagate_buckets, kernels.h:884-905)."""
    if not enabled:
        return state
    has = add_count >= EPS
    incoming = add_sum / torch.clamp_min(add_count, 1.0)
    new_vals = torch.clamp(ALPHA * state.cache + (1.0 - ALPHA) * incoming,
                           VALUE_MIN, VALUE_MAX)
    new_cache = torch.where(has, new_vals, state.cache)
    new_total = state.total + torch.sum(new_cache - state.cache, dim=-1)
    return RadianceState(new_cache, new_total)

