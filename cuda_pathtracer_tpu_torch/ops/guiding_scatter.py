"""Segmented (energy, weight) sums of the guiding update (counterpart of
``cuda_pathtracer_tpu/ops/guiding_scatter.py``; kernel_update_buckets,
src/kernels.h:863-882).

:func:`segment_sum_pairs` launches ``csrc/guiding_scatter.cu`` on CUDA
tensors: one interleaved (energy, weight) table, zeroed by one memset, and
one kernel of ``int4`` id loads, warp-aggregated ``float2`` atomics;
:func:`segment_sum_pairs_ref` is the plain ``index_add_`` version, used on
the CPU and as the kernel's reference on the card. Both return the two
columns of one f32 [n_bins, 2] table, as strided views.
"""
from __future__ import annotations

import torch

from . import kernels


def segment_sum_pairs_ref(val_e, val_w, seg, n_bins: int):
    """Sums of ``val_e`` and ``val_w`` per segment id. ``seg`` holds ids in
    [0, n_bins]; id ``n_bins`` is the discard bin and is dropped. Returns
    (sum_e, sum_w), each f32[n_bins]."""
    kernels.note_plain('guiding_scatter', val_e)
    idx = seg.to(torch.int64)
    out = torch.zeros((n_bins + 1, 2), dtype=torch.float32, device=val_e.device)
    out.index_add_(0, idx, torch.stack([val_e, val_w], dim=1))
    return out[:n_bins, 0], out[:n_bins, 1]


def segment_sum_pairs(val_e, val_w, seg, n_bins: int):
    """:func:`segment_sum_pairs_ref`'s contract. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if val_e.device.type == 'cpu':
        return segment_sum_pairs_ref(val_e, val_w, seg, n_bins)
    kernels.require_cuda('guiding_scatter', val_e, val_w, seg,
                         dtypes=(torch.float32, torch.float32, torch.int32))
    n = val_e.shape[0]
    if val_e.dim() != 1 or val_w.shape != (n,) or seg.shape != (n,):
        raise ValueError('guiding_scatter: inputs must be three [L] vectors')
    # the C entry zeroes the table, then (with updates) adds them into it
    table = torch.empty((n_bins, 2), dtype=torch.float32, device=val_e.device)
    err = kernels.library().cpt_guiding_scatter(
        val_e.data_ptr(), val_w.data_ptr(), seg.data_ptr(), n, n_bins,
        table.data_ptr(), kernels.stream_of(val_e))
    if n:
        kernels.LAUNCHES['guiding_scatter'] += 1
    kernels.check(err, 'guiding_scatter')
    return table[:, 0], table[:, 1]
