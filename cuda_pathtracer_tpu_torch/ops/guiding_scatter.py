"""Segmented (energy, weight) sums of the guiding update (counterpart of
``cuda_pathtracer_tpu/ops/guiding_scatter.py``; kernel_update_buckets,
src/kernels.h:863-882).

:func:`segment_sum_pairs` launches ``csrc/guiding_scatter.cu`` (one
``atomicAdd`` pair per update) on CUDA tensors; :func:`segment_sum_pairs_ref`
is the plain ``index_add_`` version, used on the CPU and as the kernel's
reference on the card.
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
    version; CUDA tensors launch the atomicAdd kernel (or raise)."""
    if val_e.device.type == 'cpu':
        return segment_sum_pairs_ref(val_e, val_w, seg, n_bins)
    kernels.require_cuda('guiding_scatter', val_e, val_w, seg,
                         dtypes=(torch.float32, torch.float32, torch.int32))
    n = val_e.shape[0]
    if val_e.dim() != 1 or val_w.shape != (n,) or seg.shape != (n,):
        raise ValueError('guiding_scatter: inputs must be three [L] vectors')
    # zero-filled: the kernel accumulates into them
    sum_e = torch.zeros(n_bins, dtype=torch.float32, device=val_e.device)
    sum_w = torch.zeros(n_bins, dtype=torch.float32, device=val_e.device)
    if n:
        lib = kernels.library()
        err = lib.cpt_guiding_scatter(
            val_e.data_ptr(), val_w.data_ptr(), seg.data_ptr(), n, n_bins,
            sum_e.data_ptr(), sum_w.data_ptr(), kernels.stream_of(val_e))
        kernels.LAUNCHES['guiding_scatter'] += 1
        kernels.check(err, 'guiding_scatter')
    return sum_e, sum_w
