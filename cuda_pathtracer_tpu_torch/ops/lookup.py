"""Table-row lookup (counterpart of ``cuda_pathtracer_tpu/ops/lookup.py``).

The JAX package replaced small-table gathers with select chains because of
TPU gather costs; on the GPU a gather is the natural form. Out-of-range
indices clamp, as XLA's gather does, so both packages read the same rows.
"""
from __future__ import annotations

import torch


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows = table[clamp(idx, 0, K-1)]: f32[K, F], int[B] -> f32[B, F]."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]
