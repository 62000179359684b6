"""Bytes and operations of one traversal wave (copied from the port's
``chip_smoke.py``), counted from the plain walk's visits and rows, so that
the same work is read whatever kernel implements it."""
from __future__ import annotations

# FP32 operations per visit, as the kernels do them: an inner visit slab-tests
# 16 slots (6 mul, 6 sub, 6 min/max, 4 for the tmin/tmax reductions, 1 max,
# 2 compares); a leaf visit runs Moller-Trumbore on 12 triangles (56 each:
# the cross, dot, reciprocal, u/v/t products and the 8 acceptance tests)
SLAB_OPS = 16 * 25
LEAF_OPS = 12 * 56


def traversal_work(n_rays: int, n_out: int, stats: dict, row_bytes: int = 512):
    """(bytes, operations) a traversal needs on this wave: each ray read
    (origin, direction, t0, live, stop) and its ``n_out`` result bytes
    written once, each table row it touches read once, and the visits the
    plain walk made. ``stats`` is the plain walk's: ``inner`` and ``leaf``
    visits and the bool masks of the rows it touched (keys ending in
    ``rows``)."""
    rows = sum(int(v.sum()) for k, v in stats.items() if k.endswith('rows'))
    n_bytes = n_rays * (12 + 12 + 4 + 1 + 1) + n_rays * n_out + rows * row_bytes
    n_ops = stats['inner'] * SLAB_OPS + stats['leaf'] * LEAF_OPS
    return n_bytes, n_ops
