"""Bottom-level BVH construction: binned SAH (Wald 2007).

Builds the same topology as the reference's createBVHBinned
(src/bvhBuilder.h:35-274): K=16 centroid bins on the dominant centroid axis,
leaf cutoff count<=4 or degenerate centroid extent, child boxes assigned from
the scanned bins (not recomputed), children adjacent in memory, and a final
triangle permutation so leaf ranges are contiguous.

This module is the pure-numpy fallback; `native.py` exposes a C++
implementation of the identical algorithm behind the same signature and is
preferred automatically when its shared object is available. The port's copy
of ``cuda_pathtracer_tpu/accel/bvh.py``, without the spatial-split (SBVH)
option the port does not take.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..constants import BVH_LEAF_SIZE

EPS = 1e-3
K_BINS = 16


class BVHNodes(NamedTuple):
    """Binary BVH in the reference's implicit layout: inner nodes store
    left-child index (right = left+1); leaves store [start, count) triangle
    ranges (count > 0 marks a leaf, src/types.h:352-374)."""
    vmin: np.ndarray        # f32[N, 3]
    vmax: np.ndarray        # f32[N, 3]
    left: np.ndarray        # i32[N] (leaf: undefined)
    leaf_start: np.ndarray  # i32[N] (inner: undefined)
    leaf_count: np.ndarray  # i32[N] (0 = inner)
    perm: np.ndarray        # i32[T] triangle permutation applied by the build


def _surface_area(vmin, vmax):
    d = np.maximum(vmax - vmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def build_bvh_numpy(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> BVHNodes:
    n = len(v0)
    assert n > 0
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroids = ((v0 + v1 + v2) * np.float32(0.333333)).astype(np.float32)

    max_nodes = 2 * n - 1 if n > 1 else 1
    vmin = np.zeros((max_nodes, 3), np.float32)
    vmax = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros(max_nodes, np.int32)
    leaf_start = np.zeros(max_nodes, np.int32)
    leaf_count = np.zeros(max_nodes, np.int32)

    indices = np.arange(n, dtype=np.int32)
    vmin[0] = tri_min.min(axis=0)
    vmax[0] = tri_max.max(axis=0)

    node_count = 1
    stack = [(0, 0, n)]  # (node index, start, count) over `indices`

    def median_split(idx, start, count, ids, axis):
        """Fallback when SAH bails with count > BVH_LEAF_SIZE: median split so
        leaves NEVER exceed BVH_LEAF_SIZE (the traversal kernels test exactly
        that many triangles per leaf; the reference instead loops a dynamic
        range, src/kernels.h:224-241 — a static bound is the TPU contract)."""
        nonlocal node_count
        order = np.argsort(centroids[ids][:, axis], kind='stable')
        indices[start:start + count] = ids[order]
        lcnt = count // 2
        c1, c2 = node_count, node_count + 1
        node_count += 2
        lids = indices[start:start + lcnt]
        rids = indices[start + lcnt:start + count]
        vmin[c1] = tri_min[lids].min(axis=0)
        vmax[c1] = tri_max[lids].max(axis=0)
        vmin[c2] = tri_min[rids].min(axis=0)
        vmax[c2] = tri_max[rids].max(axis=0)
        left[idx] = c1
        leaf_count[idx] = 0
        stack.append((c2, start + lcnt, count - lcnt))
        stack.append((c1, start, lcnt))

    while stack:
        idx, start, count = stack.pop()
        ids = indices[start:start + count]
        parent_min, parent_max = vmin[idx], vmax[idx]

        if count <= BVH_LEAF_SIZE:
            leaf_start[idx] = start
            leaf_count[idx] = count
            continue

        cen = centroids[ids]
        cmin = cen.min(axis=0)
        cmax = cen.max(axis=0)
        axis = int(np.argmax(cmax - cmin))
        bmin, bmax = cmin[axis], cmax[axis]

        if bmax - bmin < K_BINS * EPS:
            median_split(idx, start, count, ids, axis)
            continue

        bin_fac = K_BINS * (1.0 - EPS) / (bmax - bmin)
        bin_ids = ((cen[:, axis] - bmin) * bin_fac).astype(np.int32)

        # per-bin boxes and counts
        bin_counts = np.bincount(bin_ids, minlength=K_BINS)
        b_min = np.full((K_BINS, 3), np.inf, np.float32)
        b_max = np.full((K_BINS, 3), -np.inf, np.float32)
        np.minimum.at(b_min, bin_ids, tri_min[ids])
        np.maximum.at(b_max, bin_ids, tri_max[ids])

        # left-exclusive / right-inclusive scans (bvhBuilder.h:162-177)
        lmin = np.minimum.accumulate(b_min, axis=0)
        lmax = np.maximum.accumulate(b_max, axis=0)
        rmin = np.minimum.accumulate(b_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(b_max[::-1], axis=0)[::-1]
        lcount = np.cumsum(bin_counts)
        rcount = np.cumsum(bin_counts[::-1])[::-1]

        inv_parent = 1.0 / max(float(_surface_area(parent_min, parent_max)), 1e-30)
        left_costs = np.empty(K_BINS, np.float64)
        left_costs[0] = 0.0
        la = _surface_area(lmin, lmax)
        la = np.where(lcount > 0, la, 0.0)
        left_costs[1:] = lcount[:-1] * la[:-1] * inv_parent
        right_costs = np.where(rcount > 0, rcount * _surface_area(rmin, rmax), 0.0) * inv_parent

        sah = left_costs + right_costs + EPS
        min_k = int(np.argmin(sah))
        if sah[min_k] >= count:
            median_split(idx, start, count, ids, axis)
            continue
        # degenerate split (all triangles on one side)
        lcnt = int(lcount[min_k - 1]) if min_k > 0 else 0
        if lcnt == 0 or lcnt == count:
            median_split(idx, start, count, ids, axis)
            continue

        is_left = bin_ids < min_k
        indices[start:start + count] = np.concatenate([ids[is_left], ids[~is_left]])

        c1, c2 = node_count, node_count + 1
        node_count += 2
        # forward-assign child boxes from the scanned bins (bvhBuilder.h:242-251)
        vmin[c1] = lmin[min_k - 1]
        vmax[c1] = lmax[min_k - 1]
        vmin[c2] = rmin[min_k]
        vmax[c2] = rmax[min_k]

        left[idx] = c1
        leaf_count[idx] = 0
        stack.append((c2, start + lcnt, count - lcnt))
        stack.append((c1, start, lcnt))

    return BVHNodes(vmin[:node_count], vmax[:node_count], left[:node_count],
                    leaf_start[:node_count], leaf_count[:node_count], indices)


def build_bvh(v0, v1, v2) -> BVHNodes:
    """Build a BVH, preferring the native C++ builder when available."""
    from . import native
    if native.available():
        return native.build_bvh_native(v0, v1, v2)
    return build_bvh_numpy(v0, v1, v2)
