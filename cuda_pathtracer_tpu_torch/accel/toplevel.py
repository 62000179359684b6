"""Top-level BVH over instances + merge into one flat world-space structure.

The reference keeps a two-level hierarchy at trace time: a 5-deep stack over
the agglomeratively-built top-level BVH (src/scene.h:55-118, rebuilt every
frame at src/scene.h:400) whose leaves transform the ray into model space and
run the bottom-level traversal (src/kernels.h:277-387).

On TPU a per-ray two-level walk with ray re-transformation is hostile to
vectorization, so we *splice*: the tiny top-level tree and every instance's
threaded model BVH are merged into ONE threaded node array in world space.
Instance transforms are applied to node boxes conservatively (8-corner
transform, the reference's own transformBox, src/scene.h:27-47) and to
triangles exactly. Traversal then needs no stack, no transform, no special
cases — a single uniform loop over one node array.

Rebuilding after an animation step is pure array arithmetic over precomputed
per-model flats (no SAH re-run), mirroring the reference's cheap per-frame
top-level rebuild.

The port's copy of ``cuda_pathtracer_tpu/accel/toplevel.py``, without the
per-node refit metadata that only the JAX package's threaded-walk refit
reads. The port takes the world triangle layout from here (``tri_gid``,
``tri_inst``, ``wtri_base`` and the world vertices).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core import transforms as tf
from .flatten import ThreadedBVH


class WorldBVH(NamedTuple):
    """Flat world-space scene: threaded nodes + baked world triangles."""
    vmin: np.ndarray        # f32[N, 3]
    vmax: np.ndarray        # f32[N, 3]
    miss: np.ndarray        # i32[N]
    leaf_start: np.ndarray  # i32[N] into the world triangle arrays
    leaf_count: np.ndarray  # i32[N]
    tri_v0: np.ndarray      # f32[WT, 3] world space
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_gid: np.ndarray     # i32[WT] global (model-space) triangle id -> attributes
    tri_inst: np.ndarray    # i32[WT] owning instance
    wtri_base: np.ndarray   # i64[I] first world-triangle index of instance i


def _merged_area(amin, amax, bmin, bmax):
    mn = np.minimum(amin, bmin)
    mx = np.maximum(amax, bmax)
    d = mx - mn
    return 2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])


def agglomerative_pairing(bmin: np.ndarray, bmax: np.ndarray):
    """Walter-style best-match agglomerative clustering over instance boxes —
    the same pairing loop as BuildTopLevelBVH (src/scene.h:81-118).

    Returns a tree as a list of nodes (emitted parents last):
    each entry is ('leaf', instance) or ('node', left_entry, right_entry).
    """
    n = len(bmin)
    assert n >= 1
    # cluster id -> (min, max, tree)
    clusters = {i: (bmin[i].astype(np.float64), bmax[i].astype(np.float64),
                    ('leaf', i)) for i in range(n)}
    next_id = n

    def best_match(cid):
        cmin, cmax, _ = clusters[cid]
        best, best_area = cid, np.inf
        for oid, (omin, omax, _) in clusters.items():
            if oid == cid:
                continue
            a = _merged_area(cmin, cmax, omin, omax)
            if a < best_area:
                best_area = a
                best = oid
        return best

    if n == 1:
        return ('leaf', 0)

    a = next(iter(clusters))
    b = best_match(a)
    while len(clusters) > 1:
        c = best_match(b)
        if a == c:
            amin, amax, atree = clusters.pop(a)
            bmn, bmx, btree = clusters.pop(b)
            tree = ('node', (amin, amax, atree), (bmn, bmx, btree))
            nmin = np.minimum(amin, bmn)
            nmax = np.maximum(amax, bmx)
            clusters[next_id] = (nmin, nmax, tree)
            a = next_id
            next_id += 1
            if len(clusters) > 1:
                b = best_match(a)
        else:
            a, b = b, c
    _, _, tree = clusters.popitem()[1]
    return _strip(tree)


def _strip(tree):
    if tree[0] == 'leaf':
        return tree
    return ('node', _strip(tree[1][2]), _strip(tree[2][2]))


def build_world_bvh(model_bvhs: list[ThreadedBVH],
                    model_tri_starts: list[int],
                    model_tri_counts: list[int],
                    tri_v0: np.ndarray, tri_v1: np.ndarray, tri_v2: np.ndarray,
                    inst_model: np.ndarray,
                    inst_transform: np.ndarray) -> WorldBVH:
    """Merge instance subtrees into one threaded world BVH.

    model_bvhs: threaded BVH per model (leaf_start local to the model block)
    tri_v0/1/2: all model-space triangles (already permuted per model build)
    inst_model: i32[I] model id per instance
    inst_transform: f32[I, 3, 4] object-to-world transforms
    """
    n_inst = len(inst_model)
    assert n_inst >= 1

    # world boxes of each instance root for the pairing step
    wb_min = np.empty((n_inst, 3), np.float64)
    wb_max = np.empty((n_inst, 3), np.float64)
    for i in range(n_inst):
        mb = model_bvhs[inst_model[i]]
        wb_min[i], wb_max[i] = tf.transform_box(mb.vmin[0], mb.vmax[0],
                                                inst_transform[i])

    tree = agglomerative_pairing(wb_min, wb_max)

    # sizes: a top leaf is replaced by its whole model subtree
    def subtree_size(t):
        if t[0] == 'leaf':
            return len(model_bvhs[inst_model[t[1]]].vmin)
        return 1 + subtree_size(t[1]) + subtree_size(t[2])

    total_nodes = subtree_size(tree)
    vmin = np.empty((total_nodes, 3), np.float32)
    vmax = np.empty((total_nodes, 3), np.float32)
    miss = np.empty(total_nodes, np.int32)
    leaf_start = np.zeros(total_nodes, np.int32)
    leaf_count = np.zeros(total_nodes, np.int32)

    # world triangle layout: instances in tree-leaf visit order
    wtri_base = np.zeros(n_inst, np.int64)

    segs_v = []
    segs_gid = []
    segs_inst = []
    wt = 0

    def emit(t, pos, cont):
        nonlocal wt
        if t[0] == 'leaf':
            inst = t[1]
            m = inst_model[inst]
            mb = model_bvhs[m]
            mcount = len(mb.vmin)
            # conservative world boxes for every node of the subtree
            mn, mx = _transform_boxes(mb.vmin, mb.vmax, inst_transform[inst])
            vmin[pos:pos + mcount] = mn
            vmax[pos:pos + mcount] = mx
            miss[pos:pos + mcount] = np.where(mb.miss < 0, cont, mb.miss + pos)
            leaf_start[pos:pos + mcount] = mb.leaf_start + wt
            leaf_count[pos:pos + mcount] = mb.leaf_count
            # bake world triangles
            s = model_tri_starts[m]
            c = model_tri_counts[m]
            w0 = tf.transform_points(inst_transform[inst], tri_v0[s:s + c]).astype(np.float32)
            w1 = tf.transform_points(inst_transform[inst], tri_v1[s:s + c]).astype(np.float32)
            w2 = tf.transform_points(inst_transform[inst], tri_v2[s:s + c]).astype(np.float32)
            segs_v.append((w0, w1, w2))
            segs_gid.append(np.arange(s, s + c, dtype=np.int32))
            segs_inst.append(np.full(c, inst, np.int32))
            wtri_base[inst] = wt
            wt += c
            return pos + mcount
        # inner top-level node
        lsize = subtree_size(t[1])
        right_pos = pos + 1 + lsize
        end = emit(t[1], pos + 1, right_pos)
        end2 = emit(t[2], right_pos, cont)
        vmin[pos] = np.minimum(vmin[pos + 1], vmin[right_pos])
        vmax[pos] = np.maximum(vmax[pos + 1], vmax[right_pos])
        miss[pos] = cont
        leaf_count[pos] = 0
        return end2

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        emit(tree, 0, -1)
    finally:
        sys.setrecursionlimit(old_limit)

    w0 = np.concatenate([s[0] for s in segs_v], axis=0)
    w1 = np.concatenate([s[1] for s in segs_v], axis=0)
    w2 = np.concatenate([s[2] for s in segs_v], axis=0)
    return WorldBVH(vmin, vmax, miss, leaf_start, leaf_count,
                    w0, w1, w2,
                    np.concatenate(segs_gid), np.concatenate(segs_inst),
                    wtri_base)


def _transform_boxes(vmin: np.ndarray, vmax: np.ndarray, m34: np.ndarray):
    """Vectorized 8-corner conservative transform of [N] boxes."""
    n = len(vmin)
    # corners [N, 8, 3] via binary masks
    masks = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                      [1, 1, 1], [0, 1, 1], [1, 0, 1], [1, 1, 0]], np.float32)
    corners = vmin[:, None, :] * (1 - masks)[None] + vmax[:, None, :] * masks[None]
    rot = np.asarray(m34, np.float32)[:3, :3]
    trans = np.asarray(m34, np.float32)[:3, 3]
    w = corners @ rot.T + trans
    return w.min(axis=1).astype(np.float32), w.max(axis=1).astype(np.float32)
