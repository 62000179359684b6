"""Flatten a binary BVH into a threaded (stackless) layout for TPU traversal.

TPU-first redesign of the traversal data structure: instead of the reference's
per-ray short stack (src/kernels.h:202-275), nodes are stored in DFS pre-order
with a precomputed *miss link*. Traversal is then a single uniform loop

    node = (inner and box-hit) ? node + 1 : miss[node]

with no stack and no data-dependent memory footprint — exactly the shape a
vmapped `lax.while_loop` wants: one gather + elementwise ops per step across
the whole wavefront. A sentinel miss link of -1 terminates.

The price is a fixed left-first ordering chosen at build time instead of the
reference's per-ray ordered descent; the slab test's t-early-out (boxtest,
src/kernels.h:194-200) still prunes by the current best hit.

The port's copy of ``cuda_pathtracer_tpu/accel/flatten.py``; the port reads
the model root boxes and the world triangle layout built on it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .bvh import BVHNodes


class ThreadedBVH(NamedTuple):
    vmin: np.ndarray        # f32[N, 3]
    vmax: np.ndarray        # f32[N, 3]
    miss: np.ndarray        # i32[N]  (next node when skipped / after a leaf; -1 = done)
    leaf_start: np.ndarray  # i32[N]  first triangle (local to the model block)
    leaf_count: np.ndarray  # i32[N]  0 = inner node


def thread_bvh(nodes: BVHNodes) -> ThreadedBVH:
    """DFS pre-order flatten with miss links.

    The continuation of a node's subtree is tracked in the *source* index
    space: the left child's continuation is its right sibling, the right
    child inherits the parent's continuation (-1 at the root).
    """
    n = len(nodes.vmin)
    order = np.empty(n, np.int32)      # preorder position -> source index
    cont = np.empty(n, np.int64)       # preorder position -> continuation (source idx, -1 end)
    new_pos = np.empty(n, np.int64)    # source index -> preorder position

    stack = [(0, -1)]
    pos = 0
    while stack:
        old, c = stack.pop()
        order[pos] = old
        cont[pos] = c
        new_pos[old] = pos
        pos += 1
        if nodes.leaf_count[old] == 0:
            l = int(nodes.left[old])
            stack.append((l + 1, c))   # right child: inherit continuation
            stack.append((l, l + 1))   # left child: continue at right sibling
    assert pos == n

    miss = np.where(cont >= 0, new_pos[np.maximum(cont, 0)], -1).astype(np.int32)

    return ThreadedBVH(
        vmin=nodes.vmin[order],
        vmax=nodes.vmax[order],
        miss=miss,
        leaf_start=nodes.leaf_start[order],
        leaf_count=nodes.leaf_count[order])
