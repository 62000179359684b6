"""Wide (16-ary) BVH with fat 512-byte rows — the TPU-native traversal layout.

Motivation (measured on TPU v5e, tools/tpu_gather_curve.py): XLA row-gathers
cost ~2-7 ns per ROW with a large fixed per-step cost, nearly independent of
row width up to 512B. A binary BVH walk does one 32-byte gather per visited
node (~17-205 visits/ray on sibenik); collapsing to a 16-ary tree with
512-byte rows cuts visits ~4-8x while each iteration still costs ONE gather.

Every row of the table is float32[128] and is either:
  inner:  [0] = +n_children
          [1:97]   vminx[16] vminy[16] vminz[16] vmaxx[16] vmaxy[16] vmaxz[16]
          [97:113] child row refs (bitcast int32)
          empty slots get inside-out boxes (never hit)
  leaf:   [0] = -n_tris   (1..12)
          [1:109]   triangles in FIELD-MAJOR order: field j of all 12 tris
                    at [1+12j : 1+12j+12], j over (v0x v0y v0z v1x v1y v1z
                    v2x v2y v2z), world space. Field-major lets the Pallas
                    packet kernel (ops/traverse_packet.py) slice per-field
                    [12,1] vectors from a transposed row with NO reshape
                    (Mosaic rejects general shape casts).
          [109:121] world-triangle indices (bitcast int32) into the flat
                    WorldArrays triangle list (for shading attribute lookup)

This realizes BASELINE.json's "width-flattened BVH traversed by a masked
short-stack kernel": the traversal (ops/traverse_wide.py) keeps a per-lane
short stack of (node, visited-mask) pairs, one entry per tree level.

The reference's QBVH ambition was left as a stub (makeQBVH,
src/bvhBuilder.h:418-422); this is its realized TPU-native form.

The port's copy of ``cuda_pathtracer_tpu/accel/wide.py``: the traversal
tables (``ops/traverse_packet.py``, ``ops/traverse_packet2.py``) derive from
this table. The greedy collapse and its fill and cost knobs (``CPT_COLLAPSE``,
``CPT_WIDE_FILL``, ``CPT_DP_CLEAF``) are left out; the DP collapse is the JAX
package's default.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .bvh import BVHNodes, _surface_area

ROW = 128
ARITY = 16
LEAF_MAX = 12

INNER_BOX0 = 1
INNER_REFS = 97
LEAF_TRIS = 1
LEAF_GIDS = 109
LEAF_GID_MAX = LEAF_GIDS + LEAF_MAX  # 121


class WideBVH(NamedTuple):
    rows: np.ndarray   # f32[N, 128] (int fields bitcast)
    depth: int         # max tree depth (for traversal stack sizing)


def _collect_leaf_ranges(nodes: BVHNodes, idx: int):
    out = []
    stack = [idx]
    while stack:
        i = stack.pop()
        if nodes.leaf_count[i] > 0:
            out.append((int(nodes.leaf_start[i]), int(nodes.leaf_count[i])))
        else:
            stack.append(int(nodes.left[i]))
            stack.append(int(nodes.left[i]) + 1)
    return out


def _dp_collapse_plan(nodes: BVHNodes, tris_count: np.ndarray,
                      c_leaf: float, c_node: float):
    """Optimal binary->16-ary partition (the collapse DP of Ylitie et al.
    2017, re-derived for this row format; replaces the greedy largest-area
    expansion whose bottom nodes average 4.2 of 16 slots on sibenik).

    C[n, j] = min expected visit cost of covering subtree n with a FOREST
    of at most j wide-node slots. C[n,1] chooses leaf (tris <= LEAF_MAX,
    flat cost — the kernel's leaf visit prices 12 tris at one price) vs an
    internal wide node (c_node + optimal distribution of its two binary
    children over ARITY slots). Visit probability ~ surface area (single-
    ray SAH; the exact union sim prices the result on real wavefronts —
    tools/collapse_ab.py).

    Returns (leaf_better, whole, kbest, kdist): per-node emit decisions.
    Vectorized level-by-level so the 2M-tri class plans in seconds.
    """
    N = nodes.vmin.shape[0]
    K = ARITY
    # fp32 throughout: costs are relative SAH estimates, and the [N, 17]
    # tables are the peak host allocation at 2M tris (~4M binary nodes)
    A = _surface_area(nodes.vmin, nodes.vmax).astype(np.float32)
    is_leaf = nodes.leaf_count > 0
    left = nodes.left.astype(np.int64)

    # depth levels (children = left, left+1)
    depth = np.zeros(N, np.int32)
    order = [np.array([0], np.int64)]
    cur = order[0]
    while True:
        cur = cur[~is_leaf[cur]]
        if cur.size == 0:
            break
        nxt = np.concatenate([left[cur], left[cur] + 1])
        depth[nxt] = depth[cur[0]] + 1
        order.append(nxt)
        cur = nxt

    INF = np.float32(1e30)
    C = np.full((N, K + 1), INF, np.float32)
    whole = np.zeros((N, K + 1), bool)
    kbest = np.zeros((N, K + 1), np.int8)
    kdist = np.zeros(N, np.int8)      # argmin k of the ARITY-way dist
    leaf_better = np.zeros(N, bool)

    lf = np.where(is_leaf)[0]
    C[lf, 1:] = (c_leaf * A[lf])[:, None]
    whole[lf, :] = True
    leaf_better[lf] = True

    for lev in reversed(order):
        n = lev[~is_leaf[lev]]
        if n.size == 0:
            continue
        l, r = left[n], left[n] + 1
        Cl, Cr = C[l], C[r]                      # [M, K+1]
        dist = np.full((n.size, K + 1), INF, np.float32)
        karg = np.zeros((n.size, K + 1), np.int8)
        for j in range(2, K + 1):
            for k in range(1, j):
                cand = Cl[:, k] + Cr[:, j - k]
                better = cand < dist[:, j]
                dist[better, j] = cand[better]
                karg[better, j] = k
        cleaf = np.where(tris_count[n] <= LEAF_MAX, c_leaf * A[n], INF)
        cwide = c_node * A[n] + dist[:, K]
        cwhole = np.minimum(cleaf, cwide)
        leaf_better[n] = cleaf <= cwide
        kdist[n] = karg[:, K]
        C[n, 1] = cwhole
        whole[n, 1] = True
        kbest[n, 1] = 0
        for j in range(2, K + 1):
            w = cwhole <= dist[:, j]
            C[n, j] = np.where(w, cwhole, dist[:, j])
            whole[n, j] = w
            kbest[n, j] = np.where(w, 0, karg[:, j])
    return leaf_better, whole, kbest, kdist


def build_wide_bvh(nodes: BVHNodes, tri_v0: np.ndarray, tri_v1: np.ndarray,
                   tri_v2: np.ndarray, tri_index_base: int = 0) -> WideBVH:
    """Collapse a binary BVH into the fat-row 16-ary layout with the DP
    collapse plan (the JAX package's default ``CPT_COLLAPSE=dp``, fill
    'default', ``c_leaf`` 1.4).

    tri_v0/1/2: the triangle block the binary build's leaf ranges refer to
    (already permuted). tri_index_base offsets the stored triangle indices so
    they address a global flat triangle array.
    """
    rows: list[np.ndarray] = []
    max_depth = [0]

    def emit_leaf(ranges) -> int:
        """Pack triangle ranges (≤ LEAF_MAX total tris) into one leaf row."""
        row = np.zeros(ROW, np.float32)
        tris = []
        gids = []
        for start, count in ranges:
            for k in range(count):
                tris.append(np.concatenate([tri_v0[start + k], tri_v1[start + k],
                                            tri_v2[start + k]]))
                gids.append(tri_index_base + start + k)
        n = len(tris)
        assert 1 <= n <= LEAF_MAX
        row[0] = -float(n)
        # field-major: [9, LEAF_MAX] flattened; absent tris stay zero
        fm = np.zeros((9, LEAF_MAX), np.float32)
        fm[:, :n] = np.stack(tris, axis=1)
        row[LEAF_TRIS:LEAF_TRIS + 9 * LEAF_MAX] = fm.reshape(-1)
        row[LEAF_GIDS:LEAF_GIDS + n] = np.frombuffer(
            np.asarray(gids, np.int32).tobytes(), np.float32)
        rows.append(row)
        return len(rows) - 1

    def emit_inner(slots, depth: int, emit_child) -> int:
        """Reserve + fill one inner row whose children are `slots`."""
        row_id = len(rows)
        rows.append(np.zeros(ROW, np.float32))  # reserve position
        row = np.zeros(ROW, np.float32)
        row[0] = float(len(slots))
        refs = np.zeros(ARITY, np.int32)
        # inside-out boxes for empty slots
        box = np.zeros((6, ARITY), np.float32)
        box[0:3] = 3.0e38
        box[3:6] = -3.0e38
        for k, s in enumerate(slots):
            box[0:3, k] = nodes.vmin[s]
            box[3:6, k] = nodes.vmax[s]
            refs[k] = emit_child(s, depth + 1)
        row[INNER_BOX0:INNER_BOX0 + 6 * ARITY] = box.reshape(-1)
        row[INNER_REFS:INNER_REFS + ARITY] = np.frombuffer(
            refs.tobytes(), np.float32)
        rows[row_id] = row
        return row_id

    # cost constants from the measured kernel step prices of the JAX
    # package's packet kernel: c_leaf/c_node = 1.4
    def emit_dp(idx: int, depth: int) -> int:
        max_depth[0] = max(max_depth[0], depth)
        if leaf_better[idx]:
            return emit_leaf(_collect_leaf_ranges(nodes, idx))
        l = int(nodes.left[idx])
        k = int(kdist[idx])
        slots = roots(l, k) + roots(l + 1, ARITY - k)
        return emit_inner(slots, depth, emit_dp)

    def roots(m: int, j: int) -> list:
        """Forest roots realizing C[m, j] (DP backtrack)."""
        if j <= 1 or whole[m, j]:
            return [m]
        k = int(kbest[m, j])
        l = int(nodes.left[m])
        return roots(l, k) + roots(l + 1, j - k)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        if nodes.leaf_count[0] == 0:
            # vectorized bottom-up subtree triangle counts
            is_lf = nodes.leaf_count > 0
            lft = nodes.left.astype(np.int64)
            tris_count = np.where(is_lf, nodes.leaf_count, 0).astype(np.int64)
            levels = [np.array([0], np.int64)]
            cur = levels[0]
            while True:
                cur = cur[~is_lf[cur]]
                if cur.size == 0:
                    break
                nxt = np.concatenate([lft[cur], lft[cur] + 1])
                levels.append(nxt)
                cur = nxt
            for lev in reversed(levels):
                n = lev[~is_lf[lev]]
                if n.size:
                    tris_count[n] = (tris_count[lft[n]]
                                     + tris_count[lft[n] + 1])
            leaf_better, whole, kbest, kdist = _dp_collapse_plan(
                nodes, tris_count, c_leaf=1.4, c_node=1.0)
            root = emit_dp(0, 1)
        else:
            # a single-leaf model (at most BVH_LEAF_SIZE triangles)
            max_depth[0] = 1
            root = emit_leaf(_collect_leaf_ranges(nodes, 0))
    finally:
        sys.setrecursionlimit(old)
    assert root == 0
    return WideBVH(np.stack(rows), max_depth[0])


def transform_wide_rows(rows: np.ndarray, m34: np.ndarray) -> np.ndarray:
    """Apply an affine transform to a model-space wide table: triangles are
    transformed exactly, inner boxes conservatively (8-corner), refs kept.
    Vectorized over all rows (the per-invalidation instance rebake)."""
    out = rows.copy()
    tag = rows[:, 0]
    rot = np.asarray(m34[:, :3], np.float32)
    trn = np.asarray(m34[:, 3], np.float32)

    leaf = tag < 0
    if leaf.any():
        # field-major [9, 12] per row -> [R, 3 verts, 3 xyz, 12 tris]
        tr = rows[leaf, LEAF_TRIS:LEAF_TRIS + 9 * LEAF_MAX].reshape(-1, 3, 3, LEAF_MAX)
        w = np.einsum('ij,rvjt->rvit', rot, tr) + trn[None, None, :, None]
        out[leaf, LEAF_TRIS:LEAF_TRIS + 9 * LEAF_MAX] = w.reshape(leaf.sum(), -1)

    inner = tag > 0
    if inner.any():
        box = rows[inner, INNER_BOX0:INNER_BOX0 + 6 * ARITY].reshape(-1, 6, ARITY)
        vmin = box[:, 0:3].transpose(0, 2, 1)   # [R, 16, 3]
        vmax = box[:, 3:6].transpose(0, 2, 1)
        masks = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                          [1, 1, 1], [0, 1, 1], [1, 0, 1], [1, 1, 0]], np.float32)
        corners = vmin[:, :, None, :] * (1 - masks) + vmax[:, :, None, :] * masks
        wc = corners @ rot.T + trn
        nmin = wc.min(axis=2)
        nmax = wc.max(axis=2)
        empty = vmin[..., 0] > 1e38  # keep inside-out slots inside-out
        nmin = np.where(empty[..., None], vmin, nmin)
        nmax = np.where(empty[..., None], vmax, nmax)
        nb = np.concatenate([nmin.transpose(0, 2, 1),
                             nmax.transpose(0, 2, 1)], axis=1)
        out[inner, INNER_BOX0:INNER_BOX0 + 6 * ARITY] = nb.reshape(inner.sum(), -1)
    return out


def offset_wide_refs(rows: np.ndarray, offset: int) -> np.ndarray:
    """Shift child refs when splicing a model table into the world table."""
    out = rows.copy()
    inner = rows[:, 0] > 0
    refs = out[inner, INNER_REFS:INNER_REFS + ARITY].view(np.int32)
    out[inner, INNER_REFS:INNER_REFS + ARITY] = (refs + offset).view(np.float32)
    return out


def offset_wide_gids(rows: np.ndarray, offset: int) -> np.ndarray:
    """Shift stored triangle indices (leaf rows)."""
    out = rows.copy()
    leaf = rows[:, 0] < 0
    gids = out[leaf, LEAF_GIDS:LEAF_GID_MAX].view(np.int32)
    n = (-rows[leaf, 0]).astype(np.int32)
    valid = np.arange(LEAF_MAX)[None, :] < n[:, None]
    out[leaf, LEAF_GIDS:LEAF_GID_MAX] = np.where(
        valid, gids + offset, gids).view(np.float32)
    return out


def build_world_wide(model_wides: list[WideBVH],
                     inst_model: np.ndarray,
                     inst_transform: np.ndarray,
                     wtri_bases: list[int]) -> WideBVH:
    """Merge per-instance transformed wide tables under 16-ary top nodes.

    wtri_bases: base index of each INSTANCE's triangles in the flat world
    triangle array (leaf gids in model tables are local tri indices).
    """
    n_inst = len(inst_model)
    segs = []
    roots = []
    root_boxes = []
    # top-level fan-out: reserve top rows first (a chain of 16-ary levels
    # when there are more than 16 instances)
    n_top = 0
    cnt = n_inst
    while cnt > 1:
        n_top += (cnt + ARITY - 1) // ARITY
        cnt = (cnt + ARITY - 1) // ARITY
    pos = n_top
    for i in range(n_inst):
        mw = model_wides[inst_model[i]]
        rows = transform_wide_rows(mw.rows, inst_transform[i])
        rows = offset_wide_refs(rows, pos)
        rows = offset_wide_gids(rows, wtri_bases[i])
        segs.append(rows)
        roots.append(pos)
        # root box of this instance subtree
        tag = rows[0, 0]
        if tag > 0:
            box = rows[0, INNER_BOX0:INNER_BOX0 + 6 * ARITY].reshape(6, ARITY)
            valid = box[0] < 1e38
            bmin = box[0:3, valid].min(axis=1)
            bmax = box[3:6, valid].max(axis=1)
        else:
            ntr = int(-tag)
            # field-major: [3 verts, 3 xyz, 12 tris]
            t = rows[0, LEAF_TRIS:LEAF_TRIS + 9 * LEAF_MAX].reshape(3, 3, LEAF_MAX)
            pts = t[:, :, :ntr].transpose(0, 2, 1).reshape(-1, 3)
            bmin = pts.min(axis=0)
            bmax = pts.max(axis=0)
        root_boxes.append((bmin, bmax))
        pos += len(rows)

    if n_top == 0:
        depth = max(mw.depth for mw in model_wides)
        return WideBVH(segs[0], depth)

    # build the top levels bottom-up: group current roots 16 at a time until
    # one remains; rows are placed in the reserved [0, n_top) region with the
    # final root at row 0 (emitted last, in reverse order)
    def make_group(children):
        """children: list of (row_id, bmin, bmax) -> a top row array."""
        top = np.zeros(ROW, np.float32)
        top[0] = float(len(children))
        box = np.zeros((6, ARITY), np.float32)
        box[0:3] = 3.0e38
        box[3:6] = -3.0e38
        refs = np.zeros(ARITY, np.int32)
        gmin = np.full(3, 3.0e38)
        gmax = np.full(3, -3.0e38)
        for i, (r, bmin, bmax) in enumerate(children):
            box[0:3, i] = bmin
            box[3:6, i] = bmax
            refs[i] = r
            gmin = np.minimum(gmin, bmin)
            gmax = np.maximum(gmax, bmax)
        top[INNER_BOX0:INNER_BOX0 + 6 * ARITY] = box.reshape(-1)
        top[INNER_REFS:INNER_REFS + ARITY] = np.frombuffer(refs.tobytes(),
                                                           np.float32)
        return top, gmin, gmax

    level = [(roots[i], root_boxes[i][0], root_boxes[i][1])
             for i in range(n_inst)]
    top_rows = [None] * n_top
    next_free = n_top  # allocate reserved slots from the back
    levels = 0
    while len(level) > 1:
        levels += 1
        nxt = []
        for g in range(0, len(level), ARITY):
            chunk = level[g:g + ARITY]
            next_free -= 1
            row, gmin, gmax = make_group(chunk)
            top_rows[next_free] = row
            nxt.append((next_free, gmin, gmax))
        level = nxt
    assert next_free == 0 and level[0][0] == 0
    depth = max(mw.depth for mw in model_wides) + levels
    return WideBVH(np.concatenate([np.stack(top_rows), *segs]), depth)
