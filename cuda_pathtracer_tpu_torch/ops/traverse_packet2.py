"""Closest-hit / any-hit traversal of the merged 16-ary world BVH (counterpart
of ``cuda_pathtracer_tpu/ops/traverse_packet2.py``).

The merged table (:func:`build_merged_table`, host numpy) stores each inner
node's children as one contiguous block of rows ``[base, base + n)``, inner
children first, so a visit needs only ``(hitmask, base | n_inner << 20)``:

  * inner row: six 16-wide box blocks (lo x, lo y, lo z, hi x, hi y, hi z) at
    [0:96], NaN in empty slots; the meta word ``base | n_inner << 20`` as
    int32 bits at [96]; ``(1 << n_inner) - 1`` at [97] (unused here);
  * leaf row: up to 12 triangles as v0, e1 = v1 - v0, e2 = v2 - v0 in
    field-major 9 x 12 order at [0:108]; world-triangle ids as int32 bits at
    [108:120].

:func:`traverse_merged` launches ``csrc/traverse.cu`` (one 16-lane group per
ray, a lane per child slot) on CUDA tensors; :func:`traverse_merged_ref` is
the plain PyTorch version of the same walk, used on the CPU and as the
kernel's reference on the card.
Both descend lowest slot first with a stack of (hitmask, meta) entries and
test a leaf's triangles against the ``t`` the ray had on entering the leaf;
within a leaf an exact-``t`` tie goes to the lowest triangle id. The TPU
kernel walks 128-ray packets over the union of their hitmasks; per ray the
closest ``t`` is the same, and ``prim_id`` can differ only on exact-``t``
ties between leaves.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import intersect as isect
from . import kernels
from .traverse import Hit, Prepass, merge_hit
from ..accel.wide import (ARITY, LEAF_MAX, INNER_BOX0,
                                            INNER_REFS, LEAF_TRIS, LEAF_GIDS,
                                            LEAF_GID_MAX)

ROW = 128
PBOX0 = 0
PMETA = 96
PMETA2 = 97
PTRIS = 0
PGIDS = 108
META_BASE_BITS = 20
BIG = 3.0e38
MT_DET_EPS = 1e-4


class MergedTable(NamedTuple):
    rows: torch.Tensor | np.ndarray  # f32[N, 128]
    depth: int                       # max depth of the tree


def _leaf_payload(leaf_row: np.ndarray) -> np.ndarray:
    """(v0, e1, e2) field-major payload of one wide leaf row."""
    fm = leaf_row[LEAF_TRIS:LEAF_TRIS + 9 * LEAF_MAX].reshape(3, 3, LEAF_MAX)
    return np.concatenate([fm[0], fm[1] - fm[0], fm[2] - fm[0]], axis=0).reshape(-1)


class MergedRefitMaps(NamedTuple):
    """Static per-topology maps that derive the merged table from the
    refitted v1 split tables (:func:`derive_merged`)."""
    from_inner: torch.Tensor   # i64[NM] v1 inner row (junk where a leaf)
    from_leaf: torch.Tensor    # i64[NM] v1 leaf row (junk where inner)
    is_leaf: torch.Tensor      # bool[NM]
    slot_order: torch.Tensor   # i64[NM, 16] merged slot -> wide slot
    meta: torch.Tensor         # f32[NM] static meta word (int32 bits)
    meta2: torch.Tensor        # f32[NM] static inner-slot mask (int32 bits)


def _merged(wide_rows: np.ndarray):
    """The merged rows in BFS order, with (row_map wide row -> merged row,
    is_leaf per merged row, slot order per merged row)."""
    src = np.asarray(wide_rows, np.float32)
    tag = src[:, 0]
    n = len(src)
    if n == 0 or (tag > 0).sum() == 0:
        # single-leaf or empty scene: synthesize an inner root over one leaf
        rows = np.zeros((2, ROW), np.float32)
        box = np.full((6, ARITY), np.nan, np.float32)
        if n:
            box[0:3, 0] = -BIG
            box[3:6, 0] = BIG
        rows[0, PBOX0:PBOX0 + 96] = box.reshape(-1)
        rows[0, PMETA] = np.int32(1).view(np.float32)   # base=1, n_inner=0
        row_map = np.full(max(n, 1), -1, np.int32)
        if n and tag[0] < 0:
            rows[1, PTRIS:PTRIS + 9 * LEAF_MAX] = _leaf_payload(src[0])
            rows[1, PGIDS:PGIDS + LEAF_MAX] = src[0, LEAF_GIDS:LEAF_GID_MAX]
        if n:
            row_map[0] = 1
        return (rows, row_map, np.array([False, True]),
                np.tile(np.arange(ARITY, dtype=np.int32), (2, 1)))

    if tag[0] <= 0:
        raise ValueError('wide root must be an inner row')
    refs_all = src[:, INNER_REFS:INNER_REFS + ARITY].view(np.int32)
    nch_all = src[:, 0].astype(np.int32)

    # level-synchronous BFS: every non-root wide row is someone's child
    # exactly once, so the merged table has exactly n rows
    rows = np.zeros((n, ROW), np.float32)
    row_map = np.full(n, -1, np.int32)
    is_leaf_m = np.zeros(n, bool)
    slot_order_m = np.tile(np.arange(ARITY, dtype=np.int32), (n, 1))
    iota = np.arange(ARITY, dtype=np.int32)
    frontier_old = np.array([0], np.int32)
    frontier_new = np.array([0], np.int32)
    row_map[0] = 0
    next_free = 1
    while len(frontier_old):
        refs = refs_all[frontier_old]
        nch = nch_all[frontier_old]
        valid = iota[None, :] < nch[:, None]
        inner_c = valid & (tag[np.clip(refs, 0, n - 1)] > 0)
        # slot order: inner children first (stable), then leaves, then empty
        key = np.where(inner_c, 0, np.where(valid, 1, 2))
        order = np.argsort(key, axis=1, kind='stable').astype(np.int32)
        n_inner = inner_c.sum(1).astype(np.int32)
        sizes = nch.astype(np.int64)
        bases = next_free + np.concatenate(
            [[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        next_free = int(next_free + sizes.sum())
        if next_free > (1 << META_BASE_BITS):
            raise ValueError('merged table exceeds the 20-bit child base')
        ordered_refs = np.take_along_axis(refs, order, axis=1)
        ordered_valid = np.take_along_axis(valid, order, axis=1)
        box = src[frontier_old, INNER_BOX0:INNER_BOX0 + 96].reshape(-1, 6, ARITY)
        newbox = np.take_along_axis(box, order[:, None, :], axis=2).copy()
        newbox[np.broadcast_to((~ordered_valid)[:, None, :],
                               newbox.shape)] = np.nan
        rows[frontier_new, PBOX0:PBOX0 + 96] = newbox.reshape(-1, 96)
        rows[frontier_new, PMETA] = (bases.astype(np.int32)
                                     | (n_inner << META_BASE_BITS)).view(np.float32)
        rows[frontier_new, PMETA2] = ((np.int32(1) << n_inner)
                                      - 1).astype(np.int32).view(np.float32)
        slot_order_m[frontier_new] = order
        child_old = ordered_refs[ordered_valid]
        child_new = (bases[:, None] + iota[None, :].astype(np.int64))[
            ordered_valid].astype(np.int32)
        row_map[child_old] = child_new
        child_is_inner = tag[child_old] > 0
        lo = child_old[~child_is_inner]
        ln = child_new[~child_is_inner]
        if len(lo):
            fm = src[lo, LEAF_TRIS:LEAF_TRIS + 9 * LEAF_MAX].reshape(
                -1, 3, 3, LEAF_MAX)
            pk = np.concatenate([fm[:, 0], fm[:, 1] - fm[:, 0],
                                 fm[:, 2] - fm[:, 0]], axis=1)
            rows[ln, PTRIS:PTRIS + 9 * LEAF_MAX] = pk.reshape(len(lo), -1)
            rows[ln, PGIDS:PGIDS + LEAF_MAX] = src[lo, LEAF_GIDS:LEAF_GID_MAX]
            is_leaf_m[ln] = True
        frontier_old = child_old[child_is_inner]
        frontier_new = child_new[child_is_inner]
    if next_free != n:
        raise ValueError(f'merged table has {next_free} rows, expected {n}')
    return rows, row_map, is_leaf_m, slot_order_m


def build_merged_table(wide_rows: np.ndarray, depth: int) -> MergedTable:
    """The merged contiguous-children table from the wide table
    (``accel/wide.py`` layout), in BFS order, bit-identical to the JAX
    package's ``build_merged_table`` with its default slot order."""
    return MergedTable(_merged(wide_rows)[0], depth)


def build_refit_maps(wide_rows: np.ndarray, device) -> MergedRefitMaps:
    """Compose the merged BFS mapping with the v1 split-table mapping, as
    the JAX package's ``build_refit_maps``; tensors on ``device``."""
    src = np.asarray(wide_rows, np.float32)
    tag = src[:, 0]
    inner_ids = np.flatnonzero(tag > 0)
    leaf_ids = np.flatnonzero(tag < 0)
    inner_pos = np.zeros(len(src), np.int64)
    inner_pos[inner_ids] = np.arange(len(inner_ids))
    leaf_pos = np.zeros(len(src), np.int64)
    leaf_pos[leaf_ids] = np.arange(len(leaf_ids))
    rows, row_map, is_leaf, slot_order = _merged(src)
    old_of = np.zeros(len(rows), np.int64)
    old_of[row_map] = np.arange(len(row_map))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return MergedRefitMaps(
        from_inner=t(inner_pos[old_of]), from_leaf=t(leaf_pos[old_of]),
        is_leaf=t(is_leaf), slot_order=t(slot_order.astype(np.int64)),
        meta=t(rows[:, PMETA]), meta2=t(rows[:, PMETA2]))


def derive_merged(inner_rows, leaf_rows, maps: MergedRefitMaps):
    """The merged table from refitted v1 split tables: row gathers and a
    static slot permutation, on the tables' device (topology is frozen)."""
    nm = maps.is_leaf.shape[0]
    gi = inner_rows[maps.from_inner.clamp(0, inner_rows.shape[0] - 1)]
    boxes = gi[:, :96].reshape(nm, 6, ARITY)
    boxes = torch.gather(boxes, 2, maps.slot_order[:, None, :].expand(
        nm, 6, ARITY)).reshape(nm, 96)
    pad = torch.zeros((nm, ROW - 98), dtype=torch.float32,
                      device=inner_rows.device)
    inner_m = torch.cat([boxes, maps.meta[:, None], maps.meta2[:, None], pad],
                        dim=1)
    gl = leaf_rows[maps.from_leaf.clamp(0, leaf_rows.shape[0] - 1)]
    return torch.where(maps.is_leaf[:, None], gl, inner_m)


def traverse_merged_ref(table: MergedTable, ro, rd, t0, live, stop,
                        want_uv: bool = False, stats: dict | None = None):
    """Plain PyTorch walk of the merged table, one stack per ray.

    ro, rd: f32[B, 3]; t0: f32[B] (the ray's t after the analytic prepass);
    live: bool[B] rays to trace; stop: bool[B] rays that end at their first
    hit (any-hit). Returns (t f32[B], gid i32[B] world-triangle id or -1,
    found bool[B], u, v) with u, v f32[B] when ``want_uv`` else None.
    ``stats``, when given, receives the work this walk did: inner and leaf
    visits (``inner``, ``leaf``) and the rows it touched (``rows``, bool[N]).
    """
    kernels.note_plain('traverse', ro)
    dev = ro.device
    B = ro.shape[0]
    rows = table.rows
    rows_i = rows.view(torch.int32)
    inv = isect.safe_inv_dir(rd)
    oiv = ro * inv
    t = t0.clone()
    gid = torch.full((B,), -1, dtype=torch.int32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    u = torch.zeros(B, dtype=torch.float32, device=dev)
    v = torch.zeros(B, dtype=torch.float32, device=dev)
    # stack entry: hitmask (16 bits) | meta << 16
    stack = torch.zeros((B, table.depth + 2), dtype=torch.int64, device=dev)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    cur = torch.zeros(B, dtype=torch.int64, device=dev)
    is_leaf = torch.zeros(B, dtype=torch.bool, device=dev)
    act = live.clone()
    slot = torch.arange(ARITY, dtype=torch.int64, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    if stats is not None:
        stats.update(inner=0, leaf=0, rows=torch.zeros(
            rows.shape[0], dtype=torch.bool, device=dev))
    while True:
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        lf = is_leaf[idx]
        if stats is not None:
            n_leaf = int(lf.sum())
            stats['leaf'] += n_leaf
            stats['inner'] += idx.numel() - n_leaf
            stats['rows'][cur[idx]] = True

        # inner visit: slab-test the 16 children, push the hitmask
        ii = idx[~lf]
        if ii.numel():
            r = rows[cur[ii]]
            bx = r[:, PBOX0:PBOX0 + 96].reshape(-1, 6, ARITY)
            iv = inv[ii][:, :, None]
            oi = oiv[ii][:, :, None]
            t_lo = bx[:, 0:3] * iv - oi
            t_hi = bx[:, 3:6] * iv - oi
            # torch.minimum/maximum propagate NaN: empty slots never hit
            near = torch.minimum(t_lo, t_hi)
            far = torch.maximum(t_lo, t_hi)
            tmin = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
            tmax = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
            chit = ((tmax >= torch.maximum(tmin, torch.zeros_like(tmin)))
                    & (tmin < t[ii][:, None]))
            bits = (chit.to(torch.int64) << slot).sum(1)
            meta = rows_i[cur[ii], PMETA].to(torch.int64)
            push = bits != 0
            pi = ii[push]
            stack[pi, sp[pi]] = bits[push] | (meta[push] << 16)
            sp[pi] += 1

        # leaf visit: Moller-Trumbore on up to 12 triangles
        li = idx[lf]
        if li.numel():
            r = rows[cur[li]]
            fm = r[:, PTRIS:PTRIS + 9 * LEAF_MAX].reshape(-1, 9, LEAF_MAX)
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = fm.unbind(1)
            o = ro[li]
            d = rd[li]
            ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
            dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            a = (e1x * hx + e1y * hy) + e1z * hz
            f = 1.0 / torch.where(torch.abs(a) < MT_DET_EPS,
                                  torch.ones_like(a), a)
            sx = ox - v0x
            sy = oy - v0y
            sz = oz - v0z
            uu = f * ((sx * hx + sy * hy) + sz * hz)
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            vv = f * ((dx * qx + dy * qy) + dz * qz)
            tt = f * ((e2x * qx + e2y * qy) + e2z * qz)
            ok = ((torch.abs(a) >= MT_DET_EPS) & (uu >= 0.0) & (uu <= 1.0)
                  & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > 0.0)
                  & (tt < t[li][:, None]))
            ttm = torch.where(ok, tt, big)
            leaf_t = ttm.amin(1)
            g = rows_i[cur[li], PGIDS:PGIDS + LEAF_MAX]
            tie = ttm == leaf_t[:, None]
            leaf_g = torch.where(tie, g, torch.full_like(g, 2 ** 30)).amin(1)
            take = ok.any(1)
            tk = li[take]
            t[tk] = leaf_t[take]
            gid[tk] = leaf_g[take]
            found[tk] = True
            if want_uv:
                win = ok & tie & (g == leaf_g[:, None])
                u[tk] = torch.where(win, uu, big).amin(1)[take]
                v[tk] = torch.where(win, vv, big).amin(1)[take]
            act[li[take & stop[li]]] = False

        # pop the next child: lowest set bit of the top entry
        pidx = idx[act[idx]]
        empty = sp[pidx] == 0
        act[pidx[empty]] = False
        pidx = pidx[~empty]
        top = sp[pidx] - 1
        e = stack[pidx, top]
        bits = e & 0xFFFF
        meta = e >> 16
        low = bits & -bits
        j = (((low - 1)[:, None] >> slot) & 1).sum(1)
        rest = bits ^ low
        stack[pidx, top] = rest | (meta << 16)
        sp[pidx] -= (rest == 0).to(torch.int64)
        n_inner = meta >> META_BASE_BITS
        cur[pidx] = (meta & ((1 << META_BASE_BITS) - 1)) + j
        is_leaf[pidx] = j >= n_inner
    return t, gid, found, (u if want_uv else None), (v if want_uv else None)


def traverse_merged(table: MergedTable, ro, rd, t0, live, stop,
                    want_uv: bool = False, *, prepass: Prepass | None = None,
                    active=None):
    """:func:`traverse_merged_ref`'s contract. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/traverse.cu`` (or raise).

    With ``prepass`` (the :class:`Prepass` that gave t0, live and stop) and
    the trace's ``active`` lanes (None: every lane), returns the trace's
    :class:`Hit` instead, the walk's hit merged over the prepass's
    (:func:`merge_hit`; on the card by the kernel's merge epilogue). The
    renderer always passes them; the walk alone, with the seven arguments,
    is there so the walk can be timed and checked on its own (the
    benchmark's traverse roofline, ``chip_smoke.py``)."""
    if ro.device.type == 'cpu':
        out = traverse_merged_ref(table, ro, rd, t0, live, stop, want_uv)
        return out if prepass is None else merge_hit(*out, prepass, active)
    rows = table.rows
    B = ro.shape[0]
    kernels.require_cuda('traverse', rows, ro, rd, t0, live, stop,
                         dtypes=(torch.float32,) * 4 + (torch.bool,) * 2)
    if prepass is not None:
        merge = (prepass.prim_type, prepass.prim_id, prepass.found) + (
            (active,) if active is not None else ())
        kernels.require_cuda('traverse', ro, *merge, dtypes=(
            torch.float32, torch.int32, torch.int32, torch.bool, torch.bool))
        if any(x.shape != (B,) for x in merge):
            raise ValueError('traverse: merge tensors disagree on shape')
    if rows.dim() != 2 or rows.shape[1] != ROW:
        raise ValueError(f'traverse: table must be [N, {ROW}], got {tuple(rows.shape)}')
    if ro.shape != (B, 3) or rd.shape != (B, 3) or t0.shape != (B,) \
            or live.shape != (B,) or stop.shape != (B,):
        raise ValueError('traverse: ray tensors disagree on shape')
    kernels.check_group_count('traverse', B)
    lib = kernels.library()
    if table.depth + 2 > lib.cpt_traverse_max_stack():
        raise ValueError(f'traverse: tree depth {table.depth} exceeds the '
                         f'kernel stack ({lib.cpt_traverse_max_stack()})')
    dev = ro.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    gid = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    u = torch.empty(B, dtype=torch.float32, device=dev) if want_uv else None
    v = torch.empty(B, dtype=torch.float32, device=dev) if want_uv else None
    ptype, merge_ptrs = None, [None] * 5
    if prepass is not None:
        ptype = torch.empty(B, dtype=torch.int32, device=dev)
        merge_ptrs = [x.data_ptr() for x in merge[:3]] + [
            active.data_ptr() if active is not None else None,
            ptype.data_ptr()]
    if B:
        err = lib.cpt_traverse(
            rows.data_ptr(), ro.data_ptr(), rd.data_ptr(), t0.data_ptr(),
            live.data_ptr(), stop.data_ptr(), B, int(want_uv),
            t.data_ptr(), gid.data_ptr(), found.data_ptr(),
            u.data_ptr() if want_uv else None,
            v.data_ptr() if want_uv else None, *merge_ptrs,
            kernels.stream_of(ro))
        kernels.LAUNCHES['traverse'] += 1
        kernels.check(err, 'traverse')
    if prepass is None:
        return t, gid, found, u, v
    # with the merge epilogue gid and found hold prim_id and intersected
    return Hit(t=t, prim_type=ptype, prim_id=gid, intersected=found, u=u, v=v)
