"""Closest-hit / any-hit traversal of the split inner/leaf tables, v1
(counterpart of ``cuda_pathtracer_tpu/ops/traverse_packet.py``).

:func:`split_packet_tables` derives the two tables from the wide table
(``accel/wide.py`` layout), a numpy copy of the JAX package's:

  * inner row: six 16-wide box blocks (lo x, lo y, lo z, hi x, hi y, hi z) at
    [0:96], NaN in empty slots; 16 signed child refs as int32 bits at
    [96:112], >= 0 an inner row and < 0 the leaf row ``~ref``;
  * leaf row: up to 12 triangles as v0, e1 = v1 - v0, e2 = v2 - v0 in
    field-major 9 x 12 order at [0:108]; world-triangle ids as int32 bits at
    [108:120].

These are the tables the scene refits on the device for every animated frame
(``accel/refit.py``); the v2 merged table is re-derived from them
(``ops/traverse_packet2.py::derive_merged``).

:func:`traverse_split` launches ``csrc/traverse_packet.cu`` (one 16-lane group
per ray, a lane per child slot) on CUDA tensors; :func:`traverse_packet_ref`
is the plain PyTorch version of the same walk, used on the CPU and as the
kernel's reference on the card. Both follow the TPU kernel's rules per ray:
nearest-first descent (lowest-index descent for any-hit calls), a (row,
visited-mask) stack whose pop re-fetches the parent row and re-prunes against
the improved ``t``, and lowest triangle id on an exact-``t`` tie inside a
leaf. Neither returns barycentrics. :func:`traverse_packet` adds the
sphere/plane prepass and returns the renderer's :class:`Hit` with ``u = v =
None``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import intersect as isect
from . import kernels
from .traverse import Hit, merge_hit, prepass
from ..accel.wide import (ARITY, LEAF_MAX, INNER_BOX0, INNER_REFS, LEAF_TRIS,
                          LEAF_GIDS, LEAF_GID_MAX)

ROW = 128
PBOX0 = 0
PREFS = 96
PTRIS = 0
PGIDS = 108
BIG = 3.0e38
MT_DET_EPS = 1e-4


class PacketTables(NamedTuple):
    inner: torch.Tensor | np.ndarray   # f32[Ni, 128]
    leaf: torch.Tensor | np.ndarray    # f32[Nl, 128]
    depth: int                         # max depth of the wide tree


def stack_cap(depth: int) -> int:
    """Stack entries per ray, as the TPU kernel sizes one front's stack
    (``_stack_cap(1, depth + 2)``)."""
    return depth + 8


def split_packet_tables(wide_rows: np.ndarray, depth: int,
                        device=None) -> PacketTables:
    """The two packet tables from the wide table, bit-identical to the JAX
    package's ``split_packet_tables``. numpy arrays, or tensors on
    ``device`` when one is given."""
    rows = np.asarray(wide_rows, np.float32)
    tag = rows[:, 0]
    inner_ids = np.flatnonzero(tag > 0)
    leaf_ids = np.flatnonzero(tag < 0)
    remap = np.zeros(len(rows), np.int32)
    remap[inner_ids] = np.arange(len(inner_ids), dtype=np.int32)
    remap[leaf_ids] = ~np.arange(len(leaf_ids), dtype=np.int32)  # <0 => leaf

    if len(inner_ids) == 0:
        # single-leaf scene: synthesize an always-hit inner root
        inner = np.zeros((1, ROW), np.float32)
        box = np.full((6, ARITY), np.nan, np.float32)
        box[0:3, 0] = -BIG
        box[3:6, 0] = BIG
        inner[0, PBOX0:PBOX0 + 96] = box.reshape(-1)
        refs = np.zeros(ARITY, np.int32)
        refs[0] = -1 if len(leaf_ids) else 0   # ~0 == -1 -> leaf row 0
        inner[0, PREFS:PREFS + ARITY] = refs.view(np.float32)
    else:
        if tag[0] <= 0:
            raise ValueError('wide root must be an inner row')
        src = rows[inner_ids]
        inner = np.zeros((len(inner_ids), ROW), np.float32)
        box = src[:, INNER_BOX0:INNER_BOX0 + 96].reshape(-1, 6, ARITY).copy()
        n_child = src[:, 0].astype(np.int32)
        empty = np.arange(ARITY)[None, :] >= n_child[:, None]
        box[:, :, :] = np.where(empty[:, None, :], np.nan, box)
        inner[:, PBOX0:PBOX0 + 96] = box.reshape(-1, 96)
        refs = src[:, INNER_REFS:INNER_REFS + ARITY].view(np.int32)
        refs = np.where(empty, 0, remap[np.clip(refs, 0, len(rows) - 1)])
        inner[:, PREFS:PREFS + ARITY] = refs.astype(np.int32).view(np.float32)

    if len(leaf_ids) == 0:
        leaf = np.zeros((1, ROW), np.float32)
    else:
        src = rows[leaf_ids]
        leaf = np.zeros((len(leaf_ids), ROW), np.float32)
        fm = src[:, LEAF_TRIS:LEAF_TRIS + 9 * LEAF_MAX].reshape(-1, 3, 3,
                                                                LEAF_MAX)
        pk = np.concatenate([fm[:, 0], fm[:, 1] - fm[:, 0],
                             fm[:, 2] - fm[:, 0]], axis=1)  # [R, 9, 12]
        leaf[:, PTRIS:PTRIS + 9 * LEAF_MAX] = pk.reshape(len(leaf_ids), -1)
        leaf[:, PGIDS:PGIDS + LEAF_MAX] = src[:, LEAF_GIDS:LEAF_GID_MAX]
    if device is not None:
        inner = torch.as_tensor(inner, device=device)
        leaf = torch.as_tensor(leaf, device=device)
    return PacketTables(inner, leaf, depth)


def traverse_packet_ref(tables: PacketTables, ro, rd, t0, live, stop,
                        cheap: bool = False, stats: dict | None = None):
    """Plain PyTorch walk of the split tables, one stack per ray.

    ro, rd: f32[B, 3]; t0: f32[B] (the ray's t after the analytic prepass);
    live: bool[B] rays to trace; stop: bool[B] rays that end at their first
    hit; ``cheap``: lowest-index descent (any-hit calls). Returns (t f32[B],
    gid i32[B] world-triangle id or -1, found bool[B]). ``stats``, when
    given, receives the work this walk did: inner and leaf visits
    (``inner``, ``leaf``) and the rows it touched (``inner_rows``,
    ``leaf_rows``, bool per table row).
    """
    kernels.note_plain('traverse_packet', ro)
    dev = ro.device
    B = ro.shape[0]
    inner, leaf = tables.inner, tables.leaf
    inner_i = inner.view(torch.int32)
    leaf_i = leaf.view(torch.int32)
    inv = isect.safe_inv_dir(rd)
    oiv = ro * inv
    t = t0.clone()
    gid = torch.full((B,), -1, dtype=torch.int32, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    S = stack_cap(tables.depth)
    stack_row = torch.zeros((B, S), dtype=torch.int64, device=dev)
    stack_mask = torch.zeros((B, S), dtype=torch.int64, device=dev)
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    cur = torch.zeros(B, dtype=torch.int64, device=dev)   # the root row
    mask = torch.zeros(B, dtype=torch.int64, device=dev)
    act = live.clone()
    slot = torch.arange(ARITY, dtype=torch.int64, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    if stats is not None:
        stats.update(inner=0, leaf=0, inner_rows=torch.zeros(
            inner.shape[0], dtype=torch.bool, device=dev),
            leaf_rows=torch.zeros(leaf.shape[0], dtype=torch.bool, device=dev))
    while True:
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        pop = torch.ones(B, dtype=torch.bool, device=dev)
        if stats is not None:
            c = cur[idx]
            stats['inner'] += int((c >= 0).sum())
            stats['leaf'] += int((c < 0).sum())
            stats['inner_rows'][c[c >= 0]] = True
            stats['leaf_rows'][~c[c < 0]] = True

        # leaf visit: Moller-Trumbore on up to 12 triangles
        li = idx[cur[idx] < 0]
        if li.numel():
            lrow = ~cur[li]
            r = leaf[lrow]
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
            g = leaf_i[lrow, PGIDS:PGIDS + LEAF_MAX]
            leaf_g = torch.where(ttm == leaf_t[:, None], g,
                                 torch.full_like(g, 2 ** 30)).amin(1)
            take = ok.any(1)
            tk = li[take]
            t[tk] = leaf_t[take]
            gid[tk] = leaf_g[take]
            found[tk] = True
            act[li[take & stop[li]]] = False

        # inner visit: slab-test the 16 children, skip the visited ones,
        # descend into the nearest (or, cheap, the lowest) hit child
        ii = idx[cur[idx] >= 0]
        if ii.numel():
            r = inner[cur[ii]]
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
            visited = ((mask[ii][:, None] >> slot) & 1) != 0
            chit = ((tmax >= torch.maximum(tmin, torch.zeros_like(tmin)))
                    & (tmin < t[ii][:, None]) & ~visited)
            n_hit = chit.sum(1)
            if cheap:
                sel = chit.to(torch.int8).argmax(1)
            else:
                # argmin returns the first of equal minima: lowest slot
                sel = torch.where(chit, tmin, big).argmin(1)
            descend = n_hit > 0
            push = descend & (n_hit > 1) & (sp[ii] < S)
            pi = ii[push]
            stack_row[pi, sp[pi]] = cur[pi]
            stack_mask[pi, sp[pi]] = mask[pi] | (1 << sel[push])
            sp[pi] += 1
            di = ii[descend]
            cur[di] = inner_i[cur[di], PREFS + sel[descend]].to(torch.int64)
            mask[di] = 0
            pop[di] = False

        # pop the next (row, mask) entry; an empty stack ends the ray
        pidx = idx[act[idx] & pop[idx]]
        empty = sp[pidx] == 0
        act[pidx[empty]] = False
        pidx = pidx[~empty]
        sp[pidx] -= 1
        cur[pidx] = stack_row[pidx, sp[pidx]]
        mask[pidx] = stack_mask[pidx, sp[pidx]]
    return t, gid, found


def traverse_split(tables: PacketTables, ro, rd, t0, live, stop,
                   cheap: bool = False):
    """:func:`traverse_packet_ref`'s contract. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/traverse_packet.cu`` (or raise)."""
    if ro.device.type == 'cpu':
        return traverse_packet_ref(tables, ro, rd, t0, live, stop, cheap)
    inner, leaf = tables.inner, tables.leaf
    B = ro.shape[0]
    kernels.require_cuda('traverse_packet', inner, leaf, ro, rd, t0, live, stop,
                         dtypes=(torch.float32,) * 5 + (torch.bool,) * 2)
    for name, tab in (('inner', inner), ('leaf', leaf)):
        if tab.dim() != 2 or tab.shape[1] != ROW or tab.shape[0] == 0:
            raise ValueError(f'traverse_packet: {name} table must be '
                             f'[N > 0, {ROW}], got {tuple(tab.shape)}')
    if ro.shape != (B, 3) or rd.shape != (B, 3) or t0.shape != (B,) \
            or live.shape != (B,) or stop.shape != (B,):
        raise ValueError('traverse_packet: ray tensors disagree on shape')
    kernels.check_group_count('traverse_packet', B)
    lib = kernels.library()
    cap = stack_cap(tables.depth)
    if cap > lib.cpt_traverse_packet_max_stack():
        raise ValueError(f'traverse_packet: tree depth {tables.depth} exceeds '
                         f'the kernel stack '
                         f'({lib.cpt_traverse_packet_max_stack()})')
    dev = ro.device
    t = torch.empty(B, dtype=torch.float32, device=dev)
    gid = torch.empty(B, dtype=torch.int32, device=dev)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        err = lib.cpt_traverse_packet(
            inner.data_ptr(), leaf.data_ptr(), ro.data_ptr(), rd.data_ptr(),
            t0.data_ptr(), live.data_ptr(), stop.data_ptr(), B, int(cheap),
            cap, t.data_ptr(), gid.data_ptr(), found.data_ptr(),
            kernels.stream_of(ro))
        kernels.LAUNCHES['traverse_packet'] += 1
        kernels.check(err, 'traverse_packet')
    return t, gid, found


def traverse_packet(scene, tables: PacketTables, ro, rd, t_max=None,
                    active=None, any_hit: bool = False,
                    stop_on_hit=None) -> Hit:
    """The renderer's trace on the split tables: the sphere/plane prepass,
    then :func:`traverse_split`. Same :class:`Hit` as ``dispatch.trace``,
    with ``u = v = None`` (shading re-intersects the winning triangle).
    CUDA tensors must be contiguous (``dispatch.trace`` makes them so)."""
    pre = prepass(scene, ro, rd, t_max=t_max, active=active,
                  stop_on_hit=stop_on_hit, any_hit=any_hit)
    t, gid, found = traverse_split(tables, ro, rd, pre.t, pre.live, pre.stop,
                                   cheap=any_hit)
    return merge_hit(t, gid, found, None, None, pre, active)
