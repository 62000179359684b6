"""The plain walk of the program's merged BVH table (copied from the port's
``ops/traverse_packet2.py::traverse_merged_ref``), which the roofline
readers run on a recorded wave to count the visits and rows the wave needs
(``work.traversal_work``), so that the same work is read whatever kernel
implements it. It decides nothing about ``correct``.

The table: inner rows hold six 16-wide box blocks at [0:96] (NaN in empty
slots) and ``base | n_inner << 20`` as int32 bits at [96]; leaf rows hold
up to 12 triangles as v0, e1, e2 in field-major 9 x 12 order at [0:108]
and their ids as int32 bits at [108:120].
"""
from __future__ import annotations

import torch

ARITY = 16
LEAF_MAX = 12
PBOX0 = 0
PMETA = 96
PTRIS = 0
PGIDS = 108
META_BASE_BITS = 20
BIG = 3.0e38
MT_DET_EPS = 1e-4


def safe_inv_dir(rd):
    """Reciprocal direction with tiny components clamped to +-1e-20."""
    tiny = 1e-20
    sign = torch.where(rd >= 0.0, 1.0, -1.0).to(rd.dtype)
    return 1.0 / torch.where(torch.abs(rd) < tiny, sign * tiny, rd)


def walk(table, ro, rd, t0, live, stop,
                        want_uv: bool = False, stats: dict | None = None):
    """Plain PyTorch walk of the merged table, one stack per ray.

    ro, rd: f32[B, 3]; t0: f32[B] (the ray's t after the analytic prepass);
    live: bool[B] rays to trace; stop: bool[B] rays that end at their first
    hit (any-hit). Returns (t f32[B], gid i32[B] world-triangle id or -1,
    found bool[B], u, v) with u, v f32[B] when ``want_uv`` else None.
    ``stats``, when given, receives the work this walk did: inner and leaf
    visits (``inner``, ``leaf``) and the rows it touched (``rows``, bool[N]).
    """
    dev = ro.device
    B = ro.shape[0]
    rows = table.rows
    rows_i = rows.view(torch.int32)
    inv = safe_inv_dir(rd)
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


