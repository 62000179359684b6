"""Plain PyTorch pieces of a 128-ray packet step, shared by the probe modules
that stand for the TPU packet-traversal probes (``packet_step_probe``,
``decision_probe``, ``visit_probe``, ``lab_v1_probe``).

A packet's rays lie on the last axis (128 lanes); a node row is a f32[128]
whose field blocks are sliced by the callers. Everything here is
elementwise or a reduction over one axis, so batches of packets (programs x
packets) go through at once. The arithmetic is the TPU kernels': separate
multiplies and adds in the order written there, NaN-propagating min/max,
first-index argmin, int32 wrapping and floor-mod for the scalar words.
"""
from __future__ import annotations

import torch

BIG = 3.0e38
MASK32 = 0xFFFFFFFF
ARITY = 16


def wrap32(x):
    """int64 tensor -> the int32 value of its low 32 bits (as int64)."""
    return ((x + 2 ** 31) & MASK32) - 2 ** 31


def abs32(x):
    """jnp.abs on int32 words held in int64: abs(INT_MIN) is INT_MIN."""
    return wrap32(torch.abs(x))


def digest_add(d, x):
    """The running digest: a wrapping uint32 sum (int64 holding 0..2^32-1)."""
    return (d + x) & MASK32


def clamp_rows(idx, n: int):
    """The row a dynamic one-row slice reads in interpret mode: any index
    outside [0, n) reads the last row."""
    return torch.where((idx < 0) | (idx >= n), torch.full_like(idx, n - 1),
                       idx)


def int_bits(x):
    """f32 words reinterpreted as int32, widened to int64."""
    return x.contiguous().view(torch.int32).to(torch.int64)


def bits16(device):
    return 1 << torch.arange(ARITY, dtype=torch.int64, device=device)


def slab_sub(lo, hi, o, iv):
    """(tmin, tmax) of the classic form (lo - o) * iv; lo/hi [..., 3, S, 1]
    field blocks against o/iv [..., 3, 1, 128]: returns [..., S, 128]."""
    t0 = (lo - o) * iv
    t1 = (hi - o) * iv
    return _tmin_tmax(t0, t1)


def slab_fma(lo, hi, iv, oiv):
    """(tmin, tmax) of the product form lo * iv - oiv (oiv = o * iv)."""
    t0 = lo * iv - oiv
    t1 = hi * iv - oiv
    return _tmin_tmax(t0, t1)


def _tmin_tmax(t0, t1):
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(near[..., 0, :, :], near[..., 1, :, :]),
                         near[..., 2, :, :])
    tmax = torch.minimum(torch.minimum(far[..., 0, :, :], far[..., 1, :, :]),
                         far[..., 2, :, :])
    return tmin, tmax


def slab_hit(tmin, tmax, t):
    """(tmax >= max(tmin, 0)) & (tmin < t)."""
    return (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin < t)


def moller(v0, e1, e2, o, d, eps: float):
    """Moller-Trumbore of triangles (v0, e1, e2) [..., 3, K, 1] against rays
    o/d [..., 3, 1, 128]; returns (ok-before-the-t-tests, tt) [..., K, 128]
    where ok holds |a| >= eps and the barycentric tests."""
    v0x, v0y, v0z = v0.unbind(-3)
    e1x, e1y, e1z = e1.unbind(-3)
    e2x, e2y, e2z = e2.unbind(-3)
    ox, oy, oz = o.unbind(-3)
    dx, dy, dz = d.unbind(-3)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    small = torch.abs(a) < eps
    f = 1.0 / torch.where(small, torch.ones_like(a), a)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    tt = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ~small & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return ok, tt


def nearest_child(chit, tmin, big: float = BIG):
    """The packet's nearest-first pick over slots [..., S, 128]: per slot the
    least tmin of its hit lanes (``pc_min``) and whether any lane hit
    (``anyc``); ``key`` = pc_min where any else big; ``kmin`` its minimum;
    ``selhot`` the slots that reach it; ``selc`` the first of them (S when
    none)."""
    s = chit.shape[-2]
    tsel = torch.where(chit, tmin, torch.full_like(tmin, big))
    pc_min = tsel.amin(-1)
    anyc = chit.any(-1)
    key = torch.where(anyc, pc_min, torch.full_like(pc_min, big))
    kmin = key.amin(-1, keepdim=True)
    selhot = (key == kmin) & anyc
    iota = torch.arange(s, dtype=torch.int64, device=chit.device)
    selc = torch.where(selhot, iota, torch.full_like(iota, s)).amin(-1)
    return dict(pc_min=pc_min, anyc=anyc, key=key, kmin=kmin.squeeze(-1),
                selhot=selhot, selc=selc)


def hitmask(anyc):
    """sum(where(anyc, 2^slot, 0)) over the last axis."""
    return torch.where(anyc, bits16(anyc.device)[:anyc.shape[-1]],
                       torch.zeros((), dtype=torch.int64,
                                   device=anyc.device)).sum(-1)


def same(a: dict, b: dict) -> bool:
    """Every output of two runs bit for bit (floats by their int32 bits)."""
    return a.keys() == b.keys() and all(
        torch.equal(a[k].contiguous().view(torch.int32),
                    b[k].contiguous().view(torch.int32))
        if a[k].dtype == torch.float32 else torch.equal(a[k].long(),
                                                        b[k].long())
        for k in a)


def max_err(a: dict, b: dict) -> float:
    """The largest absolute difference over the float outputs."""
    return max(float((a[k] - b[k]).abs().max()) for k in a
               if a[k].dtype == torch.float32)
