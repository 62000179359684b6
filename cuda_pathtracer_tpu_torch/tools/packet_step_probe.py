"""The TPU packet-traversal step on one block: the Hopper counterpart of the
four module-level Pallas probes ``tools/pallas_probe_r2f.py:96`` (``make``
:35), ``r2g.py:158`` (``make`` :16), ``r2h.py:172`` (``make`` :75,
``leaf_math`` :18, ``inner_math`` :43) and ``r2i.py:68`` (``make`` :14),
which priced a realistic packet step on the TPU. Here: ns per packet-step
on the H100, beside ``step_probe``'s 441 ns block-wide dependent step and
the 16-lane group traversal's ~76 ns per ray-visit.

    python -m cuda_pathtracer_tpu_torch.tools.packet_step_probe [--device cpu]

The sites (a packet is 128 rays; the next row is scripted in all four):
  r2f  a [1, 128] row of a [16384, 128] table, boxes by reshape, a [16, 128]
       slab against the rays, the argmin child and the hit mask, a push and
       pop of a 64-entry stack; NI in {1, 2, 4} interleaved packets;
  r2g  the real step body, both paths every step: 12 Moller-Trumbore tests
       with the lowest-gid pick, 16 slabs with the visited mask and the
       nearest child, a 32-entry (row, mask) stack; NPK in {1, 2, 4};
  r2h  split inner / leaf tables, 8 packets, three homes for the state: A
       registers, B a shared-memory t, C a branch per path with the decision
       handed over in shared memory (the TPU's SMEM word); T in {256, 2048};
  r2i  the fields read per thread straight from the row (V1) or from the row
       staged once in shared memory (V2); T in {512, 4096}.

:func:`run` launches ``tools/csrc/probe_packet_step.cu`` on CUDA tensors (or
raises) and takes the plain version :func:`run_ref` for CPU tensors. Every
output is returned with the scratch the TPU kernel leaves behind (stacks,
the t scratch, the decision words) and a per-packet digest, the wrapping
uint32 sum of every step's decision words and next row, so a comparison
sees the walk even where the output is blind to it (r2f's output depends on
T alone).
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ..ops import kernels
from . import packet_ops as po
from . import probe_kernels
from . import timing

NAME = 'probe_packet_step'
SITES = ('r2f', 'r2g', 'r2h', 'r2i')
SITE_LINES = {'r2f': 'pallas_probe_r2f.py:96', 'r2g': 'pallas_probe_r2g.py:158',
              'r2h': 'pallas_probe_r2h.py:172', 'r2i': 'pallas_probe_r2i.py:68'}
R2H_VARIANTS = ('A', 'B', 'C')
R2H_NPK = 8
# r2h's t0 is BIG on the TPU, which makes its output t + BIG (inf where no
# leaf was hit); a finite t0 is passed so the output carries the walk
R2H_T0 = 64.0
STEP_NS = 441             # step_probe: one block-wide dependent step
GROUP_NS_PER_VISIT = 76   # the v2 group traversal, sibenik primary wave
# the scratch each site leaves, in the order of the kernel's outputs
OUTPUTS = {'r2f': ('out', 'stack', 'digest'),
           'r2g': ('t', 'gid', 'stk_n', 'stk_m', 'digest'),
           'r2h': ('out', 'stk_n', 'stk_m', 't_s', 'dec_s', 'digest'),
           'r2i': ('out', 'digest')}


def _packets(site: str, variant) -> int:
    return {'r2f': variant, 'r2g': variant, 'r2h': R2H_NPK, 'r2i': 1}[site]


# ---------------------------------------------------------------- plain ----

def r2f_ref(tab, ro, ird, steps: int, ni: int):
    """``pallas_probe_r2f.py:35-90``. tab f32[N, 128]; ro, ird f32[3 NI,
    128]. Returns out = ro + packet 0's final t, the stack, the digest."""
    dev = tab.device
    n = tab.shape[0]
    ar = torch.arange(ni, device=dev)
    idx = ar.clone()
    sp = torch.zeros(ni, dtype=torch.int64, device=dev)
    stack = torch.zeros((ni, 64), dtype=torch.int64, device=dev)
    ts = torch.full((ni,), 3e38, dtype=torch.float32, device=dev)
    dig = torch.zeros(ni, dtype=torch.int64, device=dev)
    o = ro.view(ni, 3, 1, 128)
    ip = ird.view(ni, 3, 1, 128)
    for _ in range(steps):
        rows = tab[idx]
        box = rows[:, 1:97].reshape(ni, 6, 16, 1)
        tmin, tmax = po.slab_sub(box[:, 0:3], box[:, 3:6], o, ip)
        hitc = po.slab_hit(tmin, tmax, ts[:, None, None])
        tsel = torch.where(hitc, tmin, torch.full_like(tmin, 3e38))
        anyc = hitc.any(-1)
        enc = torch.where(anyc, tsel.amin(-1), torch.full_like(ts[:, None], 3e38))
        sel = enc.argmin(-1)
        nmask = po.hitmask(anyc)
        ts = ts * 0.9999
        nxt = (idx * 7 + sel + 1) % n
        push = (nmask > 0) & (sp < 62)
        stack[ar, sp] = torch.where(push, nxt, stack[ar, sp])
        sp2 = sp + push.long()
        sp = (sp2 - 1).clamp_min(0)
        idx = torch.where(sp2 > 0, stack[ar, sp], nxt)
        dig = po.digest_add(dig, sel + nmask + idx)
    return dict(out=ro + ts[0], stack=stack.int(), digest=dig)


def r2g_ref(tab, o, inv, d, steps: int, npk: int):
    """``pallas_probe_r2g.py:16-142``. tab f32[N, 128] (tag at lane 0, boxes
    and triangles from lane 1, refs at 97, gids at 109 as int32 bits); o,
    inv, d f32[3 NPK, 128]. Returns the final t and gid per lane, the
    stacks, the digest."""
    dev = tab.device
    n = tab.shape[0]
    P = npk
    ar = torch.arange(P, device=dev)
    cur = ar.clone()
    mask = torch.zeros(P, dtype=torch.int64, device=dev)
    sp = torch.zeros(P, dtype=torch.int64, device=dev)
    stk_n = torch.zeros((P, 32), dtype=torch.int64, device=dev)
    stk_m = torch.zeros((P, 32), dtype=torch.int64, device=dev)
    t = torch.full((P, 128), po.BIG, dtype=torch.float32, device=dev)
    best = torch.full((P, 128), -1, dtype=torch.int64, device=dev)
    dig = torch.zeros(P, dtype=torch.int64, device=dev)
    O, IV, D = (x.view(P, 3, 1, 128) for x in (o, inv, d))
    slot = torch.arange(16, device=dev)
    slot_f = slot.float()
    b16 = po.bits16(dev)
    for i in range(steps):
        rows = tab[cur]
        tag = rows[:, 0]
        # leaf path: 12 Moller-Trumbore tests, lowest gid at the least t
        fm = rows[:, 1:109].reshape(P, 9, 12, 1)
        v0 = fm[:, 0:3]
        ok, tt = po.moller(v0, fm[:, 3:6] - v0, fm[:, 6:9] - v0, O, D, 1e-9)
        okm = ok & (tt > 1e-4) & (tt < t[:, None]) & (tag < 0)[:, None, None]
        ttm = torch.where(okm, tt, torch.full_like(tt, po.BIG))
        leaf_t = ttm.amin(1)
        gids = po.int_bits(rows[:, 109:121])[:, :, None]
        leaf_gid = torch.where(ttm == leaf_t[:, None], gids,
                               torch.full_like(gids, 2 ** 30)).amin(1)
        found = okm.any(1)
        t2 = torch.where(found, torch.minimum(t, leaf_t), t)
        best = torch.where(found & (leaf_t < t), leaf_gid, best)
        # inner path: 16 slabs, the visited mask, the nearest child
        box = rows[:, 1:97].reshape(P, 6, 16, 1)
        tmin, tmax = po.slab_sub(box[:, 0:3], box[:, 3:6], O, IV)
        vis = ((mask[:, None] >> slot) & 1) != 0
        chit = (po.slab_hit(tmin, tmax, t2[:, None])
                & (tag > 0)[:, None, None]
                & (slot_f[None, :] < tag[:, None])[:, :, None]
                & ~vis[:, :, None])
        nc = po.nearest_child(chit, tmin)
        refs = po.int_bits(rows[:, 97:113])
        zero = torch.zeros_like(refs)
        selref = torch.where(nc['selhot'], refs, zero).amax(-1)
        selbit = torch.where(nc['selhot'], b16, zero).amax(-1)
        nhits = nc['anyc'].sum(-1)
        # the scalar step
        descend = ~(tag.int() < 0) & (nhits > 0)
        push = descend & (nhits > 1) & (sp < 30)
        stk_n[ar, sp] = torch.where(push, cur, stk_n[ar, sp])
        stk_m[ar, sp] = torch.where(push, mask | selbit, stk_m[ar, sp])
        sp2 = sp + push.long()
        sp3 = torch.where(~descend & (sp2 > 0), sp2 - 1, sp2)
        nxt = torch.where(descend, selref, stk_n[ar, sp3])
        nxt = po.wrap32(po.abs32(nxt) + i) % n
        mask = torch.where(descend, torch.zeros_like(mask), stk_m[ar, sp3])
        cur, sp, t = nxt, sp3, t2
        dig = po.digest_add(dig, selref + selbit + nhits + nxt)
    return dict(t=t, gid=best.int(), stk_n=stk_n.int(), stk_m=stk_m.int(),
                digest=dig)


def _r2h_leaf(rowL, O, D, t):
    """``pallas_probe_r2h.py:18-41``: (leaf_t, take) of a leaf row."""
    fm = rowL[:, 0:108].reshape(-1, 9, 12, 1)
    ok, tt = po.moller(fm[:, 0:3], fm[:, 3:6], fm[:, 6:9], O, D, 1e-4)
    okm = ok & (tt > 0.0) & (tt < t[:, None])
    leaf_t = torch.where(okm, tt, torch.full_like(tt, po.BIG)).amin(1)
    return leaf_t, okm.any(1)


def _r2h_inner(rowI, O, IV, t, mask, slot, b16):
    """``pallas_probe_r2h.py:43-73``: (selref, selbit, nhits)."""
    box = rowI[:, 0:96].reshape(-1, 6, 16, 1)
    tmin, tmax = po.slab_sub(box[:, 0:3], box[:, 3:6], O, IV)
    vis = ((mask[:, None] >> slot) & 1) != 0
    chit = po.slab_hit(tmin, tmax, t[:, None]) & ~vis[:, :, None]
    nc = po.nearest_child(chit, tmin)
    onehot = (slot[None] == nc['selc'][:, None]) & nc['anyc']
    refs = po.int_bits(rowI[:, 96:112])
    zero = torch.zeros_like(refs)
    selref = torch.where(onehot, refs, zero).sum(-1)
    selbit = torch.where(onehot, b16, zero).sum(-1)
    return selref, selbit, nc['anyc'].sum(-1)


def r2h_ref(itab, ltab, o, dv, iv, t0, steps: int, variant: str):
    """``pallas_probe_r2h.py:75-161`` with NPK 8. itab f32[NI, 128], ltab
    f32[NL, 128]; o, dv, iv f32[24, 128]; t0 f32[8, 128]. Returns out =
    t + t0 (in the variant's order), the stacks, the t scratch, the
    decision words (C only) and the digest. The three variants walk alike."""
    dev = itab.device
    ni, nl = itab.shape[0], ltab.shape[0]
    P = R2H_NPK
    ar = torch.arange(P, device=dev)
    cur = ar % 5
    mask = torch.zeros(P, dtype=torch.int64, device=dev)
    sp = torch.zeros(P, dtype=torch.int64, device=dev)
    stk_n = torch.zeros((P, 32), dtype=torch.int64, device=dev)
    stk_m = torch.zeros((P, 32), dtype=torch.int64, device=dev)
    dec_s = torch.zeros((P, 4), dtype=torch.int64, device=dev)
    dig = torch.zeros(P, dtype=torch.int64, device=dev)
    t = t0.clone()
    O, D, IV = (x.view(P, 3, 1, 128) for x in (o, dv, iv))
    slot = torch.arange(16, device=dev)
    b16 = po.bits16(dev)
    for i in range(steps):
        leaf = cur < 0
        rowL = ltab[torch.where(leaf, ~cur, torch.zeros_like(cur))]
        rowI = itab[cur.clamp_min(0)]
        leaf_t, take = _r2h_leaf(rowL, O, D, t)
        take = take & leaf[:, None]
        t = torch.where(take, torch.minimum(t, leaf_t), t)
        selref, selbit, nhits = _r2h_inner(rowI, O, IV, t, mask, slot, b16)
        if variant == 'C':
            # the inner branch writes the words; a leaf step reads stale ones
            new = torch.stack([selref, selbit, nhits], 1)
            dec_s[:, :3] = torch.where(leaf[:, None], dec_s[:, :3], new)
            selref, selbit, nhits = dec_s[:, 0], dec_s[:, 1], dec_s[:, 2]
        descend = ~leaf & (nhits > 0)
        push = descend & (nhits > 1) & (sp < 30)
        stk_n[ar, sp] = torch.where(push, cur, stk_n[ar, sp])
        stk_m[ar, sp] = torch.where(push, mask | selbit, stk_m[ar, sp])
        sp2 = sp + push.long()
        spr = torch.where(~descend & (sp2 > 0), sp2 - 1, sp2)
        nxt = po.abs32(torch.where(descend, selref, stk_n[ar, spr]))
        nxt = torch.where((i + ar) % 3 == 0, ~(nxt % nl), nxt % ni)
        mask = torch.where(descend, torch.zeros_like(mask), stk_m[ar, spr])
        cur, sp = nxt, spr
        dig = po.digest_add(dig, selref + selbit + nhits + nxt)
    if variant == 'A':          # t carried as tiles, t_s left at t0
        out, t_s = t + t0, t0.clone()
    else:                       # t in the scratch, the carry left at t0
        out, t_s = t0 + t, t
    return dict(out=out, stk_n=stk_n.int(), stk_m=stk_m.int(), t_s=t_s,
                dec_s=dec_s.int(), digest=dig)


def r2i_ref(tab, o, steps: int, variant: int):
    """``pallas_probe_r2i.py:14-61``. tab f32[N, 128]; o f32[8, 128] (rows
    0-2 are the origin, and also the direction and the slab's inverse).
    Returns out = the final t on 8 rows, and the digest."""
    dev = tab.device
    n = tab.shape[0]
    idx = torch.zeros(1, dtype=torch.int64, device=dev)
    t = torch.full((1, 128), po.BIG, dtype=torch.float32, device=dev)
    dig = torch.zeros(1, dtype=torch.int64, device=dev)
    O = o[0:3].reshape(1, 3, 1, 128)
    IV = o[[1, 2, 0]].reshape(1, 3, 1, 128)
    iota = torch.arange(16, device=dev)
    for _ in range(steps):
        row = tab[idx]
        if variant == 1:      # 15 column broadcasts
            fm = row[:, 0:108].reshape(1, 9, 12, 1)
        else:                 # one lane broadcast, then row slices
            fm = torch.cat([row[:, 0:128].reshape(1, 8, 16)[:, :, :12],
                            row[:, None, 112:124]], 1)[..., None]
        ok, tt = po.moller(fm[:, 0:3], fm[:, 3:6], fm[:, 6:9], O, O, 1e-4)
        okm = ok & (tt > 0.0) & (tt < t[:, None])
        leaf_t = torch.where(okm, tt, torch.full_like(tt, po.BIG)).amin(1)
        box = row[:, 0:96].reshape(1, 6, 16, 1)
        tmin, tmax = po.slab_sub(box[:, 0:3], box[:, 3:6], O, IV)
        chit = po.slab_hit(tmin, tmax, t[:, None])
        pc = torch.where(chit, tmin, torch.full_like(tmin, po.BIG)).amin(-1)
        kmin = pc.amin(-1, keepdim=True)
        sel = torch.where(pc == kmin, iota, torch.full_like(iota, 16)).amin(-1)
        t = torch.minimum(t, leaf_t)
        idx = (idx * 5 + sel + 1) % n
        dig = po.digest_add(dig, sel + idx)
    return dict(out=t.expand(8, 128).clone(), digest=dig)


def run_ref(site: str, variant, steps: int, ins: dict):
    """The plain version of one site: ``ins`` as :func:`inputs` makes them
    (as tensors). Returns the dict of outputs named in ``OUTPUTS``."""
    probe_kernels.note_plain(NAME, next(iter(ins.values())))
    if site == 'r2f':
        return r2f_ref(ins['tab'], ins['ro'], ins['ird'], steps, variant)
    if site == 'r2g':
        return r2g_ref(ins['tab'], ins['o'], ins['inv'], ins['d'], steps,
                       variant)
    if site == 'r2h':
        return r2h_ref(ins['itab'], ins['ltab'], ins['o'], ins['dv'],
                       ins['iv'], ins['t0'], steps, variant)
    return r2i_ref(ins['tab'], ins['o'], steps, variant)


INPUT_ORDER = {'r2f': ('tab', 'ro', 'ird'), 'r2g': ('tab', 'o', 'inv', 'd'),
               'r2h': ('itab', 'ltab', 'o', 'dv', 'iv', 't0'),
               'r2i': ('tab', 'o')}


def _out_shapes(site: str, variant):
    p = _packets(site, variant)
    return {'r2f': {'out': (3 * p, 128), 'stack': (p, 64), 'digest': (p,)},
            'r2g': {'t': (p, 128), 'gid': (p, 128), 'stk_n': (p, 32),
                    'stk_m': (p, 32), 'digest': (p,)},
            'r2h': {'out': (p, 128), 'stk_n': (p, 32), 'stk_m': (p, 32),
                    't_s': (p, 128), 'dec_s': (p, 4), 'digest': (p,)},
            'r2i': {'out': (8, 128), 'digest': (1,)}}[site]


_FLOAT_OUT = ('out', 't', 't_s')


def run(site: str, variant, steps: int, ins: dict):
    """:func:`run_ref`'s contract. CPU tensors take the plain version; CUDA
    tensors launch ``tools/csrc/probe_packet_step.cu`` on one block (or
    raise)."""
    first = ins[INPUT_ORDER[site][0]]
    if first.device.type == 'cpu':
        return run_ref(site, variant, steps, ins)
    names = INPUT_ORDER[site]
    kernels.require_cuda(NAME, *(ins[k] for k in names),
                         dtypes=(torch.float32,) * len(names))
    code = {'r2f': (0, variant), 'r2g': (1, variant),
            'r2h': (2, R2H_VARIANTS.index(variant) if variant in R2H_VARIANTS
                    else -1),
            'r2i': (3, variant)}[site]
    outs = {k: torch.empty(s, dtype=torch.float32 if k in _FLOAT_OUT
                           else torch.int32, device=first.device)
            for k, s in _out_shapes(site, variant).items()}
    rows = [ins[k].shape[0] for k in names if k.endswith('tab')]
    in_ptrs = (ctypes.c_void_p * len(names))(*(ins[k].data_ptr() for k in names))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(v.data_ptr() for v in outs.values()))
    err = probe_kernels.library().cpt_probe_packet_step(
        code[0], code[1], steps, in_ptrs, out_ptrs, rows[0],
        rows[1] if len(rows) > 1 else 0, kernels.stream_of(first))
    probe_kernels.launched(err, NAME)
    outs['digest'] = outs['digest'].long() & po.MASK32
    return outs


# --------------------------------------------------------------- sweeps ----

def inputs(site: str, variant, small: bool = False, seed: int = 0):
    """Numpy inputs in the TPU probe's own distributions and sizes (small on
    the CPU), from a seed."""
    rs = np.random.RandomState(seed + 17 * SITES.index(site)
                               + (variant if isinstance(variant, int) else 0))
    f32 = np.float32
    if site == 'r2f':
        n, ni = (64 if small else 16384), variant
        return dict(tab=(rs.rand(n, 128) * 2 - 1).astype(f32),
                    ro=rs.rand(3 * ni, 128).astype(f32),
                    ird=(rs.rand(3 * ni, 128) + 0.5).astype(f32))
    if site == 'r2g':
        n, p = (96 if small else 25600), variant
        rows = np.zeros((n, 128), f32)
        rows[:, 0] = np.where(rs.rand(n) < 0.5, 8.0, -10.0)
        rows[:, 1:97] = rs.rand(n, 96) * 20 - 10
        rows[:, 97:121] = rs.randint(0, n, size=(n, 24)).astype(
            np.int32).view(f32)
        return dict(tab=rows, o=(rs.rand(3 * p, 128) * 2 - 1).astype(f32),
                    inv=(rs.rand(3 * p, 128) + 0.5).astype(f32),
                    d=(rs.rand(3 * p, 128) * 2 - 1).astype(f32))
    if site == 'r2h':
        ni, nl = (40, 72) if small else (6833, 18632)
        return dict(itab=(rs.rand(ni, 128) * 10 - 5).astype(f32),
                    ltab=(rs.rand(nl, 128) * 10 - 5).astype(f32),
                    o=rs.rand(3 * R2H_NPK, 128).astype(f32),
                    dv=(rs.rand(3 * R2H_NPK, 128) + 0.1).astype(f32),
                    iv=(rs.rand(3 * R2H_NPK, 128) + 0.5).astype(f32),
                    t0=np.full((R2H_NPK, 128), R2H_T0, f32))
    n = 64 if small else 8192
    return dict(tab=(rs.rand(n, 128) * 10 - 5).astype(f32),
                o=rs.rand(8, 128).astype(f32))


def cases(small: bool = False):
    """The probes' own sweeps: (site, variant, T)."""
    s = (lambda big, little: little) if small else (lambda big, little: big)
    out = [('r2f', ni, s(16384, 24)) for ni in (1, 2, 4)]
    out += [('r2g', p, s(16384, 24)) for p in (1, 2, 4)]
    out += [('r2h', v, t) for v in R2H_VARIANTS for t in (s(256, 8), s(2048, 40))]
    out += [('r2i', v, t) for v in (1, 2) for t in (s(512, 8), s(4096, 40))]
    return out


def _label(site, variant):
    return {'r2f': f'NI={variant}', 'r2g': f'NPK={variant}',
            'r2h': str(variant), 'r2i': f'V{variant}'}[site]


def probe(device: str = 'cuda', small: bool = False, seed: int = 0,
          reps: int = 3):
    """The probes' sweeps through :func:`run` (the main path): one dict per
    case with its outputs and, on the card, the kernel's time."""
    rows = []
    for site, variant, t in cases(small):
        ins = {k: torch.as_tensor(v, device=device)
               for k, v in inputs(site, variant, small, seed).items()}
        fn = lambda: run(site, variant, t, ins)  # noqa: E731
        if device != 'cpu':
            ms, out = timing.cuda_ms(fn, reps=reps, warmup=1, preroll=True)
        else:
            ms, out = None, fn()
        rows.append(dict(site=site, variant=variant, label=_label(site, variant),
                         steps=t, out=out, ms=ms, ins=ins,
                         packets=_packets(site, variant)))
    return rows




# per packet-step FP32 operations (counted from the plain versions): r2f 16
# slabs; r2g 12 triangles + 16 slabs; r2h the same; r2i likewise
STEP_OPS = {'r2f': 16 * 128 * 25, 'r2g': 128 * (12 * 62 + 16 * 27),
            'r2h': 128 * (12 * 56 + 16 * 27), 'r2i': 128 * (12 * 56 + 16 * 27)}


def compare(rows, check_steps: int = 256):
    """Each case against the plain version bit for bit, digest included, at
    its T cut to ``check_steps`` (the plain chain is ~60 launches per step).
    The first r2h case (T = 256, run whole) also gets the plain version's
    time and the bound: the tables read once, the rays and outputs, and the
    step's FP32 operations."""
    for r in rows:
        t = min(r['steps'], check_steps)
        got = r['out'] if t == r['steps'] else run(r['site'], r['variant'], t,
                                                   r['ins'])
        fn = lambda: run_ref(r['site'], r['variant'], t, r['ins'])  # noqa: E731
        on_card = next(iter(r['ins'].values())).is_cuda
        if on_card and r is _summary_row(rows):
            r['plain_ms'], want = timing.cuda_ms(fn)
            n_bytes = sum(v.numel() * 4 for v in r['ins'].values()) + sum(
                v.numel() * 4 for v in got.values())
            r['bound_ms'], r['bound_by'] = timing.bound(
                n_bytes, STEP_OPS[r['site']] * r['packets'] * t)
        else:
            want = fn()
        r['check_steps'], r['equal'] = t, po.same(got, want)
        r['max_abs_err'] = po.max_err(got, want)
    return rows


def _summary_row(rows):
    return next(r for r in rows if r['site'] == 'r2h')


def _slope(rows, site, variant):
    pts = sorted((r['steps'], r['ms']) for r in rows
                 if r['site'] == site and r['variant'] == variant)
    (t0, a), (t1, b) = pts[0], pts[-1]
    return (b - a) * 1e6 / (t1 - t0)


def hopper_question(rows):
    """ns per packet-step per case (the slope between the two T for r2h and
    r2i), beside step_probe's dependent step and the group traversal."""
    lines = []
    for site in ('r2f', 'r2g'):
        for r in rows:
            if r['site'] == site:
                ns = r['ms'] * 1e6 / r['steps'] / r['packets']
                lines.append(f"{SITE_LINES[site]} {r['label']:6s} T={r['steps']}: "
                             f"{r['ms']:8.3f} ms, {ns:7.1f} ns/packet-step")
    for site, variants in (('r2h', R2H_VARIANTS), ('r2i', (1, 2))):
        for v in variants:
            p = _packets(site, v)
            ns = _slope(rows, site, v) / p
            lines.append(f'{SITE_LINES[site]} {_label(site, v):6s} slope '
                         f'{ns:7.1f} ns/packet-step')
    lines.append(f'(step_probe: {STEP_NS} ns per block-wide dependent step; '
                 f'16-lane group traversal: ~{GROUP_NS_PER_VISIT} ns per '
                 f'ray-visit)')
    return lines


def answer(rows) -> str:
    ok = all(r['equal'] for r in rows)
    if rows[0]['ms'] is None:
        return f'packet_step_probe: {len(rows)} cases, plain only, ok={ok}'
    g1 = next(r for r in rows if r['site'] == 'r2g' and r['variant'] == 1)
    h = {v: _slope(rows, 'r2h', v) / R2H_NPK for v in R2H_VARIANTS}
    return (f'packet_step_probe: r2g real step {g1["ms"] * 1e6 / g1["steps"]:.1f} '
            f'ns/packet-step; r2h A/B/C {h["A"]:.1f}/{h["B"]:.1f}/{h["C"]:.1f} '
            f'ns/packet-step; step_probe {STEP_NS} ns; bit-equal={ok}')


def summary(rows):
    """The kernel's line for ``chip_smoke.py``: r2h A at T = 256, the case
    whose plain version runs at the probe's own length."""
    r = _summary_row(rows)
    return dict(max_abs_err=max(x['max_abs_err'] for x in rows), ms=r['ms'],
                plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                bound_by=r['bound_by'], library_ms=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    cpu = args.device == 'cpu'
    if not cpu:
        timing.require_card()
        print('card:', timing.card_line())
    rows = compare(probe(args.device, small=cpu, seed=args.seed))
    if not cpu:
        for line in hopper_question(rows):
            print(line)
    print(answer(rows))
    return 0 if all(r['equal'] for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
