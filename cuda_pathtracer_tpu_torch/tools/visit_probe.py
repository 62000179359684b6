"""The v2 packet visit taken apart piece by piece on Hopper: the counterpart
of two Pallas probes of the repo's ``tools/``, ``kernel_lab3.py:487``
(``make_kernel`` :65, ``pack_bf16`` :459) and ``subpacket_probe.py:295``
(``_mk`` :68, ``_mk_v2ref`` :227).

    python -m cuda_pathtracer_tpu_torch.tools.visit_probe [--device cpu]

kernel_lab3: 256 programs of 2 packets, 256 scripted steps over an
8,192-row table, 17 rungs (``make_kernel``'s whole list): ``empty`` (the
loop), ``fetch`` (+ the row), ``trans`` (+ the row's first word to every
lane), ``bcast`` (+ six 16-wide field blocks), ``slab`` (+ the 16-slot slab),
``full`` (+ the any-reduce and the decision words), ``bf16`` (the box planes
as packed bf16 pairs, unpacked by shift), ``dual`` (two visits per step),
``mxu`` (the any-reduce as per-slot hit counts on the tensor cores),
``share8``/``share16`` (8 or 16 visits under one reduce), ``share8t``/
``share16t`` (the same with the rows staged together in shared memory),
``leaf`` (12 Moller-Trumbore tests), ``leaf8``/``leaf8t``/``leaf16t`` (8 or 16
leaves per step, staged or not).
subpacket_probe: one program, 32,768 steps x 8 sets over a 32,768-row
table, 8 subpackets of 16 lanes per step: ``v2ref`` (one row per 128-lane
packet), ``fetch8`` (8 dependent row fetches), ``exp_mxu`` (each lane's box
fields expanded from its subpacket's row on the tensor cores), ``dec_mxu``
(per-subpacket decisions from tensor-core counts, handed over as an (8,
DECW) block in shared memory and one barrier), ``dec_sum`` (the same words
from per-subpacket reductions), ``full`` (``dec_mxu`` plus the leaf path).

The tensor-core rungs stay exact: 0/1 hit masks and counts in bf16 with an
f32 accumulator, and an f32 row expanded by a 0/1 matrix as three bf16
pieces summed (hi + mid) + lo (``onehot_probe``'s scheme). :func:`run`
launches ``csrc/probe_visit.cu`` on CUDA tensors (or raises) and takes the
plain version :func:`run_ref` for CPU tensors. Outputs come with the
scratch the TPU kernel leaves and a per-packet digest of every decision
word written, since most rungs' output is blind to their work (kernel_lab3
scripts its next row and ``full`` only scales t).
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ..ops import kernels
from . import packet_ops as po
from . import timing

NAME = 'probe_visit'
LAB3 = ('empty', 'fetch', 'trans', 'bcast', 'slab', 'full', 'bf16', 'dual',
        'mxu', 'share8', 'share8t', 'share16', 'share16t', 'leaf', 'leaf8',
        'leaf8t', 'leaf16t')
SUBPACKET = ('v2ref', 'fetch8', 'exp_mxu', 'dec_mxu', 'dec_sum', 'full')
NPK = 2
DECW = 128
BIG_SUB = 1e30          # subpacket_probe.py's BIG
# visits per packet-step (kernel_lab3.py:508-510)
VISITS = {'dual': 2, 'share8': 8, 'share8t': 8, 'share16': 16,
          'share16t': 16, 'leaf8': 8, 'leaf8t': 8, 'leaf16t': 16}
SITE_LINES = {'lab3': 'kernel_lab3.py:487', 'subpacket': 'subpacket_probe.py:295'}
SUB_OUTPUTS = {'v2ref': ('out', 'sc', 't_s'),
               'fetch8': ('out', 'rt', 'sc', 't_s'),
               'exp_mxu': ('out', 'rt', 'sc', 't_s'),
               'dec_sum': ('out', 'rt', 'sc', 't_s'),
               'dec_mxu': ('out', 'rt', 'dec_v', 'dmem', 'sc', 't_s'),
               'full': ('out', 'rt', 'dec_v', 'dmem', 'sc', 't_s')}


def outputs(site: str, variant: str):
    """The outputs one case returns, digest last."""
    if site == 'lab3':
        return ('out', 'dec_s', 'digest')
    return SUB_OUTPUTS[variant] + ('digest',)


def pack_bf16(tab):
    """``kernel_lab3.py:459-467``: the 96 box planes rounded to bf16 and
    packed in pairs (plane 2k low, 2k + 1 high) into lanes 0-47, 80 zero
    lanes after."""
    planes = tab[:, :96].to(torch.bfloat16).view(torch.int16).to(
        torch.int64) & 0xFFFF
    planes = planes.view(-1, 48, 2)
    packed = po.wrap32(planes[..., 0] | (planes[..., 1] << 16))
    out = torch.zeros((tab.shape[0], 128), dtype=torch.int32,
                      device=tab.device)
    out[:, :48] = packed.to(torch.int32)
    return out.view(torch.float32)


# ---------------------------------------------------------------- plain ----

def _slab(rows, IV, OIV, t):
    """kernel_lab3's ``slab``: boxes at lanes 0-95 of each row [Q, 128],
    the product form; rows may carry an extra leading axis of visits."""
    box = rows[..., 0:96].reshape(*rows.shape[:-1], 6, 16, 1)
    tmin, tmax = po.slab_fma(box[..., 0:3, :, :], box[..., 3:6, :, :], IV,
                             OIV)
    return po.slab_hit(tmin, tmax, t)


def _slab_bf16(brow, IV, OIV, t):
    """``kernel_lab3.py:100-132``: even planes unpacked by shift; child c
    of field f reads packed lane 8 f + c // 2."""
    packed = po.int_bits(brow[:, 0:48])
    lo16 = po.wrap32((packed << 16) & po.MASK32).to(torch.int32).view(
        torch.float32)
    box = lo16.view(-1, 6, 8).repeat_interleave(2, dim=-1)[..., None]
    tmin, tmax = po.slab_fma(box[:, 0:3], box[:, 3:6], IV, OIV)
    return po.slab_hit(tmin, tmax, t)


def _leaf(rows, O, D, t, big=po.BIG):
    """kernel_lab3's ``visit_leaf`` on K rows at once [Q, K, 128]: (leaf_t,
    take) over all K x 12 triangles."""
    q, k = rows.shape[0], rows.shape[1]
    fm = rows[:, :, 0:108].reshape(q, k, 9, 12).permute(0, 2, 1, 3).reshape(
        q, 9, k * 12, 1)
    ok, tt = po.moller(fm[:, 0:3], fm[:, 3:6], fm[:, 6:9], O, D, 1e-4)
    okm = ok & (tt > 0.0) & (tt < t[:, None])
    leaf_t = torch.where(okm, tt, torch.full_like(tt, big)).amin(1)
    return leaf_t, okm.any(1)


def lab3_ref(tab, btab, rays, steps: int, variant: str):
    """``kernel_lab3.py:65-456``. tab f32[N, 128]; btab its ``pack_bf16``;
    rays f32[G * 32, 128] (per packet 16 rows: o 0-2, d 3-5, 1/d 6-8, o/d
    12-14). Returns out f32[G * 8, 128] (rows 0-1 of each program the
    packets' t), the decision words and the digest per packet."""
    dev = tab.device
    n = tab.shape[0]
    P = rays.shape[0] // 16
    g = P // NPK
    R = rays.view(P, 16, 128)
    O = R[:, 0:3].reshape(P, 3, 1, 128)
    D = R[:, 3:6].reshape(P, 3, 1, 128)
    IV = R[:, 6:9].reshape(P, 3, 1, 128)
    OIV = R[:, 12:15].reshape(P, 3, 1, 128)
    cur = torch.arange(P, device=dev) % NPK
    t = torch.full((P, 128), po.BIG / 2, dtype=torch.float32, device=dev)
    dec = torch.zeros((P, 4), dtype=torch.int64, device=dev)
    dig = torch.zeros(P, dtype=torch.int64, device=dev)
    kvis = VISITS.get(variant, 1)

    def decide(chit, meta_row):
        nonlocal dig
        dec[:, 0] = po.hitmask(chit.any(-1))
        dec[:, 1] = po.int_bits(meta_row[:, 96])
        dig = po.digest_add(dig, dec[:, 0] + dec[:, 1])

    for _ in range(steps):
        if variant in ('full', 'mxu', 'dual', 'bf16'):
            for c in ((cur, (cur + 1) % (n - 1)) if variant == 'dual'
                      else (cur,)):
                src = btab if variant == 'bf16' else tab
                row = src[c]
                th = t[:, None]
                chit = (_slab_bf16(row, IV, OIV, th) if variant == 'bf16'
                        else _slab(row, IV, OIV, th))
                decide(chit, row)
                t = t * 1.0000001
        elif variant.startswith('share'):
            idx = (cur[:, None] + 37 * torch.arange(kvis, device=dev)) % (n - 1)
            rows = tab[idx]                                  # [P, K, 128]
            chit = _slab(rows, IV[:, None], OIV[:, None], t[:, None, None])
            masks = po.hitmask(chit.any(-1))                 # [P, K]
            metas = po.int_bits(rows[:, :, 96])
            dig = po.digest_add(dig, (masks + metas).sum(-1))
            dec[:, 0], dec[:, 1] = masks[:, -1], metas[:, -1]
            t = t * 1.0000001
        elif variant.startswith('leaf'):
            idx = (cur[:, None] + 37 * torch.arange(kvis, device=dev)) % (n - 1)
            leaf_t, take = _leaf(tab[idx], O, D, t)
            t = torch.where(take, leaf_t, t)
            dec[:, 0] = cur
            dig = po.digest_add(dig, cur)
        else:
            row = tab[cur]
            if variant == 'fetch':
                t = t + row * 1e-30
            elif variant == 'trans':
                t = t + row[:, 0:1] * 1e-30
            elif variant == 'bcast':
                f = row[:, 0:96].view(P, 6, 16)
                acc = f[:, 0]
                for k in range(1, 6):
                    acc = acc + f[:, k]
                t = t + acc.amin(-1, keepdim=True) * 1e-30
            elif variant == 'slab':
                csum = _slab(row, IV, OIV, t[:, None]).float().sum(1)
                t = t + csum * 1e-30
            dec[:, 0] = cur
            dig = po.digest_add(dig, cur)
        cur = (cur * 5 + 1) % (n - 1)
    out = torch.zeros((g, 8, 128), dtype=torch.float32, device=dev)
    out[:, :NPK] = t.view(g, NPK, 128)
    return dict(out=out.view(g * 8, 128), dec_s=dec.int(), digest=dig)


def _expand(rt, lo: int, k: int, rows: int):
    """``subpacket_probe.py:100-106``: out[i, l] = rt[l // 16, lo + k rows
    + i], each lane the field of its subpacket's row (exact: a 0/1
    product)."""
    f = rt[:, lo + k * rows:lo + (k + 1) * rows]             # [8, rows]
    return f.t().repeat_interleave(16, dim=1)                # [rows, 128]


def subpacket_ref(tab, rays, steps: int, sets: int, variant: str):
    """``subpacket_probe.py:68-272``. tab f32[N, 128] (N a power of two);
    rays f32[16, 128] (o 0-2, d 3-5, 1/d 6-8, t 9, o/d 12-14). Returns out
    f32[1, 128] = the 8 row ids' sum + t, the scratch (``rt``, ``dec_v``,
    ``dmem``, ``sc``, ``t_s``) and the digest."""
    dev = tab.device
    n = tab.shape[0]
    O = rays[0:3].view(3, 1, 128)
    D = rays[3:6].view(3, 1, 128)
    IV = rays[6:9].view(3, 1, 128)
    OIV = rays[12:15].view(3, 1, 128)
    sc = torch.zeros((3, 8), dtype=torch.int64, device=dev)
    rt = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    dec_v = torch.zeros((8, DECW), dtype=torch.int64, device=dev)
    dig = torch.zeros(1, dtype=torch.int64, device=dev)
    grp = torch.arange(8, device=dev)
    out = None
    for c in range(sets):
        t_s = rays[9:10].clone()
        if variant == 'v2ref':
            sc[2, 0] = c % n
        else:
            sc[2] = (c * 7 + grp * 13) % n
        for s in range(steps):
            if variant == 'v2ref':
                row = tab[sc[2, 0]]
                box = row[0:96].view(6, 16, 1)
                tmin, tmax = po.slab_fma(box[0:3], box[3:6], IV, OIV)
                chit = po.slab_hit(tmin, tmax, t_s)
                sc[0, 0] = po.hitmask(chit.any(-1))
                sc[1, 0] = po.int_bits(row[96:97])[0]
                sc[2, 0] = (sc[0, 0] + sc[1, 0] + sc[2, 0] * 5 + s) & (n - 1)
                dig = po.digest_add(dig, sc[0, 0] + sc[1, 0] + sc[2, 0])
                continue
            rt = tab[sc[2]]
            if variant == 'fetch8':
                sc[0, 0] = rt[0, 0].to(torch.int32).long()
                sc[2] = (sc[0, 0] + sc[2] * 5 + grp * 37 + s) & (n - 1)
                dig = po.digest_add(dig, sc[0, 0] + sc[2].sum())
                continue
            box = torch.stack([_expand(rt, 0, k, 16) for k in range(6)])
            tmin, tmax = po.slab_fma(box[0:3], box[3:6], IV, OIV)
            chit = po.slab_hit(tmin, tmax, t_s)              # [16, 128]
            if variant == 'exp_mxu':
                sc[0, 0] = po.hitmask(chit.any(-1))
                sc[2] = (sc[0, 0] + sc[2] * 5 + grp * 37 + s) & (n - 1)
                dig = po.digest_add(dig, sc[0, 0] + sc[2].sum())
            else:
                anyg = chit.view(16, 8, 16).any(-1).t()       # [8 groups, 16]
                bits = po.hitmask(anyg)
                meta = po.int_bits(rt[:, 96])
                if variant == 'dec_sum':
                    sc[0], sc[1] = bits, meta
                else:
                    dec_v[:, 0], dec_v[:, 1] = bits, meta
                sc[2] = (bits + meta + sc[2] * 5 + grp * 37 + s) & (n - 1)
                dig = po.digest_add(dig, (bits + meta).sum() + sc[2].sum())
            if variant == 'full':
                tri = torch.stack([_expand(rt, 0, k, 12) for k in range(9)])
                leaf_t, take = _leaf_rows(tri, O, D, t_s)
                t_s = torch.where(take, leaf_t, t_s)
        acc = sc[2, 0] if variant == 'v2ref' else sc[2].sum()
        out = torch.zeros((1, 128), dtype=torch.float32, device=dev) \
            + acc.to(torch.float32)
        out = out + t_s
    res = dict(out=out, rt=rt, dec_v=dec_v.int(), dmem=dec_v.int(),
               sc=sc.int(), t_s=t_s, digest=dig)
    return {k: res[k] for k in outputs('subpacket', variant)}


def _leaf_rows(tri, O, D, t):
    """subpacket's leaf path on expanded fields tri [9, 12, 128]."""
    ok, tt = po.moller(tri[0:3], tri[3:6], tri[6:9], O, D, 1e-4)
    okm = ok & (tt > 0.0) & (tt < t)
    leaf_t = torch.where(okm, tt, torch.full_like(tt, BIG_SUB)).amin(0,
                                                                     keepdim=True)
    return leaf_t, okm.any(0, keepdim=True)


def run_ref(site: str, variant: str, steps: int, ins: dict, sets: int = 8):
    kernels.note_plain(NAME, next(iter(ins.values())))
    if site == 'lab3':
        return lab3_ref(ins['tab'], ins['btab'], ins['rays'], steps, variant)
    return subpacket_ref(ins['tab'], ins['rays'], steps, sets, variant)


INPUT_ORDER = {'lab3': ('tab', 'btab', 'rays'), 'subpacket': ('tab', 'rays')}
_FLOAT_OUT = ('out', 't_s', 'rt')


def run(site: str, variant: str, steps: int, ins: dict, sets: int = 8):
    """:func:`run_ref`'s contract. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/probe_visit.cu`` (or raise): one block of 128
    threads per program."""
    names = INPUT_ORDER[site]
    first = ins[names[0]]
    if first.device.type == 'cpu':
        return run_ref(site, variant, steps, ins, sets)
    kernels.require_cuda(NAME, *(ins[k] for k in names),
                         dtypes=(torch.float32,) * len(names))
    n = first.shape[0]
    if site == 'lab3':
        code, programs = (0, LAB3.index(variant)), ins['rays'].shape[0] // 32
        shapes = {'out': (programs * 8, 128), 'dec_s': (programs * NPK, 4),
                  'digest': (programs * NPK,)}
    else:
        if n & (n - 1):
            raise ValueError(f'{NAME}: subpacket table rows must be a power '
                             f'of 2')
        code, programs = (1, SUBPACKET.index(variant)), sets
        shapes = {'out': (1, 128), 'rt': (8, 128), 'dec_v': (8, DECW),
                  'dmem': (8, DECW), 'sc': (3, 8), 't_s': (1, 128),
                  'digest': (1,)}
    outs = {k: torch.zeros(s, dtype=torch.float32 if k in _FLOAT_OUT
                           else torch.int32, device=first.device)
            for k, s in shapes.items()}
    in_ptrs = (ctypes.c_void_p * len(names))(*(ins[k].data_ptr() for k in names))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(v.data_ptr() for v in outs.values()))
    err = kernels.library().cpt_probe_visit(
        code[0], code[1], steps, in_ptrs, out_ptrs, n, programs,
        kernels.stream_of(first))
    kernels.LAUNCHES[NAME] += 1
    kernels.check(err, NAME)
    outs['digest'] = outs['digest'].long() & po.MASK32
    return {k: outs[k] for k in outputs(site, variant)}


# --------------------------------------------------------------- sweeps ----

def inputs(site: str, small: bool = False, seed: int = 0):
    """The probes' inputs in their distributions and sizes (small on the
    CPU), from a seed; kernel_lab3's packed table is made by the caller
    (:func:`pack_bf16`)."""
    rs = np.random.RandomState(seed + (2 if site == 'lab3' else 3))
    if site == 'lab3':
        n, g = (256, 2) if small else (8192, 256)
        return dict(tab=rs.uniform(-10, 10, (n, 128)).astype(np.float32),
                    rays=rs.uniform(0.1, 1, (g * NPK * 16, 128)).astype(
                        np.float32))
    n = 256 if small else 1 << 15
    return dict(tab=rs.random_sample((n, 128)).astype(np.float32),
                rays=(rs.random_sample((16, 128)) + 0.5).astype(np.float32))


def case_inputs(site: str, small: bool, device, seed: int = 0):
    ins = {k: torch.as_tensor(v, device=device)
           for k, v in inputs(site, small, seed).items()}
    if site == 'lab3':
        ins = dict(tab=ins['tab'], btab=pack_bf16(ins['tab']), rays=ins['rays'])
    return ins


def cases(small: bool = False):
    """(site, variant, T, sets): every kernel_lab3 rung, every subpacket
    variant."""
    return ([('lab3', v, 8 if small else 256, 1) for v in LAB3]
            + [('subpacket', v, 4 if small else 32768, 2 if small else 8)
               for v in SUBPACKET])


def probe(device: str = 'cuda', small: bool = False, seed: int = 0,
          reps: int = 3):
    """The probes' sweeps through :func:`run` (the main path)."""
    ins = {site: case_inputs(site, small, device, seed)
           for site in ('lab3', 'subpacket')}
    rows = []
    for site, variant, t, sets in cases(small):
        fn = lambda: run(site, variant, t, ins[site], sets)  # noqa: E731
        if device != 'cpu':
            ms, out = timing.cuda_ms(fn, reps=reps, warmup=1, preroll=True)
        else:
            ms, out = None, fn()
        programs = ins[site]['rays'].shape[0] // 32 if site == 'lab3' else 1
        rows.append(dict(site=site, variant=variant, label=variant, steps=t,
                         sets=sets, out=out, ms=ms, ins=ins[site],
                         programs=programs))
    return rows




def compare(rows, check_steps: int = 256, check_sets: int = 1):
    """Each case against the plain version bit for bit, digests included, at
    T cut to ``check_steps`` (subpacket: one set of ``check_steps``). The
    ``full`` rung (run whole) also gets the plain version's time and the
    bound: the table and rays read once, the outputs, 16 slabs of 128 rays
    per packet-step (25 FP32 operations each)."""
    for r in rows:
        t = min(r['steps'], check_steps)
        sets = r['sets'] if t == r['steps'] else min(r['sets'], check_sets)
        got = r['out'] if (t, sets) == (r['steps'], r['sets']) else run(
            r['site'], r['variant'], t, r['ins'], sets)
        fn = lambda: run_ref(r['site'], r['variant'], t, r['ins'], sets)  # noqa: E731
        if r['ins']['rays'].is_cuda and (r['site'], r['variant']) == ('lab3',
                                                                       'full'):
            r['plain_ms'], want = timing.cuda_ms(fn)
            n_bytes = sum(v.numel() * 4 for v in r['ins'].values()) + sum(
                v.numel() * 4 for v in got.values())
            r['bound_ms'], r['bound_by'] = timing.bound(
                n_bytes, r['programs'] * NPK * t * 16 * 128 * 25)
        else:
            want = fn()
        r['check_steps'], r['equal'] = t, po.same(got, want)
        r['max_abs_err'] = po.max_err(got, want)
    return rows


def _ns_visit(r):
    """kernel_lab3: ns per visit (``kernel_lab3.py:507-513``: the grid's
    programs side by side, so per program); subpacket: ns per step."""
    if r['site'] == 'lab3':
        return r['ms'] * 1e6 / r['steps'] / NPK / VISITS.get(r['variant'], 1)
    return r['ms'] * 1e6 / r['steps'] / r['sets']


def hopper_question(rows):
    """ns per visit per kernel_lab3 rung, in order; ns per step per
    subpacket variant and ``full / v2ref`` against its break-even of 4.0."""
    lines = []
    for r in rows:
        unit = 'visit' if r['site'] == 'lab3' else 'step'
        lines.append(f"{SITE_LINES[r['site']]} {r['variant']:8s}: "
                     f"{r['ms']:9.3f} ms, {_ns_visit(r):8.1f} ns/{unit}")
    lab = {r['variant']: _ns_visit(r) for r in rows if r['site'] == 'lab3'}
    lines.append(f'kernel_lab3.py:487 bf16 box planes: {lab["bf16"]:.1f} '
                 f'against full {lab["full"]:.1f} ns/visit '
                 f'({lab["bf16"] / lab["full"]:.3f}x)')
    sub = {r['variant']: _ns_visit(r) for r in rows if r['site'] == 'subpacket'}
    lines.append(f'subpacket_probe.py:295 full / v2ref = '
                 f'{sub["full"] / sub["v2ref"]:.2f} (break-even 4.0, a win '
                 f'below)')
    return lines


def answer(rows) -> str:
    ok = all(r['equal'] for r in rows)
    if rows[0]['ms'] is None:
        return f'visit_probe: {len(rows)} cases, plain only, ok={ok}'
    lab = {r['variant']: _ns_visit(r) for r in rows if r['site'] == 'lab3'}
    sub = {r['variant']: _ns_visit(r) for r in rows if r['site'] == 'subpacket'}
    return (f'visit_probe: full visit {lab["full"]:.1f} ns, bf16 '
            f'{lab["bf16"]:.1f}, leaf {lab["leaf"]:.1f}; subpacket full / '
            f'v2ref {sub["full"] / sub["v2ref"]:.2f} (break-even 4.0); '
            f'bit-equal={ok}')


def summary(rows):
    """The kernel's line for ``chip_smoke.py``: kernel_lab3's ``full``."""
    r = next(x for x in rows if (x['site'], x['variant']) == ('lab3', 'full'))
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
