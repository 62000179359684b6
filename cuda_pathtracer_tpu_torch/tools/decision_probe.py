"""What a vector->scalar decision round trip costs on Hopper: the
counterpart of two Pallas probes of the repo's ``tools/``,
``kernel_lab2.py:136`` (``make_kernel`` :34) and ``mosaic_bisect.py:166``
(``mk`` :43, ``mk_rays`` :113).

    python -m cuda_pathtracer_tpu_torch.tools.decision_probe [--device cpu]

kernel_lab2: 256 programs of 2 packets, 256 steps over an 8,192-row inner
table; every step does the same vector work (row fetch, 16-slot slab,
reductions, the nearest slot), and only the next row differs:
  sA  scripted (no wait on the decision)
  sB  from this step's decision word: a block reduce, a shared-memory word,
      a barrier, then the next row's address (the round trip)
  sC  sB plus a push / pop of a shared-memory word
  sD  from the previous step's word (the round trip off the critical path)
mosaic_bisect: one program, 1,024 dependent steps over a 4,096-row table,
each rung adding one construct (m0 the loop with a static row read, m1 a
dynamic read, m2 the slab-like math, m3/m4 the decision word as the next
row, m5 8 sets, m6 the row id in shared memory, m7 the rays, m8 a bit-cast
meta word, m9 the t compare), so each construct's price is a difference.

:func:`run` launches ``csrc/probe_decision.cu`` on CUDA tensors (or raises)
and takes the plain version :func:`run_ref` for CPU tensors. Outputs come
with the scratch the TPU kernel leaves (the decision words, ``sc``, ``t_s``)
and a per-packet digest of every step's decision words and next row.
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

NAME = 'probe_decision'
LAB2 = ('sA', 'sB', 'sC', 'sD')
MOSAIC = tuple(f'm{k}' for k in range(10))
NPK = 2
SITE_LINES = {'lab2': 'kernel_lab2.py:136', 'mosaic': 'mosaic_bisect.py:166'}
OUTPUTS = {'lab2': ('out', 'dec_s', 'digest'),
           'mosaic': ('out', 'sc', 't_s', 'digest')}


# ---------------------------------------------------------------- plain ----

def lab2_ref(itab, rays, steps: int, variant: str):
    """``kernel_lab2.py:34-123``. itab f32[N, 128]; rays f32[G * 24, 128]
    (per packet 12 rows: o at 0-2, 1/d at 6-8). Returns out f32[G * 8, 128]
    (rows 0-1 of each program the packets' t), the decision words per
    program and packet, the digest."""
    dev = itab.device
    n = itab.shape[0]
    P = rays.shape[0] // 12
    g = P // NPK
    R = rays.view(P, 12, 128)
    O = R[:, 0:3].reshape(P, 3, 1, 128)
    IV = R[:, 6:9].reshape(P, 3, 1, 128)
    cur = torch.arange(P, device=dev) % NPK
    t = torch.full((P, 128), po.BIG / 2, dtype=torch.float32, device=dev)
    dec = torch.zeros((P, 4), dtype=torch.int64, device=dev)
    prev = torch.zeros(P, dtype=torch.int64, device=dev)
    dig = torch.zeros(P, dtype=torch.int64, device=dev)
    for step in range(steps):
        box = itab[cur][:, 0:96].reshape(P, 6, 16, 1)
        tmin, tmax = po.slab_sub(box[:, 0:3], box[:, 3:6], O, IV)
        nc = po.nearest_child(po.slab_hit(tmin, tmax, t[:, None]), tmin)
        t = torch.where((nc['kmin'] < po.BIG)[:, None], t * 1.0000001, t)
        selc = nc['selc']
        dec[:, 0] = selc
        if variant == 'sA':
            nxt = (cur * 5 + 1) % (n - 1)
        elif variant == 'sD':
            nxt = (cur + prev + 1) % (n - 1)
            prev = selc
        else:
            nxt = (cur + selc + 1) % (n - 1)
        if variant == 'sC':
            if step % 2 == 0:
                dec[:, 1] = nxt
            else:
                dec[:, 2] = dec[:, 1]
        dig = po.digest_add(dig, selc + nxt)
        cur = nxt
    out = torch.zeros((g, 8, 128), dtype=torch.float32, device=dev)
    out[:, :NPK] = t.view(g, NPK, 128)
    return dict(out=out.view(g * 8, 128), dec_s=dec.int(), digest=dig)


def _body_math(row):
    """``mosaic_bisect.py:35-40`` on the row's first four 16-wide fields
    (the same for every lane): f32[16]."""
    f = row[0:64].view(4, 16)
    a = torch.minimum(f[0] * 1.5 - 0.25, f[1])
    b = torch.maximum(f[2] * 0.5 + 0.125, f[3])
    return torch.maximum(a, b)


def _block_sum(x):
    """The kernels' block sum of 128 lanes [..., 128]: a halving tree in
    each 32-lane warp (the xor butterfly's lane 0), then the four warp sums
    in order."""
    v = x.reshape(*x.shape[:-1], 4, 32)
    o = 16
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    w = v[..., 0]
    return ((w[..., 0] + w[..., 1]) + w[..., 2]) + w[..., 3]


def mosaic_ref(tab, rays, steps: int, variant: str):
    """``mosaic_bisect.py:43-158``. tab f32[N, 128] (N a power of two);
    rays f32[16, 128] (m7-m9: 1/d x, y at rows 6-7, o/d at 12-13, t at 9).
    Returns out f32[1, 128], the ``sc`` words, ``t_s``, the digest."""
    dev = tab.device
    n = tab.shape[0]
    sc = torch.zeros((3, 8), dtype=torch.int64, device=dev)
    t_s = torch.zeros((1, 128), dtype=torch.float32, device=dev)
    dig = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.zeros((1, 128), dtype=torch.float32, device=dev)
    bits = po.bits16(dev)
    sets = 8 if variant == 'm5' else 1
    k = int(variant[1])
    for c in range(sets):
        if k <= 5:
            cur = torch.tensor(c, dtype=torch.int64, device=dev)
        if k >= 6:
            sc[2, 0] = c % n
        if k >= 7:
            t_s = rays[9:10].clone()
            ivx, ivy, oivx, oivy = rays[6], rays[7], rays[12], rays[13]
        for s in range(steps):
            if k == 0:
                v = _block_sum(tab[0]).to(torch.int32).long()
                nxt = (cur * 5 + s + v - v) & (n - 1)
                word = v
            elif k in (1, 2):
                m = tab[cur].amax() if k == 1 else _body_math(tab[cur]).amax()
                word = (m > 2.0).long()
                nxt = (cur * 5 + s + word) & (n - 1)
            elif k <= 5:
                word = torch.where(_body_math(tab[cur]) > 0.7, bits,
                                   torch.zeros_like(bits)).sum()
                sc[0, 0] = word
                nxt = (word + cur * 5 + s) & (n - 1)
            elif k == 6:
                word = torch.where(_body_math(tab[sc[2, 0]]) > 0.7, bits,
                                   torch.zeros_like(bits)).sum()
                sc[0, 0] = word
                nxt = (word + sc[2, 0] * 5 + s) & (n - 1)
            else:
                row = tab[sc[2, 0]]
                f = row[0:64].view(4, 16, 1)
                t0x = f[0] * ivx - oivx
                t1x = f[1] * ivx - oivx
                t0y = f[2] * ivy - oivy
                t1y = f[3] * ivy - oivy
                tmin = torch.maximum(torch.minimum(t0x, t1x),
                                     torch.minimum(t0y, t1y))
                tmax = torch.minimum(torch.maximum(t0x, t1x),
                                     torch.maximum(t0y, t1y))
                if k == 9:
                    chit = po.slab_hit(tmin, tmax, t_s)
                else:
                    chit = tmax >= torch.clamp_min(tmin, 0.0)
                sc[0, 0] = po.hitmask(chit.any(-1))
                sc[1, 0] = po.int_bits(row[96:97])[0] if k >= 8 else 0
                word = sc[0, 0] + sc[1, 0]
                nxt = (word + sc[2, 0] * 5 + s) & (n - 1)
            if k >= 6:
                sc[2, 0] = nxt
            else:
                cur = nxt
            dig = po.digest_add(dig, word + nxt)
        fin = sc[2, 0] if k >= 6 else cur
        out = torch.zeros((1, 128), dtype=torch.float32, device=dev) \
            + fin.to(torch.float32)
        if k == 9:
            out = out + t_s
    return dict(out=out, sc=sc.int(), t_s=t_s, digest=dig)


def run_ref(site: str, variant: str, steps: int, ins: dict):
    kernels.note_plain(NAME, next(iter(ins.values())))
    if site == 'lab2':
        return lab2_ref(ins['itab'], ins['rays'], steps, variant)
    return mosaic_ref(ins['tab'], ins['rays'], steps, variant)


INPUT_ORDER = {'lab2': ('itab', 'rays'), 'mosaic': ('tab', 'rays')}
_FLOAT_OUT = ('out', 't_s')


def run(site: str, variant: str, steps: int, ins: dict):
    """:func:`run_ref`'s contract. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/probe_decision.cu`` (or raise): one block per
    program, 128 threads on the lanes."""
    names = INPUT_ORDER[site]
    first = ins[names[0]]
    if first.device.type == 'cpu':
        return run_ref(site, variant, steps, ins)
    kernels.require_cuda(NAME, *(ins[k] for k in names),
                         dtypes=(torch.float32,) * len(names))
    n = first.shape[0]
    if site == 'lab2':
        code, programs = (0, LAB2.index(variant)), ins['rays'].shape[0] // 24
        shapes = {'out': (programs * 8, 128), 'dec_s': (programs * NPK, 4),
                  'digest': (programs * NPK,)}
    else:
        if n & (n - 1):
            raise ValueError(f'{NAME}: mosaic table rows must be a power of 2')
        code, programs = (1, MOSAIC.index(variant)), 1
        shapes = {'out': (1, 128), 'sc': (3, 8), 't_s': (1, 128),
                  'digest': (1,)}
    outs = {k: torch.empty(s, dtype=torch.float32 if k in _FLOAT_OUT
                           else torch.int32, device=first.device)
            for k, s in shapes.items()}
    in_ptrs = (ctypes.c_void_p * len(names))(*(ins[k].data_ptr() for k in names))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(v.data_ptr() for v in outs.values()))
    err = kernels.library().cpt_probe_decision(
        code[0], code[1], steps, in_ptrs, out_ptrs, n, programs,
        kernels.stream_of(first))
    kernels.LAUNCHES[NAME] += 1
    kernels.check(err, NAME)
    outs['digest'] = outs['digest'].long() & po.MASK32
    return outs


# --------------------------------------------------------------- sweeps ----

def inputs(site: str, small: bool = False, seed: int = 0):
    """The probes' inputs, in their distributions and sizes (small on the
    CPU), from a seed."""
    rs = np.random.RandomState(seed + (0 if site == 'lab2' else 1))
    if site == 'lab2':
        n, g = (256, 2) if small else (8192, 256)
        return dict(itab=rs.uniform(-10, 10, (n, 128)).astype(np.float32),
                    rays=rs.uniform(0.1, 1, (g * NPK * 12, 128)).astype(
                        np.float32))
    n = 256 if small else 4096
    return dict(tab=rs.random_sample((n, 128)).astype(np.float32),
                rays=(rs.random_sample((16, 128)) + 0.5).astype(np.float32))


def cases(small: bool = False):
    """(site, variant, T): kernel_lab2's four variants, then the rungs."""
    return ([('lab2', v, 16 if small else 256) for v in LAB2]
            + [('mosaic', v, 24 if small else 1024) for v in MOSAIC])


def probe(device: str = 'cuda', small: bool = False, seed: int = 0,
          reps: int = 3):
    """The probes' sweeps through :func:`run` (the main path)."""
    ins = {site: {k: torch.as_tensor(v, device=device)
                  for k, v in inputs(site, small, seed).items()}
           for site in ('lab2', 'mosaic')}
    rows = []
    for site, variant, t in cases(small):
        fn = lambda: run(site, variant, t, ins[site])  # noqa: E731
        if device != 'cpu':
            ms, out = timing.cuda_ms(fn, reps=reps, warmup=1, preroll=True)
        else:
            ms, out = None, fn()
        programs = ins[site]['rays'].shape[0] // 24 if site == 'lab2' else 1
        rows.append(dict(site=site, variant=variant, label=variant, steps=t,
                         out=out, ms=ms, ins=ins[site], programs=programs,
                         sets=8 if variant == 'm5' else 1))
    return rows




def compare(rows, check_steps: int = 256):
    """Each case against the plain version bit for bit, digests included, at
    its T cut to ``check_steps``. ``sB`` (run whole) also gets the plain
    version's time and the bound: the table and rays read once, the
    outputs, and 16 slabs of 128 rays per packet-step (25 FP32 operations
    each)."""
    for r in rows:
        t = min(r['steps'], check_steps)
        got = r['out'] if t == r['steps'] else run(r['site'], r['variant'], t,
                                                   r['ins'])
        fn = lambda: run_ref(r['site'], r['variant'], t, r['ins'])  # noqa: E731
        if r['ins']['rays'].is_cuda and r['variant'] == 'sB':
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


def _ns(r):
    """ns per packet-step (lab2: the 256 programs run side by side, so per
    program) or per step (mosaic, over its sets)."""
    if r['site'] == 'lab2':
        return r['ms'] * 1e6 / r['steps'] / NPK
    return r['ms'] * 1e6 / r['steps'] / r['sets']


def hopper_question(rows):
    """ns per packet-step per kernel_lab2 variant, the round trip (sB - sA)
    and what sD hides of it; ns per step per mosaic rung, in order, with the
    step over the rung before."""
    lab = {r['variant']: _ns(r) for r in rows if r['site'] == 'lab2'}
    lines = [f"kernel_lab2.py:136 {v}: {lab[v]:7.1f} ns/packet-step"
             for v in LAB2]
    trip = lab['sB'] - lab['sA']
    hidden = (lab['sB'] - lab['sD']) / trip if trip else float('nan')
    lines.append(f'kernel_lab2.py:136 round trip sB - sA: {trip:.1f} ns; '
                 f'sD hides {hidden:.2f} of it; stack traffic sC - sB '
                 f'{lab["sC"] - lab["sB"]:.1f} ns')
    prev = None
    for r in rows:
        if r['site'] == 'mosaic':
            ns = _ns(r)
            step = '' if prev is None else f' ({ns - prev:+.1f})'
            lines.append(f"mosaic_bisect.py:166 {r['variant']}: {ns:7.1f} "
                         f"ns/step{step}")
            prev = ns
    return lines


def answer(rows) -> str:
    ok = all(r['equal'] for r in rows)
    if rows[0]['ms'] is None:
        return f'decision_probe: {len(rows)} cases, plain only, ok={ok}'
    lab = {r['variant']: _ns(r) for r in rows if r['site'] == 'lab2'}
    return (f'decision_probe: round trip sB - sA {lab["sB"] - lab["sA"]:.1f} '
            f'ns per packet-step (sA {lab["sA"]:.1f}, sB {lab["sB"]:.1f}, sD '
            f'{lab["sD"]:.1f}); bit-equal={ok}')


def summary(rows):
    """The kernel's line for ``chip_smoke.py``: kernel_lab2 ``sB``."""
    r = next(x for x in rows if x['variant'] == 'sB')
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
