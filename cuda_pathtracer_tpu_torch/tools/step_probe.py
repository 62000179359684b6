"""A scripted packet-traversal step chained T times on one block: the Hopper
counterpart of the repo's ``tools/pallas_probe_r2b.py:49``, ``r2c.py:63``,
``r2d.py:52`` and ``r2e.py:62``, which priced one dependent step of a packet
loop on the TPU and what each part of it costs. Here: ns per dependent step,
what each toggle costs, and how NI interleaved chains share a block's
barrier, beside the 16-lane group traversal's ~76 ns of card time per
ray-visit on sibenik's primary wave (``chip_smoke.py``'s v2 primary wave,
its ms over the plain walk's visits; ROADMAP B.5).

    python -m cuda_pathtracer_tpu_torch.tools.step_probe [--device cpu]

A step (``r2b.py:17-44``): read tile ``tab[idx]`` (8 x 128 f32), vector ops
against an 8 x 128 ray block, a max reduce to a scalar, a push and pop of a
64-entry stack, the scalar accumulated; the next index is scripted,
``(idx * 5 + 1) % N``. :func:`step` launches ``tools/csrc/probe_step.cu`` on
CUDA tensors (or raises) and takes the plain version :func:`step_ref` for
CPU tensors; the two are bit-equal.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import kernels
from . import probe_kernels
from . import timing

NAME = 'probe_step'
N_NODES = 1024
STACK_LIMIT = 60
# (read, vec, sreduce, stack) of r2c's and r2d's variants
R2C_FLAGS = {'loop only': (0, 0, 0, 0), 'read': (1, 0, 0, 0),
             'vec': (0, 1, 0, 0), 'sreduce': (0, 0, 1, 0),
             'stack': (0, 0, 0, 1), 'read+vec': (1, 1, 0, 0),
             'read+vec+sreduce': (1, 1, 1, 0), 'full': (1, 1, 1, 1)}
R2D_NAMES = ('loop only', 'read', 'read+vec', 'read+vec+sreduce', 'full')
FULL = (1, 1, 1, 1)
GROUP_NS_PER_VISIT = 76   # the v2 group traversal, sibenik primary wave


def step_ref(tab, rays, steps: int, flags=FULL, ni: int = 1,
             batched: bool = False):
    """The plain version. ``tab`` f32 [N, 8, 128], ``rays`` f32 [8, 128];
    ``flags`` = (read, vec, sreduce, stack); ``ni`` chains start at indices
    0..ni-1. ``batched`` changes no value (one drain for all chains' reduces
    instead of one each). Returns f32 [8, 128]."""
    probe_kernels.note_plain(NAME, tab)
    read, vec, sreduce, stack = (bool(f) for f in flags)
    n = tab.shape[0]
    dev = tab.device
    idx = [torch.tensor(p, dtype=torch.int64, device=dev) for p in range(ni)]
    sp = [torch.tensor(0, dtype=torch.int64, device=dev) for _ in range(ni)]
    stk = torch.zeros((ni, 64), dtype=torch.int64, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    vacc = torch.zeros_like(rays)
    for i in range(steps):
        cs = []
        for p in range(ni):
            tile = tab[idx[p]] if read else rays * (1.0 + idx[p].float())
            if vec:
                a = (tile - rays) * rays
                b = torch.maximum(a, tile * 0.5 + rays)
                tile = torch.minimum(b * b + a, a * 1.5 - tile)
            cs.append(tile)
        if sreduce:
            reds = [c.max() for c in cs]
            for r in reds:
                acc = acc + r
            hits = [r > 0.0 for r in reds]
        else:
            vacc = vacc + cs[0]
            hits = [torch.tensor((i % 3) > 0, device=dev)] * ni
        for p in range(ni):
            nxt = (idx[p] * 5 + 1) % n
            if stack:
                push = hits[p] & (sp[p] < STACK_LIMIT)
                stk[p].index_put_((sp[p],), torch.where(push, nxt,
                                                        stk[p][sp[p]]))
                sp2 = torch.where(push, sp[p] + 1, sp[p])
                sp3 = (sp2 - 1).clamp_min(0)
                idx[p] = torch.where(sp2 > 0, stk[p][sp3], nxt)
                sp[p] = sp3
            else:
                idx[p] = nxt
    out = rays + acc
    return out if sreduce else out + vacc


def step(tab, rays, steps: int, flags=FULL, ni: int = 1,
         batched: bool = False):
    """:func:`step_ref`'s contract. CPU tensors take the plain version; CUDA
    tensors launch ``tools/csrc/probe_step.cu`` on one block (or raise). NI > 1
    takes all four flags on, as r2e does."""
    if tab.device.type == 'cpu':
        return step_ref(tab, rays, steps, flags, ni, batched)
    kernels.require_cuda(NAME, tab, rays,
                         dtypes=(torch.float32, torch.float32))
    if tab.shape[1:] != (8, 128) or tuple(rays.shape) != (8, 128):
        raise ValueError(f'{NAME}: tab [N, 8, 128] and rays [8, 128]')
    if ni not in (1, 2, 4, 8) or (ni > 1 and tuple(flags) != FULL) \
            or ni > tab.shape[0]:
        raise ValueError(f'{NAME}: ni={ni} with flags {flags}')
    code = sum(int(bool(f)) << k for k, f in enumerate(flags))
    out = torch.empty_like(rays)
    err = probe_kernels.library().cpt_probe_step(
        tab.data_ptr(), rays.data_ptr(), out.data_ptr(), tab.shape[0], steps,
        code, ni, int(batched), kernels.stream_of(tab))
    probe_kernels.launched(err, NAME)
    return out


def inputs(n: int = N_NODES, seed: int = 0):
    """The probes' table (uniform in [-0.5, 0.5)) and rays (in [0, 1))."""
    rs = np.random.RandomState(seed)
    tab = (rs.rand(n, 8, 128) - 0.5).astype(np.float32)
    rays = rs.rand(8, 128).astype(np.float32)
    return tab, rays


def cases(small: bool = False):
    """The probes' own sweeps: (site, label, flags, ni, batched, T)."""
    s = (lambda big, little: little) if small else (lambda big, little: big)
    out = [('pallas_probe_r2b.py:49', 'base chain', FULL, 1, False,
            s(4096, 24))]
    out += [('pallas_probe_r2c.py:63', name, f, 1, False, s(4096, 24))
            for name, f in R2C_FLAGS.items()]
    out += [('pallas_probe_r2d.py:52', name, R2C_FLAGS[name], 1, False, t)
            for name in R2D_NAMES for t in (s(8192, 16), s(131072, 40))]
    out += [('pallas_probe_r2e.py:62', f'NI={ni} batched={int(b)}', FULL, ni,
             b, t) for ni in (1, 2, 4, 8) for b in (False, True)
            for t in (s(4096, 8), s(32768, 20))]
    return out


def probe(device: str = 'cuda', small: bool = False, seed: int = 0,
          reps: int = 3):
    """The probes' sweeps through :func:`step` (the main path): one dict per
    case with the output and, on the card, the kernel's time."""
    tab_np, rays_np = inputs(16 if small else N_NODES, seed)
    tab = torch.as_tensor(tab_np, device=device)
    rays = torch.as_tensor(rays_np, device=device)
    rows = []
    for site, label, flags, ni, batched, t in cases(small):
        fn = lambda: step(tab, rays, t, flags, ni, batched)  # noqa: E731
        if tab.is_cuda:
            ms, out = timing.cuda_ms(fn, reps=reps, warmup=1, preroll=True)
        else:
            ms, out = None, fn()
        rows.append(dict(site=site, label=label, flags=flags, ni=ni,
                         batched=batched, steps=t, out=out, ms=ms, tab=tab,
                         rays=rays))
    return rows


def _distinct_tiles(n: int, steps: int, ni: int) -> int:
    seen = set()
    for p in range(ni):
        i = p
        for _ in range(steps):
            seen.add(i)
            i = (i * 5 + 1) % n
    return len(seen)


def compare(rows, check_steps: int = 1024, check_steps_ni: int = 256):
    """Each distinct kernel configuration against the plain version, bit
    for bit, at its own T cut to ``check_steps`` (``check_steps_ni`` for
    NI > 1): the plain chain is ~25 launches per chain and step. The r2b row
    also gets the plain version's time and the bound (distinct tiles read
    once, rays and output; 11 operations per element and step, FP32)."""
    done = {}
    for r in rows:
        key = (r['flags'], r['ni'], r['batched'])
        cap = check_steps if r['ni'] == 1 else check_steps_ni
        if r['site'].endswith('r2b.py:49'):
            cap = r['steps']
        t = min(r['steps'], cap)
        if key not in done or r['site'].endswith('r2b.py:49'):
            got = r['out'] if t == r['steps'] else step(
                r['tab'], r['rays'], t, *key)
            fn = lambda: step_ref(r['tab'], r['rays'], t, *key)  # noqa: E731
            if r['tab'].is_cuda and r['site'].endswith('r2b.py:49'):
                r['plain_ms'], want = timing.cuda_ms(fn)
                n_bytes = (_distinct_tiles(r['tab'].shape[0], t, 1) * 4096
                           + 2 * 4096)
                r['bound_ms'], r['bound_by'] = timing.bound(
                    n_bytes, 11 * 1024 * t)
            else:
                want = fn()
            done[key] = (t, bool(torch.equal(got.view(torch.int32),
                                             want.view(torch.int32))),
                         float((got - want).abs().max()))
        r['check_steps'], r['equal'], r['max_abs_err'] = done[key]
    return rows


def _slope(rows, site: str, label: str):
    """(ns per step between the case's shortest and longest T, the two
    (T, ms))."""
    pts = sorted((r['steps'], r['ms']) for r in rows
                 if r['site'] == site and r['label'] == label)
    (t0, a), (t1, b) = pts[0], pts[-1]
    return (b - a) * 1e6 / (t1 - t0), (t0, a), (t1, b)


def hopper_question(rows):
    """ns per step per case, the r2d and r2e slopes, and the toggles' costs,
    beside the group traversal's ns per ray-visit."""
    lines = []
    for r in rows:
        if r['site'].endswith(('r2b.py:49', 'r2c.py:63')):
            lines.append(f"{r['site']} {r['label']:18s} T={r['steps']:6d}: "
                         f"{r['ms']:9.3f} ms, {r['ms'] / r['steps'] * 1e6:7.1f} "
                         f"ns/step")
    for name in R2D_NAMES:
        slope, (t0, a), (t1, b) = _slope(rows, 'pallas_probe_r2d.py:52', name)
        lines.append(f'pallas_probe_r2d.py:52 {name:18s} slope {slope:7.1f} '
                     f'ns/step (T{t0}: {a:.3f} ms, T{t1}: {b:.3f} ms)')
    for ni in (1, 2, 4, 8):
        for b_ in (0, 1):
            label = f'NI={ni} batched={b_}'
            slope = _slope(rows, 'pallas_probe_r2e.py:62', label)[0]
            lines.append(f'pallas_probe_r2e.py:62 {label:18s} {slope:7.1f} '
                         f'ns/step = {slope / ni:6.1f} ns/chain-step')
    lines.append(f'(16-lane group traversal: ~{GROUP_NS_PER_VISIT} ns of card '
                 f'time per ray-visit on sibenik\'s primary wave)')
    return lines


def answer(rows) -> str:
    ok = all(r['equal'] for r in rows)
    if rows[0]['ms'] is None:
        return f'step_probe: {len(rows)} cases, plain only, ok={ok}'
    full = _slope(rows, 'pallas_probe_r2d.py:52', 'full')[0]
    loop = _slope(rows, 'pallas_probe_r2d.py:52', 'loop only')[0]
    e8 = _slope(rows, 'pallas_probe_r2e.py:62', 'NI=8 batched=1')[0]
    return (f'step_probe: full step {full:.1f} ns (loop only {loop:.1f}); NI=8 '
            f'batched {e8 / 8:.1f} ns per chain-step; group traversal '
            f'~{GROUP_NS_PER_VISIT} ns per ray-visit; bit-equal={ok}')


def summary(rows):
    """The kernel's line for ``chip_smoke.py``: r2b's base chain (T = 4096),
    the one case whose plain version runs at the probe's own length."""
    r = rows[0]
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
