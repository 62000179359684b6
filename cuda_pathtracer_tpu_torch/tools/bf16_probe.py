"""A chained slab test in f32, in packed bf16x2 and in bf16 widened to f32:
the Hopper counterpart of the repo's ``tools/bf16_vpu_probe.py:56`` (which
asked whether bf16 slab math is ~2x cheaper per element than f32 on the
TPU's vector unit). Here: element-steps per second per variant, and whether
bf16x2 halves the slab instruction count on Hopper.

    python -m cuda_pathtracer_tpu_torch.tools.bf16_probe [--device cpu]

:func:`slab` launches ``tools/csrc/probe_slab.cu`` on CUDA tensors (or raises)
and takes the plain version :func:`slab_ref` for CPU tensors. Both compute
``make``'s kernel (``bf16_vpu_probe.py:31-52``): K chained steps of four
products, four differences, six min/max, a compare and two selects on a
(16 R, 128) block, with K = 20000 and R = 64 as in the probe. Each op rounds
in the working type, so the kernel is bit-equal to the plain version in all
three variants.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..ops import kernels
from . import probe_kernels
from . import timing

F32, BF16, WIDEN = range(3)
VARIANTS = {'f32': F32, 'bf16': BF16, 'bf16->f32': WIDEN}
KERNEL_NAMES = {F32: 'slab_f32_kernel', BF16: 'slab_bf16_kernel',
                WIDEN: 'slab_widen_kernel'}
NAME = 'probe_slab'
K = 20000
R = 64
OPS_PER_STEP = 17   # 4 mul, 4 sub, 6 min/max, 1 compare, 2 selects


def slab_ref(variant: int, x, k: int):
    """The plain version: ``x`` f32 (F32) or bf16 (BF16, WIDEN); returns the
    same type."""
    probe_kernels.note_plain(NAME, x)
    cdt = torch.bfloat16 if variant == BF16 else torch.float32

    def const(v):
        return torch.tensor(v, dtype=cdt, device=x.device)

    xc = x.to(cdt)
    iv = xc * const(1.0009765625)
    oiv = xc * const(0.999)
    lo, hi = xc, xc + const(1.0)
    for _ in range(k):
        t0 = lo * iv - oiv
        t1 = hi * iv - oiv
        t0b = lo * oiv - iv
        t1b = hi * oiv - iv
        tmin = torch.maximum(torch.minimum(t0, t1), torch.minimum(t0b, t1b))
        tmax = torch.minimum(torch.maximum(t0, t1), torch.maximum(t0b, t1b))
        hit = tmax >= tmin
        lo, hi = torch.where(hit, -hi, lo), torch.where(hit, tmin, hi)
    return (lo + hi).to(x.dtype)


def slab(variant: int, x, k: int):
    """:func:`slab_ref`'s contract. CPU tensors take the plain version; CUDA
    tensors launch ``tools/csrc/probe_slab.cu`` (or raise)."""
    if x.device.type == 'cpu':
        return slab_ref(variant, x, k)
    want = torch.float32 if variant == F32 else torch.bfloat16
    kernels.require_cuda(NAME, x, dtypes=(want,))
    if variant not in KERNEL_NAMES or x.numel() % 2:
        raise ValueError(f'{NAME}: variant {variant} on {x.numel()} elements')
    out = torch.empty_like(x)
    if x.numel():
        err = probe_kernels.library().cpt_probe_slab(
            variant, x.data_ptr(), out.data_ptr(), x.numel(), k,
            kernels.stream_of(x))
        probe_kernels.launched(err, NAME)
    return out


def inputs(r: int = R, seed: int = 0):
    """The probe's block: standard normal (16 r, 128), f32."""
    x32 = np.random.default_rng(seed).standard_normal((16 * r, 128)).astype(
        np.float32)
    return x32


def probe(device: str = 'cuda', k: int = K, r: int = R, seed: int = 0,
          reps: int = 3):
    """The probe's three variants through :func:`slab` (its main path): one
    dict per variant with the output and, on the card, the kernel's time."""
    x32 = torch.as_tensor(inputs(r, seed), device=device)
    rows = []
    for label, v in VARIANTS.items():
        x = x32 if v == F32 else x32.to(torch.bfloat16)
        fn = lambda: slab(v, x, k)  # noqa: E731
        if x.is_cuda:
            ms, out = timing.cuda_ms(fn, reps=reps, warmup=1, preroll=True)
        else:
            ms, out = None, fn()
        rows.append(dict(label=label, variant=v, x=x, k=k, out=out, ms=ms))
    return rows


def compare(rows):
    """Each variant's kernel output against the plain version, bit for bit;
    on the card also the plain version's time and the bound (FP32 at 67
    TFLOP/s, bf16x2 at 134 TFLOP/s)."""
    for r in rows:
        fn = lambda: slab_ref(r['variant'], r['x'], r['k'])  # noqa: E731
        if r['x'].is_cuda:
            r['plain_ms'], want = timing.cuda_ms(fn)
            n_ops = OPS_PER_STEP * r['x'].numel() * r['k']
            rate = (timing.BF16_OPS_PER_S if r['variant'] == BF16
                    else timing.FP32_OPS_PER_S)
            r['bound_ms'], r['bound_by'] = timing.bound(
                2 * r['x'].numel() * r['x'].element_size(), n_ops, rate)
        else:
            want = fn()
            r.update(plain_ms=None, bound_ms=None, bound_by=None)
        got = r['out']
        bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        same = got.view(bits) == want.view(bits)
        r['equal'] = bool(same.all())
        # equal bits count as 0 (the chains reach inf, and inf - inf is NaN)
        r['max_abs_err'] = float(torch.where(
            same, 0.0, (got.float() - want.float()).abs()).max())
    return rows


def sass_counts(so: str):
    """Per slab kernel, its SASS instructions by opcode (from ``cuobjdump
    -sass`` of the built library), or {} where cuobjdump is missing."""
    tool = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, '-sass', so], capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            cur = next((v for v, n in KERNEL_NAMES.items() if n in m.group(1)),
                       None)
            if cur is not None:
                counts[cur] = collections.Counter()
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)',
                     line)
        if m and cur is not None:
            counts[cur][m.group(1)] += 1
    return counts


def hopper_question(rows):
    """Element-steps per second per variant and the SASS instruction counts
    per kernel: does bf16x2 halve the slab instructions?"""
    lines = []
    for r in rows:
        eps = r['x'].numel() * r['k'] / (r['ms'] * 1e-3)
        lines.append(f"{r['label']:10s} kernel {r['ms']:9.3f} ms  "
                     f"{eps / 1e9:8.1f} Gelem-steps/s  plain {r['plain_ms']:.1f}"
                     f" ms  bound {r['bound_ms']:.3f} ms ({r['bound_by']})  "
                     f"bit-equal={r['equal']}")
    counts = sass_counts(probe_kernels.build())
    for v, c in sorted(counts.items()):
        label = next(k for k, x in VARIANTS.items() if x == v)
        top = ', '.join(f'{op} {n}' for op, n in c.most_common(8))
        lines.append(f'{label:10s} SASS {sum(c.values())} instructions '
                     f'(2 elements per thread): {top}')
    if F32 in counts and BF16 in counts:
        lines.append(f'bf16x2 / f32 SASS instructions: '
                     f'{sum(counts[BF16].values()) / sum(counts[F32].values()):.2f}')
    return lines


def answer(rows) -> str:
    ok = all(r['equal'] for r in rows)
    if rows[0]['ms'] is None:
        return f'bf16_probe: 3 variants, plain only, ok={ok}'
    rate = {r['label']: r['x'].numel() * r['k'] / (r['ms'] * 1e-3) / 1e9
            for r in rows}
    return ('bf16_probe: Gelem-steps/s ' + ', '.join(
        f'{k} {v:.1f}' for k, v in rate.items())
        + f"; bf16x2 / f32 = {rate['bf16'] / rate['f32']:.2f}; bit-equal={ok}")


def summary(rows):
    """The kernel's line for ``chip_smoke.py``: times summed over the three
    variants."""
    big = max(rows, key=lambda r: r['bound_ms'])
    return dict(max_abs_err=max(r['max_abs_err'] for r in rows),
                ms=sum(r['ms'] for r in rows),
                plain_ms=sum(r['plain_ms'] for r in rows),
                bound_ms=sum(r['bound_ms'] for r in rows),
                bound_by=big['bound_by'], library_ms=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--k', type=int, default=None,
                    help=f'steps (default {K} on the card, 3 on the CPU)')
    args = ap.parse_args(argv)
    cpu = args.device == 'cpu'
    if not cpu:
        timing.require_card()
        print('card:', timing.card_line())
    k = args.k if args.k is not None else (3 if cpu else K)
    rows = compare(probe(args.device, k=k, r=1 if cpu else R))
    if not cpu:
        for line in hopper_question(rows):
            print(line)
    print(answer(rows))
    return 0 if all(r['equal'] for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
