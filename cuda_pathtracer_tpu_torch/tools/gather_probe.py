"""Row and element gathers on the card: the Hopper counterpart of six Pallas
probes under the repo's ``tools/`` (which asked which gather formulations
Mosaic lowers and what a row read inside a kernel costs), and the question
they become here: what does a row read cost by row width, index pattern and
where the table lives (L1, the 50 MB L2, HBM)?

    python -m cuda_pathtracer_tpu_torch.tools.gather_probe [--device cpu]

One kernel (``csrc/probe_gather.cu``) with a mode per formulation:

========  ======================================  ==============================
mode      function                                TPU probe (file:line)
========  ======================================  ==============================
ROWS      ``out[b] = tab[idx[b]]``                pallas_gather_probe1.py:16,
                                                  pallas_probe_r2a.py:10 (row
                                                  gather and ``jnp.take``)
TAA0      ``take_along_axis(tab, idx, axis=0)``   pallas_gather_probe2.py:12,27
TAA1      ``take_along_axis(tab, idx, axis=1)``   pallas_gather_probe3.py:12,
                                                  pallas_probe_r2a.py:10
ROWSUM    sum of ``tab[idx[i]]`` in order         pallas_probe_r2a.py:10
                                                  (``fori_loop``, :63-67)
ROWPAIR   ``tab[idx[0, b]] + tab[idx[1, b]]``     pallas_probe_r2f.py:18
                                                  (``t[0:8] + t[N-8:N]``)
CHASE     dependent row reads: column 0 of each   the Hopper form of r2f:18's
          row names the next row                  capacity question
========  ======================================  ==============================

:func:`gather` launches the kernel on CUDA tensors (or raises) and takes the
plain version :func:`gather_ref` for CPU tensors. :func:`probe` runs the TPU
probes' own cases through it, :func:`compare` holds each case to the plain
version (bit for bit) and times it beside ``torch.index_select`` /
``torch.gather`` / ``embedding_bag`` (``library_ms``, which the port never
calls), and :func:`hopper_question` times dependent and independent row
reads by table size.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import kernels
from . import timing

ROWS, TAA0, TAA1, ROWSUM, ROWPAIR, CHASE = range(6)
MODE_NAMES = ('ROWS', 'TAA0', 'TAA1', 'ROWSUM', 'ROWPAIR', 'CHASE')
NAME = 'probe_gather'


def gather_ref(mode: int, tab, idx, steps: int = 0):
    """The plain version: ``tab`` f32 2-D, ``idx`` int32 (shapes as in the
    module's table; ``steps`` is the chain length for CHASE)."""
    kernels.note_plain(NAME, tab)
    i = idx.long()
    if mode == ROWS:
        return tab[i]
    if mode == TAA0:
        return tab[i, torch.arange(tab.shape[1], device=tab.device)]
    if mode == TAA1:
        return tab[torch.arange(tab.shape[0], device=tab.device)[:, None], i]
    if mode == ROWSUM:
        acc = torch.zeros(tab.shape[1], dtype=torch.float32, device=tab.device)
        for k in range(i.shape[0]):
            acc = acc + tab[i[k]]
        return acc[None]
    if mode == ROWPAIR:
        return tab[i[0]] + tab[i[1]]
    if mode == CHASE:
        acc = torch.zeros((i.shape[0], tab.shape[1]), dtype=torch.float32,
                          device=tab.device)
        for _ in range(steps):
            row = tab[i]
            acc = acc + row
            i = row[:, 0].to(torch.int32).long()
        return acc
    raise ValueError(f'{NAME}: unknown mode {mode}')


def out_shape(mode: int, tab, idx):
    if mode in (ROWS, CHASE):
        return (idx.shape[0], tab.shape[1])
    if mode in (TAA0, TAA1):
        return tuple(idx.shape)
    if mode == ROWSUM:
        return (1, tab.shape[1])
    return (idx.shape[1], tab.shape[1])


def _check_shapes(mode, tab, idx):
    ok = tab.dim() == 2
    if mode in (ROWS, ROWSUM, CHASE):
        ok &= idx.dim() == 1
    elif mode == TAA0:
        ok &= idx.dim() == 2 and idx.shape[1] == tab.shape[1]
    elif mode == TAA1:
        ok &= idx.dim() == 2 and idx.shape[0] == tab.shape[0]
    elif mode == ROWPAIR:
        ok &= idx.dim() == 2 and idx.shape[0] == 2
    else:
        raise ValueError(f'{NAME}: unknown mode {mode}')
    if mode == CHASE:
        q = tab.shape[1] // 4
        ok &= tab.shape[1] % 4 == 0 and 0 < q <= 32 and q & (q - 1) == 0
    if not ok:
        raise ValueError(f'{NAME}: {MODE_NAMES[mode]} does not take tab '
                         f'{tuple(tab.shape)} with idx {tuple(idx.shape)}')


def gather(mode: int, tab, idx, steps: int = 0):
    """:func:`gather_ref`'s contract. CPU tensors take the plain version;
    CUDA tensors launch ``csrc/probe_gather.cu`` (or raise). Indices must be
    in range: the kernel does not check them."""
    if tab.device.type == 'cpu':
        return gather_ref(mode, tab, idx, steps)
    kernels.require_cuda(NAME, tab, idx, dtypes=(torch.float32, torch.int32))
    _check_shapes(mode, tab, idx)
    shape = out_shape(mode, tab, idx)
    out = torch.empty(shape, dtype=torch.float32, device=tab.device)
    if mode == ROWSUM:
        steps = idx.shape[0]
    if out.numel():
        err = kernels.library().cpt_probe_gather(
            mode, tab.data_ptr(), idx.data_ptr(), out.data_ptr(), tab.shape[0],
            tab.shape[1], shape[0], shape[1], steps, kernels.stream_of(tab))
        kernels.LAUNCHES[NAME] += 1
        kernels.check(err, NAME)
    return out


def library_call(mode: int, tab, idx):
    """One PyTorch call computing the same function (the yardstick), or None."""
    i = idx.long()
    if mode == ROWS:
        return lambda: torch.index_select(tab, 0, i)
    if mode in (TAA0, TAA1):
        return lambda: torch.gather(tab, 0 if mode == TAA0 else 1, i)
    if mode == ROWSUM:
        return lambda: torch.nn.functional.embedding_bag(i[None], tab,
                                                         mode='sum')
    if mode == ROWPAIR:
        pairs = i.t().contiguous()
        return lambda: torch.nn.functional.embedding_bag(pairs, tab, mode='sum')
    return None


def sites(small: bool = False, seed: int = 0):
    """The TPU probes' cases as numpy inputs from a seed: (site, label,
    mode, tab, idx, steps). ``small`` cuts every size for the CPU tests."""
    rs = np.random.RandomState(seed)
    f32 = np.float32

    def rand(*shape):
        return rs.rand(*shape).astype(f32)

    def ints(n, shape):
        return rs.randint(0, n, size=shape).astype(np.int32)

    s = (lambda big, little: little) if small else (lambda big, little: big)
    out = []
    n, b = s(4096, 64), s(1024, 32)
    out.append(('pallas_gather_probe1.py:16', f'tab[idx] f32[{n},8] B={b}',
                ROWS, rand(n, 8), ints(n, b), 0))
    n, b = s(2048, 48), s(256, 16)
    c = s(128, 16)
    tab = rand(n, c)
    out.append(('pallas_gather_probe2.py:12', f'take_along_axis 0 [{n},{c}] '
                f'idx [{b},{c}]', TAA0, tab, ints(n, (b, c)), 0))
    out.append(('pallas_gather_probe2.py:27', f'take_along_axis 0 [{n},{c}] '
                f'idx [{n},{c}]', TAA0, tab, ints(n, (n, c)), 0))
    for a, n, b in ([(8, 2048, 2048), (8, 16384, 1024), (16, 131072, 1024)]
                    if not small else [(8, 64, 64), (4, 256, 32)]):
        out.append(('pallas_gather_probe3.py:12', f'take_along_axis 1 '
                    f'[{a},{n}] idx [{a},{b}]', TAA1, rand(a, n),
                    ints(n, (a, b)), 0))
    n, b, c = s(16384, 256), s(1024, 32), 128    # r2a's row sum is 128 wide
    tab = rand(n, c)
    idx1 = ints(n, b)
    out.append(('pallas_probe_r2a.py:10', f'row gather / jnp.take [{n},{c}] '
                f'B={b}', ROWS, tab, idx1, 0))
    tab_t = np.ascontiguousarray(tab.T)
    out.append(('pallas_probe_r2a.py:10', f'take_along_axis 1 [{c},{n}]',
                TAA1, tab_t, np.ascontiguousarray(
                    np.broadcast_to(idx1[None, :], (c, b))), 0))
    out.append(('pallas_probe_r2a.py:10', f'take_along_axis 1 [{c},{c}]',
                TAA1, np.ascontiguousarray(tab_t[:, :c]), ints(c, (c, b)), 0))
    out.append(('pallas_probe_r2a.py:10', f'fori_loop row sum B={b}', ROWSUM,
                tab, idx1, 0))
    for mb in ((8, 14, 20, 32, 64, 100) if not small else (1,)):
        n = mb * 1024 * 1024 // 512 if not small else 64
        idx = np.stack([np.arange(8), np.arange(n - 8, n)]).astype(np.int32)
        out.append(('pallas_probe_r2f.py:18', f't[0:8] + t[N-8:N], '
                    f'{n * 512 / 2**20:g} MB', ROWPAIR, rand(n, 128), idx, 0))
    # r2f's question on the card: dependent reads through a 1 MB table
    n = s(2048, 64)
    tab = rand(n, 128)
    perm = rs.permutation(n)
    tab[perm, 0] = np.roll(perm, -1)
    out.append(('pallas_probe_r2f.py:18', f'dependent row reads, 4 chains x '
                f'{s(256, 16)} steps, {n * 512 / 2**20:g} MB', CHASE, tab,
                ints(n, 4), s(256, 16)))
    return out


def _work(mode, tab, idx, out, steps):
    """Bytes and operations the function needs on these inputs: the distinct
    rows (or elements) its indices name, read once; the indices; the output
    written once; one add per output element for the sums."""
    i = idx.long()
    if mode == CHASE:
        nxt = tab[:, 0].to(torch.int64).cpu().numpy()
        cur, seen = i.cpu().numpy(), set()
        for _ in range(steps):
            seen.update(cur.tolist())
            cur = nxt[cur]
        return (len(seen) * tab.shape[1] * 4 + idx.numel() * 4
                + out.numel() * 4, steps * out.numel())
    if mode in (TAA0, TAA1):
        if mode == TAA0:
            flat = i * tab.shape[1] + torch.arange(tab.shape[1],
                                                   device=i.device)
        else:
            flat = torch.arange(tab.shape[0], device=i.device)[:, None] \
                * tab.shape[1] + i
        read = torch.unique(flat).numel() * 4
    else:
        read = torch.unique(i).numel() * tab.shape[1] * 4
    ops = i.numel() * tab.shape[1] if mode in (ROWSUM, ROWPAIR) else 0
    return read + idx.numel() * 4 + out.numel() * 4, ops


def probe(device: str = 'cuda', small: bool = False, seed: int = 0,
          reps: int = 20):
    """The TPU probes' own cases through :func:`gather` (the probe's main
    path): one dict per case with the kernel's output and, on the card, its
    time (CUDA events behind the sleep pre-roll)."""
    rows = []
    for site, label, mode, tab, idx, steps in sites(small, seed):
        t = torch.as_tensor(tab, device=device)
        i = torch.as_tensor(idx, device=device)
        fn = lambda: gather(mode, t, i, steps)  # noqa: E731
        if t.is_cuda:
            ms, out = timing.cuda_ms(fn, reps=reps, warmup=2, preroll=True)
        else:
            ms, out = None, fn()
        rows.append(dict(site=site, label=label, mode=mode, tab=t, idx=i,
                         steps=steps, out=out, ms=ms))
    return rows


def compare(rows, reps: int = 3):
    """Holds each case's kernel output to the plain version bit for bit and,
    on the card, times the plain version and the library call and computes
    the bound. Adds plain_ms, library_ms, bound_ms, bound_by, equal and
    max_abs_err to each row."""
    for r in rows:
        mode, t, i, steps = r['mode'], r['tab'], r['idx'], r['steps']
        fn = lambda: gather_ref(mode, t, i, steps)  # noqa: E731
        lib = library_call(mode, t, i)
        if t.is_cuda:
            r['plain_ms'], want = timing.cuda_ms(fn, reps=reps, warmup=1,
                                                 preroll=True)
            r['library_ms'] = (timing.cuda_ms(lib, reps=reps * 5, warmup=1,
                                              preroll=True)[0] if lib else None)
            r['bound_ms'], r['bound_by'] = timing.bound(*_work(mode, t, i,
                                                               r['out'],
                                                               steps))
        else:
            want = fn()
            r.update(plain_ms=None, library_ms=None, bound_ms=None,
                     bound_by=None)
        got = r['out']
        r['equal'] = bool(torch.equal(got.view(torch.int32),
                                      want.view(torch.int32)))
        r['max_abs_err'] = float((got - want).abs().max()) if got.numel() else 0.0
    return rows


def site_line(r) -> str:
    if r['ms'] is None:
        return (f"{r['site']:28s} {r['label']:44s} bit-equal={r['equal']}")
    lib = f"{r['library_ms']:.4f}" if r['library_ms'] is not None else '-'
    return (f"{r['site']:28s} {r['label']:44s} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f}, library {lib}, bound {r['bound_ms']:.5f} "
            f"({r['bound_by']}), bit-equal={r['equal']}")


def _chase_table(n_rows: int, width: int, pattern: str, device, gen):
    """A table whose column 0 names each row's successor: one random cycle
    through every row, or row + 1."""
    tab = torch.rand((n_rows, width), generator=gen, device=device)
    if pattern == 'random':
        perm = torch.randperm(n_rows, generator=gen, device=device)
        nxt = torch.empty(n_rows, dtype=torch.int64, device=device)
        nxt[perm] = torch.roll(perm, -1)
    else:
        nxt = (torch.arange(n_rows, device=device) + 1) % n_rows
    tab[:, 0] = nxt.to(torch.float32)
    return tab


# table sizes for the question: L1-sized, L2-sized and beyond the 50 MB L2
TABLE_BYTES = (64 << 10, 1 << 20, 16 << 20, 40 << 20, 128 << 20, 512 << 20)
CHASE_STEPS = 16384
GATHER_ROWS = 1 << 20


def hopper_question(device: str = 'cuda', seed: int = 0):
    """ns per dependent row read (one chain of CHASE_STEPS steps, cold after
    an L2 flush and warm right after) and GB/s of 2^20 independent row reads
    (ROWS, beside ``torch.index_select``), by row width (32 B, 512 B), index
    pattern (random, sorted) and table size. Returns printable lines."""
    timing.require_card()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    lines = ['dependent row reads (1 chain) and independent row reads '
             f'({GATHER_ROWS} rows), by table size:',
             f"{'table':>8s} {'row':>5s} {'pattern':>7s} {'cold ns/row':>11s} "
             f"{'warm ns/row':>11s} {'gather GB/s':>11s} {'index_select GB/s':>17s}"]
    for width in (8, 128):
        for size in TABLE_BYTES:
            n = size // (width * 4)
            for pattern in ('random', 'sorted'):
                tab = _chase_table(n, width, pattern, device, gen)
                start = torch.zeros(1, dtype=torch.int32, device=device)
                steps = CHASE_STEPS
                flush.zero_()
                cold, _ = timing.cuda_ms(
                    lambda: gather(CHASE, tab, start, steps), preroll=True)
                warm, _ = timing.cuda_ms(
                    lambda: gather(CHASE, tab, start, steps), reps=3,
                    preroll=True)
                idx = torch.randint(0, n, (GATHER_ROWS,), generator=gen,
                                    device=device, dtype=torch.int32)
                if pattern == 'sorted':
                    idx = torch.sort(idx).values
                moved = GATHER_ROWS * (width * 4 * 2 + 4)
                g_ms, _ = timing.cuda_ms(lambda: gather(ROWS, tab, idx),
                                         reps=5, warmup=1, preroll=True)
                i64 = idx.long()
                l_ms, _ = timing.cuda_ms(lambda: torch.index_select(tab, 0, i64),
                                         reps=5, warmup=1, preroll=True)
                lines.append(
                    f'{size / 2**20:7.3g}M {width * 4:4d}B {pattern:>7s} '
                    f'{cold / steps * 1e6:11.1f} {warm / steps * 1e6:11.1f} '
                    f'{moved / g_ms / 1e6:11.1f} {moved / l_ms / 1e6:17.1f}')
                del tab, idx, i64
    del flush
    return lines


def answer(rows) -> str:
    ok = all(r['equal'] for r in rows)
    if rows[0]['ms'] is None:
        return f'gather_probe: {len(rows)} TPU probe cases, plain only, ok={ok}'
    k = sum(r['ms'] for r in rows)
    lib = sum(r['library_ms'] for r in rows if r['library_ms'] is not None)
    klib = sum(r['ms'] for r in rows if r['library_ms'] is not None)
    return (f'gather_probe: {len(rows)} TPU probe cases (6 sites) bit-equal='
            f'{ok}; kernel {k:.3f} ms in all, the library calls {lib:.3f} ms '
            f'where the kernel takes {klib:.3f} ms')


def summary(rows):
    """The kernel's line for ``chip_smoke.py``: times summed over the
    cases; the library calls' over the cases that have one (all but the
    dependent reads)."""
    big = max(rows, key=lambda r: r['bound_ms'])
    return dict(max_abs_err=max(r['max_abs_err'] for r in rows),
                ms=sum(r['ms'] for r in rows),
                plain_ms=sum(r['plain_ms'] for r in rows),
                bound_ms=sum(r['bound_ms'] for r in rows),
                bound_by=big['bound_by'],
                library_ms=sum(r['library_ms'] for r in rows
                               if r['library_ms'] is not None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    if args.device != 'cpu':
        timing.require_card()
        print('card:', timing.card_line())
    rows = compare(probe(args.device, small=args.device == 'cpu',
                         seed=args.seed))
    for r in rows:
        print(site_line(r))
    print(answer(rows))
    if args.device != 'cpu':
        for line in hopper_question(args.device, args.seed):
            print(line)
    return 0 if all(r['equal'] for r in rows) else 1


if __name__ == '__main__':
    sys.exit(main())
