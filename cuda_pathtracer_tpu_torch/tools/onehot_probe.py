"""Per-lane dependent row fetches from a small table, by a one-hot product on
the tensor cores or by a load: the Hopper counterpart of the repo's
``tools/pallas_probe_onehot.py:63``, ``pallas_probe_onehot2.py:74`` and
``pallas_probe_onehot3.py:68``, which asked whether a per-lane row gather
through the TPU's matrix unit (``onehot(cur) @ tab``) could drive a per-lane
walk. Here: ns per lane-step by table rows N and by chains in flight (P, or
W lane groups, which on Hopper are the same thing), for (a) ``mma.sync`` over
a one-hot A fragment and (b) a direct load, and whether (a) is exact.

    python -m cuda_pathtracer_tpu_torch.tools.onehot_probe [--device cpu]

Each lane runs T = 64 steps: ``row = tab[cur]``, ``acc += row[1]``,
``cur = (int(row[0]) * 7 + step + 1) % N``, on a table whose column 0 echoes
the row index and column 1 holds integers up to 2^24, in f32 or rounded to
bf16. :func:`fetch` launches ``csrc/probe_onehot.cu`` on CUDA tensors (or
raises) and takes the plain version :func:`fetch_ref` for CPU tensors; both
kernel paths give the plain version's bits.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import kernels
from . import timing

NAME = 'probe_onehot'
PATHS = {'mma': 0, 'ldg': 1}
T = 64
LANES = 128


def split3(tab):
    """An f32 table as three bf16 pieces, hi + mid + lo, whose sum in f32
    ((hi + mid) + lo) is the table exactly (raises where it is not)."""
    hi = tab.to(torch.bfloat16)
    r = tab - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    back = (hi.float() + mid.float()) + lo.float()
    if not torch.equal(back, tab):
        raise ValueError(f'{NAME}: the table does not split into three bf16 '
                         'pieces exactly')
    return hi, mid, lo


def fragments(piece):
    """A bf16 [N, 128] piece in m16n8k16 B-fragment order: [16 strips of 8
    columns, N / 16 k-tiles, 32 lanes, 4]; lane g * 4 + t holds rows 2t,
    2t + 1, 2t + 8, 2t + 9 of the k-tile at column g of the strip."""
    n = piece.shape[0]
    x = piece.reshape(n // 16, 2, 4, 2, 16, 8)      # kt, h, t, j, strip, g
    return x.permute(4, 0, 5, 2, 1, 3).reshape(16, n // 16, 32, 4).contiguous()


class Table:
    """A probe table, prepared once for both kernel paths: ``rows`` is the
    [N, 128] table the load path reads (f32, or rounded to bf16), ``frag``
    the mma path's bf16 pieces in fragment order (one piece for bf16, three
    for f32)."""

    def __init__(self, tab, bf16: bool):
        if tab.dim() != 2 or tab.shape[1] != LANES or tab.shape[0] % 16:
            raise ValueError(f'{NAME}: the table must be [16 k, 128]')
        self.src, self.bf16 = tab, bf16
        self.n = tab.shape[0]
        self.rows = tab.to(torch.bfloat16) if bf16 else tab.contiguous()
        pieces = (tab.to(torch.bfloat16),) if bf16 else split3(tab)
        self.frag = torch.stack([fragments(p) for p in pieces])


def fetch_ref(table: Table, starts, steps: int = T):
    """The plain version: ``starts`` int32 [cells, chains, 128]; returns the
    final indices (int32) and the sums of column 1 (f32), both shaped like
    ``starts``."""
    tab = table.src
    kernels.note_plain(NAME, tab)
    tc = tab.to(torch.bfloat16).float() if table.bf16 else tab
    c0, c1 = tc[:, 0].contiguous(), tc[:, 1].contiguous()
    cur = starts.long()
    acc = torch.zeros(starts.shape, dtype=torch.float32, device=tab.device)
    for s in range(steps):
        acc = acc + c1[cur]
        cur = (c0[cur].to(torch.int32).long() * 7 + s + 1) % table.n
    return cur.to(torch.int32), acc


def fetch(path: str, table: Table, starts, steps: int = T):
    """:func:`fetch_ref`'s contract by the path 'mma' or 'ldg'. CPU tensors
    take the plain version; CUDA tensors launch ``csrc/probe_onehot.cu`` (or
    raise)."""
    if starts.device.type == 'cpu':
        return fetch_ref(table, starts, steps)
    kernels.require_cuda(NAME, starts, table.src,
                         dtypes=(torch.int32, torch.float32))
    cells, chains, lanes = starts.shape
    if lanes != LANES or chains not in (1, 2, 4, 8) or path not in PATHS:
        raise ValueError(f'{NAME}: starts {tuple(starts.shape)}, path {path}')
    tab = table.frag if path == 'mma' else table.rows
    cur = torch.empty_like(starts)
    acc = torch.empty(starts.shape, dtype=torch.float32, device=starts.device)
    err = kernels.library().cpt_probe_onehot(
        PATHS[path], int(table.bf16), tab.data_ptr(), starts.data_ptr(),
        cur.data_ptr(), acc.data_ptr(), table.n, cells, chains, steps,
        kernels.stream_of(starts))
    kernels.LAUNCHES[NAME] += 1
    kernels.check(err, NAME)
    return cur, acc


def make_table(n_rows: int, seed: int = 0):
    """The probes' table (``bench``): column 0 the row index, column 1
    integers below 2^24, the rest uniform in [0, 100)."""
    rng = np.random.default_rng(seed)
    tab = np.zeros((n_rows, LANES), np.float32)
    tab[:, 0] = np.arange(n_rows)
    tab[:, 1] = rng.integers(0, 1 << 24, n_rows)
    tab[:, 2:] = rng.random((n_rows, LANES - 2)) * 100
    return tab, rng


def case_inputs(site: str, n_rows: int, cells: int, chains: int,
                seed: int = 0):
    """A case's table and the probe's index block (``cells`` x 8 rows of
    128, or ``cells`` x W for onehot3), as numpy arrays."""
    tab, rng = make_table(n_rows, seed)
    rows = cells * (chains if site.startswith('pallas_probe_onehot3') else 8)
    return tab, rng.integers(0, n_rows, (rows, LANES)).astype(np.int32)


def starts_of(site: str, idx, cells: int, chains: int):
    """The probe's index block as [cells, chains, 128] chain starts: row 0
    of each 8-row cell (onehot), rows 0..P-1 of it (onehot2), or the cell's
    W rows (onehot3)."""
    if site.startswith('pallas_probe_onehot3'):
        return idx.reshape(cells, chains, LANES)
    return idx.reshape(cells, 8, LANES)[:, :chains].contiguous()


def tpu_layout(site: str, cur, acc):
    """The probe's output block from the final indices and sums: per cell,
    8 rows (onehot: cur, acc, zeros), 16 (onehot2: P rows of cur from row 0,
    P of acc from row 8) or 2 W rounded up to 8 (onehot3: W of cur, W of
    acc; the probe leaves the rest unwritten, here zeros)."""
    cells, chains, _ = cur.shape
    if site.startswith('pallas_probe_onehot3'):
        rows, acc_at = -(-2 * chains // 8) * 8, chains
    elif site.startswith('pallas_probe_onehot2'):
        rows, acc_at = 16, 8
    else:
        rows, acc_at = 8, 1
    out = torch.zeros((cells, rows, LANES), dtype=torch.float32,
                      device=cur.device)
    out[:, :chains] = cur.float()
    out[:, acc_at:acc_at + chains] = acc
    return out.reshape(cells * rows, LANES)


def cases(small: bool = False):
    """The probes' own sweeps: (site, N, bf16, cells, chains)."""
    if small:
        return [('pallas_probe_onehot.py:63', 64, True, 2, 1),
                ('pallas_probe_onehot.py:63', 64, False, 2, 1),
                ('pallas_probe_onehot2.py:74', 32, True, 2, 4),
                ('pallas_probe_onehot3.py:68', 48, True, 2, 2)]
    out = [('pallas_probe_onehot.py:63', n, True, 64, 1)
           for n in (512, 1024, 2048, 4096, 8192)]
    out += [('pallas_probe_onehot.py:63', n, False, 64, 1) for n in (1024, 4096)]
    out += [('pallas_probe_onehot2.py:74', n, True, 16, p)
            for n in (1024, 4096) for p in (1, 2, 4, 8)]
    out += [('pallas_probe_onehot3.py:68', n, True, 16, w)
            for n in (1024, 4096, 8192) for w in (1, 2, 4, 8)]
    return out


def probe(device: str = 'cuda', small: bool = False, seed: int = 0,
          steps: int = T, reps: int = 3):
    """The probes' sweeps through :func:`fetch`, both paths on the card (the
    main path): one dict per case with the outputs and the kernel times."""
    rows = []
    for site, n, bf16, cells, chains in cases(small):
        tab_np, idx_np = case_inputs(site, n, cells, chains, seed)
        idx = torch.as_tensor(idx_np, device=device)
        table = Table(torch.as_tensor(tab_np, device=device), bf16)
        starts = starts_of(site, idx, cells, chains)
        row = dict(site=site, n=n, bf16=bf16, cells=cells, chains=chains,
                   steps=steps, table=table, starts=starts, idx=idx,
                   tab_np=tab_np)
        for path in PATHS:
            fn = lambda: fetch(path, table, starts, steps)  # noqa: E731
            if starts.is_cuda:
                row[f'{path}_ms'], row[path] = timing.cuda_ms(
                    fn, reps=reps, warmup=1, preroll=True)
            else:
                row[f'{path}_ms'], row[path] = None, fn()
        rows.append(row)
    return rows


def compare(rows):
    """Both paths against the plain version, bit for bit; on the card the
    plain version's time, the function's bound (the table once, the starts
    and the outputs; 4 operations per lane-step) and the mma path's share
    of the tensor cores' dense bf16 rate for its one-hot products."""
    for r in rows:
        fn = lambda: fetch_ref(r['table'], r['starts'], r['steps'])  # noqa: E731
        lane_steps = r['starts'].numel() * r['steps']
        if r['starts'].is_cuda:
            r['plain_ms'], (cur, acc) = timing.cuda_ms(fn)
            tab_bytes = r['n'] * LANES * (2 if r['bf16'] else 4)
            r['bound_ms'], r['bound_by'] = timing.bound(
                tab_bytes + 12 * r['starts'].numel(), 4 * lane_steps)
            pieces = 1 if r['bf16'] else 3
            r['mma_tensor_ms'] = (2 * r['n'] * LANES * lane_steps * pieces
                                  / timing.TENSOR_BF16_OPS_PER_S * 1e3)
        else:
            cur, acc = fn()
            r.update(plain_ms=None, bound_ms=None, bound_by=None,
                     mma_tensor_ms=None)
        for path in PATHS:
            kc, ka = r[path]
            r[f'{path}_equal'] = bool(torch.equal(kc, cur) and torch.equal(
                ka.view(torch.int32), acc.view(torch.int32)))
        r['equal'] = r['mma_equal'] and r['ldg_equal']
        r['max_abs_err'] = max(float((r[p][1] - acc).abs().max())
                               for p in PATHS)
    return rows


def hopper_question(rows):
    lines = [f"{'site':28s} {'N':>5s} {'table':>5s} {'P/W':>3s} "
             f"{'mma ns/lane-step':>16s} {'ldg ns/lane-step':>16s} "
             f"{'mma tensor share':>16s} exact"]
    for r in rows:
        ls = r['starts'].numel() * r['steps']
        lines.append(
            f"{r['site']:28s} {r['n']:5d} {'bf16' if r['bf16'] else 'f32':>5s} "
            f"{r['chains']:3d} {r['mma_ms'] * 1e6 / ls:16.3f} "
            f"{r['ldg_ms'] * 1e6 / ls:16.4f} "
            f"{r['mma_tensor_ms'] / r['mma_ms']:16.3f} "
            f"{r['mma_equal']}/{r['ldg_equal']}")
    return lines


def answer(rows) -> str:
    ok = all(r['equal'] for r in rows)
    if rows[0]['mma_ms'] is None:
        return f'onehot_probe: {len(rows)} cases, plain only, ok={ok}'
    best = min(rows, key=lambda r: r['mma_ms'] / r['ldg_ms'])
    ls = lambda r: r['starts'].numel() * r['steps']  # noqa: E731
    return (f"onehot_probe: mma / ldg time {min(r['mma_ms'] / r['ldg_ms'] for r in rows):.1f}"
            f"-{max(r['mma_ms'] / r['ldg_ms'] for r in rows):.1f}x (best at N="
            f"{best['n']}, P/W={best['chains']}: mma "
            f"{best['mma_ms'] * 1e6 / ls(best):.3f} vs ldg "
            f"{best['ldg_ms'] * 1e6 / ls(best):.4f} ns/lane-step); exact "
            f"(both paths bit-equal to plain) {ok}")


def summary(rows):
    """The kernel's line for ``chip_smoke.py``: the mma path's times (the TPU
    probes' formulation) summed over the probes' cases."""
    big = max(rows, key=lambda r: r['bound_ms'])
    return dict(max_abs_err=max(r['max_abs_err'] for r in rows),
                ms=sum(r['mma_ms'] for r in rows),
                plain_ms=sum(r['plain_ms'] for r in rows),
                bound_ms=sum(r['bound_ms'] for r in rows),
                bound_by=big['bound_by'], library_ms=None)


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
