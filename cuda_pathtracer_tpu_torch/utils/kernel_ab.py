"""Time versions of the port's render kernels against each other, in turns,
on the main path's own inputs.

    python -m cuda_pathtracer_tpu_torch.utils.kernel_ab \\
        --tree before=_scratch/parent --tree after=. [--kernel blur ...]

Each ``--tree NAME=DIR`` names a checkout of this repository (an earlier
commit unpacked with ``git archive``, or this one). Its package is loaded
under an alias of its own and builds its own kernel library into its own
``_build/``, so each version runs through its own wrappers, whatever its C
interface. The inputs come from this package's engine on sibenik at
1920x1080, after a clear frame:

- ``traverse``, ``traverse_packet``: the primary, shadow, bounce-1 and first
  level-1 tail waves of the first band of the first converge sample, in the
  engine's default schedule (v2 on the merged table, v1 on the split tables,
  any-hit waves walked cheap), and the same waves with no ray live (the
  launch floor);
- ``guiding_scatter``: the updates of that band's scatter, and as many
  updates half kept on random bins and all on one bin (full contention);
- ``blur``: the accumulators in pixel order after the sample.

It also prints the guiding scatter's traffic in the first ``--samples``
converge samples: per call, the kept updates and the ``float2`` atomics the
kernel's warp aggregation leaves for them.

Every version must agree with this package's plain versions: the traversals
and the blur bit for bit, the scatter at rtol 1e-5 / atol 1e-5 (atomics add
in another order). Versions run in the order of the ``--tree`` arguments and
then back (A, B, B, A for two), ``--rounds`` times; each time is the mean
device ms of ``--reps`` wrapper calls behind a sleep pre-roll (device time,
not the wrappers' host time), so a version's time covers every launch its
wrapper makes. Prints one line per kernel, case and version, and writes the
numbers to ``chiprun_out/kernel_ab.json``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from collections import defaultdict
from types import SimpleNamespace

import torch

from ..constants import MAX_RAY_DEPTH
from ..core.camera import Camera
from ..models import guiding
from ..models import pathtracer as ptm
from ..ops import blur, dispatch, guiding_scatter
from ..ops import traverse_packet as tp1
from ..ops import traverse_packet2 as tp2
from ..scene.builder import get_scene
from ..tools.timing import card_line, cuda_ms
from .frame_profile import ScheduleTap

WIDTH, HEIGHT = 1920, 1080
WAVES = ('primary', 'shadow', 'bounce-1', 'tail-1')
KERNELS = ('traverse', 'traverse_packet', 'guiding_scatter', 'blur')


def load_tree(name: str, root: str) -> SimpleNamespace:
    """The wrapper modules of the package in checkout ``root``, imported
    under the alias package ``_ab_<name>``."""
    alias = f'_ab_{name}'
    pkg = os.path.join(os.path.abspath(root), 'cuda_pathtracer_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    ops = {m: importlib.import_module(f'{alias}.ops.{m}') for m in
           ('kernels', 'traverse_packet', 'traverse_packet2',
            'guiding_scatter', 'blur')}
    return SimpleNamespace(**ops)


def scatter_traffic(seg, n_bins: int) -> tuple[int, int]:
    """(kept, atomics) of one scatter call: its kept updates, and the
    ``float2`` atomics ``csrc/guiding_scatter.cu`` issues for them, one per
    distinct id among the 32 lanes of a warp on each of a thread's four id
    slots (threads on consecutive 16-byte lines of ids)."""
    pad = (-seg.shape[0]) % 128
    s = torch.cat([seg, seg.new_full((pad,), -1)]).view(-1, 32, 4)
    s = torch.where((s >= 0) & (s < n_bins), s, -1).transpose(1, 2)
    s = s.sort(dim=2).values
    kept = s >= 0
    first = kept.clone()
    first[..., 1:] &= s[..., 1:] != s[..., :-1]
    return int(kept.sum()), int(first.sum())


def capture(samples: int):
    """(waves, v1 tables, scatter args, blur args, traffic) from sibenik:
    a clear frame, then ``samples`` converge samples; the waves and the
    scatter's arguments from the first band of the first."""
    pt = ptm.Pathtracer(get_scene('sibenik'), WIDTH, HEIGHT, device='cuda')
    cam = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0,
                        device='cuda')
    levels = ptm.tail_levels(pt.width * pt.band_h, MAX_RAY_DEPTH)
    pt.render(cam, should_clear=True)     # clear frames train no guiding
    waves, calls, saved, traffic = {}, [], [], []
    orig_t, orig_s = dispatch.traverse_merged, guiding.segment_sum_pairs

    def record_wave(table, ro, rd, t0, live, stop, want_uv=False, **merge):
        if len(tap.bands) == 1:
            calls.append(ro.shape[0])
            name = (WAVES[len(calls) - 1] if len(calls) <= 3 else
                    'tail-1' if ro.shape[0] == levels[0][2] else None)
            if name and name not in waves:
                waves[name] = (table, ro.clone(), rd.clone(), t0.clone(),
                               live.clone(), stop.clone(), want_uv)
        return orig_t(table, ro, rd, t0, live, stop, want_uv, **merge)

    def record_scatter(e, w, seg, n_bins):
        if not saved:
            saved.append((e.clone(), w.clone(), seg.clone(), n_bins))
        traffic.append((pt.sample_idx, *scatter_traffic(seg, n_bins)))
        return orig_s(e, w, seg, n_bins)

    dispatch.traverse_merged = record_wave
    guiding.segment_sum_pairs = record_scatter
    try:
        with ScheduleTap() as tap:
            for _ in range(samples):
                pt.render(cam)
    finally:
        dispatch.traverse_merged = orig_t
        guiding.segment_sum_pairs = orig_s
    tables = tp1.PacketTables(pt.dyn.packet_inner, pt.dyn.packet_leaf,
                              pt.dyn.depth)
    lum, alb = pt.accumulators_pixel_order()
    torch.cuda.synchronize()
    return (waves, tables, saved[0],
            (lum, alb, float(pt.sample_idx), WIDTH, HEIGHT), traffic)


def same_bits(got, want) -> bool:
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        if a is None:
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            return False
    return True


def scatter_close(got, want) -> bool:
    return all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
               for a, b in zip(got, want))


def cases(kinds, waves, tables, scat, blur_args):
    """(kernel, case, call(tree), check(out) or None) for the chosen
    kernels; ``check`` holds an output against this package's plain
    version."""
    out = []
    for wave in WAVES if {'traverse', 'traverse_packet'} & set(kinds) else ():
        table, ro, rd, t0, live, stop, want_uv = waves[wave]
        any_hit = bool(stop.all())
        dead = torch.zeros_like(live)
        if 'traverse' in kinds:
            want = tp2.traverse_merged_ref(table, ro, rd, t0, live, stop,
                                           want_uv)
            for lv, tag in ((live, ''), (dead, ', no ray live')):
                out.append(('traverse', f'{wave} ({int(lv.sum())} live of '
                            f'{ro.shape[0]}){tag}',
                            lambda m, lv=lv, a=(table, ro, rd, t0, stop,
                                                want_uv):
                            m.traverse_packet2.traverse_merged(
                                *a[:4], lv, *a[4:]),
                            (lambda g, want=want: same_bits(g, want))
                            if lv is live else None))
        if 'traverse_packet' in kinds:
            want = tp1.traverse_packet_ref(tables, ro, rd, t0, live, stop,
                                           any_hit)
            for lv, tag in ((live, ''), (dead, ', no ray live')):
                out.append(('traverse_packet', f'{wave} ({int(lv.sum())} '
                            f'live of {ro.shape[0]}){tag}',
                            lambda m, lv=lv, a=(ro, rd, t0, stop, any_hit):
                            m.traverse_packet.traverse_split(
                                tables, *a[:3], lv, *a[3:]),
                            (lambda g, want=want: same_bits(g, want))
                            if lv is live else None))
    if 'guiding_scatter' in kinds:
        e, w, seg, n_bins = scat
        g = torch.Generator(device='cuda').manual_seed(3)
        half = torch.where(
            torch.rand(seg.shape, device='cuda', generator=g) < 0.5,
            torch.randint(0, n_bins, seg.shape, device='cuda', generator=g,
                          dtype=torch.int32), n_bins)
        for label, s in (('band', seg), ('half kept', half),
                         ('one bin', torch.full_like(seg, n_bins // 2))):
            args = (e, w, s, n_bins)
            want = guiding_scatter.segment_sum_pairs_ref(*args)
            out.append(('guiding_scatter',
                        f'{label} ({int((s < n_bins).sum())} kept of '
                        f'{s.shape[0]}, {n_bins} bins)',
                        lambda m, a=args: m.guiding_scatter.segment_sum_pairs(
                            *a),
                        lambda got, want=want: scatter_close(got, want)))
    if 'blur' in kinds:
        want = blur.blur_luminance_ref(*blur_args)
        out.append(('blur', f'{WIDTH}x{HEIGHT}, n={blur_args[2]}',
                    lambda m: m.blur.blur_luminance(*blur_args),
                    lambda got: same_bits(got, want)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--tree', action='append', required=True,
                   help='NAME=DIR of a checkout of the repository (repeat)')
    p.add_argument('--kernel', action='append', choices=KERNELS,
                   help='a kernel to time (repeat; default all)')
    p.add_argument('--samples', type=int, default=4,
                   help='converge samples whose scatter traffic is counted')
    p.add_argument('--reps', type=int, default=20)
    p.add_argument('--rounds', type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('kernel_ab: needs a CUDA device', file=sys.stderr)
        return 1
    card = card_line()
    print(f'card: {card}', flush=True)
    trees = dict(spec.split('=', 1) for spec in args.tree)
    mods = {name: load_tree(name, root) for name, root in trees.items()}
    for name, m in mods.items():
        m.kernels.library()
        with open(m.kernels.library_path()[:-3] + '.log') as f:
            for line in f:
                if 'registers' in line or 'bytes stack' in line:
                    print(f'  {name} ptxas: {line.strip()}')

    waves, tables, scat, blur_args, traffic = capture(args.samples)
    kept = sum(k for _, k, _ in traffic)
    atomics = sum(a for _, _, a in traffic)
    print(f'guiding_scatter traffic over {args.samples} converge samples, '
          f'{len(traffic)} calls of {scat[2].shape[0]} updates: kept '
          f'{kept} ({kept / (len(traffic) * scat[2].shape[0]):.5f}), float2 '
          f'atomics {atomics} ({atomics / max(kept, 1):.4f} per kept update); '
          f'per call (sample, kept, atomics): {traffic}', flush=True)

    order = list(mods)
    order = (order + order[::-1]) * args.rounds
    times = defaultdict(list)
    ok = True
    for kname, label, call, check in cases(args.kernel or KERNELS, waves,
                                           tables, scat, blur_args):
        for name in order:
            m = mods[name]
            if check is not None and not check(call(m)):
                ok = False
                print(f'FAIL: {kname} {label} {name} disagrees with the plain '
                      f'version')
            ms, _ = cuda_ms(lambda: call(m), reps=args.reps, warmup=2,
                            preroll=True)
            times[(kname, label, name)].append(ms)
        for name in mods:
            ts = times[(kname, label, name)]
            print(f'{kname:15s} {label:40s} {name:8s} '
                  + ' '.join(f'{t:.4f}' for t in ts)
                  + f' ms (mean {sum(ts) / len(ts):.4f})', flush=True)
    res = dict(card=card, trees=trees, order=order, reps=args.reps,
               traffic=traffic,
               ms={'/'.join(k): v for k, v in times.items()})
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'kernel_ab.json'), 'w') as f:
        json.dump(res, f, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
