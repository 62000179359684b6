"""Time versions of the traversal kernels against each other, in turns, on
the main path's own waves.

    python -m cuda_pathtracer_tpu_torch.utils.traverse_ab \\
        --csrc before=DIR --csrc after=cuda_pathtracer_tpu_torch/csrc

Each ``--csrc NAME=DIR`` names a directory of kernel sources with this
package's C entry points (an earlier commit's ``csrc/``, or this one's); each
builds into its own library. The waves are those ``chip_smoke.py`` holds the
kernels to: the primary, shadow, bounce-1 and first level-1 tail waves of
the first band of sibenik's first converge sample at 1920x1080, in the
engine's default schedule. On each wave both traversals (v2 on the merged
table, v1 on the split tables, any-hit waves walked cheap) run through the
package's wrappers with each library in turn, in the order of the ``--csrc``
arguments and then back (A, B, B, A for two), ``--rounds`` times; each
timing is the mean of ``--reps`` launches between two CUDA events, after a
warm-up, with a sleep kernel ahead of them so the host queues every launch
before the first one runs (device time, not the wrappers' host time). Every
version's outputs must equal the plain version's bit for bit.
A last pass times each version on the same waves with no ray live (the
launch floor). Prints one line per wave, kernel and version, and writes the
numbers to ``chiprun_out/traverse_ab.json``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import torch

from ..constants import MAX_RAY_DEPTH
from ..core.camera import Camera
from ..models import pathtracer as ptm
from ..ops import dispatch, kernels
from ..ops import traverse_packet as tp1
from ..ops import traverse_packet2 as tp2
from ..scene.builder import get_scene
from .frame_profile import ScheduleTap

WIDTH, HEIGHT = 1920, 1080
WAVES = ('primary', 'shadow', 'bounce-1', 'tail-1')
PREROLL_CYCLES = 20_000_000   # ~10 ms of sleep at the H100's clock


def capture_waves(pt, cam) -> dict:
    """Clones of the arguments of the v2 calls that make the four waves: the
    first band of the first converge sample after a clear frame."""
    levels = ptm.tail_levels(pt.width * pt.band_h, MAX_RAY_DEPTH)
    pt.render(cam, should_clear=True)
    saved, calls = {}, []
    orig = dispatch.traverse_merged

    def record(table, ro, rd, t0, live, stop, want_uv=False):
        if len(tap.bands) == 1:
            calls.append(ro.shape[0])
            name = (WAVES[len(calls) - 1] if len(calls) <= 3 else
                    'tail-1' if ro.shape[0] == levels[0][2] else None)
            if name and name not in saved:
                saved[name] = (table, ro.clone(), rd.clone(), t0.clone(),
                               live.clone(), stop.clone(), want_uv)
        return orig(table, ro, rd, t0, live, stop, want_uv)

    dispatch.traverse_merged = record
    try:
        with ScheduleTap() as tap:
            pt.render(cam)
    finally:
        dispatch.traverse_merged = orig
    torch.cuda.synchronize()
    return saved


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call of fn: a sleep kernel first keeps the card busy
    while the host queues the calls, so host time per call is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda._sleep(PREROLL_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_bits(got, want) -> bool:
    for a, b in zip(got, want):
        if a is None:
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            return False
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--csrc', action='append', required=True,
                   help='NAME=DIR of kernel sources (repeat)')
    p.add_argument('--reps', type=int, default=20)
    p.add_argument('--rounds', type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('traverse_ab: needs a CUDA device', file=sys.stderr)
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f'card: {card}', flush=True)
    libs = {}
    for spec in args.csrc:
        name, src = spec.split('=', 1)
        so = kernels.build(os.path.abspath(src), os.path.join(
            kernels.BUILD_DIR, f'ab_{name}'))
        libs[name] = kernels.load(so)
        with open(so[:-3] + '.log') as f:
            for line in f:
                if 'registers' in line or 'bytes stack' in line:
                    print(f'  {name} ptxas: {line.strip()}')

    pt = ptm.Pathtracer(get_scene('sibenik'), WIDTH, HEIGHT, device='cuda')
    cam = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)
    waves = capture_waves(pt, cam)
    tables = tp1.PacketTables(pt.dyn.packet_inner, pt.dyn.packet_leaf,
                              pt.dyn.depth)
    order = list(libs)
    order = (order + order[::-1]) * args.rounds
    times = defaultdict(list)
    floor = {}
    ok = True
    for wave in WAVES:
        table, ro, rd, t0, live, stop, want_uv = waves[wave]
        any_hit = bool(stop.all())
        calls = {
            'traverse': (lambda lv: tp2.traverse_merged(
                table, ro, rd, t0, lv, stop, want_uv),
                tp2.traverse_merged_ref(table, ro, rd, t0, live, stop,
                                        want_uv)),
            'traverse_packet': (lambda lv: tp1.traverse_split(
                tables, ro, rd, t0, lv, stop, any_hit),
                tp1.traverse_packet_ref(tables, ro, rd, t0, live, stop,
                                        any_hit)),
        }
        dead = torch.zeros_like(live)
        for kname, (call, want) in calls.items():
            for name in order:
                kernels._lib = libs[name]
                if not same_bits(call(live), want):
                    ok = False
                    print(f'FAIL: {kname} {wave} {name} differs from plain')
                times[(kname, wave, name)].append(
                    cuda_ms(lambda: call(live), args.reps))
            for name in libs:
                kernels._lib = libs[name]
                floor[(kname, wave, name)] = cuda_ms(lambda: call(dead),
                                                     args.reps)
            for name in libs:
                ts = times[(kname, wave, name)]
                print(f'{kname:15s} {wave:8s} {name:10s} {int(live.sum()):7d} '
                      f'live of {ro.shape[0]:7d}: '
                      + ' '.join(f'{t:.4f}' for t in ts)
                      + f' ms (mean {sum(ts) / len(ts):.4f}); no ray live '
                      f'{floor[(kname, wave, name)]:.4f} ms', flush=True)
    kernels._lib = None
    out = dict(card=card, versions={s.split('=', 1)[0]: s.split('=', 1)[1]
                                    for s in args.csrc},
               order=order, reps=args.reps,
               ms={'/'.join(k): v for k, v in times.items()},
               floor_ms={'/'.join(k): v for k, v in floor.items()})
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'traverse_ab.json'), 'w') as f:
        json.dump(out, f, indent=1)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
