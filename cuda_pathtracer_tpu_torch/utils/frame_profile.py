"""Where one frame's time goes on the card, per band and tail level.

    python -m cuda_pathtracer_tpu_torch.utils.frame_profile [--v1] [--one-band]

Profiles, with ``torch.profiler``, one clearing frame of the CLI's animated
path (the ``outside`` scene at 1920x1080, ``Scene.update`` at t = 5 so the
frame refits the moved cubes, 5 samples of at most 5 bounces, NEE, and the
blurred display image of ``--blur``) and one
converge sample of the sibenik path (1920x1080, 32 bounces). ``--v1``
traces with the split-table kernel; ``--one-band`` renders each frame as one
band (the lane cap raised to the frame) instead of the engine's default
bands.

Each frame runs four times: a warm-up, an unprofiled run (its wall time
around synchronized work), a profiled run with no synchronization beyond the
engine's own, and a marked run, each of the same work (the sibenik runs
each render the first converge sample from the state the clear frame left).
From the profiled run
it prints the wall time, the device-busy time (the union of the CUDA kernel
intervals), the device's idle share against the profiled and the unprofiled
wall, the kernel launches and the kernels that took the most device time.
It also prints the device time of each of the port's own kernels (``csrc/``)
by name, and of all traversal launches together. The marked run
synchronizes around each band and tail level, so that each
part's kernels finish inside it, and counts the live lanes of every bounce
(one more sync per bounce); from it one line per band and part of the
schedule (the full-width bounces before the tail, each tail level): bounces
run, rounds, the lane width of the bounces, the live lanes per bounce, the
CUDA kernels, wall and busy time and the idle share. Its syncs lengthen the
parts' walls, so compare its idle shares with each other only. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..core.camera import Camera
from ..models import pathtracer as ptm
from ..ops import dispatch, kernels
from ..scene.builder import get_scene

WIDTH, HEIGHT = 1920, 1080
MAIN = 0   # the part key of the full-width bounces before the tail
# the __global__ functions of csrc/ on the render path, as the profiler
# names them
PORT_KERNELS = ('traverse_kernel', 'traverse_packet_kernel',
                'guiding_scatter_kernel', 'blur_kernel')


class ScheduleTap:
    """While active, records the engine's schedule: one entry per
    render_sample call (a band of one dispatch) with its band index, the
    rounds of each tail level and, per part (``MAIN`` or a level's start
    bounce), the lane width of each bounce. ``mark=True`` also counts the
    live lanes of each bounce (one more sync per bounce), synchronizes
    around each band and level and labels them for the profiler as
    ``cpt/<call>/<part>``."""

    def __init__(self, mark: bool = False):
        self.mark = mark
        self.bands = []
        self._part = MAIN

    @contextlib.contextmanager
    def _span(self, label: str):
        if not self.mark:
            yield
            return
        torch.cuda.synchronize()
        with record_function(label):
            yield
            torch.cuda.synchronize()

    def __enter__(self):
        tap = self
        self._orig = {n: getattr(ptm, n) for n in
                      ('render_sample', '_tail_level', '_tail_round',
                       '_bounce_body')}
        orig = self._orig

        def render_sample(*args, **kw):
            tap.bands.append(dict(band=kw.get('row_offset', 0) // kw['height'],
                                  rounds={}, widths=defaultdict(list),
                                  lives=defaultdict(list)))
            tap._part = MAIN
            with tap._span(f'cpt/{len(tap.bands) - 1}/band'):
                return orig['render_sample'](*args, **kw)

        def tail_level(*args, **kw):
            tap._part = args[5]
            try:
                with tap._span(f'cpt/{len(tap.bands) - 1}/{args[5]}'):
                    return orig['_tail_level'](*args, **kw)
            finally:
                tap._part = MAIN

        def tail_round(*args, **kw):
            r = tap.bands[-1]['rounds']
            r[args[5]] = r.get(args[5], 0) + 1
            return orig['_tail_round'](*args, **kw)

        def bounce_body(scene, dyn, radiance, c, ln, **kw):
            b = tap.bands[-1]
            b['widths'][tap._part].append(c.alive.shape[0])
            if tap.mark:
                b['lives'][tap._part].append(int(c.alive.sum()))
            return orig['_bounce_body'](scene, dyn, radiance, c, ln, **kw)

        for name, fn in (('render_sample', render_sample),
                         ('_tail_level', tail_level),
                         ('_tail_round', tail_round),
                         ('_bounce_body', bounce_body)):
            setattr(ptm, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(ptm, name, fn)

    def rounds(self, part: int) -> int:
        return sum(b['rounds'].get(part, 0) for b in self.bands)


def _is_kernel(e) -> bool:
    """A CUDA kernel or copy event: the profiler also mirrors the
    ``cpt/...`` labels onto the device timeline, and those are not work."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith('cpt/'))


def _cuda_spans(events):
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if _is_kernel(e))


def _busy(spans, lo=float('-inf'), hi=float('inf')) -> tuple[float, int]:
    """Union (us) of the kernel intervals that start in [lo, hi), clipped to
    it, and their count."""
    busy, end, n = 0.0, float('-inf'), 0
    for s, e in spans:
        if not lo <= s < hi:
            continue
        n += 1
        e = min(e, hi)
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, n


def _scatter_memsets(events) -> tuple[float, int]:
    """(us, count) of the memsets that zero the guiding scatter's table: the
    device event just before each ``guiding_scatter_kernel``, when it is a
    memset (the wrapper issues the two back to back on one stream)."""
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if _is_kernel(e))
    total, n = 0.0, 0
    for (s, t, prev), (_, _, name) in zip(dev, dev[1:]):
        if 'guiding_scatter_kernel(' in name and prev.startswith('Memset'):
            total += t - s
            n += 1
    return total, n


def _parts(tap: ScheduleTap, events, spans):
    """Per (band, part): bounces, rounds, widths, live lanes, kernels, wall
    and busy us, summed over the dispatches of the profiled work."""
    ranges = {}
    for e in events:
        if (e.name.startswith('cpt/')
                and e.device_type == torch.autograd.DeviceType.CPU):
            _, call, part = e.name.split('/')
            ranges[(int(call), part)] = (e.time_range.start, e.time_range.end)
    rows = defaultdict(lambda: dict(bounces=0, rounds=0, widths=set(),
                                    lives=[], kernels=0, wall=0.0, busy=0.0))
    for i, b in enumerate(tap.bands):
        lo, hi = ranges.get((i, 'band'), (0.0, 0.0))
        inner = [ranges[(i, str(p))] for p in b['widths'] if p != MAIN
                 and (i, str(p)) in ranges]
        for part in sorted(b['widths']):
            row = rows[(b['band'], part)]
            row['bounces'] += len(b['widths'][part])
            row['rounds'] += b['rounds'].get(part, 0)
            row['widths'] |= set(b['widths'][part])
            row['lives'] += b['lives'][part]
            if part == MAIN:
                # the band minus its tail levels: bounces, guiding, film
                busy, n = _busy(spans, lo, hi)
                wall = hi - lo
                for s, e in inner:
                    db, dn = _busy(spans, s, e)
                    busy, n, wall = busy - db, n - dn, wall - (e - s)
            else:
                s, e = ranges.get((i, str(part)), (0.0, 0.0))
                busy, n = _busy(spans, s, e)
                wall = e - s
            row['kernels'] += n
            row['wall'] += wall
            row['busy'] += busy
    return rows


def _profiled(work, tap: ScheduleTap):
    """(wall ms, profiler) of one synchronized run of ``work`` under ``tap``
    and the profiler."""
    with tap, profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    return wall, prof


def _report(name: str, work, top: int = 8):
    work()                      # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    work()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t) * 1e3

    kernels.reset_counts()
    tap = ScheduleTap()
    wall, prof = _profiled(work, tap)
    busy, n = _busy(_cuda_spans(prof.events()))
    busy /= 1e3
    bodies = sum(len(w) for b in tap.bands for w in b['widths'].values())
    print(f'{name}: unprofiled wall {plain_wall:.1f} ms; profiled wall '
          f'{wall:.1f} ms, device busy {busy:.1f} ms, idle share '
          f'{1 - busy / wall:.3f} ({1 - busy / plain_wall:.3f} of the '
          f'unprofiled wall), {n} CUDA kernels, {bodies} bounce bodies; '
          f'launches of the port\'s kernels {dict(kernels.LAUNCHES)}; '
          f'{len(tap.bands)} band calls')
    rows = [r for r in prof.key_averages()
            if getattr(r, 'device_time_total', 0) > 0]
    rows.sort(key=lambda r: r.device_time_total, reverse=True)
    for r in rows[:top]:
        print(f'  {r.device_time_total / 1e3:9.2f} ms {r.count:6d} x  '
              f'{r.key[:90]}')
    ours = [(name, r) for r in rows for name in PORT_KERNELS
            if name + '(' in r.key]
    trav = sum(r.device_time_total for name, r in ours
               if name.startswith('traverse')) / 1e3
    print('  the port\'s kernels: ' + '; '.join(
        f'{name} {r.device_time_total / 1e3:.3f} ms over {r.count}'
        for name, r in ours) + f'; traverse* {trav:.3f} ms of {busy:.1f} ms '
        f'busy')
    memsets = [r for r in rows if r.key.startswith('Memset')]
    scat_us, scat_n = _scatter_memsets(prof.events())
    print(f'  the guiding scatter\'s table memsets {scat_us / 1e3:.3f} ms over '
          f'{scat_n}; all memsets of the frame '
          f'{sum(r.device_time_total for r in memsets) / 1e3:.3f} ms over '
          f'{sum(r.count for r in memsets)}')

    tap = ScheduleTap(mark=True)
    wall, prof = _profiled(work, tap)
    events = prof.events()
    spans = _cuda_spans(events)
    print(f'  marked run (a sync per bounce and around each band and level): '
          f'wall {wall:.1f} ms')
    print('  band part      bounces rounds widths        live lanes per bounce '
          '(mean)  kernels  wall ms  busy ms  idle')
    for (band, part), r in sorted(_parts(tap, events, spans).items()):
        label = 'full-width' if part == MAIN else f'level@{part}'
        live = sum(r['lives']) / max(len(r['lives']), 1)
        idle = 1 - r['busy'] / r['wall'] if r['wall'] > 0 else float('nan')
        print(f'  {band:4d} {label:10s} {r["bounces"]:7d} {r["rounds"]:6d} '
              f'{",".join(map(str, sorted(r["widths"]))):13s} {live:12.1f}'
              f'{"":17s} {r["kernels"]:7d} {r["wall"] / 1e3:8.1f} '
              f'{r["busy"] / 1e3:8.1f} {idle:5.3f}')


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--v1', action='store_true',
                   help='trace with the split-table v1 kernel')
    p.add_argument('--one-band', action='store_true',
                   help='render each frame as one band')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('frame_profile: needs a CUDA device', file=sys.stderr)
        return 1
    dispatch.PACKET_V1 = args.v1
    if args.one_band:
        ptm.Pathtracer.MAX_LANES_PER_DISPATCH = WIDTH * HEIGHT
    print(f'{torch.cuda.get_device_name(0)}; PACKET_V1={args.v1}; lane cap '
          f'{ptm.Pathtracer.MAX_LANES_PER_DISPATCH}')

    scene = get_scene('outside')
    pt = ptm.Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    cam = Camera.create([0.0, 4.0, -17.0], [0.0, -0.2, 1.0], 1.5, 12.0, 0.0)
    print(f'{pt.bands} bands of {pt.band_h} rows, tile order {pt.tile_order}')

    def outside_frame():
        scene.update(None, 5.0)
        pt.render(cam, 5.0, 0.0, should_clear=True)
        pt.image(blur=True)
    _report('outside clearing frame (refit + 5 samples x 5 bounces + the '
            'blurred image)',
            outside_frame)

    scene = get_scene('sibenik')
    pt = ptm.Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    cam = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)
    pt.render(cam, should_clear=True)
    start = (pt.lum, pt.alb, pt.radiance, pt.sample_idx, pt.rand_idx)

    def converge_sample():
        # every run renders the first converge sample from the same state,
        # so the four runs do the same work
        pt.lum, pt.alb, pt.radiance, pt.sample_idx, pt.rand_idx = start
        pt.render(cam)
    _report('sibenik converge sample', converge_sample)
    return 0


if __name__ == '__main__':
    sys.exit(main())
