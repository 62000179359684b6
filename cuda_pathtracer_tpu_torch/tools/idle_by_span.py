"""The card's idle time by the innermost program span the host had open.

Renders a still camera's depth-7 Whitted frames for a while (render,
finish, ``film.to_uint8(image())``: the benchmark's ``whitted_still`` loop)
under a CUDA-only ``torch.profiler`` profile, then splits the window's
idle time (no kernel, copy or fill on the card) by the innermost span of
``utils/profiling`` open on the host at each instant, and prints each
span's idle seconds, its share of the idle time, its host ms a frame and
how often it opens a frame, with the device ms a frame of the costliest
ops. The ``sync.<site>`` spans are summed as ``sync.*``; idle time with no
span open is the loop's own, "outside the program". The spans are stamped
on the clock of the profiler's events, so the two compare directly.

Run from the repository root on a CUDA machine:

    python3 -m cuda_pathtracer_tpu_torch.tools.idle_by_span \\
        --config portbench/configs/sibenik-480p.json --seconds 10

``--out`` also writes the table as JSON. The profile records CUDA events
only, so the host pays the profiler's cost per launch and nothing per
PyTorch op on the CPU; span times are still longer than untraced ones.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

OUTSIDE = 'outside the program'


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_intervals(busy, lo: float, hi: float) -> list:
    """The gaps of ``busy`` (sorted disjoint intervals) within [lo, hi)."""
    idle, at = [], lo
    for a, b in busy:
        if a > at:
            idle.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        idle.append((at, hi))
    return [(a, b) for a, b in idle if b > a]


def span_key(name: str) -> str:
    return 'sync.*' if name.startswith('sync.') else name


def idle_by_span(idle, spans) -> dict:
    """{span name: idle time} over the ``idle`` intervals, each instant
    given to the innermost of ``spans`` ((name, start, end), nested on one
    thread) open then, or to ``OUTSIDE``."""
    marks = sorted([(a, 1, i) for i, (_, a, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, _, b) in enumerate(spans)],
                   key=lambda m: (m[0], m[1]))
    out = collections.defaultdict(float)
    stack, mi = [], 0
    for a, b in idle:
        t = a
        while t < b:
            while mi < len(marks) and marks[mi][0] <= t:
                _, opens, i = marks[mi]
                if opens:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                mi += 1
            end = min(b, marks[mi][0]) if mi < len(marks) else b
            out[span_key(spans[stack[-1]][0]) if stack else OUTSIDE] += end - t
            t = end
    return dict(out)


def op_name(name: str) -> str:
    """A device op's name without its arguments, template arguments,
    ``void`` and anonymous namespace (where the port's kernels live)."""
    n = name.replace('(anonymous namespace)::', '')
    n = n[5:] if n.startswith('void ') else n
    return n.split('(')[0].split('<')[0].strip()[:60] or name[:60]


def table(events, spans, lo: float, hi: float, frames: int) -> dict:
    """The window [lo, hi) (us) read from the device ``events`` ((name,
    start, end) us) and the host ``spans`` ((name, start, end) us) of
    ``frames`` frames: busy and idle us, and a row per span name (idle us,
    host ms a frame, opened a frame), costliest idle first."""
    busy = union((a, b) for _, a, b in events)
    idle = idle_intervals(busy, lo, hi)
    by_span = idle_by_span(idle, spans)
    host = collections.defaultdict(float)
    count = collections.Counter()
    for name, a, b in spans:
        host[span_key(name)] += (b - a) / 1e3
        count[span_key(name)] += 1
    ops = collections.defaultdict(float)
    for name, a, b in events:
        ops[op_name(name)] += (b - a) / 1e3
    n = max(frames, 1)
    rows = [dict(span=name, idle_us=us,
                 host_ms_a_frame=host.get(name, 0.0) / n,
                 a_frame=count.get(name, 0) / n)
            for name, us in sorted(by_span.items(), key=lambda kv: -kv[1])]
    return dict(window_us=hi - lo, frames=frames,
                busy_us=sum(min(b, hi) - max(a, lo) for a, b in busy
                            if b > lo and a < hi),
                idle_us=sum(b - a for a, b in idle), device_ops=len(events),
                rows=rows, device_ms_a_frame=dict(sorted(
                    ((k, v / n) for k, v in ops.items()),
                    key=lambda kv: -kv[1])[:10]))


def device_events(prof) -> list:
    """Sorted (name, start_us, end_us) of a finished profile's device events
    (kernels, copies, fills), from the Kineto results, leaving out the
    ``cpt/`` labels the profiler mirrors onto the device timeline."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).split('.')[-1] != 'CUDA':
            continue
        start = (e.start_ns() / 1e3 if hasattr(e, 'start_ns')
                 else e.start_us())
        dur = (e.duration_ns() / 1e3 if hasattr(e, 'duration_ns')
               else e.duration_us())
        out.append((e.name(), float(start), float(start + dur)))
    return sorted((ev for ev in out if not ev[0].startswith('cpt/')),
                  key=lambda ev: ev[1])


def report(t: dict) -> str:
    win, idle = t['window_us'], t['idle_us']
    lines = [f'{t["frames"]} frames in {win / 1e6:.3f} s; busy '
             f'{t["busy_us"] / 1e6:.4f} s, idle {idle / 1e6:.4f} s '
             f'({100 * idle / win:.2f}%); '
             f'{t["device_ops"] / max(t["frames"], 1):.1f} device ops a frame']
    for r in t['rows']:
        lines.append(f'  {r["span"]}: idle {r["idle_us"] / 1e6:.4f} s '
                     f'({100 * r["idle_us"] / max(idle, 1e-9):.1f}% of idle), '
                     f'host {r["host_ms_a_frame"]:.3f} ms a frame, '
                     f'{r["a_frame"]:.1f} a frame')
    lines.append('device ms a frame by op: ' + ', '.join(
        f'{k} {v:.4f}' for k, v in t['device_ms_a_frame'].items()))
    return '\n'.join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--config', default='portbench/configs/sibenik-480p.json',
                   help='scene, width, height and camera, as JSON')
    p.add_argument('--seconds', type=float, default=10.0)
    p.add_argument('--warmup', type=int, default=5, help='frames before it')
    p.add_argument('--out', help='also write the table here as JSON')
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core.camera import Camera
    from ..models import film, raytracer
    from ..scene.builder import get_scene
    from ..utils import profiling
    from .timing import card_line, require_card
    require_card()
    with open(args.config) as f:
        cfg = json.load(f)
    eng = raytracer.Raytracer(get_scene(cfg['scene']), cfg['width'],
                              cfg['height'], device='cuda')
    c = cfg['camera']
    cam = Camera.create(c['eye'], c['view_dir'], c['d'], c['focal_length'],
                        c['aperture'], device='cuda')

    def tick():
        eng.render(cam, should_clear=False)
        eng.finish()
        film.to_uint8(eng.image())

    for _ in range(args.warmup):
        tick()
    torch.cuda.synchronize()
    profiling.clear()
    frames = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.time_ns()
        while time.time_ns() - w0 < args.seconds * 1e9:
            tick()
            frames += 1
        torch.cuda.synchronize()
        w1 = time.time_ns()
    spans = [(s.name, s.start_ns / 1e3, s.end_ns / 1e3)
             for s in profiling.spans() if s.end_ns is not None]
    t = table(device_events(prof), spans, w0 / 1e3, w1 / 1e3, frames)
    t['card'] = card_line()
    print(t['card'])
    print(report(t))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(t, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
