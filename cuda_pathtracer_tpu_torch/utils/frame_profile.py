"""Where one frame's time goes on the card, from ``torch.profiler``.

    python -m cuda_pathtracer_tpu_torch.utils.frame_profile [--v1]

Profiles one clearing frame of the CLI's animated path (the ``outside``
scene at 1920x1080, ``Scene.update`` at t = 5 so the frame refits the moved
cubes, 5 samples of at most 5 bounces, NEE) and one converge sample of the
sibenik path (1920x1080, 32 bounces), each after a warm-up of the same work.
``--v1`` traces with the split-table kernel. Prints, per frame, the wall time
around synchronized work, the device-busy time (the union of the CUDA kernel
intervals), the device's idle share, the kernel launches, and the kernels
that took the most device time. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..core.camera import Camera
from ..models.pathtracer import Pathtracer
from ..ops import dispatch, kernels
from ..scene.builder import get_scene

WIDTH, HEIGHT = 1920, 1080


def _busy_ms(events) -> tuple[float, int]:
    """Union of the CUDA kernel intervals (ms) and the kernel count."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float('-inf')
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3, len(spans)


def _report(name: str, work, top: int = 8):
    work()                      # warm-up
    torch.cuda.synchronize()
    kernels.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy, n = _busy_ms(prof.events())
    print(f'{name}: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share '
          f'{1 - busy / wall:.3f}, {n} CUDA kernels; launches of the port\'s '
          f'kernels {dict(kernels.LAUNCHES)}')
    rows = [r for r in prof.key_averages()
            if getattr(r, 'device_time_total', 0) > 0]
    rows.sort(key=lambda r: r.device_time_total, reverse=True)
    for r in rows[:top]:
        print(f'  {r.device_time_total / 1e3:9.2f} ms {r.count:6d} x  '
              f'{r.key[:90]}')


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--v1', action='store_true',
                   help='trace with the split-table v1 kernel')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('frame_profile: needs a CUDA device', file=sys.stderr)
        return 1
    dispatch.PACKET_V1 = args.v1
    print(f'{torch.cuda.get_device_name(0)}; PACKET_V1={args.v1}')

    scene = get_scene('outside')
    pt = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    cam = Camera.create([0.0, 4.0, -17.0], [0.0, -0.2, 1.0], 1.5, 12.0, 0.0)

    def outside_frame():
        scene.update(None, 5.0)
        pt.render(cam, 5.0, 0.0, should_clear=True)
    _report('outside clearing frame (refit + 5 samples x 5 bounces)',
            outside_frame)

    scene = get_scene('sibenik')
    pt = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    cam = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0)
    pt.render(cam, should_clear=True)
    _report('sibenik converge sample', lambda: pt.render(cam))
    return 0


if __name__ == '__main__':
    sys.exit(main())
