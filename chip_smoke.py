"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three hand-written CUDA kernels from ``cuda_pathtracer_tpu_torch/
csrc`` and drives the port's main path once at full size: the sibenik scene
at 1920x1080, one clear frame, 4 converge samples (32 bounces, NEE, guiding
training) and the blurred display image. It checks that every kernel ran on
that path and that the plain PyTorch versions did not, then holds each kernel
against its plain version on the main path's own inputs (traversal: the
primary, shadow and first-bounce waves of the first converge sample, found
and t bit-identical; guiding scatter: that sample's updates, rtol 1e-5; blur:
the final 1920x1080 accumulators, rtol 1e-6), renders a small room on the
card and on the CPU and compares the two, and times each kernel against its
plain version with CUDA events.

Prints the card's name and power limit, the build time, per-phase lines,
then one JSON line of per-kernel results, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line, when
there is no CUDA device or any phase fails. Imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

KERNELS = {
    'traverse': ('cuda_pathtracer_tpu_torch/csrc/traverse.cu',
                 'cuda_pathtracer_tpu/ops/traverse_packet2.py:289'),
    'guiding_scatter': ('cuda_pathtracer_tpu_torch/csrc/guiding_scatter.cu',
                        'cuda_pathtracer_tpu/ops/guiding_scatter.py:47'),
    'blur': ('cuda_pathtracer_tpu_torch/csrc/blur.cu',
             'cuda_pathtracer_tpu/ops/blur_pallas.py:40'),
}
WIDTH, HEIGHT = 1920, 1080
CONVERGE_SAMPLES = 4


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 1, warmup: int = 0):
    """Mean milliseconds of fn() over reps, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


class Recorder:
    """Wraps a module attribute; keeps clones of the arguments of the calls
    numbered in ``keep`` (0-based) and otherwise passes straight through."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep = module, name, set(keep)
        self.orig = getattr(module, name)
        self.calls, self.saved = 0, {}

    def __enter__(self):
        def wrapped(*args, **kw):
            if self.calls in self.keep:
                self.saved[self.calls] = (
                    tuple(a.clone() if hasattr(a, 'clone') else a for a in args),
                    dict(kw))
            self.calls += 1
            return self.orig(*args, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false)', file=sys.stderr)
        return 1
    # the port must not need JAX: make any attempt to import it fail
    sys.modules['jax'] = None
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models import guiding as guiding_mod
    from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu_torch.ops import blur as blur_mod
    from cuda_pathtracer_tpu_torch.ops import dispatch as dispatch_mod
    from cuda_pathtracer_tpu_torch.ops import guiding_scatter as gs_mod
    from cuda_pathtracer_tpu_torch.ops import kernels
    from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
    from cuda_pathtracer_tpu_torch.scene import builder

    card = card_line()
    log(f'card: {card} | torch {torch.__version__} cuda {torch.version.cuda}'
        f' | {torch.cuda.get_device_name(0)}')

    t = time.perf_counter()
    so = kernels.build()
    kernels.library()
    log(f'kernel build: {time.perf_counter() - t:.2f} s -> {os.path.relpath(so)}')
    with open(so[:-3] + '.log') as f:
        for line in f:
            if 'registers' in line or 'spill' in line:
                log('  ptxas: ' + line.strip())

    # ---- the main path at full size ----
    t = time.perf_counter()
    scene = builder.get_scene('sibenik')
    pt = Pathtracer(scene, WIDTH, HEIGHT, device='cuda')
    torch.cuda.synchronize()
    log(f'scene: sibenik {len(scene._tri_mat)} triangles, merged BVH '
        f'{pt.dyn.packet_merged.shape[0]} rows, depth {pt.dyn.depth}; '
        f'host build + upload {time.perf_counter() - t:.2f} s')
    cam = Camera.create([0.0, 5.0, -16.0], [0.0, 0.0, 1.0], 1.5, 12.0, 0.0,
                        device='cuda')

    kernels.reset_counts()
    sample_ms, sample_rays = [], []
    # the clear frame traces once (bounce cap 1); the first converge
    # sample's primary, shadow and bounce-1 waves are trace calls 2, 3, 4
    with Recorder(dispatch_mod, 'traverse_merged', keep=(2, 3, 4)) as trav, \
            Recorder(guiding_mod, 'segment_sum_pairs', keep=(0,)) as scat:
        for i in range(1 + CONVERGE_SAMPLES):
            rays0 = int(pt.rays_traced)
            ms, _ = cuda_ms(lambda: pt.render(cam, should_clear=(i == 0)))
            rays = int(pt.rays_traced) - rays0
            log(f'sample {i} ({"clear" if i == 0 else "converge"}): '
                f'{ms:.1f} ms, {rays} rays, {rays / ms / 1e3:.2f} Mrays/s')
            if i:
                sample_ms.append(ms)
                sample_rays.append(rays)
        blur_ms, img = cuda_ms(lambda: pt.image(blur=True))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    plain_on_cuda = dict(kernels.PLAIN_ON_CUDA)
    log(f'launches on the main path: {launches}; plain versions on CUDA: '
        f'{plain_on_cuda}')
    energy, has_nan, has_neg = pt.energy()
    mrays = sum(sample_rays) / sum(sample_ms) / 1e3
    log(f'slice: {CONVERGE_SAMPLES} converge samples, '
        f'{sum(sample_ms) / len(sample_ms):.1f} ms/sample, {mrays:.2f} Mrays/s; '
        f'image(blur=True) {blur_ms:.2f} ms; energy={energy:.4f} '
        f'nan={has_nan} neg={has_neg}')
    failures = []
    if not (energy > 0 and energy == energy and energy != float('inf')):
        failures.append(f'energy {energy}')
    if has_nan or has_neg:
        failures.append(f'nan={has_nan} neg={has_neg}')
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        failures.append('blurred image is not finite [1080, 1920, 3]')
    for name in KERNELS:
        if launches[name] <= 0:
            failures.append(f'{name}: no launch on the main path')
        if plain_on_cuda[name]:
            failures.append(f'{name}: plain version ran on CUDA')

    results = {}

    # ---- kernel vs plain: traversal on the captured waves ----
    trav_ms = trav_plain_ms = trav_err = 0.0
    for call, wave in zip((2, 3, 4), ('primary', 'shadow', 'bounce-1')):
        (table, ro, rd, t0, live, stop), kw = trav.saved[call]
        want_uv = kw.get('want_uv', False)
        ms, (t, gid, found, u, v) = cuda_ms(
            lambda: tp2.traverse_merged(table, ro, rd, t0, live, stop, want_uv),
            reps=3, warmup=1)
        pms, (pt_, pgid, pfound, pu, pv) = cuda_ms(
            lambda: tp2.traverse_merged_ref(table, ro, rd, t0, live, stop,
                                            want_uv))
        same_found = bool(torch.equal(found, pfound))
        t_bits = int((t.view(torch.int32) != pt_.view(torch.int32)).sum())
        gid_diff = int(((gid != pgid) & found).sum())
        err = float((t - pt_)[found].abs().max()) if bool(found.any()) else 0.0
        uv_err = (float(torch.maximum((u - pu).abs(), (v - pv).abs())[found].max())
                  if want_uv and bool(found.any()) else 0.0)
        log(f'traverse {wave}: {ro.shape[0]} rays, {int(live.sum())} live, '
            f'{int(found.sum())} hits | kernel {ms:.3f} ms, plain {pms:.1f} ms '
            f'| found equal={same_found}, t bit mismatches={t_bits}, '
            f'gid mismatches={gid_diff}, max|dt|={err}, max|duv|={uv_err}')
        if not same_found or t_bits:
            failures.append(f'traverse {wave}: kernel disagrees with plain')
        if gid_diff > 0.001 * max(int(found.sum()), 1):
            failures.append(f'traverse {wave}: {gid_diff} gid mismatches')
        if uv_err > 1e-6:
            failures.append(f'traverse {wave}: uv differ by {uv_err}')
        trav_ms += ms
        trav_plain_ms += pms
        trav_err = max(trav_err, err)
    results['traverse'] = (trav_err, trav_ms, trav_plain_ms)

    # ---- kernel vs plain: guiding scatter on the first converge sample ----
    (e, w, seg, n_bins), _ = scat.saved[0]
    ms, (ke, kw_) = cuda_ms(lambda: gs_mod.segment_sum_pairs(e, w, seg, n_bins),
                            reps=5, warmup=1)
    pms, (pe, pw) = cuda_ms(lambda: gs_mod.segment_sum_pairs_ref(e, w, seg, n_bins),
                            reps=5, warmup=1)
    err = float(torch.maximum((ke - pe).abs().max(), (kw_ - pw).abs().max()))
    ok = (torch.allclose(ke, pe, rtol=1e-5, atol=1e-5)
          and torch.allclose(kw_, pw, rtol=1e-5, atol=1e-5))
    log(f'guiding_scatter: {e.shape[0]} updates ({int((seg < n_bins).sum())} '
        f'kept) into {n_bins} bins | kernel {ms:.3f} ms, plain {pms:.3f} ms '
        f'| max|d|={err}, within rtol 1e-5: {ok}')
    if not ok:
        failures.append('guiding_scatter: kernel disagrees with plain')
    results['guiding_scatter'] = (err, ms, pms)

    # ---- kernel vs plain: blur on the final accumulators ----
    n = float(pt.sample_idx)
    ms, kout = cuda_ms(lambda: blur_mod.blur_luminance(pt.lum, pt.alb, n, WIDTH,
                                                       HEIGHT), reps=5, warmup=1)
    pms, pout = cuda_ms(lambda: blur_mod.blur_luminance_ref(pt.lum, pt.alb, n,
                                                            WIDTH, HEIGHT),
                        reps=5, warmup=1)
    err = float((kout - pout).abs().max())
    ok = bool(torch.isfinite(kout).all()) and torch.allclose(kout, pout,
                                                             rtol=1e-6, atol=0)
    log(f'blur: {WIDTH}x{HEIGHT}, n={n} | kernel {ms:.3f} ms, plain {pms:.3f} ms'
        f' | max|d|={err}, within rtol 1e-6: {ok}')
    if not ok:
        failures.append('blur: kernel disagrees with plain')
    results['blur'] = (err, ms, pms)

    # ---- end to end on a small input: the room on the card vs the CPU ----
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    'tests'))
    from _torch_room import build_room, CAMERA
    from cuda_pathtracer_tpu_torch.scene import scene as scene_mod
    accs = []
    for device in ('cuda', 'cpu'):
        small = Pathtracer(build_room(scene_mod, builder.add_cube), 64, 48,
                           device=device)
        c = Camera.create(**CAMERA, device=device)
        for clear in (True, False, False, False):
            small.render(c, should_clear=clear)
        accs.append(small.lum.cpu())
    close = torch.isclose(accs[0][:, :3], accs[1][:, :3], rtol=1e-3,
                          atol=1e-5).all(dim=1).float().mean().item()
    log(f'room 64x48, clear + 3 converge samples: {close:.4f} of pixels agree '
        f'between the CUDA path and the CPU path')
    if close < 0.99:
        failures.append(f'room render: only {close:.4f} of pixels agree')

    if 'jax' in sys.modules and sys.modules['jax'] is not None:
        failures.append('jax was imported')
    if failures:
        for f in failures:
            print('FAIL: ' + f, file=sys.stderr)
        return 1

    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
         'launches': launches[name], 'max_abs_err': results[name][0],
         'ms': results[name][1], 'plain_ms': results[name][2]}
        for name, (src, rep) in KERNELS.items()]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
