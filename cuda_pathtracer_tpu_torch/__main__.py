"""Command-line entry point (counterpart of ``cuda_pathtracer_tpu/__main__.py``;
the reference binary, src/main.cpp:179-432), headless path only:

    python -m cuda_pathtracer_tpu_torch --scene outside --spp 16 --out out.png

builds the scene, runs its animation handlers at ``--time``, renders one
clearing frame and then converge samples until ``--spp``, writes the PNG,
prints the same stderr lines as the JAX CLI (the render line and the energy
audit) and saves the camera to ``--state`` (the reference's save.txt). It runs
on the card unless ``--device cpu`` is given.

Not ported yet, and refused with a non-zero exit: ``--mode ray`` (the Whitted
raytracer), ``--shard``, ``--serve``/``--frames``, ``--interactive``,
``--checkpoint``, ``--resume`` and scene scripts.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(
        prog='cuda_pathtracer_tpu_torch',
        description='wavefront path tracer, PyTorch + CUDA port '
                    '(capabilities of HugoPeters1024/cuda_pathtracer)')
    p.add_argument('-s', '--scene', default='outside',
                   help='built-in scene name (default: outside)')
    p.add_argument('--width', type=int, default=640)
    p.add_argument('--height', type=int, default=480)
    p.add_argument('--spp', type=int, default=16,
                   help='samples per pixel in headless mode')
    p.add_argument('--mode', choices=('path', 'ray'), default='path',
                   help='pathtracer or Whitted raytracer (not ported yet)')
    p.add_argument('--out', default='out.png', help='output PNG path')
    p.add_argument('--no-nee', action='store_true')
    p.add_argument('--no-cache', action='store_true', help='disable guiding')
    p.add_argument('--blur', action='store_true',
                   help='apply the luminance Gaussian filter to the output')
    p.add_argument('--state', default='save.txt',
                   help='camera state file (reference save.txt format)')
    p.add_argument('--asset-dir', action='append', default=[],
                   help='additional asset search directories')
    p.add_argument('--time', type=float, default=0.0,
                   help='scene time for animation handlers')
    p.add_argument('--device', default='cuda',
                   help="torch device to render on (default: cuda; 'cpu' "
                        'runs the plain PyTorch versions of the kernels)')
    # the JAX CLI's other modes, refused until ported
    p.add_argument('--shard', action='store_true', help='not ported yet')
    p.add_argument('--interactive', action='store_true', help='not ported yet')
    p.add_argument('--serve', type=int, metavar='PORT', default=0,
                   help='not ported yet')
    p.add_argument('--frames', type=int, default=0, help='not ported yet')
    p.add_argument('--checkpoint', default='', help='not ported yet')
    p.add_argument('--resume', default='', help='not ported yet')
    return p


def _unported(args) -> list[str]:
    opts = []
    if args.mode != 'path':
        opts.append(f'--mode {args.mode}')
    for flag in ('shard', 'interactive', 'serve', 'frames', 'checkpoint',
                 'resume'):
        if getattr(args, flag):
            opts.append(f'--{flag}')
    return opts


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    unported = _unported(args)
    if unported:
        print(f'cuda_pathtracer_tpu_torch: {", ".join(unported)}: not ported '
              f'yet', file=sys.stderr)
        return 2

    from .models.pathtracer import Pathtracer
    from .scene import state as state_mod
    from .scene.builder import get_scene
    from .utils.image import save_png

    print(f"Loading scene '{args.scene}', this might take a moment",
          file=sys.stderr)
    try:
        scene = get_scene(args.scene, asset_dirs=args.asset_dir + ['.'])
    except ValueError as e:
        print(f'cuda_pathtracer_tpu_torch: {e}', file=sys.stderr)
        return 2
    camera = state_mod.read_state(args.state, device=args.device)
    app = Pathtracer(scene, args.width, args.height, device=args.device)
    app.nee = not args.no_nee
    app.cache = not args.no_cache

    # headless: animate to the requested time, render spp samples, save
    scene.update(None, args.time)
    t0 = time.perf_counter()
    app.render(camera, args.time, 0.0, should_clear=True)
    while app.sample_idx < args.spp:
        app.render(camera, args.time, 0.0, should_clear=False)
    app.finish()
    dt = time.perf_counter() - t0
    img = app.image(blur=args.blur)
    save_png(img.cpu().numpy(), args.out)
    print(f'rendered {args.width}x{args.height} @ {app.sample_idx} spp '
          f'in {dt:.2f}s -> {args.out}', file=sys.stderr)
    total, has_nan, has_neg = app.energy()
    print(f'energy {total:.2f} nan={has_nan} neg={has_neg}', file=sys.stderr)
    state_mod.save_state(camera, args.state)
    return 0


if __name__ == '__main__':
    sys.exit(main())
