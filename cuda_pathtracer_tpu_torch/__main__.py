"""Command-line entry point (counterpart of ``cuda_pathtracer_tpu/__main__.py``;
the reference binary, src/main.cpp:179-432). It runs on the card unless
``--device cpu`` is given.

  * headless (default): build the scene, run its animation handlers at
    ``--time``, render one clearing frame and then converge samples until
    ``--spp``, write the PNG, print the same stderr lines as the JAX CLI (the
    render line and, in path mode, the energy audit) and save the camera to
    ``--state`` (the reference's save.txt). ``--mode ray`` renders one
    clearing frame of the Whitted raytracer instead. ``--checkpoint`` writes
    the render state at exit and ``--resume`` starts from one (path mode;
    the format is the JAX package's).
  * ``--serve PORT``: the real-time loop of the reference's window, with an
    HTTP viewer in place of the window (``--frames N`` stops after N frames).
  * ``--interactive``: a terminal loop that takes the reference's key
    bindings one line at a time and previews each frame in the terminal.

Usage:
  python -m cuda_pathtracer_tpu_torch --scene outside --spp 32 --out out.png
  python -m cuda_pathtracer_tpu_torch --scene sibenik --mode ray --out ray.png
  python -m cuda_pathtracer_tpu_torch --scene outside --serve 8000

``--scene`` takes a built-in scene (``outside``, ``sibenik``, ``minecraft``,
``2mtris``) or the path of a ``.chai`` scene script. Not ported yet, and
refused with a non-zero exit: ``--shard``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(
        prog='cuda_pathtracer_tpu_torch',
        description='wavefront path tracer, PyTorch + CUDA port '
                    '(capabilities of HugoPeters1024/cuda_pathtracer)')
    p.add_argument('-s', '--scene', default='outside',
                   help='built-in scene name or path to a .chai script '
                        '(default: outside)')
    p.add_argument('--width', type=int, default=640)
    p.add_argument('--height', type=int, default=480)
    p.add_argument('--spp', type=int, default=16,
                   help='samples per pixel in headless mode')
    p.add_argument('--mode', choices=('path', 'ray'), default='path',
                   help='pathtracer or Whitted raytracer')
    p.add_argument('--out', default='out.png', help='output PNG path')
    p.add_argument('--no-nee', action='store_true')
    p.add_argument('--no-cache', action='store_true', help='disable guiding')
    p.add_argument('--blur', action='store_true',
                   help='apply the luminance Gaussian filter to the output')
    p.add_argument('--state', default='save.txt',
                   help='camera state file (reference save.txt format)')
    p.add_argument('--asset-dir', action='append', default=[],
                   help='additional asset search directories')
    p.add_argument('--shard', action='store_true', help='not ported yet')
    p.add_argument('--interactive', action='store_true',
                   help='terminal-interactive loop with reference keybindings')
    p.add_argument('--serve', type=int, metavar='PORT', default=0,
                   help='interactive browser viewer on this HTTP port '
                        '(the headless stand-in for the GLFW window)')
    p.add_argument('--time', type=float, default=0.0,
                   help='scene time for animation handlers')
    p.add_argument('--frames', type=int, default=0,
                   help='with --serve: stop after N frames (0 = forever)')
    p.add_argument('--checkpoint', default='',
                   help='write a render-state checkpoint (.npz) at exit')
    p.add_argument('--resume', default='',
                   help='resume from a render-state checkpoint (.npz)')
    p.add_argument('--device', default='cuda',
                   help="torch device to render on (default: cuda; 'cpu' "
                        'runs the plain PyTorch versions of the kernels)')
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.shard:
        print('cuda_pathtracer_tpu_torch: --shard: not ported yet',
              file=sys.stderr)
        return 2

    from .scene import state as state_mod
    from .scene.builder import get_scene
    from .utils.image import save_png

    print(f"Loading scene '{args.scene}', this might take a moment",
          file=sys.stderr)
    scene = get_scene(args.scene, asset_dirs=args.asset_dir + ['.'])
    camera = state_mod.read_state(args.state, device=args.device)

    if args.mode == 'ray':
        from .models.raytracer import Raytracer
        app = Raytracer(scene, args.width, args.height, device=args.device)
    else:
        from .models.pathtracer import Pathtracer
        app = Pathtracer(scene, args.width, args.height, device=args.device)
        app.nee = not args.no_nee
        app.cache = not args.no_cache

    if args.serve:
        _serve_loop(app, scene, camera, args)
        return 0
    if args.interactive:
        _interactive_loop(app, scene, camera, args)
        return 0

    # headless: animate to the requested time, render spp samples, save
    scene.update(None, args.time)
    t0 = time.perf_counter()
    if args.resume and args.mode == 'path':
        from .utils.checkpoint import load_checkpoint
        camera = load_checkpoint(args.resume, app)
        print(f'resumed at {app.sample_idx} spp from {args.resume}',
              file=sys.stderr)
    else:
        app.render(camera, args.time, 0.0, should_clear=True)
    if args.mode == 'path':
        while app.sample_idx < args.spp:
            app.render(camera, args.time, 0.0, should_clear=False)
    app.finish()
    if args.checkpoint and args.mode == 'path':
        from .utils.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, app, camera)
        print(f'checkpoint -> {args.checkpoint}', file=sys.stderr)
    dt = time.perf_counter() - t0
    img = app.image(blur=args.blur)
    save_png(img.cpu().numpy(), args.out)
    spp = getattr(app, 'sample_idx', 1)
    print(f'rendered {args.width}x{args.height} @ {spp} spp '
          f'in {dt:.2f}s -> {args.out}', file=sys.stderr)
    if args.mode == 'path':
        total, has_nan, has_neg = app.energy()
        print(f'energy {total:.2f} nan={has_nan} neg={has_neg}',
              file=sys.stderr)
    state_mod.save_state(camera, args.state)
    return 0


def _ascii_preview(img, cols=96):
    """Cheap terminal preview of a bottom-first [H, W, 3] image."""
    h, w, _ = img.shape
    rows = max(1, int(cols * h / w / 2))
    ys = (np.linspace(0, h - 1, rows)).astype(int)[::-1]
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    ramp = ' .:-=+*#%@'
    lum = img[..., 0] * 0.3 + img[..., 1] * 0.6 + img[..., 2] * 0.1
    out = []
    for y in ys:
        line = ''.join(ramp[min(int(lum[y, x] * (len(ramp) - 1) + 0.5),
                                len(ramp) - 1)] for x in xs)
        out.append(line)
    return '\n'.join(out)


def _apply_toggles(app, scene, kb, blur: bool) -> tuple[bool, bool]:
    """The toggles and light keys of main.cpp:396-411 and keyboard.h:
    NEE, guiding, blur, light dim/brighten. Returns (moved, blur)."""
    moved = False
    if kb.is_pressed('switch_nee') and hasattr(app, 'nee'):
        app.nee = not app.nee
        moved = True
    if kb.is_pressed('switch_cache') and hasattr(app, 'cache'):
        app.cache = not app.cache
        moved = True
    if kb.is_pressed('switch_blur'):
        blur = not blur
    if kb.is_down('light_dim') and scene.point_lights:
        scene.point_lights[0].color = tuple(
            c * 0.97 for c in scene.point_lights[0].color)
        moved = True
    if kb.is_down('light_brighten') and scene.point_lights:
        scene.point_lights[0].color = tuple(
            c * 1.03 for c in scene.point_lights[0].color)
        moved = True
    return moved, blur


def _serve_loop(app, scene, camera, args):
    """The real-time loop of the reference main() (src/main.cpp:301-425) with
    the GLFW window replaced by the HTTP live viewer: render, present, poll
    keys, update camera/scene, decide shouldClear."""
    from .core.camera import update_camera
    from .models import film
    from .scene import state as state_mod
    from .utils.display import HttpDisplay
    from .utils.focus import click_to_focus
    from .utils.keyboard import Keyboard, DEFAULT_KEYMAP
    from .utils.profiling import FpsMeter

    display = HttpDisplay(args.serve)
    print(f'live viewer: http://localhost:{display.port}/', file=sys.stderr)
    kb = Keyboard()
    fps = FpsMeter(report_every=10)
    blur = True
    should_clear = True
    t = args.time
    tick = 0
    try:
        while args.frames == 0 or tick < args.frames:
            tick += 1
            app.render(camera, t, 0.0, should_clear=should_clear)
            # the host-side scene update overlaps the asynchronous device
            # render (main.cpp:312-313)
            keys = display.poll_keys()
            kb.set_down(keys)
            scene.update(kb, t)
            app.finish()
            display.present(film.to_uint8(app.image(blur=blur)))
            ema = fps.frame()
            if ema is not None:
                print(f'running average fps: {ema:.2f}', file=sys.stderr)
            # DEBUG_ENERGY audit every 10 ticks (src/main.cpp:342-366):
            # detect NaNs / negative channels, report energy per sample
            if tick % 10 == 0 and hasattr(app, 'energy'):
                total, has_nan, has_neg = app.energy()
                per_sample = total / max(1, getattr(app, 'sample_idx', 1))
                if has_nan:
                    print('energy audit: NANS DETECTED!', file=sys.stderr)
                if has_neg:
                    print('energy audit: negative channel detected!',
                          file=sys.stderr)
                print(f'Total energy per sample: {per_sample:.1f}',
                      file=sys.stderr)

            moved = False
            # click-to-focus (main.cpp:381-393): browser clicks set the focal
            # length to the hit distance under the cursor
            for (cu, cv) in display.poll_clicks():
                px = int(cu * app.width)
                py = int((1.0 - cv) * app.height)   # browser y is top-down
                camera, ok = click_to_focus(camera, app.arrays, app.dyn,
                                            px, py, app.width, app.height)
                if ok:
                    print(f'focal length: {float(camera.focal_length):.3f}',
                          file=sys.stderr)
                    moved = True
            if scene.attached == 0:
                actions = {DEFAULT_KEYMAP.get(k, k) for k in keys}
                camera, moved_c = update_camera(camera, actions)
                moved = moved or moved_c
            moved_t, blur = _apply_toggles(app, scene, kb, blur)
            kb.swap_buffers()
            should_clear = moved or moved_t or scene.invalid
            t += 0.1
    except KeyboardInterrupt:
        pass
    finally:
        display.close()
        state_mod.save_state(camera, args.state)


def _interactive_loop(app, scene, camera, args):
    """Line-based interactive loop with the reference's key bindings
    (keyboard.h:106-138; main.cpp:396-411). It starts at scene time 0,
    whatever ``--time`` says, as the JAX CLI does."""
    from .core.camera import update_camera
    from .scene import state as state_mod
    from .utils.focus import click_to_focus
    from .utils.keyboard import Keyboard, DEFAULT_KEYMAP

    kb = Keyboard()
    blur = True
    should_clear = True
    t = 0.0
    print('interactive mode: type keys then Enter (e.g. "w", "ww", "space"); '
          '"focus X Y" to click-focus; "quit" to exit', file=sys.stderr)
    while True:
        app.render(camera, t, 0.0, should_clear=should_clear)
        app.finish()
        img = app.image(blur=blur and hasattr(app, 'lum')).cpu().numpy()
        print(_ascii_preview(img))
        spp = getattr(app, 'sample_idx', 1)
        print(f'[t={t:.1f} spp={spp}] > ', end='', flush=True)
        try:
            line = input().strip()
        except EOFError:
            break
        if line in ('quit', 'exit'):
            break
        t += 0.1
        keys = line.split() if ' ' in line else list(line) if len(line) <= 8 \
            else [line]
        if keys and keys[0] == 'focus' and len(keys) == 3:
            camera, ok = click_to_focus(camera, app.arrays, app.dyn,
                                        int(keys[1]), int(keys[2]),
                                        app.width, app.height)
            should_clear = ok
            continue
        kb.set_down(keys)
        # camera movement (scene.attached == 0 -> camera, main.cpp:396)
        moved = False
        if scene.attached == 0:
            actions = {DEFAULT_KEYMAP.get(k, k) for k in keys}
            camera, moved = update_camera(camera, actions)
        scene.update(kb, t)
        moved_t, blur = _apply_toggles(app, scene, kb, blur)
        kb.swap_buffers()
        should_clear = moved or moved_t or scene.invalid
    state_mod.save_state(camera, args.state)


if __name__ == '__main__':
    sys.exit(main())
