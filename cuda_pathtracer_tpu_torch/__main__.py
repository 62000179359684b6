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
``2mtris``) or the path of a ``.chai`` scene script.

``--shard`` splits the frame's bands over ranks, one process per rank
(``parallel/mesh.py``): under torchrun, its ranks (``WORLD_SIZE``); else one
rank per visible CUDA device, the CLI starting the other ranks itself; with
``--device cpu``, one rank. Every rank renders its bands; only rank 0
writes the PNG, the state file, the checkpoint and the stderr lines. In the
loops rank 0 reads the keys, clicks and stop request of each tick and
shares them, and every rank runs the tick on its own scene, camera and
engine. ``--mode ray`` renders on rank 0 alone, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import os
import shutil
import signal
import sys
import tempfile
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
    p.add_argument('--shard', action='store_true',
                   help='split pixel rows over ranks: torchrun\'s, else one '
                        'per visible CUDA device')
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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    if not args.shard:
        return _run(args)
    if args.mode == 'ray':
        # the Whitted frame renders on one device: rank 0's
        return 0 if int(os.environ.get('RANK', '0')) else _run(args)
    if 'WORLD_SIZE' in os.environ:          # started by torchrun
        return _rank_main(argv)
    world = 1
    if args.device == 'cuda':
        import torch
        world = max(1, torch.cuda.device_count())
    return _spawn_ranks(argv, world)


def _rank_device(device: str, local_rank: int) -> str:
    """The render device of a rank: ``cuda`` means this host's card
    ``local_rank`` (ranks share the cards when there are fewer)."""
    if device != 'cuda':
        return device
    import torch
    return f'cuda:{local_rank % max(1, torch.cuda.device_count())}'


def _spawn_ranks(argv, world: int) -> int:
    """Run rank 0 here and ranks 1.. in processes of their own (the spawn
    start method), meeting at a file store in a temporary directory. Every
    rank is joined; one that outlives rank 0 by the collectives' timeout is
    killed."""
    import importlib
    import multiprocessing as mp
    from .parallel.mesh import TIMEOUT_S
    tmp = tempfile.mkdtemp(prefix='cpt_shard_')
    store = os.path.join(tmp, 'store')
    ctx = mp.get_context('spawn')
    # a spawned rank imports its target by the module's name, and spawn
    # runs no package's __main__ again: under ``python -m`` this module is
    # __main__, so the target comes from the module imported by its name
    target = importlib.import_module(__spec__.name)._rank_process
    procs = [ctx.Process(target=target, args=(argv, r, world, store))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        rc = _rank_main(argv, 0, world, store)
    finally:
        for p in procs:
            p.join(TIMEOUT_S + 30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [p.exitcode for p in procs if p.exitcode]
    return rc or (bad[0] if bad else 0)


def _rank_main(argv, rank: int | None = None, world: int | None = None,
               store: str | None = None) -> int:
    """One rank of a ``--shard`` run: join the group (from torchrun's
    environment without ``rank``, else at the file ``store``), run the
    CLI's path, leave the group."""
    from .parallel.mesh import close_group, init_group
    args = build_argparser().parse_args(argv)
    local = int(os.environ.get('LOCAL_RANK', '0')) if rank is None else rank
    group = init_group(_rank_device(args.device, local), rank, world, store)
    try:
        return _run(args, group)
    finally:
        close_group()


def _rank_process(argv, rank: int, world: int, store: str):
    """The entry point of a spawned rank: Ctrl-C is rank 0's to handle."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    sys.exit(_rank_main(argv, rank, world, store))


def _run(args, group=None) -> int:
    """The CLI's work on one rank (``group`` None: unsharded)."""
    from .scene import state as state_mod
    from .scene.builder import get_scene
    from .utils.image import save_png

    lead = group is None or group.rank == 0
    say = _printer(lead)
    device = group.device if group is not None else args.device
    say(f"Loading scene '{args.scene}', this might take a moment")
    scene = get_scene(args.scene, asset_dirs=args.asset_dir + ['.'])
    camera = state_mod.read_state(args.state, device=device)

    if args.mode == 'ray':
        from .models.raytracer import Raytracer
        app = Raytracer(scene, args.width, args.height, device=device)
    else:
        if group is not None:
            from .parallel.mesh import ShardedPathtracer
            app = ShardedPathtracer(scene, args.width, args.height,
                                    group=group)
        else:
            from .models.pathtracer import Pathtracer
            app = Pathtracer(scene, args.width, args.height, device=device)
        app.nee = not args.no_nee
        app.cache = not args.no_cache

    if args.serve:
        _serve_loop(app, scene, camera, args, group)
        return 0
    if args.interactive:
        _interactive_loop(app, scene, camera, args, group)
        return 0

    # headless: animate to the requested time, render spp samples, save
    scene.update(None, args.time)
    t0 = time.perf_counter()
    if args.resume and args.mode == 'path':
        from .utils.checkpoint import load_checkpoint
        camera = load_checkpoint(args.resume, app)
        say(f'resumed at {app.sample_idx} spp from {args.resume}')
    else:
        app.render(camera, args.time, 0.0, should_clear=True)
    if args.mode == 'path':
        while app.sample_idx < args.spp:
            app.render(camera, args.time, 0.0, should_clear=False)
    app.finish()
    if args.checkpoint and args.mode == 'path':
        from .utils.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, app, camera)
        say(f'checkpoint -> {args.checkpoint}')
    dt = time.perf_counter() - t0
    img = app.image(blur=args.blur)
    if lead:
        save_png(img.cpu().numpy(), args.out)
    spp = getattr(app, 'sample_idx', 1)
    say(f'rendered {args.width}x{args.height} @ {spp} spp '
        f'in {dt:.2f}s -> {args.out}')
    if args.mode == 'path':
        total, has_nan, has_neg = app.energy()
        say(f'energy {total:.2f} nan={has_nan} neg={has_neg}')
    if lead:
        state_mod.save_state(camera, args.state)
    return 0


def _printer(lead: bool):
    """print to stderr on the lead rank; nothing on the others."""
    def say(*a, **kw):
        if lead:
            print(*a, file=sys.stderr, **kw)
    return say


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


class _Ticks:
    """The inputs of a loop's ticks: read on rank 0 and, under ``--shard``,
    shared with every rank, so that every rank runs the same tick. Under a
    group, Ctrl-C on rank 0 asks the loop to stop at the next tick (the
    other ranks ignore it), so that no rank leaves a collective early."""

    def __init__(self, group):
        self.group = group
        self.lead = group is None or group.rank == 0
        self.stop = False
        self._old = None
        self._lines = None
        if group is not None:
            self._old = signal.signal(
                signal.SIGINT, self._on_sigint if self.lead else signal.SIG_IGN)

    def _on_sigint(self, *_):
        self.stop = True

    def share(self, read):
        """``read()``'s value on rank 0, on every rank."""
        value = read() if self.lead else None
        return value if self.group is None else self.group.share(value)

    def share_line(self):
        """The next line of rank 0's stdin (None at its end or when Ctrl-C
        asked the loop to stop), on every rank. Under a group a thread of
        rank 0 reads the lines, and rank 0 shares its stop flag with "no
        line yet" every second, so that a person's pause at the prompt
        outlasts no collective's timeout and Ctrl-C needs no Enter."""
        if self.group is None:
            return _read_line()
        import queue
        if self.lead and self._lines is None:
            import threading
            self._lines = queue.Queue()

            def pump():
                while True:
                    line = _read_line()
                    self._lines.put(line)
                    if line is None:
                        return
            threading.Thread(target=pump, daemon=True).start()
        while True:
            line = _WAIT
            if self.lead:
                try:
                    line = self._lines.get(timeout=1.0)
                except queue.Empty:
                    pass
            line, stop = self.group.share((line, self.stop))
            if stop:
                return None
            if line != _WAIT:
                return line

    def close(self):
        if self._old is not None:
            signal.signal(signal.SIGINT, self._old)


def _serve_loop(app, scene, camera, args, group=None):
    """The real-time loop of the reference main() (src/main.cpp:301-425) with
    the GLFW window replaced by the HTTP live viewer: render, present, poll
    keys, update camera/scene, decide shouldClear. Under ``--shard`` the
    viewer is rank 0's. Spans (``utils/profiling.py``): ``serve.render``,
    ``serve.update``, ``serve.finish`` and ``serve.present``."""
    from .core.camera import update_camera
    from .models import film
    from .scene import state as state_mod
    from .utils.display import HttpDisplay
    from .utils.focus import click_to_focus
    from .utils.keyboard import Keyboard, DEFAULT_KEYMAP
    from .utils.profiling import FpsMeter, span

    ticks = _Ticks(group)
    say = _printer(ticks.lead)
    display = HttpDisplay(args.serve) if ticks.lead else None
    if display is not None:
        say(f'live viewer: http://localhost:{display.port}/')
    kb = Keyboard()
    fps = FpsMeter(report_every=10)
    blur = True
    should_clear = True
    t = args.time
    tick = 0
    try:
        while args.frames == 0 or tick < args.frames:
            tick += 1
            with span('serve.render'):
                app.render(camera, t, 0.0, should_clear=should_clear)
            # the host-side scene update overlaps the asynchronous device
            # render (main.cpp:312-313)
            stop, keys, clicks = ticks.share(lambda: (
                ticks.stop, display.poll_keys(), list(display.poll_clicks())))
            if stop:
                break
            kb.set_down(keys)
            with span('serve.update'):
                scene.update(kb, t)
            with span('serve.finish'):
                app.finish()
            img = app.image(blur=blur)
            if display is not None:
                frame = film.to_uint8(img)
                with span('serve.present'):
                    display.present(frame)
                ema = fps.frame()
                if ema is not None:
                    say(f'running average fps: {ema:.2f}')
            # DEBUG_ENERGY audit every 10 ticks (src/main.cpp:342-366):
            # detect NaNs / negative channels, report energy per sample
            if tick % 10 == 0 and hasattr(app, 'energy'):
                total, has_nan, has_neg = app.energy()
                per_sample = total / max(1, getattr(app, 'sample_idx', 1))
                if has_nan:
                    say('energy audit: NANS DETECTED!')
                if has_neg:
                    say('energy audit: negative channel detected!')
                say(f'Total energy per sample: {per_sample:.1f}')

            moved = False
            # click-to-focus (main.cpp:381-393): browser clicks set the focal
            # length to the hit distance under the cursor
            for (cu, cv) in clicks:
                px = int(cu * app.width)
                py = int((1.0 - cv) * app.height)   # browser y is top-down
                camera, ok = click_to_focus(camera, app.arrays, app.dyn,
                                            px, py, app.width, app.height)
                if ok:
                    say(f'focal length: {float(camera.focal_length):.3f}')
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
        ticks.close()
        if display is not None:
            display.close()
            state_mod.save_state(camera, args.state)


def _interactive_loop(app, scene, camera, args, group=None):
    """Line-based interactive loop with the reference's key bindings
    (keyboard.h:106-138; main.cpp:396-411). It starts at scene time 0,
    whatever ``--time`` says, as the JAX CLI does. Under ``--shard`` rank 0
    reads the lines."""
    from .core.camera import update_camera
    from .scene import state as state_mod
    from .utils.focus import click_to_focus
    from .utils.keyboard import Keyboard, DEFAULT_KEYMAP

    ticks = _Ticks(group)
    kb = Keyboard()
    blur = True
    should_clear = True
    t = 0.0
    _printer(ticks.lead)('interactive mode: type keys then Enter (e.g. "w", '
                         '"ww", "space"); "focus X Y" to click-focus; "quit" '
                         'to exit')
    try:
        while True:
            app.render(camera, t, 0.0, should_clear=should_clear)
            app.finish()
            img = app.image(blur=blur and hasattr(app, 'lum'))
            if ticks.lead:
                print(_ascii_preview(img.cpu().numpy()))
                spp = getattr(app, 'sample_idx', 1)
                print(f'[t={t:.1f} spp={spp}] > ', end='', flush=True)
            line = ticks.share_line()
            if line is None or line in ('quit', 'exit'):
                break
            t += 0.1
            keys = line.split() if ' ' in line else list(line) \
                if len(line) <= 8 else [line]
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
    finally:
        ticks.close()
    if ticks.lead:
        state_mod.save_state(camera, args.state)


_WAIT = ('no line yet',)   # never equal to a line, which is a str


def _read_line():
    """The next stripped line of stdin, or None at its end."""
    try:
        return input().strip()
    except EOFError:
        return None


if __name__ == '__main__':
    sys.exit(main())
