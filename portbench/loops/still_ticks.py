"""A Whitted preview of a still camera: every tick renders one frame at
depth 7 (``Raytracer.render(should_clear=False)``, src/raytracer.h:65) and
brings it to the host as ``film.to_uint8``. The answers are
``compare_ticks`` frames of the window drawn from the seed; the reference
renders the camera's frame once (``portbench/reference/whitted.py``)."""
from __future__ import annotations

import time

import torch

from portbench.lib.check import compare_frames
from portbench.lib.traffic import Reservoir

# level 0 of the first frame: the closest-hit wave, then the light's shadow
WAVES = ('closest-hit', 'shadow')


class Loop:

    def __init__(self, ctx):
        self.ctx = ctx
        pm, config = ctx.pm, ctx.config
        self.engine = pm.raytracer.Raytracer(
            ctx.scene, int(config['width']), int(config['height']),
            device=ctx.device)
        cam = ctx.camera
        self.camera = pm.camera.Camera.create(
            cam['eye'], cam['view_dir'], cam['d'], cam['focal_length'],
            cam['aperture'], device=ctx.device)
        self.kept = Reservoir(int(ctx.mix.get('compare_ticks', 3)), ctx.seed)

    def _frame(self) -> dict:
        eng, pm = self.engine, self.ctx.pm
        t0 = time.perf_counter()
        eng.render(self.camera, should_clear=False)
        eng.finish()
        d0 = time.perf_counter()
        frame = pm.film.to_uint8(eng.image())
        t1 = time.perf_counter()
        bad = bool(torch.isnan(eng.frame).any() | (eng.frame < 0).any())
        return dict(seconds=t1 - t0, display_s=t1 - d0, frame=frame, bad=bad)

    def warm_up(self):
        for _ in range(int(self.ctx.mix.get('warmup_ticks', 2))):
            self._frame()

    def tick(self, i: int) -> dict:
        rec = self._frame()
        self.kept.offer(rec.pop('frame'))
        return rec

    def record(self) -> dict:
        return dict(kind='frames')

    def answers(self) -> dict:
        return dict(frames=self.kept.sample())


def reference(ctx, answers: dict, control: bool = False) -> dict:
    from portbench.reference.whitted import Whitted
    cfg = ctx.config
    frame = Whitted(cfg['scene'], ctx.device, round_rays=control).frame(
        ctx.camera, int(cfg['width']), int(cfg['height']))
    return dict(frames=[frame for _ in answers['frames']])


def compare(got: dict, want: dict) -> dict:
    return compare_frames(got['frames'], want['frames'])
