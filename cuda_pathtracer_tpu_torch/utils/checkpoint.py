"""Render-state checkpoint/resume (counterpart of
``cuda_pathtracer_tpu/utils/checkpoint.py``).

The reference persists only the camera (save.txt, src/stateLoader.h:30-75,
``scene/state.py``). This adds the progressive render state: the luminance
and albedo accumulators, the path-guiding radiance cache, the sample and
RNG counters, in one ``.npz``, so a long converge resumes across process
restarts. The format is the JAX package's, key for key: a checkpoint that
either package writes resumes in the other. Both engines keep the
accumulators in their lane order (tile order when the frame tiles), and
both derive it from the frame size alone, so the arrays need no
reordering.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera
from ..models.guiding import RadianceState

FORMAT_VERSION = 1


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_checkpoint(path: str, engine, camera: Camera) -> None:
    """Snapshot a Pathtracer's progressive state."""
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        width=engine.width,
        height=engine.height,
        lum=_host(engine.lum),
        alb=_host(engine.alb),
        radiance_cache=_host(engine.radiance.cache),
        radiance_total=_host(engine.radiance.total),
        sample_idx=engine.sample_idx,
        rand_idx=int(engine.rand_idx),
        rays_traced=float(engine.rays_traced),
        nee=engine.nee,
        cache=engine.cache,
        cam_eye=_host(camera.eye),
        cam_view=_host(camera.view_dir),
        cam_d=float(camera.d),
        cam_focal=float(camera.focal_length),
        cam_aperture=float(camera.aperture),
    )


def _check(ok: bool, message: str) -> None:
    # raised as the JAX package's asserts do, and kept under python -O
    if not ok:
        raise AssertionError(message)


def load_checkpoint(path: str, engine) -> Camera:
    """Restore a snapshot into an engine built for the same scene and
    resolution. Returns the camera the snapshot was rendered with, on the
    engine's device."""
    dev = engine.device
    with np.load(path) as z:
        _check(int(z['version']) == FORMAT_VERSION, 'unknown checkpoint version')
        _check(int(z['width']) == engine.width
               and int(z['height']) == engine.height,
               'checkpoint resolution does not match the engine')
        _check(z['radiance_cache'].shape == tuple(engine.radiance.cache.shape),
               'checkpoint scene (triangle count) does not match')

        def t(key):
            return torch.as_tensor(z[key], dtype=torch.float32, device=dev)
        engine.lum = t('lum')
        engine.alb = t('alb')
        engine.radiance = RadianceState(t('radiance_cache'),
                                        t('radiance_total'))
        engine.sample_idx = int(z['sample_idx'])
        engine.rand_idx = int(z['rand_idx'])
        engine.rays_traced = float(z['rays_traced'])
        engine.nee = bool(z['nee'])
        engine.cache = bool(z['cache'])
        return Camera.create(z['cam_eye'], z['cam_view'], float(z['cam_d']),
                             float(z['cam_focal']), float(z['cam_aperture']),
                             device=dev)
