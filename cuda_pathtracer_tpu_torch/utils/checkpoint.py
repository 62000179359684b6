"""Render-state checkpoint/resume (counterpart of
``cuda_pathtracer_tpu/utils/checkpoint.py``).

The reference persists only the camera (save.txt, src/stateLoader.h:30-75,
``scene/state.py``). This adds the progressive render state: the luminance
and albedo accumulators, the path-guiding radiance cache, the sample and
RNG counters, in one ``.npz``, so a long converge resumes across process
restarts. The format is the JAX package's, key for key: a checkpoint that
either package writes resumes in the other. Both engines keep the
accumulators in their lane order (tile order when the frame tiles), and
both derive it from the frame size (and, sharded, the rank count) alone,
so the arrays need no reordering; the port also saves the band geometry and
refuses a resume at another.
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
    """Snapshot a Pathtracer's progressive state. A ShardedPathtracer's
    ranks all call it: the bands are gathered and rank 0 writes the whole
    frame (its padded height, in lane order), as the JAX package does. The
    band geometry that decides the lane order is saved beside them (keys
    the JAX loader, which reads keys by name, does not read)."""
    lum, alb = engine.gather_lanes()
    if engine.rank:
        return
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        width=engine.width,
        height=engine.height,
        bands=engine.bands,
        tile_order=engine.tile_order,
        lum=_host(lum),
        alb=_host(alb),
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
    resolution and, when the snapshot names it, the same band geometry (a
    ShardedPathtracer: the same rank count, each rank keeping its own
    bands; the geometry decides the lane order). Returns the camera the
    snapshot was rendered with, on the engine's device."""
    dev = engine.device
    with np.load(path) as z:
        _check(int(z['version']) == FORMAT_VERSION, 'unknown checkpoint version')
        _check(int(z['width']) == engine.width
               and int(z['height']) == engine.height,
               'checkpoint resolution does not match the engine')
        _check(z['radiance_cache'].shape == tuple(engine.radiance.cache.shape),
               'checkpoint scene (triangle count) does not match')
        if 'bands' in z.files:      # absent: the JAX package's checkpoint
            saved = (int(z['bands']), bool(z['tile_order']))
            _check(saved == (engine.bands, engine.tile_order),
                   f'checkpoint band geometry (bands, tile order) {saved} '
                   f'does not match the engine\'s '
                   f'{(engine.bands, engine.tile_order)}: resume at the '
                   f'rank count that wrote it')

        def t(key):
            return torch.as_tensor(z[key], dtype=torch.float32, device=dev)
        engine.keep_lanes(t('lum'), t('alb'))
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
