"""Camera state persistence in the reference's save.txt format (counterpart
of ``cuda_pathtracer_tpu/scene/state.py``; src/stateLoader.h:30-75).

Files written by the reference, the JAX package or the port load in each of
them unchanged: eye, view direction, screen distance, focal length and
aperture, pipe-separated, 6 significant digits.
"""
from __future__ import annotations

import os

from ..core.camera import Camera, default_camera


def _fmt(x: float) -> str:
    """C++ ostream default formatting (6 significant digits)."""
    return f'{x:.6g}'


def save_state(camera: Camera, path: str = 'save.txt') -> None:
    """src/stateLoader.h:35-49."""
    eye = [float(x) for x in camera.eye]
    view = [float(x) for x in camera.view_dir]
    with open(path, 'w') as f:
        f.write(f'{_fmt(eye[0])}|{_fmt(eye[1])}|{_fmt(eye[2])}\n')
        f.write(f'{_fmt(view[0])}|{_fmt(view[1])}|{_fmt(view[2])}\n')
        f.write(f'{_fmt(float(camera.d))}\n')
        f.write(f'{_fmt(float(camera.focal_length))}\n')
        f.write(f'{_fmt(float(camera.aperture))}\n')


def _parse_float3(line: str):
    return [float(p) for p in line.strip().split('|')]


def read_state(path: str = 'save.txt', device='cuda') -> Camera:
    """src/stateLoader.h:51-75: the camera in ``path`` on ``device``, or the
    default camera when the file is missing or malformed."""
    if not os.path.exists(path):
        return default_camera(device)
    try:
        with open(path) as f:
            lines = f.read().splitlines()
        eye = _parse_float3(lines[0])
        view = _parse_float3(lines[1])
        d = float(lines[2])
        focal = float(lines[3])
        aperture = float(lines[4])
        return Camera.create(eye, view, d, focal, aperture, device=device)
    except (ValueError, IndexError):
        return default_camera(device)
