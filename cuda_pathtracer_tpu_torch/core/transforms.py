"""Host-side affine transform helpers (numpy).

Replaces the reference's GLM / linmath usage (src/scene.h:9-25, src/vec.h:173-198)
with plain 4x4 numpy matrices. Device code only ever sees the derived [3, 4]
affine matrices (the reference's mat4x3, src/types.h:385-406).

The port's copy of ``cuda_pathtracer_tpu/core/transforms.py``.
"""
from __future__ import annotations

import numpy as np


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def scaling(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, np.float64), (3,))
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def axis_rotations(rx, ry, rz) -> np.ndarray:
    """Rx * Ry * Rz, the order used by the OBJ bake (src/vec.h:187-197) and by
    ConvertToInstance's successive glm::rotate calls (src/scene.h:12-15)."""
    return rot_x(rx) @ rot_y(ry) @ rot_z(rz)


def model_bake(scale, rotation, offset) -> np.ndarray:
    """The vertex-bake transform of Scene::addModel (src/scene.h:176):
    T(offset) * S(scale) * Rx*Ry*Rz."""
    return translation(offset) @ scaling(scale) @ axis_rotations(*rotation)


def object_transform(position, rotation, scale) -> np.ndarray:
    """ConvertToInstance (src/scene.h:9-25): T * Rx * Ry * Rz * S."""
    return (translation(position) @ axis_rotations(*rotation) @ scaling(scale))


def to_affine34(m: np.ndarray) -> np.ndarray:
    """4x4 -> [3,4] float32 affine (the device-side mat4x3)."""
    return np.asarray(m[:3, :], np.float32)


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 (or [3,4]) to an [N,3] array of points."""
    m = np.asarray(m, np.float64)
    return pts @ m[:3, :3].T + m[:3, 3]


def transform_box(vmin, vmax, m) -> tuple[np.ndarray, np.ndarray]:
    """Conservative AABB of a transformed AABB via its 8 corners — the
    reference's transformBox (src/scene.h:27-47)."""
    vmin = np.asarray(vmin, np.float64)
    vmax = np.asarray(vmax, np.float64)
    corners = np.array([[vmin[0], vmin[1], vmin[2]],
                        [vmax[0], vmin[1], vmin[2]],
                        [vmin[0], vmax[1], vmin[2]],
                        [vmin[0], vmin[1], vmax[2]],
                        [vmax[0], vmax[1], vmax[2]],
                        [vmin[0], vmax[1], vmax[2]],
                        [vmax[0], vmin[1], vmax[2]],
                        [vmax[0], vmax[1], vmin[2]]])
    w = transform_points(m, corners)
    return w.min(axis=0), w.max(axis=0)
