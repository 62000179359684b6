"""The reference's scenes: what src/sceneBuilder.h puts in each, as flat
world-space arrays. The OBJ assets are not in the repository, so the meshes
are the stand-ins of ``procedural.py`` (and a 12-triangle cube for
``cube.obj``), as the configurations list under ``reduced``.

A scene is a :class:`SceneData`: triangles in world space (each object's
model triangles through its transform ``T * Rx * Ry * Rz * S``, rounded to
f32), a geometric normal and a material per triangle (the object's material
when it sets one), spheres, planes, point lights and the material table.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from . import procedural


@dataclass
class Material:
    diffuse: tuple = (1.0, 1.0, 1.0)
    reflect: float = 0.0
    transmit: float = 0.0
    ior: float = 0.0
    absorption: tuple = (0.0, 0.0, 0.0)
    texture: int = -1     # set by the stand-in generator; Whitted reads none


class _Atlas:
    """Takes the stand-in's texture and hands out an id (nothing reads it)."""

    def __init__(self):
        self.n = 0

    def add_array(self, _image) -> int:
        self.n += 1
        return self.n - 1


def _rotations(rx, ry, rz) -> np.ndarray:
    cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry),
                              math.sin(ry), math.cos(rz), math.sin(rz))
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mx @ my @ mz


@dataclass
class SceneData:
    materials: list = field(default_factory=list)
    models: list = field(default_factory=list)      # (v0, v1, v2, normal, mat)
    objects: list = field(default_factory=list)     # (model, pos, rot, scale, mat)
    spheres: list = field(default_factory=list)     # (centre, radius, mat)
    planes: list = field(default_factory=list)      # (normal, d, mat)
    lights: list = field(default_factory=list)      # (position, colour)
    atlas: _Atlas = field(default_factory=_Atlas)

    def add_material(self, m: Material) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_mesh(self, v0, v1, v2, material: int, normals=None, uv=None) -> int:
        """A model from a triangle soup; the normal is the face's,
        cross(v1 - v0, v2 - v0) normalised."""
        v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
        n = np.cross(v1 - v0, v2 - v0)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        self.models.append((v0, v1, v2, n.astype(np.float32),
                            np.full(len(v0), material, np.int64)))
        return len(self.models) - 1

    def add_object(self, model: int, position=(0, 0, 0), rotation=(0, 0, 0),
                   scale=(1, 1, 1), material: int = -1):
        self.objects.append((model, position, rotation, scale, material))

    def world(self):
        """(v0, v1, v2, normal, material) of every object's triangles, in
        world space, object after object."""
        out = [[] for _ in range(5)]
        for model, pos, rot, scale, mat in self.objects:
            v0, v1, v2, n, tm = self.models[model]
            lin = _rotations(*rot) @ np.diag(np.asarray(scale, np.float64))
            m = np.concatenate([lin, np.asarray(pos, np.float64)[:, None]], 1)
            m = m.astype(np.float32).astype(np.float64)   # the f32 mat4x3
            for k, v in enumerate((v0, v1, v2)):
                out[k].append((v.astype(np.float64) @ m[:, :3].T
                               + m[:, 3]).astype(np.float32))
            wn = n.astype(np.float64) @ m[:, :3].T
            wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-12)
            out[3].append(wn.astype(np.float32))
            out[4].append(tm if mat < 0 else np.full_like(tm, mat))
        return tuple(np.concatenate(a) for a in out)

    def to_device(self, device) -> dict:
        """The arrays the tracer reads, on ``device``."""
        v0, v1, v2, n, tm = self.world()

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        mats = self.materials
        out = dict(
            v0=t(v0), v1=t(v1), v2=t(v2), normal=t(n),
            tri_mat=t(tm, torch.int64),
            diffuse=t([m.diffuse for m in mats]),
            reflect=t([m.reflect for m in mats]),
            transmit=t([m.transmit for m in mats]),
            ior=t([m.ior for m in mats]),
            absorption=t([m.absorption for m in mats]),
            sphere_pos=t(np.zeros((0, 3)) if not self.spheres
                         else [s[0] for s in self.spheres]),
            sphere_radius=t([s[1] for s in self.spheres]),
            sphere_mat=t([s[2] for s in self.spheres], torch.int64),
            plane_normal=t(np.zeros((0, 3)) if not self.planes
                           else [p[0] for p in self.planes]),
            plane_d=t([p[1] for p in self.planes]),
            plane_mat=t([p[2] for p in self.planes], torch.int64),
            light_pos=t([l[0] for l in self.lights]),
            light_color=t([l[1] for l in self.lights]))
        return out


def _cube(scene: SceneData, material: int) -> int:
    """``cube.obj``'s stand-in: the unit cube [-1, 1]^3, 12 triangles
    wound outward."""
    c = np.array([[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                  for z in (-1.0, 1.0)], np.float32)
    f = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
                  (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
                  (1, 5, 7), (1, 7, 3)])
    return scene.add_mesh(c[f[:, 0]], c[f[:, 1]], c[f[:, 2]], material)


def sibenik() -> SceneData:
    """src/sceneBuilder.h:119-218: the cathedral lifted by 12, lucy, an
    emissive glass cube at (0, 3, 0), a glass and a mirror sphere of radius
    2, one point light of 150."""
    s = SceneData()
    s.add_material(Material((0.4, 0.4, 0.4)))
    cube = s.add_material(Material((1, 1, 1), transmit=1.0, ior=1.1,
                                   absorption=(0.1, 0.5, 0.8)))
    stone = s.add_material(Material((0.2, 0.2, 0.2)))
    gold = s.add_material(Material((0.98, 0.745, 0.02), reflect=0.7))
    glass = s.add_material(Material((1, 1, 1), transmit=1.0, ior=1.5))
    mirror = s.add_material(Material((1, 1, 1), reflect=1.0, ior=1.4))
    s.add_object(procedural.add_cathedral(s, stone), position=(0, 12, 0))
    s.add_object(procedural.add_statue(s, gold))
    s.add_object(_cube(s, cube), position=(0, 3, 0), material=cube)
    s.spheres += [((-2, -1, -3), 2.0, glass), ((-2, -1, 3), 2.0, mirror)]
    s.lights.append(((-8, 5, 1), (150, 150, 150)))
    return s


SCENES = {'sibenik': sibenik}


def get(name: str) -> SceneData:
    if name not in SCENES:
        raise ValueError(f'the reference has no scene {name!r} '
                         f'(has: {", ".join(sorted(SCENES))})')
    return SCENES[name]()
