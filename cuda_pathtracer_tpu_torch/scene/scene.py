"""Host-side scene graph (counterpart of ``cuda_pathtracer_tpu/scene/scene.py``;
reference Scene, src/scene.h:120-402).

The host build is numpy and the port's own copies of the JAX package's numpy
accel modules (binned-SAH BVH, threaded flattening, world BVH merge, 16-ary
wide collapse); ``to_device(device)`` exports the static SceneArrays and
``dynamic_arrays(device)`` the instance, light, world-triangle and BVH-table
state as tensors on ``device``. Animation handlers run in :meth:`Scene.update`;
after the first full build, an invalidation that only moves objects refits
the tables on the device (``accel/refit.py``) instead of rebuilding them.
"""
from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .device import SceneArrays, DynamicArrays
from .textures import TextureAtlas, load_image
from ..accel import refit as _refit
from ..ops.traverse_packet import split_packet_tables
from ..ops.traverse_packet2 import (build_merged_table, build_refit_maps,
                                    derive_merged, META_BASE_BITS)
from ..accel.bvh import build_bvh
from ..accel.flatten import thread_bvh, ThreadedBVH
from ..accel.toplevel import build_world_bvh
from ..accel.wide import build_wide_bvh, build_world_wide
from ..core import transforms as tf
from ..constants import EPS
from . import objloader
from ..utils.profiling import span

NO_MATERIAL = -1  # the reference's 0xffffffff override marker


@dataclass
class Material:
    """Host material (reference Material, src/types.h:33-56)."""
    diffuse_color: tuple = (1.0, 1.0, 1.0)
    specular_color: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    reflect: float = 0.0
    glossy: float = 0.0
    transmit: float = 0.0
    refractive_index: float = 0.0
    absorption: tuple = (0.0, 0.0, 0.0)
    texture: int = -1         # atlas id, -1 = none
    normal_texture: int = -1

    @staticmethod
    def DIFFUSE(color) -> 'Material':
        return Material(diffuse_color=tuple(float(c) for c in color))


@dataclass
class GameObject:
    """src/types.h:416-429."""
    model_id: int
    kind: int = 0
    material_id: int = NO_MATERIAL
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3))

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float64).copy()
        self.rotation = np.asarray(self.rotation, np.float64).copy()
        self.scale = np.asarray(self.scale, np.float64).copy()


@dataclass
class Sphere:
    pos: tuple
    radius: float
    material: int


@dataclass
class Plane:
    normal: tuple
    d: float
    material: int


@dataclass
class PointLight:
    pos: tuple
    color: tuple


@dataclass
class Model:
    triangle_start: int
    nr_triangles: int
    bvh: ThreadedBVH
    wide: object   # accel.wide.WideBVH, model space


def _i2f(a):
    """int32 values -> the f32 words with the same bits."""
    return np.asarray(a, np.int32).view(np.float32)


class Scene:
    """The scriptable scene container (src/scene.h:120-402)."""

    def __init__(self, asset_dirs=()):
        self.asset_dirs = list(asset_dirs) or ['.']
        self.models: list[Model] = []
        self.objects: list[GameObject] = []
        self.materials: list[Material] = []
        self.spheres: list[Sphere] = []
        self.planes: list[Plane] = []
        self.point_lights: list[PointLight] = []
        self.handlers: list[Callable] = []
        self.atlas = TextureAtlas()
        self.invalid = False
        self.attached = 0
        self.interactive_depth = 1
        self.interactive_samples = 1
        # concatenated triangle data (allVertices / allVertexData)
        self._v0 = np.zeros((0, 3), np.float32)
        self._v1 = np.zeros((0, 3), np.float32)
        self._v2 = np.zeros((0, 3), np.float32)
        self._normal = np.zeros((0, 3), np.float32)
        self._tangent = np.zeros((0, 3), np.float32)
        self._bitangent = np.zeros((0, 3), np.float32)
        self._uv = np.zeros((0, 6), np.float32)
        self._tri_mat = np.zeros((0,), np.int32)
        self._version = 0          # bumped whenever dynamic state changes
        self._dyn_cache = None     # (version, device, DynamicArrays)
        self._full_dyn = None      # the last full build's DynamicArrays
        self._refit_templates = None   # accel/refit.py model-space tables
        self._merged_maps = None   # ops/traverse_packet2.py refit maps
        self._refit_key = None
        self.refits = 0            # device refits taken so far

    # -- scriptable API (sceneBuilder.h:283-301) --

    def add_material(self, material: Material) -> int:
        self.materials.append(material)
        return len(self.materials) - 1

    def add_sphere(self, sphere: Sphere):
        self.spheres.append(sphere)

    def add_plane(self, plane: Plane):
        self.planes.append(plane)

    def add_point_light(self, light: PointLight):
        self.point_lights.append(light)

    def add_object(self, obj: GameObject) -> int:
        self.objects.append(obj)
        return len(self.objects) - 1

    def add_handler(self, handler: Callable):
        """Register ``handler(scene, keyboard, current_time)``, run by
        :meth:`update` every frame (the reference's addHandler)."""
        self.handlers.append(handler)

    addHandler = add_handler

    def invalidate(self):
        self.invalid = True
        self._version += 1

    def _resolve(self, filename: str) -> str:
        if os.path.exists(filename):
            return filename
        for d in self.asset_dirs:
            cand = os.path.join(d, os.path.basename(filename))
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(f'{filename} (searched {self.asset_dirs})')

    def add_model(self, filename: str, scale=1.0, rotation=(0, 0, 0),
                  offset=(0, 0, 0), material: int = 0,
                  use_mtl: bool = False) -> int:
        """Scene::addModel (src/scene.h:159-347): OBJ parse, MTL->Material
        derivation, vertex bake, per-triangle attributes, BVH build."""
        print(f'Loading model {filename}', file=sys.stderr)
        path = self._resolve(filename)
        mesh = objloader.load_obj(path, self.asset_dirs)

        # --- MTL -> Material (src/scene.h:182-247) ---
        n_mtl = max(len(mesh.materials), 1)
        material_ids = np.full(n_mtl, material, np.int32)
        mat_has_nmap = np.zeros(n_mtl, bool)
        mat_uv_offset = np.zeros((n_mtl, 2), np.float32)
        if use_mtl:
            for m_i, mm in enumerate(mesh.materials):
                mat = Material.DIFFUSE((1, 1, 1))
                mat.diffuse_color = tuple(np.clip(mm.diffuse, 0.0, 1.0))
                mat.specular_color = tuple(mm.specular)
                mat.transmit = 1.0 - mm.dissolve
                mat.reflect = float(np.mean(mm.specular))
                mat.glossy = mm.shininess / 4000.0
                s = mat.transmit + mat.reflect
                if s > 1.0:
                    mat.transmit /= s
                    mat.reflect /= s
                if mat.transmit > EPS:   # "make glass white" (scene.h:206-209)
                    mat.diffuse_color = (1.0, 1.0, 1.0)
                mat.refractive_index = mm.ior
                if mm.diffuse_texname:
                    mat.texture = self.atlas.add_path(mm.diffuse_texname,
                                                      self.asset_dirs)
                    mat_uv_offset[m_i] = mm.diffuse_tex_offset
                if mm.normal_texname:
                    mat.normal_texture = self.atlas.add_path(mm.normal_texname,
                                                             self.asset_dirs)
                    mat_has_nmap[m_i] = True
                material_ids[m_i] = self.add_material(mat)

        # --- vectorized per-triangle bake (src/scene.h:259-336) ---
        bake = tf.model_bake(scale, rotation, offset)
        nt = len(mesh.tri_v)
        if nt == 0:
            raise ValueError(f'no triangles in {path}')
        v = mesh.vertices[mesh.tri_v]
        v = tf.transform_points(bake, v.reshape(-1, 3)).reshape(nt, 3, 3)
        v0, v1, v2 = (v[:, 0].astype(np.float32), v[:, 1].astype(np.float32),
                      v[:, 2].astype(np.float32))

        if len(mesh.texcoords) > 0:
            vt = np.maximum(mesh.tri_vt, 0)
            uv = mesh.texcoords[vt]
            uv = np.where((mesh.tri_vt >= 0)[..., None], uv, 0.0)
        else:
            uv = np.zeros((nt, 3, 2), np.float32)

        fmat = np.where(mesh.tri_mat >= 0, mesh.tri_mat, 0)
        if use_mtl:
            # MTL texcoord origin offset (scene.h:275-283)
            uv = uv + mat_uv_offset[fmat][:, None, :]
            tri_materials = np.where(mesh.tri_mat >= 0,
                                     material_ids[fmat], material).astype(np.int32)
        else:
            tri_materials = np.full(nt, material, np.int32)

        # flat normal: vertex 0's normal, geometric fallback (scene.h:293-305)
        e1 = v1 - v0
        e2 = v2 - v0
        geo_n = np.cross(e1, e2)
        geo_n /= np.maximum(np.linalg.norm(geo_n, axis=-1, keepdims=True), 1e-30)
        has_n = np.all(mesh.tri_vn >= 0, axis=1) & (len(mesh.normals) > 0)
        if len(mesh.normals) > 0:
            n0 = mesh.normals[np.maximum(mesh.tri_vn[:, 0], 0)]
        else:
            n0 = geo_n
        normal = np.where(has_n[:, None], n0, geo_n).astype(np.float32)

        # tangent frame for normal-mapped faces (scene.h:308-328)
        tangent = np.zeros((nt, 3), np.float32)
        bitangent = np.zeros((nt, 3), np.float32)
        if use_mtl and mat_has_nmap.any():
            need = mat_has_nmap[fmat] & (mesh.tri_mat >= 0)
            duv1 = uv[:, 1] - uv[:, 0]
            duv2 = uv[:, 2] - uv[:, 0]
            denom = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
            f = 1.0 / np.where(np.abs(denom) < 1e-30, 1.0, denom)
            tg = f[:, None] * (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2)
            bt = f[:, None] * (duv1[:, 0:1] * e2 - duv2[:, 0:1] * e1)
            bad = ~np.isfinite(tg).all(axis=1) | ~np.isfinite(bt).all(axis=1) \
                | (np.abs(denom) < 1e-30)
            # NaN fallback basis (scene.h:321-327)
            w = normal
            helper = np.where((np.abs(w[:, 0]) > 0.1)[:, None],
                              np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
            u_f = np.cross(helper, w)
            u_f /= np.maximum(np.linalg.norm(u_f, axis=1, keepdims=True), 1e-30)
            v_f = np.cross(w, u_f)
            v_f /= np.maximum(np.linalg.norm(v_f, axis=1, keepdims=True), 1e-30)
            tg = np.where(bad[:, None], u_f, tg)
            bt = np.where(bad[:, None], v_f, bt)
            tangent = np.where(need[:, None], tg, 0.0).astype(np.float32)
            bitangent = np.where(need[:, None], bt, 0.0).astype(np.float32)

        return self._append_model(v0, v1, v2, normal, tangent, bitangent,
                                  uv.reshape(nt, 6).astype(np.float32),
                                  tri_materials)

    def add_mesh(self, v0, v1, v2, material: int, normals=None, uv=None) -> int:
        """Register a raw triangle soup as a model (the procedural stand-in
        scenes and the tests; the reference only ingests OBJ files)."""
        nt = len(v0)
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        if normals is None:
            n = np.cross(v1 - v0, v2 - v0)
            normals = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                                     1e-30)
        zeros = np.zeros((nt, 3), np.float32)
        uv6 = np.zeros((nt, 6), np.float32) if uv is None \
            else np.asarray(uv, np.float32).reshape(nt, 6)
        return self._append_model(v0, v1, v2,
                                  np.asarray(normals, np.float32),
                                  zeros, zeros, uv6,
                                  np.full(nt, material, np.int32))

    def _append_model(self, v0, v1, v2, normal, tangent, bitangent,
                      uv6, tri_materials) -> int:
        """BVH over the model's block, permute the block, register the model
        (boot logging as scene.h:338-343)."""
        nt = len(v0)
        print(f'Building a BVH over {nt} triangles', file=sys.stderr)
        with span('scene.models', setup=True) as sp:
            sp.attrs['triangles'] = nt
            t0 = time.perf_counter()
            nodes = build_bvh(v0, v1, v2)
            print(f'Build took {(time.perf_counter() - t0) * 1e3:.3f}ms',
                  file=sys.stderr)
            perm = nodes.perm
            if len(perm) != nt:
                raise ValueError('spatial-split BVHs are not supported by '
                                 'the port')
            start = len(self._v0)
            self._v0 = np.concatenate([self._v0, v0[perm]])
            self._v1 = np.concatenate([self._v1, v1[perm]])
            self._v2 = np.concatenate([self._v2, v2[perm]])
            self._normal = np.concatenate([self._normal, normal[perm]])
            self._tangent = np.concatenate([self._tangent, tangent[perm]])
            self._bitangent = np.concatenate([self._bitangent,
                                              bitangent[perm]])
            self._uv = np.concatenate([self._uv, uv6[perm]])
            self._tri_mat = np.concatenate([self._tri_mat,
                                            tri_materials[perm]])
            wide = build_wide_bvh(nodes, v0[perm], v1[perm], v2[perm])
            self.models.append(Model(start, nt, thread_bvh(nodes), wide))
        return len(self.models) - 1

    def finalize(self):
        if len(self._v0) != len(self._tri_mat):
            raise ValueError('triangle attribute arrays out of step')
        if not self.materials:
            self.add_material(Material.DIFFUSE((0.4, 0.4, 0.4)))
        self._version += 1

    def instances(self):
        """Instance transforms from GameObjects (ConvertToInstance,
        src/scene.h:9-25,364)."""
        n = len(self.objects)
        transforms = np.zeros((n, 3, 4), np.float32)
        inverses = np.zeros((n, 3, 4), np.float32)
        overrides = np.full(n, NO_MATERIAL, np.int32)
        for i, obj in enumerate(self.objects):
            m = tf.object_transform(obj.position, obj.rotation, obj.scale)
            transforms[i] = tf.to_affine34(m)
            inverses[i] = tf.to_affine34(np.linalg.inv(m))
            overrides[i] = obj.material_id
        return transforms, inverses, overrides

    def update(self, keyboard=None, current_time: float = 0.0):
        """Per-frame host dynamics (src/scene.h:367-401): attach/move objects
        with the keyboard, run the animation handlers, mark dynamic state
        dirty. ``keyboard`` answers ``is_pressed(action)`` and
        ``is_down(action)``; None skips the keys."""
        self.invalid = False
        if keyboard is not None:
            for i in range(10):
                if keyboard.is_pressed(f'attach_{i}'):
                    self.attached = i
            if 0 < self.attached <= len(self.objects):
                obj = self.objects[self.attached - 1]
                step = 0.04
                moves = {'move_left': (0, -step), 'move_right': (0, step),
                         'move_forward': (2, step), 'move_backward': (2, -step),
                         'move_up': (1, step), 'move_down': (1, -step)}
                for act, (axis, delta) in moves.items():
                    if keyboard.is_down(act):
                        obj.position[axis] += delta
                        self.invalidate()
                looks = {'look_left': (1, -step), 'look_right': (1, step),
                         'look_up': (0, -step), 'look_down': (0, step)}
                for act, (axis, delta) in looks.items():
                    if keyboard.is_down(act):
                        obj.rotation[axis] += delta
                        self.invalidate()
        for handler in self.handlers:
            handler(self, keyboard, current_time)
        if self.handlers:
            self._version += 1

    # ------------------------------------------------------------------
    # device export

    def extract_triangle_lights(self, overrides: np.ndarray):
        """Emissive-triangle extraction (src/pathtracer.h:154-170)."""
        tris, insts = [], []
        emis = np.array([m.emission for m in self.materials], np.float32) \
            if self.materials else np.zeros((0, 3), np.float32)
        for i, obj in enumerate(self.objects):
            model = self.models[obj.model_id]
            s, c = model.triangle_start, model.nr_triangles
            mat = self._tri_mat[s:s + c]
            if overrides[i] >= 0:
                mat = np.full(c, overrides[i], np.int32)
            idx = np.nonzero(emis[mat].max(axis=1) >= EPS)[0]
            tris.append(idx.astype(np.int32) + s)
            insts.append(np.full(len(idx), i, np.int32))
        if tris:
            return np.concatenate(tris), np.concatenate(insts)
        return np.zeros(0, np.int32), np.zeros(0, np.int32)

    def to_device(self, device, skydome: str | None = None,
                  blue_noise: str | None = None) -> SceneArrays:
        """The static SceneArrays on ``device`` (Pathtracer::Init's upload
        block, src/pathtracer.h:73-221). Span: ``scene.to_device``."""
        with span('scene.to_device', setup=True):
            return self._to_device(device, skydome, blue_noise)

    def _to_device(self, device, skydome, blue_noise) -> SceneArrays:
        mats = self.materials or [Material.DIFFUSE((0.4, 0.4, 0.4))]

        def t(a, dtype=np.float32):
            return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

        def col(f):
            return t([f(m) for m in mats])

        sky = None
        for cand in ([skydome] if skydome else []) + ['cave.hdr', 'skydome.jpg']:
            try:
                sky = load_image(self._resolve(cand))[..., :3]
                break
            except (FileNotFoundError, ValueError):
                continue
        if sky is None:
            sky = np.full((2, 4, 3), 0.5, np.float32)

        bn = None
        for cand in ([blue_noise] if blue_noise else []) + ['bluenoise.png']:
            try:
                bn = load_image(self._resolve(cand))[..., 0]
                break
            except FileNotFoundError:
                continue
        if bn is None:
            bn = np.linspace(0, 1, 64 * 64, dtype=np.float32).reshape(64, 64)

        _, _, overrides = self.instances()
        light_tri, light_inst = self.extract_triangle_lights(overrides)
        sp, pl, pls = self.spheres, self.planes, self.point_lights

        mat_packed = np.zeros((len(mats), 24), np.float32)
        for i, m in enumerate(mats):
            mat_packed[i, 0:3] = m.diffuse_color
            mat_packed[i, 3:6] = m.specular_color
            mat_packed[i, 6:9] = m.emission
            mat_packed[i, 9] = m.reflect
            mat_packed[i, 10] = m.glossy
            mat_packed[i, 11] = m.transmit
            mat_packed[i, 12] = m.refractive_index
            mat_packed[i, 13:16] = m.absorption
            mat_packed[i, 16] = _i2f([m.texture])[0]
            mat_packed[i, 17] = _i2f([m.normal_texture])[0]

        tri_packed = np.zeros((len(self._tri_mat), 16), np.float32)
        tri_packed[:, 0:3] = self._normal
        tri_packed[:, 3:6] = self._tangent
        tri_packed[:, 6:9] = self._bitangent
        tri_packed[:, 9:15] = self._uv
        tri_packed[:, 15] = _i2f(self._tri_mat)

        sphere_packed = np.zeros((len(sp), 8), np.float32)
        for i, s in enumerate(sp):
            sphere_packed[i, 0:3] = s.pos
            sphere_packed[i, 3] = s.radius
            sphere_packed[i, 4] = _i2f([s.material])[0]
        plane_packed = np.zeros((len(pl), 8), np.float32)
        for i, p in enumerate(pl):
            plane_packed[i, 0:3] = p.normal
            plane_packed[i, 3] = p.d
            plane_packed[i, 4] = _i2f([p.material])[0]

        return SceneArrays(
            tri_normal=t(self._normal),
            tri_tangent=t(self._tangent),
            tri_bitangent=t(self._bitangent),
            tri_uv=t(self._uv),
            tri_mat=t(self._tri_mat, np.int32),
            mat_diffuse=col(lambda m: m.diffuse_color),
            mat_specular=col(lambda m: m.specular_color),
            mat_emission=col(lambda m: m.emission),
            mat_reflect=col(lambda m: m.reflect),
            mat_glossy=col(lambda m: m.glossy),
            mat_transmit=col(lambda m: m.transmit),
            mat_ior=col(lambda m: m.refractive_index),
            mat_absorption=col(lambda m: m.absorption),
            mat_tex=t([m.texture for m in mats], np.int32),
            mat_normal_tex=t([m.normal_texture for m in mats], np.int32),
            textures=self.atlas.build(device),
            sphere_pos=t(np.reshape([s.pos for s in sp], (-1, 3))),
            sphere_radius=t([s.radius for s in sp]),
            sphere_mat=t([s.material for s in sp], np.int32),
            plane_normal=t(np.reshape([p.normal for p in pl], (-1, 3))),
            plane_d=t([p.d for p in pl]),
            plane_mat=t([p.material for p in pl], np.int32),
            point_light_pos=t(np.reshape([x.pos for x in pls], (-1, 3))),
            point_light_color=t(np.reshape([x.color for x in pls], (-1, 3))),
            light_tri=t(light_tri, np.int32),
            light_inst=t(light_inst, np.int32),
            sky_img=t(sky),
            blue_noise=t(bn),
            mat_packed=t(mat_packed),
            tri_packed=t(tri_packed),
            sphere_packed=t(sphere_packed),
            plane_packed=t(plane_packed))

    def _structure_key(self):
        """Scene topology fingerprint: while unchanged, invalidations can use
        the device refit instead of a full host rebuild."""
        return (len(self.models),
                tuple(o.model_id for o in self.objects),
                tuple(int(o.material_id) for o in self.objects))

    def dynamic_arrays(self, device) -> DynamicArrays:
        """Instances, world-space lights, world triangles and the BVH tables
        on ``device``, cached until the next invalidation (the counterpart of
        the JAX package's ``Scene.dynamic_arrays``). After the first full
        build, invalidations that only move things (animation handlers,
        attached-object motion) refit on the device (accel/refit.py)."""
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            # the tensors report 'cuda:N'; compare like with like
            device = torch.device('cuda', torch.cuda.current_device())
        if (self._dyn_cache is not None and self._dyn_cache[0] == self._version
                and self._dyn_cache[1] == device):
            return self._dyn_cache[2]
        if (self._refit_templates is not None
                and self._refit_key == self._structure_key()
                and self._refit_templates.inner.device == device):
            dyn = self._refit_dynamic_arrays()
            self._dyn_cache = (self._version, device, dyn)
            return dyn
        if not self.objects:
            raise ValueError('the scene has no objects to trace')
        # the world BVH, its wide and packet tables, refit maps and
        # templates: the host build a native rewrite would move
        with span('scene.world', setup=True):
            transforms, inverses, overrides = self.instances()
            inst_model = np.array([o.model_id for o in self.objects], np.int32)
            wb = build_world_bvh(
                [m.bvh for m in self.models],
                [m.triangle_start for m in self.models],
                [m.nr_triangles for m in self.models],
                self._v0, self._v1, self._v2, inst_model, transforms)
            lv0, lv1, lv2, lnrm, lemis, light_packed = \
                self._light_arrays(transforms, overrides)
            wtri_bases = [int(b) for b in wb.wtri_base]
            ww = build_world_wide([m.wide for m in self.models], inst_model,
                                  transforms, wtri_bases)
            ptab = split_packet_tables(ww.rows, ww.depth, device)
            if len(ww.rows) < (1 << META_BASE_BITS):   # the 20-bit child base
                merged = build_merged_table(ww.rows, ww.depth).rows
                # static maps so device refits can re-derive the merged table
                # from the refitted split tables
                self._merged_maps = build_refit_maps(ww.rows, device)
            else:
                merged = np.zeros((0, 128), np.float32)
                self._merged_maps = None
            # the model-space templates of later move-only refits
            self._refit_templates = _refit.build_templates(
                [m.wide for m in self.models], inst_model, wtri_bases, wb,
                self._v0, self._v1, self._v2, ww.depth, device)
            self._refit_key = self._structure_key()

            def t(a, dtype=np.float32):
                return torch.as_tensor(np.ascontiguousarray(a, dtype),
                                       device=device)
            dyn = DynamicArrays(
                inst_transform=t(transforms), inst_inv=t(inverses),
                inst_mat=t(overrides, np.int32),
                light_v0w=t(lv0), light_v1w=t(lv1), light_v2w=t(lv2),
                light_normal_w=t(lnrm), light_emission_w=t(lemis),
                light_packed=t(light_packed),
                inst_packed=t(self._inst_packed(transforms, overrides)),
                tri_gid=t(wb.tri_gid, np.int32),
                tri_inst=t(wb.tri_inst, np.int32),
                world_tris=t(np.concatenate([wb.tri_v0, wb.tri_v1, wb.tri_v2],
                                            axis=1)),
                packet_inner=ptab.inner, packet_leaf=ptab.leaf,
                packet_merged=t(merged), depth=int(ww.depth))
        self._dyn_cache = (self._version, device, dyn)
        self._full_dyn = dyn
        return dyn

    def _refit_dynamic_arrays(self) -> DynamicArrays:
        """Move-only invalidation: instance matrices and the top rows on the
        host, the tables and world triangles transformed on the device. The
        world-triangle numbering (``tri_gid``, ``tri_inst``, the order of
        ``world_tris``) stays the full build's."""
        transforms, inverses, overrides = self.instances()
        inst_boxes = np.empty((len(self.objects), 6), np.float32)
        for i, o in enumerate(self.objects):
            mb = self.models[o.model_id].bvh
            mn, mx = tf.transform_box(mb.vmin[0], mb.vmax[0], transforms[i])
            inst_boxes[i, 0:3] = mn
            inst_boxes[i, 3:6] = mx
        inner, leaf, wtris = _refit.refit_all(self._refit_templates,
                                              transforms, inst_boxes)
        lv0, lv1, lv2, lnrm, lemis, light_packed = \
            self._light_arrays(transforms, overrides)
        base = self._full_dyn
        dev = inner.device

        def t(a, dtype=np.float32):
            return torch.as_tensor(np.ascontiguousarray(a, dtype), device=dev)
        self.refits += 1
        return base._replace(
            inst_transform=t(transforms), inst_inv=t(inverses),
            inst_mat=t(overrides, np.int32),
            light_v0w=t(lv0), light_v1w=t(lv1), light_v2w=t(lv2),
            light_normal_w=t(lnrm), light_emission_w=t(lemis),
            light_packed=t(light_packed),
            inst_packed=t(self._inst_packed(transforms, overrides)),
            world_tris=wtris, packet_inner=inner, packet_leaf=leaf,
            packet_merged=(derive_merged(inner, leaf, self._merged_maps)
                           if self._merged_maps is not None
                           else base.packet_merged))

    @staticmethod
    def _inst_packed(transforms, overrides):
        inst_packed = np.zeros((len(transforms), 16), np.float32)
        inst_packed[:, 0:12] = transforms.reshape(-1, 12)
        inst_packed[:, 12] = _i2f(overrides)
        return inst_packed

    def _light_arrays(self, transforms, overrides):
        """World-space emissive light triangles (the DTriangleLights of
        pathtracer.h:154-170, pre-transformed)."""
        light_tri, light_inst = self.extract_triangle_lights(overrides)
        if len(light_tri):
            lt = transforms[light_inst]
            rot, trn = lt[:, :, :3], lt[:, :, 3]
            lv0 = np.einsum('lij,lj->li', rot, self._v0[light_tri]) + trn
            lv1 = np.einsum('lij,lj->li', rot, self._v1[light_tri]) + trn
            lv2 = np.einsum('lij,lj->li', rot, self._v2[light_tri]) + trn
            lnrm = np.einsum('lij,lj->li', rot, self._normal[light_tri])
            lnrm /= np.maximum(np.linalg.norm(lnrm, axis=1, keepdims=True),
                               1e-30)
            lmat = np.where(overrides[light_inst] >= 0, overrides[light_inst],
                            self._tri_mat[light_tri])
            emis = np.array([m.emission for m in self.materials], np.float32)
            lemis = emis[lmat]
        else:
            lv0 = lv1 = lv2 = lnrm = lemis = np.zeros((0, 3), np.float32)
        light_packed = np.zeros((len(lv0), 16), np.float32)
        if len(lv0):
            light_packed[:, 0:3] = lv0
            light_packed[:, 3:6] = lv1
            light_packed[:, 6:9] = lv2
            light_packed[:, 9:12] = lnrm
            light_packed[:, 12:15] = lemis
        return lv0, lv1, lv2, lnrm, lemis, light_packed
