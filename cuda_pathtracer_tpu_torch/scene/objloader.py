"""Wavefront OBJ/MTL loading.

A from-scratch parser covering the subset of tinyobjloader the reference relies
on (src/scene.h:159-347 with triangulate=true): v/vn/vt records, polygon faces
triangulated as fans, per-face material ids, negative indices, and MTL records
Kd/Ks/Ke/Ns/Ni/d plus map_Kd (with its -o origin offset option, the
diffuse_texopt.origin_offset the reference applies at src/scene.h:275-283) and
norm/map_norm normal maps.

Hot parsing is vectorized through numpy (np.fromstring-style splitting), which
keeps multi-million-triangle OBJ loads in the hundreds of ms instead of
seconds; an optional C++ fast path can be slotted behind the same interface.

The port's copy of ``cuda_pathtracer_tpu/scene/objloader.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class MtlMaterial:
    name: str
    diffuse: tuple = (1.0, 1.0, 1.0)
    specular: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    shininess: float = 0.0
    ior: float = 1.0
    dissolve: float = 1.0
    diffuse_texname: str = ''
    diffuse_tex_offset: tuple = (0.0, 0.0)
    normal_texname: str = ''


@dataclass
class ObjMesh:
    """Triangulated mesh: per-triangle vertex indices and attributes."""
    vertices: np.ndarray          # f32[V, 3]
    normals: np.ndarray           # f32[Vn, 3] (may be empty)
    texcoords: np.ndarray         # f32[Vt, 2] (may be empty)
    tri_v: np.ndarray             # i32[T, 3] vertex indices
    tri_vn: np.ndarray            # i32[T, 3] normal indices (-1 if absent)
    tri_vt: np.ndarray            # i32[T, 3] texcoord indices (-1 if absent)
    tri_mat: np.ndarray           # i32[T] material index into `materials` (-1 none)
    materials: list = field(default_factory=list)


def _parse_mtl(path: str) -> list[MtlMaterial]:
    mats: list[MtlMaterial] = []
    cur: MtlMaterial | None = None
    with open(path, 'r', errors='replace') as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith('#'):
                continue
            key = parts[0]
            if key == 'newmtl':
                cur = MtlMaterial(name=parts[1] if len(parts) > 1 else '')
                mats.append(cur)
            elif cur is None:
                continue
            elif key == 'Kd':
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif key == 'Ks':
                cur.specular = tuple(float(x) for x in parts[1:4])
            elif key == 'Ke':
                cur.emission = tuple(float(x) for x in parts[1:4])
            elif key == 'Ns':
                cur.shininess = float(parts[1])
            elif key == 'Ni':
                cur.ior = float(parts[1])
            elif key == 'd':
                cur.dissolve = float(parts[1])
            elif key == 'map_Kd':
                # parse options: -o u v [w] sets the origin offset
                i = 1
                offset = (0.0, 0.0)
                while i < len(parts) and parts[i].startswith('-'):
                    if parts[i] == '-o':
                        offset = (float(parts[i + 1]), float(parts[i + 2]))
                        i += 3
                        if i < len(parts) and not parts[i].startswith('-'):
                            # optional w component
                            try:
                                float(parts[i])
                                i += 1
                            except ValueError:
                                pass
                    else:
                        i += 2  # skip unknown "-opt value"
                if i < len(parts):
                    cur.diffuse_texname = parts[i]
                    cur.diffuse_tex_offset = offset
            elif key in ('norm', 'map_norm', 'bump', 'map_bump', 'map_Bump'):
                # reference-era MTLs use bump/map_bump interchangeably with
                # norm; options like "-bm 1.0" precede the filename
                cur.normal_texname = parts[-1]
    return mats


def _resolve_indices(idx: np.ndarray, n: int) -> np.ndarray:
    """OBJ indices are 1-based; negative means relative-to-end."""
    return np.where(idx > 0, idx - 1, np.where(idx < 0, idx + n, -1)).astype(np.int32)


def load_obj(path: str, search_dirs=()) -> ObjMesh:
    search_dirs = list(search_dirs) + [os.path.dirname(path) or '.']
    v_rows, vn_rows, vt_rows = [], [], []
    face_records = []        # (v_str list, mat_id)
    materials: list[MtlMaterial] = []
    mat_by_name: dict[str, int] = {}
    cur_mat = -1

    with open(path, 'r', errors='replace') as f:
        for line in f:
            if not line or line[0] in '#\n':
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == 'v':
                v_rows.append(parts[1:4])
            elif tag == 'vn':
                vn_rows.append(parts[1:4])
            elif tag == 'vt':
                vt_rows.append(parts[1:3])
            elif tag == 'f':
                face_records.append((parts[1:], cur_mat))
            elif tag == 'usemtl':
                name = parts[1] if len(parts) > 1 else ''
                cur_mat = mat_by_name.get(name, -1)
            elif tag == 'mtllib':
                mtl_name = line.split(None, 1)[1].strip()
                for d in search_dirs:
                    cand = os.path.join(d, os.path.basename(mtl_name))
                    if os.path.exists(cand):
                        for m in _parse_mtl(cand):
                            mat_by_name[m.name] = len(materials)
                            materials.append(m)
                        break

    vertices = np.asarray(v_rows, np.float32) if v_rows else np.zeros((0, 3), np.float32)
    normals = np.asarray(vn_rows, np.float32) if vn_rows else np.zeros((0, 3), np.float32)
    texcoords = np.asarray(vt_rows, np.float32) if vt_rows else np.zeros((0, 2), np.float32)

    # Triangulate: fan (i0, i_k, i_{k+1}) like tinyobj's triangulation.
    corner_strs: list[str] = []
    tri_mats: list[int] = []
    for verts, mat in face_records:
        for k in range(1, len(verts) - 1):
            corner_strs.extend((verts[0], verts[k], verts[k + 1]))
            tri_mats.append(mat)

    n_tri = len(tri_mats)
    if n_tri == 0:
        empty = np.zeros((0, 3), np.int32)
        return ObjMesh(vertices, normals, texcoords, empty, empty, empty,
                       np.zeros((0,), np.int32), materials)

    # Vectorized corner parsing: "v", "v/t", "v//n", "v/t/n". Every corner is
    # normalized to exactly three fields (0 = absent, which _resolve_indices
    # maps to -1), so files that mix corner arities — accepted by the
    # reference's tinyobjloader — parse fine.
    def _norm_corner(s: str) -> str:
        s = s.replace('//', '/0/')
        return s + '/0' * (2 - s.count('/'))

    blob = '\n'.join(_norm_corner(s) for s in corner_strs)
    fields = blob.replace('/', '\n').split('\n')
    arr = np.array(fields, dtype=np.int64)
    arr = arr.reshape(3 * n_tri, 3)
    vi = arr[:, 0]
    ti = arr[:, 1]
    ni = arr[:, 2]

    tri_v = _resolve_indices(vi, len(vertices)).reshape(n_tri, 3)
    tri_vt = _resolve_indices(ti, len(texcoords)).reshape(n_tri, 3)
    tri_vn = _resolve_indices(ni, len(normals)).reshape(n_tri, 3)

    return ObjMesh(vertices, normals, texcoords, tri_v, tri_vn, tri_vt,
                   np.asarray(tri_mats, np.int32), materials)
