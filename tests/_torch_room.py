"""A small procedural room shared by the port's parity tests.

``build_room(scene_mod, add_cube)`` builds the same scene through either
package's scene graph (``cuda_pathtracer_tpu.scene.scene`` or
``cuda_pathtracer_tpu_torch.scene.scene``): a textured floor, walls (the
back one normal-mapped), an emissive ceiling quad, a glass sphere, a mirror
sphere, a 12-triangle cube made with ``add_mesh`` and, below the open front,
a checkerboard plane. A few hundred triangles, no files read.

``write_cube_obj(dir)`` writes the ``cube.obj`` that the ``outside`` scene
loads, for tests that build it through both packages.
"""
import numpy as np

CAMERA = dict(eye=[0.0, 1.6, -4.2], view_dir=[0.0, -0.12, 1.0], d=1.5,
              focal_length=5.0, aperture=0.02)


def _grid(origin, du, dv, nu, nv):
    """Quad grid of 2*nu*nv triangles spanning origin + [0,1]^2 (du, dv),
    with per-vertex uvs tiled twice across the grid."""
    o, du, dv = (np.asarray(a, np.float64) for a in (origin, du, dv))
    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    p = o + us[None, :, None] * du + vs[:, None, None] * dv      # [nv+1, nu+1, 3]
    uv = np.stack(np.meshgrid(us * 2.0, vs * 2.0), -1)            # [nv+1, nu+1, 2]
    a, b = p[:-1, :-1].reshape(-1, 3), p[:-1, 1:].reshape(-1, 3)
    c, d = p[1:, :-1].reshape(-1, 3), p[1:, 1:].reshape(-1, 3)
    ta, tb = uv[:-1, :-1].reshape(-1, 2), uv[:-1, 1:].reshape(-1, 2)
    tc, td = uv[1:, :-1].reshape(-1, 2), uv[1:, 1:].reshape(-1, 2)
    v0 = np.concatenate([a, b]); v1 = np.concatenate([b, d])
    v2 = np.concatenate([c, c])
    uv6 = np.concatenate([np.concatenate([ta, tb, tc], 1),
                          np.concatenate([tb, td, tc], 1)])
    return v0, v1, v2, uv6


def build_room(scene_mod, add_cube):
    s = scene_mod.Scene(asset_dirs=['.'])
    M = scene_mod.Material
    floor_mat = M.DIFFUSE((0.8, 0.8, 0.8))
    tex = np.random.RandomState(7).rand(16, 16, 3).astype(np.float32) * 0.8 + 0.2
    floor_mat.texture = s.atlas.add_array(tex)
    floor = s.add_material(floor_mat)
    wall = s.add_material(M.DIFFUSE((0.6, 0.5, 0.4)))
    bumpy = M.DIFFUSE((0.5, 0.6, 0.4))
    nmap = np.random.RandomState(8).rand(8, 8, 3).astype(np.float32) * 0.3 \
        + np.array([0.35, 0.35, 0.7], np.float32)
    bumpy.normal_texture = s.atlas.add_array(nmap)
    back_wall = s.add_material(bumpy)
    light_m = M.DIFFUSE((1, 1, 1))
    light_m.emission = (12.0, 11.0, 10.0)
    light = s.add_material(light_m)
    glass = M.DIFFUSE((1, 1, 1))
    glass.transmit = 1.0
    glass.refractive_index = 1.5
    glass.absorption = (0.1, 0.3, 0.5)
    glass_id = s.add_material(glass)
    mirror = M.DIFFUSE((0.9, 0.9, 0.9))
    mirror.reflect = 1.0
    mirror.glossy = 0.05
    mirror_id = s.add_material(mirror)
    cube_m = M.DIFFUSE((0.3, 0.6, 0.3))
    cube_m.reflect = 0.3
    cube_m.glossy = 0.2
    cube_id = s.add_material(cube_m)

    def mesh(v0, v1, v2, uv6, mat):
        return s.add_mesh(v0.astype(np.float32), v1.astype(np.float32),
                          v2.astype(np.float32), mat, uv=uv6)

    # floor (textured), back / left / right walls, ceiling; every face's
    # geometric normal cross(du, dv) points into the room
    room = [
        (_grid([-3, 0, -2], [0, 0, 6], [6, 0, 0], 8, 8), floor),
        (_grid([-3, 0, 4], [0, 4, 0], [6, 0, 0], 4, 6), back_wall),
        (_grid([-3, 0, -2], [0, 4, 0], [0, 0, 6], 4, 6), wall),
        (_grid([3, 0, -2], [0, 0, 6], [0, 4, 0], 6, 4), wall),
        (_grid([-3, 4, -2], [6, 0, 0], [0, 0, 6], 6, 6), wall),
    ]
    for (v0, v1, v2, uv6), mat in room:
        s.add_object(scene_mod.GameObject(mesh(v0, v1, v2, uv6, mat)))
    lv0, lv1, lv2, luv = _grid([-0.8, 3.95, 1.2], [1.6, 0, 0], [0, 0, 1.6], 1, 1)
    s.add_object(scene_mod.GameObject(
        mesh(lv0, lv1, lv2, luv, light), material_id=light))
    cube = scene_mod.GameObject(add_cube(s, cube_id))
    cube.position[:] = [1.4, 0.5, 2.2]
    cube.rotation[1] = 0.4
    cube.scale[:] = 0.5
    s.add_object(cube)
    s.add_sphere(scene_mod.Sphere((-1.3, 0.8, 2.0), 0.8, glass_id))
    s.add_sphere(scene_mod.Sphere((0.2, 0.6, 3.0), 0.6, mirror_id))
    s.add_plane(scene_mod.Plane((0.0, 1.0, 0.0), 0.05, wall))   # y = -0.05
    s.add_point_light(scene_mod.PointLight((0.0, 3.0, 0.0), (5.0, 5.0, 5.0)))
    s.finalize()
    return s


def write_cube_obj(directory) -> str:
    """Write ``cube.obj`` into ``directory``: the 12 triangles of
    ``scene/builder.py::add_cube``, same vertices and winding, so both
    packages' ``outside`` scene load the same mesh. Returns the directory."""
    c = [(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
    f = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
         (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    lines = [f'v {x} {y} {z}' for x, y, z in c]
    lines += [f'f {a + 1} {b + 1} {d + 1}' for a, b, d in f]
    with open(f'{directory}/cube.obj', 'w') as fh:
        fh.write('\n'.join(lines) + '\n')
    return str(directory)
