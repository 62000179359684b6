"""Built-in scenes (counterpart of ``cuda_pathtracer_tpu/scene/builder.py``;
src/sceneBuilder.h:15-323): the four built-in scenes (``outside``,
``sibenik``, ``minecraft``, ``2mtris``) and, for any other name, the
``.chai`` scene script of that path (``scene/chai.py``).

Assets the repository does not ship degrade to procedural stand-ins of the
same scale (``scene/procedural.py``). The one deviation from the JAX
builder: ``cube.obj`` also falls back, to the 12-triangle cube of
:func:`add_cube`, so both scenes build without it (``outside``'s glass
cubes; sibenik's emissive light, which NEE samples).
"""
from __future__ import annotations

import math

import numpy as np

from .scene import Scene, Material, GameObject, Sphere, Plane, PointLight
from . import procedural


def _try_model(scene: Scene, filename, *args, fallback=None, **kwargs):
    try:
        return scene.add_model(filename, *args, **kwargs)
    except FileNotFoundError:
        if fallback is None:
            raise
        return fallback(scene)


def add_cube(scene, material: int) -> int:
    """Add the stand-in for ``cube.obj`` through ``scene.add_mesh``: an
    axis-aligned cube spanning [-1, 1] on every axis (edge 2, centred on the
    model origin), 12 triangles, faces wound so that cross(v1-v0, v2-v0)
    points outward. Works with either package's Scene."""
    c = np.array([[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                  for z in (-1.0, 1.0)], np.float32)
    f = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
                  (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
                  (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)])
    return scene.add_mesh(c[f[:, 0]], c[f[:, 1]], c[f[:, 2]], material)


def get_outside_scene(asset_dirs=()) -> Scene:
    """src/sceneBuilder.h:15-117: 10 animated glass cubes on a circle, a
    checkerboard plane, three point lights. The cubes are ``cube.obj``,
    or :func:`add_cube` when the file is not on the asset path."""
    scene = Scene(asset_dirs=asset_dirs)
    scene.interactive_depth = 5
    scene.interactive_samples = 3

    white_id = scene.add_material(Material.DIFFUSE((0.4,) * 3))

    cube_mat = Material.DIFFUSE((1, 1, 1))
    cube_mat.transmit = 1.0
    cube_mat.refractive_index = 1.1
    cube_mat.glossy = 0.02
    cube_mat.absorption = (0.1, 0.5, 0.8)
    cube_mat_id = scene.add_material(cube_mat)

    # the additional materials the reference registers (kept for script parity)
    scene.add_material(Material.DIFFUSE((0.8,) * 3))            # sibenikMat
    teapot_mat = Material.DIFFUSE((1, 1, 1))
    teapot_mat.reflect = 0.6
    teapot_mat.glossy = 0.08
    scene.add_material(teapot_mat)

    cube_model = _try_model(scene, 'cube.obj', 1, (0, 0, 0), (0, 0, 0),
                            cube_mat_id,
                            fallback=lambda s: add_cube(s, cube_mat_id))
    for i in range(10):
        cube = GameObject(cube_model)
        cube.kind = 1
        cube.position[0] = 10 * math.sin(i * 2 * 3.1415926)
        cube.position[2] = 10 * math.cos(i * 2 * 3.1415926)
        cube.rotation[0] = i * 3.1415926
        scene.add_object(cube)

    def animate(s: Scene, keyboard, t):
        """The circle animation handler (sceneBuilder.h:89-100)."""
        f = 0.0
        for obj in s.objects:
            if obj.kind != 1:
                continue
            obj.position[0] = 10 * math.sin(f + t / 10.0)
            obj.position[2] = 10 * math.cos(f + t / 10.0)
            obj.rotation[0] = f
            f += 2 * 0.3141592
        s.invalidate()

    scene.add_handler(animate)
    scene.add_plane(Plane((0, -1, 0), -3, white_id))
    scene.add_point_light(PointLight((-8, 5, 1), (50, 50, 50)))
    scene.add_point_light(PointLight((-8, 5, -5), (50, 0, 0)))
    scene.add_point_light(PointLight((-8, 5, 5), (0, 50, 0)))
    scene.finalize()
    return scene


def get_sibenik_scene(asset_dirs=()) -> Scene:
    """src/sceneBuilder.h:119-218: the cathedral with an emissive cube light,
    a gold lucy, and two spheres."""
    scene = Scene(asset_dirs=asset_dirs)

    scene.add_material(Material.DIFFUSE((0.4,) * 3))
    cube_mat = Material.DIFFUSE((1, 1, 1))
    cube_mat.transmit = 1.0
    cube_mat.refractive_index = 1.1
    cube_mat.glossy = 0.02
    cube_mat.absorption = (0.1, 0.5, 0.8)
    cube_mat.emission = (10.0, 10.0, 10.0)
    cube_mat_w = scene.add_material(cube_mat)

    sibenik_mat = scene.add_material(Material.DIFFUSE((0.2,) * 3))

    lucy_mat = Material.DIFFUSE((0.98, 0.745, 0.02))
    lucy_mat.reflect = 0.7
    lucy_mat.glossy = 0.08
    lucy_id = scene.add_material(lucy_mat)

    white_glass = Material.DIFFUSE((1, 1, 1))
    white_glass.transmit = 1.0
    white_glass.refractive_index = 1.5
    white_glass_id = scene.add_material(white_glass)

    mirror = Material.DIFFUSE((1, 1, 1))
    mirror.refractive_index = 1.4
    mirror.reflect = 1.0
    mirror_id = scene.add_material(mirror)

    sibenik_model = _try_model(
        scene, 'sibenik.obj', 1, (0, 0, 0), (0, 0, 0), sibenik_mat, use_mtl=True,
        fallback=lambda s: procedural.add_cathedral(s, sibenik_mat))
    sibenik_obj = GameObject(sibenik_model)
    sibenik_obj.position[1] = 12
    scene.add_object(sibenik_obj)

    lucy_model = _try_model(
        scene, 'lucy.obj', 0.005, (-3.1415926 / 2, 0, 3.1415926 / 2),
        (3, 0, 4.0), lucy_id,
        fallback=lambda s: procedural.add_statue(s, lucy_id))
    scene.add_object(GameObject(lucy_model))

    cube_model = _try_model(
        scene, 'cube.obj', 1.0, (0, 0, 0), (0, 0, 0), cube_mat_w,
        fallback=lambda s: add_cube(s, cube_mat_w))
    cube_obj = GameObject(cube_model, material_id=cube_mat_w)
    cube_obj.position[:] = [0, 3, 0]
    cube_obj.kind = 5
    scene.add_object(cube_obj)

    scene.add_sphere(Sphere((-2, -1, -3), 2, white_glass_id))
    scene.add_sphere(Sphere((-2, -1, 3), 2, mirror_id))
    scene.add_point_light(PointLight((-8, 5, 1), (150, 150, 150)))
    scene.finalize()
    return scene


def get_minecraft_scene(asset_dirs=()) -> Scene:
    """src/sceneBuilder.h:220-239: the vokselia_spawn voxel world, or the
    procedural height field of cubes of :func:`procedural.add_voxel_world`."""
    scene = Scene(asset_dirs=asset_dirs)
    white_id = scene.add_material(Material.DIFFUSE((0.4,) * 3))
    model = _try_model(
        scene, 'vokselia_spawn.obj', 20.0, (0, 0, 0), (0, 0, 0), white_id,
        use_mtl=True,
        fallback=lambda s: procedural.add_voxel_world(s, white_id))
    scene.add_object(GameObject(model))
    scene.add_point_light(PointLight((-8, 5, 1), (150, 150, 150)))
    scene.finalize()
    return scene


def get_2million_scene(asset_dirs=()) -> Scene:
    """src/sceneBuilder.h:241-261: the ~2M-triangle BVH stress scene, or the
    procedural statue of :func:`procedural.add_high_poly_statue`."""
    scene = Scene(asset_dirs=asset_dirs)
    white_id = scene.add_material(Material.DIFFUSE((0.4,) * 3))
    model = _try_model(
        scene, '2Mtris.obj', 0.2, (0, 0, 0), (0, 0, 0), white_id,
        fallback=lambda s: procedural.add_high_poly_statue(s, white_id,
                                                           target_tris=2_000_000))
    obj = GameObject(model)
    obj.rotation[0] = -3.1415926535 / 2
    scene.add_object(obj)
    scene.add_point_light(PointLight((-8, 5, 1), (150, 150, 150)))
    scene.finalize()
    return scene


def get_scene(name: str, asset_dirs=()) -> Scene:
    """Scene dispatch (src/sceneBuilder.h:308-323); any other name is the
    path of a ``.chai`` scene script."""
    builders = {
        'outside': get_outside_scene,
        'sibenik': get_sibenik_scene,
        'minecraft': get_minecraft_scene,
        '2mtris': get_2million_scene,
    }
    if name in builders:
        return builders[name](asset_dirs=asset_dirs)
    from .chai import get_scripted_scene
    return get_scripted_scene(name, asset_dirs=asset_dirs)
