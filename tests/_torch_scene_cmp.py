"""Comparisons of one scene built by both packages, shared by the port's
scene tests.

``same_graph(jscene, tscene)``: the host scene graphs hold the same
materials, objects (model, kind, material override, position, rotation,
scale), spheres, planes, point lights and models, and the same triangles
bit for bit.

``same_device_arrays(jscene, tscene)``: ``Scene.to_device`` and
``Scene.dynamic_arrays`` leaf by leaf (``same_to_device``,
``same_dynamic_arrays``), f32 leaves compared on their bit patterns (NaN
boxes and int32 words stored in f32 rows).
"""
import dataclasses

import jax
import numpy as np

from cuda_pathtracer_tpu_torch.scene.device import SceneArrays, DynamicArrays


def eq(got, want, name: str):
    """``got`` (a tensor or an array) equals ``want``, bit for bit."""
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def _fields(x):
    return {k: (tuple(np.asarray(v).ravel().tolist())
                if isinstance(v, (tuple, list, np.ndarray)) else v)
            for k, v in dataclasses.asdict(x).items()}


def same_graph(jscene, tscene):
    for name in ('materials', 'spheres', 'planes', 'point_lights'):
        j, t = getattr(jscene, name), getattr(tscene, name)
        assert len(j) == len(t), name
        for a, b in zip(j, t):
            assert _fields(a) == _fields(b), (name, a, b)
    assert len(jscene.objects) == len(tscene.objects)
    for a, b in zip(jscene.objects, tscene.objects):
        assert (a.model_id, a.kind, a.material_id) == \
            (b.model_id, b.kind, b.material_id)
        for f in ('position', 'rotation', 'scale'):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                          err_msg=f)
    assert [(m.triangle_start, m.nr_triangles) for m in jscene.models] == \
        [(m.triangle_start, m.nr_triangles) for m in tscene.models]
    for f in ('_v0', '_v1', '_v2', '_normal', '_uv', '_tri_mat'):
        eq(getattr(tscene, f), getattr(jscene, f), f)


def same_to_device(jarr, tarr):
    """``to_device`` leaves: ``jarr`` the JAX package's (numpy leaves),
    ``tarr`` the port's."""
    for f in SceneArrays._fields:
        if f == 'textures':
            for g in ('texels', 'offset', 'width', 'height'):
                eq(getattr(tarr.textures, g), getattr(jarr.textures, g), g)
        else:
            eq(getattr(tarr, f), getattr(jarr, f), f)


def same_dynamic_arrays(jdyn, tdyn):
    """``dynamic_arrays`` leaves: ``jdyn`` the JAX package's (numpy
    leaves), ``tdyn`` the port's."""
    eq(tdyn.tri_gid, jdyn.world.tri_gid, 'tri_gid')
    eq(tdyn.tri_inst, jdyn.world.tri_inst, 'tri_inst')
    eq(tdyn.world_tris, jdyn.world.tris, 'world_tris')
    for f in DynamicArrays._fields:
        if f not in ('tri_gid', 'tri_inst', 'world_tris', 'depth'):
            eq(getattr(tdyn, f), getattr(jdyn, f), f)


def same_device_arrays(jscene, tscene):
    same_to_device(jax.tree.map(np.asarray, jscene.to_device()),
                   tscene.to_device('cpu'))
    jdyn = jax.tree.map(np.asarray, jscene.dynamic_arrays())
    tdyn = tscene.dynamic_arrays('cpu')
    assert tdyn.depth == jscene.wide_depth
    same_dynamic_arrays(jdyn, tdyn)
