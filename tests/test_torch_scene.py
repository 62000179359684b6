"""The port's scene export matches the JAX package's on the small room:
``Scene.to_device`` / ``dynamic_arrays`` leaf by leaf, the numpy
``build_merged_table`` bit for bit, and the bridge round-trips."""
import jax
import numpy as np
import pytest
import torch

from _torch_room import build_room
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu.ops import traverse_packet2 as jtp2
from cuda_pathtracer_tpu.models.guiding import init_radiance_state
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu_torch import bridge
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as ttp2
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.builder import add_cube
from cuda_pathtracer_tpu_torch.scene.device import SceneArrays, DynamicArrays


@pytest.fixture(scope='module')
def scenes():
    jscene = build_room(js, add_cube)
    tscene = build_room(ts, add_cube)
    jarr = jax.tree.map(np.asarray, jscene.to_device())
    jdyn = jax.tree.map(np.asarray, jscene.dynamic_arrays())
    return jscene, tscene, jarr, jdyn


def _eq(got: torch.Tensor, want: np.ndarray, name: str):
    got = got.numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == np.float32:
        # bit patterns: NaN boxes and int32 words stored in f32 rows
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_room_is_small_and_complete(scenes):
    jscene, tscene, _, _ = scenes
    assert 100 <= len(tscene._tri_mat) <= 1000
    assert len(tscene.spheres) == 2 and len(tscene.objects) == 7
    assert len(tscene.planes) == 1 and len(tscene.atlas) == 2
    np.testing.assert_array_equal(tscene._v0, jscene._v0)


def test_to_device_matches(scenes):
    _, tscene, jarr, _ = scenes
    tarr = tscene.to_device('cpu')
    for f in SceneArrays._fields:
        if f == 'textures':
            for g in ('texels', 'offset', 'width', 'height'):
                _eq(getattr(tarr.textures, g), getattr(jarr.textures, g), g)
        else:
            _eq(getattr(tarr, f), getattr(jarr, f), f)


def test_dynamic_arrays_match(scenes):
    jscene, tscene, _, jdyn = scenes
    tdyn = tscene.dynamic_arrays('cpu')
    assert tdyn.depth == jscene.wide_depth
    _eq(tdyn.tri_gid, jdyn.world.tri_gid, 'tri_gid')
    _eq(tdyn.tri_inst, jdyn.world.tri_inst, 'tri_inst')
    _eq(tdyn.world_tris, jdyn.world.tris, 'world_tris')
    for f in DynamicArrays._fields:
        if f not in ('tri_gid', 'tri_inst', 'world_tris', 'depth'):
            _eq(getattr(tdyn, f), getattr(jdyn, f), f)


def test_build_merged_table_bit_exact(scenes):
    jscene, tscene, _, jdyn = scenes
    from cuda_pathtracer_tpu.accel.wide import build_world_wide
    from cuda_pathtracer_tpu.accel.toplevel import build_world_bvh
    transforms, _, _ = tscene.instances()
    inst_model = np.array([o.model_id for o in tscene.objects], np.int32)
    wb = build_world_bvh([m.bvh for m in tscene.models],
                         [m.triangle_start for m in tscene.models],
                         [m.nr_triangles for m in tscene.models],
                         tscene._v0, tscene._v1, tscene._v2, inst_model,
                         transforms)
    ww = build_world_wide([m.wide for m in tscene.models], inst_model,
                          transforms, [int(b) for b in wb.wtri_base])
    got = ttp2.build_merged_table(ww.rows, ww.depth)
    want = np.asarray(jtp2.build_merged_table(ww.rows, ww.depth).rows)
    assert got.depth == ww.depth
    np.testing.assert_array_equal(got.rows.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(want.view(np.int32),
                                  jdyn.packet_merged.view(np.int32))


@pytest.mark.parametrize('n_rows', [0, 1])
def test_build_merged_table_degenerate_bit_exact(scenes, n_rows):
    """Empty and single-leaf scenes get a synthesized root."""
    _, _, _, jdyn = scenes
    wide = np.zeros((n_rows, 128), np.float32)
    if n_rows:
        wide[0, 0] = -3.0    # a leaf of three triangles
        wide[0, 1:109] = np.random.RandomState(1).rand(108)
        wide[0, 109:112] = np.array([4, 5, 6], np.int32).view(np.float32)
    got = ttp2.build_merged_table(wide, 1)
    want = np.asarray(jtp2.build_merged_table(wide, 1).rows)
    np.testing.assert_array_equal(got.rows.view(np.int32), want.view(np.int32))


def test_bridge_round_trips(scenes):
    jscene, tscene, jarr, jdyn = scenes
    barr = bridge.scene_arrays(jarr, 'cpu')
    tarr = tscene.to_device('cpu')
    for f in SceneArrays._fields:
        if f == 'textures':
            for g in ('texels', 'offset', 'width', 'height'):
                _eq(getattr(barr.textures, g), getattr(jarr.textures, g), g)
                assert torch.equal(getattr(barr.textures, g),
                                   getattr(tarr.textures, g))
        else:
            _eq(getattr(barr, f), getattr(jarr, f), f)
    bdyn = bridge.dynamic_arrays(jdyn, jscene.wide_depth, 'cpu')
    tdyn = tscene.dynamic_arrays('cpu')
    for f in DynamicArrays._fields:
        if f == 'depth':
            assert bdyn.depth == tdyn.depth
        else:
            assert torch.equal(getattr(bdyn, f).view(torch.int32)
                               if getattr(bdyn, f).dtype == torch.float32
                               else getattr(bdyn, f),
                               getattr(tdyn, f).view(torch.int32)
                               if getattr(tdyn, f).dtype == torch.float32
                               else getattr(tdyn, f)), f
    rad = jax.tree.map(np.asarray, init_radiance_state(40))
    brad = bridge.radiance_state(rad, 'cpu')
    _eq(brad.cache, rad.cache, 'cache')
    _eq(brad.total, rad.total, 'total')
    cam = jax.tree.map(np.asarray, JCamera.create([0, 1, 2], [0, 0, 1], 1.5,
                                                  4.0, 0.1))
    bcam = bridge.camera(cam, 'cpu')
    for got, want in zip(bcam, cam):
        _eq(got, np.asarray(want, np.float32), 'camera')
