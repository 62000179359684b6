"""The port's device refit (``accel/refit.py`` through
``Scene.dynamic_arrays``) on the animated ``outside`` scene: full build,
``update(None, 3.0)`` (the animation handler moves the 10 cubes), refit.

Held to the port's own full rebuild of the same state with the tolerances of
the JAX package's ``tests/test_refit.py`` (atol 2e-4, NaN positions equal;
the rebuild renumbers world triangles, so those compare in (instance,
triangle) order), and to the JAX package's refit of the same state (atol
1e-5, NaN positions equal, same numbering). ``derive_merged`` matches the
JAX package's bit for bit on the same inputs. ``cube.obj`` is written by the
test, so both packages load the same mesh.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_room import write_cube_obj
from cuda_pathtracer_tpu.accel.toplevel import build_world_bvh
from cuda_pathtracer_tpu.accel.wide import build_world_wide
from cuda_pathtracer_tpu.ops import traverse_packet2 as jtp2
from cuda_pathtracer_tpu.scene import builder as jbuilder
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as ttp2
from cuda_pathtracer_tpu_torch.scene import builder as tbuilder


@pytest.fixture(scope='module')
def dyns(tmp_path_factory):
    assets = write_cube_obj(tmp_path_factory.mktemp('assets'))
    tscene = tbuilder.get_scene('outside', asset_dirs=[assets])
    first = tscene.dynamic_arrays('cpu')
    tscene.update(None, 3.0)
    assert tscene.invalid
    refit = tscene.dynamic_arrays('cpu')
    assert tscene._refit_templates is not None and tscene.refits == 1
    # a forced full rebuild of the same state
    tscene._refit_templates = None
    tscene._dyn_cache = None
    full = tscene.dynamic_arrays('cpu')

    jscene = jbuilder.get_scene('outside', asset_dirs=[assets])
    jscene.dynamic_arrays()
    jscene.update(None, 3.0)
    jrefit = jax.tree.map(np.asarray, jscene.dynamic_arrays())
    return first, refit, full, jrefit, jscene


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_nan(a, b, atol, name):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=0, atol=atol, err_msg=name)


def test_refit_moved_the_cubes(dyns):
    first, refit, _, _, _ = dyns
    moved = np.abs(_np(refit.world_tris) - _np(first.world_tris)).max()
    assert moved > 1.0
    assert refit.packet_merged.shape[0] > 1


def test_refit_matches_full_rebuild(dyns):
    _, refit, full, _, _ = dyns

    def canon(d):
        key = np.lexsort((_np(d.tri_gid), _np(d.tri_inst)))
        return _np(d.world_tris)[key]
    np.testing.assert_allclose(canon(refit), canon(full), rtol=0, atol=2e-4)
    np.testing.assert_allclose(_np(refit.packet_leaf)[:, :108],
                               _np(full.packet_leaf)[:, :108], rtol=0,
                               atol=2e-4)
    _close_nan(_np(refit.packet_inner)[:, :96], _np(full.packet_inner)[:, :96],
               2e-4, 'packet_inner')
    _close_nan(refit.packet_merged, full.packet_merged, 2e-4, 'packet_merged')
    for f in ('inst_transform', 'inst_inv', 'inst_packed', 'light_packed'):
        np.testing.assert_allclose(_np(getattr(refit, f)),
                                   _np(getattr(full, f)), rtol=0, atol=2e-4,
                                   err_msg=f)


@pytest.mark.parametrize('field', ['packet_inner', 'packet_leaf',
                                   'packet_merged', 'world_tris'])
def test_refit_matches_jax_refit(dyns, field):
    _, refit, _, jrefit, _ = dyns
    want = jrefit.world.tris if field == 'world_tris' else getattr(jrefit, field)
    _close_nan(getattr(refit, field), want, 1e-5, field)
    if field == 'world_tris':
        np.testing.assert_array_equal(_np(refit.tri_gid), jrefit.world.tri_gid)
        np.testing.assert_array_equal(_np(refit.tri_inst),
                                      jrefit.world.tri_inst)


def test_derive_merged_bit_exact(dyns):
    _, _, _, jrefit, jscene = dyns
    inner, leaf = jrefit.packet_inner, jrefit.packet_leaf
    want = np.asarray(jtp2.derive_merged(inner, leaf, jscene._merged_maps))
    # the maps depend on the topology only, which the move keeps
    transforms, _, _ = jscene.instances()
    inst_model = np.array([o.model_id for o in jscene.objects], np.int32)
    wb = build_world_bvh([m.bvh for m in jscene.models],
                         [m.triangle_start for m in jscene.models],
                         [m.nr_triangles for m in jscene.models],
                         jscene._v0, jscene._v1, jscene._v2, inst_model,
                         transforms)
    ww = build_world_wide([m.wide for m in jscene.models], inst_model,
                          transforms, [int(b) for b in wb.wtri_base])
    maps = ttp2.build_refit_maps(ww.rows, 'cpu')
    got = ttp2.derive_merged(torch.from_numpy(np.array(inner)),
                             torch.from_numpy(np.array(leaf)),
                             maps).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
