"""The port's built-in ``minecraft`` and ``2mtris`` scenes against the JAX
package's on the CPU.

Both packages build each scene through ``get_scene`` (from an empty asset
directory, so the procedural stand-ins load: the voxel world of 70,328
triangles, and the high-poly statue, here at the 50,000 triangles of the JAX
golden ``stress_statue`` by patching ``add_high_poly_statue`` in both
packages). The host graphs, ``to_device`` and ``dynamic_arrays`` agree bit
for bit (``_torch_scene_cmp.py``).

Then the renders: minecraft through both packages' ``Pathtracer`` at 32x24
with the JAX golden ``minecraft_guided`` camera and guiding on (a clear
frame and 3 converge samples; below the tail gate, so both engines draw the
same random numbers): at least 99% of the pixels within 1e-3 relative +
1e-5 absolute, the energy to 1e-3, the guiding cache and the blurred
display alike. And the statue in both packages' Whitted ``Raytracer`` at
48x32 with the ``stress_statue`` camera, on the port's v2 and v1
traversals: at least 99.5% of the pixels within the same tolerance.
"""
import contextlib

import numpy as np
import pytest

from _torch_scene_cmp import same_device_arrays, same_graph
from _torch_whitted import agree, count_traversals, jax_frames
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer as JPathtracer
from cuda_pathtracer_tpu.scene import builder as jbuilder
from cuda_pathtracer_tpu.scene import procedural as jproc
from cuda_pathtracer_tpu_torch.core.camera import Camera as TCamera
from cuda_pathtracer_tpu_torch.models import raytracer as trt
from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer as TPathtracer
from cuda_pathtracer_tpu_torch.ops import dispatch as tdispatch
from cuda_pathtracer_tpu_torch.scene import builder as tbuilder
from cuda_pathtracer_tpu_torch.scene import procedural as tproc

STATUE_TRIS = 50_000
# eye, view direction, d, focal length, aperture of the JAX goldens
# (tests/test_goldens_configs.py: minecraft_guided, stress_statue)
MINECRAFT_CAMERA = ([0, 6, -14], [0, -0.15, 1], 1.5, 10.0, 0.0)
STATUE_CAMERA = ([0, 6, -14], [0, -0.05, 1], 1.5, 14.0, 0.0)
W, H = 32, 24


@contextlib.contextmanager
def small_statue():
    """``add_high_poly_statue`` at STATUE_TRIS in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jproc, tproc):
            def add(scene, material, target_tris=None,
                    _f=mod.add_high_poly_statue):
                return _f(scene, material, target_tris=STATUE_TRIS)
            mp.setattr(mod, 'add_high_poly_statue', add)
        yield


def build_both(name, asset_dir):
    with small_statue():
        return (jbuilder.get_scene(name, asset_dirs=[asset_dir]),
                tbuilder.get_scene(name, asset_dirs=[asset_dir]))


@pytest.fixture(scope='module')
def empty_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp('no_assets'))


@pytest.fixture(scope='module')
def built(empty_dir):
    """name -> (JAX scene, port scene), each pair built once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = build_both(name, empty_dir)
        return cache[name]
    return get


@pytest.fixture(scope='module', params=['minecraft', '2mtris'])
def scenes(request, built):
    return built(request.param)


def test_minecraft_scene(built):
    """The port's counterpart of ``test_scenes_builtin.py``'s: one object,
    the voxel world, one point light."""
    _, s = built('minecraft')
    assert len(s.objects) == 1 and len(s.point_lights) == 1
    assert len(s._v0) == 70_328


def test_2mtris_scene(built):
    jscene, tscene = built('2mtris')
    assert len(tscene.objects) == 1
    assert STATUE_TRIS <= len(tscene._v0) < 1.01 * STATUE_TRIS
    # the statue, built along +z, stands along +y
    np.testing.assert_array_equal(tscene.objects[0].rotation,
                                  [-3.1415926535 / 2, 0.0, 0.0])
    np.testing.assert_array_equal(tscene.objects[0].rotation,
                                  jscene.objects[0].rotation)


def test_graph_matches_jax(scenes):
    jscene, tscene = scenes
    same_graph(jscene, tscene)


def test_device_arrays_match_jax(scenes):
    jscene, tscene = scenes
    same_device_arrays(jscene, tscene)


@pytest.fixture(scope='module')
def renders(built):
    jscene, tscene = built('minecraft')
    jpt = JPathtracer(jscene, W, H)
    tpt = TPathtracer(tscene, W, H, device='cpu')
    jpt.cache = tpt.cache = True
    jcam = JCamera.create(*MINECRAFT_CAMERA)
    tcam = TCamera.create(*MINECRAFT_CAMERA, device='cpu')
    for clear in (True, False, False, False):
        jpt.render(jcam, should_clear=clear)
        tpt.render(tcam, should_clear=clear)
    return jpt, tpt


def test_minecraft_accumulators_agree(renders):
    jpt, tpt = renders
    assert tpt.sample_idx == jpt.sample_idx == 4
    for got, want in zip(tpt.accumulators_pixel_order(),
                         jpt.accumulators_pixel_order()):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (W * H, 4)
        np.testing.assert_array_equal(got[:, 3], want[:, 3])
        close = np.isclose(got[:, :3], want[:, :3], rtol=1e-3,
                           atol=1e-5).all(axis=1)
        print(f'pixels within tolerance: {close.mean():.4f}')
        assert close.mean() >= 0.99


def test_minecraft_energy_agrees(renders):
    jpt, tpt = renders
    (te, tnan, tneg), (je, jnan, jneg) = tpt.energy(), jpt.energy()
    assert not (tnan or tneg or jnan or jneg)
    assert te > 0
    np.testing.assert_allclose(te, je, rtol=1e-3)


def test_minecraft_guiding_trained(renders):
    jpt, tpt = renders
    got = tpt.radiance.cache.numpy()
    want = np.asarray(jpt.radiance.cache)
    assert (got != 0.1).any()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_minecraft_blurred_image(renders):
    jpt, tpt = renders
    got = tpt.image(blur=True).numpy()
    want = np.asarray(jpt.image(blur=True))
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert got.std() > 0.01          # the voxel field is in view
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(axis=2)
    assert close.mean() >= 0.99


@pytest.fixture(scope='module')
def jax_statue(empty_dir):
    with small_statue():
        scene = jbuilder.get_scene('2mtris', asset_dirs=[empty_dir])
    return jax_frames(scene, JCamera.create(*STATUE_CAMERA), (False,),
                      48, 32)[0]


@pytest.mark.parametrize('v1', [False, True], ids=['v2', 'v1'])
def test_statue_whitted_matches_jax(jax_statue, empty_dir, monkeypatch, v1):
    with small_statue():
        scene = tbuilder.get_scene('2mtris', asset_dirs=[empty_dir])
    monkeypatch.setattr(tdispatch, 'PACKET_V1', v1)
    calls = count_traversals(monkeypatch)
    rt = trt.Raytracer(scene, 48, 32, device='cpu')
    stats = []
    rt.render(TCamera.create(*STATUE_CAMERA, device='cpu'), stats=stats)
    assert (calls['v1'] > 0, calls['v2'] > 0) == (v1, not v1), calls
    got, (want, want_active) = rt.frame.numpy(), jax_statue
    assert got.shape == want.shape == (48 * 32, 3)
    assert np.isfinite(got).all() and (got >= 0).all()
    # the statue fills part of the view, in front of the sky
    assert 0 < stats[0]['active'] and (got != got[0]).any()
    share = agree(got, want)
    print(f'pixels within tolerance: {share:.4f}; active per level '
          f'{[s["active"] for s in stats]} vs {want_active}')
    assert share >= 0.995
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)
