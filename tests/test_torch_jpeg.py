"""The port's JPEG decoder (``scene/jpeg.py``, C++ in ``scene/native/
jpeg_decoder.cpp``) against PIL, which the JAX package reads images with.

The committed fixtures of ``tests/data/jpeg`` (written by
``tests/_torch_jpeg.py``: baseline 4:4:4, 4:2:2 and 4:2:0, progressive,
grey, restart markers, optimized tables, Adobe RGB, 1x1 and odd sizes, a
256x128 sky, and baseline files PIL does not write: 4:4:0, chroma sampled
finer than luma, RGB by component ids) decode bit for bit as PIL decodes
them, and as their ``digests.json`` says; so do freshly written variants
over quality. ``load_image`` gives the JAX package's arrays, a room at
32x24 with ``skydome.jpg`` and a JPEG ``map_Kd`` renders in the port as in
the JAX package (the tolerances of ``tests/test_torch_pathtracer.py``), the
refused features raise NotImplementedError naming themselves, and a
decoder that cannot be compiled raises instead of leaving a grey sky.
"""
import json
import os

import numpy as np
import pytest

import _torch_jpeg as tj
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer as JPathtracer
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu.scene.textures import load_image as jload
from cuda_pathtracer_tpu_torch.core.camera import Camera as TCamera
from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer as TPathtracer
from cuda_pathtracer_tpu_torch.scene import jpeg
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.textures import load_image as tload

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data', 'jpeg')
with open(os.path.join(DATA, 'digests.json')) as _f:
    DIGESTS = json.load(_f)


def test_fixtures_are_listed():
    names = {f'{n}.jpg' for n in tj.fixtures()}
    assert names == set(DIGESTS) == {f for f in os.listdir(DATA)
                                     if f.endswith('.jpg')}


@pytest.mark.parametrize('name', sorted(DIGESTS))
def test_fixture_decodes_as_pil(name):
    with open(os.path.join(DATA, name), 'rb') as f:
        data = f.read()
    want = tj.pil_decode(data)
    assert list(want.shape) == DIGESTS[name]['shape']
    assert tj.digest(want) == DIGESTS[name]['sha256']
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


VARIANTS = [(layout, q) for layout in ('444', '422', '420', 'progressive',
                                       'grey', 'restart')
            for q in (5, 50, 90, 100)]


@pytest.mark.parametrize('layout,quality', VARIANTS,
                         ids=[f'{a}-q{q}' for a, q in VARIANTS])
def test_variants_over_quality_decode_as_pil(layout, quality):
    opts = {'444': dict(subsampling=0), '422': dict(subsampling=1),
            '420': dict(subsampling=2),
            'progressive': dict(subsampling=2, progressive=True),
            'grey': {}, 'restart': dict(subsampling=1,
                                        restart_marker_blocks=1)}[layout]
    img = tj.picture(29, 45, seed=quality)
    data = tj.save_pil(img, layout == 'grey', quality=quality, **opts)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), tj.pil_decode(data))


@pytest.mark.parametrize('factors', [[(2, 2), (1, 2), (2, 1)],
                                     [(2, 1), (1, 2), (1, 1)]],
                         ids=['mixed', 'h2v1-h1v2'])
def test_baseline_sampling_layouts_decode_as_pil(factors):
    data = tj.encode_baseline(tj.picture(26, 35, seed=7), factors)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), tj.pil_decode(data))


@pytest.mark.parametrize('name', ['sky_256x128.jpg', 'grey.jpg',
                                  'adobe_rgb.jpg'])
def test_load_image_matches_jax(name):
    path = os.path.join(DATA, name)
    got, want = tload(path), jload(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('feature', sorted(tj.refused()))
def test_refused_features_raise(feature):
    with pytest.raises(NotImplementedError) as e:
        jpeg.decode_jpeg(tj.refused()[feature])
    words = {'four-component': 'four-component', 'not all refined':
             'not all refined', 'sampling': 'sampling factors',
             'DNL': 'DNL'}.get(feature, feature)
    assert words in str(e.value)


def test_malformed_file_raises_oserror():
    data = tj.save_pil(tj.picture(8, 8), False)
    with pytest.raises(OSError):
        jpeg.decode_jpeg(data[:40])


def test_no_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(jpeg, '_BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(jpeg, '_LIB', None)
    monkeypatch.setenv('CXX', str(tmp_path / 'no-such-compiler'))
    with pytest.raises(RuntimeError, match='did not compile'):
        jpeg.decode_jpeg(tj.save_pil(tj.picture(8, 8), False))
    logs = [f for f in os.listdir(tmp_path / 'build') if f.endswith('.log')]
    assert len(logs) == 1 and 'no-such-compiler' in \
        (tmp_path / 'build' / logs[0]).read_text()


# ---- a room with a JPEG sky and a JPEG texture through both packages ----

QUAD_OBJ = """mtllib quad.mtl
v -2 0 0
v 2 0 0
v 2 3 0
v -2 3 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl painted
f 1/1 2/2 3/3
f 1/1 3/3 4/4
"""
QUAD_MTL = 'newmtl painted\nKd 0.9 0.9 0.9\nmap_Kd tex.jpg\n'
CAMERA = dict(eye=[0.5, 1.5, -6.0], view_dir=[0.0, 0.1, 1.0], d=1.5,
              focal_length=6.0, aperture=0.0)


def _jpeg_room(scene_mod, d):
    s = scene_mod.Scene(asset_dirs=[str(d)])
    white = s.add_material(scene_mod.Material.DIFFUSE((0.9, 0.9, 0.9)))
    s.add_object(scene_mod.GameObject(s.add_model('quad.obj', 1.0, (0, 0, 0),
                                                  (0, 0, 0), white, True)))
    s.add_plane(scene_mod.Plane((0.0, 1.0, 0.0), 0.0, white))
    s.finalize()
    return s


@pytest.fixture(scope='module')
def jpeg_renders(tmp_path_factory):
    d = tmp_path_factory.mktemp('jpeg-room')
    for src, dst in (('sky_256x128.jpg', 'skydome.jpg'),
                     ('baseline_420.jpg', 'tex.jpg')):
        with open(os.path.join(DATA, src), 'rb') as f:
            (d / dst).write_bytes(f.read())
    (d / 'quad.obj').write_text(QUAD_OBJ)
    (d / 'quad.mtl').write_text(QUAD_MTL)
    jpt = JPathtracer(_jpeg_room(js, d), 32, 24)
    tpt = TPathtracer(_jpeg_room(ts, d), 32, 24, device='cpu')
    jcam, tcam = JCamera.create(**CAMERA), TCamera.create(**CAMERA,
                                                          device='cpu')
    for clear in (True, False, False, False):
        jpt.render(jcam, should_clear=clear)
        tpt.render(tcam, should_clear=clear)
    return jpt, tpt


def test_jpeg_sky_and_texture_load_as_in_jax(jpeg_renders):
    jpt, tpt = jpeg_renders
    np.testing.assert_array_equal(tpt.arrays.sky_img.numpy(),
                                  np.asarray(jpt.arrays.sky_img))
    assert tpt.arrays.sky_img.shape == (128, 256, 3)
    np.testing.assert_array_equal(tpt.arrays.textures.texels.numpy(),
                                  np.asarray(jpt.arrays.textures.texels))


def test_jpeg_room_renders_as_in_jax(jpeg_renders):
    jpt, tpt = jpeg_renders
    got, want = tpt.accumulators_pixel_order()[0].numpy(), \
        np.asarray(jpt.accumulators_pixel_order()[0])
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    close = np.isclose(got[:, :3], want[:, :3], rtol=1e-3,
                       atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert got[:, :3].std() > 0.05
    np.testing.assert_allclose(tpt.energy()[0], jpt.energy()[0], rtol=1e-3)
