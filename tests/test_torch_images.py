"""The port's image decoding (``scene/images.py``, C++ in ``scene/native/
image_decoder.cpp``) against PIL, which the JAX package reads images with.

Every committed fixture of ``tests/data/images`` (written by
``tests/_torch_images.py``: PNG of every colour type and bit depth, Adam7,
every filter, palettes with and without tRNS; TGA types 1/2/3/9/10/11 at
1/8/16/24/32 bits, both origins, mirrored, colour maps; BMP 1/4/8-bit
palettes, RLE4, RLE8, 16/24/32-bit, bit fields, core and V4/V5 headers,
top-down; GIF global and local palettes, interlaced, offset frames, clear
codes; PNM P1-P6 and odd maxvals; PSD composites of every colour mode PIL
reads, raw and PackBits; and files PIL writes) loads in the port bit for
bit as in the JAX package, and as ``digests.json`` says. Seeded sweeps
over PNG colour type x bit depth x interlace x filter and over PSD mode x
compression x channel count do too. Files PIL refuses raise in the port
with the same kind of error; formats only PIL reads (and Lab PSDs, which
PIL converts through LittleCMS) raise NotImplementedError naming them;
garbage raises OSError;
each fixture cut short or with a byte changed loads alike in both packages
or fails with the same kind of error (ValueError, which the skydome search
skips, or another).
The skydome cases of ROADMAP C.9 (a palette PNG, a JPEG named ``.png``, a
PNG named ``.jpg``, a truncated PNG) and blue-noise tiles PIL reads give the
JAX package's scene arrays or raise in both packages, never a grey sky. A
room at 32x24 with a palette-PNG sky, a TGA ``map_Kd`` and a BMP ``norm``
renders in the port as in the JAX package (the tolerances of
``tests/test_torch_jpeg.py``), and a decoder that cannot be compiled
raises.
"""
import io
import json
import os
import warnings

import numpy as np
import pytest

import _torch_images as ti
import _torch_jpeg as tj
from _torch_room import build_room
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer as JPathtracer
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu.scene.textures import load_image as jload
from cuda_pathtracer_tpu_torch.core.camera import Camera as TCamera
from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer as TPathtracer
from cuda_pathtracer_tpu_torch.scene import builder as tbuilder
from cuda_pathtracer_tpu_torch.scene import images
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.textures import load_image as tload
from cuda_pathtracer_tpu_torch.utils.image import decode_png

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                    'images')
with open(os.path.join(DATA, 'digests.json')) as _f:
    DIGESTS = json.load(_f)['files']


@pytest.fixture(autouse=True)
def _quiet_pil():
    # PIL warns on palette transparency given as bytes when converting
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)
        yield


def test_fixtures_are_listed():
    names = set(ti.fixtures())
    assert names == set(DIGESTS) == set(os.listdir(DATA)) - {'digests.json'}
    formats = {n.split('_')[0] for n in names}
    assert formats == {'png', 'tga', 'bmp', 'gif', 'pnm', 'psd', 'pil'}


@pytest.mark.parametrize('name', sorted(DIGESTS))
def test_fixture_loads_as_in_jax(name):
    path = os.path.join(DATA, name)
    with open(path, 'rb') as f:
        data = f.read()
    want = DIGESTS[name]
    mode, px = ti.pil_load(data)
    assert (mode, list(px.shape), ti.digest(px)) == \
        (want['mode'], want['shape'], want['sha256'])
    got, got_mode = images.decode_image(data, name)
    assert got.dtype == np.uint8 and got_mode == mode
    np.testing.assert_array_equal(got, px)
    t, j = tload(path), jload(path)
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


PNG_LAYOUTS = [(d, c, i) for (d, c) in sorted(images.PNG_MODES)
               for i in (False, True)]


@pytest.mark.parametrize('depth,ctype,interlace', PNG_LAYOUTS,
                         ids=[f'{d}bit-type{c}-{"adam7" if i else "flat"}'
                              for d, c, i in PNG_LAYOUTS])
def test_png_layouts_decode_as_pil(depth, ctype, interlace):
    """Random samples in every filter arrangement and at sizes where Adam7
    passes are empty or one pixel wide."""
    rs = np.random.RandomState(depth * 100 + ctype * 10 + interlace)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for h, w in ((1, 1), (3, 2), (9, 13), (17, 6)):
        s = rs.randint(0, 1 << depth, (h, w, ch))
        palette = rs.randint(0, 256, (rs.randint(1, (1 << depth) + 1), 3)) \
            if ctype == 3 else None
        for filters in ('cycle', 0, 1, 2, 3, 4):
            data = ti.encode_png(s, depth, ctype, interlace, filters, palette)
            mode, want = ti.pil_load(data)
            got, got_mode = images.decode_image(data)
            assert got_mode == mode == images.PNG_MODES[(depth, ctype)]
            np.testing.assert_array_equal(got, want)
            assert decode_png(data).shape == (h, w, images.CHANNELS[mode])


@pytest.mark.parametrize('case', sorted(ti.refused()))
def test_refused_files_raise_in_both(case, tmp_path):
    """ValueError (which the skydome search skips) where PIL raises it,
    another error where PIL raises another."""
    data, name, exc = ti.refused()[case]
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(exc):
        tload(str(path))
    with pytest.raises(Exception) as e:
        jload(str(path))
    assert isinstance(e.value, ValueError) == (exc is ValueError)


def _outcome(load, path):
    """('ok', array) or the kind of error the skydome search sees: 'skip'
    (ValueError, FileNotFoundError) or 'raise' (any other)."""
    try:
        return 'ok', load(path)
    except (ValueError, FileNotFoundError):
        return 'skip', None
    except Exception:
        return 'raise', None


@pytest.mark.parametrize('prefix', ['png', 'tga', 'bmp', 'gif', 'pnm', 'psd'])
def test_mutated_fixtures_load_as_in_jax(prefix, tmp_path):
    """Each fixture cut short, with a header byte changed and with a byte
    changed anywhere (seeded): the same array in both packages, or the same
    kind of error."""
    rs = np.random.RandomState(len(prefix) * 7 + ord(prefix[0]))
    names = sorted(n for n in DIGESTS if n.startswith(prefix + '_'))
    for name in names:
        data = _fixture(name)
        for k in range(3):
            d = bytearray(data)
            if k == 0:
                d = d[:rs.randint(1, len(d))]
            else:
                at = rs.randint(0, min(len(d), 64) if k == 1 else len(d))
                d[at] = rs.randint(256)
            path = str(tmp_path / f'{k}_{name}')
            with open(path, 'wb') as f:
                f.write(bytes(d))
            (tk, t), (jk, j) = _outcome(tload, path), _outcome(jload, path)
            assert tk == jk, (name, k)
            if tk == 'ok':
                np.testing.assert_array_equal(t, j, err_msg=f'{name} {k}')


def _pil_bytes(fmt):
    from PIL import Image, features
    if fmt == 'WebP' and not features.check('webp'):
        return b'RIFF\x24\x00\x00\x00WEBPVP8L' + bytes(32)
    buf = io.BytesIO()
    Image.fromarray(ti.picture(5, 7)).save(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize('fmt', ['TIFF', 'WebP', 'PCX'])
def test_pil_only_formats_are_named(fmt, tmp_path):
    path = tmp_path / 'sky.png'
    path.write_bytes(_pil_bytes(fmt))
    with pytest.raises(NotImplementedError, match=fmt):
        tload(str(path))


PSD_LAYOUTS = [(mode, comp, extra) for mode in sorted(ti.PSD_MODES)
               if mode != 'lab' for comp in (0, 1) for extra in (0, 1)]


@pytest.mark.parametrize('mode,compression,extra', PSD_LAYOUTS, ids=[
    f'{m}-{("raw", "packbits")[c]}{"-extra" if e else ""}'
    for m, c, e in PSD_LAYOUTS])
def test_psd_layouts_decode_as_pil(mode, compression, extra, tmp_path):
    """Random planes at sizes down to 1x1, with the channels the mode needs
    or one more (PIL reads an RGB file of four as RGBA and skips a fifth;
    with PackBits it takes the row lengths of only the channels it reads,
    which shifts where the next channel starts), and indexed files with and
    without a palette."""
    rs = np.random.RandomState(len(mode) * 10 + compression * 2 + extra)
    need = {'bitmap': 1, 'grey': 1, 'indexed': 1, 'rgb': 3, 'cmyk': 4,
            'multichannel': 2, 'duotone': 1}[mode]
    for h, w in ((1, 1), (3, 9), (11, 17)):
        row = (w + 7) // 8 if mode == 'bitmap' else w
        planes = rs.randint(0, 256, (need + extra, h, row)).astype(np.uint8)
        if rs.randint(2):    # runs, so PackBits makes both kinds of packet
            planes[..., 1::2] = planes[..., :-1:2][..., :planes[..., 1::2]
                                                   .shape[-1]]
        colour = rs.randint(0, 256, 768 if extra else 300).astype(
            np.uint8).tobytes() if mode == 'indexed' else b''
        data = ti.encode_psd(planes, mode, compression, width=w,
                             colour_data=colour)
        path = tmp_path / f'{mode}.psd'
        path.write_bytes(data)
        (tk, t), (jk, j) = _outcome(tload, str(path)), \
            _outcome(jload, str(path))
        assert tk == jk, (h, w)
        if tk != 'ok':     # a shifted channel runs past the end in both
            continue
        np.testing.assert_array_equal(t, j)
        got, got_mode = images.decode_image(data, str(path))
        want_mode, want = ti.pil_load(data)
        assert got_mode == want_mode
        np.testing.assert_array_equal(got, want)


def test_psd_files_pil_refuses_raise_alike(tmp_path):
    """16 and 32-bit samples, another version, too few channels, ZIP
    compression and truncated data: the same kind of error in both
    packages (a truncated one-channel raw file raises ValueError, as PIL's
    memory map of a file opened by name does)."""
    pic = ti.picture(5, 7, 3, seed=1).transpose(2, 0, 1).copy()
    raw = ti.encode_psd(pic, 'rgb', 0)
    zipped = bytearray(raw)
    zipped[len(raw) - pic.size - 2:len(raw) - pic.size] = b'\x00\x02'
    grey = ti.encode_psd(pic[:1].copy(), 'grey', 0)
    cases = {
        '16-bit': ti.encode_psd(np.repeat(pic, 2, axis=2), 'rgb', 0,
                                width=7, depth=16),
        '32-bit': ti.encode_psd(np.repeat(pic, 4, axis=2), 'rgb', 0,
                                width=7, depth=32),
        'version 2': raw[:4] + b'\x00\x02' + raw[6:],
        'two channels of RGB': ti.encode_psd(pic[:2].copy(), 'rgb', 0),
        'ZIP': bytes(zipped),
        'truncated raw RGB': raw[:-9],
        'truncated PackBits': ti.encode_psd(pic, 'rgb', 1)[:-3],
        'truncated raw grey': grey[:-9],
        'header only': raw[:40],
    }
    for case, data in cases.items():
        path = tmp_path / 'sky.psd'
        path.write_bytes(data)
        (tk, _), (jk, _) = _outcome(tload, str(path)), \
            _outcome(jload, str(path))
        assert tk == jk != 'ok', case
        with pytest.raises(Exception) as e:
            tload(str(path))
        assert not isinstance(e.value, NotImplementedError), case


def test_lab_psd_is_named(tmp_path):
    """A Lab composite: PIL converts it to RGB through LittleCMS, which the
    port does not reproduce, so it raises NotImplementedError naming it
    (ROADMAP C.10) instead of a wrong sky."""
    for name, data in ti.psd_fixtures(lab=True).items():
        if '_lab_' not in name:
            continue
        path = tmp_path / name
        path.write_bytes(data)
        assert jload(str(path)).shape == (13, 21, 3)
        with pytest.raises(NotImplementedError, match='Lab'):
            tload(str(path))


def test_garbage_and_missing_files(tmp_path):
    path = tmp_path / 'sky.png'
    path.write_bytes(b'this is not an image, whatever its name says\n' * 3)
    with pytest.raises(OSError) as e:
        tload(str(path))
    assert not isinstance(e.value, FileNotFoundError)
    with pytest.raises(OSError):
        jload(str(path))
    with pytest.raises(FileNotFoundError):
        tload(str(tmp_path / 'missing.png'))


def test_no_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(images, '_BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(images, '_LIB', None)
    monkeypatch.setenv('CXX', str(tmp_path / 'no-such-compiler'))
    with open(os.path.join(DATA, 'png_grey4.png'), 'rb') as f:
        data = f.read()
    with pytest.raises(RuntimeError, match='did not compile'):
        images.decode_image(data)
    logs = [f for f in os.listdir(tmp_path / 'build') if f.endswith('.log')]
    assert len(logs) == 1 and 'no-such-compiler' in \
        (tmp_path / 'build' / logs[0]).read_text()


# ---- the skydome and blue-noise searches (ROADMAP C.9) -------------------


def _rooms(asset_dir):
    j = build_room(js, tbuilder.add_cube)
    t = build_room(ts, tbuilder.add_cube)
    j.asset_dirs = t.asset_dirs = [str(asset_dir)]
    return j, t


def _fixture(name):
    with open(os.path.join(DATA, name), 'rb') as f:
        return f.read()


SKIES = {'palette PNG': ('png_palette8_trns.png', 'sky.png'),
         'JPEG named .png': (None, 'sky.png'),
         'PNG named .jpg': ('png_rgb16_adam7.png', 'skydome.jpg')}


@pytest.mark.parametrize('case', sorted(SKIES))
def test_sky_loads_as_in_jax(case, tmp_path):
    src, dst = SKIES[case]
    data = _fixture(src) if src else \
        tj.save_pil(tj.picture(12, 20), False, quality=85)
    (tmp_path / dst).write_bytes(data)
    j, t = _rooms(tmp_path)
    sky = 'sky.png' if dst == 'sky.png' else None
    want = np.asarray(j.to_device(skydome=sky).sky_img)
    got = t.to_device('cpu', skydome=sky).sky_img.numpy()
    assert want.shape[:2] == jload(str(tmp_path / dst)).shape[:2]
    np.testing.assert_array_equal(got, want)
    assert not (got == 0.5).all()


def test_truncated_sky_raises_in_both(tmp_path):
    png = _fixture('png_palette8.png')
    (tmp_path / 'sky.png').write_bytes(png[:len(png) * 2 // 3])
    j, t = _rooms(tmp_path)
    with pytest.raises(OSError):
        t.to_device('cpu', skydome='sky.png')
    with pytest.raises(OSError):
        j.to_device(skydome='sky.png')


@pytest.mark.parametrize('name', ['png_grey16.png', 'png_palette4.png',
                                  'gif_interlaced.gif'])
def test_blue_noise_loads_as_in_jax(name, tmp_path):
    (tmp_path / 'bluenoise.png').write_bytes(_fixture(name))
    j, t = _rooms(tmp_path)
    want = np.asarray(j.to_device().blue_noise)
    np.testing.assert_array_equal(t.to_device('cpu').blue_noise.numpy(), want)
    assert want.shape == (19, 23) or want.shape == (21, 27)


# ---- a room with image textures through both packages ----------------------

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
QUAD_MTL = 'newmtl painted\nKd 0.9 0.9 0.9\nmap_Kd tex.tga\nnorm nrm.bmp\n'
CAMERA = dict(eye=[0.5, 1.5, -6.0], view_dir=[0.0, 0.1, 1.0], d=1.5,
              focal_length=6.0, aperture=0.0)


def _image_room(scene_mod, d):
    s = scene_mod.Scene(asset_dirs=[str(d)])
    white = s.add_material(scene_mod.Material.DIFFUSE((0.9, 0.9, 0.9)))
    s.add_object(scene_mod.GameObject(s.add_model('quad.obj', 1.0, (0, 0, 0),
                                                  (0, 0, 0), white, True)))
    s.add_plane(scene_mod.Plane((0.0, 1.0, 0.0), 0.0, white))
    s.finalize()
    return s


@pytest.fixture(scope='module')
def image_renders(tmp_path_factory):
    d = tmp_path_factory.mktemp('image-room')
    for src, dst in (('png_palette8_trns.png', 'skydome.png'),
                     ('tga_rgb24_rle_bottom.tga', 'tex.tga'),
                     ('bmp_rgb24.bmp', 'nrm.bmp')):
        (d / dst).write_bytes(_fixture(src))
    (d / 'quad.obj').write_text(QUAD_OBJ)
    (d / 'quad.mtl').write_text(QUAD_MTL)
    jpt = JPathtracer(_image_room(js, d), 32, 24, skydome='skydome.png')
    tpt = TPathtracer(_image_room(ts, d), 32, 24, device='cpu',
                      skydome='skydome.png')
    jcam, tcam = JCamera.create(**CAMERA), TCamera.create(**CAMERA,
                                                          device='cpu')
    for clear in (True, False, False, False):
        jpt.render(jcam, should_clear=clear)
        tpt.render(tcam, should_clear=clear)
    return jpt, tpt


def test_image_room_loads_as_in_jax(image_renders):
    jpt, tpt = image_renders
    np.testing.assert_array_equal(tpt.arrays.sky_img.numpy(),
                                  np.asarray(jpt.arrays.sky_img))
    assert tpt.arrays.sky_img.shape == (19, 23, 3)
    np.testing.assert_array_equal(tpt.arrays.textures.texels.numpy(),
                                  np.asarray(jpt.arrays.textures.texels))
    assert len(tpt.arrays.textures.width) == 2


def test_image_room_renders_as_in_jax(image_renders):
    jpt, tpt = image_renders
    got, want = tpt.accumulators_pixel_order()[0].numpy(), \
        np.asarray(jpt.accumulators_pixel_order()[0])
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    close = np.isclose(got[:, :3], want[:, :3], rtol=1e-3,
                       atol=1e-5).all(axis=1)
    assert close.mean() >= 0.99, close.mean()
    assert got[:, :3].std() > 0.05
    np.testing.assert_allclose(tpt.energy()[0], jpt.energy()[0], rtol=1e-3)
