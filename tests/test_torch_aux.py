"""The port's small host modules against the JAX package's, on the CPU:
``core/camera.py::update_camera`` (float64 numpy on the host: the same
camera and the same ``moved``), ``utils/keyboard.py`` (edge state),
``utils/focus.py::click_to_focus`` (the same focal length from one traced
ray, v2 and v1, on a cube, the plane and the sky of ``outside``),
``models/film.py::to_uint8``, ``utils/profiling.py`` (the fenced span
recorder that took the place of ``tests/test_aux.py``'s stage timer, its FPS
EMA, the kernel categories, a trace written to a directory) and
``utils/display.py`` (the HTTP viewer's round trip with a
PNG the port encoded, and the headless display).
"""
import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from _torch_room import write_cube_obj
from cuda_pathtracer_tpu.core import camera as jcam
from cuda_pathtracer_tpu.models import film as jfilm
from cuda_pathtracer_tpu.scene.builder import get_outside_scene as j_outside
from cuda_pathtracer_tpu.utils import focus as jfocus
from cuda_pathtracer_tpu.utils import keyboard as jkeyboard
from cuda_pathtracer_tpu_torch.core import camera as tcam
from cuda_pathtracer_tpu_torch.models import film as tfilm
from cuda_pathtracer_tpu_torch.ops import dispatch as tdispatch
from cuda_pathtracer_tpu_torch.scene import state as tstate
from cuda_pathtracer_tpu_torch.scene.builder import get_outside_scene as t_outside
from cuda_pathtracer_tpu_torch.utils import focus as tfocus
from cuda_pathtracer_tpu_torch.utils import keyboard as tkeyboard
from cuda_pathtracer_tpu_torch.utils import profiling
from cuda_pathtracer_tpu_torch.utils.display import HeadlessDisplay, HttpDisplay

_VIEW = np.array([0.1, -0.2, 1.0]) / np.linalg.norm([0.1, -0.2, 1.0])
CAM = dict(eye=[0.5, 4.0, -17.0], view_dir=list(_VIEW), d=1.5,
           focal_length=12.0, aperture=0.02)


def _same_camera(t, j):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize('actions', [
    set(), {'move_forward'}, {'move_backward', 'move_left'},
    {'move_right', 'look_up', 'look_left'}, {'look_down', 'look_right'},
    {'aperture_up'}, {'aperture_down', 'move_forward', 'look_right'},
    {'move_up', 'switch_nee'}], ids=lambda a: '+'.join(sorted(a)) or 'none')
def test_update_camera_matches_jax(actions):
    tnew, tmoved = tcam.update_camera(tcam.Camera.create(**CAM, device='cpu'),
                                      actions)
    jnew, jmoved = jcam.update_camera(jcam.Camera.create(**CAM), actions)
    assert tmoved == jmoved
    assert tmoved == bool(actions - {'move_up', 'switch_nee'})
    _same_camera(tnew, jnew)
    assert tnew.eye.device.type == 'cpu'


def test_default_camera_is_the_state_fallback(tmp_path):
    _same_camera(tcam.default_camera('cpu'), jcam.default_camera())
    _same_camera(tstate.read_state(str(tmp_path / 'none.txt'), device='cpu'),
                 jcam.default_camera())


def test_keyboard_edges_match_jax():
    assert tkeyboard.ACTIONS == jkeyboard.ACTIONS
    assert tkeyboard.DEFAULT_KEYMAP == jkeyboard.DEFAULT_KEYMAP
    tk, jk = tkeyboard.Keyboard(), jkeyboard.Keyboard()
    for held in (['w', 'n'], ['w', 'n'], ['up'], [], ['switch_blur', 'x']):
        for kb in (tk, jk):
            kb.set_down(held)
        for act in ('move_forward', 'switch_nee', 'look_up', 'switch_blur',
                    'focus'):
            got = (tk.is_down(act), tk.is_pressed(act), tk.is_released(act))
            want = (jk.is_down(act), jk.is_pressed(act), jk.is_released(act))
            assert got == want, (held, act)
        tk.swap_buffers()
        jk.swap_buffers()
    tk.set_down(['w'])
    assert tk.is_pressed('move_forward')
    tk.swap_buffers()
    assert tk.is_down('move_forward') and not tk.is_pressed('move_forward')
    tk.set_down([])
    assert tk.is_released('move_forward')


@pytest.fixture(scope='module')
def outside(tmp_path_factory):
    assets = write_cube_obj(tmp_path_factory.mktemp('focus'))
    js, ts = j_outside(asset_dirs=[assets]), t_outside(asset_dirs=[assets])
    for s in (js, ts):
        s.update(None, 2.0)
    return ((js.to_device(), js.dynamic_arrays()),
            (ts.to_device('cpu'), ts.dynamic_arrays('cpu')))


@pytest.mark.parametrize('v1', [False, True], ids=['v2', 'v1'])
@pytest.mark.parametrize('x,y,hit', [(16, 10, True), (16, 2, True),
                                     (2, 22, False)],
                         ids=['cube', 'plane', 'sky'])
def test_click_to_focus_matches_jax(outside, monkeypatch, v1, x, y, hit):
    monkeypatch.setattr(tdispatch, 'PACKET_V1', v1)
    (ja, jd), (ta, td) = outside
    jc = jcam.Camera.create(**CAM)
    tc = tcam.Camera.create(**CAM, device='cpu')
    jnew, jok = jfocus.click_to_focus(jc, ja, jd, x, y, 32, 24)
    tnew, tok = tfocus.click_to_focus(tc, ta, td, x, y, 32, 24)
    assert tok == jok == hit
    _same_camera(tnew, jnew)
    if hit:
        assert float(tnew.focal_length) != CAM['focal_length']


def test_to_uint8_matches_jax():
    img = np.random.RandomState(0).randn(24, 32, 3).astype(np.float32)
    got = tfilm.to_uint8(torch.from_numpy(img))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jfilm.to_uint8(jnp.asarray(img)))


def test_stage_timer_and_fps():
    with profiling.record(fence=True) as got:
        with profiling.span('work'):
            sum(range(1000))
    assert [s.name for s in got] == ['work'] and got[0].seconds >= 0
    assert 'work' in profiling.span_totals(got)
    assert profiling.span('work') is profiling.span('other')   # off again
    meter = profiling.FpsMeter(report_every=2)
    assert meter.frame() is None
    assert meter.frame() is not None


def test_kernel_categories():
    cat = profiling.categorize_kernel
    assert cat('void traverse_kernel(float const*, int)') == 'traverse'
    assert cat('traverse_packet_kernel(float4 const*)') == 'traverse_packet'
    assert cat('void guiding_scatter_kernel(int4 const*)') == 'guiding_scatter'
    assert cat('void blur_kernel(float4 const*)') == 'blur'
    assert cat('void at::native::vectorized_gather_kernel<16, long>') == 'gather'
    assert cat('void at::native::indexFuncLargeIndex<float>') == 'gather'
    assert cat('void cub::DeviceRadixSortOnesweepKernel<>') == 'sort'
    assert cat('void at::native::vectorized_elementwise_kernel<4>') \
        == 'elementwise'
    assert cat('Memcpy HtoD (Pageable -> Device)') == 'memcpy/memset'
    assert cat('Memset (Device)') == 'memcpy/memset'
    assert cat('void at::native::reduce_kernel<512, 1>') == 'other'


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as d:
        torch.ones(64).sum()
    with open(os.path.join(d, 'trace.json')) as f:
        assert json.load(f)['traceEvents']


def test_http_display_roundtrip():
    d = HttpDisplay(port=0)      # 0 -> ephemeral port
    try:
        port = d.port
        assert port == d.server.server_address[1] and port > 0
        frame = np.zeros((8, 12, 3), np.uint8)
        frame[:, :, 0] = 255
        frame[0] = (0, 0, 255)   # the bottom row, stored first
        d.present(frame)
        base = f'http://127.0.0.1:{port}'
        page = urllib.request.urlopen(f'{base}/').read()
        assert b'cuda_pathtracer_tpu_torch' in page
        png = urllib.request.urlopen(f'{base}/frame.png').read()
        assert png[:4] == b'\x89PNG'
        img = np.asarray(Image.open(io.BytesIO(png)))
        np.testing.assert_array_equal(img, frame[::-1])
        urllib.request.urlopen(f'{base}/key?k=w').read()
        urllib.request.urlopen(f'{base}/key?k=ArrowUp').read()
        assert d.poll_keys() == {'w', 'up'}
        assert d.poll_keys() == set()   # edge: drained
        urllib.request.urlopen(f'{base}/click?u=0.25&v=0.75').read()
        assert d.poll_clicks() == [(0.25, 0.75)]
        assert d.poll_clicks() == []
    finally:
        d.close()
    assert not d.thread.is_alive()


def test_headless_display_writes_frames(tmp_path):
    d = HeadlessDisplay(str(tmp_path / 'frames'))
    d.present(np.full((4, 6, 3), 0.5, np.float32))
    d.present(np.zeros((4, 6, 3), np.uint8))
    assert d.poll_keys() == set()
    d.close()
    names = sorted(os.listdir(tmp_path / 'frames'))
    assert names == ['frame_00000.png', 'frame_00001.png']
    img = np.asarray(Image.open(tmp_path / 'frames' / names[0]))
    assert img.shape == (4, 6, 3) and (img == 127).all()


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA'])
def test_png_decode_matches_pil(tmp_path, mode):
    """PIL writes with adaptive filtering (all five filter types on noisy
    rows); ``load_image`` decodes with the standard library as the JAX
    package's PIL path reads the file."""
    from cuda_pathtracer_tpu.scene.textures import load_image as jload
    from cuda_pathtracer_tpu_torch.scene.textures import load_image as tload
    from cuda_pathtracer_tpu_torch.utils.image import decode_png, encode_png
    rng = np.random.RandomState(5)
    px = rng.randint(0, 256, (37, 23, len(mode)), dtype=np.uint8)
    px[10:20] = px[10:11]                      # flat rows filter as Up
    px[:, 5:9] = np.arange(4, dtype=np.uint8)[None, :, None] * 9   # ramps
    path = str(tmp_path / f'{mode}.png')
    Image.fromarray(px[..., 0] if mode == 'L' else px, mode).save(path)
    np.testing.assert_array_equal(tload(path), jload(path))
    with open(path, 'rb') as f:
        np.testing.assert_array_equal(decode_png(f.read()), px)
    img = rng.rand(9, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(decode_png(encode_png(img))[::-1],
                                  (img * 255).astype(np.uint8))


def _filtered_png(px: np.ndarray) -> bytes:
    """An RGB PNG whose scanline y uses filter type y % 5 (PNG spec 9.2)."""
    import struct
    import zlib
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(np.int32)
    out = []
    for y in range(h):
        ftype, line = y % 5, rows[y]
        up = rows[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(ch, np.int32), line[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if ftype == 4:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = [0 * line, left, up, (left + up) >> 1][ftype]
        out.append(bytes([ftype]) + ((line - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(out)))
            + chunk(b'IEND', b''))


def test_png_decode_every_filter_type():
    from cuda_pathtracer_tpu_torch.utils.image import decode_png
    px = np.random.RandomState(6).randint(0, 256, (15, 11, 3), dtype=np.uint8)
    data = _filtered_png(px)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), px)
    np.testing.assert_array_equal(decode_png(data), px)


def test_jpeg_sky_is_refused_not_replaced(tmp_path):
    """A ``skydome.jpg`` on the asset path is decoded as the JAX package
    decodes it (with PIL), an arithmetic-coded one included; one that PIL
    refuses too (here a hierarchical frame) stops ``to_device`` with
    OSError, as in the JAX package, rather than falling back to the grey
    sky that a missing file gets."""
    import _torch_jpeg
    from _torch_room import build_room
    from cuda_pathtracer_tpu.scene.textures import load_image as jload
    from cuda_pathtracer_tpu_torch.scene import builder as tbuilder
    from cuda_pathtracer_tpu_torch.scene import scene as tscene
    from cuda_pathtracer_tpu_torch.scene.textures import load_image as tload
    path = tmp_path / 'skydome.jpg'
    Image.fromarray(_torch_jpeg.picture(4, 8)).save(path)
    assert jload(str(path)).shape == (4, 8, 3)
    np.testing.assert_array_equal(tload(str(path)), jload(str(path)))
    s = build_room(tscene, tbuilder.add_cube)
    s.asset_dirs = [str(tmp_path)]
    np.testing.assert_array_equal(s.to_device('cpu').sky_img.numpy(),
                                  jload(str(path)))
    path.write_bytes(_torch_jpeg.refused()['arithmetic'])
    np.testing.assert_array_equal(s.to_device('cpu').sky_img.numpy(),
                                  jload(str(path)))
    path.write_bytes(_torch_jpeg.refused()['hierarchical'])
    with pytest.raises(OSError, match='hierarchical'):
        tload(str(path))
    with pytest.raises(OSError):
        jload(str(path))
    with pytest.raises(OSError):
        s.to_device('cpu')
    s.asset_dirs = [str(tmp_path / 'missing')]
    sky = s.to_device('cpu').sky_img
    assert bool((sky == 0.5).all())