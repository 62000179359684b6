"""Checkpoints (``utils/checkpoint.py``) cross between the packages, on the
CPU: the room (``_torch_room.py``) at 64x64 with the lane cap and the tail
gate lowered to 2,048 lanes in both packages (``_torch_tail.lowered_gate``),
so the accumulators are in 8x16 tile lane order over 2 bands, as at full
size. Each package renders a clear frame and one converge sample and writes
a checkpoint; the port resumes the JAX package's, and the JAX package the
port's, and each renders one more converge sample. Both must give the JAX
package's own resumed render: the same sample and ``rand_idx``, the same
camera, at least 99% of the pixels within 1e-3 relative + 1e-5 absolute
(in pixel order) and the energy to 1e-3 relative, as the room tests hold
the two engines. The two checkpoints hold the same keys, shapes and values
(to that tolerance) but the port's band geometry, and a checkpoint of
another resolution or, from the port, another band geometry is refused.
"""
import numpy as np
import pytest

import _torch_tail as tail
from _torch_room import build_room, CAMERA
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu.models import pathtracer as jptm
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu.utils import checkpoint as jck
from cuda_pathtracer_tpu_torch.core.camera import Camera as TCamera
from cuda_pathtracer_tpu_torch.models import pathtracer as tptm
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.builder import add_cube
from cuda_pathtracer_tpu_torch.utils import checkpoint as tck

W = H = tail.W


def _jax():
    return jptm.Pathtracer(build_room(js, add_cube), W, H)


def _port():
    return tptm.Pathtracer(build_room(ts, add_cube), W, H, device='cpu')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('ckpt')
    paths = {'jax': str(tmp / 'jax.npz'), 'port': str(tmp / 'port.npz')}
    out = {'paths': paths}
    with tail.lowered_gate():
        jpt, tpt = _jax(), _port()
        assert tpt.tile_order and tpt.bands == 2
        jcam = JCamera.create(**CAMERA)
        tcam = TCamera.create(**CAMERA, device='cpu')
        for clear in (True, False):
            jpt.render(jcam, should_clear=clear)
            tpt.render(tcam, should_clear=clear)
        jck.save_checkpoint(paths['jax'], jpt, jcam)
        tck.save_checkpoint(paths['port'], tpt, tcam)
        # the JAX package's own resumed run, then each resumes the other's
        for key, engine, load, path in (
                ('jax', _jax(), jck.load_checkpoint, paths['jax']),
                ('port_from_jax', _port(), tck.load_checkpoint, paths['jax']),
                ('jax_from_port', _jax(), jck.load_checkpoint, paths['port'])):
            cam = load(path, engine)
            engine.render(cam)
            out[key] = (engine, cam)
    return out


def _pixels(engine):
    return [np.asarray(a) if not hasattr(a, 'numpy') else a.numpy()
            for a in engine.accumulators_pixel_order()]


@pytest.mark.parametrize('key', ['port_from_jax', 'jax_from_port'])
def test_resumed_render_matches_jax(runs, key):
    want, want_cam = runs['jax']
    got, got_cam = runs[key]
    assert got.sample_idx == want.sample_idx == 3
    assert int(got.rand_idx) == int(want.rand_idx)
    for a, b in zip(got_cam, want_cam):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for g, w in zip(_pixels(got), _pixels(want)):
        assert g.shape == w.shape == (W * H, 4)
        np.testing.assert_array_equal(g[:, 3], w[:, 3])
        close = np.isclose(g[:, :3], w[:, :3], rtol=1e-3,
                           atol=1e-5).all(axis=1)
        print(f'pixels within tolerance: {close.mean():.4f}')
        assert close.mean() >= 0.99
    (ge, gnan, gneg), (we, wnan, wneg) = got.energy(), want.energy()
    assert not (gnan or gneg or wnan or wneg) and we > 0
    np.testing.assert_allclose(ge, we, rtol=1e-3)


def test_checkpoints_hold_the_same_state(runs):
    jpt = runs['jax'][0]
    with np.load(runs['paths']['jax']) as j, np.load(runs['paths']['port']) as t:
        # the port also names the band geometry of the lane order
        assert sorted(j.files + ['bands', 'tile_order']) == sorted(t.files)
        assert (int(t['bands']), bool(t['tile_order'])) == \
            (jpt.bands, jpt.tile_order)
        for k in j.files:
            assert j[k].shape == t[k].shape, k
            if k in ('lum', 'alb', 'radiance_cache', 'radiance_total'):
                close = np.isclose(t[k], j[k], rtol=1e-3, atol=1e-4)
                assert close.reshape(len(close), -1).all(axis=1).mean() \
                    >= 0.99, k
            elif k == 'rays_traced':
                np.testing.assert_allclose(t[k], j[k], rtol=1e-3)
            else:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_checkpoint_rejects_mismatched_engine(runs):
    other = tptm.Pathtracer(build_room(ts, add_cube), W * 2, H, device='cpu')
    with pytest.raises(AssertionError, match='resolution'):
        tck.load_checkpoint(runs['paths']['jax'], other)


def test_checkpoint_rejects_other_band_geometry(runs):
    """The port's checkpoint (2 bands, written under the lowered lane cap)
    into an engine at the default cap (1 band): same size, other lanes."""
    other = _port()
    assert (other.bands, other.tile_order) == (1, True)
    with pytest.raises(AssertionError, match='band geometry'):
        tck.load_checkpoint(runs['paths']['port'], other)
