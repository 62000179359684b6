"""The whole slice: the JAX package's ``Pathtracer`` against the port's on
the small room at 32x24 (below the JAX tail gate, so both run the plain
full-width bounce loop): one clear frame, then 3 converge samples with NEE
and guiding training on. RNG streams are keyed on pixel coordinates, so the
two renders trace the same paths; they may part only where a float
difference flips a discrete decision. At least 99% of the pixels must agree
to 1e-3 relative + 1e-5 absolute, and the energy to 1e-3 relative."""
import numpy as np
import pytest

from _torch_room import build_room, CAMERA
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer as JPathtracer
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu_torch.core.camera import Camera as TCamera
from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer as TPathtracer
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.builder import add_cube

W, H = 32, 24


@pytest.fixture(scope='module')
def renders():
    jpt = JPathtracer(build_room(js, add_cube), W, H)
    tpt = TPathtracer(build_room(ts, add_cube), W, H, device='cpu')
    jcam, tcam = JCamera.create(**CAMERA), TCamera.create(**CAMERA, device='cpu')
    for clear in (True, False, False, False):
        jpt.render(jcam, should_clear=clear)
        tpt.render(tcam, should_clear=clear)
    return jpt, tpt


def test_accumulators_agree(renders):
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


def test_energy_agrees(renders):
    jpt, tpt = renders
    (te, tnan, tneg), (je, jnan, jneg) = tpt.energy(), jpt.energy()
    assert not (tnan or tneg or jnan or jneg)
    assert te > 0
    np.testing.assert_allclose(te, je, rtol=1e-3)


def test_guiding_trained(renders):
    jpt, tpt = renders
    got = tpt.radiance.cache.numpy()
    want = np.asarray(jpt.radiance.cache)
    assert (got != 0.1).any()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_blurred_image(renders):
    jpt, tpt = renders
    got = tpt.image(blur=True).numpy()
    want = np.asarray(jpt.image(blur=True))
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(axis=2)
    assert close.mean() >= 0.99
