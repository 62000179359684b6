"""The port's film against the JAX package: the plain blur against
``blur_luminance_pallas`` (Pallas, interpret mode) and ``film._blur_xla`` at
rtol 1e-6 (exp may round differently in the last bit between XLA and
PyTorch), and ``accumulate``, ``accumulate_albedo``, ``display`` and
``energy_audit``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pathtracer_tpu.models import film as jf
from cuda_pathtracer_tpu.ops.blur_pallas import blur_luminance_pallas
from cuda_pathtracer_tpu_torch.models import film as tf
from cuda_pathtracer_tpu_torch.ops import blur as tb

W, H = 40, 24


def _accumulators(seed=0, n=12.0, w=W, h=H):
    rng = np.random.RandomState(seed)
    lum = np.concatenate([rng.rand(h * w, 3).astype(np.float32) * n,
                          np.full((h * w, 1), n, np.float32)], axis=1)
    alb = np.concatenate([rng.rand(h * w, 3).astype(np.float32) * n + 0.1,
                          np.full((h * w, 1), n, np.float32)], axis=1)
    alb[:7, 1] = 0.0     # exercises the 0.001 albedo floor
    return lum, alb


@pytest.mark.parametrize('n,w,h', [
    pytest.param(n, w, h, id=f'{n}' + ('' if (w, h) == (W, H) else f'-{w}x{h}'))
    for n, w, h in ((1.0, W, H), (12.0, W, H), (500.0, W, H), (3.0, 1, 1),
                    (7.0, 2, 3), (12.0, 7, 5))])
def test_blur_matches_pallas_and_xla(n, w, h):
    """Also at frames smaller than the 7 x 8 halo (1x1, 2x3, 7x5)."""
    lum, alb = _accumulators(n=n, w=w, h=h)
    got = tb.blur_luminance(torch.as_tensor(lum), torch.as_tensor(alb), n, w, h)
    pallas = blur_luminance_pallas(jnp.asarray(lum), jnp.asarray(alb), n,
                                   width=w, height=h, interpret=True)
    xla = jf._blur_xla(jnp.asarray(lum), jnp.asarray(alb), n, w, h)
    assert got.shape == (h * w, 3)
    for want in (pallas, xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


def test_blur_weights_match_pallas():
    from cuda_pathtracer_tpu.ops.blur_pallas import _weights, H_TAPS, V_TAPS
    for n in (1.0, 300.0):
        want = _weights(H_TAPS + V_TAPS, jnp.maximum(0.7, jnp.float32(n) / 200.0))
        np.testing.assert_allclose(tb.blur_weights(n).numpy(),
                                   np.array([float(w) for w in want]),
                                   rtol=2e-7)


def test_accumulate_and_albedo_match():
    lum, alb = _accumulators(1)
    lum[3, 0] = -1.0     # negative old values clamp to 0
    rng = np.random.RandomState(2)
    add = rng.rand(H * W, 3).astype(np.float32)
    inc = (rng.rand(H * W) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tf.accumulate(torch.as_tensor(lum), torch.as_tensor(add), 2.0).numpy(),
        np.asarray(jf.accumulate(jnp.asarray(lum), jnp.asarray(add), 2.0)))
    np.testing.assert_array_equal(
        tf.accumulate_albedo(torch.as_tensor(alb), torch.as_tensor(add),
                             torch.as_tensor(inc)).numpy(),
        np.asarray(jf.accumulate_albedo(jnp.asarray(alb), jnp.asarray(add),
                                        jnp.asarray(inc))))


@pytest.mark.parametrize('blur', [False, True])
def test_display_matches(blur):
    lum, alb = _accumulators(3, n=7.0)
    got = tf.display(torch.as_tensor(lum), torch.as_tensor(alb), 7.0, W, H,
                     blur=blur)
    want = jf.display(jnp.asarray(lum), jnp.asarray(alb), 7.0, W, H, blur=blur)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_energy_audit_matches():
    lum, _ = _accumulators(4, n=3.0)
    lum[5, 2] = np.nan
    lum[9, 0] = -0.5
    got = tf.energy_audit(torch.as_tensor(lum))
    want = jf.energy_audit(jnp.asarray(lum))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    assert bool(got[1]) and bool(want[1]) and bool(got[2]) and bool(want[2])
    clean = np.abs(np.nan_to_num(lum))
    got = tf.energy_audit(torch.as_tensor(clean))
    assert not bool(got[1]) and not bool(got[2])


def test_clear_accumulators():
    lum, alb = tf.clear_accumulators(12, 'cpu')
    assert lum.shape == alb.shape == (12, 4)
    assert not lum.any() and not alb.any()
