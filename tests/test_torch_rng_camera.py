"""The port's RNG is bit-exact with the JAX package's, and its camera rays
agree to 1e-6 relative (sin, cos and sqrt come from different math
libraries, so the last bit may differ)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cuda_pathtracer_tpu.core import camera as jcam
from cuda_pathtracer_tpu.core import rng as jrng
from cuda_pathtracer_tpu_torch.core import camera as tcam
from cuda_pathtracer_tpu_torch.core import rng as trng

SEEDS = np.concatenate([np.array([0, 1, 2 ** 32 - 1, 2 ** 31, 0xdeadbeef],
                                 np.uint32),
                        np.random.RandomState(3).randint(
                            0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)])


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize('fn', ['wang_hash', 'xorshift'])
def test_hash_bit_exact(fn):
    want = np.asarray(getattr(jrng, fn)(jnp.asarray(SEEDS)))
    got = getattr(trng, fn)(_t(SEEDS)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2 ** 32


def test_rand_uniform_chain_bit_exact():
    js, ts = jnp.asarray(SEEDS), _t(SEEDS)
    for _ in range(20):
        jv, js = jrng.rand_uniform(js)
        tv, ts = trng.rand_uniform(ts)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))


@pytest.mark.parametrize('rand_idx', [0, 1, 7, 2 ** 32 - 1])
def test_get_seed_bit_exact(rand_idx):
    ys, xs = np.mgrid[0:24, 0:40]
    xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    want = np.asarray(jrng.get_seed(jnp.asarray(xs), jnp.asarray(ys),
                                    np.uint32(rand_idx), 40))
    got = trng.get_seed(torch.as_tensor(xs), torch.as_tensor(ys), rand_idx, 40)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize('sample_idx', [0, 1, 5])
def test_rand_blue_noise_gate_bit_exact(sample_idx):
    """sampleIdx < 1 draws the quasirandom blue-noise channel, else
    xorshift (src/kernels.h:20-29); both advance the seed."""
    rs = np.random.RandomState(sample_idx)
    bn = rs.rand(len(SEEDS)).astype(np.float32)
    bn_idx = rs.randint(0, 40, len(SEEDS)).astype(np.uint32)
    jst = jrng.RandState(jnp.asarray(SEEDS), jnp.asarray(bn),
                         jnp.asarray(bn_idx), jnp.uint32(sample_idx))
    tst = trng.RandState(_t(SEEDS), torch.as_tensor(bn), _t(bn_idx),
                         sample_idx)
    for _ in range(12):
        jv, jst = jrng.rand(jst)
        tv, tst = trng.rand(tst)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tst.seed.numpy().astype(np.uint32),
                                      np.asarray(jst.seed))
        np.testing.assert_array_equal(tst.bn_idx.numpy().astype(np.uint32),
                                      np.asarray(jst.bn_idx))


def test_make_state_forces_xorshift_without_blue_noise():
    st = trng.make_state(_t(SEEDS[:4]))
    assert st.sample_idx == 1
    assert np.asarray(jrng.make_state(jnp.asarray(SEEDS[:4])).sample_idx) == 1


@pytest.mark.parametrize('cam', [
    dict(eye=[0.0, 1.6, -4.2], view_dir=[0.0, -0.12, 1.0], d=1.5,
         focal_length=5.0, aperture=0.02),
    dict(eye=[0.0, 5.0, -16.0], view_dir=[0.0, 0.0, 1.0], d=1.5,
         focal_length=12.0, aperture=0.0),
    dict(eye=[1.0, -2.0, 3.0], view_dir=[-0.6, 0.3, 0.74], d=1.1,
         focal_length=3.0, aperture=0.3),
])
def test_generate_rays_agree(cam):
    W, H = 48, 32
    ys, xs = np.mgrid[0:H, 0:W]
    xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    seeds = np.asarray(jrng.get_seed(jnp.asarray(xs), jnp.asarray(ys), 3, W))
    jo, jd, _ = jcam.generate_rays(jcam.Camera.create(**cam), jnp.asarray(xs),
                                   jnp.asarray(ys), jnp.asarray(seeds), W, H)
    to, td, _ = tcam.generate_rays(tcam.Camera.create(**cam, device='cpu'),
                                   torch.as_tensor(xs), torch.as_tensor(ys),
                                   _t(seeds), W, H)
    for got, want in ((to, jo), (td, jd)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
