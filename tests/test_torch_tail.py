"""The port's full-size schedule against the JAX engine's on the CPU.

(a) The band geometry, the tile lane order and its inverse equal the JAX
package's, over several frame sizes, spp and lane caps, among them 1080p
(5 bands of 216 rows) and a frame without tile order.

(b) The room at 64x64 in 2 bands of 2,048 lanes with the tail gate lowered to
2,048 (``_torch_tail.py``): a clear frame and 2 converge samples, where every
band runs both tail levels and level 1 takes more than one round. ``rand_idx``
after each frame equals the JAX engine's exactly; at least 99% of the pixels
agree to 1e-3 relative + 1e-5 absolute, the energy to 1e-3 relative and the
guiding caches to 1e-3 relative + 1e-4 absolute."""
import numpy as np
import pytest
import torch

from cuda_pathtracer_tpu.models import pathtracer as jptm
from cuda_pathtracer_tpu_torch.models import pathtracer as tptm

import _torch_tail as tail

GEOMETRIES = [(1920, 1080, 1, 360000), (640, 480, 1, 360000),
              (1920, 1080, 4, 360000), (64, 64, 1, 2048), (64, 64, 2, 2048),
              (64, 48, 1, 1024), (100, 60, 1, 2048), (48, 40, 3, 1000)]


class _Stop(Exception):
    pass


def _jax_geometry(width, height, spp, max_lanes):
    """The JAX Pathtracer's band choice, read where __init__ makes it (before
    it touches the scene)."""
    seen = {}

    class Probe(jptm.Pathtracer):
        MAX_LANES_PER_DISPATCH = max_lanes

        def _set_bands(self, bands):
            super()._set_bands(bands)
            seen.update(bands=self.bands, band_h=self.band_h,
                        tile_order=self.tile_order)
            raise _Stop

    with pytest.raises(_Stop):
        Probe(None, width, height, spp=spp)
    return seen['bands'], seen['band_h'], seen['tile_order']


@pytest.mark.parametrize('width,height,spp,max_lanes', GEOMETRIES)
def test_band_geometry_matches_jax(width, height, spp, max_lanes):
    got = tptm.band_geometry(width, height, spp, max_lanes)
    assert got == _jax_geometry(width, height, spp, max_lanes)
    if (width, height, spp) == (1920, 1080, 1):
        assert got == (5, 216, True)
    if width == 100:
        assert got[2] is False


@pytest.mark.parametrize('width,height', [(1920, 1080), (64, 48), (48, 40),
                                          (100, 60)])
def test_tile_order_matches_jax(width, height):
    want = jptm.tile_permutation(width, height)
    got = tptm.tile_permutation(width, height)
    if width % 16 or height % 8:
        assert want is None and got is None
        return
    np.testing.assert_array_equal(got.numpy(), want)
    lanes = np.arange(width * height)
    jx, jy = jptm._tile_coords(lanes, width)
    tx, ty = tptm._tile_coords(torch.from_numpy(lanes), width)
    np.testing.assert_array_equal(tx.numpy(), jx)
    np.testing.assert_array_equal(ty.numpy(), jy)
    for bands in (b for b in (1, 2, 5) if height % b == 0
                  and (height // b) % 8 == 0):
        arr = np.random.RandomState(bands).rand(width * height, 4).astype(
            np.float32)
        want_u = np.asarray(jptm.tile_unpermute(arr, width, height // bands,
                                                bands))
        got_u = tptm.tile_unpermute(torch.from_numpy(arr), width,
                                    height // bands, bands)
        np.testing.assert_array_equal(got_u.numpy(), want_u)


@pytest.fixture(scope='module')
def renders():
    return tail.render_both(spp=1)


def test_rand_idx_matches_jax(renders):
    tail.check_geometry(renders, 1)
    assert renders.tpt.bands == 2
    assert renders.t_ridx == renders.j_ridx
    assert renders.t_ridx == [2, 28, 52]


def test_both_levels_multi_round(renders):
    assert len(renders.rounds) == 2
    for per_band in renders.rounds:
        assert len(per_band) == 2
        for levels in per_band:
            assert set(levels) == {tptm.TAIL_START, tptm.TAIL2_START}
            assert levels[tptm.TAIL_START] > 1, levels


def test_accumulators_agree(renders):
    tail.check_accumulators(renders)


def test_energy_agrees(renders):
    tail.check_energy(renders)


def test_guiding_agrees(renders):
    tail.check_guiding(renders)


def test_blurred_image_agrees(renders):
    got = renders.tpt.image(blur=True).numpy()
    want = np.asarray(renders.jpt.image(blur=True))
    assert got.shape == (tail.H, tail.W, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(axis=2)
    assert close.mean() >= 0.99
