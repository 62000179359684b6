"""The port's batched dispatch (``SPP_PER_DISPATCH`` 2: two sample-major lane
blocks, each with its own ``rand_idx`` window) against the JAX engine's with
the same setting, on the room at 64x64 in bands of 2,048 lanes (4 bands of 16
rows) with the tail gate lowered to 2,048 (``_torch_tail.py``): a clear frame
and 2 converge dispatches of 2 samples each. ``rand_idx`` after each frame
equals the JAX engine's exactly; at least 99% of the pixels agree to 1e-3
relative + 1e-5 absolute, the energy to 1e-3 relative and the guiding caches
(the EMA run once per sample) to 1e-3 relative + 1e-4 absolute."""
import pytest

from cuda_pathtracer_tpu_torch.models import pathtracer as tptm

import _torch_tail as tail


@pytest.fixture(scope='module')
def renders():
    return tail.render_both(spp=2)


def test_rand_idx_matches_jax(renders):
    tail.check_geometry(renders, 2)
    assert renders.tpt.bands == 4
    assert renders.tpt.sample_idx == 1 + 2 * 2
    assert renders.t_ridx == renders.j_ridx


def test_tail_ran(renders):
    for per_band in renders.rounds:
        assert len(per_band) == 4
        assert all(levels.get(tptm.TAIL_START, 0) >= 1 for levels in per_band)
    assert any(levels[tptm.TAIL_START] > 1 for per_band in renders.rounds
               for levels in per_band)


def test_accumulators_agree(renders):
    tail.check_accumulators(renders)


def test_energy_agrees(renders):
    tail.check_energy(renders)


def test_guiding_agrees(renders):
    tail.check_guiding(renders)
