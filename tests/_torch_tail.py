"""The small room rendered by the JAX ``Pathtracer`` and by the port's in the
full-size regime, shared by ``test_torch_tail.py`` and ``test_torch_spp.py``.

``render_both(spp)`` renders the room (``_torch_room.py``) at 64x64 with the
lane cap of a dispatch lowered to 2,048 (bands of 2,048 lanes: 2 bands of 32
rows at spp 1, 4 of 16 at spp 2, tile order on) and the tail gate lowered to
2,048 lanes, so bands, tile order, both tail levels and multi-round level-1
tails all run. One clear frame, then two converge dispatches. Both packages'
attributes are patched for the call only; the JAX engine's compiled
``render_sample`` is dropped before and after, since the gate is read while
it traces.

``lowered_gate(spp)`` is that patch as a context manager, for tests that
drive the engines themselves.
"""
import contextlib

import numpy as np
import pytest

from _torch_room import build_room, CAMERA
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu.models import pathtracer as jptm
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu_torch.core.camera import Camera as TCamera
from cuda_pathtracer_tpu_torch.models import pathtracer as tptm
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.builder import add_cube

W = H = 64
LANES = 2048


class Result:
    def __init__(self, jpt, tpt, j_ridx, t_ridx, rounds):
        self.jpt, self.tpt = jpt, tpt
        self.j_ridx, self.t_ridx = j_ridx, t_ridx
        # per converge dispatch, per band: {level start bounce: rounds}
        self.rounds = rounds


@contextlib.contextmanager
def lowered_gate(spp: int = 1):
    """Both packages' lane cap and tail gate at LANES and their
    SPP_PER_DISPATCH at ``spp`` for the body; yields the MonkeyPatch. The
    JAX engine's compiled ``render_sample`` is dropped before and after."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, cls in ((jptm, jptm.Pathtracer), (tptm, tptm.Pathtracer)):
            mp.setattr(mod, 'TAIL_MIN_LANES', LANES)
            mp.setattr(cls, 'MAX_LANES_PER_DISPATCH', LANES)
            mp.setattr(cls, 'SPP_PER_DISPATCH', spp)
        jptm.render_sample.clear_cache()
        try:
            yield mp
        finally:
            jptm.render_sample.clear_cache()


def render_both(spp: int) -> Result:
    rounds = []
    band_rounds = {}

    def count_round(orig):
        def wrapped(*args, **kw):
            start_b = args[5]
            band_rounds[start_b] = band_rounds.get(start_b, 0) + 1
            return orig(*args, **kw)
        return wrapped

    def band(orig):
        def wrapped(*args, **kw):
            band_rounds.clear()
            out = orig(*args, **kw)
            rounds[-1].append(dict(band_rounds))
            return out
        return wrapped

    with lowered_gate(spp) as mp:
        mp.setattr(tptm, '_tail_round', count_round(tptm._tail_round))
        mp.setattr(tptm, 'render_sample', band(tptm.render_sample))
        jpt = jptm.Pathtracer(build_room(js, add_cube), W, H)
        tpt = tptm.Pathtracer(build_room(ts, add_cube), W, H, device='cpu')
        jcam = JCamera.create(**CAMERA)
        tcam = TCamera.create(**CAMERA, device='cpu')
        j_ridx, t_ridx = [], []
        for clear in (True, False, False):
            rounds.append([])
            jpt.render(jcam, should_clear=clear)
            tpt.render(tcam, should_clear=clear)
            j_ridx.append(int(jpt.rand_idx))
            t_ridx.append(tpt.rand_idx)
    return Result(jpt, tpt, j_ridx, t_ridx, rounds[1:])


def check_geometry(r: Result, spp: int):
    for pt in (r.jpt, r.tpt):
        assert pt.band_h * W * spp == LANES and pt.tile_order
    assert (r.tpt.bands, r.tpt.band_h) == (r.jpt.bands, r.jpt.band_h)


def check_accumulators(r: Result, min_share: float = 0.99):
    assert r.tpt.sample_idx == r.jpt.sample_idx
    for got, want in zip(r.tpt.accumulators_pixel_order(),
                         r.jpt.accumulators_pixel_order()):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (W * H, 4)
        np.testing.assert_array_equal(got[:, 3], want[:, 3])
        close = np.isclose(got[:, :3], want[:, :3], rtol=1e-3,
                           atol=1e-5).all(axis=1)
        print(f'pixels within tolerance: {close.mean():.4f}')
        assert close.mean() >= min_share


def check_energy(r: Result):
    (te, tnan, tneg), (je, jnan, jneg) = r.tpt.energy(), r.jpt.energy()
    assert not (tnan or tneg or jnan or jneg)
    assert te > 0
    np.testing.assert_allclose(te, je, rtol=1e-3)


def check_guiding(r: Result):
    got = r.tpt.radiance.cache.numpy()
    want = np.asarray(r.jpt.radiance.cache)
    assert (got != 0.1).any()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
