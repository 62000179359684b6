"""The port's Whitted raytracer (``models/raytracer.py``) against the JAX
package's on the CPU.

(a) The animated ``outside`` scene at 32x24 (``cube.obj`` written by the
test), after ``update(None, 2.0)`` so the clearing frame refits the moved
cubes: a clearing frame (depth 2) and a converged one (depth 7), on the v2
and on the v1 traversal. At least 99.5% of the pixels agree to 1e-3
relative + 1e-5 absolute, the frame's sum to 1e-4 relative and the active
lanes of every level to 0.5%.

(b) ``_torch_room.py``'s glass room, where a clear sphere fills the view:
the lane cap (2x the pixels) drops active lanes, and the port keeps the
lanes the JAX package keeps (the same tolerances).

(c) ``_compact`` keeps the JAX ``_compact``'s active lanes, in its order,
on weights full of ties, and so does the ascending order of the card's
compaction keys (``whitted_lanes.falling_keys``); ``Raytracer.image`` is the JAX package's display
of the frame (w = 1, no blur whatever ``blur`` says).

(d) The card's route of a level (``_shade_level_kernels``: shadow rays in
[L, n] blocks, children in 2n-row buffers), its two kernels stood in by
plain code, gives the plain route's frame and stats on the CPU.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_room import GLASS_CAMERA, build_glass_room, write_cube_obj
from _torch_whitted import agree, count_traversals, jax_frames
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu.models import raytracer as jrt
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu.scene.builder import get_outside_scene as j_outside
from cuda_pathtracer_tpu_torch.core import vecmath as vm
from cuda_pathtracer_tpu_torch.core.camera import Camera as TCamera
from cuda_pathtracer_tpu_torch.models import raytracer as trt
from cuda_pathtracer_tpu_torch.ops import dispatch as tdispatch
from cuda_pathtracer_tpu_torch.ops import whitted_lanes
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.builder import add_cube
from cuda_pathtracer_tpu_torch.scene.builder import get_outside_scene as t_outside

W, H = 32, 24
OUTSIDE_CAMERA = dict(eye=[0.0, 4.0, -17.0], view_dir=[0.0, -0.2, 1.0],
                      d=1.5, focal_length=12.0, aperture=0.02)
ROUTES = pytest.mark.parametrize('v1', [False, True], ids=['v2', 'v1'])


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return write_cube_obj(tmp_path_factory.mktemp('whitted'))


@pytest.fixture(scope='module')
def jax_outside(assets):
    """{depth: (frame, active lanes per level)}: the scene moved to t = 2,
    then a clearing frame (depth 2) and a converged one (depth 7)."""
    scene = j_outside(asset_dirs=[assets])
    scene.update(None, 2.0)
    out = jax_frames(scene, JCamera.create(**OUTSIDE_CAMERA), (True, False),
                     W, H)
    return {2: out[0], 7: out[1]}


def _check(got, got_stats, want, want_active):
    assert got.shape == want.shape == (W * H, 3)
    assert np.isfinite(got).all() and (got >= 0).all()
    share = agree(got, want)
    print(f'pixels within tolerance: {share:.4f}; sums {got.sum()} '
          f'{want.sum()}; active per level {[s["active"] for s in got_stats]} '
          f'vs {want_active}')
    assert share >= 0.995
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)
    active = np.array([s['active'] for s in got_stats])
    assert len(active) == len(want_active)
    np.testing.assert_allclose(active, want_active, rtol=0.005)


@ROUTES
@pytest.mark.parametrize('depth', [2, 7])
def test_outside_matches_jax(assets, jax_outside, monkeypatch, v1, depth):
    scene = t_outside(asset_dirs=[assets])
    monkeypatch.setattr(tdispatch, 'PACKET_V1', v1)
    calls = count_traversals(monkeypatch)
    rt = trt.Raytracer(scene, W, H, device='cpu')
    scene.update(None, 2.0)
    cam = TCamera.create(**OUTSIDE_CAMERA, device='cpu')
    refits = scene.refits
    stats = []
    rt.render(cam, should_clear=True, stats=stats if depth == 2 else None)
    assert scene.refits == refits + 1
    if depth == 7:
        rt.render(cam, should_clear=False, stats=stats)
    assert (calls['v1'] > 0, calls['v2'] > 0) == (v1, not v1), calls
    assert len(stats) == depth
    assert stats[0]['lanes'] == stats[0]['active'] == W * H
    assert all(s['lanes'] == 2 * W * H for s in stats[1:])
    _check(rt.frame.numpy(), stats, *jax_outside[depth])


@pytest.fixture(scope='module')
def jax_glass():
    return jax_frames(build_glass_room(js, add_cube),
                      JCamera.create(**GLASS_CAMERA), (False,), W, H)[0]


@ROUTES
def test_glass_room_cap_matches_jax(jax_glass, monkeypatch, v1):
    monkeypatch.setattr(tdispatch, 'PACKET_V1', v1)
    calls = count_traversals(monkeypatch)
    rt = trt.Raytracer(build_glass_room(ts, add_cube), W, H, device='cpu')
    stats = []
    rt.render(TCamera.create(**GLASS_CAMERA, device='cpu'), stats=stats)
    assert (calls['v1'] > 0, calls['v2'] > 0) == (v1, not v1), calls
    dropped = [s['dropped'] for s in stats]
    print(f'active lanes dropped by the cap per level: {dropped}')
    assert dropped[:2] == [0, 0] and max(dropped) > 0
    # a level the cap cut is full, in both packages
    for s, n in zip(stats, jax_glass[1]):
        if s['dropped']:
            assert s['active'] == n == 2 * W * H
    _check(rt.frame.numpy(), stats, *jax_glass)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_compact_matches_jax(seed):
    """Weights drawn from a few values, so most lanes tie."""
    rng = np.random.RandomState(seed)
    n, cap = 4096, 1024
    w = rng.choice([0.0, 0.25, 0.5, 1e-6, 0.75], size=(n, 3)).astype(np.float32)
    active = rng.rand(n) < 0.6
    ro = rng.rand(n, 3).astype(np.float32)
    rd = rng.rand(n, 3).astype(np.float32)
    pixel = np.arange(n, dtype=np.int32)
    jro, jrd, jw, jpix, jact = jrt._compact(
        *(jnp.asarray(a) for a in (ro, rd, w, pixel, active)), cap)
    keep = np.asarray(jact)
    (tro, trd, tw, tpix), dropped, sort = trt._compact(
        *(torch.from_numpy(a) for a in (ro, rd, w)),
        torch.from_numpy(pixel.astype(np.int64)), torch.from_numpy(active),
        cap, True)
    assert dropped == int(active.sum()) - cap > 0
    assert sort == 'library'
    np.testing.assert_array_equal(tpix.numpy(), np.asarray(jpix)[keep])
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw)[keep])
    np.testing.assert_array_equal(tro.numpy(), np.asarray(jro)[keep])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_compact_keys_match_jax(seed):
    """The card's compaction sorts one 64-bit key a lane
    (``whitted_lanes.falling_keys``): on the weights of
    :func:`test_compact_matches_jax`, the keys are unique and their
    ascending order, cut to the cap, is ``argsort(-score, stable=True)``'s
    and keeps the JAX ``_compact``'s lanes in its order."""
    rng = np.random.RandomState(seed)
    n, cap = 4096, 1024
    w = rng.choice([0.0, 0.25, 0.5, 1e-6, 0.75], size=(n, 3)).astype(np.float32)
    active = rng.rand(n) < 0.6
    pixel = np.arange(n, dtype=np.int32)
    _, _, _, jpix, jact = jrt._compact(
        *(jnp.asarray(a) for a in (rng.rand(n, 3).astype(np.float32),
                                   rng.rand(n, 3).astype(np.float32), w,
                                   pixel, active)), cap)
    tw = torch.from_numpy(w)
    idx = torch.nonzero(torch.from_numpy(active)).squeeze(1)
    keys = whitted_lanes.falling_keys(tw, idx)
    assert torch.unique(keys).shape == keys.shape
    order = torch.sort(keys).values & 0xffffffff
    want = idx[torch.argsort(-vm.max_comp(tw[idx]), stable=True)]
    assert torch.equal(order, want)
    np.testing.assert_array_equal(order[:cap].numpy(),
                                  np.asarray(jpix)[np.asarray(jact)])


def test_image_matches_jax():
    """The display of one frame, the same in both packages, blur or not."""
    frame = np.random.RandomState(3).rand(W * H, 3).astype(np.float32) * 2
    jr = jrt.Raytracer.__new__(jrt.Raytracer)
    jr.width, jr.height, jr.frame = W, H, jnp.asarray(frame)
    tr = trt.Raytracer.__new__(trt.Raytracer)
    tr.width, tr.height, tr.device = W, H, torch.device('cpu')
    tr.frame = torch.from_numpy(frame)
    want = np.asarray(jr.image(blur=True))
    got = tr.image(blur=True).numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got, tr.image().numpy())


def _pre_standin(calls):
    """``whitted_shade.shade_pre``'s contract from the plain version: its
    shadow traces' rays, stacked into [L, n] blocks."""
    def pre(tables, lv):
        (scene, dyn), (ro, rd, hit) = tables, lv
        rays = []

        def fake(scene_, dyn_, o, d, *, t_max=None, active=None,
                 any_hit=False):
            if any_hit:
                rays.append((o, d, t_max, active))
                return hit._replace(intersected=torch.zeros_like(active))
            return hit
        calls['pre'] += 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trt, 'trace', fake)
            trt._shade_level(scene, dyn, ro, rd, torch.ones_like(ro))
        return tuple(torch.stack(x) for x in zip(*rays))
    return pre


def _post_standin(calls):
    """``whitted_shade.shade_post``'s contract from the plain version, given
    the shadow traces' hits: the contribution added into the frame, the
    shadow rays into the counter, the children written into 2n-row buffers
    (refract rows [0, n), reflect rows [n, 2n))."""
    def post(tables, lv, weight, pixel, occluded, out, shadow):
        (scene, dyn), (ro, rd, hit) = tables, lv
        lights = iter(occluded)

        def fake(scene_, dyn_, o, d, *, any_hit=False, **kw):
            return hit._replace(intersected=next(lights)) if any_hit else hit
        calls['post'] += 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trt, 'trace', fake)
            contrib, rays, children = trt._shade_level(scene, dyn, ro, rd,
                                                       weight)
        out.index_add_(0, pixel, contrib)
        shadow += rays
        n = ro.shape[0]
        bufs = [torch.empty((2 * n, 3)) for _ in range(3)] + [
            torch.empty(2 * n, dtype=torch.int64),
            torch.empty(2 * n, dtype=torch.bool)]
        for half, (o, d, w, a) in zip((slice(0, n), slice(n, 2 * n)),
                                      children):
            for buf, x in zip(bufs, (o, d, w, pixel, a)):
                buf[half] = x
        return tuple(bufs)
    return post


@pytest.mark.parametrize('room', [False, True], ids=['outside', 'glass_room'])
def test_kernel_route_layout_matches_plain_route(assets, monkeypatch, room):
    """The frame and stats of depth-7 frames, bit for bit: the outside scene
    moved to t = 2 (three lights, the checker plane, moved cubes) and the
    glass room (inside hits, total internal reflection, the lane cap)."""
    if room:
        scene, cam = build_glass_room(ts, add_cube), GLASS_CAMERA
    else:
        scene, cam = t_outside(asset_dirs=[assets]), OUTSIDE_CAMERA
        scene.update(None, 2.0)
    camera = TCamera.create(**cam, device='cpu')
    rt = trt.Raytracer(scene, W, H, device='cpu')
    rt.render(camera, should_clear=True)
    frames, stats = [], []
    for route in ('plain', 'kernels'):
        if route == 'kernels':
            calls = {'pre': 0, 'post': 0}
            # the scene's and the level's arrays handed on as they are
            monkeypatch.setattr(
                trt, '_level_plain', lambda scene, dyn, *a:
                trt._shade_level_kernels((scene, dyn), scene, dyn, *a))
            monkeypatch.setattr(trt.whitted_shade, 'level',
                                lambda ro, rd, hit: (ro, rd, hit))
            monkeypatch.setattr(trt.whitted_shade, 'shade_pre',
                                _pre_standin(calls))
            monkeypatch.setattr(trt.whitted_shade, 'shade_post',
                                _post_standin(calls))
        stats.append([])
        rt.render(camera, should_clear=False, stats=stats[-1])
        frames.append(rt.frame.clone())
    levels = sum(1 for s in stats[0] if s['active'])
    assert calls == {'pre': levels, 'post': levels} and levels == 7
    assert sum(s['shadow'] for s in stats[0]) > 0
    if room:
        assert max(s['dropped'] for s in stats[0]) > 0
    assert stats[0] == stats[1]
    assert torch.equal(frames[0], frames[1])
