"""One ``shade`` call of the port against the JAX package's on identical
inputs: the room's arrays bridged from the JAX export, the same rays, hits
(with barycentrics), path state, radiance cache and blue noise. Every output
is compared: flags, ids and buckets exactly, floats to 2e-5 relative (XLA's
CPU code contracts multiply-adds into FMAs, the port does not)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_room import build_room, CAMERA
from cuda_pathtracer_tpu.core import camera as jcam
from cuda_pathtracer_tpu.core import rng as jrng
from cuda_pathtracer_tpu.models import guiding as jg
from cuda_pathtracer_tpu.models import shading as jsh
from cuda_pathtracer_tpu.ops.traverse import Hit as JHit
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu_torch import bridge
from cuda_pathtracer_tpu_torch.models import guiding as tg
from cuda_pathtracer_tpu_torch.models import shading as tsh
from cuda_pathtracer_tpu_torch.ops.dispatch import trace
from cuda_pathtracer_tpu_torch.ops.traverse import Hit as THit, PRIM_PLANE, PRIM_SPHERE
from cuda_pathtracer_tpu_torch.scene.builder import add_cube

W, H = 32, 24
B = W * H


@pytest.fixture(scope='module')
def inputs():
    jscene = build_room(js, add_cube)
    jarr, jdyn = jscene.to_device(), jscene.dynamic_arrays()
    tarr = bridge.scene_arrays(jax.tree.map(np.asarray, jarr), 'cpu')
    tdyn = bridge.dynamic_arrays(jax.tree.map(np.asarray, jdyn),
                                 jscene.wide_depth, 'cpu')
    ys, xs = np.mgrid[0:H, 0:W]
    xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    seeds = jrng.get_seed(jnp.asarray(xs), jnp.asarray(ys), 0, W)
    ro, rd, _ = jcam.generate_rays(jcam.Camera.create(**CAMERA),
                                   jnp.asarray(xs), jnp.asarray(ys), seeds, W, H)
    ro, rd = np.asarray(ro), np.asarray(rd)
    rs = np.random.RandomState(21)
    active = rs.rand(B) < 0.9
    hit = trace(tarr, tdyn, torch.as_tensor(ro), torch.as_tensor(rd),
                active=torch.as_tensor(active), want_uv=True)
    hit = {k: v.numpy() for k, v in hit._asdict().items()}
    # every kind of surface is in view: triangles (textured floor,
    # normal-mapped back wall), both spheres and the checkerboard plane
    kinds = hit['prim_type'][hit['intersected']]
    assert (kinds == PRIM_PLANE).any() and (kinds == PRIM_SPHERE).any()
    mids = tarr.tri_mat[tdyn.tri_gid[torch.as_tensor(
        hit['prim_id'][hit['intersected'] & (hit['prim_type'] == 0)]).long()].long()]
    assert (tarr.mat_normal_tex[mids.long()] >= 0).any()
    assert (tarr.mat_tex[mids.long()] >= 0).any()
    state = dict(mask=(rs.rand(B, 3) * 0.9 + 0.1).astype(np.float32),
                 accucolor=(rs.rand(B, 3) * 2).astype(np.float32),
                 light=(rs.rand(B, 3)).astype(np.float32),
                 from_specular=rs.rand(B) < 0.5,
                 albedo_set=rs.rand(B) < 0.3)
    n_tris = int(jarr.tri_mat.shape[0])
    cache = (rs.rand(n_tris, 8) * 1.9 + 0.1).astype(np.float32)
    radiance = dict(cache=cache, total=cache.sum(1).astype(np.float32))
    bn = rs.rand(B).astype(np.float32)
    return (jarr, jdyn, tarr, tdyn, xs, ys, ro, rd, active, hit, state,
            radiance, bn)


def _shade_both(inputs, sample_idx, cache_on, rand_idx, uv: bool = True):
    """Flat dicts of the JAX and the port's shade outputs; ``uv=False``
    hands both a hit without barycentrics (u = v = None)."""
    (jarr, jdyn, tarr, tdyn, xs, ys, ro, rd, active, hit, state, radiance,
     bn) = inputs
    hit = {k: v for k, v in hit.items() if uv or k not in ('u', 'v')}
    J = jnp.asarray
    T = torch.as_tensor
    jout = jsh.shade(jarr, jdyn, J(ro), J(rd), JHit(**{k: J(v) for k, v in hit.items()}),
                     jsh.TraceState(**{k: J(v) for k, v in state.items()}),
                     J(active), J(xs), J(ys), jnp.uint32(rand_idx),
                     jnp.uint32(sample_idx), 0, True, cache_on,
                     jg.RadianceState(J(radiance['cache']), J(radiance['total'])),
                     W, bn_sample=J(bn))
    tout = tsh.shade(tarr, tdyn, T(ro), T(rd),
                     THit(**{k: T(v) for k, v in hit.items()}),
                     tsh.TraceState(**{k: T(v) for k, v in state.items()}),
                     T(active), T(xs), T(ys), rand_idx, sample_idx, True,
                     cache_on, tg.RadianceState(T(radiance['cache']),
                                                T(radiance['total'])),
                     W, T(bn))
    assert tout.alive.any() and tout.shadow_active.any()
    if cache_on:
        assert (tout.cache_stype == jg.SAMPLE_BUCKET).any()
    flat = []
    for out in (jout, tout):
        d = dict(out._asdict(), **{f's.{k}': v for k, v in
                                   out.state._asdict().items()})
        del d['state']
        flat.append({k: np.asarray(v) for k, v in d.items()})
    return flat


def _assert_outputs_close(got, want, rtol, atol):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.dtype == np.float32:
            assert np.isfinite(g).all(), k
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)


@pytest.mark.parametrize('sample_idx,cache_on,rand_idx', [
    (0, True, 1), (5, True, 4), (7, False, 9)])
def test_shade_matches_jax(inputs, sample_idx, cache_on, rand_idx):
    jflat, tflat = _shade_both(inputs, sample_idx, cache_on, rand_idx)
    _assert_outputs_close(tflat, jflat, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize('sample_idx,cache_on,rand_idx', [
    (0, True, 1), (7, False, 9)])
def test_shade_reintersects_without_uv(inputs, sample_idx, cache_on,
                                       rand_idx):
    """A hit without barycentrics (the v1 traversal's): the port
    re-intersects the winning triangle from ``world_tris``, the JAX package
    from ``tri_meta``. Held to the JAX shade without uv and to the port's
    own shade with the traversal's uv, within 1e-5."""
    jflat, tflat = _shade_both(inputs, sample_idx, cache_on, rand_idx,
                               uv=False)
    _assert_outputs_close(tflat, jflat, rtol=1e-5, atol=1e-5)
    _, with_uv = _shade_both(inputs, sample_idx, cache_on, rand_idx)
    _assert_outputs_close(tflat, with_uv, rtol=1e-5, atol=1e-5)
