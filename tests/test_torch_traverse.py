"""The port's trace (prepass + ``traverse_merged_ref``) against the JAX
package's ``traverse_packet2`` Pallas kernel in interpret mode, on the small
room with 2048 rays (camera rays plus random rays from inside the room) that
mix closest-hit lanes with barycentrics, any-hit lanes with a short ``t_max``
and inactive lanes.

The JAX kernel runs in a subprocess (``_torch_jax_traverse.py``) with XLA
limited to AVX: XLA's CPU code otherwise contracts ``a*b + c`` into FMAs and
moves ``t`` by up to 3 ulp, while the port (and its CUDA kernel, built with
``-fmad=false``) rounds every product and sum. Bounds, with that: ``found``
identical; ``t`` bit-identical (0 ulp); ``prim_id`` equal except where two
triangles tie at exactly the same ``t``; ``u, v`` within 1e-6. Both JAX
schedules run: the default share-8 steps and the sequential ``share=0``
steps. The port descends in the sequential order, so against ``share=0``
every output, any-hit ``t`` included, is bit-identical; any-hit ``t`` under
share-8 depends on which occluder its batch met first, and the renderer
reads only the any-hit flag.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_room import build_room
from cuda_pathtracer_tpu_torch.ops.dispatch import trace
from cuda_pathtracer_tpu_torch.ops.traverse import PRIM_TRIANGLE
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.builder import add_cube

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp('jax_traverse')
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_cpu_max_isa=AVX')
    procs = {share: subprocess.Popen(
        [sys.executable, os.path.join(HERE, '_torch_jax_traverse.py'),
         str(out / f'share{share}.npz'), str(share)],
        env=env, cwd=HERE, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for share in (0, 8)}
    for share, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
    jax_hits = {share: dict(np.load(out / f'share{share}.npz'))
                for share in procs}
    z = jax_hits[0]
    scene = build_room(ts, add_cube)
    h = trace(scene.to_device('cpu'), scene.dynamic_arrays('cpu'),
              torch.as_tensor(z['ro']), torch.as_tensor(z['rd']),
              t_max=torch.as_tensor(z['t_max']),
              active=torch.as_tensor(z['active']),
              stop_on_hit=torch.as_tensor(z['stop']), want_uv=True)
    port = {k: v.numpy() for k, v in h._asdict().items()}
    return port, jax_hits


def _bits(x):
    return x.view(np.int32)


def test_closest_hit_with_uv(runs):
    port, jh = runs
    z = jh[0]
    lanes = z['active'] & ~z['stop']
    assert 0.5 < port['intersected'][lanes].mean() < 1.0
    for want in jh.values():
        np.testing.assert_array_equal(port['intersected'][lanes],
                                      want['intersected'][lanes])
        np.testing.assert_array_equal(_bits(port['t'][lanes]),
                                      _bits(want['t'][lanes]))
        hit = lanes & port['intersected']
        np.testing.assert_array_equal(port['prim_type'][hit],
                                      want['prim_type'][hit])
        tie = hit & (port['prim_id'] != want['prim_id'])
        # t is bit-identical above, so a differing id is an exact-t tie
        assert (port['prim_type'][tie] == PRIM_TRIANGLE).all()
        assert tie.sum() <= 0.01 * hit.sum(), tie.sum()
        same = hit & ~tie & (port['prim_type'] == PRIM_TRIANGLE)
        assert same.sum() > 500
        for k in ('u', 'v'):
            np.testing.assert_allclose(port[k][same], want[k][same],
                                       rtol=0, atol=1e-6)


def test_any_hit_with_t_max(runs):
    port, jh = runs
    lanes = jh[0]['active'] & jh[0]['stop']
    assert 0.1 < port['intersected'][lanes].mean() < 0.95
    for want in jh.values():
        np.testing.assert_array_equal(port['intersected'][lanes],
                                      want['intersected'][lanes])
    np.testing.assert_array_equal(_bits(port['t'][lanes]),
                                  _bits(jh[0]['t'][lanes]))


def test_inactive_lanes(runs):
    port, jh = runs
    off = ~jh[0]['active']
    assert off.sum() > 300
    assert not port['intersected'][off].any()
    np.testing.assert_array_equal(_bits(port['t'][off]),
                                  _bits(jh[8]['t'][off]))


def test_sequential_schedule_bit_exact(runs):
    """Against the JAX kernel's sequential steps every output matches."""
    port, jh = runs
    want = jh[0]
    for k in ('intersected', 'prim_type', 'prim_id'):
        np.testing.assert_array_equal(port[k], want[k], err_msg=k)
    for k in ('t', 'u', 'v'):
        np.testing.assert_array_equal(_bits(port[k]), _bits(want[k]),
                                      err_msg=k)
