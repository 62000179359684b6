"""The port's v1 traversal (prepass + ``traverse_packet_ref`` on the split
inner/leaf tables) against the JAX package's ``traverse_packet`` Pallas
kernel in interpret mode, on the small room with the 2048 rays of
``_torch_jax_traverse.py``: camera rays and random rays from inside the room,
closest-hit lanes, stop-on-hit lanes with a short ``t_max`` and inactive
lanes, then the same rays as one any-hit call.

The JAX kernel runs in a subprocess with XLA limited to AVX (no FMA), so
``t`` can be compared bit for bit. Bounds: ``found`` equal on every lane;
``t`` bit-identical on closest-hit lanes; ``prim_id`` equal except where two
triangles tie at exactly the same ``t`` (the packet visits its leaves in
another order than one ray does); any-hit lanes agree on ``found``. The
traversal returns no barycentrics.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_room import build_room
from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
from cuda_pathtracer_tpu_torch.ops.traverse import PRIM_TRIANGLE
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene.builder import add_cube

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp('jax_traverse_v1') / 'v1.npz'
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_cpu_max_isa=AVX')
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, '_torch_jax_traverse.py'),
         str(out), 'v1'], env=env, cwd=HERE, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    z = dict(np.load(out))
    scene = build_room(ts, add_cube)
    arr, dyn = scene.to_device('cpu'), scene.dynamic_arrays('cpu')
    tables = tp1.PacketTables(dyn.packet_inner, dyn.packet_leaf, dyn.depth)
    T = torch.as_tensor
    common = dict(t_max=T(z['t_max']), active=T(z['active']))
    h = tp1.traverse_packet(arr, tables, T(z['ro']), T(z['rd']),
                            stop_on_hit=T(z['stop']), **common)
    ha = tp1.traverse_packet(arr, tables, T(z['ro']), T(z['rd']),
                             any_hit=True, **common)
    assert h.u is None and h.v is None
    port = {k: v.numpy() for k, v in h._asdict().items() if v is not None}
    port.update({'any_' + k: v.numpy() for k, v in ha._asdict().items()
                 if v is not None})
    return port, z


def _bits(x):
    return x.view(np.int32)


def test_closest_hit(runs):
    port, z = runs
    lanes = z['active'] & ~z['stop']
    assert 0.5 < port['intersected'][lanes].mean() < 1.0
    np.testing.assert_array_equal(port['intersected'], z['intersected'])
    np.testing.assert_array_equal(_bits(port['t'][lanes]),
                                  _bits(z['t'][lanes]))
    hit = lanes & port['intersected']
    np.testing.assert_array_equal(port['prim_type'][hit], z['prim_type'][hit])
    tie = hit & (port['prim_id'] != z['prim_id'])
    # t is bit-identical above, so a differing id is an exact-t tie
    assert (port['prim_type'][tie] == PRIM_TRIANGLE).all()
    assert tie.sum() <= 0.01 * hit.sum(), tie.sum()
    assert (hit & (port['prim_type'] == PRIM_TRIANGLE)).sum() > 500


def test_stop_on_hit_lanes(runs):
    port, z = runs
    lanes = z['active'] & z['stop']
    assert 0.1 < port['intersected'][lanes].mean() < 0.95
    np.testing.assert_array_equal(port['intersected'][lanes],
                                  z['intersected'][lanes])


def test_any_hit_call(runs):
    port, z = runs
    lanes = z['active']
    assert 0.3 < port['any_intersected'][lanes].mean() < 1.0
    np.testing.assert_array_equal(port['any_intersected'],
                                  z['any_intersected'])


def test_inactive_lanes(runs):
    port, z = runs
    off = ~z['active']
    assert off.sum() > 300
    assert not port['intersected'][off].any()
    np.testing.assert_array_equal(_bits(port['t'][off]), _bits(z['t'][off]))
