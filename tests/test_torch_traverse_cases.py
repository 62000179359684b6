"""Both plain traversal walks against the JAX package's kernels on the hard
cases of ``_torch_traverse_cases.py``: rays along the axes, grazing box
faces, starting inside boxes, at exact-t ties inside one leaf and between two
leaves, with a t_max shorter than every hit, stop-on-hit and dead lanes, and
down a chain of 24 nested boxes that runs the stack deeper than the room.

The JAX kernels run in interpret mode in a subprocess with XLA limited to AVX
(no FMA), so ``t`` compares bit for bit. Bounds, per case:
  * v2 (``traverse_merged_ref``) against JAX's sequential ``share=0``
    schedule: ``found``, ``t`` and ``gid`` bit-identical on every lane,
    ``u, v`` within 1e-6;
  * v1 (``traverse_packet_ref``) against JAX's packet kernel: ``found`` and
    closest-hit ``t`` bit-identical, ``gid`` equal except on exact-t ties
    between leaves (the packet visits its leaves in another order; the
    fixture makes such ties on purpose, and the test counts them); on an
    any-hit call ``found`` equal.
One exception holds for both, on rays along a box edge only: a ray that
touches a triangle on its boundary (a vertex on the box's edge) where the
box's slab test rejects the ray (its exit t rounds to 0) is found by a JAX
packet whose other rays entered that box, since a packet tests every leaf it
visits against all its rays, and never by a walk of one ray. Those lanes are
counted and must be such boundary hits; every other lane obeys the bounds.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_traverse_cases as cases
from cuda_pathtracer_tpu_torch.ops import kernels
from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2

HERE = os.path.dirname(os.path.abspath(__file__))
# the lanes whose closest hit is an exact-t tie between two leaves
TIE_ACROSS_GIDS = (200, 400)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp('jax_cases') / 'cases.npz'
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_cpu_max_isa=AVX')
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, '_torch_traverse_cases.py'),
         str(out)], env=env, cwd=HERE, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    jax = dict(np.load(out))
    wide, depth = cases.wide_table()
    z = cases.rays()
    T = torch.as_tensor
    ro, rd, t0 = T(z['ro']), T(z['rd']), T(z['t_max'])
    live, stop = T(z['active']), T(z['stop'])
    merged = tp2.build_merged_table(wide, depth)
    table = tp2.MergedTable(T(merged.rows), depth)
    split = tp1.split_packet_tables(wide, depth, device='cpu')
    v2 = tp2.traverse_merged_ref(table, ro, rd, t0, live, stop, want_uv=True)
    v1 = tp1.traverse_packet_ref(split, ro, rd, t0, live, stop)
    any_ = tp1.traverse_packet_ref(split, ro, rd, t0, live,
                                   torch.ones_like(stop), cheap=True)
    port = {}
    for prefix, out_ in (('v2_', v2), ('v1_', v1), ('any_', any_)):
        for k, v in zip(('t', 'gid', 'found', 'u', 'v'), out_):
            port[prefix + k] = v.numpy()
    return port, jax, z


def _bits(x):
    return np.ascontiguousarray(x).view(np.int32)


def _lanes(runs, case, walk):
    """This case's lanes, less those only a packet walk finds (see above);
    the latter exist only on the edge case."""
    port, jax, z = runs
    s = z['case'] == cases.CASES.index(case)
    u, v = jax['v2_u'], jax['v2_v']
    boundary = (u == 0) | (u == 1) | (v == 0) | (v == 1) | (u + v == 1)
    packet_only = (s & ~port[walk + '_found'] & jax[walk + '_intersected']
                   & boundary)
    if case != 'edge':
        assert not packet_only.any()
    return s & ~packet_only


@pytest.mark.parametrize('case', cases.CASES)
def test_v2_matches_sequential_jax(runs, case):
    port, jax, z = runs
    s = _lanes(runs, case, 'v2')
    np.testing.assert_array_equal(port['v2_found'][s], jax['v2_intersected'][s])
    np.testing.assert_array_equal(_bits(port['v2_t'][s]), _bits(jax['v2_t'][s]))
    np.testing.assert_array_equal(port['v2_gid'][s], jax['v2_prim_id'][s])
    for k in ('u', 'v'):
        np.testing.assert_allclose(port['v2_' + k][s], jax['v2_' + k][s],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize('case', cases.CASES)
def test_v1_matches_packet_jax(runs, case):
    port, jax, z = runs
    s = _lanes(runs, case, 'v1')
    np.testing.assert_array_equal(port['v1_found'][s], jax['v1_intersected'][s])
    closest = s & z['active'] & ~z['stop']
    np.testing.assert_array_equal(_bits(port['v1_t'][closest]),
                                  _bits(jax['v1_t'][closest]))
    differ = closest & (port['v1_gid'] != jax['v1_prim_id'])
    # t is bit-identical above, so a differing id is an exact-t tie; the
    # only such ties in the fixture are between the two copies of case X
    ties = int(differ.sum())
    assert np.isin(port['v1_gid'][differ], TIE_ACROSS_GIDS).all(), ties
    assert np.isin(jax['v1_prim_id'][differ], TIE_ACROSS_GIDS).all(), ties
    if case != 'tie_across':
        assert ties == 0


@pytest.mark.parametrize('case', cases.CASES)
def test_v1_any_hit_matches_packet_jax(runs, case):
    port, jax, z = runs
    s = _lanes(runs, case, 'any')
    np.testing.assert_array_equal(port['any_found'][s],
                                  jax['any_intersected'][s])


def test_cases_reach_what_they_aim_at(runs):
    """The fixture does what its cases say: every case but the empty ones
    finds hits, the ties go to the ids the walks' rules give, the chain's rays
    hit its innermost triangle after walking all 24 levels."""
    port, _, z = runs
    idx = {c: z['case'] == i for i, c in enumerate(cases.CASES)}
    for c in ('axis', 'graze', 'edge', 'inside', 'stop', 'random'):
        assert 0 < port['v2_found'][idx[c]].mean() < 1, c
    for c in ('short_t0', 'dead'):
        assert not port['v2_found'][idx[c]].any(), c
        np.testing.assert_array_equal(port['v2_t'][idx[c]],
                                      z['t_max'][idx[c]])
    for p in ('v2_', 'v1_'):
        assert (port[p + 'gid'][idx['tie_leaf']] == 305).all()
        assert (port[p + 'gid'][idx['chain']] == 7000).all()
    # v2 walks slot 0 (id 400) first; v1 the nearer box (id 200) from -x
    assert (port['v2_gid'][idx['tie_across']] == 400).all()
    assert (port['v1_gid'][idx['tie_across']] == 200).all()

    wide, depth = cases.wide_table()
    assert depth == cases.CHAIN + 2
    merged = tp2.build_merged_table(wide, depth)
    T = torch.as_tensor
    s = idx['chain']
    n = int(s.sum())
    stats = {}
    tp2.traverse_merged_ref(
        tp2.MergedTable(T(merged.rows), depth), T(z['ro'][s]), T(z['rd'][s]),
        T(z['t_max'][s]), torch.ones(n, dtype=torch.bool),
        torch.zeros(n, dtype=torch.bool), stats=stats)
    assert stats['inner'] >= n * (cases.CHAIN + 1)


def test_ray_count_limit_of_the_kernels():
    """The kernels give each ray 16 threads and index threads with 32-bit
    ints: the wrappers refuse a wave whose 16 * n overflows."""
    limit = (2 ** 31 - 1) // 16
    kernels.check_group_count('traverse', limit)
    with pytest.raises(ValueError, match='16 threads per ray'):
        kernels.check_group_count('traverse', limit + 1)
