"""The port's packet-step probe modules (``cuda_pathtracer_tpu_torch/tools/``
``packet_step_probe``, ``decision_probe``, ``visit_probe``, ``lab_v1_probe``)
against the nine Pallas sites of the repo's ``tools/`` they stand for, at
small sizes on the CPU: ``pallas_probe_r2f.py:96``, ``r2g.py:158``,
``r2h.py:172``, ``r2i.py:68``, ``kernel_lab2.py:136``,
``mosaic_bisect.py:166``, ``kernel_lab3.py:487``, ``subpacket_probe.py:295``
and ``kernel_lab.py:256``, every variant each file defines.

The sites run in interpret mode in subprocesses (``_torch_jax_probes.py``,
one per family, in parallel) with XLA limited to AVX (no FMA contraction)
and ``--xla_allow_excess_precision=false``. A wrapper there zeroes each
kernel's scratch before its body and returns it after, so the test holds
the plain versions' outputs AND the scratch the TPU kernel leaves (stacks,
decision words, ``sc``, ``rt``, ``dec_v``, ``dmem``, ``t_s``) to JAX, bit for
bit: several of the sites' outputs are blind to the work (r2f's depends on
T alone, kernel_lab3's rungs scale t by a constant, kernel_lab's ``script``
and ``nodec`` return t0). The same file holds the port's ``split_packet_tables``,
``ray_blocks``, ``bounce_wave`` and ``generate_rays_simple`` to the JAX
package's on the test room.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_room import build_room, CAMERA
from cuda_pathtracer_tpu_torch.core import camera as cam_mod
from cuda_pathtracer_tpu_torch.scene import builder, scene as scene_mod
from cuda_pathtracer_tpu_torch.tools import (decision_probe, lab_v1_probe,
                                             packet_step_probe, visit_probe)

HERE = os.path.dirname(os.path.abspath(__file__))
FAMILIES = ('packet_step', 'decision', 'visit', 'lab_v1')
STEP_CASES = list(enumerate(packet_step_probe.cases(small=True)))
DECISION_CASES = list(enumerate(decision_probe.cases(small=True)))
VISIT_CASES = list(enumerate(visit_probe.cases(small=True)))


@pytest.fixture(scope='module')
def jax_out(tmp_path_factory):
    out = tmp_path_factory.mktemp('jax_lab_probes')
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_cpu_max_isa=AVX '
                         '--xla_allow_excess_precision=false')
    procs = {f: subprocess.Popen(
        [sys.executable, os.path.join(HERE, '_torch_jax_probes.py'), f,
         str(out / f'{f}.npz')], env=env, cwd=HERE,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE) for f in FAMILIES}
    for f, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f'{f}: ' + err.decode()[-3000:]
    return {f: dict(np.load(out / f'{f}.npz')) for f in FAMILIES}


def _assert_bits(got, want, name):
    want = torch.as_tensor(want)
    assert tuple(got.shape) == tuple(want.shape), name
    if got.dtype == torch.float32:
        assert torch.equal(got.contiguous().view(torch.int32),
                           want.contiguous().view(torch.int32)), name
    else:
        assert torch.equal(got.long(), want.long()), name


@pytest.mark.parametrize('k,case', STEP_CASES,
                         ids=[f'{c[0]}-{c[1]}-T{c[2]}' for _, c in STEP_CASES])
def test_packet_step_matches_jax(jax_out, k, case):
    site, variant, t = case
    ins = {n: torch.as_tensor(v) for n, v in
           packet_step_probe.inputs(site, variant, small=True).items()}
    got = packet_step_probe.run(site, variant, t, ins)
    for name in packet_step_probe.OUTPUTS[site]:
        if name != 'digest':
            _assert_bits(got[name], jax_out['packet_step'][f'{name}_{k}'], name)
    assert got['digest'].min() >= 0 and got['digest'].max() < 2 ** 32
    if site == 'r2h':          # the output carries the walk: some leaf hits
        assert bool((got['out'] < 2 * packet_step_probe.R2H_T0).any())
    if site == 'r2g':
        assert bool((got['gid'] >= 0).any())


@pytest.mark.parametrize('k,case', DECISION_CASES,
                         ids=[f'{c[0]}-{c[1]}' for _, c in DECISION_CASES])
def test_decision_matches_jax(jax_out, k, case):
    site, variant, t = case
    ins = {n: torch.as_tensor(v) for n, v in
           decision_probe.inputs(site, small=True).items()}
    got = decision_probe.run(site, variant, t, ins)
    for name in decision_probe.OUTPUTS[site]:
        if name != 'digest':
            _assert_bits(got[name], jax_out['decision'][f'{name}_{k}'], name)


@pytest.mark.parametrize('k,case', VISIT_CASES,
                         ids=[f'{c[0]}-{c[1]}' for _, c in VISIT_CASES])
def test_visit_matches_jax(jax_out, k, case):
    site, variant, t, sets = case
    ins = visit_probe.case_inputs(site, True, 'cpu')
    got = visit_probe.run(site, variant, t, ins, sets)
    assert tuple(got) == visit_probe.outputs(site, variant)
    for name in got:
        if name != 'digest':
            _assert_bits(got[name], jax_out['visit'][f'{name}_{k}'], name)


def test_pack_bf16_matches_jax(jax_out):
    """kernel_lab3's packed-bf16 table (``pack_bf16``, :459)."""
    ins = visit_probe.case_inputs('lab3', True, 'cpu')
    _assert_bits(ins['btab'], jax_out['visit']['btab'], 'btab')


@pytest.mark.parametrize('wave,variant', lab_v1_probe.cases())
def test_lab_v1_matches_jax(jax_out, wave, variant):
    z = jax_out['lab_v1']
    got = lab_v1_probe.walk(torch.as_tensor(z['inner']),
                            torch.as_tensor(z['leaf']),
                            torch.as_tensor(z[wave]), int(z['depth']), variant)
    for name in ('out', 'stk_n', 'stk_m', 'dec_s'):
        _assert_bits(got[name], z[f'{wave}_{variant}_{name}'], name)
    found = got['out'].view(-1, 4, 128)[:, 2]
    if variant in ('script', 'nodec'):
        assert not bool(found.any())          # the lab returns t0, -1, 0
        assert bool(got['lane_digest'].any())  # the slabs ran all the same
    else:
        assert bool(found.any())


@pytest.fixture(scope='module')
def port_room():
    s = build_room(scene_mod, builder.add_cube)
    return s, s.dynamic_arrays('cpu')


def test_split_tables_and_waves_match_jax(jax_out, port_room):
    """The port's split tables bit for bit; its ray blocks and bounce wave
    (from the JAX hits) within rtol 1e-6, as the camera rays are held."""
    z = jax_out['lab_v1']
    _, dyn = port_room
    _assert_bits(dyn.packet_inner, z['inner'], 'inner')
    _assert_bits(dyn.packet_leaf, z['leaf'], 'leaf')
    assert dyn.depth == int(z['depth'])
    ro, rd = torch.as_tensor(z['ro']), torch.as_tensor(z['rd'])
    perm = lab_v1_probe.tile_order(64, 8)
    prim = lab_v1_probe.ray_blocks(ro[perm], rd[perm])
    np.testing.assert_allclose(prim.numpy(), z['prim'], rtol=1e-6)
    bro, brd = lab_v1_probe.bounce_wave(z['ro'], z['rd'], z['hit_t'])
    bounce = lab_v1_probe.ray_blocks(torch.as_tensor(bro),
                                     torch.as_tensor(brd))
    np.testing.assert_allclose(bounce.numpy(), z['bounce'], rtol=1e-6)


def test_generate_rays_simple_matches_jax(jax_out):
    z = jax_out['lab_v1']
    cam = cam_mod.Camera.create(**CAMERA, device='cpu')
    ro, rd = lab_v1_probe.primary_wave(cam, 64, 8, 48, y0=20)
    np.testing.assert_allclose(ro.numpy(), z['ro'], rtol=1e-6)
    np.testing.assert_allclose(rd.numpy(), z['rd'], rtol=1e-6, atol=1e-7)


def test_lab_v1_waves_on_the_port_scene(port_room):
    """The port's own waves on the room: the bounce rays come from its v1
    trace, sorted; every variant's plain walk agrees with v0 on t, and v0's
    t equals traverse_split's on every ray."""
    s, dyn = port_room
    tables = lab_v1_probe.tp1.PacketTables(dyn.packet_inner, dyn.packet_leaf,
                                           dyn.depth)
    cam = cam_mod.Camera.create(**CAMERA, device='cpu')
    w = lab_v1_probe.waves(s.to_device('cpu'), tables, cam, 64, 8, 48, y0=20)
    for wave, (ro, rd) in w.items():
        blocks = lab_v1_probe.ray_blocks(ro, rd)
        outs = {v: lab_v1_probe.walk(tables.inner, tables.leaf, blocks,
                                     tables.depth, v)
                for v in ('v0', 'packed', 'phase')}
        t0 = lab_v1_probe.lab_t(outs['v0'])
        for v in ('packed', 'phase'):
            assert torch.equal(lab_v1_probe.lab_t(outs[v]), t0)
        n = ro.shape[0]
        t, _, found = lab_v1_probe.tp1.traverse_split(
            tables, ro, rd, torch.full((n,), 1.5e38), torch.ones(n, dtype=bool),
            torch.zeros(n, dtype=bool))
        assert bool(found.any())
        assert torch.equal(t.view(torch.int32), t0.view(torch.int32))


@pytest.mark.parametrize('mod', [packet_step_probe, decision_probe,
                                 visit_probe, lab_v1_probe],
                         ids=lambda m: m.__name__.rsplit('.', 1)[1])
def test_probe_main_runs_plain_on_cpu(mod, capsys):
    assert mod.main(['--device', 'cpu']) == 0
    assert 'ok=True' in capsys.readouterr().out
