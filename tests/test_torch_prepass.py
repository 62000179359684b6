"""The port's trace on the CPU as the prepass kernel and the walk's merge
epilogue left it: ``dispatch.trace`` gives the same ``Hit`` as before, bit
for bit, and calls the walk through ``dispatch.traverse_merged`` once per v2
trace with ``(table, ro, rd, t0, live, stop)`` positional and ``t0``,
``live``, ``stop`` the plain prepass's (the benchmark's wave recorder wraps
that name and times the walk on exactly those arguments). The kernels
themselves are held to the same plain versions on the card in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import _torch_prepass_cases as pc
from _torch_room import build_room
from cuda_pathtracer_tpu_torch.ops import dispatch
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
from cuda_pathtracer_tpu_torch.ops.traverse import (PRIM_PLANE, PRIM_SPHERE,
                                                    prepass_ref)
from cuda_pathtracer_tpu_torch.scene import builder, scene as scene_mod

# trace keywords: closest hit with barycentrics, the defaults, any-hit
# shadow rays with a length and active lanes, and mixed stop-on-hit lanes
CALLS = {
    'closest uv': lambda z: dict(active=z['active'], want_uv=True),
    'defaults': lambda z: dict(),
    'shadow': lambda z: dict(t_max=z['t_max'], active=z['active'],
                             any_hit=True, want_uv=True),
    'mixed stop': lambda z: dict(t_max=z['t_max'], active=z['active'],
                                 stop_on_hit=z['stop'], want_uv=True),
}


@pytest.fixture(scope='module')
def room():
    s = build_room(scene_mod, builder.add_cube)
    z = {k: torch.as_tensor(v) for k, v in pc.rays(600, seed=5).items()}
    # the room's rays: half this file's cases, half from inside the room
    rs = np.random.RandomState(6)
    n = z['ro'].shape[0]
    inside = torch.as_tensor(rs.rand(n) < 0.5)
    z['ro'] = torch.where(inside[:, None], torch.as_tensor(rs.uniform(
        [-2.9, 0.05, -1.9], [2.9, 3.9, 3.9], (n, 3)).astype(np.float32)),
        z['ro'])
    return s.to_device('cpu'), s.dynamic_arrays('cpu'), z


@pytest.mark.parametrize('prims', ['room', 'spheres and planes'])
@pytest.mark.parametrize('call', list(CALLS))
def test_trace_walks_once_on_the_plain_prepass(room, monkeypatch, prims,
                                               call):
    arr, dyn, z = room
    scene = arr if prims == 'room' else pc.with_primitives(
        arr, 'spheres and planes')
    kw = CALLS[call](z)
    seen = []
    walk = dispatch.traverse_merged

    def recorded(*args, **kwargs):
        seen.append((args, kwargs))
        return walk(*args, **kwargs)
    monkeypatch.setattr(dispatch, 'traverse_merged', recorded)
    hit = dispatch.trace(scene, dyn, z['ro'], z['rd'], **kw)
    assert len(seen) == 1
    args, kwargs = seen[0]
    assert len(args) == 6
    table, ro, rd, t0, live, stop = args
    assert isinstance(table, tp2.MergedTable)
    assert table.rows is dyn.packet_merged and table.depth == dyn.depth
    assert torch.equal(pc.bits(ro), pc.bits(z['ro']))
    assert torch.equal(pc.bits(rd), pc.bits(z['rd']))
    want = prepass_ref(scene, z['ro'], z['rd'], kw.get('t_max'),
                       kw.get('active'), kw.get('stop_on_hit'),
                       kw.get('any_hit', False))
    assert pc.differing(type(want)(t0, want.prim_type, want.prim_id,
                                   want.found, live, stop), want) == []
    assert kwargs['want_uv'] == (kw.get('want_uv', False)
                                 and not kw.get('any_hit', False))
    # the walk, called with just these seven arguments, is the walk alone
    alone = walk(table, ro, rd, t0, live, stop, kwargs['want_uv'])
    assert isinstance(alone, tuple) and len(alone) == 5
    assert pc.differing(hit, pc.trace_before(scene, dyn, z['ro'], z['rd'],
                                             **kw)) == []
    assert hit.intersected.any() and not hit.intersected.all()


@pytest.mark.parametrize('call', ['closest uv', 'shadow'])
def test_v1_trace_matches_the_route_before(room, monkeypatch, call):
    arr, dyn, z = room
    scene = pc.with_primitives(arr, 'spheres and planes')
    kw = CALLS[call](z)
    monkeypatch.setattr(dispatch, 'PACKET_V1', True)
    hit = dispatch.trace(scene, dyn, z['ro'], z['rd'], **kw)
    assert hit.u is None and hit.v is None
    want = pc.trace_before(scene, dyn, z['ro'], z['rd'], v1=True, **kw)
    assert pc.differing(hit, want) == []


@pytest.mark.parametrize('which', list(pc.PRIMITIVE_SETS))
def test_prepass_ties_and_edges(which):
    """The plain prepass on the fixed lanes of ``_torch_prepass_cases``: an
    exact-t tie goes to the lowest index within a family and to the sphere
    between a sphere and a plane; a primitive must beat t_max strictly; NaN
    and zero directions hit nothing."""
    z = {k: torch.as_tensor(v) for k, v in pc.rays(0).items()}
    n_s, n_p = pc.PRIMITIVE_SETS[which]
    scene = pc.with_primitives(
        build_room(scene_mod, builder.add_cube).to_device('cpu'), which)
    p = prepass_ref(scene, z['ro'], z['rd'], t_max=z['t_max'],
                    active=z['active'], stop_on_hit=z['stop'])
    hit = [(float(p.t[i]), int(p.prim_type[i]), int(p.prim_id[i]))
           if bool(p.found[i]) else None for i in range(len(p.t))]
    # down +z from the origin: sphere 0 (tied with sphere 1) or plane 0
    # (tied with plane 1), all at t = 4
    assert hit[0] == ((4.0, PRIM_SPHERE, 0) if n_s else
                      (4.0, PRIM_PLANE, 0) if n_p else None)
    assert hit[2] == ((4.0, PRIM_PLANE, 0) if n_p else None)
    # tangent to spheres 0 and 2: a discriminant of exactly 0
    assert hit[3] == ((0.5, PRIM_SPHERE, 0) if n_s else None)
    assert hit[4] == ((0.5, PRIM_SPHERE, 2) if n_s else None)
    # from inside sphere 0: its far side
    assert hit[5] == ((1.0, PRIM_SPHERE, 0) if n_s else None)
    # t_max 3 short of everything, t_max 4 exactly at the tie
    assert hit[11] is None and hit[12] is None
    # zero, NaN and infinite directions, a NaN origin, NaN and 0 t_max
    assert hit[14:21] == [None] * 7
    assert torch.equal(p.live, z['active'] & ~(z['stop'] & p.found))
    assert torch.equal(p.stop, z['stop'])
