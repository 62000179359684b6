"""The comparison that decides ``correct`` has to fail where it should: the
control (the plain reference with bf16 ray rows in the program's place) and
each fault the cell can have, planted in the program underneath a run that
skips the harness's look for a card. On the CPU at 64x48, the program's
plain versions in place of its kernels:

    python3 -m pytest portbench/test_correct.py -q

(about a minute). On the card at the cell's own size the control is read by
``python3 portbench/calibrate.py``.
"""
from __future__ import annotations

import copy
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import driver, spec  # noqa: E402
from portbench.lib.check import judge  # noqa: E402
from portbench.lib.traffic import load_loop, seeded_camera  # noqa: E402
from portbench.reference import bvh  # noqa: E402

CPU = torch.device('cpu')
SEED = 2 ** 31 + 12345
CELLS = ('sibenik-whitted-480p',)


def small(name: str) -> dict:
    c = copy.deepcopy(spec.cell(name))
    c['config']['width'], c['config']['height'] = 64, 48
    return c


def run(cell) -> dict:
    return driver.run_cell(cell, SEED, 0.5, False, CPU, time.time())


# ---- faults planted in the program (each a monkeypatch of its modules)

def fault_unchanged(mp_, pm):
    """A step that returns its state unchanged: the render leaves the
    frame as it was."""
    mp_.setattr(pm.raytracer.Raytracer, 'render', lambda self, *a, **k: None)


def fault_half(mp_, pm):
    """Half of the batch left out: the second half of a frame's pixels
    gets nothing."""
    orig = pm.raytracer.render_whitted

    def half(*a, **k):
        out = orig(*a, **k)
        out[out.shape[0] // 2:] = 0.0
        return out
    mp_.setattr(pm.raytracer, 'render_whitted', half)


def fault_altered(mp_, pm):
    """An answer altered where it is produced: one row of every frame the
    viewer gets."""
    orig = pm.film.to_uint8

    def u8(img):
        out = orig(img).copy()
        out[0] ^= 0x40
        return out
    mp_.setattr(pm.film, 'to_uint8', u8)


FAULTS = {'unchanged': fault_unchanged, 'half': fault_half,
          'altered': fault_altered}


@pytest.fixture(scope='module')
def pm():
    return driver.program_modules()


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name):
    r = run(small(name))
    assert r['correct'], r['checks']
    assert r['attempted'] > 0 and r['failed'] == 0


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('name', CELLS)
def test_fault_is_not_correct(name, fault, pm, monkeypatch):
    FAULTS[fault](monkeypatch, pm)
    r = run(small(name))
    assert not r['correct'], (fault, r['checks'])


@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(name):
    """The reference with bf16 ray rows, in the program's place."""
    c = small(name)
    lp = load_loop(c['mix']['loop'])
    ctx = SimpleNamespace(config=c['config'], mix=c['mix'], seed=SEED,
                          device=CPU,
                          camera=seeded_camera(c['config'], c['mix'], SEED))
    answers = dict(frames=[None] * int(c['mix'].get('compare_ticks', 3)))
    want = lp.reference(ctx, answers)
    got = lp.reference(ctx, answers, control=True)
    numbers = lp.compare(got, want)
    numbers['plain_on_cuda'] = 0.0
    ok, checks = judge(numbers, c['limits'])
    assert not ok, checks


# ---- the reference's own walk against testing every triangle

def _brute(v0, v1, v2, ro, rd, t_init):
    e1, e2 = v1 - v0, v2 - v0
    d = rd[:, None]
    h = bvh._cross(d, e2)
    a = bvh._dot(e1, h)
    small = a.abs() < bvh.DET_EPS
    f = 1.0 / torch.where(small, torch.ones_like(a), a)
    s = ro[:, None] - v0
    u = f * bvh._dot(s, h)
    q = bvh._cross(s, e1)
    v = f * bvh._dot(d, q)
    t = f * bvh._dot(e2, q)
    ok = (~small & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
          & (t < t_init[:, None]))
    t = torch.where(ok, t, torch.full_like(t, float('inf')))
    best = t.amin(1)
    idx = torch.arange(t.shape[1]).expand_as(t)
    tri = torch.where(ok & (t == best[:, None]), idx,
                      torch.full_like(idx, 1 << 40)).amin(1)
    hit = ok.any(1)
    return torch.where(hit, best, t_init), torch.where(hit, tri, -1)


@pytest.mark.parametrize('n_tris', [1, 7, 300])
def test_reference_walk_finds_every_closest_hit(n_tris):
    g = torch.Generator().manual_seed(n_tris)
    c = torch.rand((n_tris, 3), generator=g) * 10 - 5
    v0 = c + torch.randn((n_tris, 3), generator=g)
    v1 = c + torch.randn((n_tris, 3), generator=g)
    v2 = c + torch.randn((n_tris, 3), generator=g)
    ro = torch.rand((2000, 3), generator=g) * 16 - 8
    rd = torch.nn.functional.normalize(torch.randn((2000, 3), generator=g), dim=1)
    t_init = torch.where(torch.rand(2000, generator=g) < 0.2, 3.0, bvh.T_MAX)
    tree = bvh.Tree(v0, v1, v2)
    on = torch.ones(2000, dtype=torch.bool)
    t, tri = tree.query(ro, rd, t_init, on, any_hit=False)
    bt, btri = _brute(v0, v1, v2, ro, rd, t_init)
    assert torch.equal(tri, btri) and torch.equal(t, bt)
    assert (btri >= 0).sum() > 100 or n_tris < 300
    blocked = tree.query(ro, rd, t_init, on, any_hit=True)
    assert torch.equal(blocked, btri >= 0)
    assert not tree.query(ro, rd, t_init, ~on, any_hit=True).any()


def test_reference_frame_is_deterministic():
    from portbench.reference.whitted import Whitted
    c = small(CELLS[0])
    cam = seeded_camera(c['config'], c['mix'], SEED)
    w = Whitted(c['config']['scene'], CPU)
    a = w.frame(cam, 32, 24)
    b = w.frame(cam, 32, 24)
    assert a.shape == (24, 32, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and a.any()
