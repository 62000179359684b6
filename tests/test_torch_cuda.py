"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device they skip. This file imports no JAX,
so on a machine without it run it without the repo's conftest:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

import _torch_traverse_cases as cases
from _torch_room import build_room, CAMERA
from cuda_pathtracer_tpu_torch.core.camera import Camera
from cuda_pathtracer_tpu_torch.models import pathtracer as ptm
from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
from cuda_pathtracer_tpu_torch.ops import blur, guiding_scatter, kernels
from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
from cuda_pathtracer_tpu_torch.ops.traverse import _primitives_prepass
from cuda_pathtracer_tpu_torch.scene import builder, scene as scene_mod

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    kernels.library()
    return torch.device('cuda')


@pytest.fixture(scope='module')
def room(dev):
    s = build_room(scene_mod, builder.add_cube)
    return s.to_device(dev), s.dynamic_arrays(dev)


def test_traverse_kernel_matches_plain(dev, room):
    arr, dyn = room
    rs = np.random.RandomState(0)
    n = 50000
    ro = torch.as_tensor(rs.uniform([-2.9, 0.05, -1.9], [2.9, 3.9, 3.9],
                                    (n, 3)).astype(np.float32), device=dev)
    rd = torch.nn.functional.normalize(
        torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32), device=dev),
        dim=1)
    t_max = torch.full((n,), 9999999.0, device=dev)
    t0, _, _, found0 = _primitives_prepass(arr, ro, rd, t_max)
    stop = torch.as_tensor(rs.rand(n) < 0.3, device=dev)
    live = torch.as_tensor(rs.rand(n) < 0.9, device=dev) & ~(stop & found0)
    table = tp2.MergedTable(dyn.packet_merged, dyn.depth)
    before = kernels.LAUNCHES['traverse']
    got = tp2.traverse_merged(table, ro, rd, t0, live, stop, want_uv=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['traverse'] == before + 1
    want = tp2.traverse_merged_ref(table, ro, rd, t0, live, stop, want_uv=True)
    t, gid, found, u, v = got
    assert found.any() and torch.equal(found, want[2])
    assert torch.equal(t.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(gid, want[1])
    assert torch.equal(u[found], want[3][found])
    assert torch.equal(v[found], want[4][found])


def _room_rays(arr, dev, n=50000, seed=0):
    rs = np.random.RandomState(seed)
    ro = torch.as_tensor(rs.uniform([-2.9, 0.05, -1.9], [2.9, 3.9, 3.9],
                                    (n, 3)).astype(np.float32), device=dev)
    rd = torch.nn.functional.normalize(
        torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32), device=dev),
        dim=1)
    t_max = torch.full((n,), 9999999.0, device=dev)
    t0, _, _, found0 = _primitives_prepass(arr, ro, rd, t_max)
    stop = torch.as_tensor(rs.rand(n) < 0.3, device=dev)
    live = torch.as_tensor(rs.rand(n) < 0.9, device=dev) & ~(stop & found0)
    return ro, rd, t0, live, stop


@pytest.mark.parametrize('cheap', [False, True])
def test_traverse_packet_kernel_matches_plain(dev, room, cheap):
    """v1: found equal and t bit-identical; closest-hit ids equal except on
    exact-t ties between leaves (none expected here: both walk the same
    order per ray)."""
    arr, dyn = room
    ro, rd, t0, live, stop = _room_rays(arr, dev, seed=3)
    tables = tp1.PacketTables(dyn.packet_inner, dyn.packet_leaf, dyn.depth)
    before = kernels.LAUNCHES['traverse_packet']
    t, gid, found = tp1.traverse_split(tables, ro, rd, t0, live, stop, cheap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['traverse_packet'] == before + 1
    pt, pgid, pfound = tp1.traverse_packet_ref(tables, ro, rd, t0, live, stop,
                                               cheap)
    assert found.any() and torch.equal(found, pfound)
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(gid, pgid)


@pytest.fixture(scope='module')
def hard_cases(dev):
    wide, depth = cases.wide_table()
    z = {k: torch.as_tensor(v, device=dev) for k, v in cases.rays().items()}
    merged = tp2.MergedTable(torch.as_tensor(
        tp2.build_merged_table(wide, depth).rows, device=dev), depth)
    return merged, tp1.split_packet_tables(wide, depth, device=dev), z


@pytest.mark.parametrize('walk', ['v2', 'v2 any-hit', 'v1', 'v1 cheap',
                                  'v1 short stack'])
def test_traversal_kernels_on_hard_cases(dev, hard_cases, walk):
    """Both kernels against their plain versions on the hard cases of
    ``_torch_traverse_cases.py`` (axis rays, grazing and edge rays, origins
    inside boxes, exact-t ties, short t_max, stop-on-hit and dead lanes, the
    24-level chain): every output bit-identical. ``v1 short stack`` gives the
    walk a stack of one entry, so most pushes are dropped (which changes the
    hits of a few rays: both must drop the same ones)."""
    merged, split, z = hard_cases
    stop = torch.ones_like(z['stop']) if walk == 'v2 any-hit' else z['stop']
    args = (z['ro'], z['rd'], z['t_max'], z['active'], stop)
    before = dict(kernels.LAUNCHES)
    if walk.startswith('v2'):
        name = 'traverse'
        got = tp2.traverse_merged(merged, *args, want_uv=True)
        want = tp2.traverse_merged_ref(merged, *args, want_uv=True)
    else:
        name = 'traverse_packet'
        if walk == 'v1 short stack':
            split = split._replace(depth=-7)
            assert tp1.stack_cap(split.depth) == 1
        cheap = walk == 'v1 cheap'
        got = tp1.traverse_split(split, *args, cheap)
        want = tp1.traverse_packet_ref(split, *args, cheap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert want[2].any() and not want[2].all()
    for k, a, b in zip(('t', 'gid', 'found', 'u', 'v'), got, want):
        if a is not None:
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), k


def test_guiding_scatter_kernel_matches_plain(dev):
    rs = np.random.RandomState(1)
    L, n_bins = 300000, 50000
    seg = torch.as_tensor(np.where(rs.rand(L) < 0.5, rs.randint(0, n_bins, L),
                                   n_bins).astype(np.int32), device=dev)
    e = torch.as_tensor(rs.rand(L).astype(np.float32) * 50, device=dev)
    w = (seg < n_bins).to(torch.float32)
    ke, kw = guiding_scatter.segment_sum_pairs(e, w, seg, n_bins)
    pe, pw = guiding_scatter.segment_sum_pairs_ref(e, w, seg, n_bins)
    assert torch.allclose(ke, pe, rtol=1e-5, atol=1e-5)
    assert torch.allclose(kw, pw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('W,H,n', [(1920, 1080, 5.0), (37, 19, 300.0)])
def test_blur_kernel_matches_plain(dev, W, H, n):
    g = torch.Generator(device=dev).manual_seed(2)
    lum = torch.rand((W * H, 4), device=dev, generator=g) * n
    alb = torch.rand((W * H, 4), device=dev, generator=g)
    got = blur.blur_luminance(lum, alb, n, W, H)
    want = blur.blur_luminance_ref(lum, alb, n, W, H)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)


def test_room_render_matches_cpu(dev):
    accs = []
    for device in (dev, torch.device('cpu')):
        pt = Pathtracer(build_room(scene_mod, builder.add_cube), 48, 32,
                        device=device)
        cam = Camera.create(**CAMERA, device=device)
        for clear in (True, False, False):
            pt.render(cam, should_clear=clear)
        accs.append(pt.lum.cpu())
    close = torch.isclose(accs[0][:, :3], accs[1][:, :3], rtol=1e-3,
                          atol=1e-5).all(dim=1).float().mean()
    assert close >= 0.99


@pytest.mark.parametrize('spp', [1, 2])
def test_tail_schedule_matches_cpu(dev, monkeypatch, spp):
    """The full-size schedule at a small size: the room at 64x64 in bands of
    2,048 lanes (2 bands at spp 1, 4 sample-major bands at spp 2) with the
    tail gate lowered to 2,048, so level 1 runs several rounds. The card and
    the CPU reach the same rand_idx after every frame and agree on at least
    99% of the pixels."""
    monkeypatch.setattr(ptm, 'TAIL_MIN_LANES', 2048)
    monkeypatch.setattr(Pathtracer, 'MAX_LANES_PER_DISPATCH', 2048)
    monkeypatch.setattr(Pathtracer, 'SPP_PER_DISPATCH', spp)
    runs = []
    for device in (dev, torch.device('cpu')):
        pt = Pathtracer(build_room(scene_mod, builder.add_cube), 64, 64,
                        device=device)
        assert pt.bands == 2 * spp
        cam = Camera.create(**CAMERA, device=device)
        ridx = []
        for clear in (True, False, False):
            pt.render(cam, should_clear=clear)
            ridx.append(pt.rand_idx)
        runs.append((ridx, pt.accumulators_pixel_order()[0].cpu()))
    (card_ridx, card), (cpu_ridx, cpu) = runs
    assert card_ridx == cpu_ridx
    close = torch.isclose(card[:, :3], cpu[:, :3], rtol=1e-3,
                          atol=1e-5).all(dim=1).float().mean()
    assert close >= 0.99
