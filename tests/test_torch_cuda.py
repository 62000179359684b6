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
from cuda_pathtracer_tpu_torch.tools import (bf16_probe, decision_probe,
                                             gather_probe, lab_v1_probe,
                                             onehot_probe, packet_step_probe,
                                             step_probe, visit_probe)

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


def _scatter_case(case):
    """(e, w, seg, n_bins) on the CPU for a card case of the scatter."""
    rs = np.random.RandomState(1)
    L, n_bins = 300000, 50000
    if case == 'half kept':
        seg = np.where(rs.rand(L) < 0.5, rs.randint(0, n_bins, L), n_bins)
    elif case == 'all discarded':
        seg = np.full(L, n_bins)
    elif case == 'one bin':
        # every update on one bin: the warp aggregation under full contention
        seg = np.full(L, 4321)
    elif case == 'ragged':
        L = 1001    # not a multiple of 4
        seg = np.where(rs.rand(L) < 0.7, rs.randint(0, 7, L), 7)
        n_bins = 7
    elif case == 'one bin table':
        n_bins = 1
        seg = rs.randint(0, 2, L)
    else:
        # the sibenik band's size: 3 x 414,720 updates in 8x16 tile lane
        # order into 164,620 x 8 bins; runs of 16 lanes share a triangle,
        # about a tenth of the records are kept
        n_tris, lanes = 164620, 414720
        L, n_bins = 3 * lanes, n_tris * 8
        tri = np.repeat(rs.randint(0, n_tris, L // 16), 16)
        seg = np.where(rs.rand(L) < 0.1, tri * 8 + rs.randint(0, 8, L),
                       n_bins)
    seg = seg.astype(np.int32)
    # discarded updates carry energy and weight too: the kernel must drop
    # their values, not only their ids
    e = (rs.rand(L) * 50).astype(np.float32)
    if case == 'one bin':
        # whole energies: the one bin's sum is exact in any order
        e = rs.randint(0, 50, L).astype(np.float32)
    w = np.where(seg < n_bins, 1.0, rs.rand(L) + 0.5).astype(np.float32)
    return e, w, seg, n_bins


@pytest.mark.parametrize('case', ['half kept', 'all discarded', 'one bin',
                                  'ragged', 'one bin table', 'sibenik band',
                                  'misaligned'])
def test_guiding_scatter_kernel_matches_plain(dev, case):
    """The kernel's sums against index_add_'s at rtol 1e-5 / atol 1e-5 (the
    atomics add in another order); 'misaligned' starts the ids 4 bytes past
    a 16-byte boundary, so the first thread's line is read id by id."""
    e, w, seg, n_bins = _scatter_case('half kept' if case == 'misaligned'
                                      else case)
    e, w, seg = (torch.as_tensor(a, device=dev) for a in (e, w, seg))
    if case == 'misaligned':
        e, w, seg = e[1:], w[1:], seg[1:]
        assert seg.data_ptr() % 16 == 4
    ke, kw = guiding_scatter.segment_sum_pairs(e, w, seg, n_bins)
    pe, pw = guiding_scatter.segment_sum_pairs_ref(e, w, seg, n_bins)
    assert ke.shape == kw.shape == (n_bins,)
    assert torch.allclose(ke, pe, rtol=1e-5, atol=1e-5)
    assert torch.allclose(kw, pw, rtol=1e-5, atol=1e-5)
    if case == 'one bin':
        assert float(kw[4321]) == seg.shape[0]
        assert float(ke[4321]) == float(e.sum())
    if case == 'all discarded':
        assert not ke.any() and not kw.any()


@pytest.mark.parametrize('W,H,n', [(1920, 1080, 5.0), (37, 19, 300.0),
                                   (1, 1, 3.0), (2, 3, 7.0), (7, 5, 12.0)])
def test_blur_kernel_matches_plain(dev, W, H, n):
    """Bit for bit, at 1080p, at a size that leaves ragged tiles, and at
    frames smaller than the 7 x 8 halo."""
    g = torch.Generator(device=dev).manual_seed(2)
    lum = torch.rand((W * H, 4), device=dev, generator=g) * n
    alb = torch.rand((W * H, 4), device=dev, generator=g)
    alb[:5, 1] = 0.0     # the 0.001 albedo floor
    got = blur.blur_luminance(lum, alb, n, W, H)
    want = blur.blur_luminance_ref(lum, alb, n, W, H)
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize('name', ['guiding_scatter', 'blur'])
def test_wrapper_launches_once_and_allocates_only_outputs(dev, name):
    """One launch counted per call, and no device memory beyond the
    outputs (the allocator rounds each block up to 512 bytes)."""
    if name == 'guiding_scatter':
        e, w, seg, n_bins = _scatter_case('half kept')
        args = [torch.as_tensor(a, device=dev) for a in (e, w, seg)]
        call = lambda: guiding_scatter.segment_sum_pairs(*args, n_bins)
        out_bytes = n_bins * 8
    else:
        W, H = 333, 77
        args = [torch.rand((W * H, 4), device=dev) + 0.1 for _ in range(2)]
        call = lambda: blur.blur_luminance(*args, 9.0, W, H)
        out_bytes = W * H * 12
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.LAUNCHES[name]
    out = call()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.cuda.max_memory_allocated() - base == -(-out_bytes // 512) * 512
    del out


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


def _rand_rows(n, w, seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, w).astype(np.float32),
            rs.randint(0, n, 40).astype(np.int32))


_tab6, _idx6 = _rand_rows(50, 6, 4)
GATHER_CARD_CASES = [c[1:] for c in gather_probe.sites(small=True)] + [
    ('rows, width 6', gather_probe.ROWS, _tab6, _idx6, 0),
    ('row sum, width 6', gather_probe.ROWSUM, _tab6, _idx6, 0),
    ('row pair, width 6', gather_probe.ROWPAIR, _tab6,
     _idx6.reshape(2, 20).copy(), 0)]


@pytest.mark.parametrize('case', GATHER_CARD_CASES,
                         ids=[c[0] for c in GATHER_CARD_CASES])
def test_probe_gather_kernel_matches_plain(dev, case):
    """Every mode of csrc/probe_gather.cu, float4 rows and widths that are
    not a multiple of 4: bit for bit."""
    _, mode, tab, idx, steps = case
    t, i = torch.as_tensor(tab, device=dev), torch.as_tensor(idx, device=dev)
    before = kernels.LAUNCHES['probe_gather']
    got = gather_probe.gather(mode, t, i, steps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_gather'] == before + 1
    want = gather_probe.gather_ref(mode, t, i, steps)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize('label', list(bf16_probe.VARIANTS))
def test_probe_slab_kernel_matches_plain(dev, label):
    """The slab chain in f32, bf16x2 and widened bf16: bit for bit."""
    v = bf16_probe.VARIANTS[label]
    x = torch.as_tensor(bf16_probe.inputs(4), device=dev)
    if v != bf16_probe.F32:
        x = x.to(torch.bfloat16)
    before = kernels.LAUNCHES['probe_slab']
    got = bf16_probe.slab(v, x, 200)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_slab'] == before + 1
    want = bf16_probe.slab_ref(v, x, 200)
    bits = torch.int32 if v == bf16_probe.F32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


STEP_CARD_CASES = step_probe.cases(small=True)


@pytest.mark.parametrize('case', STEP_CARD_CASES,
                         ids=[f'{c[0]}-{c[1]}-T{c[5]}' for c in STEP_CARD_CASES])
def test_probe_step_kernel_matches_plain(dev, case):
    """Every toggle and chain count of csrc/probe_step.cu: bit for bit."""
    _, _, flags, ni, batched, t = case
    tab, rays = (torch.as_tensor(a, device=dev) for a in step_probe.inputs(16))
    before = kernels.LAUNCHES['probe_step']
    got = step_probe.step(tab, rays, t, flags, ni, batched)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_step'] == before + 1
    want = step_probe.step_ref(tab, rays, t, flags, ni, batched)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


ONEHOT_CARD_CASES = [(path, c) for c in onehot_probe.cases(small=True)
                     for path in onehot_probe.PATHS]


@pytest.mark.parametrize('path,case', ONEHOT_CARD_CASES,
                         ids=[f'{p}-{c[0]}-N{c[1]}-{"bf16" if c[2] else "f32"}'
                              f'-P{c[4]}' for p, c in ONEHOT_CARD_CASES])
def test_probe_onehot_kernel_matches_plain(dev, path, case):
    """Both fetch paths (one-hot mma.sync, direct load) on f32 and bf16
    tables: final indices and sums bit for bit."""
    site, n, bf16, cells, chains = case
    tab, idx = onehot_probe.case_inputs(site, n, cells, chains)
    table = onehot_probe.Table(torch.as_tensor(tab, device=dev), bf16)
    starts = onehot_probe.starts_of(site, torch.as_tensor(idx, device=dev),
                                    cells, chains)
    before = kernels.LAUNCHES['probe_onehot']
    cur, acc = onehot_probe.fetch(path, table, starts, 16)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_onehot'] == before + 1
    pcur, pacc = onehot_probe.fetch_ref(table, starts, 16)
    assert torch.equal(cur, pcur)
    assert torch.equal(acc.view(torch.int32), pacc.view(torch.int32))


PACKET_CARD_CASES = [(packet_step_probe, c) for c in
                     packet_step_probe.cases(small=True)] + [
    (decision_probe, c) for c in decision_probe.cases(small=True)] + [
    (visit_probe, c) for c in visit_probe.cases(small=True)]


def _packet_inputs(mod, site, variant, dev):
    if mod is packet_step_probe:
        return {k: torch.as_tensor(v, device=dev)
                for k, v in mod.inputs(site, variant, small=True).items()}
    if mod is visit_probe:
        return mod.case_inputs(site, True, dev)
    return {k: torch.as_tensor(v, device=dev)
            for k, v in mod.inputs(site, small=True).items()}


@pytest.mark.parametrize('mod,case', PACKET_CARD_CASES,
                         ids=[f'{m.NAME}-{c[0]}-{c[1]}-T{c[2]}'
                              for m, c in PACKET_CARD_CASES])
def test_probe_packet_kernels_match_plain(dev, mod, case):
    """csrc/probe_packet_step.cu, probe_decision.cu and probe_visit.cu, every
    site and variant at the CPU tests' sizes: outputs, scratch and digests
    bit for bit."""
    site, variant, t = case[:3]
    ins = _packet_inputs(mod, site, variant, dev)
    before = kernels.LAUNCHES[mod.NAME]
    got = mod.run(site, variant, t, ins, *case[3:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[mod.NAME] == before + 1
    want = mod.run_ref(site, variant, t, ins, *case[3:])
    assert got.keys() == want.keys()
    for k in got:
        a, b = got[k], want[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a.long(), b.long()), k


@pytest.fixture(scope='module')
def lab_setup(dev):
    return lab_v1_probe.setup('cuda', small=True)


@pytest.mark.parametrize('wave,variant', lab_v1_probe.cases())
def test_probe_packet_walk_matches_plain(dev, lab_setup, wave, variant):
    """csrc/probe_packet_walk.cu, every hook on both small waves: outputs,
    stacks, words and both digests bit for bit."""
    tb = lab_setup['tables']
    blocks = lab_setup['blocks'][wave]
    before = kernels.LAUNCHES['probe_packet_walk']
    got = lab_v1_probe.walk(tb.inner, tb.leaf, blocks, tb.depth, variant)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['probe_packet_walk'] == before + 1
    want = lab_v1_probe.walk_ref(tb.inner, tb.leaf, blocks, tb.depth, variant)
    for k in got:
        a, b = got[k], want[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a.long(), b.long()), k
