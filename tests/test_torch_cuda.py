"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device they skip. This file imports no JAX,
so on a machine without it run it without the repo's conftest:
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
"""
import functools

import numpy as np
import pytest
import torch

import _torch_prepass_cases as pc
import _torch_traverse_cases as cases
from _torch_room import (CAMERA, GLASS_CAMERA, _grid, build_glass_room,
                         build_room)
from cuda_pathtracer_tpu_torch.core.camera import Camera
from cuda_pathtracer_tpu_torch.models import pathtracer as ptm
from cuda_pathtracer_tpu_torch.models import raytracer as trt
from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
from cuda_pathtracer_tpu_torch.ops import (blur, dispatch, guiding_scatter,
                                           kernels, whitted_shade)
from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2
from cuda_pathtracer_tpu_torch.ops.traverse import (_primitives_prepass,
                                                    prepass, prepass_ref)
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


@pytest.mark.parametrize('name', ['guiding_scatter', 'blur',
                                  'whitted_shade_pre', 'whitted_shade_post'])
def test_wrapper_launches_once_and_allocates_only_outputs(dev, room, name):
    """One launch counted per call, and no device memory beyond the
    outputs (the allocator rounds each block up to 512 bytes)."""
    if name == 'guiding_scatter':
        e, w, seg, n_bins = _scatter_case('half kept')
        args = [torch.as_tensor(a, device=dev) for a in (e, w, seg)]
        call = lambda: guiding_scatter.segment_sum_pairs(*args, n_bins)
        out_bytes = [n_bins * 8]
    elif name == 'blur':
        W, H = 333, 77
        args = [torch.rand((W * H, 4), device=dev) + 0.1 for _ in range(2)]
        call = lambda: blur.blur_luminance(*args, 9.0, W, H)
        out_bytes = [W * H * 12]
    else:
        arr, dyn = room
        n = 10000
        ro, rd = _room_rays(arr, dev, n)[:2]
        tab = whitted_shade.tables(arr, dyn)
        lv = whitted_shade.level(ro, rd, dispatch.trace(arr, dyn, ro, rd))
        L = tab.n_lights
        if name == 'whitted_shade_pre':
            call = lambda: whitted_shade.shade_pre(tab, lv)
            out_bytes = [L * n * 12, L * n * 12, L * n * 4, L * n]
        else:
            weight = torch.rand((n, 3), device=dev)
            pixel = torch.arange(n, device=dev)
            occluded = torch.rand((L, n), device=dev) < 0.5
            frame = torch.zeros((n, 3), device=dev)
            count = torch.zeros((), dtype=torch.int64, device=dev)
            call = lambda: whitted_shade.shade_post(
                tab, lv, weight, pixel, occluded, frame, count)
            out_bytes = [2 * n * 12] * 3 + [2 * n * 8, 2 * n]
        name = 'whitted_shade'
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = kernels.LAUNCHES[name]
    out = call()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.cuda.max_memory_allocated() - base == sum(
        -(-b // 512) * 512 for b in out_bytes)
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


def _bits(x):
    return x.detach().cpu().contiguous().view(torch.int32)


@pytest.mark.parametrize('d', [1920, 1080, 48, 2.0 * 3.141592653589793,
                               3.141592653589793, 3.0, 1.0])
def test_scalar_division_matches_cpu(dev, d):
    """ROADMAP C.7: ``vecmath.div`` (the path tracer's divisions by a
    Python number: pixel fractions, the sample count, 1/pi, 1/(2 pi), the
    light centroid's 1/3) rounds on the card as on the CPU."""
    from cuda_pathtracer_tpu_torch.core import vecmath as vm
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -2000.0, 2000.0, 1 << 20).astype(np.float32))
    assert torch.equal(_bits(vm.div(x.to(dev), d)), _bits(x / d))


def test_sqrt_matches_cpu(dev):
    """``vecmath.sqrt`` (every square root of the render paths) is the IEEE
    f32 root (numpy's) on the card and on the CPU, where PyTorch's own f32
    ``torch.sqrt`` is an ulp off it for some of these inputs."""
    from cuda_pathtracer_tpu_torch.core import vecmath as vm
    rs = np.random.RandomState(2)
    x = np.concatenate([rs.uniform(0.0, 30.0, 1 << 20),
                        np.exp(rs.uniform(-80.0, 80.0, 1 << 20))]).astype(
                            np.float32)
    want = torch.from_numpy(np.sqrt(x)).view(torch.int32)
    t = torch.from_numpy(x)
    assert torch.equal(_bits(vm.sqrt(t.to(dev))), want)
    assert torch.equal(_bits(vm.sqrt(t)), want)


def test_generate_rays_matches_cpu(dev):
    """The path tracer's primary rays at 1920x1080, bit for bit (aperture 0:
    the lens offset's sin and cos are each device's own math library, and
    0 times them drops out)."""
    from cuda_pathtracer_tpu_torch.core import camera as cam_mod
    from cuda_pathtracer_tpu_torch.core import rng
    W, H = 1920, 1080
    out = []
    for d in (dev, torch.device('cpu')):
        ys, xs = torch.meshgrid(torch.arange(H, device=d),
                                torch.arange(W, device=d), indexing='ij')
        xs, ys = xs.reshape(-1).to(torch.int32), ys.reshape(-1).to(torch.int32)
        cam = Camera.create([0.0, 5.0, -16.0], [0.0, -0.1, 1.0], 1.5, 12.0,
                            0.0, device=d)
        ro, rd, st = cam_mod.generate_rays(cam, xs, ys,
                                           rng.get_seed(xs, ys, 7, W), W, H)
        out.append((ro, rd, st.seed.to(torch.int64)))
    for got, want in zip(*out):
        if got.dtype == torch.float32:
            got, want = _bits(got), _bits(want)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize('blur_on', [False, True], ids=['plain', 'blur'])
def test_display_matches_cpu(dev, blur_on):
    """``film.display`` at 1920x1080 (the division by the sample count, the
    vignette's pixel fractions; with the blur kernel on the card against its
    plain version on the CPU), bit for bit."""
    from cuda_pathtracer_tpu_torch.models import film
    W, H = 1920, 1080
    rs = np.random.RandomState(1)
    lum = rs.uniform(0.0, 30.0, (W * H, 4)).astype(np.float32)
    lum[:, 3] = 7.0
    alb = rs.uniform(0.0, 7.0, (W * H, 4)).astype(np.float32)
    alb[:, 3] = 7.0
    got = film.display(torch.from_numpy(lum).to(dev),
                       torch.from_numpy(alb).to(dev), 7.0, W, H, blur=blur_on)
    want = film.display(torch.from_numpy(lum), torch.from_numpy(alb), 7.0, W,
                        H, blur=blur_on)
    assert torch.equal(_bits(got), _bits(want))


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


# ---- the Whitted level's shading (csrc/whitted_shade.cu) against the
# plain route (models/raytracer.py::_level_plain, _shade_level)

SIBENIK_CAMERA = dict(eye=[0.0, 5.0, -16.0], view_dir=[0.0, 0.0, 1.0], d=1.5,
                      focal_length=12.0, aperture=0.0)
OUTSIDE_CAMERA = dict(eye=[0.0, 4.0, -17.0], view_dir=[0.0, -0.2, 1.0],
                      d=1.5, focal_length=12.0, aperture=0.02)


def _bare_room(add_cube):
    """Triangles only, no sphere or plane: a floor, a half-mirror back
    wall, a glass cube (transmit 0.9, IOR 1.5, absorption) and a plain one
    turned and scaled, one point light."""
    s = scene_mod.Scene(asset_dirs=['.'])
    M = scene_mod.Material
    floor = s.add_material(M.DIFFUSE((0.8, 0.7, 0.6)))
    mirror_m = M.DIFFUSE((0.6, 0.6, 0.7))
    mirror_m.reflect = 0.5
    mirror = s.add_material(mirror_m)
    glass_m = M.DIFFUSE((0.9, 1.0, 0.9))
    glass_m.transmit = 0.9
    glass_m.refractive_index = 1.5
    glass_m.absorption = (0.2, 0.1, 0.4)
    glass = s.add_material(glass_m)
    plain = s.add_material(M.DIFFUSE((0.3, 0.6, 0.3)))
    for (v0, v1, v2, uv6), mat in (
            (_grid([-3, 0, -2], [0, 0, 6], [6, 0, 0], 4, 4), floor),
            (_grid([-3, 0, 4], [0, 4, 0], [6, 0, 0], 2, 3), mirror)):
        s.add_object(scene_mod.GameObject(s.add_mesh(
            v0.astype(np.float32), v1.astype(np.float32),
            v2.astype(np.float32), mat, uv=uv6)))
    for mat, pos, rot, scale in ((glass, [-0.8, 0.9, 1.5], 0.3, 0.8),
                                 (plain, [1.4, 0.5, 2.2], 0.4, 0.5)):
        cube = scene_mod.GameObject(add_cube(s, mat))
        cube.position[:] = pos
        cube.rotation[1] = rot
        cube.scale[:] = scale
        s.add_object(cube)
    s.add_point_light(scene_mod.PointLight((0.0, 3.0, 0.0), (5.0, 5.0, 5.0)))
    s.finalize()
    return s


# scene, camera, frame size; each a route the kernels must take: sibenik's
# one light and two spheres, outside's three lights, checker plane and
# moved cubes, the glass room's inside hits and total internal reflection,
# and a scene of triangles alone
WHITTED_CASES = {
    'sibenik': (lambda: builder.get_scene('sibenik'), SIBENIK_CAMERA, 640, 480),
    'outside': (lambda: builder.get_scene('outside'), OUTSIDE_CAMERA, 160, 120),
    'glass_room': (lambda: build_glass_room(scene_mod, builder.add_cube),
                   GLASS_CAMERA, 160, 120),
    'no_spheres_or_planes': (lambda: _bare_room(builder.add_cube), CAMERA,
                             160, 120),
}


@pytest.fixture(scope='module')
def whitted_scenes(dev):
    """name -> (arrays, dynamic arrays, camera, width, height); built on
    first use. ``outside`` is moved to t = 2 first."""
    built = {}

    def get(name):
        if name not in built:
            make, cam, W, H = WHITTED_CASES[name]
            scene = make()
            if name == 'outside':
                scene.update(None, 2.0)
            built[name] = (scene.to_device(dev), scene.dynamic_arrays(dev),
                           Camera.create(**cam, device=dev), W, H)
        return built[name]
    return get


def _level_inputs(arr, dyn, cam, W, H):
    """The rays and weights of every level of a depth-7 frame, as the plain
    route forms them."""
    levels = []

    def spy(tables, scene, dyn_, ro, rd, weight, *rest):
        levels.append((ro.clone(), rd.clone(), weight.clone()))
        return trt._level_plain(scene, dyn_, ro, rd, weight, *rest)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trt, '_shade_level_kernels', spy)
        trt.render_whitted(arr, dyn, cam, width=W, height=H, max_depth=7)
    return levels


def _run_level(route, arr, dyn, ro, rd, weight):
    """One level through ``route`` with every lane its own pixel, so the
    frame holds each lane's contribution: (frame, shadow rays, children,
    the traces' (origin, direction, t_max, active, hit))."""
    n = ro.shape[0]
    calls = []

    def traced(*a, **kw):
        hit = dispatch.trace(*a, **kw)
        calls.append((a[2], a[3], kw.get('t_max'), kw.get('active'), hit))
        return hit
    out = torch.zeros((n, 3), device=ro.device)
    count = torch.zeros((), dtype=torch.int64, device=ro.device)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trt, 'trace', traced)
        children = route(arr, dyn, ro, rd, weight,
                         torch.arange(n, device=ro.device), out, count)
    return out, count, children, calls


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _levels_agree(arr, dyn, levels) -> list:
    """Every level through both routes; the names of the outputs that
    differ, per level, and the shadow rays traced."""
    report = []
    for depth, (ro, rd, weight) in enumerate(levels):
        p_out, p_count, p_children, p_calls = _run_level(
            trt._level_plain, arr, dyn, ro, rd, weight)
        k_out, k_count, k_children, k_calls = _run_level(
            functools.partial(trt._shade_level_kernels,
                              whitted_shade.tables(arr, dyn)),
            arr, dyn, ro, rd, weight)
        bad = [f'{name} {f}'
               for name, pc, kc in zip(('closest',) + ('shadow',) * 8,
                                       p_calls, k_calls)
               for f, x, y in zip(('origin', 'direction', 't_max', 'active'),
                                  pc[:4], kc[:4]) if not _same(x, y)]
        bad += [f'trace {i} hit' for i, (pc, kc) in
                enumerate(zip(p_calls, k_calls))
                if not all(map(_same, pc[4][:4], kc[4][:4]))]
        if len(p_calls) != len(k_calls):
            bad.append(f'traces {len(p_calls)} vs {len(k_calls)}')
        bad += [f'child {f}' for f, x, y in zip(
            ('origin', 'direction', 'weight', 'pixel', 'active'),
            p_children, k_children) if not _same(x, y)]
        if not _same(p_out, k_out):
            bad.append('contribution')
        if int(p_count) != int(k_count):
            bad.append(f'shadow rays {int(p_count)} vs {int(k_count)}')
        report.append((depth, ro.shape[0], int(p_count), bad))
    return report


@pytest.mark.parametrize('name', list(WHITTED_CASES))
def test_whitted_shade_kernels_match_plain(dev, whitted_scenes, name):
    """Every level of a depth-7 frame through the two kernels and through
    the plain route, on the same rays: the shadow rays handed to each
    any-hit trace (origin, direction, t_max, active), the children (origin,
    direction, weight, pixel, active) and each lane's contribution bit for
    bit, and the same count of shadow rays."""
    arr, dyn, cam, W, H = whitted_scenes(name)
    levels = _level_inputs(arr, dyn, cam, W, H)
    assert len(levels) == 7 or name != 'sibenik'
    report = _levels_agree(arr, dyn, levels)
    for depth, n, shadow, bad in report:
        print(f'{name} level {depth}: {n} lanes, {shadow} shadow rays, '
              f'differ: {bad}')
    assert levels and not any(bad for *_, bad in report)
    assert sum(shadow for _, _, shadow, _ in report) > 0
    if name == 'outside':
        assert arr.point_light_pos.shape[0] == 3
        assert not torch.equal(dyn.inst_transform[:, :, :3],
                               torch.eye(3, device=dev).expand(
                                   dyn.inst_transform.shape[0], 3, 3))
    if name == 'no_spheres_or_planes':
        assert arr.sphere_pos.shape[0] == arr.plane_normal.shape[0] == 0


@pytest.mark.parametrize('name', ['sibenik', 'glass_room'])
def test_whitted_frame_kernels_match_plain_route(dev, whitted_scenes, name):
    """A depth-7 frame on the card through the kernels and through the
    plain route: the same stats, and the frame equal up to the order of the
    atomic adds into a pixel. Its contributions are non-negative, so two
    orders of summing k of them differ by at most 2 (k - 1) u of the sum
    (u = 2^-24); a pixel sums at most 2^7 - 1 lanes: rtol 1.6e-5. The
    kernels launch twice a level that has lanes, and no plain version runs."""
    arr, dyn, cam, W, H = whitted_scenes(name)
    frames, stats = [], []
    for route in ('kernels', 'plain'):
        stats.append([])
        with pytest.MonkeyPatch.context() as mp:
            if route == 'plain':
                mp.setattr(trt, '_shade_level_kernels',
                           lambda tables, *a: trt._level_plain(*a))
            launches = kernels.LAUNCHES['whitted_shade']
            plain = kernels.PLAIN_ON_CUDA['whitted_shade']
            frames.append(trt.render_whitted(arr, dyn, cam, width=W, height=H,
                                             max_depth=7, stats=stats[-1]))
        live = sum(1 for s in stats[-1] if s['active'])
        if route == 'kernels':
            assert kernels.LAUNCHES['whitted_shade'] - launches == 2 * live
            assert kernels.PLAIN_ON_CUDA['whitted_shade'] == plain
        else:
            assert kernels.PLAIN_ON_CUDA['whitted_shade'] - plain == live
    assert stats[0] == stats[1]
    assert (frames[0] >= 0).all() and torch.isfinite(frames[0]).all()
    assert torch.allclose(frames[0], frames[1], rtol=1.6e-5, atol=0.0)


# ---------------------------------------------------------------------------
# the trace as two launches: csrc/traverse.cu's prepass_kernel, then the
# walk with its merge epilogue, against the plain prepass and against the
# trace as the card ran it before (_torch_prepass_cases.trace_before: the
# PyTorch prepass and fills, the walk kernel alone, the where()s)

# trace keywords (the prepass's t_max / active / stop_on_hit each given or
# left to its default)
PREPASS_CALLS = {
    'closest uv': lambda z: dict(active=z['active'], want_uv=True),
    'defaults': lambda z: dict(),
    'shadow': lambda z: dict(t_max=z['t_max'], active=z['active'],
                             any_hit=True),
    'any-hit defaults': lambda z: dict(any_hit=True),
    'mixed stop': lambda z: dict(t_max=z['t_max'], active=z['active'],
                                 stop_on_hit=z['stop'], want_uv=True),
    'stop, no active': lambda z: dict(t_max=z['t_max'],
                                      stop_on_hit=z['stop']),
}


@pytest.fixture(scope='module')
def prepass_room(dev, room):
    """The room's arrays and tables, and this file's hard prepass rays
    (half of the random ones moved inside the room) on the card."""
    arr, dyn = room
    z = {k: torch.as_tensor(v, device=dev)
         for k, v in pc.rays(20000, seed=7).items()}
    rs = np.random.RandomState(8)
    n = z['ro'].shape[0]
    inside = torch.as_tensor(rs.rand(n) < 0.5, device=dev)
    z['ro'] = torch.where(inside[:, None], torch.as_tensor(rs.uniform(
        [-2.9, 0.05, -1.9], [2.9, 3.9, 3.9], (n, 3)).astype(np.float32),
        device=dev), z['ro'])
    return arr, dyn, z


def _prepass_scene(arr, prims):
    return arr if prims == 'room' else pc.with_primitives(arr, prims)


@pytest.mark.parametrize('prims', ['room'] + list(pc.PRIMITIVE_SETS))
@pytest.mark.parametrize('call', list(PREPASS_CALLS))
def test_prepass_kernel_matches_plain(dev, prepass_room, prims, call):
    """``prepass_kernel`` against the plain prepass on the same tensors:
    t, prim_type, prim_id, found, live and stop bit for bit on every lane
    (ties, tangents, rays from inside, parallel rays, short t_max, NaN and
    infinite directions, inactive and stop-on-hit lanes), with no sphere,
    no plane or neither."""
    arr, dyn, z = prepass_room
    scene = _prepass_scene(arr, prims)
    kw = PREPASS_CALLS[call](z)
    kw.pop('want_uv', None)
    before = dict(kernels.LAUNCHES)
    plain = kernels.PLAIN_ON_CUDA['prepass']
    got = prepass(scene, z['ro'], z['rd'], **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['prepass'] == before['prepass'] + 1
    assert kernels.PLAIN_ON_CUDA['prepass'] == plain
    assert {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]} == {'prepass': 1}
    want = prepass_ref(scene, z['ro'], z['rd'], **kw)
    assert pc.differing(got, want) == []
    assert all(x.is_contiguous() for x in got)
    if prims != 'none':
        assert want.found.any() and not want.found.all()


@pytest.mark.parametrize('route', ['v2', 'v1'])
@pytest.mark.parametrize('prims', ['room', 'spheres and planes', 'none'])
@pytest.mark.parametrize('call', list(PREPASS_CALLS))
def test_trace_matches_the_card_route_before(dev, prepass_room, monkeypatch,
                                             route, prims, call):
    """``dispatch.trace`` on the card (v2: the prepass kernel, then the walk
    with its merge epilogue; v1: the prepass kernel, the v1 walk and the
    where()s) against the trace as the card ran it before, on the same
    tensors: every field of the Hit bit for bit on every lane, inactive
    ones included; one prepass launch and one walk launch per trace, no
    plain version on the card."""
    arr, dyn, z = prepass_room
    scene = _prepass_scene(arr, prims)
    kw = PREPASS_CALLS[call](z)
    monkeypatch.setattr(dispatch, 'PACKET_V1', route == 'v1')
    walk = 'traverse' if route == 'v2' else 'traverse_packet'
    before = dict(kernels.LAUNCHES)
    plain = dict(kernels.PLAIN_ON_CUDA)
    hit = dispatch.trace(scene, dyn, z['ro'], z['rd'], **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]} == {'prepass': 1, walk: 1}
    assert kernels.PLAIN_ON_CUDA == plain
    want = pc.trace_before(scene, dyn, z['ro'], z['rd'], v1=route == 'v1',
                           **kw)
    assert pc.differing(hit, want) == []
    assert hit.intersected.any() and not hit.intersected.all()
    if route == 'v2' and kw.get('want_uv'):
        assert hit.u is not None and bool((hit.u != 0)[hit.intersected].any())


@pytest.mark.parametrize('route', ['v2', 'v1'])
def test_trace_on_sibenik_level0_waves(dev, whitted_scenes, monkeypatch,
                                       route):
    """Sibenik's 640x480 depth-7 Whitted frame on the card: over the frame
    the prepass launches once per walk and no plain version runs; its
    level-0 closest-hit and shadow waves, traced again, give the Hit of the
    route before bit for bit."""
    arr, dyn, cam, W, H = whitted_scenes('sibenik')
    assert arr.sphere_pos.shape[0] == 2 and arr.plane_normal.shape[0] == 0
    monkeypatch.setattr(dispatch, 'PACKET_V1', route == 'v1')
    walk = 'traverse' if route == 'v2' else 'traverse_packet'
    saved = []

    def recorded(*a, **kw):
        if len(saved) < 2:
            saved.append((a, kw))
        return dispatch.trace(*a, **kw)
    monkeypatch.setattr(trt, 'trace', recorded)
    before = dict(kernels.LAUNCHES)
    plain = dict(kernels.PLAIN_ON_CUDA)
    trt.render_whitted(arr, dyn, cam, width=W, height=H, max_depth=7)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    assert launched['prepass'] == launched[walk] >= 8
    assert kernels.PLAIN_ON_CUDA == plain
    assert len(saved) == 2 and saved[1][1].get('any_hit')
    for a, kw in saved:
        hit = dispatch.trace(*a, **kw)
        want = pc.trace_before(*a, v1=route == 'v1', **kw)
        assert pc.differing(hit, want) == []
        assert hit.intersected.any()
