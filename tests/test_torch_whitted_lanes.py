"""The lanes of each Whitted level (``ops/whitted_lanes.py``,
``csrc/whitted_lanes.cu``) on the CPU.

(a) The wrappers' contracts: they raise on tensors of the wrong dtype or
shape, and on CPU tensors.

(b) The compaction's keys (``falling_keys``, as ``scatter_kernel`` writes
them) sort as ``argsort(-score, stable=True)`` on zeros of both signs,
infinities, negative weights and NaN.

(c) The kernels themselves, compiled for the CPU by
``_torch_cuda_emulation.py`` (a thread per CUDA thread) and called through
the wrappers: the primary rays bit-equal to ``raytracer._rays_plain``, and
each compaction's lanes, order and count dropped equal to
``raytracer._compact``'s, unordered and ordered, on ties, past the cap and
across the block sort's capacity.

(d) The CPU route of a frame: ``whitted.compact`` spans name the sort.
"""
import numpy as np
import pytest
import torch

import _torch_cuda_emulation as emulation
from _torch_room import CAMERA, GLASS_CAMERA, build_room
from cuda_pathtracer_tpu_torch.core import vecmath as vm
from cuda_pathtracer_tpu_torch.core.camera import Camera
from cuda_pathtracer_tpu_torch.models import raytracer as trt
from cuda_pathtracer_tpu_torch.ops import kernels, whitted_lanes as wl
from cuda_pathtracer_tpu_torch.scene import scene as scene_mod
from cuda_pathtracer_tpu_torch.scene.builder import add_cube
from cuda_pathtracer_tpu_torch.utils import profiling

CPU = torch.device('cpu')


def _lanes(m, n=None, seed=0, values=None):
    rs = np.random.RandomState(seed)
    w = (rs.rand(m, 3) if values is None else
         rs.choice(values, size=(m, 3))).astype(np.float32)
    active = np.zeros(m, bool)
    active[rs.choice(m, m // 3 if n is None else n, replace=False)] = True
    return tuple(torch.from_numpy(a) for a in (
        rs.rand(m, 3).astype(np.float32), rs.rand(m, 3).astype(np.float32),
        w, rs.randint(0, 1 << 40, m).astype(np.int64), active))


# ---------------------------------------------------------------------------
# (a) contracts

def _camera(**change):
    cam = Camera.create(**CAMERA, device='cpu')
    return cam._replace(**change)


@pytest.mark.parametrize('camera,error', [
    (dict(), 'is on cpu'),
    (dict(eye=torch.zeros(3, dtype=torch.float64)), 'float64'),
    (dict(view_dir=torch.zeros(4)), 'shape'),
    (dict(d=torch.ones(1)), 'shape'),
], ids=['cpu', 'dtype', 'view shape', 'd shape'])
def test_primary_rays_contract(camera, error):
    with pytest.raises((TypeError, ValueError), match=error):
        wl.primary_rays(_camera(**camera), 64, 48, 7)


def _bad(i, t):
    lanes = list(_lanes(40))
    lanes[i] = t
    return lanes


@pytest.mark.parametrize('lanes,error', [
    (_lanes(40), 'is on cpu'),
    (_bad(3, torch.zeros(40, dtype=torch.int32)), 'int32'),
    (_bad(2, torch.zeros(40, 3, dtype=torch.float16)), 'float16'),
    (_bad(4, torch.zeros(40, dtype=torch.uint8)), 'uint8'),
    (_bad(0, torch.zeros(40, 4)), 'shape'),
    (_bad(3, torch.zeros(41, dtype=torch.int64)), 'shape'),
    (_bad(4, torch.zeros(40, 1, dtype=torch.bool)), 'shape'),
], ids=['cpu', 'pixel dtype', 'weight dtype', 'active dtype',
        'origin shape', 'pixel shape', 'active shape'])
def test_compact_contract(lanes, error):
    with pytest.raises((TypeError, ValueError), match=error):
        wl.compact(*lanes, 80, True)


@pytest.mark.parametrize('n,kept,path', [(10, 4, 'bitonic'), (10, 11,
                                                                'block')])
def test_sorted_lanes_contract(n, kept, path):
    with pytest.raises(ValueError, match='cannot sort'):
        wl.sorted_lanes(torch.zeros(n, dtype=torch.int64), n, kept,
                        _lanes(n)[:4], path)


# ---------------------------------------------------------------------------
# (b) the keys

def test_falling_keys_order_special_values():
    """Zeros of both signs tie, NaN sorts last, infinities and negative
    weights in their place: the keys' ascending order is the stable
    ``argsort(-score)`` of the plain compaction."""
    v = [0.0, -0.0, 0.25, 1e-6, 1e-40, np.inf, -np.inf, -3.0, np.nan, 0.5]
    w = torch.from_numpy(np.random.RandomState(4).choice(
        v, size=(3000, 3)).astype(np.float32))
    idx = torch.arange(0, 3000, 2)
    keys = wl.falling_keys(w, idx)
    assert torch.unique(keys).shape == keys.shape
    want = idx[torch.argsort(-vm.max_comp(w[idx]), stable=True)]
    assert torch.equal(torch.sort(keys).values & 0xffffffff, want)


# ---------------------------------------------------------------------------
# (c) the kernels, emulated

@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    sig = {k: v for k, v in kernels._SIGNATURES.items()
           if k.startswith(('cpt_whitted_lanes', 'cpt_whitted_sort',
                            'cpt_whitted_gather', 'cpt_whitted_primary'))}
    return emulation.build('whitted_lanes.cu',
                           str(tmp_path_factory.mktemp('lanes')), sig)


@pytest.fixture
def on_cpu(emulated, monkeypatch):
    """The wrappers call the emulated library on CPU tensors: the device
    test of the contract lifted, its pinned count and capacity set."""
    def require(name, *tensors, dtypes=None):
        for i, t in enumerate(tensors):
            assert t.is_contiguous(), (name, i)
    monkeypatch.setattr(kernels, 'library', lambda: emulated)
    monkeypatch.setattr(kernels, 'require_cuda', require)
    monkeypatch.setattr(kernels, 'stream_of', lambda t: 0)
    monkeypatch.setitem(wl._pinned, CPU, torch.zeros(1, dtype=torch.int32))
    monkeypatch.setitem(wl._capacity, CPU,
                        emulated.cpt_whitted_sort_capacity())
    return emulated


def _same(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize('size', [(64, 48), (37, 19)])
@pytest.mark.parametrize('camera', [CAMERA, GLASS_CAMERA,
                                    dict(eye=[1.0, 2.0, -3.0],
                                         view_dir=[0.37, -0.41, 0.83],
                                         d=1.3, focal_length=5.0,
                                         aperture=0.0)],
                         ids=['room', 'glass room', 'tilted'])
def test_emulated_primary_rays_match_plain(on_cpu, camera, size):
    W, H = size
    cam = Camera.create(**camera, device='cpu')
    before = kernels.LAUNCHES['whitted_lanes']
    got = wl.primary_rays(cam, W, H, 7)
    assert kernels.LAUNCHES['whitted_lanes'] - before == 1
    want = trt._rays_plain(cam, W, H, 7)
    for name, g, x in zip(('origin', 'direction', 'weight', 'pixel', 'frame',
                           'shadow'), got, want):
        assert _same(g, x.contiguous()), name


TIES = (0.0, 0.25, 0.5, 1e-6, 0.75)
# (lanes, active, weights drawn from, ordered, cap, the sort it takes);
# the threshold cases add the capacity to their active count
EMULATED_CASES = {
    'unordered, several tiles': (20000, 7000, None, False, 40000, 'none'),
    'unordered, a tile and a lane': (4097, 4097, None, False, 8194, 'none'),
    'no active lane': (3000, 0, None, True, 6000, 'none'),
    'no lane': (0, 0, None, True, 6000, 'none'),
    'ordered ties': (9000, 700, TIES, True, 18000, 'block'),
    'ordered ties over the cap': (9000, 700, TIES, True, 300, 'block'),
    'a cap of 0': (900, 300, TIES, True, 0, 'none'),
    'capacity': (40000, 0, TIES, True, 80000, 'block'),
    'capacity + 1 over the cap': (40000, 1, TIES, True, 1000, 'library'),
}


def test_emulated_sort_threshold(on_cpu):
    """A block sorts at most 8 keys in each of 1,024 threads: 8,192, which
    an H100 block's shared memory holds."""
    assert on_cpu.cpt_whitted_sort_capacity() == 8192
    assert wl.sort_threshold(CPU) == 8192


@pytest.mark.parametrize('case', list(EMULATED_CASES))
def test_emulated_compact_matches_plain(on_cpu, case, monkeypatch):
    m, n, values, ordered, cap, path = EMULATED_CASES[case]
    if case.startswith('capacity'):
        # a capacity of 2,048 keys (256 threads: stages in registers, by
        # shuffles and through shared memory), sorted by two blocks that
        # each gather half
        monkeypatch.setitem(wl._capacity, CPU, 2048)
        n += wl.sort_threshold(CPU)
        monkeypatch.setattr(wl, 'GATHER_ROWS', n // 2)
    lanes = _lanes(m, n, values=values)
    before = dict(kernels.LAUNCHES)
    got, dropped, sort = wl.compact(*lanes, cap, ordered)
    ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    want, want_dropped, _ = trt._compact(*lanes, cap, ordered)
    assert sort == path
    assert dropped == want_dropped == max(n - cap, 0)
    for name, g, x in zip(('origin', 'direction', 'weight', 'pixel'), got,
                          want):
        assert _same(g, x), name
    assert ran['whitted_lanes'] == (2 + (path != 'none') if m else 0)
    assert path == 'none' or ran[f'whitted_sort_{path}'] == 1


# ---------------------------------------------------------------------------
# (d) the CPU route

def test_cpu_frame_compactions_name_their_sort():
    """On the CPU a frame forms its lanes with the plain versions: level
    0 from ``_rays_plain``, then ``_compact`` (``sort`` attribute ``none``
    into level 1, ``library`` into the ordered levels), and no kernel."""
    scene = build_room(scene_mod, add_cube)
    rt = trt.Raytracer(scene, 16, 12, device='cpu')
    before = kernels.LAUNCHES['whitted_lanes']
    with profiling.record() as got:
        rt.render(Camera.create(**CAMERA, device='cpu'))
    sorts = [s.attrs['sort'] for s in got if s.name == 'whitted.compact']
    assert sorts == ['none'] + ['library'] * 5
    assert kernels.LAUNCHES['whitted_lanes'] == before
