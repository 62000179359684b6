"""``--shard`` on the CPU: the port's ``parallel/mesh.py`` (one process per
rank over ``torch.distributed`` gloo, ranks meeting at a file store under
the test's directory) against the JAX package's ``ShardedPathtracer`` on a
virtual 2-device mesh, and against the port's own single engine.

(i) ``mesh_geometry`` gives the JAX engine's (height, bands, band_h,
tile_order) on every listed size and rank count, padded frames included.
(ii) Two ranks render the room at 64x64 (one clear frame, 3 converge
samples) as the JAX mesh does: ``sample_idx`` and ``rand_idx`` after every
frame equal, 99% of the pixels within rtol 1e-3 / atol 1e-5, the energy to
rtol 1e-3, the radiance cache to rtol 1e-3 / atol 1e-4 (the tolerances of
``tests/test_torch_pathtracer.py``). (iii) The 64x63 frame, padded to 64
rows at two ranks: the cropped image and the energy. (iv) Two ranks
against the single engine at the same geometry (4 bands, two per rank):
``lum`` bit-equal after the clear frame and the first converge sample,
``rand_idx`` equal, the radiance cache to rtol 1e-4 / atol 1e-5 (the
guiding sums are added in another order), after the second sample the
weight channel equal and the mean within 2%; at a world of one, in this
process, everything is bit-equal. (v) The same at spp 2 (4 bands of 16
rows). (vi) The CLI at two ranks in torchrun's environment: its PNG equals
the same steps run here and the run whose second rank the CLI spawns
itself, a ``--checkpoint`` / ``--resume`` round trip equals a straight
run, ``--interactive`` fed the same keys ends in the same camera at
one and two ranks, Ctrl-C at rank 0's prompt stops both ranks, and the
two-rank checkpoint does not resume in the single engine (another lane
order). The backend is NCCL exactly when every rank has a card of its own.

Every group of processes starts with the module and is joined with a
timeout (killed on expiry), and every collective times out, so a rank that
hangs fails its test instead of the run. ~35 s on the CPU when run alone.
"""
import json
import os
import signal
import socket
import sys
import time

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_rank as ranks
from _torch_room import CAMERA, build_room, write_cube_obj
from cuda_pathtracer_tpu.core.camera import Camera as JCamera
from cuda_pathtracer_tpu.parallel.mesh import ShardedPathtracer as JSharded
from cuda_pathtracer_tpu.parallel.mesh import make_mesh
from cuda_pathtracer_tpu.scene import scene as js
from cuda_pathtracer_tpu_torch.core.camera import Camera as TCamera
from cuda_pathtracer_tpu_torch.models import pathtracer as tptm
from cuda_pathtracer_tpu_torch.parallel import mesh as tmesh
from cuda_pathtracer_tpu_torch.scene import scene as ts
from cuda_pathtracer_tpu_torch.scene import state as tstate
from cuda_pathtracer_tpu_torch.scene.builder import add_cube, get_scene
from cuda_pathtracer_tpu_torch.utils.image import save_png

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FRAMES = [True, False, False, False]
GROUPS = {
    'jax64': dict(world=2, width=64, height=64, frames=FRAMES),
    'pad63': dict(world=2, width=64, height=63, frames=[True, False]),
    'bands4': dict(world=2, width=64, height=64, frames=[True, False, False],
                   max_lanes=1024),
    'spp2': dict(world=2, width=64, height=64, frames=[True, False, False],
                 max_lanes=2048, spp=2),
}
# a static scene for the CLI (no animation handler: a resumed run traces
# what a straight one does): two cubes, one emissive, and a plane
CHAI = ('def lit(c) { var m = DiffuseMaterial(make_float3(c))\n'
        '  m.emission = make_float3(4.0)\n  return m }\n'
        'var s = scene_add_material(DiffuseMaterial(make_float3(0.5)))\n'
        'var l = scene_add_material(lit(1.0))\n'
        'for (var i = 0; i < 2; ++i) {\n'
        '  var o = GameObject(scene_add_model("cube.obj", 1.0,\n'
        '    make_float3(0, 0, 0), make_float3(0, 0, 0), s + i * l, false))\n'
        '  o.position.x = 3 * i\n  scene_add_object(o)\n}\n'
        'scene_add_plane(Plane(make_float3(0, -1, 0), -3.0, s))\n')
STATE = '1.5|1|-9\n0|-0.1|1\n1.5\n9\n0.02\n'
KEYS = 'w\nd\nww\nquit\n'


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


class _Cli:
    """``python -m cuda_pathtracer_tpu_torch --shard --device cpu`` runs:
    ``world`` 2 as two processes in torchrun's environment, 1 as one
    process that runs its one rank itself."""

    def __init__(self, d):
        self.d = d

    def start(self, tag: str, extra: list, world: int, stdin: str | None = ''):
        args = [sys.executable, '-m', 'cuda_pathtracer_tpu_torch', '--shard',
                '--device', 'cpu', '--scene', str(self.d / 's.chai'),
                '--width', '32', '--height', '24', '--asset-dir', str(self.d),
                '--out', str(self.d / f'{tag}.png'),
                '--state', str(self.d / f'{tag}.txt'), *extra]
        (self.d / f'{tag}.txt').write_text(STATE)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
        port = str(_free_port())
        procs = []
        for r in range(world):
            if world > 1:
                env = dict(env, RANK=str(r), LOCAL_RANK=str(r),
                           WORLD_SIZE=str(world),
                           LOCAL_WORLD_SIZE=str(world),
                           MASTER_ADDR='127.0.0.1', MASTER_PORT=port)
            p = ranks.start(args, env, str(self.d / f'{tag}.r{r}.log'),
                            stdin if r == 0 else '', cwd=str(self.d))
            procs.append(p)
        return procs


@pytest.fixture(scope='module')
def started(tmp_path_factory):
    """Every process group of the module, started at once."""
    runs = {}
    for name, spec in GROUPS.items():
        tmp = tmp_path_factory.mktemp(name)
        runs[name] = (ranks.launch(dict(spec, out=str(tmp / 'out')), tmp),
                      tmp / 'out')
    d = tmp_path_factory.mktemp('cli')
    write_cube_obj(d)
    (d / 's.chai').write_text(CHAI)
    cli = _Cli(d)
    runs['straight'] = (cli.start('straight', ['--spp', '5'], 2), d)
    runs['ckpt'] = (cli.start('ckpt', ['--spp', '3', '--checkpoint',
                                       str(d / 'c.npz')], 2), d)
    runs['keys1'] = (cli.start('keys1', ['--interactive'], 1, KEYS), d)
    runs['keys2'] = (cli.start('keys2', ['--interactive'], 2, KEYS), d)
    runs['sigint'] = (cli.start('sigint', ['--interactive'], 2, None), d)
    done = {}

    def result(name):
        if name not in done:
            procs, out = runs[name]
            done[name] = (ranks.join(procs), out)
        return done[name]
    result.cli = cli
    result.runs = runs
    yield result
    for procs, _ in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if p.stdin is not None and not p.stdin.closed:
                p.stdin.close()


def _rank0(started, name):
    _, out = started(name)
    with np.load(out / 'rank0.npz') as z:
        r = {k: z[k] for k in z.files}
    r['owned'] = [json.loads((out / f'rank{i}.json').read_text())
                  for i in range(GROUPS[name]['world'])]
    return r


# ---- (i) geometry ----

GEOMETRY = [(64, 64, n) for n in (1, 2, 4, 8)] + [
    (64, 63, 2), (64, 98, 4), (64, 100, 8), (640, 480, 2), (640, 480, 4)] + [
    (1920, 1080, n) for n in (1, 2, 4, 8)]


@pytest.fixture(scope='module')
def jax_room():
    return build_room(js, add_cube)


@pytest.mark.parametrize('w,h,n', GEOMETRY,
                         ids=[f'{w}x{h}-n{n}' for w, h, n in GEOMETRY])
def test_mesh_geometry_matches_jax(started, jax_room, w, h, n):
    jpt = JSharded(jax_room, w, h, mesh=make_mesh(jax.devices()[:n]))
    bands = tptm.band_geometry(w, h, 1, tptm.Pathtracer.MAX_LANES_PER_DISPATCH)[0]
    height, b = tmesh.mesh_geometry(w, h, bands, n)
    band_h = height // b
    tile = w % 16 == 0 and band_h % 8 == 0
    assert (height, b, band_h, tile) == (jpt.height, jpt.bands, jpt.band_h,
                                         jpt.tile_order)
    if (w, h) in ((64, 98), (64, 100)):
        assert height == 128
    if (w, h, n) == (1920, 1080, 2):
        assert (b, band_h, tile) == (6, 180, False)
    if (w, h, n) == (1920, 1080, 4):
        assert (b, band_h, tile) == (8, 135, False)


# ---- (ii), (iii): two ranks against the JAX mesh ----

def _jax_mesh(w, h, frames):
    jpt = JSharded(build_room(js, add_cube), w, h,
                   mesh=make_mesh(jax.devices()[:2]))
    cam = JCamera.create(**CAMERA)
    ridx = []
    for clear in frames:
        jpt.render(cam, should_clear=clear)
        ridx.append(int(jpt.rand_idx))
    return jpt, ridx


def _close(got, want, share=0.99):
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5)
    close = close.all(axis=-1).mean()
    assert close >= share, close


def test_two_ranks_match_jax_mesh(started):
    jpt, jridx = _jax_mesh(64, 64, FRAMES)
    r = _rank0(started, 'jax64')
    assert (int(r['height']), int(r['bands']), int(r['band_h']),
            bool(r['tile_order'])) == (jpt.height, jpt.bands, jpt.band_h,
                                       jpt.tile_order) == (64, 2, 32, True)
    assert [o['bands'] for o in r['owned']] == [[0], [1]]
    assert [o['lanes'] for o in r['owned']] == [2048, 2048]
    assert list(r['ridx']) == jridx
    assert list(r['sidx']) == [1, 2, 3, 4] and jpt.sample_idx == 4
    lum_j, alb_j = (np.asarray(a) for a in jpt.accumulators_pixel_order())
    for got, want in ((r['lum'], lum_j), (r['alb'], alb_j)):
        np.testing.assert_array_equal(got[:, 3], want[:, 3])
        _close(got[:, :3], want[:, :3])
    je, jnan, jneg = jpt.energy()
    assert not (jnan or jneg or r['flags'].any())
    np.testing.assert_allclose(float(r['energy']), je, rtol=1e-3)
    assert (r['cache'] != 0.1).any()
    np.testing.assert_allclose(r['cache'], np.asarray(jpt.radiance.cache),
                               rtol=1e-3, atol=1e-4)


def test_padded_frame_matches_jax_mesh(started):
    jpt, jridx = _jax_mesh(64, 63, [True, False])
    r = _rank0(started, 'pad63')
    assert (int(r['height']), int(r['bands'])) == (jpt.height, jpt.bands) \
        == (64, 2)
    assert list(r['ridx']) == jridx
    want = np.asarray(jpt.image())
    assert r['image'].shape == want.shape == (63, 64, 3)
    _close(r['image'], want)
    je, _, _ = jpt.energy()
    np.testing.assert_allclose(float(r['energy']), je, rtol=1e-3)


# ---- (iv), (v): two ranks, and one, against the single engine ----

def _single(monkeypatch, frames, spp, bands=None):
    monkeypatch.setattr(tptm.Pathtracer, 'MAX_LANES_PER_DISPATCH',
                        1024 * spp)
    monkeypatch.setattr(tptm.Pathtracer, 'SPP_PER_DISPATCH', spp)
    pt = tptm.Pathtracer(build_room(ts, add_cube), 64, 64, device='cpu')
    if bands is not None:
        pt._set_bands(bands)
    cam = TCamera.create(**CAMERA, device='cpu')
    out = []
    for clear in frames:
        pt.render(cam, should_clear=clear)
        out.append((pt.rand_idx, pt.lum.clone(), pt.alb.clone(),
                    pt.radiance.cache.clone()))
    return pt, out


@pytest.mark.parametrize('name,spp,per', [('bands4', 1, 2), ('spp2', 2, 2)])
def test_two_ranks_match_single_engine(started, monkeypatch, name, spp, per):
    r = _rank0(started, name)
    bands = int(r['bands'])
    assert bands == 2 * per
    assert [o['bands'] for o in r['owned']] == [list(range(per)),
                                                list(range(per, 2 * per))]
    _, frames = _single(monkeypatch, GROUPS[name]['frames'], spp, bands)
    assert list(r['ridx']) == [f[0] for f in frames]
    for i in (0, 1):    # the clear frame and the first converge sample
        np.testing.assert_array_equal(r[f'lum{i}'], frames[i][1].numpy())
    np.testing.assert_allclose(r['cache1'], frames[1][3].numpy(), rtol=1e-4,
                               atol=1e-5)
    got, want = r['lum2'], frames[2][1].numpy()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    assert abs(got[:, :3].mean() / want[:, :3].mean() - 1) < 0.02


def test_world_of_one_is_bit_equal(tmp_path, monkeypatch):
    frames = [True, False, False]
    _, want = _single(monkeypatch, frames, 1)
    group = tmesh.init_group('cpu', 0, 1, str(tmp_path / 'store'))
    try:
        sp = tmesh.ShardedPathtracer(build_room(ts, add_cube), 64, 64,
                                     group=group)
        assert (sp.height, sp.bands, sp.band_h, sp.tile_order) == \
            (64, 4, 16, True)
        cam = TCamera.create(**CAMERA, device='cpu')
        for clear, (ridx, lum, alb, cache) in zip(frames, want):
            sp.render(cam, should_clear=clear)
            assert sp.rand_idx == ridx
            for a, b in ((sp.lum, lum), (sp.alb, alb),
                         (sp.radiance.cache, cache)):
                assert torch.equal(a, b)
    finally:
        tmesh.close_group()


# ---- (vi) the CLI ----

def test_cli_two_ranks_equal_the_steps(started, tmp_path):
    text, d = started('straight')
    assert text.count('rendered 32x24 @ 5 spp') == 1      # rank 0 only
    group = tmesh.init_group('cpu', 0, 1, str(tmp_path / 'store'))
    try:
        scene = get_scene(str(d / 's.chai'), asset_dirs=[str(d)])
        cam = tstate.read_state(str(d / 'straight.txt'), device='cpu')
        sp = tmesh.ShardedPathtracer(scene, 32, 24, group=group)
        height, bands = tmesh.mesh_geometry(32, 24, sp.bands, 2)
        assert height == 24
        sp._set_bands(bands)
        scene.update(None, 0.0)
        sp.render(cam, should_clear=True)
        while sp.sample_idx < 5:
            sp.render(cam)
        save_png(sp.image().numpy(), str(tmp_path / 'steps.png'))
        energy = sp.energy()[0]
    finally:
        tmesh.close_group()
    assert (d / 'straight.png').read_bytes() == \
        (tmp_path / 'steps.png').read_bytes()
    assert f'energy {energy:.2f} nan=False neg=False' in text


# the CLI module run as ``python -m cuda_pathtracer_tpu_torch`` runs it (as
# __main__, under its package's spec), stopped at its argument parser; then
# its own start of ranks with the argument vector given on stdin
AS_MAIN = """
import importlib.util, json, sys, types
import torch.distributed as dist
spec = importlib.util.find_spec('cuda_pathtracer_tpu_torch.__main__')
main = types.ModuleType('__main__')
main.__spec__, main.__file__ = spec, spec.origin
main.__package__ = 'cuda_pathtracer_tpu_torch'
sys.modules['__main__'] = main
argv, sys.argv = json.loads(sys.stdin.read()), ['cpt', '--not-an-option']
try:
    exec(compile(open(spec.origin).read(), spec.origin, 'exec'), main.__dict__)
except SystemExit:
    pass
rc = main._spawn_ranks(argv, 2)
assert not dist.is_initialized()
sys.exit(rc)
"""


def test_cli_spawns_its_ranks(started, tmp_path):
    """The CLI's own start of ranks (one per card on a machine with
    several), with the CLI module as ``python -m`` runs it: rank 0 in that
    process, rank 1 spawned, meeting at a file store; the PNG equals the
    torchrun-started run's."""
    _, d = started('straight')
    state = tmp_path / 'state.txt'
    state.write_text(STATE)
    argv = ['--shard', '--device', 'cpu', '--scene', str(d / 's.chai'),
            '--width', '32', '--height', '24', '--asset-dir', str(d),
            '--spp', '5', '--out', str(tmp_path / 'spawned.png'),
            '--state', str(state)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    text = ranks.join([ranks.start([sys.executable, '-c', AS_MAIN], env,
                                   str(tmp_path / 'spawn.log'),
                                   json.dumps(argv), cwd=str(tmp_path))])
    assert 'shard: 2 ranks, backend gloo' in text
    assert (tmp_path / 'spawned.png').read_bytes() == \
        (d / 'straight.png').read_bytes()


def test_cli_checkpoint_resume_equals_straight(started):
    text, d = started('ckpt')
    assert 'checkpoint -> ' in text
    with np.load(d / 'c.npz') as z:
        assert (int(z['height']), int(z['sample_idx'])) == (24, 3)
        assert z['lum'].shape == (32 * 24, 4)
    resumed = started.cli.start('resumed', ['--spp', '5', '--resume',
                                            str(d / 'c.npz')], 2)
    text = ranks.join(resumed)
    assert 'resumed at 3 spp' in text
    started('straight')
    assert (d / 'resumed.png').read_bytes() == \
        (d / 'straight.png').read_bytes()


def test_cli_interactive_keys_one_and_two_ranks(started):
    _, d = started('keys1')
    started('keys2')
    one, two = ((d / f'keys{n}.txt').read_text() for n in (1, 2))
    assert one == two != STATE


def test_cli_interactive_ctrl_c_stops_every_rank(started):
    """Ctrl-C at rank 0's prompt, with no line typed: both ranks leave the
    loop together and exit 0, well within the collectives' timeout."""
    procs, d = started.runs['sigint']
    log = d / 'sigint.r0.log'
    end = time.monotonic() + 150
    while '] > ' not in log.read_text():
        assert procs[0].poll() is None and time.monotonic() < end, \
            log.read_text()[-2000:]
        time.sleep(0.2)
    procs[0].send_signal(signal.SIGINT)
    ranks.join(procs, timeout=tmesh.TIMEOUT_S / 2)
    assert log.read_text().count('] > ') == 1
    assert (d / 'sigint.txt').exists()


def test_cli_resume_at_another_rank_count_is_refused(started):
    """The two-rank checkpoint at 32x24 holds 2 bands of 12 rows in
    row-major order; the single engine's lanes are 1 band in tile order."""
    from cuda_pathtracer_tpu_torch.utils.checkpoint import load_checkpoint
    _, d = started('ckpt')
    single = tptm.Pathtracer(get_scene(str(d / 's.chai'), asset_dirs=[str(d)]),
                             32, 24, device='cpu')
    assert (single.bands, single.tile_order) == (1, True)
    with np.load(d / 'c.npz') as z:
        assert (int(z['bands']), bool(z['tile_order'])) == (2, False)
    with pytest.raises(AssertionError, match='band geometry'):
        load_checkpoint(str(d / 'c.npz'), single)


@pytest.mark.parametrize('ids, backend', [
    (['cuda GPU-a', 'cuda GPU-b'], 'nccl'),
    (['cuda GPU-a'], 'nccl'),
    (['cuda GPU-a', 'cuda GPU-a'], 'gloo'),     # two ranks on one card
    (['cpu', 'cpu'], 'gloo'),
    (['cuda GPU-a', 'cpu'], 'gloo'),
])
def test_backend_follows_the_ranks_cards(ids, backend):
    """NCCL exactly when every rank renders on a card of its own, whatever
    each rank can see (a launcher may show each rank one card as cuda:0)."""
    assert tmesh.choose_backend(ids) == backend
