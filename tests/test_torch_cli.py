"""The port's CLI (``python -m cuda_pathtracer_tpu_torch``) against the JAX
package's on the animated ``outside`` scene at 32x24 on the CPU: the same
arguments, ``cube.obj`` (written by the test), camera state file and scene
time. The headless path is the full build, the animation handlers at
``--time``, then a clearing frame that refits the moved cubes, then
converge samples. It runs twice, once with the v2 traversal and once with
``PACKET_V1`` (the split-table traversal and shading's re-intersect). At least
99% of the PNGs' pixels must be identical and the printed energies agree to
1e-4 relative; 32x24 is below the JAX tail gate, so both engines draw the
same random numbers.

``--mode ray`` (one clearing Whitted frame after the refit) runs the same
way, v2 and v1: at least 99.5% of the pixels identical, no energy line, the
same state file. A ``--checkpoint`` that one package writes at 6 spp
resumes in the other's ``--resume`` to 7 spp as it does in the JAX CLI's
(99% of the pixels identical, the energy to 1e-4). Scene scripts are
``tests/test_torch_chai.py``'s, ``--shard`` is ``tests/test_torch_mesh.py``'s.
"""
import contextlib
import io
import re

import numpy as np
import pytest
from PIL import Image

from _torch_room import write_cube_obj
from _torch_whitted import count_traversals
from cuda_pathtracer_tpu import __main__ as jmain
from cuda_pathtracer_tpu_torch import __main__ as tmain
from cuda_pathtracer_tpu_torch.accel import refit as trefit
from cuda_pathtracer_tpu_torch.ops import dispatch as tdispatch
from cuda_pathtracer_tpu_torch.ops import traverse_packet as tp1
from cuda_pathtracer_tpu_torch.ops import traverse_packet2 as tp2

# eye, view direction, d, focal length, aperture (the save.txt format)
STATE = '0|4|-17\n0|-0.2|1\n1.5\n12\n0.02\n'
ARGS = ['--scene', 'outside', '--width', '32', '--height', '24', '--time',
        '2', '--spp', '7']


def _cli(main, tmp_path, tag, extra=()):
    """Run a CLI main with stderr captured. Returns (stderr, PNG, state)."""
    state = tmp_path / f'{tag}.txt'
    state.write_text(STATE)
    out = tmp_path / f'{tag}.png'
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = main([*ARGS, '--asset-dir', str(tmp_path), '--state', str(state),
                   '--out', str(out), *extra])
    err = buf.getvalue()
    assert rc == 0, err[-2000:]
    return err, np.asarray(Image.open(out).convert('RGB')), state.read_text()


def _energy(err):
    return float(re.search(r'^energy (\S+) nan=False neg=False$', err,
                           re.M).group(1))


def _run(main, tmp_path, tag, extra=()):
    err, img, state = _cli(main, tmp_path, tag, extra)
    assert re.search(r'^rendered 32x24 @ 7 spp in ', err, re.M), err
    return img, _energy(err), state


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('cli')
    write_cube_obj(tmp)
    return tmp


@pytest.fixture(scope='module')
def jax_result(assets):
    return _run(jmain.main, assets, 'jax')


@pytest.fixture(scope='module')
def jax_ray(assets):
    return _cli(jmain.main, assets, 'jax-ray', ['--mode', 'ray'])


@pytest.mark.parametrize('v1', [False, True], ids=['v2', 'v1'])
def test_cli_matches_jax(assets, jax_result, monkeypatch, v1):
    monkeypatch.setattr(tdispatch, 'PACKET_V1', v1)
    calls = {'v1': 0, 'v2': 0, 'refit': 0}
    for mod, name, key in ((tp1, 'traverse_packet_ref', 'v1'),
                           (tp2, 'traverse_merged_ref', 'v2'),
                           (trefit, 'refit_all', 'refit')):
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    img, energy, state = _run(tmain.main, assets, 'v1' if v1 else 'v2',
                              ['--device', 'cpu'])
    assert calls['refit'] == 1
    assert (calls['v1'] > 0, calls['v2'] > 0) == (v1, not v1), calls
    jimg, jenergy, jstate = jax_result
    assert img.shape == jimg.shape == (24, 32, 3)
    assert img.std() > 5          # the cubes and the checkerboard are in view
    same = (img == jimg).all(axis=2).mean()
    assert same >= 0.99, same
    np.testing.assert_allclose(energy, jenergy, rtol=1e-4)
    assert state == jstate


@pytest.mark.parametrize('v1', [False, True], ids=['v2', 'v1'])
def test_cli_ray_matches_jax(assets, jax_ray, monkeypatch, v1):
    monkeypatch.setattr(tdispatch, 'PACKET_V1', v1)
    calls = count_traversals(monkeypatch)
    refits = []
    monkeypatch.setattr(trefit, 'refit_all', lambda *a, _f=trefit.refit_all,
                        **kw: refits.append(1) or _f(*a, **kw))
    err, img, state = _cli(tmain.main, assets, 'ray-v1' if v1 else 'ray-v2',
                           ['--mode', 'ray', '--device', 'cpu',
                            '--resume', 'ignored.npz', '--checkpoint',
                            str(assets / 'ignored.npz')])
    jerr, jimg, jstate = jax_ray
    for e in (err, jerr):
        assert re.search(r'^rendered 32x24 @ 1 spp in ', e, re.M), e
        assert not re.search(r'^(energy|checkpoint|resumed)', e, re.M), e
    assert not (assets / 'ignored.npz').exists()
    assert len(refits) == 1
    assert (calls['v1'] > 0, calls['v2'] > 0) == (v1, not v1), calls
    assert img.shape == jimg.shape == (24, 32, 3)
    assert img.std() > 5
    same = (img == jimg).all(axis=2).mean()
    assert same >= 0.995, same
    assert state == jstate


@pytest.fixture(scope='module')
def jax_resumed(assets):
    """The JAX CLI writes a checkpoint at 6 spp and resumes it to 7 spp.
    Returns (checkpoint path, stderr, PNG) of the resumed run."""
    ckpt = assets / 'jax6.npz'
    err, _, _ = _cli(jmain.main, assets, 'jax-6',
                     ['--spp', '6', '--checkpoint', str(ckpt)])
    assert re.search(r'^checkpoint -> ', err, re.M), err
    err, img, _ = _cli(jmain.main, assets, 'jax-resumed',
                       ['--resume', str(ckpt)])
    return ckpt, err, img


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_cli_checkpoint_resumes_across_packages(assets, jax_resumed, writer):
    """One package writes a 6 spp checkpoint and the other resumes it to 7
    spp; the result is the JAX CLI's own resumed render. (Not the
    uninterrupted 7 spp render: on resume both CLIs skip the clearing frame,
    so the samples after it trace the scene as built, not as animated to
    ``--time``.)"""
    ckpt, jerr, jimg = jax_resumed
    if writer == 'port':
        ckpt = assets / 'port6.npz'
        err, _, _ = _cli(tmain.main, assets, 'port-6',
                         ['--spp', '6', '--checkpoint', str(ckpt), '--device',
                          'cpu'])
        assert re.search(r'^checkpoint -> ', err, re.M), err
        err, img, _ = _cli(jmain.main, assets, 'port-resumed-by-jax',
                           ['--resume', str(ckpt)])
    else:
        err, img, _ = _cli(tmain.main, assets, 'jax-resumed-by-port',
                           ['--resume', str(ckpt), '--device', 'cpu'])
    for e in (err, jerr):
        assert re.search(r'^resumed at 6 spp from ', e, re.M), e
        assert re.search(r'^rendered 32x24 @ 7 spp in ', e, re.M), e
    same = (img == jimg).all(axis=2).mean()
    assert same >= 0.99, same
    np.testing.assert_allclose(_energy(err), _energy(jerr), rtol=1e-4)
