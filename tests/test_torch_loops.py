"""The real-time loops of the port's CLI against the JAX CLI's, on the CPU:
the animated ``outside`` scene at 32x24 (``cube.obj`` written by the test),
in path mode and in ray mode.

``_serve_loop`` is called directly in both packages with ``--serve 0`` (an
ephemeral port) and ``--frames 3``; the viewer's input is scripted, the same
in both, by patching ``HttpDisplay.poll_keys`` and ``poll_clicks``: frame 1
holds ``w`` and clicks the middle of the image (click-to-focus), frame 2
holds ``right`` and presses ``b`` (blur off), frame 3 holds ``s``. Every
presented frame (99% of the pixels identical) and the saved camera state
must agree. ``_interactive_loop`` reads ``w``, ``focus 16 12`` and ``quit``
from a scripted ``input()``; its terminal previews (99% of their
characters) and saved state must agree. No timing of real HTTP requests
decides anything here.
"""
import contextlib
import io

import numpy as np
import pytest

from _torch_room import write_cube_obj
from cuda_pathtracer_tpu import __main__ as jmain
from cuda_pathtracer_tpu.models.pathtracer import Pathtracer as JPathtracer
from cuda_pathtracer_tpu.models.raytracer import Raytracer as JRaytracer
from cuda_pathtracer_tpu.scene import state as jstate
from cuda_pathtracer_tpu.scene.builder import get_outside_scene as j_outside
from cuda_pathtracer_tpu.utils import display as jdisplay
from cuda_pathtracer_tpu_torch import __main__ as tmain
from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer as TPathtracer
from cuda_pathtracer_tpu_torch.models.raytracer import Raytracer as TRaytracer
from cuda_pathtracer_tpu_torch.scene import state as tstate
from cuda_pathtracer_tpu_torch.scene.builder import get_outside_scene as t_outside
from cuda_pathtracer_tpu_torch.utils import display as tdisplay

W, H = 32, 24
STATE = '0|4|-17\n0|-0.2|1\n1.5\n12\n0.02\n'
KEYS = [{'w'}, {'right', 'b'}, {'s'}]
CLICKS = [[(0.5, 0.5)], [], []]
LINES = ['w', 'focus 16 12', 'quit']
MODES = pytest.mark.parametrize('mode', ['path', 'ray'])


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    return write_cube_obj(tmp_path_factory.mktemp('loops'))


def _setup(pkg, mode, assets, tmp_path, argv):
    """(app, scene, camera, args) as each CLI's main builds them."""
    state = tmp_path / f'{pkg}-{mode}.txt'
    state.write_text(STATE)
    if pkg == 'jax':
        main, scene = jmain, j_outside(asset_dirs=[assets])
        camera = jstate.read_state(str(state))
        app = (JRaytracer if mode == 'ray' else JPathtracer)(scene, W, H)
    else:
        main, scene = tmain, t_outside(asset_dirs=[assets])
        camera = tstate.read_state(str(state), device='cpu')
        cls = TRaytracer if mode == 'ray' else TPathtracer
        app = cls(scene, W, H, device='cpu')
    args = main.build_argparser().parse_args(
        ['--mode', mode, '--time', '2', '--state', str(state), *argv])
    return main, app, scene, camera, args


def _serve(pkg, mode, assets, tmp_path, monkeypatch):
    main, app, scene, camera, args = _setup(
        pkg, mode, assets, tmp_path, ['--serve', '0', '--frames', '3'])
    cls = (jdisplay if pkg == 'jax' else tdisplay).HttpDisplay
    keys, clicks, frames = iter(KEYS), iter(CLICKS), []
    monkeypatch.setattr(cls, 'poll_keys', lambda self: set(next(keys)))
    monkeypatch.setattr(cls, 'poll_clicks', lambda self: list(next(clicks)))
    present = cls.present
    monkeypatch.setattr(cls, 'present', lambda self, f: (
        frames.append(np.array(f)), present(self, f)))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        main._serve_loop(app, scene, camera, args)
    return frames, open(args.state).read(), err.getvalue()


@MODES
def test_serve_loop_matches_jax(assets, tmp_path, monkeypatch, mode):
    jframes, jstate_txt, jerr = _serve('jax', mode, assets, tmp_path,
                                       monkeypatch)
    tframes, tstate_txt, terr = _serve('port', mode, assets, tmp_path,
                                       monkeypatch)
    assert tstate_txt == jstate_txt
    assert tstate_txt != STATE                       # the camera moved
    # the click focused on the middle of the image
    assert 'focal length: ' in terr and 'focal length: ' in jerr
    assert terr.count('live viewer: http://localhost:') == 1
    assert len(tframes) == len(jframes) == 3
    for i, (t, j) in enumerate(zip(tframes, jframes)):
        assert t.dtype == np.uint8 and t.shape == j.shape == (H, W, 3)
        same = (t == j).all(axis=2).mean()
        print(f'frame {i}: {same:.4f} of pixels identical')
        assert same >= 0.99
    assert tframes[0].std() > 5


def _interactive(pkg, mode, assets, tmp_path, monkeypatch):
    main, app, scene, camera, args = _setup(pkg, mode, assets, tmp_path,
                                            ['--interactive'])
    lines = iter(LINES)
    monkeypatch.setattr('builtins.input', lambda *a: next(lines))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main._interactive_loop(app, scene, camera, args)
    return out.getvalue(), open(args.state).read()


@MODES
def test_interactive_loop_matches_jax(assets, tmp_path, monkeypatch, mode):
    jout, jstate_txt = _interactive('jax', mode, assets, tmp_path,
                                    monkeypatch)
    tout, tstate_txt = _interactive('port', mode, assets, tmp_path,
                                    monkeypatch)
    assert tstate_txt == jstate_txt
    eye, _, _, focal, _ = tstate_txt.splitlines()
    assert eye != STATE.splitlines()[0] and focal != '12'
    # three previews, each closed by its prompt; t starts at 0 whatever
    # --time says
    assert tout.count('] > ') == 3 and '[t=0.0 ' in tout
    tl, jl = tout.splitlines(), jout.splitlines()
    assert [len(x) for x in tl] == [len(x) for x in jl]
    same = np.mean([a == b for x, y in zip(tl, jl) for a, b in zip(x, y)])
    print(f'{same:.4f} of the preview characters equal')
    assert same >= 0.99
