"""The port runs without JAX and without the JAX package: in a fresh
interpreter where ``import jax`` fails, import the port, build the small
room, render 16x8 on the CPU, run the port's CLI on ``outside`` at 16x8 on
the CPU, run the eight probe modules of ``cuda_pathtracer_tpu_torch/tools``
on their plain versions (``lab_v1_probe`` builds its scene and waves with
the port alone), and check that no module of jax or of
``cuda_pathtracer_tpu`` was loaded. A scan of the port's sources and ``chip_smoke.py`` finds no import
of ``cuda_pathtracer_tpu``."""
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

SCRIPT = r'''
import os
import sys
sys.modules['jax'] = None          # any "import jax" now raises ImportError
sys.path[:0] = [REPO, HERE]
import cuda_pathtracer_tpu_torch
from cuda_pathtracer_tpu_torch import bridge
from cuda_pathtracer_tpu_torch.core.camera import Camera
from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
from cuda_pathtracer_tpu_torch.scene import builder, scene
from _torch_room import build_room, CAMERA
pt = Pathtracer(build_room(scene, builder.add_cube), 16, 8, device='cpu')
cam = Camera.create(**CAMERA, device='cpu')
pt.render(cam, should_clear=True)
pt.render(cam)
energy, has_nan, has_neg = pt.energy()
assert energy > 0 and not has_nan and not has_neg, (energy, has_nan, has_neg)
assert pt.image(blur=True).shape == (8, 16, 3)
from cuda_pathtracer_tpu_torch.__main__ import main
rc = main(['--scene', 'outside', '--width', '16', '--height', '8', '--spp',
           '1', '--device', 'cpu', '--out', OUT + '/o.png', '--state',
           OUT + '/s.txt'])
assert rc == 0 and os.path.getsize(OUT + '/o.png') > 0
import contextlib, io
from cuda_pathtracer_tpu_torch.tools import (
    bf16_probe, decision_probe, gather_probe, lab_v1_probe, onehot_probe,
    packet_step_probe, step_probe, visit_probe)
for probe in (gather_probe, bf16_probe, step_probe, onehot_probe,
              packet_step_probe, decision_probe, visit_probe, lab_v1_probe):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert probe.main(['--device', 'cpu']) == 0, probe.__name__
    assert 'ok=True' in text.getvalue(), text.getvalue()
loaded = sorted(m for m in sys.modules
                if (m in ('jax', 'cuda_pathtracer_tpu')
                    or m.startswith(('jax.', 'jaxlib', 'cuda_pathtracer_tpu.')))
                and sys.modules[m] is not None)
assert not loaded, loaded
print('OK', energy)
'''


def test_port_imports_and_renders_without_jax(tmp_path):
    repo = os.path.dirname(HERE)
    code = (f'REPO = {repo!r}\nHERE = {HERE!r}\nOUT = {str(tmp_path)!r}\n'
            + SCRIPT)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], env=env, cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith('OK')


def test_port_sources_import_nothing_of_the_jax_package():
    repo = os.path.dirname(HERE)
    pat = re.compile(r'^\s*(from|import)\s+cuda_pathtracer_tpu([.\s]|$)',
                     re.M)
    files = [os.path.join(repo, 'chip_smoke.py')]
    for root, _, names in os.walk(os.path.join(repo,
                                               'cuda_pathtracer_tpu_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    assert len(files) > 30
    bad = []
    for f in files:
        with open(f) as fh:
            bad += [f'{f}: {m.group(0).strip()}' for m in pat.finditer(fh.read())]
    assert not bad, bad
