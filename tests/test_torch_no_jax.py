"""The port runs without JAX: in a fresh interpreter where ``import jax``
fails, import the port, build the small room, render 16x8 on the CPU, and
check that no jax module was loaded."""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

SCRIPT = r'''
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
cam = Camera.create(**CAMERA)
pt.render(cam, should_clear=True)
pt.render(cam)
energy, has_nan, has_neg = pt.energy()
assert energy > 0 and not has_nan and not has_neg, (energy, has_nan, has_neg)
assert pt.image(blur=True).shape == (8, 16, 3)
loaded = sorted(m for m in sys.modules
                if (m == 'jax' or m.startswith(('jax.', 'jaxlib')))
                and sys.modules[m] is not None)
assert not loaded, loaded
print('OK', energy)
'''


def test_port_imports_and_renders_without_jax():
    repo = os.path.dirname(HERE)
    code = f'REPO = {repo!r}\nHERE = {HERE!r}\n' + SCRIPT
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], env=env, cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith('OK')
