"""The port runs without JAX and without the JAX package: in a fresh
interpreter where ``import jax`` fails, import the port, load its native BVH
builder compiled without OpenMP (the compiler on ``CXX`` refuses
``-fopenmp``, as one with no libgomp does), build the small room, render
16x8 on the CPU (path tracer and Whitted raytracer), build ``minecraft``,
run the port's CLI on ``outside`` at 16x8 on the CPU (path mode with a
checkpoint, a resume of it, and ray mode) and on a ``.chai`` script, decode
a JPEG with the port's decoder (compiled by that compiler) and one image
fixture of each other format to PIL's digests with the image decoder,
build the room with a palette-PNG sky, run ``--shard``
at one rank with a JPEG sky through the entry point that the CLI's
spawned ranks run, run
the eight probe modules of
``cuda_pathtracer_tpu_torch/tools`` on their plain versions
(``lab_v1_probe`` builds its scene and waves with the port alone), and check
that no module of jax, of ``cuda_pathtracer_tpu`` or of PIL was loaded. A
scan of the port's sources and ``chip_smoke.py`` finds no import of
``cuda_pathtracer_tpu`` and none of PIL (the machine with the card has no
PIL)."""
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

SCRIPT = r'''
import os
import sys
sys.modules['jax'] = None          # any "import jax" now raises ImportError
sys.modules['PIL'] = None          # and so does "import PIL"
sys.path[:0] = [REPO, HERE]
import cuda_pathtracer_tpu_torch
from cuda_pathtracer_tpu_torch import bridge
from cuda_pathtracer_tpu_torch.accel import native
native._BUILD_DIR = OUT + '/build'
assert native.available(), native.build_log()
assert '-fopenmp' not in native.build_flags(), native.build_flags()
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
from cuda_pathtracer_tpu_torch.models.raytracer import Raytracer
rt = Raytracer(build_room(scene, builder.add_cube), 16, 8, device='cpu')
rt.render(cam)
frame = rt.frame
assert frame.shape == (128, 3) and bool((frame >= 0).all()) and float(frame.sum()) > 0
mc = builder.get_scene('minecraft', asset_dirs=[OUT])
assert len(mc._v0) == 70328 and mc.dynamic_arrays('cpu').depth > 0
from cuda_pathtracer_tpu_torch.__main__ import main
from _torch_room import write_cube_obj
write_cube_obj(OUT)
with open(OUT + '/s.chai', 'w') as f:
    f.write('def lit(c) { var m = DiffuseMaterial(make_float3(c))\n'
            '  m.emission = make_float3(4.0)\n  return m }\n'
            'var s = scene_add_material(DiffuseMaterial(make_float3(0.5)))\n'
            'var l = scene_add_material(lit(1.0))\n'
            'for (var i = 0; i < 2; ++i) {\n'
            '  var o = GameObject(scene_add_model("cube.obj", 1.0,\n'
            '    make_float3(0, 0, 0), make_float3(0, 0, 0), s + i * l, false))\n'
            '  o.position.x = 3 * i\n  scene_add_object(o)\n}\n'
            'scene_add_plane(Plane(make_float3(0, -1, 0), -3.0, s))\n')
rc = main(['--scene', OUT + '/s.chai', '--width', '16', '--height', '8',
           '--spp', '2', '--blur', '--device', 'cpu', '--asset-dir', OUT,
           '--out', OUT + '/chai.png', '--state', OUT + '/chai.txt'])
assert rc == 0 and os.path.getsize(OUT + '/chai.png') > 0
common = ['--scene', 'outside', '--width', '16', '--height', '8', '--device',
          'cpu', '--out', OUT + '/o.png', '--state', OUT + '/s.txt']
rc = main(common + ['--spp', '1', '--checkpoint', OUT + '/c.npz'])
assert rc == 0 and os.path.getsize(OUT + '/o.png') > 0
rc = main(common + ['--spp', '7', '--resume', OUT + '/c.npz'])
assert rc == 0
rc = main(common + ['--mode', 'ray', '--out', OUT + '/r.png'])
assert rc == 0 and os.path.getsize(OUT + '/r.png') > 0
from cuda_pathtracer_tpu_torch.scene import jpeg
jpeg._BUILD_DIR = OUT + '/build'
import shutil
shutil.copy(os.path.join(HERE, 'data', 'jpeg', 'sky_256x128.jpg'),
            OUT + '/skydome.jpg')
assert jpeg.decode_jpeg(open(OUT + '/skydome.jpg', 'rb').read()).shape == \
    (128, 256, 3)
assert jpeg.decode_jpeg(open(os.path.join(HERE, 'data', 'jpeg',
                                       'arith_sky_128x64.jpg'), 'rb').read()
                       ).shape == (64, 128, 3)
# one image fixture of each format to PIL's digests, and a palette-PNG sky
import hashlib, json
from cuda_pathtracer_tpu_torch.scene import images
images._BUILD_DIR = OUT + '/build'
IMAGES = os.path.join(HERE, 'data', 'images')
with open(os.path.join(IMAGES, 'digests.json')) as f:
    digests = json.load(f)['files']
for fmt in ('png', 'tga', 'bmp', 'gif', 'pnm', 'psd'):
    name = sorted(n for n in digests if n.startswith(fmt + '_'))[0]
    with open(os.path.join(IMAGES, name), 'rb') as f:
        px, mode = images.decode_image(f.read(), name)
    d = digests[name]
    assert (mode, list(px.shape), hashlib.sha256(px.tobytes()).hexdigest()) \
        == (d['mode'], d['shape'], d['sha256']), name
os.makedirs(OUT + '/palsky')
shutil.copy(os.path.join(IMAGES, 'png_palette8_trns.png'),
            OUT + '/palsky/sky.png')
room = build_room(scene, builder.add_cube)
room.asset_dirs = [OUT + '/palsky']
sky = room.to_device('cpu', skydome='sky.png').sky_img
assert sky.shape == (19, 23, 3) and not bool((sky == 0.5).all())
# --shard on the CPU: one rank, through the entry point a spawned rank runs
from cuda_pathtracer_tpu_torch import __main__ as cli
shard = common + ['--shard', '--spp', '2', '--asset-dir', OUT, '--out',
                  OUT + '/sh.png']
try:
    cli._rank_process(shard, 0, 1, OUT + '/store')
except SystemExit as e:
    assert e.code == 0, e.code
assert os.path.getsize(OUT + '/sh.png') > 0
import torch.distributed
assert not torch.distributed.is_initialized()
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
                if (m in ('jax', 'cuda_pathtracer_tpu', 'PIL')
                    or m.startswith(('jax.', 'jaxlib', 'cuda_pathtracer_tpu.',
                                     'PIL.')))
                and sys.modules[m] is not None)
assert not loaded, loaded
print('OK', energy)
'''


def test_port_imports_and_renders_without_jax(tmp_path):
    repo = os.path.dirname(HERE)
    code = (f'REPO = {repo!r}\nHERE = {HERE!r}\nOUT = {str(tmp_path)!r}\n'
            + SCRIPT)
    cxx = tmp_path / 'g++'
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do\n  if [ "$a" = -fopenmp ]; '
                   'then exit 1; fi\ndone\nexec g++ "$@"\n')
    cxx.chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if k not in ('PYTHONPATH', 'CXXFLAGS')}
    env['CXX'] = str(cxx)
    res = subprocess.run([sys.executable, '-c', code], env=env, cwd=HERE,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith('OK')


def test_port_sources_import_nothing_of_the_jax_package():
    repo = os.path.dirname(HERE)
    pat = re.compile(r'^\s*(from|import)\s+(cuda_pathtracer_tpu|PIL)([.\s]|$)',
                     re.M)
    files = [os.path.join(repo, 'chip_smoke.py')]
    for root, _, names in os.walk(os.path.join(repo,
                                               'cuda_pathtracer_tpu_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    assert len(files) > 30
    assert {'raytracer.py', 'display.py', 'checkpoint.py', 'focus.py',
            'keyboard.py', 'profiling.py', 'chai.py', 'mesh.py',
            'jpeg.py', 'images.py'} <= {os.path.basename(f)
                                                for f in files}
    bad = []
    for f in files:
        with open(f) as fh:
            bad += [f'{f}: {m.group(0).strip()}' for m in pat.finditer(fh.read())]
    assert not bad, bad
