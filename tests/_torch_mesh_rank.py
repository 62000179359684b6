"""One rank of a sharded render of the small room, for
``tests/test_torch_mesh.py`` (and only torch and the port: no JAX).

    python tests/_torch_mesh_rank.py SPEC.json RANK

``SPEC.json`` holds ``world``, ``store`` (the file store the ranks meet
at), ``out`` (a directory), ``width``, ``height``, ``frames`` (a list of
booleans: should_clear per frame) and optionally ``max_lanes`` and ``spp``
(``Pathtracer.MAX_LANES_PER_DISPATCH`` and ``SPP_PER_DISPATCH``). Rank 0
writes ``out/rank0.npz``: the geometry, ``rand_idx`` and ``sample_idx``
after every frame, the gathered lane-order ``lum``/``alb`` and the
radiance cache after every frame, and at the end the radiance state, the
pixel-order accumulators, the image and the energy. Every rank writes ``out/rank{r}.json`` with the
bands it rendered.

:func:`launch` starts every rank of a spec as a process; :func:`join`
waits for them with a timeout, kills them on expiry and fails unless all
exited 0.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def launch(spec: dict, tmp) -> list:
    """Write ``spec`` (world, out, ...) under ``tmp`` with a file store
    there, and start its ranks, each writing its output to
    ``out/rank{r}.log``. Returns the processes."""
    os.makedirs(spec['out'], exist_ok=True)
    spec = dict(spec, store=os.path.join(str(tmp), 'store'))
    path = os.path.join(str(tmp), 'spec.json')
    with open(path, 'w') as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS='1')
    return [start([sys.executable, __file__, path, str(r)], env,
                  os.path.join(spec['out'], f'rank{r}.log'))
            for r in range(spec['world'])]


def start(args: list, env: dict, log: str, stdin: str | None = '', cwd=None):
    """Start ``args`` with its output to the file ``log`` and ``stdin`` as
    its whole input (None: an input that stays open and empty until the
    process ends)."""
    with open(log, 'w') as out:
        p = subprocess.Popen(args, env=env, cwd=cwd, text=True,
                             stdin=subprocess.PIPE, stdout=out,
                             stderr=subprocess.STDOUT)
    p.log = log
    if stdin is not None:
        p.stdin.write(stdin)
        p.stdin.close()
    return p


def join(procs: list, timeout: float = 150.0) -> str:
    """Wait for every process; kill all of them when ``timeout`` seconds
    pass. Raises unless all exited 0. Returns their output."""
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
    text = ''
    for p in procs:
        with open(p.log) as f:
            text += f.read() + '\n'
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f'rank exit codes {codes} (killed after '
                             f'{timeout} s: -9):\n{text[-3000:]}')
    return text


def main(path: str, rank: int) -> int:
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from _torch_room import build_room, CAMERA
    from cuda_pathtracer_tpu_torch.core.camera import Camera
    from cuda_pathtracer_tpu_torch.models.pathtracer import Pathtracer
    from cuda_pathtracer_tpu_torch.parallel import mesh
    from cuda_pathtracer_tpu_torch.scene import builder, scene

    with open(path) as f:
        spec = json.load(f)
    if 'max_lanes' in spec:
        Pathtracer.MAX_LANES_PER_DISPATCH = spec['max_lanes']
    if 'spp' in spec:
        Pathtracer.SPP_PER_DISPATCH = spec['spp']
    group = mesh.init_group('cpu', rank, spec['world'], spec['store'])
    try:
        pt = mesh.ShardedPathtracer(build_room(scene, builder.add_cube),
                                    spec['width'], spec['height'],
                                    group=group)
        cam = Camera.create(**CAMERA, device='cpu')
        res = dict(height=pt.height, bands=pt.bands, band_h=pt.band_h,
                   tile_order=pt.tile_order, ridx=[], sidx=[])
        for i, clear in enumerate(spec['frames']):
            pt.render(cam, should_clear=clear)
            res['ridx'].append(pt.rand_idx)
            res['sidx'].append(pt.sample_idx)
            lum, alb = pt.gather_lanes()
            res[f'lum{i}'], res[f'alb{i}'] = lum.numpy(), alb.numpy()
            res[f'cache{i}'] = pt.radiance.cache.numpy()
        lum, alb = pt.accumulators_pixel_order()
        image = pt.image()
        energy = pt.energy()
        with open(os.path.join(spec['out'], f'rank{rank}.json'), 'w') as f:
            json.dump({'bands': list(pt._owned_bands()),
                       'lanes': int(pt.lum.shape[0])}, f)
        if rank == 0:
            res.update(cache=pt.radiance.cache.numpy(),
                       total=pt.radiance.total.numpy(), lum=lum.numpy(),
                       alb=alb.numpy(), image=image.numpy(),
                       energy=np.array(energy[0]),
                       flags=np.array(energy[1:]),
                       rays=np.array(float(pt.rays_traced)))
            np.savez(os.path.join(spec['out'], 'rank0.npz'), **res)
    finally:
        mesh.close_group()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
