"""Build, load and count the renderer's hand-written CUDA kernels under
``csrc/``.

The ``csrc/*.cu`` files (and the ``.cuh`` headers they include) compile,
one ``nvcc`` process per file in parallel, and link into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The build runs at first use, goes to
``cuda_pathtracer_tpu_torch/_build/`` (git-ignored) and is keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused. A failed build raises; nothing falls back to the plain versions.
:func:`build` and :func:`load` serve any such source directory: the
measurement kernels of ``tools/csrc/`` build into their own library through
them, so the renderer's library holds only what it launches.

Flags: ``-fmad=false`` forbids multiply-add contraction so the kernels round
like the plain PyTorch versions (the traversal's ``t`` is compared bit for
bit), and there is no ``--use_fast_math`` (IEEE division and square root,
no flush of denormals: the traversal table carries int32 words bitcast into
f32, most of them denormal).

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel, and
each plain version adds one to ``PLAIN_ON_CUDA[name]`` when it runs on a CUDA
tensor, so a run can show which implementation the main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from ..utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
              '-Xcompiler', '-fPIC', '-fmad=false', '-Xptxas', '-v']

NAMES = ('traverse', 'guiding_scatter', 'blur', 'traverse_packet',
         'whitted_shade', 'prepass', 'whitted_lanes')
# which sort each ordered Whitted compaction took (ops/whitted_lanes.py)
SORT_PATHS = ('whitted_sort_block', 'whitted_sort_library')
LAUNCHES = dict.fromkeys(NAMES + SORT_PATHS, 0)
PLAIN_ON_CUDA = dict.fromkeys(NAMES, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> (restype, argtypes). The launchers return the
# cudaError_t of cudaGetLastError() after their launch.
_SIGNATURES = {
    # (table, ray and prepass pointers, rays, want_uv, outputs, the merge
    # epilogue's inputs and prim_type output or nulls, stream)
    'cpt_traverse': (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P]),
    # (ro, rd, t_max, active, stop_on_hit (each may be null), any_hit,
    # spheres and their count, planes and their count, rays, outputs...,
    # stream)
    'cpt_prepass': (_I, [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I]
                    + [_P] * 7),
    'cpt_guiding_scatter': (_I, [_P, _P, _P, _I, _I, _P, _P]),
    'cpt_blur': (_I, [_P, _P, _F, _P, _I, _I, _P, _P]),
    'cpt_traverse_packet': (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _P, _P, _P, _P]),
    # (scene table pointers, their lengths, the level's ray and hit
    # pointers, lanes, outputs..., stream)
    'cpt_whitted_shade_pre': (_I, [_P, _P, _P, _I, _P, _P, _P, _P, _P]),
    'cpt_whitted_shade_post': (_I, [_P, _P, _P, _I] + [_P] * 11),
    # (eye, view_dir, d, width, height, width / height, 2 width / height,
    # max_depth, outputs..., stream)
    'cpt_whitted_primary_rays': (_I, [_P, _P, _P, _I, _I, _F, _F, _I]
                                 + [_P] * 7),
    'cpt_whitted_lanes_tiles': (_I, [_I]),
    # (active, lanes, tile counts, stream)
    'cpt_whitted_lanes_count': (_I, [_P, _I, _P, _P]),
    # (active, lanes, tile counts, ro, rd, w, pixel, their packed rows or
    # nulls, keys or null, count, stream)
    'cpt_whitted_lanes_scatter': (_I, [_P, _I] + [_P] * 11),
    'cpt_whitted_lanes_read_count': (_I, [_P, _P, _P]),
    'cpt_whitted_sort_capacity': (_I, []),
    # (keys, n, kept, rows a block gathers, ro, rd, w, pixel, outputs...,
    # stream)
    'cpt_whitted_sort_gather': (_I, [_P, _I, _I, _I] + [_P] * 9),
    # (sorted keys, kept, ro, rd, w, pixel, outputs..., stream)
    'cpt_whitted_gather': (_I, [_P, _I] + [_P] * 9),
    'cpt_traverse_max_stack': (_I, []),
    'cpt_traverse_packet_max_stack': (_I, []),
    'cpt_error_string': (ctypes.c_char_p, [_I]),
}

_lib = None


def reset_counts():
    for counts in (LAUNCHES, PLAIN_ON_CUDA):
        for n in counts:
            counts[n] = 0


def note_plain(name: str, tensor):
    if tensor.is_cuda:
        PLAIN_ON_CUDA[name] += 1


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def sources(src_dir: str = CSRC, headers=()) -> list:
    """The files a library's key hashes: the ``.cu`` and ``.cuh`` files of
    ``src_dir`` and the ``headers`` from elsewhere that they include."""
    return sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                  if f.endswith(('.cu', '.cuh'))) + list(headers)


def library_path(src_dir: str = CSRC, build_dir: str = BUILD_DIR,
                 stem: str = 'cpt_kernels', headers=()) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources(src_dir, headers):
        with open(src, 'rb') as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(build_dir, f'lib{stem}_{h.hexdigest()[:16]}.so')


def build(src_dir: str = CSRC, build_dir: str = BUILD_DIR,
          stem: str = 'cpt_kernels', headers=()) -> str:
    """Compile the library of ``src_dir``'s ``.cu`` files unless an
    up-to-date one exists; returns its path. One ``nvcc -c`` per source, all
    started together, then one link. The commands and the ptxas report
    (registers, spills) are kept beside the library as ``.log``."""
    so = library_path(src_dir, build_dir, stem, headers)
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    part = f'{so[:-3]}.{os.getpid()}'
    nvcc = _nvcc()
    jobs = []
    for cu in (s for s in sources(src_dir) if s.endswith('.cu')):
        obj = f'{part}.{os.path.basename(cu)}.o'
        cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', obj, cu]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(' '.join(cmd) + '\n' + out + err)
        if proc.returncode != 0:
            failed.append(f'{os.path.basename(cmd[-1])} ({proc.returncode}):\n{err}')
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], '-shared', '-o', f'{part}.tmp',
               *(o for _, o, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(' '.join(cmd) + '\n' + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f'link ({res.returncode}):\n{res.stderr}')
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(so[:-3] + '.log', 'w') as f:
        f.write('\n'.join(log))
    if failed:
        raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
    os.replace(f'{part}.tmp', so)
    return so


def load(so: str, signatures: dict = _SIGNATURES):
    """A built library, loaded with its C entry points typed (name ->
    (restype, argtypes); by default the render library's)."""
    lib = ctypes.CDLL(so)
    for name, (res, args) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def library():
    """The loaded kernel library (built on first use; span
    ``kernels.build``: the ``nvcc`` build or the library load)."""
    global _lib
    if _lib is None:
        with span('kernels.build', setup=True):
            _lib = load(build())
    return _lib


def check(err: int, name: str):
    """Raise on a nonzero cudaError_t returned after a launch."""
    if err != 0:
        msg = library().cpt_error_string(err).decode()
        raise RuntimeError(f'{name} kernel launch failed: {msg} ({err})')


def check_group_count(name: str, n_rays: int):
    """The traversal kernels give each ray a group of 16 threads, and index
    threads with 32-bit ints: ``16 * n_rays`` must fit."""
    if n_rays > (2 ** 31 - 1) // 16:
        raise ValueError(f'{name}: {n_rays} rays exceed the kernel\'s '
                         f'{(2 ** 31 - 1) // 16} (16 threads per ray)')


def stream_of(tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda(name: str, *tensors, dtypes=None):
    """The wrapper contract: every tensor on one CUDA device and contiguous
    (and of the given dtypes, when given)."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or not t.is_cuda:
            raise ValueError(f'{name}: argument {i} is on {t.device}, '
                             f'expected {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: argument {i} is not contiguous')
        if dtypes is not None and t.dtype != dtypes[i]:
            raise TypeError(f'{name}: argument {i} is {t.dtype}, '
                            f'expected {dtypes[i]}')
