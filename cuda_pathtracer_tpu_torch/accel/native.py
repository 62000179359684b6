"""Bridge to the native C++ binned-SAH BVH builder (accel/native/
bvh_builder.cpp), the port's copy of ``cuda_pathtracer_tpu/accel/native.py``.

The source compiles at first use, with the JAX package's Makefile flags
(``-O3 -march=native -ffast-math -fPIC -std=c++17 -Wall -fopenmp``), into the
git-ignored ``cuda_pathtracer_tpu_torch/_build/`` and never beside its
source. The library name carries a hash of the source and flags. A compiler
without OpenMP (no ``libgomp``) refuses ``-fopenmp``; the source then
compiles once more with the same flags minus ``-fopenmp``, and its
``#pragma omp`` loops run serially: the same tree, built on one thread.
:func:`build_flags` says which flags built the loaded library. When the
compiler is missing or fails both times, :func:`available` is false and
``accel/bvh.py`` builds with numpy: the JAX copy's condition. The
compiler's output is kept beside the library as ``.log`` (both attempts'
in the serial library's). Built with the same flags on the same host, both
packages' libraries give the same tree, so the parity tests compare BVHs
bit for bit; ``-march=native`` makes the tree differ between hosts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'native', 'bvh_builder.cpp')
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')
CXXFLAGS = ['-O3', '-march=native', '-ffast-math', '-fPIC', '-std=c++17',
            '-Wall', '-fopenmp']
_LIB = None
_TRIED = False
_FLAGS = None       # the flags that built the loaded library
_LOG = None         # the .log of the last build attempt


def library_path(src: str, flags, build_dir: str, stem: str) -> str:
    """Where :func:`compile_library` puts ``src`` built with ``flags``:
    ``build_dir/{stem}_<hash>.so``, the hash of the compiler (``$CXX``,
    else ``g++``), the flags and the source."""
    h = hashlib.sha256(' '.join([os.environ.get('CXX', 'g++'), *flags]
                                ).encode())
    with open(src, 'rb') as f:
        h.update(f.read())
    return os.path.join(build_dir, f'{stem}_{h.hexdigest()[:16]}.so')


def compile_library(src: str, flags, build_dir: str, stem: str,
                    prior: str = ''):
    """Compile ``src`` with ``flags`` into the shared library at
    :func:`library_path` unless it exists, with the compiler's output
    (after ``prior``) beside it as ``.log``. Returns (library path or None
    when the compiler is missing or fails, log path, the compiler's
    output)."""
    so = library_path(src, flags, build_dir, stem)
    log_path = so[:-3] + '.log'
    if os.path.exists(so):
        return so, log_path, ''
    os.makedirs(build_dir, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    cmd = [os.environ.get('CXX', 'g++'), *flags, '-shared', '-o', tmp, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        log = ' '.join(cmd) + '\n' + res.stdout + res.stderr
        ok = res.returncode == 0
    except Exception as e:   # no compiler, or it hung
        log, ok = f'{" ".join(cmd)}\n{e!r}\n', False
    with open(log_path, 'w') as f:
        f.write(prior + log)
    if not ok:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None, log_path, log
    os.replace(tmp, so)
    return so, log_path, log


def _flags():
    return os.environ['CXXFLAGS'].split() if os.environ.get('CXXFLAGS') \
        else CXXFLAGS


def build_log() -> str:
    """The compiler's output of the last build (empty before one)."""
    path = _LOG or library_path(_SRC, _flags(), _BUILD_DIR,
                                'libbvh')[:-3] + '.log'
    if not os.path.exists(path):
        return ''
    with open(path) as f:
        return f.read()


def build_flags():
    """The compiler flags of the loaded library (``-fopenmp`` among them
    for the OpenMP build), or None when no library loaded and the numpy
    builder runs."""
    _load()
    return None if _FLAGS is None else list(_FLAGS)


def _compile(flags, prior: str = ''):
    """Compile the library with ``flags`` unless an up-to-date one exists.
    Returns (library path or None, the compiler's output)."""
    global _LOG
    so, _LOG, log = compile_library(_SRC, flags, _BUILD_DIR, 'libbvh', prior)
    return so, log


def _build():
    """(library path, flags) of a library built with the configured flags,
    or without ``-fopenmp`` when the compiler refuses it; (None, None) when
    both fail."""
    flags = _flags()
    so, log = _compile(flags)
    if so is None and '-fopenmp' in flags:
        flags = [f for f in flags if f != '-fopenmp']
        so, _ = _compile(flags, prior=log)
    return (so, flags) if so is not None else (None, None)


def _load():
    global _LIB, _TRIED, _FLAGS
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so, flags = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.build_bvh_binned.restype = ctypes.c_int64
    lib.build_bvh_binned.argtypes = [
        ctypes.c_int64,                   # n triangles
        ctypes.POINTER(ctypes.c_float),   # v0 [n,3]
        ctypes.POINTER(ctypes.c_float),   # v1
        ctypes.POINTER(ctypes.c_float),   # v2
        ctypes.POINTER(ctypes.c_float),   # out vmin [2n-1,3]
        ctypes.POINTER(ctypes.c_float),   # out vmax
        ctypes.POINTER(ctypes.c_int32),   # out left
        ctypes.POINTER(ctypes.c_int32),   # out leaf_start
        ctypes.POINTER(ctypes.c_int32),   # out leaf_count
        ctypes.POINTER(ctypes.c_int32),   # out perm [n]
    ]
    _LIB, _FLAGS = lib, flags
    return lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    from .bvh import BVHNodes
    lib = _load()
    assert lib is not None
    n = len(v0)
    max_nodes = max(2 * n - 1, 1)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    vmin = np.empty((max_nodes, 3), np.float32)
    vmax = np.empty((max_nodes, 3), np.float32)
    left = np.empty(max_nodes, np.int32)
    leaf_start = np.empty(max_nodes, np.int32)
    leaf_count = np.empty(max_nodes, np.int32)
    perm = np.empty(n, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    count = lib.build_bvh_binned(
        n,
        v0.ctypes.data_as(fp), v1.ctypes.data_as(fp), v2.ctypes.data_as(fp),
        vmin.ctypes.data_as(fp), vmax.ctypes.data_as(fp),
        left.ctypes.data_as(ip),
        leaf_start.ctypes.data_as(ip), leaf_count.ctypes.data_as(ip),
        perm.ctypes.data_as(ip))
    c = int(count)
    return BVHNodes(vmin[:c], vmax[:c], left[:c],
                    leaf_start[:c], leaf_count[:c], perm)
