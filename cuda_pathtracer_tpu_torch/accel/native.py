"""Bridge to the native C++ binned-SAH BVH builder (accel/native/
bvh_builder.cpp), the port's copy of ``cuda_pathtracer_tpu/accel/native.py``.

The source compiles at first use, with the JAX package's Makefile flags
(``-O3 -march=native -ffast-math -fPIC -std=c++17 -Wall -fopenmp``), into the
git-ignored ``cuda_pathtracer_tpu_torch/_build/`` and never beside its
source. The library name carries a hash of the source and flags. When the
compiler is missing or fails, :func:`available` is false and
``accel/bvh.py`` builds with numpy: the JAX copy's condition. The compiler's
output is kept beside the library as ``.log``. Built with the
same flags on the same host, both packages' libraries give the same tree, so
the parity tests compare BVHs bit for bit; ``-march=native`` makes the tree
differ between hosts.
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


def _library_path():
    """(compiler, flags, library path): the name hashes all three inputs."""
    cxx = os.environ.get('CXX', 'g++')
    flags = os.environ['CXXFLAGS'].split() if os.environ.get('CXXFLAGS') \
        else CXXFLAGS
    h = hashlib.sha256(' '.join([cxx, *flags]).encode())
    with open(_SRC, 'rb') as f:
        h.update(f.read())
    return cxx, flags, os.path.join(_BUILD_DIR,
                                    f'libbvh_{h.hexdigest()[:16]}.so')


def build_log() -> str:
    """The compiler's output of the last build (empty before one)."""
    path = _library_path()[2][:-3] + '.log'
    if not os.path.exists(path):
        return ''
    with open(path) as f:
        return f.read()


def _build() -> str | None:
    """Compile the library unless an up-to-date one exists; None on failure."""
    cxx, flags, so = _library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    cmd = [cxx, *flags, '-shared', '-o', tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        log = ' '.join(cmd) + '\n' + res.stdout + res.stderr
        if res.returncode == 0:
            os.replace(tmp, so)
    except Exception as e:   # no compiler, or it hung
        res, log = None, f'{" ".join(cmd)}\n{e!r}\n'
    with open(so[:-3] + '.log', 'w') as f:
        f.write(log)
    if res is None or res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return so


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
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
    _LIB = lib
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
