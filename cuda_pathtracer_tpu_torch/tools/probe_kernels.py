"""The probe kernels' own library, ``tools/csrc/``: built apart from the
renderer's by ``ops/kernels.build`` (same flags and ``_build/``) into
``libcpt_probes_<hash>.so`` at a probe's first launch, with its own error
string and launch counts. Its key covers the renderer's
``csrc/traverse_common.cuh``, which ``probe_packet.cuh`` includes.
"""
from __future__ import annotations

import ctypes
import os

from ..ops import kernels

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
STEM = 'cpt_probes'
# headers of the renderer's csrc/ that the probe sources include
SHARED = ('traverse_common.cuh',)

NAMES = ('probe_gather', 'probe_slab', 'probe_step', 'probe_onehot',
         'probe_packet_step', 'probe_decision', 'probe_visit',
         'probe_packet_walk')
LAUNCHES = dict.fromkeys(NAMES, 0)
PLAIN_ON_CUDA = dict.fromkeys(NAMES, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (restype, argtypes). The launchers return the
# cudaError_t of cudaGetLastError() after their launch.
_SIGNATURES = {
    'cpt_probe_gather': (_I, [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    'cpt_probe_slab': (_I, [_I, _P, _P, _I, _I, _P]),
    'cpt_probe_step': (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    'cpt_probe_onehot': (_I, [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # (site, variant, steps, input pointers, output pointers, table rows,
    # rows of a second table or programs, stream)
    'cpt_probe_packet_step': (_I, [_I, _I, _I, _P, _P, _I, _I, _P]),
    'cpt_probe_decision': (_I, [_I, _I, _I, _P, _P, _I, _I, _P]),
    'cpt_probe_visit': (_I, [_I, _I, _I, _P, _P, _I, _I, _P]),
    # (variant, input pointers, output pointers, inner rows, leaf rows,
    # programs, stack capacity, stream)
    'cpt_probe_packet_walk': (_I, [_I, _P, _P, _I, _I, _I, _I, _P]),
    'cpt_probe_error_string': (ctypes.c_char_p, [_I]),
}

_lib = None


def reset_counts():
    for n in NAMES:
        LAUNCHES[n] = 0
        PLAIN_ON_CUDA[n] = 0


def note_plain(name: str, tensor):
    if tensor.is_cuda:
        PLAIN_ON_CUDA[name] += 1


def _shared(render_dir: str):
    return [os.path.join(render_dir, h) for h in SHARED]


def library_path(src_dir: str = CSRC, render_dir: str = kernels.CSRC,
                 build_dir: str = kernels.BUILD_DIR) -> str:
    return kernels.library_path(src_dir, build_dir, STEM, _shared(render_dir))


def build(build_dir: str = kernels.BUILD_DIR) -> str:
    """Compile the probe library unless an up-to-date one exists; returns its
    path (the ``.log`` beside it holds the ptxas report)."""
    return kernels.build(CSRC, build_dir, STEM, _shared(kernels.CSRC))


def library():
    """The loaded probe library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = kernels.load(build(), _SIGNATURES)
    return _lib


def launched(err: int, name: str):
    """Count a launch of probe ``name`` and raise on the nonzero
    cudaError_t it returned."""
    LAUNCHES[name] += 1
    if err != 0:
        msg = library().cpt_probe_error_string(err).decode()
        raise RuntimeError(f'{name} kernel launch failed: {msg} ({err})')
