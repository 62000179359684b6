"""JPEG decoding on the host, for textures and skies (the JAX package reads
them with PIL, which the machine with the card does not have).

:func:`decode_jpeg` calls the C++ decoder of ``scene/native/
jpeg_decoder.cpp``, which reproduces libjpeg's integer pipeline at its
default settings (the accurate integer IDCT, fancy upsampling, the
fixed-point YCbCr -> RGB tables), so its uint8 output is PIL's bit for bit.
Entropy decoding is a serial loop over bits: C++ takes milliseconds on a
sky-sized image where Python would take tens of seconds.

The source compiles at first use (``$CXX``, else ``g++``) into the
git-ignored ``cuda_pathtracer_tpu_torch/_build/``, as the native BVH
builder does (``accel/native.py::compile_library``: a name that hashes the
compiler, the flags and the source, the compiler's output beside it as
``.log``). A missing or failing compiler raises: a sky never falls
back to grey because the decoder could not be built.

Supported: baseline, extended and progressive JPEG, Huffman or arithmetic
coded (with DAC conditioning), and 8-bit lossless JPEG (SOF3, predictors
1-7, point transforms); 8-bit samples; grey (returned as ``[H, W, 1]``,
PIL's mode ``L``), three components (YCbCr, or RGB by its Adobe marker or
component ids) or four (CMYK, or YCCK by its Adobe marker; returned as
``[H, W, 4]`` inverted, as PIL reads them in its mode ``CMYK``); sampling
factors of 1 to 4 per axis in integral ratios; restart intervals; any APPn
and COM markers. A progressive file whose first coefficients are not all
exact is block-smoothed as libjpeg smooths it. What PIL refuses raises
OSError, as in PIL: other precisions (12-bit), hierarchical and
arithmetic lossless frames, heights given by a DNL marker, two or more
than four components, fractional sampling ratios, a file that ends before
its EOI marker.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..accel.native import compile_library

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'native', 'jpeg_decoder.cpp')
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')
CXXFLAGS = ['-O2', '-std=c++17', '-Wall', '-fPIC']
_LIB = None


def _build() -> str:
    """The decoder library's path, compiled unless an up-to-date one
    exists. Raises RuntimeError with the compiler's output on failure."""
    so, _, log = compile_library(_SRC, CXXFLAGS, _BUILD_DIR, 'libjpeg')
    if so is None:
        raise RuntimeError(f'the JPEG decoder did not compile:\n{log[-2000:]}')
    return so


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.cpt_jpeg_decode.restype = ctypes.c_int
        lib.cpt_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(u8p), ip, ip, ip,
            ctypes.c_char_p, ctypes.c_int]
        lib.cpt_jpeg_free.restype = None
        lib.cpt_jpeg_free.argtypes = [u8p]
        _LIB = lib
    return _LIB


def decode_jpeg(data: bytes) -> np.ndarray:
    """The pixels of a JPEG file's bytes: uint8 [H, W, C], top row first,
    C = 1 (grey), 3 (RGB) or 4 (CMYK, inverted), equal to PIL's decode.
    Raises OSError for a file PIL refuses (see the module docstring)."""
    lib = _load()
    px = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.cpt_jpeg_decode(bytes(data), len(data), ctypes.byref(px),
                             ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c), err, len(err))
    if rc:
        raise OSError(f'JPEG: {err.value.decode()}')
    try:
        n = h.value * w.value * c.value
        out = np.ctypeslib.as_array(px, shape=(n,)).copy()
    finally:
        lib.cpt_jpeg_free(px)
    return out.reshape(h.value, w.value, c.value)
