"""Image decoding on the host, for skies, blue noise and textures: the
formats the JAX package's ``load_image`` reads with PIL that are texture
formats of the reference (its ``stb_image``), read without an imaging
package (the machine with the card has none).

:func:`decode_image` identifies a file by its content, as PIL does: PNG,
JPEG, BMP, GIF, PNM and PSD by their signatures, TGA (which has none) by a
valid header when the file's name ends in ``.tga``. It returns the pixels
that the JAX ``load_image`` makes of the file, as uint8 [H, W, C], with
PIL's mode. The decoders return the pixels of PIL's mode (``"1"``, ``"L"``,
``"LA"``, ``"P"`` through its palette, ``"RGB"``, ``"RGBA"``, ``"CMYK"`` as
PIL reads it, and the 16 and 32-bit greys ``"I;16"`` and ``"I"`` as their
8-bit saturation), and :data:`KEPT` with :func:`as_loaded` is the mode
table of the JAX ``load_image``: ``RGB``, ``RGBA`` and ``L`` are kept,
every other mode goes through PIL's ``convert('RGB')``.

Decoding runs in C++ (``scene/native/image_decoder.cpp``: PNG scanlines
after the standard library's ``zlib`` has inflated them, TGA, BMP, GIF and
PSD's PackBits rows; JPEG through ``scene/jpeg.py``), compiled at first use
(``$CXX``, else ``g++``) into the git-ignored
``cuda_pathtracer_tpu_torch/_build/``, as the JPEG decoder is. A missing or
failing compiler raises. PNM and PSD headers are parsed with numpy.

What raises, so that the skydome search (which skips a file on
FileNotFoundError and ValueError, as in the JAX package) substitutes
nothing for a file the JAX package would read or raise on:
FileNotFoundError only for a missing file (``open`` raises it); OSError
for a malformed file or one no decoder recognises; ValueError where PIL
raises ValueError (a truncated IHDR, sRGB or pHYs chunk, a BMP RLE stream
that ends before the image, TGA image types whose colour map PIL refuses,
PNM header errors, a truncated one-channel raw PSD); NotImplementedError,
naming the format, for formats PIL reads that are not texture formats of
the reference (TIFF, WebP and the others of :data:`PIL_ONLY`) and for PSD
composites in Lab colour, which PIL converts through LittleCMS.
"""
from __future__ import annotations

import ctypes
import os
import re
import struct
import zlib

import numpy as np

from ..accel.native import compile_library
from .jpeg import decode_jpeg

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'native', 'image_decoder.cpp')
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')
CXXFLAGS = ['-O2', '-std=c++17', '-Wall', '-fPIC']
_LIB = None

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PIL's mode of each PNG (bit depth, colour type)
PNG_MODES = {(1, 0): '1', (2, 0): 'L', (4, 0): 'L', (8, 0): 'L',
             (16, 0): 'I;16', (8, 2): 'RGB', (16, 2): 'RGB', (1, 3): 'P',
             (2, 3): 'P', (4, 3): 'P', (8, 3): 'P', (8, 4): 'LA',
             (16, 4): 'RGBA', (8, 6): 'RGBA', (16, 6): 'RGBA'}
CHANNELS = {'1': 1, 'L': 1, 'I;16': 1, 'I': 1, 'LA': 2, 'P': 3, 'RGB': 3,
            'RGBA': 4}
# PIL's (mode, channels it reads) of a PSD's (colour mode, bits per sample)
PSD_MODES = {(0, 1): ('1', 1), (0, 8): ('L', 1), (1, 8): ('L', 1),
             (2, 8): ('P', 1), (3, 8): ('RGB', 3), (4, 8): ('CMYK', 4),
             (7, 8): ('L', 1), (8, 8): ('L', 1), (9, 8): ('LAB', 3)}
# the modes the JAX load_image keeps; it converts the others to RGB
KEPT = ('RGB', 'RGBA', 'L')
# shortest PNG chunks PIL accepts before the image data, and what it raises
# for shorter ones
_PNG_MIN = {b'gAMA': (4, OSError), b'sRGB': (1, ValueError),
            b'pHYs': (9, ValueError), b'acTL': (8, ValueError),
            b'fcTL': (26, ValueError)}
# (name, test of the first bytes) of formats PIL reads and the port does not
PIL_ONLY = [
    ('TIFF', lambda d: d[:4] in (b'II*\x00', b'MM\x00*', b'II+\x00',
                                 b'MM\x00+')),
    ('WebP', lambda d: d[:4] == b'RIFF' and d[8:12] == b'WEBP'),
    ('ICO', lambda d: d[:4] == b'\x00\x00\x01\x00'),
    ('CUR', lambda d: d[:4] == b'\x00\x00\x02\x00'),
    ('DIB', lambda d: len(d) >= 4 and struct.unpack('<I', d[:4])[0]
     in (12, 40, 52, 56, 64, 108, 124)),
    ('DDS', lambda d: d[:4] == b'DDS '),
    ('QOI', lambda d: d[:4] == b'qoif'),
    ('JPEG 2000', lambda d: d[:4] == b'\xffO\xffQ'
     or d[:12] == b'\x00\x00\x00\x0cjP  \r\n\x87\n'),
    ('ICNS', lambda d: d[:4] == b'icns'),
    ('SGI', lambda d: d[:2] == b'\x01\xda'),
    ('PCX', lambda d: len(d) >= 2 and d[0] == 10 and d[1] in (0, 2, 3, 5)),
    ('BLP', lambda d: d[:4] in (b'BLP1', b'BLP2')),
    ('EPS', lambda d: d[:4] in (b'%!PS', b'\xc5\xd0\xd3\xc6')),
    ('Sun raster', lambda d: d[:4] == b'\x59\xa6\x6a\x95'),
    ('AVIF', lambda d: d[4:8] == b'ftyp' and d[8:12] in (b'avif', b'avis')),
]
_PNM_WHITESPACE = b' \t\n\x0b\x0c\r'
# PIL's read size (ImageFile.MAXBLOCK) and largest image (twice
# Image.MAX_IMAGE_PIXELS, past which it raises DecompressionBombError)
MAXBLOCK = 65536
MAX_PIXELS = 2 * 89478485


def _check_size(w: int, h: int):
    if w * h > MAX_PIXELS:
        raise OSError(f'image size ({w}x{h}) exceeds the decompression bomb '
                      f'limit')


def _build() -> str:
    """The decoder library's path, compiled unless an up-to-date one
    exists. Raises RuntimeError with the compiler's output on failure."""
    so, _, log = compile_library(_SRC, CXXFLAGS, _BUILD_DIR, 'libimage')
    if so is None:
        raise RuntimeError(f'the image decoder did not compile:\n{log[-2000:]}')
    return so


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        i = ctypes.c_int
        lib.cpt_png_raw_size.restype = ctypes.c_int64
        lib.cpt_png_raw_size.argtypes = [i, i, i, i, i]
        lib.cpt_png_row_end.restype = i
        lib.cpt_png_row_end.argtypes = [i, i, i, i, i, ctypes.c_int64]
        lib.cpt_png_unfilter.restype = i
        lib.cpt_png_unfilter.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i, i, i, i, i, ctypes.c_char_p,
            i, u8p, i, ctypes.c_char_p, i]
        lib.cpt_image_decode.restype = i
        lib.cpt_image_decode.argtypes = [
            i, ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(u8p), ip, ip,
            ip, ctypes.c_char_p, ctypes.c_char_p, i]
        lib.cpt_image_free.restype = None
        lib.cpt_image_free.argtypes = [u8p]
        lib.cpt_packbits.restype = ctypes.c_int64
        lib.cpt_packbits.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p,
                                     ctypes.c_int64, ctypes.c_int64]
        _LIB = lib
    return _LIB


def _raise(rc: int, err, what: str):
    """The exception of a decoder's return code (2: OSError, 3:
    ValueError), as PIL raises it."""
    msg = f'{what}: {err.value.decode()}'
    raise (ValueError if rc == 3 else OSError)(msg)


# ---- PNG ---------------------------------------------------------------


def read_png(data: bytes):
    """(pixels, PIL's mode) of a PNG: uint8 [H, W, C] in the layout of
    the module docstring, top row first. Every colour type and bit depth
    of the PNG spec, Adam7 interlacing, the palette (entries it lacks are
    black). The chunks are read as PIL reads them: up to the first IDAT,
    with their CRCs checked; IHDR may come after other chunks, a PLTE
    counts when it follows the IHDR of a palette image, and an fcTL puts
    the image data in its frame. The IDAT chunks that follow one another
    are inflated up to the bytes the scanlines need."""
    if data[:8] != PNG_SIGNATURE:
        raise OSError('cannot identify image file (not a PNG file)')
    pos, ihdr, mode, plte, bbox, interlace, seq = 8, None, None, b'', None, 0, -1
    while True:
        if len(data) - pos < 8:
            raise OSError('cannot identify image file (broken PNG file)')
        n, cid = struct.unpack('>I', data[pos:pos + 4])[0], data[pos + 4:pos + 8]
        if not re.fullmatch(rb'\w{4}', cid):
            raise OSError(f'cannot identify image file (broken PNG file, '
                          f'chunk {cid!r})')
        if cid == b'IDAT':
            break
        if cid == b'IEND':
            raise OSError('cannot load this image (no PNG image data)')
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise OSError('Truncated File Read')
        if cid == b'IHDR':
            if n < 13:
                raise ValueError('Truncated IHDR chunk')
            ihdr = struct.unpack('>IIBBBBB', body[:13])
            mode = PNG_MODES.get((ihdr[2], ihdr[3]))
            interlace = interlace or ihdr[6]
            if ihdr[5]:
                raise OSError('cannot identify image file (unknown filter '
                              'category)')
        elif cid == b'PLTE' and mode == 'P':
            plte = body
        elif cid == b'tRNS' and mode is not None and \
                n < {'RGB': 6, 'P': 0, 'LA': 0, 'RGBA': 0}.get(mode, 2):
            raise OSError('cannot identify image file (short tRNS chunk)')
        elif cid in _PNG_MIN and n < _PNG_MIN[cid][0]:
            raise _PNG_MIN[cid][1](f'Truncated {cid.decode()} chunk')
        elif cid == b'fcTL' and ihdr is not None:
            nseq, fw, fh, fx, fy = struct.unpack('>5I', body[:20])
            if nseq != seq + 1 or fx + fw > ihdr[0] or fy + fh > ihdr[1]:
                raise OSError('cannot identify image file (APNG frame '
                              'errors)')
            seq, bbox = nseq, (fx, fy, fw, fh)
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or struct.unpack('>I', crc)[0] != \
                zlib.crc32(cid + body) & 0xFFFFFFFF:
            raise OSError(f'cannot identify image file (broken PNG file, bad '
                          f'checksum in {cid!r})')
        pos += 12 + n
    if mode is None or ihdr[0] == 0 or ihdr[1] == 0:
        raise OSError('cannot identify image file (PNG mode or size)')
    w, h, depth, ctype = ihdr[:4]
    _check_size(w, h)
    if len(plte) // 3 > 256:
        raise ValueError('invalid palette size')
    fx, fy, fw, fh = bbox or (0, 0, w, h)
    lib = _load()
    geometry = (fw, fh, depth, ctype, int(bool(interlace)))
    need = lib.cpt_png_raw_size(*geometry)
    # PIL inflates the IDAT chunks that follow one another, fed 64 KiB at a
    # time, and stops when the scanlines are complete: what comes after
    # them in a later piece (the zlib checksum, say) is never read. A stream
    # that ends with a row in the piece that finished it ends the image
    # there; the rows it lacks are zero.
    inflate, parts, have, got = zlib.decompressobj(), [], 0, b''
    while have < need and not inflate.eof and len(data) - pos >= 8 and \
            data[pos + 4:pos + 8] == b'IDAT':
        n = struct.unpack('>I', data[pos:pos + 4])[0]
        body = memoryview(data)[pos + 8:pos + 8 + n]
        pos += 12 + n
        for at in range(0, len(body), MAXBLOCK):
            try:
                got = inflate.decompress(body[at:at + MAXBLOCK], need - have)
            except zlib.error as e:
                raise OSError(f'PNG: broken data stream ({e})') from None
            parts.append(got)
            have += len(got)
            if have >= need or inflate.eof:
                break
    if have < need:
        if not (inflate.eof and got and lib.cpt_png_row_end(*geometry, have)):
            raise OSError('image file is truncated')
        parts.append(bytes(need - have))
    raw = b''.join(parts)
    # then it reads the chunks that follow up to IEND, and refuses one the
    # file cuts short
    while len(data) - pos >= 8 and re.fullmatch(rb'\w{4}', data[pos + 4:pos + 8]):
        n, cid = struct.unpack('>I', data[pos:pos + 4])[0], data[pos + 4:pos + 8]
        if cid == b'IEND' or (cid == b'fcTL' and seq >= 0):
            break
        if len(data) - pos - 8 < n:
            raise OSError('Truncated File Read')
        pos += 12 + n
    c = CHANNELS[mode]
    frame = np.zeros((fh, fw, c), np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = lib.cpt_png_unfilter(
        raw, len(raw), fw, fh, depth, ctype, int(bool(interlace)), plte,
        len(plte) // 3, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        c, err, len(err))
    if rc:
        _raise(rc, err, 'PNG')
    if bbox is None:
        return frame, mode
    px = np.zeros((h, w, c), np.uint8)
    if mode == 'P':      # PIL's zeros outside the frame are index 0
        px[:] = np.frombuffer(plte[:3].ljust(3, b'\0'), np.uint8)
    px[fy:fy + fh, fx:fx + fw] = frame
    return px, mode


# ---- TGA, BMP, GIF ------------------------------------------------------


def _native(fmt: int, data: bytes, what: str):
    lib = _load()
    px = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    mode = ctypes.create_string_buffer(8)
    err = ctypes.create_string_buffer(256)
    rc = lib.cpt_image_decode(fmt, bytes(data), len(data), ctypes.byref(px),
                              ctypes.byref(w), ctypes.byref(h),
                              ctypes.byref(c), mode, err, len(err))
    if rc:
        _raise(rc, err, what)
    try:
        n = h.value * w.value * c.value
        out = np.ctypeslib.as_array(px, shape=(n,)).copy()
    finally:
        lib.cpt_image_free(px)
    return out.reshape(h.value, w.value, c.value), mode.value.decode()


def read_tga(data: bytes):
    """(pixels, PIL's mode) of a TGA: types 1, 2, 3 and their RLE forms 9,
    10, 11 at 1, 8, 16, 24 and 32 bits (PIL refuses 15), colour maps of
    16, 24 or 32 bits, both origins and the mirrored ones."""
    return _native(1, data, 'TGA')


def read_bmp(data: bytes):
    """(pixels, PIL's mode) of a BMP: BITMAPCOREHEADER and INFOHEADER
    through V5, 1, 4 and 8-bit palettes (a grey ramp reads as L, black and
    white as 1, as in PIL), RLE4 and RLE8, 16 and 32-bit BI_BITFIELDS of the
    layouts PIL reads, 16, 24 and 32-bit BI_RGB, top-down rows."""
    return _native(2, data, 'BMP')


def read_gif(data: bytes):
    """(pixels, PIL's mode) of a GIF's first frame: LZW, the local or
    global palette (an identity grey ramp reads as L), interlaced rows, a
    frame offset inside (or beyond) the logical screen."""
    return _native(3, data, 'GIF')


# ---- PNM ----------------------------------------------------------------


def _pnm_token(data: bytes, pos: int):
    """PIL's header token at ``pos`` (comments skipped) and the position
    after the whitespace that ends it."""
    token = b''
    while len(token) <= 10:
        c = data[pos:pos + 1]
        pos += len(c)
        if not c:
            break
        if c in _PNM_WHITESPACE:
            if not token:
                continue
            break
        if c == b'#':
            while True:
                c = data[pos:pos + 1]
                pos += len(c)
                if c in (b'', b'\r', b'\n'):
                    break
            continue
        token += c
    if not token:
        raise ValueError('Reached EOF while reading header')
    if len(token) > 10:
        raise ValueError(f'Token too long in file header: {token!r}')
    return token, pos


def _pnm_plain(body: bytes) -> list:
    """The whitespace-separated tokens of a plain PNM's raster, with
    comments (``#`` to the end of the line) removed."""
    return re.sub(rb'#[^\r\n]*', b'', body).split()


def read_pnm(data: bytes):
    """(pixels, PIL's mode) of a PNM: P1-P3 (plain) and P4-P6 (binary),
    any maxval below 65536 (16-bit greys are PIL's mode I), scaled as PIL
    scales it. PIL's PFM and its own P0/Py variants are refused."""
    magic = b''
    pos = 0
    while len(magic) < 6:
        c = data[pos:pos + 1]
        pos += len(c)
        if not c or c in _PNM_WHITESPACE:
            break
        magic += c
    if magic in (b'Pf', b'P0CMYK', b'PyP', b'PyRGBA', b'PyCMYK'):
        raise NotImplementedError(f'PNM variant {magic.decode()}: not read '
                                  f'by the port')
    if magic not in (b'P1', b'P2', b'P3', b'P4', b'P5', b'P6'):
        raise OSError(f'cannot identify image file (PNM magic {magic!r})')
    kind = int(magic[1:])
    mode = {1: '1', 4: '1', 2: 'L', 5: 'L', 3: 'RGB', 6: 'RGB'}[kind]
    tok, pos = _pnm_token(data, pos)
    w = int(tok)
    tok, pos = _pnm_token(data, pos)
    h = int(tok)
    maxval = None
    if mode != '1':
        tok, pos = _pnm_token(data, pos)
        maxval = int(tok)
        if not 0 < maxval < 65536:
            raise ValueError('maxval must be greater than 0 and less than '
                             '65536')
        if maxval > 255 and mode == 'L':
            mode = 'I'
    if w <= 0 or h <= 0:
        raise OSError('cannot identify image file (PNM size)')
    _check_size(w, h)
    bands = 3 if mode == 'RGB' else 1
    count = w * h * bands
    body = data[pos:]
    if kind == 1:
        digits = b''.join(_pnm_plain(body))
        if digits.translate(None, b'01'):
            raise ValueError('Invalid token for this mode')
        if len(digits) < count:
            raise ValueError('not enough image data')
        px = np.where(np.frombuffer(digits[:count], np.uint8) == ord('0'),
                      255, 0).astype(np.uint8)
    elif kind == 4:
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise OSError('image file is truncated')
        bits = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8)
                             .reshape(h, stride), axis=1)[:, :w]
        px = np.where(bits == 1, 0, 255).astype(np.uint8)
    elif kind in (2, 3):
        tokens = _pnm_plain(body)[:count]
        if any(len(t) > 10 for t in tokens):
            raise ValueError('Token too long found in data')
        vals = np.array(tokens, dtype='S').astype(np.int64) if tokens \
            else np.zeros(0, np.int64)
        if (vals < 0).any() or (vals > maxval).any():
            raise ValueError('Channel value out of range for this mode')
        if len(vals) < count:
            raise ValueError('not enough image data')
        out_max = 65535 if mode == 'I' else 255
        px = _saturate(np.round(vals / maxval * out_max))
    elif maxval == 255 or (maxval == 65535 and mode == 'I'):
        size = 2 if maxval == 65535 else 1
        if len(body) < count * size:
            # PIL maps an L image of a file opened by name straight from
            # the file, and raises ValueError when it is too short for it
            raise (ValueError if mode == 'L' else OSError)(
                'image file is truncated')
        vals = np.frombuffer(body, '>u2' if size == 2 else np.uint8, count)
        px = _saturate(vals)
    else:
        size = 1 if maxval < 256 else 2
        if len(body) < count * size:
            raise ValueError('not enough image data')
        vals = np.frombuffer(body, '>u2' if size == 2 else np.uint8,
                             count).astype(np.float64)
        out_max = 65535 if mode == 'I' else 255
        px = _saturate(np.minimum(out_max, np.round(vals / maxval * out_max)))
    return px.reshape(h, w, bands), mode


def _saturate(vals) -> np.ndarray:
    """Samples of mode L, RGB or I as uint8 (I saturated at 255, which is
    what its conversion to RGB keeps)."""
    return np.minimum(np.asarray(vals), 255).astype(np.uint8)


# ---- PSD ------------------------------------------------------------------


class _Reader:
    """A file position over bytes that reads short at the end, as a file
    does; the integers of a short read raise OSError (PIL's struct.error
    and IndexError at open)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def uint(self, n: int) -> int:
        b = self.read(n)
        if len(b) < n:
            raise OSError('cannot identify image file (PSD: short read)')
        return int.from_bytes(b, 'big')


def read_psd(data: bytes, name: str = ''):
    """(pixels, PIL's mode) of a PSD's composite image as PsdImagePlugin
    reads it: bitmap as ``1``, grey, multichannel and duotone as ``L``
    (one channel), indexed as ``P`` through the colour-mode data when it
    is a 768-byte palette (else black), RGB (``RGBA`` with exactly four
    channels) and CMYK (inverted, PIL's raw mode ``CMYK;I``); raw or
    PackBits rows (C++), each channel from the offset PIL computes, which
    reads the row-length table of only the channels the mode takes. Lab
    composites raise NotImplementedError: PIL converts them to RGB through
    LittleCMS. 16 and 32-bit files, other versions and unknown modes raise
    OSError, as in PIL."""
    f = _Reader(data)
    head = f.read(26)
    if len(head) < 26 or head[:4] != b'8BPS' or head[4:6] != b'\x00\x01':
        raise OSError('cannot identify image file (not a PSD file)')
    psd_channels, h, w, bits, cmode = struct.unpack('>HIIHH', head[12:26])
    if (cmode, bits) not in PSD_MODES:
        raise OSError(f'cannot identify image file (PSD mode {cmode} at '
                      f'{bits} bits)')
    mode, channels = PSD_MODES[(cmode, bits)]
    if channels > psd_channels:
        raise OSError('not enough channels')
    if mode == 'RGB' and psd_channels == 4:
        mode, channels = 'RGBA', 4
    size = f.uint(4)
    palette = None
    if size:
        colour = f.read(size)
        if mode == 'P' and size == len(colour) == 768:
            palette = np.frombuffer(colour, np.uint8).reshape(3, 256).T
    size = f.uint(4)
    if size:   # image resources, read as PIL reads them
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            f.uint(2)
            n = f.uint(1)
            if not len(f.read(n)) & 1:
                f.read(1)
            if len(f.read(f.uint(4))) & 1:
                f.read(1)
    size = f.uint(4)
    if size:   # the layer and mask section
        end = f.pos + size
        f.uint(4)
        f.pos = end
    compression = f.uint(2)
    if mode == 'LAB':
        raise NotImplementedError(f'{name or "image"}: a PSD in Lab colour '
                                  f'is not read by the port (PIL converts '
                                  f'it through LittleCMS)')
    if compression not in (0, 1):
        raise OSError('cannot load this image (PSD compression '
                      f'{compression})')
    _check_size(w, h)
    row = (w + 7) // 8 if bits == 1 else w
    planes = np.zeros((channels, h, row), np.uint8)
    if compression == 0:
        offset = f.pos
        for c in range(channels):
            chunk = data[offset:offset + row * h]
            if len(chunk) < row * h:
                # PIL maps a one-channel L or P image of a file opened by
                # name straight from the file: a short one raises
                # ValueError unless the data starts past its end
                mapped = channels == 1 and mode in ('L', 'P') and \
                    offset <= len(data)
                raise (ValueError if mapped else OSError)(
                    'image file is truncated')
            planes[c] = np.frombuffer(chunk, np.uint8).reshape(h, row)
            offset += w * h
    else:
        counts = f.read(channels * h * 2)
        if len(counts) < channels * h * 2:
            raise OSError('cannot identify image file (PSD: short read)')
        lengths = np.frombuffer(counts, '>u2').reshape(channels, h)
        lib = _load()
        offset = f.pos
        for c in range(channels):
            rest = data[offset:]
            if lib.cpt_packbits(rest, len(rest), planes[c].ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)), row, h) < 0:
                raise OSError('image file is truncated')
            offset += int(lengths[c].sum())
    if mode == '1':
        bits_ = np.unpackbits(planes[0], axis=1)[:, :w]
        return (bits_ * 255).astype(np.uint8)[..., None], mode
    if mode == 'P':
        table = palette if palette is not None else np.zeros((256, 3),
                                                             np.uint8)
        return table[planes[0]], mode
    px = np.ascontiguousarray(planes.transpose(1, 2, 0))
    if mode == 'CMYK':
        px = 255 - px
    return px, mode


# ---- identification and the mode table ------------------------------------


def cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    """PIL's ``convert('RGB')`` of CMYK uint8 [..., 4] (Convert.c
    cmyk2rgb): each channel (255 - K) - C (255 - K) / 255, the product
    rounded as PIL's MULDIV255 rounds it."""
    c = px[..., :3].astype(np.int32)
    nk = 255 - px[..., 3:4].astype(np.int32)
    t = c * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def as_loaded(px: np.ndarray, mode: str) -> np.ndarray:
    """The JAX ``load_image``'s uint8 pixels of a decoder's output: the
    modes of :data:`KEPT` as they are; PIL's ``convert('RGB')`` of the
    others, which repeats the grey of ``1``, ``LA``, ``I;16`` and ``I``,
    keeps ``P``'s palette colours (the decoders return those already) and
    takes CMYK through :func:`cmyk_to_rgb`."""
    if mode in KEPT or mode == 'P':
        return px
    if mode == 'CMYK':
        return cmyk_to_rgb(px)
    return np.repeat(px[..., :1], 3, axis=-1)


def identify(data: bytes, name: str = '') -> str:
    """PIL's format of a file's bytes among those the port reads ('PNG',
    'JPEG', 'BMP', 'GIF', 'PNM', 'TGA', 'PSD'). Raises NotImplementedError
    for a format of :data:`PIL_ONLY` and OSError for bytes no format
    claims."""
    if data[:8] == PNG_SIGNATURE:
        return 'PNG'
    if data[:3] == b'\xff\xd8\xff':
        return 'JPEG'
    if data[:2] == b'BM':
        return 'BMP'
    if data[:6] in (b'GIF87a', b'GIF89a'):
        return 'GIF'
    if data[:4] == b'8BPS':
        return 'PSD'
    if len(data) >= 2 and data[:1] == b'P' and data[1] in b'0123456fy':
        return 'PNM'
    if name.lower().endswith('.tga') and len(data) >= 2 and data[1] in (0, 1):
        return 'TGA'
    for fmt, test in PIL_ONLY:
        if test(data):
            raise NotImplementedError(f'{name or "image"}: {fmt} images are '
                                      f'not read by the port')
    raise OSError(f'cannot identify image file {name!r}')


_READERS = {'PNG': read_png, 'BMP': read_bmp, 'GIF': read_gif,
            'PNM': read_pnm, 'TGA': read_tga}


def decode_image(data: bytes, name: str = ''):
    """(pixels, mode) of an image file's bytes: uint8 [H, W, C], top row
    first, equal to the JAX ``load_image``'s array times 255 (C = 1 for
    ``L``, 3 for RGB and every converted mode, ``CMYK`` included, 4 for
    ``RGBA``), and PIL's mode for the file. ``name`` (the file's path) lets
    a ``.tga`` be read and names the file in errors."""
    fmt = identify(data, name)
    if fmt == 'JPEG':
        px = decode_jpeg(data)
        mode = {1: 'L', 3: 'RGB', 4: 'CMYK'}[px.shape[-1]]
    elif fmt == 'PSD':
        px, mode = read_psd(data, name)
    else:
        px, mode = _READERS[fmt](data)
    return as_loaded(px, mode), mode
