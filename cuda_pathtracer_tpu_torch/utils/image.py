"""PNG encoding and decoding with the standard library alone (``zlib`` and
``struct``): the machine with the card has no imaging package."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack('>I', len(data)) + body
            + struct.pack('>I', zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """An [H, W, 3] image stored bottom-row-first (f32 display values in
    [0, 1], or uint8) as the bytes of an 8-bit RGB PNG, top row first."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f'expected an [H, W, 3] image, got {arr.shape}')
    h, w, _ = arr.shape
    rows = np.ascontiguousarray(arr[::-1]).reshape(h, w * 3)
    # filter type 0 (None) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b'\x89PNG\r\n\x1a\n'
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + _chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + _chunk(b'IEND', b''))


def save_png(img, path: str) -> None:
    """Write :func:`encode_png` of ``img`` to ``path``."""
    with open(path, 'wb') as f:
        f.write(encode_png(img))


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples per pixel


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec 9.2-9.4) of ``raw``, the
    inflated IDAT stream of ``h`` scanlines of ``stride`` bytes."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h + 1, stride + bpp), np.int32)   # a zero row and columns
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        up = out[y, bpp:]
        cur = out[y + 1]
        if ftype == 0:
            cur[bpp:] = line
        elif ftype == 2:
            cur[bpp:] = (line + up) & 0xFF
        elif ftype in (1, 3, 4):
            for x in range(stride):
                a, b, c = cur[x], up[x], out[y, x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[bpp + x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f'bad PNG filter type {ftype}')
    return out[1:, bpp:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit, non-interlaced PNG (grey, grey + alpha, RGB or
    RGBA) as uint8 [H, W, C], top row first."""
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError('not a PNG')
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,), kind = struct.unpack('>I', data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError('PNG without IHDR')
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f'unsupported PNG: bit depth {depth}, colour type '
                         f'{ctype}, interlace {interlace}')
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
