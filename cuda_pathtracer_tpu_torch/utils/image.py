"""PNG output with the standard library alone (``zlib`` and ``struct``):
the machine with the card has no imaging package."""
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
