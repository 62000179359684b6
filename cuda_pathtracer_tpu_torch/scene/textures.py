"""Image loading, the flat texture atlas and bilinear sampling (counterpart of
``cuda_pathtracer_tpu/scene/textures.py``).

All textures live in one flat texel array; :func:`sample_bilinear` reproduces
the CUDA texture objects of the reference (src/use_cuda.h:145-151:
normalized coordinates, wrap addressing, linear filter sampling at
``u*W - 0.5``). LDR images load linearly (value/255, no gamma) and are stored
bottom-row-first, like the reference (src/use_cuda.h:125-133,169,207).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .images import decode_image


def _read_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) decoder -> float32 [H, W, 3]."""
    with open(path, 'rb') as f:
        data = f.read()
    pos = data.find(b'\n\n')
    if pos < 0:
        raise ValueError(f'bad hdr header in {path}')
    header_end = pos + 2
    nl = data.find(b'\n', header_end)
    res = data[header_end:nl].split()
    if len(res) != 4 or res[0] != b'-Y' or res[2] != b'+X':
        raise ValueError(f'unsupported hdr layout in {path}: {res}')
    height, width = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=nl + 1)
    rgbe = np.zeros((height, width, 4), np.uint8)
    p = 0
    for y in range(height):
        if p + 4 <= len(buf) and buf[p] == 2 and buf[p + 1] == 2 and \
                (int(buf[p + 2]) << 8 | int(buf[p + 3])) == width:
            p += 4   # adaptive RLE scanline
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[p]); p += 1
                    if count > 128:   # run
                        rgbe[y, x:x + count - 128, c] = buf[p]
                        p += 1
                        x += count - 128
                    else:             # literal
                        rgbe[y, x:x + count, c] = buf[p:p + count]
                        p += count
                        x += count
        else:   # flat scanline
            rgbe[y] = buf[p:p + 4 * width].reshape(width, 4)
            p += 4 * width
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def load_image(path: str) -> np.ndarray:
    """Decode an image to linear float32 [H, W, C], bottom row first, as the
    JAX package's PIL path does: Radiance ``.hdr`` by its extension, every
    other file through ``scene/images.py::decode_image``, which identifies
    it by its content (PNG, JPEG, BMP, GIF, PNM, PSD, and TGA when it is
    named ``.tga``) and applies PIL's mode table (C = 1 for grey, 4 for
    RGBA, 3 for the rest). A missing file raises FileNotFoundError;
    malformed files, the files PIL refuses and the formats the port does
    not read raise OSError, ValueError or NotImplementedError as
    ``decode_image`` says, so the skydome search never takes them for a
    missing file."""
    if path.lower().endswith('.hdr'):
        img = _read_hdr(path)
    else:
        with open(path, 'rb') as f:
            px, _ = decode_image(f.read(), path)
        img = px.astype(np.float32) / 255.0
    return np.ascontiguousarray(img[::-1])


class TextureStack(NamedTuple):
    """Device-side atlas: all texels flattened, per-texture offset/size."""
    texels: torch.Tensor   # f32[P, 3]
    offset: torch.Tensor   # i32[K]
    width: torch.Tensor    # i32[K]
    height: torch.Tensor   # i32[K]


class TextureAtlas:
    """Host-side builder with path dedup (the textureItems map of
    src/scene.h:174,214-244)."""

    def __init__(self):
        self._images: list[np.ndarray] = []
        self._by_path: dict[str, int] = {}

    def add_path(self, path: str, search_dirs=()) -> int:
        full = path
        if not os.path.exists(full):
            for d in search_dirs:
                cand = os.path.join(d, os.path.basename(path))
                if os.path.exists(cand):
                    full = cand
                    break
        key = os.path.realpath(full)
        if key in self._by_path:
            return self._by_path[key]
        img = load_image(full)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        idx = len(self._images)
        self._images.append(img[..., :3])
        self._by_path[key] = idx
        return idx

    def add_array(self, img: np.ndarray) -> int:
        idx = len(self._images)
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        self._images.append(img[..., :3])
        return idx

    def __len__(self):
        return len(self._images)

    def build(self, device) -> TextureStack:
        if not self._images:
            # one white 1x1 texel so the arrays are never empty
            self._images.append(np.ones((1, 1, 3), np.float32))
        offsets, ws, hs, flats = [], [], [], []
        off = 0
        for img in self._images:
            h, w, _ = img.shape
            offsets.append(off)
            ws.append(w)
            hs.append(h)
            flats.append(img.reshape(-1, 3))
            off += w * h

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)
        return TextureStack(t(np.concatenate(flats, axis=0), np.float32),
                            t(offsets, np.int32), t(ws, np.int32),
                            t(hs, np.int32))


def bilinear_wrap(texels, off, w, h, u, v):
    """Wrap-addressed bilinear fetch of ``texels`` rows at normalized (u, v)
    for images of size (w, h) (ints, or int tensors of u's shape) starting
    at row ``off`` — the shared sampler of the texture atlas and the
    skydome."""
    fu = u * w - 0.5
    fv = v * h - 0.5
    x0 = torch.floor(fu)
    y0 = torch.floor(fv)
    tx = (fu - x0)[..., None]
    ty = (fv - y0)[..., None]
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)

    def fetch(x, y):
        return texels[off + torch.remainder(y, h) * w + torch.remainder(x, w)]
    c00, c10 = fetch(xi, yi), fetch(xi + 1, yi)
    c01, c11 = fetch(xi, yi + 1), fetch(xi + 1, yi + 1)
    return ((c00 * (1 - tx) + c10 * tx) * (1 - ty)
            + (c01 * (1 - tx) + c11 * tx) * ty)


def sample_bilinear(stack: TextureStack, tex_id, u, v):
    """Bilinear wrap-addressed atlas fetch; ``tex_id``, ``u``, ``v`` share
    one batch shape. Returns f32[..., 3]."""
    tex_id = tex_id.long()
    return bilinear_wrap(stack.texels, stack.offset[tex_id].long(),
                         stack.width[tex_id], stack.height[tex_id], u, v)
