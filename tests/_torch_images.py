"""Image files for the port's decoder tests (``tests/test_torch_images.py``)
and for ``chip_smoke.py``'s phase 7: encoders of PNG, TGA, BMP, GIF, PNM
and PSD in numpy, for the layouts PIL does not write (Adam7, 2/4/16-bit
grey, 16-bit RGB(A) and grey + alpha, every filter type, the TGA image
types and origins, BMP RLE, bit fields and header versions, GIF local
palettes, offsets and code sizes, plain PNM and odd maxvals, PSD
composites of every colour mode, raw and PackBits), and PIL for the
rest.

:func:`write_fixtures` writes the committed fixtures of ``tests/data/
images`` and their ``digests.json``: for each file PIL's mode and the
shape and SHA-256 of the JAX ``load_image``'s pixels (PIL's decode, kept
for RGB, RGBA and L, else ``convert('RGB')``, as uint8), and the Pillow
version. ``chip_smoke.py`` holds the port's decoder to those digests on
the machine with the card, which has no PIL. Run it again only to change
the fixtures:

    python tests/_torch_images.py tests/data/images

Nothing here imports PIL at module level: ``chip_smoke.py`` imports the
encoders on the machine with the card.
"""
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

KEPT = ('RGB', 'RGBA', 'L')


def picture(h: int, w: int, c: int = 3, seed: int = 0, runs: int = 0):
    """uint8 [h, w, c]: smooth waves with noise, flat blocks and, with
    ``runs`` > 0, rows made of horizontal runs of up to ``runs`` equal
    pixels (so the RLE encoders make both kinds of packet)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([np.sin(x / 7.0 + k) * 90 + np.cos(y / 5.0 - k) * 60 + 128
                     for k in range(c)], -1)
    base[(x // 9 + y // 7) % 5 == 0] = 250 if c == 1 else \
        np.array([250, 5, 128, 77][:c])
    img = np.clip(base + rs.randn(h, w, c) * 25, 0, 255).astype(np.uint8)
    if runs:
        starts = rs.randint(0, 2, (h, w)).astype(bool) & \
            (rs.randint(0, runs, (h, w)) == 0)
        starts[:, 0] = True
        idx = np.maximum.accumulate(np.where(starts, np.arange(w)[None], 0),
                                    axis=1)
        img = np.take_along_axis(img, idx[..., None].repeat(c, -1), axis=1)
    return img


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.uint8).tobytes()
                          ).hexdigest()


# ---- PNG ------------------------------------------------------------------

ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """uint8 [h, row bytes] of integer samples [h, n] at ``depth`` bits
    (big-endian for 16, MSB first below 8)."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype('>u2').view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    pad = -n % per
    s = np.concatenate([samples, np.zeros((h, pad), samples.dtype)], 1)
    s = s.reshape(h, -1, per).astype(np.uint16)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint16)
    return (s << shifts).sum(-1).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """Filtered scanlines (filter byte + row) of uint8 [h, n] rows; row y
    takes filter ``ftypes[y]``."""
    ft = np.asarray(ftypes, np.int64)
    out = np.empty((len(rows), rows.shape[1] + 1), np.uint8)
    out[:, 0] = ft
    for f in range(5):
        sel = np.flatnonzero(ft == f)
        if not len(sel):
            continue
        r = rows[sel].astype(np.int32)
        up = np.where(sel[:, None] > 0, rows[np.maximum(sel - 1, 0)], 0
                      ).astype(np.int32)
        left = np.pad(r, ((0, 0), (bpp, 0)))[:, :-bpp]
        ul = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
        if f == 4:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = [0, left, up, (left + up) >> 1][f]
        out[sel, 1:] = (r - pred) & 0xFF
    return out.tobytes()


def encode_png(samples: np.ndarray, depth: int, ctype: int,
               interlace: bool = False, filters='cycle', palette=None,
               trns=None, level: int = 6, idat_parts: int = 1,
               before_idat: bytes = b'') -> bytes:
    """A PNG of integer samples [h, w, channels of ``ctype``] (palette
    indices for ctype 3) at ``depth`` bits. ``filters``: 'cycle' (row y
    takes filter y % 5 in each pass), an int, or a per-row list (non-
    interlaced). ``palette``: uint8 [n, 3]; ``trns``: the tRNS chunk's
    bytes; ``idat_parts``: how many IDAT chunks the stream is split into;
    ``before_idat``: chunks placed before the image data."""
    h, w, ch = samples.shape
    bits = depth * ch
    bpp = max(1, bits // 8)
    passes = ADAM7 if interlace else [(0, 0, 1, 1)]
    raw = b''
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        n = len(rows)
        if isinstance(filters, str):
            ft = np.arange(n) % 5
        elif isinstance(filters, int):
            ft = np.full(n, filters)
        else:
            ft = np.asarray(filters)
        raw += _filter(rows, bpp, ft)
    z = zlib.compress(raw, level)
    cuts = np.linspace(0, len(z), idat_parts + 1).astype(int)
    out = (b'\x89PNG\r\n\x1a\n'
           + png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, ctype,
                                            0, 0, int(interlace))))
    if palette is not None:
        out += png_chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b'tRNS', trns)
    out += before_idat
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += png_chunk(b'IDAT', z[a:b])
    return out + png_chunk(b'IEND', b'')


# ---- TGA ------------------------------------------------------------------


def _tga_rle(rows: np.ndarray) -> bytes:
    """RLE packets of pixel rows [h, w, bytes per pixel], one row at a
    time (a run never crosses a row, as PIL requires)."""
    out = bytearray()
    for row in rows:
        keys = row.reshape(len(row), -1)
        change = np.ones(len(keys), bool)
        change[1:] = (keys[1:] != keys[:-1]).any(1)
        starts = np.flatnonzero(change)
        lens = np.diff(np.append(starts, len(keys)))
        lit = []

        def flush():
            while lit:
                part = lit[:128]
                del lit[:128]
                out.append(len(part) - 1)
                out.extend(b''.join(part))
        for s, n in zip(starts, lens):
            if n == 1:
                lit.append(keys[s].tobytes())
                continue
            flush()
            while n > 0:
                k = min(n, 128)
                out.append(0x80 | (k - 1))
                out.extend(keys[s].tobytes())
                n -= k
        flush()
    return bytes(out)


def encode_tga(pixels: np.ndarray, itype: int, depth: int, top: bool = True,
               mirror: bool = False, cmap=None, cmap_depth: int = 24,
               cmap_start: int = 0, image_id: bytes = b'') -> bytes:
    """A TGA of ``pixels``: [h, w, bytes per pixel] in the file's byte
    order (BGR(A), index, grey(+alpha), or 16-bit little-endian words as
    two bytes), packed for 1-bit type 3/11 from [h, w, 1] of 0/1. RLE when
    ``itype`` > 8. ``cmap``: the colour map's entries as bytes [n, depth /
    8]."""
    h, w = pixels.shape[:2]
    order = pixels if top else pixels[::-1]
    if mirror:
        order = order[:, ::-1]
    flags = (0x20 if top else 0) | (0x10 if mirror else 0)
    if depth == 1:
        packed = np.packbits(order[..., 0].astype(np.uint8), axis=1)
        body = _tga_rle(packed[..., None]) if itype > 8 else packed.tobytes()
    else:
        body = _tga_rle(order) if itype > 8 else order.tobytes()
    cm = b''
    cm_spec = (0, 0, 0)
    if cmap is not None:
        cm = np.asarray(cmap, np.uint8).tobytes()
        cm_spec = (cmap_start, len(cmap), cmap_depth)
    head = (bytes([len(image_id), int(cmap is not None), itype])
            + struct.pack('<HHB', *cm_spec)
            + struct.pack('<HHHH', 0, 0, w, h) + bytes([depth, flags]))
    return head + image_id + cm + body


# ---- BMP ------------------------------------------------------------------


def _rle8(rows: np.ndarray, rle4: bool, deltas: bool = False) -> bytes:
    """BMP RLE8 (or RLE4) of index rows [h, w], bottom row first, with
    runs, literals (absolute mode, word aligned) and end-of-line codes.
    ``deltas``: skip the rest of a row with PIL's delta, which reads two
    bytes it ignores and then the offsets, where the row ends in zeros."""
    out = bytearray()
    for row in rows:
        x, w = 0, len(row)
        if deltas and w > 4 and not row[w // 2:].any():
            w = w // 2
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or w - x < 3:
                v = row[x]
                out += bytes([n, (v << 4 | v) if rle4 else v])
                x += n
                continue
            m = 0
            while x + m < w and m < 254 and \
                    not (x + m + 2 < w and row[x + m] == row[x + m + 1]
                         == row[x + m + 2]):
                m += 1
            m = max(m - (m % 2 if rle4 else 0), 0)
            if m < 3:
                v = row[x]
                out += bytes([1, (v << 4) if rle4 else v])
                x += 1
                continue
            seg = row[x:x + m]
            if rle4:
                data = bytes((seg[0::2] << 4 | seg[1::2]).astype(np.uint8))
            else:
                data = bytes(seg.astype(np.uint8))
            out += bytes([0, m]) + data + (b'\0' if len(data) % 2 else b'')
            x += m
        if w < len(row):     # PIL skips (0, 1), then moves right
            out += bytes([0, 2, 0, 1, len(row) - w, 0])
        out += b'\x00\x00'
    return bytes(out + b'\x00\x01')


def encode_bmp(pixels: np.ndarray, bits: int, palette=None, header: int = 40,
               compression: int = 0, masks=None, top_down: bool = False,
               colors: int = 0, deltas: bool = False) -> bytes:
    """A BMP of ``pixels``: indices [h, w] for 1/4/8 bits, else [h, w, k]
    bytes of each pixel in file order (B, G, R(, X/A)) or [h, w] 16-bit
    words. ``compression`` 1/2 is RLE8/RLE4, 3 bit fields with ``masks``
    (r, g, b(, a)); ``header`` 12, 40, 52, 56, 108 or 124."""
    h, w = pixels.shape[:2]
    rows = pixels if top_down else pixels[::-1]
    if compression in (1, 2):
        data = _rle8(rows, compression == 2, deltas)
    else:
        if bits < 8:
            data_rows = _pack_rows(rows.astype(np.int64), bits)
        elif bits == 16:
            data_rows = rows.astype('<u2').view(np.uint8).reshape(h, -1)
        else:
            data_rows = rows.reshape(h, -1).astype(np.uint8)
        stride = ((w * bits + 31) >> 3) & ~3
        data_rows = np.concatenate(
            [data_rows, np.zeros((h, stride - data_rows.shape[1]), np.uint8)], 1)
        data = data_rows.tobytes()
    pal = b''
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]        # RGB -> BGR
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    mask_bytes = b''
    if header == 12:
        info = struct.pack('<IHHHH', 12, w, h, 1, bits)
    else:
        info = struct.pack('<IiiHHIIiiII', header, w, -h if top_down else h,
                           1, bits, compression, len(data), 2835, 2835, colors,
                           0)
        if compression == 3:
            m = list(masks) + [0] * (4 - len(masks))
            if header >= 52:
                info += struct.pack('<4I', *m)[:(16 if header >= 56 else 12)]
            else:
                mask_bytes = struct.pack('<3I', *m[:3])
        info += bytes(max(0, header - len(info)))
    offset = 14 + len(info) + len(mask_bytes) + len(pal)
    head = b'BM' + struct.pack('<IHHI', offset + len(data), 0, 0, offset)
    return head + info + mask_bytes + pal + data


# ---- GIF ------------------------------------------------------------------


def _lzw(indices: np.ndarray, min_code: int, clear_every: int = 0) -> bytes:
    """GIF LZW of a flat index array, in data sub-blocks; with
    ``clear_every`` a clear code after that many codes, else the table
    fills to 4096 and stays (a deferred clear). Each code is written at the
    width the decoder reads it with: its table runs one entry behind."""
    clear, eoi = 1 << min_code, (1 << min_code) + 1
    acc = nbits = 0
    data = bytearray()
    dec = {}                    # the decoder's next entry, width, first code

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += dec['size']
        while nbits >= 8:
            data.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
        if code == clear:
            dec.update(next=eoi + 1, size=min_code + 1, first=True)
        elif code != eoi and dec['first']:
            dec['first'] = False
        elif code != eoi and dec['next'] < 4096:
            if dec['next'] == (1 << dec['size']) - 1 and dec['size'] < 12:
                dec['size'] += 1
            dec['next'] += 1
    dec.update(size=min_code + 1)
    emit(clear)
    table, nxt, cur, count = {(i,): i for i in range(clear)}, eoi + 1, (), 0
    for v in indices.tolist():
        if cur + (v,) in table:
            cur += (v,)
            continue
        emit(table[cur])
        count += 1
        if nxt < 4096:
            table[cur + (v,)] = nxt
            nxt += 1
        cur = (v,)
        if clear_every and count % clear_every == 0:
            emit(table[cur])
            emit(clear)
            table, nxt, cur = {(i,): i for i in range(clear)}, eoi + 1, ()
    if cur:
        emit(table[cur])
    emit(eoi)
    if nbits:
        data.append(acc)
    blocks = bytearray([min_code])
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        blocks += bytes([len(part)]) + part
    return bytes(blocks + b'\x00')


def encode_gif(indices: np.ndarray, palette, local_palette=None,
               interlace: bool = False, screen=None, offset=(0, 0),
               transparency=None, min_code: int = 0, clear_every: int = 0,
               version: bytes = b'GIF89a') -> bytes:
    """A one-frame GIF of uint8 indices [h, w]: ``palette`` (uint8 [n, 3],
    n a power of two from 2, or None) as the global colour table and
    ``local_palette`` as the frame's own; the frame at ``offset`` in a
    logical ``screen`` (w, h) (default: the frame's size); a graphic
    control extension with ``transparency``."""
    h, w = indices.shape
    sw, sh = screen or (w, h)

    def table_bits(p):
        return max(1, int(np.ceil(np.log2(max(len(p), 2))))) - 1
    flags = 0
    out = bytearray(version + struct.pack('<HH', sw, sh))
    if palette is not None:
        flags = 0x80 | table_bits(palette)
    out += bytes([flags, 0, 0])
    if palette is not None:
        out += np.asarray(palette, np.uint8).tobytes()
    if transparency is not None:
        out += bytes([0x21, 0xF9, 4, 1, 0, 0, transparency, 0])
    out += b'\x21\xfe\x05hello\x00'        # a comment extension
    f = 0x40 if interlace else 0
    if local_palette is not None:
        f |= 0x80 | table_bits(local_palette)
    out += b',' + struct.pack('<HHHHB', offset[0], offset[1], w, h, f)
    if local_palette is not None:
        out += np.asarray(local_palette, np.uint8).tobytes()
    rows = indices
    if interlace:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = indices[order]
    mc = min_code or max(2, int(np.ceil(np.log2(max(int(indices.max()) + 1,
                                                     2)))))
    out += _lzw(rows.ravel(), mc, clear_every)
    return bytes(out + b';')


# ---- PNM ------------------------------------------------------------------


def encode_pnm(samples: np.ndarray, kind: int, maxval: int = 255,
               comment: bool = True) -> bytes:
    """A PNM of integer samples [h, w, 1 or 3] (0/1 for P1 and P4, 1 =
    black): P1-P3 as text, P4-P6 binary (two bytes, big-endian, for a
    maxval above 255)."""
    h, w = samples.shape[:2]
    head = f'P{kind}\n' + ('# a comment\n' if comment else '') + f'{w} {h}\n'
    if kind not in (1, 4):
        head += f'{maxval}\n'
    s = samples.reshape(h, -1)
    if kind == 1:
        body = '\n'.join(''.join(str(int(v)) for v in r) for r in s) + '\n'
        return head.encode() + body.encode()
    if kind in (2, 3):
        body = '\n'.join(' '.join(str(int(v)) for v in r) for r in s) + '\n'
        return head.encode() + body.encode()
    if kind == 4:
        return head.encode() + np.packbits(s.astype(np.uint8), axis=1).tobytes()
    return head.encode() + s.astype('>u2' if maxval > 255 else np.uint8).tobytes()


# ---- the fixtures ----------------------------------------------------------


# ---- PSD --------------------------------------------------------------------

# Photoshop colour modes of the composite image PIL reads: name -> (mode
# number, bits per sample)
PSD_MODES = {'bitmap': (0, 1), 'grey': (1, 8), 'indexed': (2, 8),
             'rgb': (3, 8), 'cmyk': (4, 8), 'multichannel': (7, 8),
             'duotone': (8, 8), 'lab': (9, 8)}


def packbits(plane: np.ndarray):
    """PackBits of each row of uint8 ``plane`` [rows, width], in numpy:
    runs of 3 or more equal bytes as (257 - n, byte) packets of up to 128
    (a last piece of 1 as a literal), the bytes between them as literals of
    up to 128. Returns (the packed rows, concatenated; each row's length)."""
    rows, w = plane.shape
    if rows == 0 or w == 0:
        return b'', np.zeros(rows, np.int64)
    flat = plane.reshape(-1).astype(np.int64)
    col = np.tile(np.arange(w), rows)
    new_run = np.ones(flat.size, bool)
    new_run[1:] = (flat[1:] != flat[:-1]) | (col[1:] == 0)
    starts = np.flatnonzero(new_run)
    lengths = np.diff(np.append(starts, flat.size))
    is_run = lengths >= 3
    # literal segments: maximal stretches of short runs within a row
    seg_start = is_run.copy()
    seg_start[1:] |= is_run[:-1] | (col[starts[1:]] == 0)
    seg_start[0] = True
    seg_id = np.cumsum(seg_start) - 1
    seg_pos = starts[seg_start]
    seg_len = np.bincount(seg_id, lengths)
    seg_run = is_run[seg_start]
    # pieces of up to 128 bytes
    pieces = -(-seg_len.astype(np.int64) // 128)
    piece_seg = np.repeat(np.arange(len(seg_len)), pieces)
    first_piece = np.cumsum(pieces) - pieces
    k = np.arange(len(piece_seg)) - first_piece[piece_seg]
    n = np.minimum(128, seg_len[piece_seg].astype(np.int64) - 128 * k)
    src = seg_pos[piece_seg] + 128 * k
    run = seg_run[piece_seg] & (n >= 2)
    size = np.where(run, 2, n + 1)
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[at] = np.where(run, 257 - n, n - 1)
    out[at[run] + 1] = flat[src[run]]
    lit = ~run
    count = n[lit]
    base = np.repeat(at[lit] + 1 - np.cumsum(count) + count, count)
    idx = np.arange(int(count.sum()))
    out[base + idx] = flat[np.repeat(src[lit] - np.cumsum(count) + count,
                                     count) + idx]
    row_of = src // w
    return out.tobytes(), np.bincount(row_of, size, minlength=rows).astype(
        np.int64)


def encode_psd(planes: np.ndarray, mode: str, compression: int = 0,
               width: int = None, colour_data: bytes = b'',
               depth: int = None) -> bytes:
    """A PSD of uint8 ``planes`` [channels, h, row bytes] (bitmap rows
    packed 8 pixels to a byte, MSB first) in colour ``mode`` (a key of
    :data:`PSD_MODES`): raw (``compression`` 0) or PackBits rows (1), with
    ``colour_data`` (an indexed file's palette: 256 reds, greens, blues),
    two image resources and an empty layer section, which readers of the
    composite skip; ``depth`` overrides the mode's bits per sample in the
    header."""
    number, bits = PSD_MODES[mode]
    ch, h, row = planes.shape
    w = width if width is not None else (row * 8 if bits == 1 else row)
    out = bytearray(b'8BPS' + struct.pack('>H', 1) + bytes(6))
    out += struct.pack('>HIIHH', ch, h, w, depth or bits, number)
    out += struct.pack('>I', len(colour_data)) + colour_data
    # a resolution block and one with an odd-length name
    res = (b'8BIM' + struct.pack('>H', 1005) + b'\x00\x00'
           + struct.pack('>I', 16) + bytes(range(16))
           + b'8BIM' + struct.pack('>H', 1000) + b'\x03abc'
           + struct.pack('>I', 3) + b'xyz\x00')
    out += struct.pack('>I', len(res)) + res
    lay = bytes(8)
    out += struct.pack('>I', len(lay)) + lay
    out += struct.pack('>H', compression)
    if compression == 0:
        out += planes.tobytes()
    else:
        packed, lengths = packbits(planes.reshape(ch * h, row))
        out += lengths.astype('>u2').tobytes() + packed
    return bytes(out)


def psd_fixtures(lab: bool = False) -> dict:
    """{file name: bytes} of PSD composites in every mode PIL reads, raw
    and PackBits; Lab ones (which the port refuses) only with ``lab``."""
    pic = picture(13, 21, 4, seed=50, runs=6)
    rs = np.random.RandomState(51)
    palette = rs.randint(0, 256, (256, 3)).astype(np.uint8)
    bits = np.packbits(picture(13, 21, 1, seed=52, runs=5)[..., 0] > 128,
                       axis=1)
    layouts = {
        'bitmap': bits[None],
        'grey': pic[None, ..., 0],
        'indexed': (pic[None, ..., 1] % 64),
        'rgb': pic[..., :3].transpose(2, 0, 1),
        'rgba': pic.transpose(2, 0, 1),
        'cmyk': pic.transpose(2, 0, 1),
        'multichannel': pic[..., :2].transpose(2, 0, 1),
        'duotone': pic[None, ..., 2],
        'lab': pic[..., :3].transpose(2, 0, 1),
    }
    out = {}
    for name, planes in layouts.items():
        if name == 'lab' and not lab:
            continue
        mode = 'rgb' if name == 'rgba' else name
        colour = palette.T.tobytes() if name == 'indexed' else b''
        for comp in (0, 1):
            out[f'psd_{name}_{("raw", "packbits")[comp]}.psd'] = encode_psd(
                np.ascontiguousarray(planes), mode, comp, width=21,
                colour_data=colour)
    return out


def _grey_palette(n):
    return np.stack([np.linspace(0, 255, n)] * 3, 1).astype(np.uint8)


def _palette(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 3)).astype(np.uint8)


def hand_fixtures() -> dict:
    """{file name: bytes} of the fixtures written by the encoders here."""
    rs = np.random.RandomState(11)
    pic = picture(19, 23, 3, seed=1)
    pic4 = picture(19, 23, 4, seed=2)
    grey = picture(19, 23, 1, seed=3)
    out = {}
    # PNG: bit depths, colour types, filters, Adam7, palettes
    for depth in (1, 2, 4, 8, 16):
        top = (1 << depth) - 1
        s = (grey.astype(np.int64) * top // 255) if depth < 16 else \
            grey.astype(np.int64) * 257 + rs.randint(0, 257, grey.shape)
        if depth == 16:
            s[:4] = rs.randint(0, 300, s[:4].shape)     # values around 255
        out[f'png_grey{depth}.png'] = encode_png(s, depth, 0)
        out[f'png_grey{depth}_adam7.png'] = encode_png(s, depth, 0, True)
    s16 = pic.astype(np.int64) * 257 + rs.randint(0, 257, pic.shape)
    out['png_rgb16.png'] = encode_png(s16, 16, 2)
    out['png_rgb16_adam7.png'] = encode_png(s16, 16, 2, True)
    out['png_rgba16.png'] = encode_png(
        pic4.astype(np.int64) * 257 + rs.randint(0, 257, pic4.shape), 16, 6)
    la = np.concatenate([grey, pic4[..., 3:]], -1)
    out['png_la8_adam7.png'] = encode_png(la, 8, 4, True)
    out['png_la16.png'] = encode_png(la.astype(np.int64) * 257, 16, 4)
    out['png_rgb8_adam7.png'] = encode_png(pic, 8, 2, True)
    out['png_rgba8_adam7.png'] = encode_png(pic4, 8, 6, True)
    for f, name in enumerate(('none', 'sub', 'up', 'average', 'paeth')):
        out[f'png_filter_{name}.png'] = encode_png(pic, 8, 2, filters=f)
    idx = rs.randint(0, 16, (19, 23, 1))
    for depth in (1, 2, 4, 8):
        n = 1 << depth
        ix = idx % n
        out[f'png_palette{depth}.png'] = encode_png(ix, depth, 3,
                                                    palette=_palette(n, depth))
    out['png_palette4_adam7.png'] = encode_png(idx, 4, 3, True,
                                               palette=_palette(16, 4))
    out['png_palette8_trns.png'] = encode_png(
        idx, 8, 3, palette=_palette(16, 8),
        trns=bytes(rs.randint(0, 256, 12).astype(np.uint8)))
    out['png_palette_short.png'] = encode_png(idx, 8, 3,
                                              palette=_palette(10, 9))
    out['png_grey8_trns.png'] = encode_png(grey, 8, 0, trns=b'\x00\x80')
    out['png_rgb8_trns.png'] = encode_png(pic, 8, 2,
                                          trns=b'\x00\x01\x00\x02\x00\x03')
    out['png_multi_idat.png'] = encode_png(pic, 8, 2, idat_parts=4)
    # TGA: image types, depths, origins, colour maps
    bgr = pic[..., ::-1]
    bgra = pic4[..., [2, 1, 0, 3]]
    word = (rs.randint(0, 1 << 16, (19, 23)).astype('<u2').view(np.uint8)
            .reshape(19, 23, 2))
    for itype in (2, 10):
        r = 'rle' if itype > 8 else 'raw'
        out[f'tga_rgb24_{r}.tga'] = encode_tga(bgr, itype, 24)
        out[f'tga_rgba32_{r}.tga'] = encode_tga(bgra, itype, 32)
        out[f'tga_rgb16_{r}.tga'] = encode_tga(word, itype, 16)
        out[f'tga_rgb24_{r}_bottom.tga'] = encode_tga(bgr, itype, 24, top=False)
    out['tga_grey1.tga'] = encode_tga(grey > 127, 3, 1)
    out['tga_rgb24_mirror.tga'] = encode_tga(bgr, 2, 24, top=False,
                                             mirror=True, image_id=b'abc')
    out['tga_rgba32_rle_runs.tga'] = encode_tga(
        picture(21, 300, 4, seed=5, runs=200)[..., [2, 1, 0, 3]], 10, 32)
    for itype in (3, 11):
        r = 'rle' if itype > 8 else 'raw'
        out[f'tga_grey8_{r}.tga'] = encode_tga(grey, itype, 8, top=itype == 3)
        out[f'tga_la16_{r}.tga'] = encode_tga(la, itype, 16)
    for itype in (1, 9):
        r = 'rle' if itype > 8 else 'raw'
        cm = _palette(16, itype)[:, ::-1]
        out[f'tga_cmap24_{r}.tga'] = encode_tga(idx.astype(np.uint8), itype,
                                                8, cmap=cm)
        out[f'tga_cmap24_{r}_bottom_mirror.tga'] = encode_tga(
            idx.astype(np.uint8), itype, 8, top=False, mirror=True, cmap=cm)
    out['tga_cmap16_start.tga'] = encode_tga(
        (idx + 4).astype(np.uint8), 1, 8, cmap_start=4, cmap_depth=16,
        cmap=rs.randint(0, 1 << 16, 16).astype('<u2').view(np.uint8)
        .reshape(16, 2))
    # BMP: palettes, RLE, bit fields, header versions, top-down
    i8 = rs.randint(0, 256, (19, 23))
    for bits, n in ((1, 2), (4, 16), (8, 256)):
        ix = i8 % n
        out[f'bmp_pal{bits}.bmp'] = encode_bmp(ix, bits, _palette(n, bits))
    out['bmp_pal8_core.bmp'] = encode_bmp(i8, 8, _palette(256, 3), header=12)
    out['bmp_pal4_core.bmp'] = encode_bmp(i8 % 16, 4, _palette(16, 5),
                                          header=12)
    out['bmp_pal8_short.bmp'] = encode_bmp(i8 % 40, 8, _palette(40, 6),
                                           colors=40)
    out['bmp_grey8.bmp'] = encode_bmp(i8, 8, _grey_palette(256))
    out['bmp_bw1.bmp'] = encode_bmp(i8 % 2, 1, _grey_palette(2))
    out['bmp_pal8_topdown.bmp'] = encode_bmp(i8, 8, _palette(256, 7),
                                             top_down=True)
    rle_src = picture(21, 37, 1, seed=8, runs=12)[..., 0] // 16
    rle_src[5:9, 10:30] = 3
    out['bmp_rle8.bmp'] = encode_bmp(rle_src * 7, 8, _palette(256, 10),
                                     compression=1)
    out['bmp_rle4.bmp'] = encode_bmp(rle_src, 4, _palette(16, 12),
                                     compression=2)
    half = rle_src.copy()
    half[:, 18:] = 0
    out['bmp_rle8_delta.bmp'] = encode_bmp(half * 5, 8, _palette(256, 14),
                                           compression=1, deltas=True)
    out['bmp_rle8_topdown.bmp'] = encode_bmp(rle_src * 3, 8, _palette(256, 13),
                                             compression=1, top_down=True)
    out['bmp_rgb24.bmp'] = encode_bmp(bgr, 24)
    out['bmp_rgb24_topdown_v5.bmp'] = encode_bmp(bgr, 24, header=124,
                                                 top_down=True)
    out['bmp_rgbx32.bmp'] = encode_bmp(bgra, 32)
    out['bmp_rgb16_555.bmp'] = encode_bmp(word.view('<u2')[..., 0], 16)
    out['bmp_rgb16_565_bitfields.bmp'] = encode_bmp(
        word.view('<u2')[..., 0], 16, compression=3,
        masks=(0xF800, 0x7E0, 0x1F))
    out['bmp_rgba32_bitfields_v4.bmp'] = encode_bmp(
        bgra, 32, header=108, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    out['bmp_xbgr32_bitfields.bmp'] = encode_bmp(
        bgra[..., [3, 0, 1, 2]], 32, compression=3,
        masks=(0xFF000000, 0xFF0000, 0xFF00))
    # GIF: palettes, interlace, offsets, transparency, clears
    gi = rs.randint(0, 16, (21, 27)).astype(np.uint8)
    gi[3:9, 4:20] = 5
    out['gif_global.gif'] = encode_gif(gi, _palette(16, 20))
    out['gif_local.gif'] = encode_gif(gi, _palette(16, 21),
                                      local_palette=_palette(16, 22))
    out['gif_interlaced.gif'] = encode_gif(gi, _palette(16, 23),
                                           interlace=True)
    out['gif_grey_palette.gif'] = encode_gif(gi % 4, _grey_palette(4))
    out['gif_identity_ramp.gif'] = encode_gif(gi % 4, np.repeat(
        np.arange(4, dtype=np.uint8)[:, None], 3, 1), version=b'GIF87a')
    out['gif_offset.gif'] = encode_gif(gi, _palette(16, 24), screen=(33, 25),
                                       offset=(3, 2), transparency=7)
    out['gif_clears_8bit.gif'] = encode_gif(
        rs.randint(0, 256, (24, 30)).astype(np.uint8), _palette(256, 25),
        clear_every=100)
    out['gif_full_table.gif'] = encode_gif(
        rs.randint(0, 4, (64, 80)).astype(np.uint8), _palette(4, 26))
    # PNM: P1-P6, maxvals
    bw = (grey[..., :1] > 127).astype(np.int64)
    out['pnm_p1.pbm'] = encode_pnm(bw, 1)
    out['pnm_p4.pbm'] = encode_pnm(bw, 4)
    out['pnm_p2.pgm'] = encode_pnm(grey.astype(np.int64), 2)
    out['pnm_p2_maxval100.pgm'] = encode_pnm(grey.astype(np.int64) * 100 // 255,
                                             2, 100)
    out['pnm_p3.ppm'] = encode_pnm(pic.astype(np.int64), 3)
    out['pnm_p5.pgm'] = encode_pnm(grey, 5)
    out['pnm_p5_maxval1000.pgm'] = encode_pnm(grey.astype(np.int64) * 4, 5, 1000)
    out['pnm_p5_16bit.pgm'] = encode_pnm(grey.astype(np.int64) * 2, 5, 65535)
    out['pnm_p6.ppm'] = encode_pnm(pic, 6)
    out['pnm_p6_16bit.ppm'] = encode_pnm(s16, 6, 65535)
    out['pnm_p6_maxval31.ppm'] = encode_pnm(pic.astype(np.int64) // 8, 6, 31)
    return out


def pil_fixtures() -> dict:
    """{file name: bytes} of the fixtures PIL writes."""
    from PIL import Image
    rs = np.random.RandomState(12)
    pic = picture(17, 29, 3, seed=30)
    pic4 = picture(17, 29, 4, seed=31)
    out = {}

    def save(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()
    rgb = Image.fromarray(pic)
    pal = rgb.quantize(32)
    out['pil_rgb.png'] = save(rgb, 'PNG')
    out['pil_rgba.png'] = save(Image.fromarray(pic4), 'PNG')
    out['pil_l.png'] = save(rgb.convert('L'), 'PNG')
    out['pil_la.png'] = save(Image.fromarray(pic4).convert('LA'), 'PNG')
    out['pil_1.png'] = save(rgb.convert('1'), 'PNG')
    out['pil_p.png'] = save(pal, 'PNG')
    out['pil_p_bits2.png'] = save(rgb.quantize(4), 'PNG', bits=2)
    pt = pal.copy()
    pt.info['transparency'] = 3
    out['pil_p_trns.png'] = save(pt, 'PNG', transparency=3)
    out['pil_i16.png'] = save(Image.fromarray(
        (rs.randint(0, 1200, (17, 29))).astype(np.uint16)), 'PNG')
    out['pil_rgb.tga'] = save(rgb, 'TGA')
    out['pil_rgba_rle.tga'] = save(Image.fromarray(pic4), 'TGA', rle=True)
    out['pil_l_rle.tga'] = save(rgb.convert('L'), 'TGA', rle=True)
    out['pil_p.tga'] = save(pal, 'TGA')
    out['pil_rgb.bmp'] = save(rgb, 'BMP')
    out['pil_rgba.bmp'] = save(Image.fromarray(pic4), 'BMP')
    out['pil_p.bmp'] = save(pal, 'BMP')
    out['pil_l.bmp'] = save(rgb.convert('L'), 'BMP')
    out['pil_1.bmp'] = save(rgb.convert('1'), 'BMP')
    out['pil_p.gif'] = save(pal, 'GIF')
    out['pil_l.gif'] = save(rgb.convert('L'), 'GIF')
    out['pil_interlaced.gif'] = save(pal, 'GIF', interlace=True)
    out['pil_rgb.ppm'] = save(rgb, 'PPM')
    out['pil_l.pgm'] = save(rgb.convert('L'), 'PPM')
    out['pil_1.pbm'] = save(rgb.convert('1'), 'PPM')
    return out


def refused() -> dict:
    """{name: (file bytes, file name, the exception the port raises)} of
    files PIL refuses too: the JAX package raises the same kind of error
    (ValueError, which the skydome search skips, or an error it does not
    skip) or, for the formats of ``PIL_ONLY``, reads a format the port does
    not."""
    pic = picture(8, 8, 3, seed=40)
    idx = np.arange(64, dtype=np.uint8).reshape(8, 8, 1) % 16
    png = encode_png(pic, 8, 2)
    ihdr_at = png.index(b'IHDR')
    bad_crc = bytearray(png)
    bad_crc[ihdr_at + 17] ^= 1
    bad_filter = encode_png(pic, 8, 2, filters=4)
    z = zlib.decompress(bad_filter[bad_filter.index(b'IDAT') + 4:-16])
    z = bytes([7]) + z[1:]
    bad_filter = (png[:ihdr_at + 21] + png_chunk(b'IDAT', zlib.compress(z))
                  + png_chunk(b'IEND', b''))
    gif = encode_gif(idx[..., 0], _palette(16, 41))
    return {
        'truncated PNG': (png[:len(png) // 2], 'sky.png', OSError),
        'PNG with a bad header CRC': (bytes(bad_crc), 'sky.png', OSError),
        'PNG with filter type 7': (bad_filter, 'sky.png', OSError),
        'PNG with a short IHDR': (
            png[:8] + png_chunk(b'IHDR', png[ihdr_at + 4:ihdr_at + 14])
            + png[ihdr_at + 21:], 'sky.png', ValueError),
        'PNG without IDAT': (png[:ihdr_at + 21] + png_chunk(b'IEND', b''),
                             'sky.png', OSError),
        'TGA with a 32-bit colour map': (
            encode_tga(idx, 1, 8, cmap=np.full((16, 4), 9, np.uint8),
                       cmap_depth=32), 't.tga', ValueError),
        'TGA of 1-bit RLE': (encode_tga(idx % 2, 11, 1), 't.tga', OSError),
        'TGA of 15 bits': (encode_tga(np.zeros((8, 8, 2), np.uint8), 2, 15),
                           't.tga', OSError),
        'TGA type 1 without a colour map': (encode_tga(idx, 1, 8), 't.tga',
                                            ValueError),
        'truncated TGA': (encode_tga(pic, 2, 24)[:100], 't.tga', OSError),
        'BMP RLE ending early': (
            encode_bmp(idx[..., 0], 8, _palette(256, 42), compression=1)[:-40],
            't.bmp', ValueError),
        'BMP with an unknown compression': (
            encode_bmp(idx[..., 0], 8, _palette(256, 43), compression=4),
            't.bmp', OSError),
        'truncated BMP': (encode_bmp(pic, 24)[:-30], 't.bmp', OSError),
        'truncated GIF': (gif[:len(gif) - 12], 't.gif', OSError),
        'GIF without an image': (gif[:gif.index(b',')] + b';', 't.gif',
                                 OSError),
        'PNM with maxval 0': (b'P5 2 2 0 abcd', 't.pgm', ValueError),
        'PNM with a bad token': (b'P2 2 2 9 1 2 x 4', 't.pgm', ValueError),
        'truncated P6': (encode_pnm(pic, 6)[:-5], 't.ppm', OSError),
    }


def fixtures() -> dict:
    return {**hand_fixtures(), **psd_fixtures(), **pil_fixtures()}


def pil_load(data: bytes):
    """(PIL's mode, the JAX ``load_image``'s uint8 pixels [H, W, C]) of a
    file's bytes."""
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        mode = im.mode
        if mode not in KEPT:
            im = im.convert('RGB')
        arr = np.asarray(im)
    return mode, (arr[..., None] if arr.ndim == 2 else arr)


def write_fixtures(directory: str):
    """Write every fixture and ``digests.json`` (PIL's mode, the shape and
    SHA-256 of the JAX ``load_image``'s pixels, the Pillow version) into
    ``directory``."""
    import PIL
    os.makedirs(directory, exist_ok=True)
    digests = {}
    for name, data in sorted(fixtures().items()):
        with open(os.path.join(directory, name), 'wb') as f:
            f.write(data)
        mode, px = pil_load(data)
        digests[name] = {'mode': mode, 'shape': list(px.shape),
                         'sha256': digest(px)}
    with open(os.path.join(directory, 'digests.json'), 'w') as f:
        json.dump({'pillow': PIL.__version__, 'files': digests}, f, indent=1,
                  sort_keys=True)
        f.write('\n')


if __name__ == '__main__':
    write_fixtures(sys.argv[1])
