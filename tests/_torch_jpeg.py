"""JPEG files for the port's decoder tests (``tests/test_torch_jpeg.py``)
and ``chip_smoke.py``, written here with PIL (libjpeg-turbo) and, for the
layouts PIL does not write, with the encoders of this module:
:func:`encode_baseline` (sampling factors 1-4, grey, YCbCr, RGB, CMYK,
YCCK), :func:`encode_arithmetic` (the same quantized coefficients,
sequential or with libjpeg's progression, restarts, DAC) and
:func:`encode_lossless` (SOF3). Their default tables are constants, so
they run without PIL, as ``chip_smoke.py`` runs them on the machine with
the card.

:func:`write_fixtures` writes the committed fixtures of ``tests/data/jpeg``
and their ``digests.json``: for each file the shape and the SHA-256 of
PIL's decode (uint8 [H, W, C], C = 1 for grey, 4 for CMYK as PIL reads
it). ``chip_smoke.py`` holds the port's decoder to those digests on the
machine with the card, which has no PIL. Run it again only to change the
fixtures (the existing ones come out byte-identical):

    python tests/_torch_jpeg.py tests/data/jpeg

:func:`refused` makes the files of the features the decoder once refused
and :func:`pil_refuses` more files PIL refuses, by editing markers.
"""
import hashlib
import io
import json
import os
import sys

import numpy as np

# zigzag index -> natural index
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def picture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """uint8 [h, w, 3]: smooth colour waves with noise, edges and flat
    areas (so the IDCT clamps and every upsampling weight matters)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([np.sin(x / 7.0 + c) * 90 + np.cos(y / 5.0 - c) * 60
                     + 128 for c in range(3)], -1)
    base[(x // 9 + y // 7) % 5 == 0] = (250, 5, 128)
    return np.clip(base + rs.randn(h, w, 3) * 25, 0, 255).astype(np.uint8)


def smooth_picture(h: int, w: int, seed: int = 0, c: int = 3) -> np.ndarray:
    """uint8 [h, w, c]: broad waves and a vertical gradient with faint
    noise, a sky's content (few coefficients, so the encoders here write
    4096x2048 in seconds)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([np.sin(x / (w / 5) + k + rs.rand()) * 60
                     + np.cos(y / (h / 3) - k) * 50 + 128 + 40 * (y / h)
                     for k in range(c)], -1)
    return np.clip(base + rs.randn(h, w, c) * 2, 0, 255).astype(np.uint8)


# (name, height, width, grey, PIL save options)
PIL_FIXTURES = [
    ('baseline_444', 23, 37, False, dict(quality=90, subsampling=0)),
    ('baseline_422', 23, 37, False, dict(quality=75, subsampling=1)),
    ('baseline_420', 23, 37, False, dict(quality=75, subsampling=2)),
    ('progressive_420', 48, 64, False, dict(quality=80, subsampling=2,
                                            progressive=True)),
    ('progressive_444', 17, 9, False, dict(quality=95, subsampling=0,
                                           progressive=True)),
    ('grey', 23, 37, True, dict(quality=85)),
    ('grey_progressive', 40, 24, True, dict(quality=60, progressive=True)),
    ('restart_420', 40, 72, False, dict(quality=70, subsampling=2,
                                        restart_marker_blocks=3)),
    ('optimized_422', 33, 50, False, dict(quality=50, subsampling=1,
                                          optimize=True)),
    ('adobe_rgb', 19, 21, False, dict(quality=90, keep_rgb=True)),
    ('tiny_1x1', 1, 1, False, dict(quality=75, subsampling=2)),
    ('odd_17x9', 9, 17, False, dict(quality=75, subsampling=2)),
    ('sky_256x128', 128, 256, False, dict(quality=85, subsampling=2)),
]
# (name, height, width, sampling factors per component, component ids)
BASELINE_FIXTURES = [
    ('h1v2_440', 21, 30, [(1, 2), (1, 1), (1, 1)], (1, 2, 3)),
    ('chroma_wider', 18, 27, [(1, 1), (2, 2), (1, 2)], (1, 2, 3)),
    ('rgb_ids', 16, 20, [(1, 1), (1, 1), (1, 1)], (82, 71, 66)),
]


def save_pil(img: np.ndarray, grey: bool, **options) -> bytes:
    from PIL import Image
    im = Image.fromarray(img)
    if grey:
        im = im.convert('L')
    buf = io.BytesIO()
    im.save(buf, 'JPEG', bufsize=1 << 20, **options)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    """PIL's pixels of a JPEG, uint8 [H, W, C]."""
    from PIL import Image
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return arr[..., None] if arr.ndim == 2 else arr


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.uint8).tobytes()
                          ).hexdigest()


def _segments(data: bytes):
    """(marker, payload) of the segments before the first scan."""
    pos = 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], 'big')
        yield data[pos + 1], data[pos + 4:pos + 2 + n]
        pos += 2 + n


# T.81 Annex K: the example quantization tables (natural order) and the
# standard Huffman tables, which libjpeg writes by default
ANNEX_K_QUANT = {
    0: [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    1: [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32}
ANNEX_K_HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], list(bytes.fromhex(
        '01020300041105122131410613516107227114328191a1082342b1c11552d1f0'
        '2433627282090a161718191a25262728292a3435363738393a43444546474849'
        '4a535455565758595a636465666768696a737475767778797a83848586878889'
        '8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5'
        'c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8'
        'f9fa'))),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], list(bytes.fromhex(
        '000102031104052131061241510761711322328108144291a1b1c109233352f0'
        '156272d10a162434e125f11718191a262728292a35363738393a434445464748'
        '494a535455565758595a636465666768696a737475767778797a828384858687'
        '88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3'
        'c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8'
        'f9fa'))),
}


def _std_tables(quality: int = 90):
    """libjpeg's default tables at ``quality`` (jcparam.c: the Annex K
    tables scaled by 200 - 2 quality percent, clamped to 1-255):
    {0, 1: natural-order quant} and {(class, id): (counts, values)}."""
    scale = 200 - 2 * quality if quality >= 50 else 5000 // quality
    quant = {t: np.clip((np.array(q, np.int64) * scale + 50) // 100, 1, 255)
             for t, q in ANNEX_K_QUANT.items()}
    return quant, ANNEX_K_HUFFMAN


def pil_tables():
    """The quantization and Huffman tables of a PIL file at quality 90, as
    :func:`_std_tables` returns them."""
    data = save_pil(picture(16, 16), False, quality=90, subsampling=0)
    quant, huff = {}, {}
    for m, p in _segments(data):
        i = 0
        while m == 0xDB and i < len(p):
            q = np.zeros(64, np.int64)
            q[NATURAL] = list(p[i + 1:i + 65])
            quant[p[i] & 15] = q
            i += 65
        while m == 0xC4 and i < len(p):
            counts = list(p[i + 1:i + 17])
            n = sum(counts)
            huff[(p[i] >> 4, p[i] & 15)] = (counts, list(p[i + 17:i + 17 + n]))
            i += 17 + n
    return quant, huff


def _codes(counts, values):
    """symbol -> (code, length) of a JPEG Huffman table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


# Colour kinds of the encoders: the planes written and the markers that
# tell a decoder what they are. 'ycc': YCbCr with a JFIF marker; 'rgb': the
# RGB planes, ids 'R' 'G' 'B', no marker; 'cmyk': four planes as given (no
# marker, or an Adobe marker of transform 0 with ``adobe``); 'ycck': the
# YCbCr of (255 - C, 255 - M, 255 - Y) and K as given, with an Adobe marker
# of transform 2. libjpeg reads four components as CMYK unless an Adobe
# marker says otherwise, and PIL inverts what it reads.
KIND_IDS = {'ycc': (1, 2, 3), 'rgb': (82, 71, 66), 'cmyk': (1, 2, 3, 4),
            'ycck': (1, 2, 3, 4), 'grey': (1,)}


def _ycc(r, g, b):
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


def _planes(img: np.ndarray, kind: str):
    f = img.astype(np.float64)
    if kind in ('rgb', 'cmyk', 'grey'):
        return [f[..., i] for i in range(f.shape[-1])]
    if kind == 'ycck':
        return _ycc(255 - f[..., 0], 255 - f[..., 1], 255 - f[..., 2]) \
            + [f[..., 3]]
    return _ycc(f[..., 0], f[..., 1], f[..., 2])


def _layout(h: int, w: int, factors, unit: int):
    """(hmax, vmax, MCUs across, MCUs down) of a frame."""
    hmax = max(a for a, _ in factors)
    vmax = max(b for _, b in factors)
    return hmax, vmax, -(-w // (unit * hmax)), -(-h // (unit * vmax))


def _sampled(planes, factors, h, w, unit):
    """Each plane padded by edge replication to the MCU grid and box-
    averaged to its component's sampling: [mcuy * v * unit, mcux * h *
    unit] float arrays."""
    hmax, vmax, mcux, mcuy = _layout(h, w, factors, unit)
    out = []
    for plane, (fh, fv) in zip(planes, factors):
        full = np.pad(plane, ((0, mcuy * unit * vmax - h),
                              (0, mcux * unit * hmax - w)), mode='edge')
        sh, sv = hmax // fh, vmax // fv
        out.append(full.reshape(full.shape[0] // sv, sv, full.shape[1] // sh,
                                sh).mean(axis=(1, 3)))
    return out


def quantized(img: np.ndarray, factors, kind: str = 'ycc'):
    """The quantized DCT coefficients of ``img`` (uint8 [h, w, 3] RGB, or
    [h, w, 4] file CMYK) at libjpeg's default tables of quality 90, as the
    encoders write them: one int array [blocks down, blocks across, 64] per
    component in zigzag order, over the whole MCU grid. Component 0 takes
    quantization and entropy table 0, the others table 1."""
    quant, _ = _std_tables()
    h, w = img.shape[:2]
    k = np.arange(8)
    dct = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) \
        * np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    out = []
    for c, small in enumerate(_sampled(_planes(img, kind), factors, h, w, 8)):
        t = min(c, 1)
        by, bx = small.shape[0] // 8, small.shape[1] // 8
        q = np.zeros((by, bx, 64), np.int64)
        for y in range(by):
            for x in range(bx):
                blk = small[y * 8:y * 8 + 8, x * 8:x * 8 + 8] - 128
                coef = (dct @ blk @ dct.T).ravel()
                q[y, x] = np.round(coef / quant[t]).astype(np.int64)[NATURAL]
        out.append(q)
    return out


def _segment(marker: int, payload: bytes) -> bytes:
    return (bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, 'big')
            + bytes(payload))


def _header(h, w, factors, kind, sof, adobe=False, huffman=None, dac=None,
            restart=0, tables=(0, 1), ids=None) -> bytearray:
    """SOI and the segments before the first scan: JFIF (YCbCr) or Adobe
    (YCCK, or CMYK with ``adobe``) marker, quantization tables, the frame
    header of marker ``sof``, Huffman tables ({(class, id): (counts,
    values)}), DAC conditioning ([(class, id, value)]) and DRI."""
    quant, _ = _std_tables()
    ids = ids or KIND_IDS[kind]
    out = bytearray(b'\xff\xd8')
    if kind == 'ycc':
        out += _segment(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')
    if kind == 'ycck' or adobe:
        transform = {'ycck': 2, 'ycc': 1}.get(kind, 0)
        out += _segment(0xEE, b'Adobe\x00\x64\x00\x00\x00\x00'
                        + bytes([transform]))
    for t in tables:
        out += _segment(0xDB, bytes([t]) + bytes(int(v) for v in
                                                 quant[t][NATURAL]))
    frame = bytes([8]) + h.to_bytes(2, 'big') + w.to_bytes(2, 'big') + \
        bytes([len(factors)])
    for i, (fh, fv) in enumerate(factors):
        frame += bytes([ids[i], (fh << 4) | fv, min(i, 1) if sof != 0xC3
                        else 0])
    out += _segment(sof, frame)
    for (tc, th), (counts, values) in sorted((huffman or {}).items()):
        out += _segment(0xC4, bytes([(tc << 4) | th] + list(counts)
                                    + list(values)))
    if dac:
        out += _segment(0xCC, b''.join(bytes([(tc << 4) | tb, v])
                                       for tc, tb, v in dac))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, 'big'))
    return out


def _sos(ids, tables, ss, se, ah, al) -> bytes:
    """A scan header: components ``ids`` with (DC, AC) ``tables``."""
    body = bytes([len(ids)])
    for i, (td, ta) in zip(ids, tables):
        body += bytes([i, (td << 4) | ta])
    return _segment(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def encode_baseline(img: np.ndarray, factors, ids=(1, 2, 3),
                    kind: str = None, adobe: bool = False) -> bytes:
    """A baseline JPEG of uint8 ``img`` (RGB [h, w, 3], CMYK [h, w, 4] or
    grey [h, w, 1]) with any sampling factors of 1 to 4 (``factors``: (h,
    v) per component), libjpeg's default tables at quality 90. ``kind``
    (see :data:`KIND_IDS`) defaults to YCbCr for three channels unless the
    ids are 'R' 'G' 'B', to CMYK for four and to grey for one."""
    _, huff = _std_tables()
    if kind is None:
        kind = {1: 'grey', 4: 'cmyk'}.get(img.shape[-1]) or \
            ('rgb' if tuple(ids) == KIND_IDS['rgb'] else 'ycc')
    h, w = img.shape[:2]
    blocks = quantized(img, factors, kind)
    out = _header(h, w, factors, kind, 0xC0, adobe, huffman=huff)
    n = len(factors)
    ids = KIND_IDS[kind]
    out += _sos(ids[:n], [(min(i, 1), min(i, 1)) for i in range(n)], 0, 63,
                0, 0)
    dc_codes = {t: _codes(*huff[(0, t)]) for t in (0, 1)}
    ac_codes = {t: _codes(*huff[(1, t)]) for t in (0, 1)}
    bw = _BitWriter()
    pred = [0] * n
    hmax, vmax, mcux, mcuy = _layout(h, w, factors, 8)

    def emit(codes, sym):
        bw.put(*codes[sym])

    for my in range(mcuy):
        for mx in range(mcux):
            for c, (fh, fv) in enumerate(factors):
                t = min(c, 1)
                for by in range(fv):
                    for bx in range(fh):
                        q = blocks[c][my * fv + by, mx * fh + bx]
                        s, bits = _magnitude(int(q[0]) - pred[c])
                        pred[c] = int(q[0])
                        emit(dc_codes[t], s)
                        bw.put(bits, s)
                        run = 0
                        for v in q[1:]:
                            if v == 0:
                                run += 1
                                continue
                            while run > 15:
                                emit(ac_codes[t], 0xF0)
                                run -= 16
                            s, bits = _magnitude(int(v))
                            emit(ac_codes[t], (run << 4) | s)
                            bw.put(bits, s)
                            run = 0
                        if run:
                            emit(ac_codes[t], 0x00)
    bw.flush()
    out.extend(bw.out)
    out.extend(b'\xff\xd9')
    return bytes(out)


def _magnitude(v: int):
    """(category, appended bits) of a JPEG difference or coefficient."""
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


# ---- arithmetic coding (T.81 Annex D and F.1.4, as libjpeg's jcarith.c) ----

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS), and
# libjpeg's entry 113, a fixed estimate of 0.5
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
# per state: (Qe, state after an LPS with the MPS flip in bit 7, state
# after an MPS)
_QE = [(qe, nl | (sw << 7), nm) for qe, nl, nm, sw in QE_TABLE]


class _ArithWriter:
    """The QM encoder of jcarith.c: ``encode(stats, i, bit)`` codes one
    decision in statistics bin ``stats[i]`` (a list of state bytes: index
    in bits 0-6, the MPS in bit 7)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = \
            0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out.extend(bytes(self.zc))
        self.zc = 0

    def _byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nl, nm = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:       # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:                    # the more probable symbol
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:              # renormalization and output, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _flush_stack(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer)
        if self.sc:
            self._zeros()
            self.out.extend(b'\xff\x00' * self.sc)
            self.sc = 0

    def finish(self):
        """Termination, D.1.8: the shortest tail that decodes the same."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stack()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)


class _ArithStats:
    """The statistics of one scan: DC and AC bins per table, the DC
    predictions and conditioning of each scan component, DAC's L, U and
    Kx."""

    def __init__(self, dac):
        self.L = {t: 0 for t in range(16)}
        self.U = {t: 1 for t in range(16)}
        self.K = {t: 5 for t in range(16)}
        for tc, tb, v in dac or ():
            if tc:
                self.K[tb] = v
            else:
                self.L[tb], self.U[tb] = v & 15, v >> 4
        self.fixed = [113]

    def reset(self, n):
        self.dc = {t: [0] * 64 for t in range(16)}
        self.ac = {t: [0] * 256 for t in range(16)}
        self.last, self.ctx = [0] * n, [0] * n


def _arith_dc(w, st, i, tbl, v):
    """F.1.4.1: DC difference ``v`` of scan component ``i``."""
    bins, s = st.dc[tbl], st.ctx[i]
    if v == 0:
        w.encode(bins, s, 0)
        st.ctx[i] = 0
        return
    w.encode(bins, s, 1)
    if v > 0:
        w.encode(bins, s + 1, 0)
        at, st.ctx[i] = s + 2, 4
    else:
        v = -v
        w.encode(bins, s + 1, 1)
        at, st.ctx[i] = s + 3, 8
    m = 0
    v -= 1
    if v:
        w.encode(bins, at, 1)
        m, v2, at = 1, v, 20
        v2 >>= 1
        while v2:
            w.encode(bins, at, 1)
            m <<= 1
            at += 1
            v2 >>= 1
    w.encode(bins, at, 0)
    if m < (1 << st.L[tbl]) >> 1:
        st.ctx[i] = 0
    elif m > (1 << st.U[tbl]) >> 1:
        st.ctx[i] += 8
    at += 14
    m >>= 1
    while m:
        w.encode(bins, at, 1 if m & v else 0)
        m >>= 1


def _arith_magnitude(w, st, tbl, bins, at, k, v):
    """F.1.4.2: the magnitude of an AC value ``v`` > 0 at index ``k``."""
    m = 0
    v -= 1
    if v:
        w.encode(bins, at, 1)
        m, v2 = 1, v >> 1
        if v2:
            w.encode(bins, at, 1)
            m <<= 1
            at = 189 if k <= st.K[tbl] else 217
            v2 >>= 1
            while v2:
                w.encode(bins, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
    w.encode(bins, at, 0)
    at += 14
    m >>= 1
    while m:
        w.encode(bins, at, 1 if m & v else 0)
        m >>= 1


def _pt(v: int, al: int) -> int:
    """An AC coefficient after the point transform: division by 2^al
    rounding toward zero."""
    return v >> al if v >= 0 else -((-v) >> al)


def _arith_ac_first(w, st, tbl, blk, ss, se, al):
    bins = st.ac[tbl]
    vals = [_pt(int(x), al) for x in blk]
    ke = se
    while ke > 0 and vals[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        at = 3 * (k - 1)
        w.encode(bins, at, 0)
        while vals[k] == 0:
            w.encode(bins, at + 1, 0)
            at += 3
            k += 1
        w.encode(bins, at + 1, 1)
        w.encode(st.fixed, 0, 1 if vals[k] < 0 else 0)
        _arith_magnitude(w, st, tbl, bins, at + 2, k, abs(vals[k]))
        k += 1
    if k <= se:
        w.encode(bins, 3 * (k - 1), 1)


def _arith_ac_refine(w, st, tbl, blk, ss, se, ah, al):
    bins = st.ac[tbl]
    mags = [abs(int(x)) >> al for x in blk]
    ke = se
    while ke > 0 and mags[ke] == 0:
        ke -= 1
    kex = ke
    while kex > 0 and abs(int(blk[kex])) >> ah == 0:
        kex -= 1
    k = ss
    while k <= ke:
        at = 3 * (k - 1)
        if k > kex:
            w.encode(bins, at, 0)
        while True:
            v = mags[k]
            if v:
                if v >> 1:
                    w.encode(bins, at + 2, v & 1)
                else:
                    w.encode(bins, at + 1, 1)
                    w.encode(st.fixed, 0, 1 if blk[k] < 0 else 0)
                break
            w.encode(bins, at + 1, 0)
            at += 3
            k += 1
        k += 1
    if k <= se:
        w.encode(bins, 3 * (k - 1), 1)


# libjpeg's jpeg_simple_progression for three YCbCr components and for one:
# (components, Ss, Se, Ah, Al)
PROGRESSION_3 = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                 ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                 ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                 ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
PROGRESSION_1 = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                 ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def encode_arithmetic(img: np.ndarray, factors, kind: str = None,
                      progressive: bool = False, restart: int = 0,
                      dac=None, adobe: bool = False, blocks=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with libjpeg's default
    progression) of the quantized coefficients :func:`encode_baseline`
    writes for the same arguments, with a restart marker every ``restart``
    MCUs and DAC conditioning ``dac`` ([(class, table, value)]: DC
    L + 16 U, AC Kx). ``blocks`` (from :func:`quantized`) skips the DCT."""
    if kind is None:
        kind = {1: 'grey', 4: 'cmyk'}.get(img.shape[-1], 'ycc')
    h, w = img.shape[:2]
    if blocks is None:
        blocks = quantized(img, factors, kind)
    n = len(factors)
    ids = KIND_IDS[kind]
    out = _header(h, w, factors, kind, 0xCA if progressive else 0xC9, adobe,
                  dac=dac, restart=restart)
    hmax, vmax, mcux, mcuy = _layout(h, w, factors, 8)
    if not progressive:
        script = [(tuple(range(n)), 0, 63, 0, 0)]
    elif n == 3:
        script = PROGRESSION_3
    else:
        script = [(tuple(range(n)), 0, 0, 0, 1)] + \
            [((c,), *p[1:]) for c in range(n) for p in PROGRESSION_1[1:4]] + \
            [(tuple(range(n)), 0, 0, 1, 0)] + \
            [((c,), 1, 63, 1, 0) for c in range(n)]
    st = _ArithStats(dac)
    for comps, ss, se, ah, al in script:
        out += _sos([ids[c] for c in comps],
                    [(min(c, 1), min(c, 1)) for c in comps], ss, se, ah, al)
        wr = _ArithWriter()
        st.reset(len(comps))
        if len(comps) > 1:
            units = [[(i, c, my * fv + by, mx * fh + bx)
                      for i, c in enumerate(comps)
                      for fh, fv in [factors[c]]
                      for by in range(fv) for bx in range(fh)]
                     for my in range(mcuy) for mx in range(mcux)]
        else:
            c = comps[0]
            fh, fv = factors[c]
            wib, hib = -(-w * fh // (8 * hmax)), -(-h * fv // (8 * vmax))
            units = [[(0, c, by, bx)] for by in range(hib)
                     for bx in range(wib)]
        for u, mcu in enumerate(units):
            if restart and u and u % restart == 0:
                wr.finish()
                out += wr.out + bytes([0xFF, 0xD0 + (u // restart - 1) % 8])
                wr = _ArithWriter()
                st.reset(len(comps))
            for i, c, by, bx in mcu:
                blk = blocks[c][by, bx]
                tbl = min(c, 1)
                if ss == 0 and ah == 0:
                    dcv = int(blk[0]) >> al
                    _arith_dc(wr, st, i, tbl, dcv - st.last[i])
                    st.last[i] = dcv
                elif ss == 0:
                    wr.encode(st.fixed, 0, (int(blk[0]) >> al) & 1)
                if ss == 0 and not progressive:
                    _arith_ac_first(wr, st, tbl, blk, 1, 63, 0)
                elif ss and ah == 0:
                    _arith_ac_first(wr, st, tbl, blk, ss, se, al)
                elif ss:
                    _arith_ac_refine(wr, st, tbl, blk, ss, se, ah, al)
        wr.finish()
        out += wr.out
    out += b'\xff\xd9'
    return bytes(out)


# ---- lossless (SOF3, T.81 Annex H) ----

# a Huffman table of the 17 difference categories: lengths 2, 3 x5, 4..14
LOSSLESS_TABLE = ([0, 1, 5] + [1] * 11 + [0, 0], list(range(17)))


def encode_lossless(img: np.ndarray, factors, predictor: int,
                    point_transform: int = 0, kind: str = None,
                    restart_rows: int = 0) -> bytes:
    """A lossless JPEG (SOF3) of ``img``: one interleaved scan (one
    component for grey [h, w, 1]) with predictor 1-7, a point transform,
    and a restart marker every ``restart_rows`` MCU rows. Samples of
    subsampled components are box averages, rounded."""
    h, w = img.shape[:2]
    if kind is None:
        kind = {1: 'rgb', 4: 'cmyk'}.get(img.shape[-1], 'ycc')
    planes = _planes(img, kind)
    hmax, vmax, mcux, mcuy = _layout(h, w, factors, 1)
    samples = [np.clip(np.round(p), 0, 255).astype(np.int64) >> point_transform
               for p in _sampled(planes, factors, h, w, 1)]
    n = len(factors)
    ids = KIND_IDS[kind][:n] if n > 1 else (1,)
    restart = restart_rows * mcux
    out = _header(h, w, factors, kind if n > 1 else 'rgb', 0xC3,
                  huffman={(0, 0): LOSSLESS_TABLE}, restart=restart,
                  tables=(0,), ids=ids)
    out += _sos(ids, [(0, 0)] * n, predictor, 0, 0, point_transform)
    codes = _codes(*LOSSLESS_TABLE)
    dims = [(-(-w * fh // hmax), -(-h * fv // vmax)) for fh, fv in factors]
    # the differences of each component's rows, as the decoder predicts
    diffs, first = [], True
    for c, (fh, fv) in enumerate(factors):
        s, (dw, dh) = samples[c], dims[c]
        d = np.zeros_like(s)
        for y in range(dh):
            if restart_rows and y % (restart_rows * fv) == 0:
                first = True
            row = s[y, :dw]
            if first or y == 0:
                pred = np.concatenate([[1 << (8 - point_transform - 1)],
                                       row[:-1]])
                first = False
            else:
                up = s[y - 1, :dw]
                ra, rb = np.concatenate([[0], row[:-1]]), up
                rc = np.concatenate([[0], up[:-1]])
                pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                        5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                        7: (ra + rb) >> 1}[predictor]
                pred = np.concatenate([[up[0]], pred[1:]])
            d[y, :dw] = (row - pred + 32768) % 65536 - 32768
        diffs.append(d)
        first = True
    bw = _BitWriter()
    for my in range(mcuy):
        if restart_rows and my and my % restart_rows == 0:
            bw.flush()
            out += bw.out + bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
            bw = _BitWriter()
        for mx in range(mcux):
            for c, (fh, fv) in enumerate(factors):
                for yy in range(fv):
                    for xx in range(fh):
                        v = int(diffs[c][my * fv + yy, mx * fh + xx])
                        s, bits = _magnitude(v)
                        bw.put(*codes[s])
                        bw.put(bits, s)
    bw.flush()
    out += bw.out + b'\xff\xd9'
    return bytes(out)


def progressive_cuts(grey: bool):
    """{name: bytes} of a PIL progressive file cut after each of its scans
    but the last (libjpeg then smooths the blocks whose first coefficients
    are not exact): scans 1-9 of the colour script, 1-5 of the grey one."""
    data = save_pil(picture(40, 56, seed=3), grey, quality=75,
                    progressive=True)
    starts = [i for i in range(len(data) - 1)
              if data[i] == 0xFF and data[i + 1] == 0xDA]
    tag = 'grey' if grey else 'colour'
    return {f'cut_{tag}_{k}': data[:starts[k]] + b'\xff\xd9'
            for k in range(1, len(starts))}


F444, F420 = [(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)]


def cmyk_picture(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 [h, w, 4]: :func:`picture` and a fourth plane."""
    return np.concatenate([picture(h, w, seed),
                           picture(h, w, seed + 1)[..., :1]], -1)


def hand_fixtures() -> dict:
    """{name: bytes} of the layouts PIL does not write: arithmetic coding
    (sequential and progressive, restarts, DAC), CMYK and YCCK with and
    without the Adobe marker, sampling factors 3 and 4, lossless with
    every predictor; and PIL's progressive files cut after each scan."""
    grey = lambda h, w, seed: picture(h, w, seed)[..., :1]
    dac = [(0, 0, 0x21), (0, 1, 0x10), (1, 0, 2), (1, 1, 9)]
    out = {
        'arith_420': encode_arithmetic(picture(27, 38, 200), F420),
        'arith_444_restart_dac': encode_arithmetic(
            picture(24, 35, 201), F444, restart=3, dac=dac),
        'arith_progressive_420': encode_arithmetic(
            picture(33, 41, 202), F420, progressive=True),
        'arith_progressive_restart_dac': encode_arithmetic(
            picture(40, 48, 203), [(2, 1), (1, 1), (1, 1)], progressive=True,
            restart=2, dac=[(0, 0, 0x32), (1, 0, 1), (1, 1, 63)]),
        'arith_grey_progressive': encode_arithmetic(
            grey(30, 26, 204), [(1, 1)], progressive=True, restart=5),
        'arith_h3v2': encode_arithmetic(picture(29, 50, 205),
                                        [(3, 2), (1, 1), (1, 1)]),
        'arith_sky_128x64': encode_arithmetic(
            picture(64, 128, 206), F420, progressive=True, restart=16),
        'cmyk': encode_baseline(cmyk_picture(21, 27, 210), [(1, 1)] * 4),
        'cmyk_adobe': encode_baseline(cmyk_picture(21, 27, 211), [(1, 1)] * 4,
                                      adobe=True),
        'ycck_adobe': encode_baseline(cmyk_picture(22, 31, 212), [(1, 1)] * 4,
                                      kind='ycck'),
        'ycck_adobe_420': encode_baseline(
            cmyk_picture(34, 29, 213), [(2, 2), (1, 1), (1, 1), (2, 2)],
            kind='ycck'),
        'arith_ycck_progressive': encode_arithmetic(
            cmyk_picture(26, 33, 214), [(2, 1), (1, 1), (1, 1), (1, 1)],
            kind='ycck', progressive=True),
        'cmyk_sky_128x64': encode_baseline(
            cmyk_picture(64, 128, 215), [(1, 1)] * 4, adobe=True),
        'h3v1': encode_baseline(picture(23, 50, 220), [(3, 1), (1, 1),
                                                       (1, 1)]),
        'h4v1': encode_baseline(picture(23, 61, 221), [(4, 1), (1, 1),
                                                       (1, 1)]),
        'h4v2': encode_baseline(picture(35, 70, 222), [(4, 2), (1, 1),
                                                       (1, 1)]),
        'h4v1_chroma_h2': encode_baseline(picture(19, 67, 223),
                                          [(4, 1), (2, 1), (1, 1)]),
        'h1v4_chroma_v2': encode_baseline(picture(61, 21, 224),
                                          [(1, 4), (1, 1), (1, 2)]),
        'grey_h3v3': encode_baseline(grey(31, 29, 225), [(3, 3)]),
        'lossless_rgb_p5_pt1_restart': encode_lossless(
            picture(26, 31, 240), F444, 5, 1, kind='rgb', restart_rows=4),
        'lossless_rgb_420': encode_lossless(picture(25, 33, 241), F420, 4,
                                            kind='rgb'),
        'lossless_cmyk_p7': encode_lossless(cmyk_picture(17, 22, 242),
                                            [(1, 1)] * 4, 7),
    }
    for p in range(1, 8):
        out[f'lossless_grey_p{p}'] = encode_lossless(
            grey(19, 23, 230 + p), [(1, 1)], p, p % 3,
            restart_rows=5 if p % 2 else 0)
    out.update(progressive_cuts(False))
    out.update(progressive_cuts(True))
    return out


def fixtures() -> dict:
    """{name: JPEG bytes} of every fixture."""
    out = {}
    for i, (name, h, w, grey, opts) in enumerate(PIL_FIXTURES):
        out[name] = save_pil(picture(h, w, seed=i), grey, **opts)
    for i, (name, h, w, factors, ids) in enumerate(BASELINE_FIXTURES):
        out[name] = encode_baseline(picture(h, w, seed=100 + i), factors, ids)
    out.update(hand_fixtures())
    return out


def write_fixtures(directory: str):
    """Write every fixture as ``name.jpg`` and ``digests.json`` (shape and
    SHA-256 of PIL's decode) into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    digests = {}
    for name, data in fixtures().items():
        with open(os.path.join(directory, f'{name}.jpg'), 'wb') as f:
            f.write(data)
        px = pil_decode(data)
        digests[f'{name}.jpg'] = {'shape': list(px.shape),
                                  'sha256': digest(px)}
    with open(os.path.join(directory, 'digests.json'), 'w') as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write('\n')


def _replace_at(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` bytes after the first ``marker``
    (0xFF xx) set to ``value``."""
    i = data.index(bytes([0xFF, marker]))
    return data[:i + offset] + bytes([value]) + data[i + offset + 1:]


def refused() -> dict:
    """{feature: JPEG bytes} of the files the decoder refused before it
    read arithmetic coding, four components, sampling factors 3 and 4 and
    block smoothing: the named feature marked in an otherwise decodable
    file (CMYK written by PIL; a progressive file cut after its first scans,
    whose coefficients libjpeg then smooths). PIL decodes 'arithmetic'
    (Huffman data read as arithmetic codes), 'sampling' (a 4:4:4 file whose
    luma factor says 4x1), 'four-component' and 'not all refined', and
    refuses the others with OSError."""
    base = save_pil(picture(16, 24), False, quality=80, subsampling=0)
    out = {
        'arithmetic': _replace_at(base, 0xC0, 1, 0xC9),
        '12-bit': _replace_at(base, 0xC0, 4, 12),
        'lossless': _replace_at(base, 0xC0, 1, 0xC3),
        'hierarchical': _replace_at(base, 0xC0, 1, 0xC5),
        'sampling': _replace_at(base, 0xC0, 11, 0x41),
        'DNL': _replace_at(_replace_at(base, 0xC0, 5, 0), 0xC0, 6, 0),
    }
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(picture(16, 24)).convert('CMYK').save(buf, 'JPEG')
    out['four-component'] = buf.getvalue()
    prog = save_pil(picture(32, 32), False, quality=80, progressive=True)
    starts = [i for i in range(len(prog) - 1)
              if prog[i] == 0xFF and prog[i + 1] == 0xDA]
    out['not all refined'] = prog[:starts[3]] + b'\xff\xd9'
    return out


def pil_refuses() -> dict:
    """{case: JPEG bytes} of more files PIL refuses with OSError (at open,
    or libjpeg's error while decoding)."""
    img = picture(16, 24, seed=300)
    base = encode_baseline(img, F444)
    at = base.index(b'\xff\xc0')

    def sof(marker):
        return base[:at + 1] + bytes([marker]) + base[at + 2:]
    lossless = encode_lossless(img, F444, 4, kind='rgb')
    ls = lossless.index(b'\xff\xc3')
    frame = base.index(b'\xff\xc0') + 9       # the component count
    return {
        'hierarchical SOF13': sof(0xCD),
        'hierarchical SOF7': sof(0xC7),
        'DHP': sof(0xDE),
        'JPG marker': sof(0xC8),
        'arithmetic lossless': lossless[:ls + 1] + b'\xcb' + lossless[ls + 2:],
        'lossless YCbCr': encode_lossless(img, F444, 4, kind='ycc'),
        'lossless predictor 0': lossless.replace(
            b'\x03\x52\x00\x47\x00\x42\x00\x04',
            b'\x03\x52\x00\x47\x00\x42\x00\x00'),
        'two components': base[:frame] + b'\x02' + base[frame + 1:],
        'fractional sampling': encode_baseline(img, [(3, 1), (2, 1), (1, 1)]),
        'eleven blocks in an MCU': encode_baseline(img, [(3, 3), (1, 1),
                                                         (1, 1)]),
        'no EOI marker': base[:-2],
        'cut in its scan': base[:len(base) * 2 // 3],
        'progressive without EOI': save_pil(img, False, progressive=True)[:-2],
    }


if __name__ == '__main__':
    write_fixtures(sys.argv[1])
