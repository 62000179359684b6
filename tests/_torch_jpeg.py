"""JPEG files for the port's decoder tests (``tests/test_torch_jpeg.py``),
written here with PIL (libjpeg-turbo) and, for the layouts PIL does not
write, with :func:`encode_baseline`.

:func:`write_fixtures` writes the committed fixtures of ``tests/data/jpeg``
and their ``digests.json``: for each file the shape and the SHA-256 of
PIL's decode (uint8 [H, W, C], C = 1 for grey). ``chip_smoke.py`` holds the
port's decoder to those digests on the machine with the card, which has no
PIL. Run it again only to change the fixtures:

    python tests/_torch_jpeg.py tests/data/jpeg

:func:`refused` makes files of the features the decoder refuses, by
editing a PIL file's markers.
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


def _std_tables():
    """The quantization and Huffman tables libjpeg writes by default (read
    off a PIL file): {0, 1: natural-order quant} and {(class, id): (counts,
    values)}."""
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


def encode_baseline(img: np.ndarray, factors, ids=(1, 2, 3)) -> bytes:
    """A baseline JPEG of uint8 RGB ``img`` with any sampling factors of
    1 or 2 (``factors``: (h, v) per component), YCbCr unless the ids are
    'R' 'G' 'B' (then the planes are the RGB ones, and no JFIF marker is
    written), libjpeg's default tables at quality 90."""
    quant, huff = _std_tables()
    h, w = img.shape[:2]
    f = img.astype(np.float64)
    rgb = tuple(ids) == (82, 71, 66)
    if rgb:
        planes = [f[..., 0], f[..., 1], f[..., 2]]
    else:
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hmax = max(a for a, _ in factors)
    vmax = max(b for _, b in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    k = np.arange(8)
    dct = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) \
        * np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    blocks = []
    for plane, (fh, fv) in zip(planes, factors):
        full = np.pad(plane, ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)),
                      mode='edge')
        sh, sv = hmax // fh, vmax // fv
        small = full.reshape(full.shape[0] // sv, sv, full.shape[1] // sh,
                             sh).mean(axis=(1, 3))
        blocks.append(small)
    out = bytearray(b'\xff\xd8')

    def seg(marker, payload):
        out.extend(bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, 'big')
                   + bytes(payload))
    if not rgb:
        seg(0xE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')
    for t in (0, 1):
        seg(0xDB, bytes([t]) + bytes(int(v) for v in quant[t][NATURAL]))
    sof = bytes([8]) + h.to_bytes(2, 'big') + w.to_bytes(2, 'big') + bytes([3])
    for i, (fh, fv) in enumerate(factors):
        sof += bytes([ids[i], (fh << 4) | fv, min(i, 1)])
    seg(0xC0, sof)
    for (tc, th), (counts, values) in sorted(huff.items()):
        seg(0xC4, bytes([(tc << 4) | th] + counts + values))
    sos = bytes([3])
    for i in range(3):
        sos += bytes([ids[i], min(i, 1) * 0x11])
    seg(0xDA, sos + bytes([0, 63, 0]))
    dc_codes = {t: _codes(*huff[(0, t)]) for t in (0, 1)}
    ac_codes = {t: _codes(*huff[(1, t)]) for t in (0, 1)}
    bw = _BitWriter()
    pred = [0, 0, 0]

    def emit(codes, sym):
        bw.put(*codes[sym])

    def magnitude(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    for my in range(mcuy):
        for mx in range(mcux):
            for c, (fh, fv) in enumerate(factors):
                t = min(c, 1)
                for by in range(fv):
                    for bx in range(fh):
                        y0, x0 = (my * fv + by) * 8, (mx * fh + bx) * 8
                        blk = blocks[c][y0:y0 + 8, x0:x0 + 8] - 128
                        coef = (dct @ blk @ dct.T).ravel()
                        q = np.round(coef / quant[t]).astype(np.int64)[NATURAL]
                        s, bits = magnitude(int(q[0]) - pred[c])
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
                            s, bits = magnitude(int(v))
                            emit(ac_codes[t], (run << 4) | s)
                            bw.put(bits, s)
                            run = 0
                        if run:
                            emit(ac_codes[t], 0x00)
    bw.flush()
    out.extend(bw.out)
    out.extend(b'\xff\xd9')
    return bytes(out)


def fixtures() -> dict:
    """{name: JPEG bytes} of every fixture."""
    out = {}
    for i, (name, h, w, grey, opts) in enumerate(PIL_FIXTURES):
        out[name] = save_pil(picture(h, w, seed=i), grey, **opts)
    for i, (name, h, w, factors, ids) in enumerate(BASELINE_FIXTURES):
        out[name] = encode_baseline(picture(h, w, seed=100 + i), factors, ids)
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
    """{feature: JPEG bytes} of files the decoder refuses: the named
    feature marked in an otherwise decodable file (CMYK written by PIL; a
    progressive file cut after its first scans, whose coefficients libjpeg
    then smooths)."""
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


if __name__ == '__main__':
    write_fixtures(sys.argv[1])
