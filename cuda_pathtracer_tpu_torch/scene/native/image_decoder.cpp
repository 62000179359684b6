// Host decoders of PNG scanlines (after inflate), TGA, BMP, GIF and PSD's
// PackBits rows, for
// textures and skies (scene/images.py binds them with ctypes). Their target
// is the pixels PIL returns for the same file, which is how the JAX package
// reads images: the same modes, the same bit expansions (5 and 6-bit
// channels as floor(v * 255 / max), 16-bit PNG samples by their high byte),
// the same quirks of its TGA, BMP RLE and GIF LZW decoders, and the same
// refusals.
//
// Every decoder returns uint8 [h, w, c], top row first, with PIL's mode:
//   "1"    c = 1, 0 or 255           "L"  c = 1          "LA"   c = 2
//   "P"    c = 3, the palette's RGB  "RGB" c = 3         "RGBA" c = 4
//   "I;16" c = 1, min(v, 255)
// P is returned through its palette and I;16 as its 8-bit saturation, which
// is all that PIL's convert('RGB') keeps of either.
//
// C interface (0 on success; 2: malformed, PIL raises OSError; 3: PIL
// raises ValueError; the reason in err):
//   cpt_png_raw_size(w, h, depth, ctype, interlace) -> inflated bytes needed
//   cpt_png_row_end(w, h, depth, ctype, interlace, n) -> 1 if n bytes of
//                    scanlines end at the end of a row
//   cpt_png_unfilter(raw, n, w, h, depth, ctype, interlace, plte, nplte,
//                    out, c, err, err_len)   into a caller's [h, w, c]
//   cpt_image_decode(format, data, n, &pixels, &w, &h, &c, mode, err,
//                    err_len)   format 1 TGA, 2 BMP, 3 GIF; a malloc'ed
//                    buffer that cpt_image_free releases
//   cpt_packbits(data, n, out, row_bytes, rows) -> the bytes PIL's PackBits
//                    decoder takes to fill rows x row_bytes of out, or -1
//                    if data ends first
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Fail {
  int code;
  std::string what;
};

[[noreturn]] void malformed(const std::string& what) { throw Fail{2, what}; }
[[noreturn]] void value_error(const std::string& what) { throw Fail{3, what}; }

struct Image {
  int w = 0, h = 0, c = 0;
  std::string mode;
  std::vector<uint8_t> px;
  void init(int w_, int h_, const std::string& m) {
    w = w_;
    h = h_;
    mode = m;
    c = m == "LA" ? 2 : (m == "P" || m == "RGB") ? 3 : m == "RGBA" ? 4 : 1;
    px.assign(size_t(w) * h * c, 0);
  }
};

uint32_t u16le(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t u32le(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// PIL's read size (ImageFile.MAXBLOCK) and largest image (twice
// Image.MAX_IMAGE_PIXELS, past which it raises DecompressionBombError)
const size_t kMaxBlock = 65536;
const int64_t kMaxPixels = 2 * int64_t(89478485);

void check_size(int64_t w, int64_t h) {
  if (w * h > kMaxPixels) malformed("image size exceeds the decompression bomb limit");
}

// 256 RGB entries; entries a file does not give are black, as in PIL
struct Palette {
  uint8_t rgb[256 * 3] = {};
};

// ---- raw modes: one row of packed samples -> the mode's samples ----------

enum Raw {
  kBit1,      // "1": MSB first, a set bit is 255
  kIndex1,    // "P;1"
  kIndex2,    // "P;2"
  kIndex4,    // "P;4"
  kIndex8,    // "P"
  kL,         // "L"
  kLA,        // "LA"
  kBGR15,     // "BGR;15"
  kBGR16,     // "BGR;16"
  kBGRA15Z,   // "BGRA;15Z": alpha 0 where bit 15 is set
  kBGR,       // "BGR"
  kBGRX,      // "BGRX"
  kXBGR,
  kBGXR,
  kABGR,
  kRGBA,
  kBGRA,
  kBGAR,
};

int raw_bits(Raw r) {
  switch (r) {
    case kBit1: case kIndex1: return 1;
    case kIndex2: return 2;
    case kIndex4: return 4;
    case kIndex8: case kL: return 8;
    case kLA: case kBGR15: case kBGR16: case kBGRA15Z: return 16;
    case kBGR: return 24;
    default: return 32;
  }
}

uint8_t expand5(uint32_t v) { return uint8_t((v & 31) * 255 / 31); }
uint8_t expand6(uint32_t v) { return uint8_t((v & 63) * 255 / 63); }

// byte positions of R, G, B (and A, -1 for none) in a 32-bit pixel
void byte_order(Raw r, int& R, int& G, int& B, int& A) {
  switch (r) {
    case kBGRX: R = 2; G = 1; B = 0; A = -1; break;
    case kXBGR: R = 3; G = 2; B = 1; A = -1; break;
    case kBGXR: R = 3; G = 1; B = 0; A = -1; break;
    case kABGR: R = 3; G = 2; B = 1; A = 0; break;
    case kRGBA: R = 0; G = 1; B = 2; A = 3; break;
    case kBGRA: R = 2; G = 1; B = 0; A = 3; break;
    case kBGAR: R = 3; G = 1; B = 0; A = 2; break;
    default: R = G = B = A = -1;
  }
}

// Unpack w pixels of `src` into row `y` of `im` (mode's layout), through
// `pal` for the index modes when the image is "P" (an "L" or "1" image of
// index data keeps the indices, as PIL's greyscale BMPs do).
void unpack_row(Raw r, const uint8_t* src, int w, Image& im, int y,
                const Palette& pal) {
  uint8_t* out = im.px.data() + size_t(y) * w * im.c;
  const bool pmode = im.mode == "P";
  auto put_index = [&](int x, int v) {
    if (pmode) {
      std::memcpy(out + 3 * x, pal.rgb + 3 * v, 3);
    } else {
      out[x] = uint8_t(v);
    }
  };
  switch (r) {
    case kBit1:
      for (int x = 0; x < w; x++) out[x] = (src[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0;
      break;
    case kIndex1:
      for (int x = 0; x < w; x++) put_index(x, (src[x >> 3] >> (7 - (x & 7))) & 1);
      break;
    case kIndex2:
      for (int x = 0; x < w; x++) put_index(x, (src[x >> 2] >> (6 - 2 * (x & 3))) & 3);
      break;
    case kIndex4:
      for (int x = 0; x < w; x++) put_index(x, (src[x >> 1] >> (x & 1 ? 0 : 4)) & 15);
      break;
    case kIndex8:
      for (int x = 0; x < w; x++) put_index(x, src[x]);
      break;
    case kL:
      std::memcpy(out, src, w);
      break;
    case kLA:
      std::memcpy(out, src, size_t(2) * w);
      break;
    case kBGR15:
      for (int x = 0; x < w; x++) {
        uint32_t v = u16le(src + 2 * x);
        out[3 * x] = expand5(v >> 10);
        out[3 * x + 1] = expand5(v >> 5);
        out[3 * x + 2] = expand5(v);
      }
      break;
    case kBGR16:
      for (int x = 0; x < w; x++) {
        uint32_t v = u16le(src + 2 * x);
        out[3 * x] = expand5(v >> 11);
        out[3 * x + 1] = expand6(v >> 5);
        out[3 * x + 2] = expand5(v);
      }
      break;
    case kBGRA15Z:
      for (int x = 0; x < w; x++) {
        uint32_t v = u16le(src + 2 * x);
        out[4 * x] = expand5(v >> 10);
        out[4 * x + 1] = expand5(v >> 5);
        out[4 * x + 2] = expand5(v);
        out[4 * x + 3] = v & 0x8000 ? 0 : 255;
      }
      break;
    case kBGR:
      for (int x = 0; x < w; x++) {
        out[3 * x] = src[3 * x + 2];
        out[3 * x + 1] = src[3 * x + 1];
        out[3 * x + 2] = src[3 * x];
      }
      break;
    default: {
      int R, G, B, A;
      byte_order(r, R, G, B, A);
      for (int x = 0; x < w; x++) {
        const uint8_t* p = src + 4 * x;
        uint8_t* o = out + size_t(im.c) * x;
        o[0] = p[R];
        o[1] = p[G];
        o[2] = p[B];
        if (im.c == 4) o[3] = A >= 0 ? p[A] : 255;
      }
    }
  }
}

// Rows of raw data (`stride` bytes apart, the first at `d`) into `im`,
// bottom row first when `bottom_up`. A `mapped` image (one PIL maps
// straight from a file it opened by name: L, P or RGBA data of the image's
// own mode) that the file holds `stride` bytes a row for is read row by row
// at that stride even when its rows overlap, bytes past the end of the
// file reading 0.
void raw_rows(Raw r, const uint8_t* d, size_t avail, size_t stride,
              bool bottom_up, Image& im, const Palette& pal,
              bool mapped = false) {
  size_t row_bytes = (size_t(im.w) * raw_bits(r) + 7) / 8;
  if (mapped && avail >= stride * im.h) {
    std::vector<uint8_t> row(row_bytes);
    for (int i = 0; i < im.h; i++) {
      size_t at = stride * i, have = at < avail ? std::min(row_bytes, avail - at) : 0;
      std::memcpy(row.data(), d + at, have);
      std::memset(row.data() + have, 0, row_bytes - have);
      unpack_row(r, row.data(), im.w, im, bottom_up ? im.h - 1 - i : i, pal);
    }
    return;
  }
  if (stride < row_bytes) malformed("bad configuration");
  if (avail < stride * (im.h - 1) + row_bytes)
    malformed("image file is truncated");
  for (int i = 0; i < im.h; i++)
    unpack_row(r, d + stride * i, im.w, im, bottom_up ? im.h - 1 - i : i, pal);
}

// ---- PNG ------------------------------------------------------------------

const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};

int png_samples(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

// (x0, y0, dx, dy) of each pass: one pass of step 1 without interlace
int png_passes(int interlace, int (*p)[4]) {
  if (!interlace) {
    p[0][0] = p[0][1] = 0;
    p[0][2] = p[0][3] = 1;
    return 1;
  }
  std::memcpy(p, kAdam7, sizeof(kAdam7));
  return 7;
}

int64_t png_raw_size(int w, int h, int depth, int ctype, int interlace) {
  int passes[7][4];
  int np = png_passes(interlace, passes);
  int64_t bits = int64_t(depth) * png_samples(ctype), total = 0;
  for (int k = 0; k < np; k++) {
    int64_t pw = w > passes[k][0] ? (w - passes[k][0] + passes[k][2] - 1) / passes[k][2] : 0;
    int64_t ph = h > passes[k][1] ? (h - passes[k][1] + passes[k][3] - 1) / passes[k][3] : 0;
    if (pw && ph) total += ph * (1 + (pw * bits + 7) / 8);
  }
  return total;
}

void png_unfilter_row(uint8_t* cur, const uint8_t* prev, size_t n, int bpp,
                      int ftype) {
  switch (ftype) {
    case 0: break;
    case 1:
      for (size_t i = bpp; i < n; i++) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
      break;
    case 2:
      for (size_t i = 0; i < n; i++) cur[i] = uint8_t(cur[i] + prev[i]);
      break;
    case 3:
      for (size_t i = 0; i < n; i++) {
        int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
        cur[i] = uint8_t(cur[i] + ((a + prev[i]) >> 1));
      }
      break;
    case 4:
      for (size_t i = 0; i < n; i++) {
        int a = i >= size_t(bpp) ? cur[i - bpp] : 0, b = prev[i];
        int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
        int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
            pc = std::abs(p - c);
        int pred = pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
        cur[i] = uint8_t(cur[i] + pred);
      }
      break;
    default:
      malformed("unrecognized data stream contents (PNG filter type " +
                std::to_string(ftype) + ")");
  }
}

// The mode's samples of pixel i of an unfiltered PNG row, into `o`.
inline void png_pixel(const uint8_t* row, int i, int depth, int ctype,
                      const Palette& pal, uint8_t* o) {
  if (depth < 8) {
    int per = 8 / depth, shift = 8 - depth * (i % per + 1);
    int v = (row[i / per] >> shift) & ((1 << depth) - 1);
    if (ctype == 3) {
      std::memcpy(o, pal.rgb + 3 * v, 3);
    } else {
      o[0] = uint8_t(depth == 1 ? v * 255 : depth == 2 ? v * 85 : v * 17);
    }
    return;
  }
  int ns = png_samples(ctype);
  if (depth == 8) {
    const uint8_t* s = row + size_t(i) * ns;
    if (ctype == 3) {
      std::memcpy(o, pal.rgb + 3 * s[0], 3);
    } else {
      std::memcpy(o, s, ns);
    }
    return;
  }
  const uint8_t* s = row + size_t(i) * ns * 2;   // 16 bits, big-endian
  switch (ctype) {
    case 0:   // I;16, saturated as its conversion to RGB does
      o[0] = s[0] ? 255 : s[1];
      break;
    case 4:   // opened as RGBA: L, L, L, A
      o[0] = o[1] = o[2] = s[0];
      o[3] = s[2];
      break;
    default:
      for (int k = 0; k < ns; k++) o[k] = s[2 * k];
  }
}

// whether `n` bytes of scanlines end at the end of a row (of any pass)
bool png_row_end(int w, int h, int depth, int ctype, int interlace,
                 int64_t n) {
  int passes[7][4];
  int np = png_passes(interlace, passes);
  int64_t bits = int64_t(depth) * png_samples(ctype), start = 0;
  for (int k = 0; k < np && n > start; k++) {
    int64_t pw = w > passes[k][0] ? (w - passes[k][0] + passes[k][2] - 1) / passes[k][2] : 0;
    int64_t ph = h > passes[k][1] ? (h - passes[k][1] + passes[k][3] - 1) / passes[k][3] : 0;
    if (!pw || !ph) continue;
    int64_t row = 1 + (pw * bits + 7) / 8;
    if (n <= start + ph * row) return (n - start) % row == 0;
    start += ph * row;
  }
  return n == start;
}

void png_unfilter(const uint8_t* raw, int64_t n, int w, int h, int depth,
                  int ctype, int interlace, const uint8_t* plte, int nplte,
                  uint8_t* out, int c) {
  if (n < png_raw_size(w, h, depth, ctype, interlace))
    malformed("image file is truncated");
  Palette pal;
  std::memcpy(pal.rgb, plte, std::min(nplte, 256) * 3);
  int passes[7][4];
  int np = png_passes(interlace, passes);
  int bits = depth * png_samples(ctype), bpp = bits < 8 ? 1 : bits / 8;
  std::vector<uint8_t> prev, cur;
  const uint8_t* p = raw;
  for (int k = 0; k < np; k++) {
    int x0 = passes[k][0], y0 = passes[k][1], dx = passes[k][2],
        dy = passes[k][3];
    int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (!pw || !ph) continue;
    size_t len = (size_t(pw) * bits + 7) / 8;
    prev.assign(len, 0);
    cur.resize(len);
    for (int j = 0; j < ph; j++) {
      int ftype = *p++;
      std::memcpy(cur.data(), p, len);
      p += len;
      png_unfilter_row(cur.data(), prev.data(), len, bpp, ftype);
      uint8_t* orow = out + size_t(y0 + j * dy) * w * c;
      for (int i = 0; i < pw; i++)
        png_pixel(cur.data(), i, depth, ctype, pal,
                  orow + size_t(x0 + i * dx) * c);
      prev.swap(cur);
    }
  }
}

// ---- TGA (PIL's TgaImagePlugin and TgaRleDecode) ----------------------------

void tga(const uint8_t* d, size_t n, Image& im) {
  if (n < 18) malformed("cannot identify image file (short TGA header)");
  int id_len = d[0], cmt = d[1], type = d[2], depth = d[16], flags = d[17];
  int w = u16le(d + 12), h = u16le(d + 14);
  if (cmt > 1 || w <= 0 || h <= 0 ||
      !(depth == 1 || depth == 8 || depth == 16 || depth == 24 || depth == 32))
    malformed("cannot identify image file (not a TGA file)");
  std::string mode;
  if (type == 3 || type == 11) {
    mode = depth == 1 ? "1" : depth == 16 ? "LA" : "L";
  } else if (type == 1 || type == 9) {
    mode = cmt ? "P" : "L";
  } else if (type == 2 || type == 10) {
    mode = depth == 24 ? "RGB" : "RGBA";
  } else {
    malformed("cannot identify image file (unknown TGA mode)");
  }
  bool bottom_up = !(flags & 0x20), mirror = flags & 0x10;
  size_t pos = std::min(n, size_t(18) + id_len);
  Palette pal;
  bool has_palette = false;
  if (cmt) {
    int start = u16le(d + 3), size = u16le(d + 5), mapdepth = d[7];
    if (mapdepth != 16 && mapdepth != 24 && mapdepth != 32)
      malformed("cannot identify image file (unknown TGA map depth)");
    if (mapdepth == 32) value_error("unrecognized raw mode (32-bit TGA colour map)");
    int eb = mapdepth / 8;
    size_t got = std::min(n - pos, size_t(eb) * size);
    if (start + got / eb > 256) value_error("invalid palette size");
    for (int e = start; e < 256 && size_t(e - start + 1) * eb <= got; e++) {
      const uint8_t* q = d + pos + size_t(e - start) * eb;
      uint8_t* o = pal.rgb + 3 * e;
      if (eb == 2) {
        uint32_t v = u16le(q);
        o[0] = expand5(v >> 10);
        o[1] = expand5(v >> 5);
        o[2] = expand5(v);
      } else {
        o[0] = q[2];
        o[1] = q[1];
        o[2] = q[0];
      }
    }
    pos += got;
    has_palette = true;
  }
  check_size(w, h);
  Raw r;
  switch ((type & 7) * 100 + depth) {
    case 108: r = kIndex8; break;
    case 301: r = kBit1; break;
    case 308: r = kL; break;
    case 316: r = kLA; break;
    case 216: r = kBGRA15Z; break;
    case 224: r = kBGR; break;
    case 232: r = kBGRA; break;
    default: malformed("cannot load this image");
  }
  if (r == kIndex8 && mode != "P")
    value_error("unknown raw mode for given image mode");
  if (has_palette && mode != "P") value_error("unrecognized image mode");
  im.init(w, h, mode);
  size_t stride = (size_t(w) * depth + 7) / 8;
  if (!(type & 8)) {
    // PIL maps an L or P image of a file opened by name straight from the
    // file, and raises ValueError when the file is too short for it
    if ((r == kL || r == kIndex8) && n - pos < stride * h)
      value_error("buffer is not large enough");
    raw_rows(r, d + pos, n - pos, stride, bottom_up, im, pal);
  } else {
    // RLE packets of depth / 8-byte pixels into rows of `stride` bytes: a
    // literal may run on into the next row, a run may not (PIL's pixels of
    // a 1-bit file are 0 bytes long, so its packets never fill a row)
    int pb = depth / 8;
    if (!pb) malformed("image file is truncated (1-bit RLE)");
    std::vector<uint8_t> row(stride);
    size_t x = 0, extra = 0;
    int done = 0;
    const uint8_t* p = d + pos;
    const uint8_t* end = d + n;
    while (done < h) {
      if (p >= end) malformed("image file is truncated");
      size_t cnt = size_t(pb) * ((p[0] & 0x7f) + 1);
      if (p[0] & 0x80) {
        if (end - p < 1 + pb) malformed("image file is truncated");
        if (x + cnt > stride) malformed("buffer overrun when reading image file");
        for (size_t i = 0; i < cnt; i += pb) std::memcpy(&row[x + i], p + 1, pb);
        p += 1 + pb;
      } else {
        if (size_t(end - p) < 1 + cnt) malformed("image file is truncated");
        size_t take = cnt;
        if (x + cnt > stride) {
          take = stride - x;
          extra = cnt - take;
        }
        std::memcpy(&row[x], p + 1, take);
        p += 1 + take;
        cnt = take;
      }
      for (;;) {
        x += cnt;
        if (x >= stride) {
          unpack_row(r, row.data(), w, im, bottom_up ? h - 1 - done : done, pal);
          x = 0;
          if (++done == h) break;
        }
        if (!extra || x > 0) break;
        cnt = std::min(extra, stride);
        std::memcpy(&row[0], p, cnt);
        p += cnt;
        extra -= cnt;
      }
    }
  }
  if (mirror) {
    for (int y = 0; y < h; y++) {
      uint8_t* rowp = im.px.data() + size_t(y) * w * im.c;
      for (int a = 0, b = w - 1; a < b; a++, b--)
        for (int k = 0; k < im.c; k++) std::swap(rowp[a * im.c + k], rowp[b * im.c + k]);
    }
  }
}

// ---- BMP (PIL's BmpImagePlugin and BmpRleDecoder) ---------------------------

void bmp(const uint8_t* d, size_t n, Image& im) {
  if (n < 18) malformed("cannot identify image file (short BMP header)");
  size_t offset = u32le(d + 10);
  uint32_t hsize = u32le(d + 14);
  if (hsize < 4 || n - 18 < hsize - 4) malformed("Truncated File Read");
  const uint8_t* hd = d + 18;
  size_t pos = 14 + size_t(hsize);
  int64_t w, h;
  int bits, comp;
  uint64_t colors = 0;
  int padding;
  bool top_down = false;
  uint32_t mask[4] = {0, 0, 0, 0};
  if (hsize == 12) {
    w = u16le(hd);
    h = u16le(hd + 2);
    bits = u16le(hd + 6);
    comp = 0;
    padding = 3;
  } else if (hsize == 40 || hsize == 52 || hsize == 56 || hsize == 64 ||
             hsize == 108 || hsize == 124) {
    top_down = hd[7] == 0xFF;
    w = u32le(hd);
    h = top_down ? (int64_t(1) << 32) - u32le(hd + 4) : u32le(hd + 4);
    bits = u16le(hd + 10);
    comp = int(u32le(hd + 12));
    colors = u32le(hd + 28);
    padding = 4;
    if (comp == 3) {
      if (hsize >= 52) {
        for (int k = 0; k < (hsize >= 56 ? 4 : 3); k++) mask[k] = u32le(hd + 36 + 4 * k);
      } else {
        if (n < pos + 12) malformed("cannot identify image file (short masks)");
        for (int k = 0; k < 3; k++) mask[k] = u32le(d + pos + 4 * k);
        pos += 12;
      }
    }
  } else {
    malformed("Unsupported BMP header type (" + std::to_string(hsize) + ")");
  }
  if (w <= 0 || h <= 0 || w > 0x7fffffff || h > 0x7fffffff)
    malformed("cannot identify image file (BMP size)");
  if (!colors) colors = bits < 64 ? uint64_t(1) << bits : 0;
  if (offset == 14 + size_t(hsize) && bits <= 8) offset += 4 * colors;
  std::string mode;
  Raw r;
  switch (bits) {
    case 1: mode = "P"; r = kIndex1; break;
    case 4: mode = "P"; r = kIndex4; break;
    case 8: mode = "P"; r = kIndex8; break;
    case 16: mode = "RGB"; r = kBGR15; break;
    case 24: mode = "RGB"; r = kBGR; break;
    case 32: mode = "RGB"; r = kBGRX; break;
    default: malformed("Unsupported BMP pixel depth (" + std::to_string(bits) + ")");
  }
  bool rle = false;
  if (comp == 3) {
    auto is = [&](uint32_t a, uint32_t b, uint32_t c, uint32_t e) {
      return mask[0] == a && mask[1] == b && mask[2] == c && mask[3] == e;
    };
    auto rgb = [&](uint32_t a, uint32_t b, uint32_t c) {
      return mask[0] == a && mask[1] == b && mask[2] == c;
    };
    bool ok = true;
    if (bits == 32) {
      if (is(0xFF0000, 0xFF00, 0xFF, 0)) r = kBGRX;
      else if (is(0xFF000000, 0xFF0000, 0xFF00, 0)) r = kXBGR;
      else if (is(0xFF000000, 0xFF00, 0xFF, 0)) r = kBGXR;
      else if (is(0xFF000000, 0xFF0000, 0xFF00, 0xFF)) r = kABGR;
      else if (is(0xFF, 0xFF00, 0xFF0000, 0xFF000000)) r = kRGBA;
      else if (is(0xFF0000, 0xFF00, 0xFF, 0xFF000000)) r = kBGRA;
      else if (is(0xFF000000, 0xFF00, 0xFF, 0xFF0000)) r = kBGAR;
      else if (is(0, 0, 0, 0)) r = kBGRA;
      else ok = false;
      if (ok && (r == kABGR || r == kRGBA || r == kBGRA || r == kBGAR)) mode = "RGBA";
    } else if (bits == 24) {
      ok = rgb(0xFF0000, 0xFF00, 0xFF);
    } else if (bits == 16) {
      if (rgb(0xF800, 0x7E0, 0x1F)) r = kBGR16;
      else if (rgb(0x7C00, 0x3E0, 0x1F)) r = kBGR15;
      else ok = false;
    } else {
      ok = false;
    }
    if (!ok) malformed("Unsupported BMP bitfields layout");
  } else if (comp == 1 || comp == 2) {
    rle = true;
  } else if (comp != 0) {
    malformed("Unsupported BMP compression (" + std::to_string(comp) + ")");
  }
  Palette pal;
  bool too_many = false;   // palette entries; PIL refuses them on loading
  if (mode == "P") {
    if (colors == 0 || colors > 65536)
      malformed("Unsupported BMP Palette size (" + std::to_string(colors) + ")");
    size_t want = size_t(padding) * colors;
    size_t got = pos < n ? std::min(n - pos, want) : 0;
    const uint8_t* q = d + pos;
    bool grey = true;
    for (uint64_t i = 0; i < colors && grey; i++) {
      int val = colors == 2 ? (i ? 255 : 0) : int(i & 255);
      if (i * padding + 3 > got || q[i * padding] != val ||
          q[i * padding + 1] != val || q[i * padding + 2] != val)
        grey = false;
    }
    if (grey) {
      mode = colors == 2 ? "1" : "L";
      r = colors == 2 ? kBit1 : kL;
    } else {
      too_many = got / padding > 256;
      for (size_t e = 0; e < 256 && (e + 1) * padding <= got; e++) {
        pal.rgb[3 * e] = q[e * padding + 2];
        pal.rgb[3 * e + 1] = q[e * padding + 1];
        pal.rgb[3 * e + 2] = q[e * padding];
      }
    }
  }
  check_size(w, h);
  if (too_many) value_error("invalid palette size");
  im.init(int(w), int(h), mode);
  if (!rle) {
    if (offset > n) malformed("image file is truncated");
    size_t stride = ((size_t(w) * bits + 31) >> 3) & ~size_t(3);
    bool mapped = (r == kL && mode == "L") || (r == kIndex8 && mode == "P") ||
                  (r == kRGBA && mode == "RGBA");
    raw_rows(r, d + offset, n - offset, stride, !top_down, im, pal, mapped);
    return;
  }
  // PIL's BmpRleDecoder, quirks and all: a delta reads two bytes more than
  // it uses, an odd RLE4 literal loses its last pixel, and the word
  // alignment follows the position in the file
  bool rle4 = comp == 2;
  size_t xs = size_t(w), dest = xs * size_t(h), x = 0, fp = offset;
  std::vector<uint8_t> data;
  data.reserve(dest);
  while (data.size() < dest) {
    if (fp + 2 > n) break;
    int count = d[fp], byte = d[fp + 1];
    fp += 2;
    if (count) {
      size_t np = x + count > xs ? (xs > x ? xs - x : 0) : size_t(count);
      for (size_t i = 0; i < np; i++)
        data.push_back(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte);
      x += np;
    } else if (byte == 0) {
      while (data.size() % xs) data.push_back(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      if (fp + 2 > n) break;
      fp += 2;
      if (fp + 2 > n) value_error("not enough values to unpack");
      size_t right = d[fp], up = d[fp + 1];
      fp += 2;
      data.insert(data.end(), right + up * xs, 0);
      x = data.size() % xs;
    } else {
      size_t want = rle4 ? byte / 2 : byte;
      size_t got = std::min(want, n - fp);
      for (size_t i = 0; i < got; i++) {
        if (rle4) {
          data.push_back(d[fp + i] >> 4);
          data.push_back(d[fp + i] & 15);
        } else {
          data.push_back(d[fp + i]);
        }
      }
      fp += got;
      if (got < want) break;
      x += byte;
      if (fp % 2) fp++;
    }
  }
  if (data.size() < dest) value_error("not enough image data");
  if (mode != "P" && mode != "L") value_error("unknown raw mode for given image mode");
  for (int i = 0; i < im.h; i++)
    unpack_row(kIndex8, data.data() + xs * i, im.w, im,
               top_down ? i : im.h - 1 - i, pal);
}

// ---- GIF (PIL's GifImagePlugin and GifDecode, first frame) ------------------

// a palette PIL keeps: anything but the identity grey ramp, which it reads
// as mode L (a palette cut short by the end of the file is malformed)
bool palette_needed(const uint8_t* p, size_t len) {
  if (len % 3) malformed("cannot identify image file (short GIF palette)");
  for (size_t i = 0; i < len; i += 3)
    if (!(i / 3 == p[i] && p[i] == p[i + 1] && p[i] == p[i + 2])) return true;
  return false;
}

void gif(const uint8_t* d, size_t n, Image& im) {
  if (n < 13) malformed("cannot identify image file (short GIF header)");
  int sw = u16le(d + 6), sh = u16le(d + 8), flags = d[10];
  size_t pos = 13;
  const uint8_t* gpal = nullptr;
  size_t gpal_len = 0;
  if (flags & 128) {
    size_t len = size_t(3) << ((flags & 7) + 1);
    len = std::min(len, n - pos);
    if (palette_needed(d + pos, len)) {
      gpal = d + pos;
      gpal_len = len;
    }
    pos += len;
  }
  auto byte = [&]() -> int { return pos < n ? d[pos++] : -1; };
  // one data sub-block: its length (0: none) and start
  auto block = [&](size_t& start) -> size_t {
    int len = byte();
    if (len <= 0) return 0;
    start = pos;
    size_t got = std::min(size_t(len), n - pos);
    pos += got;
    return got;
  };
  int transparency = -1;
  bool found = false;
  int x0 = 0, y0 = 0, fw = 0, fh = 0, interlace = 0, bits = 0;
  const uint8_t* lpal = nullptr;
  size_t lpal_len = 0;
  bool local = false, local_needed = false;
  for (;;) {
    int s = byte();
    if (s < 0 || s == ';') break;
    if (s == '!') {
      int label = byte();
      size_t start = 0, len = block(start);
      size_t st;
      if (label == 254) {
        while (len) len = block(st);
        continue;
      }
      if (label == 249 && len) {
        if (len < 3 || ((d[start] & 1) && len < 4))
          malformed("cannot identify image file (short GIF extension)");
        if (d[start] & 1) transparency = d[start + 3];
      }
      // as PIL: read on to an empty block, even after one that ended
      while (block(st)) {
      }
    } else if (s == ',') {
      if (n - pos < 9) malformed("cannot identify image file (short GIF frame)");
      x0 = u16le(d + pos);
      y0 = u16le(d + pos + 2);
      fw = u16le(d + pos + 4);
      fh = u16le(d + pos + 6);
      int f = d[pos + 8];
      pos += 9;
      interlace = f & 64;
      if (f & 128) {
        size_t len = std::min(size_t(3) << ((f & 7) + 1), n - pos);
        local = true;
        local_needed = palette_needed(d + pos, len);
        lpal = d + pos;
        lpal_len = len;
        pos += len;
      }
      if (pos >= n) malformed("cannot identify image file (short GIF frame)");
      bits = d[pos++];
      found = true;
      break;
    }
  }
  if (!found) malformed("image not found in GIF frame");
  int w = std::max(sw, x0 + fw), h = std::max(sh, y0 + fh);
  if (w <= 0 || h <= 0) malformed("cannot identify image file (GIF size)");
  check_size(w, h);
  const uint8_t* fpal = local ? (local_needed ? lpal : nullptr) : gpal;
  size_t fpal_len = local ? (local_needed ? lpal_len : 0) : gpal_len;
  // decode indices into an index plane, then apply the palette
  std::vector<uint8_t> plane(size_t(w) * h, transparency >= 0 ? uint8_t(transparency) : 0);
  if (bits > 12) malformed("bad configuration (GIF code size)");
  if (fw > 0 && fh > 0) {
    const int clear = 1 << bits, eoi = clear + 1;
    std::vector<uint16_t> link(4096);
    std::vector<uint8_t> first(4096), stack(4097);
    int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
    int state = 2, lastcode = 0, lastdata = 0;
    uint32_t bitbuf = 0;
    int bitcount = 0;
    size_t blocksize = 0;
    // PIL feeds the decoder 64 KiB of the file at a time: a sub-block must
    // lie whole in what it has been fed, and an end code returns to the
    // feeder, which fails at the end of the file and else feeds more
    size_t fed = std::min(n, pos + kMaxBlock);
    auto feed_more = [&]() {
      if (fed >= n) malformed("image file is truncated");
      fed = std::min(n, fed + kMaxBlock);
    };
    int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
    bool complete = false;
    auto put = [&](uint8_t v) {
      plane[size_t(y0 + y) * w + x0 + x] = v;
      if (++x < fw) return;
      x = 0;
      y += step;
      while (y >= fh) {
        if (pass == 1) { y = 4; pass = 2; }
        else if (pass == 2) { step = 4; y = 2; pass = 3; }
        else if (pass == 3) { step = 2; y = 1; pass = 0; }
        else { complete = true; return; }
      }
    };
    while (!complete) {
      while (bitcount < codesize) {
        if (blocksize > 0) {
          bitbuf |= uint32_t(d[pos++]) << bitcount;
          bitcount += 8;
          blocksize--;
        } else {
          if (pos >= fed || fed - pos < size_t(d[pos]) + 1) {
            feed_more();
            continue;
          }
          blocksize = d[pos++];
        }
      }
      int c = int(bitbuf & uint32_t(codemask));
      bitbuf >>= codesize;
      bitcount -= codesize;
      if (c == clear) {
        if (state != 2) {
          next = clear + 2;
          codesize = bits + 1;
          codemask = (1 << codesize) - 1;
          state = 2;
        }
        continue;
      }
      if (c == eoi) {
        feed_more();
        continue;
      }
      int sp = 0;
      if (state == 2) {
        if (c > clear) malformed("broken data stream when reading image file");
        lastdata = lastcode = c;
        state = 3;
      } else {
        int thiscode = c;
        if (c > next) malformed("broken data stream when reading image file");
        if (c == next) {
          stack[sp++] = uint8_t(lastdata);
          c = lastcode;
        }
        while (c >= clear) {
          if (sp >= 4096 || c >= 4096)
            malformed("broken data stream when reading image file");
          stack[sp++] = first[c];
          c = link[c];
        }
        lastdata = c;
        if (next < 4096) {
          first[next] = uint8_t(c);
          link[next] = uint16_t(lastcode);
          if (next == codemask && codesize < 12) {
            codesize++;
            codemask = (1 << codesize) - 1;
          }
          next++;
        }
        lastcode = thiscode;
      }
      put(uint8_t(lastdata));
      while (sp > 0 && !complete) put(stack[--sp]);
    }
  }
  if (!fpal) {
    im.init(w, h, "L");
    im.px = plane;
    return;
  }
  Palette pal;
  std::memcpy(pal.rgb, fpal, std::min(fpal_len, size_t(768)));
  im.init(w, h, "P");
  for (size_t i = 0; i < plane.size(); i++) std::memcpy(&im.px[3 * i], pal.rgb + 3 * plane[i], 3);
}

int fail(const Fail& f, char* err, int err_len) {
  std::snprintf(err, size_t(err_len), "%s", f.what.c_str());
  return f.code;
}

}  // namespace

extern "C" {

int64_t cpt_png_raw_size(int w, int h, int depth, int ctype, int interlace) {
  return png_raw_size(w, h, depth, ctype, interlace);
}

int cpt_png_row_end(int w, int h, int depth, int ctype, int interlace,
                    int64_t n) {
  return png_row_end(w, h, depth, ctype, interlace, n);
}

int cpt_png_unfilter(const uint8_t* raw, int64_t n, int w, int h, int depth,
                     int ctype, int interlace, const uint8_t* plte, int nplte,
                     uint8_t* out, int c, char* err, int err_len) {
  try {
    png_unfilter(raw, n, w, h, depth, ctype, interlace, plte, nplte, out, c);
    return 0;
  } catch (const Fail& f) {
    return fail(f, err, err_len);
  }
}

int cpt_image_decode(int format, const uint8_t* data, int64_t n,
                     uint8_t** pixels, int* width, int* height, int* channels,
                     char* mode, char* err, int err_len) {
  try {
    Image im;
    if (format == 1) {
      tga(data, size_t(n), im);
    } else if (format == 2) {
      bmp(data, size_t(n), im);
    } else if (format == 3) {
      gif(data, size_t(n), im);
    } else {
      malformed("unknown format");
    }
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(im.px.size() ? im.px.size() : 1));
    if (!buf) malformed("out of memory");
    std::memcpy(buf, im.px.data(), im.px.size());
    *pixels = buf;
    *width = im.w;
    *height = im.h;
    *channels = im.c;
    std::snprintf(mode, 8, "%s", im.mode.c_str());
    return 0;
  } catch (const Fail& f) {
    return fail(f, err, err_len);
  } catch (const std::exception& e) {
    return fail(Fail{2, e.what()}, err, err_len);
  }
}

void cpt_image_free(uint8_t* p) { std::free(p); }

// PackbitsDecode.c: a run or literal fills the current row and drops what
// does not fit; a packet that data holds only part of ends the stream.
int64_t cpt_packbits(const uint8_t* d, int64_t n, uint8_t* out,
                     int64_t row_bytes, int64_t rows) {
  int64_t pos = 0, x = 0, y = 0;
  if (rows <= 0 || row_bytes <= 0) return 0;
  while (pos < n) {
    int b = d[pos];
    if (b == 0x80) {   // no operation
      pos++;
      continue;
    }
    uint8_t* row = out + y * row_bytes;
    if (b & 0x80) {    // a run of 257 - b copies of the next byte
      if (n - pos < 2) break;
      for (int k = 257 - b; k > 0 && x < row_bytes; k--) row[x++] = d[pos + 1];
      pos += 2;
    } else {           // b + 1 literal bytes
      if (n - pos < b + 2) break;
      for (int k = 1; k < b + 2 && x < row_bytes; k++) row[x++] = d[pos + k];
      pos += b + 2;
    }
    if (x >= row_bytes) {
      x = 0;
      if (++y >= rows) return pos;
    }
  }
  return -1;
}

}  // extern "C"
