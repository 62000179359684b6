// A host decoder of JPEG, for textures and skies (scene/jpeg.py binds it
// with ctypes). Its target is the uint8 output of libjpeg-turbo at its
// default settings, which is what PIL returns: the accurate integer IDCT
// (jidctint.c, as its x86 vector code computes it), progressive block
// smoothing (jdcoefct.c), fancy (triangle) upsampling with its alternating
// rounding biases and replicated edges and box replication for the other
// integral ratios (jdsample.c), and the
// fixed-point YCbCr -> RGB and YCCK -> CMYK tables (jdcolor.c), all in the
// same integer arithmetic, so the output is the same bit for bit.
//
// Read: SOF0, SOF1 and SOF2 (Huffman), SOF9 and SOF10 (arithmetic coding,
// T.81 Annex D and F.2.4/G.1.3 as jdarith.c decodes them, DAC conditioning),
// SOF3 (lossless, predictors 1-7 and the point transform, jdlossls.c),
// progressive spectral selection and successive approximation, 8-bit
// samples, one component (grey), three (YCbCr, or RGB after an Adobe marker
// of transform 0 or component ids 'R' 'G' 'B') or four (CMYK, or YCCK after
// an Adobe marker of transform 2), sampling factors 1-4 per axis whose
// ratios to the largest are integral, restart intervals, any APPn and COM
// markers. Entropy-coded data that ends at a marker decodes as libjpeg
// decodes it: Huffman data reads zero bits for the MCU it ends in and
// leaves the segment's later MCUs zero; arithmetic data reads zero bytes,
// and a code the statistics cannot hold leaves the segment's later blocks
// as they are (jdarith.c warns). What libjpeg-turbo or PIL refuses is
// refused: other precisions, hierarchical and arithmetic lossless frames,
// a height of 0 (DNL), two components or more than four, fractional
// sampling ratios, a file that ends before its EOI marker.
//
// Four components come out as PIL reads them: inverted (its raw mode
// "CMYK;I", whatever the Adobe marker says).
//
// C interface: cpt_jpeg_decode(data, n, &pixels, &w, &h, &c, err, err_len)
// returns 0 and a malloc'ed [h, w, c] uint8 buffer (free it with
// cpt_jpeg_free), or 2 for a file PIL refuses too (it raises OSError), with
// the reason in err.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Malformed { std::string what; };

// zigzag index -> natural index, with 16 guard entries for corrupt runs
const int kNatural[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kMaxBlocksInMcu = 10;   // D_MAX_BLOCKS_IN_MCU

struct Huffman {
  bool present = false;
  int maxcode[18];   // largest code of each length, -1 if none
  int valptr[17];    // index of the first value of each length
  int mincode[17];
  uint8_t vals[256];
  uint8_t look_len[256];   // 8-bit lookahead: code length (0: longer)
  uint8_t look_sym[256];

  void build(const uint8_t* counts, const uint8_t* values, int nvals) {
    std::memcpy(vals, values, nvals);
    int code = 0, k = 0;
    std::memset(look_len, 0, sizeof(look_len));
    for (int len = 1; len <= 16; len++) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
        if (len <= 8) {
          int shift = 8 - len;
          for (int j = 0; j < (1 << shift); j++) {
            look_len[(code << shift) | j] = len;
            look_sym[(code << shift) | j] = values[k];
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (code >= (1 << len)) throw Malformed{"bad Huffman table"};
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

// The position after the restart marker that ends an interval whose data
// starts at or before pos, or pos at another marker (libjpeg then treats
// the next interval as empty). `found` says which.
size_t seek_restart(const uint8_t* d, size_t n, size_t pos, bool& found) {
  found = false;
  while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 &&
                          d[pos + 1] <= 0xD7)) {
    if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF)
      return pos;   // another marker: no restart marker here
    pos++;
  }
  if (pos + 1 < n) {
    found = true;
    pos += 2;
  }
  return pos;
}

// The next byte of entropy-coded data (0xFF 0x00, after any 0xFF fill, is
// a 0xFF), or -1 at a marker, where pos is left on an 0xFF before it.
int next_data_byte(const uint8_t* d, size_t n, size_t& pos) {
  if (pos >= n) return -1;
  if (d[pos] != 0xFF) return d[pos++];
  size_t q = pos + 1;
  while (q < n && d[q] == 0xFF) q++;
  if (q < n && d[q] == 0x00) {
    pos = q + 1;
    return 0xFF;
  }
  pos = q - 1;
  return -1;
}

// Huffman-coded bits. At a marker the reader feeds zero bits; a bit taken
// from past the data sets `insufficient`, after which libjpeg leaves the
// segment's MCUs zero (jdhuff.c, jpeg_fill_bit_buffer).
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  int pad = 0;   // the zero bits at the end of buf that follow the data
  bool at_marker = false;
  bool insufficient = false;

  void fill() {
    while (cnt <= 56) {
      int b = at_marker ? -1 : next_data_byte(d, n, pos);
      if (b < 0) {
        at_marker = true;
        b = 0;
        pad += 8;
      }
      buf |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  void drop(int k) {
    if (k > cnt - pad) insufficient = true;
    buf <<= k;
    cnt -= k;
    if (pad > cnt) pad = cnt;
  }
  int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = int(buf >> (64 - k));
    drop(k);
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huffman& h) {
    if (!h.present) throw Malformed{"scan uses an undefined Huffman table"};
    if (cnt < 16) fill();
    int peek = int(buf >> 56);
    int len = h.look_len[peek];
    if (len) {
      drop(len);
      return h.look_sym[peek];
    }
    int code = get(8);
    for (len = 9; len <= 16; len++) {
      code = (code << 1) | get(1);
      if (code <= h.maxcode[len])
        return h.vals[h.valptr[len] + code - h.mincode[len]];
    }
    return 0;   // a corrupt code: libjpeg warns and returns 0
  }
  // the next restart marker: drop the bits left in this interval
  void restart() {
    buf = 0;
    cnt = pad = 0;
    bool found;
    pos = seek_restart(d, n, pos, found);
    at_marker = !found;
    if (found) insufficient = false;
  }
};

// jaricom.c: Qe (16 bits) << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS, T.81 Table D.2, and entry 113, a fixed estimate of 0.5
#define QE(qe, nlps, nmps, sw) \
  ((int64_t(qe) << 16) | (int64_t(nmps) << 8) | ((sw) << 7) | (nlps))
const int64_t kAriTab[114] = {
    QE(0x5a1d, 1, 1, 1),     QE(0x2586, 14, 2, 0),    QE(0x1114, 16, 3, 0),
    QE(0x080b, 18, 4, 0),    QE(0x03d8, 20, 5, 0),    QE(0x01da, 23, 6, 0),
    QE(0x00e5, 25, 7, 0),    QE(0x006f, 28, 8, 0),    QE(0x0036, 30, 9, 0),
    QE(0x001a, 33, 10, 0),   QE(0x000d, 35, 11, 0),   QE(0x0006, 9, 12, 0),
    QE(0x0003, 10, 13, 0),   QE(0x0001, 12, 13, 0),   QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 36, 16, 0),   QE(0x2cf2, 38, 17, 0),   QE(0x207c, 39, 18, 0),
    QE(0x17b9, 40, 19, 0),   QE(0x1182, 42, 20, 0),   QE(0x0cef, 43, 21, 0),
    QE(0x09a1, 45, 22, 0),   QE(0x072f, 46, 23, 0),   QE(0x055c, 48, 24, 0),
    QE(0x0406, 49, 25, 0),   QE(0x0303, 51, 26, 0),   QE(0x0240, 52, 27, 0),
    QE(0x01b1, 54, 28, 0),   QE(0x0144, 56, 29, 0),   QE(0x00f5, 57, 30, 0),
    QE(0x00b7, 59, 31, 0),   QE(0x008a, 60, 32, 0),   QE(0x0068, 62, 33, 0),
    QE(0x004e, 63, 34, 0),   QE(0x003b, 32, 35, 0),   QE(0x002c, 33, 9, 0),
    QE(0x5ae1, 37, 37, 1),   QE(0x484c, 64, 38, 0),   QE(0x3a0d, 65, 39, 0),
    QE(0x2ef1, 67, 40, 0),   QE(0x261f, 68, 41, 0),   QE(0x1f33, 69, 42, 0),
    QE(0x19a8, 70, 43, 0),   QE(0x1518, 72, 44, 0),   QE(0x1177, 73, 45, 0),
    QE(0x0e74, 74, 46, 0),   QE(0x0bfb, 75, 47, 0),   QE(0x09f8, 77, 48, 0),
    QE(0x0861, 78, 49, 0),   QE(0x0706, 79, 50, 0),   QE(0x05cd, 48, 51, 0),
    QE(0x04de, 50, 52, 0),   QE(0x040f, 50, 53, 0),   QE(0x0363, 51, 54, 0),
    QE(0x02d4, 52, 55, 0),   QE(0x025c, 53, 56, 0),   QE(0x01f8, 54, 57, 0),
    QE(0x01a4, 55, 58, 0),   QE(0x0160, 56, 59, 0),   QE(0x0125, 57, 60, 0),
    QE(0x00f6, 58, 61, 0),   QE(0x00cb, 59, 62, 0),   QE(0x00ab, 61, 63, 0),
    QE(0x008f, 61, 32, 0),   QE(0x5b12, 65, 65, 1),   QE(0x4d04, 80, 66, 0),
    QE(0x412c, 81, 67, 0),   QE(0x37d8, 82, 68, 0),   QE(0x2fe8, 83, 69, 0),
    QE(0x293c, 84, 70, 0),   QE(0x2379, 86, 71, 0),   QE(0x1edf, 87, 72, 0),
    QE(0x1aa9, 87, 73, 0),   QE(0x174e, 72, 74, 0),   QE(0x1424, 72, 75, 0),
    QE(0x119c, 74, 76, 0),   QE(0x0f6b, 74, 77, 0),   QE(0x0d51, 75, 78, 0),
    QE(0x0bb6, 77, 79, 0),   QE(0x0a40, 77, 48, 0),   QE(0x5832, 80, 81, 1),
    QE(0x4d1c, 88, 82, 0),   QE(0x438e, 89, 83, 0),   QE(0x3bdd, 90, 84, 0),
    QE(0x34ee, 91, 85, 0),   QE(0x2eae, 92, 86, 0),   QE(0x299a, 93, 87, 0),
    QE(0x2516, 86, 71, 0),   QE(0x5570, 88, 89, 1),   QE(0x4ca9, 95, 90, 0),
    QE(0x44d9, 96, 91, 0),   QE(0x3e22, 97, 92, 0),   QE(0x3824, 99, 93, 0),
    QE(0x32b4, 99, 94, 0),   QE(0x2e17, 93, 86, 0),   QE(0x56a8, 95, 96, 1),
    QE(0x4f46, 101, 97, 0),  QE(0x47e5, 102, 98, 0),  QE(0x41cf, 103, 99, 0),
    QE(0x3c3d, 104, 100, 0), QE(0x375e, 99, 93, 0),   QE(0x5231, 105, 102, 0),
    QE(0x4c0f, 106, 103, 0), QE(0x4639, 107, 104, 0), QE(0x415e, 103, 99, 0),
    QE(0x5627, 105, 106, 1), QE(0x50e7, 108, 107, 0), QE(0x4b85, 109, 103, 0),
    QE(0x5597, 110, 109, 0), QE(0x504f, 111, 107, 0), QE(0x5a10, 110, 111, 1),
    QE(0x5522, 112, 109, 0), QE(0x59eb, 112, 111, 1), QE(0x5a1d, 113, 113, 0)};
#undef QE

// jdarith.c: the arithmetic decoder's registers. At a marker it reads zero
// bytes; ct == -1 marks a code the statistics could not hold, after which
// the segment decodes nothing.
struct Arith {
  const uint8_t* d;
  size_t n, pos;
  bool at_marker = false;
  int64_t c = 0, a = 0;
  int ct = -16;

  int decode(uint8_t* st) {
    // renormalization and data input, D.2.6
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = at_marker ? -1 : next_data_byte(d, n, pos);
        if (data < 0) {
          at_marker = true;
          data = 0;
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;   // two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    int nl = int(qe & 0xFF);
    qe >>= 8;
    int nm = int(qe & 0xFF);
    qe >>= 8;
    // decoding and estimation, D.2.4 and D.2.5
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {   // conditional LPS exchange
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {   // conditional MPS exchange
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void restart() {
    bool found;
    pos = seek_restart(d, n, pos, found);
    at_marker = !found;
    c = a = 0;
    ct = -16;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int bw, bh;            // blocks (lossless: samples) stored, the MCU grid's
  int wib, hib;          // blocks that hold image data
  int dw, dh;            // downsampled_width / downsampled_height
  std::vector<int16_t> coef;   // [bh * bw][64], natural order
  int qtable[64];
  bool latched = false;
  int coef_bits[64];
  int prev_coef_bits[10];   // coef_bits before the latest scan that set them
  int dc_pred = 0;
  std::vector<uint8_t> plane;   // bw*8 x bh*8 samples (lossless: bw x bh)
  // lossless
  std::vector<int> diff, undiff;   // [bh][bw]
  bool first_row = true;
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, arithmetic = false, lossless = false;
  bool frame = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int scans = 0;
  int last_good_row = 1 << 30;   // jdcoefct.c last_good_iMCU_row
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  std::vector<Component> comps;
  int qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int dc_L[16], dc_U[16], ac_K[16];   // DAC conditioning
  int eobrun = 0;
  // arithmetic statistics and the scan's DC state
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  int last_dc[4], dc_context[4];

  Decoder() {
    for (int i = 0; i < 16; i++) {
      dc_L[i] = 0;
      dc_U[i] = 1;
      ac_K[i] = 5;
    }
  }

  int u8() {
    if (pos >= n) throw Malformed{"unexpected end of data"};
    return d[pos++];
  }
  int u16() { int a = u8(); return (a << 8) | u8(); }

  void run() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw Malformed{"no SOI marker"};
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0) throw Malformed{"image file is truncated (no EOI marker)"};
      if (m == 0xD9) break;                       // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;       // stray RSTn
      if (m == 0x01) continue;                    // TEM
      int len = u16();
      if (len < 2 || pos + len - 2 > n) throw Malformed{"bad segment length"};
      size_t end = pos + len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          sof(m, end);
          break;
        case 0xCB: throw Malformed{"arithmetic-coded lossless JPEG (SOF11)"};
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        case 0xDE: case 0xDF:
          throw Malformed{"hierarchical JPEG (SOF5-7, SOF13-15, DHP, EXP)"};
        case 0xC8: throw Malformed{"JPG marker (reserved)"};
        case 0xC4: dht(end); break;
        case 0xCC: dac(end); break;
        case 0xDB: dqt(end); break;
        case 0xDD: restart_interval = u16(); break;
        case 0xDA: sos(end); break;
        case 0xDC: throw Malformed{"a height given by a DNL marker"};
        case 0xE0: app0(end); break;
        case 0xEE: app14(end); break;
        default: break;                           // APPn, COM, ...
      }
      pos = end > pos ? end : pos;   // sos() leaves pos after its data
    }
    if (!frame) throw Malformed{"no frame"};
  }

  int next_marker() {
    // the next 0xFF that is not a stuffed byte, past any fill bytes
    for (;;) {
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) return -1;
      int m = d[pos++];
      if (m != 0x00) return m;
    }
  }

  void app0(size_t end) {
    static const uint8_t jfif_id[5] = {'J', 'F', 'I', 'F', 0};
    if (end - pos >= 14 && std::memcmp(d + pos, jfif_id, 5) == 0) jfif = true;
  }
  void app14(size_t end) {
    static const uint8_t id[5] = {'A', 'd', 'o', 'b', 'e'};
    if (end - pos >= 12 && std::memcmp(d + pos, id, 5) == 0) {
      adobe = true;
      adobe_transform = d[pos + 11];
    }
  }

  void sof(int m, size_t end) {
    if (frame) throw Malformed{"second frame"};
    frame = true;
    progressive = m == 0xC2 || m == 0xCA;
    arithmetic = m == 0xC9 || m == 0xCA;
    lossless = m == 0xC3;
    int precision = u8();
    if (precision != 8)
      throw Malformed{"cannot handle " + std::to_string(precision) +
                      "-bit samples"};
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) throw Malformed{"a height given by a DNL marker"};
    if (width == 0) throw Malformed{"zero width"};
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      throw Malformed{"cannot handle " + std::to_string(ncomp) +
                      "-component images"};
    comps.resize(ncomp);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Malformed{"bad sampling factors"};
      if (c.tq > 3) throw Malformed{"bad quantization table index"};
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (pos != end) throw Malformed{"bad SOF length"};
    for (const auto& c : comps)
      if (ncomp > 1 && (hmax % c.h || vmax % c.v))
        throw Malformed{"fractional sampling ratios are not implemented"};
    int unit = lossless ? 1 : 8;   // samples per block side
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.wib = (width * c.h + unit * hmax - 1) / (unit * hmax);
      c.hib = (height * c.v + unit * vmax - 1) / (unit * vmax);
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      if (lossless) {
        c.diff.assign(size_t(c.bw) * c.bh, 0);
        c.undiff.assign(size_t(c.bw) * c.bh, 0);
        c.plane.assign(size_t(c.bw) * c.bh, 0);
      } else {
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
  }

  void dht(size_t end) {
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Malformed{"bad Huffman table index"};
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = uint8_t(u8());
        total += counts[i];
      }
      if (total > 256 || pos + total > end) throw Malformed{"bad Huffman table"};
      (tc ? ac[th] : dc[th]).build(counts, d + pos, total);
      pos += total;
    }
  }

  // jdmarker.c get_dac
  void dac(size_t end) {
    while (pos < end) {
      int index = u8(), val = u8();
      if (index >= 32) throw Malformed{"bad DAC index"};
      if (index >= 16) {   // AC conditioning
        if (val < 1 || val > 63) throw Malformed{"bad DAC value"};
        ac_K[index - 16] = val;
      } else {
        dc_L[index] = val & 15;
        dc_U[index] = val >> 4;
        if (dc_L[index] > dc_U[index]) throw Malformed{"bad DAC value"};
      }
    }
  }

  void dqt(size_t end) {
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw Malformed{"bad quantization table"};
      for (int k = 0; k < 64; k++)
        qt[tq][kNatural[k]] = pq ? u16() : u8();
      qt_present[tq] = true;
    }
  }

  void sos(size_t end) {
    if (!frame) throw Malformed{"scan before the frame"};
    int ns = u8();
    if (ns < 1 || ns > ncomp || ns > 4)
      throw Malformed{"bad scan component count"};
    std::vector<Component*> sc;
    std::vector<int> td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      int cid = u8(), t = u8();
      Component* c = nullptr;
      for (auto& cc : comps)
        if (cc.id == cid) c = &cc;
      if (!c) throw Malformed{"scan names an unknown component"};
      sc.push_back(c);
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (!arithmetic && (td[i] > 3 || ta[i] > 3))
        throw Malformed{"bad table index"};
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (pos != end) throw Malformed{"bad SOS length"};
    scans++;
    if (ns > 1) {
      int blocks = 0;
      for (auto* c : sc) blocks += c->h * c->v;
      if (blocks > kMaxBlocksInMcu) throw Malformed{"bad MCU size"};
    }
    if (lossless) {
      // jdlossls.c start_pass_lossless
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
        throw Malformed{"bad lossless scan parameters"};
      lossless_scan(sc, td, ss, al);
      return;
    }
    if (progressive) {
      bool dc_scan = ss == 0;
      if (dc_scan ? se != 0 : (ss > se || se > 63 || ns != 1))
        throw Malformed{"bad progression parameters"};
      if (al > 13 || (ah && ah != al + 1)) throw Malformed{"bad successive approximation"};
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      ss = 0; se = 63; ah = 0; al = 0;   // libjpeg ignores them in sequential mode
    }
    for (auto* c : sc) {
      if (!c->latched) {   // the table in force at the component's first scan
        if (!qt_present[c->tq]) throw Malformed{"missing quantization table"};
        std::memcpy(c->qtable, qt[c->tq], sizeof(c->qtable));
        c->latched = true;
      }
      c->dc_pred = 0;
      if (progressive) {   // start_pass: the progression status
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          if (k < 10) c->prev_coef_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
      }
    }
    eobrun = 0;
    // arithmetic statistics, per jdarith.c start_pass and process_restart
    auto reset_stats = [&]() {
      for (int i = 0; i < ns; i++) {
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(dc_stats[td[i]], 0, sizeof(dc_stats[0]));
          last_dc[i] = 0;
          dc_context[i] = 0;
        }
        if (!progressive || ss) std::memset(ac_stats[ta[i]], 0, sizeof(ac_stats[0]));
      }
    };
    if (arithmetic) reset_stats();
    Bits bits{d, n, pos};
    Arith ar{d, n, pos};

    // decode one block; false ends the MCU (an arithmetic code error)
    auto block = [&](Component* c, int bx, int by, int i) -> bool {
      int16_t* blk = &c->coef[(size_t(by) * c->bw + bx) * 64];
      if (arithmetic) {
        if (!progressive) return arith_sequential(ar, blk, i, td[i], ta[i]);
        if (ss == 0 && ah == 0) return arith_dc_first(ar, blk, i, td[i], al);
        if (ss == 0) {
          if (ar.decode(fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
          return true;
        }
        if (ah == 0) return arith_ac(ar, blk, ta[i], ss, se, al);
        return arith_ac_refine(ar, blk, ta[i], ss, se, al);
      }
      if (!progressive) decode_sequential(bits, blk, *c, dc[td[i]], ac[ta[i]]);
      else if (ss == 0) decode_dc(bits, blk, *c, dc[td[i]], ah, al);
      else if (ah == 0) decode_ac_first(bits, blk, ac[ta[i]], ss, se, al);
      else decode_ac_refine(bits, blk, ac[ta[i]], ss, se, al);
      return true;
    };
    // at the start of each MCU: the restart marker when the interval is
    // done, then whether the MCU decodes at all
    int togo = restart_interval;
    bool dc_refine = progressive && ss == 0 && ah != 0;
    auto mcu_start = [&]() -> bool {
      if (restart_interval) {
        if (togo == 0) {
          if (arithmetic) {
            ar.restart();
            reset_stats();
          } else {
            bits.restart();
          }
          for (auto* c : sc) c->dc_pred = 0;
          eobrun = 0;
          togo = restart_interval;
        }
        togo--;
      }
      if (arithmetic) return dc_refine || ar.ct != -1;
      return dc_refine || !bits.insufficient;
    };
    // the iMCU row in which the Huffman data ran out: smoothing takes
    // the rows after it with the progression status before this scan
    auto note_end = [&](int imcu_row) {
      if (!arithmetic && bits.insufficient && last_good_row > imcu_row)
        last_good_row = imcu_row;
    };
    if (ns == 1) {
      Component* c = sc[0];
      for (int by = 0; by < c->hib; by++)
        for (int bx = 0; bx < c->wib; bx++)
          if (mcu_start()) {
            block(c, bx, by, 0);
            note_end(by / c->v);
          }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (!mcu_start()) continue;
          note_end(my);
          bool ok = true;
          for (int i = 0; i < ns && ok; i++) {
            Component* c = sc[i];
            for (int y = 0; y < c->v && ok; y++)
              for (int x = 0; x < c->h && ok; x++)
                ok = block(c, mx * c->h + x, my * c->v + y, i);
          }
        }
    }
    // continue after the scan's data: at the marker the reader stopped at
    pos = arithmetic ? ar.pos : bits.pos;
  }

  static void decode_sequential(Bits& b, int16_t* blk, Component& c,
                                const Huffman& dct, const Huffman& act) {
    int s = b.decode(dct);
    int diff = s ? extend(b.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64; k++) {
      int rs = b.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(b.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void decode_dc(Bits& b, int16_t* blk, Component& c,
                        const Huffman& dct, int ah, int al) {
    if (ah == 0) {
      int s = b.decode(dct);
      int diff = s ? extend(b.get(s), s) : 0;
      c.dc_pred += diff;
      blk[0] = int16_t(int(unsigned(c.dc_pred) << al));
    } else if (b.bit()) {
      blk[0] = int16_t(blk[0] | (1 << al));
    }
  }

  void decode_ac_first(Bits& b, int16_t* blk, const Huffman& act, int ss,
                       int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = b.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(int(unsigned(extend(b.get(s), s)) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        eobrun--;
        break;
      }
    }
  }

  void decode_ac_refine(Bits& b, int16_t* blk, const Huffman& act, int ss,
                        int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (b.bit() && (*coef & p1) == 0)
        *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = b.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = b.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t* coef = &blk[kNatural[k]];
          if (*coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = &blk[kNatural[k]];
        if (*coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  // ---- arithmetic decoding (jdarith.c) ----

  // F.1.4.4.1: a DC difference in the statistics of table tbl; false and
  // ct = -1 on a magnitude overflow
  bool arith_dc_diff(Arith& ar, int i, int tbl, int& diff) {
    uint8_t* st = dc_stats[tbl] + dc_context[i];
    diff = 0;
    if (ar.decode(st) == 0) {
      dc_context[i] = 0;
      return true;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < int((1L << dc_L[tbl]) >> 1)) dc_context[i] = 0;
    else if (m > int((1L << dc_U[tbl]) >> 1)) dc_context[i] = 12 + sign * 4;
    else dc_context[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    diff = sign ? -v : v;
    return true;
  }

  // F.1.4.4.2: the AC coefficients ss..se; false and ct = -1 on a spectral
  // or magnitude overflow
  bool arith_ac(Arith& ar, int16_t* blk, int tbl, int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;   // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        k++;
        if (k > se) {
          ar.ct = -1;
          return false;
        }
      }
      int sign = ar.decode(fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0) {
        if (ar.decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= ac_K[tbl] ? 189 : 217);
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) {
              ar.ct = -1;
              return false;
            }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(int(unsigned(v) << al));
    }
    return true;
  }

  bool arith_sequential(Arith& ar, int16_t* blk, int i, int dtbl, int atbl) {
    int diff;
    if (!arith_dc_diff(ar, i, dtbl, diff)) return false;
    last_dc[i] = (last_dc[i] + diff) & 0xffff;
    blk[0] = int16_t(last_dc[i]);
    return arith_ac(ar, blk, atbl, 1, 63, 0);
  }

  bool arith_dc_first(Arith& ar, int16_t* blk, int i, int tbl, int al) {
    int diff;
    if (!arith_dc_diff(ar, i, tbl, diff)) return false;
    last_dc[i] = (last_dc[i] + diff) & 0xffff;
    blk[0] = int16_t(int(unsigned(last_dc[i]) << al));
    return true;
  }

  bool arith_ac_refine(Arith& ar, int16_t* blk, int tbl, int ss, int se,
                       int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;   // EOBx: the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex)
        if (ar.decode(st)) break;   // EOB
      for (;;) {
        int16_t* coef = &blk[kNatural[k]];
        if (*coef) {   // previously nonzero
          if (ar.decode(st + 2))
            *coef = int16_t(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (ar.decode(st + 1)) {   // newly nonzero
          *coef = int16_t(ar.decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        k++;
        if (k > se) {
          ar.ct = -1;
          return false;
        }
      }
    }
    return true;
  }

  // ---- lossless (jdlossls.c, jddiffct.c, jdlhuff.c) ----

  // Decodes one scan's differences an iMCU row at a time and undifferences
  // each row of the components after its iMCU row, as libjpeg-turbo does.
  void lossless_scan(const std::vector<Component*>& sc,
                     const std::vector<int>& td, int psv, int pt) {
    int ns = int(sc.size());
    for (auto* c : sc) c->first_row = true;
    Bits bits{d, n, pos};
    int mcus_per_row = ns > 1 ? mcux : sc[0]->dw;
    int mcu_rows = ns > 1 ? mcuy : sc[0]->dh;
    int rows_per_imcu = ns > 1 ? 1 : sc[0]->v;
    int restart_rows = restart_interval / std::max(mcus_per_row, 1);
    int togo = restart_rows;
    for (int mrow = 0; mrow < mcu_rows; mrow += rows_per_imcu) {
      for (int y = mrow; y < std::min(mrow + rows_per_imcu, mcu_rows); y++) {
        if (restart_interval) {
          if (togo == 0) {
            bits.restart();
            for (auto* c : sc) c->first_row = true;
            togo = restart_rows;
          }
        }
        if (bits.insufficient) {
          // out of data: zero differences, and every component's
          // undifferencer starts over (the output is then CENTERJSAMPLE)
          for (auto* c : sc) {
            int r0 = ns > 1 ? y * c->v : y, r1 = ns > 1 ? r0 + c->v : y + 1;
            for (int r = r0; r < r1; r++)
              std::fill_n(&c->diff[size_t(r) * c->bw], c->bw, 0);
          }
          for (auto& c : comps) c.first_row = true;
        } else {
          for (int x = 0; x < mcus_per_row; x++)
            for (int i = 0; i < ns; i++) {
              Component* c = sc[i];
              int hh = ns > 1 ? c->h : 1, vv = ns > 1 ? c->v : 1;
              for (int yy = 0; yy < vv; yy++)
                for (int xx = 0; xx < hh; xx++) {
                  int s = bits.decode(dc[td[i]]);
                  if (s == 16) s = 32768;
                  else if (s) s = extend(bits.get(s), s);
                  size_t at = size_t(y * vv + yy) * c->bw + x * hh + xx;
                  c->diff[at] = s;
                }
            }
        }
        if (restart_interval) togo--;
      }
      // undifference the iMCU row's sample rows
      for (auto* c : sc) {
        int r0 = ns > 1 ? mrow * c->v : mrow;
        int r1 = std::min(ns > 1 ? r0 + c->v : r0 + rows_per_imcu, c->dh);
        for (int r = r0; r < r1; r++) undifference(*c, r, psv, pt);
      }
    }
    pos = bits.pos;
  }

  static void undifference(Component& c, int r, int psv, int pt) {
    const int* df = &c.diff[size_t(r) * c.bw];
    int* out = &c.undiff[size_t(r) * c.bw];
    uint8_t* px = &c.plane[size_t(r) * c.bw];
    int w = c.dw;
    if (c.first_row) {
      int ra = (df[0] + (1 << (8 - pt - 1))) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; x++) out[x] = ra = (df[x] + ra) & 0xFFFF;
      c.first_row = false;
    } else {
      const int* up = &c.undiff[size_t(r - 1) * c.bw];
      int rb = up[0];
      int ra = (df[0] + rb) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; x++) {
        int rc = rb;
        rb = up[x];
        int p;
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        out[x] = ra = (df[x] + p) & 0xFFFF;
      }
    }
    for (int x = 0; x < w; x++) px[x] = uint8_t(out[x] << pt);
  }

  // ---- the inverse DCT and block smoothing ----

  // jidctint.c's accurate integer IDCT as libjpeg-turbo's x86 SIMD code
  // (jidctint-sse2.asm, -avx2.asm) computes it, which is what PIL runs:
  // 16-bit dequantized coefficients and 16-bit sums where the vector code
  // adds words, 32-bit products, each pass's output saturated to 16 bits and
  // the samples saturated to 8. On coefficients in range this is the C
  // code's result; on garbage it is the vector code's.
  static inline int16_t w16(int32_t x) { return int16_t(uint16_t(uint32_t(x))); }
  static inline int32_t w32(int64_t x) { return int32_t(uint32_t(uint64_t(x))); }
  static inline int32_t sat16(int32_t x) {
    return x < -32768 ? -32768 : x > 32767 ? 32767 : x;
  }
  // one 1-D pass over in[0], in[s], ..., in[7s], descaled by nb bits
  static void idct_1d(const int16_t* in, int s, int32_t* out, int nb) {
    int32_t z2 = in[2 * s], z3 = in[6 * s];
    int32_t tmp3 = w32(int64_t(z2) * 10703 + int64_t(z3) * 4433);
    int32_t tmp2 = w32(int64_t(z2) * 4433 + int64_t(z3) * -10704);
    int32_t tmp0 = int32_t(w16(in[0] + in[4 * s])) * 8192;
    int32_t tmp1 = int32_t(w16(in[0] - in[4 * s])) * 8192;
    int32_t t10 = w32(int64_t(tmp0) + tmp3), t13 = w32(int64_t(tmp0) - tmp3);
    int32_t t11 = w32(int64_t(tmp1) + tmp2), t12 = w32(int64_t(tmp1) - tmp2);
    int32_t o0 = in[7 * s], o1 = in[5 * s], o2 = in[3 * s], o3 = in[s];
    int32_t z3s = w16(o0 + o2), z4s = w16(o1 + o3);
    int32_t z3p = z3s * -6436 + z4s * 9633;
    int32_t z4p = z3s * 9633 + z4s * 6437;
    int32_t a0 = w32(int64_t(o0 * -4927 + o3 * -7373) + z3p);
    int32_t a3 = w32(int64_t(o0 * -7373 + o3 * 4926) + z4p);
    int32_t a1 = w32(int64_t(o1 * -4176 + o2 * -20995) + z4p);
    int32_t a2 = w32(int64_t(o1 * -20995 + o2 * 4177) + z3p);
    int64_t half = int64_t(1) << (nb - 1);
    auto ds = [&](int64_t x) { return w32(x + half) >> nb; };
    out[0] = ds(int64_t(t10) + a3);
    out[7] = ds(int64_t(t10) - a3);
    out[1] = ds(int64_t(t11) + a2);
    out[6] = ds(int64_t(t11) - a2);
    out[2] = ds(int64_t(t12) + a1);
    out[5] = ds(int64_t(t12) - a1);
    out[3] = ds(int64_t(t13) + a0);
    out[4] = ds(int64_t(t13) - a0);
  }
  static void idct(const int16_t* in, const int* q, uint8_t* out, int stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    int16_t deq[64], ws[64];
    bool ac_zero = true;   // rows 1-7 of every column
    for (int k = 0; k < 64; k++) {
      deq[k] = w16(int32_t(in[k]) * q[k]);
      if (k >= 8 && in[k]) ac_zero = false;
    }
    int32_t o[8];
    for (int col = 0; col < 8; col++) {
      if (ac_zero) {
        int16_t v = w16(int32_t(deq[col]) * (1 << PASS1_BITS));
        for (int k = 0; k < 8; k++) ws[8 * k + col] = v;
        continue;
      }
      idct_1d(deq + col, 8, o, CONST_BITS - PASS1_BITS);
      for (int k = 0; k < 8; k++) ws[8 * k + col] = int16_t(sat16(o[k]));
    }
    for (int row = 0; row < 8; row++) {
      idct_1d(ws + 8 * row, 1, o, CONST_BITS + PASS1_BITS + 3);
      uint8_t* op = out + size_t(row) * stride;
      for (int k = 0; k < 8; k++) {
        int32_t v = sat16(o[k]);
        op[k] = uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
      }
    }
  }

  // jdcoefct.c smoothing_ok: a progressive image whose first AC
  // coefficients are not all exact has its blocks smoothed
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const auto& c : comps) {
      for (int k = 0; k < 10; k++)
        if (c.qtable[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+): an estimate of
  // each of the first nine AC coefficients that is still zero and not
  // exact, from the DC values of a 5x5 window of blocks; with no AC data at
  // all, a Gaussian-like interpolation of the DC value too. Rows past the
  // one where a scan's data ran out use the status before that scan.
  void smooth_component(Component& c) {
    size_t pw = size_t(c.bw) * 8;
    int prev_bits[10];
    for (int k = 1; k < 10; k++) prev_bits[k] = scans > 1 ? c.prev_coef_bits[k] : -1;
    const int* q = c.qtable;
    const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9],
                  Q02 = q[2], Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
    auto dcat = [&](int row, int col) -> int {
      return c.coef[(size_t(row) * c.bw + col) * 64];
    };
    // the estimate of a coefficient: rounded num / (Q << 8), clamped below
    // 2^Al when Al bits are missing
    auto estimate = [](int64_t num, int64_t qv, int al) -> int {
      int pred;
      if (num >= 0) {
        pred = int(((qv << 7) + num) / (qv << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((qv << 7) - num) / (qv << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return pred;
    };
    int total = mcuy;   // total_iMCU_rows
    int last_col = c.wib - 1;
    int16_t ws[64];
    for (int irow = 0; irow < total; irow++) {
      const int* cb = irow > last_good_row ? prev_bits : c.coef_bits;
      bool change_dc = true;
      for (int k = 1; k < 10; k++)
        if (cb[k] != -1) change_dc = false;
      int block_rows = c.v;
      if (irow == total - 1) {
        block_rows = c.hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      int image_block_rows = block_rows * total;
      for (int br = 0; br < block_rows; br++) {
        int row = irow * c.v + br;                 // the block row
        int ibr = irow * block_rows + br;          // as jdcoefct.c counts it
        int prev = ibr > 0 ? row - 1 : row;
        int prev2 = ibr > 1 ? row - 2 : prev;
        int next = ibr < image_block_rows - 1 ? row + 1 : row;
        int next2 = ibr < image_block_rows - 2 ? row + 2 : next;
        int DC[26];
        for (int k = 1; k <= 5; k++) {
          DC[k] = dcat(prev2, 0);
          DC[5 + k] = dcat(prev, 0);
          DC[10 + k] = dcat(row, 0);
          DC[15 + k] = dcat(next, 0);
          DC[20 + k] = dcat(next2, 0);
        }
        for (int col = 0; col <= last_col; col++) {
          std::memcpy(ws, &c.coef[(size_t(row) * c.bw + col) * 64], sizeof(ws));
          if (col == 0 && col < last_col) {
            DC[4] = DC[5] = dcat(prev2, 1);
            DC[9] = DC[10] = dcat(prev, 1);
            DC[14] = DC[15] = dcat(row, 1);
            DC[19] = DC[20] = dcat(next, 1);
            DC[24] = DC[25] = dcat(next2, 1);
          }
          if (col + 1 < last_col) {
            DC[5] = dcat(prev2, col + 2);
            DC[10] = dcat(prev, col + 2);
            DC[15] = dcat(row, col + 2);
            DC[20] = dcat(next, col + 2);
            DC[25] = dcat(next2, col + 2);
          }
          const int* D = DC;
          int al;
          if ((al = cb[1]) != 0 && ws[1] == 0) {   // AC01
            int64_t num = Q00 * (change_dc ?
                (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] -
                 13 * D[9] + 3 * D[10] - 3 * D[11] + 38 * D[12] - 38 * D[14] +
                 3 * D[15] - 3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] -
                 D[21] - D[22] + D[24] + D[25]) :
                (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]));
            ws[1] = int16_t(estimate(num, Q01, al));
          }
          if ((al = cb[2]) != 0 && ws[8] == 0) {   // AC10
            int64_t num = Q00 * (change_dc ?
                (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] +
                 13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16] -
                 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
                 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]) :
                (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]));
            ws[8] = int16_t(estimate(num, Q10, al));
          }
          if ((al = cb[3]) != 0 && ws[16] == 0) {   // AC20
            int64_t num = Q00 * (change_dc ?
                (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                 14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] +
                 D[23]) :
                (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]));
            ws[16] = int16_t(estimate(num, Q20, al));
          }
          if ((al = cb[4]) != 0 && ws[9] == 0) {   // AC11
            int64_t num = Q00 * (change_dc ?
                (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] +
                 D[21] - D[25]) :
                (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] +
                 D[22] - D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9]));
            ws[9] = int16_t(estimate(num, Q11, al));
          }
          if ((al = cb[5]) != 0 && ws[2] == 0) {   // AC02
            int64_t num = Q00 * (change_dc ?
                (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] -
                 14 * D[13] + 7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] +
                 2 * D[19]) :
                (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]));
            ws[2] = int16_t(estimate(num, Q02, al));
          }
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0) {   // AC03
              int64_t num = Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] +
                                   D[17] - D[19]);
              ws[3] = int16_t(estimate(num, Q03, al));
            }
            if ((al = cb[7]) != 0 && ws[10] == 0) {   // AC12
              int64_t num = Q00 * (D[7] - 3 * D[8] + D[9] - D[17] +
                                   3 * D[18] - D[19]);
              ws[10] = int16_t(estimate(num, Q12, al));
            }
            if ((al = cb[8]) != 0 && ws[17] == 0) {   // AC21
              int64_t num = Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] +
                                   D[17] - D[19]);
              ws[17] = int16_t(estimate(num, Q21, al));
            }
            if ((al = cb[9]) != 0 && ws[24] == 0) {   // AC30
              int64_t num = Q00 * (D[7] + 2 * D[8] + D[9] - D[17] -
                                   2 * D[18] - D[19]);
              ws[24] = int16_t(estimate(num, Q30, al));
            }
            int64_t num = Q00 *
                (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] -
                 6 * D[6] + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] -
                 8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14] -
                 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
                 6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] -
                 2 * D[25]);
            ws[0] = int16_t(estimate(num, Q00, 0));
          }
          idct(ws, c.qtable, &c.plane[size_t(row) * 8 * pw + size_t(col) * 8],
               int(pw));
          for (int r = 0; r < 5; r++)
            for (int k = 1; k < 5; k++) DC[5 * r + k] = DC[5 * r + k + 1];
        }
      }
    }
  }

  // ---- upsampling and colour conversion ----

  // jdsample.c: the component's samples at full size, [height][width].
  // With fancy upsampling (DCT frames; lossless frames have none), a ratio
  // of exactly 2 is triangle-filtered (h2v1 and h2v2 only where the
  // component is more than 2 samples wide); every other integral ratio
  // replicates samples.
  std::vector<uint8_t> upsample(const Component& c) const {
    int rh = hmax / c.h, rv = vmax / c.v;
    size_t pw = lossless ? size_t(c.bw) : size_t(c.bw) * 8;
    auto at = [&](int x, int y) -> int {
      return c.plane[size_t(y) * pw + x];
    };
    std::vector<uint8_t> out(size_t(width) * height);
    bool fancy = !lossless;
    enum { kBox, kH2V1, kH1V2, kH2V2 } kind = kBox;
    if (fancy && rh == 2 && rv == 1 && c.dw > 2) kind = kH2V1;
    else if (fancy && rh == 1 && rv == 2) kind = kH1V2;
    else if (fancy && rh == 2 && rv == 2 && c.dw > 2) kind = kH2V2;
    for (int y = 0; y < height; y++) {
      int sy = y / rv;
      int ny = sy;   // the nearest other row, for vertical fancy weights
      int vbias = 0;
      if (rv == 2) {
        ny = (y & 1) ? std::min(sy + 1, c.dh - 1) : std::max(sy - 1, 0);
        vbias = (y & 1) ? 1 : 0;
      }
      uint8_t* op = &out[size_t(y) * width];
      for (int x = 0; x < width; x++) {
        int sx = x / rh;
        int v;
        if (kind == kBox) {
          v = at(sx, sy);
        } else if (kind == kH2V1) {
          if (x & 1)
            v = (at(sx, sy) * 3 + at(std::min(sx + 1, c.dw - 1), sy) + 2) >> 2;
          else
            v = (at(sx, sy) * 3 + at(std::max(sx - 1, 0), sy) + 1) >> 2;
        } else if (kind == kH1V2) {
          v = (at(sx, sy) * 3 + at(sx, ny) + 1 + vbias) >> 2;
        } else {
          int nx = (x & 1) ? std::min(sx + 1, c.dw - 1) : std::max(sx - 1, 0);
          int here = at(sx, sy) * 3 + at(sx, ny);
          int there = at(nx, sy) * 3 + at(nx, ny);
          v = (here * 3 + there + ((x & 1) ? 7 : 8)) >> 4;
        }
        op[x] = uint8_t(v);
      }
    }
    return out;
  }

  std::vector<uint8_t> pixels(int& channels) {
    for (auto& c : comps)
      if (!c.latched && !lossless) throw Malformed{"a component with no scan"};
    if (!lossless) {
      bool smooth = smoothing_ok();
      for (auto& c : comps) {
        size_t pw = size_t(c.bw) * 8;
        c.plane.assign(pw * c.bh * 8, 0);
        for (int by = 0; by < c.bh; by++)
          for (int bx = 0; bx < c.bw; bx++)
            idct(&c.coef[(size_t(by) * c.bw + bx) * 64], c.qtable,
                 &c.plane[size_t(by) * 8 * pw + size_t(bx) * 8], int(pw));
        if (smooth) smooth_component(c);
      }
    }
    channels = ncomp;
    std::vector<uint8_t> out(size_t(width) * height * ncomp);
    size_t np = size_t(width) * height;
    if (ncomp == 1) {
      // one component: its own sampling factors are the maximum
      const Component& c = comps[0];
      size_t pw = lossless ? size_t(c.bw) : size_t(c.bw) * 8;
      for (int y = 0; y < height; y++)
        std::memcpy(&out[size_t(y) * width], &c.plane[size_t(y) * pw], width);
      return out;
    }
    // jdapimin.c default_decompress_parms: JFIF means YCbCr, then Adobe's
    // transform, then the component ids; four components are CMYK unless
    // an Adobe marker's transform is not 0 (YCCK)
    bool ycc;
    if (ncomp == 4) ycc = adobe && adobe_transform != 0;
    else if (jfif) ycc = true;
    else if (adobe) ycc = adobe_transform != 0;
    else ycc = !(comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
    if (lossless && ycc)   // jdcolor.c: no colour conversion in lossless mode
      throw Malformed{"colour conversion of a lossless JPEG"};
    std::vector<std::vector<uint8_t>> p;
    for (const auto& c : comps) p.push_back(upsample(c));
    // jdcolor.c build_ycc_rgb_table
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return int64_t(x * (1 << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < np; i++) {
      uint8_t* o = &out[i * ncomp];
      if (!ycc) {
        for (int k = 0; k < ncomp; k++) o[k] = p[k][i];
      } else {
        int y = p[0][i], cb = p[1][i], cr = p[2][i];
        o[0] = clamp(y + cr_r[cr]);
        o[1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        o[2] = clamp(y + cb_b[cb]);
        if (ncomp == 4) {   // ycck_cmyk_convert: 255 - RGB, K as it is
          o[0] = uint8_t(255 - o[0]);
          o[1] = uint8_t(255 - o[1]);
          o[2] = uint8_t(255 - o[2]);
          o[3] = p[3][i];
        }
      }
      if (ncomp == 4)   // PIL's raw mode CMYK;I
        for (int k = 0; k < 4; k++) o[k] = uint8_t(255 - o[k]);
    }
    return out;
  }
};

}  // namespace

extern "C" {

int cpt_jpeg_decode(const uint8_t* data, int64_t n, uint8_t** pixels,
                    int* width, int* height, int* channels, char* err,
                    int err_len) {
  auto fail = [&](int code, const std::string& what) {
    std::snprintf(err, size_t(err_len), "%s", what.c_str());
    return code;
  };
  try {
    Decoder* dec = new Decoder();   // the statistics are too large for a stack
    struct Owner {
      Decoder* p;
      ~Owner() { delete p; }
    } owner{dec};
    dec->d = data;
    dec->n = size_t(n);
    dec->run();
    int c = 0;
    std::vector<uint8_t> px = dec->pixels(c);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(px.size()));
    if (!buf) return fail(2, "out of memory");
    std::memcpy(buf, px.data(), px.size());
    *pixels = buf;
    *width = dec->width;
    *height = dec->height;
    *channels = c;
    return 0;
  } catch (const Malformed& e) {
    return fail(2, e.what);
  } catch (const std::exception& e) {
    return fail(2, e.what());
  }
}

void cpt_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
