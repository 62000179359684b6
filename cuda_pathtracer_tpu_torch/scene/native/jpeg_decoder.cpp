// A host decoder of baseline and progressive JPEG, for textures and skies
// (scene/jpeg.py binds it with ctypes). Its target is the uint8 output of
// libjpeg(-turbo) at its default settings, which is what PIL returns: the
// accurate integer IDCT (jidctint.c), fancy (triangle) upsampling with its
// alternating rounding biases and replicated edges (jdsample.c), and the
// fixed-point YCbCr -> RGB tables (jdcolor.c), all in the same integer
// arithmetic, so the output is the same bit for bit.
//
// Supported: SOF0, SOF1 and SOF2 (progressive: spectral selection and
// successive approximation), 8-bit samples, one component (grey) or three
// (YCbCr, or RGB after an Adobe marker of transform 0 or component ids
// 'R' 'G' 'B') with sampling factors of 1 or 2 per axis, restart intervals,
// any APPn and COM markers. Refused with the feature named: arithmetic
// coding, 12-bit samples, lossless and hierarchical frames, four components
// (CMYK, YCCK), other sampling factors, DNL heights, and progressive files
// whose first coefficients are not all refined (libjpeg smooths those).
//
// C interface: cpt_jpeg_decode(data, n, &pixels, &w, &h, &c, err, err_len)
// returns 0 and a malloc'ed [h, w, c] uint8 buffer (free it with
// cpt_jpeg_free), 1 for an unsupported feature or 2 for a malformed file,
// with the reason in err.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Unsupported { std::string what; };
struct Malformed { std::string what; };

// zigzag index -> natural index, with 16 guard entries for corrupt runs
const int kNatural[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

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

// Entropy-coded bits: 0xFF 0x00 is a stuffed 0xFF; at a marker the reader
// stops and feeds zeros, as libjpeg does.
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t next = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = int(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huffman& h) {
    if (!h.present) throw Malformed{"scan uses an undefined Huffman table"};
    if (cnt < 16) fill();
    int peek = int(buf >> 56);
    int len = h.look_len[peek];
    if (len) {
      buf <<= len;
      cnt -= len;
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
    cnt = 0;
    at_marker = false;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 &&
                            d[pos + 1] <= 0xD7)) {
      if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF)
        return;   // another marker: no restart marker here
      pos++;
    }
    if (pos + 1 < n) pos += 2;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int bw, bh;            // blocks stored (the MCU grid's)
  int wib, hib;          // blocks that hold image data (non-interleaved scans)
  int dw, dh;            // downsampled_width / downsampled_height
  std::vector<int16_t> coef;   // [bh * bw][64], natural order
  int qtable[64];
  bool latched = false;
  int coef_bits[64];
  int dc_pred = 0;
  std::vector<uint8_t> plane;   // bw*8 x bh*8 samples after the IDCT
};

struct Decoder {
  const uint8_t* d;
  size_t n, pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, frame = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  std::vector<Component> comps;
  int qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int eobrun = 0;

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
      if (m == 0xD9) break;                       // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;       // stray RSTn
      if (m == 0x01) continue;                    // TEM
      int len = u16();
      if (len < 2 || pos + len - 2 > n) throw Malformed{"bad segment length"};
      size_t end = pos + len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: sof(m, end); break;
        case 0xC3: throw Unsupported{"lossless JPEG (SOF3)"};
        case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
          throw Unsupported{"hierarchical JPEG (SOF5-7, DHP, EXP)"};
        case 0xC9: case 0xCA: case 0xCB: case 0xCC:
        case 0xCD: case 0xCE: case 0xCF:
          throw Unsupported{"arithmetic-coded JPEG (SOF9-15, DAC)"};
        case 0xC4: dht(end); break;
        case 0xDB: dqt(end); break;
        case 0xDD: restart_interval = u16(); break;
        case 0xDA: sos(end); break;
        case 0xDC: throw Unsupported{"a height given by a DNL marker"};
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
      if (pos >= n) return 0xD9;   // no EOI: libjpeg ends here too
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
    progressive = m == 0xC2;
    int precision = u8();
    if (precision != 8)
      throw Unsupported{std::to_string(precision) + "-bit samples"};
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) throw Unsupported{"a height given by a DNL marker"};
    if (width == 0) throw Malformed{"zero width"};
    if (ncomp == 4) throw Unsupported{"four-component JPEG (CMYK or YCCK)"};
    if (ncomp != 1 && ncomp != 3)
      throw Unsupported{std::to_string(ncomp) + "-component JPEG"};
    comps.resize(ncomp);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        throw Unsupported{"sampling factors other than 1 or 2"};
      if (c.tq > 3) throw Malformed{"bad quantization table index"};
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (pos != end) throw Malformed{"bad SOF length"};
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.wib = (width * c.h + 8 * hmax - 1) / (8 * hmax);
      c.hib = (height * c.v + 8 * vmax - 1) / (8 * vmax);
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
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
    if (ns < 1 || ns > ncomp) throw Malformed{"bad scan component count"};
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
      if (td[i] > 3 || ta[i] > 3) throw Malformed{"bad table index"};
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (pos != end) throw Malformed{"bad SOS length"};
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
      if (progressive)
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
    }
    eobrun = 0;
    Bits bits{d, n, pos};

    auto block = [&](Component* c, int bx, int by, int i) {
      int16_t* blk = &c->coef[(size_t(by) * c->bw + bx) * 64];
      if (!progressive) decode_sequential(bits, blk, *c, dc[td[i]], ac[ta[i]]);
      else if (ss == 0) decode_dc(bits, blk, *c, dc[td[i]], ah, al);
      else if (ah == 0) decode_ac_first(bits, blk, ac[ta[i]], ss, se, al);
      else decode_ac_refine(bits, blk, ac[ta[i]], ss, se, al);
    };
    int todo = restart_interval;
    auto between_mcus = [&](bool last) {
      if (!restart_interval || last) return;
      if (--todo == 0) {
        bits.restart();
        for (auto* c : sc) c->dc_pred = 0;
        eobrun = 0;
        todo = restart_interval;
      }
    };
    if (ns == 1) {
      Component* c = sc[0];
      int total = c->wib * c->hib;
      for (int by = 0, k = 0; by < c->hib; by++)
        for (int bx = 0; bx < c->wib; bx++, k++) {
          block(c, bx, by, 0);
          between_mcus(k + 1 == total);
        }
    } else {
      int total = mcux * mcuy;
      for (int my = 0, k = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++, k++) {
          for (int i = 0; i < ns; i++) {
            Component* c = sc[i];
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++)
                block(c, mx * c->h + x, my * c->v + y, i);
          }
          between_mcus(k + 1 == total);
        }
    }
    // continue after the scan's data: at the marker the reader stopped at
    pos = bits.pos;
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

  // jidctint.c: jpeg_idct_islow, 8-bit samples
  static void idct(const int16_t* in, const int* q, uint8_t* out, int stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int nb) {
      return (x + (int64_t(1) << (nb - 1))) >> nb;
    };
    auto limit = [](int64_t x) -> uint8_t {
      int i = int(x) & 1023;   // RANGE_MASK, then the post-IDCT table
      if (i < 128) return uint8_t(i + 128);
      if (i < 512) return 255;
      if (i < 896) return 0;
      return uint8_t(i - 896);
    };
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const int* qp = q + col;
      int* wp = ws + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
          !ip[56]) {
        int dcval = int(unsigned(ip[0] * qp[0]) << PASS1_BITS);
        for (int k = 0; k < 8; k++) wp[8 * k] = dcval;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int nb = CONST_BITS - PASS1_BITS;
      wp[0] = int(descale(tmp10 + tmp3, nb));
      wp[56] = int(descale(tmp10 - tmp3, nb));
      wp[8] = int(descale(tmp11 + tmp2, nb));
      wp[48] = int(descale(tmp11 - tmp2, nb));
      wp[16] = int(descale(tmp12 + tmp1, nb));
      wp[40] = int(descale(tmp12 - tmp1, nb));
      wp[24] = int(descale(tmp13 + tmp0, nb));
      wp[32] = int(descale(tmp13 - tmp0, nb));
    }
    const int nb = CONST_BITS + PASS1_BITS + 3;
    for (int row = 0; row < 8; row++) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + size_t(row) * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = limit(descale(wp[0], PASS1_BITS + 3));
        for (int k = 0; k < 8; k++) op[k] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      op[0] = limit(descale(tmp10 + tmp3, nb));
      op[7] = limit(descale(tmp10 - tmp3, nb));
      op[1] = limit(descale(tmp11 + tmp2, nb));
      op[6] = limit(descale(tmp11 - tmp2, nb));
      op[2] = limit(descale(tmp12 + tmp1, nb));
      op[5] = limit(descale(tmp12 - tmp1, nb));
      op[3] = limit(descale(tmp13 + tmp0, nb));
      op[4] = limit(descale(tmp13 - tmp0, nb));
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths a progressive image whose
  // first AC coefficients are not all refined; that is not reproduced
  void check_refined() const {
    if (!progressive) return;
    static const int first[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const auto& c : comps) {
      for (int k = 0; k < 10; k++)
        if (c.qtable[first[k]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      throw Unsupported{"a progressive JPEG whose first coefficients are "
                        "not all refined (libjpeg block smoothing)"};
  }

  // jdsample.c: the component's samples at full size, [height][width]
  std::vector<uint8_t> upsample(const Component& c) const {
    int rh = hmax / c.h, rv = vmax / c.v;
    size_t pw = size_t(c.bw) * 8;
    auto at = [&](int x, int y) -> int {
      return c.plane[size_t(y) * pw + x];
    };
    std::vector<uint8_t> out(size_t(width) * height);
    bool fancy_h = c.dw > 2;
    for (int y = 0; y < height; y++) {
      int sy = y / rv;
      int ny = sy;   // the nearest other row, for vertical fancy weights
      int vbias = 0;
      if (rv == 2) {
        ny = (y & 1) ? std::min(sy + 1, c.dh - 1) : std::max(sy - 1, 0);
        vbias = (y & 1) ? 1 : 0;
      }
      for (int x = 0; x < width; x++) {
        int sx = x / rh;
        int v;
        if (rh == 1 && rv == 1) {
          v = at(sx, sy);
        } else if (rh == 2 && rv == 1) {
          if (!fancy_h) {
            v = at(sx, sy);
          } else if (x & 1) {
            v = (at(sx, sy) * 3 + at(std::min(sx + 1, c.dw - 1), sy) + 2) >> 2;
          } else {
            v = (at(sx, sy) * 3 + at(std::max(sx - 1, 0), sy) + 1) >> 2;
          }
        } else if (rh == 1) {   // h1v2, always fancy
          v = (at(sx, sy) * 3 + at(sx, ny) + 1 + vbias) >> 2;
        } else if (!fancy_h) {  // h2v2 on a narrow image: a box
          v = at(sx, sy);
        } else {
          int nx = (x & 1) ? std::min(sx + 1, c.dw - 1) : std::max(sx - 1, 0);
          int here = at(sx, sy) * 3 + at(sx, ny);
          int there = at(nx, sy) * 3 + at(nx, ny);
          v = (here * 3 + there + ((x & 1) ? 7 : 8)) >> 4;
        }
        out[size_t(y) * width + x] = uint8_t(v);
      }
    }
    return out;
  }

  std::vector<uint8_t> pixels(int& channels) {
    check_refined();
    for (auto& c : comps) {
      if (!c.latched) throw Malformed{"a component with no scan"};
      size_t pw = size_t(c.bw) * 8;
      c.plane.assign(pw * c.bh * 8, 0);
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct(&c.coef[(size_t(by) * c.bw + bx) * 64], c.qtable,
               &c.plane[size_t(by) * 8 * pw + size_t(bx) * 8], int(pw));
    }
    channels = ncomp;
    std::vector<uint8_t> out(size_t(width) * height * ncomp);
    if (ncomp == 1) {
      // one component: its own sampling factors are the maximum
      const Component& c = comps[0];
      size_t pw = size_t(c.bw) * 8;
      for (int y = 0; y < height; y++)
        std::memcpy(&out[size_t(y) * width], &c.plane[size_t(y) * pw], width);
      return out;
    }
    std::vector<uint8_t> p0 = upsample(comps[0]), p1 = upsample(comps[1]),
                         p2 = upsample(comps[2]);
    // jdapimin.c default_decompress_parms: JFIF means YCbCr, then Adobe's
    // transform, then the component ids
    bool rgb;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
    size_t np = size_t(width) * height;
    if (rgb) {
      for (size_t i = 0; i < np; i++) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return out;
    }
    // jdcolor.c build_ycc_rgb_table, ycc_rgb_convert
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
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
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
    Decoder dec;
    dec.d = data;
    dec.n = size_t(n);
    dec.run();
    int c = 0;
    std::vector<uint8_t> px = dec.pixels(c);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(px.size()));
    if (!buf) return fail(2, "out of memory");
    std::memcpy(buf, px.data(), px.size());
    *pixels = buf;
    *width = dec.width;
    *height = dec.height;
    *channels = c;
    return 0;
  } catch (const Unsupported& e) {
    return fail(1, e.what);
  } catch (const Malformed& e) {
    return fail(2, e.what);
  } catch (const std::exception& e) {
    return fail(2, e.what());
  }
}

void cpt_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
