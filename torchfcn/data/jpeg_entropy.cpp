// Huffman entropy coding of baseline sequential JPEG scans, for
// torchfcn/data/jpeg.py (loaded with ctypes).  Only the bit-level work lives
// here: the colour transforms, sampling, DCTs and quantisation are numpy.
//
// Coefficient blocks are int16 in natural (row-major) order.  A scan's
// components are described by 6 int32 each:
//   dc table, ac table, MCU width in blocks, MCU height in blocks,
//   the component's row length in blocks, its first block's offset (in
//   blocks) into the coefficient array.
// A non-interleaved scan passes an MCU of 1 x 1 blocks.

#include <cstdint>
#include <cstring>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // past the end: a corrupt run lands here, harmlessly (as libjpeg)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Comp {
  int dc, ac, mcu_w, mcu_h, stride;
  long offset;
};

void read_comps(int ncomp, const int32_t* desc, Comp* comps) {
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* d = desc + 6 * c;
    comps[c] = Comp{d[0], d[1], d[2], d[3], d[4], static_cast<long>(d[5])};
  }
}

// --- decoding ----------------------------------------------------------

struct DecodeTable {
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_decode_table(const uint8_t* bits, const uint8_t* vals,
                        DecodeTable* t) {
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = bits[len - 1];
    t->valoffset[len] = k - code;
    code += n;
    k += n;
    t->maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  std::memcpy(t->vals, vals, 256);
}

struct BitReader {
  const uint8_t* buf;
  long len, pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      unsigned byte = 0;
      if (!at_marker && pos < len) {
        byte = buf[pos];
        if (byte == 0xFF) {
          unsigned next = pos + 1 < len ? buf[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            // a marker ends the entropy-coded data: zeros from here on,
            // as libjpeg feeds them
            at_marker = true;
            byte = 0;
          }
        } else {
          pos += 1;
        }
      }
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }

  int bits(int n) {  // n in 1..16
    if (nbits < n) fill();
    int v = static_cast<int>(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }

  int decode(const DecodeTable& t) {  // -1 on a bad code
    if (nbits < 16) fill();
    int code = 0;
    for (int len = 1; len <= 16; ++len) {
      code = (code << 1) | static_cast<int>(acc >> 63);
      acc <<= 1;
      nbits -= 1;
      if (code <= t.maxcode[len]) return t.vals[code + t.valoffset[len]];
    }
    return -1;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

}  // namespace

extern "C" {

// Decodes one scan from buf[pos:], the byte after its SOS segment.  tables:
// 8 tables of 16 code counts then 256 values (DC 0-3, then AC 0-3).
// Returns the position of the marker that ends the scan, or
//   -1: a bad Huffman code;  -2: a restart marker missing where expected;
//   -3: a block's run past its 64 coefficients.
long tf_jpeg_decode_scan(const uint8_t* buf, long len, long pos, int ncomp,
                         const int32_t* desc, const uint8_t* tables,
                         int mcus_x, int mcus_y, int restart_interval,
                         int16_t* coefs) {
  Comp comps[4];
  read_comps(ncomp, desc, comps);
  static thread_local DecodeTable dec[8];
  for (int t = 0; t < 8; ++t)
    build_decode_table(tables + 272 * t, tables + 272 * t + 16, &dec[t]);
  BitReader r{buf, len, pos};
  int pred[4] = {0, 0, 0, 0};
  long mcu = 0, total = static_cast<long>(mcus_x) * mcus_y;
  for (; mcu < total; ++mcu) {
    if (restart_interval && mcu && mcu % restart_interval == 0) {
      // discard the padding bits, then read RSTn (after any fill bytes)
      r.acc = 0;
      r.nbits = 0;
      long p = r.pos;
      while (p < len && buf[p] == 0xFF) ++p;
      if (p >= len || buf[p] < 0xD0 || buf[p] > 0xD7) return -2;
      r.pos = p + 1;
      r.at_marker = false;
      std::memset(pred, 0, sizeof(pred));
    }
    long my = mcu / mcus_x, mx = mcu % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      const Comp& k = comps[c];
      for (int v = 0; v < k.mcu_h; ++v) {
        for (int h = 0; h < k.mcu_w; ++h) {
          long row = my * k.mcu_h + v, col = mx * k.mcu_w + h;
          int16_t* blk = coefs + 64 * (k.offset + row * k.stride + col);
          int s = r.decode(dec[k.dc]);
          if (s < 0) return -1;
          if (s) pred[c] += extend(r.bits(s), s);
          blk[0] = static_cast<int16_t>(pred[c]);
          for (int i = 1; i < 64; ++i) {
            int rs = r.decode(dec[4 + k.ac]);
            if (rs < 0) return -1;
            int run = rs >> 4;
            s = rs & 15;
            if (s) {
              i += run;
              if (i > 63) return -3;
              blk[kNatural[i]] = static_cast<int16_t>(extend(r.bits(s), s));
            } else if (run == 15) {
              i += 15;
            } else {
              break;
            }
          }
        }
      }
    }
  }
  // the scan ends at the next marker: skip what is left of its data
  long p = r.pos;
  while (p + 1 < len && !(buf[p] == 0xFF && buf[p + 1] != 0x00 &&
                          (buf[p + 1] < 0xD0 || buf[p + 1] > 0xD7)))
    ++p;
  return p;
}

// Encodes one scan (no restart markers) into out[0:cap].  codes / sizes:
// the scan's Huffman tables as code words and lengths of each of 256
// symbols, DC tables first (one per distinct dc index), then AC, both in
// 256-entry rows indexed by the descriptors' table numbers (DC t at row t,
// AC t at row 4 + t).  The last byte is padded with 1-bits.  Returns the
// bytes written, or -1 if cap is too small.
long tf_jpeg_encode_scan(const int16_t* coefs, int ncomp, const int32_t* desc,
                         const uint32_t* codes, const uint8_t* sizes,
                         int mcus_x, int mcus_y, uint8_t* out, long cap) {
  Comp comps[4];
  read_comps(ncomp, desc, comps);
  uint64_t acc = 0;
  int nbits = 0;
  long n = 0;
  bool overflow = false;
  auto put = [&](uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t byte = static_cast<uint8_t>(acc >> (nbits - 8));
      nbits -= 8;
      if (n + 2 > cap) {
        overflow = true;
        return;
      }
      out[n++] = byte;
      if (byte == 0xFF) out[n++] = 0x00;
    }
  };
  auto symbol = [&](int table, int sym) {
    put(codes[256 * table + sym], sizes[256 * table + sym]);
  };
  int pred[4] = {0, 0, 0, 0};
  for (long my = 0; my < mcus_y; ++my) {
    for (long mx = 0; mx < mcus_x; ++mx) {
      for (int c = 0; c < ncomp; ++c) {
        const Comp& k = comps[c];
        for (int v = 0; v < k.mcu_h; ++v) {
          for (int h = 0; h < k.mcu_w; ++h) {
            long row = my * k.mcu_h + v, col = mx * k.mcu_w + h;
            const int16_t* blk =
                coefs + 64 * (k.offset + row * k.stride + col);
            int t = blk[0] - pred[c], t2 = t;
            pred[c] = blk[0];
            if (t < 0) {
              t = -t;
              t2 -= 1;
            }
            int nb = 0;
            while (t) {
              ++nb;
              t >>= 1;
            }
            symbol(k.dc, nb);
            if (nb) put(static_cast<uint32_t>(t2), nb);
            int run = 0;
            for (int i = 1; i < 64; ++i) {
              t = blk[kNatural[i]];
              if (t == 0) {
                ++run;
                continue;
              }
              while (run > 15) {
                symbol(4 + k.ac, 0xF0);
                run -= 16;
              }
              t2 = t;
              if (t < 0) {
                t = -t;
                t2 -= 1;
              }
              nb = 0;
              while (t) {
                ++nb;
                t >>= 1;
              }
              symbol(4 + k.ac, (run << 4) + nb);
              put(static_cast<uint32_t>(t2), nb);
              run = 0;
            }
            if (run > 0) symbol(4 + k.ac, 0);
            if (overflow) return -1;
          }
        }
      }
    }
  }
  if (nbits > 0) put(0x7F, 7);  // pad the last byte with 1-bits
  return overflow ? -1 : n;
}

}  // extern "C"
