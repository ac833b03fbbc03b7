// Host image I/O of the PyTorch port: a JPEG decoder, the bilinear resize
// and threaded batch decode of faithdiff_tpu/native.py, and the host-side
// Gaussian tile merge. Plain C++17 and the standard library: it links no
// libjpeg, libpng or zlib (the GPU machine has none of them). Built by the
// host compiler at first use (ops/_build.py) and called through ctypes
// (utils/jpeg.py, native.py).
//
// The decoder reproduces what Pillow's `Image.open(p).convert("RGB")` gives
// through libjpeg-turbo's default decompression settings, byte for byte:
// - baseline and extended sequential (SOF0 / SOF1) and progressive (SOF2)
//   Huffman JPEG, 8-bit samples, 1 or 3 components, restart intervals;
// - the accurate integer IDCT (jidctint.c, jpeg_idct_islow), with the
//   output clamped to 0..255 (the SIMD routines' saturation);
// - libjpeg's upsampler choice (jdsample.c, jinit_upsampler): "fancy"
//   triangle filters for 2h1v (h2v1_fancy_upsample), 1h2v
//   (h1v2_fancy_upsample) and 2h2v (h2v2_fancy_upsample) components, box
//   replication for 2h components at most 2 samples wide and for other
//   integral ratios; the row above the first and below the last row of a
//   component repeat its edge row (jdmainct.c's context pointers);
// - the fixed-point YCbCr -> RGB tables of jdcolor.c (build_ycc_rgb_table);
//   the colour space from the JFIF / Adobe markers and the component ids
//   (jdapimin.c, default_decompress_parms); gray replicated to RGB.
// EXIF orientation and ICC profiles are ignored, as `convert("RGB")` does.
// It refuses, with a message, what it does not decode: arithmetic coding,
// lossless and hierarchical processes, 12-bit samples, CMYK / YCCK (4
// components), a progressive file whose first AC coefficients are left
// unrefined (libjpeg would smooth its blocks), and any truncated or
// malformed stream.
//
// C ABI:
//   fd_jpeg_info / fd_jpeg_decode        one JPEG from memory
//   fd_decode_resize_batch               JPEG files and decoded pixels,
//                                        bilinear-resized, on a thread pool
//   fd_tile_merge                        the Gaussian tile merge
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// JPEG decoding
// ---------------------------------------------------------------------------

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

const char* const kLeft = " (ROADMAP §1.1: not decoded by the port)";

// zigzag index -> natural (row-major) index
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  // canonical decode (jdhuff.c): maxcode[l] is the largest code of length
  // l (-1 if none), valptr[l] the index of its first value
  int32_t maxcode[17];
  int32_t mincode[17];
  int valptr[17];
  uint8_t values[256];
  // 9-bit lookahead: (length << 8) | value, 0 if the code is longer
  uint16_t fast[512];
};

void build_huffman(Huffman* h, const uint8_t* counts, const uint8_t* values,
                   int n_values) {
  std::memset(h->fast, 0, sizeof(h->fast));
  std::memcpy(h->values, values, n_values);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h->valptr[len] = k;
    h->mincode[len] = code;
    code += counts[len - 1];
    k += counts[len - 1];
    if (counts[len - 1]) {
      h->maxcode[len] = code - 1;
    } else {
      h->maxcode[len] = -1;
    }
    if (code > (1 << len)) fail("bad Huffman table");
    code <<= 1;
  }
  // the lookahead table
  code = 0;
  k = 0;
  for (int len = 1; len <= 9; ++len) {
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      const int shift = 9 - len;
      for (int j = 0; j < (1 << shift); ++j)
        h->fast[(code << shift) | j] = static_cast<uint16_t>((len << 8) | values[k]);
    }
    code <<= 1;
  }
  h->defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_table = 0, ac_table = 0;
  int dw = 0, dh = 0;             // downsampled size (jdinput.c)
  int bw = 0, bh = 0;             // blocks, padded to whole MCUs
  bool quant_latched = false;
  uint16_t quant[64];             // natural order, latched at first scan
  std::vector<int16_t> coef;      // bw * bh blocks of 64, natural order
  int dc_pred = 0;
  int coef_bits[64];              // progressive: last Al of each coefficient
  std::vector<uint8_t> plane;     // bw * 8 x bh * 8 samples after the IDCT
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t pos)
      : data_(data), size_(size), pos_(pos) {}

  // next byte of entropy-coded data, or 0 past a marker (or the end)
  uint32_t next_byte() {
    if (marker_hit_) return 0;
    if (pos_ >= size_) {
      marker_hit_ = true;
      return 0;
    }
    const uint8_t b = data_[pos_];
    if (b != 0xFF) {
      ++pos_;
      return b;
    }
    // 0xFF: a stuffed zero, fill bytes, or a marker
    size_t p = pos_ + 1;
    while (p < size_ && data_[p] == 0xFF) ++p;
    if (p < size_ && data_[p] == 0x00) {
      pos_ = p + 1;
      return 0xFF;
    }
    marker_hit_ = true;       // leave pos_ on the marker's first 0xFF
    return 0;
  }

  void fill(int n) {
    while (bits_ < n) {
      const bool before = marker_hit_;
      acc_ = (acc_ << 8) | next_byte();
      if (before || marker_hit_) padding_ += 8;
      bits_ += 8;
    }
  }

  // bits consumed past the end of the segment mean a truncated stream
  void consume(int n) {
    bits_ -= n;
    if (bits_ < padding_) fail("truncated or corrupt entropy-coded data");
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    fill(n);
    const int v = static_cast<int>((acc_ >> (bits_ - n)) & ((1u << n) - 1));
    consume(n);
    return v;
  }

  int get_bit() { return get_bits(1); }

  int decode(const Huffman& h) {
    if (!h.defined) fail("scan uses an undefined Huffman table");
    fill(16);
    const uint32_t peek = static_cast<uint32_t>(acc_ >> (bits_ - 16)) & 0xFFFF;
    const uint16_t f = h.fast[peek >> 7];
    if (f) {
      consume(f >> 8);
      return f & 0xFF;
    }
    for (int len = 10; len <= 16; ++len) {
      const int code = static_cast<int>(peek >> (16 - len));
      if (code <= h.maxcode[len]) {
        consume(len);
        return h.values[h.valptr[len] + code - h.mincode[len]];
      }
    }
    fail("bad Huffman code");
  }

  // restart: drop the buffered bits and step over the expected RSTn marker
  void restart(int expected) {
    acc_ = 0;
    bits_ = 0;
    padding_ = 0;
    marker_hit_ = false;
    size_t p = pos_;
    if (p + 1 >= size_ || data_[p] != 0xFF) fail("missing restart marker");
    while (p < size_ && data_[p] == 0xFF) ++p;
    if (p >= size_ || data_[p] != 0xD0 + expected) fail("wrong restart marker");
    pos_ = p + 1;
  }

  // after a scan: the position of the marker that ends it
  size_t end_of_scan() {
    size_t p = pos_;
    while (p + 1 < size_) {
      if (data_[p] == 0xFF && data_[p + 1] != 0x00 && data_[p + 1] != 0xFF &&
          !(data_[p + 1] >= 0xD0 && data_[p + 1] <= 0xD7))
        return p;
      ++p;
    }
    return size_;
  }

 private:
  const uint8_t* data_;
  size_t size_, pos_;
  uint64_t acc_ = 0;
  int bits_ = 0, padding_ = 0;
  bool marker_hit_ = false;
};

// HUFF_EXTEND: an s-bit magnitude r as a signed value
inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

struct Jpeg {
  int width = 0, height = 0;
  bool progressive = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
};

uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

void read_frame(Jpeg* j, const uint8_t* p, int len, int marker) {
  if (len < 6) fail("short SOF segment");
  if (p[0] != 8)
    fail(std::to_string(p[0]) + "-bit samples" + kLeft);
  j->height = be16(p + 1);
  j->width = be16(p + 3);
  const int nc = p[5];
  if (j->height == 0) fail("a height set by a DNL marker" + std::string(kLeft));
  if (j->width == 0) fail("zero image width");
  if (nc == 4) fail("a CMYK / YCCK JPEG (4 components)" + std::string(kLeft));
  if (nc != 1 && nc != 3) fail(std::to_string(nc) + " components" + kLeft);
  if (len < 6 + 3 * nc) fail("short SOF segment");
  if (j->frame) fail("two frames");
  j->frame = true;
  j->progressive = marker == 0xC2;
  j->comps.resize(nc);
  for (int i = 0; i < nc; ++i) {
    Component& c = j->comps[i];
    c.id = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail("bad component sampling or quantization table");
    j->hmax = std::max(j->hmax, c.h);
    j->vmax = std::max(j->vmax, c.v);
  }
  const long long pixels = static_cast<long long>(j->width) * j->height;
  if (pixels > (1LL << 30)) fail("image too large");
  j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (Component& c : j->comps) {
    c.dw = static_cast<int>((static_cast<long long>(j->width) * c.h + j->hmax - 1) / j->hmax);
    c.dh = static_cast<int>((static_cast<long long>(j->height) * c.v + j->vmax - 1) / j->vmax);
    c.bw = j->mcux * c.h;
    c.bh = j->mcuy * c.v;
    c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    std::fill(c.coef_bits, c.coef_bits + 64, -1);
  }
}

void read_dqt(Jpeg* j, const uint8_t* p, int len) {
  int off = 0;
  while (off < len) {
    const int pq = p[off] >> 4, tq = p[off] & 15;
    if (tq > 3 || pq > 1) fail("bad DQT segment");
    const int n = pq ? 128 : 64;
    if (off + 1 + n > len) fail("short DQT segment");
    for (int i = 0; i < 64; ++i)
      j->qt[tq][kZigzag[i]] = pq ? be16(p + off + 1 + 2 * i) : p[off + 1 + i];
    j->qt_defined[tq] = true;
    off += 1 + n;
  }
}

void read_dht(Jpeg* j, const uint8_t* p, int len) {
  int off = 0;
  while (off < len) {
    if (off + 17 > len) fail("short DHT segment");
    const int tc = p[off] >> 4, th = p[off] & 15;
    if (tc > 1 || th > 3) fail("bad DHT segment");
    int n = 0;
    for (int i = 0; i < 16; ++i) n += p[off + 1 + i];
    if (n > 256 || off + 17 + n > len) fail("bad DHT segment");
    build_huffman(tc ? &j->ac[th] : &j->dc[th], p + off + 1, p + off + 17, n);
    off += 17 + n;
  }
}

struct Scan {
  std::vector<int> comps;         // indices into Jpeg::comps
  int ss = 0, se = 63, ah = 0, al = 0;
};

int16_t* block_at(Component& c, int bx, int by) {
  return c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
}

// one block of a sequential scan (jdhuff.c, decode_mcu)
void decode_block_sequential(BitReader& br, Jpeg& j, Component& c, int16_t* blk) {
  int s = br.decode(j.dc[c.dc_table]);
  if (s > 16) fail("bad DC magnitude");
  const int diff = s ? extend(br.get_bits(s), s) : 0;
  c.dc_pred += diff;
  blk[0] = static_cast<int16_t>(c.dc_pred);
  const Huffman& ac = j.ac[c.ac_table];
  for (int k = 1; k < 64; ++k) {
    const int rs = br.decode(ac);
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) fail("AC coefficients past the block");
      blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get_bits(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// progressive scans (jdphuff.c)
void decode_dc_first(BitReader& br, Jpeg& j, Component& c, int16_t* blk, int al) {
  const int s = br.decode(j.dc[c.dc_table]);
  if (s > 16) fail("bad DC magnitude");
  const int diff = s ? extend(br.get_bits(s), s) : 0;
  c.dc_pred += diff;
  blk[0] = static_cast<int16_t>(c.dc_pred * (1 << al));
}

void decode_dc_refine(BitReader& br, int16_t* blk, int al) {
  if (br.get_bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
}

void decode_ac_first(BitReader& br, const Huffman& ac, int16_t* blk, int ss,
                     int se, int al, int* eobrun) {
  if (*eobrun > 0) {
    --*eobrun;
    return;
  }
  for (int k = ss; k <= se; ++k) {
    const int rs = br.decode(ac);
    const int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) fail("AC coefficients past the block");
      blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get_bits(s), s) * (1 << al));
    } else {
      if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br.get_bits(r);
        --*eobrun;
        break;
      }
    }
  }
}

void decode_ac_refine(BitReader& br, const Huffman& ac, int16_t* blk, int ss,
                      int se, int al, int* eobrun) {
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  int k = ss;
  if (*eobrun == 0) {
    for (; k <= se; ++k) {
      const int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) fail("bad AC refinement magnitude");
        s = br.get_bit() ? p1 : m1;
      } else if (r != 15) {
        *eobrun = 1 << r;
        if (r) *eobrun += br.get_bits(r);
        break;
      }
      do {
        int16_t* coef = blk + kZigzag[k];
        if (*coef != 0) {
          if (br.get_bit() && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= se);
      if (s) {
        if (k > 63) fail("AC coefficients past the block");
        blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
  }
  if (*eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t* coef = blk + kZigzag[k];
      if (*coef != 0 && br.get_bit() && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    --*eobrun;
  }
}

// Decodes the scan that starts at data[pos] (after its SOS header); returns
// the position of the marker after its entropy-coded data.
size_t decode_scan(Jpeg& j, const Scan& sc, const uint8_t* data, size_t size,
                   size_t pos) {
  for (int ci : sc.comps) {
    Component& c = j.comps[ci];
    if (!c.quant_latched) {
      if (!j.qt_defined[c.tq]) fail("scan before its quantization table");
      std::memcpy(c.quant, j.qt[c.tq], sizeof(c.quant));
      c.quant_latched = true;
    }
    c.dc_pred = 0;
  }
  BitReader br(data, size, pos);
  const bool single = sc.comps.size() == 1;
  int units_x, units_y;
  if (single) {
    const Component& c = j.comps[sc.comps[0]];
    units_x = (c.dw + 7) / 8;
    units_y = (c.dh + 7) / 8;
  } else {
    units_x = j.mcux;
    units_y = j.mcuy;
  }
  const long long units = static_cast<long long>(units_x) * units_y;
  int eobrun = 0, next_rst = 0;
  for (long long u = 0; u < units; ++u) {
    if (j.restart_interval && u > 0 && u % j.restart_interval == 0) {
      br.restart(next_rst);
      next_rst = (next_rst + 1) & 7;
      eobrun = 0;
      for (int ci : sc.comps) j.comps[ci].dc_pred = 0;
    }
    const int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
    for (int ci : sc.comps) {
      Component& c = j.comps[ci];
      const int nh = single ? 1 : c.h, nv = single ? 1 : c.v;
      for (int by = 0; by < nv; ++by)
        for (int bx = 0; bx < nh; ++bx) {
          int16_t* blk = block_at(c, ux * nh + bx, uy * nv + by);
          if (!j.progressive) {
            decode_block_sequential(br, j, c, blk);
          } else if (sc.ss == 0) {
            if (sc.ah == 0) decode_dc_first(br, j, c, blk, sc.al);
            else decode_dc_refine(br, blk, sc.al);
          } else if (sc.ah == 0) {
            decode_ac_first(br, j.ac[c.ac_table], blk, sc.ss, sc.se, sc.al, &eobrun);
          } else {
            decode_ac_refine(br, j.ac[c.ac_table], blk, sc.ss, sc.se, sc.al, &eobrun);
          }
        }
    }
  }
  return br.end_of_scan();
}

Scan read_sos(Jpeg& j, const uint8_t* p, int len) {
  if (!j.frame) fail("SOS before SOF");
  if (len < 1) fail("short SOS segment");
  const int ns = p[0];
  if (ns < 1 || ns > 4 || len < 1 + 2 * ns + 3) fail("bad SOS segment");
  Scan sc;
  for (int i = 0; i < ns; ++i) {
    const int id = p[1 + 2 * i];
    int ci = -1;
    for (size_t k = 0; k < j.comps.size(); ++k)
      if (j.comps[k].id == id) ci = static_cast<int>(k);
    if (ci < 0) fail("scan names an unknown component");
    Component& c = j.comps[ci];
    c.dc_table = p[2 + 2 * i] >> 4;
    c.ac_table = p[2 + 2 * i] & 15;
    if (c.dc_table > 3 || c.ac_table > 3) fail("bad Huffman table index");
    sc.comps.push_back(ci);
  }
  const uint8_t* q = p + 1 + 2 * ns;
  sc.ss = q[0];
  sc.se = q[1];
  sc.ah = q[2] >> 4;
  sc.al = q[2] & 15;
  if (j.progressive) {
    if (sc.ss > sc.se || sc.se > 63 || sc.al > 13 || (sc.ah && sc.ah != sc.al + 1))
      fail("bad progressive scan parameters");
    if (sc.ss == 0 && sc.se != 0) fail("bad progressive DC scan");
    if (sc.ss > 0 && ns != 1) fail("interleaved progressive AC scan");
    for (int ci : sc.comps) {
      int* bits = j.comps[ci].coef_bits;
      for (int k = sc.ss; k <= sc.se; ++k) {
        // a first scan of a coefficient, or a refinement by one bit
        if ((sc.ah == 0) != (bits[k] < 0) || (sc.ah && bits[k] != sc.ah))
          fail("progressive scans out of order");
        bits[k] = sc.al;
      }
    }
  } else {
    if (sc.ss != 0 || sc.se != 63 || sc.ah || sc.al) fail("bad sequential scan");
  }
  if (ns > 1) {
    int blocks = 0;
    for (int ci : sc.comps) blocks += j.comps[ci].h * j.comps[ci].v;
    if (blocks > 10) fail("MCU of more than 10 blocks");
  }
  return sc;
}

// ---- reconstruction -------------------------------------------------------

// jidctint.c, jpeg_idct_islow
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

inline uint8_t clamp_sample(int32_t x) {
  x += 128;
  return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
}

void idct_islow(const int16_t* in, const uint16_t* quant, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* ip = in + col;
    const uint16_t* qp = quant + col;
    int32_t* wp = ws + col;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int32_t dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int32_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    const int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, n);
    wp[56] = descale(tmp10 - tmp3, n);
    wp[8] = descale(tmp11 + tmp2, n);
    wp[48] = descale(tmp11 - tmp2, n);
    wp[16] = descale(tmp12 + tmp1, n);
    wp[40] = descale(tmp12 - tmp1, n);
    wp[24] = descale(tmp13 + tmp0, n);
    wp[32] = descale(tmp13 - tmp0, n);
  }
  for (int row = 0; row < 8; ++row) {
    const int32_t* wp = ws + 8 * row;
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = clamp_sample(descale(wp[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << kConstBits);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << kConstBits);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    const int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits + kPass1Bits + 3;
    op[0] = clamp_sample(descale(tmp10 + tmp3, n));
    op[7] = clamp_sample(descale(tmp10 - tmp3, n));
    op[1] = clamp_sample(descale(tmp11 + tmp2, n));
    op[6] = clamp_sample(descale(tmp11 - tmp2, n));
    op[2] = clamp_sample(descale(tmp12 + tmp1, n));
    op[5] = clamp_sample(descale(tmp12 - tmp1, n));
    op[3] = clamp_sample(descale(tmp13 + tmp0, n));
    op[4] = clamp_sample(descale(tmp13 - tmp0, n));
  }
}

// The component upsampled to the image's size, as jdsample.c does it.
std::vector<uint8_t> upsample(const Jpeg& j, const Component& c) {
  const int W = j.width, H = j.height;
  const int stride = c.bw * 8;
  const uint8_t* in = c.plane.data();
  std::vector<uint8_t> out(static_cast<size_t>(W) * H);
  const int fh = j.hmax / c.h, fv = j.vmax / c.v;
  auto at = [&](int y, int x) { return static_cast<int>(in[static_cast<size_t>(y) * stride + x]); };
  auto row_clamp = [&](int y) { return y < 0 ? 0 : y >= c.dh ? c.dh - 1 : y; };
  if (fh == 1 && fv == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(&out[static_cast<size_t>(y) * W], in + static_cast<size_t>(y) * stride, W);
  } else if (fh == 2 && fv == 1 && c.dw > 2) {
    // h2v1_fancy_upsample
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        const int i = x >> 1;
        const int cur = at(y, i) * 3;
        int v;
        if (x & 1) v = (cur + at(y, std::min(i + 1, c.dw - 1)) + 2) >> 2;
        else v = (cur + at(y, std::max(i - 1, 0)) + 1) >> 2;
        out[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(v);
      }
  } else if (fh == 1 && fv == 2) {
    // h1v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      const int i = y >> 1;
      const int near = i, far = row_clamp((y & 1) ? i + 1 : i - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        out[static_cast<size_t>(y) * W + x] =
            static_cast<uint8_t>((at(near, x) * 3 + at(far, x) + bias) >> 2);
    }
  } else if (fh == 2 && fv == 2 && c.dw > 2) {
    // h2v2_fancy_upsample
    std::vector<int> colsum(c.dw);
    for (int y = 0; y < H; ++y) {
      const int i = y >> 1;
      const int far = row_clamp((y & 1) ? i + 1 : i - 1);
      for (int x = 0; x < c.dw; ++x) colsum[x] = at(i, x) * 3 + at(far, x);
      uint8_t* op = &out[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; ++x) {
        const int k = x >> 1;
        const int cur = colsum[k] * 3;
        int v;
        if (x & 1) v = (cur + colsum[std::min(k + 1, c.dw - 1)] + 7) >> 4;
        else v = (cur + colsum[std::max(k - 1, 0)] + 8) >> 4;
        op[x] = static_cast<uint8_t>(v);
      }
    }
  } else {
    // h2v1_upsample, h2v2_upsample, int_upsample: box replication
    if (j.hmax % c.h || j.vmax % c.v) fail("fractional sampling factors" + std::string(kLeft));
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x)
        out[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(at(y / fv, x / fh));
  }
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    // jdcolor.c, build_ycc_rgb_table
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

inline uint8_t clamp255(int x) { return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x); }

void decode_jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>* rgb,
                 int* width, int* height, bool header_only) {
  if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
  Jpeg j;
  size_t pos = 2;
  bool eoi = false, any_scan = false;
  while (!eoi) {
    // find the next marker, stepping over fill bytes
    if (pos >= size) fail("truncated JPEG");
    if (data[pos] != 0xFF) fail("corrupt JPEG (no marker where one is due)");
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) fail("truncated JPEG");
    const int marker = data[pos++];
    if (marker == 0xD9) {
      eoi = true;
      break;
    }
    if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
    if (pos + 2 > size) fail("truncated JPEG");
    const int len = be16(data + pos) - 2;
    if (len < 0 || pos + 2 + len > size) fail("truncated JPEG segment");
    const uint8_t* p = data + pos + 2;
    const size_t next = pos + 2 + len;
    switch (marker) {
      case 0xC0: case 0xC1: case 0xC2:
        read_frame(&j, p, len, marker);
        if (header_only) {
          *width = j.width;
          *height = j.height;
          return;
        }
        break;
      case 0xC3: case 0xC7: case 0xCB: case 0xCF:
        fail("a lossless JPEG" + std::string(kLeft));
      case 0xC5: case 0xC6: case 0xCD: case 0xCE: case 0xDE: case 0xDF:
        fail("a hierarchical JPEG" + std::string(kLeft));
      case 0xC9: case 0xCA: case 0xCC:
        fail("an arithmetic-coded JPEG" + std::string(kLeft));
      case 0xC4: read_dht(&j, p, len); break;
      case 0xDB: read_dqt(&j, p, len); break;
      case 0xDD:
        if (len < 2) fail("short DRI segment");
        j.restart_interval = be16(p);
        break;
      case 0xDC: fail("a DNL marker" + std::string(kLeft));
      case 0xE0:
        if (len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) j.jfif = true;
        break;
      case 0xEE:
        if (len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
          j.adobe = true;
          j.adobe_transform = p[11];
        }
        break;
      case 0xDA: {
        const Scan sc = read_sos(j, p, len);
        pos = decode_scan(j, sc, data, size, next);
        any_scan = true;
        continue;
      }
      default:
        if (marker < 0xC0) fail("bad marker");
        break;   // APPn, COM, JPGn: skipped
    }
    pos = next;
  }
  if (!j.frame || !any_scan) fail("JPEG without a frame or a scan");
  for (const Component& c : j.comps) {
    if (!c.quant_latched) fail("a component no scan covers");
    if (j.progressive)
      for (int k = 0; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          fail("a progressive JPEG with unrefined coefficients (libjpeg smooths "
               "its blocks)" + std::string(kLeft));
  }
  // the IDCT of every block
  std::vector<std::vector<uint8_t>> full(j.comps.size());
  for (size_t ci = 0; ci < j.comps.size(); ++ci) {
    Component& c = j.comps[ci];
    const int stride = c.bw * 8;
    c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(block_at(c, bx, by), c.quant,
                   c.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
    std::vector<int16_t>().swap(c.coef);
    full[ci] = upsample(j, c);
    std::vector<uint8_t>().swap(c.plane);
  }
  const size_t n = static_cast<size_t>(j.width) * j.height;
  rgb->resize(n * 3);
  uint8_t* o = rgb->data();
  if (j.comps.size() == 1) {
    for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
  } else {
    bool ycc = true;
    if (j.jfif) {
      ycc = true;
    } else if (j.adobe) {
      ycc = j.adobe_transform != 0;
    } else {
      const int a = j.comps[0].id, b = j.comps[1].id, c = j.comps[2].id;
      ycc = !(a == 82 && b == 71 && c == 66);
    }
    if (!ycc) {
      for (size_t i = 0; i < n; ++i) {
        o[3 * i] = full[0][i];
        o[3 * i + 1] = full[1][i];
        o[3 * i + 2] = full[2][i];
      }
    } else {
      static const YccTables t;
      for (size_t i = 0; i < n; ++i) {
        const int y = full[0][i], cb = full[1][i], cr = full[2][i];
        o[3 * i] = clamp255(y + t.cr_r[cr]);
        o[3 * i + 1] = clamp255(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[3 * i + 2] = clamp255(y + t.cb_b[cb]);
      }
    }
  }
  *width = j.width;
  *height = j.height;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// ---------------------------------------------------------------------------
// resize (bilinear, float32 out in [0, 1]): faithdiff_tpu's native route
// ---------------------------------------------------------------------------

void resize_bilinear(const uint8_t* src, int sw, int sh, float* dst, int dw,
                     int dh) {
  const float sx = float(sw) / dw;
  const float sy = float(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::clamp(int(std::floor(fy)), 0, sh - 1);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::clamp(int(std::floor(fx)), 0, sw - 1);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(size_t(y0) * sw + x0) * 3 + c];
        float v01 = src[(size_t(y0) * sw + x1) * 3 + c];
        float v10 = src[(size_t(y1) * sw + x0) * 3 + c];
        float v11 = src[(size_t(y1) * sw + x1) * 3 + c];
        float top = v00 * (1 - wx) + v01 * wx;
        float bot = v10 * (1 - wx) + v11 * wx;
        dst[(size_t(y) * dw + x) * 3 + c] = (top * (1 - wy) + bot * wy) / 255.f;
      }
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(size));
  const bool ok = std::fread(out->data(), 1, out->size(), f) == out->size();
  std::fclose(f);
  return ok;
}

// One item of a batch: a JPEG file (decoded here) or pixels the caller
// decoded (PNG), resized into dst. Returns "" or the error.
std::string decode_resize_one(const char* path, const uint8_t* pixels, int pw,
                              int ph, float* dst, int dw, int dh) {
  if (pixels) {
    resize_bilinear(pixels, pw, ph, dst, dw, dh);
    return "";
  }
  std::vector<uint8_t> raw, rgb;
  if (!read_file(path, &raw)) return std::string(path) + ": cannot read the file";
  int w = 0, h = 0;
  try {
    decode_jpeg(raw.data(), raw.size(), &rgb, &w, &h, false);
  } catch (const std::exception& e) {
    return std::string(path) + ": " + e.what();
  }
  resize_bilinear(rgb.data(), w, h, dst, dw, dh);
  return "";
}

}  // namespace

extern "C" {

// The width and height in a JPEG's frame header. Returns 0, or 1 with the
// reason in err.
int fd_jpeg_info(const uint8_t* data, size_t size, int* width, int* height,
                 char* err, int errlen) {
  try {
    std::vector<uint8_t> unused;
    decode_jpeg(data, size, &unused, width, height, true);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decodes a JPEG into out, [height, width, 3] uint8 RGB (its size from
// fd_jpeg_info). Returns 0, or 1 with the reason in err.
int fd_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int width,
                   int height, char* err, int errlen) {
  try {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    decode_jpeg(data, size, &rgb, &w, &h, false);
    if (w != width || h != height) throw JpegError("size changed between calls");
    std::memcpy(out, rgb.data(), rgb.size());
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// n items into dst, [n, dh, dw, 3] float32 in [0, 1]: item i is the JPEG
// file paths[i] when pixels[i] is null, else pixels[i], [sizes[2i+1],
// sizes[2i], 3] uint8 RGB. A pool of num_threads threads takes the items
// in turn. Returns the number of failures; the first one's reason (by
// item) goes to err.
int fd_decode_resize_batch(const char* const* paths, const uint8_t* const* pixels,
                           const int* sizes, int n, float* dst, int dw, int dh,
                           int num_threads, char* err, int errlen) {
  std::vector<std::string> errors(static_cast<size_t>(std::max(n, 0)));
  std::atomic<int> next{0};
  auto work = [&] {
    for (int i = next++; i < n; i = next++) {
      float* out = dst + static_cast<size_t>(i) * dw * dh * 3;
      errors[i] = decode_resize_one(paths[i], pixels[i], sizes[2 * i],
                                    sizes[2 * i + 1], out, dw, dh);
    }
  };
  const int threads = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  int failures = 0;
  for (const std::string& e : errors) {
    if (e.empty()) continue;
    if (failures++ == 0) set_error(err, errlen, e);
  }
  return failures;
}

// Gaussian-weighted tile merge on the host (float32): canvas [H, W, C]
// accumulates tiles [T, k1, k2, C] at offsets [T, 2] under the reference's
// Gaussian mask (var = 0.01, midpoints (k2 - 1) / 2 and k1 / 2), then is
// divided by the accumulated weight; weight [H, W] is scratch. The
// arithmetic of faithdiff_tpu's native fd_tile_merge.
void fd_tile_merge(const float* tiles, const int* offsets, int num_tiles,
                   int k1, int k2, int channels, float* canvas, float* weight,
                   int H, int W) {
  std::vector<float> mask(size_t(k1) * k2);
  const double var = 0.01;
  const double mx = (k2 - 1) / 2.0, my = k1 / 2.0;
  std::vector<double> xp(k2), yp(k1);
  for (int x = 0; x < k2; ++x)
    xp[x] = std::exp(-(x - mx) * (x - mx) / (double(k2) * k2) / (2 * var)) /
            std::sqrt(2 * M_PI * var);
  for (int y = 0; y < k1; ++y)
    yp[y] = std::exp(-(y - my) * (y - my) / (double(k1) * k1) / (2 * var)) /
            std::sqrt(2 * M_PI * var);
  for (int y = 0; y < k1; ++y)
    for (int x = 0; x < k2; ++x) mask[size_t(y) * k2 + x] = float(yp[y] * xp[x]);

  std::memset(canvas, 0, sizeof(float) * size_t(H) * W * channels);
  std::memset(weight, 0, sizeof(float) * size_t(H) * W);
  for (int t = 0; t < num_tiles; ++t) {
    const int oi = offsets[t * 2], oj = offsets[t * 2 + 1];
    const float* tile = tiles + size_t(t) * k1 * k2 * channels;
    for (int y = 0; y < k1; ++y) {
      for (int x = 0; x < k2; ++x) {
        const float m = mask[size_t(y) * k2 + x];
        const size_t ci = size_t(oi + y) * W + (oj + x);
        weight[ci] += m;
        for (int c = 0; c < channels; ++c)
          canvas[ci * channels + c] += tile[(size_t(y) * k2 + x) * channels + c] * m;
      }
    }
  }
  for (size_t i = 0; i < size_t(H) * W; ++i) {
    const float wsum = std::max(weight[i], 1e-12f);
    for (int c = 0; c < channels; ++c) canvas[i * channels + c] /= wsum;
  }
}

}  // extern "C"
