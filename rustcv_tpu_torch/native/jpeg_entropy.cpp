// Baseline JPEG entropy decoder → quantized DCT coefficients.
//
// The host half of the TPU MJPEG path (SURVEY.md §7 hard-part #1): Huffman
// entropy decoding is sequential and bit-granular — hostile to TPU — so it
// runs here in C++; everything numeric after it (dequantization, 8×8 IDCT as
// MXU matmuls, chroma upsampling, YCbCr→BGR) runs on-device
// (rustcv_tpu/ops/jpeg_tpu.py). This mirrors the split the reference makes
// by delegating to turbojpeg (rustcv/src/videoio/mod.rs:206-252) — except
// the number-crunching half moves to the TPU.
//
// Supports baseline sequential DCT, 8-bit, 1 or 3 components, interleaved
// single-scan, restart markers. Emits the full padded MCU block grid per
// component, coefficients in natural (row-major) order.
//
// The full host decode (jpeg_host.cpp) also reads what libjpeg reads in
// several scans into one coefficient image (rcv_jpeg_host_info,
// rcv_jpeg_host_coeffs): progressive streams (SOF2: DC first and refine,
// AC first and refine with EOB runs, restart markers resetting the run),
// sequential streams whose scans hold fewer components than the frame,
// four-component (CMYK and YCCK) frames, arithmetic-coded frames (SOF9,
// SOF10: the QM-coder of T.81 Annex D with the statistical models of F.1.4
// and G.1.3) and lossless frames (SOF3: Huffman-coded differences, the
// seven predictors and the point transform, undone here into samples, as
// libjpeg-turbo 3 decodes them). The hybrid path's entry points refuse all
// of these, as before.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// The host decode's return codes beside the parse's: a scan header libjpeg
// refuses, and a restart interval that is not a whole number of MCU rows
// in a lossless scan (libjpeg refuses it too).
constexpr int kBadScan = -52;
constexpr int kBadRestart = -53;
constexpr int kMaxBlocksInMcu = 10;  // libjpeg's D_MAX_BLOCKS_IN_MCU
constexpr int kMaxComps = 4;

// T.81 Table D.2 in libjpeg's packing (jaricom.c): Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
// fixed probability 0.5 of the sign and refinement decisions.
const int32_t ARITAB[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

const uint8_t ZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffTable {
  // Canonical decode tables per JPEG spec F.2.2.3.
  int32_t mincode[17];
  int32_t maxcode[18];  // maxcode[l] = -1 when no codes of length l
  int32_t valptr[17];
  uint8_t values[256];
  // 8-bit lookahead LUT: lut[peek8] = (code_len << 8) | value for codes of
  // length <= 8 (the standard tables resolve ~99% of symbols here);
  // 0 = escape to the canonical 9..16-bit walk. Rebuilt on every DHT.
  uint16_t lut[256];
  bool defined = false;
};

// 64-bit accumulator bit reader: refill() batches byte-stuffing handling
// (0xFF 0x00) and stops AT markers, so whole-byte pre-reads never cross an
// entropy-segment boundary; peek/drop give multi-bit Huffman lookahead.
// Measured ~3x faster host entropy decode than the 1-bit-at-a-time reader
// at 1080p q85 (the per-core scaling term for co-located MJPEG hosts).
// Near stream end / markers the per-bit path preserves the legacy error
// semantics exactly (truncated streams still fail, not zero-pad).
struct BitReader {
  const uint8_t* data;
  long len;
  long pos = 0;
  uint64_t acc = 0;  // newest bits at the LSB end; navail valid bits
  int navail = 0;
  bool hit_marker = false;
  uint8_t marker = 0;

  void refill() {
    while (navail <= 56 && !hit_marker && pos < len) {
      uint8_t b = data[pos];
      if (b == 0xFF) {
        if (pos + 1 >= len) return;  // lone trailing 0xFF: exhausted
        uint8_t b2 = data[pos + 1];
        if (b2 != 0x00) {
          hit_marker = true;
          marker = b2;
          pos += 2;
          return;
        }
        pos += 2;  // stuffed byte
      } else {
        pos += 1;
      }
      acc = (acc << 8) | b;
      navail += 8;
    }
  }

  inline int peek(int n) const {
    return (int)((acc >> (navail - n)) & ((1u << n) - 1));
  }

  inline void drop(int n) { navail -= n; }

  void align() {
    // Discard buffered bits (pad bits before a restart marker). refill()
    // never reads past a marker, so everything here belongs to the
    // segment being closed.
    acc = 0;
    navail = 0;
  }

  // Returns next bit or -1 on marker/end.
  int bit() {
    if (navail == 0) {
      refill();
      if (navail == 0) return -1;
    }
    navail--;
    return (int)((acc >> navail) & 1);
  }

  int get_bits(int n) {
    if (n <= 0) return 0;
    if (navail < n) refill();
    if (navail >= n) {
      int v = peek(n);
      drop(n);
      return v;
    }
    int v = 0;  // tail: per-bit, legacy error semantics
    for (int i = 0; i < n; ++i) {
      int b = bit();
      if (b < 0) return -1;
      v = (v << 1) | b;
    }
    return v;
  }
};

int huff_decode(BitReader& br, const HuffTable& t) {
  if (br.navail < 16) br.refill();
  if (br.navail >= 16) {
    uint16_t e = t.lut[br.peek(8)];
    if (e) {
      br.drop(e >> 8);
      return e & 255;
    }
    int code16 = br.peek(16);
    for (int l = 9; l <= 16; ++l) {
      int c = code16 >> (16 - l);
      if (t.maxcode[l] >= 0 && c <= t.maxcode[l]) {
        br.drop(l);
        return t.values[t.valptr[l] + c - t.mincode[l]];
      }
    }
    return -1;
  }
  // Slow tail (near stream end / marker): bit-by-bit, exact legacy errors.
  int code = 0;
  for (int l = 1; l <= 16; ++l) {
    int b = br.bit();
    if (b < 0) return -1;
    code = (code << 1) | b;
    if (t.maxcode[l] >= 0 && code <= t.maxcode[l]) {
      return t.values[t.valptr[l] + code - t.mincode[l]];
    }
  }
  return -1;
}

inline int receive_extend(BitReader& br, int s) {
  // s is a coefficient bit-category: valid streams keep it <= 15 (callers
  // reject larger huffman values), and the arithmetic below stays defined.
  if (s <= 0) return 0;
  int v = br.get_bits(s);
  if (v < 0) return 0;
  if (v < (1 << (s - 1))) v -= (1 << s) - 1;
  return v;
}

// The QM-coder's decoder (T.81 D.2, libjpeg's jdarith.c): C and A
// registers, bytes fed through the 0xFF 0x00 stuffing; a marker, or the end
// of the data, feeds zeros from there on, as T.81 wants.
struct ArithReader {
  const uint8_t* data;
  long len;
  long pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: the next decision fetches the two first bytes
  bool hit_marker = false;
  // A bad code (a magnitude past 15 bits, a run past the band) ends the
  // decode of the restart interval: libjpeg warns and leaves the rest of
  // its blocks as they are.
  bool broken = false;

  void reset() {
    c = a = 0;
    ct = -16;
    broken = false;
  }

  int next_byte() {
    if (hit_marker || pos >= len) {
      hit_marker = true;
      return 0;
    }
    int d = data[pos++];
    if (d != 0xFF) return d;
    do d = pos < len ? data[pos++] : 0xD9;
    while (d == 0xFF);
    if (d == 0) return 0xFF;  // a stuffed byte
    hit_marker = true;        // the marker is consumed; zeros from here
    return 0;
  }

  // One binary decision in statistics bin *st.
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two first bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = ARITAB[sv & 0x7F];
    int nl = int(qe & 0xFF), nm = int((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t t = a - qe;
    a = t;
    t <<= ct;
    if (c >= t) {
      c -= t;
      if (a < qe) {  // conditional exchange: the MPS after all
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0;
  int h = 1, v = 1;
  int tq = 0;       // quant table id
  int td = 0, ta = 0;  // huff (or arithmetic conditioning) table ids
  int fv = 1;          // the frame header's v, kept where a lone component's v is set to 1
  int bw = 0, bh = 0;  // padded block grid dims (samples, in a lossless frame)
  // int64: corrupt streams can feed ±32767 diffs for millions of blocks;
  // valid streams stay within ±1024 (UBSan-found signed overflow otherwise).
  int64_t dc_pred = 0;
};

struct Decoder {
  const uint8_t* data;
  long len;
  int width = 0, height = 0, ncomp = 0;
  Component comp[kMaxComps];
  uint16_t qt[4][64];       // natural order
  bool qt_defined[4] = {false, false, false, false};
  HuffTable hdc[4], hac[4];
  int restart_interval = 0;
  long scan_pos = -1;  // offset of entropy data

  // The host decode's reading (host == true): progressive frames, scans of
  // fewer components than the frame, and the markers that set the colour
  // space. Left false, the parse refuses what the hybrid path cannot take.
  bool host = false;
  bool progressive = false, arith = false, lossless = false;
  bool saw_sof = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int scans_seen = 0;
  int scan_ns = 0, scan_comp[kMaxComps] = {0, 0, 0, 0};  // the current scan's components
  int ss = 0, se = 63, ah = 0, al = 0;  // its spectral band (predictor) and bit positions
  // The arithmetic conditioning (DAC; libjpeg's defaults where none is given).
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  Decoder(const uint8_t* d, long n) : data(d), len(n) {
    for (int t = 0; t < 16; ++t) {
      dc_l[t] = 0;
      dc_u[t] = 1;
      ac_k[t] = 5;
    }
  }

  int u16(long p) { return (data[p] << 8) | data[p + 1]; }

  // Parse headers up to (and including) SOS. Returns 0 ok.
  int parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
    return parse_segments(2);
  }

  // Parse marker segments from the marker at `p` up to (and including) the
  // next SOS: 0 there, 1 at an EOI after a scan (host), < 0 for an error.
  int parse_segments(long p) {
    while (p + 4 <= len) {
      if (data[p] != 0xFF) return -2;
      uint8_t m = data[p + 1];
      p += 2;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (p + 2 > len) return -3;
      int seglen = u16(p);
      if (seglen < 2) return -3;  // would move p backwards → loop forever
      long seg = p + 2;
      long segend = p + seglen;
      if (segend > len) return -3;
      // Every field read below is bounded against segend BEFORE the
      // dereference: this parser runs on untrusted camera/MJPEG bytes
      // (ADVICE r1: truncated-DQT heap overflow, ASan-confirmed).
      if (m == 0xDB) {  // DQT
        long q = seg;
        while (q < segend) {
          int pq = data[q] >> 4, tq = data[q] & 15;
          q++;
          if (tq > 3 || pq > 1) return -4;
          if (q + (pq ? 128 : 64) > segend) return -4;  // truncated table
          for (int k = 0; k < 64; ++k) {
            int val = pq ? ((data[q] << 8) | data[q + 1]) : data[q];
            q += pq ? 2 : 1;
            qt[tq][ZIGZAG[k]] = (uint16_t)val;
          }
          qt_defined[tq] = true;
        }
      } else if (m == 0xC0 || m == 0xC1 ||
                 (host && (m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA))) {
        // SOF0/1; the host decode's SOF2 (progressive), SOF3 (lossless),
        // SOF9 and SOF10 (arithmetic-coded, sequential and progressive)
        if (host && saw_sof) return -5;  // a second frame header
        saw_sof = true;
        progressive = m == 0xC2 || m == 0xCA;
        arith = m == 0xC9 || m == 0xCA;
        lossless = m == 0xC3;
        if (seg + 6 > segend) return -5;
        if (data[seg] != 8) return -5;  // 8-bit precision only (Pillow refuses the others too)
        height = u16(seg + 1);
        width = u16(seg + 3);
        // libjpeg's JERR_EMPTY_IMAGE (it reads no DNL marker either)
        if (host && (width == 0 || height == 0)) return -5;
        ncomp = data[seg + 5];
        // the host decode reads one to four components (two only with no
        // colour conversion, as libtiff asks of libjpeg)
        if (host ? (ncomp < 1 || ncomp > 4) : (ncomp != 1 && ncomp != 3)) return -6;
        if (seg + 6 + 3 * (long)ncomp > segend) return -5;
        for (int c = 0; c < ncomp; ++c) {
          comp[c].id = data[seg + 6 + c * 3];
          comp[c].h = data[seg + 7 + c * 3] >> 4;
          comp[c].v = data[seg + 7 + c * 3] & 15;
          comp[c].tq = data[seg + 8 + c * 3];
          if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 ||
              comp[c].v > 4 || comp[c].tq > 3)
            return -6;
        }
        // A lone component's scan is not interleaved: its MCU is one block
        // whatever sampling factors the frame header gives it.
        if (ncomp == 1) {
          comp[0].fv = comp[0].v;
          comp[0].h = comp[0].v = 1;
        }
      } else if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        // what the hybrid path does not read; and what libjpeg refuses:
        // lossless arithmetic-coded (SOF11) and hierarchical frames
        return -7;
      } else if (host && m == 0xCC) {  // DAC: L and U per DC table, K per AC table
        long q = seg;
        for (; q + 2 <= segend; q += 2) {
          int t = data[q], val = data[q + 1];
          if (t >= 32) return -8;
          if (t >= 16) {
            ac_k[t - 16] = uint8_t(val);
          } else {
            dc_l[t] = uint8_t(val & 15);
            dc_u[t] = uint8_t(val >> 4);
            if (dc_l[t] > dc_u[t]) return -8;
          }
        }
        if (q != segend) return -8;
      } else if (m == 0xC4) {  // DHT
        long q = seg;
        while (q < segend) {
          if (q + 17 > segend) return -8;  // id byte + 16 count bytes
          int tc = data[q] >> 4, th = data[q] & 15;
          q++;
          if (th > 3 || tc > 1) return -8;
          HuffTable& t = tc ? hac[th] : hdc[th];
          uint8_t counts[17];
          int total = 0;
          for (int l = 1; l <= 16; ++l) {
            counts[l] = data[q++];
            total += counts[l];
          }
          // total <= 256 also bounds huff_decode's values[] index:
          // valptr[l] + (code - mincode[l]) < valptr[l] + counts[l] <= total.
          if (total > 256 || q + total > segend) return -8;
          int code = 0, k = 0;
          for (int l = 1; l <= 16; ++l) {
            t.valptr[l] = k;
            t.mincode[l] = code;
            if (counts[l]) {
              code += counts[l];
              k += counts[l];
              t.maxcode[l] = code - 1;
            } else {
              t.maxcode[l] = -1;
            }
            code <<= 1;
          }
          t.maxcode[17] = -1;
          for (int i = 0; i < total; ++i) t.values[i] = data[q + i];
          q += total;
          // 8-bit lookahead LUT (see HuffTable): every 8-bit window whose
          // prefix is a code of length l <= 8 resolves in one load.
          memset(t.lut, 0, sizeof(t.lut));
          code = 0;
          k = 0;
          for (int l = 1; l <= 8; ++l) {
            for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
              if (code >= (1 << l)) break;  // over-subscribed (corrupt) DHT:
              // don't index lut past 255; decode falls back to the
              // canonical walk, which bounds values[] by total <= 256.
              int prefix = code << (8 - l);
              for (int j = 0; j < (1 << (8 - l)); ++j) {
                t.lut[prefix | j] = (uint16_t)((l << 8) | t.values[k]);
              }
            }
            code <<= 1;
          }
          t.defined = true;
        }
      } else if (m == 0xDD) {  // DRI
        if (seg + 2 > segend) return -3;
        restart_interval = u16(seg);
      } else if (m == 0xE0) {  // APP0: JFIF implies YCbCr
        if (segend - seg >= 14 && memcmp(data + seg, "JFIF\0", 5) == 0) saw_jfif = true;
      } else if (m == 0xEE) {  // APP14: Adobe's transform flag
        if (segend - seg >= 12 && memcmp(data + seg, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = data[seg + 11];
        }
      } else if (m == 0xDA) {  // SOS
        if (seg + 1 > segend) return -9;
        int ns = data[seg];
        if (host ? (ns < 1 || ns > ncomp) : ns != ncomp) return -9;  // interleaved single-scan only
        if (seg + 1 + 2 * (long)ns + (host ? 3 : 0) > segend) return -9;
        for (int s = 0; s < ns; ++s) {
          int cid = data[seg + 1 + s * 2];
          int tabs = data[seg + 2 + s * 2];
          int td = tabs >> 4, ta = tabs & 15;
          if (!arith && (td > 3 || ta > 3)) return -9;  // hdc/hac are 4-entry arrays
          int found = -1;
          for (int c = 0; c < ncomp; ++c) {
            if (comp[c].id == cid) {
              comp[c].td = td;
              comp[c].ta = ta;
              found = c;
            }
          }
          if (host) {
            if (found < 0) return -9;
            for (int t = 0; t < s; ++t)
              if (scan_comp[t] == found) return -9;
            scan_comp[s] = found;
          }
        }
        if (host) {
          long b = seg + 1 + 2 * (long)ns;
          scan_ns = ns;
          ss = data[b];
          se = data[b + 1];
          ah = data[b + 2] >> 4;
          al = data[b + 2] & 15;
        }
        scan_pos = segend;
        return 0;
      } else if (m == 0xD9) {
        return scans_seen ? 1 : -10;  // EOI before SOS
      }
      p = segend;
    }
    // an EOI in the stream's last two bytes, after a scan (host)
    if (scans_seen && p + 2 <= len && data[p] == 0xFF && data[p + 1] == 0xD9) return 1;
    return -11;
  }

  void grid_dims(int* hmax, int* vmax, int* mx, int* my) {
    *hmax = 1;
    *vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
      if (comp[c].h > *hmax) *hmax = comp[c].h;
      if (comp[c].v > *vmax) *vmax = comp[c].v;
    }
    *mx = (width + 8 * *hmax - 1) / (8 * *hmax);
    *my = (height + 8 * *vmax - 1) / (8 * *vmax);
  }

  // Packed-output mode: when pk_pos != nullptr, decode() emits only the
  // NONZERO coefficients as (flat position, value) pairs instead of dense
  // grids. Positions index the concatenated dense layout (component grids
  // back-to-back, block-major, natural order within each block), so a
  // device-side scatter-add of the pairs into zeros reproduces the dense
  // tensor exactly. DCT coefficients are mostly zero (~85-95% at camera
  // qualities), so this cuts host→device bytes ~3-4× — the one lever that
  // helps even on transport-bound links.
  int32_t* pk_pos = nullptr;
  int16_t* pk_val = nullptr;
  long pk_cap = 0;
  long pk_n = 0;
  long comp_base[3] = {0, 0, 0};

  // Block-packed mode: fixed K (index, value) slots per block, plus a
  // DENSE-ROW escape for blocks with more than K nonzeros (the block's
  // full 64 coefficients + its block id). Motivation (measured on TPU):
  // a flat scatter-add of ~130k pairs costs ~35 ms/tick — 4× the whole
  // dense reconstruction — while a fixed-K one-hot unpack is ~1-2 ms of
  // pure VPU work and a row-granular scatter of the few busy blocks is
  // ~1-2 ms more. Camera-quality block histograms are bimodal (most
  // blocks ≤4 nonzeros, a small tail nearly dense), so small K + dense
  // escape is both the smallest wire format and the cheapest unpack.
  uint8_t* bp_idx = nullptr;   // [total_blocks, K] natural coeff index
  int16_t* bp_val = nullptr;   // [total_blocks, K]
  int bp_k = 0;
  int32_t* bp_dense_ids = nullptr;  // [cap] global block ids
  int16_t* bp_dense_rows = nullptr;  // [cap, 64] full blocks, natural order
  long bp_dense_cap = 0;
  long bp_dense_n = 0;
  long comp_block_base[3] = {0, 0, 0};

  // One block of a sequential scan (zeroed first).
  static int block_seq(BitReader& br, Component& co, const HuffTable& dct,
                       const HuffTable& act, int16_t* block) {
    memset(block, 0, 64 * sizeof(int16_t));
    int t = huff_decode(br, dct);
    if (t < 0 || t > 15) return -21;  // DC category <= 11 in 8-bit
    co.dc_pred += receive_extend(br, t);
    block[0] = (int16_t)co.dc_pred;
    int k = 1;
    while (k < 64) {
      int rs = huff_decode(br, act);
      if (rs < 0) return -22;
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r == 15) {
          k += 16;
          continue;
        }
        break;  // EOB
      }
      k += r;
      if (k > 63) return -23;
      block[ZIGZAG[k]] = (int16_t)receive_extend(br, s);
      k++;
    }
    return 0;
  }

  // Past the RSTn marker that ends a restart interval: `hit_marker` when
  // the reader has consumed it already, else the next one at or after
  // `pos` (libjpeg's read_restart_marker skips what comes before it).
  static void skip_restart(const uint8_t* data, long len, long& pos, bool& hit_marker) {
    if (hit_marker) {
      hit_marker = false;
      return;
    }
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7))
      pos++;
    if (pos + 1 < len) pos += 2;
  }

  // Byte-align and consume the RSTn marker; the caller resets its
  // predictors.
  static void restart(BitReader& br) {
    br.align();
    skip_restart(br.data, br.len, br.pos, br.hit_marker);
  }

  // -- the host decode's scans ------------------------------------------------

  int coef_bits[kMaxComps][64];  // per coefficient, the low bit its last scan left (-1: none yet)
  uint16_t q_latched[kMaxComps][64];  // each component's table when it first came in a scan
  bool latched[kMaxComps] = {false, false, false, false};
  int64_t eobrun = 0;

  // The arithmetic decoder's statistics (F.1.4.4, G.1.3.3): 64 DC and 256 AC
  // bins per conditioning table, each component's DC context, and the bin
  // of the fixed probability 0.5.
  uint8_t dc_stats[16][64], ac_stats[16][256];
  int dc_context[kMaxComps] = {0, 0, 0, 0};
  uint8_t fixed_bin = 113;

  // A progressive block of the current scan, in place.
  int block_prog(BitReader& br, Component& co, int16_t* blk) {
    if (ss == 0) {  // DC: first scan or refinement
      if (ah == 0) {
        int t = huff_decode(br, hdc[co.td]);
        if (t < 0 || t > 15) return -21;
        co.dc_pred += receive_extend(br, t);
        blk[0] = (int16_t)(co.dc_pred * (int64_t(1) << al));
      } else {
        int b = br.get_bits(1);
        if (b < 0) return -21;
        if (b) blk[0] = (int16_t)(blk[0] | (1 << al));
      }
      return 0;
    }
    const HuffTable& act = hac[co.ta];
    int k = ss;
    if (ah == 0) {  // AC first scan
      if (eobrun > 0) {
        eobrun--;
        return 0;
      }
      for (; k <= se; k++) {
        int rs = huff_decode(br, act);
        if (rs < 0) return -22;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > se) return -23;
          blk[ZIGZAG[k]] = (int16_t)(receive_extend(br, s) * (1 << al));
        } else if (r == 15) {
          k += 15;  // sixteen zeros
        } else {
          eobrun = int64_t(1) << r;
          if (r) {
            int e = br.get_bits(r);
            if (e < 0) return -22;
            eobrun += e;
          }
          eobrun--;  // this block ends the band
          break;
        }
      }
      return 0;
    }
    // AC refinement: a correction bit for each coefficient already nonzero,
    // new coefficients of magnitude 1 << al
    const int p1 = 1 << al, m1 = -(1 << al);
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = huff_decode(br, act);
        if (rs < 0) return -22;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          int b = br.get_bits(1);
          if (b < 0) return -22;
          s = b ? p1 : m1;
        } else if (r != 15) {
          eobrun = int64_t(1) << r;
          if (r) {
            int e = br.get_bits(r);
            if (e < 0) return -22;
            eobrun += e;
          }
          break;  // the rest of the block is the EOB run's
        }
        do {  // past the nonzero coefficients (refining them) and r zeros
          int16_t* c = blk + ZIGZAG[k];
          if (*c != 0) {
            int b = br.get_bits(1);
            if (b < 0) return -22;
            if (b && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;  // the zero that becomes nonzero
          }
          k++;
        } while (k <= se);
        if (s) {
          if (k > se) return -23;
          blk[ZIGZAG[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* c = blk + ZIGZAG[k];
        if (*c != 0) {
          int b = br.get_bits(1);
          if (b < 0) return -22;
          if (b && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        }
      }
      eobrun--;
    }
    return 0;
  }

  // An arithmetic-coded DC difference (F.1.4.4.1, figures F.19-F.24);
  // *ok is cleared for a magnitude past 15 bits.
  int arith_dc_diff(ArithReader& ar, int c, int tbl, bool* ok) {
    uint8_t* st = dc_stats[tbl] + dc_context[c];
    if (ar.decode(st) == 0) {
      dc_context[c] = 0;
      return 0;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;  // X1
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          *ok = false;
          return 0;
        }
        st += 1;
      }
    }
    // the conditioning category of the next difference (F.1.4.4.1.2)
    if (m < ((1 << dc_l[tbl]) >> 1))
      dc_context[c] = 0;
    else if (m > ((1 << dc_u[tbl]) >> 1))
      dc_context[c] = 12 + sign * 4;
    else
      dc_context[c] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // An arithmetic-coded AC value at band position k (F.1.4.4.2): its sign
  // and magnitude, `st` at the position's SE bin. *ok cleared on overflow.
  int arith_ac_value(ArithReader& ar, int tbl, int k, uint8_t* st, bool* ok) {
    int sign = ar.decode(&fixed_bin);
    st += 2;
    int m = ar.decode(st);
    if (m != 0 && ar.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= ac_k[tbl] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          *ok = false;
          return 0;
        }
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // One block of an arithmetic-coded scan, in place: sequential (the whole
  // block, zeroed first) or one progressive pass (G.1.3). A bad code breaks
  // the reader (ArithReader::broken).
  void block_arith(ArithReader& ar, int c, int16_t* blk) {
    if (ar.broken) return;
    Component& co = comp[c];
    bool ok = true;
    if (!progressive || ss == 0) {
      if (progressive && ah != 0) {  // DC refinement: the next bit
        if (ar.decode(&fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
        return;
      }
      if (!progressive) memset(blk, 0, 64 * sizeof(int16_t));
      int d = arith_dc_diff(ar, c, co.td, &ok);
      if (!ok) {
        ar.broken = true;
        return;
      }
      if (progressive) {
        co.dc_pred += d;
        blk[0] = int16_t(co.dc_pred * (int64_t(1) << al));
        return;
      }
      co.dc_pred = (co.dc_pred + d) & 0xFFFF;
      blk[0] = int16_t(co.dc_pred);
    }
    const int tbl = co.ta;
    const int lo = progressive ? ss : 1, hi = progressive ? se : 63;
    if (progressive && ah != 0) {  // AC refinement
      const int p1 = 1 << al, m1 = -(1 << al);
      int kex = hi;  // the end of the band's previous stage (EOBx)
      for (; kex > 0; kex--)
        if (blk[ZIGZAG[kex]]) break;
      for (int k = lo; k <= hi; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;  // EOB
        for (;;) {
          int16_t* x = blk + ZIGZAG[k];
          if (*x) {  // already nonzero: a correction bit
            if (ar.decode(st + 2)) *x = int16_t(*x < 0 ? *x + m1 : *x + p1);
            break;
          }
          if (ar.decode(st + 1)) {  // newly nonzero
            *x = int16_t(ar.decode(&fixed_bin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > hi) {
            ar.broken = true;
            return;
          }
        }
      }
      return;
    }
    for (int k = lo; k <= hi; k++) {  // sequential AC, or an AC first pass
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > hi) {
          ar.broken = true;
          return;
        }
      }
      int v = arith_ac_value(ar, tbl, k, st, &ok);
      if (!ok) {
        ar.broken = true;
        return;
      }
      blk[ZIGZAG[k]] = int16_t(progressive ? int(unsigned(v) << al) : v);
    }
  }

  // The statistics an arithmetic-coded scan starts from, and restarts with:
  // its components' DC bins and predictors where it codes a first DC, its
  // AC bins where it codes AC coefficients.
  void arith_reset_stats() {
    for (int i = 0; i < scan_ns; ++i) {
      Component& co = comp[scan_comp[i]];
      if (!progressive || (ss == 0 && ah == 0)) {
        memset(dc_stats[co.td], 0, sizeof(dc_stats[0]));
        co.dc_pred = 0;
        dc_context[scan_comp[i]] = 0;
      }
      if (!progressive || ss > 0) memset(ac_stats[co.ta], 0, sizeof(ac_stats[0]));
    }
  }

  // Decode the scan whose header parse_segments just read into the
  // padded grids `out` (zeroed before the first scan).
  int decode_scan(int16_t* out[kMaxComps]) {
    scans_seen++;
    if (progressive) {  // libjpeg's JERR_BAD_PROGRESSION
      if (ss == 0 ? se != 0 : (ss > se || se > 63 || scan_ns != 1)) return kBadScan;
      if ((ah != 0 && al != ah - 1) || al > 13) return kBadScan;
    }
    int blocks = 0;
    for (int i = 0; i < scan_ns; ++i) {
      Component& co = comp[scan_comp[i]];
      blocks += scan_ns == 1 ? 1 : co.h * co.v;
      if (!latched[scan_comp[i]]) {
        if (!qt_defined[co.tq]) return -30;
        memcpy(q_latched[scan_comp[i]], qt[co.tq], sizeof(qt[0]));
        latched[scan_comp[i]] = true;
      }
      bool dc_first = !progressive || (ss == 0 && ah == 0);
      if (!arith &&
          ((dc_first && !hdc[co.td].defined) || ((!progressive || ss > 0) && !hac[co.ta].defined)))
        return -20;
      for (int k = progressive ? ss : 0; k <= (progressive ? se : 63); ++k)
        coef_bits[scan_comp[i]][k] = progressive ? al : 0;
      co.dc_pred = 0;
    }
    if (blocks > kMaxBlocksInMcu) return kBadScan;
    int hmax, vmax, mx, my;
    grid_dims(&hmax, &vmax, &mx, &my);
    // A scan of one component is not interleaved: one block per MCU over
    // the component's own block extent, not the padded MCU grid.
    if (scan_ns == 1) {
      Component& co = comp[scan_comp[0]];
      mx = (width * co.h + 8 * hmax - 1) / (8 * hmax);
      my = (height * co.v + 8 * vmax - 1) / (8 * vmax);
    }
    BitReader br{data + scan_pos, len - scan_pos};
    ArithReader ar{data + scan_pos, len - scan_pos};
    if (arith) arith_reset_stats();
    eobrun = 0;
    long mcu_count = 0;
    int16_t block[64];
    for (int myi = 0; myi < my; ++myi) {
      for (int mxi = 0; mxi < mx; ++mxi) {
        if (restart_interval && mcu_count && mcu_count % restart_interval == 0) {
          if (arith) {
            skip_restart(ar.data, ar.len, ar.pos, ar.hit_marker);
            ar.reset();
            arith_reset_stats();
          } else {
            restart(br);
            for (int i = 0; i < scan_ns; ++i) comp[scan_comp[i]].dc_pred = 0;
            eobrun = 0;
          }
        }
        for (int i = 0; i < scan_ns; ++i) {
          int c = scan_comp[i];
          Component& co = comp[c];
          int nv = scan_ns == 1 ? 1 : co.v, nh = scan_ns == 1 ? 1 : co.h;
          for (int v = 0; v < nv; ++v) {
            for (int h = 0; h < nh; ++h) {
              int by = myi * nv + v, bx = mxi * nh + h;
              int16_t* dst = out[c] + ((long)by * co.bw + bx) * 64;
              int rc = 0;
              if (arith) {
                block_arith(ar, c, dst);
              } else if (progressive) {
                rc = block_prog(br, co, dst);
              } else {
                rc = block_seq(br, co, hdc[co.td], hac[co.ta], block);
                memcpy(dst, block, sizeof(block));
              }
              if (rc != 0) return rc;
            }
          }
        }
        mcu_count++;
      }
    }
    return 0;
  }

  // The next marker after the current scan's entropy data, or -1.
  long next_marker() const {
    long q = scan_pos;
    while (q + 1 < len) {
      if (data[q] == 0xFF) {
        uint8_t b = data[q + 1];
        if (b == 0x00 || (b >= 0xD0 && b <= 0xD7)) {
          q += 2;  // a stuffed byte or a restart marker
          continue;
        }
        if (b != 0xFF) return q;
      }
      q++;
    }
    return -1;
  }

  // -- lossless (SOF3), as libjpeg-turbo 3 decodes it (jdlhuff.c,
  // jddiffct.c, jdlossls.c) ----------------------------------------------------

  // One lossless scan into the sample planes `out` (each bh rows of bw
  // int16, the output samples: the point transform applied). Differences
  // are decoded a row of MCUs at a time; each component's rows of an
  // iMCU row are undone after all of it is decoded, and a restart makes
  // the next row undone a first row, as libjpeg does.
  int lossless_scan(int16_t* out[kMaxComps], int* undiff[kMaxComps], int* diff[kMaxComps]) {
    scans_seen++;
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8) return kBadScan;
    int blocks = 0;
    for (int i = 0; i < scan_ns; ++i) {
      Component& co = comp[scan_comp[i]];
      blocks += scan_ns == 1 ? 1 : co.h * co.v;
      if (!hdc[co.td].defined) return -20;
    }
    if (blocks > kMaxBlocksInMcu) return kBadScan;
    int hmax = 1, vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
      hmax = comp[c].h > hmax ? comp[c].h : hmax;
      vmax = comp[c].v > vmax ? comp[c].v : vmax;
    }
    const int imcu_rows = (height + vmax - 1) / vmax;
    int wib[kMaxComps], hib[kMaxComps];  // each component's real extent
    for (int c = 0; c < ncomp; ++c) {
      wib[c] = int((long(width) * comp[c].h + hmax - 1) / hmax);
      hib[c] = int((long(height) * comp[c].v + vmax - 1) / vmax);
    }
    const int mcus_per_row = scan_ns == 1 ? wib[scan_comp[0]] : (width + hmax - 1) / hmax;
    if (restart_interval % mcus_per_row != 0) return kBadRestart;
    const long rows_per_interval = restart_interval / mcus_per_row;
    long rows_to_go = rows_per_interval;
    bool first_row[kMaxComps];
    for (int c = 0; c < kMaxComps; ++c) first_row[c] = true;
    BitReader br{data + scan_pos, len - scan_pos};
    for (int im = 0; im < imcu_rows; ++im) {
      int mcu_rows = 1;
      if (scan_ns == 1) {
        const Component& co = comp[scan_comp[0]];
        mcu_rows = im < imcu_rows - 1 ? co.v : (hib[scan_comp[0]] % co.v ? hib[scan_comp[0]] % co.v : co.v);
      }
      for (int yoff = 0; yoff < mcu_rows; ++yoff) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            restart(br);
            for (int c = 0; c < kMaxComps; ++c) first_row[c] = true;
            rows_to_go = rows_per_interval;
          }
          rows_to_go--;
        }
        for (int m = 0; m < mcus_per_row; ++m) {
          for (int i = 0; i < scan_ns; ++i) {
            int c = scan_comp[i];
            const Component& co = comp[c];
            int nv = scan_ns == 1 ? 1 : co.v, nh = scan_ns == 1 ? 1 : co.h;
            for (int y = 0; y < nv; ++y) {
              for (int x = 0; x < nh; ++x) {
                int s = huff_decode(br, hdc[co.td]);
                if (s < 0 || s > 16) return -21;
                int d = s == 16 ? 32768 : receive_extend(br, s);
                diff[c][long(yoff + y) * co.bw + m * nh + x] = d;
              }
            }
          }
        }
      }
      for (int i = 0; i < scan_ns; ++i) {
        int c = scan_comp[i];
        const Component& co = comp[c];
        int rows = im < imcu_rows - 1 ? co.v : (hib[c] % co.v ? hib[c] % co.v : co.v);
        for (int r = 0; r < rows; ++r) {
          const int* d = diff[c] + long(r) * co.bw;
          const int* above = undiff[c] + long(r ? r - 1 : co.v - 1) * co.bw;
          int* u = undiff[c] + long(r) * co.bw;
          undifference(d, above, u, wib[c], first_row[c]);
          first_row[c] = false;
          int16_t* o = out[c] + long(im * co.v + r) * co.bw;
          for (int x = 0; x < wib[c]; ++x) o[x] = int16_t(uint8_t(u[x] << al));
        }
      }
    }
    return 0;
  }

  // One row of samples from its differences (H.1.2.1): the first row of a
  // scan or a restart interval predicts 2^(P - Pt - 1) and then the sample
  // to the left; every other row the sample above in its first column and
  // the scan's predictor elsewhere; all modulo 2^16.
  void undifference(const int* d, const int* above, int* u, int n, bool first) const {
    if (first) {
      int ra = (d[0] + (1 << (8 - al - 1))) & 0xFFFF;
      u[0] = ra;
      for (int x = 1; x < n; ++x) u[x] = ra = (d[x] + ra) & 0xFFFF;
      return;
    }
    int rb = above[0], ra = (d[0] + rb) & 0xFFFF, rc;
    u[0] = ra;
    for (int x = 1; x < n; ++x) {
      rc = rb;
      rb = above[x];
      int64_t p;
      switch (ss) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = int64_t(ra) + rb - rc; break;
        case 5: p = ra + ((int64_t(rb) - rc) >> 1); break;
        case 6: p = rb + ((int64_t(ra) - rc) >> 1); break;
        default: p = (int64_t(ra) + rb) >> 1; break;
      }
      u[x] = ra = int((d[x] + p) & 0xFFFF);
    }
  }

  // The host decode after parse(): every scan up to EOI into the padded
  // grids `out` (each bh*bw*64, zeroed here; bh*bw samples for a lossless
  // frame), the tables each component latched into `qs` and the bits each
  // coefficient was left at into `bits` (kMaxComps x 64; -1 for none). A
  // single interleaved sequential Huffman scan takes decode().
  int decode_host(int16_t* out[kMaxComps], uint16_t* qs[kMaxComps], int* bits) {
    int hmax, vmax, mx, my;
    grid_dims(&hmax, &vmax, &mx, &my);
    if (lossless) {
      mx = (width + hmax - 1) / hmax;
      my = (height + vmax - 1) / vmax;
    }
    for (int c = 0; c < ncomp; ++c) {
      comp[c].bw = mx * comp[c].h;
      comp[c].bh = my * comp[c].v;
    }
    for (int c = 0; c < kMaxComps * 64; ++c) bits[c] = 0;
    bool in_order = scan_ns == ncomp;
    for (int i = 0; i < scan_ns; ++i) in_order = in_order && scan_comp[i] == i;
    if (!progressive && !arith && !lossless && in_order) {
      int blocks = 0;
      for (int c = 0; c < ncomp; ++c) blocks += ncomp == 1 ? 1 : comp[c].h * comp[c].v;
      if (blocks > kMaxBlocksInMcu) return kBadScan;
      int rc = decode(out);
      if (rc != 0) return rc;
      for (int c = 0; c < ncomp; ++c) {
        if (!qt_defined[comp[c].tq]) return -30;
        memcpy(qs[c], qt[comp[c].tq], 64 * sizeof(uint16_t));
      }
      return 0;
    }
    const long unit = lossless ? 1 : 64;
    for (int c = 0; c < ncomp; ++c) {
      memset(out[c], 0, (size_t)comp[c].bw * comp[c].bh * unit * sizeof(int16_t));
      for (int k = 0; k < 64; ++k) coef_bits[c][k] = -1;
    }
    // lossless: each component's differences and undone samples of one
    // iMCU row (libjpeg's diff_buf and undiff_buf)
    std::vector<int> work;
    int* diff[kMaxComps] = {nullptr, nullptr, nullptr, nullptr};
    int* undiff[kMaxComps] = {nullptr, nullptr, nullptr, nullptr};
    if (lossless) {
      long total = 0;
      for (int c = 0; c < ncomp; ++c) total += 2L * comp[c].v * comp[c].bw;
      work.assign(size_t(total), 0);
      long at = 0;
      for (int c = 0; c < ncomp; ++c) {
        diff[c] = work.data() + at;
        undiff[c] = diff[c] + long(comp[c].v) * comp[c].bw;
        at += 2L * comp[c].v * comp[c].bw;
      }
    }
    for (;;) {
      int rc = lossless ? lossless_scan(out, undiff, diff) : decode_scan(out);
      if (rc != 0) return rc;
      long p = next_marker();
      if (p < 0) return -11;
      if (data[p + 1] == 0xD9) break;
      rc = parse_segments(p);
      if (rc == 1) break;
      if (rc != 0) return rc;
    }
    if (lossless) return 0;
    for (int c = 0; c < ncomp; ++c) {
      memcpy(qs[c], q_latched[c], 64 * sizeof(uint16_t));
      for (int k = 0; k < 64; ++k) bits[c * 64 + k] = coef_bits[c][k];
    }
    return 0;
  }

  // Entropy-decode all MCUs into per-component coefficient grids
  // (natural order within each 64-coeff block).
  int decode(int16_t* out[3]) {
    int hmax, vmax, mx, my;
    grid_dims(&hmax, &vmax, &mx, &my);
    for (int c = 0; c < ncomp; ++c) {
      comp[c].bw = mx * comp[c].h;
      comp[c].bh = my * comp[c].v;
      comp[c].dc_pred = 0;
    }
    BitReader br{data + scan_pos, len - scan_pos};
    long mcu_count = 0;
    int16_t block[64];
    for (int myi = 0; myi < my; ++myi) {
      for (int mxi = 0; mxi < mx; ++mxi) {
        if (restart_interval && mcu_count && mcu_count % restart_interval == 0) {
          restart(br);  // and reset the DC predictors
          for (int c = 0; c < ncomp; ++c) comp[c].dc_pred = 0;
        }
        for (int c = 0; c < ncomp; ++c) {
          Component& co = comp[c];
          const HuffTable& dct = hdc[co.td];
          const HuffTable& act = hac[co.ta];
          if (!dct.defined || !act.defined) return -20;
          for (int v = 0; v < co.v; ++v) {
            for (int h = 0; h < co.h; ++h) {
              int rc = block_seq(br, co, dct, act, block);
              if (rc != 0) return rc;
              int by = myi * co.v + v, bx = mxi * co.h + h;
              if (bp_idx != nullptr) {
                long blk = comp_block_base[c] + (long)by * co.bw + bx;
                int nz = 0;
                for (int j = 0; j < 64; ++j) nz += block[j] != 0;
                if (nz <= bp_k) {
                  int slots = 0;
                  for (int j = 0; j < 64 && slots < nz; ++j) {
                    if (block[j] == 0) continue;
                    bp_idx[blk * bp_k + slots] = (uint8_t)j;
                    bp_val[blk * bp_k + slots] = block[j];
                    slots++;
                  }
                  for (; slots < bp_k; ++slots) {
                    bp_idx[blk * bp_k + slots] = 0;  // (0,0) slots add nothing
                    bp_val[blk * bp_k + slots] = 0;
                  }
                } else {
                  // Busy block: ship the whole 64-coeff row.
                  if (bp_dense_n >= bp_dense_cap) return -24;
                  bp_dense_ids[bp_dense_n] = (int32_t)blk;
                  memcpy(bp_dense_rows + bp_dense_n * 64, block, sizeof(block));
                  bp_dense_n++;
                  memset(bp_idx + blk * bp_k, 0, bp_k);
                  memset(bp_val + blk * bp_k, 0, bp_k * sizeof(int16_t));
                }
              } else if (pk_pos != nullptr) {
                long base = comp_base[c] + ((long)by * co.bw + bx) * 64;
                for (int j = 0; j < 64; ++j) {
                  if (block[j] != 0) {
                    if (pk_n >= pk_cap) return -24;  // capacity exceeded
                    pk_pos[pk_n] = (int32_t)(base + j);
                    pk_val[pk_n] = block[j];
                    pk_n++;
                  }
                }
              } else {
                memcpy(out[c] + ((long)by * co.bw + bx) * 64, block,
                       sizeof(block));
              }
            }
          }
        }
        mcu_count++;
      }
    }
    return 0;
  }
};

}  // namespace

extern "C" {

// Query stream geometry. h_samp/v_samp/blocks_w/blocks_h are int[3].
int rcv_jpeg_info(const uint8_t* data, long len, int* width, int* height,
                  int* ncomp, int* h_samp, int* v_samp, int* blocks_w,
                  int* blocks_h) {
  Decoder d{data, len};
  int rc = d.parse();
  if (rc != 0) return rc;
  int hmax, vmax, mx, my;
  d.grid_dims(&hmax, &vmax, &mx, &my);
  *width = d.width;
  *height = d.height;
  *ncomp = d.ncomp;
  for (int c = 0; c < 3; ++c) {
    if (c < d.ncomp) {
      h_samp[c] = d.comp[c].h;
      v_samp[c] = d.comp[c].v;
      blocks_w[c] = mx * d.comp[c].h;
      blocks_h[c] = my * d.comp[c].v;
    } else {
      h_samp[c] = v_samp[c] = blocks_w[c] = blocks_h[c] = 0;
    }
  }
  return 0;
}

// Entropy-decode to PACKED nonzeros: (flat position, value) pairs over the
// concatenated per-component dense layout (see Decoder::pk_pos). Returns the
// pair count via *nnz, or -24 if more than `capacity` nonzeros exist (caller
// falls back to the dense path). Quant tables exported as in rcv_jpeg_coeffs.
int rcv_jpeg_coeffs_packed(const uint8_t* data, long len, int32_t* pos,
                           int16_t* val, long capacity, uint16_t* q0,
                           uint16_t* q1, uint16_t* q2, long* nnz) {
  Decoder d{data, len};
  int rc = d.parse();
  if (rc != 0) return rc;
  int hmax, vmax, mx, my;
  d.grid_dims(&hmax, &vmax, &mx, &my);
  long base = 0;
  for (int c = 0; c < d.ncomp; ++c) {
    d.comp_base[c] = base;
    base += (long)(mx * d.comp[c].h) * (my * d.comp[c].v) * 64;
  }
  d.pk_pos = pos;
  d.pk_val = val;
  d.pk_cap = capacity;
  int16_t* outs[3] = {nullptr, nullptr, nullptr};
  rc = d.decode(outs);
  if (rc != 0) return rc;
  uint16_t* qs[3] = {q0, q1, q2};
  for (int c = 0; c < d.ncomp; ++c) {
    if (!d.qt_defined[d.comp[c].tq]) return -30;
    memcpy(qs[c], d.qt[d.comp[c].tq], 64 * sizeof(uint16_t));
  }
  *nnz = d.pk_n;
  return 0;
}

// Entropy-decode to BLOCK-PACKED form: K (index, value) slots per block
// over the concatenated block grid (unused slots zero-filled) plus a
// dense-row escape (block id + full 64 coeffs) for blocks with more than K
// nonzeros. Returns the dense-row count via *dense_n, or -24 if it exceeds
// dense_cap (caller falls back to the fully dense path).
int rcv_jpeg_coeffs_blockpacked(const uint8_t* data, long len, uint8_t* idx,
                                int16_t* val, int k, int32_t* dense_ids,
                                int16_t* dense_rows, long dense_cap,
                                uint16_t* q0, uint16_t* q1, uint16_t* q2,
                                long* dense_n) {
  Decoder d{data, len};
  int rc = d.parse();
  if (rc != 0) return rc;
  if (k < 1 || k > 64) return -25;
  int hmax, vmax, mx, my;
  d.grid_dims(&hmax, &vmax, &mx, &my);
  long cbase = 0, bbase = 0;
  for (int c = 0; c < d.ncomp; ++c) {
    d.comp_base[c] = cbase;
    d.comp_block_base[c] = bbase;
    long nblocks = (long)(mx * d.comp[c].h) * (my * d.comp[c].v);
    cbase += nblocks * 64;
    bbase += nblocks;
  }
  d.bp_idx = idx;
  d.bp_val = val;
  d.bp_k = k;
  d.bp_dense_ids = dense_ids;
  d.bp_dense_rows = dense_rows;
  d.bp_dense_cap = dense_cap;
  int16_t* outs[3] = {nullptr, nullptr, nullptr};
  rc = d.decode(outs);
  if (rc != 0) return rc;
  uint16_t* qs[3] = {q0, q1, q2};
  for (int c = 0; c < d.ncomp; ++c) {
    if (!d.qt_defined[d.comp[c].tq]) return -30;
    memcpy(qs[c], d.qt[d.comp[c].tq], 64 * sizeof(uint16_t));
  }
  *dense_n = d.bp_dense_n;
  return 0;
}

// The host decode's header parse: rcv_jpeg_info's geometry (int[4] each)
// for any frame the host decode reads. *flags: bit 0 a progressive frame,
// bit 1 three components libjpeg takes as RGB (no JFIF marker and Adobe's
// transform 0, or neither marker and the component ids 'R', 'G', 'B'), bit
// 2 a lossless frame (its grids count samples, not blocks), bit 3 an
// arithmetic-coded one, bit 4 four components libjpeg takes as YCCK (an
// Adobe marker whose transform is not 0); bits 8-11 a lone component's
// vertical factor as its frame header gives it.
int rcv_jpeg_host_info(const uint8_t* data, long len, int* width, int* height, int* ncomp,
                       int* h_samp, int* v_samp, int* blocks_w, int* blocks_h, int* flags) {
  Decoder d{data, len};
  d.host = true;
  int rc = d.parse();
  if (rc != 0) return rc;
  int hmax, vmax, mx, my;
  d.grid_dims(&hmax, &vmax, &mx, &my);
  if (d.lossless) {
    mx = (d.width + hmax - 1) / hmax;
    my = (d.height + vmax - 1) / vmax;
  }
  *width = d.width;
  *height = d.height;
  *ncomp = d.ncomp;
  for (int c = 0; c < kMaxComps; ++c) {
    bool on = c < d.ncomp;
    h_samp[c] = on ? d.comp[c].h : 0;
    v_samp[c] = on ? d.comp[c].v : 0;
    blocks_w[c] = on ? mx * d.comp[c].h : 0;
    blocks_h[c] = on ? my * d.comp[c].v : 0;
  }
  bool rgb = false;
  if (d.ncomp == 3 && !d.saw_jfif) {
    rgb = d.saw_adobe ? d.adobe_transform == 0
                      : (d.comp[0].id == 'R' && d.comp[1].id == 'G' && d.comp[2].id == 'B');
  }
  bool ycck = d.ncomp == 4 && d.saw_adobe && d.adobe_transform != 0;
  *flags = (d.progressive ? 1 : 0) | (rgb ? 2 : 0) | (d.lossless ? 4 : 0) | (d.arith ? 8 : 0) |
           (ycck ? 16 : 0) | ((d.ncomp == 1 ? d.comp[0].fv : 0) << 8);
  return 0;
}

// The host decode's entropy decode: every scan into the caller's buffers
// outs[c] (bh*bw*64 int16 each, natural order, as rcv_jpeg_host_info sizes
// them; bh*bw output samples for a lossless frame), the quant table each
// component used into qs[c] (64 uint16), and into bits (4 x 64 int) the
// low bit each coefficient was last refined to at EOI (-1: never sent; 0
// but in a progressive frame), which decides libjpeg's block smoothing.
int rcv_jpeg_host_coeffs(const uint8_t* data, long len, int16_t** outs, uint16_t** qs, int* bits) {
  Decoder d{data, len};
  d.host = true;
  int rc = d.parse();
  if (rc != 0) return rc;
  return d.decode_host(outs, qs, bits);
}

// Entropy-decode into caller buffers (each bh*bw*64 int16, natural order)
// and export the per-component quant tables (64 × uint16, natural order).
int rcv_jpeg_coeffs(const uint8_t* data, long len, int16_t* out0,
                    int16_t* out1, int16_t* out2, uint16_t* q0, uint16_t* q1,
                    uint16_t* q2) {
  Decoder d{data, len};
  int rc = d.parse();
  if (rc != 0) return rc;
  int16_t* outs[3] = {out0, out1, out2};
  rc = d.decode(outs);
  if (rc != 0) return rc;
  uint16_t* qs[3] = {q0, q1, q2};
  for (int c = 0; c < d.ncomp; ++c) {
    if (!d.qt_defined[d.comp[c].tq]) return -30;
    memcpy(qs[c], d.qt[d.comp[c].tq], 64 * sizeof(uint16_t));
  }
  return 0;
}

}  // extern "C"
