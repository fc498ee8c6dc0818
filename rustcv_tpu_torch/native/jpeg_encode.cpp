// Baseline JPEG entropy ENCODER: quantized DCT coefficients → JFIF bytes.
//
// The host half of the TPU MJPEG *encode* path — the mirror image of
// jpeg_entropy.cpp. Everything numeric (BGR→YCbCr, chroma subsampling,
// forward DCT as one [64,64] MXU matmul, quantization) runs on-device
// (rustcv_tpu/ops/jpeg_encode.py); the sequential, bit-granular Huffman
// coding runs here. This mirrors the reference's use of turbojpeg to
// *encode* camera frames for MJPEG-over-HTTP fan-out
// (rustcv-backend-v4l2/examples/web_streaming.rs:44-100) — except the
// number-crunching half moves to the TPU.
//
// Emits baseline sequential, 8-bit, 1 or 3 components, single interleaved
// scan, standard Annex-K Huffman tables, JFIF APP0 header, no restart
// markers. Input coefficients are int16 in NATURAL (row-major) order over
// the full padded MCU block grid per component — exactly the layout the
// device quantizer produces and jpeg_entropy.cpp's decoder emits, so
// encode→decode round-trips bit-exactly.

#include <cstdint>
#include <cstring>

#ifndef INT32_MIN
#define INT32_MIN (-2147483647 - 1)
#endif

namespace {

const uint8_t ZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K (K.3.3) standard Huffman table specs: BITS[1..16] then HUFFVAL.
const uint8_t DC_LUMA_BITS[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t DC_LUMA_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t DC_CHROMA_BITS[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t DC_CHROMA_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t AC_LUMA_BITS[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t AC_LUMA_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t AC_CHROMA_BITS[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t AC_CHROMA_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Canonical Huffman encode table: code + length per symbol value.
struct EncTable {
  uint16_t code[256];
  uint8_t len[256];
};

void build_enc_table(const uint8_t bits[17], const uint8_t* vals, int nvals,
                     EncTable* t) {
  std::memset(t->len, 0, sizeof(t->len));
  uint16_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l] && k < nvals; ++i, ++k) {
      t->code[vals[k]] = code++;
      t->len[vals[k]] = (uint8_t)l;
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* out;
  long cap;
  long pos = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (pos >= cap) {
      overflow = true;
      return;
    }
    out[pos++] = b;
  }

  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((n < 32 ? (1u << n) : 0u) - 1u));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      byte(b);
      if (b == 0xFF) byte(0x00);  // byte stuffing
      nbits -= 8;
    }
  }

  void flush() {
    if (nbits > 0) {
      // Pad with 1-bits per spec F.1.2.3.
      uint8_t b = (uint8_t)((acc << (8 - nbits)) | ((1u << (8 - nbits)) - 1u));
      byte(b);
      if (b == 0xFF) byte(0x00);
      nbits = 0;
      acc = 0;
    }
  }
};

inline int bit_size(int v) {
  int a = v < 0 ? -v : v;
  int s = 0;
  while (a) {
    ++s;
    a >>= 1;
  }
  return s;
}

// Encode one 8×8 block (natural order) given previous DC value. Returns the
// new DC predictor, or INT32_MIN when a coefficient's magnitude exceeds the
// Huffman tables' categories (DC diff > 11 bits / AC > 10 with Annex-K
// tables) — emitting the magnitude bits without a symbol code would
// produce a silently undecodable stream, so the caller aborts instead.
int encode_block(BitWriter* bw, const int16_t* blk, int prev_dc,
                 const EncTable* dc_t, const EncTable* ac_t) {
  int dc = blk[0];
  int diff = dc - prev_dc;
  int s = bit_size(diff);
  if (s > 15 || dc_t->len[s] == 0) return INT32_MIN;
  bw->put(dc_t->code[s], dc_t->len[s]);
  if (s) bw->put((uint32_t)(diff >= 0 ? diff : diff + (1 << s) - 1), s);

  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = blk[ZIGZAG[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run >= 16) {
      bw->put(ac_t->code[0xF0], ac_t->len[0xF0]);  // ZRL
      run -= 16;
    }
    int sz = bit_size(v);
    int sym = (run << 4) | sz;
    if (sz > 15 || ac_t->len[sym] == 0) return INT32_MIN;
    bw->put(ac_t->code[sym], ac_t->len[sym]);
    bw->put((uint32_t)(v >= 0 ? v : v + (1 << sz) - 1), sz);
    run = 0;
  }
  if (run > 0) bw->put(ac_t->code[0x00], ac_t->len[0x00]);  // EOB
  return dc;
}

void put_u16(BitWriter* bw, uint16_t v) {
  bw->byte((uint8_t)(v >> 8));
  bw->byte((uint8_t)(v & 0xFF));
}

void put_marker(BitWriter* bw, uint8_t m) {
  bw->byte(0xFF);
  bw->byte(m);
}

void put_dht(BitWriter* bw, int cls, int id, const uint8_t bits[17],
             const uint8_t* vals) {
  int n = 0;
  for (int l = 1; l <= 16; ++l) n += bits[l];
  put_marker(bw, 0xC4);
  put_u16(bw, (uint16_t)(2 + 1 + 16 + n));
  bw->byte((uint8_t)((cls << 4) | id));
  for (int l = 1; l <= 16; ++l) bw->byte(bits[l]);
  for (int i = 0; i < n; ++i) bw->byte(vals[i]);
}

}  // namespace

extern "C" {

// Quantized coefficient grids (natural order, int16, full padded MCU grid
// per component, [bh*bw*64]) → baseline JFIF stream.
//
// ncomp: 1 (gray) or 3 (YCbCr). bws/bhs: per-component block-grid dims.
// hs/vs: sampling factors (e.g. 4:2:0 = {2,1,1}/{2,1,1}). width/height: the
// image geometry written to SOF0. qluma/qchroma: quant tables in NATURAL
// order (chroma table ignored when ncomp == 1). Returns bytes written, or
// -1 bad args / -2 output buffer too small / -3 a coefficient's magnitude
// exceeds the baseline Huffman categories (callers clamp to ±1023).
long rcv_jpeg_entropy_encode(const int16_t* c0, const int16_t* c1,
                             const int16_t* c2, int ncomp, const int* bws,
                             const int* bhs, const int* hs, const int* vs,
                             int width, int height, const uint16_t* qluma,
                             const uint16_t* qchroma, uint8_t* out,
                             long cap) {
  if (!c0 || !out || !qluma || (ncomp != 1 && ncomp != 3) || width <= 0 ||
      height <= 0)
    return -1;
  if (ncomp == 3 && (!c1 || !c2 || !qchroma)) return -1;
  const int16_t* comps[3] = {c0, c1, c2};

  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (hs[c] < 1 || hs[c] > 4 || vs[c] < 1 || vs[c] > 4) return -1;
    if (hs[c] > hmax) hmax = hs[c];
    if (vs[c] > vmax) vmax = vs[c];
  }
  int mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
  int mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
  for (int c = 0; c < ncomp; ++c) {
    if (bws[c] != mcus_x * hs[c] || bhs[c] != mcus_y * vs[c]) return -1;
  }

  BitWriter bw{out, cap};

  // SOI + JFIF APP0.
  put_marker(&bw, 0xD8);
  put_marker(&bw, 0xE0);
  put_u16(&bw, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (int i = 0; i < 14; ++i) bw.byte(jfif[i]);

  // DQT (values in zigzag order per spec; tables are stored natural here).
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); ++t) {
    const uint16_t* q = t == 0 ? qluma : qchroma;
    put_marker(&bw, 0xDB);
    put_u16(&bw, 67);
    bw.byte((uint8_t)t);  // Pq=0 (8-bit), Tq=t
    for (int k = 0; k < 64; ++k) {
      uint16_t v = q[ZIGZAG[k]];
      bw.byte((uint8_t)(v > 255 ? 255 : (v < 1 ? 1 : v)));
    }
  }

  // SOF0.
  put_marker(&bw, 0xC0);
  put_u16(&bw, (uint16_t)(8 + 3 * ncomp));
  bw.byte(8);  // precision
  put_u16(&bw, (uint16_t)height);
  put_u16(&bw, (uint16_t)width);
  bw.byte((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    bw.byte((uint8_t)(c + 1));                       // component id
    bw.byte((uint8_t)((hs[c] << 4) | vs[c]));        // sampling
    bw.byte((uint8_t)(c == 0 ? 0 : 1));              // quant table id
  }

  // DHT — standard tables.
  EncTable dc_l, ac_l, dc_c, ac_c;
  build_enc_table(DC_LUMA_BITS, DC_LUMA_VALS, 12, &dc_l);
  build_enc_table(AC_LUMA_BITS, AC_LUMA_VALS, 162, &ac_l);
  put_dht(&bw, 0, 0, DC_LUMA_BITS, DC_LUMA_VALS);
  put_dht(&bw, 1, 0, AC_LUMA_BITS, AC_LUMA_VALS);
  if (ncomp == 3) {
    build_enc_table(DC_CHROMA_BITS, DC_CHROMA_VALS, 12, &dc_c);
    build_enc_table(AC_CHROMA_BITS, AC_CHROMA_VALS, 162, &ac_c);
    put_dht(&bw, 0, 1, DC_CHROMA_BITS, DC_CHROMA_VALS);
    put_dht(&bw, 1, 1, AC_CHROMA_BITS, AC_CHROMA_VALS);
  }

  // SOS.
  put_marker(&bw, 0xDA);
  put_u16(&bw, (uint16_t)(6 + 2 * ncomp));
  bw.byte((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    bw.byte((uint8_t)(c + 1));
    bw.byte((uint8_t)(c == 0 ? 0x00 : 0x11));  // DC/AC table ids
  }
  bw.byte(0);     // Ss
  bw.byte(63);    // Se
  bw.byte(0);     // Ah/Al

  // Interleaved MCU scan.
  int prev_dc[3] = {0, 0, 0};
  for (int my = 0; my < mcus_y && !bw.overflow; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      for (int c = 0; c < ncomp; ++c) {
        const EncTable* dt = (c == 0) ? &dc_l : &dc_c;
        const EncTable* at = (c == 0) ? &ac_l : &ac_c;
        for (int by = 0; by < vs[c]; ++by) {
          for (int bx = 0; bx < hs[c]; ++bx) {
            long bi = (long)(my * vs[c] + by) * bws[c] + (mx * hs[c] + bx);
            int dc = encode_block(&bw, comps[c] + bi * 64, prev_dc[c], dt, at);
            if (dc == INT32_MIN) return -3;  // out-of-category coefficient
            prev_dc[c] = dc;
          }
        }
      }
    }
  }
  bw.flush();
  put_marker(&bw, 0xD9);  // EOI
  if (bw.overflow) return -2;
  return bw.pos;
}

// Packed-input variant: the device ships per-block (position, value) slot
// pairs for light blocks (≤ K nonzeros) plus whole 64-wide dense rows for
// busy blocks (rustcv_tpu/ops/jpeg_encode.py::pack_coeff_rows) — ~3× fewer
// D2H bytes than dense int16 grids. Components are CONCATENATED along the
// block axis in (Y, Cb, Cr) order; `idx`/`val` are [nbt, K], `dense_ids`
// [dcap] holds global block ids (sentinel ≥ nbt for unused slots),
// `dense_rows` [dcap, 64]. Geometry/table args as rcv_jpeg_entropy_encode.
// Returns bytes written or the same negative codes (-1 bad args, -2 buffer
// too small, -3 out-of-category coefficient).
long rcv_jpeg_entropy_encode_packed(
    const uint8_t* idx, const int16_t* val, int kslots,
    const int32_t* dense_ids, const int16_t* dense_rows, int dcap,
    int ncomp, const int* bws, const int* bhs, const int* hs, const int* vs,
    int width, int height, const uint16_t* qluma, const uint16_t* qchroma,
    uint8_t* out, long cap) {
  if (!idx || !val || !out || !qluma || kslots < 1 || kslots > 64 ||
      (ncomp != 1 && ncomp != 3) || width <= 0 || height <= 0)
    return -1;
  if (ncomp == 3 && !qchroma) return -1;
  if (dcap > 0 && (!dense_ids || !dense_rows)) return -1;

  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (hs[c] < 1 || hs[c] > 4 || vs[c] < 1 || vs[c] > 4) return -1;
    if (hs[c] > hmax) hmax = hs[c];
    if (vs[c] > vmax) vmax = vs[c];
  }
  int mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
  int mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
  long comp_off[3] = {0, 0, 0};
  long nbt = 0;
  for (int c = 0; c < ncomp; ++c) {
    if (bws[c] != mcus_x * hs[c] || bhs[c] != mcus_y * vs[c]) return -1;
    comp_off[c] = nbt;
    nbt += (long)bws[c] * bhs[c];
  }
  // Busy-block lookup: global block id → dense row (or -1).
  // dcap is small (~nbt/16); a full-size map keeps the hot loop branchless.
  int32_t* dense_of = new int32_t[nbt];
  for (long i = 0; i < nbt; ++i) dense_of[i] = -1;
  for (int d = 0; d < dcap; ++d) {
    int32_t id = dense_ids[d];
    if (id >= 0 && id < nbt) dense_of[id] = d;
  }

  BitWriter bw{out, cap};
  put_marker(&bw, 0xD8);
  put_marker(&bw, 0xE0);
  put_u16(&bw, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (int i = 0; i < 14; ++i) bw.byte(jfif[i]);
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); ++t) {
    const uint16_t* q = t == 0 ? qluma : qchroma;
    put_marker(&bw, 0xDB);
    put_u16(&bw, 67);
    bw.byte((uint8_t)t);
    for (int k = 0; k < 64; ++k) {
      uint16_t v = q[ZIGZAG[k]];
      bw.byte((uint8_t)(v > 255 ? 255 : (v < 1 ? 1 : v)));
    }
  }
  put_marker(&bw, 0xC0);
  put_u16(&bw, (uint16_t)(8 + 3 * ncomp));
  bw.byte(8);
  put_u16(&bw, (uint16_t)height);
  put_u16(&bw, (uint16_t)width);
  bw.byte((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    bw.byte((uint8_t)(c + 1));
    bw.byte((uint8_t)((hs[c] << 4) | vs[c]));
    bw.byte((uint8_t)(c == 0 ? 0 : 1));
  }
  EncTable dc_l, ac_l, dc_c, ac_c;
  build_enc_table(DC_LUMA_BITS, DC_LUMA_VALS, 12, &dc_l);
  build_enc_table(AC_LUMA_BITS, AC_LUMA_VALS, 162, &ac_l);
  put_dht(&bw, 0, 0, DC_LUMA_BITS, DC_LUMA_VALS);
  put_dht(&bw, 1, 0, AC_LUMA_BITS, AC_LUMA_VALS);
  if (ncomp == 3) {
    build_enc_table(DC_CHROMA_BITS, DC_CHROMA_VALS, 12, &dc_c);
    build_enc_table(AC_CHROMA_BITS, AC_CHROMA_VALS, 162, &ac_c);
    put_dht(&bw, 0, 1, DC_CHROMA_BITS, DC_CHROMA_VALS);
    put_dht(&bw, 1, 1, AC_CHROMA_BITS, AC_CHROMA_VALS);
  }
  put_marker(&bw, 0xDA);
  put_u16(&bw, (uint16_t)(6 + 2 * ncomp));
  bw.byte((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    bw.byte((uint8_t)(c + 1));
    bw.byte((uint8_t)(c == 0 ? 0x00 : 0x11));
  }
  bw.byte(0);
  bw.byte(63);
  bw.byte(0);

  int prev_dc[3] = {0, 0, 0};
  int16_t blk[64];
  long rc = 0;
  for (int my = 0; my < mcus_y && !bw.overflow && rc == 0; ++my) {
    for (int mx = 0; mx < mcus_x && rc == 0; ++mx) {
      for (int c = 0; c < ncomp; ++c) {
        const EncTable* dt = (c == 0) ? &dc_l : &dc_c;
        const EncTable* at = (c == 0) ? &ac_l : &ac_c;
        for (int by = 0; by < vs[c]; ++by) {
          for (int bx = 0; bx < hs[c]; ++bx) {
            long bi = comp_off[c] +
                      (long)(my * vs[c] + by) * bws[c] + (mx * hs[c] + bx);
            const int16_t* src;
            if (dense_of[bi] >= 0) {
              src = dense_rows + (long)dense_of[bi] * 64;
            } else {
              std::memset(blk, 0, sizeof(blk));
              const uint8_t* bidx = idx + bi * kslots;
              const int16_t* bval = val + bi * kslots;
              for (int s = 0; s < kslots; ++s) {
                if (bval[s]) blk[bidx[s] & 63] = bval[s];
              }
              src = blk;
            }
            int dc = encode_block(&bw, src, prev_dc[c], dt, at);
            if (dc == INT32_MIN) {
              rc = -3;
              break;
            }
            prev_dc[c] = dc;
          }
          if (rc) break;
        }
        if (rc) break;
      }
    }
  }
  delete[] dense_of;
  if (rc) return rc;
  bw.flush();
  put_marker(&bw, 0xD9);
  if (bw.overflow) return -2;
  return bw.pos;
}

}  // extern "C"
