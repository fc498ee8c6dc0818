// The lossless WebP decode (VP8L) to RGBA, and the ALPH chunk of a lossy
// WebP (raw or VP8L-compressed, unfiltered as libwebp unfilters it).
//
// VP8L is exact: the prefix codes (simple codes, and normal codes through
// the code-length code), the meta prefix codes of the entropy image, LZ77
// with the 120-entry distance map, the colour cache, and the four
// transforms (the predictor with its 14 modes, the cross-colour transform,
// subtract-green, colour indexing with pixel bundling), each applied once,
// in reverse order. What libwebp checks is checked here: a code must be
// complete (or one symbol, read with no bits), a transform type appears once,
// a copy stays inside the image, the stream does not end early.
//
// A corrupt or truncated stream returns a negative code; the decoder never
// reads or writes out of bounds.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum { kOk = 0, kBad = -1, kTruncated = -2, kNoMemory = -5 };

// -- the bit reader (least significant bit first) ------------------------------

struct BitReader {
  const uint8_t* data = nullptr;
  size_t len = 0;
  uint64_t pos = 0;  // in bits

  bool eos() const { return pos > 8 * (uint64_t)len; }
  uint64_t peek() const {  // at least 57 bits from pos, zeros past the end
    const size_t bp = (size_t)(pos >> 3);
    uint64_t v = 0;
    if (bp + 8 <= len) {
      memcpy(&v, data + bp, 8);
    } else {
      for (size_t i = 0; i < 8 && bp + i < len; ++i) v |= (uint64_t)data[bp + i] << (8 * i);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = (uint32_t)(peek() & ((1ull << n) - 1));
    pos += n;
    return v;
  }
};

// -- canonical prefix codes ----------------------------------------------------

constexpr int kMaxLength = 15;
constexpr int kFastBits = 8;

struct Huffman {
  int single = -1;              // the symbol of a one-symbol code (read with no bits)
  std::vector<uint32_t> fast;   // (length << 16) | symbol for codes of at most kFastBits
  uint16_t count[kMaxLength + 1] = {0};
  std::vector<uint16_t> sorted; // symbols by (length, symbol)

  bool build(const int* lengths, int n) {
    memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) {
      if (lengths[s] < 0 || lengths[s] > kMaxLength) return false;
      ++count[lengths[s]];
    }
    if (count[0] == n) return false;
    if (n - count[0] == 1) {
      for (int s = 0; s < n; ++s)
        if (lengths[s] > 0) single = s;
      return true;
    }
    int left = 1;
    for (int len = 1; len <= kMaxLength; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) return false;  // over-subscribed
    }
    if (left > 0) return false;  // incomplete
    int offset[kMaxLength + 2];
    offset[1] = 0;
    for (int len = 1; len <= kMaxLength; ++len) offset[len + 1] = offset[len] + count[len];
    sorted.assign(offset[kMaxLength + 1], 0);
    std::vector<int> next(offset, offset + kMaxLength + 2);
    for (int s = 0; s < n; ++s)
      if (lengths[s] > 0) sorted[next[lengths[s]]++] = (uint16_t)s;
    fast.assign(1 << kFastBits, 0);
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= kMaxLength; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        if (len > kFastBits) continue;
        uint32_t rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (uint32_t j = rev; j < (1u << kFastBits); j += 1u << len)
          fast[j] = ((uint32_t)len << 16) | sorted[k];
      }
      code <<= 1;
    }
    return true;
  }

  int read(BitReader& br) const {
    if (single >= 0) return single;
    const uint64_t bits = br.peek();
    const uint32_t e = fast[bits & ((1 << kFastBits) - 1)];
    if (e >> 16) {
      br.pos += e >> 16;
      return (int)(e & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxLength; ++len) {
      code |= (int)((bits >> (len - 1)) & 1);
      const int cnt = count[len];
      if (code - first < cnt) {
        br.pos += len;
        return sorted[index + code - first];
      }
      index += cnt;
      first += cnt;
      first <<= 1;
      code <<= 1;
    }
    return 0;  // not reached: the code is complete
  }
};

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24, kNumDistanceCodes = 40;
const int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, kNumLiteralCodes,
                              kNumLiteralCodes, kNumLiteralCodes, kNumDistanceCodes};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};
// the distance map: (dx, dy) of the 120 short distance codes
const int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

struct Group {
  Huffman h[5];
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int sub_sample_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) -
                             (int)((c2 >> s) & 0xff)) << s;
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}

inline int sub3(int a, int b, int c) { return abs(b - c) - abs(a - c); }

inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3((a >> 24), (b >> 24), (c >> 24)) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return (pa_minus_pb <= 0) ? a : b;
}

// the prediction of mode m from the left pixel L and the row above (top[0] is T)
inline uint32_t predict(int m, uint32_t L, const uint32_t* top) {
  switch (m) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], L, top[-1]);
    case 12: return clamped_add_subtract_full(L, top[0], top[-1]);
    case 13: return clamped_add_subtract_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and the padding modes 14 and 15
  }
}

void inverse_predictor(const Transform& t, uint32_t* data) {
  const int w = t.xsize, h = t.ysize;
  const int tiles_per_row = sub_sample_size(w, t.bits);
  data[0] = add_pixels(data[0], 0xff000000u);
  for (int x = 1; x < w; ++x) data[x] = add_pixels(data[x], data[x - 1]);
  for (int y = 1; y < h; ++y) {
    uint32_t* const row = data + (size_t)y * w;
    const uint32_t* const modes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
    row[0] = add_pixels(row[0], row[-w]);
    for (int x = 1; x < w; ++x) {
      const int m = (modes[x >> t.bits] >> 8) & 0xf;
      row[x] = add_pixels(row[x], predict(m, row[x - 1], row + x - w));
    }
  }
}

inline int color_transform_delta(int8_t color_pred, int8_t color) {
  return ((int)color_pred * color) >> 5;
}

void inverse_cross_color(const Transform& t, uint32_t* data) {
  const int w = t.xsize, h = t.ysize;
  const int tiles_per_row = sub_sample_size(w, t.bits);
  for (int y = 0; y < h; ++y) {
    uint32_t* const row = data + (size_t)y * w;
    const uint32_t* const codes = t.data.data() + (size_t)(y >> t.bits) * tiles_per_row;
    for (int x = 0; x < w; ++x) {
      const uint32_t code = codes[x >> t.bits];
      const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
                   r2b = (int8_t)((code >> 16) & 0xff);
      const uint32_t argb = row[x];
      const int8_t green = (int8_t)(argb >> 8);
      int new_red = (argb >> 16) & 0xff;
      int new_blue = argb & 0xff;
      new_red += color_transform_delta(g2r, green);
      new_red &= 0xff;
      new_blue += color_transform_delta(g2b, green);
      new_blue += color_transform_delta(r2b, (int8_t)new_red);
      new_blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
    }
  }
}

void add_green(uint32_t* data, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    const uint32_t argb = data[i];
    const uint32_t green = (argb >> 8) & 0xff;
    uint32_t red_blue = argb & 0x00ff00ffu;
    red_blue += (green << 16) | green;
    red_blue &= 0x00ff00ffu;
    data[i] = (argb & 0xff00ff00u) | red_blue;
  }
}

// colour indexing: the packed image (xsize >> bits wide) -> xsize wide
std::vector<uint32_t> inverse_color_index(const Transform& t, const std::vector<uint32_t>& in) {
  const int w = t.xsize, h = t.ysize;
  const int packed_w = sub_sample_size(w, t.bits);
  std::vector<uint32_t> out((size_t)w * h);
  const int bits_per_pixel = 8 >> t.bits;
  const int count_mask = (1 << t.bits) - 1;
  const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
  const uint32_t* map = t.data.data();
  for (int y = 0; y < h; ++y) {
    const uint32_t* src = in.data() + (size_t)y * packed_w;
    uint32_t* dst = out.data() + (size_t)y * w;
    uint32_t packed = 0;
    for (int x = 0; x < w; ++x) {
      if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
      dst[x] = map[packed & bit_mask];
      packed >>= bits_per_pixel;
    }
  }
  return out;
}

struct Decoder {
  BitReader br;
  int transforms_seen = 0;
  std::vector<Transform> transforms;

  bool read_code(int alphabet_size, Huffman* h);
  bool read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths);
  bool read_transform(int* xsize, int ysize);
  bool decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out);
};

bool Decoder::read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
  Huffman table;
  if (!table.build(cl_lengths, 19)) return false;
  int max_symbol;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(length_nbits);
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int prev_code_len = 8;
  int symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const int code_len = table.read(br);
    if (br.eos()) return false;
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      const int slot = code_len - 16;
      static const int kExtraBits[3] = {2, 3, 7};
      static const int kRepeatOffsets[3] = {3, 3, 11};
      const int repeat = (int)br.read(kExtraBits[slot]) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return false;
      const int length = (code_len == 16) ? prev_code_len : 0;
      for (int i = 0; i < repeat; ++i) lengths[symbol++] = length;
    }
  }
  return true;
}

bool Decoder::read_code(int alphabet_size, Huffman* h) {
  std::vector<int> lengths(alphabet_size > 256 ? alphabet_size : 256, 0);
  if (br.read(1)) {  // a simple code: one or two symbols
    const int num_symbols = (int)br.read(1) + 1;
    const int first_symbol_len_code = (int)br.read(1);
    int symbol = (int)br.read(first_symbol_len_code == 0 ? 1 : 8);
    lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = (int)br.read(8);
      lengths[symbol] = 1;
    }
  } else {
    int cl_lengths[19] = {0};
    const int num_codes = (int)br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = (int)br.read(3);
    if (!read_code_lengths(cl_lengths, alphabet_size, lengths.data())) return false;
  }
  if (br.eos()) return false;
  return h->build(lengths.data(), alphabet_size);
}

bool Decoder::read_transform(int* xsize, int ysize) {
  const int type = (int)br.read(2);
  if (transforms_seen & (1 << type)) return false;
  transforms_seen |= 1 << type;
  Transform t;
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  if (type == 0 || type == 1) {  // predictor, cross-colour
    t.bits = 2 + (int)br.read(3);
    if (!decode_stream(sub_sample_size(t.xsize, t.bits), sub_sample_size(t.ysize, t.bits), false,
                       &t.data))
      return false;
  } else if (type == 3) {  // colour indexing
    const int num_colors = (int)br.read(8) + 1;
    const int bits = (num_colors > 16) ? 0 : (num_colors > 4) ? 1 : (num_colors > 2) ? 2 : 3;
    *xsize = sub_sample_size(t.xsize, bits);
    t.bits = bits;
    std::vector<uint32_t> pal;
    if (!decode_stream(num_colors, 1, false, &pal)) return false;
    const int final_num_colors = 1 << (8 >> bits);
    t.data.assign(final_num_colors, 0);  // indices past the palette: transparent black
    t.data[0] = pal[0];
    for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
  }
  transforms.push_back(std::move(t));
  return true;
}

inline int copy_value(int symbol, BitReader& br) {  // GetCopyDistance / GetCopyLength
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + (int)br.read(extra_bits) + 1;
}

inline int plane_code_to_distance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int dist = kDistanceMap[plane_code - 1][1] * xsize + kDistanceMap[plane_code - 1][0];
  return dist >= 1 ? dist : 1;
}

bool Decoder::decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out) {
  int txsize = xsize;
  if (level0)
    while (br.read(1))
      if (br.eos() || !read_transform(&txsize, ysize)) return false;
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  // the prefix codes, and the entropy image that picks a group per tile
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    huffman_bits = 2 + (int)br.read(3);
    huffman_xsize = sub_sample_size(txsize, huffman_bits);
    if (!decode_stream(huffman_xsize, sub_sample_size(ysize, huffman_bits), false,
                       &huffman_image))
      return false;
    for (auto& p : huffman_image) {
      p = (p >> 8) & 0xffff;
      if ((int)p >= num_groups) num_groups = (int)p + 1;
    }
  }
  if (br.eos()) return false;
  std::vector<Group> groups(num_groups);
  for (auto& g : groups) {
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabetSize[j];
      if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
      if (!read_code(alphabet, &g.h[j])) return false;
    }
  }
  const size_t total = (size_t)txsize * ysize;
  out->assign(total, 0);
  uint32_t* const data = out->data();
  std::vector<uint32_t> cache(cache_bits > 0 ? (1u << cache_bits) : 0, 0);
  const int cache_shift = 32 - cache_bits;
  const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
  const int mask = huffman_bits > 0 ? (1 << huffman_bits) - 1 : -1;
  size_t pos = 0;
  int col = 0, row = 0;
  const Group* g = &groups[0];
  auto group_at = [&](int x, int y) -> const Group* {
    if (huffman_bits == 0) return &groups[0];
    return &groups[huffman_image[(size_t)(y >> huffman_bits) * huffman_xsize +
                                 (x >> huffman_bits)]];
  };
  auto insert = [&](uint32_t argb) {
    if (cache_bits > 0) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
  };
  while (pos < total) {
    if ((col & mask) == 0) g = group_at(col, row);
    const int code = g->h[GREEN].read(br);
    if (br.eos()) return false;
    if (code < kNumLiteralCodes) {
      const int red = g->h[RED].read(br);
      const int blue = g->h[BLUE].read(br);
      const int alpha = g->h[ALPHA].read(br);
      if (br.eos()) return false;
      const uint32_t argb = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) |
                            (uint32_t)blue;
      data[pos++] = argb;
      insert(argb);
      if (++col >= txsize) {
        col = 0;
        ++row;
      }
    } else if (code < len_code_limit) {
      const int length = copy_value(code - kNumLiteralCodes, br);
      const int dist_symbol = g->h[DIST].read(br);
      const int dist = plane_code_to_distance(txsize, copy_value(dist_symbol, br));
      if (br.eos()) return false;
      if (pos < (size_t)dist || total - pos < (size_t)length) return false;
      for (int i = 0; i < length; ++i) {
        data[pos] = data[pos - dist];
        insert(data[pos]);
        ++pos;
      }
      col += length;
      while (col >= txsize) {
        col -= txsize;
        ++row;
      }
      if (col & mask) g = group_at(col, row);
    } else {
      const int key = code - len_code_limit;
      if (key >= (int)cache.size()) return false;
      const uint32_t argb = cache[key];
      data[pos++] = argb;
      insert(argb);
      if (++col >= txsize) {
        col = 0;
        ++row;
      }
    }
  }
  return !br.eos();
}

// a whole image stream (the transforms read first) -> width x height ARGB
int decode_argb(const uint8_t* data, size_t size, int width, int height,
                std::vector<uint32_t>* argb) {
  Decoder d;
  d.br.data = data;
  d.br.len = size;
  if (!d.decode_stream(width, height, true, argb)) return d.br.eos() ? kTruncated : kBad;
  for (int i = (int)d.transforms.size() - 1; i >= 0; --i) {
    const Transform& t = d.transforms[i];
    switch (t.type) {
      case 0: inverse_predictor(t, argb->data()); break;
      case 1: inverse_cross_color(t, argb->data()); break;
      case 2: add_green(argb->data(), (size_t)t.xsize * t.ysize); break;
      default: *argb = inverse_color_index(t, *argb); break;
    }
  }
  return kOk;
}

int read_header(const uint8_t* data, long size, int* width, int* height, int* has_alpha) {
  if (size < 5) return kTruncated;
  if (data[0] != 0x2f || (data[4] >> 5) != 0) return kBad;  // signature, version 0
  BitReader br;
  br.data = data + 1;
  br.len = (size_t)size - 1;
  *width = (int)br.read(14) + 1;
  *height = (int)br.read(14) + 1;
  *has_alpha = (int)br.read(1);
  return kOk;
}

}  // namespace

extern "C" {

// The header of a VP8L chunk's payload: 0 with the size and the alpha bit,
// or a negative code.
int rcv_vp8l_info(const uint8_t* data, long size, int* width, int* height, int* has_alpha) {
  return read_header(data, size, width, height, has_alpha);
}

// A VP8L chunk's payload -> RGBA rows ``stride`` bytes apart at ``out``.
int rcv_vp8l_decode(const uint8_t* data, long size, uint8_t* out, long stride) {
  try {
    int w, h, a;
    int rc = read_header(data, size, &w, &h, &a);
    if (rc != kOk) return rc;
    if (stride < 4L * w) return kBad;
    std::vector<uint32_t> argb;
    rc = decode_argb(data + 5, (size_t)size - 5, w, h, &argb);
    if (rc != kOk) return rc;
    for (int y = 0; y < h; ++y) {
      uint8_t* dst = out + y * stride;
      const uint32_t* src = argb.data() + (size_t)y * w;
      for (int x = 0; x < w; ++x) {
        const uint32_t p = src[x];
        dst[4 * x + 0] = (p >> 16) & 0xff;
        dst[4 * x + 1] = (p >> 8) & 0xff;
        dst[4 * x + 2] = p & 0xff;
        dst[4 * x + 3] = p >> 24;
      }
    }
    return kOk;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

// An ALPH chunk's payload -> the width x height alpha plane: compression 0
// (raw) or 1 (VP8L, its green channel), then filtering 0-3 (none,
// horizontal, vertical, gradient) undone as libwebp undoes it. The
// pre-processing bits are read and ignored (no alpha dithering).
int rcv_webp_alpha_decode(const uint8_t* data, long size, int width, int height, uint8_t* out) {
  try {
    if (size <= 1) return kTruncated;
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
              rsrv = (data[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0) return kBad;
    const size_t n = (size_t)width * height;
    if (method == 0) {
      if ((size_t)(size - 1) < n) return kTruncated;
      memcpy(out, data + 1, n);
    } else {
      std::vector<uint32_t> argb;
      const int rc = decode_argb(data + 1, (size_t)size - 1, width, height, &argb);
      if (rc != kOk) return rc;
      for (size_t i = 0; i < n; ++i) out[i] = (argb[i] >> 8) & 0xff;
    }
    if (filter == 0) return kOk;
    // the first row: horizontal in every filter
    for (int x = 1; x < width; ++x) out[x] = (uint8_t)(out[x] + out[x - 1]);
    for (int y = 1; y < height; ++y) {
      const uint8_t* prev = out + (size_t)(y - 1) * width;
      uint8_t* cur = out + (size_t)y * width;
      if (filter == 1) {
        uint8_t pred = prev[0];
        for (int x = 0; x < width; ++x) {
          cur[x] = (uint8_t)(pred + cur[x]);
          pred = cur[x];
        }
      } else if (filter == 2) {
        for (int x = 0; x < width; ++x) cur[x] = (uint8_t)(prev[x] + cur[x]);
      } else {
        uint8_t top = prev[0], top_left = top, left = top;
        for (int x = 0; x < width; ++x) {
          top = prev[x];
          const int g = left + top - top_left;
          left = (uint8_t)(cur[x] + (((g & ~0xff) == 0) ? g : (g < 0) ? 0 : 255));
          top_left = top;
          cur[x] = left;
        }
      }
    }
    return kOk;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
