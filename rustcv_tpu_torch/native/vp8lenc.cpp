// The ALPH chunk of a lossy WebP, compressed: the alpha plane as a VP8L
// image stream (compression 1) that carries it in green, as libwebp's
// alpha encoder (alpha_enc.c: EncodeLossless, WebPDispatchAlphaToGreen)
// lays it out. vp8l.cpp's rcv_webp_alpha_decode reads it back exactly.
//
// The payload is one header byte (compression 1, the filter, no
// pre-processing) and the VP8L stream without the VP8L header: the width and
// height are the VP8 frame's. The stream (the lossless bitstream
// specification, least significant bit first):
//
// * the alpha filter (none, horizontal, vertical or gradient, as libwebp's
//   filters/unfilters define them): each is tried and the smallest stream
//   kept; where no stream is smaller than the plane, the plane is stored raw
//   (compression 0), as libwebp falls back;
// * the colour-indexing transform where the (filtered) plane has at most 16
//   values, which masks have: the palette (as a delta-coded 1-row image)
//   and 2, 4 or 8 pixels bundled per byte of green;
// * no colour cache and one prefix-code group (no meta prefix codes);
// * the pixels as literals and LZ77 backward references (the longest of
//   the run of the pixel before, the row above through the distance map's
//   code 1, and matches a hash chain finds), greedily;
// * five prefix codes (green with the length codes, red, blue, alpha,
//   distance) with code lengths from the symbols' histogram, limited to 15
//   bits, sent as simple codes where one or two symbols below 256 are used
//   and else through the code-length code (lengths limited to 7, runs of
//   zeros and repeats as codes 16-18).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <queue>
#include <vector>

namespace {

enum { kOk = 0, kBadArgs = -1, kTooSmall = -2, kNoMemory = -5 };

// -- the bit writer (least significant bit first) ---------------------------------

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int used = 0;

  void put(uint32_t bits, int n) {
    if (n == 0) return;
    acc |= (uint64_t)bits << used;
    used += n;
    while (used >= 8) {
      buf.push_back((uint8_t)acc);
      acc >>= 8;
      used -= 8;
    }
  }
  void finish() {
    if (used > 0) buf.push_back((uint8_t)acc);
    acc = 0;
    used = 0;
  }
};

// -- prefix codes --------------------------------------------------------------------

constexpr int kMaxCodeLength = 15;
constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24, kNumDistanceCodes = 40;
constexpr int kNumCodeLengthCodes = 19;
const uint8_t kCodeLengthCodeOrder[kNumCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                           7,  8,  9, 10, 11, 12, 13, 14, 15};

// Huffman code lengths of the histogram, none longer than max_len: the tree
// is rebuilt with every count raised to a floor that doubles until it fits.
std::vector<int> code_lengths(const std::vector<uint32_t>& histo, int max_len) {
  const int n = (int)histo.size();
  std::vector<int> lengths(n, 0);
  int used = 0;
  for (int s = 0; s < n; ++s) used += histo[s] > 0;
  if (used == 0) return lengths;
  if (used == 1) {
    for (int s = 0; s < n; ++s)
      if (histo[s]) lengths[s] = 1;
    return lengths;
  }
  for (uint64_t floor = 1;; floor *= 2) {
    struct Node {
      uint64_t w;
      int id;
    };
    auto cmp = [](const Node& a, const Node& b) { return a.w != b.w ? a.w > b.w : a.id > b.id; };
    std::priority_queue<Node, std::vector<Node>, decltype(cmp)> heap(cmp);
    std::vector<int> parent;
    for (int s = 0; s < n; ++s)
      if (histo[s]) {
        heap.push({std::max<uint64_t>(histo[s], floor), (int)parent.size()});
        parent.push_back(-1);
      }
    std::vector<int> leaf_symbol;
    for (int s = 0; s < n; ++s)
      if (histo[s]) leaf_symbol.push_back(s);
    const int leaves = (int)parent.size();
    while (heap.size() > 1) {
      const Node a = heap.top();
      heap.pop();
      const Node b = heap.top();
      heap.pop();
      const int id = (int)parent.size();
      parent.push_back(-1);
      parent[a.id] = parent[b.id] = id;
      heap.push({a.w + b.w, id});
    }
    int max_depth = 0;
    for (int i = 0; i < leaves; ++i) {
      int d = 0;
      for (int p = i; parent[p] >= 0; p = parent[p]) ++d;
      lengths[leaf_symbol[i]] = d;
      max_depth = std::max(max_depth, d);
    }
    if (max_depth <= max_len) return lengths;
  }
}

// the canonical codes of the lengths, bit-reversed for the LSB-first writer
std::vector<uint16_t> canonical_codes(const std::vector<int>& lengths) {
  int count[kMaxCodeLength + 1] = {0};
  for (int l : lengths) ++count[l];
  count[0] = 0;
  int next[kMaxCodeLength + 2] = {0};
  int code = 0;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  std::vector<uint16_t> codes(lengths.size(), 0);
  for (size_t s = 0; s < lengths.size(); ++s) {
    const int len = lengths[s];
    if (len == 0) continue;
    const int c = next[len]++;
    int rev = 0;
    for (int b = 0; b < len; ++b) rev |= ((c >> b) & 1) << (len - 1 - b);
    codes[s] = (uint16_t)rev;
  }
  return codes;
}

struct PrefixCode {
  std::vector<int> lengths;
  std::vector<uint16_t> codes;
  bool single = false;  // one symbol: written with no bits

  void write_symbol(BitWriter& bw, int s) const {
    if (!single) bw.put(codes[s], lengths[s]);
  }
};

// the code lengths through the code-length code (codes 16-18 for repeats)
void write_code_lengths(BitWriter& bw, const std::vector<int>& lengths) {
  struct Token {
    int code, extra, extra_bits;
  };
  std::vector<Token> tokens;
  const int n = (int)lengths.size();
  int prev = 8;  // the length code 16 repeats, before any non-zero one
  for (int i = 0; i < n;) {
    const int v = lengths[i];
    int run = 1;
    while (i + run < n && lengths[i + run] == v) ++run;
    i += run;
    if (v == 0) {
      while (run > 0) {
        if (run < 3) {
          for (; run > 0; --run) tokens.push_back({0, 0, 0});
        } else if (run <= 10) {
          tokens.push_back({17, run - 3, 3});
          run = 0;
        } else {
          const int r = std::min(run, 138);
          tokens.push_back({18, r - 11, 7});
          run -= r;
        }
      }
    } else {
      if (v != prev) {
        tokens.push_back({v, 0, 0});
        --run;
        prev = v;
      }
      while (run > 0) {
        if (run < 3) {
          for (; run > 0; --run) tokens.push_back({v, 0, 0});
        } else {
          const int r = std::min(run, 6);
          tokens.push_back({16, r - 3, 2});
          run -= r;
        }
      }
    }
  }
  std::vector<uint32_t> histo(kNumCodeLengthCodes, 0);
  for (const Token& t : tokens) ++histo[t.code];
  int used = 0;
  for (uint32_t h : histo) used += h > 0;
  if (used == 1) {  // a one-symbol code-length code: give it a second symbol
    for (int s = 0; s < kNumCodeLengthCodes; ++s)
      if (!histo[s]) {
        histo[s] = 1;
        break;
      }
  }
  const std::vector<int> cl = code_lengths(histo, 7);
  const std::vector<uint16_t> cc = canonical_codes(cl);
  int num_codes = kNumCodeLengthCodes;
  while (num_codes > 4 && cl[kCodeLengthCodeOrder[num_codes - 1]] == 0) --num_codes;
  bw.put(0, 1);  // a normal code
  bw.put(num_codes - 4, 4);
  for (int i = 0; i < num_codes; ++i) bw.put(cl[kCodeLengthCodeOrder[i]], 3);
  bw.put(0, 1);  // every symbol's length is sent
  for (const Token& t : tokens) {
    bw.put(cc[t.code], cl[t.code]);
    bw.put(t.extra, t.extra_bits);
  }
}

// builds and writes the prefix code of the histogram
PrefixCode write_code(BitWriter& bw, const std::vector<uint32_t>& histo) {
  PrefixCode pc;
  int symbols[2] = {0, 0}, count = 0;
  for (int s = 0; s < (int)histo.size(); ++s)
    if (histo[s]) {
      if (count < 2) symbols[count] = s;
      ++count;
    }
  if (count <= 2 && symbols[0] < 256 && symbols[1] < 256) {  // a simple code
    pc.lengths.assign(histo.size(), 0);
    bw.put(1, 1);
    bw.put(count == 2 ? 1 : 0, 1);
    if (symbols[0] < 2) {
      bw.put(0, 1);
      bw.put(symbols[0], 1);
    } else {
      bw.put(1, 1);
      bw.put(symbols[0], 8);
    }
    if (count == 2) {
      bw.put(symbols[1], 8);
      pc.lengths[symbols[0]] = pc.lengths[symbols[1]] = 1;
      pc.codes = canonical_codes(pc.lengths);
    } else {
      pc.single = true;
    }
    return pc;
  }
  pc.lengths = code_lengths(histo, kMaxCodeLength);
  pc.codes = canonical_codes(pc.lengths);
  pc.single = count == 1;
  write_code_lengths(bw, pc.lengths);
  return pc;
}

// -- the image stream ------------------------------------------------------------------

// a value (>= 1) as its prefix symbol and extra bits
inline void prefix_encode(int value, int* symbol, int* extra_bits, int* extra_value) {
  const int v = value - 1;
  if (v < 4) {
    *symbol = v;
    *extra_bits = 0;
    *extra_value = 0;
    return;
  }
  const int hb = 31 - __builtin_clz((uint32_t)v);
  const int second = (v >> (hb - 1)) & 1;
  *extra_bits = hb - 1;
  *extra_value = v & ((1 << *extra_bits) - 1);
  *symbol = 2 * hb + second;
}

// the distance map of the lossless format: (dx, dy) of codes 1-120
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

struct Ref {  // a literal (len 0) or a copy
  int len, dist;
  uint32_t argb;
};

constexpr int kMaxLength = 4096, kMinLength = 3;
constexpr int kHashBits = 16, kChainDepth = 16, kWindow = 1 << 18;

// greedy LZ77 over the pixels of an xsize-wide image
std::vector<Ref> backward_refs(const std::vector<uint32_t>& px, int xsize) {
  const int n = (int)px.size();
  std::vector<Ref> refs;
  std::vector<int> head(1 << kHashBits, -1), prev(n, -1);
  auto hash = [&](int i) {
    const uint32_t h = (px[i] * 0x1e35a7bdu) ^ (px[i + 1] * 0x9e3779b1u) ^ (px[i + 2] * 0x85ebca6bu);
    return (int)(h >> (32 - kHashBits));
  };
  auto insert = [&](int i) {
    if (i + 2 < n) {
      const int h = hash(i);
      prev[i] = head[h];
      head[h] = i;
    }
  };
  auto match_len = [&](int i, int dist) {
    const int limit = std::min(kMaxLength, n - i);
    int l = 0;
    while (l < limit && px[i + l] == px[i + l - dist]) ++l;
    return l;
  };
  for (int i = 0; i < n;) {
    int best_len = 0, best_dist = 0;
    for (int dist : {1, xsize}) {  // the run, then the row above
      if (dist <= i) {
        const int l = match_len(i, dist);
        if (l > best_len) {
          best_len = l;
          best_dist = dist;
        }
      }
    }
    if (best_len < kMaxLength && i + 2 < n) {
      int cand = head[hash(i)];
      for (int depth = 0; cand >= 0 && depth < kChainDepth && i - cand <= kWindow;
           ++depth, cand = prev[cand]) {
        const int l = match_len(i, i - cand);
        if (l > best_len) {
          best_len = l;
          best_dist = i - cand;
        }
      }
    }
    if (best_len >= kMinLength) {
      refs.push_back({best_len, best_dist, 0});
      for (int k = 0; k < best_len; ++k) insert(i + k);
      i += best_len;
    } else {
      refs.push_back({0, 0, px[i]});
      insert(i);
      ++i;
    }
  }
  return refs;
}

// the codes of the distances for an xsize-wide image: the smallest map code,
// else distance + 120
struct DistanceCodes {
  std::vector<int> code;
  explicit DistanceCodes(int xsize) : code((size_t)8 * xsize + 9, 0) {
    for (int c = 120; c >= 1; --c) {
      const int d = kDistanceMap[c - 1][1] * xsize + kDistanceMap[c - 1][0];
      if (d >= 1 && d < (int)code.size()) code[d] = c;
    }
  }
  int of(int dist) const { return dist < (int)code.size() && code[dist] ? code[dist] : dist + 120; }
};

// the entropy-coded pixels of an image (after its transforms): the colour
// cache bit, and at level 0 the meta-code bit, then the five codes and data
void write_pixels(BitWriter& bw, const std::vector<uint32_t>& px, int xsize, bool level0) {
  const std::vector<Ref> refs = backward_refs(px, xsize);
  const DistanceCodes dcodes(xsize);
  std::vector<uint32_t> histo[5] = {
      std::vector<uint32_t>(kNumLiteralCodes + kNumLengthCodes, 0),
      std::vector<uint32_t>(kNumLiteralCodes, 0), std::vector<uint32_t>(kNumLiteralCodes, 0),
      std::vector<uint32_t>(kNumLiteralCodes, 0), std::vector<uint32_t>(kNumDistanceCodes, 0)};
  int sym, eb, ev;
  for (const Ref& r : refs) {
    if (r.len == 0) {
      ++histo[0][(r.argb >> 8) & 0xff];
      ++histo[1][(r.argb >> 16) & 0xff];
      ++histo[2][r.argb & 0xff];
      ++histo[3][r.argb >> 24];
    } else {
      prefix_encode(r.len, &sym, &eb, &ev);
      ++histo[0][kNumLiteralCodes + sym];
      prefix_encode(dcodes.of(r.dist), &sym, &eb, &ev);
      ++histo[4][sym];
    }
  }
  bw.put(0, 1);             // no colour cache
  if (level0) bw.put(0, 1);  // no meta prefix codes
  PrefixCode codes[5];
  for (int j = 0; j < 5; ++j) codes[j] = write_code(bw, histo[j]);
  for (const Ref& r : refs) {
    if (r.len == 0) {
      codes[0].write_symbol(bw, (r.argb >> 8) & 0xff);
      codes[1].write_symbol(bw, (r.argb >> 16) & 0xff);
      codes[2].write_symbol(bw, r.argb & 0xff);
      codes[3].write_symbol(bw, r.argb >> 24);
    } else {
      prefix_encode(r.len, &sym, &eb, &ev);
      codes[0].write_symbol(bw, kNumLiteralCodes + sym);
      bw.put(ev, eb);
      prefix_encode(dcodes.of(r.dist), &sym, &eb, &ev);
      codes[4].write_symbol(bw, sym);
      bw.put(ev, eb);
    }
  }
}

// the alpha filters (libwebp's filters.c): the delta of each value from its
// prediction; the first row predicts from the left in every filter
std::vector<uint8_t> filter_alpha(const uint8_t* a, long stride, int w, int h, int filter) {
  std::vector<uint8_t> out((size_t)w * h);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = a + y * stride;
    const uint8_t* up = a + (y - 1) * stride;
    uint8_t* dst = &out[(size_t)y * w];
    for (int x = 0; x < w; ++x) {
      int pred;
      if (filter == 0) {
        pred = 0;
      } else if (y == 0) {
        pred = x ? row[x - 1] : 0;
      } else if (filter == 1) {
        pred = x ? row[x - 1] : up[0];
      } else if (filter == 2) {
        pred = up[x];
      } else if (x == 0) {
        pred = up[0];
      } else {
        const int g = row[x - 1] + up[x] - up[x - 1];
        pred = g < 0 ? 0 : g > 255 ? 255 : g;
      }
      dst[x] = (uint8_t)(row[x] - pred);
    }
  }
  return out;
}

// the VP8L stream (no header) of a w x h plane carried in green
std::vector<uint8_t> encode_plane(const std::vector<uint8_t>& plane, int w, int h) {
  BitWriter bw;
  bool seen[256] = {false};
  int num_colors = 0;
  for (uint8_t v : plane)
    if (!seen[v]) {
      seen[v] = true;
      ++num_colors;
    }
  std::vector<uint32_t> px;
  int xsize = w;
  if (num_colors <= 16) {  // colour indexing, 2-8 pixels bundled per byte
    uint8_t index[256] = {0};
    std::vector<uint32_t> palette;
    for (int v = 0; v < 256; ++v)
      if (seen[v]) {
        index[v] = (uint8_t)palette.size();
        palette.push_back((uint32_t)v << 8);
      }
    const int bits = num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
    const int bits_per_pixel = 8 >> bits;
    xsize = (w + (1 << bits) - 1) >> bits;
    bw.put(1, 1);  // a transform
    bw.put(3, 2);  // colour indexing
    bw.put(num_colors - 1, 8);
    std::vector<uint32_t> deltas(palette.size());  // the palette, delta-coded
    for (size_t i = 0; i < palette.size(); ++i)
      deltas[i] = i ? ((palette[i] - palette[i - 1]) & 0xff00u) : palette[i];
    write_pixels(bw, deltas, (int)deltas.size(), false);
    px.assign((size_t)xsize * h, 0);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t idx = index[plane[(size_t)y * w + x]];
        px[(size_t)y * xsize + (x >> bits)] |= idx << (8 + bits_per_pixel * (x & ((1 << bits) - 1)));
      }
  } else {
    px.resize(plane.size());
    for (size_t i = 0; i < plane.size(); ++i) px[i] = (uint32_t)plane[i] << 8;
  }
  bw.put(0, 1);  // no more transforms
  write_pixels(bw, px, xsize, true);
  bw.finish();
  return std::move(bw.buf);
}

}  // namespace

extern "C" {

// A w x h alpha plane (rows stride apart) -> an ALPH chunk's payload at out
// (cap bytes): compression 1 under the filter (0-3) that gives the smallest
// stream, or the raw plane where that is no larger (at most 1 + width *
// height bytes). Returns the payload's size, or -1 bad arguments, -2 out
// too small, -5 out of memory.
long rcv_alph_encode(const uint8_t* alpha, long stride, int width, int height, uint8_t* out,
                     long cap) {
  try {
    if (width < 1 || height < 1 || width > 16383 || height > 16383 || stride < width)
      return kBadArgs;
    std::vector<uint8_t> best;
    int best_filter = 0;
    for (int f = 0; f < 4; ++f) {
      std::vector<uint8_t> s = encode_plane(filter_alpha(alpha, stride, width, height, f), width,
                                            height);
      if (best.empty() || s.size() < best.size()) {
        best.swap(s);
        best_filter = f;
      }
    }
    const size_t n = (size_t)width * height;
    const bool raw = best.size() >= n;
    const size_t size = 1 + (raw ? n : best.size());
    if ((long)size > cap) return kTooSmall;
    if (raw) {  // compression 0, unfiltered
      out[0] = 0;
      for (int y = 0; y < height; ++y) memcpy(out + 1 + (size_t)y * width, alpha + y * stride, width);
    } else {
      out[0] = (uint8_t)((best_filter << 2) | 1);  // the filter, compression 1
      memcpy(out + 1, best.data(), best.size());
    }
    return (long)size;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
