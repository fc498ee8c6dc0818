// The bit-level loops of the port's TIFF and GIF codecs (imgcodecs/tiff.py,
// imgcodecs/gif.py), too slow in Python at 1080p (two million codes a frame):
//   GIF LZW decode and encode: codes packed LSB first, the width growing
//     from min_bits + 1 to 12 as the table fills, clear and end codes;
//   TIFF LZW decode: codes packed MSB first, 256 clear, 257 end, and the
//     "early change" (the width grows one code before the table needs it);
//   PackBits decode (TIFF compression 32773).
// Every decoder bounds its reads by the input's length and its writes by
// the output's; a corrupt stream returns a negative code.
// Built with g++ at first use (see __init__.py); plain C interface.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxCodes = 4096;

// One LZW string table: the string of code c is string(prefix[c]) then
// suffix[c]; first[c] is its first byte and length[c] its length.
struct Table {
  int16_t prefix[kMaxCodes];
  uint8_t suffix[kMaxCodes];
  uint8_t first[kMaxCodes];
  int32_t length[kMaxCodes];

  explicit Table(int literals) {
    for (int c = 0; c < literals; c++) {
      prefix[c] = -1;
      suffix[c] = first[c] = uint8_t(c);
      length[c] = 1;
    }
  }

  // Writes string(code) at out[o:], clipped at out_len; returns its length.
  long emit(int code, uint8_t* out, long o, long out_len) const {
    long len = length[code];
    for (long i = len - 1; i >= 0; i--) {
      if (o + i < out_len) out[o + i] = suffix[code];
      code = prefix[code];
    }
    return len;
  }
};

}  // namespace

extern "C" {

// GIF image data (the sub-blocks' bytes, joined) → colour indices, row
// after row as the stream gives them. Stops at the end code, when out is
// full or when the data runs out. Returns the indices written, -1 for a
// code past the table (or a string code before any literal), -2 for a
// minimum code size outside 1-8.
long rcv_gif_lzw_decode(const uint8_t* data, long n, int min_bits, uint8_t* out, long out_len) {
  if (min_bits < 1 || min_bits > 8) return -2;
  const int clear = 1 << min_bits, eoi = clear + 1;
  Table t(clear);
  int width = min_bits + 1, next = clear + 2, prev = -1;
  uint32_t bits = 0;
  int nbits = 0;
  long p = 0, o = 0;
  while (o < out_len) {
    while (nbits < width) {
      if (p >= n) return o;
      bits |= uint32_t(data[p++]) << nbits;
      nbits += 8;
    }
    const int code = int(bits & ((1u << width) - 1));
    bits >>= width;
    nbits -= width;
    if (code == clear) {
      width = min_bits + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    if (prev < 0) {
      if (code >= clear) return -1;
      out[o++] = uint8_t(code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= kMaxCodes)) return -1;
    uint8_t head;
    if (code == next) {  // the string being defined: prev's string, then its first byte
      head = t.first[prev];
    } else {
      head = t.first[code];
    }
    if (next < kMaxCodes) {
      t.prefix[next] = int16_t(prev);
      t.suffix[next] = head;
      t.first[next] = t.first[prev];
      t.length[next] = t.length[prev] + 1;
      next++;
      if (next == (1 << width) && width < 12) width++;
    }
    o += t.emit(code, out, o, out_len);
    prev = code;
  }
  return o < out_len ? o : out_len;
}

// Colour indices → GIF LZW codes (not yet cut into sub-blocks): a clear
// code first, a clear whenever the table is full, the end code last.
// Returns the bytes written, -1 when cap is too small, -2 for a bad
// minimum code size or an index past it.
long rcv_gif_lzw_encode(const uint8_t* idx, long n, int min_bits, uint8_t* out, long cap) {
  if (min_bits < 2 || min_bits > 8) return -2;
  const int clear = 1 << min_bits, eoi = clear + 1;
  constexpr int kHash = 8191;  // a prime above the 4096 codes
  std::vector<int32_t> keys(kHash), codes(kHash);
  int width = min_bits + 1, next = clear + 2;
  uint32_t acc = 0;
  int nacc = 0;
  long o = 0;
  auto put = [&](int code) -> bool {
    acc |= uint32_t(code) << nacc;
    nacc += width;
    while (nacc >= 8) {
      if (o >= cap) return false;
      out[o++] = uint8_t(acc & 0xFF);
      acc >>= 8;
      nacc -= 8;
    }
    return true;
  };
  auto reset = [&]() {
    std::fill(keys.begin(), keys.end(), -1);
    width = min_bits + 1;
    next = clear + 2;
  };
  reset();
  if (!put(clear)) return -1;
  if (n > 0) {
    int cur = idx[0];
    if (cur >= clear) return -2;
    for (long i = 1; i < n; i++) {
      const int k = idx[i];
      if (k >= clear) return -2;
      const int32_t key = (cur << 8) | k;
      int h = int((uint32_t(key) * 2654435761u) % kHash);
      while (keys[h] != -1 && keys[h] != key) h = h + 1 == kHash ? 0 : h + 1;
      if (keys[h] == key) {
        cur = codes[h];
        continue;
      }
      if (!put(cur)) return -1;
      if (next < kMaxCodes) {
        keys[h] = key;
        codes[h] = next++;
        if (next > (1 << width) && width < 12) width++;
      } else {
        if (!put(clear)) return -1;
        reset();
      }
      cur = k;
    }
    if (!put(cur)) return -1;
    // The decoder adds an entry on reading cur: the end code may need a wider code.
    if (next < kMaxCodes && next + 1 > (1 << width) && width < 12) width++;
  }
  if (!put(eoi)) return -1;
  if (nacc > 0) {
    if (o >= cap) return -1;
    out[o++] = uint8_t(acc & 0xFF);
  }
  return o;
}

// A TIFF LZW strip or tile → its bytes. Stops at the end code or when out
// is full. Returns the bytes written (fewer than out_len when the data
// ends early), -1 for a code past the table, -3 for the old-style
// (LSB-first) LZW that a stream starting 0x00 0x01 announces.
long rcv_tiff_lzw_decode(const uint8_t* data, long n, uint8_t* out, long out_len) {
  if (n >= 2 && data[0] == 0 && (data[1] & 1)) return -3;
  Table t(256);
  constexpr int clear = 256, eoi = 257;
  int width = 9, next = 258, prev = -1;
  uint64_t bits = 0;
  int nbits = 0;
  long p = 0, o = 0;
  while (o < out_len) {
    while (nbits < width) {
      if (p >= n) return o;
      bits = (bits << 8) | data[p++];
      nbits += 8;
    }
    const int code = int((bits >> (nbits - width)) & ((1u << width) - 1));
    nbits -= width;
    if (code == clear) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    if (prev < 0) {
      if (code > 255) return -1;
      out[o++] = uint8_t(code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= kMaxCodes)) return -1;
    const uint8_t head = code == next ? t.first[prev] : t.first[code];
    if (next < kMaxCodes) {
      t.prefix[next] = int16_t(prev);
      t.suffix[next] = head;
      t.first[next] = t.first[prev];
      t.length[next] = t.length[prev] + 1;
      next++;
      if (next >= (1 << width) - 1 && width < 12) width++;
    }
    o += t.emit(code, out, o, out_len);
    prev = code;
  }
  return o < out_len ? o : out_len;
}

// A PackBits strip → its bytes: a header byte h; 0-127 copies h + 1 bytes,
// -127 to -1 repeats the next byte 1 - h times, -128 is skipped. Returns
// the bytes written (stops when out is full or the data ends).
long rcv_packbits_decode(const uint8_t* data, long n, uint8_t* out, long out_len) {
  long p = 0, o = 0;
  while (p < n && o < out_len) {
    const int h = int8_t(data[p++]);
    if (h >= 0) {
      long len = h + 1;
      if (len > out_len - o) len = out_len - o;
      if (len > n - p) break;  // libtiff drops a literal run its data cuts short
      std::memcpy(out + o, data + p, size_t(len));
      p += h + 1;
      o += len;
    } else if (h != -128) {
      if (p >= n) break;
      long len = 1 - h;
      if (len > out_len - o) len = out_len - o;
      std::memset(out + o, data[p++], size_t(len));
      o += len;
    }
  }
  return o;
}

}  // extern "C"
