// PNG scanline unfiltering for the port's host PNG reader (the reading
// half of the format's five filters; see imgcodecs/host.py). Each
// decompressed row is a filter-type byte then `row_bytes` filtered bytes;
// `bpp` is the bytes per pixel, the distance to the "left" neighbour.
//   0 None, 1 Sub (+left), 2 Up (+above), 3 Average (+(left+above)/2),
//   4 Paeth (+whichever of left, above, upper-left is nearest to
//   left + above - upper-left; ties prefer left, then above)
// Built with g++ at first use (see __init__.py); plain C interface.

#include <cstdint>
#include <cstdlib>

extern "C" {

// Returns 0, -1 for an unknown filter type, -2 when `raw` is short.
int rcv_png_unfilter(const uint8_t* raw, long raw_len, int height, long row_bytes, int bpp,
                     uint8_t* out) {
  if (raw_len < long(height) * (row_bytes + 1)) return -2;
  for (int r = 0; r < height; r++) {
    const uint8_t* src = raw + long(r) * (row_bytes + 1);
    int type = src[0];
    src++;
    uint8_t* dst = out + long(r) * row_bytes;
    const uint8_t* up = r > 0 ? dst - row_bytes : nullptr;
    for (long i = 0; i < row_bytes; i++) {
      int a = i >= bpp ? dst[i - bpp] : 0;
      int b = up ? up[i] : 0;
      int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      dst[i] = uint8_t(src[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
