// Anti-aliased glyph rasterizer for put_text: exact-area coverage of a
// TrueType outline (on-curve points and quadratic off-curve points, 26.6
// fixed point), non-zero winding, written from the cell-accumulation
// algorithm that FreeType's smooth renderer uses, so that the coverage
// bytes are the ones Pillow gets from FreeType for the same hinted outline
// (tests/test_torch_text.py holds whole strings against the reference).
//
// The algorithm: each contour is walked in sub-pixel units (1/256 px).
// Every segment adds, to each pixel cell it crosses, its signed height in
// that cell ("cover") and twice the signed area between the segment and
// the cell's left edge ("area"). Quadratic arcs are cut into 2^k chords by
// forward differencing, k chosen so the deviation of a chord is at most a
// quarter pixel. A row is then swept left to right: the running sum of
// covers gives the area of every cell to the right of an edge, and a
// cell's own coverage is that sum less its area. Coverage is the area
// scaled to 0..255 (negative windings are complemented, and the result
// clamps at 255).
//
// Glyphs are composed onto the canvas as Pillow composes them: a glyph's
// coverage a goes over the canvas value d as a + d*(255-a)/255, with
// Pillow's rounding of the division, inside a clip box.
//
// Built with g++ at first use (see __init__.py); plain C interface.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

typedef long long i64;

constexpr int kPixelBits = 8;
constexpr i64 kOnePixel = i64(1) << kPixelBits;

inline i64 trunc_px(i64 x) { return x >> kPixelBits; }
inline i64 fract_px(i64 x) { return x & (kOnePixel - 1); }
inline i64 upscale(i64 x) { return x << (kPixelBits - 6); }  // 26.6 -> 1/256 px

// a / b for a >= 0, b > 0 through a 32-bit reciprocal: floor((2^32-1)/b)
// times a, over 2^32. It is at times one below the exact quotient, and the
// smooth renderer's exit points are these quotients, so the cells are too.
inline i64 recip(i64 b) { return i64(0xFFFFFFFFull / (unsigned long long)b); }
inline i64 udiv(i64 a, i64 b_recip) {
  return i64(((unsigned long long)a * (unsigned long long)b_recip) >> 32);
}

struct Raster {
  int w = 0, h = 0;          // cell grid, pixels
  std::vector<i64> cover;    // per cell: signed height crossed
  std::vector<i64> area;     // per cell: twice the signed area left of the edges
  i64 x = 0, y = 0;          // pen, 1/256 px
  int ex = 0, ey = 0;        // current cell
  bool valid = false;        // current cell inside the grid

  void set_cell(i64 cx, i64 cy) {
    ex = int(cx);
    ey = int(cy);
    valid = cx >= 0 && cx < w && cy >= 0 && cy < h;
  }
  void add(i64 c, i64 a) {
    if (valid) {
      cover[size_t(ey) * w + ex] += c;
      area[size_t(ey) * w + ex] += a;
    }
  }

  void move_to(i64 tx, i64 ty) {
    set_cell(trunc_px(tx), trunc_px(ty));
    x = tx;
    y = ty;
  }

  // One straight segment from the pen to (tx, ty), cell by cell.
  void line_to(i64 tx, i64 ty) {
    i64 ex1 = trunc_px(x), ex2 = trunc_px(tx);
    i64 ey1 = trunc_px(y), ey2 = trunc_px(ty);
    if ((ey1 >= h && ey2 >= h) || (ey1 < 0 && ey2 < 0)) {
      x = tx;
      y = ty;
      return;
    }
    i64 dx = tx - x, dy = ty - y;
    i64 fx1 = fract_px(x), fy1 = fract_px(y), fx2, fy2;

    if (ex1 == ex2 && ey1 == ey2) {
      // inside one cell
    } else if (dy == 0) {  // horizontal: no cover, just move
      set_cell(ex2, ey2);
      x = tx;
      y = ty;
      return;
    } else if (dx == 0) {  // vertical
      if (dy > 0) {
        do {
          fy2 = kOnePixel;
          add(fy2 - fy1, (fy2 - fy1) * fx1 * 2);
          fy1 = 0;
          ey1++;
          set_cell(ex1, ey1);
        } while (ey1 != ey2);
      } else {
        do {
          fy2 = 0;
          add(fy2 - fy1, (fy2 - fy1) * fx1 * 2);
          fy1 = kOnePixel;
          ey1--;
          set_cell(ex1, ey1);
        } while (ey1 != ey2);
      }
    } else {
      // `prod` is the cross product of the direction with the position in
      // the cell; its sign at the four corners says which edge the segment
      // leaves through, and the exit point is a quotient of it.
      i64 prod = dx * fy1 - dy * fx1;
      i64 rx = ex1 != ex2 ? recip(dx < 0 ? -dx : dx) : 0;
      i64 ry = ey1 != ey2 ? recip(dy < 0 ? -dy : dy) : 0;
      do {
        if (prod - dx * kOnePixel > 0 && prod <= 0) {  // left
          fx2 = 0;
          fy2 = udiv(-prod, rx);
          prod -= dy * kOnePixel;
          add(fy2 - fy1, (fy2 - fy1) * (fx1 + fx2));
          fx1 = kOnePixel;
          fy1 = fy2;
          ex1--;
        } else if (prod - dx * kOnePixel + dy * kOnePixel > 0 &&
                   prod - dx * kOnePixel <= 0) {  // up
          prod -= dx * kOnePixel;
          fx2 = udiv(-prod, ry);
          fy2 = kOnePixel;
          add(fy2 - fy1, (fy2 - fy1) * (fx1 + fx2));
          fx1 = fx2;
          fy1 = 0;
          ey1++;
        } else if (prod + dy * kOnePixel >= 0 &&
                   prod - dx * kOnePixel + dy * kOnePixel <= 0) {  // right
          prod += dy * kOnePixel;
          fx2 = kOnePixel;
          fy2 = udiv(prod, rx);
          add(fy2 - fy1, (fy2 - fy1) * (fx1 + fx2));
          fx1 = 0;
          fy1 = fy2;
          ex1++;
        } else {  // down
          fx2 = udiv(prod, ry);
          fy2 = 0;
          prod += dx * kOnePixel;
          add(fy2 - fy1, (fy2 - fy1) * (fx1 + fx2));
          fx1 = fx2;
          fy1 = kOnePixel;
          ey1--;
        }
        set_cell(ex1, ey1);
      } while (ex1 != ex2 || ey1 != ey2);
    }
    fx2 = fract_px(tx);
    fy2 = fract_px(ty);
    add(fy2 - fy1, (fy2 - fy1) * (fx1 + fx2));
    x = tx;
    y = ty;
  }

  // Quadratic arc from the pen through control (cx, cy) to (tx, ty).
  void conic_to(i64 cx, i64 cy, i64 tx, i64 ty) {
    i64 p0x = x, p0y = y;
    if ((trunc_px(p0y) >= h && trunc_px(cy) >= h && trunc_px(ty) >= h) ||
        (trunc_px(p0y) < 0 && trunc_px(cy) < 0 && trunc_px(ty) < 0)) {
      x = tx;
      y = ty;
      return;
    }
    i64 bx = cx - p0x, by = cy - p0y;
    i64 ax = tx - cx - bx, ay = ty - cy - by;  // p0 + p2 - 2 p1
    i64 d = std::max(ax < 0 ? -ax : ax, ay < 0 ? -ay : ay);
    if (d <= kOnePixel / 4) {
      line_to(tx, ty);
      return;
    }
    int shift = 0;  // each halving of the step cuts the deviation by 4
    do {
      d >>= 2;
      shift++;
    } while (d > kOnePixel / 4);
    // Forward differences in 32.32 fixed point: P += Q; Q += R.
    i64 rx = ax * (i64(1) << (33 - 2 * shift));
    i64 ry = ay * (i64(1) << (33 - 2 * shift));
    i64 qx = bx * (i64(1) << (33 - shift)) + ax * (i64(1) << (32 - 2 * shift));
    i64 qy = by * (i64(1) << (33 - shift)) + ay * (i64(1) << (32 - 2 * shift));
    i64 px = p0x * (i64(1) << 32), py = p0y * (i64(1) << 32);
    for (unsigned count = 1u << shift; count > 0; count--) {
      px += qx;
      py += qy;
      qx += rx;
      qy += ry;
      line_to(px >> 32, py >> 32);
    }
  }
};

// Walk a TrueType outline (26.6 points already placed in the grid) the way
// an outline decomposer does: a contour that begins off the curve starts at
// its last point if that is on the curve, else at the midpoint of its first
// and last; two off-curve points in a row imply an on-curve midpoint.
void decompose(Raster& r, const int32_t* xy, const uint8_t* on, const int32_t* ends,
               int n_contours) {
  int first = 0;
  for (int c = 0; c < n_contours; c++) {
    int last = ends[c];
    if (last < first) continue;
    i64 sx = xy[2 * first], sy = xy[2 * first + 1];
    i64 lx = xy[2 * last], ly = xy[2 * last + 1];
    int i = first, limit = last;
    if (!on[first]) {
      if (on[last]) {
        sx = lx;
        sy = ly;
        limit--;
      } else {
        sx = (sx + lx) / 2;
        sy = (sy + ly) / 2;
      }
      i--;
    }
    r.move_to(upscale(sx), upscale(sy));
    bool closed = false;
    while (i < limit) {
      i++;
      i64 px = xy[2 * i], py = xy[2 * i + 1];
      if (on[i]) {
        r.line_to(upscale(px), upscale(py));
        continue;
      }
      i64 cx = px, cy = py;  // a run of off-curve points
      for (;;) {
        if (i < limit) {
          i++;
          i64 vx = xy[2 * i], vy = xy[2 * i + 1];
          if (on[i]) {
            r.conic_to(upscale(cx), upscale(cy), upscale(vx), upscale(vy));
            break;
          }
          i64 mx = (cx + vx) / 2, my = (cy + vy) / 2;
          r.conic_to(upscale(cx), upscale(cy), upscale(mx), upscale(my));
          cx = vx;
          cy = vy;
          continue;
        }
        r.conic_to(upscale(cx), upscale(cy), upscale(sx), upscale(sy));
        closed = true;
        break;
      }
      if (closed) break;
    }
    if (!closed) r.line_to(upscale(sx), upscale(sy));
    first = last + 1;
  }
}

inline int floor_div64(i64 v) { return int(v >= 0 ? v / 64 : -((-v + 63) / 64)); }

}  // namespace

extern "C" {

// Render one glyph and compose it onto `canvas` (height x width u8, rows
// top down). The outline is n_points 26.6 points `xy`, on-curve flags `on`
// and contour end indices `ends`; its origin sits at canvas column `org_x`
// on the baseline below canvas row `org_y - 1` (y grows up in the outline,
// down in the canvas): Pillow draws each glyph at its pen position rounded
// to whole pixels. Only pixels inside [clip_x0, clip_x1) x [clip_y0,
// clip_y1) of the canvas are written. Returns 0, or -1 for a malformed
// outline.
int rcv_text_glyph(const int32_t* xy, const uint8_t* on, int n_points, const int32_t* ends,
                   int n_contours, int org_x, int org_y, uint8_t* canvas, int width,
                   int height, int clip_x0, int clip_y0, int clip_x1, int clip_y1) {
  if (n_points <= 0 || n_contours <= 0) return 0;
  if (ends[n_contours - 1] >= n_points) return -1;
  i64 xmin = xy[0], xmax = xy[0], ymin = xy[1], ymax = xy[1];
  for (int i = 1; i < n_points; i++) {
    xmin = std::min<i64>(xmin, xy[2 * i]);
    xmax = std::max<i64>(xmax, xy[2 * i]);
    ymin = std::min<i64>(ymin, xy[2 * i + 1]);
    ymax = std::max<i64>(ymax, xy[2 * i + 1]);
  }
  // The pixel box of the control box; the grid's origin is its corner, so
  // every coordinate the walk sees is non-negative.
  int bx0 = floor_div64(xmin), by0 = floor_div64(ymin);
  int bx1 = -floor_div64(-xmax), by1 = -floor_div64(-ymax);
  Raster r;
  r.w = bx1 - bx0;
  r.h = by1 - by0;
  if (r.w <= 0 || r.h <= 0) return 0;
  r.cover.assign(size_t(r.w) * r.h, 0);
  r.area.assign(size_t(r.w) * r.h, 0);
  std::vector<int32_t> placed(size_t(2) * n_points);
  for (int i = 0; i < n_points; i++) {
    placed[2 * i] = int32_t(xy[2 * i] - i64(bx0) * 64);
    placed[2 * i + 1] = int32_t(xy[2 * i + 1] - i64(by0) * 64);
  }
  decompose(r, placed.data(), on, ends, n_contours);

  for (int ey = 0; ey < r.h; ey++) {
    int row = org_y - 1 - (by0 + ey);
    if (row < clip_y0 || row >= clip_y1 || row < 0 || row >= height) continue;
    uint8_t* dst = canvas + size_t(row) * width;
    i64 acc = 0;
    for (int ex = 0; ex < r.w; ex++) {
      size_t k = size_t(ey) * r.w + ex;
      acc += r.cover[k] * (kOnePixel * 2);
      i64 a = acc - r.area[k];
      int cov = int(a >> (kPixelBits * 2 + 1 - 8));
      if (cov < 0) cov = ~cov;
      if (cov > 255) cov = 255;
      if (cov == 0) continue;
      int col = org_x + bx0 + ex;
      if (col < clip_x0 || col >= clip_x1 || col < 0 || col >= width) continue;
      int t = int(dst[col]) * (255 - cov) + 128;
      dst[col] = uint8_t(cov + (((t >> 8) + t) >> 8));
    }
  }
  return 0;
}

}  // extern "C"
