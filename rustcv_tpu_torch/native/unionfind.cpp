// Min-root union-find over run adjacency pairs, and the two-pass
// connected-components labeling (4- and 8-connectivity) built on it — the
// host half of rustcv_tpu_torch/ops/ccl.py (a copy of
// rustcv_tpu/native/unionfind.cpp).
//
// Pointer-chasing with data-dependent depth suits one host core, not a
// device; components number 1..N in raster order of their first pixel
// (min-root union keeps the smallest id as the representative).

#include <cstdint>
#include <vector>

namespace {

// Find with full path compression. Roots are always the SMALLEST node id in
// the set (union() orients larger roots under smaller ones), so the final
// root of each component is its raster-first run — which yields the frozen
// "components numbered by first pixel in raster order" contract for free.
int32_t uf_find(int32_t* parent, int32_t x) {
  int32_t r = x;
  while (parent[r] != r) r = parent[r];
  while (parent[x] != r) {
    int32_t nxt = parent[x];
    parent[x] = r;
    x = nxt;
  }
  return r;
}

}  // namespace

extern "C" {

// n nodes (0..n-1), m undirected edges (ea[i], eb[i]). On return,
// parent[i] = min node id of i's component. Returns the component count.
long rcv_union_find(int32_t* parent, long n, const int32_t* ea,
                    const int32_t* eb, long m) {
  if (!parent || n < 0 || (m > 0 && (!ea || !eb))) return -1;
  for (long i = 0; i < n; ++i) parent[i] = (int32_t)i;
  for (long i = 0; i < m; ++i) {
    int32_t a = ea[i], b = eb[i];
    if (a < 0 || a >= n || b < 0 || b >= n) return -2;
    int32_t ra = uf_find(parent, a);
    int32_t rb = uf_find(parent, b);
    if (ra == rb) continue;
    // min-root union keeps the smallest id as the representative
    if (ra < rb)
      parent[rb] = ra;
    else
      parent[ra] = rb;
  }
  long count = 0;
  for (long i = 0; i < n; ++i) {
    parent[i] = uf_find(parent, (int32_t)i);
    if (parent[i] == i) ++count;
  }
  return count;
}

// Classic two-pass 4-connectivity connected-components labeling over a u8
// mask: provisional labels + union-find in one raster scan, then a resolve/
// compact pass. Components number 1..count by their raster-first pixel
// (min-root union — same contract as the Python run-graph path). Returns
// the component count; labels[i] = 0 for background. ~5-10 ms @1080p on one
// core — the pointer-chasing escape hatch the TPU formulation cannot match
// (ops/ccl.py module docs).
long rcv_ccl_label(const uint8_t* mask, long h, long w, int32_t* labels) {
  if (!mask || !labels || h <= 0 || w <= 0) return -1;
  std::vector<int32_t> parent;
  parent.reserve(1024);
  const long total = h * w;
  for (long y = 0; y < h; ++y) {
    const uint8_t* row = mask + y * w;
    int32_t* lrow = labels + y * w;
    const int32_t* urow = lrow - w;
    for (long x = 0; x < w; ++x) {
      if (!row[x]) {
        lrow[x] = -1;
        continue;
      }
      int32_t left = (x > 0) ? lrow[x - 1] : -1;
      int32_t up = (y > 0) ? urow[x] : -1;
      if (left < 0 && up < 0) {
        int32_t id = (int32_t)parent.size();
        parent.push_back(id);
        lrow[x] = id;
      } else if (left < 0) {
        lrow[x] = up;
      } else if (up < 0) {
        lrow[x] = left;
      } else {
        int32_t ra = uf_find(parent.data(), left);
        int32_t rb = uf_find(parent.data(), up);
        if (ra < rb)
          parent[rb] = ra;
        else if (rb < ra)
          parent[ra] = rb;
        lrow[x] = ra < rb ? ra : rb;
      }
    }
  }
  // Resolve + compact: provisional ids are raster-ordered by first pixel,
  // so ranking roots in id order numbers components in raster order.
  std::vector<int32_t> rank(parent.size(), 0);
  long count = 0;
  for (long i = 0; i < (long)parent.size(); ++i) {
    if (uf_find(parent.data(), (int32_t)i) == (int32_t)i)
      rank[i] = (int32_t)++count;
  }
  for (long i = 0; i < total; ++i) {
    labels[i] = labels[i] < 0 ? 0 : rank[uf_find(parent.data(), labels[i])];
  }
  return count;
}

// 8-connectivity variant (OpenCV findContours' foreground connectivity):
// same two-pass min-root scheme, with up-left / up / up-right / left
// neighbor unions. Components number 1..count by raster-first pixel.
long rcv_ccl_label8(const uint8_t* mask, long h, long w, int32_t* labels) {
  if (!mask || !labels || h <= 0 || w <= 0) return -1;
  std::vector<int32_t> parent;
  parent.reserve(1024);
  const long total = h * w;
  for (long y = 0; y < h; ++y) {
    const uint8_t* row = mask + y * w;
    int32_t* lrow = labels + y * w;
    const int32_t* urow = lrow - w;
    for (long x = 0; x < w; ++x) {
      if (!row[x]) {
        lrow[x] = -1;
        continue;
      }
      int32_t best = -1;
      int32_t nbr[4];
      int nn = 0;
      if (x > 0 && lrow[x - 1] >= 0) nbr[nn++] = lrow[x - 1];
      if (y > 0) {
        if (x > 0 && urow[x - 1] >= 0) nbr[nn++] = urow[x - 1];
        if (urow[x] >= 0) nbr[nn++] = urow[x];
        if (x + 1 < w && urow[x + 1] >= 0) nbr[nn++] = urow[x + 1];
      }
      if (nn == 0) {
        int32_t id = (int32_t)parent.size();
        parent.push_back(id);
        lrow[x] = id;
        continue;
      }
      best = uf_find(parent.data(), nbr[0]);
      for (int i = 1; i < nn; ++i) {
        int32_t r = uf_find(parent.data(), nbr[i]);
        if (r == best) continue;
        if (r < best) {
          parent[best] = r;
          best = r;
        } else {
          parent[r] = best;
        }
      }
      lrow[x] = best;
    }
  }
  std::vector<int32_t> rank(parent.size(), 0);
  long count = 0;
  for (long i = 0; i < (long)parent.size(); ++i) {
    if (uf_find(parent.data(), (int32_t)i) == (int32_t)i)
      rank[i] = (int32_t)++count;
  }
  for (long i = 0; i < total; ++i) {
    labels[i] = labels[i] < 0 ? 0 : rank[uf_find(parent.data(), labels[i])];
  }
  return count;
}

}  // extern "C"
