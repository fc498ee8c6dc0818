"""Connected components, contours, flood fill and distance transforms
(port of ``rustcv_tpu.ops.ccl``).

``connectedComponents`` is the textbook sequential vision op: union-find
over a raster scan, pointer-chasing with data-dependent depth. It runs on
the host, in the port's own C++ (``native/unionfind.cpp``, the two-pass
scan ``rcv_ccl_label`` with min-root union-find): a device mask costs one
u8 fetch. Components number 1..N by their raster-first pixel (min-root
union keeps the smallest run id as each component's representative).
There is no Python fallback: a native library that does not build raises
RuntimeError with the compiler's output.

The contours, the cv2 flood fill, the L2 and chamfer distance transforms
and the BFS oracles are the reference's host numpy code. The exact L1
distance runs on the mask's device: four directional min-plus scans, each
``cummin(d − i) + i`` (exact int32; the reverse directions by a flip).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .tensors import as_tensor


def _host_mask(mask) -> np.ndarray:
    """The mask as numpy: a device tensor costs one fetch (as u8 for a
    bool mask)."""
    if isinstance(mask, torch.Tensor):
        if mask.dtype == torch.bool:
            mask = mask.to(torch.uint8)
        return mask.cpu().numpy()
    return np.asarray(mask)


def connected_components(mask, max_rounds: int = 256, connectivity: int = 4):
    """u8/bool mask (H, W) → (count, labels int32 (H, W)); background 0,
    components 1..count ordered by their minimum flat index (the raster-
    first pixel — a deterministic, content-independent order).
    ``max_rounds`` is kept for API compatibility (nothing iterates).
    ``connectivity`` is 4 (default) or 8 (OpenCV findContours' foreground
    connectivity). Any nonzero byte is foreground; a u8 mask passes to
    the native scan without a copy."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    m = _host_mask(mask)
    if m.ndim != 2:
        raise ValueError(f"connected_components: 2-D mask required, got {m.shape}")
    mm = m if m.dtype == np.uint8 else (m != 0).astype(np.uint8)
    return native.ccl_label(mm, connectivity)


def connected_components_with_stats(mask, max_rounds: int = 256):
    """OpenCV ``connectedComponentsWithStats``: (count, labels, stats,
    centroids). ``stats`` int64 [count+1, 5] rows = (left, top, width,
    height, area) — row 0 is background; ``centroids`` float64
    [count+1, 2] (x, y). Native labeling + vectorized host reductions."""
    n, labels = connected_components(mask, max_rounds=max_rounds)
    h, w = labels.shape
    stats = np.zeros((n + 1, 5), np.int64)
    cents = np.full((n + 1, 2), np.nan)
    flat = labels.reshape(-1)
    area = np.bincount(flat, minlength=n + 1)
    ys, xs = np.divmod(np.arange(h * w), w)
    sx = np.bincount(flat, weights=xs, minlength=n + 1)
    sy = np.bincount(flat, weights=ys, minlength=n + 1)
    stats[:, 4] = area
    left = np.full(n + 1, w, np.int64)
    top = np.full(n + 1, h, np.int64)
    right = np.full(n + 1, -1, np.int64)
    bot = np.full(n + 1, -1, np.int64)
    np.minimum.at(left, flat, xs)
    np.minimum.at(top, flat, ys)
    np.maximum.at(right, flat, xs)
    np.maximum.at(bot, flat, ys)
    pop = area > 0
    stats[pop, 0] = left[pop]
    stats[pop, 1] = top[pop]
    stats[pop, 2] = right[pop] - left[pop] + 1
    stats[pop, 3] = bot[pop] - top[pop] + 1
    with np.errstate(invalid="ignore"):
        cents[pop, 0] = sx[pop] / area[pop]
        cents[pop, 1] = sy[pop] / area[pop]
    return n, labels, stats, cents


def flood_fill(
    img,
    seed: tuple,
    new_val: int,
    lo_diff: int = 0,
    up_diff: int = 0,
    max_rounds: int = 256,
):
    """OpenCV ``floodFill`` (fixed-range variant): fill the 4-connected
    region around ``seed`` = (x, y) whose values lie within
    [seed−lo_diff, seed+up_diff], with ``new_val``. Returns (filled image,
    pixel count, mask u8), numpy. Reuses the component labeler over the
    tolerance mask."""
    a = _host_mask(img)
    if a.ndim != 2:
        raise ValueError("flood_fill: gray (2-D) input required")
    x, y = int(seed[0]), int(seed[1])
    if not (0 <= x < a.shape[1] and 0 <= y < a.shape[0]):
        raise ValueError(f"flood_fill: seed {seed} outside image")
    sv = int(a[y, x])
    tol = (a.astype(np.int32) >= sv - lo_diff) & (a.astype(np.int32) <= sv + up_diff)
    _, labels = connected_components(tol.astype(np.uint8), max_rounds=max_rounds)
    region = labels == labels[y, x]
    out = a.copy()
    out[region] = new_val
    return out, int(region.sum()), (region * np.uint8(255))


def flood_fill_cv(
    img: np.ndarray,
    mask,
    seed: tuple,
    new_val,
    lo_diff=0,
    up_diff=0,
    flags: int = 4,
):
    """cv2 ``floodFill`` full semantics (floodfill.cpp behaviors):
    gray or color, floating range by default (each pixel accepted
    against the NEIGHBOR it was reached from) or FLOODFILL_FIXED_RANGE
    (vs the seed), 4/8 connectivity, optional (H+2, W+2) mask whose
    nonzero pixels block the fill and whose filled pixels get
    newMaskVal = (flags >> 8) or 1, FLOODFILL_MASK_ONLY. Returns
    (count, filled image, mask, rect). Frontier-iterated in NumPy —
    the accepted set is the closure of the per-edge relation, so
    iteration order cannot change the result."""
    a = np.asarray(img)
    h, w = a.shape[:2]
    nch = 1 if a.ndim == 2 else a.shape[2]
    x0, y0 = int(seed[0]), int(seed[1])
    if not (0 <= x0 < w and 0 <= y0 < h):
        raise ValueError(f"floodFill: seed {seed} outside image")
    conn = int(flags) & 255
    conn = 8 if conn == 8 else 4
    fixed = bool(int(flags) & (1 << 16))      # FLOODFILL_FIXED_RANGE
    mask_only = bool(int(flags) & (1 << 17))  # FLOODFILL_MASK_ONLY
    new_mask_val = (int(flags) >> 8) & 255 or 1

    f = a.reshape(h, w, nch).astype(np.float64)
    lo = np.broadcast_to(np.atleast_1d(np.asarray(lo_diff, np.float64)),
                         (nch,)) if np.ndim(lo_diff) <= 1 else lo_diff
    up = np.broadcast_to(np.atleast_1d(np.asarray(up_diff, np.float64)),
                         (nch,)) if np.ndim(up_diff) <= 1 else up_diff
    lo = np.resize(np.atleast_1d(lo).astype(np.float64), nch)
    up = np.resize(np.atleast_1d(up).astype(np.float64), nch)

    allowed = np.ones((h, w), bool)
    if mask is not None:
        mm = np.asarray(mask)
        allowed = mm[1:h + 1, 1:w + 1] == 0
        # cv2 sets the (H+2, W+2) mask's outer 1-px frame to 1 up front
        mm[0, :] = np.maximum(mm[0, :], 1)
        mm[-1, :] = np.maximum(mm[-1, :], 1)
        mm[:, 0] = np.maximum(mm[:, 0], 1)
        mm[:, -1] = np.maximum(mm[:, -1], 1)

    filled = np.zeros((h, w), bool)
    if allowed[y0, x0]:
        filled[y0, x0] = True
    if fixed or (lo.max() == 0 and up.max() == 0):
        sv = f[y0, x0]
        ok = np.all((f >= sv - lo) & (f <= sv + up), axis=-1) & allowed
        shifts = [(0, 1), (0, -1), (1, 0), (-1, 0)]
        if conn == 8:
            shifts += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
        frontier = filled.copy()
        while frontier.any():
            grow = np.zeros((h, w), bool)
            for dy, dx in shifts:
                sh = np.zeros((h, w), bool)
                ys = slice(max(dy, 0), h + min(dy, 0))
                yd = slice(max(-dy, 0), h + min(-dy, 0))
                xs = slice(max(dx, 0), w + min(dx, 0))
                xd = slice(max(-dx, 0), w + min(-dx, 0))
                sh[yd, xd] = frontier[ys, xs]
                grow |= sh
            frontier = grow & ok & ~filled
            filled |= frontier
    else:
        # floating range: accept p from filled neighbor q when
        # q - lo <= p <= q + up per channel
        shifts = [(0, 1), (0, -1), (1, 0), (-1, 0)]
        if conn == 8:
            shifts += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
        changed = True
        while changed:
            changed = False
            for dy, dx in shifts:
                ys = slice(max(dy, 0), h + min(dy, 0))
                yd = slice(max(-dy, 0), h + min(-dy, 0))
                xs = slice(max(dx, 0), w + min(dx, 0))
                xd = slice(max(-dx, 0), w + min(-dx, 0))
                q = f[ys, xs]
                p = f[yd, xd]
                adm = np.all((p >= q - lo) & (p <= q + up), axis=-1)
                new = filled[ys, xs] & adm & allowed[yd, xd] & \
                    ~filled[yd, xd]
                if new.any():
                    filled[yd, xd] |= new
                    changed = True

    count = int(filled.sum())
    ysn, xsn = np.nonzero(filled)
    rect = (0, 0, 0, 0) if count == 0 else (
        int(xsn.min()), int(ysn.min()),
        int(xsn.max() - xsn.min() + 1), int(ysn.max() - ysn.min() + 1))
    if mask is not None:
        np.asarray(mask)[1:h + 1, 1:w + 1][filled] = new_mask_val
    if not mask_only:
        nv = np.resize(np.atleast_1d(np.asarray(new_val)), nch)
        a.reshape(h, w, nch)[filled] = nv.astype(a.dtype)
    return count, a, mask, rect


_MOORE = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def find_contours(mask, max_rounds: int = 256):
    """External contours of each 4-connected component (OpenCV
    ``findContours`` RETR_EXTERNAL + CHAIN_APPROX_NONE role).

    The native labeling (:func:`connected_components`) partitions the
    mask; the host then Moore-traces each component's outer boundary clockwise
    from its raster-first pixel. Returns a list of int32 [K, 2] (x, y)
    arrays, one per component, in component order; single-pixel components
    yield a 1-point contour. Host work = one O(area log area) argsort to
    locate every component's start pixel + O(Σ perimeters) tracing."""
    n, labels = connected_components(mask, max_rounds=max_rounds)
    h, w = labels.shape
    contours = []
    # Component start pixels in ONE pass (per-component full-image scans
    # would make this O(n_components · H · W) on speckled masks): labels
    # are numbered in raster order of their first pixel, so the first
    # occurrence index of each label IS its trace start.
    flat = labels.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_labels = flat[order]
    first_idx = np.searchsorted(sorted_labels, np.arange(1, n + 1))
    starts = order[first_idx]
    for comp in range(1, n + 1):
        sy, sx = divmod(int(starts[comp - 1]), w)

        def fg(y, x):
            return 0 <= y < h and 0 <= x < w and labels[y, x] == comp

        # Moore-neighbor tracing; the walk is deterministic in the state
        # (cur, backtrack), so the FIRST repeated state closes the cycle
        # exactly once (plain return-to-start double-traces shapes whose
        # boundary passes the start twice; the initial state itself may
        # sit just off the cycle for 1-px-thin shapes).
        cur, prev = (sy, sx), (sy, sx - 1)
        seen = set()
        contour = []
        while (cur, prev) not in seen:
            seen.add((cur, prev))
            contour.append((cur[1], cur[0]))
            pi = _MOORE.index((prev[0] - cur[0], prev[1] - cur[1]))
            nxt = None
            for k in range(1, 9):
                dy, dx = _MOORE[(pi + k) % 8]
                cand = (cur[0] + dy, cur[1] + dx)
                if fg(*cand):
                    nxt = cand
                    # the neighbor just BEFORE the hit becomes the backtrack
                    pdy, pdx = _MOORE[(pi + k - 1) % 8]
                    prev = (cur[0] + pdy, cur[1] + pdx)
                    break
            if nxt is None:
                break  # isolated pixel
            cur = nxt
        if len(contour) > 1 and contour[-1] == contour[0]:
            contour.pop()  # off-cycle initial state duplicated the start
        contours.append(np.asarray(contour, np.int32))
    return contours


def _trace_ccw(labels: np.ndarray, comp: int, start, backtrack):
    """OpenCV-direction Moore trace: counterclockwise neighbor scan from
    the backtrack direction (cv2's outer contours walk down the left edge
    first — verified against cv2 5.0). Terminates on the first repeated
    (cur, backtrack) state, like :func:`find_contours`'s tracer."""
    h, w = labels.shape

    def fg(y, x):
        return 0 <= y < h and 0 <= x < w and labels[y, x] == comp

    cur, prev = start, backtrack
    seen = set()
    contour = []
    while (cur, prev) not in seen:
        seen.add((cur, prev))
        contour.append((cur[1], cur[0]))
        pi = _MOORE.index((prev[0] - cur[0], prev[1] - cur[1]))
        nxt = None
        for k in range(1, 9):
            dy, dx = _MOORE[(pi - k) % 8]
            cand = (cur[0] + dy, cur[1] + dx)
            if fg(*cand):
                nxt = cand
                pdy, pdx = _MOORE[(pi - k + 1) % 8]
                prev = (cur[0] + pdy, cur[1] + pdx)
                break
        if nxt is None:
            break  # isolated pixel
        cur = nxt
    if len(contour) > 1 and contour[-1] == contour[0]:
        contour.pop()
    return np.asarray(contour, np.int32)


def _first_pixels(labels: np.ndarray, n: int) -> np.ndarray:
    """Flat index of each component's raster-first pixel (1..n) in one
    argsort pass (labels are numbered in raster order of first pixels)."""
    flat = labels.reshape(-1)
    order = np.argsort(flat, kind="stable")
    first_idx = np.searchsorted(flat[order], np.arange(1, n + 1))
    return order[first_idx]


def find_contours_tree(mask):
    """Full contour topology (OpenCV ``findContours`` RETR_TREE role,
    CHAIN_APPROX_NONE): → ``(contours, hierarchy, kinds)``.

    Frozen spec (cross-checked against cv2 5.0 in
    tests/test_contour_tree.py):

    - foreground components are 8-connected, background regions
      4-connected (the standard Suzuki–Abe duality);
    - each fg component contributes its OUTER boundary (traced
      counterclockwise-in-image-coords from its raster-first pixel, cv2's
      direction) and one HOLE boundary per enclosed background region
      (traced from the fg pixel left of the hole's raster-first pixel);
    - ``hierarchy`` is int32 [N, 4] rows (next, prev, first_child,
      parent): hole contours are children of their component's outer
      contour; an outer contour nested inside another component's hole is
      that hole contour's child; top level = enclosed by the outer
      background. Siblings chain in contour order;
    - contours are ordered by trace-start raster position (cv2's TREE
      order on our test scenes; its LIST-mode ordering differs — callers
      needing cv2's exact enumeration order should sort themselves);
    - ``kinds[i]`` is "outer" or "hole".
    """
    m = _host_mask(mask)
    if m.ndim == 3:
        m = m[..., 0]
    fgm = m != 0
    h, w = fgm.shape
    nf, lf = connected_components(fgm.astype(np.uint8), connectivity=8)
    if nf == 0:
        return [], np.zeros((0, 4), np.int32), []
    bgp = np.pad(~fgm, 1, constant_values=True)
    nb, lbp = connected_components(bgp.astype(np.uint8), connectivity=4)
    outer_bg = int(lbp[0, 0])

    fg_first = _first_pixels(lf, nf)
    bg_first = _first_pixels(lbp, nb)

    entries = []  # (start_flat, kind, comp_or_bg, trace)
    outer_idx_of_comp = {}
    for c in range(1, nf + 1):
        cy, cx = divmod(int(fg_first[c - 1]), w)
        tr = _trace_ccw(lf, c, (cy, cx), (cy, cx - 1))
        enclosing_bg = int(lbp[cy, cx + 1])  # padded coords: pixel above
        entries.append({"start": cy * w + cx, "kind": "outer", "comp": c,
                        "trace": tr, "enclosing_bg": enclosing_bg})
    hole_idx_of_bg = {}
    for b in range(2, nb + 1):
        if b == outer_bg:
            continue
        py, px = divmod(int(bg_first[b - 1]), lbp.shape[1])
        hy, hx = py - 1, px - 1  # unpadded
        owner = int(lf[hy, hx - 1])
        tr = _trace_ccw(lf, owner, (hy, hx - 1), (hy, hx))
        entries.append({"start": hy * w + (hx - 1), "kind": "hole",
                        "comp": owner, "trace": tr, "bg": b})
    entries.sort(key=lambda e: e["start"])
    for i, e in enumerate(entries):
        if e["kind"] == "outer":
            outer_idx_of_comp[e["comp"]] = i
        else:
            hole_idx_of_bg[e["bg"]] = i

    n = len(entries)
    parent = np.full(n, -1, np.int32)
    for i, e in enumerate(entries):
        if e["kind"] == "hole":
            parent[i] = outer_idx_of_comp[e["comp"]]
        elif e["enclosing_bg"] != outer_bg:
            parent[i] = hole_idx_of_bg[e["enclosing_bg"]]
    hierarchy = hierarchy_from_parents(parent)
    return [e["trace"] for e in entries], hierarchy, \
        [e["kind"] for e in entries]


def hierarchy_from_parents(parent: np.ndarray) -> np.ndarray:
    """parent[] (−1 = top level) → OpenCV hierarchy rows (next, prev,
    first_child, parent), siblings chained in index order."""
    n = len(parent)
    hier = np.full((n, 4), -1, np.int32)
    hier[:, 3] = parent
    last_sib = {}
    for i in range(n):
        p = int(parent[i])
        if p in last_sib:
            j = last_sib[p]
            hier[j, 0] = i
            hier[i, 1] = j
        elif p >= 0:
            hier[p, 2] = i
        last_sib[p] = i
    return hier


def connected_components_numpy(mask: np.ndarray):
    from collections import deque

    h, w = mask.shape
    fg = mask != 0
    labels = np.zeros((h, w), np.int32)
    count = 0
    for y in range(h):
        for x in range(w):
            if fg[y, x] and labels[y, x] == 0:
                count += 1
                q = deque([(y, x)])
                labels[y, x] = count
                while q:
                    cy, cx = q.popleft()
                    for ny, nx in ((cy - 1, cx), (cy + 1, cx), (cy, cx - 1), (cy, cx + 1)):
                        if 0 <= ny < h and 0 <= nx < w and fg[ny, nx] and labels[ny, nx] == 0:
                            labels[ny, nx] = count
                            q.append((ny, nx))
    return count, labels


def _minplus_scan(d: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """out[i] = min_{j<=i} (d[j] + (i − j)) along ``dim`` (j >= i when
    ``reverse``): ``cummin(d − i) + i``, exact in int32."""
    n = d.shape[dim]
    shape = [1] * d.ndim
    shape[dim] = n
    i = torch.arange(n, dtype=d.dtype, device=d.device).view(shape)
    if reverse:
        return torch.flip(torch.cummin(torch.flip(d + i, [dim]), dim)[0], [dim]) - i
    return torch.cummin(d - i, dim)[0] + i


def distance_l1(mask: torch.Tensor) -> torch.Tensor:
    """:func:`distance_transform_l1` on the mask's device, a tensor out.
    Sources (distance 0) are the ZERO pixels of ``mask``."""
    big = 1 << 20
    d = torch.where(mask == 0, 0, big).to(torch.int32)
    d = torch.minimum(_minplus_scan(d, -1, False), _minplus_scan(d, -1, True))
    return torch.minimum(_minplus_scan(d, -2, False), _minplus_scan(d, -2, True))


def distance_transform_l1(mask) -> np.ndarray:
    """Exact L1 (city-block) distance to the nearest ZERO pixel of a u8
    mask (OpenCV ``distanceTransform`` with DIST_L1): int32 (H, W) numpy;
    all-nonzero masks saturate at 2^20. Runs on the mask's device (numpy
    goes to the card): per-row 1-D L1 distance by the left/right min-plus
    scans, then the up/down scans of that — exact because the kernel is
    1-Lipschitz. No iteration to a fixed point."""
    return distance_l1(as_tensor(mask)).cpu().numpy()


def distance_transform_l1_numpy(mask: np.ndarray) -> np.ndarray:
    """BFS oracle (exact L1 distance to the nearest zero pixel)."""
    from collections import deque

    m = np.asarray(mask)
    h, w = m.shape
    big = 1 << 20
    dist = np.full((h, w), big, np.int32)
    q = deque()
    for y in range(h):
        for x in range(w):
            if m[y, x] == 0:
                dist[y, x] = 0
                q.append((y, x))
    while q:
        y, x = q.popleft()
        for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
            if 0 <= ny < h and 0 <= nx < w and dist[ny, nx] > dist[y, x] + 1:
                dist[ny, nx] = dist[y, x] + 1
                q.append((ny, nx))
    return dist


def distance_transform_l2_with_labels(mask):
    """Exact Euclidean distance transform + nearest-zero labels (OpenCV
    ``distanceTransformWithLabels`` with DIST_LABEL_CCOMP role):
    → (dist float32 (H, W), labels int32 (H, W)) where labels partition
    the image by the connected component of zero pixels that is nearest
    (exact L2 — OpenCV's 3×3 chamfer is an approximation of this spec).

    Host implementation: exact per-column nearest zero rows, then per row
    the lower envelope of the column distances (first arg-min on ties),
    which also gives each pixel's nearest zero for labeling; the labels
    are the native 4-connected labeling of the zero set (the numbering of
    the reference's BFS oracle)."""
    m = _host_mask(mask)
    h, w = m.shape
    if h * w == 0:
        return np.zeros((h, w), np.float32), np.zeros((h, w), np.int32)
    big = 1e18

    # per-column 1-D distance to nearest zero in that column + its row
    d0 = np.where(m == 0, 0.0, big)
    near_row = np.full((h, w), -1, np.int64)
    dcol = np.full((h, w), big)
    for x in range(w):
        rows = np.nonzero(m[:, x] == 0)[0]
        if len(rows) == 0:
            continue
        ys = np.arange(h)
        dd = (ys[:, None] - rows[None, :]).astype(np.float64) ** 2
        k = np.argmin(dd, axis=1)
        dcol[:, x] = dd[ys, k]
        near_row[:, x] = rows[k]

    # horizontal pass: lower envelope of parabolas dcol[y, x'] + (x-x')²
    dist2 = np.full((h, w), big)
    near = np.full((h, w, 2), -1, np.int64)
    xs = np.arange(w, dtype=np.float64)
    for y in range(h):
        f = dcol[y]
        valid = f < big
        if not valid.any():
            continue
        cand = np.nonzero(valid)[0]
        dd = f[cand][None, :] + (xs[:, None] - cand[None, :]) ** 2
        k = np.argmin(dd, axis=1)
        dist2[y] = dd[np.arange(w), k]
        src_x = cand[k]
        near[y, :, 0] = near_row[y, src_x]
        near[y, :, 1] = src_x

    # labels: connected components (8-conn) of the zero set, looked up
    # at each pixel's nearest zero
    zero_mask = (m == 0).astype(np.uint8)
    _, comp = connected_components(zero_mask)
    labels = np.zeros((h, w), np.int32)
    ok = near[..., 0] >= 0
    labels[ok] = comp[near[ok][:, 0], near[ok][:, 1]]
    return np.sqrt(np.where(dist2 >= big, 0.0, dist2)).astype(
        np.float32), labels


def distance_transform_chamfer(src: np.ndarray, metrics, mask_size: int
                               ) -> np.ndarray:
    """OpenCV's masked ``distanceTransform`` (maskSize 3/5): two-pass
    Borgefors chamfer in DIST_SHIFT=16 fixed point, bit-faithful to cv2's
    integer path including the final float32 scale multiply. ``metrics``
    are cv2's (a, b[, c]) step costs as float32 (e.g. DIST_L2 mask 3 →
    (0.955, 1.3693): cv2's masked L2 is this approximation, NOT exact
    Euclidean). Each row sweep is a vectorized min-plus scan (the +a
    left/right propagation is min.accumulate of cand - a·j)."""
    m = _host_mask(src)
    h, w = m.shape
    ia = int(np.rint(np.float64(np.float32(metrics[0])) * 65536))
    ib = int(np.rint(np.float64(np.float32(metrics[1])) * 65536))
    ic = int(np.rint(np.float64(np.float32(metrics[2])) * 65536)) \
        if len(metrics) > 2 else 0
    inf = np.int64(1) << 50
    dist = np.where(m != 0, inf, 0).astype(np.int64)
    if w == 0 or h == 0:
        return dist.astype(np.float32)

    def shifted(row, k):
        out = np.full_like(row, inf)
        if k > 0:
            out[:-k] = row[k:]
        elif k < 0:
            out[-k:] = row[:k]
        else:
            out[:] = row
        return out

    ar = ia * np.arange(w, dtype=np.int64)
    five = mask_size == 5
    for i in range(h):
        cand = dist[i].copy()
        if i >= 1:
            up = dist[i - 1]
            cand = np.minimum(cand, up + ia)
            cand = np.minimum(cand, shifted(up, -1) + ib)
            cand = np.minimum(cand, shifted(up, 1) + ib)
            if five:
                cand = np.minimum(cand, shifted(up, -2) + ic)
                cand = np.minimum(cand, shifted(up, 2) + ic)
        if five and i >= 2:
            up2 = dist[i - 2]
            cand = np.minimum(cand, shifted(up2, -1) + ic)
            cand = np.minimum(cand, shifted(up2, 1) + ic)
        dist[i] = np.minimum.accumulate(cand - ar) + ar
    for i in range(h - 1, -1, -1):
        cand = dist[i]
        if i + 1 < h:
            dn = dist[i + 1]
            cand = np.minimum(cand, dn + ia)
            cand = np.minimum(cand, shifted(dn, -1) + ib)
            cand = np.minimum(cand, shifted(dn, 1) + ib)
            if five:
                cand = np.minimum(cand, shifted(dn, -2) + ic)
                cand = np.minimum(cand, shifted(dn, 2) + ic)
        if five and i + 2 < h:
            dn2 = dist[i + 2]
            cand = np.minimum(cand, shifted(dn2, -1) + ic)
            cand = np.minimum(cand, shifted(dn2, 1) + ic)
        rev = cand[::-1]
        dist[i] = (np.minimum.accumulate(rev - ar) + ar)[::-1]
    return (dist.astype(np.float64) * (1.0 / 65536)).astype(np.float32)
