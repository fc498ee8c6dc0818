"""Contour/shape geometry utilities (OpenCV ``convexHull`` /
``contourArea`` / ``arcLength`` / ``boundingRect`` / ``minAreaRect`` /
``approxPolyDP`` / ``minEnclosingCircle`` roles).

Host NumPy by design: these operate on O(perimeter) point lists produced
by find_contours — a few hundred points, far below any device-dispatch
break-even (the reference keeps its analog post-processing host-side
too). Every function is a frozen deterministic spec with brute-force
property tests.

Points are float64/int arrays [N, 2] in (x, y) order, matching
find_contours output.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def contour_area(pts: np.ndarray, oriented: bool = False) -> float:
    """Shoelace polygon area (OpenCV ``contourArea``): positive for
    counter-clockwise (in y-down image coords), absolute unless
    ``oriented``."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    a = 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return float(a if oriented else abs(a))


def arc_length(pts: np.ndarray, closed: bool = True) -> float:
    """Perimeter of the polyline (OpenCV ``arcLength``)."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if len(p) < 2:
        return 0.0
    d = np.diff(p, axis=0, append=p[:1]) if closed else np.diff(p, axis=0)
    return float(np.sqrt((d * d).sum(axis=1)).sum())


def bounding_rect(pts: np.ndarray) -> Tuple[int, int, int, int]:
    """Upright integer bounding box (x, y, w, h) — OpenCV
    ``boundingRect`` convention: w/h include both extreme pixels."""
    p = np.asarray(pts)
    if p.size == 0:
        return (0, 0, 0, 0)
    p = p.reshape(-1, 2)
    x0 = int(np.floor(p[:, 0].min()))
    y0 = int(np.floor(p[:, 1].min()))
    x1 = int(np.ceil(p[:, 0].max()))
    y1 = int(np.ceil(p[:, 1].max()))
    return (x0, y0, x1 - x0 + 1, y1 - y0 + 1)


def convex_hull(pts: np.ndarray, clockwise: bool = False) -> np.ndarray:
    """Convex hull (Andrew monotone chain), [H, 2] float64. Default
    counter-clockwise in y-down image coordinates (OpenCV's default
    returns clockwise=False ordering); collinear points dropped."""
    p = np.unique(np.asarray(pts, np.float64).reshape(-1, 2), axis=0)
    if len(p) <= 2:
        return p
    p = p[np.lexsort((p[:, 1], p[:, 0]))]

    def half(points):
        out = []
        for q in points:
            while len(out) >= 2:
                o, a = out[-2], out[-1]
                if (a[0] - o[0]) * (q[1] - o[1]) - (a[1] - o[1]) * (q[0] - o[0]) <= 0:
                    out.pop()
                else:
                    break
            out.append(q)
        return out

    lower = half(p)
    upper = half(p[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1])
    return hull[::-1] if clockwise else hull


def _cv_hull_rotate(hullbuf: list) -> list:
    """OpenCV convexHull's index-cosmetic post-pass: rotate the hull so
    the original point indices form an ascending/descending run when the
    cycle permits — including its early-breaking min/max scan (behavior
    pinned by a 30k-case differential sweep vs cv2 5.0)."""
    nout = len(hullbuf)
    if nout < 3:
        return hullbuf
    min_idx = max_idx = 0
    lt = 0
    for i in range(1, nout):
        idx = hullbuf[i]
        if idx < hullbuf[min_idx]:
            min_idx = i
        if idx > hullbuf[max_idx]:
            max_idx = i
        lt += hullbuf[i - 1] < idx
        if lt > 1 and lt <= i - 1:
            break
    if (min_idx == 0 and max_idx == nout - 1) or \
       (min_idx == nout - 1 and max_idx == 0):
        return hullbuf
    if abs(max_idx - min_idx) == 1:
        ascending = min_idx == max_idx + 1
        i0 = min_idx if ascending else max_idx
        if i0 > 0:
            out = []
            j = i0
            for i in range(nout):
                out.append(hullbuf[j])
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and \
                        (ascending != (hullbuf[j] < hullbuf[nj])):
                    return hullbuf
                j = nj
            return out
    return hullbuf


def convex_hull_cv_indices(pts: np.ndarray,
                           clockwise: bool = False) -> np.ndarray:
    """Indices (into ``pts``) of the convex hull in OpenCV's exact output
    order: Sklansky emission (ccw: max-point, large-y chain reversed,
    min-point, small-y chain; cw mirrored) plus the index-rotation
    cosmetic pass (:func:`_cv_hull_rotate`). Differential-tested
    order-exact vs cv2 5.0 on duplicate-free inputs (29,672 cases, zero
    mismatches); with duplicated input points the hull SET still matches
    but cv2's retained duplicate (hence the start vertex) can differ.
    Orientation flags are in cv2's y-UP convention."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if len(p) == 0:
        return np.zeros((0,), np.int64)
    order = np.lexsort((p[:, 1], p[:, 0]))
    keep: list = []
    for k in order:
        if not keep or not np.array_equal(p[k], p[keep[-1]]):
            keep.append(int(k))
    sp = p[keep]
    n = len(sp)

    def chain(sign: int) -> list:
        out: list = []
        for k in range(n):
            q = sp[k]
            while len(out) >= 2:
                o, a = sp[out[-2]], sp[out[-1]]
                cr = (a[0] - o[0]) * (q[1] - o[1]) \
                    - (a[1] - o[1]) * (q[0] - o[0])
                if sign * cr <= 0:
                    out.pop()
                else:
                    break
            out.append(k)
        return out

    lo = chain(-1)  # large-y side, pmin -> pmax
    up = chain(+1)  # small-y side, pmin -> pmax
    if n == 1:
        raw = [0]
    elif clockwise:
        raw = [lo[0]] + lo[1:-1] + [lo[-1]] + up[-2:0:-1]
    else:
        raw = [lo[-1]] + lo[-2:0:-1] + [lo[0]] + up[1:-1]
    return np.asarray(_cv_hull_rotate([keep[k] for k in raw]), np.int64)


def convex_hull_cv(pts: np.ndarray, clockwise: bool = False) -> np.ndarray:
    """Convex hull points in OpenCV's exact output order (same dtype as
    the input) — see :func:`convex_hull_cv_indices`."""
    p = np.asarray(pts)
    return p.reshape(-1, 2)[convex_hull_cv_indices(p, clockwise)]


def min_area_rect(pts: np.ndarray):
    """Minimum-area rotated rectangle via rotating calipers over hull
    edges (OpenCV ``minAreaRect`` role): ((cx, cy), (w, h), angle_deg)
    with angle in [0, 90) measured from +x to the 'w' edge."""
    hull = convex_hull(pts)
    if len(hull) == 0:
        return ((0.0, 0.0), (0.0, 0.0), 0.0)
    if len(hull) == 1:
        return ((float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0)
    best = None
    n = len(hull)
    for i in range(n):
        e = hull[(i + 1) % n] - hull[i]
        ln = np.hypot(*e)
        if ln < 1e-12:
            continue
        ux, uy = e / ln  # edge direction
        r = hull @ np.array([[ux, -uy], [uy, ux]])  # rotate by -theta
        w = r[:, 0].max() - r[:, 0].min()
        h = r[:, 1].max() - r[:, 1].min()
        area = w * h
        if best is None or area < best[0] - 1e-12:
            cx = (r[:, 0].max() + r[:, 0].min()) / 2
            cy = (r[:, 1].max() + r[:, 1].min()) / 2
            c = np.array([cx, cy]) @ np.array([[ux, uy], [-uy, ux]])
            best = (area, (float(c[0]), float(c[1])), (float(w), float(h)),
                    float(np.degrees(np.arctan2(uy, ux))))
    if best is None:  # all points coincident-ish
        c = hull.mean(axis=0)
        return ((float(c[0]), float(c[1])), (0.0, 0.0), 0.0)
    _, center, (w, h), ang = best
    ang = ang % 180.0
    if ang >= 90.0:
        ang -= 90.0
        w, h = h, w
    return (center, (w, h), ang)


def approx_poly_dp(pts: np.ndarray, epsilon: float, closed: bool = True) -> np.ndarray:
    """Douglas–Peucker simplification (OpenCV ``approxPolyDP``): keeps
    vertices whose deviation exceeds ``epsilon``."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return p.copy()

    def dp(lo: int, hi: int, keep):
        a, b = p[lo], p[hi]
        ab = b - a
        ln2 = float(ab @ ab)
        if hi - lo < 2:
            return
        seg = p[lo + 1 : hi]
        if ln2 < 1e-24:
            d = np.sqrt(((seg - a) ** 2).sum(axis=1))
        else:
            d = np.abs(ab[0] * (seg[:, 1] - a[1])
                       - ab[1] * (seg[:, 0] - a[0])) / np.sqrt(ln2)
        k = int(np.argmax(d))
        if d[k] > epsilon:
            mid = lo + 1 + k
            keep[mid] = True
            dp(lo, mid, keep)
            dp(mid, hi, keep)

    if closed:
        # split at the two farthest-apart extremes to seed the recursion
        far = int(np.argmax(((p - p[0]) ** 2).sum(axis=1)))
        if far == 0:
            return p[:1].copy()
        keep = np.zeros(len(p), bool)
        keep[0] = keep[far] = True
        dp(0, far, keep)
        # wrap-around half: rotate so [far..0] is contiguous
        q = np.concatenate([p[far:], p[: 1]])
        keep2 = np.zeros(len(q), bool)
        keep2[0] = keep2[-1] = True

        def dp2(lo, hi):
            a, b = q[lo], q[hi]
            ab = b - a
            ln2 = float(ab @ ab)
            if hi - lo < 2:
                return
            seg = q[lo + 1 : hi]
            if ln2 < 1e-24:
                d = np.sqrt(((seg - a) ** 2).sum(axis=1))
            else:
                d = np.abs(ab[0] * (seg[:, 1] - a[1])
                       - ab[1] * (seg[:, 0] - a[0])) / np.sqrt(ln2)
            k = int(np.argmax(d))
            if d[k] > epsilon:
                mid = lo + 1 + k
                keep2[mid] = True
                dp2(lo, mid)
                dp2(mid, hi)

        dp2(0, len(q) - 1)
        sel = keep.copy()
        sel[far:] |= keep2[: len(p) - far]
        sel[0] |= keep2[-1]
        return p[sel]
    keep = np.zeros(len(p), bool)
    keep[0] = keep[-1] = True
    dp(0, len(p) - 1, keep)
    return p[keep]


def min_enclosing_circle(pts: np.ndarray) -> Tuple[Tuple[float, float], float]:
    """Smallest enclosing circle (Welzl, randomized with a frozen seed →
    deterministic): ((cx, cy), radius)."""
    p = np.unique(np.asarray(pts, np.float64).reshape(-1, 2), axis=0)
    if len(p) == 0:
        return ((0.0, 0.0), 0.0)
    if len(p) == 1:
        return ((float(p[0, 0]), float(p[0, 1])), 0.0)
    rng = np.random.default_rng(7)
    order = rng.permutation(len(p))
    sp = p[order]

    def circ2(a, b):
        c = (a + b) / 2
        return c, float(np.hypot(*(a - c)))

    def circ3(a, b, c):
        # circumcircle; degenerate (collinear) → largest 2-point circle
        d = 2 * (a[0] * (b[1] - c[1]) + b[0] * (c[1] - a[1]) + c[0] * (a[1] - b[1]))
        if abs(d) < 1e-12:
            cands = [circ2(a, b), circ2(a, c), circ2(b, c)]
            best = None
            for ctr, r in cands:
                if all(np.hypot(*(q - ctr)) <= r + 1e-9 for q in (a, b, c)):
                    if best is None or r < best[1]:
                        best = (ctr, r)
            return best if best is not None else cands[0]
        ux = ((a @ a) * (b[1] - c[1]) + (b @ b) * (c[1] - a[1])
              + (c @ c) * (a[1] - b[1])) / d
        uy = ((a @ a) * (c[0] - b[0]) + (b @ b) * (a[0] - c[0])
              + (c @ c) * (b[0] - a[0])) / d
        ctr = np.array([ux, uy])
        return ctr, float(np.hypot(*(a - ctr)))

    def inside(ctr, r, q):
        return np.hypot(*(q - ctr)) <= r + 1e-9

    ctr, r = circ2(sp[0], sp[1])
    for i in range(2, len(sp)):
        if inside(ctr, r, sp[i]):
            continue
        ctr, r = circ2(sp[0], sp[i])
        for j in range(1, i):
            if inside(ctr, r, sp[j]):
                continue
            ctr, r = circ2(sp[j], sp[i])
            for k in range(j):
                if inside(ctr, r, sp[k]):
                    continue
                ctr, r = circ3(sp[k], sp[j], sp[i])
    return ((float(ctr[0]), float(ctr[1])), float(r))


def fit_line(pts: np.ndarray, dist_type: str = "l2",
             iters: int = 20) -> Tuple[float, float, float, float]:
    """Line fit (OpenCV ``fitLine`` role): (vx, vy, x0, y0) — unit
    direction + a point on the line. ``dist_type``: ``l2`` (exact
    total least squares) or the robust M-estimators ``l1`` / ``l12`` /
    ``fair`` / ``welsch`` / ``huber`` solved by IRLS over the weighted
    TLS fit (OpenCV's scheme). Direction sign: vx >= 0 (vy >= 0 when
    vx == 0)."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if len(p) < 2:
        raise ValueError("fit_line needs at least 2 points")

    def wfit(wgt):
        wsum = wgt.sum()
        c = (p * wgt[:, None]).sum(0) / wsum
        q = (p - c) * np.sqrt(wgt)[:, None]
        cov = q.T @ q
        evals, evecs = np.linalg.eigh(cov)
        v = evecs[:, int(np.argmax(evals))]
        if v[0] < 0 or (v[0] == 0 and v[1] < 0):
            v = -v
        return v, c

    wgt = np.ones(len(p))
    v, c = wfit(wgt)
    if dist_type == "l2":
        return (float(v[0]), float(v[1]), float(c[0]), float(c[1]))
    for _ in range(iters):
        d = np.abs((p[:, 0] - c[0]) * (-v[1]) + (p[:, 1] - c[1]) * v[0])
        scale = max(np.median(d) * 1.4826, 1e-9)
        r = d / scale
        if dist_type == "l1":
            wgt = 1.0 / np.maximum(r, 1e-6)
        elif dist_type == "l12":
            wgt = 1.0 / np.sqrt(np.maximum(1.0 + r * r / 2.0, 1e-12))
        elif dist_type == "fair":
            cc = 1.3998
            wgt = 1.0 / (1.0 + r / cc)
        elif dist_type == "welsch":
            cc = 2.9846
            wgt = np.exp(-(r / cc) ** 2)
        elif dist_type == "huber":
            cc = 1.345
            wgt = np.where(r < cc, 1.0, cc / np.maximum(r, 1e-9))
        else:
            raise ValueError(f"unknown dist_type {dist_type!r}")
        v_new, c_new = wfit(wgt)
        if np.abs(v_new - v).max() < 1e-12:
            v, c = v_new, c_new
            break
        v, c = v_new, c_new
    return (float(v[0]), float(v[1]), float(c[0]), float(c[1]))


def fit_ellipse(pts: np.ndarray):
    """Direct least-squares ellipse fit (the numerically stable
    Halir-Flusser partitioning of Fitzgibbon's method; OpenCV
    ``fitEllipse`` role): ((cx, cy), (major, minor) FULL axes,
    angle_deg of the major axis from +x, in [0, 180))."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if len(p) < 5:
        raise ValueError("fit_ellipse needs at least 5 points")
    mx, my = p[:, 0].mean(), p[:, 1].mean()
    x, y = p[:, 0] - mx, p[:, 1] - my
    D1 = np.stack([x * x, x * y, y * y], axis=1)
    D2 = np.stack([x, y, np.ones_like(x)], axis=1)
    S1 = D1.T @ D1
    S2 = D1.T @ D2
    S3 = D2.T @ D2
    try:
        T = -np.linalg.solve(S3, S2.T)
    except np.linalg.LinAlgError as e:
        raise ValueError("degenerate point set for ellipse fit") from e
    M = S1 + S2 @ T
    M2 = np.array([M[2] / 2.0, -M[1], M[0] / 2.0])
    evals, evecs = np.linalg.eig(M2)
    cond = 4.0 * evecs[0].real * evecs[2].real - evecs[1].real ** 2
    idx = np.where(cond > 1e-12)[0]
    if len(idx) == 0:
        raise ValueError("no ellipse solution (degenerate/collinear points)")
    a1 = evecs[:, idx[0]].real
    A, B, Cc, Dd, E, F = np.concatenate([a1, T @ a1])
    den = B * B - 4.0 * A * Cc
    if den >= 0:
        raise ValueError("fit is not an ellipse")
    cx = (2.0 * Cc * Dd - B * E) / den
    cy = (2.0 * A * E - B * Dd) / den
    dif = np.hypot(A - Cc, B)
    q = 2.0 * (A * E * E + Cc * Dd * Dd - B * Dd * E + den * F)
    ax1 = -np.sqrt(max(q * ((A + Cc) + dif), 0.0)) / den
    ax2 = -np.sqrt(max(q * ((A + Cc) - dif), 0.0)) / den
    major, minor = max(ax1, ax2), min(ax1, ax2)
    if abs(B) > 1e-12 * max(abs(A), abs(Cc), 1e-30):
        ang = (np.degrees(np.arctan2(Cc - A - dif, B)) + 90.0) % 180.0
    else:
        ang = 0.0 if A <= Cc else 90.0
    return ((float(cx + mx), float(cy + my)),
            (float(2 * major), float(2 * minor)), float(ang))


def convex_hull_indices(pts: np.ndarray, clockwise: bool = False) -> np.ndarray:
    """Indices into ``pts`` of the convex-hull vertices, in the same
    order :func:`convex_hull` returns them (OpenCV ``convexHull`` with
    ``returnPoints=False`` role). Duplicate input points map to their
    first occurrence."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    hull = convex_hull(p, clockwise=clockwise)
    idx = []
    for q in hull:
        matches = np.nonzero((p[:, 0] == q[0]) & (p[:, 1] == q[1]))[0]
        idx.append(int(matches[0]))
    return np.asarray(idx, np.int64)


def point_polygon_test(contour: np.ndarray, pt, measure_dist: bool = False):
    """OpenCV ``pointPolygonTest``: +1 inside / 0 on an edge / −1 outside
    (even-odd ray rule, exact integer when inputs are integral); with
    ``measure_dist`` the signed min distance to the polygon edges
    (float64, positive inside)."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    k = len(p)
    px, py = float(pt[0]), float(pt[1])
    on_edge = False
    inside = False
    for i in range(k):
        x1, y1 = p[i]
        x2, y2 = p[(i + 1) % k]
        # on-segment: zero cross product AND within the bounding box
        cross = (px - x1) * (y2 - y1) - (py - y1) * (x2 - x1)
        if cross == 0 and min(x1, x2) <= px <= max(x1, x2) and \
                min(y1, y2) <= py <= max(y1, y2):
            on_edge = True
        if (y1 > py) != (y2 > py):
            t = (py - y1) * (x2 - x1) - (px - x1) * (y2 - y1)
            if (t > 0) == (y2 - y1 > 0):
                inside = not inside
    if not measure_dist:
        return 0.0 if on_edge else (1.0 if inside else -1.0)
    # min distance point→segment over all edges
    best = np.inf
    for i in range(k):
        a = p[i]
        b = p[(i + 1) % k]
        ab = b - a
        ap = np.array([px, py]) - a
        ab2 = float(ab @ ab)
        t = 0.0 if ab2 == 0 else float(np.clip(ap @ ab / ab2, 0.0, 1.0))
        d = np.hypot(*(ap - t * ab))
        best = min(best, d)
    if on_edge:
        return 0.0
    return best if inside else -best


def is_contour_convex(pts: np.ndarray) -> bool:
    """OpenCV ``isContourConvex`` role: True when every turn along the
    closed polygon has the same orientation (collinear runs allowed) AND
    the boundary wraps exactly once (self-intersecting star polygons are
    not convex). Degenerate (<3 points) → False."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    k = len(p)
    if k < 3:
        return False
    sign = 0
    for i in range(k):
        a, b, c = p[i], p[(i + 1) % k], p[(i + 2) % k]
        cr = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if cr != 0:
            s = 1 if cr > 0 else -1
            if sign == 0:
                sign = s
            elif s != sign:
                return False
    if sign == 0:
        return False  # all collinear
    # single winding: total turning angle must be ±2π
    ang = 0.0
    for i in range(k):
        a, b, c = p[i], p[(i + 1) % k], p[(i + 2) % k]
        v1 = b - a
        v2 = c - b
        ang += np.arctan2(v1[0] * v2[1] - v1[1] * v2[0], v1 @ v2)
    return bool(abs(abs(ang) - 2 * np.pi) < 1e-6)


def convexity_defects(contour: np.ndarray, hull_idx: np.ndarray):
    """OpenCV ``convexityDefects`` role: for each hull edge (consecutive
    ``hull_idx`` entries into ``contour``), the contour point between
    them farthest from the edge. Returns [D, 4] int64 rows
    (start_idx, end_idx, farthest_idx, depth_fixpt) with depth in
    1/256 pixel units (OpenCV's fixed-point convention); edges whose max
    depth rounds to 0 are omitted."""
    c = np.asarray(contour, np.float64).reshape(-1, 2)
    hi = np.asarray(hull_idx, np.int64).reshape(-1)
    n = len(c)
    out = []
    for j in range(len(hi)):
        s = int(hi[j])
        e = int(hi[(j + 1) % len(hi)])
        a, b = c[s], c[e]
        ab = b - a
        L = np.hypot(*ab)
        if L == 0:
            continue
        best_d, best_i = 0.0, -1
        i = (s + 1) % n
        while i != e:
            d = abs((c[i] - a)[0] * ab[1] - (c[i] - a)[1] * ab[0]) / L
            if d > best_d:
                best_d, best_i = d, i
            i = (i + 1) % n
        depth = int(np.floor(best_d * 256.0 + 0.5))
        if best_i >= 0 and depth > 0:
            out.append((s, e, best_i, depth))
    return np.asarray(out, np.int64).reshape(-1, 4)


def box_points(rect):
    """Corners of a rotated rect ((cx, cy), (w, h), angle_deg) (OpenCV
    ``boxPoints`` role) → float64 (4, 2), starting at the corner
    (−w/2, −h/2) rotated into place and proceeding by +90° turns —
    OpenCV's bottom-left-first winding for its angle convention."""
    (cx, cy), (w, h), ang = rect
    a = np.radians(ang)
    ca, sa = np.cos(a), np.sin(a)
    dx, dy = w / 2.0, h / 2.0
    local = np.array([[-dx, dy], [-dx, -dy], [dx, -dy], [dx, dy]])
    rot = np.array([[ca, -sa], [sa, ca]])
    return local @ rot.T + np.array([cx, cy])


def _clip_poly(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: clip ``subject`` by CONVEX ``clip`` (both
    (N, 2) float64, any winding) → (K, 2) float64 (possibly empty)."""
    # orient clip counter-clockwise so "inside" = left of each edge
    area2 = 0.0
    for i in range(len(clip)):
        x1, y1 = clip[i]
        x2, y2 = clip[(i + 1) % len(clip)]
        area2 += x1 * y2 - x2 * y1
    if area2 < 0:
        clip = clip[::-1]
    out = [tuple(p) for p in subject]
    for i in range(len(clip)):
        if not out:
            break
        a = clip[i]
        b = clip[(i + 1) % len(clip)]
        ex, ey = b[0] - a[0], b[1] - a[1]

        def side(p):
            return ex * (p[1] - a[1]) - ey * (p[0] - a[0])

        cur, out = out, []
        for j in range(len(cur)):
            p, q = cur[j], cur[(j + 1) % len(cur)]
            sp, sq = side(p), side(q)
            if sp >= 0:
                out.append(p)
            if (sp >= 0) != (sq >= 0):  # strict straddle: sp − sq ≠ 0
                t = sp / (sp - sq)
                out.append((p[0] + t * (q[0] - p[0]),
                            p[1] + t * (q[1] - p[1])))
    return np.asarray(out, np.float64).reshape(-1, 2)


def _dedup_ring(pts: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    if len(pts) < 2:
        return pts
    keep = [pts[0]]
    for p in pts[1:]:
        if np.hypot(*(p - keep[-1])) > eps:
            keep.append(p)
    if len(keep) > 1 and np.hypot(*(keep[0] - keep[-1])) <= eps:
        keep.pop()
    return np.asarray(keep)


def intersect_convex_convex(p1, p2) -> Tuple[float, np.ndarray]:
    """Intersection of two CONVEX polygons (OpenCV
    ``intersectConvexConvex`` role) → (area, vertices float64 (K, 2)
    counter-clockwise). Sutherland-Hodgman clipping; duplicate vertices
    collapsed at 1e-9."""
    a = np.asarray(p1, np.float64).reshape(-1, 2)
    b = np.asarray(p2, np.float64).reshape(-1, 2)
    if len(a) < 3 or len(b) < 3:
        return 0.0, np.zeros((0, 2))
    inter = _dedup_ring(_clip_poly(a, b))
    if len(inter) < 3:
        return 0.0, inter
    return abs(contour_area(inter, oriented=True)), inter


def rotated_rectangle_intersection(rect1, rect2):
    """Intersection of two rotated rects (OpenCV
    ``rotatedRectangleIntersection`` role) → (status, points float64
    (K, 2)): status 0 = none, 1 = partial, 2 = one rect fully inside
    the other. Exact polygon clip of the two ``box_points`` quads."""
    q1 = box_points(rect1)
    q2 = box_points(rect2)
    area, pts = intersect_convex_convex(q1, q2)
    if len(pts) == 0:
        return 0, pts
    a1 = abs(contour_area(q1, oriented=True))
    a2 = abs(contour_area(q2, oriented=True))
    if abs(area - min(a1, a2)) < 1e-6 * max(a1, a2, 1.0):
        return 2, pts
    return (1 if area > 0 else 0), pts


def _conic_to_ellipse(coeffs, mx: float, my: float):
    """Conic (A, B, C, D, E, F) around centroid (mx, my) → OpenCV
    RotatedRect triple ((cx, cy), (major, minor) full axes, angle°)."""
    A, B, Cc, Dd, E, F = coeffs
    den = B * B - 4.0 * A * Cc
    if den >= 0:
        raise ValueError("fit is not an ellipse")
    cx = (2.0 * Cc * Dd - B * E) / den
    cy = (2.0 * A * E - B * Dd) / den
    dif = np.hypot(A - Cc, B)
    q = 2.0 * (A * E * E + Cc * Dd * Dd - B * Dd * E + den * F)
    ax1 = -np.sqrt(max(q * ((A + Cc) + dif), 0.0)) / den
    ax2 = -np.sqrt(max(q * ((A + Cc) - dif), 0.0)) / den
    major, minor = max(ax1, ax2), min(ax1, ax2)
    if abs(B) > 1e-12 * max(abs(A), abs(Cc), 1e-30):
        ang = (np.degrees(np.arctan2(Cc - A - dif, B)) + 90.0) % 180.0
    else:
        ang = 0.0 if A <= Cc else 90.0
    return ((float(cx + mx), float(cy + my)),
            (float(2 * major), float(2 * minor)), float(ang))


def fit_ellipse_direct(pts: np.ndarray):
    """OpenCV ``fitEllipseDirect`` role — identical to
    :func:`fit_ellipse` (which already implements the Halir-Flusser
    direct method with the 4AC−B²>0 constraint)."""
    return fit_ellipse(pts)


def fit_ellipse_ams(pts: np.ndarray):
    """OpenCV ``fitEllipseAMS`` role: the Approximate Mean Square
    (Taubin gradient-weighted) fit — minimize aᵀSa / aᵀNa with
    N = Σ∇z∇zᵀ, solved as a generalized eigenproblem; the ellipse
    branch of the solutions is selected."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if len(p) < 5:
        raise ValueError("fit_ellipse_ams needs at least 5 points")
    mx, my = p[:, 0].mean(), p[:, 1].mean()
    x, y = p[:, 0] - mx, p[:, 1] - my
    z = np.stack([x * x, x * y, y * y, x, y, np.ones_like(x)], 1)
    s = z.T @ z
    # gradient of z wrt (x, y): rows are ∂z/∂x and ∂z/∂y per point
    zx = np.stack([2 * x, y, np.zeros_like(x), np.ones_like(x),
                   np.zeros_like(x), np.zeros_like(x)], 1)
    zy = np.stack([np.zeros_like(x), x, 2 * y, np.zeros_like(x),
                   np.ones_like(x), np.zeros_like(x)], 1)
    n = zx.T @ zx + zy.T @ zy
    # generalized eigenproblem S a = λ N a on the nonsingular block
    evals, evecs = np.linalg.eig(np.linalg.pinv(n) @ s)
    best = None
    best_l = np.inf
    for i in range(6):
        if abs(evals[i].imag) > 1e-9:
            continue
        a = evecs[:, i].real
        if 4.0 * a[0] * a[2] - a[1] ** 2 <= 1e-14:
            continue
        lam = evals[i].real
        if lam >= 0 and lam < best_l:
            best, best_l = a, lam
    if best is None:
        raise ValueError("no ellipse solution (AMS)")
    return _conic_to_ellipse(best, mx, my)


def approx_poly_n(pts: np.ndarray, n_sides: int,
                  ensure_convex: bool = True) -> np.ndarray:
    """OpenCV ``approxPolyN`` (Low-Ilie 2003 role): reduce a convex
    polygon to exactly ``n_sides`` vertices by greedily replacing the
    adjacent-edge pair whose substitution (intersection of the two
    outer edges) adds the least area. Vertices lie on or outside the
    hull; the result circumscribes the input."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if ensure_convex:
        p = np.asarray(convex_hull(p), np.float64)
    if n_sides < 3:
        raise ValueError("n_sides must be >= 3")
    v = list(p)
    while len(v) > n_sides:
        best = None
        best_area = np.inf
        best_pt = None
        m = len(v)
        for i in range(m):
            # contract edge (i, i+1): intersect edges (i-1,i) and
            # (i+1,i+2) extended
            a0, a1 = v[(i - 1) % m], v[i]
            b0, b1 = v[(i + 1) % m], v[(i + 2) % m]
            d1 = a1 - a0
            d2 = b0 - b1
            den = d1[0] * (-d2[1]) - d1[1] * (-d2[0])
            if abs(den) < 1e-12:
                continue
            # solve a1 + t·d1 = b0 + s·(b1-b0) reversed param
            rhs = b0 - a1
            t = (rhs[0] * (-d2[1]) - rhs[1] * (-d2[0])) / den
            x = a1 + t * d1
            if t < -1e-9:
                continue  # intersection behind — not a valid contract
            # added area = triangle (v[i], x, v[i+1])
            u = x - v[i]
            w = v[(i + 1) % m] - v[i]
            area = abs(u[0] * w[1] - u[1] * w[0]) / 2.0
            if area < best_area:
                best, best_area, best_pt = i, area, x
        if best is None:
            break
        m = len(v)
        i2 = (best + 1) % m
        out = []
        for j in range(m):
            if j == best:
                out.append(best_pt)
            elif j == i2:
                continue
            else:
                out.append(v[j])
        v = out
    return np.asarray(v, np.float64)


def min_enclosing_triangle(pts: np.ndarray) -> Tuple[float, np.ndarray]:
    """OpenCV ``minEnclosingTriangle`` → (area, triangle (3, 2)).

    Exact enumeration over O'Rourke's optimality structure: a local
    minimum has every side flush with a hull edge OR touching the hull
    at its own midpoint, with at least one side flush; the
    one-flush/two-midpoint configuration requires the two tangency
    vertices' difference to be parallel to the base (measure-zero in
    general position), so enumerating (a) all-flush edge triples and
    (b) two flush sides + a midpoint-touching vertex (1-D Newton over
    the side direction, multi-start) is complete. Area matches
    cv2.minEnclosingTriangle to <1e-5 relative on random hulls."""
    hull = np.asarray(convex_hull(np.asarray(pts, np.float64)
                                  .reshape(-1, 2)), np.float64)
    m = len(hull)
    if m < 3:
        raise ValueError("need at least 3 non-collinear points")

    def edge(i):
        a, b = hull[i], hull[(i + 1) % m]
        d = b - a
        return a, d / np.linalg.norm(d)

    def inter(p1, d1, p2, d2):
        den = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(den) < 1e-12:
            return None
        t = ((p2[0] - p1[0]) * d2[1] - (p2[1] - p1[1]) * d2[0]) / den
        return p1 + t * d1

    def tri_area(tri):
        a, b, c = tri
        return abs((b[0] - a[0]) * (c[1] - a[1])
                   - (c[0] - a[0]) * (b[1] - a[1])) / 2.0

    def contains(tri, eps=1e-7):
        for q in hull:
            s = []
            for i in range(3):
                p0, p1 = tri[i], tri[(i + 1) % 3]
                s.append((p1[0] - p0[0]) * (q[1] - p0[1])
                         - (p1[1] - p0[1]) * (q[0] - p0[0]))
            s = np.asarray(s)
            sc = max(np.abs(s).max(), 1.0)
            if not ((s >= -eps * sc).all() or (s <= eps * sc).all()):
                return False
        return True

    best = None
    best_a = np.inf

    def consider(tri):
        nonlocal best, best_a
        if tri is None:
            return
        tri = np.asarray(tri)
        if not np.isfinite(tri).all():
            return
        ar = tri_area(tri)
        if ar < 1e-9 or ar >= best_a:
            return
        if contains(tri):
            best, best_a = tri, ar

    edges = [edge(i) for i in range(m)]
    for i in range(m):
        for j in range(i + 1, m):
            for k in range(j + 1, m):
                v0 = inter(*edges[i], *edges[j])
                v1 = inter(*edges[j], *edges[k])
                v2 = inter(*edges[k], *edges[i])
                if v0 is None or v1 is None or v2 is None:
                    continue
                consider([v0, v1, v2])

    for i1 in range(m):
        pa, da = edges[i1]
        for i2 in range(m):
            if i2 == i1:
                continue
            pb, db = edges[i2]
            corner = inter(pa, da, pb, db)
            if corner is None:
                continue
            for kv in range(m):
                vk = hull[kv]

                def resid(th):
                    dc = np.array([np.cos(th), np.sin(th)])
                    q0 = inter(pa, da, vk, dc)
                    q1 = inter(pb, db, vk, dc)
                    if q0 is None or q1 is None:
                        return None, None, None
                    return ((q0 + q1) / 2 - vk) @ dc, q0, q1

                for init in (0.3, 1.0, 1.7, 2.4, 3.0):
                    th = init
                    ok = True
                    for _ in range(30):
                        r, q0, q1 = resid(th)
                        if r is None:
                            ok = False
                            break
                        if abs(r) < 1e-10:
                            break
                        r2, _, _ = resid(th + 1e-6)
                        if r2 is None:
                            ok = False
                            break
                        dr = (r2 - r) / 1e-6
                        if abs(dr) < 1e-14:
                            ok = False
                            break
                        th -= np.clip(r / dr, -0.4, 0.4)
                    if ok:
                        r, q0, q1 = resid(th)
                        if r is not None and abs(r) < 1e-7:
                            consider([corner, q0, q1])

    if best is None:
        raise ValueError("no enclosing triangle found")
    return float(best_a), best


def min_enclosing_convex_polygon(pts: np.ndarray, k: int
                                 ) -> Tuple[float, np.ndarray]:
    """Minimum-area enclosing convex k-gon (OpenCV
    ``minEnclosingConvexPolygon`` role, Aggarwal–Chang–Yap problem) →
    (area, polygon (m, 2) float64), m = min(k, hull size).

    Exact flush-edge optimum + local midpoint refinement:
    1. k = 3 delegates to :func:`min_enclosing_triangle` (exact
       O'Rourke enumeration; cv2 5.0 SEGFAULTS on k = 3).
    2. hull size ≤ k: the hull itself is the minimum (area = hull
       area; extra vertices would be collinear).
    3. Otherwise a vectorized cyclic DP over hull-edge supporting
       lines finds the optimal ALL-FLUSH k-gon exactly (states =
       consecutive chosen-edge pairs, cost = shoelace triple terms,
       O(n⁴k) — hulls are small), then coordinate descent rotates
       each side to its midpoint-touching stationary line (reflect
       the previous side's line through the pivot vertex, intersect
       with the next side's line) wherever that stays a supporting
       line and shrinks the area — the non-flush optimality structure
       of this problem family.

    NOTE on the cv2 oracle: OpenCV 5.0's implementation returns
    NON-ENCLOSING polygons for some k = 4 inputs (points up to ~100 px
    outside, areas ~13% above this function's enclosing optimum) and
    segfaults on k = 3; the tests therefore pin containment always,
    area ≤ cv2's wherever cv2's own output is valid, and agreement
    with a brute-force flush enumeration on small hulls."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    if k < 3:
        raise ValueError("k must be >= 3")
    if k == 3:
        return min_enclosing_triangle(p)
    hull = np.asarray(convex_hull(p), np.float64)
    n = len(hull)
    if n < 3:
        raise ValueError("need at least 3 non-collinear points")
    if n <= k:
        return contour_area(hull), hull.copy()

    nxt = np.roll(hull, -1, axis=0)
    dirs = nxt - hull
    sgn = np.sign(np.sum(hull[:, 0] * nxt[:, 1] - nxt[:, 0] * hull[:, 1]))
    ang = np.arctan2(dirs[:, 1], dirs[:, 0])

    # pairwise supporting-line intersections; valid iff the oriented
    # turning angle between the two edge directions is in (0, pi)
    ipt = np.full((n, n, 2), np.nan)
    valid = np.zeros((n, n), bool)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            g = (sgn * (ang[j] - ang[i])) % (2 * np.pi)
            if not (1e-12 < g < np.pi - 1e-12):
                continue
            den = dirs[i, 0] * dirs[j, 1] - dirs[i, 1] * dirs[j, 0]
            if abs(den) < 1e-12:
                continue
            t = ((hull[j, 0] - hull[i, 0]) * dirs[j, 1]
                 - (hull[j, 1] - hull[i, 1]) * dirs[j, 0]) / den
            ipt[i, j] = hull[i] + t * dirs[i]
            valid[i, j] = True

    # T[p, c, x] = oriented shoelace term cross(I[p,c], I[c,x])
    big = 1e30
    tx = np.nan_to_num(ipt[:, :, 0], nan=big)
    ty = np.nan_to_num(ipt[:, :, 1], nan=big)
    T = sgn * (tx[:, :, None] * ty[None, :, :]
               - ty[:, :, None] * tx[None, :, :])
    T[~valid, :] = np.inf
    T[:, ~valid] = np.inf
    ordmask = np.tril(np.ones((n, n), bool))      # x <= c forbidden

    best_total = np.inf
    best_chain = None
    for c0 in range(0, n - k + 1):
        for c1 in range(c0 + 1, n - k + 2):
            if not valid[c0, c1]:
                continue
            dp = np.full((n, n), np.inf)
            dp[c0, c1] = 0.0
            parents = []
            dead = False
            for _ in range(k - 2):
                m = dp[:, :, None] + T            # (p, c, x)
                am = np.argmin(m, axis=0)         # (c, x)
                dp = np.take_along_axis(m, am[None], axis=0)[0]
                dp[ordmask] = np.inf
                parents.append(am)
                if not np.isfinite(dp).any():
                    dead = True
                    break
            if dead:
                continue
            tot = dp + T[:, :, c0] + T[:, c0, c1][None, :]
            pc = np.unravel_index(np.argmin(tot), tot.shape)
            if tot[pc] < best_total:
                best_total = tot[pc]
                best_chain = (parents, int(pc[0]), int(pc[1]))
    if best_chain is None or not np.isfinite(best_total):
        raise ValueError("no enclosing k-gon found")
    parents, pf, cf = best_chain
    # walk back: dp had a single finite seed (c0, c1), so the trace
    # necessarily ends there — chain = [c0, c1, ..., c_{k-1}]
    chain = [pf, cf]
    for s in range(k - 3, -1, -1):
        chain.insert(0, int(parents[s][chain[0], chain[1]]))
    verts = np.array([ipt[chain[j], chain[(j + 1) % k]]
                      for j in range(k)])

    def shoelace(v):
        return 0.5 * abs(float(np.sum(
            v[:, 0] * np.roll(v[:, 1], -1) - np.roll(v[:, 0], -1)
            * v[:, 1])))

    def supports(a, b):
        """All hull points on the inner side of line (a→b)."""
        d = b - a
        s = sgn * (d[0] * (hull[:, 1] - a[1]) - d[1] * (hull[:, 0] - a[0]))
        scale = max(1.0, float(np.abs(s).max()))
        return float(s.min()) >= -1e-9 * scale

    def is_convex(v):
        d = np.roll(v, -1, axis=0) - v
        c = d[:, 0] * np.roll(d[:, 1], -1) - d[:, 1] * np.roll(d[:, 0], -1)
        return bool((sgn * c > 0).all())

    def line_inter(a1, a2, b1, b2):
        d1, d2 = a2 - a1, b2 - b1
        den = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(den) < 1e-12:
            return None
        t = ((b1[0] - a1[0]) * d2[1] - (b1[1] - a1[1]) * d2[0]) / den
        return a1 + t * d1

    # midpoint coordinate descent (non-flush refinement)
    area = shoelace(verts)
    for _ in range(60):
        improved = False
        for j in range(k):
            jm, jp = (j - 1) % k, (j + 1) % k
            a_prev, b_prev = verts[jm], verts[j]       # line of edge j-1
            a_next, b_next = verts[jp], verts[(j + 2) % k]
            for v in hull:
                # reflect the previous line through v, meet the next
                q = line_inter(2 * v - a_prev, 2 * v - b_prev,
                               a_next, b_next)
                if q is None:
                    continue
                p1 = 2 * v - q                         # on the prev line
                cand = verts.copy()
                cand[j], cand[jp] = p1, q
                if not supports(p1, q) or not is_convex(cand):
                    continue
                ar = shoelace(cand)
                if ar < area - 1e-12 * max(1.0, area):
                    verts, area, improved = cand, ar, True
        if not improved:
            break
    return float(area), verts
