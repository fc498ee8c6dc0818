"""Copy of ``rustcv_tpu.ops.viz`` (the port's ``core_ops.RNG`` and
``golden`` masks). Feature-visualization and geometry drawing helpers (OpenCV
``drawKeypoints`` / ``drawMatches`` / ``clipLine`` / ``ellipse2Poly``
roles).

Host utilities — these paint debug overlays for humans, so they reuse
the frozen integer distance-field strokes from ops/golden.py (the same
masks the device drawing path blends) and our bit-exact cv::RNG for the
"random color per keypoint" convention. ``clip_line`` and
``ellipse2poly`` are cross-validated against cv2 5.0 in
tests/test_viz.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .core_ops import RNG
from .golden import circle_mask, line_mask


def _idiv(a: int, b: int) -> int:
    """C-style integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def clip_line(rect_xywh: Tuple[int, int, int, int],
              pt1: Tuple[int, int], pt2: Tuple[int, int]
              ) -> Tuple[bool, Tuple[int, int], Tuple[int, int]]:
    """OpenCV ``clipLine``: clip the integer segment to the rectangle
    → (inside, p1, p2). Exact replica of cv2's two-phase clip (y edges
    first, then x, with C-truncated integer division) — bit-equal to
    cv2.clipLine on the fuzz test."""
    ox, oy, w, h = (int(v) for v in rect_xywh)
    if w <= 0 or h <= 0:
        return False, pt1, pt2
    right, bottom = w - 1, h - 1
    # cv2 clips in rect-local coordinates
    x1, y1 = int(pt1[0]) - ox, int(pt1[1]) - oy
    x2, y2 = int(pt2[0]) - ox, int(pt2[1]) - oy
    c1 = ((x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4
          + (y1 > bottom) * 8)
    c2 = ((x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4
          + (y2 > bottom) * 8)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _idiv((a - y1) * (x2 - x1), (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _idiv((a - y2) * (x2 - x1), (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _idiv((a - x1) * (y2 - y1), (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _idiv((a - x2) * (y2 - y1), (x2 - x1))
                x2 = a
                c2 = 0
    if (c1 | c2) != 0:
        return False, pt1, pt2
    return True, (x1 + ox, y1 + oy), (x2 + ox, y2 + oy)


_SINTAB = np.sin(np.deg2rad(np.arange(361)))
_COSTAB = np.cos(np.deg2rad(np.arange(361)))


def ellipse2poly(center: Tuple[int, int], axes: Tuple[int, int],
                 angle: int, arc_start: int, arc_end: int,
                 delta: int) -> np.ndarray:
    """OpenCV ``ellipse2Poly``: integer polyline approximating the
    elliptic arc, sampled every ``delta`` degrees (endpoint included)
    → (N, 2) int32."""
    if delta <= 0:
        raise ValueError("delta must be positive")
    cx, cy = center
    a, b = axes
    while arc_end < arc_start:
        arc_end += 360
    ca = np.cos(np.deg2rad(angle))
    sa = np.sin(np.deg2rad(angle))
    ts = list(range(int(arc_start), int(arc_end), int(delta)))
    ts.append(int(arc_end))
    pts = []
    for t in ts:
        tt = t % 360
        x = a * _COSTAB[tt]
        y = b * _SINTAB[tt]
        px = cx + x * ca - y * sa
        py = cy + x * sa + y * ca
        pts.append((int(round(px)), int(round(py))))
    out = []
    for p in pts:  # drop consecutive duplicates (cv2 behavior)
        if not out or out[-1] != p:
            out.append(p)
    return np.asarray(out, np.int32)


def _as_bgr(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    return a.astype(np.uint8).copy()


def _paint(img: np.ndarray, mask: np.ndarray, color) -> None:
    img[mask > 0] = np.asarray(color, np.uint8)


def _kp_xys(keypoints) -> np.ndarray:
    kp = np.asarray(keypoints, np.float64)
    if kp.ndim != 2 or kp.shape[1] < 2:
        raise ValueError("keypoints must be (N, >=2) with x, y first")
    return kp


def draw_keypoints(img: np.ndarray, keypoints, color=None,
                   rich: bool = False, seed: int = 12345) -> np.ndarray:
    """OpenCV ``drawKeypoints``: small circles (or, with ``rich``, a
    size-proportional circle plus the orientation ray when columns
    (x, y, size, angle_deg, ...) are present). ``color=None`` assigns
    per-keypoint colors from the bit-exact cv::RNG."""
    out = _as_bgr(img)
    h, w = out.shape[:2]
    kp = _kp_xys(keypoints)
    rng = RNG(seed)
    for row in kp:
        c = (color if color is not None else
             (rng.uniform_int(0, 256), rng.uniform_int(0, 256),
              rng.uniform_int(0, 256)))
        x, y = int(round(row[0])), int(round(row[1]))
        if not (0 <= x < w and 0 <= y < h):
            continue
        if rich and len(row) >= 3 and row[2] > 0:
            r = max(1, int(round(row[2] / 2.0)))
            _paint(out, circle_mask(h, w, (x, y), r, 1), c)
            if len(row) >= 4:
                ang = np.deg2rad(row[3])
                tip = (int(round(x + r * np.cos(ang))),
                       int(round(y + r * np.sin(ang))))
                ok, p1, p2 = clip_line((0, 0, w, h), (x, y), tip)
                if ok:
                    _paint(out, line_mask(h, w, p1, p2, 1), c)
        else:
            _paint(out, circle_mask(h, w, (x, y), 3, 1), c)
    return out


def draw_matches(img1: np.ndarray, kp1, img2: np.ndarray, kp2,
                 matches: Sequence[Tuple[int, int]],
                 match_color=None, point_color=None,
                 seed: int = 12345) -> np.ndarray:
    """OpenCV ``drawMatches``: side-by-side canvas with a line per
    (query_idx, train_idx) pair. ``matches`` also accepts (N, 2+) int
    arrays (extra columns, e.g. distance, ignored)."""
    a = _as_bgr(img1)
    b = _as_bgr(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[:a.shape[0], :a.shape[1]] = a
    canvas[:b.shape[0], a.shape[1]:] = b
    k1 = _kp_xys(kp1)
    k2 = _kp_xys(kp2)
    off = a.shape[1]
    hh, ww = canvas.shape[:2]
    rng = RNG(seed)
    for m in np.asarray(matches, np.int64).reshape(-1, np.shape(matches)[-1]):
        qi, ti = int(m[0]), int(m[1])
        if not (0 <= qi < len(k1) and 0 <= ti < len(k2)):
            continue
        c = (match_color if match_color is not None else
             (rng.uniform_int(0, 256), rng.uniform_int(0, 256),
              rng.uniform_int(0, 256)))
        p1 = (int(round(k1[qi, 0])), int(round(k1[qi, 1])))
        p2 = (int(round(k2[ti, 0])) + off, int(round(k2[ti, 1])))
        ok, q1, q2 = clip_line((0, 0, ww, hh), p1, p2)
        if ok:
            _paint(canvas, line_mask(hh, ww, q1, q2, 1), c)
        pc = point_color if point_color is not None else c
        for p in (p1, p2):
            if 0 <= p[0] < ww and 0 <= p[1] < hh:
                _paint(canvas, circle_mask(hh, ww, p, 3, 1), pc)
    return canvas


_MARKERS = ("cross", "tilted_cross", "star", "diamond", "square",
            "triangle_up", "triangle_down")


def draw_marker(img: np.ndarray, position: Tuple[int, int], color,
                marker_type: str = "cross", marker_size: int = 20,
                thickness: int = 1) -> np.ndarray:
    """OpenCV ``drawMarker``: paint one of the seven marker glyphs
    (composed from the frozen line strokes). Returns a new array."""
    out = _as_bgr(img)
    h, w = out.shape[:2]
    x, y = int(position[0]), int(position[1])
    r = marker_size // 2

    def seg(p1, p2):
        ok, q1, q2 = clip_line((0, 0, w, h), p1, p2)
        if ok:
            _paint(out, line_mask(h, w, q1, q2, thickness), color)

    if marker_type == "cross":
        seg((x - r, y), (x + r, y))
        seg((x, y - r), (x, y + r))
    elif marker_type == "tilted_cross":
        seg((x - r, y - r), (x + r, y + r))
        seg((x - r, y + r), (x + r, y - r))
    elif marker_type == "star":
        seg((x - r, y), (x + r, y))
        seg((x, y - r), (x, y + r))
        seg((x - r, y - r), (x + r, y + r))
        seg((x - r, y + r), (x + r, y - r))
    elif marker_type == "diamond":
        seg((x, y - r), (x + r, y))
        seg((x + r, y), (x, y + r))
        seg((x, y + r), (x - r, y))
        seg((x - r, y), (x, y - r))
    elif marker_type == "square":
        seg((x - r, y - r), (x + r, y - r))
        seg((x + r, y - r), (x + r, y + r))
        seg((x + r, y + r), (x - r, y + r))
        seg((x - r, y + r), (x - r, y - r))
    elif marker_type == "triangle_up":
        seg((x - r, y + r), (x + r, y + r))
        seg((x + r, y + r), (x, y - r))
        seg((x, y - r), (x - r, y + r))
    elif marker_type == "triangle_down":
        seg((x - r, y - r), (x + r, y - r))
        seg((x + r, y - r), (x, y + r))
        seg((x, y + r), (x - r, y - r))
    else:
        raise ValueError(f"unknown marker_type {marker_type!r} "
                         f"(one of {_MARKERS})")
    return out
