"""cv2-EXACT drawing rasterizers (imgproc drawing.cpp behaviors),
reconstructed from the published algorithms and pinned by randomized
differential sweeps against OpenCV 5.0 (tests/test_cv2_draw.py).

These back the drop-in ``rustcv_tpu.cv2`` facade's drawing surface.
The RustCV-parity rasterizers in imgproc/ (rectangle stride-bleed quirk,
put_text glyph blending — reference rustcv/src/imgproc/drawing.rs:67-163)
are a separate frozen spec and stay untouched.

Conventions shared by every function here:
- images are numpy u8 arrays (H, W) or (H, W, C), modified in place;
- ``color`` is a per-channel tuple already resized to C;
- integer endpoint coordinates; XY_SHIFT=16 fixed-point where cv2 uses
  it (thick lines, fillConvexPoly edge walking).
"""
from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _store(img, y, x, color):
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = color


def _hline(img, y, x0, x1, color):
    """Inclusive [x0, x1] horizontal span, clipped."""
    h, w = img.shape[:2]
    if y < 0 or y >= h or x1 < x0:
        return
    a = max(x0, 0)
    b = min(x1, w - 1)
    if a <= b:
        img[y, a:b + 1] = color


def _tdiv(a: int, b: int) -> int:
    """C-style truncating integer division."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def clip_line(size_wh, p1, p2):
    """cv2 clipLine: the exact single-pass clip (y sides first, then x)
    with C truncating int64 division. Returns (inside, p1, p2)."""
    w, h = size_wh
    right, bottom = w - 1, h - 1
    x1, y1 = int(p1[0]), int(p1[1])
    x2, y2 = int(p2[0]), int(p2[1])
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _tdiv((a - y1) * (x2 - x1), (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _tdiv((a - y2) * (x2 - x1), (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _tdiv((a - x1) * (y2 - y1), (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _tdiv((a - x2) * (y2 - y1), (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_thin(img: np.ndarray, p1, p2, color, connectivity: int = 8):
    """cv2's Line(): LineIterator walk (leftToRight=true), exact err
    bookkeeping. connectivity ∈ {4, 8}."""
    ok, p1, p2 = clip_line((img.shape[1], img.shape[0]), p1, p2)
    if not ok:
        return
    x1, y1 = p1
    x2, y2 = p2
    dx = x2 - x1
    dy = y2 - y1
    # leftToRight: start from the smaller-x endpoint
    if dx < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx = -dx
        dy = -dy
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        major = (0, sy)     # (dx step, dy step)
        minor = (1, 0)
    else:
        major = (1, 0)
        minor = (0, sy)
    x, y = x1, y1
    if connectivity == 8:
        # per ++: when err < 0 take BOTH steps, else major only
        err = dx - (dy + dy)
        plus_delta = dx + dx
        minus_delta = -(dy + dy)
        count = dx + 1
        for _ in range(count):
            _store(img, y, x, color)
            if err < 0:
                err += plus_delta
                x += minor[0]
                y += minor[1]
            err += minus_delta
            x += major[0]
            y += major[1]
    else:
        # 4-connectivity: when err < 0 take the MINOR step only,
        # else the major step (one axis step per iteration)
        err = 0
        count = dx + dy + 1
        for _ in range(count):
            _store(img, y, x, color)
            if err < 0:
                err += dx + dx
                x += minor[0]
                y += minor[1]
            else:
                err += -(dy + dy)
                x += major[0]
                y += major[1]
    return


def _round_fp(v: int) -> int:
    """(v + XY_ONE/2) >> XY_SHIFT with floor semantics for negatives."""
    return (int(v) + (XY_ONE >> 1)) >> XY_SHIFT
