"""FAST corner detector (port of ``rustcv_tpu.ops.fast``; features2d
parity), elementwise on the tensor's device.

FAST-N segment test on a Bresenham ring: a pixel is a corner when ≥ N
contiguous ring pixels are all brighter than center+t or all darker than
center−t. All three OpenCV pattern types are supported: ``9_16`` (the
classic radius-3/16-pixel ring), ``7_12`` (radius-2/12) and ``5_8``
(radius-1/8). There are no per-pixel loops: the K ring views are shifts of
the image, the two K-bit ring masks are int32 lanes, and "N contiguous
(circularly)" reduces by the rotate-AND trick (the AND of N−1 successive
rotations is nonzero iff some run of length N exists). Score = Σ|ring −
center| over the passing arc's direction (a frozen spec; OpenCV's score
differs), NMS 3×3 like Harris.

Frozen spec (exact integer): brighter = ring > c + t, darker = ring <
c − t; a border of ring-radius pixels never fires; non-max suppression on
the score. ``9_16`` detections are set-equal to cv2 5.0's (nonmax off);
the 7_12 and 5_8 tests are the published circular segment test, a strict
superset of cv2 5.0's detections. The corner list is the top-K by score,
equal scores lowest flat index first (``jax.lax.top_k``'s order), exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# Bresenham circle radius 3, clockwise from 12 o'clock: (dy, dx).
RING = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]

# Bresenham circle radius 2 (12 pixels) and the unit ring (8 pixels).
RING12 = [
    (-2, 0), (-2, 1), (-1, 2), (0, 2), (1, 2), (2, 1), (2, 0), (2, -1),
    (1, -2), (0, -2), (-1, -2), (-2, -1),
]
RING8 = [
    (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1),
]

# pattern → (ring, default n, border radius)
PATTERNS = {
    "9_16": (RING, 9, 3),
    "7_12": (RING12, 7, 2),
    "5_8": (RING8, 5, 1),
}


def _resolve(pattern: str, n: Optional[int]):
    if pattern not in PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r} "
                         f"(one of {sorted(PATTERNS)})")
    ring, default_n, border = PATTERNS[pattern]
    return ring, (default_n if n is None else n), border


def _rot(m, k, size):
    """Circular left-rotation of a size-bit lane mask by k."""
    return ((m << k) | (m >> (size - k))) & ((1 << size) - 1)


def _has_run(mask, n, size):
    """True where the size-bit circular mask contains a run of n ones."""
    acc = mask
    for k in range(1, n):
        acc = acc & _rot(mask, k, size)
    return acc != 0


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Image shifted so out[y, x] = img[y+dy, x+dx] (zero-pad borders —
    the ring-radius border is masked off anyway)."""
    h, w = img.shape[-2], img.shape[-1]
    out = torch.zeros_like(img)
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[..., yd, xd] = img[..., ys, xs]
    return out


def fast_response(gray_u8: torch.Tensor, threshold: int = 20,
                  n: Optional[int] = None, nms: bool = True,
                  pattern: str = "9_16"):
    """u8 gray (H, W) → (corner mask bool, score int32) — FAST-n."""
    ring, n, border = _resolve(pattern, n)
    size = len(ring)
    c = gray_u8.to(torch.int32)
    bright = torch.zeros_like(c)
    dark = torch.zeros_like(c)
    score_b = torch.zeros_like(c)
    score_d = torch.zeros_like(c)
    for i, (dy, dx) in enumerate(ring):
        r = _shift(c, dy, dx)
        bright = bright | ((r > c + threshold).to(torch.int32) << i)
        dark = dark | ((r < c - threshold).to(torch.int32) << i)
        score_b = score_b + torch.clamp(r - c - threshold, min=0)
        score_d = score_d + torch.clamp(c - threshold - r, min=0)
    is_b = _has_run(bright, n, size)
    is_d = _has_run(dark, n, size)
    score = torch.where(is_b, score_b, 0) + torch.where(is_d, score_d, 0)
    corner = is_b | is_d
    # ring-radius border never fires (incomplete rings read zero-padding)
    inb = torch.zeros_like(corner)
    inb[..., border:c.shape[-2] - border, border:c.shape[-1] - border] = True
    corner = corner & inb
    score = torch.where(corner, score, 0)
    if nms:
        best = score
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                best = torch.maximum(best, _shift(score, dy, dx))
        corner = corner & (score >= best) & (score > 0)
    return corner, score


def fast_corner_list(
    gray_u8: torch.Tensor,
    threshold: int = 20,
    n: Optional[int] = None,
    max_corners: int = 1024,
    nms: bool = True,
    pattern: str = "9_16",
):
    """Top-K FAST corners: ([K, 2] (y, x) int32, valid bool[K]), the same
    static-shape contract as ``features.harris_corner_list``: ordered by
    score, equal scores lowest flat index first."""
    corner, score = fast_response(gray_u8, threshold, n, nms, pattern)
    h, w = gray_u8.shape[-2], gray_u8.shape[-1]
    flat = torch.where(corner, score, -1).reshape(h * w).to(torch.int64)
    # One unique int64 key per pixel: the score above, the reversed flat
    # index below, so topk's order is the score's, ties lowest index first.
    rev = torch.arange(h * w - 1, -1, -1, dtype=torch.int64, device=flat.device)
    top_key = (flat * 2**32 + rev).topk(max_corners).values
    top = torch.div(top_key, 2**32, rounding_mode="floor")
    idx = (h * w - 1) - (top_key - top * 2**32)
    return torch.stack([idx // w, idx % w], dim=-1).to(torch.int32), top > 0


# ---------------------------------------------------------------------------
# NumPy oracle (same frozen spec)
# ---------------------------------------------------------------------------


def fast_corners_numpy(gray: np.ndarray, threshold: int = 20,
                       n: Optional[int] = None, nms: bool = True,
                       pattern: str = "9_16"):
    ring, n, border = _resolve(pattern, n)
    size = len(ring)
    c = gray.astype(np.int64)
    h, w = c.shape
    bright = np.zeros((h, w), np.int64)
    dark = np.zeros((h, w), np.int64)
    sb = np.zeros((h, w), np.int64)
    sd = np.zeros((h, w), np.int64)
    for i, (dy, dx) in enumerate(ring):
        r = np.zeros_like(c)
        ys = slice(max(dy, 0), h + min(dy, 0))
        xs = slice(max(dx, 0), w + min(dx, 0))
        yd = slice(max(-dy, 0), h + min(-dy, 0))
        xd = slice(max(-dx, 0), w + min(-dx, 0))
        r[yd, xd] = c[ys, xs]
        bright |= (r > c + threshold).astype(np.int64) << i
        dark |= (r < c - threshold).astype(np.int64) << i
        sb += np.maximum(r - c - threshold, 0)
        sd += np.maximum(c - threshold - r, 0)

    def run(mask):
        acc = mask.copy()
        for k in range(1, n):
            rot = ((mask << k) | (mask >> (size - k))) & ((1 << size) - 1)
            acc &= rot
        return acc != 0

    is_b = run(bright)
    is_d = run(dark)
    score = np.where(is_b, sb, 0) + np.where(is_d, sd, 0)
    corner = is_b | is_d
    corner[:border] = corner[-border:] = False
    corner[:, :border] = corner[:, -border:] = False
    score = np.where(corner, score, 0)
    if nms:
        best = score.copy()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                shifted = np.zeros_like(score)
                ys = slice(max(dy, 0), h + min(dy, 0))
                xs = slice(max(dx, 0), w + min(dx, 0))
                yd = slice(max(-dy, 0), h + min(-dy, 0))
                xd = slice(max(-dx, 0), w + min(-dx, 0))
                shifted[yd, xd] = score[ys, xs]
                best = np.maximum(best, shifted)
        corner = corner & (score >= best) & (score > 0)
    return corner, score
