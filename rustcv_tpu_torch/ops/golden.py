"""Frozen numpy specs the port needs from ``rustcv_tpu.ops.golden`` (its
own copy: the JAX package keeps them in a module that imports jax): the
constants and tables below, and the Lab matrix and white point, the
bicubic and nearest-neighbour resize tables.

The rotated-ellipse mask that ``imgproc.ellipse`` paints; the text
blend (:func:`blend_mask`) that ``put_text`` makes on a host Mat and the
device blends of :mod:`.draw` are held against; the Bayer CFA
patterns, the mosaic the simulated sensors send, and the integer bilinear
demosaic oracle that :func:`.color.demosaic_bilinear` computes on the
device: at each site the missing channels are the rounded
means of their 2 or 4 nearest samples (avg2 = (a+b+1)>>1, avg4 = (Σ+2)>>2),
borders mirrored about the edge pixel (reflect-101, which keeps each site's
colour).
"""

from __future__ import annotations

import numpy as np

# Bayer CFA patterns: the (row % 2, col % 2) site of red and of blue; green
# fills the other two. Keys match PixelFormat.BAYER_*.
BAYER_PATTERNS = {
    "BGGR": {"r": (1, 1), "b": (0, 0)},
    "GBRG": {"r": (1, 0), "b": (0, 1)},
    "GRBG": {"r": (0, 1), "b": (1, 0)},
    "RGGB": {"r": (0, 0), "b": (1, 1)},
}


def _sites(h: int, w: int, pattern: str):
    """Boolean (H, W) masks of the red and the blue sites, and the row
    parity of each (``ys``, (H, 1))."""
    spec = BAYER_PATTERNS[pattern]
    ys = np.arange(h)[:, None] % 2
    xs = np.arange(w)[None, :] % 2
    r_site = (ys == spec["r"][0]) & (xs == spec["r"][1])
    b_site = (ys == spec["b"][0]) & (xs == spec["b"][1])
    return r_site, b_site, ys


def mosaic_bayer(bgr: np.ndarray, pattern: str) -> np.ndarray:
    """BGR (H, W, 3) → raw Bayer mosaic (H, W) u8 by sampling the site's
    channel."""
    r_site, b_site, _ = _sites(*bgr.shape[:2], pattern)
    out = bgr[..., 1].copy()  # green everywhere else
    out[r_site] = bgr[..., 2][r_site]
    out[b_site] = bgr[..., 0][b_site]
    return out


def demosaic_bilinear(raw: np.ndarray, pattern: str) -> np.ndarray:
    """Integer bilinear demosaic of a (H, W) u8 mosaic → BGR (H, W, 3) u8;
    H, W >= 2."""
    spec = BAYER_PATTERNS[pattern]
    h, w = raw.shape
    a = raw.astype(np.int32)
    p = np.pad(a, 1, mode="reflect")
    horiz = p[1:-1, :-2] + p[1:-1, 2:]
    vert = p[:-2, 1:-1] + p[2:, 1:-1]
    diag = p[:-2, :-2] + p[:-2, 2:] + p[2:, :-2] + p[2:, 2:]
    g4 = (horiz + vert + 2) >> 2
    h2 = (horiz + 1) >> 1
    v2 = (vert + 1) >> 1
    d4 = (diag + 2) >> 2

    mr, mb, ys = _sites(h, w, pattern)
    g_red_row = ~mr & ~mb & (ys == spec["r"][0])
    g_blue_row = ~mr & ~mb & (ys == spec["b"][0])
    r = np.where(mr, a, np.where(g_red_row, h2, np.where(g_blue_row, v2, d4)))
    b = np.where(mb, a, np.where(g_blue_row, h2, np.where(g_red_row, v2, d4)))
    g = np.where(mr | mb, g4, a)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def ellipse_mask(h: int, w: int, center, axes, angle_deg: float,
                 thickness: int = 1) -> np.ndarray:
    """Frozen rotated-ellipse mask (OpenCV ``ellipse`` role, full arc):
    float64 spec — rotate into the ellipse frame with exact-radian
    cos/sin, test u² + v² ≤ 1 with u = x'/a, v = y'/b. ``thickness < 0``
    fills; a ring is inside the (a+⌈t/2⌉, b+⌈t/2⌉) ellipse and outside
    the (a−⌊(t+1)/2⌋, b−⌊(t+1)/2⌋) one (axes clamped at 0). Host-only
    spec: the device path paints this exact mask."""
    import math

    cx, cy = float(center[0]), float(center[1])
    a0, b0 = int(axes[0]), int(axes[1])
    th = math.radians(float(angle_deg))
    c, s = math.cos(th), math.sin(th)
    ys, xs = np.mgrid[0:h, 0:w]
    dx = xs.astype(np.float64) - cx
    dy = ys.astype(np.float64) - cy
    rx = dx * c + dy * s
    ry = -dx * s + dy * c

    def inside(a, b):
        if a <= 0 or b <= 0:
            return np.zeros((h, w), bool)
        return (rx / a) ** 2 + (ry / b) ** 2 <= 1.0

    if thickness < 0:
        m = inside(a0, b0)
    else:
        t = int(thickness)
        outer = inside(a0 + (t + 1) // 2, b0 + (t + 1) // 2)
        inner = inside(a0 - (t + 1) // 2, b0 - (t + 1) // 2)
        m = outer & ~inner
    return m.astype(np.uint8) * 255


def blend_mask(img: np.ndarray, mask: np.ndarray, x0: int, y0: int, color_bgr: tuple) -> None:
    """Alpha-blend a coverage mask onto a BGR image, in place: the frozen
    integer blend ``new = (color*a + old*(255-a)) // 255`` with a in
    [0, 255] (``drawing.rs:123-163``'s float blend, truncated).

    ``img``: (rows, cols, 3) u8 view; ``mask``: (mh, mw) u8 coverage;
    (x0, y0): top-left placement. Parts off the image are clipped."""
    rows, cols = img.shape[:2]
    mh, mw = mask.shape
    sy, sx = max(0, -y0), max(0, -x0)
    ey = min(mh, rows - y0)
    ex = min(mw, cols - x0)
    if sy >= ey or sx >= ex:
        return
    sub = img[y0 + sy : y0 + ey, x0 + sx : x0 + ex].astype(np.int32)
    a = mask[sy:ey, sx:ex].astype(np.int32)[..., None]
    color = np.array(color_bgr, dtype=np.int32)
    blended = (color * a + sub * (255 - a)) // 255
    img[y0 + sy : y0 + ey, x0 + sx : x0 + ex] = blended.astype(np.uint8)


# CIE L*a*b*: the frozen spec's sRGB → XYZ (D65) matrix, rows applied to
# (R, G, B), and its white point (rustcv_tpu/ops/golden.py:235-243).
_LAB_M = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    np.float64,
)
_LAB_WHITE = (0.950456, 1.0, 1.088754)  # Xn, Yn, Zn

RESIZE_SHIFT = 11  # 11-bit fixed-point resize weights
RESIZE_ONE = 1 << RESIZE_SHIFT


def resize_bicubic_coeffs(src_size: int, dst_size: int):
    """Per-output-pixel 4-tap tables for INTER_CUBIC (a = −0.75, OpenCV's
    kernel), frozen spec. Half-pixel centres; taps at ix−1..ix+2 clamped to
    [0, src−1] (replicate border). Weights w(x) for |x|≤1: (a+2)|x|³ −
    (a+3)|x|² + 1; 1<|x|<2: a(|x|³ − 5|x|² + 8|x| − 4); quantized to 11
    bits with w1 = 2048 − (w0+w2+w3) so flat regions are exact. Returns
    (tap_idx int32 [dst, 4], weights int32 [dst, 4])."""
    a = -0.75
    dx = np.arange(dst_size, dtype=np.float64)
    fx = (dx + 0.5) * (src_size / dst_size) - 0.5
    ix = np.floor(fx).astype(np.int64)
    f = fx - ix

    def k(x):
        x = np.abs(x)
        return np.where(
            x <= 1.0,
            (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
            np.where(x < 2.0, a * (x**3 - 5.0 * x**2 + 8.0 * x - 4.0), 0.0),
        )

    w = np.stack([k(f + 1.0), k(f), k(1.0 - f), k(2.0 - f)], axis=-1)
    wq = np.round(w * RESIZE_ONE).astype(np.int64)
    wq[:, 1] = RESIZE_ONE - (wq[:, 0] + wq[:, 2] + wq[:, 3])
    taps = ix[:, None] + np.arange(-1, 3)[None, :]
    taps = np.clip(taps, 0, src_size - 1)
    return taps.astype(np.int32), wq.astype(np.int32)


def resize_nearest_coeffs(src_size: int, dst_size: int) -> np.ndarray:
    """Frozen nearest-neighbour tap table: half-pixel centres,
    src = min(floor((d + 0.5) · src/dst), src − 1) in float64."""
    d = np.arange(dst_size, dtype=np.float64)
    ix = np.floor((d + 0.5) * (src_size / dst_size)).astype(np.int64)
    return np.minimum(ix, src_size - 1).astype(np.int32)
