"""cv2-exact Canny edge detector (imgproc canny.cpp scalar-path port).

Differs from the frozen framework spec (`ops/golden.py::canny`, which
fuses a 5x5 Gaussian prefilter and uses bounded hysteresis): this is
OpenCV's own algorithm — Sobel CV_16S with BORDER_REPLICATE, L1 (or L2)
magnitude, fixed-point sector NMS (CANNY_SHIFT=15, TG22), and unbounded
8-connected hysteresis from strong pixels (the flood fill's fixed point,
computed as the weak pixels' 8-connected components that hold a strong
one).  Verified
bit-exact against cv2 5.0 over random images for aperture 3/5/7 and
both norms (tests/test_poisson_cv.py).

The reference has no Canny (RustCV ships no filters); this exists for
the cv2 facade's drop-in contract and textureFlattening's edge gate.
"""
from __future__ import annotations

import numpy as np

from .filters import sobel_xy_numpy

__all__ = ["canny_cv"]


def _sobel_i16(g, dx, dy, aperture):
    """Sobel CV_16S: cv2 accumulates the separable passes in int and
    saturate_casts the final value to int16 (aperture 7 overflows at
    full contrast — measured: saturation, not wraparound).  Canny
    scales the aperture-7 Sobel by 1/16 with cvRound's
    round-half-even (measured bit-exact), and divides the user
    thresholds by 16 to match."""
    v = sobel_xy_numpy(g, dx, dy, aperture)
    if aperture == 7:
        v = np.rint(v / 16.0).astype(np.int64)
    return np.clip(v, -32768, 32767).astype(np.int64)

_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)


def canny_cv(img: np.ndarray, low: float, high: float,
             aperture: int = 3, l2gradient: bool = False) -> np.ndarray:
    """u8 image (1- or multi-channel) -> u8 edge mask (255/0),
    bit-exact vs cv2.Canny.  Multi-channel: per pixel, the channel
    with the largest magnitude supplies dx/dy (first max wins)."""
    g = np.asarray(img, np.uint8)
    if aperture == 7:
        low, high = low / 16.0, high / 16.0
    if g.ndim == 3 and g.shape[-1] == 1:
        g = g[..., 0]
    if g.ndim == 3:
        dxc = np.stack([_sobel_i16(g[..., c], 1, 0, aperture)
                        for c in range(g.shape[-1])], -1)
        dyc = np.stack([_sobel_i16(g[..., c], 0, 1, aperture)
                        for c in range(g.shape[-1])], -1)
        magc = (dxc * dxc + dyc * dyc if l2gradient
                else np.abs(dxc) + np.abs(dyc))
        sel = np.argmax(magc, axis=-1)  # first max wins (strict >)
        dx = np.take_along_axis(dxc, sel[..., None], -1)[..., 0]
        dy = np.take_along_axis(dyc, sel[..., None], -1)[..., 0]
    else:
        dx = _sobel_i16(g, 1, 0, aperture)
        dy = _sobel_i16(g, 0, 1, aperture)
    if l2gradient:
        lo = min(32767.0, float(min(low, high)))
        hi = min(32767.0, float(max(low, high)))
        lo = int(np.floor(lo * lo)) if lo > 0 else int(np.floor(lo))
        hi = int(np.floor(hi * hi)) if hi > 0 else int(np.floor(hi))
        mag = dx * dx + dy * dy
    else:
        lo = int(np.floor(float(min(low, high))))
        hi = int(np.floor(float(max(low, high))))
        mag = np.abs(dx) + np.abs(dy)
    h, w = g.shape[:2]
    magp = np.zeros((h + 2, w + 2), np.int64)
    magp[1:-1, 1:-1] = mag
    m = magp[1:-1, 1:-1]
    x = np.abs(dx)
    y = np.abs(dy) << _CANNY_SHIFT
    tg22x = x * _TG22
    # cv2 computes tg67x in int32; |dx| near 32767 (aperture 7)
    # overflows and wraps — emulate to stay bit-exact
    tg67x = tg22x + ((x + x) << _CANNY_SHIFT)
    tg67x = ((tg67x + 2**31) % 2**32 - 2**31)
    horiz = y < tg22x
    vert = (~horiz) & (y > tg67x)
    s = np.where((dx ^ dy) < 0, -1, 1)
    left, right = magp[1:-1, :-2], magp[1:-1, 2:]
    up, down = magp[:-2, 1:-1], magp[2:, 1:-1]
    ul, ur = magp[:-2, :-2], magp[:-2, 2:]
    dl, dr = magp[2:, :-2], magp[2:, 2:]
    d_prev = np.where(s == 1, ul, ur)
    d_next = np.where(s == 1, dr, dl)
    localmax = np.where(
        horiz, (m > left) & (m >= right),
        np.where(vert, (m > up) & (m >= down),
                 (m > d_prev) & (m > d_next)))
    weak = (m > lo) & localmax
    strong = weak & (m > hi)
    if not strong.any():
        return np.zeros((h, w), np.uint8)
    # the flood fill's fixed point (grow the strong pixels through 8-connected
    # weak ones) is the union of the weak pixels' 8-connected components that
    # hold a strong pixel: one labeling (native union-find), no fill rounds
    from .ccl import connected_components

    n, lab = connected_components(weak.view(np.uint8), connectivity=8)
    keep = np.zeros(int(n) + 1, bool)
    keep[np.unique(lab[strong])] = True
    keep[0] = False
    return np.where(keep[lab], 255, 0).astype(np.uint8)
