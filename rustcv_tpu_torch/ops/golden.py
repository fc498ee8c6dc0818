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
colour). The Hu moments and ``matchShapes`` of a mask, the colormap
tables of ``imgproc.apply_color_map`` and the float64 ``normalize`` that a
host Mat runs (the device form is float32, ±1 LSB). The oracles the
feature and flow modules call on a host Mat: the 5×5 Gaussian and
``pyr_down`` (BRIEF/ORB, LK, ECC), the fixed-point bilinear resize (the
HOG pyramid) and the Lab round trip (``decolor``). The integer luma
(:func:`bgr_to_gray`) that the trackers take of a BGR frame, the float64
Kalman updates that ``kalman.KalmanFilter`` runs, and the MOSSE tracker's
spec, which ``tracker.TrackerMOSSE(backend="host")`` runs and the
``kcf``/``csrt`` oracles crop with. The integer Sobel pair and the Canny
spec (the generalized Hough's R-tables, the line detector, intelligent
scissors and the Hough oracles), and the line and circle stroke masks that
``viz`` draws with.
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


def hu_moments(mask: np.ndarray) -> np.ndarray:
    """The seven Hu invariant moments of a u8 mask/gray image (OpenCV
    ``HuMoments``): translation/scale/rotation invariants from normalized
    central moments (float64; raw sums exact int64)."""
    a = mask.astype(np.int64)
    if a.ndim == 3:
        a = a[..., 0]
    h, w = a.shape
    xs = np.arange(w, dtype=np.int64)[None, :]
    ys = np.arange(h, dtype=np.int64)[:, None]
    m00 = a.sum()
    if m00 == 0:
        return np.zeros(7)
    xb = (a * xs).sum() / m00
    yb = (a * ys).sum() / m00
    xc = xs - xb
    yc = ys - yb

    def mu(p, q):
        return float((a * xc**p * yc**q).sum())

    n = float(m00)

    def eta(p, q):
        return mu(p, q) / n ** (1 + (p + q) / 2.0)

    n20, n02, n11 = eta(2, 0), eta(0, 2), eta(1, 1)
    n30, n03 = eta(3, 0), eta(0, 3)
    n21, n12 = eta(2, 1), eta(1, 2)
    h1 = n20 + n02
    h2 = (n20 - n02) ** 2 + 4 * n11**2
    h3 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h4 = (n30 + n12) ** 2 + (n21 + n03) ** 2
    h5 = (n30 - 3 * n12) * (n30 + n12) * (
        (n30 + n12) ** 2 - 3 * (n21 + n03) ** 2
    ) + (3 * n21 - n03) * (n21 + n03) * (
        3 * (n30 + n12) ** 2 - (n21 + n03) ** 2
    )
    h6 = (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) + 4 * n11 * (
        n30 + n12
    ) * (n21 + n03)
    h7 = (3 * n21 - n03) * (n30 + n12) * (
        (n30 + n12) ** 2 - 3 * (n21 + n03) ** 2
    ) - (n30 - 3 * n12) * (n21 + n03) * (
        3 * (n30 + n12) ** 2 - (n21 + n03) ** 2
    )
    return np.array([h1, h2, h3, h4, h5, h6, h7])


def match_shapes(mask_a: np.ndarray, mask_b: np.ndarray) -> float:
    """OpenCV ``matchShapes`` (I1 method): Σ |1/sgn·log|hA| − 1/sgn·log|hB||
    over the Hu moments — 0 for identical shapes, small for similar."""
    ha = hu_moments(mask_a)
    hb = hu_moments(mask_b)
    eps = 1e-30
    sa = np.sign(ha)
    sb = np.sign(hb)
    ma = sa * np.log10(np.abs(ha) + eps)
    mb = sb * np.log10(np.abs(hb) + eps)
    use = (np.abs(ha) > 1e-12) & (np.abs(hb) > 1e-12)
    if not use.any():
        return 0.0
    return float(np.abs(1.0 / ma[use] - 1.0 / mb[use]).sum())


#: reference has no colormaps; OpenCV's tables are GNU-Octave formulas.
#: Ours are linear anchor interpolation, pinned by spec-freeze hash).
#: Each anchor is (position in [0,1], (R, G, B) in [0,1]).
# RGB anchors of the classic GNU-Octave/Matlab colormap FORMULAS (public
# closed forms, verified against OpenCV's output — see colormap_table for
# the construction that reproduces cv2's corner-flattening).
COLORMAP_ANCHORS = {
    "autumn": [(0.0, (1, 0, 0)), (1.0, (1, 1, 0))],
    "bone": [(0.0, (0, 0, 0)), (0.375, (0.3281, 0.3281, 0.4531)),
             (0.75, (0.6562, 0.7812, 0.7812)), (1.0, (1, 1, 1))],
    "cool": [(0.0, (0, 1, 1)), (1.0, (1, 0, 1))],
    "hot": [(0.0, (0, 0, 0)), (0.4, (1, 0, 0)), (0.8, (1, 1, 0)),
            (1.0, (1, 1, 1))],
    "hsv": [(0.0, (1, 0, 0)), (1 / 6, (1, 1, 0)), (2 / 6, (0, 1, 0)),
            (3 / 6, (0, 1, 1)), (4 / 6, (0, 0, 1)), (5 / 6, (1, 0, 1)),
            (1.0, (1, 0, 0))],
    "jet": [(0.0, (0, 0, 0.5)), (0.125, (0, 0, 1)), (0.375, (0, 1, 1)),
            (0.625, (1, 1, 0)), (0.875, (1, 0, 0)), (1.0, (0.5, 0, 0))],
    "ocean": [(0.0, (0, 0, 0)), (1 / 3, (0, 0, 1 / 3)),
              (2 / 3, (0, 0.5, 2 / 3)), (1.0, (1, 1, 1))],
    "rainbow": [(0.0, (1, 0, 0)), (0.4, (1, 1, 0)), (0.6, (0, 1, 0)),
                (0.8, (0, 0, 1)), (1.0, (2 / 3, 0, 1))],
    "spring": [(0.0, (1, 0, 1)), (1.0, (1, 1, 0))],
    "summer": [(0.0, (0, 0.5, 0.4)), (1.0, (1, 1, 0.4))],
    "winter": [(0.0, (0, 0, 1)), (1.0, (0, 1, 0.5))],
    "gray": [(0.0, (0, 0, 0)), (1.0, (1, 1, 1))],
    "pink": None,  # sqrt((2x + hot_matlab(x)) / 3) — built in colormap_table
}

#: Matplotlib-table maps that OpenCV ships verbatim (cv2's tables match
#: matplotlib's 256-entry data bit-for-bit; twilight pair within ±2 —
#: tests/test_cv2_shim.py). Kept out of COLORMAP_ANCHORS: they are data,
#: not formulas, and require matplotlib at call time.
COLORMAP_MPL = ("viridis", "turbo", "magma", "inferno", "plasma",
                "cividis", "twilight", "twilight_shifted")


def _colormap_rgb64(name: str) -> np.ndarray:
    """The 64-sample RGB curve (float in [0,1]) of colormap ``name`` —
    OpenCV builds its tables by sampling the Octave formula at n=64 and
    linearly interpolating to 256, which flattens corners that miss the
    64-grid; reproducing the construction reproduces its tables."""
    x = np.arange(64, dtype=np.float64) / 63.0
    if name == "pink":
        # matlab pink = sqrt((2·gray + hot)/3) with matlab hot
        # (breakpoints 3/8, 3/4)
        hot = np.stack([
            np.clip(8 * x / 3, 0, 1),
            np.clip(8 * (x - 3 / 8) / 3, 0, 1),
            np.clip(4 * (x - 3 / 4), 0, 1),
        ], axis=1)
        return np.sqrt((2 * x[:, None] + hot) / 3)
    anchors = COLORMAP_ANCHORS[name]
    xs = np.array([a[0] for a in anchors], np.float64)
    rgb = np.array([a[1] for a in anchors], np.float64)
    return np.stack([np.interp(x, xs, rgb[:, c]) for c in range(3)], axis=1)


def colormap_table(name: str) -> np.ndarray:
    """256×3 u8 **BGR** lookup table for colormap ``name``.

    Formula maps (:data:`COLORMAP_ANCHORS`): cv2's construction —
    64-sample the formula, lerp to 256, round half-away. Matches
    cv2.applyColorMap bit-for-bit for autumn/spring/cool/hsv/pink, ±1 LSB
    for the rest (cv2 rounds through float32). ``jet`` keeps the direct
    256-point anchor interpolation (±1 of cv2; the matlab jet(64) stepped
    construction differs from its continuous form by up to 3).
    Matplotlib-table maps (:data:`COLORMAP_MPL`): sampled from matplotlib
    (bit-identical to cv2 for the viridis family + turbo; twilight ±2)."""
    t = np.arange(256, dtype=np.float64) / 255.0
    if name in COLORMAP_MPL:
        try:
            from matplotlib import colormaps as _mpl_maps
        except Exception as e:  # pragma: no cover
            raise ValueError(
                f"colormap {name!r} needs matplotlib (not available)"
            ) from e
        out = np.asarray(_mpl_maps[name](t), np.float64)[:, :3]
    elif name == "jet":
        anchors = COLORMAP_ANCHORS[name]
        xs = np.array([a[0] for a in anchors], np.float64)
        rgb = np.array([a[1] for a in anchors], np.float64)
        out = np.stack([np.interp(t, xs, rgb[:, c]) for c in range(3)],
                       axis=1)
    elif name in COLORMAP_ANCHORS:
        v64 = _colormap_rgb64(name)
        pos = t * 63.0
        j = np.minimum(pos.astype(np.int64), 62)
        f = (pos - j)[:, None]
        out = v64[j] * (1 - f) + v64[j + 1] * f
    else:
        have = sorted(k for k in COLORMAP_ANCHORS) + sorted(COLORMAP_MPL)
        raise ValueError(f"unknown colormap {name!r} (have {have})")
    u8 = np.floor(out * 255.0 + 0.5).astype(np.uint8)
    return u8[:, ::-1].copy()  # RGB -> BGR table


def normalize_u8(img: np.ndarray, alpha: float = 0.0, beta: float = 255.0,
                 kind: str = "minmax") -> np.ndarray:
    """Frozen u8 normalize (OpenCV ``normalize`` role): ``minmax`` maps
    [min, max] → [alpha, beta] (flat image → alpha); ``inf``/``l1``/``l2``
    scale so the chosen norm equals ``alpha``. float64 math, round
    half-away, saturate to u8. Device twin is f32 — documented ±1 LSB."""
    a = img.astype(np.float64)
    if kind == "minmax":
        lo, hi = float(a.min()), float(a.max())
        scale = 0.0 if hi == lo else (beta - alpha) / (hi - lo)
        out = (a - lo) * scale + alpha
    elif kind in ("inf", "l1", "l2"):
        n = {
            "inf": np.abs(a).max(),
            "l1": np.abs(a).sum(),
            "l2": np.sqrt((a * a).sum()),
        }[kind]
        out = a * (0.0 if n == 0 else alpha / n)
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def bgr_to_lab(bgr: np.ndarray) -> np.ndarray:
    """Frozen CIE L*a*b* spec, u8 in/out (OpenCV 8-bit convention:
    L·255/100, a+128, b+128), float64: sRGB gamma linearization → XYZ
    (D65) → f(t) = t^(1/3) for t > (6/29)³ else t/(3·(6/29)²) + 4/29 →
    L = 116·fy − 16, a = 500(fx−fy), b = 200(fy−fz); round-half-even,
    clipped to u8."""
    srgb = bgr[..., ::-1].astype(np.float64) / 255.0
    lin = np.where(
        srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4, srgb / 12.92
    )
    xyz = lin @ _LAB_M.T
    d = 6.0 / 29.0
    t = xyz / np.array(_LAB_WHITE)
    f = np.where(t > d**3, np.cbrt(t), t / (3 * d * d) + 4.0 / 29.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    ell = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    out = np.stack(
        [np.round(ell * 255.0 / 100.0), np.round(a) + 128.0, np.round(b) + 128.0],
        axis=-1,
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def lab_to_bgr(lab: np.ndarray) -> np.ndarray:
    """Inverse of :func:`bgr_to_lab` (same frozen conventions)."""
    ell = lab[..., 0].astype(np.float64) * 100.0 / 255.0
    a = lab[..., 1].astype(np.float64) - 128.0
    b = lab[..., 2].astype(np.float64) - 128.0
    fy = (ell + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    d = 6.0 / 29.0

    def finv(f):
        return np.where(f > d, f**3, 3 * d * d * (f - 4.0 / 29.0))

    xyz = np.stack([finv(fx), finv(fy), finv(fz)], axis=-1) * np.array(_LAB_WHITE)
    lin = xyz @ np.linalg.inv(_LAB_M).T
    srgb = np.where(
        lin > 0.0031308, 1.055 * np.maximum(lin, 0.0) ** (1 / 2.4) - 0.055,
        12.92 * lin,
    )
    out = np.round(srgb[..., ::-1] * 255.0)
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_coeffs(src_size: int, dst_size: int):
    """Per-output-pixel (lo_index, weight_hi) tables of the bilinear
    resize: half-pixel centers fx = (dx + 0.5)·src/dst − 0.5, ix = floor(fx)
    clamped to [0, src−2], w_hi = round(frac·2048) from the clamped
    position."""
    dx = np.arange(dst_size, dtype=np.float64)
    fx = (dx + 0.5) * (src_size / dst_size) - 0.5
    ix = np.floor(fx).astype(np.int64)
    ix = np.clip(ix, 0, max(src_size - 2, 0))
    fx_clamped = np.minimum(fx, src_size - 1)
    frac = np.clip(fx_clamped - ix, 0.0, 1.0)
    w_hi = np.round(frac * RESIZE_ONE).astype(np.int32)
    return ix.astype(np.int32), w_hi


def resize_bilinear(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Fixed-point separable bilinear resize of (H, W, C) u8: unshifted
    11-bit horizontal sums, one rounding after the vertical pass,
    ``(Σ + 2^21) >> 22``."""
    src_h, src_w = img.shape[:2]
    x_lo, x_whi = resize_coeffs(src_w, dst_w)
    y_lo, y_whi = resize_coeffs(src_h, dst_h)
    x_hi = np.minimum(x_lo + 1, src_w - 1)
    y_hi = np.minimum(y_lo + 1, src_h - 1)

    a = img.astype(np.int32)
    tmp = a[:, x_lo] * (RESIZE_ONE - x_whi)[None, :, None] + a[:, x_hi] * x_whi[None, :, None]
    acc = (
        tmp[y_lo] * (RESIZE_ONE - y_whi)[:, None, None]
        + tmp[y_hi] * y_whi[:, None, None]
    )
    out = (acc + (1 << (2 * RESIZE_SHIFT - 1))) >> (2 * RESIZE_SHIFT)
    return np.clip(out, 0, 255).astype(np.uint8)


GAUSS5 = np.array([1, 4, 6, 4, 1], dtype=np.int32)  # per-axis, sum 16


def gaussian5_u8(img: np.ndarray) -> np.ndarray:
    """5×5 Gaussian ([1,4,6,4,1]⊗[1,4,6,4,1] / 256), replicate border,
    single final rounding (Σ + 128) >> 8. Works on (H,W) or (H,W,C) u8."""
    a = img.astype(np.int32)
    pad = [(2, 2), (2, 2)] + [(0, 0)] * (a.ndim - 2)
    p = np.pad(a, pad, mode="edge")
    h, w = img.shape[:2]
    tmp = sum(int(GAUSS5[k]) * p[:, k : k + w] for k in range(5))
    acc = sum(int(GAUSS5[k]) * tmp[k : k + h] for k in range(5))
    return ((acc + 128) >> 8).astype(np.uint8)


def pyr_down(img: np.ndarray) -> np.ndarray:
    """Pyramid downsample: :func:`gaussian5_u8` then even-index decimation
    (output ceil(H/2) × ceil(W/2), OpenCV's pyrDown shape)."""
    return gaussian5_u8(img)[::2, ::2]


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """Frozen integer BT.601 luma: (77R + 150G + 29B + 128) >> 8."""
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    return ((77 * r + 150 * g + 29 * b + 128) >> 8).astype(np.uint8)


# ---------------------------------------------------------------------------
# Kalman filter (float64 frozen spec)
# ---------------------------------------------------------------------------


def kalman_predict(x, P, A, Q, B=None, u=None):
    """Kalman time update (OpenCV ``KalmanFilter::predict`` semantics,
    modules/video/src/kalman.cpp): x' = A·x (+ B·u), P' = A·P·Aᵀ + Q.
    float64 frozen spec. Returns (x', P')."""
    x = np.asarray(x, np.float64)
    P = np.asarray(P, np.float64)
    A = np.asarray(A, np.float64)
    xp = A @ x
    if B is not None and u is not None:
        xp = xp + np.asarray(B, np.float64) @ np.asarray(u, np.float64)
    Pp = A @ P @ A.T + np.asarray(Q, np.float64)
    return xp, Pp


def kalman_correct(x, P, z, H, R):
    """Kalman measurement update (OpenCV ``KalmanFilter::correct``):
    S = H·P·Hᵀ + R, K = (solve(S, H·P))ᵀ, x⁺ = x + K(z − H·x),
    P⁺ = P − K·H·P. Returns (x⁺, P⁺, K)."""
    x = np.asarray(x, np.float64)
    P = np.asarray(P, np.float64)
    H = np.asarray(H, np.float64)
    HP = H @ P
    S = HP @ H.T + np.asarray(R, np.float64)
    K = np.linalg.solve(S, HP).T
    innov = np.asarray(z, np.float64) - H @ x
    return x + K @ innov, P - K @ HP, K


# ---------------------------------------------------------------------------
# MOSSE correlation-filter tracker (frozen float64 spec)
# ---------------------------------------------------------------------------
# OpenCV ``legacy::TrackerMOSSE`` role (Bolme et al. 2010). All arithmetic
# is float64 + numpy rfft2; the tensor twin (ops/tracker.py) is float32 and
# is bounded against this spec.

MOSSE_EPS = 1e-5
MOSSE_SIGMA = 2.0
#: Fixed init perturbations (angle_rad, scale) about the patch centre —
#: deterministic stand-ins for OpenCV's 8 random warps.
MOSSE_WARPS = (
    (0.0, 1.0), (0.05, 1.0), (-0.05, 1.0), (0.10, 1.0),
    (-0.10, 1.0), (0.18, 1.0), (0.0, 0.95), (0.0, 1.05),
)


def mosse_hann(h: int, w: int) -> np.ndarray:
    """Outer product of 1-D Hann windows (0.5 − 0.5·cos(2πk/(n−1));
    all-ones when an axis has a single sample)."""
    def hann1(n):
        if n == 1:
            return np.ones(1)
        k = np.arange(n, dtype=np.float64)
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))
    return np.outer(hann1(h), hann1(w))


def mosse_preprocess(patch: np.ndarray) -> np.ndarray:
    """log(1+p), zero-mean / unit-std normalize (ε=1e-5), Hann-windowed."""
    p = np.log1p(patch.astype(np.float64))
    p = (p - p.mean()) / (p.std() + MOSSE_EPS)
    return p * mosse_hann(*p.shape)


def mosse_gauss(h: int, w: int, sigma: float = MOSSE_SIGMA) -> np.ndarray:
    """Desired response: unit-peak Gaussian at (h//2, w//2)."""
    ys, xs = np.mgrid[0:h, 0:w]
    d2 = (ys - h // 2) ** 2.0 + (xs - w // 2) ** 2.0
    return np.exp(-d2 / (2.0 * sigma * sigma))


def _mosse_warp_patch(patch: np.ndarray, angle: float, scale: float) -> np.ndarray:
    """Rotate+scale the patch about its centre, clamped bilinear sampling
    (replicate border)."""
    h, w = patch.shape
    c, s = np.cos(angle) / scale, np.sin(angle) / scale
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = c * (xs - cx) + s * (ys - cy) + cx
    sy = -s * (xs - cx) + c * (ys - cy) + cy
    x0 = np.clip(np.floor(sx), 0, w - 1).astype(np.int64)
    y0 = np.clip(np.floor(sy), 0, h - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = np.clip(sx - x0, 0.0, 1.0)
    fy = np.clip(sy - y0, 0.0, 1.0)
    p = patch.astype(np.float64)
    top = p[y0, x0] * (1 - fx) + p[y0, x1] * fx
    bot = p[y1, x0] * (1 - fx) + p[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _mosse_crop(frame: np.ndarray, cy: int, cx: int, h: int, w: int):
    """Clamped h×w crop centred at (cy, cx); returns (patch, oy, ox)."""
    fh, fw = frame.shape
    oy = int(np.clip(cy - h // 2, 0, fh - h))
    ox = int(np.clip(cx - w // 2, 0, fw - w))
    return frame[oy:oy + h, ox:ox + w], oy, ox


def mosse_init(frame: np.ndarray, bbox):
    """Train the filter on the bbox patch over :data:`MOSSE_WARPS`.
    ``bbox`` = (x, y, w, h) ints. Returns state dict with complex A/B
    numerator/denominator spectra (rfft2 half-plane), the desired-response
    spectrum G, integer centre (cy, cx) and window (h, w)."""
    x, y, w, h = (int(v) for v in bbox)
    if h < 4 or w < 4:
        raise ValueError("MOSSE window must be at least 4x4")
    cy, cx = y + h // 2, x + w // 2
    patch, _, _ = _mosse_crop(np.asarray(frame, np.float64), cy, cx, h, w)
    G = np.fft.rfft2(mosse_gauss(h, w))
    A = np.zeros_like(G)
    B = np.zeros(G.shape, np.float64)
    for ang, sc in MOSSE_WARPS:
        F = np.fft.rfft2(mosse_preprocess(_mosse_warp_patch(patch, ang, sc)))
        A += G * np.conj(F)
        B += (F * np.conj(F)).real
    return {"A": A, "B": B, "G": G, "center": (cy, cx), "size": (h, w)}


def mosse_psr(resp: np.ndarray, py: int, px: int, excl: int = 5) -> float:
    """Peak-to-sidelobe ratio: peak vs mean/std outside the (2·excl+1)²
    exclusion square around the peak."""
    h, w = resp.shape
    mask = np.ones((h, w), bool)
    mask[max(py - excl, 0):py + excl + 1, max(px - excl, 0):px + excl + 1] = False
    side = resp[mask]
    return float((resp[py, px] - side.mean()) / (side.std() + MOSSE_EPS))


def mosse_step(state: dict, frame: np.ndarray, lr: float = 0.2,
               psr_threshold: float = 5.7):
    """One tracking step: correlate at the last centre, move to the
    response peak, compute PSR; when PSR clears the threshold, re-crop at
    the new centre and blend the filter with rate ``lr``. Returns
    (new_state, ok, psr). On failure the state (incl. centre) is frozen —
    OpenCV's legacy tracker likewise reports failure and stops adapting."""
    h, w = state["size"]
    cy, cx = state["center"]
    f64 = np.asarray(frame, np.float64)
    patch, oy, ox = _mosse_crop(f64, cy, cx, h, w)
    F = np.fft.rfft2(mosse_preprocess(patch))
    resp = np.fft.irfft2(F * state["A"] / (state["B"] + MOSSE_EPS), s=(h, w))
    py, px = np.unravel_index(int(resp.argmax()), resp.shape)
    psr = mosse_psr(resp, int(py), int(px))
    if psr < psr_threshold:
        return state, False, psr
    # displacement of the peak from the response origin (h//2, w//2),
    # re-anchored to the actual (clamped) crop origin
    ncy = oy + h // 2 + (int(py) - h // 2)
    ncx = ox + w // 2 + (int(px) - w // 2)
    fh, fw = f64.shape
    ncy = int(np.clip(ncy, h // 2, fh - h + h // 2))
    ncx = int(np.clip(ncx, w // 2, fw - w + w // 2))
    patch2, _, _ = _mosse_crop(f64, ncy, ncx, h, w)
    F2 = np.fft.rfft2(mosse_preprocess(patch2))
    A = lr * (state["G"] * np.conj(F2)) + (1.0 - lr) * state["A"]
    B = lr * (F2 * np.conj(F2)).real + (1.0 - lr) * state["B"]
    new = {"A": A, "B": B, "G": state["G"], "center": (ncy, ncx),
           "size": (h, w)}
    return new, True, psr


# ---------------------------------------------------------------------------
# Sobel, Canny and the stroke masks (rustcv_tpu/ops/golden.py:847-1049)
# ---------------------------------------------------------------------------


def line_mask(h: int, w: int, p1: tuple, p2: tuple, thickness: int = 1) -> np.ndarray:
    """Frozen line-stroke mask (exact int32-safe spec):

    - body: 0 ≤ dot(AP, AB) ≤ |AB|² and (2·|cross(AP, AB)|) // isqrt(|AB|²)
      ≤ thickness (the floored perpendicular-distance test);
    - caps: 4·|P−A|² ≤ t² or 4·|P−B|² ≤ t² (round endpoints);
    - degenerate (A == B): caps only.
    """
    ax, ay = int(p1[0]), int(p1[1])
    bx, by = int(p2[0]), int(p2[1])
    ys, xs = np.mgrid[0:h, 0:w]
    px = xs.astype(np.int64)
    py = ys.astype(np.int64)
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    ab2 = abx * abx + aby * aby
    t = int(thickness)
    t2 = t * t
    bpx, bpy = px - bx, py - by
    caps = (4 * (apx * apx + apy * apy) <= t2) | (4 * (bpx * bpx + bpy * bpy) <= t2)
    if ab2 == 0:
        return caps.astype(np.uint8) * 255
    s = int(np.floor(np.sqrt(ab2)))  # isqrt(|AB|²)
    dot = apx * abx + apy * aby
    cross = np.abs(apx * aby - apy * abx)
    body = (dot >= 0) & (dot <= ab2) & ((2 * cross) // s <= t)
    return ((body | caps).astype(np.uint8)) * 255


def circle_mask(h: int, w: int, center: tuple, radius: int, thickness: int = 1) -> np.ndarray:
    """Frozen circle mask: filled when thickness < 0 (|P−C|² ≤ R²), else a
    ring (2|P−C| within [2R−t, 2R+t], exact via squared comparisons)."""
    cx, cy = int(center[0]), int(center[1])
    r = int(radius)
    ys, xs = np.mgrid[0:h, 0:w]
    d2 = (xs.astype(np.int64) - cx) ** 2 + (ys.astype(np.int64) - cy) ** 2
    if thickness < 0:
        return (d2 <= r * r).astype(np.uint8) * 255
    t = int(thickness)
    lo = max(0, 2 * r - t)
    hi = 2 * r + t
    return ((4 * d2 >= lo * lo) & (4 * d2 <= hi * hi)).astype(np.uint8) * 255


def sobel3_gray(gray: np.ndarray):
    """Sobel 3×3 gx/gy on u8 gray, replicate border → int32 (range ±1020).
    gx = [[-1,0,1],[-2,0,2],[-1,0,1]], gy = gxᵀ (y increasing downward)."""
    a = gray.astype(np.int32)
    p = np.pad(a, 1, mode="edge")
    h, w = gray.shape
    smooth_v = p[0:h, :] + 2 * p[1:h + 1, :] + p[2:h + 2, :]
    diff_v = p[2:h + 2, :] - p[0:h, :]
    gx = smooth_v[:, 2:w + 2] - smooth_v[:, 0:w]
    gy = diff_v[:, 0:w] + 2 * diff_v[:, 1:w + 1] + diff_v[:, 2:w + 2]
    return gx, gy


def _isqrt(x: np.ndarray) -> np.ndarray:
    """Exact floor integer sqrt for x ≤ ~2.1e9."""
    s = np.sqrt(x.astype(np.float64)).astype(np.int64)
    s = np.where((s + 1) * (s + 1) <= x, s + 1, s)
    return np.where(s * s > x, s - 1, s)


def _dilate3(mask: np.ndarray) -> np.ndarray:
    """3×3 window maximum of a bool mask, replicate border."""
    p = np.pad(mask, 1, mode="edge")
    h, w = mask.shape
    out = np.zeros_like(mask)
    for dy in range(3):
        for dx in range(3):
            out |= p[dy:dy + h, dx:dx + w]
    return out


CANNY_HYST_ROUNDS = 16  # bounded 8-connected hysteresis propagation


def canny(gray_u8: np.ndarray, low: int = 40, high: int = 90) -> np.ndarray:
    """Canny edge detector, frozen integer spec: gray → Gaussian5 → Sobel →
    full-range isqrt magnitude → gradient-direction NMS with fixed-point
    sector quantization (tan 22.5° ≈ 27146/65536, tan 67.5° ≈
    158218/65536; out-of-image neighbours are 0; ties kept with ≥) →
    double threshold (strict >) → bounded hysteresis (CANNY_HYST_ROUNDS
    rounds of 3×3 dilation of the strong set masked by the weak set).
    Output: u8 mask (255/0)."""
    blurred = gaussian5_u8(gray_u8)
    gx, gy = sobel3_gray(blurred)
    mag = _isqrt(gx.astype(np.int64) ** 2 + gy.astype(np.int64) ** 2).astype(np.int32)

    a = np.abs(gx)
    b = np.abs(gy)
    sector0 = (b << 16) <= a * 27146
    sector2 = (b << 16) >= a * 158218
    diag_main = (~sector0) & (~sector2) & (gx * gy >= 0)
    diag_anti = (~sector0) & (~sector2) & (gx * gy < 0)

    h, w = mag.shape
    p = np.zeros((h + 2, w + 2), np.int32)
    p[1:-1, 1:-1] = mag

    def nb(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    n1 = np.where(sector0, nb(0, -1), 0)
    n2 = np.where(sector0, nb(0, 1), 0)
    n1 = np.where(sector2, nb(-1, 0), n1)
    n2 = np.where(sector2, nb(1, 0), n2)
    n1 = np.where(diag_main, nb(-1, -1), n1)
    n2 = np.where(diag_main, nb(1, 1), n2)
    n1 = np.where(diag_anti, nb(-1, 1), n1)
    n2 = np.where(diag_anti, nb(1, -1), n2)
    keep = (mag >= n1) & (mag >= n2)
    nms = np.where(keep, mag, 0)
    strong = nms > high
    weak = nms > low
    for _ in range(CANNY_HYST_ROUNDS):
        new_strong = strong | (weak & _dilate3(strong))
        if (new_strong == strong).all():
            strong = new_strong
            break
        strong = new_strong
    return (strong * 255).astype(np.uint8)
