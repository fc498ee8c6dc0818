"""cv2-exact u8 color conversions beyond the core set (r5).

Complements ops/color.py's bgr_to_gray_cv / bgr_to_hsv_cv /
bgr_to_lab_cv (full-cube exact) with the remaining cvtColor families
the facade lacked.  Every formula here was pinned EMPIRICALLY against
the installed OpenCV 5.0 (tests/test_color_cv2.py); exactness class is
stated per function:

  exact      — bit-exact on randomized sweeps
  ±1 LSB     — float-path knife edges (rate documented in the test)

The reference (RustCV) has only YUYV/BGRA/RGB↔BGR converters
(rustcv-camera/src/decode.rs:160-219); everything here exists for the
cv2 facade's drop-in contract.
"""
from __future__ import annotations

import numpy as np

F = np.float32

# ---------------------------------------------------------------- helpers


def _i64(img):
    return np.asarray(img).astype(np.int64)


def _sat(x):
    return np.clip(x, 0, 255).astype(np.uint8)


# ------------------------------------------------------------- 555 / 565

def bgr_to_packed16(img: np.ndarray, bits: int, rgb: bool = False
                    ) -> np.ndarray:
    """BGR/RGB/BGRA u8 -> BGR565 (bits=6) or BGR555 (bits=5) as
    (H, W, 2) u8 little-endian.  For 555 with a 4-channel source, bit
    15 = (alpha != 0) (measured: a=1 sets it, a=0 clears).  exact."""
    a = np.asarray(img)
    b, g, r = a[..., 0].astype(np.uint16), a[..., 1].astype(np.uint16), \
        a[..., 2].astype(np.uint16)
    if rgb:
        b, r = r, b
    if bits == 6:
        v = (b >> 3) | ((g >> 2) << 5) | ((r >> 3) << 11)
    else:
        v = (b >> 3) | ((g >> 3) << 5) | ((r >> 3) << 10)
        if a.shape[-1] == 4:
            v = v | ((a[..., 3] != 0).astype(np.uint16) << 15)
    return v[..., None].view(np.uint8).reshape(a.shape[:2] + (2,)).copy()


def packed16_to_bgr(img: np.ndarray, bits: int, rgb: bool = False,
                    alpha: bool = False) -> np.ndarray:
    """BGR565/555 (H, W, 2) u8 -> BGR/RGB(+A).  exact."""
    a = np.ascontiguousarray(img)
    v = a.view(np.uint16)[..., 0].astype(np.uint16)
    if bits == 6:
        b = (v << 3) & 0xF8
        g = (v >> 3) & 0xFC
        r = (v >> 8) & 0xF8
    else:
        b = (v << 3) & 0xF8
        g = (v >> 2) & 0xF8
        r = (v >> 7) & 0xF8
    if rgb:
        b, r = r, b
    if alpha:
        av = np.where(v & 0x8000, 255, 0).astype(np.uint16) if bits == 5 \
            else np.full_like(b, 255)
        ch = [b, g, r, av]
    else:
        ch = [b, g, r]
    return np.stack(ch, -1).astype(np.uint8)


def packed16_to_gray(img: np.ndarray, bits: int) -> np.ndarray:
    """BGR5x52GRAY: unpack then the 15-bit gray weights.  exact."""
    from .color import bgr_to_gray_cv
    return bgr_to_gray_cv(packed16_to_bgr(img, bits))


def gray_to_packed16(img: np.ndarray, bits: int) -> np.ndarray:
    g = np.asarray(img)
    if g.ndim == 3:
        g = g[..., 0]
    return bgr_to_packed16(np.stack([g, g, g], -1), bits)


# ------------------------------------------------------------------- XYZ

_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                 [0.212671, 0.715160, 0.072169],
                 [0.019334, 0.119193, 0.950227]])
_XYZ_I = np.rint(_XYZ * 4096).astype(np.int64)
_XYZ_INV_I = np.rint(np.linalg.inv(_XYZ) * 4096).astype(np.int64)


def bgr_to_xyz_cv(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """COLOR_BGR2XYZ u8: 12-bit fixed point.  exact."""
    a = _i64(img)
    b, g, r = a[..., 0], a[..., 1], a[..., 2]
    if rgb:
        b, r = r, b
    c = _XYZ_I
    out = [(r * c[k, 0] + g * c[k, 1] + b * c[k, 2] + 2048) >> 12
           for k in range(3)]
    return _sat(np.stack(out, -1))


def xyz_to_bgr_cv(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """COLOR_XYZ2BGR u8.  exact."""
    a = _i64(img)
    c = _XYZ_INV_I
    rgb_out = [(a[..., 0] * c[k, 0] + a[..., 1] * c[k, 1]
                + a[..., 2] * c[k, 2] + 2048) >> 12 for k in range(3)]
    r, g, b = rgb_out
    if rgb:
        b, r = r, b
    return _sat(np.stack([b, g, r], -1))


# ------------------------------------------------------- YUV (full range)

_YUV_SH = 14
_YUV_D = 1 << (_YUV_SH - 1)


def _c14(v):
    return int(np.rint(v * (1 << _YUV_SH)))


def bgr_to_yuv_cv(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """COLOR_BGR2YUV u8 (full-range, Y Cb Cr order as Y U V).  exact."""
    a = _i64(img)
    b, g, r = a[..., 0], a[..., 1], a[..., 2]
    if rgb:
        b, r = r, b
    y = (r * 4899 + g * 9617 + b * 1868 + _YUV_D) >> _YUV_SH
    u = ((b - y) * _c14(0.492) + (128 << _YUV_SH) + _YUV_D) >> _YUV_SH
    v = ((r - y) * _c14(0.877) + (128 << _YUV_SH) + _YUV_D) >> _YUV_SH
    return _sat(np.stack([y, u, v], -1))


def yuv_to_bgr_cv(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """COLOR_YUV2BGR u8 (published 2.032/-0.395/-0.581/1.140).  exact."""
    a = _i64(img)
    y, u, v = a[..., 0], a[..., 1] - 128, a[..., 2] - 128
    b = ((y << _YUV_SH) + _c14(2.032) * u + _YUV_D) >> _YUV_SH
    g = ((y << _YUV_SH) + _c14(-0.581) * v + _c14(-0.395) * u
         + _YUV_D) >> _YUV_SH
    r = ((y << _YUV_SH) + _c14(1.140) * v + _YUV_D) >> _YUV_SH
    if rgb:
        b, r = r, b
    return _sat(np.stack([b, g, r], -1))


# -------------------------------------------------------------- HSV FULL

def bgr_to_hsv_full_cv(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """COLOR_BGR2HSV_FULL u8: hdiv table with 256 range.  exact."""
    a = _i64(img)
    b, g, r = a[..., 0], a[..., 1], a[..., 2]
    if rgb:
        b, r = r, b
    v = np.maximum(b, np.maximum(g, r))
    diff = v - np.minimum(b, np.minimum(g, r))
    i = np.arange(256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << 12) / i[1:]).astype(np.int64)
    hdiv = np.zeros(256, np.int64)
    hdiv[1:] = np.rint((256 << 12) / (6.0 * i[1:])).astype(np.int64)
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 256, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_bgr_full_cv(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """COLOR_HSV2BGR_FULL u8: f32 sector math, h scale 6/255.  exact."""
    h = np.asarray(img)[..., 0].astype(np.float32) * F(6.0 / 255)
    s = np.asarray(img)[..., 1].astype(np.float32) * F(1 / 255)
    v = np.asarray(img)[..., 2].astype(np.float32) * F(1 / 255)
    sector = np.floor(h).astype(np.int64)
    frac = (h - sector).astype(np.float32)
    p = v * (F(1) - s)
    q = v * (F(1) - s * frac)
    t = v * (F(1) - s * (F(1) - frac))
    sec = np.mod(sector, 6)
    tabb = [p, p, t, v, v, q]
    tabg = [t, v, v, q, p, p]
    tabr = [v, q, p, p, t, v]
    b = np.select([sec == k for k in range(6)], tabb)
    g = np.select([sec == k for k in range(6)], tabg)
    r = np.select([sec == k for k in range(6)], tabr)
    if rgb:
        b, r = r, b
    return _sat(np.rint(np.stack([b, g, r], -1) * F(255)))


# ------------------------------------------------------------------- HLS

def _hls_core_f32(img, rgb):
    bf = np.asarray(img)[..., 0].astype(np.float32) * F(1 / 255)
    gf = np.asarray(img)[..., 1].astype(np.float32) * F(1 / 255)
    rf = np.asarray(img)[..., 2].astype(np.float32) * F(1 / 255)
    if rgb:
        bf, rf = rf, bf
    mx = np.maximum(bf, np.maximum(gf, rf))
    mn = np.minimum(bf, np.minimum(gf, rf))
    msum = mx + mn
    lum = msum * F(0.5)
    diff = mx - mn
    den = np.where(lum < F(0.5), msum, F(2) - msum)
    s = np.where(diff > F(0), diff / np.maximum(den, F(1e-30)), F(0))
    dsafe = np.where(diff > F(0), diff, F(1))
    # cv2's ordering: sector offset in units of 1, THEN *60 (pins the
    # 110.99999-vs-111.0 knife edges)
    h = np.where(mx == rf, (gf - bf) / dsafe,
                 np.where(mx == gf, F(2) + (bf - rf) / dsafe,
                          F(4) + (rf - gf) / dsafe)).astype(np.float32)
    h = (h * F(60)).astype(np.float32)
    h = np.where(h < 0, h + F(360), h)
    h = np.where(diff > F(0), h, F(0))
    return h, lum, s


def bgr_to_hls_cv(img: np.ndarray, rgb: bool = False,
                  full: bool = False) -> np.ndarray:
    """COLOR_BGR2HLS u8: f32 float path.  Plain (180): ±1 LSB on
    ~2.6e-4 of pixels; FULL (256): ±1 LSB on ~1.2% of the h channel
    (cv2 5's FULL kernel rounds its fixed point differently)."""
    h, lum, s = _hls_core_f32(img, rgb)
    hs = F(255 / 360) if full else F(0.5)
    out = np.stack([np.rint(h * hs), np.rint(lum * F(255)),
                    np.rint(s * F(255))], -1)
    return _sat(out)


def hls_to_bgr_cv(img: np.ndarray, rgb: bool = False,
                  full: bool = False) -> np.ndarray:
    """COLOR_HLS2BGR u8: f32 hue2rgb path.  Plain: exact on randomized
    sweeps; FULL: h scale 360/255 (±1 LSB documented in test)."""
    a = np.asarray(img)
    h = a[..., 0].astype(np.float32) * (F(360 / 255) if full else F(2))
    lum = a[..., 1].astype(np.float32) * F(1 / 255)
    s = a[..., 2].astype(np.float32) * F(1 / 255)
    p2 = np.where(lum <= F(0.5), lum * (F(1) + s),
                  lum + s - lum * s).astype(np.float32)
    p1 = (F(2) * lum - p2).astype(np.float32)

    def hue2rgb(t):
        t = np.where(t < 0, t + F(360),
                     np.where(t >= F(360), t - F(360), t)).astype(
            np.float32)
        return np.where(
            t < F(60), p1 + (p2 - p1) * t * F(1 / 60),
            np.where(t < F(180), p2,
                     np.where(t < F(240),
                              p1 + (p2 - p1) * (F(240) - t) * F(1 / 60),
                              p1))).astype(np.float32)

    r = hue2rgb(h + F(120))
    g = hue2rgb(h)
    b = hue2rgb(h - F(120))
    gray = s == 0
    r = np.where(gray, lum, r)
    g = np.where(gray, lum, g)
    b = np.where(gray, lum, b)
    if rgb:
        b, r = r, b
    return _sat(np.rint(np.stack([b, g, r], -1) * F(255)))


# ------------------------------------------------------------------- Luv

def bgr_to_luv_cv(img: np.ndarray, rgb: bool = False,
                  srgb: bool = True) -> np.ndarray:
    """COLOR_BGR2Luv u8 via float math (D65, CIE L*u*v*).  ±1 LSB vs
    cv2's trilinear-LUT path on ~17% of pixels (documented).  srgb=False
    gives the LBGR2Luv (linear-RGB) variant."""
    x = np.asarray(img).astype(np.float64) / 255.0
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    if rgb:
        b, r = r, b
    if srgb:
        def gam(c):
            return np.where(c <= 0.04045, c / 12.92,
                            ((c + 0.055) / 1.055) ** 2.4)
        r, g, b = gam(r), gam(g), gam(b)
    X = 0.412453 * r + 0.357580 * g + 0.180423 * b
    Y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    Z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    L = np.where(Y > 0.008856, 116 * np.cbrt(Y) - 16, 903.3 * Y)
    d = X + 15 * Y + 3 * Z
    u_ = 4 * X / np.maximum(d, 1e-30)
    v_ = 9 * Y / np.maximum(d, 1e-30)
    un, vn = 0.19793943, 0.46831096
    u = 13 * L * (u_ - un)
    v = 13 * L * (v_ - vn)
    out = np.stack([np.rint(L * 255 / 100), np.rint((u + 134) * 255 / 354),
                    np.rint((v + 140) * 255 / 262)], -1)
    return _sat(out)


def luv_to_bgr_cv(img: np.ndarray, rgb: bool = False,
                  srgb: bool = True) -> np.ndarray:
    """COLOR_Luv2BGR u8 inverse (±1-2 LSB, documented)."""
    a = np.asarray(img).astype(np.float64)
    L = a[..., 0] * (100.0 / 255)
    u = a[..., 1] * (354.0 / 255) - 134
    v = a[..., 2] * (262.0 / 255) - 140
    Y = np.where(L > 8.0, ((L + 16) / 116) ** 3, L / 903.3)
    un, vn = 0.19793943, 0.46831096
    Ls = np.maximum(13 * L, 1e-30)
    u_ = u / Ls + un
    v_ = v / Ls + vn
    X = 2.25 * u_ * Y / np.maximum(v_, 1e-30)
    Z = (12 - 3 * u_ - 20 * v_) * Y / np.maximum(4 * v_, 1e-30)
    M = np.linalg.inv(_XYZ)
    r = M[0, 0] * X + M[0, 1] * Y + M[0, 2] * Z
    g = M[1, 0] * X + M[1, 1] * Y + M[1, 2] * Z
    b = M[2, 0] * X + M[2, 1] * Y + M[2, 2] * Z
    if srgb:
        def igam(c):
            c = np.clip(c, 0, 1)
            return np.where(c <= 0.0031308, c * 12.92,
                            1.055 * c ** (1 / 2.4) - 0.055)
        r, g, b = igam(r), igam(g), igam(b)
    if rgb:
        b, r = r, b
    return _sat(np.rint(np.stack([b, g, r], -1) * 255))


def bgr_to_lab_linear_cv(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """COLOR_LBGR2Lab u8: the Lab table path with a LINEAR gamma table
    (gtab[i] = i*8).  exact (same structure as ops/color.bgr_to_lab_cv,
    which is full-cube exact for the sRGB variant)."""
    from .color import _CV_LAB_CTAB, _CV_LAB_COEF
    a = _i64(img)
    b, g, r = a[..., 0], a[..., 1], a[..., 2]
    if rgb:
        b, r = r, b
    rr, gg, bb = r * 8, g * 8, b * 8
    c = _CV_LAB_COEF

    def desc(v, n):
        return (v + (1 << (n - 1))) >> n

    f_x = _CV_LAB_CTAB[desc(rr * c[0, 0] + gg * c[0, 1] + bb * c[0, 2], 12)]
    f_y = _CV_LAB_CTAB[desc(rr * c[1, 0] + gg * c[1, 1] + bb * c[1, 2], 12)]
    f_z = _CV_LAB_CTAB[desc(rr * c[2, 0] + gg * c[2, 1] + bb * c[2, 2], 12)]
    lum = desc(296 * f_y - 1336934, 15)
    av = desc(500 * (f_x - f_y) + (128 << 15), 15)
    bv = desc(200 * (f_y - f_z) + (128 << 15), 15)
    return _sat(np.stack([lum, av, bv], -1))


# ----------------------------------------------- YUV 4:2:0 (ITU-R fixed)

_ITUR = dict(CY=1220542, CUB=2116026, CUG=-409993, CVG=-852492,
             CVR=1673527, SH=20)


def yuv420_to_bgr_cv(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     rgb: bool = False, alpha: bool = False) -> np.ndarray:
    """Planar/semiplanar 4:2:0 -> BGR with OpenCV's 20-bit ITU-R BT.601
    path.  ``u``/``v`` are (H/2, W/2) planes.  exact (incl. NV12/NV21
    via the caller splitting interleaved chroma)."""
    t = _ITUR
    y = _i64(y)
    uu = _i64(u).repeat(2, 0).repeat(2, 1) - 128
    vv = _i64(v).repeat(2, 0).repeat(2, 1) - 128
    half = 1 << (t["SH"] - 1)
    ruv = half + t["CVR"] * vv
    guv = half + t["CVG"] * vv + t["CUG"] * uu
    buv = half + t["CUB"] * uu
    yy = np.maximum(0, y - 16) * t["CY"]
    b = np.clip((yy + buv) >> t["SH"], 0, 255)
    g = np.clip((yy + guv) >> t["SH"], 0, 255)
    r = np.clip((yy + ruv) >> t["SH"], 0, 255)
    if rgb:
        b, r = r, b
    ch = [b, g, r] + ([np.full_like(b, 255)] if alpha else [])
    return np.stack(ch, -1).astype(np.uint8)


def split_420_buffer(buf: np.ndarray, kind: str):
    """Single (H*3/2, W) u8 buffer -> (y, u, v) planes.
    kind: nv12 | nv21 | i420 | yv12."""
    a = np.asarray(buf)
    if a.ndim == 3:
        a = a[..., 0]
    h = a.shape[0] * 2 // 3
    w = a.shape[1]
    y = a[:h]
    rest = a[h:]
    if kind in ("nv12", "nv21"):
        uv = rest.reshape(h // 2, w // 2, 2)
        u, v = uv[..., 0], uv[..., 1]
        if kind == "nv21":
            u, v = v, u
    else:
        planes = rest.reshape(-1)
        q = (h // 2) * (w // 2)
        p0 = planes[:q].reshape(h // 2, w // 2)
        p1 = planes[q:2 * q].reshape(h // 2, w // 2)
        u, v = (p0, p1) if kind == "i420" else (p1, p0)
    return y, u, v


_FWD20 = dict(CRY=269484, CGY=528482, CBY=102760,
              CRU=-155188, CGU=-305135, CBU=460324,
              CRV=460324, CGV=-385875, CBV=-74448, SH=20)


def bgr_to_yuv420_cv(img: np.ndarray, kind: str,
                     rgb: bool = False) -> np.ndarray:
    """BGR2YUV_I420/YV12 (single (H*3/2, W) buffer), 20-bit ITU-R
    forward, chroma from the top-left pixel of each 2x2.  exact."""
    a = _i64(img)
    b, g, r = a[..., 0], a[..., 1], a[..., 2]
    if rgb:
        b, r = r, b
    t = _FWD20
    half = 1 << (t["SH"] - 1)
    y = np.clip(((r * t["CRY"] + g * t["CGY"] + b * t["CBY"] + half)
                 >> t["SH"]) + 16, 0, 255)
    rs, gs, bs = r[0::2, 0::2], g[0::2, 0::2], b[0::2, 0::2]
    u = np.clip(((rs * t["CRU"] + gs * t["CGU"] + bs * t["CBU"] + half)
                 >> t["SH"]) + 128, 0, 255)
    v = np.clip(((rs * t["CRV"] + gs * t["CGV"] + bs * t["CBV"] + half)
                 >> t["SH"]) + 128, 0, 255)
    h, w = y.shape
    out = np.empty((h * 3 // 2, w), np.uint8)
    out[:h] = y
    q = (h // 2) * (w // 2)
    flat = out[h:].reshape(-1)
    first, second = (u, v) if kind == "i420" else (v, u)
    flat[:q] = first.reshape(-1)
    flat[q:2 * q] = second.reshape(-1)
    return out


# ----------------------------------------------- YUV 4:2:2 (ITU-R fixed)

def yuv422_to_bgr_cv(buf: np.ndarray, kind: str, rgb: bool = False,
                     alpha: bool = False) -> np.ndarray:
    """YUY2/YVYU/UYVY (H, W, 2) -> BGR, same 20-bit ITU-R path as
    4:2:0 but chroma shared along x only.  exact."""
    a = np.asarray(buf)
    if kind == "uyvy":
        y = a[..., 1]
        u = a[:, 0::2, 0]
        v = a[:, 1::2, 0]
    else:
        y = a[..., 0]
        u = a[:, 0::2, 1]
        v = a[:, 1::2, 1]
        if kind == "yvyu":
            u, v = v, u
    t = _ITUR
    y = _i64(y)
    uu = _i64(u).repeat(2, 1) - 128
    vv = _i64(v).repeat(2, 1) - 128
    half = 1 << (t["SH"] - 1)
    ruv = half + t["CVR"] * vv
    guv = half + t["CVG"] * vv + t["CUG"] * uu
    buv = half + t["CUB"] * uu
    yy = np.maximum(0, y - 16) * t["CY"]
    b = np.clip((yy + buv) >> t["SH"], 0, 255)
    g = np.clip((yy + guv) >> t["SH"], 0, 255)
    r = np.clip((yy + ruv) >> t["SH"], 0, 255)
    if rgb:
        b, r = r, b
    ch = [b, g, r] + ([np.full_like(b, 255)] if alpha else [])
    return np.stack(ch, -1).astype(np.uint8)


def bgr_to_yuv422_cv(img: np.ndarray, kind: str,
                     rgb: bool = False) -> np.ndarray:
    """BGR2YUV_YUY2/YVYU/UYVY: 14-bit fixed point, pair chroma averaged
    on the RAW (pre-descale) sums.  ±1 LSB on <0.5% of chroma (f32
    knife edges in cv2's SIMD path, documented)."""
    a = _i64(img)
    b, g, r = a[..., 0], a[..., 1], a[..., 2]
    if rgb:
        b, r = r, b
    sh = 14
    half = 1 << (sh - 1)

    def c(x):
        return int(np.rint(x * (1 << sh)))

    y = np.clip(((r * c(0.257) + g * c(0.504) + b * c(0.098) + half)
                 >> sh) + 16, 0, 255)
    raw_u = r * c(-0.148) + g * c(-0.291) + b * c(0.439)
    raw_v = r * c(0.439) + g * c(-0.368) + b * c(-0.071)
    u = np.clip(((raw_u[:, 0::2] + raw_u[:, 1::2] + (1 << sh))
                 >> (sh + 1)) + 128, 0, 255)
    v = np.clip(((raw_v[:, 0::2] + raw_v[:, 1::2] + (1 << sh))
                 >> (sh + 1)) + 128, 0, 255)
    h, w = y.shape
    out = np.empty((h, w, 2), np.uint8)
    if kind == "uyvy":
        out[..., 1] = y
        out[:, 0::2, 0] = u
        out[:, 1::2, 0] = v
    else:
        out[..., 0] = y
        if kind == "yvyu":
            u, v = v, u
        out[:, 0::2, 1] = u
        out[:, 1::2, 1] = v
    return out


def yuv420_to_gray_cv(buf: np.ndarray) -> np.ndarray:
    """YUV2GRAY_420: just the Y plane.  exact."""
    a = np.asarray(buf)
    if a.ndim == 3:
        a = a[..., 0]
    return a[: a.shape[0] * 2 // 3].copy()


def yuv422_to_gray_cv(buf: np.ndarray, kind: str) -> np.ndarray:
    """YUV2GRAY_YUY2/UYVY: the luma bytes.  exact."""
    a = np.asarray(buf)
    return (a[..., 1] if kind == "uyvy" else a[..., 0]).copy()
