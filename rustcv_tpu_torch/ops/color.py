"""Colour conversions (port of ``rustcv_tpu.ops.color``): every staged wire
format to BGR and the packed-BGR helpers, bit-exact with the reference's
integer BT.601, luma and Bayer demosaic; HSV and YCrCb both ways
(bit-exact), Lab both ways (float32, within ±1 LSB of the float64 spec),
range masks and exact moments; the decode with the rectangle overlay on
the pixel pairs (``RUSTCV_DECODE=xla_fused``); and the host numpy forms
``*_cv`` that reproduce OpenCV's own fixed-point tables.

All arithmetic is int32. Each converter reads its bytes through a u8 view
(a YUYV word as ``(..., H, W/2, 4)``, an NV12 luma pair as ``(..., H, W/2,
2)``, a BGRA pixel as ``(..., H, W, 4)``) widened to int32, where the
reference bitcasts u8 groups into u16/u32 words (torch has little unsigned
word arithmetic, so nothing is bitcast), and the byte interleave into packed
rows is a plain ``stack(..., -1).reshape``. The reference's word tricks need
the width to be a multiple of 4 in places; these forms take any width the
format allows, and their values are the same.

Packed rows ``(..., H, W*3)`` is the BGR layout of the whole pipeline: the
bytes of an interleaved ``(H, W, 3)`` image, one row per image row. Each
``*_to_bgr_packed`` has a ``*_to_bgr`` twin returning that (..., H, W, 3)
view. The inputs are flat ``(..., frame bytes)`` or rows ``(..., H, row
bytes)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .golden import _LAB_M, _LAB_WHITE, BAYER_PATTERNS

_LAB_MINV = np.linalg.inv(_LAB_M)  # XYZ → linear sRGB


def _batch(src: torch.Tensor, frame_bytes: int):
    """The batch dims of ``src``: all but a last axis of ``frame_bytes``,
    else all but the last two (rows)."""
    return src.shape[:-1] if src.shape[-1] == frame_bytes else src.shape[:-2]


def _unpack_yuyv_words(src: torch.Tensor, width: int, height: int):
    """YUYV bytes, flat ``(..., H*W*2)`` or ``(..., H, W*2)`` → int32 planes
    (..., H, W/2): y0, u, y1, v."""
    batch = _batch(src, height * width * 2)
    q = src.reshape(*batch, height, width // 2, 4).to(torch.int32)
    return q[..., 0], q[..., 1], q[..., 2], q[..., 3]


def _bt601_pair(y0, y1, u, v):
    """BT.601 for a YUYV pair in plane form → six int32 planes
    (b0, g0, r0, b1, g1, r1), each clamped to [0, 255]."""
    c0 = 298 * (y0 - 16)
    c1 = 298 * (y1 - 16)
    d = u - 128
    e = v - 128
    tb = 516 * d + 128
    tg = -100 * d - 208 * e + 128
    tr = 409 * e + 128

    def cl(x):
        return (x >> 8).clamp(0, 255)

    return cl(c0 + tb), cl(c0 + tg), cl(c0 + tr), cl(c1 + tb), cl(c1 + tg), cl(c1 + tr)


def _interleave_pair_bgr(b0, g0, r0, b1, g1, r1, width: int, height: int):
    """Pair planes (..., H, W/2) → packed rows u8 (..., H, W*3)."""
    batch = b0.shape[:-2]
    packed = torch.stack([b0, g0, r0, b1, g1, r1], dim=-1).to(torch.uint8)
    return packed.reshape(*batch, height, width * 3)


def _pack_gray_pairs(gr0, gr1, width: int, height: int):
    """Per-pair luma planes (..., H, W/2) → gray u8 (..., H, W)."""
    batch = gr0.shape[:-2]
    return torch.stack([gr0, gr1], dim=-1).to(torch.uint8).reshape(*batch, height, width)


def yuyv_to_bgr_packed(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """YUYV → packed-rows BGR u8 (..., H, W*3)."""
    y0, u, y1, v = _unpack_yuyv_words(src, width, height)
    return _interleave_pair_bgr(*_bt601_pair(y0, y1, u, v), width, height)


def yuyv_to_gray(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """YUYV → gray u8 (..., H, W), equal to the luma of
    :func:`yuyv_to_bgr_packed` without making the BGR image."""
    y0, u, y1, v = _unpack_yuyv_words(src, width, height)
    return _pair_gray(y0, y1, u, v, width, height)


def _luma(r, g, b):
    """The frozen integer luma (77R + 150G + 29B + 128) >> 8 on int32."""
    return (77 * r + 150 * g + 29 * b + 128) >> 8


def _pair_gray(y0, y1, u, v, width: int, height: int):
    """Gray u8 (..., H, W) of pair planes: the luma of their BGR."""
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    return _pack_gray_pairs(_luma(r0, g0, b0), _luma(r1, g1, b1), width, height)


def yuyv_to_bgr(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """YUYV → BGR u8 (..., H, W, 3)."""
    return _hwc(yuyv_to_bgr_packed(src, width, height), width, height)


# -- UYVY (packed 4:2:2, chroma first) ----------------------------------------


def _unpack_uyvy_words(src: torch.Tensor, width: int, height: int):
    """UYVY bytes U Y0 V Y1 → int32 planes (..., H, W/2): y0, u, y1, v."""
    q = src.reshape(*_batch(src, height * width * 2), height, width // 2, 4).to(torch.int32)
    return q[..., 1], q[..., 0], q[..., 3], q[..., 2]


def uyvy_to_bgr_packed(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """UYVY → packed-rows BGR u8 (..., H, W*3)."""
    y0, u, y1, v = _unpack_uyvy_words(src, width, height)
    return _interleave_pair_bgr(*_bt601_pair(y0, y1, u, v), width, height)


def uyvy_to_bgr(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return _hwc(uyvy_to_bgr_packed(src, width, height), width, height)


def uyvy_to_gray(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """UYVY → gray u8 (..., H, W), the luma of :func:`uyvy_to_bgr_packed`."""
    y0, u, y1, v = _unpack_uyvy_words(src, width, height)
    return _pair_gray(y0, y1, u, v, width, height)


# -- NV12 and YV12 (planar 4:2:0) ----------------------------------------------


def _planar_420(src: torch.Tensor, width: int, height: int):
    """The Y plane's pixel pairs (..., H, W/2, 2) int32 and the flat chroma
    bytes (..., H*W/2) of a 4:2:0 frame."""
    npix = width * height
    flat = src.reshape(*_batch(src, npix * 3 // 2), npix * 3 // 2)
    y = flat[..., :npix].reshape(*flat.shape[:-1], height, width // 2, 2).to(torch.int32)
    return y, flat[..., npix:]


def _rows2(c: torch.Tensor) -> torch.Tensor:
    """Half-height chroma (..., H/2, W/2) → one row per image row."""
    return c.repeat_interleave(2, dim=-2)


def _unpack_nv12_pairs(src: torch.Tensor, width: int, height: int):
    """NV12 (Y plane, then interleaved U V at 2×2 sites) → pair planes
    (..., H, W/2) int32: y0, y1, u, v. Chroma column k is pixel pair k."""
    y, chroma = _planar_420(src, width, height)
    uv = chroma.reshape(*chroma.shape[:-1], height // 2, width // 2, 2).to(torch.int32)
    return y[..., 0], y[..., 1], _rows2(uv[..., 0]), _rows2(uv[..., 1])


def _unpack_yv12_pairs(src: torch.Tensor, width: int, height: int):
    """YV12 (Y plane, then the V plane, then the U plane) → pair planes
    (..., H, W/2) int32: y0, y1, u, v."""
    y, chroma = _planar_420(src, width, height)
    planes = chroma.reshape(*chroma.shape[:-1], 2, height // 2, width // 2).to(torch.int32)
    return y[..., 0], y[..., 1], _rows2(planes[..., 1, :, :]), _rows2(planes[..., 0, :, :])


def nv12_to_bgr_packed(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """NV12 → packed-rows BGR u8 (..., H, W*3)."""
    y0, y1, u, v = _unpack_nv12_pairs(src, width, height)
    return _interleave_pair_bgr(*_bt601_pair(y0, y1, u, v), width, height)


def nv12_to_bgr(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return _hwc(nv12_to_bgr_packed(src, width, height), width, height)


def nv12_to_gray(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """NV12 → gray u8 (..., H, W): the luma of the BGR, not the stored Y."""
    return _pair_gray(*_unpack_nv12_pairs(src, width, height), width, height)


def yv12_to_bgr_packed(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """YV12 → packed-rows BGR u8 (..., H, W*3)."""
    y0, y1, u, v = _unpack_yv12_pairs(src, width, height)
    return _interleave_pair_bgr(*_bt601_pair(y0, y1, u, v), width, height)


def yv12_to_bgr(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return _hwc(yv12_to_bgr_packed(src, width, height), width, height)


def yv12_to_gray(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """YV12 → gray u8 (..., H, W): the luma of the BGR."""
    return _pair_gray(*_unpack_yv12_pairs(src, width, height), width, height)


# -- 32- and 24-bit RGB orders -------------------------------------------------


def _pixels(src: torch.Tensor, width: int, height: int, channels: int) -> torch.Tensor:
    """Interleaved pixels (..., H, W, channels) u8 of a flat or row frame."""
    return src.reshape(*_batch(src, height * width * channels), height, width, channels)


def bgra_to_bgr_packed(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """BGRA32 → packed-rows BGR u8 (..., H, W*3): the alpha byte dropped."""
    px = _pixels(src, width, height, 4)[..., :3]
    return px.reshape(*px.shape[:-3], height, width * 3)


def bgra_to_bgr(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return _hwc(bgra_to_bgr_packed(src, width, height), width, height)


def rgba_to_bgr(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """RGBA32 → BGR u8 (..., H, W, 3)."""
    return _pixels(src, width, height, 4)[..., [2, 1, 0]]


def rgb_to_bgr_packed(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """RGB24 → packed-rows BGR u8 (..., H, W*3): R and B swapped."""
    px = _pixels(src, width, height, 3).flip(-1)
    return px.reshape(*px.shape[:-3], height, width * 3)


def rgb_to_bgr(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    return _hwc(rgb_to_bgr_packed(src, width, height), width, height)


def rgb_to_gray_packed_rows(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Packed RGB rows → gray u8 (..., H, W), equal to the luma of
    :func:`rgb_to_bgr_packed`."""
    q = _pixels(src, width, height, 3).to(torch.int32)
    return _luma(q[..., 0], q[..., 1], q[..., 2]).to(torch.uint8)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """BGR (..., 3) u8 → gray u8, the frozen integer luma."""
    q = bgr.to(torch.int32)
    return _luma(q[..., 2], q[..., 1], q[..., 0]).to(torch.uint8)


# -- Bayer ---------------------------------------------------------------------


def _reflect_shift(a: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """``a`` at index i + d (d = ±1) along ``dim``, mirrored about the edge
    pixel (reflect-101: index -1 reads 1, index n reads n - 2)."""
    n = a.shape[dim]
    if d < 0:
        return torch.cat([a.narrow(dim, 1, 1), a.narrow(dim, 0, n - 1)], dim)
    return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 2, 1)], dim)


def demosaic_bilinear(raw: torch.Tensor, pattern: str, width: int, height: int) -> torch.Tensor:
    """Integer bilinear Bayer demosaic → BGR u8 (..., H, W, 3), the frozen
    spec ``golden.demosaic_bilinear``: at each site the missing channels are
    the rounded means of their 2 or 4 nearest samples (avg2 = (a+b+1)>>1,
    avg4 = (Σ+2)>>2), borders mirrored (reflect-101 keeps each site's
    colour). ``raw`` u8, flat (..., H*W) or (..., H, W); H, W >= 2."""
    if width < 2 or height < 2:
        raise ValueError(f"the Bayer demosaic needs H, W >= 2, got {width}x{height}")
    spec = BAYER_PATTERNS[pattern]
    a = raw.reshape(*_batch(raw, height * width), height, width).to(torch.int32)
    up, down = _reflect_shift(a, -1, -2), _reflect_shift(a, 1, -2)
    left, right = _reflect_shift(a, -1, -1), _reflect_shift(a, 1, -1)
    horiz = left + right
    vert = up + down
    diag = (_reflect_shift(up, -1, -1) + _reflect_shift(up, 1, -1)
            + _reflect_shift(down, -1, -1) + _reflect_shift(down, 1, -1))
    g4 = (horiz + vert + 2) >> 2
    h2 = (horiz + 1) >> 1
    v2 = (vert + 1) >> 1
    d4 = (diag + 2) >> 2

    ys = torch.arange(height, device=raw.device).reshape(height, 1) % 2
    xs = torch.arange(width, device=raw.device).reshape(1, width) % 2
    mr = (ys == spec["r"][0]) & (xs == spec["r"][1])
    mb = (ys == spec["b"][0]) & (xs == spec["b"][1])
    g_red_row = ~mr & ~mb & (ys == spec["r"][0])
    g_blue_row = ~mr & ~mb & (ys == spec["b"][0])
    r = torch.where(mr, a, torch.where(g_red_row, h2, torch.where(g_blue_row, v2, d4)))
    b = torch.where(mb, a, torch.where(g_blue_row, h2, torch.where(g_red_row, v2, d4)))
    g = torch.where(mr | mb, g4, a)
    return torch.stack([b, g, r], dim=-1).clamp(0, 255).to(torch.uint8)


def demosaic_bilinear_packed(raw: torch.Tensor, pattern: str, width: int,
                             height: int) -> torch.Tensor:
    """:func:`demosaic_bilinear` as packed-rows BGR u8 (..., H, W*3)."""
    out = demosaic_bilinear(raw, pattern, width, height)
    return out.reshape(*out.shape[:-3], height, width * 3)


def _hwc(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Packed rows, (..., H, W*3) or flat (..., H*W*3) → the (..., H, W, 3)
    view. The reference reads a last axis of H*W*3 as flat; where H == 1
    makes both readings fit, this takes the rows."""
    rows = src.ndim >= 2 and tuple(src.shape[-2:]) == (height, width * 3)
    batch = src.shape[:-2] if rows else src.shape[:-1]
    return src.reshape(*batch, height, width, 3)


def bgr_to_gray_packed_rows(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Packed BGR rows → gray u8 (..., H, W), equal to ``bgr_to_gray`` on
    the (..., H, W, 3) view. Any width (the reference's word trick needs
    width % 4 == 0; the values are the same)."""
    q = _hwc(src, width, height).to(torch.int32)
    return _luma(q[..., 2], q[..., 1], q[..., 0]).to(torch.uint8)


def unpack_bgr_planes(src: torch.Tensor, width: int, height: int):
    """Packed BGR rows → int32 planes (b, g, r), each (..., H, W). Inverse
    of :func:`interleave_bgr_planes`."""
    q = _hwc(src, width, height).to(torch.int32)
    return q[..., 0], q[..., 1], q[..., 2]


def interleave_bgr_planes(b, g, r, width: int, height: int) -> torch.Tensor:
    """u8-valued planes (..., H, W), any integer dtype → packed BGR rows u8
    (..., H, W*3)."""
    packed = torch.stack([b, g, r], dim=-1).to(torch.uint8)
    return packed.reshape(*packed.shape[:-3], height, width * 3)


# -- HSV, YCrCb, Lab, range masks and moments (the frozen specs of
#    golden.bgr_to_hsv & co.) ----------------------------------------------------


def _bgr_int(bgr: torch.Tensor):
    """(b, g, r) int32 planes of BGR (..., 3)."""
    q = bgr.to(torch.int32)
    return q[..., 0], q[..., 1], q[..., 2]


def _floor_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def bgr_to_hsv(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 BGR → HSV u8 (H ∈ [0, 180)), the frozen all-integer spec
    golden.bgr_to_hsv: S = (510·diff + V) // (2V), H = (T + diff) //
    (2·diff) mod 180 with exact integer floor division."""
    b, g, r = _bgr_int(bgr)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    zero = torch.zeros_like(v)
    s = torch.where(v == 0, zero, _floor_div(510 * diff + v, (2 * v).clamp(min=1)))
    r_is = r == v
    g_is = (g == v) & ~r_is
    num = torch.where(r_is, g - b, torch.where(g_is, b - r, r - g))
    base = torch.where(r_is, zero, torch.where(g_is, zero + 120, zero + 240))
    t = base * diff + 60 * num
    t = torch.where(t < 0, t + 360 * diff, t)
    h = torch.where(diff == 0, zero, _floor_div(t + diff, (2 * diff).clamp(min=1)) % 180)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 HSV (H ∈ [0, 180)) → BGR u8, the frozen integer spec
    golden.hsv_to_bgr: round-half-up rational divisions, the (v, p, q, t)
    table per 30° sector; S == 0 gives (V, V, V)."""
    h, s, v = _bgr_int(hsv)
    sector = (h // 30) % 6
    rem = h % 30

    def rdiv(a, d):
        return _floor_div(2 * a + d, 2 * d)

    p = rdiv(v * (255 - s), 255)
    q = rdiv(v * (255 * 30 - s * rem), 255 * 30)
    t = rdiv(v * (255 * 30 - s * (30 - rem)), 255 * 30)
    # (B, G, R) per sector, as indices into (v, p, q, t): golden's table.
    tabs = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]],
                        dtype=torch.int64, device=hsv.device)
    vpqt = torch.stack([v, p, q, t], dim=-1)
    out = torch.gather(vpqt, -1, tabs[sector.to(torch.int64)])
    out = torch.where((s == 0)[..., None], v[..., None], out)
    return out.clamp(0, 255).to(torch.uint8)


def bgr_to_ycrcb(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 BGR → YCrCb u8, the frozen 14-bit fixed-point spec
    golden.bgr_to_ycrcb (arithmetic-shift descale)."""
    b, g, r = _bgr_int(bgr)
    y = (4899 * r + 9617 * g + 1868 * b + 8192) >> 14
    cr = ((r - y) * 11682 + (128 << 14) + 8192) >> 14
    cb = ((b - y) * 9241 + (128 << 14) + 8192) >> 14
    return torch.stack([y, cr.clamp(0, 255), cb.clamp(0, 255)], dim=-1).to(torch.uint8)


def ycrcb_to_bgr(ycrcb: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 YCrCb → BGR u8 (golden.ycrcb_to_bgr)."""
    y, cr, cb = _bgr_int(ycrcb)
    cr = cr - 128
    cb = cb - 128
    r = y + ((22987 * cr + 8192) >> 14)
    g = y + ((-11698 * cr - 5638 * cb + 8192) >> 14)
    b = y + ((29049 * cb + 8192) >> 14)
    return torch.stack([b, g, r], dim=-1).clamp(0, 255).to(torch.uint8)


def _mat3(m, x0, x1, x2):
    """Rows of the host 3×3 ``m`` applied to three float32 planes, as
    explicit multiply-adds (a matmul on the card may run in TF32)."""
    return [float(m[i][0]) * x0 + float(m[i][1]) * x1 + float(m[i][2]) * x2 for i in range(3)]


def bgr_to_lab(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 BGR → CIE L*a*b* u8 (OpenCV's 8-bit convention), float32
    for the frozen float64 spec golden.bgr_to_lab: within ±1 LSB."""
    srgb = bgr.flip(-1).to(torch.float32) / 255.0
    lin = torch.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4, srgb / 12.92)
    xyz = _mat3(_LAB_M, lin[..., 0], lin[..., 1], lin[..., 2])
    d = 6.0 / 29.0
    fx, fy, fz = (torch.where(t > d ** 3, t.clamp(min=0) ** (1.0 / 3.0), t / (3 * d * d) + 4.0 / 29.0)
                  for t in (c / wt for c, wt in zip(xyz, _LAB_WHITE)))
    out = torch.stack([torch.round((116.0 * fy - 16.0) * (255.0 / 100.0)),
                       torch.round(500.0 * (fx - fy)) + 128.0,
                       torch.round(200.0 * (fy - fz)) + 128.0], dim=-1)
    return out.clamp(0, 255).to(torch.uint8)


def lab_to_bgr(lab: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 Lab → BGR u8, the inverse (golden.lab_to_bgr), within
    ±1 LSB."""
    q = lab.to(torch.float32)
    ell = q[..., 0] * (100.0 / 255.0)
    fy = (ell + 16.0) / 116.0
    fx = fy + (q[..., 1] - 128.0) / 500.0
    fz = fy - (q[..., 2] - 128.0) / 200.0
    d = 6.0 / 29.0
    xyz = [torch.where(f > d, f ** 3, 3 * d * d * (f - 4.0 / 29.0)) * wt
           for f, wt in zip((fx, fy, fz), _LAB_WHITE)]
    lin = torch.stack(_mat3(_LAB_MINV, *xyz), dim=-1)
    srgb = torch.where(lin > 0.0031308, 1.055 * lin.clamp(min=0.0) ** (1.0 / 2.4) - 0.055,
                       12.92 * lin)
    return torch.round(srgb.flip(-1) * 255.0).clamp(0, 255).to(torch.uint8)


def in_range(img: torch.Tensor, lower, upper) -> torch.Tensor:
    """Per-channel inclusive range mask → u8 {0, 255} (OpenCV inRange;
    golden.in_range)."""
    a = img.to(torch.int32)
    lo = torch.as_tensor(lower, dtype=torch.int32, device=img.device)
    hi = torch.as_tensor(upper, dtype=torch.int32, device=img.device)
    ok = ((a >= lo) & (a <= hi)).all(dim=-1)
    return ok.to(torch.uint8) * 255


def moments_rows(mask: torch.Tensor) -> torch.Tensor:
    """Per-row moment partials (H, 2) int64 of a u8 mask (H, W) or (H, W,
    C) (its first channel): (Σ value, Σ value·x) per row, exact."""
    a = mask.to(torch.int64)
    if a.ndim == 3:
        a = a[..., 0]
    xs = torch.arange(a.shape[-1], dtype=torch.int64, device=a.device)
    return torch.stack([a.sum(dim=-1), (a * xs).sum(dim=-1)], dim=-1)


def moments(mask: torch.Tensor) -> dict:
    """Raw moments m00/m10/m01 (and the centroid when m00 > 0) of a u8
    mask, exact at any size (golden.moments): the row partials in int64
    where the mask is, then three sums on the host."""
    rows = moments_rows(mask).cpu().numpy()
    m00 = int(rows[:, 0].sum())
    m10 = int(rows[:, 1].sum())
    m01 = int((rows[:, 0] * np.arange(rows.shape[0], dtype=np.int64)).sum())
    out = {"m00": m00, "m10": m10, "m01": m01}
    if m00 > 0:
        out["centroid"] = (m10 / m00, m01 / m00)
    return out


def yuyv_to_bgr_packed_overlay(src: torch.Tensor, width: int, height: int,
                               rects, colors, thickness) -> torch.Tensor:
    """YUYV → packed BGR with the rectangle overlay painted on the pixel-pair
    planes before the byte interleave: the same bytes as
    ``rectangle_packed(yuyv_to_bgr_packed(...))``. ``src`` (N, H·W·2) u8,
    ``rects`` (N, 4) int32, ``colors`` (N, 3) u8, ``thickness`` int or
    (N,)."""
    from . import draw as _draw

    dev = src.device
    y0, u, y1, v = _unpack_yuyv_words(src, width, height)
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    rects = _draw._on(rects, torch.int32, dev)
    colors = _draw._on(colors, torch.int32, dev)
    thickness = _draw._on(thickness, torch.int32, dev)
    ys = torch.arange(height, dtype=torch.int32, device=dev).reshape(height, 1)
    xs_e = torch.arange(width // 2, dtype=torch.int32, device=dev).reshape(1, width // 2) * 2
    mask_e, expand = _draw._edge_masks(xs_e, ys, rects, thickness, width, height)
    mask_o, _ = _draw._edge_masks(xs_e + 1, ys, rects, thickness, width, height)
    cb, cg, cr = (expand(colors[..., i]) for i in range(3))
    planes = (torch.where(mask_e, cb, b0), torch.where(mask_e, cg, g0),
              torch.where(mask_e, cr, r0), torch.where(mask_o, cb, b1),
              torch.where(mask_o, cg, g1), torch.where(mask_o, cr, r1))
    return _interleave_pair_bgr(*planes, width, height)


# -- OpenCV-exact u8 conversions on the host (numpy; the cv2 facade's) ---------
#
# OpenCV 5.0's fixed-point table arithmetic, digit for digit, kept apart
# from the frozen specs above (the capture pipeline's).


def _cv_hsv_tables():
    hsv_shift = 12
    i = np.arange(256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << hsv_shift) / i[1:]).astype(np.int64)
    hdiv = np.zeros(256, np.int64)
    hdiv[1:] = np.rint((180 << hsv_shift) / (6.0 * i[1:])).astype(np.int64)
    return sdiv, hdiv


_CV_HSV_SDIV, _CV_HSV_HDIV = _cv_hsv_tables()


def bgr_to_gray_cv(bgr: np.ndarray) -> np.ndarray:
    """OpenCV 5.0 COLOR_BGR2GRAY u8: 15-bit fixed point
    (9798 R + 19235 G + 3735 B + 2^14) >> 15."""
    b = bgr[..., 0].astype(np.int64)
    g = bgr[..., 1].astype(np.int64)
    r = bgr[..., 2].astype(np.int64)
    return ((3735 * b + 19235 * g + 9798 * r + (1 << 14)) >> 15).astype(np.uint8)


def bgr_to_hsv_cv(bgr: np.ndarray) -> np.ndarray:
    """OpenCV COLOR_BGR2HSV u8: the hsv_shift=12 division-table double
    rounding (color_hsv's sdiv/hdiv tables)."""
    b = bgr[..., 0].astype(np.int64)
    g = bgr[..., 1].astype(np.int64)
    r = bgr[..., 2].astype(np.int64)
    v = np.maximum(b, np.maximum(g, r))
    diff = v - np.minimum(b, np.minimum(g, r))
    s = (diff * _CV_HSV_SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _CV_HSV_HDIV[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _cv_lab_tables():
    # sRGB gamma table 0..255 -> 0..2040 (gamma_shift = 3)
    i = np.arange(256, dtype=np.float64) / 255.0
    gam = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gtab = np.rint(255.0 * 8 * gam).astype(np.int64)
    # f(t) table on the descaled XYZ grid (lab_shift2 = 15)
    x = np.arange(3072, dtype=np.float64) / (255.0 * 8)
    ctab = np.rint((1 << 15) * np.where(
        x < 216.0 / 24389.0, x * (841.0 / 108.0) + 16.0 / 116.0, np.cbrt(x))).astype(np.int64)
    # two entries where OpenCV's softfloat table construction rounds the
    # other way (FMA in the linear branch at 49, cbrt ULP at 628)
    ctab[49] -= 1
    ctab[628] += 1
    d65 = (0.950456, 1.0, 1.088754)
    srgb2xyz = ((0.412453, 0.357580, 0.180423),
                (0.212671, 0.715160, 0.072169),
                (0.019334, 0.119193, 0.950227))
    coef = np.array([[int(np.rint((1 << 12) * srgb2xyz[i][j] / d65[i])) for j in range(3)]
                     for i in range(3)], np.int64)
    return gtab, ctab, coef


_CV_LAB_GTAB, _CV_LAB_CTAB, _CV_LAB_COEF = _cv_lab_tables()


def bgr_to_lab_cv(bgr: np.ndarray) -> np.ndarray:
    """OpenCV COLOR_BGR2Lab u8: gamma and cube-root tables with
    lab_shift=12 / lab_shift2=15 descales."""
    rr = _CV_LAB_GTAB[bgr[..., 2].astype(np.int64)]
    gg = _CV_LAB_GTAB[bgr[..., 1].astype(np.int64)]
    bb = _CV_LAB_GTAB[bgr[..., 0].astype(np.int64)]
    c = _CV_LAB_COEF

    def desc(v, n):
        return (v + (1 << (n - 1))) >> n

    f_x = _CV_LAB_CTAB[desc(rr * c[0, 0] + gg * c[0, 1] + bb * c[0, 2], 12)]
    f_y = _CV_LAB_CTAB[desc(rr * c[1, 0] + gg * c[1, 1] + bb * c[1, 2], 12)]
    f_z = _CV_LAB_CTAB[desc(rr * c[2, 0] + gg * c[2, 1] + bb * c[2, 2], 12)]
    lum = desc(296 * f_y - 1336934, 15)  # (116*255+50)//100, 16*255<<15
    a = desc(500 * (f_x - f_y) + (128 << 15), 15)
    b = desc(200 * (f_y - f_z) + (128 << 15), 15)
    return np.clip(np.stack([lum, a, b], axis=-1), 0, 255).astype(np.uint8)
