"""Colour conversions of every staged wire format to BGR, and the
packed-BGR helpers (port of the engine's subset of ``rustcv_tpu.ops.color``),
bit-exact with the reference's integer BT.601, luma and Bayer demosaic.

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

import torch

from .golden import BAYER_PATTERNS


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
