"""YUYV colour conversions and packed-BGR helpers (port of the pipeline's
subset of ``rustcv_tpu.ops.color``), bit-exact with the reference's integer
BT.601 and luma. The packed-BGR helpers work on the (..., H, W, 3) view,
where the reference bitcasts 4-pixel groups into three u32 words.

All arithmetic is int32. The four bytes of each YUYV word are read from a
u8 view ``(..., H, W/2, 4)`` widened to int32 (torch has little uint32
arithmetic, so nothing is bitcast), and the byte interleave into packed rows
is a plain ``stack(..., -1).reshape``.

Packed rows ``(..., H, W*3)`` is the BGR layout of the whole pipeline: the
bytes of an interleaved ``(H, W, 3)`` image, one row per image row.
"""

from __future__ import annotations

import torch


def _unpack_yuyv_words(src: torch.Tensor, width: int, height: int):
    """YUYV bytes, flat ``(..., H*W*2)`` or ``(..., H, W*2)`` → int32 planes
    (..., H, W/2): y0, u, y1, v."""
    batch = src.shape[:-1] if src.shape[-1] == height * width * 2 else src.shape[:-2]
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
    b0, g0, r0, b1, g1, r1 = _bt601_pair(y0, y1, u, v)
    # frozen integer luma (77R + 150G + 29B + 128) >> 8
    return _pack_gray_pairs(_luma(r0, g0, b0), _luma(r1, g1, b1), width, height)


def _luma(r, g, b):
    """The frozen integer luma (77R + 150G + 29B + 128) >> 8 on int32."""
    return (77 * r + 150 * g + 29 * b + 128) >> 8


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
