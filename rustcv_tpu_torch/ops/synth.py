"""Device-side simulation frame synthesis (port of ``rustcv_tpu.ops.synth``).

A frame is a pure function of ``(width, height, format, seq)``: the same
bytes as the host generator in :mod:`rustcv_tpu_torch.capture.simulation`,
made on the device from each stream's sequence number, so a simulated
camera uploads nothing per tick. The arithmetic is int32 on tensors and
keeps the reference's int32 wrap of ``seq * k`` and its floor ``%``
(``torch.remainder``), so large sequence numbers give the reference's bytes.
"""

from __future__ import annotations

import torch

from ..core.errors import SimulationError
from ..core.pixel_format import PixelFormat

from ..capture.simulation import _BAR_COLORS_BGR


def _pattern_planes(seq: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    width: int, height: int):
    """The test pattern at integer coordinate grids; ``seq`` broadcasts
    against ``xs``/``ys``. Returns (b, g, r) int32 planes."""
    shape = torch.broadcast_shapes(seq.shape, xs.shape, ys.shape)
    zero = torch.zeros(shape, dtype=torch.int32, device=xs.device)
    b, g, r = zero, zero, zero
    wmax = max(width, 1)
    for idx, (bb, gg, rr) in enumerate(_BAR_COLORS_BGR.tolist()):
        lo = -(-idx * wmax // 8)  # smallest xs with xs*8//W == idx
        hi = -(-(idx + 1) * wmax // 8)
        m = (xs >= lo) if idx == 7 else ((xs >= lo) & (xs < hi))
        b = torch.where(m, bb, b)
        g = torch.where(m, gg, g)
        r = torch.where(m, rr, r)

    gy0 = height * 2 // 3
    grad = torch.remainder(xs + ys + seq * 7, 256)
    in_grad = ys >= gy0
    b = torch.where(in_grad, grad, b)
    g = torch.where(in_grad, 255 - grad, g)
    r = torch.where(in_grad, torch.remainder(grad * 2, 256), r)

    sq = max(4, height // 8)
    span = max(1, width - sq)
    pos = torch.remainder(seq * max(2, width // 64), 2 * span)
    x0 = torch.where(pos < span, pos, 2 * span - pos)
    y0 = max(0, height // 2 - sq // 2)
    in_sq = (ys >= y0) & (ys < y0 + sq) & (xs >= x0) & (xs < x0 + sq)
    b = torch.where(in_sq, 255, b)
    g = torch.where(in_sq, 255, g)
    r = torch.where(in_sq, 255, r)
    return b, g, r


def _yuv(b, g, r):
    """Forward BT.601 integer transform (frozen spec), clamped to u8."""
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128
    return y.clamp(0, 255), u.clamp(0, 255), v.clamp(0, 255)


def synth_yuyv(seqs: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Wire-format YUYV frames: seqs [N] int → u8 [N, H*W*2] on seqs' device.

    The pattern is evaluated at the even and odd columns of each pixel pair
    directly, so no interleaved BGR intermediate exists."""
    dev = seqs.device
    seq = seqs.to(torch.int32).reshape(-1, 1, 1)
    hw = width // 2
    ys = torch.arange(height, dtype=torch.int32, device=dev).reshape(height, 1)
    js = torch.arange(hw, dtype=torch.int32, device=dev).reshape(1, hw)
    y0, u0, v0 = _yuv(*_pattern_planes(seq, js * 2, ys, width, height))
    y1, u1, v1 = _yuv(*_pattern_planes(seq, js * 2 + 1, ys, width, height))
    up = (u0 + u1 + 1) >> 1
    vp = (v0 + v1 + 1) >> 1
    out = torch.stack([y0, up, y1, vp], dim=-1).to(torch.uint8)
    return out.reshape(seq.shape[0], height * width * 2)


def _bgr_planes(seqs: torch.Tensor, width: int, height: int):
    """The pattern's (b, g, r) int32 planes [N, H, W] for seqs [N]."""
    dev = seqs.device
    seq = seqs.to(torch.int32).reshape(-1, 1, 1)
    ys = torch.arange(height, dtype=torch.int32, device=dev).reshape(height, 1)
    xs = torch.arange(width, dtype=torch.int32, device=dev).reshape(1, width)
    return _pattern_planes(seq, xs, ys, width, height)


def synth_bgr(seqs: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Pattern frames: seqs [N] int → u8 [N, H, W, 3] on seqs' device."""
    return torch.stack(_bgr_planes(seqs, width, height), dim=-1).to(torch.uint8)


def encode_nv12(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) u8 → NV12 flat (..., H*W*3/2) u8: the Y plane, then U
    and V interleaved, each the rounded mean of a 2×2 site."""
    h, w = bgr.shape[-3], bgr.shape[-2]
    batch = bgr.shape[:-3]
    q = bgr.to(torch.int32)
    y, u, v = _yuv(q[..., 0], q[..., 1], q[..., 2])
    u4 = u.reshape(*batch, h // 2, 2, w // 2, 2).sum(dim=(-3, -1))
    v4 = v.reshape(*batch, h // 2, 2, w // 2, 2).sum(dim=(-3, -1))
    uv = torch.stack([(u4 + 2) >> 2, (v4 + 2) >> 2], dim=-1).to(torch.uint8)
    return torch.cat([y.to(torch.uint8).reshape(*batch, h * w),
                      uv.reshape(*batch, h * w // 2)], dim=-1)


def encode_bgra(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) u8 → BGRA32 flat (..., H*W*4), alpha 255."""
    h, w = bgr.shape[-3], bgr.shape[-2]
    alpha = torch.full((*bgr.shape[:-1], 1), 255, dtype=torch.uint8, device=bgr.device)
    return torch.cat([bgr, alpha], dim=-1).reshape(*bgr.shape[:-3], h * w * 4)


def encode_rgb(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) u8 → RGB24 flat (..., H*W*3)."""
    h, w = bgr.shape[-3], bgr.shape[-2]
    return bgr.flip(-1).reshape(*bgr.shape[:-3], h * w * 3)


def synth_raw(seqs: torch.Tensor, width: int, height: int,
              pixel_format: PixelFormat) -> torch.Tensor:
    """Batched raw frames in wire format: [N] → u8 [N, raw_bytes]. YUYV is
    made at pixel-pair resolution; NV12, BGRA32, RGB24 and BGR24 encode the
    BGR pattern. Other formats raise :class:`SimulationError`, as in the
    reference, which cannot make them on the device either."""
    if pixel_format == PixelFormat.YUYV:
        return synth_yuyv(seqs, width, height)
    if pixel_format not in _ENCODERS:
        raise SimulationError(f"device simulation cannot encode {pixel_format}")
    return _ENCODERS[pixel_format](synth_bgr(seqs, width, height))


_ENCODERS = {
    PixelFormat.NV12: encode_nv12,
    PixelFormat.BGRA32: encode_bgra,
    PixelFormat.RGB24: encode_rgb,
    PixelFormat.BGR24: lambda bgr: bgr.reshape(bgr.shape[0], -1),
}
