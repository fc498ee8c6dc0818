"""Frame decode on the device: raw pixel formats → BGR (port of
``rustcv_tpu.ops.decode``'s ``convert_on_device``).

:func:`convert_on_device` dispatches on the wire format to the converters
of :mod:`.color`, returning the (..., H, W, 3) BGR image; the engine's
pipeline decodes every uncompressed format with it. MJPEG takes the hybrid
decode of :mod:`.jpeg_tpu` in the pipeline; the host-decode entry points of
the reference are not ported.
"""

from __future__ import annotations

import torch

from ..core.errors import DecodeError
from ..core.pixel_format import PixelFormat
from . import color


def convert_on_device(raw: torch.Tensor, fmt: PixelFormat, width: int,
                      height: int) -> torch.Tensor:
    """Raw u8 bytes, flat last axis (optionally batched) → BGR u8 (..., H,
    W, 3) on raw's device, for every uncompressed format."""
    if fmt == PixelFormat.YUYV:
        return color.yuyv_to_bgr(raw, width, height)
    if fmt == PixelFormat.UYVY:
        return color.uyvy_to_bgr(raw, width, height)
    if fmt == PixelFormat.NV12:
        return color.nv12_to_bgr(raw, width, height)
    if fmt == PixelFormat.YV12:
        return color.yv12_to_bgr(raw, width, height)
    if fmt == PixelFormat.BGRA32:
        return color.bgra_to_bgr(raw, width, height)
    if fmt == PixelFormat.RGBA32:
        return color.rgba_to_bgr(raw, width, height)
    if fmt == PixelFormat.RGB24:
        return color.rgb_to_bgr(raw, width, height)
    if fmt == PixelFormat.BGR24:
        return raw.reshape(*raw.shape[:-1], height, width, 3)
    if fmt == PixelFormat.GRAY8:
        g = raw.reshape(*raw.shape[:-1], height, width)
        return g[..., None].expand(*g.shape, 3).contiguous()
    if fmt.is_bayer:
        return color.demosaic_bilinear(raw, fmt.value.split("_")[1], width, height)
    raise DecodeError(f"unsupported device format: {fmt}")
