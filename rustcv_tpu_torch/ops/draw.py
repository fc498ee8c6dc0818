"""Rectangle overlay on packed-rows BGR (port of
``rustcv_tpu.ops.draw.rectangle_packed``).

Semantics match the reference for all in-bounds cases, including its edge
overdraw when ``thickness`` exceeds the rectangle's size. The one deviation
the reference package also makes: writes past the last column are clipped
at the column boundary instead of bleeding into the next row.
Arithmetic is int32 and wraps like the reference's.
"""

from __future__ import annotations

import torch


def _edge_masks(xs, ys, rect_xywh, thickness, w, h):
    """Rectangle edge mask; ``xs``/``ys`` are pixel-coordinate grids that
    broadcast against each other; rect fields may carry batch dims.
    Returns (mask, expand) where expand lifts (...,) params to image rank."""
    x, y, rw, rh = (rect_xywh[..., i] for i in range(4))
    x_min = x.clamp(min=0)
    y_min = y.clamp(min=0)
    x_max = (x + rw).clamp(max=w)
    y_max = (y + rh).clamp(max=h)
    degenerate = (x_min >= x_max) | (y_min >= y_max)

    def expand(v):
        return v[..., None, None]

    x_min_e, x_max_e = expand(x_min), expand(x_max)
    y_min_e, y_max_e = expand(y_min), expand(y_max)
    th = expand(thickness)

    x_span = (xs >= x_min_e) & (xs < x_max_e)
    y_span = (ys >= y_min_e) & (ys < y_max_e)
    top_bot = ((ys >= y_min_e) & (ys < y_min_e + th)) | (
        (ys >= y_max_e - th) & (ys < y_max_e)
    )
    left_right = ((xs >= x_min_e) & (xs < x_min_e + th)) | (
        (xs >= x_max_e - th) & (xs < x_max_e)
    )
    mask = (x_span & top_bot) | (y_span & left_right)
    return mask & ~expand(degenerate), expand


def rectangle_packed(img: torch.Tensor, rect_xywh, color_bgr, thickness) -> torch.Tensor:
    """Rectangle outline on packed-rows BGR u8 (..., H, W*3); ``rect_xywh``
    int (..., 4), ``color_bgr`` u8 (..., 3), ``thickness`` int or (...,).
    Returns a new image."""
    dev = img.device
    h, w3 = img.shape[-2], img.shape[-1]
    w = w3 // 3
    rect_xywh = torch.as_tensor(rect_xywh, dtype=torch.int32, device=dev)
    # A Python int is filled on the device: copying it from the host would
    # wait for all the work queued on the stream (once per tick).
    if isinstance(thickness, int):
        thickness = torch.full((), thickness, dtype=torch.int32, device=dev)
    thickness = torch.as_tensor(thickness, dtype=torch.int32, device=dev)
    color_bgr = torch.as_tensor(color_bgr, dtype=torch.uint8, device=dev)

    ys = torch.arange(h, dtype=torch.int32, device=dev).reshape(h, 1)
    cs = torch.arange(w3, dtype=torch.int32, device=dev).reshape(1, w3)
    xs = cs // 3
    ch = cs % 3

    mask, expand = _edge_masks(xs, ys, rect_xywh, thickness, w, h)
    b = expand(color_bgr[..., 0])
    g = expand(color_bgr[..., 1])
    r = expand(color_bgr[..., 2])
    lane_color = torch.where(ch == 0, b, torch.where(ch == 1, g, r))
    return torch.where(mask, lane_color, img)
