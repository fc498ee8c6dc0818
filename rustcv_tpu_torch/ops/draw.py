"""Drawing on BGR images (port of ``rustcv_tpu.ops.draw``'s rectangle,
line, circle, mask-paint, filled-polygon and text-blend ops).

Each op is a masked select over the whole image that returns a new image:
the per-pixel mask is computed on an (H, W) grid and painted on the (H, W,
3) view of the image, which for packed rows (..., H, W*3) is the same
bytes. Parameters with leading batch dims draw per image.

Semantics are the reference's frozen integer specs (``golden.line_mask``,
``circle_mask``, ``fill_poly_mask``), all int32 wrapping like the
reference's; the rectangle matches it for all in-bounds cases, including
its edge overdraw when ``thickness`` exceeds the rectangle's size. The one
deviation the reference's device ops also make: writes past the last
column are clipped at the column boundary instead of bleeding into the
next row, as ``golden.rectangle``'s flat-index check lets them.

The text blends (:func:`blend_mask_at`, :func:`blend_mask_packed_batch`,
:func:`blend_masks_packed_batch`) compute what the reference's do, the
frozen integer blend ``(color*a + old*(255-a)) // 255`` of a coverage mask
at a per-image origin, clipped at the borders, by gathering the mask's
window, blending it and writing it back (the reference pads a canvas
instead).

No parameter is copied from the host with a wait for the work queued on
the stream: a Python number is filled on the image's device (a fill is a
kernel, so it also runs inside a CUDA graph capture), and a sequence or
numpy array is uploaded from pinned memory without blocking.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import isqrt_exact


def _on(v, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``v`` as a tensor on ``dev``: a tensor is moved; a number is filled
    on the device; a sequence or numpy array is uploaded from pinned memory
    without waiting for the stream."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=dtype)
    a = np.asarray(v)
    if a.ndim == 0:
        return torch.full((), a.item(), dtype=dtype, device=dev)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _ex(v: torch.Tensor) -> torch.Tensor:
    """Lift (...,) params to image rank (..., 1, 1)."""
    return v[..., None, None]


def _grid(h: int, w: int, dev: torch.device):
    """int32 pixel coordinates: ys (H, 1), xs (1, W)."""
    ys = torch.arange(h, dtype=torch.int32, device=dev).reshape(h, 1)
    xs = torch.arange(w, dtype=torch.int32, device=dev).reshape(1, w)
    return ys, xs


def _paint(img: torch.Tensor, mask: torch.Tensor, color_bgr) -> torch.Tensor:
    """Pixels of packed-rows ``img`` (..., H, W*3) under ``mask`` (..., H,
    W) take ``color_bgr`` ((3,) shared or (..., 3) per image)."""
    h, w3 = img.shape[-2], img.shape[-1]
    color = _on(color_bgr, torch.uint8, img.device)
    img3 = img.reshape(*img.shape[:-1], w3 // 3, 3)
    out = torch.where(mask[..., None], color[..., None, None, :], img3)
    return out.reshape(*out.shape[:-3], h, w3)


def _stroke(xs, ys, ax, ay, bx, by, t):
    """The exact INT32-safe line-stroke spec (golden.line_mask): the floored
    perpendicular distance (2|cross|)//isqrt(|AB|²) against ``t``, round
    caps 4·|P−A|² ≤ t², caps alone where A == B."""
    abx, aby = bx - ax, by - ay
    apx, apy = xs - ax, ys - ay
    bpx, bpy = xs - bx, ys - by
    ab2 = abx * abx + aby * aby
    t2 = t * t
    dot = apx * abx + apy * aby
    cross = (apx * aby - apy * abx).abs()
    s = isqrt_exact(ab2).clamp(min=1)
    perp = torch.div(2 * cross, s, rounding_mode="floor")
    body = (dot >= 0) & (dot <= ab2) & (perp <= t)
    caps = (4 * (apx * apx + apy * apy) <= t2) | (4 * (bpx * bpx + bpy * bpy) <= t2)
    return torch.where(ab2 == 0, caps, body | caps)


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


def rectangle(img: torch.Tensor, rect_xywh, color_bgr, thickness) -> torch.Tensor:
    """Rectangle outline on BGR u8 (..., H, W, 3); the parameters as
    :func:`rectangle_packed`'s. Returns a new image."""
    packed = img.reshape(*img.shape[:-2], img.shape[-2] * 3)
    return rectangle_packed(packed, rect_xywh, color_bgr, thickness).reshape(img.shape)


def rectangle_packed(img: torch.Tensor, rect_xywh, color_bgr, thickness) -> torch.Tensor:
    """Rectangle outline on packed-rows BGR u8 (..., H, W*3); ``rect_xywh``
    int (..., 4), ``color_bgr`` u8 (..., 3), ``thickness`` int or (...,):
    leading batch dims apply per image. Returns a new image."""
    dev = img.device
    h, w3 = img.shape[-2], img.shape[-1]
    w = w3 // 3
    rect_xywh = _on(rect_xywh, torch.int32, dev)
    thickness = _on(thickness, torch.int32, dev)
    color_bgr = _on(color_bgr, torch.uint8, dev)

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


def line_packed(img: torch.Tensor, p1, p2, color_bgr, thickness) -> torch.Tensor:
    """Line stroke on packed-rows BGR u8 (..., H, W*3), the exact integer
    distance-field spec (golden.line_mask); ``p1``/``p2`` (x, y) int (...,
    2), ``thickness`` int or (...,)."""
    dev = img.device
    ys, xs = _grid(img.shape[-2], img.shape[-1] // 3, dev)
    p1, p2 = _on(p1, torch.int32, dev), _on(p2, torch.int32, dev)
    t = _ex(_on(thickness, torch.int32, dev))
    mask = _stroke(xs, ys, _ex(p1[..., 0]), _ex(p1[..., 1]), _ex(p2[..., 0]), _ex(p2[..., 1]), t)
    return _paint(img, mask, color_bgr)


def circle_packed(img: torch.Tensor, center, radius, color_bgr, thickness) -> torch.Tensor:
    """Circle on packed-rows BGR u8 (..., H, W*3), the exact integer spec
    (golden.circle_mask): filled where ``thickness`` < 0 (|P−C|² ≤ R²),
    else the ring 2|P−C| within [max(0, 2R−t), 2R+t]."""
    dev = img.device
    ys, xs = _grid(img.shape[-2], img.shape[-1] // 3, dev)
    center = _on(center, torch.int32, dev)
    r = _ex(_on(radius, torch.int32, dev))
    t = _ex(_on(thickness, torch.int32, dev))
    dx, dy = xs - _ex(center[..., 0]), ys - _ex(center[..., 1])
    # all magnitudes fit int32 up to 8K coordinates (d² ≤ 1.3e8, hi² ≤ 7e7)
    d2 = dx * dx + dy * dy
    lo = (2 * r - t).clamp(min=0)
    hi = 2 * r + t
    ring = (4 * d2 >= lo * lo) & (4 * d2 <= hi * hi)
    return _paint(img, torch.where(t < 0, d2 <= r * r, ring), color_bgr)


def paint_mask_packed(img: torch.Tensor, mask, color_bgr) -> torch.Tensor:
    """Paint a full-frame (H, W) u8 mask onto packed-rows BGR u8 (..., H,
    W*3): pixels where mask > 0 take ``color_bgr``. A host (numpy) mask is
    uploaded from pinned memory without waiting for the stream."""
    if not isinstance(mask, torch.Tensor):
        mask = _on(mask, torch.uint8, img.device)
    return _paint(img, mask.to(img.device) > 0, color_bgr)


def fill_poly_packed(img: torch.Tensor, pts, color_bgr, include_edges: bool = True) -> torch.Tensor:
    """Filled polygon on packed-rows BGR u8 (..., H, W*3), bit-identical to
    golden.fill_poly_mask: the exact-integer even-odd +x ray crossing per
    pixel, OR'd with the thickness-1 stroke of every edge. ``pts`` [K, 2]
    int (x, y) vertices."""
    dev = img.device
    ys, xs = _grid(img.shape[-2], img.shape[-1] // 3, dev)
    p = _on(pts, torch.int32, dev).reshape(-1, 2)
    k = p.shape[0]
    inside = torch.zeros(ys.shape[0], xs.shape[1], dtype=torch.bool, device=dev)
    edge = torch.zeros_like(inside)
    for i in range(k):
        x1, y1 = p[i, 0], p[i, 1]
        x2, y2 = p[(i + 1) % k, 0], p[(i + 1) % k, 1]
        d = y2 - y1
        straddle = (y1 > ys) != (y2 > ys)
        t = (ys - y1) * (x2 - x1) - (xs - x1) * d
        inside = inside ^ (straddle & ((t > 0) == (d > 0)) & (d != 0))
        if include_edges:
            edge = edge | _stroke(xs, ys, x1, y1, x2, y2, 1)
    return _paint(img, inside | edge, color_bgr)


def _blend_windows(img: torch.Tensor, masks3: torch.Tensor, orgs: torch.Tensor,
                   color: torch.Tensor) -> torch.Tensor:
    """The clipped text blend on packed rows: ``img`` (N, H, W*3) u8,
    ``masks3`` (N or 1, mh, mw*3) u8 coverage repeated per channel,
    ``orgs`` (N, 2) int64 top-left (x, y) pixels, ``color`` (3,) int32.
    Returns a new image."""
    n, h, w3 = img.shape
    mh, mw3 = masks3.shape[-2], masks3.shape[-1]
    dev = img.device
    rows = orgs[:, 1:2] + torch.arange(mh, device=dev)  # (N, mh)
    cols = orgs[:, 0:1] * 3 + torch.arange(mw3, device=dev)  # (N, mw3)
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w3))[:, None, :])  # (N, mh, mw3)
    src = ((torch.arange(n, device=dev)[:, None, None] * h + rows.clamp(0, h - 1)[:, :, None]) * w3
           + cols.clamp(0, w3 - 1)[:, None, :])
    flat = img.reshape(-1)
    region = flat[src].to(torch.int32)
    a = masks3.to(torch.int32)
    lane_color = color[torch.arange(mw3, device=dev) % 3]
    blended = ((lane_color * a + region * (255 - a)) // 255).to(torch.uint8)
    # Pixels off the image go to scratch slots past the end, one each, so
    # every index written is distinct.
    total = flat.numel()
    scratch = total + torch.arange(src.numel(), device=dev).reshape(src.shape)
    out = torch.empty(total + src.numel(), dtype=torch.uint8, device=dev)
    out[:total].copy_(flat)
    out.index_copy_(0, torch.where(inside, src, scratch).reshape(-1), blended.reshape(-1))
    return out[:total].reshape(img.shape)


def _mask3(mask, dev: torch.device) -> torch.Tensor:
    """A (..., mh, mw) coverage mask repeated ×3 along columns for packed
    rows, on ``dev`` (a host mask is repeated on the host and uploaded
    from pinned memory without waiting for the stream)."""
    if isinstance(mask, torch.Tensor):
        return mask.to(dev).repeat_interleave(3, dim=-1)
    return _on(np.repeat(np.asarray(mask, np.uint8), 3, axis=-1), torch.uint8, dev)


def blend_mask_packed_batch(img: torch.Tensor, mask3, orgs, color_bgr) -> torch.Tensor:
    """Batched text blend on packed-rows BGR (N, H, W*3) with one mask for
    every stream: ``mask3`` (mh, mw*3) u8, the coverage repeated ×3 along
    columns; ``orgs`` (N, 2) top-left (x, y) pixels per stream;
    ``color_bgr`` (3,). The frozen integer blend, clipped at the borders."""
    dev = img.device
    m = mask3 if isinstance(mask3, torch.Tensor) else _on(mask3, torch.uint8, dev)
    return _blend_windows(img, m.to(dev)[None], _on(orgs, torch.int64, dev).reshape(-1, 2),
                          _on(color_bgr, torch.int32, dev))


def blend_masks_packed_batch(img: torch.Tensor, masks3, orgs, color_bgr) -> torch.Tensor:
    """Per-stream text blend: :func:`blend_mask_packed_batch` with a mask
    per stream (``masks3`` (N, mh, mw*3) u8; differing strings padded to a
    common canvas)."""
    dev = img.device
    m = masks3 if isinstance(masks3, torch.Tensor) else _on(masks3, torch.uint8, dev)
    return _blend_windows(img, m.to(dev), _on(orgs, torch.int64, dev).reshape(-1, 2),
                          _on(color_bgr, torch.int32, dev))


def blend_mask_at(img: torch.Tensor, mask, x0: int, y0: int, color_bgr) -> torch.Tensor:
    """Blend a (mh, mw) u8 coverage mask onto BGR (..., H, W, 3) u8 with its
    top-left corner at (x0, y0) in every image: the frozen integer blend
    (golden.blend_mask), clipped at the borders. Returns a new image."""
    dev = img.device
    h, w = img.shape[-3], img.shape[-2]
    packed = img.reshape(-1, h, w * 3)
    orgs = np.tile(np.array([[int(x0), int(y0)]], np.int64), (packed.shape[0], 1))
    out = _blend_windows(packed, _mask3(mask, dev)[None], _on(orgs, torch.int64, dev),
                         _on(color_bgr, torch.int32, dev))
    return out.reshape(img.shape)
