"""imgproc — drawing primitives and image processing (OpenCV-style API; the
port of ``rustcv_tpu.imgproc``'s drawing surface and of the processing ops
the BASELINE configs use).

Reference surface: ``rustcv/src/imgproc/mod.rs:1-4`` re-exports
``{Point, Rect, Scalar, rectangle, put_text}`` from ``drawing.rs``; the
reference package adds ``line``, ``circle``, ``polylines``, ``ellipse``,
``fill_poly``, ``arrowed_line`` and the processing ops ``cvt_gray``,
``resize``, ``gaussian_blur``, ``sobel_magnitude``, ``canny`` and
``harris_corners``, with specs frozen in its ``ops/golden.py``.

In-place semantics preserved: ``rectangle(mat, …)`` mutates the Mat like the
reference (``drawing.rs:67``). A Mat on a device is drawn there and its
tensor swapped, with no download. A host Mat is drawn by the same function
on a CPU tensor over its (stride-aware) buffer, in place; the reference
paints its golden masks there, and the bytes are the same. Processing ops
return a new Mat on the input's side (device or host).

``put_text`` rasterizes its glyphs on the host without Pillow
(:mod:`..ops.text`) and blends the mask where the Mat is.

Not ported yet: ``resize``'s nearest, area and cubic modes and
``gaussian_blur`` with another ``ksize`` or ``sigma`` (items 10 and 14),
and the rest of the reference module (item 14). They raise ``not_ported``
or are absent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.errors import not_ported
from ..core.mat import Mat
from ..ops import color as _color
from ..ops import draw as _draw
from ..ops import features as _features
from ..ops import filters as _filters
from ..ops import golden
from ..ops import resize as _resize
from ..ops import text as _text
from ..ops.text import get_text_size


@dataclass(frozen=True)
class Point:
    """Integer pixel coordinate (drawing.rs:8-17)."""

    x: int
    y: int


@dataclass(frozen=True)
class Rect:
    """x/y/width/height rectangle (drawing.rs:19-36)."""

    x: int
    y: int
    width: int
    height: int


@dataclass(frozen=True)
class Scalar:
    """BGR color triple (drawing.rs:38-58)."""

    v0: int  # Blue
    v1: int  # Green
    v2: int  # Red

    @classmethod
    def new(cls, b: int, g: int, r: int) -> "Scalar":
        return cls(b, g, r)

    @classmethod
    def all(cls, v: int) -> "Scalar":
        return cls(v, v, v)

    @property
    def bgr(self):
        return (self.v0, self.v1, self.v2)


def _draw_inplace(mat: Mat, fn) -> None:
    """Draw in place with ``fn(hwc) -> hwc``: on the device twin (swapped),
    else on a CPU tensor over the host buffer. BGR (3-channel) Mats only —
    the masks would silently misinterpret gray layouts."""
    if mat.is_empty():
        return
    if mat.channels != 3:
        raise ValueError(
            f"drawing requires a 3-channel BGR Mat (got {mat.channels} channels)"
        )
    if mat.is_on_device:
        mat.set_device(fn(mat.device()))
        return
    view = torch.from_numpy(mat.array)  # (rows, cols, 3) over the padded rows
    view.copy_(fn(view))


def _draw_packed_inplace(mat: Mat, packed_fn) -> None:
    """:func:`_draw_inplace` for the packed-rows ops (..., H, W*3)."""
    _draw_inplace(mat, lambda img: packed_fn(img.reshape(mat.rows, mat.row_bytes)).reshape(img.shape))


def line(mat: Mat, p1: Point, p2: Point, color: Scalar, thickness: int = 1) -> None:
    """Draw a line segment in place (OpenCV ``line``; exact integer
    distance-field spec, golden.line_mask)."""
    _draw_packed_inplace(mat, lambda packed: _draw.line_packed(
        packed, (p1.x, p1.y), (p2.x, p2.y), color.bgr, thickness))


def circle(mat: Mat, center: Point, radius: int, color: Scalar,
           thickness: int = 1) -> None:
    """Draw a circle in place (OpenCV ``circle``; thickness < 0 fills)."""
    _draw_packed_inplace(mat, lambda packed: _draw.circle_packed(
        packed, (center.x, center.y), radius, color.bgr, thickness))


def polylines(mat: Mat, pts, color: Scalar, thickness: int = 1,
              closed: bool = False) -> None:
    """Draw connected segments through ``pts`` [K, 2] (x, y) (OpenCV
    ``polylines`` role; per-segment golden.line_mask spec)."""
    p = np.asarray(pts, np.int64).reshape(-1, 2)
    for i in range(len(p) - 1):
        line(mat, Point(int(p[i][0]), int(p[i][1])),
             Point(int(p[i + 1][0]), int(p[i + 1][1])), color, thickness)
    if closed and len(p) > 2:
        line(mat, Point(int(p[-1][0]), int(p[-1][1])),
             Point(int(p[0][0]), int(p[0][1])), color, thickness)


def ellipse(mat: Mat, center: Point, axes, angle: float, color: Scalar,
            thickness: int = 1) -> None:
    """Draw a rotated ellipse in place (OpenCV ``ellipse`` full-arc role;
    frozen float64 spec golden.ellipse_mask). The mask is computed on the
    host, as in the reference, and painted where the Mat is. ``thickness <
    0`` fills."""
    if mat.is_empty():
        return
    mask = golden.ellipse_mask(
        mat.rows, mat.cols, (center.x, center.y),
        (int(axes[0]), int(axes[1])), angle, thickness,
    )
    _draw_packed_inplace(mat, lambda packed: _draw.paint_mask_packed(packed, mask, color.bgr))


def fill_poly(mat: Mat, pts, color: Scalar) -> None:
    """Fill a polygon in place (OpenCV ``fillPoly`` single-polygon role;
    exact-integer even-odd spec golden.fill_poly_mask, boundary included)."""
    p = np.asarray(pts, np.int32).reshape(-1, 2)
    if len(p) < 3:
        raise ValueError("fill_poly needs >= 3 vertices")
    _draw_packed_inplace(mat, lambda packed: _draw.fill_poly_packed(packed, p, color.bgr))


def arrowed_line(mat: Mat, p1: Point, p2: Point, color: Scalar,
                 thickness: int = 1, tip_length: float = 0.1) -> None:
    """Arrow from p1 to p2 (OpenCV ``arrowedLine``): the shaft plus two
    head strokes at ±π/4 off the reverse direction, head length
    ``tip_length``·|p2−p1| (endpoints rounded half-away like OpenCV)."""
    import math

    line(mat, p1, p2, color, thickness)
    dx, dy = p1.x - p2.x, p1.y - p2.y
    L = math.hypot(dx, dy)
    if L == 0:
        return
    tip = tip_length * L
    ang = math.atan2(dy, dx)
    for da in (math.pi / 4, -math.pi / 4):
        hx = int(math.floor(p2.x + tip * math.cos(ang + da) + 0.5))
        hy = int(math.floor(p2.y + tip * math.sin(ang + da) + 0.5))
        line(mat, Point(hx, hy), p2, color, thickness)


def rectangle(mat: Mat, rect: Rect, color: Scalar, thickness: int = 1) -> None:
    """Draw a rectangle outline in place (drawing.rs:67-106 semantics; past
    the last column it clips, as the reference's device path does)."""
    _draw_inplace(mat, lambda img: _draw.rectangle(
        img, (rect.x, rect.y, rect.width, rect.height), color.bgr, thickness))


def put_text(mat: Mat, text: str, org: Point, font_scale: float, color: Scalar) -> None:
    """Render text with ``org`` as the baseline origin (drawing.rs:123-163):
    the glyph mask from the host rasterizer, blended on the device for a
    device Mat (the mask uploaded from pinned memory, no blocking copy) and
    in place for a host Mat."""
    if mat.is_empty():
        return
    mask, dx, dy = _text.rasterize(text, font_scale)
    if mat.is_on_device:
        if mat.channels != 3:
            raise ValueError(f"drawing requires a 3-channel BGR Mat (got {mat.channels} channels)")
        mat.set_device(_draw.blend_mask_at(mat.device(), mask, org.x + dx, org.y + dy, color.bgr))
        return
    golden.blend_mask(mat.array, mask, org.x + dx, org.y + dy, color.bgr)


# ---------------------------------------------------------------------------
# Processing ops (the same port functions on the device or on the CPU)
# ---------------------------------------------------------------------------


def _apply(mat: Mat, fn) -> Mat:
    """``fn`` on the Mat's tensor: a device Mat gives a device Mat, a host
    Mat a host Mat (computed on a CPU tensor)."""
    if mat.is_on_device:
        return Mat.from_device(fn(mat.device()))
    out = fn(torch.from_numpy(mat.to_numpy()))
    return Mat.from_array(out.numpy(), device=mat.target)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """The single-channel plane of an (H, W, 3) BGR (exact luma) or (H, W[,
    1]) gray image."""
    if img.ndim == 3 and img.shape[-1] == 3:
        return _color.bgr_to_gray(img)
    return img.squeeze()


def cvt_gray(mat: Mat) -> Mat:
    """BGR → gray (integer BT.601 luma)."""
    return _apply(mat, _color.bgr_to_gray)


def resize(mat: Mat, width: int, height: int, interpolation: str = "bilinear") -> Mat:
    """Resize, "bilinear" (11-bit fixed-point, golden.resize_bilinear). The
    reference's "nearest", "area" and "cubic" modes are not ported."""
    if interpolation in ("nearest", "area", "cubic"):
        raise not_ported(f"resize(interpolation={interpolation!r})", item="10 and 14")
    if interpolation != "bilinear":
        raise ValueError(
            f"unknown interpolation {interpolation!r} "
            "(bilinear, nearest, area, cubic)"
        )
    return _apply(mat, lambda img: _resize.resize_bilinear(img, width, height))


def gaussian_blur(mat: Mat, ksize: int = 5, sigma: float = -1.0) -> Mat:
    """Gaussian blur, replicate border: the default 5×5 frozen integer spec
    (golden.gaussian5_u8). Another ``ksize`` or ``sigma`` (the reference's
    float-kernel path) is not ported."""
    if ksize != 5 or sigma >= 0:
        raise not_ported(f"gaussian_blur(ksize={ksize}, sigma={sigma})", item="14")
    return _apply(mat, _filters.gaussian5_u8)


def sobel_magnitude(mat: Mat) -> Mat:
    """gray(BGR input ok) → Sobel → exact |∇| u8."""
    return _apply(mat, lambda img: _filters.gradient_magnitude_u8(
        *_filters.sobel3_gray(_gray(img))))


def canny(mat: Mat, low: int = 40, high: int = 90) -> Mat:
    """Canny edges (frozen integer spec, golden.canny). BGR input is
    converted to gray first; returns a u8 edge mask Mat."""
    return _apply(mat, lambda img: _filters.canny_u8(_gray(img), low, high))


def harris_corners(mat: Mat, k: float = 0.04, threshold_rel: float = 0.01,
                   nms_radius: int = 1) -> np.ndarray:
    """Corner mask (H, W) bool (golden.harris_corners). On a CUDA Mat the
    fixed-point response is the Harris kernel (K6)."""
    img = mat.device() if mat.is_on_device else torch.from_numpy(mat.to_numpy())
    corners = _features.harris_corners(_gray(img), k=k, threshold_rel=threshold_rel,
                                       nms_radius=nms_radius)
    return corners.cpu().numpy()


__all__ = [
    "Point", "Rect", "Scalar", "arrowed_line", "canny", "circle", "cvt_gray",
    "ellipse", "fill_poly", "gaussian_blur", "get_text_size", "harris_corners", "line",
    "polylines", "put_text", "rectangle", "resize", "sobel_magnitude",
]
