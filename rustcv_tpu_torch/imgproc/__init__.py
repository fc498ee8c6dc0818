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

The processing ops of ``ops.color``, ``ops.filters``, ``ops.resize`` and
``ops.features`` have their wrappers here: resize in every mode, the
blurs, pyramids, thresholds, morphology, medians, derivatives,
``filter2d``, integral images, colour conversions, range masks, moments,
corner seeds and their sub-pixel refinement. Each runs where the Mat is.
The rest of the reference module arrives with the ops it wraps (ROADMAP
Queue 1 items 3–7); its names are absent here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.mat import Mat
from ..ops import color as _color
from ..ops import draw as _draw
from ..ops import features as _features
from ..ops import filters as _filters
from ..ops import golden
from ..ops import resize as _resize
from ..ops import text as _text
from ..ops.filters import get_structuring_element
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
    return _from_tensor(mat, fn(_tensor(mat)))


def _from_tensor(mat: Mat, out: torch.Tensor) -> Mat:
    """A Mat of ``out`` on ``mat``'s side: a device Mat, or a host Mat made
    from the CPU tensor."""
    if mat.is_on_device:
        return Mat.from_device(out)
    return Mat.from_array(out.numpy(), device=mat.target)


def _tensor(mat: Mat) -> torch.Tensor:
    """The Mat's pixels as a tensor: its device tensor, or a CPU tensor of
    its host bytes."""
    return mat.device() if mat.is_on_device else torch.from_numpy(mat.to_numpy())


def _gray(img: torch.Tensor, allow_bgr: bool = True) -> torch.Tensor:
    """The single-channel (H, W) plane of an (H, W), (H, W, 1) or BGR (H, W,
    3) image. BGR converts by the exact luma when ``allow_bgr``, else
    raises (ops whose spec is gray only)."""
    if img.ndim == 3 and img.shape[-1] == 1:
        return img[..., 0]
    if img.ndim == 3 and img.shape[-1] == 3:
        if not allow_bgr:
            raise ValueError("gray (single-channel) input required")
        return _color.bgr_to_gray(img)
    if img.ndim != 2:
        raise ValueError(f"unsupported image shape {tuple(img.shape)}")
    return img


_RESIZE = {"bilinear": _resize.resize_bilinear, "nearest": _resize.resize_nearest,
           "area": _resize.resize_area, "cubic": _resize.resize_bicubic}


def resize(mat: Mat, width: int, height: int, interpolation: str = "bilinear") -> Mat:
    """Resize with a frozen spec per mode (OpenCV's INTER_* modes):
    "bilinear" (11-bit fixed point, golden.resize_bilinear), "nearest"
    (half-pixel-centre taps), "area" (exact box mean for integer
    downscales, bilinear otherwise) and "cubic" (a = −0.75, 11-bit)."""
    if interpolation not in _RESIZE:
        raise ValueError(
            f"unknown interpolation {interpolation!r} "
            "(bilinear, nearest, area, cubic)"
        )
    fn = _RESIZE[interpolation]
    return _apply(mat, lambda img: fn(img, width, height))


def gaussian_blur(mat: Mat, ksize: int = 5, sigma: float = -1.0) -> Mat:
    """Gaussian blur, replicate border. The default 5×5 runs the frozen
    integer spec (golden.gaussian5_u8); another ``ksize`` or ``sigma``
    goes through :func:`get_gaussian_kernel` and :func:`sep_filter_2d`
    (the float-kernel path, ±1 LSB)."""
    if ksize == 5 and sigma < 0:
        return _apply(mat, _filters.gaussian5_u8)
    k = get_gaussian_kernel(ksize, sigma)
    return sep_filter_2d(mat, k, k)


def get_gaussian_kernel(ksize: int, sigma: float = -1.0) -> np.ndarray:
    """1-D Gaussian taps (OpenCV ``getGaussianKernel``): float64 [k]
    normalized to sum 1; sigma <= 0 takes OpenCV's 0.3*((k-1)*0.5-1)+0.8."""
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError("ksize must be odd and positive")
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    t = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(t * t) / (2.0 * sigma * sigma))
    return k / k.sum()


def sep_filter_2d(mat: Mat, kx, ky) -> Mat:
    """Separable correlation (OpenCV ``sepFilter2D``): outer(ky, kx) through
    :func:`filter2d` (which runs a rank-1 kernel separably)."""
    return filter2d(mat, np.outer(np.asarray(ky, np.float64), np.asarray(kx, np.float64)))


def filter2d(mat: Mat, kernel) -> Mat:
    """Arbitrary-kernel correlation (OpenCV ``filter2D``): u8 saturate,
    replicate border; ``kernel`` a host (odd, odd) array
    (ops.filters.filter2d_u8)."""
    return _apply(mat, lambda img: _filters.filter2d_u8(img, kernel))


def adaptive_threshold(mat: Mat, maxval: int = 255, method: str = "mean",
                       block: int = 11, c: int = 2, inv: bool = False) -> Mat:
    """OpenCV ``adaptiveThreshold``: T = the block×block mean (or the 5×5
    Gaussian spec) − c; gray input only (a BGR Mat raises)."""
    g = _gray(_tensor(mat), allow_bgr=False)
    return _from_tensor(mat, _filters.adaptive_threshold_u8(g, maxval, method, block, c, inv))


def bilateral_filter(mat: Mat, sigma: int = 25) -> Mat:
    """Edge-preserving 5×5 bilateral filter (OpenCV ``bilateralFilter``
    role; the integer quadratic-ramp range kernel of golden.bilateral5_u8).
    Gray input only."""
    return _from_tensor(mat, _filters.bilateral5_u8(_gray(_tensor(mat), allow_bgr=False), sigma))


def pyr_down(mat: Mat) -> Mat:
    """Image-pyramid downsample: 5×5 Gaussian and even-index decimation
    (OpenCV pyrDown's shapes; golden.pyr_down)."""
    return _apply(mat, _filters.pyr_down)


def pyr_up(mat: Mat) -> Mat:
    """Image-pyramid upsample to (2H, 2W) (OpenCV pyrUp role;
    golden.pyr_up)."""
    return _apply(mat, _filters.pyr_up)


def stack_blur(mat: Mat, kw: int, kh: int = None) -> Mat:
    """StackBlur (separable triangle, replicate border, the stackblur
    fixed-point divider; golden.stack_blur_u8)."""
    return _apply(mat, lambda img: _filters.stack_blur_u8(img, kw, kw if kh is None else kh))


def box_blur(mat: Mat, ksize: int = 3) -> Mat:
    """k×k box blur, replicate border, the rounded integer mean."""
    return _apply(mat, lambda img: _filters.box_blur_u8(img, ksize))


def cvt_gray(mat: Mat) -> Mat:
    """BGR → gray (integer BT.601 luma)."""
    return _apply(mat, _color.bgr_to_gray)


def cvt_hsv(mat: Mat) -> Mat:
    """BGR → HSV u8 (OpenCV 8-bit convention, H ∈ [0, 180)); the exact
    all-integer spec golden.bgr_to_hsv."""
    return _apply(mat, _color.bgr_to_hsv)


def cvt_hsv_to_bgr(mat: Mat) -> Mat:
    """HSV u8 (H ∈ [0, 180)) → BGR (golden.hsv_to_bgr); round-trips
    :func:`cvt_hsv` within ±4 LSB (H is quantized to 2°)."""
    return _apply(mat, _color.hsv_to_bgr)


def cvt_ycrcb(mat: Mat) -> Mat:
    """BGR → YCrCb u8 (14-bit fixed point; golden.bgr_to_ycrcb)."""
    return _apply(mat, _color.bgr_to_ycrcb)


def cvt_ycrcb_to_bgr(mat: Mat) -> Mat:
    """YCrCb u8 → BGR (golden.ycrcb_to_bgr)."""
    return _apply(mat, _color.ycrcb_to_bgr)


def cvt_lab(mat: Mat) -> Mat:
    """BGR → CIE L*a*b* u8 (OpenCV 8-bit convention; golden.bgr_to_lab
    within ±1 LSB)."""
    return _apply(mat, _color.bgr_to_lab)


def cvt_lab_to_bgr(mat: Mat) -> Mat:
    """Lab u8 → BGR (golden.lab_to_bgr within ±1 LSB)."""
    return _apply(mat, _color.lab_to_bgr)


def in_range(mat: Mat, lower, upper) -> Mat:
    """Per-channel inclusive range mask → u8 {0, 255} Mat (OpenCV
    ``inRange``)."""
    return _apply(mat, lambda img: _color.in_range(img, lower, upper))


def moments(mat: Mat) -> dict:
    """Raw spatial moments m00/m10/m01 (and the centroid when nonempty) of a
    u8 mask or gray Mat (OpenCV ``moments``), exact: int64 row partials
    where the Mat is, summed on the host."""
    return _color.moments(_tensor(mat))


def threshold(mat: Mat, thresh: int, maxval: int = 255, type: str = "binary") -> Mat:
    """Element-wise threshold (binary, binary_inv, trunc, tozero,
    tozero_inv)."""
    return _apply(mat, lambda img: _filters.threshold_u8(img, thresh, maxval, type=type))


def erode(mat: Mat, ksize: int = 3) -> Mat:
    """k×k erosion (window minimum), replicate border."""
    return _apply(mat, lambda img: _filters.erode_u8(img, ksize))


def dilate(mat: Mat, ksize: int = 3) -> Mat:
    """k×k dilation (window maximum), replicate border."""
    return _apply(mat, lambda img: _filters.dilate_u8(img, ksize))


def erode_kernel(mat: Mat, kernel) -> Mat:
    """Erosion over an arbitrary bool structuring element (see
    :func:`get_structuring_element`)."""
    return _apply(mat, lambda img: _filters.erode_kernel_u8(img, kernel))


def dilate_kernel(mat: Mat, kernel) -> Mat:
    """Dilation over an arbitrary bool structuring element."""
    return _apply(mat, lambda img: _filters.dilate_kernel_u8(img, kernel))


def morphology_ex(mat: Mat, op: str, ksize: int = 3) -> Mat:
    """Compound morphology (OpenCV ``morphologyEx``): op in ("open",
    "close", "gradient", "tophat", "blackhat")."""
    return _apply(mat, lambda img: _filters.morphology_ex_u8(img, op, ksize))


def median_blur(mat: Mat, ksize: int = 3) -> Mat:
    """k×k median filter (odd k, exact): the exchange network at k = 3,
    the windows' order statistic otherwise."""
    if ksize == 3:
        return _apply(mat, _filters.median3_u8)
    return _apply(mat, lambda img: _filters.median_u8(img, ksize))


def integral(mat: Mat) -> np.ndarray:
    """Summed-area table (OpenCV ``integral``): (H+1, W+1) int64 with a zero
    top row and left column (a BGR Mat is summed as its gray)."""
    return _filters.integral_u8(_gray(_tensor(mat))).cpu().numpy()


def sobel(mat: Mat, dx: int = 1, dy: int = 0, ksize: int = 3) -> np.ndarray:
    """Directional derivative (OpenCV ``Sobel`` role, signed output): gray
    (a BGR Mat converts by the exact luma) → int32 (H, W), the exact
    integer separable kernels of ``getDerivKernels``."""
    return _filters.sobel_xy(_gray(_tensor(mat)), dx, dy, ksize).cpu().numpy()


def laplacian(mat: Mat) -> np.ndarray:
    """3×3 Laplacian (OpenCV ``Laplacian`` ksize=1 role): gray → signed
    int32 (H, W), replicate border (golden.laplacian3)."""
    return _filters.laplacian3(_gray(_tensor(mat))).cpu().numpy()


def scharr(mat: Mat, dx: int = 1, dy: int = 0) -> np.ndarray:
    """Scharr 3×3 derivative (OpenCV ``Scharr``): (dx, dy) = (1, 0) or
    (0, 1); signed int32 (H, W) (golden.scharr3_gray)."""
    if (dx, dy) not in ((1, 0), (0, 1)):
        raise ValueError("scharr requires (dx, dy) of (1, 0) or (0, 1)")
    gx, gy = _filters.scharr3_gray(_gray(_tensor(mat)))
    return (gx if dx else gy).cpu().numpy()


def corner_sub_pix(mat: Mat, pts, win: int = 11, iters: int = 10) -> np.ndarray:
    """Sub-pixel corner refinement (OpenCV ``cornerSubPix``): float32
    [K, 2] (x, y) in → refined out, all points at once where the Mat is
    (ops.features.corner_sub_pix)."""
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    return _features.corner_sub_pix(_gray(_tensor(mat)), pts, win=win, iters=iters).cpu().numpy()


def good_features_to_track(mat: Mat, max_corners: int = 256, **kw) -> np.ndarray:
    """Corner seeds for tracking (OpenCV ``goodFeaturesToTrack`` role,
    Harris scoring): float32 [K, 2] (x, y), K ≤ max_corners, strongest
    first, equal responses in row-major order. On a CUDA Mat the response
    is the Harris kernel (K6)."""
    gray = _gray(_tensor(mat))
    h, w = gray.shape
    coords, valid = _features.harris_corner_list(gray, max_corners=min(max_corners, h * w), **kw)
    coords = coords[valid].cpu().numpy()
    return coords[:, ::-1].astype(np.float32)


def good_features_to_track_with_quality(mat: Mat, max_corners: int = 256, **kw):
    """OpenCV ``goodFeaturesToTrackWithQuality`` role → (points float32
    [K, 2] (x, y), quality float32 [K]: the fixed-point Harris response at
    each corner)."""
    pts = good_features_to_track(mat, max_corners=max_corners, **kw)
    resp = _features.harris_response_i32(_gray(_tensor(mat)),
                                          k_num=int(round(kw.get("k", 0.04) * 1024)))
    xs = pts[:, 0].astype(np.int64)
    ys = pts[:, 1].astype(np.int64)
    return pts, resp.cpu().numpy()[ys, xs].astype(np.float32)


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
    corners = _features.harris_corners(_gray(_tensor(mat)), k=k, threshold_rel=threshold_rel,
                                       nms_radius=nms_radius)
    return corners.cpu().numpy()


__all__ = [
    "Point", "Rect", "Scalar", "adaptive_threshold", "arrowed_line", "bilateral_filter",
    "box_blur", "canny", "circle", "corner_sub_pix", "cvt_gray", "cvt_hsv", "cvt_hsv_to_bgr",
    "cvt_lab", "cvt_lab_to_bgr", "cvt_ycrcb", "cvt_ycrcb_to_bgr", "dilate", "dilate_kernel",
    "ellipse", "erode", "erode_kernel", "fill_poly", "filter2d", "gaussian_blur",
    "get_gaussian_kernel", "get_structuring_element", "get_text_size",
    "good_features_to_track", "good_features_to_track_with_quality", "harris_corners",
    "in_range", "integral", "laplacian", "line", "median_blur", "moments", "morphology_ex",
    "polylines", "put_text", "pyr_down", "pyr_up", "rectangle", "resize", "scharr",
    "sep_filter_2d", "sobel", "sobel_magnitude", "stack_blur", "threshold",
]
