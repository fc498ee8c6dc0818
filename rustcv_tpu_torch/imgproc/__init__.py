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

So do the wrappers of the second block: the arithmetic of ``ops.arith``
(saturating add/subtract, ``addWeighted``, bitwise ops, norms,
``normalize``), the histograms of ``ops.hist`` (``calcHist``,
``equalizeHist``, ``LUT``, colormaps, CLAHE, hue backprojection), the
warps of ``ops.warp`` (affine, perspective, ``remap``, polar), thinning and
anisotropic diffusion (``ops.morphx``), ``flip``, the contour and
chessboard draws; a device Mat takes the tensor op, a host Mat the
reference's numpy form. ``ops.core_ops`` (``split``/``merge``, polar
coordinates, reductions, small linear algebra, ``RNG``), ``ops.blend``'s
multi-band blend and gains and the host modules (contour geometry,
``emd``, epipolar geometry, homographies, barcodes, k-NN, Delaunay, TSDF,
octree) are re-exported as the reference does.

The features and flow of group 2 follow the same rule: corner responses,
FAST, BRIEF/ORB, SIFT, AKAZE, HOG, Lucas–Kanade, Farnebäck, DIS with its
variational refinement, TV-L1, template matching, the DFT/DCT, phase
correlation and ECC; keypoint, flow and response wrappers return numpy
arrays as the reference's do. So do those of group 3 and the head of
group 4: the MOG2 and KNN background subtractors (their masks stay on a
device frame's device), mean-shift filtering, connected components,
contours, flood fill, the distance transforms, blobs, k-means, watershed,
SLIC and the Voronoi seam. And so do those of group 4a: the Hough
transforms (lines, segments, circles, the generalized Hough), stereo BM
and SGBM, NL-means, the guided and domain-transform filters with the photo
ops, Poisson editing, inpainting, HDR fusion, merges and tonemaps, Haar
cascades, QR codes, MSER, line segments, GrabCut, intelligent scissors,
the colour checker and the drawing helpers of ``ops.viz``. And so do those
of group 4b, the geometry chain: the camera model, calibration, PnP and
undistortion (``ops.calib``, ``ops.calib_ext``), the chessboard, SB and
circle-grid detectors, ArUco markers, point clouds, meshes, the
rasterizer and normals (``ops.threed``), RGB-D odometry and stitching.
Every name of the reference module's ``__all__`` is here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.mat import Mat
from ..ops import arith as _arith
from ..ops import color as _color
from ..ops import draw as _draw
from ..ops import features as _features
from ..ops import filters as _filters
from ..ops import geometry as _geometry
from ..ops import golden
from ..ops import hist as _hist
from ..ops import morphx as _morphx
from ..ops import resize as _resize
from ..ops import text as _text
from ..ops import warp as _warp
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


# ---------------------------------------------------------------------------
# The second block of ops (arith, hist, warp, morphx, blend, core_ops and the
# host modules). Each wrapper runs where the Mat is, as the reference's
# ``_apply(mat, device_fn, host_fn)``: a device Mat takes the port's tensor
# op on its tensor, a host Mat the reference's numpy form on its bytes.
# ---------------------------------------------------------------------------


def _dispatch(mat: Mat, device_fn, host_fn) -> Mat:
    if mat.is_on_device:
        return Mat.from_device(device_fn(mat.device()))
    return Mat.from_array(np.ascontiguousarray(host_fn(mat.to_numpy())), device=mat.target)


def _gray_of_mat(mat: Mat, allow_bgr: bool = True):
    """The single-channel plane of a Mat: a tensor on the Mat's device, or
    a host numpy array. BGR converts by the exact luma when ``allow_bgr``,
    else raises (ops whose spec is gray only)."""
    if mat.is_on_device:
        return _gray(mat.device(), allow_bgr)
    return _gray(torch.from_numpy(mat.to_numpy()), allow_bgr).numpy()


def _squeeze1(a):
    return a[..., 0] if a.ndim == 3 and a.shape[-1] == 1 else a


def _pair(a: Mat, b: Mat):
    """Aligned tensors of two Mats (on the device Mat's device if either
    is on one, else CPU tensors of the host bytes), trailing 1-channels
    squeezed, and whether the result goes back to a device Mat."""
    on_device = a.is_on_device or b.is_on_device
    dev = (a if a.is_on_device else b).device().device if on_device else torch.device("cpu")
    x, y = (_squeeze1(m.device() if m.is_on_device else torch.from_numpy(m.to_numpy())).to(dev)
            for m in (a, b))
    return x, y, on_device


def _binary(a: Mat, b: Mat, fn) -> Mat:
    x, y, dev = _pair(a, b)
    out = fn(x, y)
    return Mat.from_device(out) if dev else Mat.from_array(out.numpy(), device=a.target)


def add(a: Mat, b: Mat) -> Mat:
    """Saturating u8 add (ops.arith)."""
    return _binary(a, b, _arith.add_u8)


def subtract(a: Mat, b: Mat) -> Mat:
    """Saturating u8 subtract."""
    return _binary(a, b, _arith.subtract_u8)


def absdiff(a: Mat, b: Mat) -> Mat:
    """|a − b| per element."""
    return _binary(a, b, _arith.absdiff_u8)


def add_weighted(a: Mat, alpha: float, b: Mat, beta: float,
                 gamma: float = 0.0) -> Mat:
    """αa + βb + γ with u8 saturation (OpenCV ``addWeighted``)."""
    return _binary(a, b, lambda x, y: _arith.add_weighted_u8(
        x, float(alpha), y, float(beta), float(gamma)))


def convert_scale_abs(mat: Mat, alpha: float = 1.0, beta: float = 0.0) -> Mat:
    """|αx + β| saturated to u8 (OpenCV ``convertScaleAbs``)."""
    return _dispatch(
        mat,
        lambda d: _arith.convert_scale_abs_u8(d, float(alpha), float(beta)),
        lambda h: _arith.convert_scale_abs_numpy(h, alpha, beta),
    )


def bitwise_and(a: Mat, b: Mat) -> Mat:
    return _binary(a, b, _arith.bitwise_and)


def bitwise_or(a: Mat, b: Mat) -> Mat:
    return _binary(a, b, _arith.bitwise_or)


def bitwise_xor(a: Mat, b: Mat) -> Mat:
    return _binary(a, b, _arith.bitwise_xor)


def bitwise_not(mat: Mat) -> Mat:
    return _dispatch(mat, _arith.bitwise_not, lambda h: ~h)


def count_non_zero(mat: Mat) -> int:
    if mat.is_on_device:
        return int(_arith.count_non_zero(mat.device()))
    return int(np.count_nonzero(mat.to_numpy()))


def norm(mat: Mat, kind: str = "l2") -> float:
    """L1 / L2 / inf norm (OpenCV ``norm`` NORM_L1/L2/INF)."""
    if mat.is_on_device:
        return float(_arith.norm_u8(mat.device(), kind=kind))
    return _arith.norm_numpy(mat.to_numpy(), kind=kind)


def mean_std_dev(mat: Mat):
    """(mean, population stddev) as floats (OpenCV ``meanStdDev``):
    float32 on a device Mat, float64 on a host Mat."""
    if mat.is_on_device:
        m, s = _arith.mean_stddev_u8(mat.device())
        return float(m), float(s)
    f = mat.to_numpy().astype(np.float64)
    return float(f.mean()), float(f.std())


def psnr(a: Mat, b: Mat) -> float:
    """PSNR in dB (OpenCV ``PSNR``)."""
    x, y, _ = _pair(a, b)
    return _arith.psnr_u8(x, y)


def normalize(mat: Mat, alpha: float = 0.0, beta: float = 255.0,
              norm_type: str = "minmax") -> Mat:
    """Normalize a u8 Mat (OpenCV ``normalize`` role; frozen f64 spec
    golden.normalize_u8 on a host Mat, float32 ±1 LSB on a device Mat):
    ``minmax`` maps the value range to [alpha, beta]; ``inf``/``l1``/``l2``
    scale the norm to ``alpha``."""
    return _dispatch(
        mat,
        lambda d: _arith.normalize_u8(d, alpha, beta, norm_type),
        lambda h: golden.normalize_u8(h, alpha, beta, norm_type),
    )


def accumulate_weighted(acc, mat: Mat, alpha: float):
    """Running average (OpenCV ``accumulateWeighted``): returns the new
    float32 accumulator (1−α)·acc + α·mat, a tensor on a device Mat's
    device or a numpy array for a host Mat. ``acc`` None starts from the
    frame."""
    if mat.is_on_device:
        src = mat.device()
        if acc is None:
            return src.to(torch.float32)
        return _arith.accumulate_weighted(acc, src, alpha)
    src = mat.to_numpy()
    if acc is None:
        return src.astype(np.float32)
    return _arith.accumulate_weighted_numpy(np.asarray(acc), src, alpha)


def calc_hist(mat: Mat) -> np.ndarray:
    """256-bin histogram (int32 counts) of a u8 gray Mat (BGR converts by
    the exact luma) — OpenCV ``calcHist`` for the single-channel case,
    counted where the Mat is; the counts come back as numpy."""
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        return _hist.calc_hist(g).cpu().numpy()
    return _hist.calc_hist_numpy(g)


def equalize_hist(mat: Mat) -> Mat:
    """Histogram equalization of a u8 gray Mat (OpenCV ``equalizeHist``;
    device and host agree bit for bit)."""
    return _dispatch(
        mat,
        lambda d: _hist.equalize_hist(_gray(d, allow_bgr=False)),
        lambda h: _hist.equalize_hist_numpy(_gray(h, allow_bgr=False)),
    )


def lut(mat: Mat, table) -> Mat:
    """Apply a 256-entry u8 lookup table per byte (OpenCV ``LUT`` — gamma
    and tone curves): a gather where the Mat is."""
    t = np.asarray(table, np.uint8).reshape(256)
    return _dispatch(mat, lambda d: _hist.apply_lut(d, t), lambda h: t[h])


def apply_color_map(mat: Mat, colormap: str = "jet") -> Mat:
    """Map a gray (or BGR-via-luma) Mat through a 256-entry colour table
    (OpenCV ``applyColorMap`` role; golden.colormap_table). Returns a BGR
    Mat where the input is."""
    table = golden.colormap_table(colormap)  # [256, 3] BGR
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        return Mat.from_device(torch.from_numpy(table).to(g.device)[g.to(torch.int64)])
    return Mat.from_array(table[g], device=mat.target)


def calc_hue_hist(mat_hsv: Mat, mask=None) -> np.ndarray:
    """Normalized 180-bin hue histogram of an HSV Mat (host; the model for
    :func:`back_project`)."""
    return _hist.calc_hue_hist(mat_hsv.to_numpy(), mask)


def back_project(mat_hsv: Mat, hue_hist) -> Mat:
    """Histogram backprojection (OpenCV ``calcBackProject``, hue channel):
    per-pixel likelihood u8 — the CamShift/mean-shift weight image — where
    the Mat is."""
    return _dispatch(mat_hsv, lambda d: _hist.back_project_hue(d, hue_hist),
                     lambda h: _hist.back_project_hue(h, hue_hist))


def _host_plane(g) -> np.ndarray:
    """A plane of :func:`_gray_of_mat` on the host (mean_shift and
    cam_shift are host numpy, as in the reference)."""
    return g.cpu().numpy() if torch.is_tensor(g) else g


def mean_shift(prob_mat: Mat, window, max_iter: int = 20):
    """OpenCV ``meanShift`` over a weight image (e.g. :func:`back_project`
    output): (iterations, (x, y, w, h)); host numpy, as the reference."""
    g = _gray_of_mat(prob_mat, allow_bgr=False)
    return _hist.mean_shift(_host_plane(g), tuple(window), max_iter=max_iter)


def cam_shift(prob_mat: Mat, window, max_iter: int = 20):
    """OpenCV ``CamShift`` (simplified, axis-aligned): ((cx, cy, w, h),
    next window) — meanShift + moment-driven window resize."""
    g = _gray_of_mat(prob_mat, allow_bgr=False)
    return _hist.cam_shift(_host_plane(g), tuple(window), max_iter=max_iter)


def clahe(mat: Mat, clip_limit: int = 40, grid=(8, 8)) -> Mat:
    """Contrast-limited adaptive histogram equalization (OpenCV
    ``createCLAHE`` role) on a u8 gray Mat — exact-integer frozen spec,
    host == device bit for bit (ops.hist.clahe)."""
    g = tuple(grid)
    gray = _gray_of_mat(mat, allow_bgr=False)
    if mat.is_on_device:
        return Mat.from_device(_hist.clahe(gray, clip_limit, g))
    return Mat.from_array(_hist.clahe_numpy(gray, clip_limit, g), device=mat.target)


def get_rotation_matrix_2d(center, angle_deg: float, scale: float = 1.0):
    """OpenCV ``getRotationMatrix2D`` (2×3 float64)."""
    return _warp.get_rotation_matrix_2d(tuple(center), angle_deg, scale)


def warp_affine(mat: Mat, m, dst_size, mode: str = "bilinear",
                border: str = "constant") -> Mat:
    """OpenCV ``warpAffine``: M (2×3) maps src→dst; ``dst_size`` = (w, h);
    bilinear (11-bit fixed point, the resize spec's rounding) or nearest;
    constant-0 or replicate border (ops.warp)."""
    return _dispatch(
        mat,
        lambda d: _warp.warp_affine(d, m, dst_size, mode, border),
        lambda h: _warp.warp_affine_numpy(h, m, dst_size, mode, border),
    )


def get_perspective_transform(src_pts, dst_pts):
    """OpenCV ``getPerspectiveTransform`` (exact 4-point 3×3 homography)."""
    return _warp.get_perspective_transform(src_pts, dst_pts)


def warp_perspective(mat: Mat, h_mat, dst_size, mode: str = "bilinear",
                     border: str = "constant") -> Mat:
    """OpenCV ``warpPerspective``: 3×3 homography (src→dst), the sampling
    spec of :func:`warp_affine` (ops.warp)."""
    return _dispatch(
        mat,
        lambda d: _warp.warp_perspective(d, h_mat, dst_size, mode, border),
        lambda h: _warp.warp_perspective_numpy(h, h_mat, dst_size, mode, border),
    )


def remap(mat: Mat, map_x, map_y, border: str = "constant") -> Mat:
    """OpenCV ``remap``: sample at float32 per-pixel source coordinates
    (the undistort/rectify primitive); the fixed-point bilinear spec of
    warp_affine (ops.warp.remap). Host maps are uploaded to a device Mat's
    device; tensor maps stay where they are."""
    if torch.is_tensor(map_x):
        return _dispatch(mat, lambda d: _warp.remap(d, map_x, map_y, border),
                         lambda h: _warp.remap_numpy(h, map_x.cpu().numpy(),
                                                     map_y.cpu().numpy(), border))
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    return _dispatch(mat, lambda d: _warp.remap(d, mx, my, border),
                     lambda h: _warp.remap_numpy(h, mx, my, border))


def rotate(mat: Mat, angle_deg: float, center=None, scale: float = 1.0) -> Mat:
    """Rotate about ``center`` (default: image centre) by ``angle_deg``
    (counter-clockwise for y-down images), same canvas size."""
    h, w = mat.rows, mat.cols
    if center is None:
        center = ((w - 1) / 2.0, (h - 1) / 2.0)
    m = get_rotation_matrix_2d(center, angle_deg, scale)
    return warp_affine(mat, m, (w, h))


def warp_polar(mat: Mat, center, max_radius: float, dst_size,
               semilog: bool = False, inverse: bool = False,
               border: str = "constant") -> Mat:
    """Polar/semilog-polar warp (OpenCV ``warpPolar`` role): rows =
    angle, cols = radius; ``inverse`` maps back to cartesian. Host map
    build + remap where the Mat is (ops.warp polar spec)."""

    def run(a):
        squeeze = a.ndim == 3 and a.shape[-1] == 1
        out = _warp.warp_polar(a[..., 0] if squeeze else a, center, max_radius,
                               dst_size, semilog, inverse, border)
        return out[..., None] if squeeze else out

    return _dispatch(mat, run, run)


def linear_polar(mat: Mat, center, max_radius: float,
                 inverse: bool = False) -> Mat:
    """Legacy OpenCV ``linearPolar`` (dst = src size)."""
    return warp_polar(mat, center, max_radius, (mat.rows, mat.cols),
                      False, inverse)


def log_polar(mat: Mat, center, max_radius: float,
              inverse: bool = False) -> Mat:
    """Legacy OpenCV ``logPolar`` (semilog radius axis, dst = src size)."""
    return warp_polar(mat, center, max_radius, (mat.rows, mat.cols),
                      True, inverse)


def thinning(mat: Mat) -> Mat:
    """Zhang-Suen skeletonization (OpenCV ximgproc ``thinning`` role;
    frozen spec in ops.morphx, device == oracle bit for bit). Input: u8
    mask (non-zero = set); returns a 255/0 u8 Mat (OpenCV's convention)."""
    if mat.is_on_device:
        d = mat.device()
        g = d.squeeze() if d.ndim == 3 else d
        return Mat.from_device(_morphx.thinning(g) * 255)
    h = mat.to_numpy().squeeze()
    return Mat.from_array(_morphx.thinning_numpy(h) * np.uint8(255), device=mat.target)


def anisotropic_diffusion(mat: Mat, alpha: float = 0.15, k: float = 20.0,
                          niters: int = 10) -> Mat:
    """Perona-Malik edge-preserving diffusion (OpenCV ximgproc
    ``anisotropicDiffusion`` role; float32 on a device Mat, the float64
    oracle on a host Mat, ±1 LSB apart)."""
    return _dispatch(
        mat,
        lambda d: _morphx.anisotropic_diffusion(d, alpha=alpha, k=k, niters=niters),
        lambda h: _morphx.anisotropic_diffusion_numpy(h, alpha=alpha, k=k, niters=niters),
    )


def flip(mat: Mat, flip_code: int = 0) -> Mat:
    """Flip: 0 = vertical (x-axis), 1 = horizontal, -1 = both (cv2 codes)."""
    dims = (0,) if flip_code == 0 else (1,) if flip_code > 0 else (0, 1)
    return _dispatch(mat, lambda d: torch.flip(d, dims=dims), lambda h: np.flip(h, axis=dims))


def draw_contours(mat: Mat, contours, contour_idx: int, color: Scalar,
                  thickness: int = 1) -> None:
    """Draw contours in place (OpenCV ``drawContours`` role):
    ``contour_idx < 0`` draws all; ``thickness < 0`` fills each polygon
    (fill_poly spec), else strokes it closed (polylines spec)."""
    sel = contours if contour_idx < 0 else [contours[contour_idx]]
    for c in sel:
        p = np.asarray(c, np.int64).reshape(-1, 2)
        if len(p) < 2:
            continue
        if thickness < 0 and len(p) >= 3:
            fill_poly(mat, p, color)
        else:
            polylines(mat, p, color, max(thickness, 1), closed=True)


def draw_chessboard_corners(mat: Mat, pattern_size, corners,
                            found: bool) -> None:
    """Overlay detected corners in place (OpenCV
    ``drawChessboardCorners`` role): found → colour-cycled circles
    chained row by row; not found → red circles only."""
    pts = np.asarray(corners, np.float64).reshape(-1, 2)
    if not found:
        for p in pts:
            circle(mat, Point(int(round(p[0])), int(round(p[1]))), 4,
                   Scalar(0, 0, 255), 1)
        return
    colors = [(0, 0, 255), (0, 128, 255), (0, 255, 255), (0, 255, 0),
              (255, 128, 0), (255, 0, 0), (255, 0, 255)]
    cols = int(pattern_size[0])
    prev = None
    for i, p in enumerate(pts):
        c = Scalar(*colors[(i // cols) % len(colors)])
        cur = Point(int(round(p[0])), int(round(p[1])))
        circle(mat, cur, 4, c, 1)
        if prev is not None:
            line(mat, prev, cur, c, 1)
        prev = cur


def hu_moments(mat: Mat) -> np.ndarray:
    """The seven Hu invariants of a u8 mask Mat (OpenCV ``HuMoments``;
    float64 on the host, as the reference)."""
    return golden.hu_moments(mat.to_numpy())


def match_shapes(mat_a: Mat, mat_b: Mat) -> float:
    """Shape-similarity distance from Hu moments (OpenCV ``matchShapes``
    I1 method; 0 = identical up to translation/scale/rotation)."""
    return golden.match_shapes(mat_a.to_numpy(), mat_b.to_numpy())


def get_gabor_kernel(ksize, sigma: float, theta: float, lambd: float,
                     gamma: float, psi: float = 3.14159265358979 / 2) -> np.ndarray:
    """Gabor filter taps (OpenCV ``getGaborKernel``): float64 (kh, kw),
    g = exp(−(x'² + γ²y'²)/2σ²)·cos(2πx'/λ + ψ) with x', y' the
    θ-rotated coordinates; ``ksize`` int or (width, height), each
    dimension auto-sized from σ when ≤ 0 (OpenCV's 3·max(σ, σ/γ)
    half-extent rule)."""
    if np.isscalar(ksize):
        kw = kh = int(ksize)
    else:
        kw, kh = int(ksize[0]), int(ksize[1])
    sigma_x = float(sigma)
    sigma_y = sigma_x / float(gamma)
    c, s = np.cos(theta), np.sin(theta)
    if kw <= 0:
        kw = 2 * int(round(max(abs(3 * sigma_x * c), abs(3 * sigma_y * s)))) + 1
    if kh <= 0:
        kh = 2 * int(round(max(abs(3 * sigma_x * s), abs(3 * sigma_y * c)))) + 1
    xs = np.arange(kw, dtype=np.float64) - (kw - 1) / 2
    ys = np.arange(kh, dtype=np.float64) - (kh - 1) / 2
    x, y = np.meshgrid(xs, ys)
    xr = x * c + y * s
    yr = -x * s + y * c
    ex = -0.5 / (sigma_x * sigma_x)
    ey = -0.5 / (sigma_y * sigma_y)
    return np.exp(ex * xr * xr + ey * yr * yr) * np.cos(
        2.0 * np.pi / float(lambd) * xr + float(psi))


def cvt_color_two_plane(y_plane, uv_plane) -> np.ndarray:
    """NV12 two-plane → BGR (OpenCV ``cvtColorTwoPlane`` with
    COLOR_YUV2BGR_NV12 role): separate (H, W) Y and (H/2, W/2, 2) or
    (H/2, W) interleaved UV planes through the BT.601 NV12 decode, on the
    host."""
    y = np.asarray(y_plane)
    uv = np.asarray(uv_plane)
    h, w = y.shape
    buf = np.concatenate([y.reshape(-1), uv.reshape(-1)]).astype(np.uint8)
    return _color.nv12_to_bgr(torch.from_numpy(buf), w, h).numpy()


def estimate_affine_partial_2d(src_pts, dst_pts, **kw):
    """RANSAC similarity estimation (OpenCV ``estimateAffinePartial2D``):
    (M 2×3 or None, inlier mask). See ops.geometry."""
    return _geometry.estimate_affine_partial_2d(src_pts, dst_pts, **kw)


def estimate_affine_2d(src_pts, dst_pts, **kw):
    """RANSAC full-affine estimation (OpenCV ``estimateAffine2D``)."""
    return _geometry.estimate_affine_2d(src_pts, dst_pts, **kw)


# --- the host modules and core_ops, re-exported as the reference does -----
from ..ops.barcode import detect_and_decode as detect_barcodes  # noqa: E402
from ..ops.barcode import encode_ean13  # noqa: E402
from ..ops.blend import gain_compensation, multi_band_blend  # noqa: E402
from ..ops.core_ops import (  # noqa: E402  (re-exports)
    RNG,
    accumulate,
    accumulate_product,
    accumulate_square,
    apply_ccm,
    batch_distance,
    blend_linear,
    blur,
    border_interpolate,
    box_filter,
    build_mst,
    calc_covar_matrix,
    cart_to_polar,
    check_range,
    color_correction_matrix,
    compare,
    compare_hist,
    complete_symm,
    convert_points_from_homogeneous,
    convert_points_to_homogeneous,
    copy_make_border,
    copy_to,
    create_hanning_window,
    cube_root,
    determinant,
    div_spectrums,
    eigen,
    eigen_non_symmetric,
    extract_channel,
    fast_atan2,
    find_non_zero,
    finite_mask,
    flip_nd,
    gemm,
    get_affine_transform,
    get_rect_sub_pix,
    has_non_zero,
    hconcat,
    insert_channel,
    integral2,
    integral3,
    invert,
    invert_affine_transform,
    magnitude,
    mahalanobis,
    mat_mul_deriv,
    mix_channels,
    mul_transposed,
    patch_nans,
    pca_back_project,
    pca_compute,
    pca_project,
    perspective_transform,
    phase,
    polar_to_cart,
    rand_shuffle,
    rectangle_intersection_area,
    reduce_arg_max,
    reduce_arg_min,
    scale_add,
    set_identity,
    solve,
    solve_cubic,
    solve_lp,
    solve_poly,
    sort_idx,
    split,
    sqr_box_filter,
    sum_elems,
    sv_back_subst,
    sv_decomp,
    threshold_with_mask,
    trace,
    transpose_nd,
    vconcat,
)
from ..ops.core_ops import divide_u8 as divide  # noqa: E402
from ..ops.core_ops import merge_channels as merge  # noqa: E402
from ..ops.core_ops import multiply_u8 as multiply  # noqa: E402
from ..ops.core_ops import reduce_mat as reduce  # noqa: E402
from ..ops.core_ops import repeat_mat as repeat  # noqa: E402
from ..ops.core_ops import sort_mat as sort  # noqa: E402
from ..ops.core_ops import transform_points as transform  # noqa: E402
from ..ops.core_ops import transpose_mat as transpose  # noqa: E402
from ..ops.emd import emd  # noqa: E402
from ..ops.epipolar import (  # noqa: E402  (re-exports)
    compute_correspond_epilines,
    correct_matches,
    decompose_essential_mat,
    find_essential_mat,
    find_fundamental_mat,
    recover_pose,
    triangulate_points,
)
from ..ops.geometry import find_homography  # noqa: E402
from ..ops.knn_index import KnnIndex, radius_search  # noqa: E402
from ..ops.octree import Octree  # noqa: E402
from ..ops.shape import (  # noqa: E402  (re-exports)
    approx_poly_dp,
    approx_poly_n,
    arc_length,
    bounding_rect,
    box_points,
    contour_area,
    convex_hull,
    convex_hull_indices,
    convexity_defects,
    fit_ellipse,
    fit_ellipse_ams,
    fit_ellipse_direct,
    fit_line,
    intersect_convex_convex,
    is_contour_convex,
    min_area_rect,
    min_enclosing_circle,
    min_enclosing_convex_polygon,
    min_enclosing_triangle,
    point_polygon_test,
    rotated_rectangle_intersection,
)
from ..ops.subdiv import Subdiv2D  # noqa: E402
from ..ops.tsdf import TsdfVolume  # noqa: E402
from ..ops.warp import convert_maps  # noqa: E402


# ---------------------------------------------------------------------------
# Group 2: features and flow (corner responses, FAST, BRIEF/ORB, SIFT, AKAZE,
# HOG, LK, Farnebäck, DIS, variational refinement, TV-L1, template matching,
# the DFT/DCT, phase correlation, ECC). A device Mat runs the tensor op on its
# device, a host Mat the reference's numpy form; keypoint, flow and response
# wrappers return numpy arrays, as the reference's do.
# ---------------------------------------------------------------------------


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _pair_grays(a: Mat, b: Mat):
    """Gray planes of two Mats as tensors on the device Mat's device when
    either is on one (the other uploaded there), else host numpy arrays,
    and whether the pair is on a device."""
    on_device = a.is_on_device or b.is_on_device
    ga, gb = _gray_of_mat(a), _gray_of_mat(b)
    if not on_device:
        return ga, gb, False
    dev = (a if a.is_on_device else b).device().device
    return torch.as_tensor(ga, device=dev), torch.as_tensor(gb, device=dev), True


def fast_corners(mat: Mat, threshold: int = 20, n: int = 9, max_corners: int = 256,
                 nms: bool = True):
    """FAST-n corners (features2d ``FastFeatureDetector`` role): float32
    [K, 2] (x, y) points, strongest first (ops.fast; equal scores lowest
    flat index first on either side)."""
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        coords, valid = _fast.fast_corner_list(g, threshold=threshold, n=n,
                                               max_corners=max_corners, nms=nms)
        coords = _host(coords[valid])
    else:
        mask, score = _fast.fast_corners_numpy(g, threshold=threshold, n=n, nms=nms)
        ys, xs = np.nonzero(mask)
        order = np.argsort(-score[ys, xs], kind="stable")[:max_corners]
        coords = np.stack([ys[order], xs[order]], axis=-1)
    return coords[:, ::-1].astype(np.float32)


def compute_brief(mat: Mat, pts):
    """BRIEF-256 descriptors at float32 (x, y) keypoints → (u32 [K, 8],
    valid bool [K]); upright, frozen pair pattern (ops.brief)."""
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        desc, valid = _brief.brief_descriptors(g, pts)
        return _host(desc), _host(valid)
    return _brief.brief_descriptors_numpy(g, pts)


def match_descriptors(d1, d2, valid1=None, valid2=None, ratio: float = 0.8):
    """Hamming matching (XOR + popcount, Lowe ratio + cross-check) → int32
    [M, 2] (index into d1, index into d2). See ops.brief."""
    return _brief.match_descriptors(d1, d2, valid1, valid2, ratio)


def orb_features(mat: Mat, max_keypoints: int = 512, threshold: int = 20):
    """ORB-style features (OpenCV ``ORB`` role): FAST corners → intensity-
    centroid orientation → steered BRIEF-256. Returns (pts float32 [K, 2]
    (x, y), angles float32 [K] radians, desc u32 [K, 8], valid bool [K])."""
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        yx, vk = _fast.fast_corner_list(g, threshold=threshold, max_corners=max_keypoints)
        pts = torch.stack([yx[:, 1], yx[:, 0]], dim=-1).to(torch.float32)
        ang = _brief.orb_orientations(g, pts)
        desc, vd = _brief.orb_descriptors(g, pts, ang)
        return _host(pts), _host(ang), _host(desc), _host(vk & vd)
    mask, score = _fast.fast_corners_numpy(g, threshold=threshold)
    ys, xs = np.nonzero(mask)
    order = np.argsort(-score[ys, xs], kind="stable")[:max_keypoints]
    pts = np.stack([xs[order], ys[order]], axis=-1).astype(np.float32)
    ang = _brief.orb_orientations_numpy(g, pts)
    desc, vd = _brief.orb_descriptors_numpy(g, pts, ang)
    return pts, ang.astype(np.float32), desc, vd


def calc_optical_flow_pyr_lk(prev: Mat, nxt: Mat, pts, win: int = 21, levels: int = 3,
                             iters: int = 10):
    """Pyramidal Lucas–Kanade sparse flow (OpenCV ``calcOpticalFlowPyrLK``):
    track float32 (x, y) points from ``prev`` to ``nxt`` → (next_pts [N, 2]
    float32, status [N] bool). All points track at once on the device
    (ops.optflow)."""
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    gp, gn, on_device = _pair_grays(prev, nxt)
    if on_device:
        nxt_pts, st = _optflow.calc_optical_flow_pyr_lk(gp, gn, pts, win=win, levels=levels,
                                                        iters=iters)
        return _host(nxt_pts), _host(st)
    nxt_pts, st = _optflow.calc_optical_flow_pyr_lk_numpy(gp, gn, pts, win=win, levels=levels,
                                                          iters=iters)
    return nxt_pts.astype(np.float32), st


def calc_optical_flow_farneback(prev: Mat, nxt: Mat, levels: int = 3, winsize: int = 13,
                                iterations: int = 3, poly_n: int = 5,
                                poly_sigma: float = 1.1):
    """Dense flow by polynomial expansion (OpenCV
    ``calcOpticalFlowFarneback`` role) → float32 (H, W, 2) [fx, fy] with
    prev(p) ~ next(p + flow(p)) (ops.farneback)."""
    gp, gn, on_device = _pair_grays(prev, nxt)
    kw = dict(levels=levels, winsize=winsize, iterations=iterations, poly_n=poly_n,
              poly_sigma=poly_sigma)
    if on_device:
        return _host(_farneback.farneback_flow(gp, gn, **kw))
    return _farneback.farneback_flow_numpy(gp, gn, **kw)


_DIS_PRESETS = {"ultrafast": (2, 5, False), "fast": (2, 8, False),
                "medium": (1, 12, True)}


def calc_optical_flow_dis(prev: Mat, nxt: Mat, finest_scale: int = 1, iters: int = 8,
                          refine: bool = False, preset: str = None):
    """DIS dense optical flow (OpenCV ``DISOpticalFlow`` role, ops.disflow);
    ``refine=True`` adds the variational polish (ops.varref), ``preset``
    ("ultrafast"/"fast"/"medium", OpenCV's DIS presets) overrides the
    scale/iteration/refinement knobs. Returns float32 flow [H, W, 2] (u, v)
    with I1(x+u) ~= I0(x). On a device Mat the flow and its refinement run
    on the device (the reference refines on the host; the two agree within
    its device-vs-oracle tolerance)."""
    if preset is not None:
        finest_scale, iters, refine = _DIS_PRESETS[preset]
    g0 = _gray_of_mat(prev)
    g1 = _gray_of_mat(nxt)
    if prev.is_on_device:
        g1 = torch.as_tensor(g1, device=g0.device)
        flow = _disflow.dis_flow(g0, g1, finest_scale, iters)
        if refine:
            flow = _varref.variational_refine(g0, g1, flow)
        return _host(flow)
    g1 = _host(g1)
    flow = _disflow.dis_flow_numpy(g0, g1, finest_scale, iters)
    if refine:
        flow = _varref.variational_refine_numpy(g0, g1, flow).astype(np.float32)
    return flow


def match_template(mat: Mat, tmpl: Mat, method: str = "ccoeff_normed"):
    """OpenCV ``matchTemplate``: grayscale correlation search (BGR inputs
    converted by the exact luma) → float32 response map (H−th+1, W−tw+1)
    as a numpy array; feed it to :func:`min_max_loc` (ops.template)."""
    g, t, on_device = _pair_grays(mat, tmpl)
    if on_device:
        return _host(_template.match_template(g, t, method))
    return _template.match_template_numpy(g, t, method).astype(np.float32)


def min_max_loc(resp):
    """(min_val, max_val, (min_x, min_y), (max_x, max_y)) — OpenCV
    ``minMaxLoc`` over a response map (first extremum in raster order)."""
    return _template.min_max_loc(resp)


def denoise_tvl1(observations, lam: float = 1.0, niters: int = 30):
    """Multi-observation TV-L1 denoising (OpenCV ``denoise_TVL1`` role):
    list of u8 frames → u8 numpy image; device Mats run the tensor loop on
    their device (ops.tvl1)."""
    dev_mats = [m for m in observations if getattr(m, "is_on_device", False)]
    if dev_mats:
        dev = dev_mats[0].device().device
        stack = torch.stack([torch.as_tensor(_gray_of_mat(m) if isinstance(m, Mat)
                                             else np.asarray(m), device=dev)
                             for m in observations])
        return _host(_tvl1.denoise_tvl1(stack, lam=lam, niters=niters))
    arrays = [m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m) for m in observations]
    return _tvl1.denoise_tvl1_numpy(arrays, lam=lam, niters=niters)


def hog_descriptor(mat: Mat):
    """HOG block grid (OpenCV ``HOGDescriptor.compute`` role) of a gray Mat
    with 8-multiple dims → float32 [H/8−1, W/8−1, 36] (ops.hog)."""
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        return _host(_hog.hog_blocks(g))
    return _hog.hog_blocks_numpy(g).astype(np.float32)


def hog_detect_multi_scale(mat: Mat, svm_weights, svm_bias: float, threshold: float = 0.0,
                           scale: float = 1.2):
    """Sliding-window linear-SVM detection over a scale pyramid (OpenCV
    ``HOGDescriptor.detectMultiScale`` role) → (boxes [N, 4] xywh, scores);
    a device Mat scores on its device."""
    return _hog.detect_multi_scale(_gray_of_mat(mat), svm_weights, svm_bias,
                                   threshold=threshold, scale=scale)


def akaze_features(mat: Mat, n_octaves: int = 4, n_sublevels: int = 4,
                   threshold: float = 0.001, max_keypoints: int = 2000):
    """AKAZE keypoints + descriptors (OpenCV ``AKAZE`` role) → (keypoints
    float32 [N, 6], descriptors u8 [N, 64]); a device Mat builds the FED
    scale space on its device, the sparse stage is host float64
    (ops.akaze). Match with :func:`match_descriptors_hamming_any`."""
    return _akaze.detect_and_compute(
        _gray_of_mat(mat), n_octaves=n_octaves, n_sublevels=n_sublevels,
        threshold=threshold, max_keypoints=max_keypoints,
        backend="device" if mat.is_on_device else "host")


def match_descriptors_hamming_any(d1, d2, ratio: float = 0.8):
    """Hamming matcher for byte descriptors of any width (AKAZE's 64 bytes,
    BRIEF/ORB's 32): ratio + cross-check (ops.akaze)."""
    return _akaze.match_descriptors_hamming(d1, d2, ratio=ratio)


def sift_features(mat: Mat, n_features: int = 0, contrast_threshold: float = 0.04,
                  edge_threshold: float = 10.0, sigma: float = 1.6,
                  double_image: bool = True):
    """SIFT keypoints + descriptors (OpenCV ``SIFT`` role) → (keypoints
    float32 [N, 6], descriptors u8 [N, 128]); a device Mat builds the
    pyramids on its device, the sparse stage is host float64 (ops.sift).
    Match with :func:`match_descriptors_l2`."""
    return _sift.detect_and_compute(
        _gray_of_mat(mat), n_features=n_features, contrast_threshold=contrast_threshold,
        edge_threshold=edge_threshold, sigma=sigma, double_image=double_image)


def phase_correlate(prev: Mat, nxt: Mat, window: bool = True):
    """Global translation by phase correlation (OpenCV ``phaseCorrelate``)
    → ((dx, dy) float32, peak response); content moved by +d from prev to
    nxt (ops.registration)."""
    gp, gn, on_device = _pair_grays(prev, nxt)
    if on_device:
        d, resp = _registration.phase_correlate(gp, gn, window=window)
        return _host(d), float(resp)
    return _registration.phase_correlate_numpy(gp, gn, window=window)


# ---------------------------------------------------------------------------
# Group 3 (stateful analytics) and the segmentation head of group 4: the
# background subtractors and mean-shift filtering; the components, contours,
# flood fill and distance transforms (ops.ccl, the native union-find); blobs,
# k-means, watershed, SLIC and the Voronoi seam. A device Mat runs the tensor
# op, a host Mat the reference's numpy form (ops.ccl is host code with a
# device L1 distance: its device Mats cost one fetch).
# ---------------------------------------------------------------------------


def create_background_subtractor_mog2(k: int = 4, **kw):
    """Per-pixel Gaussian-mixture background model (OpenCV
    ``createBackgroundSubtractorMOG2`` role; ops.bgsub): the model stays on
    the frame's device; ``apply`` on a device Mat or tensor returns a tensor
    mask there, on a numpy frame numpy. ``kw`` forwards to MOG2Params
    (alpha, var_threshold, ratio, ...) and the subtractor
    (``detect_shadows=True`` marks chromatic shadows 127, ``shadow_tau``,
    ``device`` for numpy frames)."""
    return _bgsub.BackgroundSubtractorMOG2(k=k, **kw)


def create_background_subtractor_knn(n_samples: int = 7, **kw):
    """Per-pixel sample-consensus background model (OpenCV
    ``createBackgroundSubtractorKNN`` role; ops.knn_bgsub): deterministic
    cyclic-slot bank on the frame's device. ``kw`` forwards to KNNParams
    (dist2_threshold, k_nn, ...) and ``device``."""
    return _knn_bgsub.BackgroundSubtractorKNN(n_samples=n_samples, **kw)


def pyr_mean_shift_filtering(mat: Mat, sp: int = 10, sr: float = 25.0,
                             max_level: int = 1, max_iter: int = 5) -> Mat:
    """Mean-shift posterization (OpenCV ``pyrMeanShiftFiltering`` role):
    per-pixel joint spatial-color mode seeking over a decimation pyramid
    (ops.meanshift_filter): the float32 twin for a device Mat, the float64
    oracle for a host Mat."""
    kw = dict(sp=sp, sr=float(sr), max_level=max_level, max_iter=max_iter)
    return _dispatch(mat, lambda t: _meanshift.pyr_mean_shift(t, **kw),
                     lambda a: _meanshift.pyr_mean_shift_numpy(a, **kw))


def _mask_of_mat(mat: Mat):
    """The first channel of a Mat: its device tensor or host numpy."""
    a = mat.device() if mat.is_on_device else mat.to_numpy()
    return a[..., 0] if a.ndim == 3 else a


def connected_components(mat: Mat, max_rounds: int = 256):
    """4-connectivity labeling of a u8 mask Mat (OpenCV
    ``connectedComponents``): (count, labels int32 (H, W)), background 0,
    components numbered in raster order of their first pixel (ops.ccl, the
    native union-find)."""
    return _ccl.connected_components(_mask_of_mat(mat), max_rounds=max_rounds)


def connected_components_with_stats(mat: Mat, max_rounds: int = 256):
    """OpenCV ``connectedComponentsWithStats``: (count, labels, stats,
    centroids) — see :func:`connected_components` and ops.ccl."""
    return _ccl.connected_components_with_stats(_mask_of_mat(mat), max_rounds=max_rounds)


def find_contours(mat: Mat, max_rounds: int = 256):
    """External contours of a u8 mask Mat (OpenCV ``findContours``
    RETR_EXTERNAL role): list of int32 [K, 2] (x, y) boundary polylines,
    one per 4-connected component (native labeling + host Moore tracing;
    ops.ccl)."""
    return _ccl.find_contours(_mask_of_mat(mat), max_rounds=max_rounds)


def distance_transform(mat: Mat) -> np.ndarray:
    """Exact L1 (city-block) distance of each nonzero pixel to the nearest
    zero (OpenCV ``distanceTransform`` DIST_L1): int32 (H, W) numpy. Four
    min-plus scans where the Mat is (exact int32 on either side;
    ops.ccl.distance_l1)."""
    g = _gray_of_mat(mat, allow_bgr=False)
    return _host(_ccl.distance_l1(torch.as_tensor(g)))


def flood_fill(mat: Mat, seed, new_val: int, lo_diff: int = 0, up_diff: int = 0):
    """OpenCV ``floodFill`` (fixed-range): returns (filled Mat on the
    input's side, count, mask). See ops.ccl.flood_fill (host)."""
    out, count, mask = _ccl.flood_fill(_mask_of_mat(mat), seed, new_val, lo_diff, up_diff)
    if mat.is_on_device:
        return Mat.from_device(torch.from_numpy(out).to(mat.device().device)), count, mask
    return Mat.from_array(out, device=mat.target), count, mask


def detect_blobs(mat: Mat, params=None):
    """Blob detection (OpenCV ``SimpleBlobDetector``): [K, 3] float64
    (cx, cy, diameter). Thresholds + native labeling + host contour
    geometry, merged across levels (ops.blob)."""
    return _blob.detect_blobs(_host(_gray_of_mat(mat)),
                              params if params is not None else _blob.BlobParams())


def kmeans(data, k: int, iters: int = 10):
    """Generic k-means (OpenCV ``kmeans`` role): (N, D) float data →
    (compactness, labels (N,), centers (K, D)) as numpy. Deterministic
    k-means++ init (ops.kmeans); a tensor runs on its device, numpy on the
    card."""
    x = data.to(torch.float32) if isinstance(data, torch.Tensor) else np.asarray(data, np.float32)
    centers, labels, inertia = _kmeans.kmeans(x, k, iters=iters)
    return float(inertia), _host(labels), _host(centers)


def _kmeans_quantize_host(a: np.ndarray, k: int, iters: int):
    """The float64 oracle's quantization (ops.kmeans.kmeans_numpy from the
    same k-means++ init)."""
    h, w = a.shape[:2]
    flat = a.reshape(-1, 3).astype(np.float32)
    c, lab, _ = _kmeans.kmeans_numpy(flat, k, iters, init_centers=_kmeans.kmeans_pp_init(flat, k))
    pal = np.clip(np.round(c), 0, 255).astype(np.uint8)
    return pal[lab].reshape(h, w, 3), pal


def kmeans_quantize(mat: Mat, k: int = 8, iters: int = 10):
    """Color quantization via k-means (OpenCV ``kmeans`` role): (quantized
    Mat with ≤ k colors, palette [k, 3] u8) — the float32 twin on a device
    Mat (ops.kmeans), the float64 oracle on a host Mat."""
    if mat.is_on_device:
        out, pal = _kmeans.kmeans_quantize(mat.device(), k=k, iters=iters)
        return Mat.from_device(out), pal
    out, pal = _kmeans_quantize_host(mat.to_numpy(), k, iters)
    return Mat.from_array(out, device=mat.target), pal


def watershed(mat: Mat, markers) -> np.ndarray:
    """Marker-based watershed (OpenCV ``watershed``): int32 markers
    (0 unknown, >0 seeds) → int32 labels with −1 watershed lines, numpy.
    Bottleneck-semiring scans to a fixed point on a device Mat's device
    (ops.watershed), the oracle's Jacobi relaxation on a host Mat: the
    same unique fixed point."""
    g = _gray_of_mat(mat)
    if mat.is_on_device:
        return _host(_watershed.watershed(g, torch.as_tensor(_host(markers), device=g.device)))
    return _watershed.watershed_numpy(g, _host(markers))


# ---------------------------------------------------------------------------
# Group 4a: Hough, stereo, NL-means, the domain-transform and guided
# filters, Poisson editing, inpainting, HDR, cascades and the host modules.
# A device Mat takes the port's tensor twin on its device; a host Mat takes
# what the reference's wrapper runs there (its numpy oracle, or its twin on
# a CPU tensor where the reference runs the twin on host arrays).
# ---------------------------------------------------------------------------


def _channel0(mat: Mat) -> torch.Tensor:
    """The Mat's first channel as an (H, W) tensor (a CPU tensor for a host
    Mat): the edge mask the Hough transforms take."""
    a = _tensor(mat)
    return a[..., 0] if a.ndim == 3 else a


def hough_lines(mat: Mat, threshold: int = 50, max_lines: int = 32,
                n_thetas: int = 180, rho_bins: int = 2048,
                max_points: int = None):
    """Standard Hough line transform on a binary edge Mat (OpenCV
    ``HoughLines``): float32 [K, 2] (rho, theta) pairs, strongest first,
    numpy. The accumulator is an integer ``bincount`` where the Mat is
    (ops.hough). Pair with :func:`canny`.

    ``max_points`` caps the edge list; by default it is the next power of
    two ≥ 65536 that holds every edge point, so no vote is dropped."""
    a = _channel0(mat)
    if max_points is None:
        n_edges = int(torch.count_nonzero(a))
        max_points = 65536
        while max_points < n_edges:
            max_points *= 2
    lines, valid, _ = _hough.hough_lines(a, n_thetas=n_thetas, rho_bins=rho_bins,
                                         max_points=max_points, max_lines=max_lines,
                                         threshold=threshold)
    return _host(lines[valid])


def hough_lines_p(mat: Mat, threshold: int = 50, min_line_length: float = 30.0,
                  max_line_gap: float = 5.0, max_segments: int = 64, **kw):
    """Line segments on a binary edge Mat (OpenCV ``HoughLinesP`` role;
    deterministic spec: accumulator peaks where the Mat is, host inlier-run
    extraction, ops.hough.hough_lines_p). Returns int32 [M, 4]
    (x1, y1, x2, y2)."""
    return _hough.hough_lines_p(_channel0(mat), threshold=threshold,
                                min_line_length=min_line_length, max_line_gap=max_line_gap,
                                max_segments=max_segments, **kw)


def hough_circles(mat: Mat, dp: int = 4, min_dist: float = 20.0, min_radius: int = 10,
                  max_radius: int = 60, edge_threshold: int = 60, vote_threshold: int = 20,
                  max_circles: int = 16):
    """Gradient Hough circle transform (OpenCV ``HoughCircles``): u8 gray
    → float32 [K, 3] (cx, cy, r), vote-sorted, greedily suppressing
    centres within ``min_dist`` of a stronger circle. The tensor twin on a
    device Mat, the numpy oracle on a host Mat (ops.hough)."""
    g = _gray_of_mat(mat)
    kw = dict(dp=dp, min_radius=min_radius, max_radius=max_radius,
              edge_threshold=edge_threshold, vote_threshold=vote_threshold,
              max_circles=max_circles)
    if mat.is_on_device:
        circ, valid, votes = _hough.hough_circles(g, **kw)
        circ, votes = _host(circ[valid]), _host(votes[valid])
    else:
        circ, votes = _hough.hough_circles_numpy(g, **kw)
    keep = []
    for i in np.argsort(-votes, kind="stable"):
        c = circ[i]
        if all(np.hypot(c[0] - circ[j][0], c[1] - circ[j][1]) >= min_dist for j in keep):
            keep.append(i)
    return circ[keep].reshape(-1, 3)


def stereo_bm(left: Mat, right: Mat, num_disparities: int = 64, block_size: int = 15,
              texture: int = 10, uniqueness: int = 10):
    """Stereo block matching (OpenCV ``StereoBM`` role) over a rectified
    gray pair: (disparity float32 (H, W), valid bool), numpy. The cost
    volume is built where the pair is (ops.stereo)."""
    gl, gr, _ = _pair_grays(left, right)
    disp, valid = _stereo.stereo_bm(torch.as_tensor(gl), torch.as_tensor(gr),
                                    num_disparities=num_disparities, block_size=block_size,
                                    texture=texture, uniqueness=uniqueness)
    return _host(disp), _host(valid)


def stereo_sgbm(left: Mat, right: Mat, num_disparities: int = 64, block_size: int = 5,
                p1=None, p2=None, uniqueness: int = 10, disp12_max_diff: int = 1,
                num_dirs: int = 8, prefilter_cap: int = 63):
    """Semi-global stereo matching (OpenCV ``StereoSGBM`` role) over a
    rectified gray pair: (disparity float32 (H, W), valid bool), numpy.
    Birchfield–Tomasi costs on the clipped-Sobel prefilter, 4 or 8 path
    directions, uniqueness, sub-pixel and the L–R check where the pair is
    (ops.sgbm)."""
    gl, gr, _ = _pair_grays(left, right)
    disp, valid = _sgbm.stereo_sgbm(torch.as_tensor(gl), torch.as_tensor(gr),
                                    num_disparities=num_disparities, block_size=block_size,
                                    p1=p1, p2=p2, uniqueness=uniqueness,
                                    disp12_max_diff=disp12_max_diff, num_dirs=num_dirs,
                                    prefilter_cap=prefilter_cap)
    return _host(disp), _host(valid)


def fast_nl_means_denoising(mat: Mat, h: float = 10.0, template_window_size: int = 7,
                            search_window_size: int = 21) -> Mat:
    """Non-local means denoising (OpenCV ``fastNlMeansDenoising`` role) on
    a gray image: the float32 twin on a device Mat, the float64 oracle on a
    host Mat (ops.nlmeans; ±1 LSB)."""
    def plane(a):
        return a if a.ndim == 2 else a[..., 0]

    return _dispatch(
        mat,
        lambda d: _nlmeans.nl_means(plane(d), h, template_window_size, search_window_size),
        lambda a: _nlmeans.nl_means_numpy(plane(a), h, template_window_size,
                                          search_window_size),
    )


def fast_nl_means_denoising_colored(mat: Mat, h: float = 10.0, h_color: float = 10.0,
                                    template_window_size: int = 7,
                                    search_window_size: int = 21) -> Mat:
    """Coloured NL-means (OpenCV ``fastNlMeansDenoisingColored`` role):
    denoise L with ``h``, a/b with ``h_color`` in CIE Lab, convert back;
    the tensor twin where the Mat is (a CPU tensor for a host Mat, as the
    reference runs its twin there)."""
    out = _nlmeans.nl_means_colored(_tensor(mat), h, h_color, template_window_size,
                                    search_window_size)
    return _from_tensor(mat, out)


def _arrays(mats) -> list:
    return [m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m) for m in mats]


def _device_stack(mats):
    """The mats' device tensors stacked on the first device Mat's device, or
    None when none is on a device."""
    dev = next((m.device().device for m in mats if getattr(m, "is_on_device", False)), None)
    if dev is None:
        return None
    return torch.stack([m.device().to(dev) if getattr(m, "is_on_device", False)
                        else torch.as_tensor(a, device=dev) for m, a in zip(mats, _arrays(mats))])


def fast_nl_means_denoising_multi(frames, img_index: int, temporal_window: int,
                                  h: float = 10.0, template: int = 7, search: int = 21):
    """Temporal NL-means (OpenCV ``fastNlMeansDenoisingMulti`` role):
    denoise one frame of a u8 gray stack with a temporal window of
    neighbours → u8 numpy. Stacks with a device Mat run the tensor twin
    there, host stacks the float64 oracle (ops.nlmeans)."""
    stack = _device_stack(frames)
    if stack is not None:
        return _host(_nlmeans.nl_means_multi(_squeeze1(stack), img_index, temporal_window,
                                             h=h, template=template, search=search))
    arrays = np.stack([_squeeze1(a) for a in _arrays(frames)])
    return _nlmeans.nl_means_multi_numpy(arrays, img_index, temporal_window, h=h,
                                         template=template, search=search)


def fast_nl_means_denoising_colored_multi(frames, img_index: int, temporal_window: int,
                                          h: float = 10.0, h_color: float = 10.0,
                                          template: int = 7, search: int = 21):
    """Coloured temporal NL-means (OpenCV
    ``fastNlMeansDenoisingColoredMulti`` role): the Lab split over the
    temporal spec, float64 on the host (ops.nlmeans)."""
    return _nlmeans.nl_means_colored_multi_numpy(np.stack(_arrays(frames)), img_index,
                                                 temporal_window, h=h, h_color=h_color,
                                                 template=template, search=search)


def guided_filter(guide_mat: Mat, src_mat: Mat, radius: int = 8, eps: float = 1e-3) -> Mat:
    """Guided filter (He et al.; OpenCV ximgproc ``guidedFilter`` role):
    box-filter-only edge-preserving smoothing of ``src`` steered by a gray
    ``guide``: float32 on the guide's device for a device guide, the
    float64 oracle for a host guide (ops.dtfilter). The result is on
    ``src``'s side."""
    g = _gray_of_mat(guide_mat)
    if guide_mat.is_on_device:
        s = _squeeze1(_tensor(src_mat)).to(g.device)
    else:
        s = _squeeze1(src_mat.to_numpy())
    out = _dtfilter.guided_filter(g, s, radius, eps)
    if out.ndim == 2:
        out = out[..., None]
    if src_mat.is_on_device:
        return Mat.from_device(torch.as_tensor(out).to(src_mat.device().device))
    return Mat.from_array(_host(out), device=src_mat.target)


def _three(a):
    """A 1-channel (H, W, 1) image repeated to 3 channels."""
    if isinstance(a, np.ndarray):
        return np.repeat(a, 3, -1)
    return a.repeat(1, 1, 3)


def _photo_op(mat: Mat, name: str, sigma_s: float, sigma_r: float) -> Mat:
    a = mat.device() if mat.is_on_device else mat.to_numpy()
    squeeze = a.ndim == 3 and a.shape[-1] == 1
    out = getattr(_dtfilter, name)(_three(a) if squeeze else a, sigma_s, sigma_r)
    if squeeze:
        out = out[..., :1]
    return Mat.from_device(out) if mat.is_on_device else Mat.from_array(out, device=mat.target)


def edge_preserving_filter(mat: Mat, sigma_s: float = 60.0, sigma_r: float = 0.4) -> Mat:
    """Domain-transform recursive edge-preserving smoothing (OpenCV
    ``edgePreservingFilter`` role): doubling scans on a device Mat, the
    float64 oracle on a host Mat (ops.dtfilter)."""
    return _photo_op(mat, "edge_preserving_filter", sigma_s, sigma_r)


def detail_enhance(mat: Mat, sigma_s: float = 10.0, sigma_r: float = 0.15) -> Mat:
    """OpenCV ``detailEnhance`` role: DT base + 3× detail."""
    return _photo_op(mat, "detail_enhance", sigma_s, sigma_r)


def stylization(mat: Mat, sigma_s: float = 60.0, sigma_r: float = 0.45) -> Mat:
    """OpenCV ``stylization`` role: DT-flattened regions + dark edges."""
    return _photo_op(mat, "stylization", sigma_s, sigma_r)


def pencil_sketch(mat: Mat, sigma_s: float = 60.0, sigma_r: float = 2.0,
                  shade_factor: float = 0.05):
    """OpenCV ``pencilSketch`` role → (gray sketch Mat, colour Mat)."""
    a = mat.device() if mat.is_on_device else mat.to_numpy()
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[-1] == 1:
        a = _three(a)
    sk, co = _dtfilter.pencil_sketch(a, sigma_s, sigma_r, shade_factor)
    if mat.is_on_device:
        return Mat.from_device(sk[..., None]), Mat.from_device(co)
    return (Mat.from_array(sk[..., None], device=mat.target),
            Mat.from_array(co, device=mat.target))


def seamless_clone(src_mat: Mat, dst_mat: Mat, mask, center, mixed: bool = False) -> Mat:
    """Poisson blending (OpenCV ``seamlessClone`` role): the guided Laplace
    equation inside the mask, by the fixed-iteration Jacobi twin on a
    device destination's device, the float64 oracle for a host
    destination (ops.poisson). ``mixed`` = MIXED_CLONE."""
    flags = _poisson.MIXED_CLONE if mixed else _poisson.NORMAL_CLONE
    s = _squeeze1(src_mat.to_numpy() if hasattr(src_mat, "to_numpy") else np.asarray(src_mat))
    d = dst_mat.device() if dst_mat.is_on_device else dst_mat.to_numpy()
    squeeze = d.ndim == 3 and d.shape[-1] == 1
    out = _poisson.seamless_clone(s, d[..., 0] if squeeze else d, _host(mask), center, flags)
    if squeeze:
        out = out[..., None]
    return Mat.from_device(out) if dst_mat.is_on_device else Mat.from_array(
        out, device=dst_mat.target)


def color_change(mat: Mat, mask, mul=(1.5, 1.0, 1.0)) -> Mat:
    """Seamless per-channel gradient scaling (OpenCV ``colorChange`` role;
    host float64, ops.poisson) → a host Mat."""
    return Mat.from_array(_poisson.color_change(mat.to_numpy(), _host(mask), mul),
                          device=mat.target)


def illumination_change(mat: Mat, mask, alpha: float = 0.2, beta: float = 0.4) -> Mat:
    """Seamless illumination attenuation (OpenCV ``illuminationChange``
    role; host float64, ops.poisson) → a host Mat."""
    return Mat.from_array(_poisson.illumination_change(mat.to_numpy(), _host(mask), alpha,
                                                       beta), device=mat.target)


def texture_flattening(mat: Mat, mask, low_threshold: float = 30.0) -> Mat:
    """Seamless texture removal keeping strong edges (OpenCV
    ``textureFlattening`` role; host float64, ops.poisson) → a host Mat."""
    return Mat.from_array(_poisson.texture_flattening(mat.to_numpy(), _host(mask),
                                                      low_threshold), device=mat.target)


def inpaint(mat: Mat, mask, radius: int = 3, method: str = "telea") -> Mat:
    """Inpaint holes (OpenCV ``inpaint`` role): ``telea`` = host Fast
    Marching; ``diffusion`` = harmonic fill, the Jacobi twin on a device
    Mat's device and the float64 oracle on the host (ops.inpaint). Telea
    and host runs give a host Mat."""
    if mat.is_on_device and method == "diffusion":
        return Mat.from_device(_inpaint.inpaint_diffusion(mat.device(), _host(mask).astype(bool)))
    a = mat.to_numpy()
    squeeze = a.ndim == 3 and a.shape[-1] == 1
    out = _inpaint.inpaint(a[..., 0] if squeeze else a, _host(mask), radius, method)
    return Mat.from_array(out[..., None] if squeeze else out, device=mat.target)


def align_mtb(mats, max_bits: int = 6, exclude_range: int = 4):
    """Median-threshold-bitmap exposure alignment (OpenCV ``AlignMTB``
    role): translation-register a u8 stack to its middle image (host,
    ops.hdr). Returns host Mats."""
    return [Mat.from_array(a) for a in _hdr.align_mtb(_arrays(mats), max_bits, exclude_range)]


def merge_mertens(mats):
    """Exposure fusion (OpenCV ``MergeMertens`` role): u8 BGR exposure
    stack → float32 [0, 1] fused image, numpy. Stacks with a device Mat
    run the tensor twin there, host stacks the float64 oracle (ops.hdr)."""
    stack = _device_stack(mats)
    if stack is not None:
        return _host(_hdr.merge_mertens(stack))
    return _hdr.merge_mertens_numpy(_arrays(mats))


def merge_robertson(mats, times, response=None):
    """Robertson radiance merge (OpenCV ``MergeRobertson`` role): u8 BGR
    stack + exposure times → float32 radiance (host, ops.hdr)."""
    return _hdr.merge_robertson_numpy(_arrays(mats), times, response)


def calibrate_robertson(mats, times, max_iter: int = 30, threshold: float = 0.01):
    """Robertson EM response recovery (OpenCV ``CalibrateRobertson`` role)
    → (3, 256), g(128) = 1 per channel (host, ops.hdr)."""
    return _hdr.calibrate_robertson(_arrays(mats), times, max_iter, threshold)


def tonemap_drago(hdr_img, gamma: float = 1.0, saturation: float = 1.0, bias: float = 0.85):
    """Drago'03 adaptive-logarithmic tonemap (OpenCV ``TonemapDrago``
    role): float radiance → float32 [0, 1] (host, ops.hdr)."""
    return _hdr.tonemap_drago_numpy(hdr_img, gamma, saturation, bias)


def tonemap_mantiuk(hdr_img, gamma: float = 1.0, scale: float = 0.7, saturation: float = 1.0):
    """Mantiuk gradient-domain tonemap (OpenCV ``TonemapMantiuk`` role):
    contrast scaling of the log-luminance gradients + exact DCT Poisson
    reintegration (host, ops.hdr)."""
    return _hdr.tonemap_mantiuk_numpy(hdr_img, gamma, scale, saturation)


def cascade_detect_multi_scale(mat: Mat, cascade_model, scale_step: float = 1.2,
                               min_size: int = 0):
    """Haar cascade detection (OpenCV ``CascadeClassifier
    .detectMultiScale`` role) → (boxes [N, 4] xywh, margins). Train or
    load models with ops.cascade (``train_cascade`` /
    ``Cascade.from_json``); a device Mat's windows are scored on its
    device, a host Mat's by the float64 oracle."""
    g = _host(_gray_of_mat(mat))
    dev = mat.device().device if mat.is_on_device else None
    return _cascade.detect_multi_scale(g, cascade_model, scale_step=scale_step,
                                       min_size=min_size, use_device=mat.is_on_device,
                                       device=dev)


def qr_detect_and_decode(mat: Mat, thresh=None):
    """QR detection + decode (OpenCV ``QRCodeDetector.detectAndDecode``
    role): model-2 versions 1-4, byte mode, every ECC level and mask, full
    Reed-Solomon correction → (text or None, corners or None) (host,
    ops.qr; make codes with ``qr.encode`` + ``qr.draw``)."""
    return _qr.detect_and_decode(_host(_gray_of_mat(mat)), thresh=thresh)


def _gray_any(mat):
    """Gray numpy plane of a Mat or of an array (BGR by the exact luma)."""
    if isinstance(mat, Mat):
        return _host(_gray_of_mat(mat))
    a = np.asarray(mat)
    return golden.bgr_to_gray(a) if a.ndim == 3 else a


def detect_mser_regions(mat, delta: int = 5, min_area: int = 60, max_area: int = 14400,
                        max_variation: float = 0.25, min_diversity: float = 0.2,
                        polarity: str = "both"):
    """Maximally stable extremal regions (OpenCV ``MSER.detectRegions``
    role; the native component tree, ops.mser). Returns (regions: list of
    int32 (K, 2) (x, y) arrays, bboxes: int32 (N, 4) (x, y, w, h))."""
    return _mser.mser_regions(_gray_any(mat), delta=delta, min_area=min_area,
                              max_area=max_area, max_variation=max_variation,
                              min_diversity=min_diversity, polarity=polarity)


def detect_line_segments(mat, **kw):
    """Line segments (OpenCV ximgproc ``FastLineDetector`` role; the
    chain-trace + Douglas-Peucker spec, ops.lsd) → float64 (N, 4) rows
    (x1, y1, x2, y2). Pass ``edges=`` to reuse an edge map."""
    if kw.get("edges") is not None:
        return _lsd.detect_line_segments(None, **kw)
    return _lsd.detect_line_segments(_gray_any(mat), **kw)


GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3


def grab_cut(mat: Mat, mask=None, rect=None, iter_count: int = 5, seed: int = 0):
    """GrabCut foreground extraction (OpenCV ``grabCut``): GMM colour
    models + a real min-cut (the native Dinic solver over the 8-connected
    grid, ops.grabcut). Returns the GC_* mask."""
    a = mat.to_numpy()
    if a.ndim == 2 or a.shape[-1] != 3:
        raise ValueError("grab_cut needs a BGR image")
    return _grabcut.grab_cut(a, mask=mask, rect=rect, iter_count=iter_count, seed=seed)


from ..ops import cascade as _cascade  # noqa: E402
from ..ops import dtfilter as _dtfilter  # noqa: E402
from ..ops import grabcut as _grabcut  # noqa: E402
from ..ops import hdr as _hdr  # noqa: E402
from ..ops import hough as _hough  # noqa: E402
from ..ops import inpaint as _inpaint  # noqa: E402
from ..ops import lsd as _lsd  # noqa: E402
from ..ops import mser as _mser  # noqa: E402
from ..ops import nlmeans as _nlmeans  # noqa: E402
from ..ops import poisson as _poisson  # noqa: E402
from ..ops import qr as _qr  # noqa: E402
from ..ops import sgbm as _sgbm  # noqa: E402
from ..ops import stereo as _stereo  # noqa: E402
from ..ops.colorchecker import color_checker_ccm, detect_color_checker  # noqa: E402
from ..ops.ghough import build_r_table, ghough_detect, ghough_detect_guil  # noqa: E402
from ..ops.scissors import IntelligentScissors  # noqa: E402
from ..ops.viz import (  # noqa: E402  (re-exports)
    clip_line,
    draw_keypoints,
    draw_marker,
    draw_matches,
    ellipse2poly,
)

from ..ops import akaze as _akaze  # noqa: E402
from ..ops import bgsub as _bgsub  # noqa: E402
from ..ops import blob as _blob  # noqa: E402
from ..ops import ccl as _ccl  # noqa: E402
from ..ops import kmeans as _kmeans  # noqa: E402
from ..ops import knn_bgsub as _knn_bgsub  # noqa: E402
from ..ops import meanshift_filter as _meanshift  # noqa: E402
from ..ops import watershed as _watershed  # noqa: E402
from ..ops import brief as _brief  # noqa: E402
from ..ops import disflow as _disflow  # noqa: E402
from ..ops import farneback as _farneback  # noqa: E402
from ..ops import fast as _fast  # noqa: E402
from ..ops import hog as _hog  # noqa: E402
from ..ops import optflow as _optflow  # noqa: E402
from ..ops import registration as _registration  # noqa: E402
from ..ops import sift as _sift  # noqa: E402
from ..ops import template as _template  # noqa: E402
from ..ops import tvl1 as _tvl1  # noqa: E402
from ..ops import varref as _varref  # noqa: E402
from ..ops.asift import affine_detect_and_compute  # noqa: E402
from ..ops.blend import voronoi_seam  # noqa: E402
from ..ops.ccl import distance_transform_l2_with_labels  # noqa: E402
from ..ops.corner import (  # noqa: E402  (re-exports)
    corner_eigen_vals_and_vecs,
    corner_min_eigen_val,
    pre_corner_detect,
    spatial_gradient,
)
from ..ops.decolor import decolor  # noqa: E402
from ..ops.dsst_scale import ScaleEstimator  # noqa: E402
from ..ops.ecc import compute_ecc, find_transform_ecc, find_transform_ecc_multiscale  # noqa: E402
from ..ops.optflow import build_optical_flow_pyramid  # noqa: E402
from ..ops.registration import phase_correlate_iterative  # noqa: E402
from ..ops.rotwarp import RotationWarper  # noqa: E402
from ..ops.sift import match_descriptors_l2  # noqa: E402
from ..ops.slic import slic_superpixels  # noqa: E402
from ..ops.transform import (  # noqa: E402  (re-exports)
    dct,
    dft,
    get_optimal_dft_size,
    idct,
    idft,
    mul_spectrums,
)
from ..ops.varref import variational_refine  # noqa: E402

# ---------------------------------------------------------------------------
# Group 4b: the geometry chain (camera model and calibration, chessboards,
# circle grids, ArUco, 3-D, RGB-D odometry, stitching). The detectors are
# host pipelines; their device steps (the chessboard refinements, the SB
# likelihood, undistortion, the stitch composite) run on a device Mat's
# device, on a CPU tensor for a host Mat, and on the card for an array.
# ---------------------------------------------------------------------------


def stitch_images(mats, min_matches: int = 12):
    """Panorama stitching (OpenCV ``Stitcher`` role): SIFT registration
    chained image-to-image, RANSAC homographies, feather-blended
    compositing — the device remap composite for device Mats, the host
    composite otherwise (ops.stitch). Returns a host Mat anchored at the
    first image."""
    arrays = []
    for m in mats:
        a = m.device() if getattr(m, "is_on_device", False) else (
            m.to_numpy() if hasattr(m, "to_numpy") else np.asarray(m))
        if a.ndim == 3 and a.shape[-1] == 1:
            a = a[..., 0]
        arrays.append(a)
    return Mat.from_array(_stitch.stitch(arrays, min_matches=min_matches))


def detect_aruco_markers(mat: Mat, dictionary, thresh=None):
    """Fiducial marker detection (OpenCV ``aruco.detectMarkers`` role; host,
    ops.aruco): → (corners list [4,2] CW from canonical top-left, ids int32
    [N]). Build dictionaries with ``aruco.Dictionary.generate``; draw with
    ``aruco.draw_marker``; pose via ``aruco.estimate_pose_single_markers``."""
    return _aruco.detect_markers(_host(_gray_of_mat(mat)), dictionary, thresh=thresh)


def _board_gray(mat):
    """The gray plane of a Mat as a tensor (on a device Mat's device, a CPU
    tensor for a host Mat: the detectors refine there), or of an array as
    numpy (refined on the card)."""
    if isinstance(mat, Mat):
        return _gray(_tensor(mat))
    a = np.asarray(mat)
    return golden.bgr_to_gray(a) if a.ndim == 3 else a


def find_chessboard_corners(mat, pattern_size, refine: bool = True):
    """Inner chessboard corners (OpenCV ``findChessboardCorners`` role;
    frozen pipeline spec in ops.chessboard). Accepts a Mat or array, gray
    or BGR. Returns (found, corners float64 (rows·cols, 2) row-major — the
    ``calibrate_camera`` object-point traversal)."""
    return _chessboard.find_chessboard_corners(_board_gray(mat), pattern_size, refine=refine)


def find_chessboard_corners_sb(mat, pattern_size, normalize: bool = False,
                               refine: bool = True):
    """Sector-based chessboard detection (OpenCV ``findChessboardCornersSB``
    role; ops.chessboard_sb: the corner-likelihood convolution on the
    device, host lattice growth). Same canonical ordering as
    :func:`find_chessboard_corners`. ``normalize`` =
    CALIB_CB_NORMALIZE_IMAGE role."""
    return _chessboard_sb.find_chessboard_corners_sb(_board_gray(mat), pattern_size,
                                                     normalize=normalize, refine=refine)


def undistort(mat: Mat, K, dist, new_K=None) -> Mat:
    """Undistort a u8 image (OpenCV ``undistort``): 5-coefficient
    radial-tangential model; host map build + the remap where the Mat is
    (ops.calib): a device Mat gives a device Mat, a host Mat a host Mat."""
    if mat.is_on_device:
        return Mat.from_device(_calib.undistort(mat.device(), K, dist, new_K))
    out = _calib.undistort(torch.from_numpy(mat.to_numpy()), K, dist, new_K)
    return Mat.from_array(out.numpy(), device=mat.target)


def solve_pnp_refine(obj_pts, img_pts, k, dist, rvec, tvec, iterations: int = 20):
    """OpenCV ``solvePnPRefineLM``/``VVS`` role: Gauss-Newton refinement of
    an existing pose through the full distortion model (the same minimizer
    solve_pnp ends with; ops.calib)."""
    return _calib.refine_pose(
        np.asarray(obj_pts, np.float64).reshape(-1, 3),
        np.asarray(img_pts, np.float64).reshape(-1, 2),
        np.asarray(k, np.float64), dist,
        np.asarray(rvec, np.float64).ravel(),
        np.asarray(tvec, np.float64).ravel(), iterations)


from ..ops import aruco as _aruco  # noqa: E402
from ..ops import calib as _calib  # noqa: E402
from ..ops import chessboard as _chessboard  # noqa: E402
from ..ops import chessboard_sb as _chessboard_sb  # noqa: E402
from ..ops import stitch as _stitch  # noqa: E402
from ..ops.calib import (  # noqa: E402  (re-exports)
    calibrate_camera,
    decompose_homography_mat,
    estimate_affine_3d,
    fisheye_init_undistort_rectify_map,
    fisheye_project_points,
    fisheye_undistort,
    fisheye_undistort_points,
    get_optimal_new_camera_matrix,
    init_undistort_rectify_map,
    project_points,
    reproject_image_to_3d,
    rodrigues,
    solve_pnp,
    solve_pnp_ransac,
    stereo_calibrate,
    stereo_rectify,
    undistort_points,
)
from ..ops.calib_ext import (  # noqa: E402  (re-exports)
    calibrate_camera_extended,
    calibration_matrix_values,
    compose_rt,
    decompose_projection_matrix,
    draw_frame_axes,
    estimate_translation_2d,
    estimate_translation_3d,
    filter_homography_decomp_by_visible_refpoints,
    filter_speckles,
    init_camera_matrix_2d,
    init_inverse_rectification_map,
    read_optical_flow,
    register_cameras,
    sampson_distance,
    solve_p3p,
    solve_pnp_epnp,
    solve_pnp_generic,
    stereo_rectify_uncalibrated,
    write_optical_flow,
)
from ..ops.chessboard import estimate_chessboard_sharpness  # noqa: E402
from ..ops.circles_grid import circles_grid_object_points, find_circles_grid  # noqa: E402
from ..ops.odometry import rgbd_odometry  # noqa: E402
from ..ops.threed import (  # noqa: E402  (re-exports)
    depth_to_3d,
    depth_to_3d_sparse,
    find_planes,
    load_mesh,
    load_point_cloud,
    register_depth,
    rescale_depth,
    rgbd_normals,
    save_mesh,
    save_point_cloud,
    triangle_rasterize,
    warp_frame,
)

_GROUP2 = [
    "fast_corners", "compute_brief", "match_descriptors", "orb_features",
    "calc_optical_flow_pyr_lk", "build_optical_flow_pyramid", "calc_optical_flow_farneback",
    "calc_optical_flow_dis", "variational_refine", "match_template", "min_max_loc",
    "denoise_tvl1", "hog_descriptor", "hog_detect_multi_scale", "akaze_features",
    "match_descriptors_hamming_any", "sift_features", "match_descriptors_l2",
    "affine_detect_and_compute", "RotationWarper", "phase_correlate",
    "phase_correlate_iterative", "compute_ecc", "find_transform_ecc",
    "find_transform_ecc_multiscale", "dct", "idct", "dft", "idft", "mul_spectrums",
    "get_optimal_dft_size", "spatial_gradient", "corner_min_eigen_val",
    "corner_eigen_vals_and_vecs", "pre_corner_detect", "decolor",
]

_GROUP3 = [
    "create_background_subtractor_mog2", "create_background_subtractor_knn",
    "pyr_mean_shift_filtering", "ScaleEstimator", "connected_components",
    "connected_components_with_stats", "find_contours", "distance_transform", "flood_fill",
    "distance_transform_l2_with_labels", "detect_blobs", "kmeans", "kmeans_quantize",
    "watershed", "slic_superpixels", "voronoi_seam",
]

_GROUP4A = [
    "hough_lines", "hough_lines_p", "hough_circles", "build_r_table", "ghough_detect",
    "ghough_detect_guil", "stereo_bm", "stereo_sgbm", "fast_nl_means_denoising",
    "fast_nl_means_denoising_colored", "fast_nl_means_denoising_multi",
    "fast_nl_means_denoising_colored_multi", "guided_filter", "edge_preserving_filter",
    "detail_enhance", "stylization", "pencil_sketch", "seamless_clone", "color_change",
    "illumination_change", "texture_flattening", "inpaint", "align_mtb", "merge_mertens",
    "merge_robertson", "calibrate_robertson", "tonemap_drago", "tonemap_mantiuk",
    "cascade_detect_multi_scale", "qr_detect_and_decode", "detect_mser_regions",
    "detect_line_segments", "grab_cut", "IntelligentScissors", "detect_color_checker",
    "color_checker_ccm", "clip_line", "ellipse2poly", "draw_keypoints", "draw_matches",
    "draw_marker",
]

_GROUP4B = [
    "stitch_images", "detect_aruco_markers", "calibrate_camera", "solve_pnp",
    "solve_pnp_ransac", "stereo_rectify", "reproject_image_to_3d", "fisheye_project_points",
    "fisheye_undistort_points", "fisheye_init_undistort_rectify_map", "fisheye_undistort",
    "stereo_calibrate", "decompose_homography_mat", "estimate_affine_3d",
    "find_chessboard_corners", "get_optimal_new_camera_matrix", "init_undistort_rectify_map",
    "project_points", "rodrigues", "undistort", "undistort_points", "find_circles_grid",
    "circles_grid_object_points", "compose_rt", "decompose_projection_matrix",
    "calibration_matrix_values", "sampson_distance", "estimate_translation_2d",
    "estimate_translation_3d", "init_camera_matrix_2d", "stereo_rectify_uncalibrated",
    "filter_speckles", "read_optical_flow", "write_optical_flow", "save_point_cloud",
    "load_point_cloud", "depth_to_3d", "find_planes", "triangle_rasterize", "solve_p3p",
    "solve_pnp_refine", "register_depth", "warp_frame", "rescale_depth",
    "estimate_chessboard_sharpness", "calibrate_camera_extended", "register_cameras",
    "solve_pnp_generic", "draw_frame_axes", "filter_homography_decomp_by_visible_refpoints",
    "save_mesh", "load_mesh", "depth_to_3d_sparse", "rgbd_normals", "rgbd_odometry",
    "solve_pnp_epnp", "init_inverse_rectification_map",
]

_SLICE2 = [
    "add", "subtract", "absdiff", "add_weighted", "convert_scale_abs", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "count_non_zero", "norm", "mean_std_dev",
    "psnr", "normalize", "accumulate_weighted", "calc_hist", "equalize_hist", "lut",
    "apply_color_map", "calc_hue_hist", "back_project", "mean_shift", "cam_shift", "clahe",
    "get_rotation_matrix_2d", "warp_affine", "get_perspective_transform", "warp_perspective",
    "remap", "rotate", "warp_polar", "linear_polar", "log_polar", "thinning",
    "anisotropic_diffusion", "flip", "draw_contours", "draw_chessboard_corners", "hu_moments",
    "match_shapes", "get_gabor_kernel", "cvt_color_two_plane", "estimate_affine_partial_2d",
    "estimate_affine_2d", "detect_barcodes", "encode_ean13", "gain_compensation",
    "multi_band_blend", "RNG", "accumulate", "accumulate_product", "accumulate_square",
    "apply_ccm", "batch_distance", "blend_linear", "blur", "border_interpolate", "box_filter",
    "build_mst", "calc_covar_matrix", "cart_to_polar", "check_range",
    "color_correction_matrix", "compare", "compare_hist", "complete_symm",
    "convert_points_from_homogeneous", "convert_points_to_homogeneous", "copy_make_border",
    "copy_to", "create_hanning_window", "cube_root", "determinant", "div_spectrums", "eigen",
    "eigen_non_symmetric", "extract_channel", "fast_atan2", "find_non_zero", "finite_mask",
    "flip_nd", "gemm", "get_affine_transform", "get_rect_sub_pix", "has_non_zero", "hconcat",
    "insert_channel", "integral2", "integral3", "invert", "invert_affine_transform",
    "magnitude", "mahalanobis", "mat_mul_deriv", "mix_channels", "mul_transposed",
    "patch_nans", "pca_back_project", "pca_compute", "pca_project", "perspective_transform",
    "phase", "polar_to_cart", "rand_shuffle", "rectangle_intersection_area", "reduce_arg_max",
    "reduce_arg_min", "scale_add", "set_identity", "solve", "solve_cubic", "solve_lp",
    "solve_poly", "sort_idx", "split", "sqr_box_filter", "sum_elems", "sv_back_subst",
    "sv_decomp", "threshold_with_mask", "trace", "transpose_nd", "vconcat", "divide", "merge",
    "multiply", "reduce", "repeat", "sort", "transform", "transpose", "emd",
    "compute_correspond_epilines", "correct_matches", "decompose_essential_mat",
    "find_essential_mat", "find_fundamental_mat", "recover_pose", "triangulate_points",
    "find_homography", "KnnIndex", "radius_search", "Octree", "approx_poly_dp",
    "approx_poly_n", "arc_length", "bounding_rect", "box_points", "contour_area",
    "convex_hull", "convex_hull_indices", "convexity_defects", "fit_ellipse",
    "fit_ellipse_ams", "fit_ellipse_direct", "fit_line", "intersect_convex_convex",
    "is_contour_convex", "min_area_rect", "min_enclosing_circle",
    "min_enclosing_convex_polygon", "min_enclosing_triangle", "point_polygon_test",
    "rotated_rectangle_intersection", "Subdiv2D", "TsdfVolume", "convert_maps",
]

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
] + _SLICE2 + _GROUP2 + _GROUP3 + _GROUP4A + _GROUP4B
