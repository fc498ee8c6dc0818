"""Drop-in OpenCV-compatible facade over rustcv_tpu_torch (the port of
``rustcv_tpu.cv2``).

``import rustcv_tpu_torch.cv2 as cv2`` gives cv2's camelCase API: int enum
constants, cv2 signatures and return conventions, numpy results, over the
port's ``imgproc``, ``imgcodecs``, ``highgui``, ``videoio`` and ``ops``.
Each wrapper is held call for call against ``rustcv_tpu.cv2`` in
``tests/test_torch_cv2_calls.py``.

Where a call runs (:mod:`._device`): a numpy image that a wrapper hands to a
Mat or to a device op goes to the card; a torch tensor stays on its device
(CPU tensors run on the CPU); results are numpy. Copied host code (the
float64 geometry, the cv2 colour tables, the file formats) runs on the host,
and in-place draws on a numpy image are drawn on the host, in the caller's
array.

Coverage policy: the high-traffic cv2 surface is wrapped 1:1; exotic
argument combinations the facade does not model raise ``ValueError`` /
``NotImplementedError`` with the supported alternatives named, never
silently diverge. The reference's multi-page, animated and metadata image
files (read and written with Pillow there) run on the port's own codecs
for TIFF, GIF, WebP and animated PNG; the forms those codecs do not write
or read yet raise ``not_ported`` (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import numpy as np
import torch as _torch

from ._constants import *  # noqa: F401,F403
from . import _constants as _C
from ._device import _a, _copyto, _host_mat, _hwc, _m, _o, _t
from ._device import bind as _bind
from ..core.mat import Mat as _CoreMat
from .. import imgproc as _ip
from ..ops import color as _color_ops
from .. import imgcodecs as _icodec
from .. import highgui as _hg
from ..imgproc import Point as _Point, Rect as _Rect, Scalar as _Scalar

__version__ = "5.0-rustcv_tpu_torch"


# ---------------------------------------------------------------- helpers

def _color(c):
    if np.isscalar(c):
        return _Scalar.all(int(c))
    c = tuple(int(v) for v in np.atleast_1d(_a(c, dtype=np.float64)))
    c = (c + (0, 0, 0))[:3]
    return _Scalar(*c)


def _pad_run_crop(src, pad, fn, borderType=4, value=0):
    """cv2-exact borders for stencil ops: pad with cv2's border rule,
    run our (replicate-border) op, crop the pad ring back off. The image
    goes to the call's device first and is padded there."""
    t = _t(src)
    name = _BORDER_NAMES.get(int(borderType) & 15, "reflect101")
    padded = _ip.copy_make_border(t, pad, pad, pad, pad, name, value)
    out = _a(fn(padded))
    return out[pad:out.shape[0] - pad, pad:out.shape[1] - pad]


def _pt(p):
    return _Point(int(round(p[0])), int(round(p[1])))


def _inplace(img, fn):
    """Run a Mat-mutating drawing op and write the result back into img.

    cv2 draws on single-channel images using color[0]; the Mat drawing
    layer is 3-channel BGR, so grayscale inputs are expanded, drawn, and
    collapsed back via channel 0 (channel 0 of _color() is color[0] for
    both scalar and tuple colors, so semantics match cv2's).

    A tensor is drawn on its device and copied back into it. A numpy image
    is drawn on the host, in a host Mat over the caller's own bytes where
    they are a contiguous BGR array (no copy), as cv2 draws into it."""
    if isinstance(img, _torch.Tensor):
        gray = img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 1)
        work = img.reshape(img.shape[0], img.shape[1], 1).expand(-1, -1, 3) \
            if gray else img
        m = _m(work.contiguous())
        fn(m)
        out = m.device()
        img.copy_((out[..., :1] if gray else out).reshape(img.shape))
        return img
    arr = np.asarray(img)
    if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 1):
        work = np.ascontiguousarray(
            np.repeat(arr.reshape(arr.shape[0], arr.shape[1], 1), 3,
                      axis=2))
        m = _host_mat(work)
        fn(m)
        out = _a(_o(m))[..., 0]
        _copyto(img, out.reshape(img.shape))
        return img
    m = _host_mat(arr)
    fn(m)
    if not np.shares_memory(m.array, arr):
        _copyto(img, _o(m).reshape(img.shape))
    return img


def _sat(arr, ddepth, src_dtype):
    """Convert an exact int/float result to the requested cv2 ddepth."""
    if ddepth in (-1, None):
        dt = src_dtype
    else:
        dt = {_C.CV_8U: np.uint8, _C.CV_8S: np.int8, _C.CV_16U: np.uint16,
              _C.CV_16S: np.int16, _C.CV_32S: np.int32,
              _C.CV_32F: np.float32, _C.CV_64F: np.float64}[ddepth]
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        return np.clip(np.rint(arr), info.min, info.max).astype(dt)
    return _a(arr, dtype=dt)


# ------------------------------------------------------------- color

_CVT_DIRECT = {}


def _rev3(a):
    return a[..., ::-1] if a.ndim == 3 else a


def cvtColor(src, code, dst=None, dstCn=0):
    a = _a(src)
    C = _C
    if code in (C.COLOR_BGR2RGB,):  # == RGB2BGR
        out = a[..., ::-1].copy()
    elif code in (C.COLOR_BGR2BGRA,):  # == RGB2RGBA
        alpha = np.full(a.shape[:2] + (1,), 255, a.dtype)
        out = np.concatenate([a, alpha], axis=-1)
    elif code in (C.COLOR_BGRA2BGR,):  # == RGBA2RGB
        out = a[..., :3].copy()
    elif code in (C.COLOR_BGR2GRAY, C.COLOR_RGB2GRAY,
                  C.COLOR_BGRA2GRAY, C.COLOR_RGBA2GRAY):
        x = a[..., :3]
        if code in (C.COLOR_RGB2GRAY, C.COLOR_RGBA2GRAY):
            x = x[..., ::-1]
        if a.dtype == np.uint8:
            # cv2's own 15-bit fixed point (full-cube exact), not the
            # RustCV golden BT.601 form the capture pipeline uses
            out = _color_ops.bgr_to_gray_cv(x)
        else:
            out = _o(_ip.cvt_gray(_m(x)))
    elif code in (C.COLOR_GRAY2BGR, C.COLOR_GRAY2RGB):
        out = np.repeat(a[..., None] if a.ndim == 2 else a, 3, axis=-1)
    elif code in (C.COLOR_GRAY2BGRA,):
        g = a if a.ndim == 2 else a[..., 0]
        out = np.stack([g, g, g, np.full_like(g, 255)], axis=-1)
    elif code in (C.COLOR_BGR2HSV, C.COLOR_RGB2HSV):
        x = _rev3(a) if code == C.COLOR_RGB2HSV else a
        if a.dtype == np.uint8:
            out = _color_ops.bgr_to_hsv_cv(x)  # cv2 table rounding, exact
        else:
            out = _o(_ip.cvt_hsv(_m(x)))
    elif code in (C.COLOR_HSV2BGR, C.COLOR_HSV2RGB):
        out = _o(_ip.cvt_hsv_to_bgr(_m(a)))
        if code == C.COLOR_HSV2RGB:
            out = out[..., ::-1].copy()
    elif code in (C.COLOR_BGR2Lab, C.COLOR_RGB2Lab):
        x = _rev3(a) if code == C.COLOR_RGB2Lab else a
        if a.dtype == np.uint8:
            out = _color_ops.bgr_to_lab_cv(x)  # cv2 table math, exact
        else:
            out = _o(_ip.cvt_lab(_m(x)))
    elif code in (C.COLOR_Lab2BGR, C.COLOR_Lab2RGB):
        out = _o(_ip.cvt_lab_to_bgr(_m(a)))
        if code == C.COLOR_Lab2RGB:
            out = out[..., ::-1].copy()
    elif code in (C.COLOR_BGR2YCrCb, C.COLOR_RGB2YCrCb):
        x = _rev3(a) if code == C.COLOR_RGB2YCrCb else a
        out = _o(_ip.cvt_ycrcb(_m(x)))
    elif code in (C.COLOR_YCrCb2BGR, C.COLOR_YCrCb2RGB):
        out = _o(_ip.cvt_ycrcb_to_bgr(_m(a)))
        if code == C.COLOR_YCrCb2RGB:
            out = out[..., ::-1].copy()
    else:
        from ._color_dispatch import try_convert
        out = try_convert(a, code)
        if out is None:
            raise NotImplementedError(
                f"cvtColor code {code} not wrapped yet")
    if dst is not None:
        _copyto(dst, out)
        return dst
    return out


def cvtColorTwoPlane(src1, src2, code, dst=None):
    """NV12/NV21 two-plane → BGR/RGB via the 20-bit ITU-R BT.601 path
    (ops/color_cv2.py) — bit-exact vs cv2 5.0.  The capture pipeline's
    frozen-spec NV12 kernel stays behind imgproc.cvt_color_two_plane."""
    from ..ops import color_cv2 as _cc

    y = _a(src1)
    uv = _a(src2).reshape(y.shape[0] // 2, -1, 2)
    code = int(code)
    nv21 = code in (_C.COLOR_YUV2BGR_NV21, _C.COLOR_YUV2RGB_NV21)
    rgb = code in (_C.COLOR_YUV2RGB_NV12, _C.COLOR_YUV2RGB_NV21)
    u, v = uv[..., 0], uv[..., 1]
    if nv21:
        u, v = v, u
    return _cc.yuv420_to_bgr_cv(y, u, v, rgb)


def demosaicing(src, code, dst=None, dstCn=0):
    """Bilinear Bayer demosaic via the device kernel (frozen spec
    golden.demosaic_bilinear; ±1 LSB of cv2's bilinear path at interior
    pixels, documented reflect-101 borders). cv2 pattern naming is by the
    SECOND row's first two sites, ours by the first — hence the map."""
    from ..ops import color as _color

    codes = {
        _C.COLOR_BayerBG2BGR: "RGGB", _C.COLOR_BayerGB2BGR: "GRBG",
        _C.COLOR_BayerRG2BGR: "BGGR", _C.COLOR_BayerGR2BGR: "GBRG",
        _C.COLOR_BayerBG2RGB: "BGGR", _C.COLOR_BayerGB2RGB: "GBRG",
        _C.COLOR_BayerRG2RGB: "RGGB", _C.COLOR_BayerGR2RGB: "GRBG",
    }
    pattern = codes.get(int(code))
    if pattern is None:
        raise NotImplementedError(f"demosaicing code {code}")
    a = _a(src)
    h, w = a.shape[:2]
    out = _a(_color.demosaic_bilinear(_t(src), pattern, w, h))
    return _o(out)


# ------------------------------------------------------------- threshold

_THRESH_NAMES = {0: "binary", 1: "binary_inv", 2: "trunc",
                 3: "tozero", 4: "tozero_inv"}


def _otsu_thresh(a):
    # cv2 getThreshVal_Otsu_8u: maximize between-class variance,
    # first (lowest) maximizer wins.
    hist = np.bincount(a.ravel(), minlength=256).astype(np.float64)
    total = a.size
    mu_t = np.dot(np.arange(256), hist) / total
    w = np.cumsum(hist) / total
    mu = np.cumsum(np.arange(256) * hist) / total
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma = (mu_t * w - mu) ** 2 / (w * (1.0 - w))
    sigma[~np.isfinite(sigma)] = 0.0
    return float(np.argmax(sigma))


def _triangle_thresh(a):
    # cv2 getThreshVal_Triangle_8u (Zack): longest perpendicular from
    # the peak→far-bound chord to the histogram, on the longer side
    # (histogram flipped if the peak is nearer the left bound).
    hist = np.bincount(a.ravel(), minlength=256).astype(np.int64)
    nz = np.flatnonzero(hist)
    if nz.size == 0:
        return 0.0
    left = max(int(nz[0]) - 1, 0)
    right = min(int(nz[-1]) + 1, 255)
    max_ind = int(np.argmax(hist))
    peak = int(hist[max_ind])
    flipped = (max_ind - left) < (right - max_ind)
    if flipped:
        hist = hist[::-1]
        left = 255 - right
        max_ind = 255 - max_ind
    thresh = left
    if left != max_ind:
        i = np.arange(left + 1, max_ind + 1, dtype=np.int64)
        dist = peak * i + (left - max_ind) * hist[i]
        # strict > keeps the FIRST maximizer, matching the C loop
        thresh = int(i[np.argmax(dist)])
        if int(dist.max()) <= 0:
            thresh = left
        thresh -= 1
    if flipped:
        thresh = 255 - thresh
    return float(thresh)


def threshold(src, thresh, maxval, type, dst=None):
    a = _a(src)
    flags = int(type)
    base = flags & 7
    if flags & _C.THRESH_OTSU:
        thresh = _otsu_thresh(a)
    elif flags & _C.THRESH_TRIANGLE:
        thresh = _triangle_thresh(a)
    name = _THRESH_NAMES[base]
    out = _o(_ip.threshold(_m(a), int(thresh), int(maxval), type=name))
    return float(thresh), out


def adaptiveThreshold(src, maxValue, adaptiveMethod, thresholdType,
                      blockSize, C, dst=None):
    method = "mean" if adaptiveMethod == _C.ADAPTIVE_THRESH_MEAN_C else "gaussian"
    inv = thresholdType == _C.THRESH_BINARY_INV
    return _o(_ip.adaptive_threshold(_m(src), int(maxValue), method,
                                     int(blockSize), C, inv))


def inRange(src, lowerb, upperb, dst=None):
    return _o(_ip.in_range(_m(src), _a(lowerb).ravel(),
                           _a(upperb).ravel()))


# ------------------------------------------------------------- geometry

_INTER_NAMES = {0: "nearest", 1: "bilinear", 2: "cubic", 3: "area"}


def resize(src, dsize, dst=None, fx=0, fy=0, interpolation=1):
    from ..ops import resize_cv as _rcv
    a = _a(src)
    if dsize is None or tuple(dsize) == (0, 0):
        w = int(round(a.shape[1] * fx))
        h = int(round(a.shape[0] * fy))
    else:
        w, h = int(dsize[0]), int(dsize[1])
    interp = int(interpolation) & 7
    if interp == _C.INTER_NEAREST:
        # cv2's INTER_NEAREST is floor(dst * scale), not half-pixel-center
        sh, sw = a.shape[:2]
        # cv2 rounds ifx as 1/(dst/src) — one ulp below src/dst; keep
        # its exact double sequence so tap indices match bit-for-bit
        ifx, ify = 1.0 / (w / sw), 1.0 / (h / sh)
        xi = np.minimum(np.floor(np.arange(w) * ifx).astype(np.int64),
                        sw - 1)
        yi = np.minimum(np.floor(np.arange(h) * ify).astype(np.int64),
                        sh - 1)
        return np.ascontiguousarray(a[yi[:, None], xi[None, :]])
    if a.dtype == np.uint8 and interp in (1, 2, 3, 4):
        # cv2 5's exact u8 arithmetic per mode (see ops/resize_cv.py)
        return _rcv.resize_cv_u8(a, w, h, interp)
    name = _INTER_NAMES.get(interp)
    if name is None:
        raise NotImplementedError(f"interpolation {interpolation}")
    return _o(_ip.resize(_m(a), w, h, interpolation=name))


def flip(src, flipCode, dst=None):
    return _o(_ip.flip(_m(src), int(flipCode)))


def flipND(src, axis, dst=None):
    return _o(_ip.flip_nd(_a(src), int(axis)))


def rotate(src, rotateCode, dst=None):
    a = _a(src)
    if rotateCode == _C.ROTATE_90_CLOCKWISE:
        return np.ascontiguousarray(np.rot90(a, k=-1))
    if rotateCode == _C.ROTATE_180:
        return np.ascontiguousarray(np.rot90(a, k=2))
    if rotateCode == _C.ROTATE_90_COUNTERCLOCKWISE:
        return np.ascontiguousarray(np.rot90(a, k=1))
    raise ValueError(f"bad rotateCode {rotateCode}")


_BORDER_NAMES = {0: "constant", 1: "replicate", 2: "reflect",
                 3: "wrap", 4: "reflect101"}


def warpAffine(src, M, dsize, dst=None, flags=1, borderMode=0,
               borderValue=0):
    from ..ops import warp as _warp
    mode = _INTER_NAMES.get(int(flags) & 7, "bilinear")
    border = _BORDER_NAMES.get(int(borderMode), "constant")
    # cv2 5's float path (bit-exact for integer dtypes; see ops/warp.py)
    return _warp.warp_affine_cv_numpy(
        _a(src), _a(M, np.float64),
        (int(dsize[0]), int(dsize[1])), mode=mode, border=border,
        border_value=borderValue,
        inverse_map=bool(int(flags) & _C.WARP_INVERSE_MAP))


def warpPerspective(src, M, dsize, dst=None, flags=1, borderMode=0,
                    borderValue=0):
    from ..ops import warp as _warp
    mode = _INTER_NAMES.get(int(flags) & 7, "bilinear")
    border = _BORDER_NAMES.get(int(borderMode), "constant")
    return _warp.warp_perspective_cv_numpy(
        _a(src), _a(M, np.float64),
        (int(dsize[0]), int(dsize[1])), mode=mode, border=border,
        border_value=borderValue,
        inverse_map=bool(int(flags) & _C.WARP_INVERSE_MAP))


def getRotationMatrix2D(center, angle, scale):
    return _a(_ip.get_rotation_matrix_2d(
        (float(center[0]), float(center[1])), float(angle), float(scale)),
        dtype=np.float64)


def getAffineTransform(src, dst):
    return _a(_ip.get_affine_transform(
        _a(src, np.float64).reshape(3, 2),
        _a(dst, np.float64).reshape(3, 2)), dtype=np.float64)


def getPerspectiveTransform(src, dst, solveMethod=0):
    return _a(_ip.get_perspective_transform(
        _a(src, np.float64).reshape(4, 2),
        _a(dst, np.float64).reshape(4, 2)), dtype=np.float64)


def invertAffineTransform(M, iM=None):
    return _a(_ip.invert_affine_transform(_a(M, np.float64)))


def remap(src, map1, map2, interpolation=1, dst=None, borderMode=0,
          borderValue=0):
    from ..ops import warp as _warp

    interp = int(interpolation) & 7
    border = _BORDER_NAMES.get(int(borderMode), "constant")
    mx, my = _a(map1), _a(map2)
    if interp == _C.INTER_LINEAR:
        # cv2 5's float path (bit-exact for integer dtypes)
        return _o(_warp.remap_linear_cv_numpy(_a(src), mx, my,
                                              border, borderValue))
    a = _a(src)
    if interp == _C.INTER_NEAREST:
        # bit-exact vs cv2 (tests/test_cv2_shim.py::test_remap_modes)
        return _o(_warp.remap_nearest_numpy(a, mx, my, border,
                                            borderValue))
    if interp == _C.INTER_CUBIC:
        # cv2 5's float bicubic path, bit-exact (same test)
        return _o(_warp.remap_cubic_numpy(a, mx, my, border, borderValue))
    raise NotImplementedError(f"remap interpolation {interpolation}")


def convertMaps(map1, map2, dstmap1type, nninterpolation=False):
    """cv2 signature: dstmap1type selects CV_16SC2 (fixed point),
    CV_32FC1 (two float planes) or CV_32FC2 (one 2-ch float map)."""
    m1 = _a(map1)
    m2 = None if map2 is None else _a(map2)
    t = int(dstmap1type)
    if t == 11:        # CV_16SC2
        if m1.ndim == 3 and m1.shape[-1] == 2:
            m1, m2 = m1[..., 0], m1[..., 1]
        return _ip.convert_maps(m1, m2)
    if m1.dtype == np.int16:   # fixed point -> float
        frac = (np.zeros(m1.shape[:2], np.uint16) if m2 is None
                else _a(m2, np.uint16))
        fx = (frac & 31).astype(np.float32) / 32.0
        fy = ((frac >> 5) & 31).astype(np.float32) / 32.0
        mx = m1[..., 0].astype(np.float32) + fx
        my = m1[..., 1].astype(np.float32) + fy
    elif m1.ndim == 3 and m1.shape[-1] == 2:
        mx, my = m1[..., 0].astype(np.float32), m1[..., 1].astype(
            np.float32)
    else:
        mx = m1.astype(np.float32)
        my = (np.zeros_like(mx) if m2 is None
              else _a(m2, np.float32))
    if t == 13:        # CV_32FC2
        return np.stack([mx, my], -1), None
    return mx, my      # CV_32FC1


def warpPolar(src, dsize, center, maxRadius, flags):
    from ..ops import warp as _warp

    a = _a(src)
    fl = int(flags)
    log = bool(fl & _C.WARP_POLAR_LOG)
    inverse = bool(fl & _C.WARP_INVERSE_MAP)
    w, h = int(dsize[0]), int(dsize[1])
    if w <= 0 and h <= 0:
        # cv2: auto dsize ≈ full resolution of the polar unwrap
        w = int(round(maxRadius))
        h = int(round(maxRadius * np.pi))
    if inverse:
        # cv2: polar source wrap-padded 1 row (angular seam), f32 maps
        mx, my = _warp.warp_polar_inverse_maps_cv(
            (a.shape[0], a.shape[1]), (h, w),
            (float(center[0]), float(center[1])), float(maxRadius),
            semilog=log)
        pad = np.concatenate([a[-1:], a, a[:1]], axis=0)
        # out-of-range dst pixels are UNDEFINED in cv2 (transparent
        # remap over an uninitialized dst); we emit constant 0
        return remap(pad, mx, my, fl & 7, _C.BORDER_CONSTANT)
    mx, my = _warp.warp_polar_maps((a.shape[0], a.shape[1]),
                                   (float(center[0]), float(center[1])),
                                   float(maxRadius), (h, w),
                                   semilog=log, inverse=False)
    # cv2 warpPolar delegates to remap; use the cv2-exact remap path
    return remap(a, mx, my, fl & 7, _C.BORDER_CONSTANT)


# ------------------------------------------------------------- filters

def GaussianBlur(src, ksize, sigmaX, dst=None, sigmaY=0, borderType=4):
    kx, ky = int(ksize[0]), int(ksize[1])
    sx = float(sigmaX)
    sy = float(sigmaY) if sigmaY not in (0, 0.0) else sx
    if kx == 0:
        kx = int(round(sx * 3 * 2 + 1)) | 1
    if ky == 0:
        ky = int(round(sy * 3 * 2 + 1)) | 1
    if kx == ky and sy == sx:
        sigma = sx if sx > 0 else -1.0
        return _pad_run_crop(
            src, kx // 2,
            lambda p: _o(_ip.gaussian_blur(_m(p), kx, sigma)), borderType)
    # Anisotropic (rectangular ksize and/or sigmaY != sigmaX): exact
    # float64 separable correlation with cv2's per-axis kernels.
    gx = _a(_ip.get_gaussian_kernel(kx, sx if sx > 0 else -1.0),
                    np.float64).ravel()
    gy = _a(_ip.get_gaussian_kernel(ky, sy if sy > 0 else -1.0),
                    np.float64).ravel()
    a = _a(src)
    pad = builtins_max(kx, ky) // 2
    out = _pad_run_crop(src, pad,
                        lambda p: _correlate_f64(p, np.outer(gy, gx)),
                        borderType)
    return _sat(out, -1, a.dtype)


def blur(src, ksize, dst=None, anchor=(-1, -1), borderType=4):
    from ..ops import core_ops as _co
    return _o(_co.blur(_a(src), (int(ksize[0]), int(ksize[1]))))


def boxFilter(src, ddepth, ksize, dst=None, anchor=(-1, -1),
              normalize=True, borderType=4):
    from ..ops import core_ops as _co
    out = _co.box_filter(_a(src), (int(ksize[0]), int(ksize[1])),
                         normalize=bool(normalize))
    return _sat(out, ddepth, _a(src).dtype)


def sqrBoxFilter(src, ddepth, ksize, dst=None, anchor=(-1, -1),
                 normalize=True, borderType=4):
    out = _ip.sqr_box_filter(_a(src), (int(ksize[0]), int(ksize[1])),
                             normalize=bool(normalize))
    return _sat(out, ddepth, np.float32)


def medianBlur(src, ksize, dst=None):
    return _o(_ip.median_blur(_m(src), int(ksize)))


def bilateralFilter(src, d, sigmaColor, sigmaSpace, dst=None, borderType=4):
    return _o(_ip.bilateral_filter(_m(src), int(sigmaColor)))


def _correlate_f64(p, k):
    """Exact float64 correlation with replicate border (the caller's
    _pad_run_crop ring already carries the requested cv2 border). Host
    code: a padded tensor comes to the host."""
    p = _a(p)
    kh, kw = k.shape
    ry, rx = kh // 2, kw // 2
    h, w = p.shape[:2]
    pp = np.pad(p.astype(np.float64),
                ((ry, ry), (rx, rx)) + ((0, 0),) * (p.ndim - 2),
                mode="edge")
    acc = np.zeros(p.shape, np.float64)
    for dy in range(kh):
        for dx in range(kw):
            acc += k[dy, dx] * pp[dy:dy + h, dx:dx + w]
    return acc


def filter2D(src, ddepth, kernel, dst=None, anchor=(-1, -1), delta=0,
             borderType=4):
    k = _a(kernel, np.float64)
    pad = builtins_max(k.shape) // 2
    a = _a(src)
    u8_out = ddepth in (-1, None, _C.CV_8U) and a.dtype == np.uint8
    if u8_out and not delta:
        return _pad_run_crop(src, pad, lambda p: _o(_ip.filter2d(_m(p), k)),
                             borderType)
    out = _pad_run_crop(src, pad, lambda p: _correlate_f64(p, k), borderType)
    return _sat(out + delta, ddepth, a.dtype)


def sepFilter2D(src, ddepth, kernelX, kernelY, dst=None, anchor=(-1, -1),
                delta=0, borderType=4):
    kx = _a(kernelX, np.float64).ravel()
    ky = _a(kernelY, np.float64).ravel()
    pad = builtins_max(len(kx), len(ky)) // 2
    a = _a(src)
    u8_out = ddepth in (-1, None, _C.CV_8U) and a.dtype == np.uint8
    if u8_out and not delta:
        return _pad_run_crop(src, pad,
                             lambda p: _o(_ip.sep_filter_2d(_m(p), kx, ky)),
                             borderType)
    out = _pad_run_crop(src, pad,
                        lambda p: _correlate_f64(p, np.outer(ky, kx)),
                        borderType)
    return _sat(out + delta, ddepth, a.dtype)


def Sobel(src, ddepth, dx, dy, dst=None, ksize=3, scale=1, delta=0,
          borderType=4):
    out = _pad_run_crop(
        src, int(ksize) // 2,
        lambda p: _ip.sobel(_m(p), int(dx), int(dy), int(ksize)),
        borderType).astype(np.float64)
    return _sat(out * scale + delta, ddepth, _a(src).dtype)


def Scharr(src, ddepth, dx, dy, dst=None, scale=1, delta=0, borderType=4):
    out = _pad_run_crop(src, 1,
                        lambda p: _ip.scharr(_m(p), int(dx), int(dy)),
                        borderType).astype(np.float64)
    return _sat(out * scale + delta, ddepth, _a(src).dtype)


def Laplacian(src, ddepth, dst=None, ksize=1, scale=1, delta=0,
              borderType=4):
    if ksize == 1:
        # special 3x3 aperture [[0,1,0],[1,-4,1],[0,1,0]]
        out = _pad_run_crop(src, 1,
                            lambda p: _a(_ip.laplacian(_m(p))),
                            borderType).astype(np.float64)
        return _sat(out * scale + delta, ddepth, _a(src).dtype)
    # ksize >= 3: sum of the two second-derivative separable kernels
    # (getDerivKernels), cv2-exact — for ksize=3 this reproduces the
    # documented [[2,0,2],[0,-8,0],[2,0,2]] aperture (the ksize=1 kernel
    # applied for ksize=3 is up to 1422 off cv2 on random u8).
    from ..ops import filters as _F

    d2, sm = _F.deriv_kernels(2, 0, int(ksize))
    k = (np.outer(_a(sm, np.float64), _a(d2, np.float64))
         + np.outer(_a(d2, np.float64), _a(sm, np.float64)))
    out = _pad_run_crop(src, int(ksize) // 2,
                        lambda p: _correlate_f64(p, k), borderType)
    return _sat(out * scale + delta, ddepth, _a(src).dtype)


def spatialGradient(src, dx=None, dy=None, ksize=3, borderType=4):
    gx, gy = _ip.spatial_gradient(_t(src), int(ksize))
    return _a(gx, np.int16), _a(gy, np.int16)


def Canny(image, threshold1, threshold2, edges=None, apertureSize=3,
          L2gradient=False):
    # bit-exact cv2 algorithm (ops/canny_cv.py): raw Sobel, fixed-point
    # sector NMS, unbounded 8-connected hysteresis.  The framework's own
    # frozen spec (ops/golden.py::canny, Gaussian-prefiltered, bounded
    # hysteresis) stays behind rustcv_tpu_torch.imgproc.canny.
    from ..ops.canny_cv import canny_cv
    return canny_cv(_o(_hwc(image)), threshold1, threshold2,
                    int(apertureSize), bool(L2gradient))


def erode(src, kernel, dst=None, anchor=(-1, -1), iterations=1,
          borderType=0, borderValue=None):
    return _morph_iter(_ip.erode_kernel, src, kernel, iterations, 255)


def dilate(src, kernel, dst=None, anchor=(-1, -1), iterations=1,
           borderType=0, borderValue=None):
    return _morph_iter(_ip.dilate_kernel, src, kernel, iterations, 0)


def _morph_iter(fn, src, kernel, iterations, identity):
    """cv2 erode/dilate default border is BORDER_CONSTANT at the morph
    identity (+inf for erode, -inf for dilate), NOT replicate — they only
    coincide for kernels whose window always contains in-image support
    (e.g. all-ones). Pad with the identity, run, crop (cross and hit-miss
    kernels differ at the borders otherwise)."""
    if kernel is None:
        kernel = np.ones((3, 3), np.uint8)
    k = _a(kernel)
    it = max(1, int(iterations))
    ry, rx = it * (k.shape[0] // 2), it * (k.shape[1] // 2)
    a = _a(src)
    pad = ((ry, ry), (rx, rx)) + ((0, 0),) * (a.ndim - 2)
    m = _m(np.pad(a, pad, constant_values=identity))
    for _ in range(it):
        m = fn(m, k)
    out = _a(_o(m))
    return _o(np.ascontiguousarray(out[ry:out.shape[0] - ry,
                                       rx:out.shape[1] - rx]))


_MORPH_NAMES = {2: "open", 3: "close", 4: "gradient", 5: "tophat",
                6: "blackhat"}


def morphologyEx(src, op, kernel, dst=None, anchor=(-1, -1), iterations=1,
                 borderType=0, borderValue=None):
    op = int(op)
    if op == _C.MORPH_ERODE:
        return erode(src, kernel, iterations=iterations)
    if op == _C.MORPH_DILATE:
        return dilate(src, kernel, iterations=iterations)
    k = _a(kernel) if kernel is not None else np.ones((3, 3), np.uint8)
    if op == _C.MORPH_HITMISS:
        # cv2 semantics (binary input): erode by the +1 cells AND erode
        # the complement by the -1 cells; 0 cells are don't-care.
        ks = k.astype(np.int8)
        a = _a(src)
        e1 = _a(erode(a, (ks == 1).astype(np.uint8))) \
            if (ks == 1).any() else np.full_like(a, 255)
        e2 = _a(erode(255 - a, (ks == -1).astype(np.uint8))) \
            if (ks == -1).any() else np.full_like(a, 255)
        return _o(np.minimum(e1, e2))
    if op not in _MORPH_NAMES:
        raise NotImplementedError(f"morphologyEx op {op}")
    # square all-ones kernels ride the fused device path
    if (k.ndim == 2 and k.shape[0] == k.shape[1] and np.all(k != 0)
            and iterations == 1):
        return _o(_ip.morphology_ex(_m(src), _MORPH_NAMES[op], k.shape[0]))
    a = _a(src)
    er = lambda x: erode(x, k)
    di = lambda x: dilate(x, k)
    if op == _C.MORPH_OPEN:
        return di(er(a))
    if op == _C.MORPH_CLOSE:
        return er(di(a))
    if op == _C.MORPH_GRADIENT:
        return subtract(di(a), er(a))
    if op == _C.MORPH_TOPHAT:
        return subtract(a, di(er(a)))
    return subtract(er(di(a)), a)  # blackhat


def getStructuringElement(shape, ksize, anchor=(-1, -1)):
    names = {_C.MORPH_RECT: "rect", _C.MORPH_CROSS: "cross",
             _C.MORPH_ELLIPSE: "ellipse"}
    kw, kh = int(ksize[0]), int(ksize[1])
    if kw == kh and kw % 2 == 1:
        return _a(_ip.get_structuring_element(names[int(shape)], kw),
                          dtype=np.uint8)
    # Rectangular elements: OpenCV getStructuringElement row scan
    # (modules/imgproc/src/morph.cpp), bit-exact incl. the inscribed-
    # ellipse int truncation.
    ax = kw // 2 if anchor[0] < 0 else int(anchor[0])
    ay = kh // 2 if anchor[1] < 0 else int(anchor[1])
    shape = int(shape)
    elem = np.zeros((kh, kw), np.uint8)
    r, c = kh // 2, kw // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(kh):
        if shape == _C.MORPH_RECT or (shape == _C.MORPH_CROSS and i == ay):
            elem[i, :] = 1
        elif shape == _C.MORPH_CROSS:
            elem[i, ax] = 1
        else:  # MORPH_ELLIPSE
            dy = i - r
            if abs(dy) <= r:
                dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
                elem[i, max(c - dx, 0): min(c + dx + 1, kw)] = 1
    return elem


_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def getGaussianKernel(ksize, sigma, ktype=6):
    # cv2's exact algorithm: fixed binomial tables for small auto-sigma
    # kernels, the 0.3*((n-1)/2 - 1) + 0.8 formula otherwise.
    n = int(ksize)
    if sigma <= 0 and n in _SMALL_GAUSSIAN_TAB:
        k = _a(_SMALL_GAUSSIAN_TAB[n], np.float64)
    else:
        s = float(sigma) if sigma > 0 else 0.3 * ((n - 1) * 0.5 - 1) + 0.8
        x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
        k = np.exp(-(x * x) / (2.0 * s * s))
        k /= k.sum()
        if sigma <= 0:
            # cv2's auto-sigma path quantizes to 1/256ths, folding the
            # rounding residue into the center tap
            q = np.rint(k * 256.0)
            q[n // 2] += 256.0 - q.sum()
            k = q / 256.0
    k = k.reshape(-1, 1)
    return k.astype(np.float32) if ktype == _C.CV_32F else k


def getGaborKernel(ksize, sigma, theta, lambd, gamma, psi=np.pi * 0.5,
                   ktype=6):
    k = _ip.get_gabor_kernel((int(ksize[0]), int(ksize[1])), sigma, theta,
                             lambd, gamma, psi)
    return _a(k, np.float32 if ktype == _C.CV_32F else np.float64)


def stackBlur(src, ksize, dst=None):
    """StackBlur (triangular separable). u8: within the measured cv2
    envelope (≤3 LSB k≤13 / ≤6 k≤63; cv2's own bits are SIMD-lane-
    position-dependent — vector body rounds the fixed-point shift, scalar
    tail truncates — and its final column mishandles the last window
    step); the truncating scalar form is the frozen spec (ops/golden.py).
    float32: the true float triangular filter, matches cv2 to f32 noise
    everywhere but cv2's buggy last column."""
    from ..ops import filters as _f

    a = _a(src)
    kw, kh = int(ksize[0]), int(ksize[1])
    if a.dtype == np.uint8:
        return _o(_a(_f.stack_blur_u8(_t(src), kw, kh)))
    rw, rh = kw // 2, kh // 2
    x = a.astype(np.float64)
    nd2 = x.ndim == 2
    if nd2:
        x = x[..., None]
    p = np.pad(x, ((0, 0), (rw, rw), (0, 0)), mode="edge")
    h = sum((rw + 1 - abs(i)) * p[:, rw + i : rw + i + a.shape[1]]
            for i in range(-rw, rw + 1)) / float((rw + 1) ** 2)
    p = np.pad(h, ((rh, rh), (0, 0), (0, 0)), mode="edge")
    v = sum((rh + 1 - abs(i)) * p[rh + i : rh + i + a.shape[0]]
            for i in range(-rh, rh + 1)) / float((rh + 1) ** 2)
    out = (v[..., 0] if nd2 else v).astype(a.dtype)
    return _o(out)


def pyrDown(src, dst=None, dstsize=None, borderType=4):
    # cv2 pads with BORDER_REFLECT_101; the op replicates — pad by 2
    # (even, so decimation parity is kept), run, crop 1
    a = _a(src)
    name = _BORDER_NAMES.get(int(borderType) & 15, "reflect101")
    padded = _a(_ip.copy_make_border(a, 2, 2, 2, 2, name, 0))
    out = _a(_o(_ip.pyr_down(_m(padded))))
    return out[1:1 + (a.shape[0] + 1) // 2, 1:1 + (a.shape[1] + 1) // 2]


def pyrUp(src, dst=None, dstsize=None, borderType=4):
    # cv2 quirk: the border reflects on the UPSAMPLED zero-interleaved
    # grid, not the source — bit-exact integer construction
    # ((t + 32) >> 6 after the separable [1,4,6,4,1]² conv)
    a = _a(src)
    chans = a[..., None] if a.ndim == 2 else a
    k = np.array([1, 4, 6, 4, 1], np.int64)
    outs = []
    for c in range(chans.shape[2]):
        plane = chans[..., c]
        z = np.zeros((2 * plane.shape[0], 2 * plane.shape[1]),
                     np.float64 if np.issubdtype(a.dtype, np.floating)
                     else np.int64)
        z[::2, ::2] = plane
        p = np.pad(z, 2, mode="reflect")
        t = np.apply_along_axis(np.convolve, 1, p, k, "valid")
        t = np.apply_along_axis(np.convolve, 0, t, k, "valid")
        if np.issubdtype(a.dtype, np.floating):
            outs.append((t / 64.0).astype(a.dtype))
        elif a.dtype == np.uint8:
            outs.append(np.clip((t + 32) >> 6, 0, 255).astype(np.uint8))
        else:
            info = np.iinfo(a.dtype)
            outs.append(np.clip((t + 32) >> 6, info.min,
                                info.max).astype(a.dtype))
    out = np.stack(outs, axis=-1)
    return out[..., 0] if a.ndim == 2 else out


def buildOpticalFlowPyramid(img, winSize, maxLevel, pyramid=None,
                            withDerivatives=True, pyrBorder=4,
                            derivBorder=0, tryReuseInputImage=True):
    """cv2 semantics (lkpyramid.cpp): levels are exact pyrDown chains;
    building stops when the NEXT level would not exceed winSize in both
    dimensions; returns (top_level, [img0, deriv0, img1, deriv1, ...])
    with int16 Scharr (3,10,3) xy-derivative pairs when requested."""
    _pd = pyrDown  # the cv2-exact variant, not the frozen capture spec

    g = _a(img)
    ww, wh = int(winSize[0]), int(winSize[1])
    levels = [g]
    top = 0
    while top < int(maxLevel):
        h, w = levels[-1].shape[:2]
        nw, nh = (w + 1) // 2, (h + 1) // 2
        if nw <= ww or nh <= wh:
            break
        levels.append(_pd(levels[-1]))
        top += 1
    if not withDerivatives:
        return top, levels

    def _scharr_deriv(a):
        # BORDER_REFLECT_101 on the level image (np "reflect")
        p = np.pad(a.astype(np.int32), 1, mode="reflect")
        dx = (3 * (p[:-2, 2:] + p[2:, 2:] - p[:-2, :-2] - p[2:, :-2])
              + 10 * (p[1:-1, 2:] - p[1:-1, :-2]))
        dy = (3 * (p[2:, :-2] + p[2:, 2:] - p[:-2, :-2] - p[:-2, 2:])
              + 10 * (p[2:, 1:-1] - p[:-2, 1:-1]))
        return np.stack([dx, dy], axis=-1).astype(np.int16)

    out = []
    for lvl in levels:
        out.append(lvl)
        out.append(_scharr_deriv(lvl))
    return top, out


def copyMakeBorder(src, top, bottom, left, right, borderType, dst=None,
                   value=0):
    name = _BORDER_NAMES.get(int(borderType) & 15, "constant")
    return _o(_ip.copy_make_border(_a(src), int(top), int(bottom),
                                   int(left), int(right), name, value))


def borderInterpolate(p, len_, borderType):
    return int(_ip.border_interpolate(int(p), int(len_),
                                      _BORDER_NAMES[int(borderType) & 15]))


# ------------------------------------------------------------- histograms

def equalizeHist(src, dst=None):
    return _o(_ip.equalize_hist(_m(src)))


class CLAHE:
    """cv2.CLAHE role over the device `imgproc.clahe` op."""

    def __init__(self, clipLimit=40.0, tileGridSize=(8, 8)):
        self._clip = clipLimit
        self._grid = tuple(int(v) for v in tileGridSize)

    def apply(self, src, dst=None):
        return _o(_ip.clahe(_m(src), int(self._clip), self._grid))

    def setClipLimit(self, v):
        self._clip = v

    def getClipLimit(self):
        return self._clip

    def setTilesGridSize(self, sz):
        self._grid = tuple(int(v) for v in sz)

    def getTilesGridSize(self):
        return self._grid


def createCLAHE(clipLimit=40.0, tileGridSize=(8, 8)):
    return CLAHE(clipLimit, tileGridSize)


def calcHist(images, channels, mask, histSize, ranges, hist=None,
             accumulate=False):
    img = _a(images[0])
    ch = channels[0] if channels else 0
    plane = img if img.ndim == 2 else img[..., ch]
    n = int(histSize[0])
    lo, hi = (float(ranges[0]), float(ranges[1])) if ranges else (0.0, 256.0)
    if (plane.dtype == np.uint8 and n == 256 and (lo, hi) == (0.0, 256.0)
            and mask is None):
        # cv2 5.0 returns histograms 1-D
        return _a(_ip.calc_hist(_m(plane)), np.float32)
    vals = plane[mask.astype(bool)] if mask is not None else plane.ravel()
    idx = np.floor((vals.astype(np.float64) - lo) * (n / (hi - lo)))
    idx = idx[(idx >= 0) & (idx < n)].astype(np.int64)
    return np.bincount(idx, minlength=n).astype(np.float32)


_HISTCMP_NAMES = {0: "correl", 1: "chisqr", 2: "intersect",
                  3: "bhattacharyya", 4: "chisqr_alt", 5: "kl_div"}


def compareHist(H1, H2, method):
    from ..ops import core_ops as _co
    return float(_co.compare_hist(_a(H1).ravel(),
                                  _a(H2).ravel(),
                                  _HISTCMP_NAMES[int(method)]))


def calcBackProject(images, channels, hist, ranges, scale=1):
    """cv2 semantics: per-pixel uniform-bin lookup hist[bin(v)] * scale,
    saturate_cast to u8; out-of-range values map to 0 (differential-
    tested vs cv2 5.0 for 1- and 2-channel histograms)."""
    img = _a(images[0])
    h = np.squeeze(_a(hist, np.float64))
    if h.ndim == 0:
        h = h.reshape(1)
    idxs = []
    valid = None
    for k in range(h.ndim):
        ch = int(channels[k]) if channels else 0
        plane = img if img.ndim == 2 else img[..., ch]
        lo, hi = float(ranges[2 * k]), float(ranges[2 * k + 1])
        n = h.shape[k]
        sc = n / (hi - lo)
        idx = np.floor((plane.astype(np.float64) - lo) * sc).astype(np.int64)
        inr = (idx >= 0) & (idx < n)
        idxs.append(np.clip(idx, 0, n - 1))
        valid = inr if valid is None else (valid & inr)
    vals = h[tuple(idxs)]
    vals = np.where(valid, vals, 0.0) * float(scale)
    return np.clip(np.rint(vals), 0, 255).astype(np.uint8)


def createHanningWindow(winSize, type=5):
    from ..ops import core_ops as _co
    w = _co.create_hanning_window((int(winSize[1]), int(winSize[0])))
    return _a(w, np.float32 if type == _C.CV_32F else np.float64)


# ------------------------------------------------------------- core array

def _np2(a, b, op):
    return op(_a(a), _a(b))


def add(src1, src2, dst=None, mask=None, dtype=-1):
    return _o(_ip.add(_m(src1), _m(src2)))


def subtract(src1, src2, dst=None, mask=None, dtype=-1):
    return _o(_ip.subtract(_m(src1), _m(src2)))


def multiply(src1, src2, dst=None, scale=1, dtype=-1):
    # host code, as the reference's: ops.multiply_u8 on host arrays
    # (float64)
    return _o(_ip.multiply(_o(_hwc(src1)), _o(_hwc(src2)), float(scale)))


def divide(src1, src2, dst=None, scale=1, dtype=-1):
    return _o(_ip.divide(_o(_hwc(src1)), _o(_hwc(src2)), float(scale)))


def absdiff(src1, src2, dst=None):
    return _o(_ip.absdiff(_m(src1), _m(src2)))


def addWeighted(src1, alpha, src2, beta, gamma, dst=None, dtype=-1):
    return _o(_ip.add_weighted(_m(src1), float(alpha), _m(src2),
                               float(beta), float(gamma)))


def scaleAdd(src1, alpha, src2, dst=None):
    return _o(_ip.scale_add(_a(src1), float(alpha),
                            _a(src2)))


def bitwise_and(src1, src2, dst=None, mask=None):
    return _o(_ip.bitwise_and(_m(src1), _m(src2)))


def bitwise_or(src1, src2, dst=None, mask=None):
    return _o(_ip.bitwise_or(_m(src1), _m(src2)))


def bitwise_xor(src1, src2, dst=None, mask=None):
    return _o(_ip.bitwise_xor(_m(src1), _m(src2)))


def bitwise_not(src, dst=None, mask=None):
    return _o(_ip.bitwise_not(_m(src)))


def min(src1, src2, dst=None):  # noqa: A001 - cv2 API name
    return _np2(src1, src2, np.minimum)


def max(src1, src2, dst=None):  # noqa: A001 - cv2 API name
    return _np2(src1, src2, np.maximum)


def mean(src, mask=None):
    a = _a(src, np.float64)
    if mask is not None:
        sel = _a(mask).astype(bool)
        a = a[sel]
        mu = a.mean(axis=0) if a.ndim > 1 else a.mean()
    else:
        mu = a.mean(axis=(0, 1)) if a.ndim == 3 else a.mean()
    mu = np.atleast_1d(mu)
    return tuple(np.concatenate([mu, np.zeros(4 - len(mu))]))


def meanStdDev(src, mean=None, stddev=None, mask=None):
    a = _a(src, np.float64)
    if a.ndim == 2:
        a = a[..., None]
    if mask is not None:
        a = a[_a(mask).astype(bool)]
        mu = a.mean(axis=0)
        sd = a.std(axis=0)
    else:
        mu = a.mean(axis=(0, 1))
        sd = a.std(axis=(0, 1))
    return mu.reshape(-1, 1), sd.reshape(-1, 1)


def minMaxLoc(src, mask=None):
    a = _a(src)
    if mask is not None:
        masked = np.where(_a(mask).astype(bool), a.astype(np.float64),
                          np.nan)
        mn = np.nanmin(masked)
        mx = np.nanmax(masked)
        mnl = np.unravel_index(np.nanargmin(masked), a.shape)
        mxl = np.unravel_index(np.nanargmax(masked), a.shape)
        return float(mn), float(mx), (int(mnl[1]), int(mnl[0])), \
            (int(mxl[1]), int(mxl[0]))
    return _ip.min_max_loc(a)


def norm(src1, src2=None, normType=4, mask=None):
    # cv2's one-array overload is norm(src1, normType[, mask]) — a
    # scalar second positional is the norm type, not a second array
    if src2 is not None and np.isscalar(src2):
        normType, src2 = int(src2), None
    a = _a(src1, np.float64)
    if src2 is not None:
        a = a - _a(src2, np.float64)
    if mask is not None:
        sel = _a(mask) != 0
        if a.ndim == 3 and sel.ndim == 2:
            sel = sel[..., None]
        a = np.where(sel, a, 0.0)
    nt = int(normType) & 7
    if int(normType) & _C.NORM_RELATIVE and src2 is not None:
        return norm(a, None, nt, mask) / max(norm(src2, None, nt, mask),
                                             1e-300)
    if nt == _C.NORM_INF:
        return float(np.abs(a).max())
    if nt == _C.NORM_L1:
        return float(np.abs(a).sum())
    if nt == _C.NORM_L2SQR:
        return float((a * a).sum())
    if nt == _C.NORM_HAMMING:
        return float(np.unpackbits(_a(a, np.uint8)).sum())
    return float(np.sqrt((a * a).sum()))


def countNonZero(src):
    return int(_ip.count_non_zero(_m(src)))


def hasNonZero(src):
    return bool(_ip.has_non_zero(_m(src)))


def findNonZero(src, idx=None):
    # cv2 5.0 returns (N, 2) int32 (x, y) in raster order
    return _a(_ip.find_non_zero(_a(src)), np.int32)


def split(m):
    a = _a(m)
    if a.ndim == 2:
        return (a.copy(),)
    return tuple(np.ascontiguousarray(a[..., i]) for i in range(a.shape[2]))


def merge(mv, dst=None):
    return np.ascontiguousarray(np.stack([_a(c) for c in mv],
                                         axis=-1))


def hconcat(src):
    return np.ascontiguousarray(np.concatenate([_a(s) for s in src],
                                               axis=1))


def vconcat(src):
    return np.ascontiguousarray(np.concatenate([_a(s) for s in src],
                                               axis=0))


def transpose(src, dst=None):
    a = _a(src)
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return np.ascontiguousarray(np.swapaxes(a, 0, 1))


def transposeND(src, order, dst=None):
    return np.ascontiguousarray(np.transpose(_a(src), order))


def repeat(src, ny, nx, dst=None):
    return _o(_ip.repeat(_a(src), int(ny), int(nx)))


def convertScaleAbs(src, dst=None, alpha=1, beta=0):
    return _o(_ip.convert_scale_abs(_m(src), float(alpha), float(beta)))


def LUT(src, lut, dst=None):
    return _o(_ip.lut(_m(src), _a(lut).ravel()))


def normalize(src, dst=None, alpha=1, beta=0, norm_type=4, dtype=-1,
              mask=None):
    names = {_C.NORM_MINMAX: "minmax", _C.NORM_INF: "inf",
             _C.NORM_L1: "l1", _C.NORM_L2: "l2"}
    nm = names[int(norm_type)]
    if nm == "minmax":
        out = _o(_ip.normalize(_m(src), float(builtins_min(alpha, beta)),
                               float(builtins_max(alpha, beta)), nm))
    else:
        out = _o(_ip.normalize(_m(src), float(alpha), 0.0, nm))
    if dst is not None:
        _copyto(dst, out.reshape(_a(dst).shape))
        return dst
    return out


import builtins as _builtins  # noqa: E402
builtins_min = _builtins.min
builtins_max = _builtins.max


def integral(src, sum=None, sdepth=-1):
    return _a(_ip.integral(_m(src)), np.int32)


def integral2(src, **kw):
    s, sq = _ip.integral2(_o(_a(src)))
    return _a(s, np.int32), _a(sq, np.float64)


def integral3(src, **kw):
    s, sq, t = _ip.integral3(_o(_a(src)))
    return _a(s, np.int32), _a(sq, np.float64), \
        _a(t, np.int32)


def magnitude(x, y, magnitude=None):
    return _a(_ip.magnitude(_a(x), _a(y)))


def phase(x, y, angle=None, angleInDegrees=False):
    return _a(_ip.phase(_a(x), _a(y),
                                bool(angleInDegrees)))


def cartToPolar(x, y, magnitude=None, angle=None, angleInDegrees=False):
    m, a = _ip.cart_to_polar(_a(x), _a(y),
                             bool(angleInDegrees))
    return _a(m), _a(a)


def polarToCart(magnitude, angle, x=None, y=None, angleInDegrees=False):
    xx, yy = _ip.polar_to_cart(_a(magnitude), _a(angle),
                               bool(angleInDegrees))
    return _a(xx), _a(yy)


def fastAtan2(y, x):
    return float(_ip.fast_atan2(float(y), float(x)))


def cubeRoot(val):
    return float(_ip.cube_root(float(val)))


def exp(src, dst=None):
    return np.exp(_a(src))


def log(src, dst=None):
    return np.log(_a(src))


def sqrt(src, dst=None):
    return np.sqrt(_a(src))


def pow(src, power, dst=None):  # noqa: A001 - cv2 API name
    return np.power(_a(src), power)


def compare(src1, src2, cmpop):
    from ..ops import core_ops as _co
    names = {0: "eq", 1: "gt", 2: "ge", 3: "lt", 4: "le", 5: "ne"}
    return _a(_co.compare(_a(src1), _a(src2),
                                  names[int(cmpop)]))


def gemm(src1, src2, alpha, src3, beta, dst=None, flags=0):
    from ..ops import core_ops as _co
    return _a(_co.gemm(_a(src1), _a(src2),
                               float(alpha), src3, float(beta), int(flags)))


def PSNR(src1, src2, R=255.0):
    return float(_ip.psnr(_m(src1), _m(src2)))


def reduce(src, dim, rtype, dst=None, dtype=-1):
    names = {_C.REDUCE_SUM: "sum", _C.REDUCE_AVG: "avg",
             _C.REDUCE_MAX: "max", _C.REDUCE_MIN: "min"}
    if int(rtype) not in names:
        raise NotImplementedError(f"reduce rtype {rtype}")
    out = _a(_ip.reduce(_a(src), int(dim),
                                names[int(rtype)]))
    out = out.reshape(1, -1) if int(dim) == 0 else out.reshape(-1, 1)
    if dtype != -1:
        return _sat(out, dtype, _a(src).dtype)
    if int(rtype) == _C.REDUCE_SUM:
        return out  # f64 accumulator (cv2 requires an explicit dtype)
    return _sat(out, -1, _a(src).dtype)


def reduceArgMax(src, axis, lastIndex=False):
    return _a(_ip.reduce_arg_max(_a(src), int(axis),
                                         bool(lastIndex)))


def reduceArgMin(src, axis, lastIndex=False):
    return _a(_ip.reduce_arg_min(_a(src), int(axis),
                                         bool(lastIndex)))


def sortIdx(src, flags):
    axis = 0 if int(flags) & _C.SORT_EVERY_COLUMN else 1
    desc = bool(int(flags) & _C.SORT_DESCENDING)
    return _a(_ip.sort_idx(_a(src), axis=axis,
                                   descending=desc))


def sort(src, flags, dst=None):
    axis = 0 if int(flags) & _C.SORT_EVERY_COLUMN else 1
    desc = bool(int(flags) & _C.SORT_DESCENDING)
    return _a(_ip.sort(_a(src), axis=axis,
                               descending=desc))


def setIdentity(mtx, s=1):
    a = _a(mtx)
    sval = s[0] if isinstance(s, (tuple, list, np.ndarray)) else s
    out = _a(_ip.set_identity(a.shape, float(sval), a.dtype))
    _copyto(mtx, out.astype(a.dtype))
    return mtx


def completeSymm(m, lowerToUpper=False):
    from ..ops import core_ops as _co
    out = _a(_co.complete_symm(_a(m), bool(lowerToUpper)))
    _copyto(m, out)
    return m


def determinant(mtx):
    return float(_ip.determinant(_a(mtx)))


def trace(mtx):
    t = _ip.trace(_a(mtx))
    return (float(t), 0.0, 0.0, 0.0)


def invert(src, dst=None, flags=0):
    ok, inv = _ip.invert(_a(src, np.float64))
    return ok, _a(inv)


def solve(src1, src2, dst=None, flags=0):
    ok, x = _ip.solve(_a(src1, np.float64),
                      _a(src2, np.float64))
    return ok, _a(x)


def eigen(src, eigenvalues=None, eigenvectors=None):
    from ..ops import core_ops as _co
    ok, w, v = _co.eigen(_a(src, np.float64))
    return ok, _a(w).reshape(-1, 1), _a(v)


def eigenNonSymmetric(src, eigenvalues=None, eigenvectors=None):
    from ..ops import core_ops as _co
    w, v = _co.eigen_non_symmetric(_a(src, np.float64))
    return _a(w).reshape(-1, 1), _a(v)


def SVDecomp(src, w=None, u=None, vt=None, flags=0):
    w_, u_, vt_ = _ip.sv_decomp(_a(src, np.float64))
    return _a(w_).reshape(-1, 1), _a(u_), _a(vt_)


def SVBackSubst(w, u, vt, rhs, dst=None):
    return _a(_ip.sv_back_subst(_a(w).ravel(),
                                        _a(u), _a(vt),
                                        _a(rhs)))


def PCACompute(data, mean, eigenvectors=None, maxComponents=0):
    # ops.pca_compute returns (mean, eigenvectors, eigenvalues) and
    # takes (data, mean, max_components)
    mu, vecs, _vals = _ip.pca_compute(
        _a(data, np.float64),
        None if mean is None else _a(mean, np.float64),
        int(maxComponents))
    return _a(mu).reshape(1, -1), _a(vecs)


def PCAProject(data, mean, eigenvectors, result=None):
    a = _a(data)
    dt = a.dtype if a.dtype in (np.float32, np.float64) else np.float64
    return _a(_ip.pca_project(a, _a(mean).ravel(),
                                      _a(eigenvectors)), dt)


def PCABackProject(data, mean, eigenvectors, result=None):
    a = _a(data)
    dt = a.dtype if a.dtype in (np.float32, np.float64) else np.float64
    return _a(_ip.pca_back_project(a, _a(mean).ravel(),
                                           _a(eigenvectors)), dt)


def Mahalanobis(v1, v2, icovar):
    return float(_ip.mahalanobis(_a(v1).ravel(),
                                 _a(v2).ravel(),
                                 _a(icovar)))


def calcCovarMatrix(samples, mean, flags, ctype=6):
    from ..ops import core_ops as _co
    cov, mu = _co.calc_covar_matrix(_a(samples, np.float64),
                                    int(flags))
    return _a(cov), _a(mu)


def mulTransposed(src, aTa, dst=None, delta=None, scale=1, dtype=-1):
    a = _a(src, np.float64)
    if delta is not None:
        a = a - _a(delta, np.float64)
    return _a(_ip.mul_transposed(a, bool(aTa), float(scale)))


def mixChannels(src, dst, fromTo):
    # ops.mix_channels takes per-output CHANNEL COUNTS, not the arrays
    dsts = [_a(d) for d in dst]
    counts = [1 if d.ndim == 2 else d.shape[-1] for d in dsts]
    out = _ip.mix_channels([_a(s) for s in src], counts,
                           [int(v) for v in fromTo])
    for d, o in zip(dst, out):
        _copyto(d, _a(o).reshape(_a(d).shape))
    return dst


def extractChannel(src, coi, dst=None):
    return _a(_ip.extract_channel(_a(src), int(coi)))


def insertChannel(src, dst, coi):
    out = _a(_ip.insert_channel(_a(src), _a(dst),
                                        int(coi)))
    _copyto(dst, out)
    return dst


def copyTo(src, mask, dst=None):
    out = _ip.copy_to(_a(src), _a(mask),
                      None if dst is None else _a(dst))
    out = _a(out)
    if dst is not None:
        _copyto(dst, out)
        return dst
    return out


def convertFp16(src, dst=None):
    a = _a(src)
    return a.astype(np.float16) if a.dtype != np.float16 \
        else a.astype(np.float32)


def checkRange(a, quiet=True, minVal=-1e308, maxVal=1e308):
    ok, pos = _ip.check_range(_a(a), float(minVal), float(maxVal))
    if not ok and not quiet:
        raise ValueError(f"checkRange failed at {pos}")
    return bool(ok)


def patchNaNs(a, val=0):
    out = _a(_ip.patch_nans(_a(a), float(val)))
    _copyto(a, out)
    return a


def finiteMask(img, mask=None):
    return _a(_ip.finite_mask(_a(img)))


_the_rng = _ip.RNG()


def theRNG():
    return _the_rng


def setRNGSeed(seed):
    global _the_rng
    _the_rng = _ip.RNG(int(seed))


def randu(dst, low, high):
    out = _the_rng.randu(_a(dst).shape, low, high,
                         dtype=_a(dst).dtype)
    _copyto(dst, out)
    return dst


def randn(dst, mean, stddev):
    out = _the_rng.randn(_a(dst).shape, mean, stddev,
                         dtype=_a(dst).dtype)
    _copyto(dst, out)
    return dst


def randShuffle(dst, iterFactor=1.0, rng=None):
    out = _ip.rand_shuffle(_a(dst), rng if rng is not None
                           else _the_rng)
    _copyto(dst, out)
    return dst


def kmeans(data, K, bestLabels, criteria, attempts, flags, centers=None):
    compactness, labels, ctrs = _ip.kmeans(_t(data),
                                           int(K))
    return float(compactness), _a(labels, np.int32).reshape(-1, 1), \
        _a(ctrs, np.float32)


# ------------------------------------------------------------- dft family

def _ccs_pack(F):
    """Complex spectrum of a REAL 2-D input → cv2's CCS-packed real array
    (verified element-for-element vs cv2.dft; see tests/test_cv2_shim.py)."""
    H, W = F.shape
    A = np.zeros((H, W), np.float64)
    A[0, 0] = F[0, 0].real
    ks = np.arange(1, (W + 1) // 2)
    A[0, 2 * ks - 1] = F[0, ks].real
    A[0, 2 * ks] = F[0, ks].imag
    if W % 2 == 0:
        A[0, W - 1] = F[0, W // 2].real
    js = np.arange(1, (H + 1) // 2)
    A[2 * js - 1, 0] = F[js, 0].real
    A[2 * js, 0] = F[js, 0].imag
    if W % 2 == 0:
        A[2 * js - 1, W - 1] = F[js, W // 2].real
        A[2 * js, W - 1] = F[js, W // 2].imag
    if H % 2 == 0:
        A[H - 1, 0] = F[H // 2, 0].real
        if W % 2 == 0:
            A[H - 1, W - 1] = F[H // 2, W // 2].real
    A[1:, 2 * ks - 1] = F[1:, ks].real
    A[1:, 2 * ks] = F[1:, ks].imag
    return A


def _ccs_unpack(A):
    """cv2 CCS-packed real array → the full complex spectrum (inverse of
    ``_ccs_pack``, using conjugate symmetry for the redundant half)."""
    H, W = A.shape
    F = np.zeros((H, W), np.complex128)
    F[0, 0] = A[0, 0]
    ks = np.arange(1, (W + 1) // 2)
    F[0, ks] = A[0, 2 * ks - 1] + 1j * A[0, 2 * ks]
    if W % 2 == 0:
        F[0, W // 2] = A[0, W - 1]
    js = np.arange(1, (H + 1) // 2)
    F[js, 0] = A[2 * js - 1, 0] + 1j * A[2 * js, 0]
    if W % 2 == 0:
        F[js, W // 2] = A[2 * js - 1, W - 1] + 1j * A[2 * js, W - 1]
    if H % 2 == 0:
        F[H // 2, 0] = A[H - 1, 0]
        if W % 2 == 0:
            F[H // 2, W // 2] = A[H - 1, W - 1]
    F[1:, ks] = A[1:, 2 * ks - 1] + 1j * A[1:, 2 * ks]
    # conjugate-symmetric completion: F[j, W-k] = conj(F[(H-j) % H, k])
    kk = np.arange((W + 1) // 2 + (0 if W % 2 else 1), W)
    F[:, kk] = np.conj(F[(-np.arange(H)) % H][:, W - kk])
    js_hi = np.arange((H + 1) // 2 + (0 if H % 2 else 1), H)
    F[js_hi, 0] = np.conj(F[H - js_hi, 0])
    if W % 2 == 0:
        F[js_hi, W // 2] = np.conj(F[H - js_hi, W // 2])
    return F


def _ccs_pack_rows(F):
    """Per-row CCS pack (DFT_ROWS semantics on real input)."""
    n, W = F.shape
    A = np.zeros((n, W), np.float64)
    A[:, 0] = F[:, 0].real
    ks = np.arange(1, (W + 1) // 2)
    A[:, 2 * ks - 1] = F[:, ks].real
    A[:, 2 * ks] = F[:, ks].imag
    if W % 2 == 0:
        A[:, W - 1] = F[:, W // 2].real
    return A


def _ccs_unpack_rows(A):
    n, W = A.shape
    F = np.zeros((n, W), np.complex128)
    F[:, 0] = A[:, 0]
    ks = np.arange(1, (W + 1) // 2)
    F[:, ks] = A[:, 2 * ks - 1] + 1j * A[:, 2 * ks]
    if W % 2 == 0:
        F[:, W // 2] = A[:, W - 1]
    kk = np.arange(W // 2 + 1, W)
    F[:, kk] = np.conj(F[:, W - kk])
    return F


def dft(src, dst=None, flags=0, nonzeroRows=0):
    """cv2.dft semantics: real input → CCS-packed output (default) or
    2-channel complex (DFT_COMPLEX_OUTPUT); 2-channel input → complex
    transform; DFT_ROWS = independent 1-D row transforms; DFT_SCALE
    divides by the transform length; DFT_INVERSE delegates to idft."""
    flags = int(flags)
    if flags & _C.DFT_INVERSE:
        return idft(src, flags=flags & ~_C.DFT_INVERSE)
    a = _a(src)
    rows = bool(flags & _C.DFT_ROWS)
    complex_in = a.ndim == 3 and a.shape[2] == 2
    complex_out = bool(flags & _C.DFT_COMPLEX_OUTPUT) or complex_in
    x = (a[..., 0] + 1j * a[..., 1]) if complex_in else a.astype(np.float64)
    F = np.fft.fft(x, axis=1) if rows else np.fft.fft2(x)
    if flags & _C.DFT_SCALE:
        F = F / (x.shape[1] if rows else x.size)
    if complex_out:
        out = np.stack([F.real, F.imag], axis=-1)
    elif rows:
        out = _ccs_pack_rows(F)
    else:
        out = _ccs_pack(F)
    return out.astype(np.float32 if a.dtype == np.float32 else np.float64)


def idft(src, dst=None, flags=0, nonzeroRows=0):
    """cv2.idft: unnormalized inverse (divide only under DFT_SCALE);
    2-channel complex or CCS-packed real input; DFT_REAL_OUTPUT (or a
    packed/real input) yields a real array, else 2-channel complex."""
    flags = int(flags)
    a = _a(src)
    rows = bool(flags & _C.DFT_ROWS)
    complex_in = a.ndim == 3 and a.shape[2] == 2
    if complex_in:
        F = a[..., 0].astype(np.float64) + 1j * a[..., 1]
    else:
        F = (_ccs_unpack_rows if rows else _ccs_unpack)(
            a.astype(np.float64))
    inv = np.fft.ifft(F, axis=1) if rows else np.fft.ifft2(F)
    n = F.shape[1] if rows else F.size
    if not (flags & _C.DFT_SCALE):
        inv = inv * n
    real_out = (not complex_in) or bool(flags & _C.DFT_REAL_OUTPUT)
    out = inv.real if real_out else np.stack([inv.real, inv.imag], -1)
    return out.astype(np.float32 if a.dtype == np.float32 else np.float64)


def dct(src, dst=None, flags=0):
    if int(flags) & _C.DCT_INVERSE:
        return idct(src)
    return _a(_ip.dct(_t(src)))


def idct(src, dst=None, flags=0):
    return _a(_ip.idct(_a(src)))


def _spectrum_binop(a, b, flags, op):
    """Shared cv2 spectrum-format handling for mul/divSpectrums: inputs
    are either 2-channel complex or CCS-packed real (cv2.dft's default),
    honouring DFT_ROWS; output format and dtype match the inputs."""
    a, b = _a(a), _a(b)
    rows = bool(int(flags) & _C.DFT_ROWS)
    if a.ndim == 3 and a.shape[2] == 2:  # 2-channel complex
        fa = a[..., 0].astype(np.float64) + 1j * a[..., 1]
        fb = b[..., 0].astype(np.float64) + 1j * b[..., 1]
        f = op(fa, fb)
        out = np.stack([f.real, f.imag], axis=-1)
    else:  # CCS-packed real: unpack, operate, repack
        unpack = _ccs_unpack_rows if rows else _ccs_unpack
        pack = _ccs_pack_rows if rows else _ccs_pack
        f = op(unpack(a.astype(np.float64)), unpack(b.astype(np.float64)))
        out = pack(f)
    return out.astype(np.float32 if a.dtype == np.float32 else np.float64)


def mulSpectrums(a, b, flags, conjB=False):
    conj = bool(conjB)
    return _spectrum_binop(
        a, b, flags, lambda x, y: x * (np.conj(y) if conj else y))


def divSpectrums(a, b, flags, conjB=False):
    conj = bool(conjB)

    def div(x, y):
        yy = np.conj(y) if conj else y
        mag = yy.real * yy.real + yy.imag * yy.imag
        return np.where(mag != 0, x * np.conj(yy) /
                        np.where(mag != 0, mag, 1.0), 0.0)

    return _spectrum_binop(a, b, flags, div)


def getOptimalDFTSize(vecsize):
    return int(_ip.get_optimal_dft_size(int(vecsize)))


def phaseCorrelate(src1, src2, window=None, response=None):
    from ..ops import registration as _reg
    shift, resp = _reg.phase_correlate_numpy(
        _a(src1, np.float32), _a(src2, np.float32),
        window is not None)
    dx, dy = _a(shift).ravel()[:2]
    return (float(dx), float(dy)), float(resp)


# ------------------------------------------------------------- contours

def findContours(image, mode, method, contours=None, hierarchy=None,
                 offset=(0, 0)):
    """All four retrieval modes over ops/ccl.find_contours_tree (8-conn
    foreground / 4-conn holes, cv2-matching point order — cross-checked
    against cv2 5.0 in tests/test_contour_tree.py)."""
    from ..ops import ccl as _ccl

    arr = image.to_numpy() if isinstance(image, _CoreMat) else _a(image)
    cts, hier_tree, kinds = _ccl.find_contours_tree(arr)
    mode = int(mode)
    if mode == _C.RETR_EXTERNAL:
        keep = [i for i, k in enumerate(kinds)
                if k == "outer" and hier_tree[i, 3] == -1]
        cts = [cts[i] for i in keep]
        parent = np.full(len(cts), -1, np.int32)
        hier = _ccl.hierarchy_from_parents(parent)
    elif mode == _C.RETR_LIST:
        parent = np.full(len(cts), -1, np.int32)
        hier = _ccl.hierarchy_from_parents(parent)
    elif mode == _C.RETR_CCOMP:
        # Two-level semantics: every OUTER boundary is top level (even if
        # nested inside another component's hole); each hole is a child of
        # its component's outer boundary.
        parent = np.full(len(cts), -1, np.int32)
        for i, k in enumerate(kinds):
            if k == "hole":
                parent[i] = hier_tree[i, 3]
        hier = _ccl.hierarchy_from_parents(parent)
    elif mode == _C.RETR_TREE:
        hier = hier_tree
    else:
        raise NotImplementedError(f"findContours mode {mode}")
    out = []
    for c in cts:
        c = _a(c, np.int32)
        if int(method) != _C.CHAIN_APPROX_NONE:
            c = _compress_chain(c)
        if offset != (0, 0):
            c = c + _a(offset, np.int32)
        out.append(c.reshape(-1, 1, 2))
    if not out:
        return (), None
    return tuple(out), hier.reshape(1, -1, 4)


def _compress_chain(c):
    """CHAIN_APPROX_SIMPLE: drop interior points of straight runs."""
    if len(c) <= 2:
        return c
    d = np.diff(np.vstack([c, c[:1]]), axis=0)
    keep = np.ones(len(c), bool)
    prev = np.roll(d, 1, axis=0)
    keep = ~np.all(d == prev, axis=1)
    keep[0] = True
    return c[keep]


def drawContours(image, contours, contourIdx, color, thickness=1,
                 lineType=8, hierarchy=None, maxLevel=2**31 - 1,
                 offset=(0, 0)):
    cts = [_a(c).reshape(-1, 2) for c in contours]
    return _inplace(image, lambda m: _ip.draw_contours(
        m, cts, int(contourIdx), _color(color), int(thickness)))


def contourArea(contour, oriented=False):
    return float(_ip.contour_area(_a(contour).reshape(-1, 2),
                                  bool(oriented)))


def arcLength(curve, closed):
    return float(_ip.arc_length(_a(curve).reshape(-1, 2),
                                bool(closed)))


def approxPolyDP(curve, epsilon, closed):
    out = _ip.approx_poly_dp(_a(curve).reshape(-1, 2),
                             float(epsilon), bool(closed))
    return _a(out).reshape(-1, 1, 2)


def approxPolyN(curve, nsides, approxCurve=None, epsilon_percentage=-1.0,
                ensure_convex=True):
    out = _ip.approx_poly_n(_a(curve).reshape(-1, 2), int(nsides),
                            bool(ensure_convex))
    out = _a(out).reshape(1, -1, 2)   # cv2's (1, N, 2)
    if approxCurve is not None:
        _copyto(approxCurve, out.reshape(_a(approxCurve).shape))
        return approxCurve
    return out


def convexHull(points, hull=None, clockwise=False, returnPoints=True):
    from ..ops import shape as _shape
    pts = _a(points).reshape(-1, 2)
    idx = _shape.convex_hull_cv_indices(pts, bool(clockwise))
    if returnPoints:
        # cv2's exact output order incl. the index-rotation cosmetic pass
        return pts[idx].reshape(-1, 1, 2)
    return _a(idx, np.int32).reshape(-1, 1)


def convexityDefects(contour, convexhull, convexityDefects=None):
    out = _ip.convexity_defects(_a(contour).reshape(-1, 2),
                                _a(convexhull).ravel())
    # cv2 5 returns an (N, 4) int32 array (start, end, farthest, depth*256)
    return _a(out, np.int32).reshape(-1, 4)


def isContourConvex(contour):
    return bool(_ip.is_contour_convex(_a(contour).reshape(-1, 2)))


def boundingRect(array):
    a = _a(array)
    if a.dtype == np.uint8 and a.ndim == 2:
        a = np.argwhere(a)[:, ::-1]
    return tuple(int(v) for v in _ip.bounding_rect(a.reshape(-1, 2)))


def minAreaRect(points):
    # ours: (w, h, angle in [0, 90)); cv2 5.0: (h, w, angle - 90)
    (cx, cy), (w, h), ang = _ip.min_area_rect(
        _a(points).reshape(-1, 2).astype(np.float32))
    return ((float(cx), float(cy)), (float(h), float(w)),
            float(ang) - 90.0)


def boxPoints(box, points=None):
    (cx, cy), (w, h), ang = box
    # cv2's formula: b = cos(angle)*0.5, a = sin(angle)*0.5 over (w, h)
    th = np.deg2rad(ang)
    b, a = np.cos(th) * 0.5, np.sin(th) * 0.5
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (2 * cx - p0[0], 2 * cy - p0[1])
    p3 = (2 * cx - p1[0], 2 * cy - p1[1])
    return _a([p0, p1, p2, p3], np.float32)


def minEnclosingCircle(points):
    (cx, cy), r = _ip.min_enclosing_circle(
        _a(points).reshape(-1, 2).astype(np.float32))
    return (float(cx), float(cy)), float(r)


def minEnclosingTriangle(points, triangle=None):
    area, tri = _ip.min_enclosing_triangle(
        _a(points).reshape(-1, 2).astype(np.float64))
    return float(area), _a(tri, np.float32).reshape(3, 1, 2)


def fitEllipse(points):
    return _ip.fit_ellipse(_a(points).reshape(-1, 2))


def fitEllipseAMS(points):
    return _ip.fit_ellipse_ams(_a(points).reshape(-1, 2))


def fitEllipseDirect(points):
    return _ip.fit_ellipse_direct(_a(points).reshape(-1, 2))


def fitLine(points, distType, param, reps, aeps, line=None):
    names = {_C.DIST_L2: "l2", _C.DIST_L1: "l1", _C.DIST_L12: "l12",
             _C.DIST_FAIR: "fair", _C.DIST_WELSCH: "welsch",
             _C.DIST_HUBER: "huber"}
    out = _ip.fit_line(_a(points).reshape(-1, 2),
                       dist_type=names[int(distType)])
    return _a(out, np.float32).reshape(-1, 1)


def moments(array, binaryImage=False):
    a = _a(array)
    if a.ndim == 3:
        a = a[:, :, 0]
    if a.dtype != np.uint8 or binaryImage:
        a = (a != 0).astype(np.float64) if binaryImage \
            else a.astype(np.float64)
    a = a.astype(np.float64)
    h, w = a.shape
    x = np.arange(w, dtype=np.float64)
    y = np.arange(h, dtype=np.float64)
    d = {}
    for p in range(4):
        for q in range(4 - p):
            d[f"m{p}{q}"] = float(((x[None, :] ** p) * (y[:, None] ** q)
                                   * a).sum())
    m00 = d["m00"]
    cx = d["m10"] / m00 if m00 else 0.0
    cy = d["m01"] / m00 if m00 else 0.0
    for p in range(4):
        for q in range(4 - p):
            if p + q < 2:
                continue
            mu = (((x[None, :] - cx) ** p) * ((y[:, None] - cy) ** q)
                  * a).sum()
            d[f"mu{p}{q}"] = float(mu)
    for key in ("mu20", "mu11", "mu02", "mu30", "mu21", "mu12", "mu03"):
        p, q = int(key[2]), int(key[3])
        denom = m00 ** (1 + (p + q) / 2.0) if m00 else 1.0
        d["nu" + key[2:]] = d[key] / denom if m00 else 0.0
    return d


def HuMoments(m, hu=None):
    if isinstance(m, dict):
        nu = [m["nu20"], m["nu11"], m["nu02"], m["nu30"], m["nu21"],
              m["nu12"], m["nu03"]]
    else:
        nu = list(_a(m).ravel())
    n20, n11, n02, n30, n21, n12, n03 = nu
    h = np.zeros(7)
    h[0] = n20 + n02
    h[1] = (n20 - n02) ** 2 + 4 * n11 ** 2
    h[2] = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h[3] = (n30 + n12) ** 2 + (n21 + n03) ** 2
    h[4] = (n30 - 3 * n12) * (n30 + n12) * ((n30 + n12) ** 2
           - 3 * (n21 + n03) ** 2) + (3 * n21 - n03) * (n21 + n03) \
           * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    h[5] = (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) \
           + 4 * n11 * (n30 + n12) * (n21 + n03)
    h[6] = (3 * n21 - n03) * (n30 + n12) * ((n30 + n12) ** 2
           - 3 * (n21 + n03) ** 2) - (n30 - 3 * n12) * (n21 + n03) \
           * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    return h.reshape(7, 1)


def matchShapes(contour1, contour2, method, parameter=0):
    a, b = _a(contour1), _a(contour2)
    if a.ndim == 2 and a.dtype == np.uint8:
        return float(_ip.match_shapes(_m(a), _m(b)))
    # contour input: Hu-moment distance from polygon moments
    def hu_of(c):
        img = np.zeros((int(c.reshape(-1, 2)[:, 1].max()) + 3,
                        int(c.reshape(-1, 2)[:, 0].max()) + 3), np.uint8)
        fillPoly(img, [c.reshape(-1, 1, 2).astype(np.int32)], 255)
        return HuMoments(moments(img)).ravel()
    h1, h2 = hu_of(a), hu_of(b)
    eps = 1e-5
    s1 = np.sign(h1) * np.log10(np.abs(h1) + 1e-300)
    s2 = np.sign(h2) * np.log10(np.abs(h2) + 1e-300)
    sel = (np.abs(h1) > eps) & (np.abs(h2) > eps)
    m = int(method)
    if m == 1:
        return float(np.abs(1 / s1[sel] - 1 / s2[sel]).sum())
    if m == 2:
        return float(np.abs(s1[sel] - s2[sel]).sum())
    return float(np.abs((s1[sel] - s2[sel]) / s1[sel]).max()) if sel.any() \
        else 0.0


def pointPolygonTest(contour, pt, measureDist):
    return float(_ip.point_polygon_test(
        _a(contour).reshape(-1, 2),
        (float(pt[0]), float(pt[1])), bool(measureDist)))


def intersectConvexConvex(p1, p2, p12=None, handleNested=True):
    area, poly = _ip.intersect_convex_convex(
        _a(p1).reshape(-1, 2), _a(p2).reshape(-1, 2))
    return float(area), _a(poly, np.float32).reshape(-1, 1, 2)


def rotatedRectangleIntersection(rect1, rect2, intersectingRegion=None):
    code, pts = _ip.rotated_rectangle_intersection(rect1, rect2)
    return int(code), _a(pts, np.float32).reshape(-1, 1, 2)


# ---------------------------------------------------------- segmentation

def _merge_8conn(lab):
    """Upgrade our 4-connected labels to cv2's default 8-connectivity:
    union-find over diagonal label adjacencies, then relabel compactly
    in raster order of first appearance (cv2's label order)."""
    lab = _a(lab, np.int64)
    nmax = int(lab.max()) + 1
    parent = np.arange(nmax, dtype=np.int64)

    def find_many(x):
        while True:
            p = parent[x]
            pp = parent[p]
            if np.array_equal(p, pp):
                return p
            parent[x] = pp

    pairs = []
    a, b = lab[:-1, :-1], lab[1:, 1:]
    sel = (a > 0) & (b > 0) & (a != b)
    pairs.append(np.stack([a[sel], b[sel]], axis=1))
    a, b = lab[:-1, 1:], lab[1:, :-1]
    sel = (a > 0) & (b > 0) & (a != b)
    pairs.append(np.stack([a[sel], b[sel]], axis=1))
    for x, y in np.unique(np.concatenate(pairs), axis=0):
        rx, ry = int(find_many(_a([x]))[0]), \
            int(find_many(_a([y]))[0])
        if rx != ry:
            parent[builtins_max(rx, ry)] = builtins_min(rx, ry)
    roots = find_many(np.arange(nmax))
    merged = roots[lab]
    # compact relabel, raster order of first appearance (bg stays 0)
    flat = merged.ravel()
    first = np.full(nmax, np.iinfo(np.int64).max)
    np.minimum.at(first, flat, np.arange(flat.size))
    present = np.unique(flat)
    present = present[present > 0]
    order = present[np.argsort(first[present], kind="stable")]
    remap_t = np.zeros(nmax, np.int64)
    remap_t[order] = np.arange(1, len(order) + 1)
    return remap_t[merged].astype(np.int32)


def _cc_stats(lab):
    n = int(lab.max()) + 1
    flat = lab.ravel()
    h, w = lab.shape
    ys, xs = np.divmod(np.arange(flat.size), w)
    stats = np.zeros((n, 5), np.int32)
    area = np.bincount(flat, minlength=n)
    xmin = np.full(n, w)
    np.minimum.at(xmin, flat, xs)
    xmax = np.zeros(n, np.int64)
    np.maximum.at(xmax, flat, xs)
    ymin = np.full(n, h)
    np.minimum.at(ymin, flat, ys)
    ymax = np.zeros(n, np.int64)
    np.maximum.at(ymax, flat, ys)
    stats[:, _C.CC_STAT_LEFT] = xmin
    stats[:, _C.CC_STAT_TOP] = ymin
    stats[:, _C.CC_STAT_WIDTH] = xmax - xmin + 1
    stats[:, _C.CC_STAT_HEIGHT] = ymax - ymin + 1
    stats[:, _C.CC_STAT_AREA] = area
    sx = np.bincount(flat, weights=xs, minlength=n)
    sy = np.bincount(flat, weights=ys, minlength=n)
    with np.errstate(invalid="ignore", divide="ignore"):
        cents = np.stack([sx / area, sy / area], axis=1)
    return stats, cents


def connectedComponents(image, labels=None, connectivity=8, ltype=4):
    n, lab, stats, cents = _ip.connected_components_with_stats(_m(image))
    lab = _a(lab, np.int32)
    if int(connectivity) == 8:
        lab = _merge_8conn(lab)
    return int(lab.max()) + 1, lab


def connectedComponentsWithStats(image, labels=None, stats=None,
                                 centroids=None, connectivity=8, ltype=4):
    n, lab, stats_, cents = _ip.connected_components_with_stats(_m(image))
    lab = _a(lab, np.int32)
    if int(connectivity) == 8:
        lab = _merge_8conn(lab)
        stats_, cents = _cc_stats(lab)
    return int(lab.max()) + 1, lab, _a(stats_, np.int32), \
        _a(cents, np.float64)


_CHAMFER_METRICS = {
    # (distanceType, maskSize) -> cv2's step costs (a, b[, c])
    (_C.DIST_C, 3): (1.0, 1.0),
    (_C.DIST_L1, 3): (1.0, 2.0),
    (_C.DIST_L2, 3): (0.955, 1.3693),
    (_C.DIST_L2, 5): (1.0, 1.4, 2.1969),
}


def distanceTransform(src, distanceType, maskSize, dst=None, dstType=5):
    from ..ops import ccl as _ccl
    a = _a(src)
    dt, ms = int(distanceType), int(maskSize)
    if dt in (_C.DIST_C, _C.DIST_L1):
        ms = 3  # cv2 forces maskSize 3 for C/L1
    if ms == _C.DIST_MASK_PRECISE and dt == _C.DIST_L2:
        out = _ccl.distance_transform_l2_with_labels(a)[0]
    else:
        metrics = _CHAMFER_METRICS.get((dt, ms))
        if metrics is None:
            raise ValueError(f"distanceTransform type {dt} mask {ms}")
        out = _ccl.distance_transform_chamfer(a, metrics, ms)
    if int(dstType) == _C.CV_8U:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return _a(out, np.float32)


def distanceTransformWithLabels(src, distanceType, maskSize, **kw):
    # ops takes the raw (H, W) array, not a Mat (host code)
    d, lab = _ip.distance_transform_l2_with_labels(
        _a(_o(_hwc(src))))
    return _a(d, np.float32), _a(lab, np.int32)


def watershed(image, markers):
    out = _ip.watershed(_m(image), _a(markers, np.int32))
    _copyto(markers, out)
    return markers


def grabCut(img, mask, rect, bgdModel, fgdModel, iterCount, mode=0):
    if mode == _C.GC_INIT_WITH_RECT:
        out_mask = _ip.grab_cut(_m(img), rect=rect, iter_count=iterCount)
    else:
        out_mask = _ip.grab_cut(_m(img), mask=_a(mask),
                                iter_count=iterCount)
    if isinstance(out_mask, tuple):
        out_mask = out_mask[0]
    _copyto(mask, _a(out_mask, np.uint8))
    return mask, bgdModel, fgdModel


def floodFill(image, mask, seedPoint, newVal, loDiff=0, upDiff=0, flags=4):
    from ..ops import ccl as _ccl

    # host code: a tensor's pixels are filled on the host and copied back
    host = _a(image).copy() if isinstance(image, _torch.Tensor) else image
    count, _, mask, rect = _ccl.flood_fill_cv(
        host, mask, (int(seedPoint[0]), int(seedPoint[1])), newVal,
        loDiff, upDiff, int(flags))
    if host is not image:
        _copyto(image, host)
    return count, image, mask, rect


def pyrMeanShiftFiltering(src, sp, sr, dst=None, maxLevel=1, termcrit=None):
    # ops treats sp as an integer window radius (cv2 accepts float)
    return _o(_ip.pyr_mean_shift_filtering(_m(src), int(sp), float(sr),
                                           max_level=int(maxLevel)))


# ------------------------------------------------------------- features

def cornerHarris(src, blockSize, ksize, k, dst=None, borderType=4):
    """The float32 Harris response (``ops.features.harris_response``): on
    the card it is the Harris kernel's float32 form (K6)."""
    from ..ops import features as _feat
    if isinstance(src, _torch.Tensor) and src.dtype == _torch.uint8:
        g = src
    else:
        g = _t(_a(src).astype(np.uint8))
    resp = _feat.harris_response(g, float(k))
    return _a(resp, np.float32)


def cornerMinEigenVal(src, blockSize, dst=None, ksize=3, borderType=4):
    return _a(_ip.corner_min_eigen_val(_t(src),
                                               int(blockSize), int(ksize)),
                      np.float32)


def cornerEigenValsAndVecs(src, blockSize, ksize, dst=None, borderType=4):
    return _a(_ip.corner_eigen_vals_and_vecs(_t(src),
                                                     int(blockSize),
                                                     int(ksize)), np.float32)


def preCornerDetect(src, ksize, dst=None, borderType=4):
    return _a(_ip.pre_corner_detect(_t(src), int(ksize)),
                      np.float32)


def goodFeaturesToTrack(image, maxCorners, qualityLevel, minDistance,
                        corners=None, mask=None, blockSize=3,
                        useHarrisDetector=False, k=0.04):
    pts = _ip.good_features_to_track(
        _m(image), int(maxCorners), k=float(k),
        threshold_rel=float(qualityLevel),
        nms_radius=builtins_max(1, int(minDistance)))
    return _a(pts, np.float32).reshape(-1, 1, 2)


def cornerSubPix(image, corners, winSize, zeroZone, criteria):
    pts = _a(corners, np.float32).reshape(-1, 2)
    out = _ip.corner_sub_pix(_m(image), pts, win=int(winSize[0]) * 2 + 1)
    return _a(out, np.float32).reshape(-1, 1, 2)


# ------------------------------------------------------------- hough

def HoughLines(image, rho, theta, threshold, lines=None, srn=0, stn=0,
               min_theta=0, max_theta=np.pi):
    n_thetas = int(round(np.pi / theta))
    out = _ip.hough_lines(_m(image), int(threshold), n_thetas=n_thetas)
    return _a(out, np.float32).reshape(-1, 1, 2)


def HoughLinesP(image, rho, theta, threshold, lines=None, minLineLength=0,
                maxLineGap=0):
    out = _ip.hough_lines_p(_m(image), int(threshold),
                            min_line_length=float(minLineLength),
                            max_line_gap=float(maxLineGap))
    return _a(out, np.int32).reshape(-1, 1, 4)


def HoughCircles(image, method, dp, minDist, circles=None, param1=100,
                 param2=100, minRadius=0, maxRadius=0):
    out = _ip.hough_circles(_m(image), dp=int(dp), min_dist=float(minDist),
                            min_radius=int(minRadius),
                            max_radius=int(maxRadius),
                            edge_threshold=int(param1),
                            vote_threshold=int(param2))
    return _a(out, np.float32).reshape(1, -1, 3)


# ------------------------------------------------------------- template

_TM_NAMES = {0: "sqdiff", 1: "sqdiff_normed", 2: "ccorr",
             3: "ccorr_normed", 4: "ccoeff", 5: "ccoeff_normed"}


def matchTemplate(image, templ, method, result=None, mask=None):
    return _a(_ip.match_template(_m(image), _m(templ),
                                         _TM_NAMES[int(method)]),
                      np.float32)


# ------------------------------------------------------------- drawing

def line(img, pt1, pt2, color, thickness=1, lineType=8, shift=0):
    return _inplace(img, lambda m: _ip.line(m, _pt(pt1), _pt(pt2),
                                            _color(color), int(thickness)))


def arrowedLine(img, pt1, pt2, color, thickness=1, line_type=8, shift=0,
                tipLength=0.1):
    """cv2's construction: the main line plus two tip lines at the
    destination, angle ±π/4 off the reverse direction, length
    tipLength·|p2−p1|, endpoints cvRound-ed (verified vs cv2 5.0)."""
    import math

    x1, y1 = float(pt1[0]), float(pt1[1])
    x2, y2 = float(pt2[0]), float(pt2[1])
    ang = math.atan2(y1 - y2, x1 - x2)
    tip = math.hypot(x2 - x1, y2 - y1) * float(tipLength)
    line(img, pt1, pt2, color, thickness, line_type, shift)
    for da in (math.pi / 4, -math.pi / 4):
        p = (int(np.rint(x2 + tip * math.cos(ang + da))),
             int(np.rint(y2 + tip * math.sin(ang + da))))
        line(img, p, pt2, color, thickness, line_type, shift)
    return img


def rectangle(img, pt1, pt2=None, color=None, thickness=1, lineType=8,
              shift=0):
    if pt2 is None or (color is None and not np.isscalar(color)):
        # rectangle(img, rect, color, ...) overload
        raise TypeError("use rectangle(img, pt1, pt2, color)")
    x1, y1 = int(pt1[0]), int(pt1[1])
    x2, y2 = int(pt2[0]), int(pt2[1])
    x1, x2 = builtins_min(x1, x2), builtins_max(x1, x2)
    y1, y2 = builtins_min(y1, y2), builtins_max(y1, y2)
    if int(thickness) < 0:  # FILLED (pt2 inclusive, like cv2)
        # written where the image is: a tensor on its device, an array
        # on the host
        h, w = img.shape[:2]
        c = np.asarray(_color(color).bgr
                       if img.ndim == 3 else [_color(color).bgr[0]],
                       _a(img[:1, :1]).dtype)
        if isinstance(img, _torch.Tensor):
            c = _torch.from_numpy(c).to(img.device)
        img[builtins_max(y1, 0):builtins_min(y2 + 1, h),
            builtins_max(x1, 0):builtins_min(x2 + 1, w)] = \
            c if img.ndim == 3 else c[0]
        return img
    r = _Rect(x1, y1, x2 - x1 + 1, y2 - y1 + 1)
    return _inplace(img, lambda m: _ip.rectangle(m, r, _color(color),
                                                 int(thickness)))


def circle(img, center, radius, color, thickness=1, lineType=8, shift=0):
    return _inplace(img, lambda m: _ip.circle(m, _pt(center), int(radius),
                                              _color(color),
                                              int(thickness)))


def ellipse(img, center, axes, angle, startAngle=0, endAngle=360,
            color=None, thickness=1, lineType=8, shift=0):
    if (int(startAngle), int(endAngle)) in ((0, 360), (0, -360)) or \
            abs(int(endAngle) - int(startAngle)) >= 360:
        return _inplace(img, lambda m: _ip.ellipse(
            m, _pt(center), (int(axes[0]), int(axes[1])), float(angle),
            _color(color), int(thickness)))
    # Partial arc: OpenCV's ellipseEx polygonizes the arc and draws it as
    # an open polyline (thickness >= 0) or a filled pie with the center
    # appended (thickness < 0). We use ellipse2Poly at delta = 3 degrees —
    # same approximation class as cv2's internal sampling; cross-checked
    # within a 1-px band in tests/test_cv2_shim.py::test_ellipse_arc.
    sa, ea = int(round(startAngle)), int(round(endAngle))
    if ea < sa:
        sa, ea = ea, sa
    pts = ellipse2Poly(center, axes, int(round(angle)), sa, ea, 3)
    if int(thickness) >= 0:
        return polylines(img, [pts], False, color, thickness, lineType)
    pie = np.vstack([pts, _a([[int(center[0]), int(center[1])]],
                                     np.int32)])
    return fillPoly(img, [pie], color)


def ellipse2Poly(center, axes, angle, arcStart, arcEnd, delta):
    out = _ip.ellipse2poly((int(center[0]), int(center[1])),
                           (int(axes[0]), int(axes[1])), int(angle),
                           int(arcStart), int(arcEnd), int(delta))
    return _a(out, np.int32)


def polylines(img, pts, isClosed, color, thickness=1, lineType=8, shift=0):
    arrs = [_a(p).reshape(-1, 2) for p in pts]
    return _inplace(img, lambda m: _ip.polylines(
        m, arrs, _color(color), int(thickness), bool(isClosed)))


def fillPoly(img, pts, color, lineType=8, shift=0, offset=(0, 0)):
    arrs = [_a(p).reshape(-1, 2) for p in pts]
    return _inplace(img, lambda m: _ip.fill_poly(m, arrs, _color(color)))


def fillConvexPoly(img, points, color, lineType=8, shift=0):
    return fillPoly(img, [points], color)


def putText(img, text, org, fontFace, fontScale, color, thickness=1,
            lineType=8, bottomLeftOrigin=False):
    return _inplace(img, lambda m: _ip.put_text(
        m, str(text), _pt(org), float(fontScale), _color(color)))


def getTextSize(text, fontFace, fontScale, thickness):
    (w, h), base = _ip.get_text_size(str(text), float(fontScale))
    return (int(w), int(h)), int(base)


def drawMarker(img, position, color, markerType=0, markerSize=20,
               thickness=1, line_type=8):
    names = {0: "cross", 1: "tilted_cross", 2: "star", 3: "diamond",
             4: "square", 5: "triangle_up", 6: "triangle_down"}
    out = _ip.draw_marker(_a(img),
                          (int(position[0]), int(position[1])),
                          tuple(np.atleast_1d(color).tolist()),
                          names[int(markerType)], int(markerSize),
                          int(thickness))
    _copyto(img, out)
    return img


def clipLine(imgRect, pt1, pt2):
    return _ip.clip_line(tuple(int(v) for v in imgRect),
                         (int(pt1[0]), int(pt1[1])),
                         (int(pt2[0]), int(pt2[1])))


def applyColorMap(src, colormap, dst=None):
    """All cv2 colormaps except PARULA/DEEPGREEN (cv2-only data tables
    with no public formula/matplotlib source). Exactness vs cv2 is per
    golden.colormap_table's docstring (bit-exact to ±2 LSB by family,
    tests/test_cv2_shim.py::test_colormap_tables)."""
    names = {
        _C.COLORMAP_AUTUMN: "autumn", _C.COLORMAP_BONE: "bone",
        _C.COLORMAP_JET: "jet", _C.COLORMAP_WINTER: "winter",
        _C.COLORMAP_RAINBOW: "rainbow", _C.COLORMAP_OCEAN: "ocean",
        _C.COLORMAP_SUMMER: "summer", _C.COLORMAP_SPRING: "spring",
        _C.COLORMAP_COOL: "cool", _C.COLORMAP_HSV: "hsv",
        _C.COLORMAP_PINK: "pink", _C.COLORMAP_HOT: "hot",
        _C.COLORMAP_MAGMA: "magma", _C.COLORMAP_INFERNO: "inferno",
        _C.COLORMAP_PLASMA: "plasma", _C.COLORMAP_VIRIDIS: "viridis",
        _C.COLORMAP_CIVIDIS: "cividis", _C.COLORMAP_TWILIGHT: "twilight",
        _C.COLORMAP_TWILIGHT_SHIFTED: "twilight_shifted",
        _C.COLORMAP_TURBO: "turbo",
    }
    if int(colormap) not in names:
        raise NotImplementedError(f"colormap {colormap}")
    return _o(_ip.apply_color_map(_m(src), names[int(colormap)]))


# ---------------------------------------------------------- class APIs

from ._classes import (  # noqa: E402,F401
    KeyPoint, DMatch, SIFT, ORB, AKAZE, FastFeatureDetector,
    SIFT_create, ORB_create, AKAZE_create, FastFeatureDetector_create,
    BFMatcher, drawKeypoints, drawMatches,
    calcOpticalFlowFarneback, calcOpticalFlowPyrLK,
    BackgroundSubtractorMOG2, BackgroundSubtractorKNN,
    createBackgroundSubtractorMOG2, createBackgroundSubtractorKNN,
    meanShift, CamShift, KalmanFilter,
    TrackerKCF, TrackerCSRT, TrackerMIL, TrackerMOSSE,
    TrackerKCF_create, TrackerCSRT_create, TrackerMIL_create,
    TrackerMOSSE_create,
    Rodrigues, solvePnP, solvePnPRansac, projectPoints, findHomography,
    findFundamentalMat, findEssentialMat, recoverPose, calibrateCamera,
    undistort, undistortPoints, initUndistortRectifyMap,
    getOptimalNewCameraMatrix, stereoRectify, triangulatePoints,
    estimateAffine2D, estimateAffinePartial2D, perspectiveTransform,
    transform, findChessboardCorners, findChessboardCornersSB,
    drawChessboardCorners, drawFrameAxes, decomposeHomographyMat,
    decomposeEssentialMat, computeCorrespondEpilines,
    StereoSGBM, StereoBM, StereoSGBM_create, StereoBM_create,
    fastNlMeansDenoising, fastNlMeansDenoisingColored, inpaint,
    seamlessClone, colorChange, illuminationChange, textureFlattening,
    detailEnhance, stylization, pencilSketch, edgePreservingFilter,
    decolor, createMergeMertens, createMergeDebevec, createMergeRobertson,
    createCalibrateDebevec, createCalibrateRobertson, createTonemap,
    createTonemapDrago, createTonemapMantiuk, createTonemapReinhard,
    createAlignMTB, denoise_TVL1,
    QRCodeDetector, HOGDescriptor, CascadeClassifier,
    imread, imwrite, imencode, imdecode, imshow, waitKey, waitKeyEx,
    pollKey, destroyWindow, destroyAllWindows, namedWindow, moveWindow,
    resizeWindow, setWindowTitle, getWindowProperty, VideoCapture,
)
from ._util import *  # noqa: E402,F401,F403
from ._calib3d import *  # noqa: E402,F401,F403
from ._algos import *  # noqa: E402,F401,F403
from ._filestorage import FileNode, FileStorage  # noqa: E402,F401
from ._extras import *  # noqa: E402,F401,F403
from ._misc3 import *  # noqa: E402,F401,F403
from . import barcode, ccm, data, fisheye, flann  # noqa: E402,F401
from . import mcc, segmentation, videoio_registry  # noqa: E402,F401
from . import detail  # noqa: E402
from . import dnn, parallel, samples, utils  # noqa: E402,F401
from . import typing  # noqa: E402,F401

# flat detail_* aliases (cv2 exposes both spellings)
for _n in dir(detail):
    if _n[0].isupper():
        globals()[f"detail_{_n}"] = getattr(detail, _n)
del _n
from . import aruco  # noqa: E402,F401


class Mat(np.ndarray):
    """cv2.Mat: a numpy.ndarray subclass (exactly cv2's Python Mat).
    The zero-copy device-aware Mat lives at rustcv_tpu_torch.core.mat.Mat;
    this class is the cv2 calling-convention wrapper type."""

    def __new__(cls, arr=None, wrap_channels=False, **kw):
        if arr is None:
            arr = np.empty((0, 0), np.uint8)
        if isinstance(arr, _CoreMat):
            arr = arr.to_numpy()
        obj = _a(arr).view(cls)
        obj.wrap_channels = bool(wrap_channels)
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.wrap_channels = getattr(obj, "wrap_channels", False)


_bind(globals())
