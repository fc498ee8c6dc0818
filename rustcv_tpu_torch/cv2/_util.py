"""cv2 facade: core utilities, accumulation, small math, simple classes
(the port of ``rustcv_tpu.cv2._util``; host code, held against the
reference in ``tests/test_torch_cv2_calls.py``). Same coverage policy as
the package: unsupported argument combinations raise, never silently
diverge.

The reference's swallow-all wrappers (``imcount``, ``imreadmulti``,
``imwritemulti``, ``haveImageReader``, ``VideoWriter.open``) keep cv2's
False / 0 for a missing or unreadable file and let ``NotImplementedError``
(the port's ``not_ported``) through.
"""
from __future__ import annotations

import os
import time

import numpy as np

from . import _constants as _C
from .. import imgcodecs as _icodec
from ..core.errors import CameraError
from ..core.mat import Mat
from ..core.tick_meter import TickMeter as _CoreTickMeter
from ._device import _a, _copyto, _m
from ._device import bind as _bind

__all__ = [
    "error", "Error",
    "getTickCount", "getTickFrequency", "getCPUTickCount",
    "getNumThreads", "setNumThreads", "getThreadNum", "getNumberOfCPUs",
    "useOptimized", "setUseOptimized",
    "getVersionString", "getVersionMajor", "getVersionMinor",
    "getVersionRevision", "getBuildInformation",
    "checkHardwareSupport", "getHardwareFeatureName", "getCPUFeaturesLine",
    "currentUIFramework",
    "sumElems", "blendLinear", "batchDistance",
    "accumulate", "accumulateSquare", "accumulateProduct",
    "accumulateWeighted",
    "getRectSubPix", "getDerivKernels", "getDefaultNewCameraMatrix",
    "getFontScaleFromHeight",
    "convertPointsToHomogeneous", "convertPointsFromHomogeneous",
    "haveImageReader", "haveImageWriter",
    "imcount", "imreadmulti", "imwritemulti",
    "imreadWithMetadata", "imwriteWithMetadata",
    "TickMeter", "RotatedRect", "UMat", "Algorithm",
    "VideoWriter", "VideoWriter_fourcc",
]


class error(Exception):
    """cv2.error analog: raised for cv2-level argument errors."""


Error = error


# ------------------------------------------------------------------ timing

def getTickCount() -> int:
    return time.perf_counter_ns()


def getTickFrequency() -> float:
    return 1e9


def getCPUTickCount() -> int:
    return time.perf_counter_ns()


# ----------------------------------------------------------------- runtime

_num_threads = [os.cpu_count() or 1]
_use_optimized = [True]


def getNumThreads() -> int:
    return _num_threads[0]


def setNumThreads(nthreads: int) -> None:
    # Recorded only: the host-side worker pools and the device's streams
    # take their own sizes.
    _num_threads[0] = (os.cpu_count() or 1) if nthreads <= 0 else int(nthreads)


def getThreadNum() -> int:
    return 0


def getNumberOfCPUs() -> int:
    return os.cpu_count() or 1


def useOptimized() -> bool:
    return _use_optimized[0]


def setUseOptimized(onoff: bool) -> None:
    _use_optimized[0] = bool(onoff)


def getVersionString() -> str:
    return "5.0.0"


def getVersionMajor() -> int:
    return 5


def getVersionMinor() -> int:
    return 0


def getVersionRevision() -> int:
    return 0


def getBuildInformation() -> str:
    import torch

    cuda = torch.cuda.is_available()
    return (
        "rustcv_tpu_torch cv2 facade (OpenCV-5.0-compatible surface)\n"
        f"  backend: torch {torch.__version__}, CUDA {torch.version.cuda}\n"
        f"  device: {torch.cuda.get_device_name(0) if cuda else 'none (CPU only)'}\n"
        "  compute path: PyTorch with hand-written sm_90a kernels\n"
    )


def checkHardwareSupport(feature: int) -> bool:
    return False  # CPU-feature flags are not reported


def getHardwareFeatureName(feature: int) -> str:
    return ""


def getCPUFeaturesLine() -> str:
    return ""


def currentUIFramework() -> str:
    return "SDL" if os.environ.get("RUSTCV_SDL") else ""


# ----------------------------------------------------------- small numeric

def sumElems(src):
    """Per-channel sum, always a 4-tuple (cv2.sumElems)."""
    a = _a(src)
    if a.ndim == 2:
        a = a[:, :, None]
    s = a.reshape(-1, a.shape[-1]).sum(axis=0, dtype=np.float64)
    out = [0.0, 0.0, 0.0, 0.0]
    for i in range(min(4, s.shape[0])):
        out[i] = float(s[i])
    return tuple(out)


def blendLinear(src1, src2, weights1, weights2, dst=None):
    a = _a(src1, np.float64)
    b = _a(src2, np.float64)
    w1 = _a(weights1, np.float64)
    w2 = _a(weights2, np.float64)
    if a.ndim == 3:
        w1, w2 = w1[..., None], w2[..., None]
    out = (a * w1 + b * w2) / (w1 + w2 + 1e-5)
    src_dt = _a(src1).dtype
    if np.issubdtype(src_dt, np.integer):
        info = np.iinfo(src_dt)
        return np.clip(np.rint(out), info.min, info.max).astype(src_dt)
    return out.astype(src_dt)


def batchDistance(src1, src2, dtype, dist=None, nidx=None,
                  normType=_C.NORM_L2, K=0, mask=None, update=0,
                  crosscheck=False):
    """Pairwise distances with optional K-NN selection (cv2.batchDistance).

    K=0 returns (dist, None) with the full (n1, n2) matrix — which the
    cv2 5.0 Python binding itself cannot express (it asserts
    nidx.needed() == (K>0)); K>0 matches cv2 exactly.
    """
    a = _a(src1, np.float64)
    b = _a(src2, np.float64)
    if normType == _C.NORM_L2:
        d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    elif normType == _C.NORM_L2SQR:
        d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    elif normType == _C.NORM_L1:
        d = np.abs(a[:, None, :] - b[None, :, :]).sum(-1)
    elif normType == _C.NORM_HAMMING:
        au = _a(src1, np.uint8)
        bu = _a(src2, np.uint8)
        x = au[:, None, :] ^ bu[None, :, :]
        d = np.unpackbits(x, axis=-1).sum(-1)
    else:
        raise error(f"batchDistance: unsupported normType {normType}")
    dt = {_C.CV_32F: np.float32, _C.CV_64F: np.float64,
          _C.CV_32S: np.int32}.get(dtype, np.float32)
    if K <= 0:
        return d.astype(dt), None
    k = min(int(K), d.shape[1])
    idx = np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)
    dk = np.take_along_axis(d, idx, axis=1).astype(dt)
    return dk, idx


def accumulate(src, dst, mask=None):
    a = _a(src, dst.dtype)
    if mask is not None:
        m = _a(mask) != 0
        if a.ndim == 3 and m.ndim == 2:
            m = m[..., None]
        dst += np.where(m, a, 0)
    else:
        dst += a
    return dst


def accumulateSquare(src, dst, mask=None):
    a = _a(src, dst.dtype)
    return accumulate(a * a, dst, mask)


def accumulateProduct(src1, src2, dst, mask=None):
    a = _a(src1, dst.dtype) * _a(src2, dst.dtype)
    return accumulate(a, dst, mask)


def accumulateWeighted(src, dst, alpha, mask=None):
    a = _a(src, dst.dtype)
    upd = dst * (1.0 - alpha) + a * alpha
    if mask is not None:
        m = _a(mask) != 0
        if a.ndim == 3 and m.ndim == 2:
            m = m[..., None]
        _copyto(dst, np.where(m, upd, dst))
    else:
        _copyto(dst, upd)
    return dst


def getRectSubPix(image, patchSize, center, patch=None, patchType=-1):
    """Bilinear sub-pixel patch extraction, replicate border (cv2-exact)."""
    a = _a(image)
    pw, ph = int(patchSize[0]), int(patchSize[1])
    cx, cy = float(center[0]), float(center[1])
    x0 = cx - (pw - 1) * 0.5
    y0 = cy - (ph - 1) * 0.5
    xs = x0 + np.arange(pw)
    ys = y0 + np.arange(ph)
    xi = np.floor(xs).astype(np.int64)
    yi = np.floor(ys).astype(np.int64)
    fx = xs - xi
    fy = ys - yi
    h, w = a.shape[:2]

    def at(yy, xx):
        return a[np.clip(yy, 0, h - 1)[:, None], np.clip(xx, 0, w - 1)[None, :]]

    v00 = at(yi, xi).astype(np.float64)
    v01 = at(yi, xi + 1).astype(np.float64)
    v10 = at(yi + 1, xi).astype(np.float64)
    v11 = at(yi + 1, xi + 1).astype(np.float64)
    wx = fx[None, :, None] if a.ndim == 3 else fx[None, :]
    wy = fy[:, None, None] if a.ndim == 3 else fy[:, None]
    out = (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy + v11 * wx * wy)
    if np.issubdtype(a.dtype, np.integer) and patchType in (-1, _C.CV_8U):
        info = np.iinfo(a.dtype if patchType == -1 else np.uint8)
        return np.clip(np.rint(out), info.min, info.max).astype(
            a.dtype if patchType == -1 else np.uint8)
    if patchType == _C.CV_32F:
        return out.astype(np.float32)
    return out.astype(a.dtype)


def _deriv_kernel_1d(order: int, ksize: int) -> np.ndarray:
    """cv2 getSobelKernels construction: (ksize-order-1) binomial [1,1]
    smoothing convolutions then `order` difference [-1,1] convolutions."""
    n = 3 if ksize == 1 else ksize  # ksize=1 uses the 3-tap aperture
    k = np.array([1.0])
    for _ in range(n - order - 1):
        k = np.convolve(k, [1.0, 1.0])
    for _ in range(order):
        k = np.convolve(k, [-1.0, 1.0])
    if ksize == 1 and order == 0:
        return np.array([1.0])
    return k


def getDerivKernels(dx, dy, ksize, kx=None, ky=None, normalize=False,
                    ktype=_C.CV_32F):
    if ksize == -1:  # FILTER_SCHARR
        kxv = np.array([3.0, 10.0, 3.0]) if dx == 0 else np.array([-1.0, 0.0, 1.0])
        kyv = np.array([3.0, 10.0, 3.0]) if dy == 0 else np.array([-1.0, 0.0, 1.0])
        if normalize:  # cv2 scales only the smoothing kernel for Scharr
            kxv = kxv / (32.0 if dx == 0 else 1.0)
            kyv = kyv / (32.0 if dy == 0 else 1.0)
    else:
        kxv = _deriv_kernel_1d(dx, ksize)
        kyv = _deriv_kernel_1d(dy, ksize)
        if normalize:
            kxv = kxv / float(1 << (len(kxv) - dx - 1))
            kyv = kyv / float(1 << (len(kyv) - dy - 1))
    dt = np.float64 if ktype == _C.CV_64F else np.float32
    return kxv.astype(dt).reshape(-1, 1), kyv.astype(dt).reshape(-1, 1)


def getDefaultNewCameraMatrix(cameraMatrix, imgsize=None,
                              centerPrincipalPoint=False):
    K = np.array(cameraMatrix, np.float64, copy=True)
    if centerPrincipalPoint and imgsize is not None:
        K[0, 2] = (imgsize[0] - 1) * 0.5
        K[1, 2] = (imgsize[1] - 1) * 0.5
    return K


# Hershey cap heights, extracted numerically from OpenCV 5.0
# (pixelHeight / getFontScaleFromHeight is constant per font; thickness
# and FONT_ITALIC do not enter).
_FONT_CAP = {0: 27.0, 1: 15.0, 2: 27.0, 3: 27.0, 4: 27.0,
             5: 22.0, 6: 25.0, 7: 25.0}


def getFontScaleFromHeight(fontFace, pixelHeight, thickness=1):
    return float(pixelHeight) / _FONT_CAP[int(fontFace) & 7]


# ------------------------------------------------------------ homogeneous

def convertPointsToHomogeneous(src, dst=None):
    a = _a(src, np.float64)
    pts = a.reshape(-1, a.shape[-1])
    out = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    return out[:, None, :].astype(
        np.float32 if _a(src).dtype != np.float64 else np.float64)


def convertPointsFromHomogeneous(src, dst=None):
    a = _a(src, np.float64)
    pts = a.reshape(-1, a.shape[-1])
    w = pts[:, -1:]
    scale = np.where(np.abs(w) > np.finfo(np.float64).eps, 1.0 / np.where(w == 0, 1.0, w), 1.0)
    out = pts[:, :-1] * scale
    return out[:, None, :].astype(
        np.float32 if _a(src).dtype != np.float64 else np.float64)


# -------------------------------------------------------------- image I/O

_READ_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff",
              ".webp", ".ppm", ".pgm", ".pbm", ".pnm"}


def haveImageReader(filename: str) -> bool:
    """True where the port's codecs open the file as the reference's
    ``Image.open`` does (its header; a TIFF's first IFD, a GIF's blocks, a
    WebP's chunks); a form the port does not read yet (the TIFF forms of
    item 8) raises ``not_ported``."""
    try:
        with open(filename, "rb") as f:
            data = f.read()
        _icodec.open_check(data)
    except (OSError, ValueError):
        return False
    return True


def haveImageWriter(filename: str) -> bool:
    return os.path.splitext(filename)[1].lower() in _READ_EXTS


def imcount(filename: str, flags=1) -> int:
    if not os.path.isfile(filename):
        return 0
    try:
        return _icodec.imcount(filename)
    except (OSError, ValueError, CameraError):
        return 0


def imreadmulti(filename: str, mats=None, flags=1, start=None, count=None):
    if not os.path.isfile(filename):
        return False, []
    try:
        frames = _icodec.imreadmulti(filename, device="cpu")
    except (OSError, ValueError, CameraError):
        return False, []
    out = [m.to_numpy() for m in frames]
    if flags == 0:  # IMREAD_GRAYSCALE
        from . import cvtColor
        out = [cvtColor(f, _C.COLOR_BGR2GRAY) for f in out]
    if start is not None:
        out = out[int(start):]
    if count is not None:
        out = out[:int(count)]
    return bool(out), out


def imwritemulti(filename: str, img, params=None) -> bool:
    if not os.path.isdir(os.path.dirname(os.path.abspath(filename))):
        return False
    try:
        return _icodec.imwritemulti(filename, [_a(x) for x in img])
    except NotImplementedError:  # not_ported goes through
        raise
    except (OSError, ValueError, TypeError, KeyError, RuntimeError, CameraError):
        # TypeError: fromarray's; KeyError: no multi-frame writer; RuntimeError: libwebp's
        return False


def imreadWithMetadata(filename: str, metadataTypes=None, flags=1):
    mat, meta = _icodec.imread_with_metadata(filename, device="cpu")
    keys = list(meta.keys())
    vals = [meta[k] for k in keys]
    return mat.to_numpy(), keys, vals


def imwriteWithMetadata(filename: str, img, metadataTypes=None,
                        metadata=None, params=None) -> bool:
    md = metadata
    if metadataTypes is not None and metadata is not None \
            and not isinstance(metadata, dict):
        md = dict(zip([str(t) for t in metadataTypes], list(metadata)))
    a = _a(img)
    return _icodec.imwrite_with_metadata(filename, Mat.from_array(
        np.ascontiguousarray(a), device="cpu"), md or {})


# ----------------------------------------------------------------- classes

class TickMeter:
    """cv2.TickMeter over the core TickMeter (reference tick_meter.rs)."""

    def __init__(self):
        self._tm = _CoreTickMeter()

    def start(self):
        self._tm.start()

    def stop(self):
        self._tm.stop()

    def reset(self):
        self._tm.reset()

    def getCounter(self):
        return self._tm.get_counter()

    def getTimeSec(self):
        return self._tm.get_time_sec()

    def getTimeMilli(self):
        return self._tm.get_time_milli()

    def getTimeMicro(self):
        return self._tm.get_time_micro()

    def getTimeTicks(self):
        return int(self._tm.get_time_sec() * getTickFrequency())

    def getFPS(self):
        return self._tm.get_fps()

    def getAvgTimeMilli(self):
        return self._tm.get_avg_time_milli()

    def getAvgTimeSec(self):
        return self._tm.get_avg_time_milli() / 1e3


class RotatedRect:
    """cv2.RotatedRect value type (center, size, angle-in-degrees)."""

    def __init__(self, center=(0.0, 0.0), size=(0.0, 0.0), angle=0.0):
        self.center = (float(center[0]), float(center[1]))
        self.size = (float(size[0]), float(size[1]))
        self.angle = float(angle)

    def points(self):
        b = np.deg2rad(self.angle)
        ca, sa = np.cos(b), np.sin(b)
        w2, h2 = self.size[0] * 0.5, self.size[1] * 0.5
        cx, cy = self.center
        # cv2 order: bottomLeft, topLeft, topRight, bottomRight
        pts = np.array([
            [cx - sa * h2 - ca * w2, cy + ca * h2 - sa * w2],
            [cx + sa * h2 - ca * w2, cy - ca * h2 - sa * w2],
            [cx + sa * h2 + ca * w2, cy - ca * h2 + sa * w2],
            [cx - sa * h2 + ca * w2, cy + ca * h2 + sa * w2],
        ], np.float32)
        return pts

    def boundingRect(self):
        p = self.points()
        x0 = int(np.floor(p[:, 0].min()))
        y0 = int(np.floor(p[:, 1].min()))
        x1 = int(np.ceil(p[:, 0].max()))
        y1 = int(np.ceil(p[:, 1].max()))
        return (x0, y0, x1 - x0 + 1, y1 - y0 + 1)

    def __repr__(self):
        return (f"RotatedRect(center={self.center}, size={self.size}, "
                f"angle={self.angle})")


class UMat:
    """cv2.UMat role: device-resident array handle. On this stack a UMat
    wraps the host ndarray; device residency lives in the engine
    (device-resident stream state) and in tensors, not in per-Mat
    handles."""

    def __init__(self, arg=None, *a, **k):
        if isinstance(arg, UMat):
            self._a = arg._a.copy()
        elif arg is None:
            self._a = np.empty((0, 0), np.uint8)
        else:
            self._a = np.ascontiguousarray(_a(arg))

    def get(self):
        return self._a.copy()


class Algorithm:
    """cv2.Algorithm base: save/load are format-stubs; getDefaultName
    reports the class."""

    def getDefaultName(self):
        return type(self).__name__

    def clear(self):
        pass

    def empty(self):
        return False


def VideoWriter_fourcc(c1, c2, c3, c4):
    return (ord(c1) & 255) | ((ord(c2) & 255) << 8) \
        | ((ord(c3) & 255) << 16) | ((ord(c4) & 255) << 24)


def _fourcc_str(v) -> str:
    if isinstance(v, str):
        return v
    v = int(v)
    return "".join(chr((v >> (8 * i)) & 255) for i in range(4))


class VideoWriter:
    """cv2.VideoWriter over the MJPEG-in-AVI writer
    (rustcv_tpu_torch.capture.avi.VideoWriter). A numpy frame goes to the
    card and is encoded there; a tensor is encoded on its device."""

    def __init__(self, filename=None, fourcc=None, fps=None, frameSize=None,
                 isColor=True, apiPreference=None, params=None):
        self._w = None
        self._is_color = bool(isColor)
        # cv2 also allows (filename, apiPreference, fourcc, fps, size)
        if fourcc is not None and fps is not None and frameSize is None:
            # (filename, apiPreference, fourcc, fps, frameSize) shift
            pass
        if filename is not None and fourcc is not None and fps is not None \
                and frameSize is not None:
            self.open(filename, fourcc, fps, frameSize, isColor)

    def open(self, filename, fourcc, fps, frameSize, isColor=True):
        from ..capture.avi import VideoWriter as _AviWriter

        try:
            self._w = _AviWriter(filename, _fourcc_str(fourcc), float(fps),
                                 (int(frameSize[0]), int(frameSize[1])))
        except (OSError, ValueError, CameraError):
            self._w = None
            return False
        return True

    def isOpened(self):
        return self._w is not None

    def write(self, image):
        if self._w is None:
            return
        m = _m(image)
        if getattr(image, "ndim", 3) == 2:
            m = _m(m.device().expand(-1, -1, 3))
        self._w.write(m)

    def release(self):
        if self._w is not None:
            self._w.release()
            self._w = None

    def getBackendName(self):
        return "RUSTCV_AVI"

    def set(self, propId, value):
        return False

    def get(self, propId):
        return 0.0

    @staticmethod
    def fourcc(c1, c2, c3, c4):
        return VideoWriter_fourcc(c1, c2, c3, c4)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


_bind(globals())
