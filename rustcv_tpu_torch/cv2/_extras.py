"""cv2 facade — remaining surface: LP solver, geometry extras, animation
I/O, ANN index, RGB-D normals, colorchecker, 3d rasterizer, calibration
variants (the port of ``rustcv_tpu.cv2._extras``). Host code, as the
reference's, but for the facade calls it makes (``connectedComponents``,
``cornerSubPix``, ``findChessboardCornersSB``), which run on the call's
device.

The reference reads and writes multi-page, animated and metadata image
files with Pillow. The port does so with its own codecs
(``imgcodecs.tiff``, ``imgcodecs.gif``, ``imgcodecs.webp``,
``imgcodecs.apng``, ``imgcodecs.exif``): multi-page TIFF, animated GIF,
still and animated WebP and animated PNG both ways, every still format's
one frame, the metadata of all seven formats. The forms of ROADMAP Queue 1
item 8d-ii (4-channel GIF writes, the TIFF forms ``imgcodecs.tiff``
names) raise ``not_ported``, also through the calls that answer False for a
file or buffer that is no image; every JPEG Pillow reads (CMYK and YCCK,
progressive streams left unrefined, lossless, arithmetic-coded) reads as
Pillow reads it.
Held call for call against the reference in
``tests/test_torch_cv2_later_calls.py``.
"""
from __future__ import annotations

import numpy as np

from . import _constants as _C
from ._device import _a, _copyto
from ._device import bind as _bind
from ..core.errors import not_ported as _not_ported
from ..ops import calib as _calib
from ..ops import calib_ext as _cx

__all__ = [
    "solveLP", "phaseCorrelateIterative", "rectangleIntersectionArea",
    "minEnclosingConvexPolygon", "getClosestEllipsePoints",
    "connectedComponentsWithAlgorithm",
    "connectedComponentsWithStatsWithAlgorithm",
    "find4QuadCornerSubpix", "findChessboardCornersSBWithMeta",
    "calibrateCameraRO", "calibrateCameraROExtended",
    "stereoCalibrateExtended", "registerCamerasExtended",
    "imencodemulti", "imdecodemulti", "imdecodeWithMetadata",
    "imencodeWithMetadata",
    "Animation", "imreadanimation", "imwriteanimation",
    "imdecodeanimation", "imencodeanimation",
    "ANNIndex", "ANNIndex_create", "RgbdNormals", "RgbdNormals_create",
    "mcc_CCheckerDetector", "ccm_ColorCorrectionModel",
    "triangleRasterize", "triangleRasterizeColor", "triangleRasterizeDepth",
    "TriangleRasterizeSettings",
    "VideoCapture_waitAny", "redirectError", "UsacParams", "TermCriteria",
    "Tracker", "TrackerMIL_Params", "WarperCreator", "AsyncArray",
]


# ------------------------------------------------------------------ solveLP

def solveLP(Func, Constr, constr_eps=1e-12, z=None):
    """Maximize c·x s.t. Ax <= b, x >= 0 (cv2.solveLP, dense simplex).
    Constr = [A | b].  Returns (SOLVELP_SINGLE / _UNBOUNDED /
    _UNFEASIBLE, z)."""
    c = _a(Func, np.float64).ravel()
    M = _a(Constr, np.float64)
    A, b = M[:, :-1], M[:, -1]
    m, n = A.shape
    if (b < 0).any():
        # would need two-phase simplex; OpenCV's solver has the same
        # restriction in spirit (feasible origin)
        T = None
    # standard tableau with slack variables; origin feasible iff b >= 0
    if (b < 0).any():
        return _C.SOLVELP_UNFEASIBLE, np.zeros((n, 1))
    T = np.zeros((m + 1, n + m + 1))
    T[:m, :n] = A
    T[:m, n:n + m] = np.eye(m)
    T[:m, -1] = b
    T[m, :n] = -c
    basis = list(range(n, n + m))
    for _ in range(1000):
        j = int(np.argmin(T[m, :-1]))
        if T[m, j] >= -constr_eps:
            break
        col = T[:m, j]
        if (col <= constr_eps).all():
            return _C.SOLVELP_UNBOUNDED, np.zeros((n, 1))
        ratios = np.where(col > constr_eps, T[:m, -1] / np.where(
            col > constr_eps, col, 1.0), np.inf)
        i = int(np.argmin(ratios))
        T[i] /= T[i, j]
        for r in range(m + 1):
            if r != i and T[r, j] != 0:
                T[r] -= T[r, j] * T[i]
        basis[i] = j
    x = np.zeros(n + m)
    for i, bi in enumerate(basis):
        x[bi] = T[i, -1]
    return _C.SOLVELP_SINGLE, x[:n].reshape(-1, 1)


# ------------------------------------------------------------ geometry misc

def phaseCorrelateIterative(src1, src2, L2size=5, maxIters=50):
    """Iterative sub-pixel phase correlation: re-correlate against a
    phase-ramp-shifted src2 until the residual shift converges."""
    from . import phaseCorrelate

    a = _a(src1, np.float64)
    b = _a(src2, np.float64)
    h, w = a.shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    total = np.zeros(2)
    cur = b
    for _ in range(int(maxIters)):
        (dx, dy), _resp = phaseCorrelate(a.astype(np.float32),
                                         cur.astype(np.float32))
        total += (dx, dy)
        if abs(dx) < 1e-4 and abs(dy) < 1e-4:
            break
        F = np.fft.fft2(b)
        ramp = np.exp(2j * np.pi * (fx * total[0] + fy * total[1]))
        cur = np.real(np.fft.ifft2(F * ramp))
    return float(total[0]), float(total[1])


def rectangleIntersectionArea(a, b):
    x0 = max(a[0], b[0])
    y0 = max(a[1], b[1])
    x1 = min(a[0] + a[2], b[0] + b[2])
    y1 = min(a[1] + a[3], b[1] + b[3])
    return float(max(0.0, x1 - x0) * max(0.0, y1 - y0))


def _poly_area(p):
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _line_intersect(p0, d0, p1, d1):
    A = np.array([[d0[0], -d1[0]], [d0[1], -d1[1]]])
    if abs(np.linalg.det(A)) < 1e-12:
        return None
    t = np.linalg.solve(A, _a(p1) - _a(p0))
    return _a(p0) + t[0] * _a(d0)


def minEnclosingConvexPolygon(points, k, polygon=None):
    """Minimum-area enclosing convex k-gon (cv2 role): convex hull then
    greedy edge merging — repeatedly replace the vertex whose removal
    (extending its two neighbor edges to their intersection) adds the
    least area.  Within a few percent of the optimal (exact DP) area."""
    from . import convexHull

    pts = _a(points, np.float64).reshape(-1, 2)
    hull = convexHull(pts.astype(np.float32)).reshape(-1, 2)
    P = hull.astype(np.float64)
    if len(P) < 3:
        raise ValueError("need at least 3 hull points")
    k = int(k)

    def _contains_all(poly, pts_):
        n_ = len(poly)
        ok = np.ones(len(pts_), bool)
        sgn = 0.0
        for i in range(n_):
            e = poly[(i + 1) % n_] - poly[i]
            d_ = pts_ - poly[i]
            cr = e[0] * d_[:, 1] - e[1] * d_[:, 0]
            if sgn == 0.0:
                sgn = np.sign(cr[np.abs(cr).argmax()]) or 1.0
            ok &= sgn * cr >= -1e-7
        return ok.all()

    while len(P) > max(k, 3):
        n = len(P)
        best = None
        for i in range(n):
            a, b = P[(i - 1) % n], P[i]
            c, d = P[(i + 1) % n], P[(i + 2) % n]
            q = _line_intersect(a, b - a, d, c - d)
            if q is None:
                continue
            cand = np.vstack([P[:i], [q], P[i + 2:]]) if i + 1 < n \
                else np.vstack([[q], P[1:n - 1]])
            if not _contains_all(cand, P):
                continue
            extra = _poly_area(cand) - _poly_area(P)
            if extra < -1e-9:
                continue
            if best is None or extra < best[0]:
                best = (extra, cand)
        if best is None:
            break
        P = best[1]
    return _poly_area(P), P.astype(np.float32)


def getClosestEllipsePoints(ellipse_params, points, closest_pts=None):
    """Nearest point on a rotated ellipse per query (Newton projection
    in the ellipse frame)."""
    (cx, cy), (w, h), ang = ellipse_params
    a, b = w / 2.0, h / 2.0
    th = np.deg2rad(ang)
    ca, sa = np.cos(th), np.sin(th)
    p = _a(points, np.float64).reshape(-1, 2)
    # to ellipse frame
    dx, dy = p[:, 0] - cx, p[:, 1] - cy
    u = ca * dx + sa * dy
    v = -sa * dx + ca * dy
    out = np.empty_like(p)
    for i, (px, py) in enumerate(zip(u, v)):
        t = np.arctan2(py * a, px * b)
        for _ in range(50):
            ct, st = np.cos(t), np.sin(t)
            ex, ey = a * ct, b * st
            # derivative of squared distance wrt t
            g = -(px - ex) * a * st + (py - ey) * b * ct
            gp = -(px - ex) * a * ct - (a * st) ** 2 \
                - (py - ey) * b * st - (b * ct) ** 2
            step = g / gp if abs(gp) > 1e-12 else 0.0
            t -= step
            if abs(step) < 1e-12:
                break
        out[i] = (a * np.cos(t), b * np.sin(t))
    # back to image frame
    X = ca * out[:, 0] - sa * out[:, 1] + cx
    Y = sa * out[:, 0] + ca * out[:, 1] + cy
    return np.stack([X, Y], axis=1).astype(np.float32)


# -------------------------------------------------------------- CC aliases

def connectedComponentsWithAlgorithm(image, connectivity, ltype, ccltype,
                                     labels=None):
    from . import connectedComponents

    return connectedComponents(image, connectivity=connectivity,
                               ltype=ltype)


def connectedComponentsWithStatsWithAlgorithm(image, connectivity, ltype,
                                              ccltype, labels=None,
                                              stats=None, centroids=None):
    from . import connectedComponentsWithStats

    return connectedComponentsWithStats(image, connectivity=connectivity,
                                        ltype=ltype)


# ---------------------------------------------------------- chessboard etc

def find4QuadCornerSubpix(img, corners, region_size):
    from . import cornerSubPix

    crit = (_C.TERM_CRITERIA_EPS + _C.TERM_CRITERIA_MAX_ITER, 30, 0.01)
    out = cornerSubPix(img, _a(corners, np.float32),
                       (int(region_size[0]) // 2, int(region_size[1]) // 2),
                       (-1, -1), crit)
    return True, out


def findChessboardCornersSBWithMeta(image, patternSize, flags=0,
                                    corners=None, meta=None):
    from ._classes import findChessboardCornersSB

    ok, c = findChessboardCornersSB(image, patternSize, flags=flags)
    cols, rows = int(patternSize[0]), int(patternSize[1])
    m = np.zeros((rows, cols), np.uint8) if ok else None
    return ok, c, m


# ---------------------------------------------------- calibration variants

def calibrateCameraRO(objectPoints, imagePoints, imageSize, iFixedPoint,
                      cameraMatrix=None, distCoeffs=None, rvecs=None,
                      tvecs=None, newObjPoints=None, flags=0,
                      criteria=None):
    """Release-object calibration role: standard Zhang calibration; the
    object points are treated as exact (newObjPoints = input)."""
    rms, k, dist, rv, tv = _calib.calibrate_camera(
        list(objectPoints), list(imagePoints), imageSize)
    return (rms, k, _a(dist).reshape(1, -1),
            [_a(r).reshape(3, 1) for r in rv],
            [_a(t).reshape(3, 1) for t in tv],
            _a(objectPoints[0], np.float32))


def calibrateCameraROExtended(objectPoints, imagePoints, imageSize,
                              iFixedPoint, cameraMatrix=None,
                              distCoeffs=None, **kw):
    rms, k, dist, rv, tv, new_obj = calibrateCameraRO(
        objectPoints, imagePoints, imageSize, iFixedPoint)
    views = len(rv)
    pve = []
    for o, i, r, t in zip(objectPoints, imagePoints, rv, tv):
        proj = _calib.project_points(
            _a(o, np.float64).reshape(-1, 3), _a(r).ravel(),
            _a(t).ravel(), k, _a(dist).ravel())
        pve.append(float(np.sqrt(((proj - _a(i, np.float64)
                                   .reshape(-1, 2)) ** 2).sum(1).mean())))
    return (rms, k, dist, rv, tv, new_obj,
            np.zeros((18, 1)), np.zeros((6 * views, 1)), np.zeros((3, 1)),
            _a(pve).reshape(-1, 1))


def stereoCalibrateExtended(objectPoints, imagePoints1, imagePoints2,
                            cameraMatrix1, distCoeffs1, cameraMatrix2,
                            distCoeffs2, imageSize, R=None, T=None,
                            E=None, F=None, rvecs=None, tvecs=None,
                            perViewErrors=None, flags=0, criteria=None):
    from ._calib3d import stereoCalibrate

    out = stereoCalibrate(objectPoints, imagePoints1, imagePoints2,
                          cameraMatrix1, distCoeffs1, cameraMatrix2,
                          distCoeffs2, imageSize)
    rms, k1, d1, k2, d2, R_, T_, E_, F_ = out
    rv, tv, pve = [], [], []
    for o, i1, i2 in zip(objectPoints, imagePoints1, imagePoints2):
        obj = _a(o, np.float64).reshape(-1, 3)
        r1, t1 = _calib.solve_pnp(obj,
                                  _a(i1, np.float64).reshape(-1, 2),
                                  _a(k1, np.float64),
                                  _a(d1).ravel())
        rv.append(_a(r1).reshape(3, 1))
        tv.append(_a(t1).reshape(3, 1))
        p1 = _calib.project_points(obj, r1, t1, _a(k1, np.float64),
                                   _a(d1).ravel())
        e1 = np.sqrt(((p1 - _a(i1, np.float64).reshape(-1, 2))
                      ** 2).sum(1).mean())
        pve.append([float(e1), float(e1)])
    return (rms, k1, d1, k2, d2, R_, T_, E_, F_, rv, tv,
            _a(pve, np.float64))


def registerCamerasExtended(objectPoints1, objectPoints2, imagePoints1,
                            imagePoints2, cameraMatrix1, distCoeffs1,
                            cameraMatrix2, distCoeffs2, *a, **k):
    rms, rvec, tvec = _cx.register_cameras(
        objectPoints1, imagePoints1, imagePoints2, cameraMatrix1,
        distCoeffs1, cameraMatrix2, distCoeffs2)
    R = _calib.rodrigues(_a(rvec, np.float64))
    T = _a(tvec, np.float64).reshape(3, 1)
    E = np.cross(np.eye(3), T.ravel()) @ R
    K1 = _a(cameraMatrix1, np.float64)
    K2 = _a(cameraMatrix2, np.float64)
    F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    return rms, R, T, E, F, np.zeros((0, 1))


# ----------------------------------------------------------- image buffers

_MULTI = {"tif": "tiff", "tiff": "tiff", "gif": "gif"}  # imencodemulti's formats


def imencodemulti(ext, imgs, params=None):
    """(True, bytes) of a multi-page TIFF or an animated GIF of ``imgs``
    (BGR or gray); (False, empty) for any other extension (a ".png" too, as
    the reference's) or no images."""
    from ..imgcodecs import encode_frames

    frames = [_a(x) for x in imgs]
    fmt = _MULTI.get(str(ext).lower().lstrip("."))
    if fmt is None or not frames:
        return False, np.zeros((0,), np.uint8)
    return True, np.frombuffer(encode_frames(fmt, frames), np.uint8)


def imdecodemulti(buf, flags=1, mats=None, range=None):
    """(ok, every page or frame as BGR) of an encoded buffer; (False, [])
    where the reference's ``Image.open`` fails."""
    from ..imgcodecs import decode_frames, open_check

    data = _a(buf, np.uint8).tobytes()
    try:
        open_check(data)
    except ValueError:
        return False, []
    out = decode_frames(data)
    return bool(out), out


def imdecodeWithMetadata(buf, metadataTypes=None, flags=1, img=None,
                         metadatas=None):
    """(BGR image, keys, values) of Pillow's ``info`` as the reference
    shows it (str, int and float values, as str; no EXIF)."""
    from ..core.errors import CameraError
    from ..imgcodecs import _decode_host
    from ..imgcodecs import exif as _exif

    data = _a(buf, np.uint8).tobytes()
    try:
        meta = _exif.info_metadata(data)
        bgr = _decode_host(data)
    except ValueError as e:
        raise CameraError(f"imdecodeWithMetadata: cannot decode buffer: {e}") from e
    return bgr, list(meta.keys()), list(meta.values())


# imencodeWithMetadata's formats: the reference's Pillow format names
_ENCODE_FORMATS = {"png": "png", "jpg": "jpeg", "jpeg": "jpeg", "bmp": "bmp", "ppm": "pnm",
                   "tiff": "tiff", "gif": "gif", "webp": "webp"}
# the modes of Image.fromarray's that Pillow's JPEG, BMP and PPM writers take (its OSError
# for the others); PNG's are imgcodecs.host's, TIFF, GIF and WebP take every one
_PILLOW_SAVES = {"jpeg": ("1", "L", "RGB"), "bmp": ("1", "L", "RGB", "RGBA"),
                 "pnm": ("1", "L", "I;16", "I", "RGB", "RGBA", "F")}


def imencodeWithMetadata(ext, img, metadataTypes=None, metadata=None,
                         params=None):
    """(True, bytes) of ``img`` (BGR or gray) as ``ext``: a PNG with
    ``metadata`` as text chunks (a dict, or values under
    ``metadataTypes``), other formats through the port's writers (a JPEG
    at quality 75, the reference's Pillow default; a WebP as Pillow's still,
    without metadata, and Pillow's ValueError for a side above 16383).
    ``img`` is what the reference hands ``Image.fromarray``: its TypeError
    for a dtype or shape that has no mode, Pillow's OSError for a mode the
    format's writer refuses. A PNG takes every mode but F; the other
    formats' writers take u8 images, and a mode Pillow writes there but the
    port does not yet (1 to JPEG or BMP, 16-bit, I and F to PPM, any of
    them to TIFF, GIF or WebP) raises ``not_ported``."""
    import torch

    from ..core.errors import CameraError
    from ..imgcodecs import host as _host
    from ..ops.jpeg_encode import encode_jpeg

    a = _a(img)
    e = str(ext).lower().lstrip(".")
    fmt = _ENCODE_FORMATS.get(e)
    if fmt is None:
        raise CameraError(f"imencodeWithMetadata: unknown image format {ext!r}")
    rgb = a[..., ::-1] if a.ndim == 3 else a
    mode = _host.pillow_mode(rgb)
    if mode not in _PILLOW_SAVES.get(fmt, (mode,)):
        raise OSError(f"cannot write mode {mode} as {fmt.upper()}")
    if fmt != "png" and mode not in ("L", "LA", "RGB", "RGBA"):
        raise _not_ported(f"cv2.imencodeWithMetadata of mode {mode} ({a.dtype}) images as "
                          f"{fmt.upper()}", item="8")
    if fmt == "webp":  # the reference lets Pillow's errors through
        return True, np.frombuffer(_host.ENCODERS[fmt](rgb), np.uint8)
    try:
        if fmt == "png" and metadata:
            md = metadata if isinstance(metadata, dict) else \
                dict(zip(map(str, metadataTypes or []), metadata))
            data = _host.write_png(rgb, {str(k): str(v) for k, v in md.items()})
        elif fmt == "jpeg":
            data = encode_jpeg(torch.from_numpy(np.ascontiguousarray(a, np.uint8)), quality=75)
        else:
            data = _host.ENCODERS[fmt](rgb)
    except _host.CodecError as err:
        raise CameraError(f"imencodeWithMetadata: {err}") from err
    return True, np.frombuffer(data, np.uint8)


# ------------------------------------------------------------ animation IO

class Animation:
    """cv2.Animation: frames (BGR ndarrays), per-frame durations (ms),
    loop_count, bgcolor, still_image."""

    def __init__(self, loopCount=0, bgColor=(0, 0, 0, 0)):
        self.loop_count = int(loopCount)
        self.bgcolor = tuple(bgColor)
        self.frames = []
        self.durations = []
        self.still_image = None


def _read_animation(data: bytes, start, count):
    """The reference's ``imreadanimation`` over bytes: (False, an empty
    Animation) where the file is no image or cannot be read."""
    from ..imgcodecs import animation_frames

    anim = Animation()
    try:
        frames, loop = animation_frames(data)
        anim.loop_count = int(loop)
        for i, read in enumerate(frames):  # each step a seek, as the reference's ImageSequence
            if i < start:
                continue
            if len(anim.frames) >= count:  # the seek of the frame after the last one asked for ran
                break
            frame, ms = read()
            anim.frames.append(frame)
            anim.durations.append(int(ms))
    except ValueError:  # the reference keeps the frames read before the one that fails
        return False, anim
    return bool(anim.frames), anim


def imreadanimation(filename, start=0, count=32767, animation=None):
    try:
        with open(filename, "rb") as f:
            data = f.read()
    except OSError:
        return False, Animation()
    return _read_animation(data, start, count)


def _encode_animation(ext: str, animation):
    """The bytes the reference's ``imwriteanimation`` writes for a file
    named ``*ext``, or None where it answers False."""
    from ..core.errors import CameraError
    from ..imgcodecs import _format_of, encode_frames

    if not animation.frames:
        return None
    frames = [_a(f) for f in animation.frames]
    durations = animation.durations or [100] * len(frames)
    try:
        fmt = _format_of(str(ext), "imwriteanimation")
    except CameraError:  # Pillow: "unknown file extension", a ValueError
        return None
    try:
        return encode_frames(fmt, frames, duration=durations, loop=animation.loop_count)
    except (ValueError, OSError):  # a frame Pillow cannot write: its save raises, it answers False
        return None


def imwriteanimation(filename, animation, params=None):
    import os

    data = _encode_animation(os.path.splitext(str(filename))[1], animation)
    if data is None:
        return False
    try:
        with open(filename, "wb") as f:
            f.write(data)
    except OSError:
        return False
    return True


def imdecodeanimation(buf, animation=None, start=0, count=32767):
    return _read_animation(_a(buf, np.uint8).tobytes(), start, count)


def imencodeanimation(ext, animation, params=None):
    data = _encode_animation(ext if str(ext).startswith(".") else "." + str(ext), animation)
    if data is None:
        return False, np.zeros((0,), np.uint8)
    return True, np.frombuffer(data, np.uint8)


# ---------------------------------------------------------------- ANNIndex

class ANNIndex:
    """cv2.ANNIndex (annoy role) over the exact kd-tree in
    ops/knn_index.py — approximate interface, exact answers."""

    DIST_EUCLIDEAN = 0
    DIST_MANHATTAN = 1
    DIST_ANGULAR = 2
    DIST_HAMMING = 3
    DIST_DOTPRODUCT = 4

    def __init__(self, dim, distType=0):
        self._dim = int(dim)
        self._dist = int(distType)
        self._rows = []
        self._idx = None
        self._trees = 0

    def addItems(self, features):
        a = _a(features, np.float32).reshape(-1, self._dim)
        self._rows.append(a)
        self._idx = None

    def build(self, trees=-1):
        self._trees = int(trees)
        self._data = np.vstack(self._rows) if self._rows else \
            np.zeros((0, self._dim), np.float32)
        if self._dist == ANNIndex.DIST_EUCLIDEAN and len(self._data):
            from ..ops.knn_index import KnnIndex

            self._idx = KnnIndex(self._data)
        return True

    def getItemNumber(self):
        return sum(len(r) for r in self._rows)

    def getTreeNumber(self):
        return self._trees

    def setSeed(self, seed):
        pass  # exact search: no randomness

    def setOnDiskBuild(self, filename):
        pass

    def knnSearch(self, query, knn):
        q = _a(query, np.float32).reshape(-1, self._dim)
        k = int(knn)
        if self._dist == ANNIndex.DIST_EUCLIDEAN and self._idx is not None:
            ii, d2 = self._idx.knn_search(q, k)
            return (_a(ii, np.int32),
                    np.sqrt(_a(d2, np.float32)))
        d = self._pairwise(q)
        ii = np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)
        dd = np.take_along_axis(d, ii, axis=1).astype(np.float32)
        return ii, dd

    def _pairwise(self, q):
        x = self._data.astype(np.float64)
        qq = q.astype(np.float64)
        if self._dist == ANNIndex.DIST_MANHATTAN:
            return np.abs(qq[:, None] - x[None]).sum(-1)
        if self._dist == ANNIndex.DIST_ANGULAR:
            nq = qq / np.maximum(np.linalg.norm(qq, axis=1,
                                                keepdims=True), 1e-30)
            nx = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                                1e-30)
            return np.sqrt(np.maximum(2.0 - 2.0 * (nq @ nx.T), 0.0))
        if self._dist == ANNIndex.DIST_DOTPRODUCT:
            return -(qq @ x.T)
        if self._dist == ANNIndex.DIST_HAMMING:
            xb = x > 0.5
            qb = qq > 0.5
            return (qb[:, None] != xb[None]).sum(-1).astype(np.float64)
        return np.sqrt(((qq[:, None] - x[None]) ** 2).sum(-1))

    def save(self, filename, prefix=""):
        np.save(filename, np.vstack(self._rows))
        return True

    def load(self, filename, prefix=""):
        self._rows = [np.load(filename)]
        self.build(self._trees)
        return True

    @staticmethod
    def create(dim, distType=0):
        return ANNIndex(dim, distType)


def ANNIndex_create(dim, distType=0):
    return ANNIndex(dim, distType)


# ------------------------------------------------------------ RGB-D normals

class RgbdNormals:
    RGBD_NORMALS_METHOD_FALS = 0
    RGBD_NORMALS_METHOD_LINEMOD = 1
    RGBD_NORMALS_METHOD_SRI = 2
    RGBD_NORMALS_METHOD_CROSS_PRODUCT = 3

    def __init__(self, rows=0, cols=0, depth=0, K=None, window_size=5,
                 diff_threshold=50.0, method=3):
        self._k = None if K is None else _a(K, np.float64)

    def apply(self, points, normals=None):
        from ..ops.threed import rgbd_normals_numpy

        return _a(rgbd_normals_numpy(
            _a(points, np.float64)), np.float32)

    @staticmethod
    def create(rows=0, cols=0, depth=0, K=None, window_size=5,
               diff_threshold=50.0, method=3):
        return RgbdNormals(rows, cols, depth, K, window_size,
                           diff_threshold, method)


def RgbdNormals_create(*a, **k):
    return RgbdNormals(*a, **k)


# ------------------------------------------------------------- colorchecker

class mcc_CCheckerDetector:
    """cv2.mcc.CCheckerDetector role over ops/colorchecker.py."""

    def __init__(self):
        self._result = None

    @staticmethod
    def create():
        return mcc_CCheckerDetector()

    def process(self, image, chartType=0, nc=1, useNet=False, params=None):
        from ..ops.colorchecker import detect_color_checker

        res = detect_color_checker(_a(image))
        self._result = res
        return res is not None

    def getBestColorChecker(self):
        return self._result

    def getListColorChecker(self):
        return [self._result] if self._result is not None else []


class ccm_ColorCorrectionModel:
    """cv2.ccm.ColorCorrectionModel role over
    ops/colorchecker.color_checker_ccm."""

    def __init__(self, src, constcolor_or_colors=None, ref_cs=None,
                 colored=None):
        self._src = _a(src, np.float64)
        self._ccm = None

    def run(self):
        from ..ops.colorchecker import color_checker_ccm

        self._ccm = color_checker_ccm(self._src)
        return self._ccm

    def getCCM(self):
        return self._ccm

    def infer(self, img):
        a = _a(img, np.float64)
        out = a.reshape(-1, 3) @ self._ccm[:3, :3].T
        if self._ccm.shape[0] == 4 or self._ccm.shape[1] == 4:
            pass
        return out.reshape(a.shape)


# ----------------------------------------------------------- 3d rasterizer

class TriangleRasterizeSettings:
    def __init__(self):
        self.shadingType = 2   # shaded
        self.cullingMode = 0
        self.glCompatibleMode = 0

    def setShadingType(self, t):
        self.shadingType = t
        return self

    def setCullingMode(self, m):
        self.cullingMode = m
        return self


def _project_gl(vertices, world2cam, fovY, zNear, zFar, w, h):
    v = _a(vertices, np.float64).reshape(-1, 3)
    rt = _a(world2cam, np.float64)
    cam = v @ rt[:3, :3].T + rt[:3, 3]
    # OpenGL camera looks down -z, y up; fovY in radians (cv2 asserts
    # fovyRadians < pi)
    f = 1.0 / np.tan(float(fovY) / 2.0)
    aspect = w / h
    z = -cam[:, 2]
    x_ndc = (f / aspect) * cam[:, 0] / np.maximum(z, 1e-12)
    y_ndc = f * cam[:, 1] / np.maximum(z, 1e-12)
    xs = (x_ndc + 1.0) * 0.5 * w - 0.5
    ys = (1.0 - y_ndc) * 0.5 * h - 0.5
    return np.stack([xs, ys, z], axis=1)


def triangleRasterize(vertices, indices, colors, colorBuf, depthBuf,
                      world2cam, fovY, zNear, zFar, settings=None):
    from ..ops.threed import triangle_rasterize_numpy

    h, w = _a(depthBuf).shape[:2]
    proj = _project_gl(vertices, world2cam, fovY, zNear, zFar, w, h)
    color, depth = triangle_rasterize_numpy(
        proj, _a(indices, np.int64).reshape(-1, 3),
        _a(colors, np.float64).reshape(-1, 3), w, h)
    cb0, db0 = _a(colorBuf), _a(depthBuf)
    cb = _a(cb0, np.float32)
    db = _a(db0, np.float32)
    hit = np.isfinite(depth) & (depth < db) & (depth >= zNear) \
        & (depth <= zFar)
    out_c = np.where(hit[..., None], color, cb)
    out_d = np.where(hit, depth, db)
    _copyto(colorBuf, out_c.astype(cb0.dtype))
    _copyto(depthBuf, out_d.astype(db0.dtype))
    return colorBuf, depthBuf


def triangleRasterizeColor(vertices, indices, colors, colorBuf, world2cam,
                           fovY, zNear, zFar, settings=None):
    depth = np.full(_a(colorBuf).shape[:2], np.float32(zFar))
    triangleRasterize(vertices, indices, colors, colorBuf, depth,
                      world2cam, fovY, zNear, zFar, settings)
    return colorBuf


def triangleRasterizeDepth(vertices, indices, depthBuf, world2cam, fovY,
                           zNear, zFar, settings=None):
    n = _a(vertices).reshape(-1, 3).shape[0]
    colors = np.ones((n, 3), np.float64)
    cbuf = np.zeros(_a(depthBuf).shape[:2] + (3,), np.float32)
    triangleRasterize(vertices, indices, colors, cbuf, depthBuf,
                      world2cam, fovY, zNear, zFar, settings)
    return depthBuf


# ------------------------------------------------------------ small shims

def VideoCapture_waitAny(streams, timeoutNs=0):
    """Role port: our facade captures decode synchronously, so every
    opened stream is ready."""
    ready = [i for i, s in enumerate(streams) if s.isOpened()]
    return bool(ready), ready


_error_handler = [None]


def redirectError(onError=None, userdata=None):
    _error_handler[0] = onError
    return None


class UsacParams:
    def __init__(self):
        self.confidence = 0.99
        self.isParallel = False
        self.loIterations = 5
        self.loMethod = 0
        self.loSampleSize = 14
        self.maxIterations = 5000
        self.neighborsSearch = 0
        self.randomGeneratorState = 0
        self.sampler = 0
        self.score = 1
        self.threshold = 1.5
        self.final_polisher = 0
        self.final_polisher_iterations = 0


class TermCriteria:
    COUNT = 1
    MAX_ITER = 1
    EPS = 2

    def __init__(self, type=3, maxCount=30, epsilon=1e-3):
        self.type = int(type)
        self.maxCount = int(maxCount)
        self.epsilon = float(epsilon)

    def __iter__(self):
        return iter((self.type, self.maxCount, self.epsilon))


class Tracker:
    def init(self, image, boundingBox):
        raise NotImplementedError

    def update(self, image):
        raise NotImplementedError


class TrackerMIL_Params:
    def __init__(self):
        self.samplerInitInRadius = 3.0
        self.samplerInitMaxNegNum = 65
        self.samplerSearchWinSize = 25.0
        self.samplerTrackInRadius = 4.0
        self.samplerTrackMaxPosNum = 100000
        self.samplerTrackMaxNegNum = 65
        self.featureSetNumFeatures = 250


class WarperCreator:
    def create(self, scale):
        from ._algos import PyRotationWarper

        return PyRotationWarper("spherical", scale)


class AsyncArray:
    """cv2.AsyncArray role: synchronous result holder (our pipelines
    expose async execution at the engine level, not per-call)."""

    def __init__(self, value=None):
        self._v = value

    def get(self, timeoutNs=-1):
        return self._v

    def valid(self):
        return self._v is not None

    def wait_for(self, timeoutNs):
        return self._v is not None


_bind(globals())
