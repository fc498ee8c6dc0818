"""cv2 facade — flat-surface completion: type helpers, KeyPoint utils,
base classes, EMD, Hough accumulator variants, MST, GUI trackbar state,
dnn-model guards (the port of ``rustcv_tpu.cv2._misc3``). Host code, as
the reference's, but for the facade calls it makes: ``GFTTDetector``'s
``goodFeaturesToTrack`` (the Harris kernel on the card), ``filter2Dp``'s
``filter2D``, ``addText``'s draw (a tensor on its device, a numpy image on
the host, in the caller's buffer). Held call for call against the
reference in ``tests/test_torch_cv2_later_calls.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _constants as _C
from ._classes import KeyPoint
from ._device import _a, _copyto, _host_mat, _m, _o
from ._device import bind as _bind

__all__ = [
    "CV_MAKETYPE", "CV_8UC", "CV_8SC", "CV_16UC", "CV_16SC", "CV_32SC",
    "CV_32FC", "CV_64FC", "CV_16FC", "CV_16BFC", "CV_32UC", "CV_64UC",
    "CV_64SC",
    "KeyPoint_convert", "KeyPoint_overlap",
    "Feature2D", "GFTTDetector", "GFTTDetector_create",
    "GeneralizedHough", "StereoMatcher", "BackgroundSubtractor",
    "FlannBasedMatcher_create", "GraphicalCodeDetector", "IStreamReader",
    "EMD", "HoughLinesWithAccumulator", "HoughCirclesWithAccumulator",
    "HoughLinesPointSet",
    "MSTEdge", "buildMST", "broadcast", "getDefaultAlgorithmHint",
    "filter2Dp", "projectPointsSepJ", "findTransformECCWithMask",
    "FontFace",
    "OdometryFrame", "OdometrySettings", "VolumeSettings",
    "CirclesGridFinderParameters", "ECCParameters",
    "QRCodeEncoder_Params", "QRCodeDetectorAruco_Params",
    "TrackerDaSiamRPN", "TrackerDaSiamRPN_Params", "TrackerDaSiamRPN_create",
    "TrackerNano", "TrackerNano_Params", "TrackerNano_create",
    "TrackerVit", "TrackerVit_Params", "TrackerVit_create",
    "ALIKED", "ALIKED_Params", "ALIKED_create",
    "DISK", "DISK_create", "DISK_createFromMemory",
    "LightGlueMatcher", "LightGlueMatcher_create",
    "LightGlueMatcher_createFromMemory",
    "FaceDetectorYN", "FaceDetectorYN_create",
    "FaceRecognizerSF", "FaceRecognizerSF_create",
    "barcode_BarcodeDetector", "mcc_CChecker", "mcc_DetectorParametersMCC",
    "aruco_ArucoDetector", "aruco_DetectorParameters", "aruco_Dictionary",
    "createTrackbar", "getTrackbarPos", "setTrackbarPos", "setTrackbarMax",
    "setTrackbarMin", "setMouseCallback", "setWindowProperty",
    "getWindowImageRect", "startWindowThread", "addText",
    "displayOverlay", "displayStatusBar", "selectROI", "selectROIs",
    "bootstrap", "calibrateMultiview", "calibrateMultiviewExtended",
    "correctChromaticAberration", "loadChromaticAberrationParams",
    "createButton",
    "aruco_Board", "aruco_GridBoard", "aruco_CharucoBoard",
    "aruco_CharucoDetector", "aruco_CharucoParameters",
    "aruco_RefineParameters",
]


# --------------------------------------------------------- type helpers

def CV_MAKETYPE(depth, cn):
    # OpenCV 5 layout: 5 depth bits, channels start at bit 5
    return (int(depth) & 31) + ((int(cn) - 1) << 5)


def CV_8UC(n):
    return CV_MAKETYPE(0, n)


def CV_8SC(n):
    return CV_MAKETYPE(1, n)


def CV_16UC(n):
    return CV_MAKETYPE(2, n)


def CV_16SC(n):
    return CV_MAKETYPE(3, n)


def CV_32SC(n):
    return CV_MAKETYPE(4, n)


def CV_32FC(n):
    return CV_MAKETYPE(5, n)


def CV_64FC(n):
    return CV_MAKETYPE(6, n)


def CV_16FC(n):
    return CV_MAKETYPE(7, n)


# cv2 5 extended depth codes (16BF=8, 64U=10, 64S=11, 32U=12)
def CV_16BFC(n):
    return CV_MAKETYPE(8, n)


def CV_64UC(n):
    return CV_MAKETYPE(10, n)


def CV_64SC(n):
    return CV_MAKETYPE(11, n)


def CV_32UC(n):
    return CV_MAKETYPE(12, n)


# ------------------------------------------------------- KeyPoint utils

def KeyPoint_convert(keypoints, keypointIndexes=None, size=1.0,
                     response=1.0, octave=0, class_id=-1):
    seq = list(keypoints) if not isinstance(keypoints, np.ndarray) \
        else keypoints
    if len(seq) and isinstance(seq[0], KeyPoint):
        if keypointIndexes is not None and len(keypointIndexes):
            seq = [seq[i] for i in _a(keypointIndexes).ravel()]
        return _a([[k.pt[0], k.pt[1]] for k in seq], np.float32)
    pts = _a(keypoints, np.float32).reshape(-1, 2)
    return [KeyPoint(float(x), float(y), float(size), -1.0,
                     float(response), int(octave), int(class_id))
            for x, y in pts]


def KeyPoint_overlap(kp1, kp2):
    """Intersection-over-union of the two keypoint support circles
    (radius = size/2), cv2-exact analytic circle intersection."""
    r1 = kp1.size * 0.5
    r2 = kp2.size * 0.5
    d = float(np.hypot(kp1.pt[0] - kp2.pt[0], kp1.pt[1] - kp2.pt[1]))
    if d >= r1 + r2:
        return 0.0
    a1, a2 = np.pi * r1 * r1, np.pi * r2 * r2
    if d <= abs(r1 - r2):
        inter = min(a1, a2)
    else:
        alpha1 = np.arccos((d * d + r1 * r1 - r2 * r2) / (2 * d * r1))
        alpha2 = np.arccos((d * d + r2 * r2 - r1 * r1) / (2 * d * r2))
        inter = (r1 * r1 * (alpha1 - 0.5 * np.sin(2 * alpha1))
                 + r2 * r2 * (alpha2 - 0.5 * np.sin(2 * alpha2)))
    return float(inter / (a1 + a2 - inter))


# ----------------------------------------------------------- base classes

class Feature2D:
    def detect(self, image, mask=None):
        raise NotImplementedError

    def compute(self, image, keypoints):
        raise NotImplementedError

    def detectAndCompute(self, image, mask=None):
        raise NotImplementedError

    def empty(self):
        return False

    def getDefaultName(self):
        return type(self).__name__


class GFTTDetector(Feature2D):
    """cv2.GFTTDetector over the facade goodFeaturesToTrack."""

    def __init__(self, maxCorners=1000, qualityLevel=0.01, minDistance=1,
                 blockSize=3, useHarrisDetector=False, k=0.04):
        self._args = (int(maxCorners), float(qualityLevel),
                      float(minDistance), int(blockSize),
                      bool(useHarrisDetector), float(k))

    def detect(self, image, mask=None):
        from . import goodFeaturesToTrack

        mc, ql, md, bs, harris, k = self._args
        a = image if isinstance(image, torch.Tensor) else _a(image)
        if a.ndim == 3:
            from . import cvtColor
            a = cvtColor(a, _C.COLOR_BGR2GRAY)
        pts = goodFeaturesToTrack(a, mc, ql, md, mask=mask, blockSize=bs,
                                  useHarrisDetector=harris, k=k)
        if pts is None:
            return []
        return [KeyPoint(float(x), float(y), float(bs))
                for x, y in pts.reshape(-1, 2)]

    @staticmethod
    def create(*a, **kw):
        return GFTTDetector(*a, **kw)


def GFTTDetector_create(*a, **kw):
    return GFTTDetector(*a, **kw)


class GeneralizedHough:
    """Base of GeneralizedHoughBallard / Guil (see _algos.py)."""


class StereoMatcher:
    DISP_SHIFT = 4
    DISP_SCALE = 16

    def compute(self, left, right, disparity=None):
        raise NotImplementedError


class BackgroundSubtractor:
    def apply(self, image, fgmask=None, learningRate=-1):
        raise NotImplementedError

    def getBackgroundImage(self, backgroundImage=None):
        raise NotImplementedError


def FlannBasedMatcher_create():
    from ._algos import FlannBasedMatcher

    return FlannBasedMatcher()


class GraphicalCodeDetector:
    """Base role of QRCodeDetector / BarcodeDetector."""

    def detect(self, img, points=None):
        raise NotImplementedError

    def decode(self, img, points, straight_code=None):
        raise NotImplementedError

    def detectAndDecode(self, img, points=None, straight_code=None):
        raise NotImplementedError


class IStreamReader:
    """cv2.IStreamReader role: file-like adapter for stream captures."""

    def read(self, size):
        raise NotImplementedError

    def seek(self, offset, origin):
        raise NotImplementedError


# ------------------------------------------------------------------- EMD

def EMD(signature1, signature2, distType, cost=None, lowerBound=None,
        flow=None):
    from ..ops.emd import emd as _emd

    names = {_C.DIST_L1: "l1", _C.DIST_L2: "l2", _C.DIST_C: "linf"}
    c = None if cost is None else _a(cost, np.float64)
    if distType == _C.DIST_USER and c is None:
        raise ValueError("EMD: DIST_USER needs a cost matrix")
    kind = names.get(int(distType), "l2")
    val, fl = _emd(_a(signature1, np.float64),
                   _a(signature2, np.float64), kind, c,
                   return_flow=True)
    return float(val), None, _a(fl, np.float32)


# ---------------------------------------------------- Hough accumulator

def HoughLinesWithAccumulator(image, rho, theta, threshold, lines=None,
                              srn=0, stn=0, min_theta=0,
                              max_theta=np.pi):
    from ..ops.hough import hough_lines_numpy

    n_thetas = max(int(round(np.pi / theta)), 1)
    a = _a(image)
    if a.ndim == 3:
        a = a[..., 0]
    image = a
    diag = float(np.hypot(*a.shape[:2]))
    rho_bins = max(int(np.ceil(2 * diag / rho)) | 1, 3)
    ls, votes = hough_lines_numpy(_a(image), n_thetas=n_thetas,
                                  rho_bins=rho_bins, threshold=threshold,
                                  max_lines=4096)
    if len(ls) == 0:
        return None
    out = np.concatenate([_a(ls, np.float32),
                          _a(votes, np.float32).reshape(-1, 1)],
                         axis=1)
    return out.reshape(-1, 1, 3)


def HoughCirclesWithAccumulator(image, method, dp, minDist, circles=None,
                                param1=100, param2=100, minRadius=0,
                                maxRadius=0):
    from ..ops.hough import hough_circles_numpy

    cs, votes = hough_circles_numpy(
        _a(image), dp=max(int(dp), 1),
        min_radius=max(int(minRadius), 1),
        max_radius=int(maxRadius) if maxRadius > 0 else 60,
        edge_threshold=int(param1), vote_threshold=int(param2))
    if len(cs) == 0:
        return None
    out = np.concatenate([_a(cs, np.float32),
                          _a(votes, np.float32).reshape(-1, 1)],
                         axis=1)
    return out.reshape(1, -1, 4)


def HoughLinesPointSet(point, lines_max, threshold, min_rho, max_rho,
                       rho_step, min_theta, max_theta, theta_step,
                       lines=None):
    """Standard Hough over a sparse point set → (N, 1, 3)
    [votes, rho, theta], strongest first (cv2 layout)."""
    pts = _a(point, np.float64).reshape(-1, 2)
    thetas = np.arange(min_theta, max_theta, theta_step)
    rhos = pts[:, 0:1] * np.cos(thetas)[None] \
        + pts[:, 1:2] * np.sin(thetas)[None]
    ri = np.round((rhos - min_rho) / rho_step).astype(np.int64)
    n_r = int(np.floor((max_rho - min_rho) / rho_step)) + 1
    acc = np.zeros((n_r, len(thetas)), np.int64)
    valid = (ri >= 0) & (ri < n_r)
    for p in range(len(pts)):
        acc[ri[p][valid[p]], np.nonzero(valid[p])[0]] += 1
    ys, xs = np.nonzero(acc >= threshold)
    votes = acc[ys, xs]
    order = np.argsort(-votes, kind="stable")[:int(lines_max)]
    out = np.stack([votes[order].astype(np.float64),
                    min_rho + ys[order] * rho_step,
                    thetas[xs[order]]], axis=1).astype(np.float64)
    return out.reshape(-1, 1, 3)


# -------------------------------------------------------------------- MST

class MSTEdge:
    def __init__(self, source=0, target=0, weight=0.0):
        self.source = int(source)
        self.target = int(target)
        self.weight = float(weight)

    def __repr__(self):
        return f"MSTEdge({self.source}, {self.target}, {self.weight})"


def buildMST(numNodes, inputEdges, algorithm=0, root=0):
    """Kruskal MST (negative weights fine) → (True, [MSTEdge...]);
    (False, []) when the graph cannot be spanned."""
    n = int(numNodes)
    edges = []
    for e in inputEdges:
        if isinstance(e, MSTEdge):
            s, t, w = e.source, e.target, e.weight
        else:
            s, t, w = int(e[0]), int(e[1]), float(e[2])
        if s != t:
            edges.append((w, s, t))
    edges.sort()
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for w, s, t in edges:
        rs, rt = find(s), find(t)
        if rs != rt:
            parent[rs] = rt
            out.append(MSTEdge(s, t, w))
    ok = len(out) == n - 1
    return ok, out if ok else []


# ------------------------------------------------------------- small fns

def broadcast(src, shape, dst=None):
    tgt = tuple(int(v) for v in _a(shape).ravel())
    return np.ascontiguousarray(np.broadcast_to(_a(src), tgt))


def getDefaultAlgorithmHint():
    return _C.ALGO_HINT_ACCURATE


def filter2Dp(src, kernel, dst=None, anchorX=-1, anchorY=-1,
              borderType=4, ddepth=-1, scale=1.0, shift=0.0):
    """cv2 5's parameterized filter2D: same correlation core with a
    post scale + shift."""
    from . import filter2D

    out = filter2D(src, _C.CV_64F, kernel, anchor=(anchorX, anchorY),
                   borderType=borderType)
    out = out * float(scale) + float(shift)
    from . import _sat

    return _sat(out, ddepth, _a(src).dtype)


def projectPointsSepJ(objectPoints, rvec, tvec, cameraMatrix, distCoeffs,
                      imagePoints=None, dpdr=None, dpdt=None, dpdf=None,
                      dpdc=None, dpdk=None, dpdo=None, aspectRatio=0):
    """projectPoints with separated numeric jacobians (dr, dt, df, dc,
    dk, dobj)."""
    from ..ops.calib import project_points

    obj = _a(objectPoints, np.float64).reshape(-1, 3)
    K = _a(cameraMatrix, np.float64)
    dist = np.zeros(5) if distCoeffs is None \
        else _a(distCoeffs, np.float64).ravel()
    rv = _a(rvec, np.float64).ravel()
    tv = _a(tvec, np.float64).ravel()

    def f(rv_, tv_, K_, dist_, obj_):
        return project_points(obj_, rv_, tv_, K_, dist_).ravel()

    base = f(rv, tv, K, dist, obj)
    n = len(base)
    eps = 1e-7

    def num_jac(wrt, apply):
        J = np.empty((n, len(wrt)))
        for j in range(len(wrt)):
            d = np.zeros(len(wrt))
            d[j] = eps
            J[:, j] = (apply(wrt + d) - apply(wrt - d)) / (2 * eps)
        return J

    Jr = num_jac(rv, lambda v: f(v, tv, K, dist, obj))
    Jt = num_jac(tv, lambda v: f(rv, v, K, dist, obj))

    def with_f(v):
        K2 = K.copy()
        K2[0, 0], K2[1, 1] = v
        return f(rv, tv, K2, dist, obj)

    Jf = num_jac(np.array([K[0, 0], K[1, 1]]), with_f)

    def with_c(v):
        K2 = K.copy()
        K2[0, 2], K2[1, 2] = v
        return f(rv, tv, K2, dist, obj)

    Jc = num_jac(np.array([K[0, 2], K[1, 2]]), with_c)
    Jk = num_jac(dist, lambda v: f(rv, tv, K, v, obj))
    Jo = num_jac(obj.ravel(), lambda v: f(rv, tv, K, dist,
                                          v.reshape(-1, 3)))
    return (base.reshape(-1, 1, 2), Jr, Jt, Jf, Jc, Jk, Jo)


def findTransformECCWithMask(templateImage, inputImage, warpMatrix=None,
                             motionType=2, criteria=None, inputMask=None,
                             gaussFiltSize=5):
    from ._calib3d import findTransformECC

    if inputMask is not None and _a(inputMask).size \
            and not _a(inputMask).all():
        raise NotImplementedError(
            "findTransformECCWithMask: partial masks unsupported; "
            "use findTransformECC on a cropped region instead")
    return findTransformECC(templateImage, inputImage, warpMatrix,
                            motionType, criteria, None)


class FontFace:
    """cv2.FontFace role: named font handle (we render with the vendored
    DejaVuSans; the name is kept for API compatibility)."""

    def __init__(self, fontPathOrName=""):
        self._name = str(fontPathOrName)

    def getName(self):
        return self._name

    def set(self, fontPathOrName):
        self._name = str(fontPathOrName)
        return True


# --------------------------------------------------------- param holders

class OdometrySettings:
    def __init__(self):
        self._k = None

    def setCameraMatrix(self, K):
        self._k = _a(K, np.float64)

    def getCameraMatrix(self):
        return self._k


class OdometryFrame:
    def __init__(self, depth=None, image=None, mask=None):
        self.depth = depth
        self.image = image
        self.mask = mask


class VolumeSettings:
    def __init__(self, volumeType=0):
        self.volumeType = int(volumeType)
        self._resolution = (128, 128, 128)
        self._voxel = 0.02
        self._k = None

    def setVolumeResolution(self, r):
        self._resolution = tuple(int(v) for v in _a(r).ravel())

    def getVolumeResolution(self):
        return self._resolution

    def setVoxelSize(self, v):
        self._voxel = float(v)

    def getVoxelSize(self):
        return self._voxel

    def setCameraIntegrateIntrinsics(self, K):
        self._k = _a(K, np.float64)


class CirclesGridFinderParameters:
    def __init__(self):
        self.densityNeighborhoodSize = (16.0, 16.0)
        self.minDensity = 10.0
        self.kmeansAttempts = 100
        self.minDistanceToAddKeypoint = 20
        self.keypointScale = 1
        self.minGraphConfidence = 9.0
        self.vertexGain = 1.0
        self.vertexPenalty = -0.6
        self.existingVertexGain = 10000.0
        self.edgeGain = 1.0
        self.edgePenalty = -0.6
        self.convexHullFactor = 1.1
        self.minRNGEdgeSwitchDist = 5.0


class ECCParameters:
    def __init__(self):
        self.motionType = 2
        self.maxCount = 50
        self.epsilon = 1e-6
        self.gaussFiltSize = 5


def QRCodeEncoder_Params():
    from ._algos import QRCodeEncoder

    return QRCodeEncoder.Params()


class QRCodeDetectorAruco_Params:
    def __init__(self):
        self.minModuleSizeInPyramid = 4.0
        self.maxRotation = 0.17
        self.maxModuleSizeMismatch = 1.75
        self.maxTimingPatternMismatch = 2.0
        self.maxPenalties = 0.4
        self.maxColorsMismatch = 0.2
        self.scaleTimingPatternScore = 0.9


# ----------------------------------------------- dnn-model-gated guards

def _dnn_guard(name, alt):
    class _Params:
        pass

    class _Guard:
        def __init__(self, *a, **k):
            raise NotImplementedError(
                f"{name} requires a pretrained DNN model which rustcv_tpu_torch "
                f"does not ship (no bundled weights); use {alt} instead")

    _Guard.__name__ = name
    _Guard.Params = _Params
    return _Guard


TrackerDaSiamRPN = _dnn_guard("TrackerDaSiamRPN", "TrackerCSRT/TrackerKCF")
TrackerNano = _dnn_guard("TrackerNano", "TrackerCSRT/TrackerKCF")
TrackerVit = _dnn_guard("TrackerVit", "TrackerCSRT/TrackerKCF")
ALIKED = _dnn_guard("ALIKED", "SIFT/AKAZE")
DISK = _dnn_guard("DISK", "SIFT/AKAZE")
LightGlueMatcher = _dnn_guard("LightGlueMatcher", "BFMatcher")
FaceDetectorYN = _dnn_guard("FaceDetectorYN", "CascadeClassifier")
FaceRecognizerSF = _dnn_guard("FaceRecognizerSF", "ops/hog descriptors")


class TrackerDaSiamRPN_Params:
    pass


class TrackerNano_Params:
    pass


class TrackerVit_Params:
    pass


class ALIKED_Params:
    pass


def TrackerDaSiamRPN_create(*a, **k):
    return TrackerDaSiamRPN()


def TrackerNano_create(*a, **k):
    return TrackerNano()


def TrackerVit_create(*a, **k):
    return TrackerVit()


def ALIKED_create(*a, **k):
    return ALIKED()


def DISK_create(*a, **k):
    return DISK()


def DISK_createFromMemory(*a, **k):
    return DISK()


def LightGlueMatcher_create(*a, **k):
    return LightGlueMatcher()


def LightGlueMatcher_createFromMemory(*a, **k):
    return LightGlueMatcher()


def FaceDetectorYN_create(*a, **k):
    return FaceDetectorYN()


def FaceRecognizerSF_create(*a, **k):
    return FaceRecognizerSF()


# ------------------------------------------------- flat submodule aliases

def barcode_BarcodeDetector(*a, **k):
    from .barcode import BarcodeDetector

    return BarcodeDetector(*a, **k)


def mcc_CChecker(*a, **k):
    raise NotImplementedError(
        "mcc_CChecker instances come from mcc_CCheckerDetector.process")


def mcc_DetectorParametersMCC():
    from .mcc import DetectorParameters

    return DetectorParameters()


def aruco_ArucoDetector(*a, **k):
    from . import aruco

    return aruco.ArucoDetector(*a, **k)


def aruco_DetectorParameters(*a, **k):
    from . import aruco

    return aruco.DetectorParameters(*a, **k)


def aruco_Dictionary(*a, **k):
    from . import aruco

    return aruco.getPredefinedDictionary(*a, **k)


def aruco_Board(*a, **k):
    from . import aruco

    return aruco.Board(*a, **k)


def aruco_GridBoard(*a, **k):
    from . import aruco

    return aruco.GridBoard(*a, **k)


def aruco_CharucoBoard(*a, **k):
    from . import aruco

    return aruco.CharucoBoard(*a, **k)


def aruco_CharucoDetector(*a, **k):
    from . import aruco

    return aruco.CharucoDetector(*a, **k)


def aruco_CharucoParameters(*a, **k):
    from . import aruco

    return aruco.CharucoParameters(*a, **k)


def aruco_RefineParameters(*a, **k):
    from . import aruco

    return aruco.RefineParameters(*a, **k)


# ----------------------------------------------------- GUI (highgui role)

_trackbars = {}
_mouse_callbacks = {}
_window_props = {}


def createTrackbar(trackbarName, windowName, value, count, onChange):
    _trackbars[(windowName, trackbarName)] = {
        "value": int(value), "min": 0, "max": int(count),
        "callback": onChange}


def getTrackbarPos(trackbarName, windowName):
    tb = _trackbars.get((windowName, trackbarName))
    if tb is None:
        raise ValueError(f"no trackbar {trackbarName!r} on {windowName!r}")
    return tb["value"]


def setTrackbarPos(trackbarName, windowName, pos):
    tb = _trackbars.get((windowName, trackbarName))
    if tb is None:
        raise ValueError(f"no trackbar {trackbarName!r} on {windowName!r}")
    tb["value"] = int(np.clip(pos, tb["min"], tb["max"]))
    if tb["callback"] is not None:
        tb["callback"](tb["value"])


def setTrackbarMax(trackbarName, windowName, maxval):
    tb = _trackbars.get((windowName, trackbarName))
    if tb is not None:
        tb["max"] = int(maxval)
        tb["value"] = min(tb["value"], tb["max"])


def setTrackbarMin(trackbarName, windowName, minval):
    tb = _trackbars.get((windowName, trackbarName))
    if tb is not None:
        tb["min"] = int(minval)
        tb["value"] = max(tb["value"], tb["min"])


def setMouseCallback(windowName, onMouse, param=None):
    _mouse_callbacks[windowName] = (onMouse, param)


def setWindowProperty(winname, prop_id, prop_value):
    _window_props[(winname, int(prop_id))] = prop_value


def getWindowImageRect(winname):
    from .. import highgui as _hg

    shape = getattr(_hg, "last_shown_shape", lambda w: None)(winname)
    if shape is None:
        return (-1, -1, -1, -1)
    return (0, 0, shape[1], shape[0])


def startWindowThread():
    return 0  # our SDL window pumps events on waitKey, like cv2's GTK


def addText(img, text, org, nameFont, pointSize=-1, color=(0, 0, 0),
            weight=50, style=0, spacing=0):
    """Drawn in place: a tensor on its device, a numpy image on the host in
    a Mat over the caller's own bytes (as cv2 draws into it)."""
    from .. import imgproc as _ip

    m = _m(img) if isinstance(img, torch.Tensor) else _host_mat(img)
    _ip.put_text(m, str(text), _ip.Point(int(org[0]), int(org[1])),
                 max(pointSize, 12) / 22.0,
                 _ip.Scalar(*[int(c) for c in color[:3]]))
    if isinstance(img, torch.Tensor) or not np.shares_memory(m.array, img):
        _copyto(img, _o(m).reshape(img.shape))
    return img


def displayOverlay(winname, text, delayms=0):
    pass  # Qt status-overlay: a no-op on the SDL/sink backends


def displayStatusBar(winname, text, delayms=0):
    pass


def selectROI(windowName, img=None, showCrosshair=True,
              fromCenter=False, printNotice=True):
    raise NotImplementedError(
        "selectROI needs an interactive window; run with RUSTCV_GUI=sdl "
        "and use the mouse callbacks, or pass an explicit rect")


def selectROIs(windowName, img, showCrosshair=True, fromCenter=False,
               printNotice=True):
    raise NotImplementedError(
        "selectROIs needs an interactive window; run with RUSTCV_GUI=sdl "
        "and use the mouse callbacks, or pass explicit rects")


def bootstrap():
    return None  # cv2's loader shim; nothing to bootstrap here


def calibrateMultiview(*a, **k):
    raise NotImplementedError(
        "calibrateMultiview: use calibrateCamera per camera + "
        "registerCameras for the rig extrinsics")


calibrateMultiviewExtended = calibrateMultiview


# ---------------------------------------------- chromatic aberration

def _ca_basis(deg, xn, yn):
    """Monomial basis in cv2's order: graded degree, within each total
    degree x-power ascending — [1, y, x, y2, xy, x2, ...]; coordinates
    normalized to [-1, 1] about the image centre (measured against
    cv2 5.0 in tests/test_cv2_misc3b.py)."""
    terms = []
    for t in range(int(deg) + 1):
        for xi in range(t + 1):
            terms.append((xn ** xi) * (yn ** (t - xi)))
    return terms


def correctChromaticAberration(input_image, coefficients, image_size,
                               calib_degree, output_image=None,
                               bayer_pattern=0):
    """Per-channel polynomial warp removing lateral CA: row order in
    ``coefficients`` is [blue dx, blue dy, red dx, red dy]."""
    from . import remap

    img = _a(input_image)
    if img.ndim == 2:
        from . import demosaicing

        img = demosaicing(img, int(bayer_pattern))
    co = _a(coefficients, np.float64)
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (xs - w / 2.0) / (w / 2.0)
    yn = (ys - h / 2.0) / (h / 2.0)
    basis = _ca_basis(calib_degree, xn, yn)
    nb = len(basis)

    def shift(row):
        acc = np.zeros((h, w))
        for cix in range(min(nb, co.shape[1])):
            acc += co[row, cix] * basis[cix]
        return acc

    out = img.copy()
    for ch, (rx, ry) in ((0, (0, 1)), (2, (2, 3))):
        mapx = (xs - shift(rx)).astype(np.float32)
        mapy = (ys - shift(ry)).astype(np.float32)
        out[..., ch] = remap(img[..., ch], mapx, mapy, 1)
    return out


def loadChromaticAberrationParams(node, coeffMat=None):
    """Read CA calibration written by our FileStorage schema:
    map with `coefficients` (4xN matrix), `image_width`,
    `image_height`, `degree`."""
    coeff = node.getNode("coefficients").mat()
    w = int(node.getNode("image_width").real())
    h = int(node.getNode("image_height").real())
    deg = int(node.getNode("degree").real())
    return _a(coeff, np.float32), (w, h), deg


# ------------------------------------------------------------- buttons

_buttons = {}


def createButton(buttonName, onChange, userData=None, buttonType=0,
                 initialButtonState=0):
    _buttons[buttonName] = {"state": int(initialButtonState),
                            "callback": onChange, "user": userData,
                            "type": int(buttonType)}


_bind(globals())
