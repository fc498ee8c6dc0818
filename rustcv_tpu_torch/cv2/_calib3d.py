"""cv2 facade — calib3d / 3d-module extensions over the ops layer (the port
of ``rustcv_tpu.cv2._calib3d``).

Wrappers keep cv2's exact calling/return conventions; the math lives in
``rustcv_tpu_torch.ops.calib`` / ``calib_ext`` / ``epipolar`` / ``threed`` /
``ecc`` / ``circles_grid`` / ``nlmeans``, float64 host code. The image
calls that reach a device op (``checkChessboard``'s corner refinement,
``thresholdWithMask``'s and ``goodFeaturesToTrackWithQuality``'s facade
calls) run on the call's device (:mod:`._device`). Held call for call
against the reference in ``tests/test_torch_cv2_later_calls.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _constants as _C
from ._device import _a, _copyto, _t
from ._device import bind as _bind
from ..ops import calib as _calib
from ..ops import calib_ext as _cx
from ..ops import ecc as _ecc
from ..ops import epipolar as _epi
from ..ops import nlmeans as _nlm
from ..ops import threed as _3d

__all__ = [
    "composeRT", "matMulDeriv", "RQDecomp3x3", "decomposeProjectionMatrix",
    "calibrationMatrixValues", "sampsonDistance", "correctMatches",
    "solveCubic", "solvePoly",
    "estimateAffine3D", "estimateTranslation2D", "estimateTranslation3D",
    "initCameraMatrix2D", "stereoRectifyUncalibrated", "stereoCalibrate",
    "calibrateCameraExtended", "registerCameras",
    "initInverseRectificationMap", "filterHomographyDecompByVisibleRefpoints",
    "solveP3P", "solvePnPGeneric", "solvePnPRefineLM", "solvePnPRefineVVS",
    "undistortImagePoints",
    "reprojectImageTo3D", "filterSpeckles", "getValidDisparityROI",
    "validateDisparity",
    "computeECC", "findTransformECC", "findTransformECCMultiScale",
    "PCACompute2", "thresholdWithMask", "goodFeaturesToTrackWithQuality",
    "drawMatchesKnn", "fastNlMeansDenoisingMulti",
    "fastNlMeansDenoisingColoredMulti",
    "readOpticalFlow", "writeOpticalFlow",
    "findCirclesGrid", "estimateChessboardSharpness", "checkChessboard",
    "depthTo3d", "depthTo3dSparse", "findPlanes", "registerDepth",
    "warpFrame", "rescaleDepth", "rgbdNormals",
    "savePointCloud", "loadPointCloud", "saveMesh", "loadMesh",
]


def _col(v):
    return _a(v, np.float64).reshape(-1, 1)


# ------------------------------------------------------------ pose algebra

def composeRT(rvec1, tvec1, rvec2, tvec2, *out_args):
    """cv2.composeRT: (rvec3, tvec3) + the 8 jacobians
    d{r,t}3/d{r,t}{1,2} (numeric central differences, ≤1e-5 of cv2's
    analytic values — tested)."""
    rv3, tv3 = _cx.compose_rt(rvec1, tvec1, rvec2, tvec2)

    def f(r1, t1, r2, t2):
        r, t = _cx.compose_rt(r1, t1, r2, t2)
        return np.concatenate([_a(r).ravel(),
                               _a(t).ravel()])

    args = [_a(a, np.float64).ravel().copy()
            for a in (rvec1, tvec1, rvec2, tvec2)]
    jacs = []
    eps = 1e-7
    for ai in range(4):
        J = np.empty((6, 3))
        for k in range(3):
            p = [a.copy() for a in args]
            m = [a.copy() for a in args]
            p[ai][k] += eps
            m[ai][k] -= eps
            J[:, k] = (f(*p) - f(*m)) / (2 * eps)
        jacs.append(J)
    dr_blocks = [J[:3] for J in jacs]   # dr3/d{r1,t1,r2,t2}
    dt_blocks = [J[3:] for J in jacs]   # dt3/d{r1,t1,r2,t2}
    return (_col(rv3), _col(tv3), *dr_blocks, *dt_blocks)


def matMulDeriv(A, B, dABdA=None, dABdB=None):
    a = _a(A, np.float64)
    b = _a(B, np.float64)
    m, n = a.shape[0], b.shape[1]
    return np.kron(np.eye(m), b.T), np.kron(a, np.eye(n))


def _givens_rq3(m):
    """cv2's cvRQDecomp3x3: three Givens rotations triangularize M from
    the right; R upper-triangular with positive leading diagonal."""
    M = np.array(_a(m), np.float64)
    eps = np.finfo(np.float64).eps

    s, c = M[2, 1], M[2, 2]
    z = 1.0 / np.sqrt(c * c + s * s + eps)
    c, s = c * z, s * z
    Qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]], np.float64)
    R = M @ Qx

    s, c = -R[2, 0], R[2, 2]
    z = 1.0 / np.sqrt(c * c + s * s + eps)
    c, s = c * z, s * z
    Qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float64)
    M2 = R @ Qy

    s, c = M2[1, 0], M2[1, 1]
    z = 1.0 / np.sqrt(c * c + s * s + eps)
    c, s = c * z, s * z
    Qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float64)
    R = M2 @ Qz

    # diagonal-sign ambiguity (cv2: rotate 180° about z / y / x; the
    # Givens steps leave R11, R22 ≥ 0, so only the y branch is reachable)
    qz_report = Qz
    if R[0, 0] < 0:
        if R[1, 1] < 0:
            R[0, 0] *= -1; R[0, 1] *= -1; R[1, 1] *= -1  # noqa: E702
            Qz[0, 0] *= -1; Qz[0, 1] *= -1               # noqa: E702
            Qz[1, 0] *= -1; Qz[1, 1] *= -1               # noqa: E702
        else:
            R[0, 0] *= -1; R[0, 2] *= -1; R[1, 2] *= -1  # noqa: E702
            R[2, 2] *= -1                                 # noqa: E702
            Qy[0, 0] *= -1; Qy[0, 2] *= -1               # noqa: E702
            Qy[2, 0] *= -1; Qy[2, 2] *= -1               # noqa: E702
            qz_report = Qz.T  # cv2 reports the opposite-handed z rotation
    elif R[1, 1] < 0:
        R[0, 1] *= -1; R[0, 2] *= -1; R[1, 1] *= -1      # noqa: E702
        R[1, 2] *= -1; R[2, 2] *= -1                      # noqa: E702
        Qx[1, 1] *= -1; Qx[1, 2] *= -1                   # noqa: E702
        Qx[2, 1] *= -1; Qx[2, 2] *= -1                   # noqa: E702

    Q = qz_report.T @ Qy.T @ Qx.T
    euler = (
        np.degrees(np.arccos(np.clip(Qx[1, 1], -1, 1))
                   * (1 if Qx[1, 2] >= 0 else -1)),
        np.degrees(np.arccos(np.clip(Qy[0, 0], -1, 1))
                   * (1 if Qy[2, 0] >= 0 else -1)),
        np.degrees(np.arccos(np.clip(qz_report[0, 0], -1, 1))
                   * (1 if qz_report[0, 1] >= 0 else -1)),
    )
    return R, Q, Qx, Qy, qz_report, euler


def RQDecomp3x3(src, mtxR=None, mtxQ=None, Qx=None, Qy=None, Qz=None):
    R, Q, qx, qy, qz, euler = _givens_rq3(src)
    return euler, R, Q, qx, qy, qz


def decomposeProjectionMatrix(projMatrix, *out_args):
    P = _a(projMatrix, np.float64)
    R, Q, qx, qy, qz, euler = _givens_rq3(P[:, :3])
    # homogeneous camera centre: right null-vector of P (unit norm)
    _, _, vt = np.linalg.svd(P)
    t = vt[-1]
    return (R, Q, t.reshape(4, 1), qx, qy, qz,
            _a(euler, np.float64).reshape(3, 1))


def calibrationMatrixValues(cameraMatrix, imageSize, apertureWidth,
                            apertureHeight):
    return _cx.calibration_matrix_values(cameraMatrix, imageSize,
                                         apertureWidth, apertureHeight)


def sampsonDistance(pt1, pt2, F):
    return _cx.sampson_distance(pt1, pt2, F)


def correctMatches(F, points1, points2, newPoints1=None, newPoints2=None):
    p1 = _a(points1, np.float64)
    p2 = _a(points2, np.float64)
    o1, o2 = _epi.correct_matches(F, p1.reshape(-1, 2), p2.reshape(-1, 2))
    return (o1.reshape(p1.shape).astype(p1.dtype),
            o2.reshape(p2.shape).astype(p2.dtype))


# --------------------------------------------------------- root finding

def solveCubic(coeffs, roots=None):
    c = _a(coeffs, np.float64).ravel()
    if len(c) == 4 and c[0] == 0:
        c = c[1:]
    if len(c) == 3 and c[0] == 0:
        c = c[1:]
    if len(c) <= 1 or c[0] == 0:
        return 0, np.zeros((3, 1))
    r = np.roots(c)
    real = np.sort(r[np.abs(r.imag) <= 1e-9 * np.maximum(np.abs(r.real), 1)]
                   .real)
    out = np.zeros(3)
    out[:len(real)] = real[:3]
    return len(real), out.reshape(3, 1)


def solvePoly(coeffs, roots=None, maxIters=300):
    c = _a(coeffs, np.float64).ravel()  # lowest-degree first
    r = np.roots(c[::-1])
    out = np.stack([r.real, r.imag], axis=-1)[:, None, :]
    return 0.0, out


# ------------------------------------------------------ point-set fitting

def estimateAffine3D(src, dst, out=None, inliers=None,
                     ransacThreshold=3.0, confidence=0.99):
    ret, A, inl = _calib.estimate_affine_3d(
        _a(src), _a(dst), ransac_thresh=float(ransacThreshold),
        confidence=float(confidence))
    return ret, A, _a(inl, np.uint8).reshape(-1, 1)


def estimateTranslation2D(src, dst, inliers=None, method=8,
                          ransacReprojThreshold=3.0, maxIters=2000,
                          confidence=0.99, refineIters=10):
    t, inl = _cx.estimate_translation_2d(_a(src), _a(dst),
                                         float(ransacReprojThreshold))
    return t.reshape(1, 2), _a(inl, np.uint8).reshape(-1, 1)


def estimateTranslation3D(src, dst, out=None, inliers=None,
                          ransacThreshold=3.0, confidence=0.99):
    t, inl = _cx.estimate_translation_3d(_a(src), _a(dst), float(ransacThreshold))
    return 1, t.reshape(3, 1), _a(inl, np.uint8).reshape(-1, 1)


# ----------------------------------------------------------- calibration

def initCameraMatrix2D(objectPoints, imagePoints, imageSize,
                       aspectRatio=1.0):
    return _cx.init_camera_matrix_2d(objectPoints, imagePoints,
                                     imageSize, aspectRatio)


def stereoRectifyUncalibrated(points1, points2, F, imgSize, H1=None,
                              H2=None, threshold=5.0):
    return _cx.stereo_rectify_uncalibrated(points1, points2, F, imgSize,
                                           threshold)


def stereoCalibrate(objectPoints, imagePoints1, imagePoints2,
                    cameraMatrix1, distCoeffs1, cameraMatrix2, distCoeffs2,
                    imageSize, R=None, T=None, E=None, F=None,
                    flags=0, criteria=None):
    d1 = np.zeros(5) if distCoeffs1 is None else distCoeffs1
    d2 = np.zeros(5) if distCoeffs2 is None else distCoeffs2
    rms, R_, T_, E_, F_ = _calib.stereo_calibrate(
        list(objectPoints), list(imagePoints1), list(imagePoints2),
        _a(cameraMatrix1, np.float64), d1,
        _a(cameraMatrix2, np.float64), d2)
    return (rms, _a(cameraMatrix1, np.float64), _a(d1),
            _a(cameraMatrix2, np.float64), _a(d2),
            R_, T_.reshape(3, 1), E_, F_)


def calibrateCameraExtended(objectPoints, imagePoints, imageSize,
                            cameraMatrix=None, distCoeffs=None, rvecs=None,
                            tvecs=None, stdDeviationsIntrinsics=None,
                            stdDeviationsExtrinsics=None,
                            perViewErrors=None, flags=0, criteria=None):
    rms, k, dist, rv, tv, std_i, pve = _cx.calibrate_camera_extended(
        list(objectPoints), list(imagePoints), imageSize)
    std_int = np.zeros(18)
    std_int[:len(std_i)] = std_i
    return (rms, k, dist.reshape(1, -1), [r.reshape(3, 1) for r in rv],
            [t.reshape(3, 1) for t in tv], std_int.reshape(-1, 1),
            np.zeros((6 * len(rv), 1)), _a(pve).reshape(-1, 1))


def registerCameras(objectPoints1, objectPoints2, imagePoints1,
                    imagePoints2, cameraMatrix1, distCoeffs1,
                    cameraMatrix2, distCoeffs2, *a, **k):
    return _cx.register_cameras(objectPoints1, imagePoints1, imagePoints2,
                                cameraMatrix1, distCoeffs1, cameraMatrix2,
                                distCoeffs2)


def initInverseRectificationMap(cameraMatrix, distCoeffs, R, newCameraMatrix,
                                size, m1type=None, map1=None, map2=None):
    if R is not None and not np.allclose(_a(R, np.float64),
                                         np.eye(3)):
        raise NotImplementedError(
            "initInverseRectificationMap: only R=None/identity supported")
    return _cx.init_inverse_rectification_map(
        cameraMatrix, distCoeffs if distCoeffs is not None else np.zeros(5),
        newCameraMatrix, size)


def filterHomographyDecompByVisibleRefpoints(rotations, normals,
                                             beforePoints, afterPoints,
                                             possibleSolutions=None,
                                             pointsMask=None):
    return _cx.filter_homography_decomp_by_visible_refpoints(
        rotations, normals, beforePoints, afterPoints).reshape(-1, 1)


# ------------------------------------------------------------------- PnP

def solveP3P(objectPoints, imagePoints, cameraMatrix, distCoeffs, flags=0,
             rvecs=None, tvecs=None):
    dist = np.zeros(5) if distCoeffs is None else _a(distCoeffs)
    sols = _cx.solve_p3p(objectPoints, imagePoints,
                         _a(cameraMatrix, np.float64), dist)
    rv = [_col(r) for r, _ in sols]
    tv = [_col(t) for _, t in sols]
    return len(sols), rv, tv


def solvePnPGeneric(objectPoints, imagePoints, cameraMatrix, distCoeffs,
                    rvecs=None, tvecs=None, useExtrinsicGuess=False,
                    flags=0, rvec=None, tvec=None, reprojectionError=None):
    dist = np.zeros(5) if distCoeffs is None else _a(distCoeffs)
    n, sols, errs = _cx.solve_pnp_generic(
        objectPoints, imagePoints, _a(cameraMatrix, np.float64),
        dist)
    return (n, [_col(r) for r, _ in sols], [_col(t) for _, t in sols],
            _a(errs, np.float64).reshape(-1, 1))


def solvePnPRefineLM(objectPoints, imagePoints, cameraMatrix, distCoeffs,
                     rvec, tvec, criteria=None):
    dist = np.zeros(5) if distCoeffs is None else _a(distCoeffs)
    rv, tv = _calib.refine_pose(
        _a(objectPoints, np.float64).reshape(-1, 3),
        _a(imagePoints, np.float64).reshape(-1, 2),
        _a(cameraMatrix, np.float64), dist,
        _a(rvec, np.float64).ravel(),
        _a(tvec, np.float64).ravel())
    return _col(rv), _col(tv)


solvePnPRefineVVS = solvePnPRefineLM  # same minimum, different damping


def undistortImagePoints(src, cameraMatrix, distCoeffs, dst=None,
                         arg1=None):
    a = _a(src, np.float64)
    K = _a(cameraMatrix, np.float64)
    out = _calib.undistort_points(a.reshape(-1, 2), K, distCoeffs,
                                  new_K=K)
    return out.reshape(a.shape).astype(_a(src).dtype)


# ------------------------------------------------------------ stereo/depth

def reprojectImageTo3D(disparity, Q, _3dImage=None,
                       handleMissingValues=False, ddepth=-1):
    out = _calib.reproject_image_to_3d(_a(disparity), Q)
    return _a(out, np.float32)


def filterSpeckles(img, newVal, maxSpeckleSize, maxDiff, buf=None):
    a = _a(img)
    out = _cx.filter_speckles(a, newVal,
                              int(maxSpeckleSize), float(maxDiff))
    _copyto(img, out.astype(a.dtype))
    return img, None


def getValidDisparityROI(roi1, roi2, minDisparity, numberOfDisparities,
                         blockSize):
    sw2 = int(blockSize) // 2
    max_d = int(minDisparity) + int(numberOfDisparities) - 1
    xmin = max(roi1[0], roi2[0] + max_d) + sw2
    xmax = min(roi1[0] + roi1[2], roi2[0] + roi2[2]) - sw2
    ymin = max(roi1[1], roi2[1]) + sw2
    ymax = min(roi1[1] + roi1[3], roi2[1] + roi2[3]) - sw2
    r = (xmin, ymin, xmax - xmin, ymax - ymin)
    return r if r[2] > 0 and r[3] > 0 else (0, 0, 0, 0)


def validateDisparity(disparity, cost, minDisparity, numberOfDisparities,
                      disp12MaxDisp=1):
    """Left-right consistency check from the cost volume slice
    (port of cv2's validateDisparity; disparity CV_16S, scaled by 16)."""
    disp = _a(disparity) if isinstance(disparity, torch.Tensor) else disparity
    c = _a(cost)
    rows, cols = disp.shape
    min_d = int(minDisparity)
    max_d = min_d + int(numberOfDisparities)
    min_x1, max_x1 = max(max_d, 0), cols + min(min_d, 0)
    INVALID = (min_d - 1) * 16
    max_diff = int(disp12MaxDisp) * 16
    INT_MAX = np.iinfo(np.int64).max
    for y in range(rows):
        d2 = np.full(cols, INVALID, np.int64)
        d2c = np.full(cols, INT_MAX, np.int64)
        for x in range(min_x1, max_x1):
            d = int(disp[y, x])
            if d == INVALID:
                continue
            x2 = x - ((d + 8) >> 4)
            if 0 <= x2 < cols and d2c[x2] > c[y, x]:
                d2c[x2] = c[y, x]
                d2[x2] = d
        for x in range(min_x1, max_x1):
            d = int(disp[y, x])
            if d == INVALID:
                continue
            x0 = x - (d >> 4)
            x1 = x - ((d + 15) >> 4)
            bad0 = (0 <= x0 < cols and d2[x0] > INVALID
                    and abs(d2[x0] - d) > max_diff)
            bad1 = (0 <= x1 < cols and d2[x1] > INVALID
                    and abs(d2[x1] - d) > max_diff)
            if bad0 and bad1:
                disp[y, x] = INVALID
    if disp is not disparity:  # a tensor: written where it lives
        _copyto(disparity, disp)
    return disparity


# --------------------------------------------------------------------- ECC

_MOTION_NAMES = {0: "translation", 1: "euclidean", 2: "affine",
                 3: "homography"}


def computeECC(templateImage, inputImage, inputMask=None):
    if inputMask is not None:
        raise NotImplementedError("computeECC: inputMask unsupported")
    return _ecc.compute_ecc(_a(templateImage, np.float64),
                            _a(inputImage, np.float64))


def findTransformECC(templateImage, inputImage, warpMatrix=None,
                     motionType=2, criteria=None, inputMask=None,
                     gaussFiltSize=None):
    if inputMask is not None:
        raise NotImplementedError("findTransformECC: inputMask unsupported")
    iters, eps = 50, 1e-6
    if criteria is not None:
        _, iters, eps = criteria
    motion = _MOTION_NAMES[int(motionType)]
    warp = None if warpMatrix is None else _a(warpMatrix,
                                                      np.float64)
    rho, W = _ecc.find_transform_ecc(
        _a(templateImage, np.float64),
        _a(inputImage, np.float64), motion, warp,
        int(iters), float(eps))
    Wf = _a(W, np.float32)
    if warpMatrix is not None and Wf.shape == _a(warpMatrix).shape:
        _copyto(warpMatrix, Wf.astype(_a(warpMatrix).dtype))
    return rho, Wf


def findTransformECCMultiScale(templateImage, inputImage, warpMatrix=None,
                               motionType=2, criteria=None, inputMask=None,
                               maxPyrLevel=3):
    iters, eps = 50, 1e-6
    if criteria is not None:
        _, iters, eps = criteria
    motion = _MOTION_NAMES[int(motionType)]
    # ops signature: (template, image, motion, levels, iterations, eps)
    # — it derives its own initial warp per level; warpMatrix only
    # selects the motion model's shape (r5 call-coverage fix: the old
    # code passed the warp matrix into the `levels` slot)
    rho, W = _ecc.find_transform_ecc_multiscale(
        _a(templateImage, np.float64),
        _a(inputImage, np.float64), motion,
        int(maxPyrLevel), int(iters), float(eps))
    return rho, _a(W, np.float32)


# ---------------------------------------------------------------- misc 2d

def PCACompute2(data, mean, eigenvectors=None, eigenvalues=None,
                maxComponents=0, retainedVariance=None):
    a = _a(data, np.float64)
    mu = a.mean(axis=0, keepdims=True)
    x = a - mu
    cov = x.T @ x / a.shape[0]
    w, v = np.linalg.eigh(cov)
    order = np.argsort(w)[::-1]
    w, v = w[order], v[:, order].T  # rows are eigenvectors (cv2 layout)
    if retainedVariance is not None and 0 < retainedVariance < 1:
        frac = np.cumsum(w) / max(w.sum(), 1e-300)
        keep = int(np.searchsorted(frac, retainedVariance) + 1)
        w, v = w[:keep], v[:keep]
    elif maxComponents and maxComponents > 0:
        w, v = w[:maxComponents], v[:maxComponents]
    dt = _a(data).dtype
    dt = np.float64 if dt == np.float64 else np.float64
    return (mu.astype(dt), v.astype(dt), w.reshape(-1, 1).astype(dt))


def thresholdWithMask(src, dst, mask, thresh, maxval, type):
    from . import threshold  # facade threshold (cv2-exact)

    ret, t = threshold(src, thresh, maxval, type)
    if mask is None or _a(mask).size == 0:
        return ret, t
    m = _a(mask) != 0
    if dst is None:
        raise ValueError("thresholdWithMask: dst required with a mask")
    d = _a(dst)
    out = np.where(m, t, d)
    _copyto(dst, out.astype(d.dtype))
    return ret, dst


def goodFeaturesToTrackWithQuality(image, maxCorners, qualityLevel,
                                   minDistance, mask=None, corners=None,
                                   blockSize=3, gradientSize=3,
                                   useHarrisDetector=False, k=0.04):
    from . import cornerHarris, cornerMinEigenVal, goodFeaturesToTrack

    pts = goodFeaturesToTrack(image, maxCorners, qualityLevel, minDistance,
                              mask=mask, blockSize=blockSize,
                              useHarrisDetector=useHarrisDetector, k=k)
    if pts is None or len(pts) == 0:
        return None, np.zeros((0,), np.float32)
    if useHarrisDetector:
        q = cornerHarris(image, blockSize, gradientSize, k)
    else:
        q = cornerMinEigenVal(image, blockSize, gradientSize)
    xy = pts.reshape(-1, 2).astype(np.int64)
    quality = _a(q)[xy[:, 1], xy[:, 0]].astype(np.float32)
    return pts, quality


def drawMatchesKnn(img1, keypoints1, img2, keypoints2, matches1to2,
                   outImg=None, matchColor=None, singlePointColor=None,
                   matchesMask=None, flags=0):
    from ._classes import drawMatches

    flat = []
    masks = []
    for i, group in enumerate(matches1to2):
        for j, m in enumerate(group):
            keep = 1
            if matchesMask is not None:
                keep = matchesMask[i][j] if matchesMask[i] else 0
            flat.append(m)
            masks.append(keep)
    kept = [m for m, ok in zip(flat, masks) if ok]
    return drawMatches(img1, keypoints1, img2, keypoints2, kept, outImg,
                       matchColor=matchColor,
                       singlePointColor=singlePointColor, flags=flags)


def fastNlMeansDenoisingMulti(srcImgs, imgToDenoiseIndex,
                              temporalWindowSize, dst=None, h=3,
                              templateWindowSize=7, searchWindowSize=21):
    stack = np.stack([_a(f) for f in srcImgs])
    return _nlm.nl_means_multi_numpy(stack, int(imgToDenoiseIndex),
                                     int(temporalWindowSize), float(h),
                                     int(templateWindowSize),
                                     int(searchWindowSize))


def fastNlMeansDenoisingColoredMulti(srcImgs, imgToDenoiseIndex,
                                     temporalWindowSize, dst=None, h=3,
                                     hColor=3, templateWindowSize=7,
                                     searchWindowSize=21):
    stack = np.stack([_a(f) for f in srcImgs])
    return _nlm.nl_means_colored_multi_numpy(
        stack, int(imgToDenoiseIndex), int(temporalWindowSize), float(h),
        float(hColor), int(templateWindowSize), int(searchWindowSize))


def readOpticalFlow(path):
    return _cx.read_optical_flow(path)


def writeOpticalFlow(path, flow):
    return _cx.write_optical_flow(path, flow)


# --------------------------------------------------------- pattern finding

def findCirclesGrid(image, patternSize, centers=None, flags=1,
                    blobDetector=None, parameters=None):
    from ..ops.circles_grid import find_circles_grid

    a = _a(image)
    if a.ndim == 3:
        from . import cvtColor
        a = cvtColor(a, _C.COLOR_BGR2GRAY)
    asym = bool(int(flags) & _C.CALIB_CB_ASYMMETRIC_GRID)
    ok, pts = find_circles_grid(a, (int(patternSize[0]),
                                    int(patternSize[1])), asymmetric=asym)
    if not ok:
        return False, None
    return True, _a(pts, np.float32).reshape(-1, 1, 2)


def estimateChessboardSharpness(image, patternSize, corners,
                                rise_distance=0.8, vertical=False,
                                sharpness=None):
    from ..ops.chessboard import estimate_chessboard_sharpness

    a = _a(image)
    if a.ndim == 3:
        from . import cvtColor
        a = cvtColor(a, _C.COLOR_BGR2GRAY)
    s, avg_min, avg_max = estimate_chessboard_sharpness(
        a, (int(patternSize[0]), int(patternSize[1])),
        _a(corners, np.float64).reshape(-1, 2), rise_distance)
    return (s, avg_min, avg_max, 0.0)


def checkChessboard(img, size):
    from ..ops.chessboard import find_chessboard_corners

    a = _a(img)
    if a.ndim == 3:
        from . import cvtColor
        a = cvtColor(a, _C.COLOR_BGR2GRAY)
    # the refinement is a device op: on the call's device
    ok, _ = find_chessboard_corners(_t(a), (int(size[0]), int(size[1])))
    return bool(ok)


# ------------------------------------------------------------ 3d module

def depthTo3d(depth, K, mask=None):
    pts = _3d.depth_to_3d(_a(depth, np.float64), K)
    return _a(pts, np.float32)


def depthTo3dSparse(depth, in_K, in_points, points3d=None):
    p = _a(in_points, np.float64).reshape(-1, 2)
    d = _a(depth, np.float64)
    xi = np.clip(p[:, 0].astype(np.int64), 0, d.shape[1] - 1)
    yi = np.clip(p[:, 1].astype(np.int64), 0, d.shape[0] - 1)
    out = _3d.depth_to_3d_sparse(p, d[yi, xi], in_K)
    return _a(out, np.float32).reshape(-1, 1, 3)


def findPlanes(points3d, normals=None, blockSize=200, *a, **k):
    labels, planes = _3d.find_planes(_a(points3d, np.float64),
                                     min_size=int(blockSize))
    return labels, planes


def registerDepth(unregisteredCameraMatrix, registeredCameraMatrix,
                  registeredDistCoeffs, Rt, unregisteredDepth,
                  outputImagePlaneSize, registeredDepth=None,
                  depthDilation=False):
    out = _3d.register_depth(unregisteredCameraMatrix,
                             registeredCameraMatrix, Rt,
                             _a(unregisteredDepth),
                             outputImagePlaneSize)
    return _a(out)


def warpFrame(depth, image, mask, Rt, cameraMatrix, distCoeff=None,
              warpedDepth=None, warpedImage=None, warpedMask=None):
    wd, wi, wm = _3d.warp_frame(_a(depth),
                                None if image is None else _a(image),
                                Rt, cameraMatrix)
    return wd, wi, wm


def rescaleDepth(in_, type=None, depth_factor=1000.0, out=None):
    return _3d.rescale_depth(_a(in_), float(depth_factor))


def rgbdNormals(points3d):
    return _a(_3d.rgbd_normals_numpy(
        _a(points3d, np.float64)), np.float32)


def savePointCloud(filename, vertices, normals=None, rgb=None):
    _3d.save_point_cloud(filename,
                         _a(vertices, np.float64).reshape(-1, 3))


def loadPointCloud(filename, vertices=None, normals=None, rgb=None):
    pts = _3d.load_point_cloud(filename)
    return _a(pts, np.float32).reshape(-1, 1, 3), None, None


def saveMesh(filename, vertices, indices, normals=None, rgb=None,
             texCoords=None):
    v = _a(vertices, np.float64).reshape(-1, 3)
    _3d.save_mesh(filename, v, _a(indices, np.int64).reshape(-1, 3))


def loadMesh(filename, vertices=None, indices=None, *a, **k):
    v, f = _3d.load_mesh(filename)
    return (_a(v, np.float32).reshape(-1, 1, 3),
            [_a(x, np.int32) for x in f])


_bind(globals())
