"""cv2.fisheye — equidistant-distortion camera model over
rustcv_tpu_torch.ops.calib's fisheye_* functions (the port of
``rustcv_tpu.cv2.fisheye``). The point functions and the calibration are
float64 host code; ``undistortImage`` is the device remap on the call's
device (a numpy image goes to the card).

Model (OpenCV fisheye, Kannala-Brandt): theta_d = theta (1 + k1 th^2 +
k2 th^4 + k3 th^6 + k4 th^8).  Held call for call against the
reference in tests/test_torch_cv2_later_calls.py.
"""
from __future__ import annotations

import numpy as np

from ._device import _a, _t
from ._device import bind as _bind
from ..ops import calib as _calib

CALIB_USE_INTRINSIC_GUESS = 1
CALIB_RECOMPUTE_EXTRINSIC = 2
CALIB_CHECK_COND = 4
CALIB_FIX_SKEW = 8
CALIB_FIX_K1 = 16
CALIB_FIX_K2 = 32
CALIB_FIX_K3 = 64
CALIB_FIX_K4 = 128
CALIB_FIX_INTRINSIC = 256
CALIB_FIX_PRINCIPAL_POINT = 512
CALIB_ZERO_DISPARITY = 1024
CALIB_FIX_FOCAL_LENGTH = 2048


def projectPoints(objectPoints, rvec, tvec, K, D, imagePoints=None,
                  alpha=0, jacobian=None):
    obj = _a(objectPoints, np.float64).reshape(-1, 3)
    out = _calib.fisheye_project_points(
        obj, _a(rvec, np.float64).ravel(),
        _a(tvec, np.float64).ravel(),
        _a(K, np.float64),
        np.zeros(4) if D is None else _a(D, np.float64).ravel())
    return _a(out, np.float64).reshape(-1, 1, 2), None


def distortPoints(undistorted, K, D, Kundistorted=None, distorted=None,
                  alpha=0):
    """cv2 semantics: the input points are NORMALIZED coordinates
    (identity camera) unless ``Kundistorted`` names their pixel
    matrix."""
    K = _a(K, np.float64)
    D = np.zeros(4) if D is None else _a(D, np.float64).ravel()
    p = _a(undistorted, np.float64).reshape(-1, 2)
    if Kundistorted is None:
        x, y = p[:, 0], p[:, 1]
    else:
        src_K = _a(Kundistorted, np.float64)
        x = (p[:, 0] - src_K[0, 2]) / src_K[0, 0]
        y = (p[:, 1] - src_K[1, 2]) / src_K[1, 1]
    r = np.hypot(x, y)
    theta = np.arctan(r)
    theta_d = _calib._fisheye_theta_d(theta, D)
    scale = np.where(r > 1e-12, theta_d / np.where(r > 1e-12, r, 1.0), 1.0)
    xd, yd = x * scale, y * scale
    out = np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]],
                   axis=1)
    return out.reshape(_a(undistorted).shape).astype(
        _a(undistorted).dtype)


def undistortPoints(distorted, K, D, undistorted=None, R=None, P=None,
                    criteria=None):
    """Fisheye pixels -> undistorted NORMALIZED coords (cv2 default);
    optional rectification R and reprojection P (pixels under P)."""
    p = _a(distorted, np.float64).reshape(-1, 2)
    out = _a(_calib.fisheye_undistort_points(
        p, _a(K, np.float64),
        np.zeros(4) if D is None else _a(D, np.float64).ravel()),
        np.float64)
    if R is not None:
        xyz = np.concatenate([out, np.ones((len(out), 1))], axis=1)
        xyz = xyz @ _a(R, np.float64).T
        out = xyz[:, :2] / xyz[:, 2:]
    if P is not None:
        P_ = _a(P, np.float64)
        out = np.stack([P_[0, 0] * out[:, 0] + P_[0, 2],
                        P_[1, 1] * out[:, 1] + P_[1, 2]], axis=1)
    return out.reshape(_a(distorted).shape).astype(
        _a(distorted).dtype)


def initUndistortRectifyMap(K, D, R, P, size, m1type=None, map1=None,
                            map2=None):
    if R is not None and not np.allclose(_a(R, np.float64),
                                         np.eye(3)):
        raise NotImplementedError("fisheye map: only R=identity")
    mx, my = _calib.fisheye_init_undistort_rectify_map(
        _a(K, np.float64),
        np.zeros(4) if D is None else _a(D, np.float64).ravel(),
        None if P is None else _a(P, np.float64)[:3, :3],
        (int(size[0]), int(size[1])))
    return _a(mx, np.float32), _a(my, np.float32)


def undistortImage(distorted, K, D, undistorted=None, Knew=None,
                   new_size=None):
    out = _calib.fisheye_undistort(
        _t(distorted), _a(K, np.float64),
        np.zeros(4) if D is None else _a(D, np.float64).ravel(),
        None if Knew is None else _a(Knew, np.float64))
    return _a(out)


def estimateNewCameraMatrixForUndistortRectify(K, D, image_size, R,
                                               P=None, balance=0.0,
                                               new_size=None,
                                               fov_scale=1.0):
    """cv2 role: pick a new K so the undistorted image fits.  Balance
    blends between the min (all content visible) and max focal."""
    K = _a(K, np.float64)
    D = np.zeros(4) if D is None else _a(D, np.float64).ravel()
    w, h = int(image_size[0]), int(image_size[1])
    border = np.array([[w / 2, 0], [w - 1, h / 2], [w / 2, h - 1],
                       [0, h / 2]], np.float64)
    und = _calib.fisheye_undistort_points(border, K, D)  # normalized
    xn = np.abs(und[:, 0])
    yn = np.abs(und[:, 1])
    fx_min = (w / 2) / max(xn[[0, 2]].max(), 1e-9) \
        if xn[[0, 2]].max() > 0 else K[0, 0]
    fx_all = (w / 2) / max(xn[[1, 3]].max(), 1e-9)
    fy_all = (h / 2) / max(yn[[0, 2]].max(), 1e-9)
    f_min = min(fx_all, fy_all)
    f_max = max(fx_all, fy_all)
    f = f_min * (1.0 - balance) + f_max * balance
    f /= fov_scale
    new_K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])
    return new_K


def calibrate(objectPoints, imagePoints, image_size, K=None, D=None,
              rvecs=None, tvecs=None, flags=0, criteria=None):
    """Fisheye calibration: pinhole Zhang init (distortion-free) then
    joint Gauss-Newton over [fx, fy, cx, cy, k1..k4] + extrinsics with
    the equidistant projection (numeric Jacobian, deterministic)."""
    objs = [_a(o, np.float64).reshape(-1, 3) for o in objectPoints]
    imgs = [_a(i, np.float64).reshape(-1, 2) for i in imagePoints]
    _, K0, _, rv, tv = _calib.calibrate_camera(objs, imgs, image_size,
                                               iterations=10)
    views = len(objs)
    p = np.concatenate([[K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]],
                        np.zeros(4),
                        np.concatenate([np.concatenate([r, t])
                                        for r, t in zip(rv, tv)])])

    def residual(p):
        kk = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        dd = p[4:8]
        out = []
        for v in range(views):
            r = p[8 + 6 * v:11 + 6 * v]
            t = p[11 + 6 * v:14 + 6 * v]
            proj = _calib.fisheye_project_points(objs[v], r, t, kk, dd)
            out.append((proj - imgs[v]).ravel())
        return np.concatenate(out)

    lam = 1e-3
    r0 = residual(p)
    for _ in range(30):
        J = np.empty((len(r0), len(p)))
        for j in range(len(p)):
            dp = np.zeros_like(p)
            dp[j] = max(1e-6, 1e-6 * abs(p[j]))
            J[:, j] = (residual(p + dp) - r0) / dp[j]
        A = J.T @ J + lam * np.eye(len(p))
        g = J.T @ r0
        try:
            step = np.linalg.solve(A, g)
        except np.linalg.LinAlgError:
            break
        p_new = p - step
        r_new = residual(p_new)
        if (r_new ** 2).sum() < (r0 ** 2).sum():
            p, r0 = p_new, r_new
            lam = max(lam * 0.5, 1e-9)
            if np.linalg.norm(step) < 1e-10:
                break
        else:
            lam *= 4.0
            if lam > 1e6:
                break
    K_out = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
    D_out = p[4:8].reshape(4, 1)
    rv_out = [p[8 + 6 * v:11 + 6 * v].reshape(3, 1) for v in range(views)]
    tv_out = [p[11 + 6 * v:14 + 6 * v].reshape(3, 1) for v in range(views)]
    rms = float(np.sqrt((r0 ** 2).mean()))
    return rms, K_out, D_out, rv_out, tv_out


def solvePnP(objectPoints, imagePoints, cameraMatrix, distCoeffs, *a, **k):
    """PnP on a fisheye camera: undistort to the ideal pinhole then the
    standard solver."""
    und = undistortPoints(_a(imagePoints, np.float64)
                          .reshape(-1, 1, 2), cameraMatrix, distCoeffs,
                          P=cameraMatrix)
    rv, tv = _calib.solve_pnp(
        _a(objectPoints, np.float64).reshape(-1, 3),
        _a(und, np.float64).reshape(-1, 2),
        _a(cameraMatrix, np.float64), (0, 0, 0, 0, 0))
    return True, _a(rv).reshape(3, 1), _a(tv).reshape(3, 1)


_bind(globals())
