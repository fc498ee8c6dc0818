"""Robust 2-D transform estimation (host-side) — the estimate step of the
match → estimate → warp stabilization loop.

``estimate_affine_partial_2d`` (4-DOF similarity: rotation+scale+t) and
``estimate_affine_2d`` (full 6-DOF affine), both RANSAC over point
correspondences with a deterministic seed and a final least-squares refit
on the inliers — OpenCV's estimateAffinePartial2D/estimateAffine2D roles.
Pure NumPy: the model fit is a 4/6-parameter solve over at most a few
hundred matches; this is control logic, not device math.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _fit_similarity(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """LS similarity (a, b, tx, ty): [[a, -b, tx], [b, a, ty]]."""
    n = len(src)
    if n < 2:
        return None
    # Normal equations for Σ|R s + t − d|² with R = [[a, -b], [b, a]].
    sx, sy = src[:, 0], src[:, 1]
    dx, dy = dst[:, 0], dst[:, 1]
    s2 = float((sx * sx + sy * sy).sum())
    a_mat = np.array(
        [
            [s2, 0.0, sx.sum(), sy.sum()],
            [0.0, s2, -sy.sum(), sx.sum()],
            [sx.sum(), -sy.sum(), n, 0.0],
            [sy.sum(), sx.sum(), 0.0, n],
        ]
    )
    b_vec = np.array(
        [
            float((sx * dx + sy * dy).sum()),
            float((sx * dy - sy * dx).sum()),
            dx.sum(),
            dy.sum(),
        ]
    )
    try:
        a, b, tx, ty = np.linalg.solve(a_mat, b_vec)
    except np.linalg.LinAlgError:
        return None
    return np.array([[a, -b, tx], [b, a, ty]], np.float64)


def _fit_affine(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    n = len(src)
    if n < 3:
        return None
    a_mat = np.hstack([src, np.ones((n, 1))])
    try:
        sol, *_ = np.linalg.lstsq(a_mat, dst, rcond=None)
    except np.linalg.LinAlgError:
        return None
    if not np.all(np.isfinite(sol)):
        return None
    return sol.T  # [2, 3]


def _ransac(
    src, dst, fit, sample_size, thresh, iters, seed
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    n = len(src)
    rng = np.random.default_rng(seed)
    best_mask = np.zeros(n, bool)
    best_m = None
    for _ in range(iters):
        idx = rng.choice(n, size=sample_size, replace=False)
        m = fit(src[idx], dst[idx])
        if m is None:
            continue
        proj = src @ m[:, :2].T + m[:, 2]
        err = np.linalg.norm(proj - dst, axis=1)
        mask = err < thresh
        if mask.sum() > best_mask.sum():
            best_mask = mask
            best_m = m
    if best_m is None or best_mask.sum() < sample_size:
        return None, np.zeros(n, bool)
    refined = fit(src[best_mask], dst[best_mask])
    if refined is not None:
        proj = src @ refined[:, :2].T + refined[:, 2]
        best_mask = np.linalg.norm(proj - dst, axis=1) < thresh
        best_m = refined
    return best_m, best_mask


def estimate_affine_partial_2d(
    src_pts,
    dst_pts,
    ransac_thresh: float = 3.0,
    iters: int = 100,
    seed: int = 7,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """4-DOF similarity (rotation, uniform scale, translation) via RANSAC →
    (M 2×3 float64 or None, inlier mask). Deterministic for a given seed."""
    src = np.asarray(src_pts, np.float64).reshape(-1, 2)
    dst = np.asarray(dst_pts, np.float64).reshape(-1, 2)
    if len(src) != len(dst) or len(src) < 2:
        return None, np.zeros(len(src), bool)
    return _ransac(src, dst, _fit_similarity, 2, ransac_thresh, iters, seed)


def estimate_affine_2d(
    src_pts,
    dst_pts,
    ransac_thresh: float = 3.0,
    iters: int = 100,
    seed: int = 7,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Full 6-DOF affine via RANSAC → (M 2×3 float64 or None, inliers)."""
    src = np.asarray(src_pts, np.float64).reshape(-1, 2)
    dst = np.asarray(dst_pts, np.float64).reshape(-1, 2)
    if len(src) != len(dst) or len(src) < 3:
        return None, np.zeros(len(src), bool)
    return _ransac(src, dst, _fit_affine, 3, ransac_thresh, iters, seed)


def _fit_homography(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """Normalized DLT → 3×3 H (H @ [sx, sy, 1] ∝ [dx, dy, 1])."""
    n = len(src)
    if n < 4:
        return None

    def norm(p):
        c = p.mean(axis=0)
        s = np.sqrt(2.0) / max(np.linalg.norm(p - c, axis=1).mean(), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        return (p - c) * s, T

    sp, Ts = norm(src)
    dp, Td = norm(dst)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = sp[i]
        u, v = dp[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    try:
        _, _, vt = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return None
    H = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    if abs(H[2, 2]) < 1e-12 or not np.all(np.isfinite(H)):
        return None
    return H / H[2, 2]


def _proj_h(H: np.ndarray, p: np.ndarray) -> np.ndarray:
    q = p @ H[:, :2].T + H[:, 2]
    w = q[:, 2:]
    return q[:, :2] / np.where(np.abs(w) < 1e-12, 1e-12, w)


def find_homography(
    src_pts,
    dst_pts,
    ransac_thresh: float = 3.0,
    iters: int = 200,
    seed: int = 7,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Projective 3×3 homography via RANSAC + inlier DLT refit (the
    OpenCV ``findHomography`` RANSAC role) → (H float64 or None,
    inlier mask). Deterministic for a given seed."""
    src = np.asarray(src_pts, np.float64).reshape(-1, 2)
    dst = np.asarray(dst_pts, np.float64).reshape(-1, 2)
    n = len(src)
    if n != len(dst) or n < 4:
        return None, np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    best_mask = np.zeros(n, bool)
    best_h = None
    for _ in range(iters):
        idx = rng.choice(n, size=4, replace=False)
        h = _fit_homography(src[idx], dst[idx])
        if h is None:
            continue
        err = np.linalg.norm(_proj_h(h, src) - dst, axis=1)
        mask = err < ransac_thresh
        if mask.sum() > best_mask.sum():
            best_mask = mask
            best_h = h
    if best_h is None or best_mask.sum() < 4:
        return None, np.zeros(n, bool)
    refined = _fit_homography(src[best_mask], dst[best_mask])
    if refined is not None:
        best_mask = np.linalg.norm(_proj_h(refined, src) - dst, axis=1) < ransac_thresh
        best_h = refined
    return best_h, best_mask
