"""Copy of ``rustcv_tpu.ops.circles_grid`` (the port's ``blob`` and
``chessboard``). Circles-grid calibration target detection (OpenCV
``findCirclesGrid`` role, SYMMETRIC + ASYMMETRIC grids) plus the
matching object-point generators.

Pipeline (host — the per-image work is a handful of blobs):
1. blob centers from ops/blob.detect_blobs (dark circles);
2. size-consistency filter (diameter within [0.45, 2.2]× the median);
3. lattice-basis estimation: every point's displacements to its 4
   nearest neighbors, folded into the upper half-plane and clustered
   by angle; the two dominant non-collinear clusters give the basis
   (for the asymmetric grid the natural basis is the two diagonals of
   the checkerboard half-lattice — no special case needed);
4. integer coordinates by rounding in basis space, refined by two
   rounds of least-squares (basis + origin from the current integer
   assignment), outliers dropped by residual;
5. symmetric: full (cols × rows) occupancy via the chessboard
   module's canonical ordering (ops/chessboard._order_grid);
   asymmetric: checkerboard-parity coordinates mapped to (row, col)
   with full occupancy required, canonicalized deterministically.

The asymmetric grid object points follow OpenCV's convention
(x = (2·col + row%2)·size, y = row·size) so a (detected, object)
pair from this module drops straight into calibrate_camera — the
end-to-end property tests/test_circles_grid.py exercises (and the
detected sets are cross-checked against cv2.findCirclesGrid).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .blob import BlobParams, detect_blobs
from .chessboard import _order_grid


def circles_grid_object_points(pattern_size: Tuple[int, int],
                               size: float = 1.0,
                               asymmetric: bool = False) -> np.ndarray:
    """(N, 3) object points in OpenCV's conventions. ``pattern_size`` =
    (cols, rows) = circles per row, number of rows."""
    cols, rows = pattern_size
    pts = []
    for r in range(rows):
        for c in range(cols):
            if asymmetric:
                pts.append(((2 * c + r % 2) * size, r * size, 0.0))
            else:
                pts.append((c * size, r * size, 0.0))
    return np.asarray(pts, np.float64)


def _nn_displacements(pts: np.ndarray, k: int = 4) -> np.ndarray:
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    disp = pts[idx] - pts[:, None, :]
    return disp.reshape(-1, 2)


def _estimate_basis(pts: np.ndarray) -> Optional[np.ndarray]:
    """Two dominant short lattice vectors (2, 2) or None."""
    disp = _nn_displacements(pts)
    # fold into the upper half-plane (lattice vectors are ±pairs)
    flip = (disp[:, 1] < 0) | ((disp[:, 1] == 0) & (disp[:, 0] < 0))
    disp = np.where(flip[:, None], -disp, disp)
    ang = np.arctan2(disp[:, 1], disp[:, 0])  # [0, π)
    nrm = np.linalg.norm(disp, axis=1)
    med = np.median(nrm)
    keep = (nrm > 0.3 * med) & (nrm < 1.8 * med)
    disp, ang = disp[keep], ang[keep]
    if len(disp) < 4:
        return None
    # greedy angular clustering (π-periodic): seed with the most common
    # direction, collect ±12°, repeat for the remainder
    basis = []
    remaining = np.ones(len(disp), bool)
    for _ in range(2):
        if not remaining.any():
            return None
        hist_ang = ang[remaining]
        # mode via a coarse histogram
        bins = np.linspace(0, np.pi, 36)
        h, _ = np.histogram(hist_ang, bins)
        center = (bins[np.argmax(h)] + bins[np.argmax(h) + 1]) / 2
        delta = np.abs(((ang - center + np.pi / 2) % np.pi) - np.pi / 2)
        sel = remaining & (delta < np.deg2rad(12))
        if sel.sum() < 2:
            return None
        # median vector of the cluster, sign-aligned to the first member
        v0 = disp[sel][0]
        signs = np.where(disp[sel] @ v0 < 0, -1.0, 1.0)
        vec = np.median(disp[sel] * signs[:, None], axis=0)
        basis.append(vec)
        remaining &= ~(delta < np.deg2rad(25))
    b = np.stack(basis, axis=1)  # columns = basis vectors
    if abs(np.linalg.det(b)) < 1e-9:
        return None
    return b


def _fit_lattice(pts: np.ndarray, basis: np.ndarray
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Round points into integer lattice coords; refine (basis, origin)
    by least squares twice → (uv int (K,2), inlier mask)."""
    origin = pts[np.argmin(pts.sum(axis=1))]
    b = basis.copy()
    uv = None
    for _ in range(3):
        q = np.linalg.solve(b, (pts - origin).T).T
        uv = np.round(q).astype(np.int64)
        resid = np.linalg.norm(pts - (origin + uv @ b.T), axis=1)
        scale = np.linalg.norm(b, axis=0).min()
        inl = resid < 0.25 * scale
        if inl.sum() < 4:
            return None
        # refit origin + basis on inliers: p = origin + U b^T
        a = np.concatenate([uv[inl], np.ones((inl.sum(), 1))], axis=1)
        sol, *_ = np.linalg.lstsq(a, pts[inl], rcond=None)
        b = sol[:2].T
        if abs(np.linalg.det(b)) < 1e-9:
            return None
        origin = sol[2]
    q = np.linalg.solve(b, (pts - origin).T).T
    uv = np.round(q).astype(np.int64)
    resid = np.linalg.norm(pts - (origin + uv @ b.T), axis=1)
    inl = resid < 0.25 * np.linalg.norm(b, axis=0).min()
    return uv, inl


def find_circles_grid(gray: np.ndarray, pattern_size: Tuple[int, int],
                      asymmetric: bool = False,
                      params: Optional[BlobParams] = None
                      ) -> Tuple[bool, Optional[np.ndarray]]:
    """→ (found, centers (rows·cols, 2) float64 row-major) — OpenCV
    ``findCirclesGrid``. ``pattern_size`` = (cols, rows)."""
    cols, rows = pattern_size
    n = cols * rows
    blobs = detect_blobs(np.asarray(gray), params or BlobParams())
    if len(blobs) < n:
        return False, None
    # size-consistency filter
    dia = blobs[:, 2]
    med = np.median(dia)
    blobs = blobs[(dia > 0.45 * med) & (dia < 2.2 * med)]
    if len(blobs) < n:
        return False, None
    pts = blobs[:, :2].astype(np.float64)
    basis = _estimate_basis(pts)
    if basis is None:
        return False, None
    fit = _fit_lattice(pts, basis)
    if fit is None:
        return False, None
    uv, inl = fit
    pts, uv = pts[inl], uv[inl]
    if len(pts) < n:
        return False, None
    uv = uv - uv.min(axis=0)

    if not asymmetric:
        # drop duplicate lattice cells (outliers that rounded together)
        if len(pts) != n:
            return False, None
        grid = _order_grid(pts, uv, pattern_size)
        if grid is None:
            return False, None
        return True, grid.reshape(-1, 2)

    # asymmetric: lattice basis found the checkerboard diagonals d1, d2;
    # centers live at (x, y) = a·d1 + b·d2 with image row r = a + b,
    # col c = (a − b − r%2) / 2 (after choosing the orientation that
    # makes occupancy a full rows × cols block)
    obj = circles_grid_object_points(pattern_size, 1.0, True)[:, :2]
    best = None
    best_resid = np.inf
    for flip_d in (False, True):
        a = uv[:, 1] if flip_d else uv[:, 0]
        b = uv[:, 0] if flip_d else uv[:, 1]
        for sa in (1, -1):
            for sb in (1, -1):
                aa, bb = sa * a, sb * b
                r = aa + bb
                x = aa - bb
                r = r - r.min()
                x = x - x.min()
                if ((x + r) % 2).any():
                    continue
                c = (x - (r % 2)) // 2
                if r.max() + 1 != rows or c.max() + 1 != cols:
                    continue
                key = np.stack([r, c], 1)
                if not (len(np.unique(key, axis=0)) == n == len(key)):
                    continue
                out = np.zeros((rows, cols, 2))
                out[r, c] = pts
                cand = out.reshape(-1, 2)
                # disambiguate mirrors: the true labeling fits an
                # ORIENTATION-PRESERVING homography from object space
                h, resid = _fit_homography(obj, cand)
                if h is None or np.linalg.det(h[:2, :2]) <= 0:
                    continue
                if resid < best_resid:
                    best, best_resid = cand, resid
    if best is None:
        return False, None
    return True, best


def _fit_homography(src: np.ndarray, dst: np.ndarray
                    ) -> Tuple[Optional[np.ndarray], float]:
    """DLT least squares → (H normalized to H[2,2]=1, rms residual)."""
    n = len(src)
    a = np.zeros((2 * n, 9))
    a[0::2, 0:2] = src
    a[0::2, 2] = 1
    a[0::2, 6:8] = -src * dst[:, :1]
    a[0::2, 8] = -dst[:, 0]
    a[1::2, 3:5] = src
    a[1::2, 5] = 1
    a[1::2, 6:8] = -src * dst[:, 1:2]
    a[1::2, 8] = -dst[:, 1]
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    if abs(h[2, 2]) < 1e-12:
        return None, np.inf
    h = h / h[2, 2]
    w = src @ h[2, :2].T + 1.0
    proj = (src @ h[:2, :2].T + h[:2, 2]) / w[:, None]
    resid = float(np.sqrt(((proj - dst) ** 2).sum(axis=1).mean()))
    return h, resid
