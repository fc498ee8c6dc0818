"""Copy of ``rustcv_tpu.ops.calib_ext`` (the port's ``calib``, ``geometry``,
``golden`` and ``viz``). Calib3d long tail (OpenCV ``composeRT`` /
``decomposeProjectionMatrix`` / ``calibrationMatrixValues`` /
``sampsonDistance`` / ``estimateTranslation2D/3D`` /
``stereoRectifyUncalibrated`` / ``initCameraMatrix2D`` roles) and the
stereo post-filter ``filterSpeckles``.

Host float64 like ops/calib.py (tiny problems, once per frame/camera).
All cross-validated against cv2 5.0 in tests/test_calib_ext.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .calib import rodrigues


def compose_rt(rvec1, tvec1, rvec2, tvec2
               ) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``composeRT``: the pose that applies (R1,t1) then
    (R2,t2) → (rvec3, tvec3)."""
    r1 = rodrigues(np.asarray(rvec1, np.float64))
    r2 = rodrigues(np.asarray(rvec2, np.float64))
    r3 = r2 @ r1
    t3 = r2 @ np.asarray(tvec1, np.float64).ravel() \
        + np.asarray(tvec2, np.float64).ravel()
    return rodrigues(r3), t3


def _rq3(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RQ decomposition of a 3×3 (R upper-triangular, Q rotation)."""
    # QR of the flipped transpose gives RQ
    p = np.fliplr(np.eye(3))
    q, r = np.linalg.qr((p @ m).T)
    rr = p @ r.T @ p
    qq = p @ q.T
    # make diagonal of rr positive
    sgn = np.sign(np.diag(rr))
    sgn[sgn == 0] = 1.0
    d = np.diag(sgn)
    return rr @ d, d @ qq


def decompose_projection_matrix(p
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """OpenCV ``decomposeProjectionMatrix`` → (K (3,3) with K[2,2]=1,
    R, homogeneous camera centre (4,))."""
    p = np.asarray(p, np.float64)
    k, r = _rq3(p[:, :3])
    if np.linalg.det(r) < 0:
        r = -r
    c = -np.linalg.solve(p[:, :3], p[:, 3])
    center = np.concatenate([c, [1.0]])
    return k / k[2, 2], r, center


def calibration_matrix_values(k, image_size: Tuple[int, int],
                              aperture_width: float,
                              aperture_height: float):
    """OpenCV ``calibrationMatrixValues`` → (fovx°, fovy°,
    focal_length_mm, principal_point_mm, aspect_ratio)."""
    k = np.asarray(k, np.float64)
    w, h = image_size
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    fovx = np.degrees(np.arctan2(cx, fx) + np.arctan2(w - cx, fx))
    fovy = np.degrees(np.arctan2(cy, fy) + np.arctan2(h - cy, fy))
    focal = fx * aperture_width / w if aperture_width > 0 else 0.0
    pp = ((cx * aperture_width / w) if aperture_width > 0 else 0.0,
          (cy * aperture_height / h) if aperture_height > 0 else 0.0)
    return float(fovx), float(fovy), float(focal), pp, float(fy / fx)


def sampson_distance(pt1, pt2, f) -> float:
    """OpenCV ``sampsonDistance``: first-order epipolar distance of
    HOMOGENEOUS points (x1, x2) under F."""
    x1 = np.asarray(pt1, np.float64).ravel()
    x2 = np.asarray(pt2, np.float64).ravel()
    f = np.asarray(f, np.float64)
    fx1 = f @ x1
    ftx2 = f.T @ x2
    num = float(x2 @ f @ x1) ** 2
    den = fx1[0] ** 2 + fx1[1] ** 2 + ftx2[0] ** 2 + ftx2[1] ** 2
    return num / den if den > 0 else 0.0


def _ransac_translation(src: np.ndarray, dst: np.ndarray, thresh: float,
                        iters: int = 100
                        ) -> Tuple[np.ndarray, np.ndarray]:
    d = dst - src
    best_inl = None
    for i in range(min(iters, len(d))):
        t = d[i % len(d)]
        inl = np.linalg.norm(d - t, axis=1) < thresh
        if best_inl is None or inl.sum() > best_inl.sum():
            best_inl = inl
    t = d[best_inl].mean(axis=0)
    return t, best_inl


def estimate_translation_2d(src, dst, ransac_threshold: float = 3.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``estimateTranslation2D`` → ((2,) translation, inlier
    mask) — RANSAC + inlier mean."""
    return _ransac_translation(np.asarray(src, np.float64).reshape(-1, 2),
                               np.asarray(dst, np.float64).reshape(-1, 2),
                               ransac_threshold)


def estimate_translation_3d(src, dst, ransac_threshold: float = 3.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    return _ransac_translation(np.asarray(src, np.float64).reshape(-1, 3),
                               np.asarray(dst, np.float64).reshape(-1, 3),
                               ransac_threshold)


def init_camera_matrix_2d(obj_points: Sequence, img_points: Sequence,
                          image_size: Tuple[int, int],
                          aspect_ratio: float = 1.0) -> np.ndarray:
    """OpenCV ``initCameraMatrix2D``: per-view homography columns,
    principal point pinned at the image centre, then the two
    vanishing-point orthogonality constraints per view solved by SVD
    least squares for (1/fx², 1/fy²) — works from a single planar view
    (cv2's cvInitIntrinsicParams2D structure, verified differentially)."""
    from .geometry import _fit_homography

    w, h = image_size
    cx = 0.5 if not w else (w - 1) * 0.5
    cy = 0.5 if not h else (h - 1) * 0.5
    rows_a = []
    rows_b = []
    for obj, img in zip(obj_points, img_points):
        m = np.asarray(obj, np.float64).reshape(-1, 3)[:, :2]
        p = np.asarray(img, np.float64).reshape(-1, 2)
        H = np.asarray(_fit_homography(m, p), np.float64).reshape(3, 3)
        H = H / H[2, 2]
        # translate the principal point to the origin
        H = H.copy()
        H[0] -= H[2] * cx
        H[1] -= H[2] * cy
        hcol = H[:, 0].copy()
        vcol = H[:, 1].copy()
        d1 = (hcol + vcol) * 0.5
        d2 = (hcol - vcol) * 0.5
        hcol /= np.linalg.norm(hcol)
        vcol /= np.linalg.norm(vcol)
        d1 /= np.linalg.norm(d1)
        d2 /= np.linalg.norm(d2)
        rows_a.append([hcol[0] * vcol[0], hcol[1] * vcol[1]])
        rows_a.append([d1[0] * d2[0], d1[1] * d2[1]])
        rows_b.append(-hcol[2] * vcol[2])
        rows_b.append(-d1[2] * d2[2])
    f, *_ = np.linalg.lstsq(np.asarray(rows_a), np.asarray(rows_b),
                            rcond=None)
    fx = np.sqrt(abs(1.0 / f[0]))
    fy = np.sqrt(abs(1.0 / f[1]))
    if aspect_ratio:
        tf = (fx + fy) / (aspect_ratio + 1.0)
        fx = aspect_ratio * tf
        fy = tf
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def stereo_rectify_uncalibrated(pts1, pts2, f,
                                image_size: Tuple[int, int],
                                threshold: float = 5.0
                                ) -> Tuple[bool, np.ndarray, np.ndarray]:
    """OpenCV ``stereoRectifyUncalibrated`` (Hartley): homographies
    (H1, H2) that map the epipoles to infinity and align epipolar
    lines to scanlines."""
    p1 = np.asarray(pts1, np.float64).reshape(-1, 2)
    p2 = np.asarray(pts2, np.float64).reshape(-1, 2)
    f = np.asarray(f, np.float64)
    w, h = image_size
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0

    # epipole in image 2: left null vector of F
    u, s, vt = np.linalg.svd(f)
    e2 = u[:, 2]
    if abs(e2[2]) > 1e-12:
        e2 = e2 / e2[2]

    # translate centre to origin, rotate epipole onto x-axis, map to ∞
    t = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    ex, ey = e2[0] - cx, e2[1] - cy
    d = np.hypot(ex, ey)
    if d < 1e-9:
        return False, np.eye(3), np.eye(3)
    ca, sa = ex / d, ey / d
    r = np.array([[ca, sa, 0], [-sa, ca, 0], [0, 0, 1.0]])
    x0 = d
    g = np.array([[1, 0, 0], [0, 1, 0], [-1.0 / x0, 0, 1]])
    h2 = np.linalg.inv(t) @ g @ r @ t

    # H1 = matching transform minimizing Σ‖H1 x1 − H2 x2‖² over
    # H1 = (I + e2 aᵀ) H2 M with M = [e2]x F + e2 vᵀ (v = 1s)
    e2x = np.array([[0, -e2[2], e2[1]], [e2[2], 0, -e2[0]],
                    [-e2[1], e2[0], 0]])
    m = e2x @ f + np.outer(e2, np.ones(3))
    hm = h2 @ m
    x1h = np.concatenate([p1, np.ones((len(p1), 1))], 1)
    x2h = np.concatenate([p2, np.ones((len(p2), 1))], 1)
    a1 = x1h @ hm.T
    a1 = a1 / a1[:, 2:3]
    b = x2h @ h2.T
    b = b / b[:, 2:3]
    # least squares for a: a1 @ (a0,a1,a2) ≈ b_x
    sol, *_ = np.linalg.lstsq(a1, b[:, 0], rcond=None)
    ha = np.eye(3)
    ha[0] = sol
    h1 = ha @ hm
    # success check: rectified y residual
    y1 = (x1h @ h1.T)
    y1 = y1[:, 1] / y1[:, 2]
    y2 = (x2h @ h2.T)
    y2 = y2[:, 1] / y2[:, 2]
    ok = bool(np.median(np.abs(y1 - y2)) < threshold)
    return ok, h1 / h1[2, 2], h2 / h2[2, 2]


def filter_speckles(disparity: np.ndarray, new_val: float,
                    max_speckle_size: int, max_diff: float
                    ) -> np.ndarray:
    """OpenCV ``filterSpeckles``: connected regions (4-conn, neighbors
    linked when |d_p − d_q| ≤ max_diff) smaller than
    ``max_speckle_size`` are overwritten with ``new_val``. Returns a
    new array (functional; cv2 mutates)."""
    d = np.asarray(disparity)
    h, w = d.shape
    out = d.copy()
    seen = np.zeros((h, w), bool)
    for y0 in range(h):
        for x0 in range(w):
            if seen[y0, x0]:
                continue
            stack = [(y0, x0)]
            seen[y0, x0] = True
            comp = []
            while stack:
                y, x = stack.pop()
                comp.append((y, x))
                dv = d[y, x]
                for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1),
                               (y, x + 1)):
                    if (0 <= yy < h and 0 <= xx < w and not seen[yy, xx]
                            and abs(float(d[yy, xx]) - float(dv))
                            <= max_diff):
                        seen[yy, xx] = True
                        stack.append((yy, xx))
            if len(comp) <= max_speckle_size:
                for y, x in comp:
                    out[y, x] = new_val
    return out


def read_optical_flow(path: str) -> np.ndarray:
    """Middlebury ``.flo`` reader (OpenCV ``readOpticalFlow``)."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
        if magic != b"PIEH":
            raise ValueError("not a .flo file")
        w = int(np.frombuffer(fh.read(4), np.int32)[0])
        h = int(np.frombuffer(fh.read(4), np.int32)[0])
        data = np.frombuffer(fh.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_optical_flow(path: str, flow: np.ndarray) -> bool:
    """Middlebury ``.flo`` writer (OpenCV ``writeOpticalFlow``)."""
    f = np.asarray(flow, np.float32)
    h, w = f.shape[:2]
    with open(path, "wb") as fh:
        fh.write(b"PIEH")
        fh.write(np.asarray([w, h], np.int32).tobytes())
        fh.write(f.astype(np.float32).tobytes())
    return True


def solve_p3p(obj_pts, img_pts, k, dist=(0, 0, 0, 0, 0)):
    """OpenCV ``solveP3P`` role (Grunert's 3-point pose): → list of
    (rvec, tvec) solutions (up to 4), reprojection-sorted.

    Derivation (the classical side-length/ray-angle system): with
    camera-frame depths s₁, s₂u, s₂v along the three unit rays and
    pairwise angles (α, β, γ), eliminating t = 1/s₁² leaves two conics
    in (u, v); their v-resultant is a degree ≤ 8 polynomial in u whose
    real positive roots give candidate depth ratios. Each candidate is
    completed by the exact 3-point absolute-orientation (Horn) fit."""
    from .calib import rodrigues, undistort_points

    obj = np.asarray(obj_pts, np.float64).reshape(3, 3)
    img = np.asarray(img_pts, np.float64).reshape(3, 2)
    k = np.asarray(k, np.float64)
    und = undistort_points(img, k, dist)
    rays = np.concatenate([(und - k[:2, 2]) / np.array(
        [k[0, 0], k[1, 1]]), np.ones((3, 1))], axis=1)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)

    a2 = ((obj[1] - obj[2]) ** 2).sum()
    b2 = ((obj[0] - obj[2]) ** 2).sum()
    c2 = ((obj[0] - obj[1]) ** 2).sum()
    ca = rays[1] @ rays[2]
    cb = rays[0] @ rays[2]
    cg = rays[0] @ rays[1]

    # conic coefficients as polynomials in u (low order first)
    def P(*coeffs):
        return np.asarray(coeffs, np.float64)  # [c0, c1, c2]

    A1 = P(b2 - a2)
    B1 = P(2 * a2 * cb, -2 * b2 * ca)
    C1 = P(-a2, 0, b2)
    A2 = P(c2)
    B2 = P(0, -2 * c2 * ca)
    C2 = P(-a2, 2 * a2 * cg, c2 - a2)

    def pmul(p, q):
        return np.convolve(p, q)

    def psub(p, q):
        n = max(len(p), len(q))
        out = np.zeros(n)
        out[:len(p)] += p
        out[:len(q)] -= q
        return out

    m0 = psub(pmul(A1, C2), pmul(A2, C1))
    m1 = psub(pmul(A1, B2), pmul(A2, B1))
    m2 = psub(pmul(B1, C2), pmul(B2, C1))
    res = psub(pmul(m0, m0), pmul(m1, m2))
    res = np.trim_zeros(res, "b")
    if len(res) < 2:
        return []
    roots = np.roots(res[::-1])
    sols = []
    for u in roots:
        if abs(u.imag) > 1e-8 or u.real <= 0:
            continue
        u = float(u.real)
        aa = float(np.polyval(A1[::-1], u))
        bb = float(np.polyval(B1[::-1], u))
        cc = float(np.polyval(C1[::-1], u))
        vs = []
        if abs(aa) > 1e-12:
            disc = bb * bb - 4 * aa * cc
            if disc >= 0:
                r = np.sqrt(disc)
                vs = [(-bb + r) / (2 * aa), (-bb - r) / (2 * aa)]
        elif abs(bb) > 1e-12:
            vs = [-cc / bb]
        for v in vs:
            if v <= 0:
                continue
            # verify on the second conic
            e2 = (float(np.polyval(A2[::-1], u)) * v * v
                  + float(np.polyval(B2[::-1], u)) * v
                  + float(np.polyval(C2[::-1], u)))
            if abs(e2) > 1e-6 * max(a2, b2, c2):
                continue
            denom = 1 + u * u - 2 * u * cg
            if denom <= 0:
                continue
            s1 = np.sqrt(c2 / denom)
            cam = np.stack([s1 * rays[0], s1 * u * rays[1],
                            s1 * v * rays[2]])
            rt = _absolute_orientation_3pt(obj, cam)
            if rt is not None:
                sols.append(rt)
    # dedupe + sort by reprojection error
    uniq = []
    for rvec, tvec in sols:
        if not any(np.allclose(rvec, r2, atol=1e-6)
                   and np.allclose(tvec, t2, atol=1e-6)
                   for r2, t2 in uniq):
            uniq.append((rvec, tvec))

    def reproj_err(rt):
        from .calib import project_points

        proj = project_points(obj, rt[0], rt[1], k, dist)
        return float(np.abs(proj - img).max())

    return sorted(uniq, key=reproj_err)


def _absolute_orientation_3pt(obj: np.ndarray, cam: np.ndarray):
    """Exact rigid fit cam = R·obj + t for 3 correspondences (Horn
    via SVD of the cross-covariance) → (rvec, tvec) or None."""
    from .calib import rodrigues

    co = obj.mean(0)
    cc = cam.mean(0)
    h = (obj - co).T @ (cam - cc)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    if np.linalg.det(r) < 0:
        return None
    t = cc - r @ co
    return rodrigues(r), t


def calibrate_camera_extended(obj_points, img_points, image_size,
                              iterations: int = 30):
    """OpenCV ``calibrateCameraExtended`` role: Zhang calibration plus
    uncertainty — → (rms, K, dist, rvecs, tvecs,
    stddev_intrinsics (9,), per_view_errors (V,)).

    Std deviations come from the Gauss-Newton covariance at the
    optimum: σ_p = √(diag((JᵀJ)⁻¹)·σ²) with σ² = RSS/(2N − P), J the
    numeric Jacobian over [fx, fy, cx, cy, k1, k2, p1, p2, k3] and all
    extrinsics (the extrinsic block is marginalized by including it in
    J)."""
    from .calib import calibrate_camera, project_points

    rms, k, dist, rvecs, tvecs = calibrate_camera(
        list(obj_points), list(img_points), image_size, iterations)
    views = len(rvecs)
    dist = np.asarray(dist, np.float64).ravel()

    def pack():
        p = [k[0, 0], k[1, 1], k[0, 2], k[1, 2], *dist[:5]]
        for r, t in zip(rvecs, tvecs):
            p.extend(r)
            p.extend(t)
        return np.asarray(p, np.float64)

    def residual(p):
        kk = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        dd = p[4:9]
        out = []
        for v in range(views):
            base = 9 + 6 * v
            proj = project_points(np.asarray(obj_points[v], np.float64),
                                  p[base:base + 3], p[base + 3:base + 6],
                                  kk, dd)
            out.append((proj - np.asarray(img_points[v],
                                          np.float64)).ravel())
        return np.concatenate(out)

    p0 = pack()
    r0 = residual(p0)
    n_res = len(r0)
    n_par = len(p0)
    jac = np.zeros((n_res, n_par))
    eps = 1e-6
    for j in range(n_par):
        p2 = p0.copy()
        p2[j] += eps
        jac[:, j] = (residual(p2) - r0) / eps
    dof = max(n_res - n_par, 1)
    sigma2 = float(r0 @ r0) / dof
    try:
        cov = np.linalg.inv(jac.T @ jac + 1e-12 * np.eye(n_par))
        std = np.sqrt(np.maximum(np.diag(cov)[:9], 0.0) * sigma2)
    except np.linalg.LinAlgError:
        std = np.full(9, np.nan)

    per_view = np.zeros(views)
    for v in range(views):
        proj = project_points(np.asarray(obj_points[v], np.float64),
                              rvecs[v], tvecs[v], k, dist)
        d = proj - np.asarray(img_points[v], np.float64)
        per_view[v] = np.sqrt((d ** 2).sum(axis=1).mean())
    return rms, k, dist, rvecs, tvecs, std, per_view


def register_cameras(obj_points, img_points1, img_points2, k1, dist1,
                     k2, dist2, iterations: int = 20
                     ) -> Tuple[float, np.ndarray, np.ndarray]:
    """OpenCV ``registerCameras`` role: rigid transform (R, t) from
    camera-1 frame to camera-2 frame given views of shared targets and
    KNOWN intrinsics → (rms_px, rvec, tvec). Per-view PnP poses give
    R_rel = R₂R₁ᵀ candidates; the chordal-mean rotation + mean
    translation seed a Gauss-Newton refinement of the joint
    reprojection error in camera 2."""
    from .calib import project_points, rodrigues, solve_pnp

    k1 = np.asarray(k1, np.float64)
    k2 = np.asarray(k2, np.float64)
    views = len(obj_points)
    poses1, poses2 = [], []
    for v in range(views):
        poses1.append(solve_pnp(obj_points[v], img_points1[v], k1,
                                dist1))
        poses2.append(solve_pnp(obj_points[v], img_points2[v], k2,
                                dist2))
    rels = []
    trs = []
    for (r1, t1), (r2, t2) in zip(poses1, poses2):
        m1 = rodrigues(r1)
        m2 = rodrigues(r2)
        rrel = m2 @ m1.T
        rels.append(rrel)
        trs.append(t2 - rrel @ t1)
    # chordal mean rotation: SVD-project the averaged matrix
    mavg = np.mean(rels, axis=0)
    u, _, vt = np.linalg.svd(mavg)
    rmean = u @ np.diag([1, 1, np.sign(np.linalg.det(u @ vt))]) @ vt
    rvec = rodrigues(rmean)
    tvec = np.mean(trs, axis=0)

    def residual(p):
        rr = rodrigues(p[:3])
        tt = p[3:]
        out = []
        for v in range(views):
            r1m = rodrigues(poses1[v][0])
            rv2 = rodrigues(rr @ r1m)
            tv2 = rr @ poses1[v][1] + tt
            proj = project_points(np.asarray(obj_points[v], np.float64),
                                  rv2, tv2, k2, dist2)
            out.append((proj - np.asarray(img_points2[v],
                                          np.float64)).ravel())
        return np.concatenate(out)

    params = np.concatenate([rvec, tvec])
    eps = 1e-7
    for _ in range(iterations):
        r0 = residual(params)
        jac = np.zeros((len(r0), 6))
        for j in range(6):
            p2 = params.copy()
            p2[j] += eps
            jac[:, j] = (residual(p2) - r0) / eps
        try:
            step = np.linalg.solve(jac.T @ jac + 1e-10 * np.eye(6),
                                   -jac.T @ r0)
        except np.linalg.LinAlgError:
            break
        params = params + step
        if np.linalg.norm(step) < 1e-12:
            break
    r0 = residual(params)
    rms = float(np.sqrt((r0 ** 2).reshape(-1, 2).sum(1).mean()))
    return rms, params[:3].copy(), params[3:].copy()


def solve_pnp_generic(obj_pts, img_pts, k, dist=(0, 0, 0, 0, 0)):
    """OpenCV ``solvePnPGeneric`` role: all candidate poses with their
    reprojection errors → (n, [(rvec, tvec)...], errors). Three points
    route to P3P (multi-solution); ≥4 to the ITERATIVE solver."""
    from .calib import project_points, solve_pnp

    obj = np.asarray(obj_pts, np.float64).reshape(-1, 3)
    img = np.asarray(img_pts, np.float64).reshape(-1, 2)
    if len(obj) == 3:
        sols = solve_p3p(obj, img, k, dist)
    else:
        sols = [solve_pnp(obj, img, np.asarray(k, np.float64), dist)]
    errs = []
    for rv, tv in sols:
        proj = project_points(obj, rv, tv, np.asarray(k, np.float64),
                              dist)
        errs.append(float(np.sqrt(((proj - img) ** 2).sum(1).mean())))
    return len(sols), sols, np.asarray(errs)


def draw_frame_axes(img: np.ndarray, k, dist, rvec, tvec,
                    length: float, thickness: int = 2) -> np.ndarray:
    """OpenCV ``drawFrameAxes``: paint the pose's XYZ axes (X red,
    Y green, Z blue — cv2's colors) → new BGR image."""
    from .calib import project_points
    from .golden import line_mask

    a = np.asarray(img)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    out = a.astype(np.uint8).copy()
    h, w = out.shape[:2]
    obj = np.array([[0.0, 0, 0], [length, 0, 0], [0, length, 0],
                    [0, 0, length]])
    proj = project_points(obj, np.asarray(rvec, np.float64).ravel(),
                          np.asarray(tvec, np.float64).ravel(),
                          np.asarray(k, np.float64), dist)
    o = tuple(int(round(v)) for v in proj[0])
    for i, color in ((1, (0, 0, 255)), (2, (0, 255, 0)),
                     (3, (255, 0, 0))):
        p = tuple(int(round(v)) for v in proj[i])
        from .viz import clip_line

        ok, q1, q2 = clip_line((0, 0, w, h), o, p)
        if ok:
            out[line_mask(h, w, q1, q2, thickness) > 0] = color
    return out


def filter_homography_decomp_by_visible_refpoints(
        rotations, normals, before_pts, after_pts,
        pointwise_mask=None) -> np.ndarray:
    """OpenCV ``filterHomographyDecompByVisibleRefpoints`` role: keep
    the decomposition indices whose plane normal keeps every reference
    point in front of both cameras (positive depth side) → int32
    indices of surviving solutions."""
    bp = np.asarray(before_pts, np.float64).reshape(-1, 2)
    keep = []
    for i, (r, n) in enumerate(zip(rotations, normals)):
        m = np.concatenate([bp, np.ones((len(bp), 1))], axis=1)
        if pointwise_mask is not None:
            m = m[np.asarray(pointwise_mask).ravel().astype(bool)]
        # visibility: nᵀx > 0 for normalized image points x (the plane
        # faces the first camera at every observation)
        if (m @ np.asarray(n, np.float64).ravel() > 0).all():
            keep.append(i)
    return np.asarray(keep, np.int32)


def solve_pnp_epnp(obj_pts, img_pts, k, dist=(0, 0, 0, 0, 0)
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """EPnP (Lepetit 2009; OpenCV ``SOLVEPNP_EPNP`` role): O(n)
    closed-form pose from ≥4 points. Control points = centroid + PCA
    axes; each image point gives 2 rows of M over the 12 control-point
    camera coordinates; candidate solutions from the N=1..3 null-space
    combinations (betas via the distance-constraint system), best by
    reprojection, finished with one Gauss-Newton polish."""
    from .calib import project_points, refine_pose, undistort_points

    obj = np.asarray(obj_pts, np.float64).reshape(-1, 3)
    img = np.asarray(img_pts, np.float64).reshape(-1, 2)
    n = len(obj)
    if n < 4:
        raise ValueError("EPnP needs >= 4 points")
    k = np.asarray(k, np.float64)
    und = undistort_points(img, k, dist)

    # control points: centroid + principal directions
    c0 = obj.mean(0)
    q = obj - c0
    cov = q.T @ q / n
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    scale = np.sqrt(np.maximum(evals, 1e-12))
    cws = [c0] + [c0 + scale[i] * evecs[:, i] for i in range(3)]
    cws = np.asarray(cws)

    # barycentric coordinates (alphas): solve [cw;1] alphas = [p;1]
    cmat = np.vstack([cws.T, np.ones(4)])
    pmat = np.vstack([obj.T, np.ones(n)])
    alphas = np.linalg.solve(cmat, pmat).T  # (n, 4)

    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    m = np.zeros((2 * n, 12))
    for i in range(n):
        u, v = und[i]
        for j in range(4):
            a = alphas[i, j]
            m[2 * i, 3 * j:3 * j + 3] = [a * fx, 0, a * (cx - u)]
            m[2 * i + 1, 3 * j:3 * j + 3] = [0, a * fy, a * (cy - v)]
    _, _, vt = np.linalg.svd(m)
    kernel = vt[-4:][::-1]  # v1 = smallest singular vector first

    # pairwise distances of the world control points
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    dw = np.array([np.linalg.norm(cws[a] - cws[b]) for a, b in pairs])

    def cam_points(betas):
        ccs = sum(b * kernel[i].reshape(4, 3)
                  for i, b in enumerate(betas))
        pc = alphas @ ccs
        # enforce positive depth
        if pc[:, 2].sum() < 0:
            pc = -pc
        return pc

    def solve_beta_n1():
        v1 = kernel[0].reshape(4, 3)
        dc = np.array([np.linalg.norm(v1[a] - v1[b])
                       for a, b in pairs])
        return [float((dc @ dw) / max(dc @ dc, 1e-12)), 0.0, 0.0]

    def solve_beta_n2():
        # unknowns b11, b12, b22 from 6 distance equations
        v1 = kernel[0].reshape(4, 3)
        v2 = kernel[1].reshape(4, 3)
        rows = []
        for a, b in pairs:
            d1 = v1[a] - v1[b]
            d2 = v2[a] - v2[b]
            rows.append([d1 @ d1, 2 * (d1 @ d2), d2 @ d2])
        sol, *_ = np.linalg.lstsq(np.asarray(rows), dw ** 2,
                                  rcond=None)
        b11 = max(sol[0], 0.0)
        b1 = np.sqrt(b11)
        b2 = (np.sign(sol[1]) * np.sqrt(max(sol[2], 0.0))
              if b11 > 1e-12 else np.sqrt(max(sol[2], 0.0)))
        return [float(b1), float(b2), 0.0]

    best = None
    best_err = np.inf
    for betas in (solve_beta_n1(), solve_beta_n2()):
        pc = cam_points(betas)
        rvec, tvec = _absolute_orientation_npt(obj, pc)
        proj = project_points(obj, rvec, tvec, k, dist)
        err = float(np.abs(proj - img).mean())
        if err < best_err:
            best, best_err = (rvec, tvec), err
    rvec, tvec = refine_pose(obj, img, k, dist, best[0], best[1],
                             iterations=10)
    return rvec, tvec


def _absolute_orientation_npt(obj: np.ndarray, cam: np.ndarray):
    """Horn rigid fit for N points (allows the EPnP scale to be
    absorbed: solve with unit scale — betas already carry it)."""
    from .calib import rodrigues

    co = obj.mean(0)
    cc = cam.mean(0)
    h = (obj - co).T @ (cam - cc)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    t = cc - r @ co
    return rodrigues(r), t


def init_inverse_rectification_map(k, dist, new_k,
                                   size: Tuple[int, int]
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV ``initInverseRectificationMap`` role: maps DISTORTED
    pixel coordinates to their RECTIFIED positions (the inverse
    direction of initUndistortRectifyMap) → (map_x, map_y) float32
    (h, w). size = (width, height)."""
    from .calib import undistort_points

    w, h = size
    k = np.asarray(k, np.float64)
    nk = k if new_k is None else np.asarray(new_k, np.float64)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel()], 1)
    und = undistort_points(pts, k, dist)
    # re-project through the NEW camera matrix
    xn = (und[:, 0] - k[0, 2]) / k[0, 0]
    yn = (und[:, 1] - k[1, 2]) / k[1, 1]
    mx = (nk[0, 0] * xn + nk[0, 2]).reshape(h, w)
    my = (nk[1, 1] * yn + nk[1, 2]).reshape(h, w)
    return mx.astype(np.float32), my.astype(np.float32)
