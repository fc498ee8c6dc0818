"""Affine-invariant feature wrapper (OpenCV ``AffineFeature`` /
ASIFT role): simulate viewpoint tilts, run SIFT on each simulated
view, and map keypoints back through the inverse affine — extending
rotation/scale invariance to strong out-of-plane viewpoint changes.

Frozen spec: tilt set t ∈ {1, √2, 2} with longitude steps Δφ = 72°/t
(the ASIFT paper's sampling, truncated for speed); each simulation is
an affine warp A = R(φ) then a 1/t x-compression with σ = 0.8·√(t²−1)
anti-alias blur along x; keypoints map back by A⁻¹ and carry their
descriptors unchanged (SIFT descriptors are computed in the simulated
frame, as in ASIFT).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .sift import detect_and_compute


def _simulations():
    sims = [(1.0, 0.0)]
    for t in (np.sqrt(2.0), 2.0):
        dphi = 72.0 / t
        phi = 0.0
        while phi < 180.0:
            sims.append((t, phi))
            phi += dphi
    return sims


def _warp_affine(img: np.ndarray, a: np.ndarray,
                 out_shape: Tuple[int, int]) -> np.ndarray:
    from .warp import warp_affine_numpy

    return warp_affine_numpy(img, a, (out_shape[1], out_shape[0]))


def affine_detect_and_compute(gray: np.ndarray, n_features: int = 0,
                              **sift_kw
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (keypoints float32 [N, 6] (x, y, size, angle, response,
    octave) in the ORIGINAL frame, descriptors u8 [N, 128])."""
    g = np.asarray(gray)
    h, w = g.shape
    all_kp = []
    all_desc = []
    for t, phi in _simulations():
        if t == 1.0:
            sim = g
            ainv = np.array([[1.0, 0, 0], [0, 1.0, 0]])
        else:
            rad = np.deg2rad(phi)
            c, s = np.cos(rad), np.sin(rad)
            r = np.array([[c, -s], [s, c]])
            # rotated corners → bounding box
            corners = np.array([[0, 0], [w, 0], [w, h], [0, h]]) @ r.T
            mn = corners.min(0)
            sz = corners.max(0) - mn
            a = np.array([[c, -s, -mn[0]], [s, c, -mn[1]]])
            # tilt: compress x by 1/t after blurring along x
            tilt = np.array([[1.0 / t, 0, 0], [0, 1.0, 0]])
            a_full = tilt @ np.vstack([a, [0, 0, 1]])
            out_w = int(np.ceil(sz[0] / t))
            out_h = int(np.ceil(sz[1]))
            rot = _warp_affine(g, a, (out_h, int(np.ceil(sz[0]))))
            # anti-alias along x before the compression
            sigma = 0.8 * np.sqrt(t * t - 1.0)
            k = int(sigma * 4) | 1
            xs = np.arange(k) - k // 2
            kern = np.exp(-xs ** 2 / (2 * sigma * sigma))
            kern /= kern.sum()
            p = np.pad(rot.astype(np.float64),
                       ((0, 0), (k // 2, k // 2)), mode="edge")
            blurred = sum(kern[i] * p[:, i:i + rot.shape[1]]
                          for i in range(k))
            sim = _warp_affine(
                np.clip(blurred, 0, 255).astype(np.uint8),
                tilt, (out_h, out_w))
            a_full33 = np.vstack([a_full, [0, 0, 1]])
            ainv = np.linalg.inv(a_full33)[:2]
        kp, desc = detect_and_compute(sim, n_features=n_features,
                                      **sift_kw)
        if len(kp) == 0:
            continue
        pts = kp[:, :2] @ ainv[:, :2].T + ainv[:, 2]
        keep = ((pts[:, 0] >= 0) & (pts[:, 0] < w)
                & (pts[:, 1] >= 0) & (pts[:, 1] < h))
        kp = kp.copy()
        kp[:, :2] = pts
        all_kp.append(kp[keep])
        all_desc.append(desc[keep])
    if not all_kp:
        return np.zeros((0, 6), np.float32), np.zeros((0, 128), np.uint8)
    return (np.concatenate(all_kp).astype(np.float32),
            np.concatenate(all_desc))
