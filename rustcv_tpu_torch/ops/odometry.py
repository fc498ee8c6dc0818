"""Copy of ``rustcv_tpu.ops.odometry`` (the port's ``calib`` and
``threed``). RGB-D odometry (OpenCV ``Odometry`` role, ICP flavor): estimate the
rigid motion between two depth frames by coarse-to-fine point-to-plane
ICP with projective data association — the KinectFusion-style tracker.

Frozen spec (float64):
- pyramid: depth subsampled 2× per level (plain ``[::2, ::2]`` — depth
  averaging would blur step edges), intrinsics halved;
- per level, ``iters`` Gauss-Newton rounds: transform frame-0 points by
  the current pose, project into frame 1 (projective association),
  reject pairs with depth gap > ``max_depth_diff`` or grazing normals;
- point-to-plane residual r = n₁ · (p̂₀ − p₁); the 6×6 normal equations
  use the standard small-angle parametrization (ω × p + t);
- normals from ops/threed.rgbd_normals_numpy.

Tests recover synthetic ground-truth motions on structured scenes to
<1e-3 rad / <1 mm and degrade gracefully on textureless planes
(only the constrained DOF are checked there).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .calib import rodrigues
from .threed import depth_to_3d, rgbd_normals_numpy


def _pyr(depth: np.ndarray, k: np.ndarray, levels: int):
    out = [(depth, k)]
    d, kk = depth, k
    for _ in range(levels - 1):
        d = d[::2, ::2]
        kk = kk.copy()
        kk = np.array([[kk[0, 0] / 2, 0, kk[0, 2] / 2],
                       [0, kk[1, 1] / 2, kk[1, 2] / 2],
                       [0, 0, 1.0]])
        out.append((d, kk))
    return out[::-1]  # coarse first


def rgbd_odometry(depth0: np.ndarray, depth1: np.ndarray, k,
                  levels: int = 3, iters: int = 10,
                  max_depth_diff: float = 0.07
                  ) -> Tuple[bool, np.ndarray, np.ndarray]:
    """→ (ok, rvec, tvec): the pose mapping frame-0 camera points into
    frame 1 (p₁ = R·p₀ + t)."""
    k = np.asarray(k, np.float64)
    r = np.eye(3)
    t = np.zeros(3)
    p0_l = _pyr(np.asarray(depth0, np.float64), k, levels)
    p1_l = _pyr(np.asarray(depth1, np.float64), k, levels)
    ok_any = False
    for (d0, k0), (d1, k1) in zip(p0_l, p1_l):
        pts0 = depth_to_3d(d0.astype(np.float32), k0).astype(np.float64)
        pts1 = depth_to_3d(d1.astype(np.float32), k1).astype(np.float64)
        n1 = rgbd_normals_numpy(pts1).astype(np.float64)
        h, w = d0.shape
        valid0 = d0 > 1e-6
        for _ in range(iters):
            p = pts0 @ r.T + t
            proj = p @ k1.T
            z = proj[..., 2]
            good = valid0 & (z > 1e-6)
            u = np.where(good, proj[..., 0] / np.where(good, z, 1.0),
                         -1)
            v = np.where(good, proj[..., 1] / np.where(good, z, 1.0),
                         -1)
            ui = np.round(u).astype(np.int64)
            vi = np.round(v).astype(np.int64)
            good &= (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
            uis = np.where(good, ui, 0)
            vis = np.where(good, vi, 0)
            q = pts1[vis, uis]
            nq = n1[vis, uis]
            good &= q[..., 2] > 1e-6
            good &= np.abs(p[..., 2] - q[..., 2]) < max_depth_diff
            if good.sum() < 64:
                break
            pm = p[good]
            qm = q[good]
            nm = nq[good]
            res = ((pm - qm) * nm).sum(-1)
            # J row: [ (p × n) , n ]
            jac = np.concatenate([np.cross(pm, nm), nm], axis=1)
            a = jac.T @ jac
            b = -jac.T @ res
            try:
                x = np.linalg.solve(a + 1e-9 * np.eye(6), b)
            except np.linalg.LinAlgError:
                break
            dr = rodrigues(x[:3])
            r = dr @ r
            t = dr @ t + x[3:]
            ok_any = True
            if np.abs(x).max() < 1e-10:
                break
    return ok_any, rodrigues(r), t
