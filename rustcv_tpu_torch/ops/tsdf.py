"""TSDF volume (OpenCV ``Volume`` role, KinectFusion-style): integrate
depth frames into a truncated signed distance field, raycast synthetic
depth, extract the surface cloud.

Frozen spec (float32 voxels, host numpy — the voxel update is pure
vectorized math):
- voxel grid of ``resolution³`` cells of ``voxel_size`` metres anchored
  at ``origin`` (world frame);
- integrate(depth, K, camera pose R|t world→camera): project every
  voxel centre into the frame; sdf = depth(u, v) − z_cam, truncated to
  ±``trunc``; weighted running average with per-voxel weight clamped
  at 64 (the standard KinectFusion update);
- raycast(K, pose): per-pixel ray marching at voxel_size/2 steps with
  trilinear TSDF sampling and linear zero-crossing refinement;
- extract_cloud(): voxel centres where the TSDF changes sign against
  any +x/+y/+z neighbor (|tsdf| < 1 both sides), linearly interpolated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class TsdfVolume:
    def __init__(self, resolution: int = 128, voxel_size: float = 0.02,
                 origin=(0.0, 0.0, 0.0), trunc: Optional[float] = None):
        self.res = int(resolution)
        self.voxel = float(voxel_size)
        self.origin = np.asarray(origin, np.float64)
        self.trunc = float(trunc if trunc is not None
                           else 4.0 * voxel_size)
        self.tsdf = np.ones((self.res,) * 3, np.float32)
        self.weight = np.zeros((self.res,) * 3, np.float32)
        idx = (np.arange(self.res) + 0.5) * self.voxel
        zz, yy, xx = np.meshgrid(idx, idx, idx, indexing="ij")
        self._centers = np.stack(
            [xx + self.origin[0], yy + self.origin[1],
             zz + self.origin[2]], -1).reshape(-1, 3)

    def integrate(self, depth: np.ndarray, k, r, t,
                  max_weight: float = 64.0) -> None:
        d = np.asarray(depth, np.float64)
        h, w = d.shape
        k = np.asarray(k, np.float64)
        cam = self._centers @ np.asarray(r, np.float64).T \
            + np.asarray(t, np.float64)
        z = cam[:, 2]
        ok = z > 1e-6
        proj = cam @ k.T
        u = np.where(ok, proj[:, 0] / np.where(ok, z, 1.0), -1)
        v = np.where(ok, proj[:, 1] / np.where(ok, z, 1.0), -1)
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        ok &= (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        dm = np.zeros(len(cam))
        dm[ok] = d[vi[ok], ui[ok]]
        ok &= dm > 1e-6
        sdf = dm - z
        ok &= sdf > -self.trunc
        val = np.clip(sdf / self.trunc, -1.0, 1.0)
        flat_t = self.tsdf.reshape(-1)
        flat_w = self.weight.reshape(-1)
        wnew = np.minimum(flat_w[ok] + 1.0, max_weight)
        flat_t[ok] = (flat_t[ok] * flat_w[ok] + val[ok]) / wnew
        flat_w[ok] = wnew

    def _sample(self, pts: np.ndarray) -> np.ndarray:
        """Trilinear TSDF at world points (out of grid → +1)."""
        g = (pts - self.origin) / self.voxel - 0.5
        x0 = np.floor(g).astype(np.int64)
        f = g - x0
        out = np.zeros(len(pts))
        acc = np.zeros(len(pts))
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    xi = x0[:, 0] + dx
                    yi = x0[:, 1] + dy
                    zi = x0[:, 2] + dz
                    inb = ((xi >= 0) & (xi < self.res) & (yi >= 0)
                           & (yi < self.res) & (zi >= 0)
                           & (zi < self.res))
                    wgt = (np.where(dx, f[:, 0], 1 - f[:, 0])
                           * np.where(dy, f[:, 1], 1 - f[:, 1])
                           * np.where(dz, f[:, 2], 1 - f[:, 2]))
                    val = np.ones(len(pts))
                    val[inb] = self.tsdf[zi[inb], yi[inb], xi[inb]]
                    out += wgt * val
                    acc += wgt
        return out / np.maximum(acc, 1e-12)

    def raycast(self, k, r, t, shape: Tuple[int, int],
                max_depth: float = 5.0) -> np.ndarray:
        """→ synthetic depth (H, W) float32 (0 = no surface hit).
        Pose maps world→camera; rays march in world space."""
        h, w = shape
        k = np.asarray(k, np.float64)
        rm = np.asarray(r, np.float64)
        tv = np.asarray(t, np.float64)
        vs, us = np.mgrid[0:h, 0:w].astype(np.float64)
        rays_cam = np.stack([(us - k[0, 2]) / k[0, 0],
                             (vs - k[1, 2]) / k[1, 1],
                             np.ones_like(us)], -1).reshape(-1, 3)
        cam_center = -rm.T @ tv
        dirs = rays_cam @ rm  # world direction (unnormalized, z_cam=1)
        step = self.voxel * 0.5
        n_steps = int(max_depth / step)
        depth = np.zeros(len(dirs))
        active = np.ones(len(dirs), bool)
        prev = np.ones(len(dirs))
        tt = np.full(len(dirs), 5 * self.voxel)
        for _ in range(n_steps):
            pts = cam_center + dirs * tt[:, None]
            val = self._sample(pts)
            hit = active & (prev > 0) & (val <= 0)
            if hit.any():
                # linear zero crossing between prev and val
                frac = prev[hit] / np.maximum(prev[hit] - val[hit],
                                              1e-9)
                depth[hit] = tt[hit] - step + frac * step
                active[hit] = False
            prev = val
            tt = tt + step
            if not active.any():
                break
        return depth.reshape(h, w).astype(np.float32)

    def extract_cloud(self) -> np.ndarray:
        """→ (N, 3) float32 surface points (zero crossings along +x)."""
        t = self.tsdf
        w = self.weight
        pts = []
        for axis in range(3):
            a = t
            b = np.roll(t, -1, axis=axis)
            wa = w
            wb = np.roll(w, -1, axis=axis)
            cross = (np.sign(a) != np.sign(b)) & (np.abs(a) < 1) \
                & (np.abs(b) < 1) & (wa > 0) & (wb > 0)
            cross[tuple(slice(None) if i != axis else slice(-1, None)
                        for i in range(3))] = False
            zi, yi, xi = np.nonzero(cross)
            frac = a[zi, yi, xi] / np.maximum(
                a[zi, yi, xi] - b[zi, yi, xi], 1e-9)
            base = np.stack([xi, yi, zi], -1).astype(np.float64) + 0.5
            base[:, 2 - axis] += frac
            pts.append(base * self.voxel + self.origin)
        if not pts:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(pts).astype(np.float32)
